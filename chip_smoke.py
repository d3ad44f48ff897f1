"""On-card smoke run of the PyTorch/CUDA port (akari_render_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
1. environment: the card's name and power limit; CUDA must be present;
2. build: compile the K1 intersect kernel from csrc/ and time the build;
3. K1 parity: matbox's triangles against 2^18 rays (camera rays plus
   seeded random rays from inside the box, some with exclusion ids),
   kernel against its plain torch version, closest and any hit, with CUDA
   event timings; and the PCG32 sampler on the card against the CPU;
4. slice correctness: matbox 64x64, 16 spp, d12 through the port's CLI,
   held against the committed JAX images (testdata/matbox64_spp*.npy);
5. the slice at full width: matbox 512x512 through the CLI with
   scenes/matbox/pt.json, with the kernel's launches counted.

It prints a JSON line of kernel results, the card's name and power limit,
and last a JSON line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCENE = ROOT / "scenes" / "matbox" / "scene.json"
METHOD = ROOT / "scenes" / "matbox" / "pt.json"
OUT = ROOT / "build" / "chip_smoke"
N_RAYS = 1 << 18
FULL_SPP = 8

# phase-3 tolerances: ids / occlusion may differ on at most this fraction of
# rays; t, u, v agree to this relative error where the ids agree
ID_MISMATCH_FRAC = 1e-5
REL_TOL = 1e-5
# phase-4 tolerances: channel means within 1 % of the JAX 16-spp image, and
# MSE against the JAX 256-spp image within 1.1x of the JAX 16-spp image's
MEAN_TOL = 0.01
MSE_RATIO = 1.1


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def gpu_query() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the current stream (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_rays(scene, device):
    """2^17 jittered camera rays plus 2^17 rays from inside the box."""
    import numpy as np
    import torch

    from akari_render_tpu_torch.camera import generate_rays

    rng = np.random.default_rng(7)
    cam = scene.camera
    half = N_RAYS // 2
    pix = rng.choice(cam.width * cam.height, size=half, replace=False)
    p_film = np.stack([pix % cam.width, pix // cam.width], -1) + rng.random((half, 2))
    o_c, d_c = generate_rays(cam, torch.as_tensor(p_film, dtype=torch.float32, device=device))
    v0 = scene.arrays.v0.cpu().numpy()
    lo, hi = v0.min(0), v0.max(0)
    o_r = lo + (hi - lo) * (0.05 + 0.9 * rng.random((half, 3)))
    d_r = rng.normal(size=(half, 3))
    d_r /= np.linalg.norm(d_r, axis=-1, keepdims=True)
    o = torch.cat([o_c.contiguous(), torch.as_tensor(o_r, dtype=torch.float32, device=device)])
    d = torch.cat([d_c, torch.as_tensor(d_r, dtype=torch.float32, device=device)])
    return o.contiguous(), d.contiguous(), rng


def k1_parity(scene, device):
    """Phase 3: kernel vs plain version. Returns the kernel's JSON entry."""
    import numpy as np
    import torch

    from akari_render_tpu_torch.accel import intersect as k1
    from akari_render_tpu_torch.core.math import RAY_TMAX

    a = scene.arrays
    tris = (a.v0, a.e1, a.e2)
    o, d, rng = make_rays(scene, device)
    n, t_count = o.shape[0], a.v0.shape[0]
    tmin = torch.zeros(n, device=device)
    tmax = torch.full((n,), RAY_TMAX, device=device)
    # exclusion ids: a quarter of the rays exclude the surface they hit
    # first, others carry random ids in the second and third slots
    first = k1.intersect_tris_torch(o, d, tmin, tmax, *tris)
    ex0 = torch.where(torch.as_tensor(rng.random(n) < 0.25, device=device), first.tri_id, -1)
    ex1 = torch.as_tensor(np.where(rng.random(n) < 0.25, rng.integers(0, t_count, n), -1),
                          dtype=torch.int32, device=device)
    ex2 = torch.as_tensor(np.where(rng.random(n) < 0.1, rng.integers(0, t_count, n), -1),
                          dtype=torch.int32, device=device)
    ex0 = ex0.to(torch.int32)
    # any-hit rays: shadow-like segments, half cut before the first hit
    seg = torch.where(first.valid, first.t, 10.0)
    cut = torch.as_tensor(rng.random(n) < 0.5, device=device)
    tmax_any = torch.where(cut, seg * 0.5, seg * 1.5)
    args = (o, d, tmin, tmax, *tris, ex0, ex1, ex2)
    args_any = (o, d, tmin, tmax_any, *tris, ex0, ex1, ex2)

    hk = k1.intersect_tris(*args)
    hp = k1.intersect_tris_torch(*args)
    ok_k = k1.intersect_tris(*args_any, any_hit=True)
    ok_p = k1.intersect_tris_torch(*args_any, any_hit=True)
    torch.cuda.synchronize()
    id_mis = int((hk.tri_id != hp.tri_id).sum())
    occ_mis = int((ok_k != ok_p).sum())
    same = (hk.tri_id == hp.tri_id) & hk.valid

    def rel(x, y):
        return float((torch.abs(x - y) / torch.clamp(torch.abs(y), min=1e-30))[same].max()) if bool(same.any()) else 0.0

    def absd(x, y):
        return float(torch.abs(x - y)[same].max()) if bool(same.any()) else 0.0

    rel_t, rel_u, rel_v = rel(hk.t, hp.t), rel(hk.bary[:, 0], hp.bary[:, 0]), rel(hk.bary[:, 1], hp.bary[:, 1])
    max_abs = max(absd(hk.t, hp.t), absd(hk.bary[:, 0], hp.bary[:, 0]), absd(hk.bary[:, 1], hp.bary[:, 1]))
    miss_ok = bool(torch.all(hk.t[~hk.valid] == RAY_TMAX))
    print(f"K1 parity: {n} rays x {t_count} tris; hits {int(hk.valid.sum())}, "
          f"occluded {int(ok_k.sum())}; id mismatches {id_mis}, occlusion mismatches {occ_mis}; "
          f"max rel err t {rel_t:.3g} u {rel_u:.3g} v {rel_v:.3g}; max abs err {max_abs:.3g}",
          flush=True)
    check(id_mis <= ID_MISMATCH_FRAC * n, f"K1 closest-hit ids differ on {id_mis} rays")
    check(occ_mis <= ID_MISMATCH_FRAC * n, f"K1 any-hit flags differ on {occ_mis} rays")
    check(max(rel_t, rel_u, rel_v) <= REL_TOL, "K1 t/u/v disagree with the plain version")
    check(miss_ok, "K1 misses must report t = RAY_TMAX")

    ms = cuda_ms(lambda: k1.intersect_tris(*args), 20)
    plain_ms = cuda_ms(lambda: k1.intersect_tris_torch(*args), 3)
    ms_any = cuda_ms(lambda: k1.intersect_tris(*args_any, any_hit=True), 20)
    plain_ms_any = cuda_ms(lambda: k1.intersect_tris_torch(*args_any, any_hit=True), 3)
    print(f"K1 times at {n} rays x {t_count} tris: closest {ms:.4f} ms (plain {plain_ms:.4f} ms), "
          f"any hit {ms_any:.4f} ms (plain {plain_ms_any:.4f} ms)", flush=True)
    return {
        "name": "K1 brute-force Moller-Trumbore (closest hit)",
        "route": "cuda",
        "source": "akari_render_tpu_torch/csrc/intersect.cu",
        "replaces": "akari_render_tpu/accel/pallas_intersect.py:37",
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
    }


def pcg_parity(device):
    """The PCG32 sampler's int64 wraparound on the card equals the CPU's."""
    import torch

    from akari_render_tpu_torch.core.lds import make_sampler

    pix = torch.arange(N_RAYS, dtype=torch.int64)
    draws = []
    for dev in ("cpu", device):
        s = make_sampler({"type": "independent", "seed": 0}, pix.to(dev), 5, 0)
        s, u = s.next_3d()
        draws.append((u.cpu(), s.rng.state.cpu()))
    check(torch.equal(draws[0][0], draws[1][0]) and torch.equal(draws[0][1], draws[1][1]),
          "PCG32 draws on the card differ from the CPU's")
    print(f"PCG32 parity: {N_RAYS} lanes x 3 draws bit-equal on cpu and {device}", flush=True)


def slice_correctness(device):
    """Phase 4: matbox 64^2 16 spp against the committed JAX images."""
    import numpy as np

    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr

    out = OUT / "matbox64.exr"
    cli_main(["-s", str(SCENE), "-m", str(METHOD), "--res", "64", "--spp", "16",
              "-o", str(out), "--device", device])
    img = read_exr(out)
    testdata = ROOT / "akari_render_tpu_torch" / "testdata"
    jax16 = np.load(testdata / "matbox64_spp16.npy")
    gt = np.load(testdata / "matbox64_spp256.npy")
    check(img.shape == jax16.shape and bool(np.all(np.isfinite(img))), "64^2 image shape / finiteness")
    m_port, m_jax = img.mean(axis=(0, 1)), jax16.mean(axis=(0, 1))
    mean_rel = float(np.max(np.abs(m_port - m_jax) / np.abs(m_jax)))
    mse_port = float(np.mean((img - gt) ** 2))
    mse_jax = float(np.mean((jax16 - gt) ** 2))
    mse_pj = float(np.mean((img - jax16) ** 2))
    print(f"slice 64^2 16spp: means port {m_port} jax {m_jax} (max rel {mean_rel:.3g}); "
          f"MSE(port, gt) {mse_port:.6g}, MSE(jax16, gt) {mse_jax:.6g}, "
          f"MSE(port, jax16) {mse_pj:.6g}", flush=True)
    check(mean_rel <= MEAN_TOL, "64^2 channel means differ from the JAX image by more than 1%")
    check(mse_port <= MSE_RATIO * mse_jax, "64^2 MSE against the JAX ground truth too high")


def full_width(device):
    """Phase 5: matbox 512^2 through the CLI, launches counted."""
    import numpy as np

    from akari_render_tpu_torch.accel import intersect as k1
    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr

    out = OUT / "matbox512.exr"
    stats_path = out.with_suffix(".stats.json")
    for p in (out, stats_path):
        p.unlink(missing_ok=True)
    k1.launches = 0
    t0 = time.perf_counter()
    stats = cli_main(["-s", str(SCENE), "-m", str(METHOD), "--spp", str(FULL_SPP),
                      "-o", str(out), "--save-stats", "--device", device])
    wall = time.perf_counter() - t0
    launches = k1.launches
    check(launches > 0, "the main path launched K1 no time")
    check(out.exists() and stats_path.exists(), "EXR or stats JSON missing")
    img = read_exr(out)
    check(img.shape == (512, 512, 3) and bool(np.all(np.isfinite(img))), "512^2 image shape / finiteness")
    paths = 512 * 512 * FULL_SPP
    mpaths = paths / stats["total_time"] / 1e6
    print(f"slice 512^2 {FULL_SPP}spp d12: render {stats['total_time']:.3f} s "
          f"({mpaths:.4f} Mpaths/s), CLI wall {wall:.3f} s, K1 launches {launches}, "
          f"image mean {img.mean(axis=(0, 1))}", flush=True)
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    from akari_render_tpu_torch.accel import intersect as k1
    from akari_render_tpu_torch.core.math import disable_tf32
    from akari_render_tpu_torch.scene import load_scene

    query = gpu_query()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} ({query}); torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    disable_tf32()
    device = "cuda"
    OUT.mkdir(parents=True, exist_ok=True)

    t0 = time.perf_counter()
    k1.build()
    print(f"K1 build: {time.perf_counter() - t0:.3f} s (nvcc {k1.build_seconds:.3f} s)", flush=True)

    scene = load_scene(str(SCENE), device=device)
    entry = k1_parity(scene, device)
    pcg_parity(device)
    slice_correctness(device)
    entry["launches"] = full_width(device)

    print(json.dumps({"kernels": [entry]}))
    print(gpu_query())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
