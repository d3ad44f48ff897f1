"""On-card smoke run of the PyTorch/CUDA port (akari_render_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
1. environment: the card's name and power limit; CUDA must be present;
2. build: compile the K1 intersect kernel from csrc/ and time the build
   (in parallel with phase 6's build: one nvcc per source);
3. K1 parity: matbox's triangles against 2^18 rays (camera rays plus
   seeded random rays from inside the box, some with exclusion ids),
   kernel against its plain torch version, closest and any hit, with CUDA
   event timings; and the PCG32 sampler on the card against the CPU;
4. slice correctness: matbox 64x64, 16 spp, d12 through the port's CLI,
   held against the committed JAX images (testdata/matbox64_spp*.npy);
5. the flat-tier path at full width: matbox 512x512 through the CLI with
   scenes/matbox/pt.json, with K1's launches counted;
6. build: compile the pair-sweep kernels K2, K3 and K4 (csrc/pairs.cu);
7. K2/K3/K4 parity at classroom's shapes: the unified candidate list
   (4,633 clusters) against 2^18 rays (1080p camera rays, rays from
   interior points, shadow segments, dead and NaN lanes, exclusion ids),
   each kernel against its plain version, bit-equal, with CUDA event
   timings; and the pair sweep against K1 over the fully flattened world
   soup, an independent check;
8. cluster-tier correctness: classroom 96x96, 16 spp, d12 through the CLI,
   held against the committed JAX image (testdata/classroom96_spp16.npy)
   and the committed 512-spp ground truth (BENCH_MSE_CLASSROOM.gt.exr);
9. the cluster-tier path at full width: classroom 1920x1080, 1 spp, d12
   through the CLI with scenes/classroom/pt.json, with K2/K3/K4's launches
   counted;
10. build: the path megakernel K8 (csrc/megakernel.cu) and the fused shade
   K9 (csrc/fused_shade.cu), in the same parallel build as phases 2 and 6;
11. K9 parity: the live lanes of the first bounce of a path-B sample of
   blinds 256x256 (the main path's inputs), and 2^18 lanes of seeded
   blinds shade inputs, kernel against its plain version, with CUDA event
   timings at both;
12. K8 parity: blinds 256x256, 16 spp, d12 (one pass of the main path),
   the kernel pass against its plain version per pixel and on the rays
   each traced, with the time of each;
13. fused-tier correctness: blinds 64x64, 16 spp, d12 through the CLI with
   AKR_MEGAKERNEL=1 (path A) and with AKR_PALLAS_SHADE=1 (path B), each
   held against the committed JAX image of its tier
   (testdata/blinds64{_mk,}_spp16.npy) and the JAX 256-spp image;
14. the fused tiers at full width: blinds 256x256, d12 through the CLI
   three times, path B and path A with scenes/blinds/pt.json (64 spp;
   path B: K9 at most once per bounce and no lane through the per-kind
   dispatch; path A: K8 once per pass) and, as the baseline, the
   wavefront with the per-kind dispatch at one 16-spp pass, with every
   kernel's launches counted per path, and the device events of one sample
   of each read from torch.profiler;
15. build: the wide-BVH walk K7 (csrc/wide.cu), in the same parallel build
   (K5, the window refine, is part of csrc/pairs.cu);
16. K7 and K5 parity on phase 7's classroom rays: the wide walk's kernel
   against its plain version (closest hit with exclusion ids and cut tmax
   against the plain rounds; any hit against the plain version at one leaf
   a round, which is the kernel step for step, with the nodes expanded and
   leaves tested of each block), bit-equal; the wide walk and the windowed
   walk against the static pair sweep (valid and t bit-equal; ids equal
   except on exact t ties, counted); K5 on the first round's window of that
   windowed traversal against its plain version, bit-equal; CUDA event
   timings and bounds;
17. the other traversals' correctness: classroom 96x96, 16 spp, d12 through
   the CLI with AKR_WIDE=1 and with AKR_PAIRS_STATIC=0, each held to phase
   8's gates and against phase 8's image;
18. the other traversals at full width: classroom 1920x1080, 1 spp, d12
   through the CLI under each switch, with every kernel's launches counted
   and the windowed walk's rounds, beside phase 9's default route.

Each phase prints the seconds since the start when it ends.

Phase 7 also runs K6 (the K4 kernel with the early-out off, `pairs.sweep`)
at classroom's shapes against its plain version; no main path calls it.

It prints a JSON line of kernel results (with each kernel's bound: the
bytes it must move over 3.35 TB/s or the FP32 operations this run's data
needs over 67 TFLOP/s, whichever is longer; a lane's slab test of one box
counted as 12), the card's name and power
limit, and last a JSON line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCENE = ROOT / "scenes" / "matbox" / "scene.json"
METHOD = ROOT / "scenes" / "matbox" / "pt.json"
CLASSROOM = ROOT / "scenes" / "classroom" / "scene.json"
CLASSROOM_METHOD = ROOT / "scenes" / "classroom" / "pt.json"
CLASSROOM_GT = ROOT / "BENCH_MSE_CLASSROOM.gt.exr"  # 96x96, 512 spp
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
# phase-7 independent check, the pair sweep against K1 over the flattened
# soup. Where their t differ by more than PAIRS_T_REL (relative) or their
# hit flags differ, either both hit the same triangle and t differs by at
# most PAIRS_T_ABS metres (instanced hits compute t from a transformed ray,
# which rounds to ~1e-6 m at classroom's coordinates, and a ray that starts
# millimetres from a surface has a tiny t), or the two hit different
# surfaces: on at most PAIRS_K1_MAX rays (measured: 1 of 2^18), each passing
# within GRAZE_M metres of an edge of the nearer triangle (float64), where
# Moller-Trumbore, not watertight, lets a ray through the crack between two
# triangles in one form of the geometry and not in the other
PAIRS_T_REL = 1e-4
PAIRS_T_ABS = 1e-5
PAIRS_K1_MAX = 1
GRAZE_M = 1e-5
# the fused tiers on blinds
BLINDS = ROOT / "scenes" / "blinds" / "scene.json"
BLINDS_METHOD = ROOT / "scenes" / "blinds" / "pt.json"
# phase-11 tolerances: K9 against its plain version, relative per output,
# and the fraction of lanes whose valid flag may differ
K9_REL = 1e-5
K9_VALID_FRAC = 1e-5
# phase-12 tolerances: per pixel rtol / atol; a rounding flip of a path
# decision may put at most K8_PIX_FRAC of the pixels outside them, with the
# channel means then within K8_MEAN_REL
K8_RTOL, K8_ATOL, K8_PIX_FRAC, K8_MEAN_REL = 1e-3, 2e-3, 0.01, 1e-3
# the card's peaks (NVIDIA's H100 SXM data sheet, at 700 W): FP32 outside
# the tensor cores, and HBM bandwidth
FP32_PEAK = 67e12
HBM_BPS = 3.35e12
# FP32 operations of one Möller-Trumbore ray-triangle test (adds, multiplies
# and the division; compares not counted), as K1, K4, K6 and K8 write it
MT_FLOPS = 46


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(least milliseconds, what sets it): ops FP32 operations at the
    FP32 peak against nbytes of device memory traffic at HBM_BPS."""
    t_ops, t_bytes = ops / FP32_PEAK * 1e3, nbytes / HBM_BPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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


def timed(fn):
    """(fn's result, milliseconds of that one call by CUDA events): for a
    plain version whose result is also the one compared."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


T0 = time.perf_counter()


def lap(phase: str):
    print(f"[{time.perf_counter() - T0:.1f} s] {phase} done", flush=True)


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
    # every ray is live: each tests every triangle; each ray reads 44 B
    # (o, d, tmin, tmax, three ids) and writes 16 B, each triangle is 36 B
    bound_ms, bound_by = bound(n * t_count * MT_FLOPS, n * 60 + t_count * 36)
    print(f"K1 times at {n} rays x {t_count} tris: closest {ms:.4f} ms (plain {plain_ms:.4f} ms), "
          f"any hit {ms_any:.4f} ms (plain {plain_ms_any:.4f} ms); bound {bound_ms:.4f} ms "
          f"({bound_by}: {n * t_count * MT_FLOPS:.4g} FP32 operations)", flush=True)
    return {
        "name": "K1 brute-force Moller-Trumbore (closest hit)",
        "route": "cuda",
        "source": "akari_render_tpu_torch/csrc/intersect.cu",
        "replaces": "akari_render_tpu/accel/pallas_intersect.py:37",
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
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


def max_abs_diff(a, b) -> float:
    """Largest |a - b| over entries that are not bit-equal (0.0 if all are;
    inf where only one side is infinite)."""
    import torch

    diff = torch.where(a == b, 0.0, torch.abs(a.double() - b.double()))
    diff = torch.nan_to_num(diff, nan=float("inf"))
    return float(diff.max()) if diff.numel() else 0.0


def mt64(o, d, v0, e1, e2):
    """Float64 Moller-Trumbore of ray i against triangle i: (t, signed
    distance in the triangle's plane from the hit point to its nearest
    edge, negative outside)."""
    import numpy as np

    o, d, v0, e1, e2 = (np.asarray(a, np.float64) for a in (o, d, v0, e1, e2))
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.cross(d, e2)
        inv = 1.0 / np.sum(e1 * p, -1)
        tv = o - v0
        q = np.cross(tv, e1)
        u = np.sum(tv * p, -1) * inv
        v = np.sum(d * q, -1) * inv
        t = np.sum(e2 * q, -1) * inv
        area2 = np.linalg.norm(np.cross(e1, e2), axis=-1)
        ln = [np.linalg.norm(e, axis=-1) for e in (e2 - e1, e2, e1)]
        dist = np.minimum.reduce([w * area2 / np.maximum(n, 1e-30)
                                  for w, n in zip((1.0 - u - v, u, v), ln)])
    return t, dist


def virtual_to_flat(scene, sg, info):
    """([n_ids] flattened-soup triangle of each global virtual id, the names
    of the instanced instances). Flat ids come first, in scene order
    without the instanced instances, then each instance's local triangles
    from its tri_base."""
    import numpy as np

    from akari_render_tpu_torch.scene import _partition_instances

    skip, _, _ = _partition_instances(sg)
    ia = scene.arrays.instanced
    base, count = ia.tri_base.cpu().numpy(), ia.tri_count.cpu().numpy()
    names = list(sg.instances)
    v2f = np.full(int(base[-1] + count[-1]), -1, np.int64)
    run = 0
    for i in info:
        if i["name"] not in skip:
            v2f[run:run + i["tri_count"]] = i["tri_start"] + np.arange(i["tri_count"])
            run += i["tri_count"]
    check(run == scene.num_tris, "flat triangles of the scene and the flattened soup differ")
    start = {i["name"]: i["tri_start"] for i in info}
    for b, c, k in zip(base, count, ia.inst_index.cpu().numpy()):
        v2f[b:b + c] = start[names[k]] + np.arange(c)
    return v2f, skip


def explain_disagreements(o, d, tmin, tmax, hk, hp, bad, scene, sg, soup, info):
    """For each ray on which the pair sweep (hp) and K1 over the flattened
    soup (hk) disagree, print both hits mapped back to their instances and
    either the gap in t (the same triangle on both sides) or, in float64,
    the distance from the ray to the nearest edge of the nearer triangle,
    which the farther side missed. The rays and hits go to
    pairs_vs_k1.npz. Returns (same triangle [m], |t gap| [m], that edge
    distance [m])."""
    import numpy as np

    idx = np.nonzero(bad.cpu().numpy())[0]
    v2f, skip = virtual_to_flat(scene, sg, info)
    names = list(sg.instances)
    kt, kid, kv = (x[idx].cpu().numpy() for x in (hk.t, hk.tri_id, hk.valid))
    pt, pid, pv = (x[idx].cpu().numpy() for x in (hp.t, hp.tri_id, hp.valid))
    pflat = np.where(pv, v2f[np.clip(pid, 0, len(v2f) - 1)], -1)
    same = kv & pv & (kid == pflat)
    gap = np.where(same, np.abs(kt.astype(np.float64) - pt), np.inf)
    k_near = kv & (~pv | (kt < pt))
    near_tri = np.where(k_near, kid, pflat)
    _, edge = mt64(o[idx].cpu().numpy(), d[idx].cpu().numpy(),
                   *(a[near_tri] for a in (soup.v0, soup.e1, soup.e2)))

    def who(flat):
        if flat < 0:
            return "miss"
        name = names[soup.inst_id[flat]]
        return f"{name} tri {flat} ({'instanced' if name in skip else 'flat'})"

    for j, r in enumerate(idx):
        why = (f"same triangle, t gap {gap[j]:.3g} m" if same[j] else
               f"different surfaces, nearer {'K1' if k_near[j] else 'pair sweep'}, whose "
               f"triangle's edge is {edge[j]:.3g} m from the ray (float64)")
        print(f"  ray {r}: K1 t {kt[j]:.7g} {who(kid[j] if kv[j] else -1)}; pair sweep t "
              f"{pt[j]:.7g} {who(pflat[j])}; {why}", flush=True)
    np.savez(OUT / "pairs_vs_k1.npz", idx=idx, o=o[idx].cpu().numpy(), d=d[idx].cpu().numpy(),
             tmin=tmin[idx].cpu().numpy(), tmax=tmax[idx].cpu().numpy(),
             k1_t=kt, k1_id=kid, k1_valid=kv, pairs_t=pt, pairs_id=pid, pairs_valid=pv,
             pairs_flat=pflat)
    return same, gap, edge


def classroom_rays(scene, cl, device):
    """2^18 rays over classroom: a quarter 1080p camera rays, a quarter
    from interior points in random directions, half shadow segments between
    interior points (flagged any hit); 2 % dead (tmax -1), 8 NaN lanes.
    Returns (o, d, tmin, tmax, shadow mask)."""
    import numpy as np
    import torch

    from akari_render_tpu_torch.camera import generate_rays
    from akari_render_tpu_torch.core.math import RAY_TMAX

    rng = np.random.default_rng(11)
    n, q = N_RAYS, N_RAYS // 4
    cam = scene.camera
    pix = rng.choice(cam.width * cam.height, size=q, replace=False)
    p_film = np.stack([pix % cam.width, pix // cam.width], -1) + rng.random((q, 2))
    o_c, d_c = generate_rays(cam, torch.as_tensor(p_film, dtype=torch.float32, device=device))
    lo = cl.cbmin.amin(0).cpu().numpy()
    hi = cl.cbmax.amax(0).cpu().numpy()

    def interior(m):
        return lo + (hi - lo) * (0.1 + 0.8 * rng.random((m, 3)))

    o_r = interior(q)
    d_r = rng.normal(size=(q, 3))
    d_r /= np.linalg.norm(d_r, axis=-1, keepdims=True)
    o_s, p_s = interior(2 * q), interior(2 * q)
    seg = np.linalg.norm(p_s - o_s, axis=-1)
    d_s = (p_s - o_s) / seg[:, None]
    tmax = np.concatenate([np.full(2 * q, RAY_TMAX), seg])
    tmax[rng.random(n) < 0.02] = -1.0
    o = np.concatenate([o_c.cpu().numpy(), o_r, o_s])
    o[rng.choice(n, 8, replace=False)] = np.nan
    d = np.concatenate([d_c.cpu().numpy(), d_r, d_s])
    shadow = np.arange(n) >= 2 * q

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    return t(o), t(d), t(np.full(n, 1e-4)), t(tmax), t(shadow, torch.bool)


def pairs_parity(device):
    """Phase 7: K2, K3 and K4 against their plain versions at classroom's
    shapes, and the pair sweep against K1 over the flattened world soup.
    Returns the kernels' JSON entries and, for phase 16, the scene, its
    candidate list, the rays with their exclusion ids, their sorted blocks
    and the static pair sweep's hits."""
    import numpy as np
    import torch

    from akari_render_tpu_torch.accel import intersect as k1
    from akari_render_tpu_torch.accel import pairs
    from akari_render_tpu_torch.accel.flatten import flatten_scene
    from akari_render_tpu_torch.scene import load_scene
    from akari_render_tpu_torch.scenegraph.model import load_scene_json

    scene = load_scene(str(CLASSROOM), device=device)
    cl = scene.arrays.unified
    o, d, tmin, tmax, shadow = classroom_rays(scene, cl, device)
    n, K = o.shape[0], cl.num_clusters
    # exclusion ids: a quarter of the rays exclude their first hit, others a
    # random global virtual id
    first = pairs.intersect_pairs(cl, o, d, tmin, tmax)
    rng = np.random.default_rng(12)
    n_ids = int(scene.arrays.instanced.tri_base[-1] + scene.arrays.instanced.tri_count[-1])
    ex0 = torch.where(torch.as_tensor(rng.random(n) < 0.25, device=device), first.tri_id, -1)
    ex1 = torch.as_tensor(np.where(rng.random(n) < 0.25, rng.integers(0, n_ids, n), -1),
                          dtype=torch.int32, device=device)
    s = pairs.sort_rays(cl, o, d, tmin, tmax, ex0, ex1)
    s_mask = pairs.sort_rays(cl, o, d, tmin, tmax, ex0, ex1, any_hit_mask=shadow)
    cb6 = pairs.cluster_bounds(cl)
    B = s.summ.shape[0]

    e_con = pairs.cull_einit(s.summ, cb6)
    e_con_p = pairs.cull_einit_torch(s.summ, cb6)
    e_init = pairs.refine_all(cb6, s.o_soa, s.inv_soa, s.lim, e_con)
    e_init_p, plain_ms = timed(lambda: pairs.refine_all_torch(cb6, s.o_soa, s.inv_soa, s.lim, e_con))
    plain_ms = {"K3": plain_ms}
    order = pairs.walk_order(e_init)
    walks = {}
    for mode, sr, any_hit in (("any hit", s, True), ("any_hit_mask", s_mask, False),
                              ("closest", s, False)):
        args = (*order, cl.tri_row, cl.tri, cl.xf, sr.o_soa, sr.d_soa, sr.lim, sr.ex, sr.best0,
                any_hit)
        got = pairs.sweep_walk(*args)
        want, plain_ms["K4"] = timed(lambda: pairs.sweep_walk_torch(*args))
        walks[mode] = (got, want)  # closest last: K4's plain time is its walk's
    torch.cuda.synchronize()
    errs = {"K2": max_abs_diff(e_con, e_con_p), "K3": max_abs_diff(e_init, e_init_p),
            "K4": max(max_abs_diff(*w) for w in walks.values())}
    kcnt = order[2].float()
    print(f"pair parity at {n} rays ({B} blocks) x {K} clusters: e_con finite "
          f"{float(torch.isfinite(e_con).float().mean()):.4f}, e_init finite "
          f"{float(torch.isfinite(e_init).float().mean()):.4f} (walk length mean "
          f"{float(kcnt.mean()):.1f}, max {int(kcnt.max())}); max abs err K2 {errs['K2']} "
          f"K3 {errs['K3']} K4 {errs['K4']}", flush=True)
    check(torch.equal(e_con, e_con_p), "K2 e_con differs from its plain version")
    check(torch.equal(e_init, e_init_p), "K3 e_init differs from its plain version")
    for mode, (wk, wp) in walks.items():
        check(torch.equal(wk, wp), f"K4 walk ({mode}) differs from its plain version")
    hits = {m: int((w[0][1] >= 0).sum()) for m, w in walks.items()}
    print(f"K4 lanes with a hit: {hits}", flush=True)

    walk_args = (*order, cl.tri_row, cl.tri, cl.xf, s.o_soa, s.d_soa, s.lim, s.ex, s.best0, False)
    walked = torch.zeros(B, dtype=torch.int32, device=device)
    pairs.sweep_walk(*walk_args, walked=walked)

    # K6: the first K6_M candidates of each block's closest-hit walk, with
    # JAX's dummy row (index R) for the ends of short walks
    R, C = cl.tri.shape[0], cl.tri.shape[1]
    k6_m = 64
    worder, _, kcnt = order
    cand = worder[:, :k6_m].long()
    valid = torch.arange(cand.shape[1], device=device)[None, :] < kcnt[:, None].long()
    rows = cl.tri_row.long()[cand] if cl.tri_row is not None else cand
    tri_k6 = torch.cat([cl.tri, torch.zeros((1, C, 12), device=device)])
    xf_k6 = cl.xf if cl.xf is not None else torch.eye(4, device=device).reshape(1, 16)[:, :16]
    k6_args = (torch.where(valid, rows, R), cand if cl.xf is not None else torch.zeros_like(cand),
               s.o_soa, s.d_soa, s.lim, s.ex, tri_k6, xf_k6, s.best0, False)
    k6 = pairs.sweep(*k6_args)
    k6_p, plain_ms["K6"] = timed(lambda: pairs.sweep_torch(*k6_args))
    torch.cuda.synchronize()
    errs["K6"] = max_abs_diff(k6, k6_p)
    print(f"K6 (K4 kernel, early-out off) at {n} rays x {int(valid.sum())} candidates (the first "
          f"{k6_m} of each walk): lanes with a hit {int((k6[1] >= 0).sum())}, max abs err "
          f"{errs['K6']}", flush=True)
    check(torch.equal(k6, k6_p), "K6 differs from its plain version")

    # the plain K3, K4 and K6 times are those of their parity calls above
    ms = {
        "K2": (cuda_ms(lambda: pairs.cull_einit(s.summ, cb6), 20),
               cuda_ms(lambda: pairs.cull_einit_torch(s.summ, cb6), 3)),
        "K3": (cuda_ms(lambda: pairs.refine_all(cb6, s.o_soa, s.inv_soa, s.lim, e_con), 20),
               plain_ms["K3"]),
        "K4": (cuda_ms(lambda: pairs.sweep_walk(*walk_args), 5), plain_ms["K4"]),
        "K6": (cuda_ms(lambda: pairs.sweep(*k6_args), 5), plain_ms["K6"]),
    }
    # bounds: K2 writes e_con (36 FP32 operations per element); K3 runs 12
    # per lane x cluster on the tiles K2 left live; K4 and K6 transform each
    # live lane's ray (33) and test it against C slots (MT_FLOPS + 1 each)
    # per candidate tested, and read each lane's 16 floats, write its 4
    nt = -(-K // pairs.RALL_TILE)
    con = torch.nn.functional.pad(e_con, (0, nt * pairs.RALL_TILE - K), value=float("inf"))
    live_tiles = int(torch.any(con.reshape(B, nt, pairs.RALL_TILE) < float("inf"), 2).sum())
    live_lanes = (s.lim[1] > s.lim[0]).reshape(B, pairs.BLOCK).sum(1).double()
    per_cand = 33 + C * (MT_FLOPS + 1)
    table_bytes = cl.tri.numel() * 4 + (cl.xf.numel() * 4 if cl.xf is not None else 0)
    bounds = {
        "K2": bound(36.0 * B * K, 4.0 * (B * K + 16 * B + 6 * K)),
        "K3": bound(12.0 * live_tiles * pairs.BLOCK * pairs.RALL_TILE,
                    4.0 * (2 * B * K + 8 * n + 6 * K)),
        "K4": bound(float((walked.double() * live_lanes).sum()) * per_cand,
                    80.0 * n + table_bytes + 8.0 * float(walked.sum())),
        "K6": bound(float((valid.sum(1).double() * live_lanes).sum()) * per_cand,
                    80.0 * n + table_bytes),
    }
    print("pair kernel times at classroom's shapes (closest-hit walk for K4): " + ", ".join(
        f"{k} {a:.4f} ms (plain {b:.4f} ms, bound {bounds[k][0]:.4f} ms by {bounds[k][1]})"
        for k, (a, b) in ms.items()) + f"; K4 tested {int(walked.sum())} candidates "
        f"(mean {float(walked.float().mean()):.1f} per block)", flush=True)

    # independent check: K1 over the fully flattened world soup
    sg = load_scene_json(str(CLASSROOM))
    soup, _, info = flatten_scene(sg)
    tris = [torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
            for a in (soup.v0, soup.e1, soup.e2)]
    hk = k1.intersect_tris(o, d, tmin, tmax, *tris)
    hp = pairs.intersect_pairs(cl, o, d, tmin, tmax)
    both = hk.valid & hp.valid
    rel_t = torch.abs(hk.t - hp.t) / torch.clamp(torch.abs(hk.t), min=1e-30)
    flag_mis = int((hk.valid != hp.valid).sum())
    t_far = both & (rel_t > PAIRS_T_REL)
    t_mis = int(t_far.sum())
    t_mis_inst = int((t_far & (hp.tri_id >= scene.num_tris)).sum())
    print(f"pair sweep vs K1 over the flattened soup ({len(soup.v0)} triangles): hits "
          f"{int(hp.valid.sum())} / {int(hk.valid.sum())}, hit-flag mismatches {flag_mis}, "
          f"t beyond rel {PAIRS_T_REL} on {t_mis} ({t_mis_inst} of them instanced hits of the "
          f"pair sweep), max rel t "
          f"{float(rel_t[both].max()) if bool(both.any()) else 0.0:.3g}", flush=True)
    same, gap, edge = explain_disagreements(o, d, tmin, tmax, hk, hp,
                                            (hk.valid != hp.valid) | t_far, scene, sg, soup, info)
    cross = ~same
    print(f"of the {len(same)} disagreements, {int(same.sum())} hit the same triangle (t gap at "
          f"most {float(gap[same].max()) if same.any() else 0.0:.3g} m) and {int(cross.sum())} "
          f"different surfaces (nearer triangle's edge at most "
          f"{float(np.abs(edge[cross]).max()) if cross.any() else 0.0:.3g} m from the ray)",
          flush=True)
    check(bool(np.all(gap[same] <= PAIRS_T_ABS)), "the pair sweep's t on K1's triangle is off")
    check(int(cross.sum()) <= PAIRS_K1_MAX, "the pair sweep and K1 hit different surfaces too often")
    check(bool(np.all(np.abs(edge[cross]) <= GRAZE_M)),
          "the pair sweep and K1 hit different surfaces on a ray that grazes no edge")

    names = {"K2": ("K2 pair-sweep conservative cull", 195),
             "K3": ("K3 pair-sweep per-ray refine", 333),
             "K4": ("K4 pair-sweep candidate walk", 544),
             "K6": ("K6 one-candidate sweep (K4 kernel, early-out off; on no main path)", 430)}
    entries = {k: {"name": names[k][0], "route": "cuda",
                   "source": "akari_render_tpu_torch/csrc/pairs.cu",
                   "replaces": f"akari_render_tpu/accel/pairs.py:{names[k][1]}",
                   "launches": 0, "max_abs_err": errs[k], "ms": ms[k][0], "plain_ms": ms[k][1],
                   "bound_ms": bounds[k][0], "bound_by": bounds[k][1], "library_ms": None}
               for k in names}
    return entries, {"scene": scene, "cl": cl, "rays": (o, d, tmin, tmax), "ex": (ex0, ex1),
                     "sorted": s, "e_con": e_con, "static_hits": hp}


class windowed_rounds:
    """For a block, collect the windowed walk's rounds: the list it yields
    receives each round's count of live blocks."""

    def __enter__(self):
        from akari_render_tpu_torch.accel import pairs

        self.real, rounds = pairs.windowed_walk, []
        pairs.windowed_walk = lambda *a, **k: self.real(*a, rounds=rounds, **k)
        return rounds

    def __exit__(self, *exc):
        from akari_render_tpu_torch.accel import pairs

        pairs.windowed_walk = self.real


# the cluster tier's traversals: the name the stats report -> its switch
TRAVERSALS = {"pairs-static": {}, "wide": {"AKR_WIDE": "1"},
              "pairs-windowed": {"AKR_PAIRS_STATIC": "0"}}


def classroom_correctness(device, traversal="pairs-static", base=None):
    """Phases 8 and 17: classroom 96^2 16 spp through `traversal` against
    the committed JAX image and ground truth and, where given, against the
    default traversal's image `base`. Returns the image."""
    import numpy as np

    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr

    out = OUT / f"classroom96_{traversal}.exr"
    t0 = time.perf_counter()
    with env_switch(**TRAVERSALS[traversal]):
        stats = cli_main(["-s", str(CLASSROOM), "-m", str(CLASSROOM_METHOD), "--res", "96",
                          "--spp", "16", "-o", str(out), "--device", device])
    wall = time.perf_counter() - t0
    check(stats["traversal"] == traversal, f"classroom 96^2 took the {stats['traversal']} traversal")
    img = read_exr(out)
    jax16 = np.load(ROOT / "akari_render_tpu_torch" / "testdata" / "classroom96_spp16.npy")
    gt = read_exr(CLASSROOM_GT)
    check(img.shape == jax16.shape == gt.shape and bool(np.all(np.isfinite(img))),
          "classroom 96^2 image shape / finiteness")
    m_port, m_jax = img.mean(axis=(0, 1)), jax16.mean(axis=(0, 1))
    mean_rel = float(np.max(np.abs(m_port - m_jax) / np.abs(m_jax)))
    mse_port = float(np.mean((img - gt) ** 2))
    mse_jax = float(np.mean((jax16 - gt) ** 2))
    mse_pj = float(np.mean((img - jax16) ** 2))
    vs_base = "" if base is None else (f", max abs difference from the pairs-static image "
                                       f"{float(np.abs(img - base).max()):.3g}")
    print(f"classroom 96^2 16spp, {traversal} ({wall:.3f} s CLI wall): means port {m_port} jax "
          f"{m_jax} (max rel {mean_rel:.3g}); MSE(port, gt) {mse_port:.6g}, MSE(jax16, gt) "
          f"{mse_jax:.6g}, MSE(port, jax16) {mse_pj:.6g}{vs_base}", flush=True)
    check(mean_rel <= MEAN_TOL, "classroom channel means differ from the JAX image by more than 1%")
    check(mse_port <= MSE_RATIO * mse_jax, "classroom MSE against the ground truth too high")
    return img


def classroom_full_width(device, traversal="pairs-static"):
    """Phases 9 and 18: classroom 1920x1080 1 spp d12 through the CLI with
    `traversal`, every kernel's launches counted around it. Returns the
    launch counts."""
    import numpy as np
    import torch

    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr

    out = OUT / f"classroom1080_{traversal}.exr"
    out.unlink(missing_ok=True)
    torch.cuda.reset_peak_memory_stats()
    with env_switch(**TRAVERSALS[traversal]), windowed_rounds() as rounds:
        reset_launches()
        t0 = time.perf_counter()
        stats = cli_main(["-s", str(CLASSROOM), "-m", str(CLASSROOM_METHOD), "-o", str(out),
                          "--device", device])
        wall = time.perf_counter() - t0
        launches = read_launches()
    check(stats["traversal"] == traversal, f"classroom 1080p took the {stats['traversal']} traversal")
    used = {"pairs-static": ("K2", "K3", "K4"), "wide": ("K7",),
            "pairs-windowed": ("K2", "K4", "K5")}[traversal]
    for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9"):
        check((launches[k] > 0) == (k in used),
              f"classroom 1080p through {traversal} launched {k} {launches[k]} times")
    img = read_exr(out)
    check(img.shape == (1080, 1920, 3) and bool(np.all(np.isfinite(img))),
          "1080p image shape / finiteness")
    paths = 1920 * 1080
    peak = torch.cuda.max_memory_allocated()
    walk = (f", {len(rounds)} rounds of the windowed walk in {launches['K2']} traversals (a host "
            f"read each; {sum(rounds)} live blocks in all)") if traversal == "pairs-windowed" else ""
    print(f"classroom 1920x1080 1spp d12, {traversal}: render {stats['total_time']:.3f} s "
          f"({paths / stats['total_time'] / 1e6:.4f} Mpaths/s), CLI wall {wall:.3f} s, "
          f"launches and counts {launches}{walk}, peak device memory {peak / 2**30:.3f} GiB "
          f"({peak / paths:.0f} B per lane), image mean {img.mean(axis=(0, 1))}", flush=True)
    return launches


def other_traversals_parity(ctx, device):
    """Phase 16: K7 (the wide walk) and K5 (the window refine) against
    their plain versions on phase 7's classroom rays, and both traversals
    against the static pair sweep. Returns the two kernels' JSON entries."""
    import torch

    from akari_render_tpu_torch.accel import pairs, wide

    cl, (o, d, tmin, tmax), (ex0, ex1) = ctx["cl"], ctx["rays"], ctx["ex"]
    hp = ctx["static_hits"]
    n, K, C = o.shape[0], cl.num_clusters, cl.tri.shape[1]
    sw = pairs.sort_rays(cl, o, d, tmin, tmax, ex0, ex1, dead_last=False)
    B = sw.summ.shape[0]

    def walk_args(any_hit):
        return (cl.wide, cl.tri, cl.xf, sw.o_soa, sw.d_soa, sw.lim, sw.ex, sw.best0, any_hit)

    # closest hit (exclusion ids, cut tmax) against the plain rounds; any
    # hit against the plain version at one leaf a round, counts and all
    counts = torch.zeros((B, 2), dtype=torch.int32, device=device)
    got = wide.wide_walk(*walk_args(False), counts=counts)
    want, plain_ms = timed(lambda: wide.wide_walk_torch(*walk_args(False)))
    counts_any = torch.zeros((B, 2), dtype=torch.int32, device=device)
    counts_any_p = torch.zeros((B, 2), dtype=torch.int32, device=device)
    got_any = wide.wide_walk(*walk_args(True), counts=counts_any)
    want_any, plain_ms_any = timed(
        lambda: wide.wide_walk_torch(*walk_args(True), maxc=1, counts=counts_any_p))
    err_k7 = max(max_abs_diff(got, want), max_abs_diff(got_any, want_any))
    print(f"K7 parity at {n} rays ({B} blocks) x {K} candidates ({cl.wide.shape[0]} nodes): "
          f"closest hit, lanes with a hit {int((got[1] >= 0).sum())}, nodes expanded "
          f"{int(counts[:, 0].sum())} (max {int(counts[:, 0].max())} a block), leaves tested "
          f"{int(counts[:, 1].sum())} (max {int(counts[:, 1].max())}); any hit, lanes occluded "
          f"{int((got_any[1] >= 0).sum())}, nodes {int(counts_any[:, 0].sum())}, leaves "
          f"{int(counts_any[:, 1].sum())}; max abs err {err_k7}", flush=True)
    check(torch.equal(got, want), "K7 (closest hit) differs from its plain version")
    check(torch.equal(got_any, want_any), "K7 (any hit) differs from its plain version")
    check(torch.equal(counts_any, counts_any_p),
          "K7's nodes expanded / leaves tested differ from the plain version's at one leaf a round")

    # both traversals against the static pair sweep, no exclusions
    hw = wide.intersect_wide(cl, o, d, tmin, tmax)
    with env_switch(AKR_PAIRS_STATIC="0"), windowed_rounds() as rounds:
        hwin = pairs.intersect_pairs(cl, o, d, tmin, tmax)
    for name, h in (("wide walk", hw), ("windowed walk", hwin)):
        id_mis = hp.valid & (h.tri_id != hp.tri_id)
        print(f"{name} vs the static pair sweep: hits {int(h.valid.sum())} / "
              f"{int(hp.valid.sum())}, valid equal {torch.equal(h.valid, hp.valid)}, t bit-equal "
              f"{torch.equal(h.t, hp.t)}, ids differ on {int(id_mis.sum())} rays (exact t ties "
              f"between two candidates)" + (f"; {len(rounds)} rounds" if h is hwin else ""),
              flush=True)
        check(torch.equal(h.valid, hp.valid) and torch.equal(h.t, hp.t),
              f"the {name}'s valid or t differs from the static pair sweep's")
        check(bool(torch.equal(h.bary[~id_mis], hp.bary[~id_mis])),
              f"the {name}'s u, v differ from the static pair sweep's on the same triangle")
    check(torch.equal(hwin.tri_id, hp.tri_id), "the windowed walk's ids differ from the static walk's")

    # K5 on the first round's window of the windowed traversal of phase 7's
    # sorted blocks (exclusion ids do not reach it)
    s7, calls, real_refine = ctx["sorted"], [], pairs.refine

    def capture(*args):
        if not calls:
            calls.append(tuple(a.clone() for a in args))
        return real_refine(*args)

    pairs.refine = capture
    try:
        pairs.windowed_walk(cl, s7, ctx["e_con"], False)
    finally:
        pairs.refine = real_refine
    check(len(calls) == 1, "the windowed walk made no K5 call")
    k5_args = calls[0]
    wb = k5_args[0]
    W = wb.shape[2]
    passed = pairs.refine(*k5_args)
    passed_p, plain_ms_k5 = timed(lambda: pairs.refine_torch(*k5_args))
    err_k5 = max_abs_diff(passed.float(), passed_p.float())
    print(f"K5 parity on the first window of the windowed walk ({tuple(wb.shape)}): members "
          f"that pass {float(passed.float().mean()):.4f}; max abs err {err_k5}", flush=True)
    check(tuple(wb.shape) == (B, 6, pairs.MAXC * pairs.WINDOW_MULT), "K5's window shape")
    check(torch.equal(passed, passed_p), "K5 differs from its plain version")

    ms_k7 = cuda_ms(lambda: wide.wide_walk(*walk_args(False)), 5)
    ms_k7_any = cuda_ms(lambda: wide.wide_walk(*walk_args(True)), 5)
    ms_k5 = cuda_ms(lambda: pairs.refine(*k5_args), 20)
    # bounds. K7: per live lane 8 slab tests (12 operations each) a node
    # expanded and a ray transform (33) plus C triangle tests (MT_FLOPS + 1)
    # a leaf tested; it reads each lane's 16 floats, the node table and the
    # triangle and transform tables once, and writes 4 floats a lane. K5:
    # one slab test for a member that passes (the lane that passes), one
    # per live lane for a member that fails; it reads the window and the
    # lanes' 8 floats and writes an int a member.
    live_w = (sw.lim[1] > sw.lim[0]).reshape(B, pairs.BLOCK).sum(1).double()
    table_bytes = (cl.tri.numel() + cl.wide.numel()
                   + (cl.xf.numel() if cl.xf is not None else 0)) * 4
    ops_k7 = float((live_w * (counts[:, 0].double() * 96
                              + counts[:, 1].double() * (33 + C * (MT_FLOPS + 1)))).sum())
    b_k7 = bound(ops_k7, 80.0 * n + table_bytes)
    live_7 = (k5_args[3][1] > k5_args[3][0]).reshape(B, pairs.BLOCK).sum(1).double()
    ops_k5 = 12.0 * float(torch.where(passed > 0, 1.0, live_7[:, None]).sum())
    b_k5 = bound(ops_k5, 4.0 * (7 * B * W + 8 * n))
    print(f"K7 at classroom's shapes: closest hit {ms_k7:.4f} ms (plain {plain_ms:.4f} ms, bound "
          f"{b_k7[0]:.4f} ms by {b_k7[1]}: {ops_k7:.4g} FP32 operations), any hit {ms_k7_any:.4f} "
          f"ms (plain, one leaf a round, {plain_ms_any:.4f} ms); K5 {ms_k5:.4f} ms (plain "
          f"{plain_ms_k5:.4f} ms, bound {b_k5[0]:.4f} ms by {b_k5[1]}: {ops_k5:.4g} FP32 "
          f"operations)", flush=True)
    common = {"route": "cuda", "launches": 0, "library_ms": None}
    return {
        "K5": {"name": "K5 windowed walk's window refine",
               "source": "akari_render_tpu_torch/csrc/pairs.cu",
               "replaces": "akari_render_tpu/accel/pairs.py:267", "max_abs_err": err_k5,
               "ms": ms_k5, "plain_ms": plain_ms_k5, "bound_ms": b_k5[0], "bound_by": b_k5[1],
               **common},
        "K7": {"name": "K7 wide-BVH walk (with the leaf test)",
               "source": "akari_render_tpu_torch/csrc/wide.cu",
               "replaces": "akari_render_tpu/accel/wide.py:187", "max_abs_err": err_k7,
               "ms": ms_k7, "plain_ms": plain_ms, "bound_ms": b_k7[0], "bound_by": b_k7[1],
               **common},
    }


def blinds_setup(device):
    """(scene, task, PTSettings, filter) of blinds at its own 256x256 with
    scenes/blinds/pt.json."""
    from akari_render_tpu_torch.config import RenderTask
    from akari_render_tpu_torch.core.filters import filter_from_config
    from akari_render_tpu_torch.integrators.common import PTSettings
    from akari_render_tpu_torch.scene import load_scene

    task = RenderTask.from_file(BLINDS_METHOD)
    m = task.method
    settings = PTSettings(max_depth=m.max_depth, rr_depth=m.rr_depth, use_nee=m.use_nee,
                          clamp_indirect=m.clamp_indirect)
    scene = load_scene(str(BLINDS), device=device)
    return scene, task, settings, filter_from_config(task.filter_config)


def path_b_bounce(device):
    """The arguments of K9's first call in one path-B sample of blinds at
    its own 256x256 with scenes/blinds/pt.json: the live lanes of the first
    bounce, as the main path hands them to fused_shade."""
    import torch

    from akari_render_tpu_torch.integrators import common
    from akari_render_tpu_torch.integrators.pt import render_sample

    scene, task, settings, filt = blinds_setup(device)
    real, calls = common.fused_shade, []

    def capture(*args):
        if not calls:
            calls.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return real(*args)

    common.fused_shade = capture
    try:
        with env_switch(AKR_PALLAS_SHADE="1"):
            render_sample(scene, settings, filt, 0, task.seed, task.sampler)
    finally:
        common.fused_shade = real
    check(len(calls) == 1, "a path-B sample of blinds made no K9 call")
    return calls[0]


def k9_check(label: str, args) -> dict:
    """K9 against its plain version on one set of fused_shade arguments,
    with CUDA event timings; returns its numbers for the JSON line."""
    import torch

    from akari_render_tpu_torch.integrators import fused_shade as fs

    lanes = args[1].shape[0]
    got = fs.fused_shade(*args)
    want = fs.fused_shade_torch(*args)
    torch.cuda.synchronize()
    same = got["valid"] == want["valid"]
    valid_mis = int((~same).sum())
    max_abs, max_rel = 0.0, 0.0
    for k in ("direct", "wi", "f", "pdf", "albedo"):
        g, w = got[k], want[k]
        if k in ("wi", "f", "pdf"):  # a flipped sample draws another direction
            g, w = g[same], w[same]
        max_abs = max(max_abs, max_abs_diff(g, w))
        diff = torch.where(g == w, 0.0, torch.abs(g - w) / torch.clamp(torch.abs(w), min=1e-30))
        max_rel = max(max_rel, float(torch.nan_to_num(diff, nan=float("inf")).max()))
    ms = cuda_ms(lambda: fs.fused_shade(*args), 20)
    plain_ms = cuda_ms(lambda: fs.fused_shade_torch(*args), 3)
    # 26 values in (104 B) and 13 floats plus a bool out (53 B) per lane,
    # the material table once
    bound_ms, bound_by = bound(0.0, lanes * 157.0 + args[0][0].numel() * 4)
    print(f"K9 parity on {label} ({lanes} lanes): valid "
          f"{float(want['valid'].float().mean()):.4f}, valid mismatches {valid_mis}, max rel err "
          f"{max_rel:.3g}, max abs err {max_abs:.3g}; kernel {ms:.4f} ms (plain {plain_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms by {bound_by})", flush=True)
    check(valid_mis <= K9_VALID_FRAC * lanes, f"K9 valid differs on {valid_mis} lanes")
    check(max_rel <= K9_REL, f"K9 disagrees with its plain version on {label}")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def k9_parity(device):
    """Phase 11: K9 against its plain version on the live lanes of a real
    path-B bounce at 256^2 and on 2^18 seeded blinds shade inputs. Returns
    the kernel's JSON entry, timed at the path-B bounce."""
    import numpy as np
    import torch

    scene, _, _, _ = blinds_setup(device)
    check(scene.shade_bake is not None, "blinds must bake into the reduced closure")
    n = N_RAYS
    rng = np.random.default_rng(13)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    def unit():
        v = rng.normal(size=(n, 3))
        return t(v / np.linalg.norm(v, axis=-1, keepdims=True))

    si = scene.surface_interaction(t(rng.integers(0, scene.num_tris, n), torch.int64),
                                   t(rng.random((n, 2)) * 0.45))
    synthetic = (scene.shade_bake, *(f.contiguous() for f in si["frame"]), si["ng"].contiguous(),
                 unit(), unit(), t(rng.random((n, 3)) * 3.0), t(rng.random(n) * 2.0 + 1e-3),
                 t(rng.random((n, 3))), si["mat"])
    main = k9_check("the live lanes of a path-B bounce at 256^2", path_b_bounce(device))
    seeded = k9_check("seeded blinds inputs", synthetic)
    main["max_abs_err"] = max(main["max_abs_err"], seeded["max_abs_err"])
    return {"name": "K9 fused shade", "route": "cuda",
            "source": "akari_render_tpu_torch/csrc/fused_shade.cu",
            "replaces": "akari_render_tpu/integrators/pallas_shade.py:85", **main,
            "library_ms": None}


def k8_parity(device):
    """Phase 12: one K8 pass of the main path (blinds 256^2, 16 spp, d12)
    against its plain version per pixel and on the rays each traced, with
    the time of each. Returns the kernel's JSON entry."""
    import torch

    from akari_render_tpu_torch.integrators import megakernel as mk

    scene, task, settings, filt = blinds_setup(device)
    check(mk.megakernel_eligible(scene, settings, task.sampler, filt),
          "blinds must be megakernel-eligible")
    tb = mk.pass_tables(scene, settings, filt, task.seed)
    spp = task.method.spp_per_pass
    rk = torch.zeros(2, dtype=torch.int64, device=device)
    rp = torch.zeros(2, dtype=torch.int64, device=device)
    got = mk.megakernel_pass(tb, 0, spp, rk)
    want, plain_ms = timed(lambda: mk.megakernel_pass_torch(tb, 0, spp, rp))
    diff = torch.abs(got - want)
    bad = (diff > K8_ATOL + K8_RTOL * torch.abs(want)).any(0)
    bad_frac = float(bad.float().mean())
    mean_rel = float((torch.abs(got[:3].mean(1) - want[:3].mean(1))
                      / torch.abs(want[:3].mean(1))).max())
    max_abs = max_abs_diff(got, want)
    print(f"K8 parity at {tb.width}^2 {spp} spp d{tb.max_depth}: pixels outside rtol {K8_RTOL} "
          f"atol {K8_ATOL}: {int(bad.sum())} ({bad_frac:.3g}), channel means within "
          f"{mean_rel:.3g}, max abs err {max_abs:.3g}; rays traced kernel {rk.tolist()} plain "
          f"{rp.tolist()} (closest, shadow)", flush=True)
    check(bool(torch.isfinite(got).all()), "K8 output not finite")
    check(bad_frac == 0.0 or (bad_frac <= K8_PIX_FRAC and mean_rel <= K8_MEAN_REL),
          "K8 disagrees with its plain version")
    check(torch.equal(rk, rp), "K8 and its plain version traced different numbers of rays")

    ms = cuda_ms(lambda: mk.megakernel_pass(tb, 0, spp), 10)
    n_rays = int(rk.sum())
    T = scene.num_tris
    ops = float(n_rays) * T * MT_FLOPS
    table_bytes = sum(x.numel() * 4 for x in (tb.attr, tb.ce, tb.lsel, tb.loff, tb.ltab, tb.mat))
    bound_ms, bound_by = bound(ops, table_bytes + 16.0 * tb.npix)
    print(f"K8 at {tb.width}^2, {spp} spp, d{tb.max_depth}: {ms:.4f} ms per pass (plain "
          f"{plain_ms:.4f} ms, the parity call); {n_rays} rays traced x {T} triangles x "
          f"{MT_FLOPS} = {ops:.4g} FP32 operations: bound {bound_ms:.4f} ms by {bound_by}",
          flush=True)
    return {"name": "K8 path megakernel", "route": "cuda",
            "source": "akari_render_tpu_torch/csrc/megakernel.cu",
            "replaces": "akari_render_tpu/integrators/megakernel.py:445",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


class env_switch:
    """Set environment switches for a block, then restore them."""

    def __init__(self, **kv):
        self.kv = kv

    def __enter__(self):
        import os

        self.old = {k: os.environ.get(k) for k in self.kv}
        os.environ.update(self.kv)

    def __exit__(self, *exc):
        import os

        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# the two fused paths: (name, switch, shade the CLI reports, JAX image of its tier)
FUSED_PATHS = (("path A", "AKR_MEGAKERNEL", "megakernel (K8)", "blinds64_mk_spp16.npy"),
               ("path B", "AKR_PALLAS_SHADE", "fused (K9)", "blinds64_spp16.npy"))


def blinds_correctness(device):
    """Phase 13: paths A and B at 64^2, 16 spp through the CLI against the
    committed JAX images of their tiers and the JAX 256-spp image."""
    import numpy as np

    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr

    testdata = ROOT / "akari_render_tpu_torch" / "testdata"
    gt = np.load(testdata / "blinds64_spp256.npy")
    for name, switch, shade, ref in FUSED_PATHS:
        out = OUT / f"blinds64_{name[-1]}.exr"
        with env_switch(**{switch: "1"}):
            stats = cli_main(["-s", str(BLINDS), "-m", str(BLINDS_METHOD), "--res", "64",
                              "--spp", "16", "-o", str(out), "--device", device])
        check(stats["shade"] == shade, f"{name} took the {stats['shade']} shade")
        img = read_exr(out)
        jax16 = np.load(testdata / ref)
        check(img.shape == jax16.shape == gt.shape and bool(np.all(np.isfinite(img))),
              f"blinds 64^2 {name} image shape / finiteness")
        m_port, m_jax = img.mean(axis=(0, 1)), jax16.mean(axis=(0, 1))
        mean_rel = float(np.max(np.abs(m_port - m_jax) / np.abs(m_jax)))
        mse_port = float(np.mean((img - gt) ** 2))
        mse_jax = float(np.mean((jax16 - gt) ** 2))
        print(f"blinds 64^2 16spp {name} ({stats['tier']}, {shade}): means port {m_port} jax "
              f"{m_jax} (max rel {mean_rel:.3g}); MSE(port, jax256) {mse_port:.6g}, MSE(jax16, "
              f"jax256) {mse_jax:.6g}, MSE(port, jax16) {float(np.mean((img - jax16) ** 2)):.6g}",
              flush=True)
        check(mean_rel <= MEAN_TOL, f"blinds {name} means differ from the JAX image by more than 1%")
        check(mse_port <= MSE_RATIO * mse_jax, f"blinds {name} MSE against the JAX 256-spp image too high")


def reset_launches():
    """Every kernel's launch count, and the bounce loop's counts, to 0."""
    from akari_render_tpu_torch.accel import intersect as k1
    from akari_render_tpu_torch.accel import pairs, wide
    from akari_render_tpu_torch.integrators import common
    from akari_render_tpu_torch.integrators import fused_shade as fs
    from akari_render_tpu_torch.integrators import megakernel as mk

    k1.launches = mk.launches = fs.launches = 0
    for counts in (pairs.launches, wide.launches):
        for k in counts:
            counts[k] = 0
    common.counts.update(bounces=0, dispatch_groups=0)


def read_launches() -> dict:
    from akari_render_tpu_torch.accel import intersect as k1
    from akari_render_tpu_torch.accel import pairs, wide
    from akari_render_tpu_torch.integrators import common
    from akari_render_tpu_torch.integrators import fused_shade as fs
    from akari_render_tpu_torch.integrators import megakernel as mk

    return {"K1": k1.launches, **pairs.launches, **wide.launches, "K8": mk.launches,
            "K9": fs.launches, **common.counts}


def device_events_per_call(calls: dict) -> dict:
    """Device events (kernels, copies, fills) of one call of each fn in
    `calls` (name -> fn, each called once before, as a warm-up), by
    torch.profiler in one window, where a marker kernel (spin_kernel)
    opens each call's span. One window: this torch build drops the first
    device events of a window that follows earlier large windows
    (measured on the card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    t1 = time.perf_counter()
    # the raw kineto records: prof.events() would first build the
    # profiler's Python event tree over every record
    events = sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CUDA)
    print(f"profiler window {t1 - t0:.1f} s, {len(events)} device records read in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    counts = []
    for _, name in events:
        if "spin_kernel" in name:
            counts.append(0)
        elif counts:
            counts[-1] += 1
    check(len(counts) == len(calls), "the profiler lost a marker kernel")
    return dict(zip(calls, counts))


def blinds_full_width(device):
    """Phase 14: blinds 256^2, d12 through the CLI: path B and path A at
    scenes/blinds/pt.json's 64 spp, and the wavefront with the dispatch at
    one 16-spp pass, each with every launch count read around it. Returns
    the K8 and K9 launches of their paths."""
    import numpy as np

    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr
    from akari_render_tpu_torch.integrators import megakernel as mk
    from akari_render_tpu_torch.integrators.pt import render_sample

    scene, task, settings, filt = blinds_setup(device)
    tb = mk.pass_tables(scene, settings, filt, task.seed)
    m = task.method
    found = {}
    for name, switch, shade, spp in (("wavefront", None, "dispatch", m.spp_per_pass),
                                     ("path B", "AKR_PALLAS_SHADE", "fused (K9)", m.spp),
                                     ("path A", "AKR_MEGAKERNEL", "megakernel (K8)", m.spp)):
        out = OUT / f"blinds256_{name.replace(' ', '_')}.exr"
        out.unlink(missing_ok=True)
        with env_switch(**({switch: "1"} if switch else {})):
            reset_launches()
            t0 = time.perf_counter()
            stats = cli_main(["-s", str(BLINDS), "-m", str(BLINDS_METHOD), "--spp", str(spp),
                              "-o", str(out), "--device", device])
            wall = time.perf_counter() - t0
            got = read_launches()
        img = read_exr(out)
        check(img.shape == (256, 256, 3) and bool(np.all(np.isfinite(img))),
              f"blinds 256^2 {name} image shape / finiteness")
        check(stats["shade"] == shade, f"blinds 256^2 {name} took the {stats['shade']} shade")
        check(stats["spp_total"] == spp, f"blinds 256^2 {name} rendered {stats['spp_total']} spp")
        paths = scene.camera.width * scene.camera.height * spp
        print(f"blinds 256^2 {spp}spp d{m.max_depth} {name} ({stats['tier']}, {shade}): render "
              f"{stats['total_time']:.4f} s ({paths / stats['total_time'] / 1e6:.4f} Mpaths/s), "
              f"CLI wall {wall:.3f} s, launches and counts {got}, image mean "
              f"{img.mean(axis=(0, 1))}", flush=True)
        if name == "wavefront":
            check(got["K1"] > 0 and got["K8"] == 0 and got["K9"] == 0
                  and got["dispatch_groups"] > 0, "the wavefront path's launches")
        elif name == "path B":
            # a bounce whose lanes all missed has nothing to shade
            check(0 < got["K9"] <= got["bounces"], "path B must launch K9 at most once per bounce")
            check(got["dispatch_groups"] == 0 and got["K8"] == 0,
                  "path B shaded lanes through the dispatch")
            found["K9"] = got["K9"]
        else:
            passes = -(-spp // m.spp_per_pass)
            check(stats["tier"] == "megakernel" and got["K8"] == passes,
                  "path A must launch K8 once per pass")
            check(got["K1"] == got["K9"] == got["bounces"] == 0, "path A ran another kernel")
            found["K8"] = got["K8"]

    def wavefront_sample(switch=None):
        def fn():
            with env_switch(**({switch: "1"} if switch else {})):
                render_sample(scene, settings, filt, 0, task.seed, task.sampler)
        return fn

    t0 = time.perf_counter()
    events = device_events_per_call({
        "wavefront": wavefront_sample(), "path B": wavefront_sample("AKR_PALLAS_SHADE"),
        "path A": lambda: mk.megakernel_pass(tb, 0, 1)})  # a sample is a one-sample pass
    print(f"blinds 256^2 device events per sample (torch.profiler, device activity only; "
          f"{time.perf_counter() - t0:.1f} s): {events}", flush=True)
    check(events["path A"] == 1, "path A's sample must be one device event")
    return found


def build_all():
    """Phases 2, 6, 10 and 15: one nvcc per kernel source, started together."""
    from akari_render_tpu_torch.accel import intersect as k1
    from akari_render_tpu_torch.accel import pairs, wide
    from akari_render_tpu_torch.integrators import fused_shade as fs
    from akari_render_tpu_torch.integrators import megakernel as mk

    errors = []

    def run(build):
        try:
            build()
        except Exception as e:  # re-raised below, after both builds end
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(b,))
               for b in (k1.build, pairs.build, wide.build, mk.build, fs.build)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    wall = time.perf_counter() - t0
    print(f"K1 build: nvcc {k1.build_seconds:.3f} s", flush=True)
    print(f"K2-K6 build: nvcc {pairs.build_seconds:.3f} s; K7 build: nvcc "
          f"{wide.build_seconds:.3f} s", flush=True)
    print(f"K8 build: nvcc {mk.build_seconds:.3f} s; K9 build: nvcc {fs.build_seconds:.3f} s "
          f"({wall:.3f} s for the five builds, in parallel)", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    from akari_render_tpu_torch.core.math import disable_tf32
    from akari_render_tpu_torch.scene import load_scene

    query = gpu_query()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} ({query}); torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    disable_tf32()
    device = "cuda"
    OUT.mkdir(parents=True, exist_ok=True)

    build_all()
    lap("phases 2, 6, 10 and 15 (build)")
    scene = load_scene(str(SCENE), device=device)
    entry = k1_parity(scene, device)
    pcg_parity(device)
    lap("phase 3 (K1 parity)")
    slice_correctness(device)
    lap("phase 4 (matbox 64^2)")
    entry["launches"] = full_width(device)
    lap("phase 5 (matbox 512^2)")

    pair_entries, ctx = pairs_parity(device)
    lap("phase 7 (K2/K3/K4/K6 parity)")
    other = other_traversals_parity(ctx, device)
    del ctx  # its tensors would count in the renders' peak memory
    lap("phase 16 (K7 and K5 parity)")
    base96 = classroom_correctness(device)
    lap("phase 8 (classroom 96^2)")
    for k, c in classroom_full_width(device).items():
        if k in ("K2", "K3", "K4"):
            pair_entries[k]["launches"] = c
    lap("phase 9 (classroom 1080p)")
    for traversal in ("wide", "pairs-windowed"):
        classroom_correctness(device, traversal, base96)
    lap("phase 17 (classroom 96^2, wide and windowed)")
    other["K7"]["launches"] = classroom_full_width(device, "wide")["K7"]
    other["K5"]["launches"] = classroom_full_width(device, "pairs-windowed")["K5"]
    lap("phase 18 (classroom 1080p, wide and windowed)")

    fused = {"K9": k9_parity(device)}
    lap("phase 11 (K9 parity)")
    fused["K8"] = k8_parity(device)
    lap("phase 12 (K8 parity)")
    blinds_correctness(device)
    lap("phase 13 (blinds 64^2)")
    for k, c in blinds_full_width(device).items():
        fused[k]["launches"] = c
    lap("phase 14 (blinds 256^2)")

    print(json.dumps({"kernels": [entry, *pair_entries.values(), other["K5"], other["K7"],
                                  fused["K8"], fused["K9"]]}))
    print(gpu_query())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
