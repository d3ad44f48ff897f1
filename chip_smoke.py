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
   counted.

It prints a JSON line of kernel results, the card's name and power limit,
and last a JSON line {"ok": true, "device": {...}}.
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
    Returns the three kernels' JSON entries."""
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
    e_init_p = pairs.refine_all_torch(cb6, s.o_soa, s.inv_soa, s.lim, e_con)
    order = pairs.walk_order(e_init)
    walks = {}
    for mode, sr, any_hit in (("closest", s, False), ("any hit", s, True),
                              ("any_hit_mask", s_mask, False)):
        args = (*order, cl.tri_row, cl.tri, cl.xf, sr.o_soa, sr.d_soa, sr.lim, sr.ex, sr.best0,
                any_hit)
        walks[mode] = (pairs.sweep_walk(*args), pairs.sweep_walk_torch(*args))
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
    ms = {
        "K2": (cuda_ms(lambda: pairs.cull_einit(s.summ, cb6), 20),
               cuda_ms(lambda: pairs.cull_einit_torch(s.summ, cb6), 3)),
        "K3": (cuda_ms(lambda: pairs.refine_all(cb6, s.o_soa, s.inv_soa, s.lim, e_con), 20),
               cuda_ms(lambda: pairs.refine_all_torch(cb6, s.o_soa, s.inv_soa, s.lim, e_con), 2)),
        "K4": (cuda_ms(lambda: pairs.sweep_walk(*walk_args), 5),
               cuda_ms(lambda: pairs.sweep_walk_torch(*walk_args), 1)),
    }
    print("pair kernel times at classroom's shapes (closest-hit walk for K4): " + ", ".join(
        f"{k} {a:.4f} ms (plain {b:.4f} ms)" for k, (a, b) in ms.items()), flush=True)

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

    names = {"K2": ("K2 pair-sweep conservative cull", "_cull_kernel", 195),
             "K3": ("K3 pair-sweep per-ray refine", "_refine_all_kernel", 333),
             "K4": ("K4 pair-sweep candidate walk", "_sweep_ent_kernel", 544)}
    return {k: {"name": names[k][0], "route": "cuda",
                "source": "akari_render_tpu_torch/csrc/pairs.cu",
                "replaces": f"akari_render_tpu/accel/pairs.py:{names[k][2]}",
                "max_abs_err": errs[k], "ms": ms[k][0], "plain_ms": ms[k][1]}
            for k in names}


def classroom_correctness(device):
    """Phase 8: classroom 96^2 16 spp against the committed JAX image and
    ground truth."""
    import numpy as np

    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr

    out = OUT / "classroom96.exr"
    t0 = time.perf_counter()
    cli_main(["-s", str(CLASSROOM), "-m", str(CLASSROOM_METHOD), "--res", "96", "--spp", "16",
              "-o", str(out), "--device", device])
    wall = time.perf_counter() - t0
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
    print(f"classroom 96^2 16spp ({wall:.3f} s CLI wall): means port {m_port} jax {m_jax} "
          f"(max rel {mean_rel:.3g}); MSE(port, gt) {mse_port:.6g}, MSE(jax16, gt) "
          f"{mse_jax:.6g}, MSE(port, jax16) {mse_pj:.6g}", flush=True)
    check(mean_rel <= MEAN_TOL, "classroom channel means differ from the JAX image by more than 1%")
    check(mse_port <= MSE_RATIO * mse_jax, "classroom MSE against the ground truth too high")


def classroom_full_width(device):
    """Phase 9: classroom 1920x1080 1 spp d12 through the CLI, K2/K3/K4
    launches counted. Returns the launch counts."""
    import numpy as np
    import torch

    from akari_render_tpu_torch.accel import pairs
    from akari_render_tpu_torch.cli import main as cli_main
    from akari_render_tpu_torch.core.image_io import read_exr

    out = OUT / "classroom1080.exr"
    out.unlink(missing_ok=True)
    torch.cuda.reset_peak_memory_stats()
    for k in pairs.launches:
        pairs.launches[k] = 0
    t0 = time.perf_counter()
    stats = cli_main(["-s", str(CLASSROOM), "-m", str(CLASSROOM_METHOD), "-o", str(out),
                      "--device", device])
    wall = time.perf_counter() - t0
    launches = dict(pairs.launches)
    for k, c in launches.items():
        check(c > 0, f"the cluster-tier path launched {k} no time")
    img = read_exr(out)
    check(img.shape == (1080, 1920, 3) and bool(np.all(np.isfinite(img))),
          "1080p image shape / finiteness")
    paths = 1920 * 1080
    peak = torch.cuda.max_memory_allocated()
    print(f"classroom 1920x1080 1spp d12: render {stats['total_time']:.3f} s "
          f"({paths / stats['total_time'] / 1e6:.4f} Mpaths/s), CLI wall {wall:.3f} s, "
          f"launches {launches}, peak device memory {peak / 2**30:.3f} GiB "
          f"({peak / paths:.0f} B per lane), image mean {img.mean(axis=(0, 1))}", flush=True)
    return launches


def build_all():
    """Phases 2 and 6: one nvcc per kernel source, started together."""
    from akari_render_tpu_torch.accel import intersect as k1
    from akari_render_tpu_torch.accel import pairs

    errors = []

    def run(build):
        try:
            build()
        except Exception as e:  # re-raised below, after both builds end
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(b,)) for b in (k1.build, pairs.build)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    wall = time.perf_counter() - t0
    print(f"K1 build: nvcc {k1.build_seconds:.3f} s", flush=True)
    print(f"K2/K3/K4 build: nvcc {pairs.build_seconds:.3f} s ({wall:.3f} s for both builds, "
          f"in parallel)", flush=True)


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
    scene = load_scene(str(SCENE), device=device)
    entry = k1_parity(scene, device)
    pcg_parity(device)
    slice_correctness(device)
    entry["launches"] = full_width(device)

    pair_entries = pairs_parity(device)
    classroom_correctness(device)
    for k, c in classroom_full_width(device).items():
        pair_entries[k]["launches"] = c

    print(json.dumps({"kernels": [entry, *pair_entries.values()]}))
    print(gpu_query())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
