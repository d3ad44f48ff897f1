"""Time the flat tier's K1 (matbox and blinds, chip_smoke.py's 2^18 rays),
the cluster tier's cull (K2: at those classroom rays' 512 blocks, and the
first launch of a classroom 1080p sample, by device time), refine with its
walk order (K3: in a parent without the fused kernel, refine_all then
walk_order) and its walks (K4 and K7, closest and any hit) at
chip_smoke.py's 2^18 classroom rays, the windowed walk's window refine (K5:
the first window of those rays' windowed walk, and the first window of a
classroom 1080p sample's first traversal; a parent whose K5 took the
gathered [B, 6, W] window, `refine`, gets that), the path megakernel (K8: a
blinds 256^2, 16-spp pass) and the shade of a path-B bounce (K9: the
bounce loop's `_fused_shade_live` on the first bounce of a blinds 256^2
sample, 65,536 lanes; its device events a call and their device time, and
the kernel's alone) in two or more checkouts of this repo, within one run
on one card: the way to compare a change with its parent. K5 is also timed
by its device records (torch.profiler), and each checkout reports K5's and
K8's registers, local memory and resident blocks.

    python tools/ab_walks.py PARENT . . PARENT [--reps 20] [--only k2,k9]
        [--variants]

Each checkout (a directory holding chip_smoke.py and the package, e.g. made
with `git archive`) runs in a process of its own, builds its own kernels and
times each walk twice with CUDA events. `--only` names the kernels to time
(default: all). `--variants` then times K2 and K9 in this checkout with one
design step changed, from a patched copy of csrc/ under build/variants/
(every replacement must find its text): K2 without its
dead-block and sign cases (the tiles alone), and tiles of 8 or 32 blocks
(not 16), and K9 held to 8 resident blocks by `__launch_bounds__` (64
registers); a variant must give the as-built result bit for bit
(K2_bits_differ 0, K9_out as built). Prints one
JSON line per checkout and variant, then the card's name and power limit.
Needs one NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

# runs with a checkout's root as argv[1], the reps, the kernels to time and
# a variant name ("" for none); the walks' box argument changed its name and
# content between checkouts, so it is looked up
CHILD = r"""
import json, os, shutil, sys
from pathlib import Path
import torch
root, reps, only, variant = sys.argv[1], int(sys.argv[2]), sys.argv[3].split(","), sys.argv[4]
sys.path.insert(0, root)
import chip_smoke
from akari_render_tpu_torch.accel import intersect as k1
from akari_render_tpu_torch.accel import nvcc, pairs, wide
from akari_render_tpu_torch.core.math import RAY_TMAX, disable_tf32
from akari_render_tpu_torch.integrators import common
from akari_render_tpu_torch.integrators import fused_shade as fs
from akari_render_tpu_torch.integrators import megakernel as mk
from akari_render_tpu_torch.scene import load_scene

disable_tf32()
VARIANTS = {
    "k2_tiles_only": ("pairs.cu", "constexpr bool kCullCases = true;",
                      "constexpr bool kCullCases = false;"),
    "k2_8_blocks": ("pairs.cu", "constexpr int kCullBlocks = 16;", "constexpr int kCullBlocks = 8;"),
    "k2_32_blocks": ("pairs.cu", "constexpr int kCullBlocks = 16;",
                     "constexpr int kCullBlocks = 32;"),
    "k9_8_blocks": ("fused_shade.cu", "__launch_bounds__(kThreads) fused_shade_kernel",
                    "__launch_bounds__(kThreads, 8) fused_shade_kernel"),
}
row = {"root": root}
if variant:  # a patched copy of csrc/, for the wrappers of K2 to K9
    fname, old, new = VARIANTS[variant]
    dst = Path(root) / "build" / "variants" / variant
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(Path(root) / "akari_render_tpu_torch" / "csrc", dst)
    text = (dst / fname).read_text()
    if text.count(old) != 1:
        raise SystemExit(f"variant {variant}: {fname} holds {text.count(old)} times: {old!r}")
    (dst / fname).write_text(text.replace(old, new))
    nvcc.CSRC, pairs.SOURCE, fs.SOURCE = dst, dst / "pairs.cu", dst / "fused_shade.cu"
    row["variant"] = variant


def pad():
    x = torch.empty(1, device="cuda")
    for _ in range(1024):
        x.add_(1.0)
    torch.cuda.synchronize()


def span(fn, n, kernel):
    # one call of fn warms up; then, under torch.profiler, padded at both ends
    # (records at a window's ends may be lost), a marker kernel, n calls and
    # another marker: (device events a call, their device ms a call, the
    # device ms of `kernel`'s launches a call)
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad()
        torch.cuda._sleep(1_000_000)
        for _ in range(n):
            fn()
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        pad()
    ev = sorted((e.start_ns(), e.duration_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA)
    marks = [i for i, e in enumerate(ev) if "spin_kernel" in e[2]]
    if len(marks) != 2:
        return None, None, None
    inside = ev[marks[0] + 1:marks[1]]
    return (len(inside) / n, sum(e[1] for e in inside) / n / 1e6,
            sum(e[1] for e in inside if kernel in e[2]) / n / 1e6)


def device_ms(fn, n, kernel):
    v = span(fn, n, kernel)[2]
    return v if v is not None else float("nan")


class Captured(Exception):
    pass


def first_call(module, name, run, clone=True):
    # the arguments of the first call of module.name that run() makes; the
    # run ends there
    real, calls = getattr(module, name), []

    def capture(*a, **kw):
        calls.append(tuple(x.clone() if clone and torch.is_tensor(x) else x for x in a))
        raise Captured

    setattr(module, name, capture)
    try:
        run()
    except Captured:
        pass
    finally:
        setattr(module, name, real)
    return calls[0]


def sample(scene, method, switches):
    from akari_render_tpu_torch.config import RenderTask
    from akari_render_tpu_torch.core.filters import filter_from_config
    from akari_render_tpu_torch.integrators.common import PTSettings
    from akari_render_tpu_torch.integrators.pt import render_sample

    task = RenderTask.from_file(method)
    m = task.method
    st = PTSettings(max_depth=m.max_depth, rr_depth=m.rr_depth, use_nee=m.use_nee,
                    clamp_indirect=m.clamp_indirect)

    def run():
        with chip_smoke.env_switch(**switches):
            render_sample(scene, st, filter_from_config(task.filter_config), 0, task.seed,
                          task.sampler)
    return run


def timing(name, fn):
    row.setdefault(name, []).append(round(chip_smoke.cuda_ms(fn, reps), 4))


def flat_rays(sc, n=1 << 18, seed=7):
    # n / 2 jittered camera rays and n / 2 rays from inside the soup's box
    import numpy as np
    from akari_render_tpu_torch.camera import generate_rays

    rng = np.random.default_rng(seed)
    cam = sc.camera
    p = torch.as_tensor(rng.random((n // 2, 2)) * [cam.width, cam.height], dtype=torch.float32)
    o_c, d_c = generate_rays(cam, p.cuda())
    v0 = sc.arrays.v0.cpu().numpy()
    lo, hi = v0.min(0), v0.max(0)
    o_r = lo + (hi - lo) * (0.05 + 0.9 * rng.random((n // 2, 3)))
    d_r = rng.normal(size=(n // 2, 3))
    d_r /= np.linalg.norm(d_r, axis=-1, keepdims=True)
    o = torch.cat([o_c, torch.as_tensor(o_r, dtype=torch.float32, device="cuda")]).contiguous()
    d = torch.cat([d_c, torch.as_tensor(d_r, dtype=torch.float32, device="cuda")]).contiguous()
    return o, d


if "k1" in only:
    flat = {}
    for name, path in (("matbox", chip_smoke.SCENE), ("blinds", chip_smoke.BLINDS)):
        sc = load_scene(str(path), device="cuda")
        o1, d1 = flat_rays(sc)
        kw1 = {"tiles": sc.tiles} if hasattr(sc, "tiles") else {}  # a parent's K1 takes none
        flat[name] = ((o1, d1, torch.zeros(o1.shape[0], device="cuda"),
                       torch.full((o1.shape[0],), RAY_TMAX, device="cuda"),
                       sc.arrays.v0, sc.arrays.e1, sc.arrays.e2), kw1)

    def k1_call(name, any_hit):
        args, kw1 = flat[name]
        return k1.intersect_tris(*args, any_hit=any_hit, **kw1)

    for _ in range(2):
        timing("K1_ms", lambda: k1_call("matbox", False))
        timing("K1_any_ms", lambda: k1_call("matbox", True))
        timing("K1_blinds_ms", lambda: k1_call("blinds", False))

if {"k2", "k3", "k4", "k7", "k5"} & set(only):
    scene = load_scene(str(chip_smoke.CLASSROOM), device="cuda")
    cl = scene.arrays.unified
    o, d, tmin, tmax, _ = chip_smoke.classroom_rays(scene, cl, "cuda")
    cb6 = pairs.cluster_bounds(cl)
    if hasattr(pairs, "candidate_test_boxes"):
        kw = {"boxes": pairs.candidate_test_boxes(cl, cb6)}
    else:
        kw = {"cb6": cb6}
    s = pairs.sort_rays(cl, o, d, tmin, tmax)
    e_con = pairs.cull_einit(s.summ, cb6)
    k3_args = (cb6, s.o_soa, s.inv_soa, s.lim, e_con)
    static_1080 = sample(scene, chip_smoke.CLASSROOM_METHOD, {})
    windowed_1080 = sample(scene, chip_smoke.CLASSROOM_METHOD, {"AKR_PAIRS_STATIC": "0"})

if "k2" in only:
    k2_1080 = first_call(pairs, "cull_einit", static_1080)
    want = pairs.cull_einit_torch(s.summ, cb6)
    if hasattr(pairs, "cull_einit_cased_torch"):  # the change's twin: its cases' rows
        tally = {}
        pairs.cull_einit_cased_torch(k2_1080[0], k2_1080[1], tally)
        row["K2_1080p_rows"] = tally
    row["K2_bits_differ"] = int((e_con.view(torch.int32) != want.view(torch.int32)).sum())
    row["K2_equal"] = bool(torch.equal(e_con, want))
    for _ in range(2):
        row.setdefault("K2_device_ms", []).append(
            round(device_ms(lambda: pairs.cull_einit(s.summ, cb6), reps, "cull_kernel"), 4))
        row.setdefault("K2_1080p_device_ms", []).append(
            round(device_ms(lambda: pairs.cull_einit(*k2_1080), reps, "cull_kernel"), 4))

if {"k3", "k4", "k7"} & set(only):
    def k3():
        if hasattr(pairs, "refine_walk"):
            return pairs.refine_walk(*k3_args)[1:]
        return pairs.walk_order(pairs.refine_all(*k3_args))

    order = k3()
    sw = pairs.sort_rays(cl, o, d, tmin, tmax, dead_last=False)

    def k4(any_hit):
        return pairs.sweep_walk(*order, cl.tri_row, cl.tri, cl.xf, s.o_soa, s.d_soa, s.lim, s.ex,
                                s.best0, any_hit, **kw)

    def k7(any_hit):
        return wide.wide_walk(cl.wide, cl.tri, cl.xf, sw.o_soa, sw.d_soa, sw.lim, sw.ex,
                              sw.best0, any_hit, **kw)

    for _ in range(2):
        if "k3" in only:
            timing("K3_ms", k3)
        if "k4" in only:
            timing("K4_ms", lambda: k4(False))
            timing("K4_any_ms", lambda: k4(True))
        if "k7" in only:
            timing("K7_ms", lambda: k7(False))
            timing("K7_any_ms", lambda: k7(True))

if "k5" in only:
    k5_name = "refine_window" if hasattr(pairs, "refine_window") else "refine"
    k5_fn = getattr(pairs, k5_name)
    k5_args = first_call(pairs, k5_name, lambda: pairs.windowed_walk(cl, s, e_con, False))
    k5_1080 = first_call(pairs, k5_name, windowed_1080)
    row["K5"], row["K5_info"] = k5_name, pairs.kernel_info()["K5"]
    for _ in range(2):
        timing("K5_ms", lambda: k5_fn(*k5_args))
        timing("K5_1080p_ms", lambda: k5_fn(*k5_1080))
        for name, a in (("K5_device_ms", k5_args), ("K5_1080p_device_ms", k5_1080)):
            row.setdefault(name, []).append(
                round(device_ms(lambda: k5_fn(*a), reps, "window_refine_kernel"), 4))

if {"k8", "k9"} & set(only):
    blinds, task, settings, filt = chip_smoke.blinds_setup("cuda")

if "k8" in only:
    tb = mk.pass_tables(blinds, settings, filt, task.seed)
    spp = task.method.spp_per_pass
    row["K8_info"] = mk.kernel_info(tb)["K8"]
    for _ in range(2):
        timing("K8_ms", lambda: mk.megakernel_pass(tb, 0, spp))

if "k9" in only:
    # the first path-B bounce at 256^2, as the bounce loop hands it to the shade
    bounce = first_call(common, "_fused_shade_live",
                        sample(blinds, chip_smoke.BLINDS_METHOD, {"AKR_PALLAS_SHADE": "1"}),
                        clone=False)
    bake, si, extra, lanes = bounce
    row["K9_lanes"], row["K9_live"] = int(lanes.shape[0]), int(lanes.sum())
    row["K9_info"] = fs.kernel_info(bake)["K9"]
    out = common._fused_shade_live(*bounce)
    torch.cuda.synchronize()
    row["K9_out"] = [round(float(out[k].double().sum()), 6) for k in ("direct", "wi", "f", "pdf",
                                                                         "albedo")]
    for _ in range(2):
        events, ms, kernel_ms = span(lambda: common._fused_shade_live(*bounce), reps,
                                     "fused_shade_kernel")
        row.setdefault("K9_bounce_events", []).append(events)
        row.setdefault("K9_bounce_device_ms", []).append(round(ms, 4) if ms is not None else None)
        row.setdefault("K9_kernel_device_ms", []).append(
            round(kernel_ms, 4) if kernel_ms is not None else None)
print(json.dumps(row), flush=True)
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+", help="checkouts, in the order to run them")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="k1,k2,k3,k4,k7,k5,k8,k9",
                    help="kernels to time, comma-separated")
    ap.add_argument("--variants", action="store_true",
                    help="also time K2's and K9's variants in this checkout")
    args = ap.parse_args()
    runs = [(root, args.only, "") for root in args.roots]
    if args.variants:
        here = str(Path(__file__).resolve().parents[1])
        runs += [(here, v[:2], v) for v in ("k2_tiles_only", "k2_8_blocks", "k2_32_blocks",
                                            "k9_8_blocks")]  # the CHILD's VARIANTS
    for root, only, variant in runs:
        subprocess.run([sys.executable, "-c", CHILD, root, str(args.reps), only, variant],
                       check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
