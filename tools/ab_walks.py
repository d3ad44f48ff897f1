"""Time the flat tier's K1 (matbox and blinds, chip_smoke.py's 2^18 rays),
the cluster tier's refine with its walk order (K3: in a parent without the
fused kernel, refine_all then walk_order) and its walks (K4 and K7, closest
and any hit) at chip_smoke.py's 2^18 classroom rays, the windowed walk's
window refine (K5: the first window of those rays' windowed walk, and the
first window of a classroom 1080p sample's first traversal; a parent whose
K5 took the gathered [B, 6, W] window, `refine`, gets that) and the path
megakernel (K8: a blinds 256^2, 16-spp pass) in two or more checkouts of
this repo, within one run on one card: the way to compare a change with
its parent. K5 is also timed by its device records (torch.profiler), and
each checkout reports K5's and K8's registers, local memory and resident
blocks.

    python tools/ab_walks.py PARENT . . PARENT [--reps 20]

Each checkout (a directory holding chip_smoke.py and the package, e.g. made
with `git archive`) runs in a process of its own, builds its own kernels and
times each walk twice with CUDA events. Prints one JSON line per checkout,
then the card's name and power limit. Needs one NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

# runs with a checkout's root as argv[1]; the walks' box argument changed
# its name and content between checkouts, so it is looked up
CHILD = r"""
import json, sys
import torch
root, reps = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, root)
import chip_smoke
from akari_render_tpu_torch.accel import intersect as k1
from akari_render_tpu_torch.accel import pairs, wide
from akari_render_tpu_torch.core.math import RAY_TMAX, disable_tf32
from akari_render_tpu_torch.integrators import megakernel as mk
from akari_render_tpu_torch.scene import load_scene

disable_tf32()


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


scene = load_scene(str(chip_smoke.CLASSROOM), device="cuda")
cl = scene.arrays.unified
o, d, tmin, tmax, _ = chip_smoke.classroom_rays(scene, cl, "cuda")
cb6 = pairs.cluster_bounds(cl)
if hasattr(pairs, "candidate_test_boxes"):
    kw = {"boxes": pairs.candidate_test_boxes(cl, cb6)}
else:
    kw = {"cb6": cb6}
s = pairs.sort_rays(cl, o, d, tmin, tmax)
sw = pairs.sort_rays(cl, o, d, tmin, tmax, dead_last=False)
k3_args = (cb6, s.o_soa, s.inv_soa, s.lim, pairs.cull_einit(s.summ, cb6))


def k3():
    if hasattr(pairs, "refine_walk"):
        return pairs.refine_walk(*k3_args)[1:]
    return pairs.walk_order(pairs.refine_all(*k3_args))


order = k3()


def k4(any_hit):
    return pairs.sweep_walk(*order, cl.tri_row, cl.tri, cl.xf, s.o_soa, s.d_soa, s.lim, s.ex,
                            s.best0, any_hit, **kw)


def k7(any_hit):
    return wide.wide_walk(cl.wide, cl.tri, cl.xf, sw.o_soa, sw.d_soa, sw.lim, sw.ex, sw.best0,
                          any_hit, **kw)


k5_name = "refine_window" if hasattr(pairs, "refine_window") else "refine"
k5_fn = getattr(pairs, k5_name)


class Captured(Exception):
    pass


def first_k5_call(run):
    # the arguments of the first K5 call that run() makes; the run ends there
    calls = []

    def capture(*a):
        calls.append(tuple(x.clone() for x in a))
        raise Captured

    setattr(pairs, k5_name, capture)
    try:
        run()
    except Captured:
        pass
    finally:
        setattr(pairs, k5_name, k5_fn)
    return calls[0]


def sample_1080p():
    from akari_render_tpu_torch.config import RenderTask
    from akari_render_tpu_torch.core.filters import filter_from_config
    from akari_render_tpu_torch.integrators.common import PTSettings
    from akari_render_tpu_torch.integrators.pt import render_sample

    task = RenderTask.from_file(chip_smoke.CLASSROOM_METHOD)
    m = task.method
    st = PTSettings(max_depth=m.max_depth, rr_depth=m.rr_depth, use_nee=m.use_nee,
                    clamp_indirect=m.clamp_indirect)
    with chip_smoke.env_switch(AKR_PAIRS_STATIC="0"):
        render_sample(scene, st, filter_from_config(task.filter_config), 0, task.seed,
                      task.sampler)


k5_args = first_k5_call(lambda: pairs.windowed_walk(cl, s, k3_args[4], False))
k5_1080 = first_k5_call(sample_1080p)
blinds, task, settings, filt = chip_smoke.blinds_setup("cuda")
tb = mk.pass_tables(blinds, settings, filt, task.seed)
spp = task.method.spp_per_pass


# chip_smoke.device_ms's way, without its retries (a parent's chip_smoke has none)
def device_ms(fn, n, kernel):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    durs = [e.duration_ns() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA and kernel in e.name()]
    return sum(durs) / max(len(durs), 1) / 1e6


row = {"root": root, "K5": k5_name,
       "K5_info": pairs.kernel_info()["K5"], "K8_info": mk.kernel_info(tb)["K8"]}
for _ in range(2):
    for name, fn in (("K1_ms", lambda: k1_call("matbox", False)),
                     ("K1_any_ms", lambda: k1_call("matbox", True)),
                     ("K1_blinds_ms", lambda: k1_call("blinds", False)), ("K3_ms", k3),
                     ("K4_ms", lambda: k4(False)), ("K4_any_ms", lambda: k4(True)),
                     ("K7_ms", lambda: k7(False)), ("K7_any_ms", lambda: k7(True)),
                     ("K5_ms", lambda: k5_fn(*k5_args)),
                     ("K5_1080p_ms", lambda: k5_fn(*k5_1080)),
                     ("K8_ms", lambda: mk.megakernel_pass(tb, 0, spp))):
        row.setdefault(name, []).append(round(chip_smoke.cuda_ms(fn, reps), 4))
    for name, fn in (("K5_device_ms", lambda: k5_fn(*k5_args)),
                     ("K5_1080p_device_ms", lambda: k5_fn(*k5_1080))):
        row.setdefault(name, []).append(round(device_ms(fn, reps, "window_refine_kernel"), 4))
print(json.dumps(row), flush=True)
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+", help="checkouts, in the order to run them")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    for root in args.roots:
        subprocess.run([sys.executable, "-c", CHILD, root, str(args.reps)], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
