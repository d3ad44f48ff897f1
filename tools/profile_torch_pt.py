"""Profile the PyTorch port's path tracer on the card: where one sample's
time goes, on matbox (flat tier, K1), classroom (cluster tier and
instancing: K2-K4, with AKR_WIDE=1 the wide-BVH walk K7, with
AKR_PAIRS_STATIC=0 the windowed walk K2, K5 and K4) or blinds (flat tier; with AKR_PALLAS_SHADE=1 the
fused shade K9 shades each bounce, with AKR_MEGAKERNEL=1 each sample is
one pass of the path megakernel K8).

Renders a warm-up sample, then `--spp` samples under torch.profiler (CPU
and CUDA activities), and reports the wall time per sample, the device's
busy and idle share, each hand-written kernel's share of the busy time
and the sorts' share, the kernel launch count, and the top device kernels.
A second, unprofiled sample brackets every Scene.intersect / occlude call
with device synchronisations and reports the traversal layer's share of
the wall time. With AKR_PALLAS_SHADE=1 it also splits the shade of each
bounce (the bounce loop's `_fused_shade_live`, in a profiler range) into
device time of the K9 kernel, of gathers, of fills and scatters, and of the
rest (nonzero), per bounce. `--root` profiles the package of another
checkout (e.g. a parent unpacked with `git archive`). The full tables go
to `--out`.

Usage:
    [AKR_PALLAS_SHADE=1 | AKR_MEGAKERNEL=1 | AKR_WIDE=1 | AKR_PAIRS_STATIC=0]
    python tools/profile_torch_pt.py
        [--scene matbox|classroom|blinds] [--res N] [--spp 2]
        [--out build/profile_torch_pt.txt] [--root CHECKOUT]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# device kernel name fragments of the port's hand-written kernels
KERNELS = {"K1": "flat_kernel", "K2": "cull_kernel", "K3": "refine_walk_kernel",
           "K4": "sweep_kernel", "K5": "window_refine_kernel", "K7": "wide_walk_kernel",
           "K8": "megakernel", "K9": "fused_shade_kernel"}


# the profiler range around each call of the bounce loop's fused shade
SHADE_RANGE = "fused shade (K9) call"


def shade_split(events, spp: int) -> dict:
    """The device time of the shade's calls (SHADE_RANGE, on path B), a
    bounce, split by kind of kernel: K9 itself, gathers (index), fills and
    scatters (fill, index_put, scatter), the rest (nonzero and its
    copies); with the calls a sample and their device events a call. A
    kernel belongs to a call when it starts inside the call's range on the
    device's timeline (the profiler's annotation of the range there): K9
    launches through ctypes, which the profiler ties to no operator."""
    cuda = torch_device_events(events)
    spans = [(e.time_range.start, e.time_range.end) for e in cuda if e.name == SHADE_RANGE]
    if not spans:
        return {}
    split = {"kernel": 0.0, "gathers": 0.0, "fills_scatters": 0.0, "rest": 0.0}
    n_kernels = 0
    for e in cuda:
        if e.name == SHADE_RANGE or not any(a <= e.time_range.start < b for a, b in spans):
            continue
        n_kernels += 1
        name = e.name.lower()
        kind = ("kernel" if "fused_shade_kernel" in name
                else "fills_scatters" if any(w in name for w in ("fill", "index_put", "scatter"))
                else "gathers" if "index" in name else "rest")
        split[kind] += e.time_range.elapsed_us() / 1e3
    calls = len(spans)
    return {"shade_calls_per_sample": calls / spp, "shade_device_events_per_call": n_kernels / calls,
            **{f"shade_{k}_device_ms_per_bounce": v / calls for k, v in split.items()}}


def torch_device_events(events):
    """The device-side records of a profile: kernels, copies, fills, and
    the ranges' annotations on the device's timeline."""
    import torch

    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=("matbox", "classroom", "blinds"), default="matbox")
    ap.add_argument("--res", type=int, default=None,
                    help="square resolution (default: the scene camera's)")
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" / "profile_torch_pt.txt"))
    ap.add_argument("--root", default=str(ROOT), help="the checkout whose package to profile")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch
    from torch.profiler import ProfilerActivity, profile

    from akari_render_tpu_torch.config import RenderTask
    from akari_render_tpu_torch.core.filters import filter_from_config
    from akari_render_tpu_torch.core.math import disable_tf32
    from akari_render_tpu_torch.integrators import common
    from akari_render_tpu_torch.integrators.common import PTSettings
    from akari_render_tpu_torch.integrators.megakernel import (
        megakernel_eligible, megakernel_pass, pass_tables,
    )
    from akari_render_tpu_torch.integrators.pt import render_sample
    from akari_render_tpu_torch.scene import load_scene

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    disable_tf32()
    scene_dir = ROOT / "scenes" / args.scene
    task = RenderTask.from_file(scene_dir / "pt.json")
    m = task.method
    settings = PTSettings(max_depth=m.max_depth, rr_depth=m.rr_depth, use_nee=m.use_nee,
                          clamp_indirect=m.clamp_indirect)
    filt = filter_from_config(task.filter_config)
    scene = load_scene(str(scene_dir / "scene.json"), args.res, args.res, device="cuda")
    pixels = scene.camera.width * scene.camera.height

    if (os.environ.get("AKR_MEGAKERNEL", "0") == "1"
            and megakernel_eligible(scene, settings, task.sampler, filt)):
        tables = pass_tables(scene, settings, filt, task.seed)

        def sample(i):  # one megakernel pass of one sample
            return megakernel_pass(tables, i, 1)
    else:
        def sample(i):
            return render_sample(scene, settings, filt, i, task.seed, task.sampler)

    real_shade = common._fused_shade_live

    def shade_in_range(*a):
        with torch.profiler.record_function(SHADE_RANGE):
            return real_shade(*a)

    common._fused_shade_live = shade_in_range
    sample(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(args.spp):
            sample(1 + i)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    common._fused_shade_live = real_shade

    # the traversal layer, unprofiled: every intersect / occlude call
    # bracketed by synchronisations
    spent = [0.0]
    for name in ("intersect", "occlude"):
        def timed(*a, f=getattr(scene, name), **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = f(*a, **k)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t
            return r
        setattr(scene, name, timed)
    t1 = time.perf_counter()
    sample(1 + args.spp)
    torch.cuda.synchronize()
    wall_timed = time.perf_counter() - t1
    del scene.intersect, scene.occlude

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    # the device's work, without the ranges' annotations on its timeline
    kernels = [e for e in torch_device_events(prof.events()) if e.name != SHADE_RANGE]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)

    def share(pred):
        us = sum(e.time_range.elapsed_us() for e in kernels if pred(e.name))
        return us / busy_us if busy_us else 0.0

    avg = prof.key_averages()
    summary = {
        "device": torch.cuda.get_device_name(0),
        "scene": args.scene,
        "traversal": scene.traversal,
        "res": [scene.camera.width, scene.camera.height],
        "spp": args.spp,
        "wall_s_per_sample": wall / args.spp,
        "device_busy_s_per_sample": busy_us / 1e6 / args.spp,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        **{f"{k}_share_of_busy": share(lambda n, p=p: p in n) for k, p in KERNELS.items()},
        "sort_share_of_busy": share(lambda n: "Sort" in n or "sort" in n),
        "kernel_launches_per_sample": len(kernels) / args.spp,
        "mpaths_per_s": pixels * args.spp / wall / 1e6,
        "unprofiled_sample_s": wall_timed,
        # the profiler's own start-up dwarfs a short sample: the idle share
        # against the unprofiled sample is the one to read there
        "device_idle_share_of_unprofiled_sample": 1.0 - busy_us / 1e6 / args.spp / wall_timed,
        "traversal_share_of_unprofiled_sample": spent[0] / wall_timed,
        **shade_split(prof.events(), args.spp),
    }
    dev_key = "self_device_time_total" if hasattr(avg[0], "self_device_time_total") else "self_cuda_time_total"
    by_dev = avg.table(sort_by=dev_key, row_limit=40)
    by_cpu = avg.table(sort_by="self_cpu_time_total", row_limit=40)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(f"{json.dumps(summary)}\n\n# by device time\n{by_dev}\n\n# by host time\n{by_cpu}\n")
    top = sorted(avg, key=dev_us, reverse=True)[:12]
    for e in top:
        print(f"  {dev_us(e) / 1e3 / args.spp:9.3f} ms/sample  x{e.count // args.spp:<6} {e.key[:90]}")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
