"""Command-line renderer (port of akari_render_tpu/cli.py).

Usage:
    python -m akari_render_tpu_torch.cli -s scenes/matbox/scene.json \\
        -m scenes/matbox/pt.json --device cuda

AKR_MEGAKERNEL=1 renders an eligible scene through the path megakernel
(K8), AKR_PALLAS_SHADE=1 shades through the fused shade (K9); on a
cluster-tier scene AKR_WIDE=1 traverses with the wide-BVH walk (K7) and
AKR_PAIRS_STATIC=0 with the pair sweep's legacy windowed walk (K5). Each
render prints which integrator, tier, shade and traversal ran.

Every method type of the reference's method JSON renders: `pt`, `gpt`,
`mcmc` and `mcmc_opt` (one branch, Kelemen PSSMLT) and `aov` (one EXR a
name, `{stem}_{name}{suffix}`, and the albedo as the main image); another
type exits with "unknown method". Not ported: --checkpoint,
--checkpoint-every, --devices (sharding), --gui and --save-intermediate.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None):
    """Render every task of the method file; returns the last task's stats."""
    ap = argparse.ArgumentParser(prog="akari-torch")
    ap.add_argument("-s", "--scene", required=True, help="scene.json path")
    ap.add_argument("-m", "--method", required=True, help="method json path")
    ap.add_argument("-o", "--output", default=None, help="override output image path")
    ap.add_argument("--spp", type=int, default=None, help="override spp")
    ap.add_argument("--res", type=int, default=None, help="override square resolution")
    ap.add_argument("--save-stats", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from .config import RenderTask
    from .scene import load_scene

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available")
    try:
        tasks = RenderTask.list_from_file(args.method)
    except ValueError as e:  # an unknown method type, or a file that does not parse
        raise SystemExit(str(e)) from None
    for task in tasks:
        if args.spp is not None:
            task.method.spp = args.spp

    t0 = time.time()
    scene = load_scene(args.scene, width=args.res, height=args.res, device=device)
    print(
        f"loaded scene: {scene.num_tris} tris, {len(scene.kinds)} shader kinds, "
        f"{scene.arrays.lights.num_lights} lights, "
        f"{scene.camera.width}x{scene.camera.height} on {device} ({time.time() - t0:.2f}s)",
        file=sys.stderr,
    )

    def progress(p, total, stats):
        print(f"  {p}/{total}  t={stats['time'][-1]:.2f}s", file=sys.stderr)

    stats = None
    for task_idx, task in enumerate(tasks):
        stats = _render_one(task, task_idx, len(tasks), scene, args,
                            progress if args.verbose else None)
    return stats


def _render_one(task, task_idx, n_tasks, scene, args, progress_cb):
    from .core.image_io import write_image
    from .integrators.aov import render_aov
    from .integrators.gpt import render_gpt
    from .integrators.mcmc import render_mcmc
    from .integrators.pt import render_pt
    from .stats import RenderSession

    out_p = Path(args.output or task.out_path)
    if n_tasks > 1 and args.output:
        out_p = out_p.with_name(f"{out_p.stem}_{task_idx}{out_p.suffix}")
    session = RenderSession(
        name=out_p.stem, save_stats=args.save_stats, out_dir=str(out_p.parent)
    )
    if task.method_type == "aov":
        img, stats = render_aov(scene, task.method, task)
        base = Path(args.output or task.out_path)
        for name, im in stats.pop("images").items():
            p = base.with_name(f"{base.stem}_{name}{base.suffix}")
            write_image(str(p), im)
            print(f"wrote {p}", file=sys.stderr)
        route = f"aov, traversal {scene.traversal}"
    elif task.method_type == "pt":
        img, stats = render_pt(scene, task.method, task, progress_cb=progress_cb, session=session)
        route = (f"pt, tier {stats['tier']}, shade {stats['shade']}, "
                 f"traversal {stats['traversal']}")
    else:
        render = render_gpt if task.method_type == "gpt" else render_mcmc
        img, stats = render(scene, task.method, task, progress_cb=progress_cb, session=session)
        what = (f"gpt ({stats['shift_mode']} shift)" if task.method_type == "gpt"
                else f"{task.method_type} (b {stats['b']:.6g}, acceptance {stats['acceptance']:.4f})")
        route = f"{what}, shade {stats['shade']}, traversal {scene.traversal}"
    write_image(str(out_p), img)
    print(f"wrote {out_p}  ({stats.get('total_time', 0.0):.2f}s render; {route})", file=sys.stderr)
    if args.save_stats:
        stats_path = out_p.with_suffix(".stats.json")
        scalars = {k: v for k, v in stats.items() if not hasattr(v, "shape") or v.ndim <= 1}
        stats_path.write_text(json.dumps(scalars, default=float))
        print(f"wrote {stats_path}", file=sys.stderr)
    return stats


if __name__ == "__main__":
    main()
