"""The control of the comparison, and the sound readings it is held against,
at a cell's own size, in one process.

    python3 bench_torch/control.py --workload <cell> --seeds 1,2,3 [--control] [--jobs N]
        [--samples S]

For each seed: N checked jobs of the cell's traffic (the jobs a run checks,
at the timed sizes), then check.compare's numbers and the tile_chi2 of the
N jobs' mean image (an MCMC cell: the job_chi2 of the N images, so give N
about a window's jobs; a GPT cell: the grad_chi2 and primal_chi2 of the N
jobs' films and the recon_gap of the checked jobs), one JSON line a seed.
With --control the reference is put in the program's place, computed in the
nearest precisions below the configuration's float32 with TF32 off: the
camera rays come from the reference camera in TF32 (patched in for the
program's ray generation, the chains' and GPT's too), every kept traversal
answer is the reference's TF32 cast of the same ray
(check.control_answers), and the image is the reference path tracer's with
TF32 traversal and bfloat16 shading (reference/render.py, "control"), of S
samples a pixel (by default as many as the N jobs render; a run's image is
the mean of every job of its window, a preview run's some 150); for an MCMC
cell N such images of S samples each (by default a job's); for a GPT cell N
control jobs of S samples each (by default a job's), binned where they land
on the film for the primal and differenced between pixels for the
gradients, and a bfloat16 solve of each checked job's own films in place of
its image. Its numbers set the limits' upper readings; the program's set
the lower ones. Needs a CUDA device, as run.py does.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_torch import check, harness, loop  # noqa: E402
from bench_torch.reference import scene as ref_scene  # noqa: E402
from bench_torch.reference.camera import directions  # noqa: E402


def control_camera(ref):
    """A stand-in for the program's ray generation: the reference camera in
    TF32."""
    import torch

    def generate_rays(camera, p_film):
        d = directions(ref.camera, p_film, "tf32").to(torch.float32)
        o = torch.as_tensor(ref.camera.origin, dtype=torch.float32, device=p_film.device)
        return o.expand(d.shape[0], 3), d

    return generate_rays


def readings(workload: str, seeds: list[int], control: bool, jobs: int | None,
             device: str = "cuda", width: int | None = None, height: int | None = None,
             out=print, samples: int | None = None) -> list[dict]:
    import torch

    spec = harness.benchmark()
    cell = harness.cell(workload, spec)
    conf = harness.load_config(cell["config"], spec)
    traffic = harness.load_traffic(cell["traffic"])
    harness.clear_route_switches()
    prog = harness.Program(conf, device, width, height)
    ref = ref_scene.load(harness.ROOT / conf["scene"], prog.width, prog.height)
    spp = loop.job_spp(traffic, conf)
    n = jobs or traffic["checked_first"]
    traffic = dict(traffic, checked_first=n)
    kind = conf["method"]["type"]
    layout = check.camera_layout(conf["method"], spp, prog.width, prog.height)
    real = prog.pt.generate_rays, prog.mcmc.generate_rays, prog.gpt.generate_rays
    if control:
        prog.pt.generate_rays = prog.mcmc.generate_rays = prog.gpt.generate_rays = \
            control_camera(ref)
    dev = torch.device(device)
    rows = []
    try:
        for seed in seeds:
            ic = harness.Intercept(prog.scene, traffic["lanes_checked"], seed)
            t0 = time.perf_counter()
            warm = loop.warm_up(prog, ic, seed, spp)
            win = loop.run_window(prog, ic, traffic, seed, 1e9, spp, max_jobs=n)
            checked = check.control_answers(ref, win["checked"], dev) if control else win["checked"]
            nums = check.compare(ref, checked, prog.width, prog.height, dev, prior=warm["image"],
                                 layout=layout)
            w, h, tiles = prog.width, prog.height, conf["reference"]["tiles"]
            if kind == "gpt":
                nums.update(gpt_readings(ref, conf, w, h, seed, dev, win, control, n,
                                         samples or spp))
            elif kind == "mcmc_opt":  # n images of a job's samples, judged by their spread
                reference = check.reference_image(ref, conf, w, h, seed, dev)
                images = [check.reference_image(ref, conf, w, h, seed + 1 + j, dev, "control",
                                                samples or spp)["mean"].cpu().numpy()
                          for j in range(n)] if control else win["images"]
                nums["job_chi2"] = check.job_chi2(images, reference, w, h, tiles)
            else:
                reference = check.reference_image(ref, conf, w, h, seed, dev)
                if control:
                    n_img = samples or spp * n
                    mean = check.reference_image(ref, conf, w, h, seed + 1, dev, "control",
                                                 n_img)["mean"].cpu().numpy()
                else:
                    n_img, mean = spp * n, check.mean_image(win["images"])
                nums["tile_chi2"] = check.tile_chi2(mean, n_img, reference, w, h, tiles)
            row = {"workload": workload, "seed": seed, "control": control, "jobs": n,
                   "seconds": time.perf_counter() - t0, **nums}
            out(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        prog.pt.generate_rays, prog.mcmc.generate_rays, prog.gpt.generate_rays = real
    return rows


def gpt_readings(ref, conf: dict, w: int, h: int, seed: int, dev, win: dict, control: bool,
                 n: int, spp: int) -> dict:
    """grad_chi2, primal_chi2 and recon_gap of a GPT cell: of the n jobs'
    films and the checked jobs' images, or, with `control`, of n jobs of
    the control path tracer of `spp` samples each (their film-binned images
    and their pixel differences in place of the films) and of a bfloat16
    solve of each checked job's own films in place of its image."""
    from bench_torch.reference.poisson import solve

    reference = check.gpt_reference(ref, conf, w, h, seed, dev)
    stats = [j["stats"] for j in win["jobs"]]
    recons = [(c["image"], win["jobs"][c["job"]]["stats"]) for c in win["checked"]]
    if not control:
        return check.gpt_numbers(reference, conf, w, h, stats, recons)
    ctl = check.gpt_reference(ref, conf, w, h, seed + 1, dev, "control", spp * n, spp,
                              job_grads=True)
    tiles, stride = conf["reference"]["tiles"], conf["method"].get("stride", 1)
    iters = conf["method"]["reconstruction_iter"]
    return {"grad_chi2": check.grad_chi2(ctl["grad_jobs"], check.grad_expected(
                reference, w, h, tiles, stride)),
            "primal_chi2": check.primal_chi2(ctl["primal_jobs"], reference["primal_jobs"]),
            "recon_gap": max(check.recon_gap(solve(s["primal"], s["gx"], s["gy"], iters,
                                                   "bfloat16"), s["primal"], s["gx"], s["gy"],
                                             iters) for _, s in recons)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--jobs", type=int, default=None, help="checked jobs a seed")
    ap.add_argument("--samples", type=int, default=None,
                    help="the control image's samples a pixel (default: the jobs')")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    readings(args.workload, [int(s) for s in args.seeds.split(",")], args.control, args.jobs,
             samples=args.samples)
    return 0


if __name__ == "__main__":
    sys.exit(main())
