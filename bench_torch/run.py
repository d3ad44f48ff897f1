"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from BENCHMARK.json and finds its configuration
(bench_torch/configs/<config>.json), its traffic mix
(bench_torch/traffic/<traffic>.json) and its metrics
(bench_torch/metrics/<metric>.py) by name. Loads the scene, warms up every
shape the traffic uses (set-up), then runs the traffic's closed loop of
render jobs (loop.py) for --seconds with tracing off. With --trace 1 one
more job (or a few) runs under torch.profiler for the per-layer metrics.
Once the window has closed and the program's state is freed, the jobs
are held against the plain reference (check.py): the checked jobs'
traversal answers and camera rays, and the mean of every job's image
against the reference path tracer's (for an MCMC cell, with the standard
error from the spread between the jobs; for a GPT cell, every job's
gradient and primal films, and each checked job's reconstruction against
a float64 solve of its own films). The last stdout line is the
result; every number compared, with its limit, is also printed last on
stderr.

It needs a CUDA device (as many as the cell asks for) and exits with 2,
printing no result, without one; with 3, naming them, if the process holds
JAX, jaxlib, flax or the JAX package once the window has closed. It unsets
every AKR_* switch, so the port's default route runs, and prints that route
on an earlier line.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_torch import harness, loop  # noqa: E402


def applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def measure(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            width: int | None = None, height: int | None = None, t_start: float | None = None,
            log=print, max_jobs: int | None = None) -> dict:
    """One run of the cell; returns the result line's object. `device`,
    `width`, `height` and `max_jobs` (the window's jobs) let the CPU
    self-check and tests drive it small."""
    import torch

    from bench_torch import check
    from bench_torch.reference import scene as ref_scene

    t_start = T_START if t_start is None else t_start
    spec = harness.benchmark()
    cell = harness.cell(workload, spec)
    conf = harness.load_config(cell["config"], spec)
    traffic = harness.load_traffic(cell["traffic"])
    cleared = harness.clear_route_switches()
    if cleared:
        log(f"unset route switches: {' '.join(cleared)}", file=sys.stderr)
    cuda = torch.device(device).type == "cuda"
    built = loop.build_files()
    if cuda:
        torch.cuda.init()
    t_prog = time.perf_counter()
    prog = harness.Program(conf, device, width, height)
    spp = loop.job_spp(traffic, conf)
    intercept = harness.Intercept(prog.scene, traffic["lanes_checked"], seed)
    t_warm = time.perf_counter()
    warm = loop.warm_up(prog, intercept, seed, spp)
    stats = warm["stats"]
    log(f"set-up: start-up {t_prog - t_start:.2f} s, load_scene {prog.load_s:.2f} s, "
        f"warm-up job {time.perf_counter() - t_warm:.2f} s", flush=True)
    log(f"route: tier {stats['tier']}, shade {stats['shade']}, traversal {stats['traversal']}, "
        f"color {stats['color']}; {prog.width}x{prog.height}, {spp} spp a job", flush=True)
    new = sorted(set(loop.build_files()) - set(built))
    log(f"built in this set-up: {len(new)} files ({', '.join(new) or 'none'}); "
        f"nvcc {loop.nvcc_seconds():.1f} s inside set-up", flush=True)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    window = loop.run_window(prog, intercept, traffic, seed, seconds, spp, max_jobs)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ms = sorted((j["end"] - j["start"]) * 1e3 for j in window["jobs"])
    log(f"window: {len(ms)} jobs in {window['seconds']:.3f} s; job ms min {ms[0]:.1f}, "
        f"median {ms[len(ms) // 2]:.1f}, max {ms[-1]:.1f}; {len(window['checked'])} checked",
        flush=True)
    traced = None
    if trace:
        from bench_torch import trace as tracing

        traced = tracing.traced_job(lambda: loop.traced_jobs(prog, intercept, traffic, seed, spp))
        log(f"traced window: {traced['samples']} samples, {traced['device_events']} device "
            f"events, read in {traced['read_s']:.1f} s", flush=True)

    width, height = prog.width, prog.height
    prog.free()
    del intercept
    t_check = time.perf_counter()
    dev = torch.device(device) if cuda else torch.device("cpu")
    ref = ref_scene.load(harness.ROOT / conf["scene"], width, height)
    numbers = check.compare(ref, window["checked"], width, height, dev, prior=warm["image"],
                            layout=check.camera_layout(conf["method"], spp, width, height))
    t_render = time.perf_counter()
    if conf["method"]["type"] == "gpt":
        reference = check.gpt_reference(ref, conf, width, height, seed, dev)
        numbers.update(check.gpt_numbers(
            reference, conf, width, height, [j["stats"] for j in window["jobs"]],
            [(c["image"], window["jobs"][c["job"]]["stats"]) for c in window["checked"]]))
    elif conf["method"]["type"] == "mcmc_opt":
        reference = check.reference_image(ref, conf, width, height, seed, dev)
        numbers["job_chi2"] = check.job_chi2(window["images"], reference, width, height,
                                             conf["reference"]["tiles"])
    else:
        reference = check.reference_image(ref, conf, width, height, seed, dev)
        numbers["tile_chi2"] = check.tile_chi2(check.mean_image(window["images"]),
                                               spp * len(window["images"]), reference, width,
                                               height, conf["reference"]["tiles"])
    log(f"reference: {numbers['answers_compared']} traversal answers of "
        f"{len(window['checked'])} jobs compared in {t_render - t_check:.1f} s; "
        f"{reference['spp']} spp rendered and {len(window['images'])} images compared in "
        f"{time.perf_counter() - t_render:.1f} s", flush=True)

    run = {"setup_s": setup_s, "scene_load_s": prog.load_s, "window": window, "trace": traced,
           "peak_bytes": peak, "pixels": width * height,
           "scene": {"tris": ref.n_unique_tris, "instances": ref.n_instances},
           "peaks": json.loads((harness.BENCH / "peaks.json").read_text())}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec[kind]:
        if not applies(m, workload):
            continue
        v = harness.metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    limits = conf["correct_limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(window["jobs"]), "failed": 0,
           "metrics": metrics, "device": dev}
    if traced is not None:
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        out["breakdown"] = traced["breakdown"]
    out["checks"] = checks
    return out


FORBIDDEN = ("jax", "jaxlib", "flax", "akari_render_tpu")  # the JAX package and its stack


def forbidden_modules() -> list[str]:
    """Top-level names (compared whole: the port's name begins with the
    JAX package's) of loaded modules that the measured process must not
    hold."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    cell = harness.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    out = measure(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the process holds {', '.join(found)}: no result", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
