"""The one traffic generator: a closed loop of render jobs, driven by a mix's
data file (bench_torch/traffic/<name>.json).

One client asks for a job, waits for the developed image on the host, and
asks for the next: a renderer's user waiting for a final frame, or a
viewer waiting for a viewport refresh. Jobs start only while the window is
open; the last one is counted whole. Every job gets its own sampler key
from (seed, job index), so every job traces new paths and the same seed
gives the same jobs. Every job's image is kept for the comparison with
the reference after the window; a share of the jobs, drawn from the seed
(and always the first two), is checked besides: their traversal answers
are kept too.

A mix's keys:
- "spp": samples of every pixel a job renders: "config" (the
  configuration's "spp", one pass of its method) or a number;
- "check_share", "checked_first", "lanes_checked": the share of jobs
  checked after the first `checked_first`, and the lanes kept of each
  traversal call of a checked job;
- "trace_jobs", "trace_spp": the jobs of the traced window and their
  samples ("config", a number, or null for the mix's own);
- "why": what the mix stands for (read by people only).
"""
from __future__ import annotations

import sys
import time

from . import harness

WARM_JOB = 1 << 40  # the warm-up job's index: no window job has it


def job_spp(traffic: dict, conf: dict, key: str = "spp") -> int:
    v = traffic[key]
    if v is None:
        return job_spp(traffic, conf)
    return int(conf["spp"]) if v == "config" else int(v)


def build_files() -> list[str]:
    """The libraries and tables the program keeps built in the checkout."""
    build = harness.ROOT / "build"
    return sorted(str(p.relative_to(build)) for d in ("torch_kernels", "native", "cache")
                  if (build / d).is_dir() for p in (build / d).iterdir() if p.is_file())


def nvcc_seconds() -> float:
    """Seconds the program's kernel modules spent in nvcc in this process
    (each keeps `build_seconds`)."""
    return sum(float(getattr(m, "build_seconds", 0.0) or 0.0)
               for name, m in list(sys.modules.items())
               if name.startswith("akari_render_tpu_torch.") and m is not None)


def _job(prog, intercept, key: int, spp: int, capture: bool, ranges: bool = False):
    if capture or ranges:
        intercept.install(capture=capture, ranges=ranges)
    try:
        return prog.render(key, spp)
    finally:
        intercept.remove()


def warm_up(prog, intercept, seed: int, spp: int) -> dict:
    """One checked job of one sample: every shape a window job uses (a job
    renders its samples one wavefront at a time; an MCMC job of one
    mutation a pixel has the bootstrap's chunks, the chains and the direct
    pass of any other), the capture path, and the lane sample of each call
    size."""
    img, stats = _job(prog, intercept, harness.job_key(seed, WARM_JOB), 1, capture=True)
    intercept.take()
    return {"stats": stats, "image": img}


def run_window(prog, intercept, traffic: dict, seed: int, seconds: float, spp: int,
               max_jobs: int | None = None) -> dict:
    """Jobs back to back while the window is open (or, for the CPU
    rehearsal, `max_jobs` of them); each job keeps its entry's stats."""
    jobs, checked, images = [], [], []
    t0 = time.perf_counter()
    j = 0
    while time.perf_counter() - t0 < seconds and (max_jobs is None or j < max_jobs):
        check = j < traffic["checked_first"] or harness.unit_draw(seed, j, 1) < traffic["check_share"]
        s = time.perf_counter()
        img, stats = _job(prog, intercept, harness.job_key(seed, j), spp, capture=check)
        e = time.perf_counter()
        jobs.append({"start": s - t0, "end": e - t0, "spp": spp, "stats": stats})
        images.append(img)
        if check:
            recs, live, calls = intercept.take()
            checked.append({"job": j, "spp": spp, "image": img, "records": recs,
                            "lanes": {n: i.cpu() for n, i in intercept.index.items()},
                            "live_rays": live, "calls": calls})
        j += 1
    return {"jobs": jobs, "checked": checked, "images": images, "seconds": jobs[-1]["end"],
            "samples": sum(x["spp"] for x in jobs)}


def traced_jobs(prog, intercept, traffic: dict, seed: int, spp: int) -> int:
    """The traced window's jobs, with the traversal ranges open; returns
    the samples rendered."""
    n = job_spp(traffic, prog.conf, "trace_spp") if traffic["trace_spp"] is not None else spp
    for k in range(traffic["trace_jobs"]):
        _job(prog, intercept, harness.job_key(seed, WARM_JOB + 1 + k), n, capture=False,
             ranges=True)
    return n * traffic["trace_jobs"]
