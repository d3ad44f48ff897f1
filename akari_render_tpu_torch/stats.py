"""Render session stats (copied from akari_render_tpu/stats.py, without
its dispatch profiler), and the port's counters and spans.

Reference: crates/akari_integrator/src/lib.rs:8-37 (RenderSession,
RenderStats/IntermediateStats — the `{session}.json` time/spp/path series
used for MSE-vs-time curves).

Counters (`counts`, since the last reset) are plain ints, always on, and
never read the device:
- bounces: iterations of trace_paths' bounce loop;
- dispatch_groups: groups of lanes (one shader kind of one bounce) shaded
  by dispatch_shade's per-kind closures;
- fused_shades: bounces of trace_paths shaded through K9, the fused shade
  (one launch over the wavefront); fused_shades / bounces is that route's
  share of the bounces;
- samples: samples of every pixel rendered by render_pt's pass route;
- host_reads: calls in the render path that block the host on the device,
  each at a `read(site)` (counted at the site on every device);
- pcg_kernel_draws, pcg_plain_draws: PCG32 float draws (lanes x draws a
  call) taken by core/pcg.py::pcg32_draws through its kernel and through
  its plain version; the first over their sum is the kernel's share;
- mcmc_graph_steps, mcmc_eager_steps: MCMC mutation steps run from CUDA
  graphs to their end (integrators/mcmc.py::GraphedSteps, captured or
  replayed) and run eagerly (the first step of a job, a route that takes
  no graphs, a step finished eagerly after every lane died); the first
  over their sum is the graphs' share of the steps.

A step replayed from CUDA graphs adds to every counter what the captured
code added while it was captured (integrators/piecewise.py), so it counts
as an eager step does.

Spans: `span(name)` is a context manager. While no profiler collects it is
one shared no-op object. While one does (torch.profiler.profile, or any
profiler that sets the flag autograd's profiler keeps), it opens
`torch.profiler.record_function(name)`, so the span lands on the
profiler's timeline on the device records' clock, and adds to `spans`,
{name: [calls, total_ns, self_ns]}, timed on the host's perf_counter_ns;
self time leaves out the spans opened inside. There is no switch of its
own: a profiler turns the spans on. `read(site)` is the span
"read.<site>" of a blocking read, and counts it.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch
from torch.autograd import profiler as _profiler


@dataclass
class RenderSession:
    """Mirrors RenderSession (lib.rs:8-23), without the per-pass EXR dumps
    and the live display, which are not ported."""

    name: str = "render"
    save_stats: bool = False
    out_dir: str = "."


@dataclass
class RenderStats:
    """The reference's stats-JSON format: intermediate = [{time, spp, path}]."""

    intermediate: list = field(default_factory=list)

    def record(self, t: float, spp: int, path: str = ""):
        self.intermediate.append({"time": t, "spp": spp, "path": path})

    def write(self, session: RenderSession):
        p = Path(session.out_dir) / f"{session.name}.json"
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps({"intermediate": self.intermediate}))
        return p


counts = {"bounces": 0, "dispatch_groups": 0, "fused_shades": 0, "samples": 0, "host_reads": 0,
          "pcg_kernel_draws": 0, "pcg_plain_draws": 0, "mcmc_graph_steps": 0,
          "mcmc_eager_steps": 0}
spans: dict[str, list[int]] = {}
_stack: list = []  # the open spans, innermost last


class _Off:
    """The span while no profiler collects."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rf", "t0", "child_ns")

    def __init__(self, name: str, args: str | None):
        self.name = name
        self.rf = torch.profiler.record_function(name, args)

    def __enter__(self):
        self.rf.__enter__()
        self.child_ns = 0
        _stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        _stack.pop()
        row = spans.get(self.name)
        if row is None:
            row = spans[self.name] = [0, 0, 0]
        row[0] += 1
        row[1] += ns
        row[2] += ns - self.child_ns
        if _stack:
            _stack[-1].child_ns += ns
        return self.rf.__exit__(*exc)


def span(name: str, args: str | None = None):
    """The span `name` (with `args`, a string the profiler's record keeps)."""
    if _profiler._is_profiler_enabled:
        return _Span(name, args)
    return _OFF


def read(site: str):
    """The span "read.<site>" around a call that blocks the host on the
    device; counts it in host_reads."""
    counts["host_reads"] += 1
    if _profiler._is_profiler_enabled:
        return _Span(f"read.{site}", None)
    return _OFF


def reset() -> None:
    """Every counter to 0, and the span table emptied."""
    for k in counts:
        counts[k] = 0
    spans.clear()


def snapshot() -> dict:
    """A copy of the counters and the span table."""
    return {"counts": dict(counts), "spans": {k: list(v) for k, v in spans.items()}}
