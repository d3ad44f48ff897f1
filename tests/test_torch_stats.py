"""The port's counters and spans (akari_render_tpu_torch/stats.py) on the
cbox fixture at 32x32 on the CPU, through the benchmark's route (pmj02bn,
d12, the per-kind dispatch): spans stay off without a profiler and nest
under one, the image does not change with them, the counters equal the
counts worked out from the code, every read that would block the host on
the card happens at a read.* site, and the benchmark's readers of them
read a traced render.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch import stats
from akari_render_tpu_torch.config import GPTConfig, RenderTask
from akari_render_tpu_torch.integrators.gpt import render_gpt
from akari_render_tpu_torch.integrators.pt import render_pt
from akari_render_tpu_torch.scene import load_scene

ROOT = Path(__file__).resolve().parents[1]
CBOX = ROOT / "scenes/cbox"
RES = 32
SPP = 2
# every span the default route opens on cbox (one shader kind, principled)
EXPECTED = {
    "render.job", "render.sample", "render.camera", "render.film", "render.finish",
    "bounce", "bounce.surface", "bounce.emission", "bounce.nee", "bounce.shade",
    "bounce.shadow", "bounce.continue", "shade.0", "traversal.intersect", "traversal.occlude",
    "read.any_live", "read.kind_rows", "read.albedo_curve", "read.normal_sign", "read.sync",
    "read.image",
}
READERS = ("host_reads_per_sample", "shade_host_ms_per_sample", "job_tail_ms",
           "shade_host_share_pct")


@pytest.fixture(scope="module")
def scene():
    return load_scene(str(CBOX / "scene.json"), RES, RES, device="cpu",
                      ggx_table=np.asarray(j_get_table("ggx_dielectric_s")))


def _render(scene, spp=SPP, seed=0):
    task = RenderTask.from_file(CBOX / "pt.json")
    task.method.spp = task.method.spp_per_pass = spp
    task.sampler = dict(task.sampler, seed=seed)
    return render_pt(scene, task.method, task)[0]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", ROOT / "bench_torch" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_without_a_profiler_spans_are_off_and_counters_count(scene):
    assert stats.span("a") is stats.span("b")  # one shared no-op
    stats.reset()
    _render(scene)
    snap = stats.snapshot()
    assert snap["spans"] == {}
    c = snap["counts"]
    assert c["samples"] == SPP
    assert c["bounces"] > 0 and c["dispatch_groups"] > 0 and c["host_reads"] > 0


def test_spans_nest_under_a_profiler(scene):
    stats.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render(scene)
    table = stats.snapshot()["spans"]
    assert EXPECTED <= set(table), EXPECTED - set(table)
    for name, (calls, total_ns, self_ns) in table.items():
        assert calls > 0 and 0 <= self_ns <= total_ns, name
    assert table["render.job"][0] == 1 and table["render.sample"][0] == SPP
    assert table["render.job"][1] >= table["render.sample"][1] >= table["bounce"][1]
    events = prof.events()
    assert EXPECTED <= {e.name for e in events if e.is_user_annotation}
    shade = [e for e in events if e.name == "bounce.shade"]
    assert len(shade) == table["bounce.shade"][0]
    for e in shade:
        chain, p = [], e.cpu_parent
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        assert chain == ["bounce", "render.sample", "render.job"]
    assert {c.name for e in shade for c in e.cpu_children} >= {"shade.0", "read.kind_rows"}
    assert stats.span("a") is stats.span("b")  # off again


def test_image_bit_equal_with_spans_on_and_off(scene):
    off = _render(scene)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _render(scene)
    assert np.array_equal(off, on)


@pytest.mark.parametrize("seed", [0, 7])
def test_counters_equal_the_counts_of_the_route(scene, seed):
    """One 1-spp job: the loop condition reads once a bounce (and once more
    when every lane died before depth 12), dispatch_shade's nonzero once a
    kind a bounce, each principled closure uploads its two albedo curves
    and the normal map's sign, and the job's end syncs and copies the
    image; emission is the constant table's, so NEE and the emission read
    nothing. Under a profiler the read.* spans count the same."""
    stats.reset()
    _render(scene, spp=1, seed=seed)
    c = stats.snapshot()["counts"]
    b, g = c["bounces"], c["dispatch_groups"]
    depth = RenderTask.from_file(CBOX / "pt.json").method.max_depth
    assert scene.arrays.const_emission is not None and 0 < g <= b <= depth
    want = (b + (b < depth)) + len(scene.kinds) * b + 3 * g + 2
    assert (c["samples"], c["host_reads"]) == (1, want)
    stats.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _render(scene, spp=1, seed=seed)
    snap = stats.snapshot()
    reads = {k: v[0] for k, v in snap["spans"].items() if k.startswith("read.")}
    assert snap["counts"]["host_reads"] == want == sum(reads.values())
    assert reads == {"read.any_live": b + (b < depth), "read.kind_rows": len(scene.kinds) * b,
                     "read.albedo_curve": 2 * g, "read.normal_sign": g, "read.sync": 1,
                     "read.image": 1}


class _Blocking(TorchDispatchMode):
    """The ops that block the host on a CUDA tensor (a scalar read, nonzero,
    a boolean mask), each with the spans open around it."""

    SCALAR = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default,
              torch.ops.aten.masked_select.default}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        mask = func is torch.ops.aten.index.Tensor and any(
            i is not None and i.dtype == torch.bool for i in args[1])
        if func in self.SCALAR or mask:
            self.seen.append((str(func), [s.name for s in stats._stack]))
        return func(*args, **(kwargs or {}))


def test_every_blocking_op_is_at_a_read_site(scene):
    """On the CPU the traversal's plain twins stand in for the kernels and
    read the host (the card's kernels do not), so ops inside a traversal.*
    span are left out; every other blocking op runs in a read.* span."""
    with profile(activities=[ProfilerActivity.CPU]), _Blocking() as mode:
        _render(scene, spp=1)
    assert mode.seen
    outside = [(f, open_) for f, open_ in mode.seen
               if not any(n.startswith("traversal.") for n in open_)
               and not (open_ and open_[-1].startswith("read."))]
    assert not outside, outside[:5]


def test_no_span_opens_inside_the_traversal(scene):
    """The profiler gives a device record to the innermost range open
    around its launch alone, and the benchmark times the traversal by its
    own range around Scene.intersect and Scene.occlude: no program span may
    open inside those two, so traversal.* wraps their callers."""
    calls = []

    def wrap(name):
        real = getattr(scene, name)

        def call(*args, **kw):
            before = stats.snapshot()["spans"]
            out = real(*args, **kw)
            calls.append((name, before == stats.snapshot()["spans"]))
            return out
        return call

    scene.intersect, scene.occlude = wrap("intersect"), wrap("occlude")
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            _render(scene, spp=1)
    finally:
        del scene.intersect, scene.occlude
    assert {n for n, _ in calls} == {"intersect", "occlude"}
    assert all(same for _, same in calls)
    assert {"traversal.intersect", "traversal.occlude"} <= set(stats.snapshot()["spans"])


def test_metric_readers_read_a_traced_render(scene):
    for name in READERS:  # a run without --trace 1
        assert _reader(name)({"trace": None}) is None
    stats.reset()
    _render(scene)
    run = {"trace": {"samples": SPP}}
    for name in READERS[1:]:  # no span was timed
        assert _reader(name)(run) is None
    with profile(activities=[ProfilerActivity.CPU]):
        _render(scene)
    for name in READERS:
        v = _reader(name)(run)
        assert v is not None and math.isfinite(v) and v > 0, name
    assert _reader("shade_host_share_pct")(run) < 100.0


def test_metric_readers_read_nothing_from_a_package_without_the_api(monkeypatch):
    """The benchmark's readers also run over a checkout of the package from
    before its counters and spans: there they return None and do not raise."""
    monkeypatch.delattr(stats, "snapshot")
    for name in READERS:
        assert _reader(name)({"trace": {"samples": SPP}}) is None, name


def test_mcmc_graph_step_pct_reads_the_step_counters(monkeypatch):
    """The reader of mcmc_graph_step_pct: 100 x mcmc_graph_steps / (that +
    mcmc_eager_steps) from stats.snapshot() in a traced run; None in a run
    without --trace 1, where no step ran, and from a package without the
    two counters (the benchmark also reads a checkout from before them)."""
    read = _reader("mcmc_graph_step_pct")
    run = {"trace": {"samples": SPP}}
    monkeypatch.setitem(stats.counts, "mcmc_graph_steps", 31)
    monkeypatch.setitem(stats.counts, "mcmc_eager_steps", 1)
    assert read(run) == pytest.approx(96.875)
    assert read({"trace": None}) is None
    monkeypatch.setitem(stats.counts, "mcmc_eager_steps", 0)
    assert read(run) == pytest.approx(100.0)
    monkeypatch.setitem(stats.counts, "mcmc_graph_steps", 0)
    assert read(run) is None
    older = {k: v for k, v in stats.counts.items() if not k.startswith("mcmc_")}
    monkeypatch.setattr(stats, "snapshot", lambda: {"counts": dict(older), "spans": {}})
    assert read(run) is None
    monkeypatch.delattr(stats, "snapshot")
    assert read(run) is None


def test_gpt_spans_and_counters_under_a_profiler(scene):
    """render_gpt (the reconnection shift on the per-kind dispatch, d3)
    under a profiler: render.job once, render.sample a sample, gpt.base a
    sample, gpt.shift four times a sample, gpt.films, render.finish and
    gpt.solve once, and the dispatch's shade.0; the counters gpt_shifts
    and gpt_shift_lanes count the shifts and their lanes (a pixel each)
    with the profiler on or off; gpt_dispatch_host_ms_per_sample reads
    the shade.<k> spans' host time over the samples."""
    stats.reset()
    render_gpt(scene, GPTConfig(spp=SPP, max_depth=3))
    assert stats.snapshot()["spans"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        render_gpt(scene, GPTConfig(spp=SPP, max_depth=3))
    snap = stats.snapshot()
    s, c = snap["spans"], snap["counts"]
    for name, calls in (("render.job", 1), ("render.sample", SPP), ("gpt.base", SPP),
                        ("gpt.shift", 4 * SPP), ("render.finish", 1), ("gpt.solve", 1)):
        assert s[name][0] == calls, name
    assert s["gpt.films"][0] >= SPP and s["shade.0"][0] > 0
    assert c["gpt_shifts"] == 2 * 4 * SPP
    assert c["gpt_shift_lanes"] == 2 * 4 * SPP * RES * RES
    v = _reader("gpt_dispatch_host_ms_per_sample")({"trace": {"samples": SPP}})
    assert v == pytest.approx(s["shade.0"][1] / SPP / 1e6)
    assert 0 < v < s["render.sample"][1] / SPP / 1e6


def test_gpt_dispatch_reader_reads_nothing_without_the_spans(monkeypatch):
    """gpt_dispatch_host_ms_per_sample is None in a run without --trace 1,
    where no shade.<k> or render.sample span was timed (a render_gpt from
    before its spans opens shade.<k> alone), and from a package without
    stats.snapshot."""
    read = _reader("gpt_dispatch_host_ms_per_sample")
    run = {"trace": {"samples": SPP}}
    assert read({"trace": None}) is None
    for spans in ({}, {"shade.0": [4, 10_000, 10_000]}, {"render.sample": [2, 50_000, 0]}):
        monkeypatch.setattr(stats, "snapshot", lambda spans=spans: {"counts": {}, "spans": spans})
        assert read(run) is None, spans
    monkeypatch.delattr(stats, "snapshot")
    assert read(run) is None
