"""The harness's render jobs against direct calls of the program's entries,
on the CPU in seconds.

    python -m pytest bench_torch/test_driver.py -q

An MCMC job (harness.Program.render on an "mcmc_opt" configuration) must be
one render_mcmc call keyed by the job's key as the task's seed, with a
sampler of seed 0: the same image as that call made directly. A GPT job
("gpt") must be one render_gpt call keyed by the job's key as the task's
seed. A PT job must stay the one render_pt call it was: the same
configuration and task. The GPT camera rule (check.camera_layout) must
reflect the shifted pixels at the border as the program does.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SIZE = 16
KEY = 0x9E3779B9


@pytest.fixture(scope="module")
def mcmc_conf():
    from bench_torch import harness

    c = harness.load_config("cbox-1024-mcmc-gpu")
    return dict(c, method=dict(c["method"], n_chains=256, n_bootstrap=4096))


def test_mcmc_job_is_one_render_mcmc_call(mcmc_conf):
    from akari_render_tpu_torch.config import MCMCConfig
    from akari_render_tpu_torch.integrators import mcmc

    from bench_torch import harness

    prog = harness.Program(mcmc_conf, "cpu", SIZE, SIZE)
    img, stats = prog.render(KEY, 2)
    task = SimpleNamespace(filter_config={"type": "gaussian", "radius": 1.5}, seed=KEY,
                           sampler={"type": "independent", "seed": 0})
    want, want_stats = mcmc.render_mcmc(prog.scene,
                                        MCMCConfig.from_json(dict(mcmc_conf["method"], spp=2)),
                                        task)
    assert np.array_equal(img, want)
    assert stats["b"] == want_stats["b"] and stats["steps"] == want_stats["steps"] == 2
    assert (stats["tier"], stats["traversal"], stats["color"]) == ("flat", "flat (K1)", "rgb")
    assert stats["shade"] == want_stats["shade"]
    other, _ = prog.render(KEY + 1, 2)
    assert not np.array_equal(img, other)


def test_mcmc_direct_pass_draws_from_the_key(mcmc_conf, monkeypatch):
    from akari_render_tpu_torch.integrators import pt

    from bench_torch import harness

    seen = []
    real = pt.render_pt

    def render_pt(scene, config, task=None, **k):
        seen.append((config.max_depth, config.spp, task.seed, dict(task.sampler)))
        return real(scene, config, task, **k)
    monkeypatch.setattr(pt, "render_pt", render_pt)
    harness.Program(mcmc_conf, "cpu", SIZE, SIZE).render(KEY, 1)
    assert seen == [(1, 1, KEY, {"type": "independent", "seed": 0})]


def test_pt_job_call_unchanged(monkeypatch):
    from akari_render_tpu_torch.config import PTConfig
    from akari_render_tpu_torch.integrators import pt

    from bench_torch import harness

    calls = []

    def render_pt(scene, config, task=None, **k):
        calls.append((config, task, k))
        return np.zeros((SIZE, SIZE, 3), np.float32), {}
    monkeypatch.setattr(pt, "render_pt", render_pt)
    conf = harness.load_config("cbox-1024-pmj02")
    prog = harness.Program(conf, "cpu", SIZE, SIZE)
    prog.render(KEY, 16)
    (config, task, k), = calls
    assert config == PTConfig.from_json({"type": "pt", "max_depth": 12, "rr_depth": 5, "spp": 16,
                                         "spp_per_pass": 16})
    assert vars(task) == {"filter_config": {"type": "gaussian", "radius": 1.5}, "seed": 0,
                          "sampler": {"type": "pmj02bn", "seed": KEY}}
    assert k == {}


def test_camera_layout():
    from bench_torch import check, harness

    method = harness.load_config("cbox-1024-mcmc-gpu")["method"]
    assert check.camera_layout(method, 4, 1024, 1024) == {
        "lanes": 1048576 + 65536 * (1 + 64) + 1024 * 1024, "pixel_calls": 1}
    assert check.camera_layout(harness.load_config("cbox-1024-pmj02")["method"], 16, 1024,
                               1024) is None


@pytest.fixture(scope="module")
def gpt_conf():
    """The GPT configuration's file; BENCHMARK.json lists no GPT cell (see
    test_checks.py)."""
    from bench_torch import harness

    return json.loads((harness.BENCH / "configs" / "cbox-1024-gpt.json").read_text())


def test_gpt_job_is_one_render_gpt_call(gpt_conf, monkeypatch):
    from akari_render_tpu_torch.config import GPTConfig
    from akari_render_tpu_torch.integrators import gpt, mcmc, pt

    from bench_torch import harness

    prog = harness.Program(gpt_conf, "cpu", SIZE, SIZE)
    for other in (pt.render_pt, mcmc.render_mcmc):
        monkeypatch.setattr(sys.modules[other.__module__], other.__name__, None)
    img, stats = prog.render(KEY, 2)
    task = SimpleNamespace(filter_config={"type": "gaussian", "radius": 1.5}, seed=KEY)
    want, want_stats = gpt.render_gpt(prog.scene,
                                      GPTConfig.from_json(dict(gpt_conf["method"], spp=2)), task)
    assert np.array_equal(img, want)
    for k in ("primal", "gx", "gy"):
        assert np.array_equal(stats[k], want_stats[k])
    assert stats["spp_total"] == 2 and stats["shift_mode"] == "reconnect"
    assert (stats["tier"], stats["traversal"], stats["color"]) == ("flat", "flat (K1)", "rgb")
    assert stats["shade"] == want_stats["shade"] == "dispatch"
    other, _ = prog.render(KEY + 1, 2)
    assert not np.array_equal(img, other)


def test_gpt_camera_layout_reflects_at_the_border(gpt_conf):
    import torch

    from bench_torch import check

    layout = check.camera_layout(gpt_conf["method"], 2, 1024, 768)
    assert layout["lanes"] == 5 * 2 * 1024 * 768 and layout["pixel_calls"] == 10
    assert layout["shifts"] == [(0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)]
    corner = torch.tensor([[0, 0], [1023, 767], [5, 0]])
    moved = [check.reflect(corner, off, 1024, 768).tolist() for off in layout["shifts"]]
    assert moved == [[[0, 0], [1023, 767], [5, 0]], [[1, 0], [1022, 767], [6, 0]],
                     [[1, 0], [1022, 767], [4, 0]], [[0, 1], [1023, 766], [5, 1]],
                     [[0, 1], [1023, 766], [5, 1]]]


def test_gpt_job_camera_rays_follow_the_layout(gpt_conf):
    """Every lane of a 16x16 job (the border's too) is kept: its camera
    rays lie within the filter's radius of their reflected pixels, and a
    rule without the shifts reads the width."""
    from bench_torch import check, harness, loop
    from bench_torch.reference import scene as ref_scene

    prog = harness.Program(gpt_conf, "cpu", SIZE, SIZE)
    ic = harness.Intercept(prog.scene, SIZE * SIZE, 3)
    win = loop.run_window(prog, ic, {"checked_first": 1, "check_share": 0.0}, 3, 1e9, 1,
                          max_jobs=1)
    ref = ref_scene.load(harness.ROOT / gpt_conf["scene"], SIZE, SIZE)
    layout = check.camera_layout(gpt_conf["method"], 1, SIZE, SIZE)
    got = check.compare(ref, win["checked"], SIZE, SIZE, "cpu", layout=layout)
    assert got["camera_px"] < 1e-3, got
    unshifted = dict(layout, shifts=[(0, 0)])
    assert check.compare(ref, win["checked"], SIZE, SIZE, "cpu",
                         layout=unshifted)["camera_px"] > 0.5
