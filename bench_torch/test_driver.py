"""The harness's render jobs against direct calls of the program's entries,
on the CPU in seconds.

    python -m pytest bench_torch/test_driver.py -q

An MCMC job (harness.Program.render on an "mcmc_opt" configuration) must be
one render_mcmc call keyed by the job's key as the task's seed, with a
sampler of seed 0: the same image as that call made directly. A PT job
must stay the one render_pt call it was: the same configuration and task.
"""
from __future__ import annotations

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
