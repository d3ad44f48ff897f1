"""The comparison that decides `correct`, at a size a CPU test run holds.

    python -m pytest bench_torch/test_checks.py -q

The harness's look for a card is skipped (run.measure on the CPU, the
kernels' plain versions, 64x64); everything else of a run is driven. A
sound run is correct; the control (the reference in TF32 and bfloat16 in
the program's place) and each fault a render job can have, planted
underneath the timed path, make `correct` false. So for the MCMC cell, at
64x64 with its chains and bootstrap cut with the pixels, and for the GPT
cell, at 32x32.
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SIZE = 64
CELL = "cbox-pt-final"


def measure(size: int = SIZE):
    from bench_torch import run

    return run.measure(CELL, 987654321012, 0.1, False, device="cpu", width=size, height=size,
                       log=lambda *a, **k: None)


def failed(out) -> list[str]:
    return [k for k, c in out["checks"].items() if c["value"] > c["limit"]]


def test_sound_run_is_correct():
    out = measure()
    assert out["correct"], out["checks"]


def test_control_fails():
    from bench_torch import control

    rows = control.readings(CELL, [5, 6, 7], True, 2, device="cpu", width=SIZE, height=SIZE,
                            out=lambda *a, **k: None)
    from bench_torch import harness

    limits = harness.load_config("cbox-1024-pmj02")["correct_limits"]
    for row in rows:
        assert any(row[k] > v for k, v in limits.items()), row


def _zero_image(pt, monkeypatch):
    real = pt.render_pt

    def render_pt(*a, **k):  # a job that leaves its film as it found it
        img, stats = real(*a, **k)
        return img * 0.0, stats
    monkeypatch.setattr(pt, "render_pt", render_pt)


def _stale_image(pt, monkeypatch):
    real, last = pt.render_pt, {}

    def render_pt(*a, **k):  # every job returns the first job's image
        img, stats = real(*a, **k)
        return last.setdefault("img", img), stats
    monkeypatch.setattr(pt, "render_pt", render_pt)


def _half_batch(pt, monkeypatch):
    real = pt.render_sample

    def render_sample(*a, **k):  # odd lanes left out, filled with the mean of the rest
        radiance, fw = real(*a, **k)
        radiance = radiance.clone()
        radiance[1::2] = radiance[0::2].mean(0)
        return radiance, fw
    monkeypatch.setattr(pt, "render_sample", render_sample)


def _light_dropped(pt, monkeypatch):
    from akari_render_tpu_torch.integrators import common

    real = common.nee_light_sample

    def nee_light_sample(*a, **k):  # the light that NEE brings is lost where it is sampled
        ls = real(*a, **k)
        return ls._replace(li=ls.li * 0.0)
    monkeypatch.setattr(common, "nee_light_sample", nee_light_sample)


def _hit_altered(pt, monkeypatch):
    from akari_render_tpu_torch.accel.trace import Hit
    from akari_render_tpu_torch.scene import Scene

    real = Scene.intersect

    def intersect(self, *a, **k):  # t moved by 0.1 % on every fourth lane
        h = real(self, *a, **k)
        t = h.t.clone()
        t[::4] = t[::4] * 1.001
        return Hit(t, h.tri_id, h.bary, h.valid)
    monkeypatch.setattr(Scene, "intersect", intersect)


def _camera_altered(pt, monkeypatch):
    real = pt.generate_rays

    def generate_rays(camera, p_film):  # every ray aimed two pixels to the right
        return real(camera, p_film + p_film.new_tensor([2.0, 0.0]))
    monkeypatch.setattr(pt, "generate_rays", generate_rays)


# at 64x64 a tile holds 16 pixels of one 16-spp job: too few to see a
# lane-level fault; at 128x128 it holds 64
@pytest.mark.parametrize("fault,expect,size", [
    (_zero_image, "tile_chi2", SIZE),
    (_stale_image, "repeat_pct", SIZE),
    (_half_batch, "tile_chi2", 2 * SIZE),
    (_light_dropped, "tile_chi2", SIZE),
    (_hit_altered, "hit_gap_pct", SIZE),
    (_camera_altered, "camera_px", SIZE),
])
def test_fault_fails(fault, expect, size, monkeypatch):
    from akari_render_tpu_torch.integrators import pt

    fault(pt, monkeypatch)
    out = measure(size)
    assert not out["correct"]
    assert expect in failed(out), out["checks"]


# The MCMC cell at 64x64: a chain a 16 pixels and 16 bootstrap candidates a
# chain, as configured, so a job keeps its 32 steps a chain; 16 jobs a
# window and 4 x 4 tiles (256 pixels a tile, against 4,096 on the card) so
# that the image's number sees a bias of a few per cent as the card's does.
MCMC_CELL = "cbox-mcmc-final"
MCMC_JOBS = 16
MCMC_TILES = 4


def mcmc_at(monkeypatch, size: int):
    """The MCMC configuration at size x size, as above."""
    from bench_torch import harness
    from bench_torch.selfcheck import scaled_method

    real = harness.load_config

    def load_config(name, spec=None):
        c = real(name, spec)
        return dict(c, method=scaled_method(c["method"], size * size, c["width"] * c["height"]),
                    reference=dict(c["reference"], tiles=MCMC_TILES))
    monkeypatch.setattr(harness, "load_config", load_config)


def measure_mcmc(size: int = SIZE):
    from bench_torch import run

    return run.measure(MCMC_CELL, 987654321012, 1e9, False, device="cpu", width=size,
                       height=size, log=lambda *a, **k: None, max_jobs=MCMC_JOBS)


def test_mcmc_sound_run_is_correct(monkeypatch):
    mcmc_at(monkeypatch, SIZE)
    out = measure_mcmc()
    assert out["attempted"] == MCMC_JOBS
    assert out["correct"], out["checks"]


def test_mcmc_control_fails(monkeypatch):
    from bench_torch import control, harness

    mcmc_at(monkeypatch, SIZE)
    rows = control.readings(MCMC_CELL, [5], True, MCMC_JOBS, device="cpu", width=SIZE,
                            height=SIZE, out=lambda *a, **k: None)
    limits = harness.load_config("cbox-1024-mcmc-gpu")["correct_limits"]
    for row in rows:
        assert row["job_chi2"] > limits["job_chi2"], row


def _b_scaled(mcmc, monkeypatch):
    real = mcmc.develop

    def develop(film, width, height, splat_scale=1.0):  # the normaliser b taken 5 % low
        return real(film, width, height, splat_scale * 0.95)
    monkeypatch.setattr(mcmc, "develop", develop)


def _direct_dropped(mcmc, monkeypatch):
    import numpy as np

    from akari_render_tpu_torch.integrators import pt

    def render_pt(scene, config, task=None, **k):  # the depth-1 direct pass left out
        cam = scene.camera
        return np.zeros((cam.height, cam.width, 3), np.float32), {"total_time": 0.0}
    monkeypatch.setattr(pt, "render_pt", render_pt)


def _rejected_dropped(mcmc, monkeypatch):
    real, calls = mcmc.add_splats, [0]

    def add_splats(*a, **k):  # a step splats the proposal (weight a), not the current state
        calls[0] += 1
        if calls[0] % 2:
            real(*a, **k)
    monkeypatch.setattr(mcmc, "add_splats", add_splats)


def _half_chains(mcmc, monkeypatch):
    import torch

    real = mcmc.add_splats

    def add_splats(film, p, color, weight, width, height, mask=None):  # odd chains left out
        keep = torch.arange(p.shape[0], device=p.device) % 2 == 0
        real(film, p, color, weight, width, height, mask=keep if mask is None else mask & keep)
    monkeypatch.setattr(mcmc, "add_splats", add_splats)


# at 64x64 a tile holds 256 pixels of 16 jobs: too few to see b taken 5 %
# low (2.79 against a sound 1.43 at 4 spp a job); at 128x128 it holds 1,024
# (6.87 against a sound 0.45-1.80 at 2)
@pytest.mark.parametrize("fault,expect,size", [
    (_b_scaled, "job_chi2", 2 * SIZE),
    (_direct_dropped, "camera_px", SIZE),
    (_rejected_dropped, "job_chi2", SIZE),
    (_half_chains, "job_chi2", SIZE),
])
def test_mcmc_fault_fails(fault, expect, size, monkeypatch):
    from akari_render_tpu_torch.integrators import mcmc

    mcmc_at(monkeypatch, size)
    fault(mcmc, monkeypatch)
    out = measure_mcmc(size)
    assert not out["correct"]
    assert expect in failed(out), out["checks"]


# The GPT cell at 32x32: a job keeps its 2 samples a pixel, each a base path
# and four shifts; 16 jobs a window and 4 x 4 tiles (64 pixels a tile).
GPT_CELL = "cbox-gpt-final"
GPT_SIZE = 32
GPT_JOBS = 16
GPT_TILES = 4
# The cell and its configuration as BENCHMARK.json would list them. It does
# not list them: the port's gradient films hold half of the difference that
# its screened-Poisson solve reads them as, so grad_chi2 fails the port on
# every seed (PERF.md, Open questions). Here the cell is driven with the
# films at full strength (full_strength), as a port that adds both ends of
# a pair into one gradient pixel holds them.
GPT_CONFIG = {"name": "cbox-1024-gpt", "source": "gpt.rs",
              "file": "bench_torch/configs/cbox-1024-gpt.json", "reduced": ["spp"],
              "why": "the gradient-domain path tracer"}
GPT_WORKLOAD = {"name": GPT_CELL, "config": "cbox-1024-gpt", "traffic": "final-job",
                "chips": 1, "why": "back-to-back 2-spp GPT jobs"}


def full_strength(monkeypatch):
    from akari_render_tpu_torch.integrators import gpt

    real = gpt.screened_poisson

    def screened_poisson(primal, gx, gy, variances=None, iters=30):
        # a gradient pixel holds the mean of a pair's two ends, and their sum
        # is the difference I(q) - I(p) that the solve reads (the job's stats
        # keep these films)
        return real(primal, gx.mul_(2), gy.mul_(2), variances, iters)
    monkeypatch.setattr(gpt, "screened_poisson", screened_poisson)


def gpt_at(monkeypatch):
    from bench_torch import harness

    real_spec, real = harness.benchmark, harness.load_config

    def benchmark():
        spec = real_spec()
        spec["configs"].append(GPT_CONFIG)
        spec["workloads"].append(GPT_WORKLOAD)
        return spec

    def load_config(name, spec=None):
        c = real(name, spec)
        return dict(c, reference=dict(c["reference"], tiles=GPT_TILES))
    monkeypatch.setattr(harness, "benchmark", benchmark)
    monkeypatch.setattr(harness, "load_config", load_config)
    full_strength(monkeypatch)


def measure_gpt(size: int = GPT_SIZE):
    from bench_torch import run

    return run.measure(GPT_CELL, 987654321012, 1e9, False, device="cpu", width=size,
                       height=size, log=lambda *a, **k: None, max_jobs=GPT_JOBS)


def test_gpt_sound_run_is_correct(monkeypatch):
    gpt_at(monkeypatch)
    out = measure_gpt()
    assert out["attempted"] == GPT_JOBS
    assert out["correct"], out["checks"]


def test_gpt_control_fails(monkeypatch):
    from bench_torch import control, harness

    gpt_at(monkeypatch)
    rows = control.readings(GPT_CELL, [5], True, GPT_JOBS, device="cpu", width=GPT_SIZE,
                            height=GPT_SIZE, out=lambda *a, **k: None)
    limits = harness.load_config("cbox-1024-gpt")["correct_limits"]
    for row in rows:
        assert any(row[k] > v for k, v in limits.items()), row


def _jacobian_one(gpt, monkeypatch):
    real = gpt.trace_shift_reconnect

    def trace_shift_reconnect(*a, **k):  # the reconnection's jacobian taken as 1
        parts, jac, success, sampler = real(*a, **k)
        return parts, jac * 0.0 + 1.0, success, sampler
    monkeypatch.setattr(gpt, "trace_shift_reconnect", trace_shift_reconnect)


def _failed_shift_succeeds(gpt, monkeypatch):
    real = gpt.trace_shift_reconnect

    def trace_shift_reconnect(*a, **k):  # a failed shift paired as a jacobian-1 success
        parts, jac, success, sampler = real(*a, **k)
        return parts, jac.where(success, 1.0), success | True, sampler
    monkeypatch.setattr(gpt, "trace_shift_reconnect", trace_shift_reconnect)


def _primal_at_pixel(gpt, monkeypatch):
    real = gpt._camera

    def _camera(scene, filt, pix, sampler):  # the primal binned at the sample's pixel
        p_film, *rest = real(scene, filt, pix, sampler)
        return (pix.to(p_film.dtype) + 0.5, *rest)
    monkeypatch.setattr(gpt, "_camera", _camera)


def _no_sweeps(gpt, monkeypatch):
    real = gpt.screened_poisson

    def screened_poisson(primal, gx, gy, variances=None, iters=30):  # the solve skipped
        return real(primal, gx, gy, variances, iters=0)
    monkeypatch.setattr(gpt, "screened_poisson", screened_poisson)


def _shift_dropped(gpt, monkeypatch):
    monkeypatch.setattr(gpt, "OFFSETS", gpt.OFFSETS[:3])  # the -y shift left out


# at 32x32 a pair of tiles holds 64 pixels of 16 jobs: too few to see a
# failed shift paired as a success (2.53 against a sound 0.85); at 64x64 it
# holds 256
@pytest.mark.parametrize("fault,expect,size", [
    (_jacobian_one, "grad_chi2", GPT_SIZE),
    (_failed_shift_succeeds, "grad_chi2", 2 * GPT_SIZE),
    (_primal_at_pixel, "primal_chi2", GPT_SIZE),
    (_no_sweeps, "recon_gap", GPT_SIZE),
    (_shift_dropped, "camera_px", GPT_SIZE),
])
def test_gpt_fault_fails(fault, expect, size, monkeypatch):
    from akari_render_tpu_torch.integrators import gpt

    gpt_at(monkeypatch)
    fault(gpt, monkeypatch)
    out = measure_gpt(size)
    assert not out["correct"]
    assert expect in failed(out), out["checks"]
