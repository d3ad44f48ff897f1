"""PyTorch port, the persistent wavefront (integrators/wavefront.py) on the
cbox stand-in at 32x32: JAX's tests/test_wavefront.py cases, each held
against the JAX package's render_pt_wavefront and against the port's own
pass (render_pt) on the CPU. Every item's radiance is the pass's; the
film's accumulation order differs, so the images agree to tolerance."""
from pathlib import Path

import numpy as np
import pytest
import torch

from akari_render_tpu.config import PTConfig as JPTConfig
from akari_render_tpu.config import RenderTask as JRenderTask
from akari_render_tpu.integrators.wavefront import render_pt_wavefront as j_render_wavefront
from akari_render_tpu.scene import load_scene as j_load_scene
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch.config import PTConfig
from akari_render_tpu_torch.config import RenderTask
from akari_render_tpu_torch.integrators import wavefront
from akari_render_tpu_torch.integrators.pt import render_pt as t_render_pt
from akari_render_tpu_torch.scene import load_scene as t_load_scene

ROOT = Path(__file__).resolve().parents[1]
CBOX = ROOT / "scenes/cbox/scene.json"
RES = 32
SWITCHES = ("AKR_FUSE_RAYS", "AKR_SPLIT_DEPTH", "AKR_PERSISTENT", "AKR_MAX_LANES",
            "AKR_WF_ITERS", "AKR_PALLAS_SHADE", "AKR_MEGAKERNEL")
# name -> (PTConfig fields, switches on both sides, sampler)
CASES = {
    "default_pool": (dict(spp=4, max_depth=5, rr_depth=3), {}, None),
    # JAX's small-pool case also caps its dispatches (AKR_WF_ITERS, not ported)
    "small_pool": (dict(spp=2, max_depth=4, rr_depth=2),
                   {"AKR_MAX_LANES": "1024", "AKR_WF_ITERS": "7"}, None),
    "deep_rr": (dict(spp=2, max_depth=8, rr_depth=1), {}, None),
    "pmj02bn": (dict(spp=4, max_depth=4, rr_depth=3, spp_per_pass=4), {},
                {"type": "pmj02bn", "seed": 0}),
    "fused": (dict(spp=8, max_depth=6, rr_depth=3, spp_per_pass=8), {"AKR_FUSE_RAYS": "1"},
              None),
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _switches_off(monkeypatch):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def scenes():
    table = np.asarray(j_get_table("ggx_dielectric_s"))
    return (j_load_scene(str(CBOX), RES, RES),
            t_load_scene(str(CBOX), RES, RES, device="cpu", ggx_table=table))


@pytest.mark.parametrize("case", list(CASES))
def test_wavefront_matches_jax_and_pass(case, scenes, monkeypatch):
    """The port's wavefront (through render_pt under AKR_PERSISTENT=1)
    within JAX's rtol=2e-4, atol=2e-5 of JAX's render_pt_wavefront and of
    the port's pass; under fused rays also of the port's sequential
    wavefront at rtol=1e-4, atol=1e-5 (measured on the CPU: every case
    within 3e-7 of both)."""
    js, ts = scenes
    fields, env, sampler = CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jtask = JRenderTask(method_type="pt", method=None, sampler=sampler) if sampler else None
    ttask = RenderTask(method_type="pt", method=None, sampler=sampler) if sampler else None
    want, _ = j_render_wavefront(js, JPTConfig(**fields), task=jtask)
    want = np.asarray(want)
    passed, pstats = t_render_pt(ts, PTConfig(**fields), ttask)
    monkeypatch.setenv("AKR_PERSISTENT", "1")
    got, stats = t_render_pt(ts, PTConfig(**fields), ttask)
    assert stats["tier"] == "persistent" and pstats["tier"] == "wavefront"
    assert stats["spp_total"] == fields["spp"] and stats["shade"] == "dispatch"
    assert stats["pool"] == min(RES * RES * fields["spp"], 1024)
    assert stats["refills"] >= 2 and stats["fused_rays"] == (case == "fused")
    assert got.shape == (RES, RES, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, passed, rtol=2e-4, atol=2e-5)
    if case == "fused":
        monkeypatch.setenv("AKR_FUSE_RAYS", "0")
        seq, _ = t_render_pt(ts, PTConfig(**fields), ttask)
        np.testing.assert_allclose(got, seq, rtol=1e-4, atol=1e-5)


def test_pool_and_refill_gate(scenes, monkeypatch):
    """The pool is one wavefront of all pixels, or AKR_MAX_LANES (at least
    1,024), never more than the items; the refill waits for a quarter of
    the pool to die, so a render refills fewer times than it bounces."""
    _, ts = scenes
    cfg = PTConfig(spp=2, max_depth=6, rr_depth=2)
    for lanes, pool in ((None, 1024), ("10", 1024), ("1500", 1500), ("5000", 2048)):
        if lanes:
            monkeypatch.setenv("AKR_MAX_LANES", lanes)
        _, stats = wavefront.render_pt_wavefront(ts, cfg)
        assert stats["pool"] == pool and 2 <= stats["refills"] < stats["bounces"], lanes
