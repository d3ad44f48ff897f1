"""PyTorch port, the slice end to end: matbox through the JAX package's and
the port's path tracer at the same seed, the pass on the cbox stand-in in
several configurations, and the port's CLI."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from akari_render_tpu.config import PTConfig as JPTConfig
from akari_render_tpu.config import RenderTask as JRenderTask
from akari_render_tpu.integrators.pt import render_pt as j_render_pt
from akari_render_tpu.scene import load_scene as j_load_scene
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch import cli
from akari_render_tpu_torch.config import PTConfig as TPTConfig
from akari_render_tpu_torch.config import RenderTask as TRenderTask
from akari_render_tpu_torch.core.image_io import read_exr
from akari_render_tpu_torch.integrators.pt import render_pt as t_render_pt
from akari_render_tpu_torch.scene import load_scene as t_load_scene
from akari_render_tpu_torch.svm import precompute as t_pre

ROOT = Path(__file__).resolve().parents[1]
SCENE = ROOT / "scenes/matbox/scene.json"
METHOD = ROOT / "scenes/matbox/pt.json"
CBOX = ROOT / "scenes/cbox/scene.json"
# name -> (PTConfig fields, sampler) of the cbox 32x32 pass cases
PASS_CASES = {
    "spp4_d5_rr3": (dict(spp=4, max_depth=5, rr_depth=3), None),
    "spp2_d4_rr2": (dict(spp=2, max_depth=4, rr_depth=2), None),
    "spp2_d8_rr1": (dict(spp=2, max_depth=8, rr_depth=1), None),
    "pmj02bn_spp4_d4_rr3": (dict(spp=4, max_depth=4, rr_depth=3, spp_per_pass=4),
                            {"type": "pmj02bn", "seed": 0}),
    "spp8_d6_rr3": (dict(spp=8, max_depth=6, rr_depth=3, spp_per_pass=8), None),
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_table():
    return np.asarray(j_get_table("ggx_dielectric_s"))


@pytest.fixture
def port_uses_jax_table(jax_table, monkeypatch):
    """The CLI computes the port's own GGX table by default; hand it the
    JAX package's instead (the process cache), which also skips the MC."""
    monkeypatch.setitem(t_pre._cache, t_pre.TABLE_NAME, jax_table)


def test_slice_matches_jax(jax_table):
    """matbox 32x32, 8 spp, d12, rr 5, independent sampler seed 0 through
    both packages with the same GGX table. The sampler streams are
    bit-exact, so paths make the same decisions; measured on the CPU: all
    1024 pixels within 1e-3 relative, max abs pixel difference 1.7e-4,
    channel means within 5e-7 relative."""
    jtask = JRenderTask.from_file(METHOD)
    ttask = TRenderTask.from_file(METHOD)
    for task in (jtask, ttask):
        task.method.spp = 8
        task.method.spp_per_pass = 8
    jimg, _ = j_render_pt(j_load_scene(str(SCENE), 32, 32), jtask.method, jtask)
    timg, stats = t_render_pt(
        t_load_scene(str(SCENE), 32, 32, device="cpu", ggx_table=jax_table), ttask.method, ttask
    )
    jimg = np.asarray(jimg)
    assert timg.shape == jimg.shape == (32, 32, 3)
    assert np.all(np.isfinite(timg))
    assert stats["spp_total"] == 8
    jm, tm = jimg.mean(axis=(0, 1)), timg.mean(axis=(0, 1))
    np.testing.assert_allclose(tm, jm, rtol=0.01)
    rel = np.abs(timg - jimg) / np.maximum(np.abs(jimg), 1e-3)
    assert np.mean(np.all(rel <= 1e-3, axis=-1)) >= 0.95


@pytest.mark.parametrize("case", list(PASS_CASES))
def test_pass_matches_jax(case, jax_table, monkeypatch):
    """cbox 32x32 through the port's default pass and the JAX package's
    render_pt, both on the per-kind dispatch with the same GGX table:
    within rtol=2e-4, atol=2e-5 (the sampler streams are bit-exact, so
    the paths make the same decisions)."""
    for k in ("AKR_SPLIT_DEPTH", "AKR_PALLAS_SHADE", "AKR_MEGAKERNEL"):
        monkeypatch.delenv(k, raising=False)
    fields, sampler = PASS_CASES[case]
    jtask = JRenderTask(method_type="pt", method=None, sampler=sampler) if sampler else None
    ttask = TRenderTask(method_type="pt", method=None, sampler=sampler) if sampler else None
    want, _ = j_render_pt(j_load_scene(str(CBOX), 32, 32), JPTConfig(**fields), task=jtask)
    got, stats = t_render_pt(t_load_scene(str(CBOX), 32, 32, device="cpu", ggx_table=jax_table),
                             TPTConfig(**fields), ttask)
    assert stats["tier"] == "wavefront" and stats["shade"] == "dispatch"
    assert stats["spp_total"] == fields["spp"]
    assert got.shape == (32, 32, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-5)


def test_cli_writes_exr_and_stats(tmp_path, port_uses_jax_table):
    out = tmp_path / "matbox.exr"
    stats = cli.main(["-s", str(SCENE), "-m", str(METHOD), "--res", "12", "--spp", "2",
                      "-o", str(out), "--save-stats", "--device", "cpu"])
    img = read_exr(out)
    assert img.shape == (12, 12, 3) and np.all(np.isfinite(img)) and img.mean() > 0.0
    saved = json.loads(out.with_suffix(".stats.json").read_text())
    assert saved["spp_total"] == stats["spp_total"] == 2
    assert json.loads((tmp_path / "matbox.json").read_text())["intermediate"][-1]["spp"] == 2


def test_cli_refuses_unported_methods(tmp_path, port_uses_jax_table):
    """Every method type of the reference's method JSON renders: gpt, mcmc
    and mcmc_opt write an 8x8 EXR on the CPU (small configurations: d3,
    64 chains from 256 bootstrap samples); a type no package knows exits
    with "unknown method"."""
    small = {"gpt": {"spp": 1, "max_depth": 3},
             "mcmc": {"spp": 2, "max_depth": 3, "n_chains": 64, "n_bootstrap": 256,
                      "direct_spp": 1}}
    small["mcmc_opt"] = small["mcmc"]
    for kind, cfg in small.items():
        method = tmp_path / f"{kind}.json"
        method.write_text(json.dumps({"method": {"type": kind, **cfg}}))
        out = tmp_path / f"{kind}.exr"
        cli.main(["-s", str(SCENE), "-m", str(method), "--res", "8", "-o", str(out),
                  "--device", "cpu"])
        img = read_exr(out)
        assert img.shape == (8, 8, 3) and np.all(np.isfinite(img)) and img.mean() > 0.0, kind
    method = tmp_path / "bdpt.json"
    method.write_text(json.dumps({"method": {"type": "bdpt"}}))
    with pytest.raises(SystemExit, match="unknown method: bdpt"):
        cli.main(["-s", str(SCENE), "-m", str(method), "--device", "cpu"])


def test_cli_cuda_without_card_exits():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli.main(["-s", str(SCENE), "-m", str(METHOD), "--device", "cuda"])
