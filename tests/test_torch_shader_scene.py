"""PyTorch port, the shader-ops fixture end to end (tests/torch_shader_scene.py:
noise-textured plastic and gold, an absorbing plastic, copper, and a
principled panel with every lobe on) rendered by both packages, the
combinator principled against the fused one in a render, and the fused
tiers' bake following AKR_FUSED_PRINCIPLED as the JAX package's does."""
from pathlib import Path

import numpy as np
import pytest
import torch

from akari_render_tpu.config import PTConfig as JPTConfig
from akari_render_tpu.integrators.megakernel import _bake_shading as j_bake_shading
from akari_render_tpu.integrators.pt import render_pt as j_render_pt
from akari_render_tpu.scene import load_scene as j_load_scene
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch.config import PTConfig
from akari_render_tpu_torch.integrators.pt import render_pt as t_render_pt
from akari_render_tpu_torch.scene import load_scene as t_load_scene
from akari_render_tpu_torch.svm import reduced
from torch_shader_scene import write_shader_scene

ROOT = Path(__file__).resolve().parents[1]
CBOX = ROOT / "scenes/cbox/scene.json"


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


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    return write_shader_scene(tmp_path_factory.mktemp("shader_ops"), res=16)


def test_fixture_loads_every_new_op(fixture, jax_table):
    """The fixture's kinds hold noise (1-4D), plastic, metal and the
    principled BSDF, and load_scene takes them (check_kind no longer
    refuses them)."""
    scene = t_load_scene(fixture, device="cpu", ggx_table=jax_table)
    ops = {node[0] for kind in scene.kinds for node in kind.nodes}
    assert {"noise", "plastic", "metal", "principled", "mix_bsdf"} <= ops
    dims = {node[1] for kind in scene.kinds for node in kind.nodes if node[0] == "noise"}
    assert dims == {1, 2, 3, 4}
    assert scene.shade_bake is None  # plastic, metal and noise are not in K8's and K9's scope


def test_fixture_render_matches_jax(fixture, jax_table):
    """16x16, 4 spp, d5 through both packages (independent sampler, seed
    0): the same draws and decisions, so the images agree to float
    rounding (channel means within 1 %, 95 % of the pixels within 1e-3
    relative; measured: every pixel, max abs 3.9e-6)."""
    jimg, _ = j_render_pt(j_load_scene(fixture), JPTConfig(spp=4, spp_per_pass=4, max_depth=5))
    timg, stats = t_render_pt(t_load_scene(fixture, device="cpu", ggx_table=jax_table),
                              PTConfig(spp=4, spp_per_pass=4, max_depth=5))
    jimg = np.asarray(jimg)
    assert timg.shape == jimg.shape == (16, 16, 3) and np.all(np.isfinite(timg))
    assert stats["shade"] == "dispatch"
    np.testing.assert_allclose(timg.mean(axis=(0, 1)), jimg.mean(axis=(0, 1)), rtol=0.01)
    rel = np.abs(timg - jimg) / np.maximum(np.abs(jimg), 1e-3)
    assert np.mean(np.all(rel <= 1e-3, axis=-1)) >= 0.95


def test_combinator_render_matches_fused(fixture, jax_table, monkeypatch):
    """The fixture rendered with the combinator principled
    (AKR_FUSED_PRINCIPLED=0, read at each closure build) and with the fused
    one: the closures agree to float rounding (tests/test_torch_shader_ops
    .py), so the images do too, within 1e-4 relative on the channel means
    and 1e-3 on 95 % of the pixels (measured: the means to 1e-7)."""
    scene = t_load_scene(fixture, device="cpu", ggx_table=jax_table)
    cfg = PTConfig(spp=4, spp_per_pass=4, max_depth=5)
    fused, _ = t_render_pt(scene, cfg)
    monkeypatch.setenv("AKR_FUSED_PRINCIPLED", "0")
    tree, _ = t_render_pt(scene, cfg)
    assert np.all(np.isfinite(tree))
    np.testing.assert_allclose(tree.mean(axis=(0, 1)), fused.mean(axis=(0, 1)), rtol=1e-4)
    rel = np.abs(tree - fused) / np.maximum(np.abs(fused), 1e-3)
    assert np.mean(np.all(rel <= 1e-3, axis=-1)) >= 0.95


@pytest.mark.parametrize("fused", ["1", "0"])
def test_bake_follows_fused_principled(jax_table, monkeypatch, fused):
    """cbox's one principled kind bakes into K8's and K9's table only with
    the fused closure, in both packages: under AKR_FUSED_PRINCIPLED=0 the
    closure is the combinator tree, which the bake refuses."""
    monkeypatch.setenv("AKR_FUSED_PRINCIPLED", fused)
    scene = t_load_scene(str(CBOX), 8, 8, device="cpu", ggx_table=jax_table)
    j_baked = j_bake_shading(j_load_scene(str(CBOX), 8, 8))
    assert (scene.shade_bake is not None) == (j_baked is not None) == (fused == "1")
    if fused == "1":  # JAX's table leaves _MT_ROUGH free; the port's holds the roughness
        got, want = scene.shade_bake[0].numpy(), np.asarray(j_baked[0])
        others = np.arange(reduced.MAT_COLS) != reduced._MT_ROUGH
        np.testing.assert_allclose(got[:, others], want[:, others], rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(got[:, reduced._MT_ROUGH],
                                      np.sqrt(got[:, reduced._MT_ALPHA]))
