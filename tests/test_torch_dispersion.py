"""PyTorch port, dispersion through the hero-wavelength spectral transport:
the JAX package's cases (tests/test_dispersion.py) on the port and the
port against JAX on the dispersive prism. The fixtures come from
tools/make_prism_scene.py (the glass wedge with a Cauchy B of 0.04 um^2,
and with 0)."""
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu.config import PTConfig as JPTConfig
from akari_render_tpu.integrators.pt import render_pt as j_render_pt
from akari_render_tpu.scene import load_scene as j_load_scene
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch import cli
from akari_render_tpu_torch.config import PTConfig
from akari_render_tpu_torch.core.image_io import read_exr
from akari_render_tpu_torch.integrators.pt import render_pt as t_render_pt
from akari_render_tpu_torch.scene import load_scene as t_load_scene
from akari_render_tpu_torch.svm.eval import kind_is_dispersive

ROOT = Path(__file__).resolve().parents[1]


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
def scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("prism")
    for name, b in (("disp", 0.04), ("b0", 0.0)):
        subprocess.run([sys.executable, str(ROOT / "tools/make_prism_scene.py"), str(d / name),
                        str(b)], check=True, cwd=ROOT, capture_output=True)
    return d


def _load(path, table, res=48):
    return t_load_scene(str(path / "scene.json"), res, res, device="cpu", ggx_table=table)


def _render(scene, color, spp=16):
    img, stats = t_render_pt(scene, PTConfig(spp=spp, max_depth=5, spp_per_pass=spp,
                                             color=color))
    assert stats["color"] == color
    return img


def _saturation(img, thresh=0.5):
    """Mean chroma (max-min)/max over bright pixels."""
    m, mn = img.max(-1), img.min(-1)
    mask = m > thresh
    assert mask.sum() > 30, "bright transmitted region missing"
    return float(((m - mn) / np.maximum(m, 1e-6))[mask].mean())


def test_dispersive_kind_flag(scenes, jax_table):
    sc = _load(scenes / "disp", jax_table)
    assert sc.has_dispersion
    assert sum(kind_is_dispersive(k) for k in sc.kinds) == 1
    sc0 = _load(scenes / "b0", jax_table)
    assert not sc0.has_dispersion
    assert not any(kind_is_dispersive(k) for k in sc0.kinds)


@pytest.mark.parametrize("name,expect_move", [("disp", True), ("b0", False)])
def test_closure_ior_depends_on_wavelength(scenes, jax_table, name, expect_move):
    """JAX's case: the dispersive kind's sampled transmission direction
    moves with the hero wavelength, the zero-B kind's does not; and at each
    lambda0 the port samples JAX's direction (within 1e-6)."""
    sc = _load(scenes / name, jax_table)
    jsc = j_load_scene(str(scenes / name / "scene.json"), width=48, height=48)
    ki = max(range(len(sc.kinds)), key=lambda i: kind_is_dispersive(sc.kinds[i]))
    tri = int(np.argmax(sc.arrays.shader_kind.numpy() == ki))
    mat = int(sc.arrays.tri_mat[tri])
    wo = np.asarray([[np.sin(0.6), 0.0, np.cos(0.6)]], np.float32)
    wis = []
    for lam in (450.0, 650.0):
        si = {"mat": torch.tensor([mat], dtype=torch.int32), "uv": torch.zeros((1, 2)),
              "p": torch.zeros((1, 3)), "ng": torch.tensor([[0.0, 0.0, 1.0]]),
              "kind": torch.tensor([ki]),
              "frame": (torch.tensor([[1.0, 0.0, 0.0]]), torch.tensor([[0.0, 1.0, 0.0]]),
                        torch.tensor([[0.0, 0.0, 1.0]]))}
        closure = sc.kind_closure(si, ki, torch.tensor([0]), lambda0=torch.tensor([lam]))
        assert closure.dispersive == expect_move, name
        s = closure.sample(torch.as_tensor(wo), torch.tensor([0.9]), torch.full((1, 2), 0.5))
        assert bool(s["valid"][0]), (name, lam)
        wis.append(s["wi"][0].numpy())
        jsi = {"mat": jnp.asarray([mat]), "uv": jnp.zeros((1, 2)), "p": jnp.zeros((1, 3)),
               "ng": jnp.asarray([[0.0, 0.0, 1.0]]), "kind": jnp.asarray([ki]),
               "frame": (jnp.asarray([[1.0, 0.0, 0.0]]), jnp.asarray([[0.0, 1.0, 0.0]]),
                         jnp.asarray([[0.0, 0.0, 1.0]]))}
        jclosure = jsc.dispatch_closures(jsi, lambda0=jnp.asarray([lam]))[ki][1]
        js_ = jclosure.sample(jnp.asarray(wo), jnp.asarray([0.9]), jnp.full((1, 2), 0.5))
        np.testing.assert_allclose(wis[-1], np.asarray(js_["wi"][0]), atol=1e-6)
        np.testing.assert_allclose(s["f"].numpy(), np.asarray(js_["f"]), rtol=1e-5)
    delta = float(np.linalg.norm(wis[0] - wis[1]))
    if expect_move:
        assert delta > 1e-3, delta  # ~0.1 IOR spread across 450..650
    else:
        assert delta < 1e-7, delta


def test_prism_fringes_only_with_dispersion(scenes, jax_table):
    """JAX's case on the port, its fixture, seed and thresholds (48x48, 16
    spp, d5): RGB is achromatic through the wedge; spectral with B = 0
    shows only wavelength noise; with the Cauchy term, systematic fringes
    (saturation, and the red and blue strip images apart)."""
    sc = _load(scenes / "disp", jax_table)
    rgb = _render(sc, "rgb")
    sp = _render(sc, "spectral")
    sp0 = _render(_load(scenes / "b0", jax_table), "spectral")
    assert np.all(np.isfinite(sp)) and np.all(np.isfinite(sp0))
    assert abs(sp.mean() - rgb.mean()) / rgb.mean() < 0.1
    s_rgb, s_disp, s_b0 = _saturation(rgb), _saturation(sp), _saturation(sp0)
    assert s_rgb < 0.01, s_rgb
    assert s_disp > 0.7, s_disp
    assert s_disp > 1.6 * s_b0, (s_disp, s_b0)

    def centroid_x(img, ch):
        w = img[..., ch] * (img.max(-1) > 0.5)
        return float((w.sum(0) * np.arange(img.shape[1])).sum() / w.sum())

    sep_disp = abs(centroid_x(sp, 0) - centroid_x(sp, 2))
    sep_b0 = abs(centroid_x(sp0, 0) - centroid_x(sp0, 2))
    assert sep_disp > 1.0, sep_disp
    assert sep_disp > 3.0 * max(sep_b0, 0.05), (sep_disp, sep_b0)


def test_prism_spectral_matches_jax(scenes, jax_table):
    """The dispersive prism, spectral, 32x32, 4 spp, d5, independent
    sampler, through both packages: the secondary wavelengths terminate on
    the same lanes, so the images agree to float rounding (channel means
    within 1 %, 95 % of the pixels within 1e-3 relative; measured at
    24x24: every pixel, max abs 5.3e-4 on values up to ~40)."""
    path = scenes / "disp" / "scene.json"
    jimg, _ = j_render_pt(j_load_scene(str(path), 32, 32),
                          JPTConfig(spp=4, spp_per_pass=4, max_depth=5, color="spectral"))
    timg = _render(_load(scenes / "disp", jax_table, 32), "spectral", spp=4)
    jimg = np.asarray(jimg)
    assert timg.shape == jimg.shape == (32, 32, 3) and np.all(np.isfinite(timg))
    np.testing.assert_allclose(timg.mean(axis=(0, 1)), jimg.mean(axis=(0, 1)), rtol=0.01)
    rel = np.abs(timg - jimg) / np.maximum(np.abs(jimg), 1e-3)
    assert np.mean(np.all(rel <= 1e-3, axis=-1)) >= 0.95


def test_cli_renders_spectral_prism(tmp_path, jax_table, monkeypatch):
    """The visible check through the CLI: scenes/prism/spectral.json (pt,
    spectral, d12) writes the EXR and the stats JSON, with colour fringes."""
    from akari_render_tpu_torch.svm import precompute as t_pre

    monkeypatch.setitem(t_pre._cache, t_pre.TABLE_NAME, jax_table)
    out = tmp_path / "prism.exr"
    stats = cli.main(["-s", str(ROOT / "scenes/prism/scene.json"), "-m",
                      str(ROOT / "scenes/prism/spectral.json"), "--res", "16", "--spp", "2",
                      "-o", str(out), "--save-stats", "--device", "cpu"])
    assert stats["color"] == "spectral" and stats["tier"] == "wavefront"
    img = read_exr(out)
    assert img.shape == (16, 16, 3) and np.all(np.isfinite(img)) and img.mean() > 0.0
    assert json.loads(out.with_suffix(".stats.json").read_text())["spp_total"] == 2
