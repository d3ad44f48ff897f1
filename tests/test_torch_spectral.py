"""PyTorch port, spectral transport: core/spectral.py function by function
against the JAX package, the rgb2spec table against JAX's, JAX's own
spectral cases on the port, and a spectral render of the cbox stand-in
against JAX's and against the port's RGB render."""
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu.config import RenderTask as JRenderTask
from akari_render_tpu.core import spectral as js
from akari_render_tpu.integrators.pt import render_pt as j_render_pt
from akari_render_tpu.scene import load_scene as j_load_scene
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch import native
from akari_render_tpu_torch.config import PTConfig, RenderTask as TRenderTask
from akari_render_tpu_torch.core import spectral as ts
from akari_render_tpu_torch.integrators.pt import render_pt as t_render_pt
from akari_render_tpu_torch.scene import load_scene as t_load_scene

ROOT = Path(__file__).resolve().parents[1]
CBOX = ROOT / "scenes/cbox/scene.json"
CBOX_METHOD = ROOT / "scenes/cbox/pt.json"
N = 8192


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
    """JAX's GGX albedo table, which the port's loader takes in place of
    computing its own (a minute on the CPU)."""
    return np.asarray(j_get_table("ggx_dielectric_s"))


@pytest.fixture(scope="module")
def tables():
    jt = js.ensure_rgb2spec_table()
    assert jt is not None, "the JAX package's native rgb2spec optimizer failed"
    return jt, ts.ensure_rgb2spec_table()


def _inputs():
    """Seeded RGB (with zeros, a zero channel, equal maxima, gamut edges and
    values above 1), wavelengths and spectra, [N, ...] float32."""
    rng = np.random.default_rng(21)
    rgb = rng.uniform(0.0, 3.0, (N, 3)).astype(np.float32)
    rgb[:16] = 0.0
    rgb[16:64, 0] = 0.0
    rgb[64:128, 1] = rgb[64:128, 0]  # ties: jnp.argmax and torch.argmax take the first
    rgb[128:256] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 128)] * rng.uniform(
        0.0, 1.0, (128, 1)).astype(np.float32)
    rgb[256:512] = rng.uniform(0.0, 1.0, (256, 3)).astype(np.float32)
    u = rng.uniform(0.0, 1.0, N).astype(np.float32)
    spec = rng.uniform(0.0, 5.0, (N, 4)).astype(np.float32)
    return rgb, u, spec


def test_sample_wavelengths_exact():
    """The hero wavelengths and pdfs bit-equal to JAX's; JAX's own case
    (tests/test_spectral.py::test_wavelength_sample_pdf) on the port."""
    _, u, _ = _inputs()
    j = js.sample_wavelengths(jnp.asarray(u))
    t = ts.sample_wavelengths(torch.as_tensor(u))
    np.testing.assert_array_equal(t.lambdas.numpy(), np.asarray(j.lambdas))
    np.testing.assert_array_equal(t.pdf.numpy(), np.asarray(j.pdf))
    lam = ts.sample_wavelengths(torch.tensor([0.0, 0.3, 0.999])).lambdas.numpy()
    assert lam.shape == (3, 4) and np.all(lam >= 360.0) and np.all(lam <= 830.0)
    for row in ((lam - 360.0) / 470.0 * 4).astype(int):
        assert sorted(set(row.tolist())) == [0, 1, 2, 3]


def test_rgb2spec_table_byte_equal(tables):
    """Both packages build the table from native/rgb2spec_opt.cpp with the
    same g++ flags, so the files are byte-equal (the port's in
    build/cache/, JAX's in its own cache)."""
    (j_scale, j_coeffs), (t_scale, t_coeffs) = tables
    assert ts.table_path().read_bytes() == js._table_path("srgb").read_bytes()
    np.testing.assert_array_equal(t_scale, j_scale)
    np.testing.assert_array_equal(t_coeffs, j_coeffs)


# Tolerances. Exact where the op is exact (above). Elsewhere 1e-6 of the
# quantity's scale: a reflectance is 0.5 + 0.5 x / sqrt(1 + x^2), so its
# rounding is an ulp of 0.5 however small it is (measured 1.2e-7); the
# sensor's sRGB is a sum of terms of either sign with a matrix of entries
# up to 3.24, so its scale is |XYZ| (measured 5.9e-7 of it); the CIE curves
# go by their peaks, about 1 (measured 2.0e-7: torch's exp is not XLA's).
# The uplift and D65 are equal.
def _close(got, want, scale, tol=1e-6):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    bound = tol * np.maximum(np.abs(np.asarray(want, np.float64)), scale)
    assert np.all(err <= bound), float(np.max(err / np.maximum(bound, 1e-30)))


@pytest.mark.parametrize("fn", ["uplift_coeffs", "uplift_unbounded", "eval_reflectance",
                                "cie_xyz_bar", "illuminant_d65", "spectral_to_rgb"])
def test_spectral_functions_match_jax(tables, fn):
    jt, tt = tables
    rgb, u, spec = _inputs()
    lam = np.asarray(js.sample_wavelengths(jnp.asarray(u)).lambdas)
    pdf = np.full_like(lam, 1.0 / 470.0)
    if fn == "uplift_coeffs":
        norm = np.minimum(rgb, 1.0)
        want = js.uplift_coeffs(jt, jnp.asarray(norm))
        # trilinear over the same corners in the same order: equal
        np.testing.assert_array_equal(ts.uplift_coeffs(tt, torch.as_tensor(norm)).numpy(),
                                      np.asarray(want))
    elif fn == "uplift_unbounded":
        (jc, jsc), (tc, tsc) = (js.uplift_unbounded(jt, jnp.asarray(rgb)),
                                ts.uplift_unbounded(tt, torch.as_tensor(rgb)))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    elif fn == "eval_reflectance":
        jc, _ = js.uplift_unbounded(jt, jnp.asarray(rgb))
        got = ts.eval_reflectance(torch.as_tensor(np.asarray(jc)), torch.as_tensor(lam))
        _close(got, js.eval_reflectance(jc, jnp.asarray(lam)), 1.0)
    elif fn == "cie_xyz_bar":
        _close(ts.cie_xyz_bar(torch.as_tensor(lam)), js.cie_xyz_bar(jnp.asarray(lam)), 1.0)
    elif fn == "illuminant_d65":
        assert ts.Y_D65 == js.Y_D65
        np.testing.assert_array_equal(ts.illuminant_d65(torch.as_tensor(lam)).numpy(),
                                      np.asarray(js.illuminant_d65(jnp.asarray(lam))))
    else:
        want = np.asarray(js.spectral_to_rgb(jnp.asarray(spec), jnp.asarray(lam),
                                             jnp.asarray(pdf)))
        got = ts.spectral_to_rgb(torch.as_tensor(spec), torch.as_tensor(lam),
                                 torch.as_tensor(pdf)).numpy()
        xyz = np.abs(np.asarray(js.cie_xyz_bar(jnp.asarray(lam)))
                     * (spec / pdf)[..., None]).mean(-2).max(-1, keepdims=True)
        _close(got, want, xyz)


def test_sensor_whitepoint():
    """JAX's case: a flat-reflectance D65 emitter is sRGB white."""
    lam = torch.linspace(360.0, 830.0, 4701)[None, :]
    rgb = ts.spectral_to_rgb(ts.illuminant_d65(lam), lam, torch.full_like(lam, 1.0 / 470.0))
    assert np.allclose(rgb[0].numpy(), 1.0, atol=2e-3), rgb


def test_uplift_round_trip(tables):
    """JAX's case: uplift -> spectrum * D65 -> the CIE sensor gives the RGB
    back (within 2 %; 0.05 absolute at the saturated gamut-edge red)."""
    tt = tables[1]
    lam = torch.linspace(360.0, 830.0, 4701)[None, :]
    pdf = torch.full_like(lam, 1.0 / 470.0)

    def round_trip(rgb):
        c, s = ts.uplift_unbounded(tt, torch.tensor([rgb]))
        spec = ts.eval_reflectance(c, lam) * s[..., None] * ts.illuminant_d65(lam)
        return ts.spectral_to_rgb(spec, lam, pdf)[0].numpy()

    for rgb in ([0.14, 0.45, 0.091], [0.725, 0.71, 0.68], [1.0, 1.0, 1.0], [0.1, 0.3, 0.8],
                [0.01, 0.01, 0.01], [5.0, 5.0, 5.0], [2.0, 8.0, 3.0]):
        out = round_trip(rgb)
        rel = np.max(np.abs(out - np.array(rgb)) / np.maximum(np.array(rgb), 1e-3))
        assert rel < 0.02, (rgb, out, rel)
    red = [0.63, 0.065, 0.05]
    assert np.max(np.abs(round_trip(red) - np.array(red))) < 0.05


def test_spectral_config_parsing():
    """JAX's case on the port's config."""
    assert PTConfig.from_json({"color": "spectral"}).color == "spectral"
    assert PTConfig.from_json({"color": {"type": "spectral"}}).color == "spectral"
    assert PTConfig.from_json({}).color == "rgb"
    assert PTConfig.from_json({"color": {"type": "rgb", "colorspace": "srgb"}}).color == "rgb"


def test_spectral_render_matches_jax(jax_table):
    """cbox stand-in 32x32, 8 spp, d5, pmj02bn seed 0, spectral, through
    both packages with the same GGX table: the sample streams and path
    decisions are JAX's, so the images agree to float rounding (channel
    means within 1 %, 95 % of the pixels within 1e-3 relative; measured at
    16x16: every pixel, max abs 6.2e-6)."""
    tasks = (JRenderTask.from_file(CBOX_METHOD), TRenderTask.from_file(CBOX_METHOD))
    for task in tasks:
        task.method.spp = task.method.spp_per_pass = 8
        task.method.max_depth = 5
        task.method.color = "spectral"
    jimg, _ = j_render_pt(j_load_scene(str(CBOX), 32, 32), tasks[0].method, tasks[0])
    timg, stats = t_render_pt(t_load_scene(str(CBOX), 32, 32, device="cpu", ggx_table=jax_table),
                              tasks[1].method, tasks[1])
    jimg = np.asarray(jimg)
    assert timg.shape == jimg.shape == (32, 32, 3) and np.all(np.isfinite(timg))
    assert stats["color"] == "spectral" and stats["shade"] == "dispatch"
    np.testing.assert_allclose(timg.mean(axis=(0, 1)), jimg.mean(axis=(0, 1)), rtol=0.01)
    rel = np.abs(timg - jimg) / np.maximum(np.abs(jimg), 1e-3)
    assert np.mean(np.all(rel <= 1e-3, axis=-1)) >= 0.95


def test_spectral_matches_rgb(jax_table):
    """JAX's end-to-end case (tests/test_spectral.py::
    test_spectral_cbox_matches_rgb, its tolerances) on the port and the
    cbox stand-in: 48x48, 48 spp, d5; the path decisions are RGB's, so the
    two differ by wavelength noise and the uplift's bias."""
    scene = t_load_scene(str(CBOX), 48, 48, device="cpu", ggx_table=jax_table)
    cfg = PTConfig(spp=48, max_depth=5, spp_per_pass=48)
    a, _ = t_render_pt(scene, cfg)
    b, stats = t_render_pt(scene, dataclasses.replace(cfg, color="spectral"))
    assert stats["color"] == "spectral" and np.all(np.isfinite(b))
    assert abs(b.mean() - a.mean()) / a.mean() < 0.04
    ca, cb = a.mean((0, 1)), b.mean((0, 1))
    assert np.all(np.abs(cb - ca) / np.maximum(ca, 1e-3) < 0.08), (ca, cb)
    assert float(np.mean((b - a) ** 2)) < 0.02


def test_spectral_without_table_raises(tmp_path, monkeypatch, jax_table):
    """No fallback: when the table cannot be made (here g++ fails), a
    spectral render raises instead of rendering RGB."""
    monkeypatch.setattr(ts, "_table_cache", {})
    monkeypatch.setattr(ts, "_device_tables", {})
    monkeypatch.setattr(ts, "CACHE_DIR", tmp_path)

    def no_compiler():
        raise RuntimeError("g++ failed (1)")

    monkeypatch.setattr(native, "get_lib", no_compiler)
    scene = t_load_scene(str(CBOX), 8, 8, device="cpu", ggx_table=jax_table)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        t_render_pt(scene, PTConfig(spp=1, max_depth=2, color="spectral"))
