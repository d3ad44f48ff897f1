"""PyTorch port, trace_paths' full interface and the AOV integrator:
the first-hit aux, the returned sampler and the per-depth taps of
trace_paths, render_aov and the CLI's aov branch, held against the JAX
package on the CPU."""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu.camera import generate_rays as j_generate_rays
from akari_render_tpu.config import AOVConfig as JAOVConfig
from akari_render_tpu.core.lds import make_sampler as j_make_sampler
from akari_render_tpu.integrators.aov import AOV_NAMES as J_AOV_NAMES
from akari_render_tpu.integrators.aov import render_aov as j_render_aov
from akari_render_tpu.integrators.common import PTSettings as JPTSettings
from akari_render_tpu.integrators.common import trace_paths as j_trace_paths
from akari_render_tpu.scene import load_scene as j_load_scene
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch import cli
from akari_render_tpu_torch.camera import generate_rays as t_generate_rays
from akari_render_tpu_torch.config import AOVConfig as TAOVConfig
from akari_render_tpu_torch.core.filters import GaussianFilter
from akari_render_tpu_torch.core.image_io import read_exr
from akari_render_tpu_torch.core.lds import make_sampler as t_make_sampler
from akari_render_tpu_torch.integrators.aov import AOV_NAMES, render_aov
from akari_render_tpu_torch.integrators.common import PTSettings, trace_paths
from akari_render_tpu_torch.integrators.pt import camera_sample
from akari_render_tpu_torch.scene import load_scene as t_load_scene
from akari_render_tpu_torch.svm import precompute as t_pre

ROOT = Path(__file__).resolve().parents[1]
MATBOX = ROOT / "scenes/matbox/scene.json"
CBOX = ROOT / "scenes/cbox/scene.json"
RES = 32


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


def _camera_lanes(js, ts, cfg, sample_index=3):
    """Both packages' samplers after the camera draw and the camera rays of
    one sample of every pixel (the render_sample recipe)."""
    w, h = ts.camera.width, ts.camera.height
    pix = np.arange(w * h, dtype=np.uint32)
    jsm = j_make_sampler(cfg, jnp.asarray(pix), jnp.uint32(sample_index), 0)
    tsm = t_make_sampler(cfg, torch.arange(w * h), sample_index, 0)
    jsm, ju = jsm.next_2d()
    tsm, tu = tsm.next_2d()
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    p = np.stack([pix % w, pix // w], -1).astype(np.float32) + 0.5 + (np.asarray(ju) - 0.5)
    jo, jd = j_generate_rays(js.camera, jnp.asarray(p))
    to, td = t_generate_rays(ts.camera, torch.as_tensor(p))
    return (jo, jd, jsm), (to, td, tsm)


def _taps(store):
    def cb(depth, kind, contribution, mask):
        c = np.where(np.asarray(mask)[..., None], np.asarray(contribution), 0.0)
        store[(int(depth), kind)] = store.get((int(depth), kind), 0.0) + c
    return cb


@pytest.mark.parametrize("scene,sampler", [("matbox", "independent"), ("cbox", "pmj02bn")])
def test_trace_paths_aux_taps_and_sampler(scene, sampler, jax_table):
    """One sample at 32x32, d6, rr 3, with radiance_cb: the radiance, the
    aux (first-hit albedo, normal, t), every (depth, kind) tap and the
    returned sampler (its next draw bit-equal) against JAX's unrolled
    trace. Measured on the CPU: within 1.4e-5 absolute (matbox's principled
    and glass closures) and 1e-6 (cbox); the normal bit-equal."""
    path = ROOT / f"scenes/{scene}/scene.json"
    js = j_load_scene(str(path), RES, RES)
    ts = t_load_scene(str(path), RES, RES, device="cpu", ggx_table=jax_table)
    (jo, jd, jsm), (to, td, tsm) = _camera_lanes(js, ts, {"type": sampler})
    jt, tt = {}, {}
    jr, ja, jsm = j_trace_paths(js, JPTSettings(max_depth=6, rr_depth=3), jo, jd, jsm,
                                radiance_cb=_taps(jt))
    tr, ta, tsm = trace_paths(ts, PTSettings(max_depth=6, rr_depth=3), to, td, tsm,
                              radiance_cb=_taps(tt))
    atol = 5e-5
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=atol)
    assert sorted(ta) == ["albedo", "first_t", "normal"]
    np.testing.assert_allclose(ta["albedo"].numpy(), np.asarray(ja["albedo"]), atol=atol)
    np.testing.assert_array_equal(ta["normal"].numpy(), np.asarray(ja["normal"]))
    np.testing.assert_allclose(ta["first_t"].numpy(), np.asarray(ja["first_t"]), rtol=1e-6)
    hit = ta["first_t"].numpy() < 1e19
    assert hit.mean() > 0.9 and ta["albedo"].numpy()[hit].max() > 0.1
    # emission at depths 0-6 and NEE at 1-6, as JAX calls them
    assert sorted(tt) == sorted(jt)
    assert len(tt) == 13
    for key in jt:
        np.testing.assert_allclose(tt[key], jt[key], atol=atol, err_msg=str(key))
    assert sum(np.abs(v).sum() for v in tt.values()) > 0
    jsm, ju = jsm.next_3d()
    tsm, tu = tsm.next_3d()
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())


def test_fused_route_aux_albedo_matches_dispatch(jax_table, monkeypatch):
    """Path B (AKR_PALLAS_SHADE=1: the first bounce shaded by K9's plain
    version on the CPU) records the aux albedo from K9's albedo output; it
    agrees with the dispatch route's per-kind closures within 5e-6 (K9's
    plain version against dispatch_shade), on cbox 32x32, one sample."""
    ts = t_load_scene(str(CBOX), RES, RES, device="cpu", ggx_table=jax_table)
    out = {}
    for route in ("0", "1"):
        monkeypatch.setenv("AKR_PALLAS_SHADE", route)
        o, d, _, sm = camera_sample(ts, GaussianFilter(1.5), 0, 0, {"type": "pmj02bn"})
        out[route] = trace_paths(ts, PTSettings(max_depth=3), o, d, sm)
    albedo = out["1"][1]["albedo"].numpy()
    np.testing.assert_allclose(albedo, out["0"][1]["albedo"].numpy(), atol=5e-6)
    assert albedo.max() > 0.5
    np.testing.assert_array_equal(out["1"][1]["first_t"].numpy(), out["0"][1]["first_t"].numpy())


def test_render_aov_matches_jax(jax_table):
    """matbox 32x32, 2 spp: each of the seven images against JAX's within
    1e-4 absolute (measured on the CPU: 5.7e-6 for the albedo, 2e-6 for the
    depth, 6e-8 for the vectors, 0 for the roughness)."""
    assert AOV_NAMES == J_AOV_NAMES
    _, jstats = j_render_aov(j_load_scene(str(MATBOX), RES, RES), JAOVConfig(spp=2))
    img, tstats = render_aov(t_load_scene(str(MATBOX), RES, RES, device="cpu",
                                          ggx_table=jax_table), TAOVConfig(spp=2))
    assert tstats["spp_total"] == 2 and tstats["aovs"] == AOV_NAMES
    np.testing.assert_array_equal(img, tstats["images"]["albedo"])
    for name in AOV_NAMES:
        got, want = tstats["images"][name], np.asarray(jstats["images"][name])
        assert got.shape == want.shape == (RES, RES, 3)
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=name)
    depth = tstats["images"]["depth"][..., 0]
    assert depth.max() > 5.0 and np.ptp(tstats["images"]["roughness"]) > 0.1


def test_cli_aov_writes_seven_images_and_albedo(tmp_path, jax_table, monkeypatch):
    """The CLI's aov branch at 8x8 on the CPU: one EXR a name,
    {stem}_{name}{suffix}, and the albedo as the main image."""
    monkeypatch.setitem(t_pre._cache, t_pre.TABLE_NAME, jax_table)
    method = tmp_path / "aov.json"
    method.write_text(json.dumps({"method": {"type": "aov", "spp": 2},
                                  "film": {"out": str(tmp_path / "unused.exr")}}))
    out = tmp_path / "cbox.exr"
    cli.main(["-s", str(CBOX), "-m", str(method), "--res", "8", "-o", str(out),
              "--device", "cpu"])
    files = sorted(p.name for p in tmp_path.glob("*.exr"))
    assert files == sorted(["cbox.exr"] + [f"cbox_{n}.exr" for n in AOV_NAMES])
    albedo = read_exr(out)
    np.testing.assert_array_equal(albedo, read_exr(tmp_path / "cbox_albedo.exr"))
    assert albedo.shape == (8, 8, 3) and np.all(np.isfinite(albedo)) and albedo.max() > 0.1
    depth = read_exr(tmp_path / "cbox_depth.exr")
    assert depth.min() > 5.0  # every ray of the box's frame hits


@pytest.mark.parametrize("method", ["mcmc", "mcmc_opt", "gpt"])
def test_cli_unported_methods_exit(tmp_path, method, capsys):
    """The methods the CLI refused before this slice: each renders cbox
    8x8 on the CPU with --save-stats (small configurations), writes its
    stats JSON and names its integrator and route in the "wrote" line."""
    cfg = ({"spp": 1, "max_depth": 3} if method == "gpt" else
           {"spp": 2, "max_depth": 3, "n_chains": 64, "n_bootstrap": 256, "direct_spp": 1})
    path = tmp_path / "m.json"
    path.write_text(json.dumps({"method": {"type": method, **cfg}}))
    out = tmp_path / f"{method}.exr"
    stats = cli.main(["-s", str(CBOX), "-m", str(path), "--res", "8", "-o", str(out),
                      "--save-stats", "--device", "cpu"])
    saved = json.loads(out.with_suffix(".stats.json").read_text())
    wrote = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith(f"wrote {out}")]
    assert len(wrote) == 1 and "traversal flat (K1)" in wrote[0]
    if method == "gpt":
        assert saved["shift_mode"] == stats["shift_mode"] == "reconnect"
        assert "gpt (reconnect shift), shade dispatch" in wrote[0]
        assert "primal" not in saved  # images stay out of the stats JSON
    else:
        assert saved["b"] == stats["b"] > 0.0 and 0.0 < saved["acceptance"] <= 1.0
        assert f"{method} (b " in wrote[0] and saved["steps"] == 2
    assert np.all(np.isfinite(read_exr(out)))
