"""PyTorch port, the megakernel tier (integrators/megakernel.py, with the
shared closure of svm/reduced.py): the shading bake, eligibility and the
hash stream against the JAX package's, K8's plain version against JAX's
render_pt_megakernel (the Pallas kernel in interpret mode), and the
AKR_MEGAKERNEL routing. The CUDA kernel against its plain version is in
test_torch_gpu.py and chip_smoke.py."""
import inspect
import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu.config import PTConfig as JPTConfig
from akari_render_tpu.core.filters import GaussianFilter as JGaussian
from akari_render_tpu.integrators import megakernel as jmk
from akari_render_tpu.integrators.common import PTSettings as JPTSettings
from akari_render_tpu.integrators.pallas_shade import shade_bake as j_shade_bake
from akari_render_tpu.scene import load_scene as j_load_scene
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch.config import PTConfig
from akari_render_tpu_torch.core.filters import GaussianFilter
from akari_render_tpu_torch.integrators import megakernel as tmk
from akari_render_tpu_torch.integrators.common import PTSettings
from akari_render_tpu_torch.integrators.pt import render_pt
from akari_render_tpu_torch.scene import load_scene
from akari_render_tpu_torch.svm import reduced

ROOT = Path(__file__).resolve().parents[1]
BLINDS = ROOT / "scenes/blinds/scene.json"


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def table():
    return np.asarray(j_get_table("ggx_dielectric_s"))


def metal_blinds(tmp_path) -> Path:
    """A copy of blinds whose slat material has metallic 0.7."""
    dst = tmp_path / "blinds_metal"
    shutil.copytree(BLINDS.parent, dst)
    doc = json.loads((dst / "scene.json").read_text())
    nodes = doc["materials"]["slat"]["shader"]["nodes"]
    nodes[nodes["bsdf"]["metallic"]["id"]]["value"] = 0.7
    (dst / "scene.json").write_text(json.dumps(doc))
    return dst / "scene.json"


@pytest.mark.parametrize("variant", ["blinds", "metal"])
def test_bake_matches_jax(variant, table, tmp_path):
    """bake_shading against JAX's _bake_shading on every column (the
    closures' constants, the GGX albedo knots), with the same flags; the
    metal variant holds the conductor lobe's n and k too. The column that
    JAX's table leaves free (_MT_ROUGH, zero there) holds the roughness of
    the port's reflection lobe, which GPT's reconnection shift reads: the
    closure's dist_r.roughness, sqrt(alpha), 1 on a diffuse row."""
    path = BLINDS if variant == "blinds" else metal_blinds(tmp_path)
    want, w_spec, w_metal = jmk._bake_shading(j_load_scene(str(path), 16, 16))
    ts = load_scene(str(path), 16, 16, device="cpu", ggx_table=table)
    got, g_spec, g_metal = ts.shade_bake
    assert (g_spec, g_metal) == (w_spec, w_metal) == (True, variant == "metal")
    assert got.shape == (4, reduced.MAT_COLS) and reduced.MAT_COLS == jmk.MAT_COLS
    rough = reduced._MT_ROUGH
    others = np.arange(reduced.MAT_COLS) != rough
    np.testing.assert_allclose(got.numpy()[:, others], np.asarray(want)[:, others], rtol=0,
                               atol=1e-6)
    assert not np.asarray(want)[:, rough].any()
    alpha = got.numpy()[:, reduced._MT_ALPHA]
    np.testing.assert_array_equal(got.numpy()[:, rough], np.sqrt(alpha))
    assert (got.numpy()[:, rough] < 1.0).any()
    assert reduced.bake_shading(ts) is not None


@pytest.mark.parametrize("scene", ["blinds", "glossy", "prism"])
def test_eligibility_matches_jax(scene, table):
    """megakernel_eligible and the presence of the bake agree with JAX's,
    with and without force_diffuse and without NEE."""
    path = ROOT / "scenes" / scene / "scene.json"
    js = j_load_scene(str(path), 16, 16)
    ts = load_scene(str(path), 16, 16, device="cpu", ggx_table=table)
    assert (ts.shade_bake is None) == (j_shade_bake(js) is None)
    for kw in ({}, {"force_diffuse": True}, {"use_nee": False}):
        want = jmk.megakernel_eligible(js, JPTSettings(**kw), None, JGaussian(1.5))
        assert tmk.megakernel_eligible(ts, PTSettings(**kw), None, GaussianFilter(1.5)) == want, kw
    if scene == "blinds":
        assert ts.shade_bake is not None and tmk.megakernel_eligible(
            ts, PTSettings(), {"type": "independent"}, GaussianFilter(1.5))


def test_hash_stream_bit_exact():
    """_hash_u64 and _draw (uint32 wrapping arithmetic, held in int64) on
    2^16 seeded keys and counters, bit-equal to JAX's."""
    rng = np.random.default_rng(5)
    hi, lo, ctr = (rng.integers(0, 1 << 32, 1 << 16, dtype=np.uint64).astype(np.uint32)
                   for _ in range(3))
    want = np.asarray(jmk._hash_u64(jnp.asarray(hi), jnp.asarray(lo)))
    got = tmk.hash_u64(torch.as_tensor(hi.astype(np.int64)), torch.as_tensor(lo.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    w_ctr, w_u = jmk._draw(jnp.asarray(want), jnp.asarray(ctr))
    g_ctr, g_u = tmk.draw(got, torch.as_tensor(ctr.astype(np.int64)))
    np.testing.assert_array_equal(g_u.numpy(), np.asarray(w_u))
    np.testing.assert_array_equal(g_ctr.numpy() & tmk.MASK32, np.asarray(w_ctr).astype(np.int64))


def test_plain_pass_matches_jax_render(table):
    """K8's plain version against JAX's render_pt_megakernel (interpret
    mode) on blinds at 16^2, 2 spp, d5. Both draw the same hash streams, so
    they trace the same paths: every pixel agrees within rtol 1e-3 and atol
    2e-3, the bound for a rounding flip of a path decision; on the CPU no
    decision flips, and every pixel is within 1e-6 absolute."""
    cfg = dict(spp=2, max_depth=5, spp_per_pass=2)
    want, _ = jmk.render_pt_megakernel(j_load_scene(str(BLINDS), 16, 16), JPTConfig(**cfg))
    ts = load_scene(str(BLINDS), 16, 16, device="cpu", ggx_table=table)
    got, stats = tmk.render_pt_megakernel(ts, PTConfig(**cfg))
    want = np.asarray(want)
    assert got.shape == want.shape == (16, 16, 3) and stats["spp_total"] == 2
    assert np.all(np.isfinite(got)) and got.mean() > 0.01
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(got.mean(axis=(0, 1)), want.mean(axis=(0, 1)), rtol=1e-3)
    assert np.abs(got - want).max() < 1e-6


def test_plain_pass_counts_rays(table):
    """The plain version's ray counter: every pixel traces its camera ray
    first, and the pass splits over sample ranges without changing the sums."""
    ts = load_scene(str(BLINDS), 8, 8, device="cpu", ggx_table=table)
    tb = tmk.pass_tables(ts, PTSettings(max_depth=4), GaussianFilter(1.5), 0)
    rays = torch.zeros(2, dtype=torch.int64)
    whole = tmk.megakernel_pass(tb, 0, 3, rays)
    assert rays[0] >= 3 * 64 and rays[1] > 0
    parts = tmk.megakernel_pass(tb, 0, 1) + tmk.megakernel_pass(tb, 1, 2)
    torch.testing.assert_close(parts, whole, rtol=1e-6, atol=1e-6)
    assert torch.equal(whole[3], torch.full((64,), 3.0))


def test_plain_pass_counts_simt(table):
    """The plain version's SIMT counters: the lanes' iterations are the
    closest-hit rays; the warps' iterations with path regeneration lie
    between the busiest lane's and those of the samples in lockstep; at one
    sample a pass the two schedules are the same."""
    ts = load_scene(str(BLINDS), 12, 12, device="cpu", ggx_table=table)
    tb = tmk.pass_tables(ts, PTSettings(max_depth=12, rr_depth=2), GaussianFilter(1.5), 0)
    rays = torch.zeros(2, dtype=torch.int64)
    simt = torch.zeros(5, dtype=torch.int64)
    tmk.megakernel_pass(tb, 0, 4, rays, simt)
    ran, used, lockstep, most, most_lockstep = simt.tolist()
    assert used == int(rays[0]) and used >= 4 * 144
    assert used <= 32 * ran and ran < lockstep  # 144 pixels: five warps, the last partial
    assert ran <= 5 * most and most <= most_lockstep <= lockstep
    one = torch.zeros(5, dtype=torch.int64)
    tmk.megakernel_pass(tb, 0, 1, simt=one)
    assert int(one[0]) == int(one[2]) and int(one[3]) == int(one[4]) and int(one[1]) >= 144


def test_routing_env_gate(table, monkeypatch):
    """AKR_MEGAKERNEL=1 routes an eligible render through the megakernel
    (the same image as a direct render_pt_megakernel); an ineligible scene
    (prism: glass) takes the wavefront."""
    cfg = PTConfig(spp=2, max_depth=3, rr_depth=2, spp_per_pass=2)
    ts = load_scene(str(BLINDS), 12, 12, device="cpu", ggx_table=table)
    direct, _ = tmk.render_pt_megakernel(ts, cfg)
    monkeypatch.setenv("AKR_MEGAKERNEL", "1")
    routed, stats = render_pt(ts, cfg)
    assert stats["tier"] == "megakernel"
    np.testing.assert_allclose(routed, direct, rtol=1e-5, atol=1e-6)
    prism = load_scene(str(ROOT / "scenes/prism/scene.json"), 8, 8, device="cpu", ggx_table=table)
    _, stats = render_pt(prism, PTConfig(spp=1, max_depth=2, spp_per_pass=1))
    assert stats["tier"] == "wavefront" and stats["shade"] == "dispatch"


def test_load_scene_defaults_to_the_card():
    """The port's entry points run on the card unless the caller asks for
    the CPU (checked by signature: no card needed)."""
    assert inspect.signature(load_scene).parameters["device"].default == "cuda"
