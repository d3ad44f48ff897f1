"""PyTorch port, samplers and the cbox fixture: make_sampler for every
sampler type, the pmj02 tables and the blue-noise textures, the cbox scene
through both packages and a pmj02bn render of it, held against the JAX
package on the CPU."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu.config import RenderTask as JRenderTask
from akari_render_tpu.core import bluenoise as j_bluenoise
from akari_render_tpu.core import lds as j_lds
from akari_render_tpu.integrators.pt import render_pt as j_render_pt
from akari_render_tpu.scene import load_scene as j_load_scene
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch.config import RenderTask as TRenderTask
from akari_render_tpu_torch.core import bluenoise as t_bluenoise
from akari_render_tpu_torch.core import lds as t_lds
from akari_render_tpu_torch.core import pmj02 as t_pmj02
from akari_render_tpu_torch.core import samplers as t_samplers
from akari_render_tpu_torch.core.filters import GaussianFilter
from akari_render_tpu_torch.integrators import megakernel as tmk
from akari_render_tpu_torch.integrators.common import PTSettings
from akari_render_tpu_torch.integrators.pt import render_pt as t_render_pt
from akari_render_tpu_torch.scene import load_scene as t_load_scene

ROOT = Path(__file__).resolve().parents[1]
CBOX = ROOT / "scenes/cbox/scene.json"
CBOX_METHOD = ROOT / "scenes/cbox/pt.json"
N_LANES = 4096
N_DIMS = 16


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_pmj02_bits():
    """JAX's pmj02 tables as its sampler holds them ([S*N, 2] uint32 24-bit
    fixed point), generated once for the module (the JAX sampler reads
    the same process cache)."""
    bits, s, n = j_lds._pmj02_tables_device()
    return bits, s, n


def _draws_equal(js, ts, dims: int):
    """Draw `dims` values one at a time from both; every float bit-equal
    (int32 views). Returns the samplers after the draws."""
    for d in range(dims):
        js, ju = js.next_1d()
        ts, tu = ts.next_1d()
        a, b = np.asarray(ju).view(np.int32), tu.numpy().view(np.int32)
        assert a.shape == b.shape == (N_LANES,)
        assert np.array_equal(a, b), f"dimension {d}: {np.sum(a != b)} lanes differ"
    return js, ts


@pytest.mark.parametrize("sample_index", [0, 5, 4100])
@pytest.mark.parametrize("kind", ["independent", "hash", "sobol", "lds", "pmj02bn"])
def test_make_sampler_bit_exact(kind, sample_index, monkeypatch, jax_pmj02_bits):
    """4,096 lanes x 16 dimensions, bit-equal to JAX's draws; "hash" is
    the independent type under AKR_RNG=hash, as the JAX package switches
    it. Sample index 4,100 is in pmj02's epoch 1."""
    cfg = {"type": "independent" if kind == "hash" else kind, "seed": 3}
    if kind == "hash":
        monkeypatch.setenv("AKR_RNG", "hash")
    pix = np.arange(N_LANES, dtype=np.uint32) * 5 + 11
    js = j_lds.make_sampler(cfg, jnp.asarray(pix), jnp.uint32(sample_index), seed_extra=1)
    ts = t_lds.make_sampler(cfg, torch.as_tensor(pix.astype(np.int64)), sample_index,
                            seed_extra=1)
    want = {"independent": t_samplers.IndependentSampler, "hash": t_samplers.HashSampler,
            "sobol": t_lds.SobolSampler, "lds": t_lds.SobolSampler,
            "pmj02bn": t_lds.Pmj02Sampler}[kind]
    assert isinstance(ts, want)
    _draws_equal(js, ts, N_DIMS)


@pytest.mark.parametrize("kind", ["independent", "hash", "sobol", "pmj02bn"])
def test_per_lane_sample_index_bit_exact(kind, monkeypatch, jax_pmj02_bits):
    """A per-lane sample index (an [N] tensor, as integrators with lanes
    at different samples pass) through the port's [N] path, across the
    pmj02 epochs and up to 2^32 - 1, bit-equal to JAX's."""
    cfg = {"type": "independent" if kind == "hash" else kind, "seed": 0}
    if kind == "hash":
        monkeypatch.setenv("AKR_RNG", "hash")
    rng = np.random.default_rng(9)
    si = rng.integers(0, 1 << 32, N_LANES, dtype=np.uint64).astype(np.uint32)
    si[: N_LANES // 2] %= 3 * 4096
    pix = np.arange(N_LANES, dtype=np.uint32)
    js = j_lds.make_sampler(cfg, jnp.asarray(pix), jnp.asarray(si))
    ts = t_lds.make_sampler(cfg, torch.arange(N_LANES), torch.as_tensor(si.astype(np.int64)))
    js, ts = _draws_equal(js, ts, 5)
    js, ju = js.next_3d()
    ts, tu = ts.next_3d()
    np.testing.assert_array_equal(np.asarray(ju).view(np.int32), tu.numpy().view(np.int32))


def test_pmj02_tables_bit_equal(jax_pmj02_bits):
    """The port's tables (from build/cache/ or built) and one set
    generated afresh equal JAX's, bit for bit."""
    bits, s, n = jax_pmj02_bits
    assert (s, n) == (t_pmj02.N_PMJ02_SETS, t_pmj02.N_PMJ02_SAMPLES)
    assert np.array_equal(t_lds.pmj02_tables("cpu").numpy(), bits.astype(np.int32))
    tabs = t_pmj02.get_pmj02_tables()
    assert tabs.shape == (s, n, 2) and tabs.dtype == np.float32
    fresh = t_pmj02.generate_pmj02(n, seed=1000 + 3).astype(np.float32)
    assert np.array_equal(fresh, tabs[3])
    fresh_bits = np.minimum((fresh * (1 << 24)).astype(np.uint32), (1 << 24) - 1)
    assert np.array_equal(fresh_bits, bits[3 * n:4 * n])
    assert t_pmj02.is_02_prefix(tabs[3], 10)


def test_bluenoise_void_and_cluster_equal():
    """One 16 x 16 dither array from the same generator state."""
    want = j_bluenoise._void_and_cluster(16, np.random.default_rng(7))
    got = t_bluenoise._void_and_cluster(16, np.random.default_rng(7))
    assert np.array_equal(want, got)
    assert sorted(got.ravel().tolist()) == list(range(256))


def test_megakernel_takes_only_independent():
    """The JAX package's rule (megakernel_eligible): only the independent
    sampler is eligible, so pmj02bn, sobol and hash renders take the
    wavefront. blinds is otherwise eligible."""
    scene = t_load_scene(str(ROOT / "scenes/blinds/scene.json"), 16, 16, device="cpu")
    for kind, want in (("independent", True), ("pmj02bn", False), ("sobol", False),
                       ("lds", False), ("hash", False)):
        got = tmk.megakernel_eligible(scene, PTSettings(), {"type": kind}, GaussianFilter(1.5))
        assert got == want, kind
    assert tmk.megakernel_eligible(scene, PTSettings(), None, GaussianFilter(1.5))


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_cbox_fixture_structure(package):
    """What tests/test_scene.py:17-43 asserts of the reference's cbox,
    through either package's loader."""
    if package == "jax":
        sc = j_load_scene(str(CBOX), width=16, height=16)
    else:
        sc = t_load_scene(str(CBOX), width=16, height=16, device="cpu")
    assert sc.num_tris == 36
    assert len(sc.kinds) == 1 and len(sc.material_names) == 8
    la = sc.arrays.lights
    assert la.num_lights == 1
    np.testing.assert_allclose(np.asarray(sc.camera.c2w)[:3, 3], [0.0, 1.0, 9.0], atol=1e-5)
    lit = np.nonzero(np.asarray(la.tri_light_id) >= 0)[0]
    assert len(lit) == 2 and (np.asarray(sc.arrays.v0)[lit][:, 1] > 1.9).all()
    assert (np.asarray(sc.arrays.area) > 0).all()
    assert abs(float(np.asarray(la.tri_prim_pdf).sum()) - 1.0) < 1e-5
    if package == "torch":
        assert sc.shade_bake is not None  # the fused shade (K9) takes it


def test_cbox_render_matches_jax():
    """cbox 16x16, pmj02bn seed 0, d5, 4 spp through both packages with the
    same GGX table, at tests/test_torch_pt.py's tolerance: channel means
    within 1 % and 95 % of the pixels within 1e-3 relative."""
    table = np.asarray(j_get_table("ggx_dielectric_s"))
    tasks = (JRenderTask.from_file(CBOX_METHOD), TRenderTask.from_file(CBOX_METHOD))
    for task in tasks:
        assert task.sampler["type"] == "pmj02bn"
        task.method.spp = task.method.spp_per_pass = 4
        task.method.max_depth = 5
    jimg, _ = j_render_pt(j_load_scene(str(CBOX), 16, 16), tasks[0].method, tasks[0])
    timg, stats = t_render_pt(t_load_scene(str(CBOX), 16, 16, device="cpu", ggx_table=table),
                              tasks[1].method, tasks[1])
    jimg = np.asarray(jimg)
    assert timg.shape == jimg.shape == (16, 16, 3) and np.all(np.isfinite(timg))
    assert stats["tier"] == "wavefront" and stats["spp_total"] == 4
    np.testing.assert_allclose(timg.mean(axis=(0, 1)), jimg.mean(axis=(0, 1)), rtol=0.01)
    rel = np.abs(timg - jimg) / np.maximum(np.abs(jimg), 1e-3)
    assert np.mean(np.all(rel <= 1e-3, axis=-1)) >= 0.95
