"""PyTorch port, the split-compacted PT pass on the cbox stand-in through
render_pt, held against the JAX package on the CPU, the resume from a
row subset of a stopped trace, and the samplers' row take, bit for bit."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu.config import PTConfig as JPTConfig
from akari_render_tpu.core import lds as j_lds
from akari_render_tpu.integrators.pt import render_pt as j_render_pt
from akari_render_tpu.scene import load_scene as j_load_scene
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch.config import PTConfig
from akari_render_tpu_torch.core import lds as t_lds
from akari_render_tpu_torch.integrators import common
from akari_render_tpu_torch.integrators.pt import render_pt as t_render_pt
from akari_render_tpu_torch.scene import load_scene as t_load_scene

ROOT = Path(__file__).resolve().parents[1]
CBOX = ROOT / "scenes/cbox/scene.json"
SWITCHES = ("AKR_SPLIT_DEPTH", "AKR_PALLAS_SHADE", "AKR_MEGAKERNEL")


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
def jax_table():
    return np.asarray(j_get_table("ggx_dielectric_s"))


def _scenes(res: int, table):
    return (j_load_scene(str(CBOX), res, res),
            t_load_scene(str(CBOX), res, res, device="cpu", ggx_table=table))


def test_split_pass_bit_exact_and_matches_jax(monkeypatch, jax_table):
    """AKR_SPLIT_DEPTH=2 (JAX's test_split_compacted_pass_bit_exact, at
    32x32, 4 spp, d7): the split image equals the unsplit one bit for bit,
    the live counts are in the stats, and it lies within 2e-4/2e-5 of
    JAX's split render."""
    js, ts = _scenes(32, jax_table)
    cfg = dict(spp=4, max_depth=7, spp_per_pass=4)
    a, st_a = t_render_pt(ts, PTConfig(**cfg))
    monkeypatch.setenv("AKR_SPLIT_DEPTH", "2")
    b, st_b = t_render_pt(ts, PTConfig(**cfg))
    assert "split_depth" not in st_a and st_b["split_depth"] == 2
    assert len(st_b["split_live"]) == 4 and 0 < min(st_b["split_live"]) < 32 * 32
    assert np.array_equal(a, b), float(np.max(np.abs(a - b)))
    want = np.asarray(j_render_pt(js, JPTConfig(**cfg))[0])
    np.testing.assert_allclose(b, want, rtol=2e-4, atol=2e-5)
    # a split depth outside (0, max_depth) renders unsplit
    monkeypatch.setenv("AKR_SPLIT_DEPTH", "7")
    assert "split_depth" not in t_render_pt(ts, PTConfig(**cfg))[1]


@pytest.mark.parametrize("kind", ["independent", "hash", "sobol", "pmj02bn"])
def test_resume_from_taken_rows_bit_exact(kind, jax_table, monkeypatch):
    """trace_paths stopped at depth 2 (finalize=False), a row subset taken
    (take_rows: every row and the sampler's) and resumed, equals the same
    lanes traced in one go, for each sampler type."""
    from akari_render_tpu_torch.core.filters import GaussianFilter
    from akari_render_tpu_torch.integrators.pt import camera_sample

    if kind == "hash":
        monkeypatch.setenv("AKR_RNG", "hash")
    cfg = {"type": "independent" if kind == "hash" else kind}
    _, ts = _scenes(16, jax_table)
    settings = common.PTSettings(max_depth=6, rr_depth=3)
    ids = torch.arange(0, 256, 3)
    o, d, _, sampler = camera_sample(ts, GaussianFilter(1.5), 1, 0, cfg)
    whole, _, _ = common.trace_paths(ts, settings, o, d, sampler)
    st = common.trace_paths(ts, settings, o, d, sampler, depth_end=2, finalize=False)
    if kind in ("sobol", "pmj02bn"):
        assert st["sampler"].dim == 2 + 7 * 2
    part, _, _ = common.trace_paths(ts, settings, None, None, None,
                                    resume_state=common.take_rows(st, ids), depth_beg=2)
    assert torch.equal(part, whole[ids])


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("kind", ["independent", "hash", "sobol", "pmj02bn"])
def test_take_bit_exact(kind, monkeypatch):
    """Lockstep samplers with a per-lane sample index, as the split pass
    holds them: 7 draws, a take of every third lane (JAX's row take of
    every per-lane leaf, the port's take) and 5 more draws, every draw
    bit-equal to JAX's, for each sampler type."""
    cfg = {"type": "independent" if kind == "hash" else kind, "seed": 0}
    if kind == "hash":
        monkeypatch.setenv("AKR_RNG", "hash")
    n = 4096
    rng = np.random.default_rng(11)
    pix = rng.integers(0, 1 << 20, n).astype(np.uint32)
    si = rng.integers(0, 3 * 4096, n).astype(np.uint32)
    js = j_lds.make_sampler(cfg, jnp.asarray(pix), jnp.asarray(si))
    ts = t_lds.make_sampler(cfg, torch.as_tensor(pix.astype(np.int64)),
                            torch.as_tensor(si.astype(np.int64)))
    for d in range(7):
        js, ju = js.next_1d()
        ts, tu = ts.next_1d()
        assert np.array_equal(_bits(ju), _bits(tu.numpy())), f"draw {d}"
    ids = np.arange(0, n, 3)
    jt = jax.tree_util.tree_map(lambda x: x[ids] if x.ndim and x.shape[0] == n else x, js)
    tt = ts.take(torch.as_tensor(ids))
    if kind == "pmj02bn":
        assert tt.tables is ts.tables
    for d in range(5):
        jt, ju = jt.next_1d()
        tt, tu = tt.next_1d()
        assert np.array_equal(_bits(ju), _bits(tu.numpy())), f"draw {d} after take"


def test_lockstep_sampler_keeps_int_dims():
    """trace_paths' lanes draw in lockstep: a sampler made for every pixel
    keeps one Python int dimension through its draws (no per-lane
    tensor, so pmj02's table row costs no launch), and so does its take."""
    pix = torch.arange(64)
    s = t_lds.make_sampler({"type": "pmj02bn"}, pix, 3)
    s, _ = s.next_3d()
    assert s.dim == 3 and isinstance(s.dim, int)
    t, _ = s.next_1d()
    t = t.take(torch.arange(0, 64, 2))
    assert t.dim == 4 and isinstance(t.dim, int) and t.cache.shape == (32,)
