"""PyTorch port, the PT pass shapes on the cbox stand-in: fused rays and
the split-compacted pass through render_pt, held against the JAX package
on the CPU, and the samplers' per-lane dimensions and row operations, bit
for bit."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu.config import PTConfig as JPTConfig
from akari_render_tpu.core import lds as j_lds
from akari_render_tpu.integrators.pt import render_pt as j_render_pt
from akari_render_tpu.integrators.wavefront import _lane_select as j_lane_select
from akari_render_tpu.scene import load_scene as j_load_scene
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch.config import PTConfig
from akari_render_tpu_torch.core import lds as t_lds
from akari_render_tpu_torch.core import samplers as t_samplers
from akari_render_tpu_torch.integrators import common
from akari_render_tpu_torch.integrators.pt import render_pt as t_render_pt
from akari_render_tpu_torch.scene import load_scene as t_load_scene

ROOT = Path(__file__).resolve().parents[1]
CBOX = ROOT / "scenes/cbox/scene.json"
SWITCHES = ("AKR_FUSE_RAYS", "AKR_SPLIT_DEPTH", "AKR_SPLIT_FRAC", "AKR_PERSISTENT",
            "AKR_MAX_LANES", "AKR_PALLAS_SHADE", "AKR_MEGAKERNEL")


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


def _spy_traversals(monkeypatch, scene) -> list:
    """Record the lane count and any-hit mask of every Scene.intersect."""
    calls = []
    orig = scene.intersect

    def spy(o, *args, **kw):
        calls.append((o.shape[0], kw.get("any_hit_mask") is not None))
        return orig(o, *args, **kw)

    monkeypatch.setattr(scene, "intersect", spy)
    return calls


def test_fused_rays_matches_jax(monkeypatch, jax_table):
    """AKR_FUSE_RAYS=1 on both sides (JAX's test_fused_rays_matches_sequential
    configuration: 16x16, 8 spp, d6, rr 3), on the dispatch route: the
    port's image within JAX's rtol=1e-4, atol=1e-5 of JAX's fused render
    and of the port's sequential one, every bounce's traversal 2N lanes
    with the any-hit mask (measured on the CPU: within 4e-7 of JAX's)."""
    js, ts = _scenes(16, jax_table)
    cfg = dict(spp=8, max_depth=6, rr_depth=3, spp_per_pass=8)
    seq, st = t_render_pt(ts, PTConfig(**cfg))
    assert st["fused_rays"] is False and st["shade"] == "dispatch"
    monkeypatch.setenv("AKR_FUSE_RAYS", "1")
    calls = _spy_traversals(monkeypatch, ts)
    fused, st = t_render_pt(ts, PTConfig(**cfg))
    assert st["fused_rays"] is True and st["shade"] == "dispatch"
    assert calls and all(n == 2 * 256 and masked for n, masked in calls)
    want, _ = j_render_pt(js, JPTConfig(**cfg))
    want = np.asarray(want)
    assert np.isfinite(fused).all()
    np.testing.assert_allclose(fused, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(fused, seq, rtol=1e-4, atol=1e-5)


def test_split_pass_bit_exact_and_matches_jax(monkeypatch, jax_table):
    """AKR_SPLIT_DEPTH=2, AKR_SPLIT_FRAC=4 (JAX's
    test_split_compacted_pass_bit_exact, at 32x32, 4 spp, d7): the split
    image equals the unsplit one bit for bit, sequential and under fused
    rays, the live counts are in the stats, and it lies within 2e-4/2e-5
    of JAX's split render."""
    js, ts = _scenes(32, jax_table)
    cfg = dict(spp=4, max_depth=7, spp_per_pass=4)
    images = {}
    for fuse in ("0", "1"):
        monkeypatch.setenv("AKR_FUSE_RAYS", fuse)
        monkeypatch.delenv("AKR_SPLIT_DEPTH", raising=False)
        a, st_a = t_render_pt(ts, PTConfig(**cfg))
        monkeypatch.setenv("AKR_SPLIT_DEPTH", "2")
        monkeypatch.setenv("AKR_SPLIT_FRAC", "4")
        b, st_b = t_render_pt(ts, PTConfig(**cfg))
        assert "split_depth" not in st_a and st_b["split_depth"] == 2
        assert len(st_b["split_live"]) == 4 and 0 < min(st_b["split_live"]) < 32 * 32
        assert np.array_equal(a, b), (fuse, float(np.max(np.abs(a - b))))
        images[fuse] = b
    monkeypatch.setenv("AKR_FUSE_RAYS", "0")
    want = np.asarray(j_render_pt(js, JPTConfig(**cfg))[0])
    np.testing.assert_allclose(images["0"], want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(images["1"], images["0"], rtol=1e-4, atol=1e-5)
    # a split depth outside (0, max_depth) renders unsplit
    monkeypatch.setenv("AKR_SPLIT_DEPTH", "7")
    assert "split_depth" not in t_render_pt(ts, PTConfig(**cfg))[1]


def test_resume_from_taken_rows_bit_exact(jax_table):
    """trace_paths stopped at depth 2 (finalize=False), a row subset taken
    (take_rows: every row and the sampler's) and resumed, equals the same
    lanes traced in one go, pending shadows of fused rays included."""
    from akari_render_tpu_torch.core.filters import GaussianFilter
    from akari_render_tpu_torch.integrators.pt import camera_sample

    _, ts = _scenes(16, jax_table)
    settings = common.PTSettings(max_depth=6, rr_depth=3)
    filt = GaussianFilter(1.5)
    ids = torch.arange(0, 256, 3)
    for fuse in ("0", "1"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("AKR_FUSE_RAYS", fuse)
            o, d, _, sampler = camera_sample(ts, filt, 1, 0, {"type": "pmj02bn"})
            whole, _, _ = common.trace_paths(ts, settings, o, d, sampler)
            st = common.trace_paths(ts, settings, o, d, sampler, depth_end=2, finalize=False)
            assert ("p_valid" in st) == (fuse == "1") and st["sampler"].dim == 2 + 7 * 2
            part, _, _ = common.trace_paths(ts, settings, None, None, None,
                                            resume_state=common.take_rows(st, ids), depth_beg=2)
        assert torch.equal(part, whole[ids]), fuse


def _state_after(js, ts, draws: int):
    for _ in range(draws):
        js, _ = js.next_1d()
        ts, _ = ts.next_1d()
    return js, ts


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("kind", ["independent", "hash", "sobol", "pmj02bn"])
def test_mixed_dims_select_take_bit_exact(kind, monkeypatch):
    """Lanes at mixed depths, as the persistent wavefront holds them: one
    sampler advanced 2, 5, 9 and 16 draws, each lane's state picked from
    one of them (JAX's _lane_select, the port's select on per-lane
    dimensions), then 9 draws and a take of every third lane and 3 more:
    every draw bit-equal to JAX's, for each sampler type."""
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
    states, done = [], 0
    for draws in (2, 5, 9, 16):
        js, ts = _state_after(js, ts, draws - done)
        done = draws
        states.append((js, t_lds.lanewise(ts, n)))
    pick = rng.integers(0, len(states), n)
    jm, tm = states[0]
    for k in range(1, len(states)):
        mask = pick == k
        jm = j_lane_select(jnp.asarray(mask), states[k][0], jm)
        tm = type(tm).select(torch.as_tensor(mask), states[k][1], tm)
    if kind in ("sobol", "pmj02bn"):
        assert torch.equal(tm.dim, torch.as_tensor(np.array(jm.dim), dtype=torch.int64))
    for d in range(9):
        jm, ju = jm.next_1d()
        tm, tu = tm.next_1d()
        assert np.array_equal(_bits(ju), _bits(tu.numpy())), f"draw {d}"
    ids = np.arange(0, n, 3)
    jt = jax.tree_util.tree_map(lambda x: x[ids] if x.ndim and x.shape[0] == n else x, jm)
    tt = tm.take(torch.as_tensor(ids))
    if kind == "pmj02bn":
        assert tt.tables is tm.tables
    for d in range(3):
        jt, ju = jt.next_1d()
        tt, tu = tt.next_1d()
        assert np.array_equal(_bits(ju), _bits(tu.numpy())), f"draw {d} after take"


def test_lockstep_sampler_keeps_int_dims():
    """trace_paths' lanes draw in lockstep: a sampler made for every pixel
    keeps one Python int dimension through its draws (no per-lane
    tensor, so pmj02's table row costs no launch), and select refuses two
    different int dimensions."""
    pix = torch.arange(64)
    s = t_lds.make_sampler({"type": "pmj02bn"}, pix, 3)
    s, _ = s.next_3d()
    assert s.dim == 3 and isinstance(s.dim, int)
    t, _ = s.next_1d()
    with pytest.raises(ValueError):
        t_samplers.select(pix < 32, s, t)
