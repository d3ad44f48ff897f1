"""The exact skips of the two kernels redesigned for the card, through
their plain torch twins:

- K1 on the flat tier (accel/intersect.py): the soup cut into tiles of
  consecutive ids (`flat_tiles`), each lane testing a tile's triangles only
  when its ray reaches the tile's widened box within its best t, or the
  tile's hittable sliver triangles. `intersect_tris_culled_torch`, the
  kernel's walk step for step, must equal the brute force
  (`intersect_tris_torch`, the definition) bit for bit, and the JAX
  package's Pallas kernel in interpret mode as the plain version does.
- K3 with the walk order it feeds (accel/pairs.py): clusters whose K2 entry
  is +inf and (cluster, 32-lane warp) pairs that K2's chain rejects on the
  warp's summary are skipped, and the walk is a sort of (entry, id) keys.
  `refine_walk_grouped_torch`, the kernel step for step, must equal
  `refine_all_torch` + `walk_order` and the JAX `_refine_all` + stable
  argsort in interpret mode.

The inputs come from seeded numpy. The CUDA kernels themselves are held to
their plain versions bit for bit on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu.accel import pairs as jp
from akari_render_tpu.accel.pallas_intersect import intersect_pallas, pack_tris
from akari_render_tpu.accel.trace import intersect_brute_force as j_brute_force
from akari_render_tpu.accel.trace import occlude_brute_force as j_occlude
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch.accel import intersect as k1
from akari_render_tpu_torch.accel import pairs as tp
from akari_render_tpu_torch.accel.cluster import build_clusters
from akari_render_tpu_torch.camera import generate_rays
from akari_render_tpu_torch.core.math import RAY_TMAX
from akari_render_tpu_torch.native import build_bvh_order
from akari_render_tpu_torch.scene import load_scene
from torch_cull_rays import aimed_rays, sliver_rays, tile_clusters

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def matbox():
    table = np.asarray(j_get_table("ggx_dielectric_s"))
    return load_scene(str(ROOT / "scenes/matbox/scene.json"), 64, 64, device="cpu",
                      ggx_table=table)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _scene_rays(sc, n, seed):
    """Camera rays and rays from inside the box, with exclusion ids on some,
    cut tmax on others and a few dead lanes."""
    rng = np.random.default_rng(seed)
    cam = sc.camera
    o_c, d_c = generate_rays(cam, _t(rng.random((n // 2, 2)) * [cam.width, cam.height]))
    v0 = sc.arrays.v0.numpy()
    lo, hi = v0.min(0), v0.max(0)
    o_r = lo + (hi - lo) * (0.05 + 0.9 * rng.random((n - n // 2, 3)))
    d_r = rng.normal(size=o_r.shape)
    d_r /= np.linalg.norm(d_r, axis=-1, keepdims=True)
    tmax = np.where(rng.random(n) < 0.3, rng.random(n) * 3.0, RAY_TMAX)
    tmax[rng.random(n) < 0.05] = -1.0
    T = sc.num_tris
    exs = [_t(np.where(rng.random(n) < f, rng.integers(0, T, n), -1), torch.int32)
           for f in (0.5, 0.3, 0.2)]
    return (torch.cat([o_c.contiguous(), _t(o_r)]), torch.cat([d_c, _t(d_r)]), torch.zeros(n),
            _t(tmax), *exs)


def _check_twin(sc, o, d, tmin, tmax, *exs):
    """The twin against the brute force, closest and any hit, bit-equal.
    Returns the closest hits and the twin's tallies."""
    a = sc.arrays
    want = k1.intersect_tris_torch(o, d, tmin, tmax, a.v0, a.e1, a.e2, *exs)
    tally = {}
    got = k1.intersect_tris_culled_torch(o, d, tmin, tmax, sc.tiles, *exs, tally=tally)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(k1.intersect_tris_culled_torch(o, d, tmin, tmax, sc.tiles, *exs,
                                                      any_hit=True),
                       k1.intersect_tris_torch(o, d, tmin, tmax, a.v0, a.e1, a.e2, *exs,
                                               any_hit=True))
    return want, tally


def test_flat_tiles_cut_the_soup(matbox):
    """The tiles cover the soup in ascending id order, at most TILE
    triangles each, staged slots rounded up to 32; each box holds its
    triangles; the sliver flag marks exactly the tiles with a hittable
    sliver (matbox: 96 of its 192 zero-area triangles have a zero edge and
    never hit), and the sliver runs have tiles of their own; blinds is one
    tile of 28."""
    a, tiles = matbox.arrays, matbox.tiles
    ids = tiles.tri[..., 9]
    real = ids >= 0
    assert torch.equal(ids[real].long(), torch.arange(matbox.num_tris))
    counts = real.sum(1)
    assert bool((counts <= k1.TILE).all()) and torch.equal(tiles.slots.long(),
                                                           (counts + 31) // 32 * 32)
    verts = torch.stack([a.v0, a.v0 + a.e1, a.v0 + a.e2]).double()
    tile_of = torch.repeat_interleave(torch.arange(len(counts)), counts)
    assert bool((verts >= tiles.boxes[:3].T[tile_of].double()).all())
    assert bool((verts <= tiles.boxes[3:6].T[tile_of].double()).all())
    sliver = k1.hittable_slivers(a.v0, a.e1, a.e2)
    zero_area = tp.sliver_slots(torch.cat([a.v0, a.e1, a.e2, torch.zeros_like(a.v0)], 1))
    assert int(sliver.sum()) == 96 and int(zero_area.sum()) == 192
    flagged = torch.zeros(len(counts), dtype=torch.bool).index_put_((tile_of[sliver],),
                                                                      torch.tensor(True))
    assert torch.equal(tiles.boxes[6] > 0, flagged) and int(flagged.sum()) == 2
    for k in torch.nonzero(flagged).squeeze(1).tolist():  # a run: slivers at both ends
        run = ids[k][real[k]].long()
        assert bool(sliver[run[0]]) and bool(sliver[run[-1]])
    table = np.asarray(j_get_table("ggx_dielectric_s"))
    blinds = load_scene(str(ROOT / "scenes/blinds/scene.json"), 16, 16, device="cpu",
                        ggx_table=table)
    assert blinds.tiles.slots.tolist() == [32] and int((blinds.tiles.tri[0, :, 9] >= 0).sum()) == 28


def test_twin_equals_brute_force_on_matbox_rays(matbox):
    """Camera rays and rays from inside the box with exclusion ids, cut and
    dead lanes: the tile walk's hits are the brute force's, and it culls
    (most live (lane, tile) pairs fail the box test)."""
    want, tally = _check_twin(matbox, *_scene_rays(matbox, 2048, seed=3))
    assert int(want.valid.sum()) > 1200
    assert tally["in_box"] < 0.15 * tally["lane_tiles"], tally


@pytest.mark.parametrize("how", ["head_on", "grazing", "plane_grazing", "random"])
def test_twin_equals_brute_force_on_aimed_rays(matbox, how):
    """Rays aimed at the triangles that define every third tile's box
    (head-on, within a few 1e-4 rad of a box face, within 1e-6 to 1e-4 rad
    of the target triangle's own plane, from random directions), with the
    t-limit open and cut just in front of the target: the widened
    box (and the widened t-limit: rays within ~1e-5 rad of a sphere's
    surface that cross a tile border lose hits without it) loses no hit."""
    cands = np.arange(matbox.tiles.slots.shape[0])[::3]
    o, d, dist = aimed_rays(tile_clusters(matbox.tiles), cands, how, seed=2)
    n = len(o)
    for cut in (None, 1.0 - 1e-5):
        tmax = torch.full((n,), RAY_TMAX) if cut is None else _t(dist * np.float32(cut))
        want, _ = _check_twin(matbox, _t(o), _t(d), torch.zeros(n), tmax)
        assert int(want.valid.sum()) > n // 4


def test_twin_equals_brute_force_on_sliver_rays(matbox):
    """Rays through the hittable sliver triangles of every sliver run, from
    random directions: they do hit slivers (on which the determinant is
    rounding noise), and the twin, which tests a flagged tile's slivers for
    every lane that can still be hit, keeps every such hit."""
    a = matbox.arrays
    ids = torch.nonzero(k1.hittable_slivers(a.v0, a.e1, a.e2)).squeeze(1).numpy()
    o, d = sliver_rays(a.v0.numpy(), a.e1.numpy(), a.e2.numpy(), ids, 12, seed=5)
    n = len(o)
    want, _ = _check_twin(matbox, _t(o), _t(d), torch.zeros(n), torch.full((n,), RAY_TMAX))
    on_sliver = want.valid & k1.hittable_slivers(a.v0, a.e1, a.e2)[want.tri_id.clamp(min=0).long()]
    assert int(on_sliver.sum()) > 0


def test_twin_matches_jax(matbox, monkeypatch):
    """The twin on the first 160 triangles (two tiles) against the JAX
    package's brute force, and its closest hit against the Pallas kernel in
    interpret mode, run as tests/test_torch_accel.py runs it (TRI_CHUNK cut
    to 64): ids and occlusion exact, t, u, v to 1e-5 (the Pallas kernel's
    fused arithmetic rounds on its own)."""
    from akari_render_tpu.accel import pallas_intersect

    monkeypatch.setattr(pallas_intersect, "TRI_CHUNK", 64)
    a = matbox.arrays
    tris = [x[:160].contiguous() for x in (a.v0, a.e1, a.e2)]
    tiles = k1.flat_tiles(*tris)
    assert tiles.slots.tolist() == [128, 32]
    o, d, tmin, tmax, *exs = _scene_rays(matbox, 512, seed=7)
    exs = [torch.where(e < 160, e, -1) for e in exs]
    got = k1.intersect_tris_culled_torch(o, d, tmin, tmax, tiles, *exs)
    j = [jnp.asarray(x.numpy()) for x in (o, d, tmin, tmax)]
    jt = [jnp.asarray(x.numpy()) for x in tris]
    jex = [jnp.asarray(e.numpy()) for e in exs]
    jp_ = intersect_pallas(pack_tris(*jt), *j, *jex, interpret=True, block=512)
    for jh in (j_brute_force(*j, *jt, *jex), jp_):
        np.testing.assert_array_equal(got.tri_id.numpy(), np.asarray(jh.tri_id))
        hit = got.valid.numpy()
        np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(jh.t)[hit], rtol=1e-5)
        np.testing.assert_allclose(got.bary.numpy()[hit], np.asarray(jh.bary)[hit], rtol=1e-5,
                                   atol=1e-5)
    assert int(got.valid.sum()) > 50
    occ = k1.intersect_tris_culled_torch(o, d, tmin, tmax, tiles, *exs, any_hit=True)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(j_occlude(*j, *jt, *jex)))
    assert int(occ.sum()) > 50


def _refine_inputs():
    """The clusters of tests/test_torch_pairs.py (the random soup of
    tests/test_pairs.py, 16 triangles a cluster) and three sorted blocks of
    rays, most of them short segments, a few dead: (cb6, SortedRays, e_con)."""
    rng = np.random.default_rng(7)
    T = 2500
    v0 = rng.uniform(-5, 5, (T, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.3, (T, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.3, (T, 3)).astype(np.float32)
    cl = build_clusters(v0, e1, e2, build_bvh_order(v0, e1, e2), cluster_size=16)
    n = 3 * tp.BLOCK
    rng = np.random.default_rng(3)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(rng.random(n) < 0.9, rng.uniform(0.3, 2.0, n), RAY_TMAX).astype(np.float32)
    tmax[rng.random(n) < 0.05] = -1.0
    s = tp.sort_rays(cl, _t(o), _t(d), torch.full((n,), 1e-3), _t(tmax))
    cb6 = tp.cluster_bounds(cl)
    return cb6, s, tp.cull_einit_torch(s.summ, cb6)


def test_refine_walk_twin_equals_plain_and_jax():
    """K3's fused twin against refine_all_torch + walk_order (every row in
    full: the twin's keys put the +inf entries last by id, as the stable
    argsort does) and against the JAX package's _refine_all in interpret
    mode followed by its stable argsort, gather and count."""
    cb6, s, e_con = _refine_inputs()
    args = (cb6, s.o_soa, s.inv_soa, s.lim, e_con)
    got = tp.refine_walk_grouped_torch(*args)
    want = tp.refine_walk_torch(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[3].min()) > 10 and int(want[3].max()) < e_con.shape[1]
    jit = jax.jit(lambda *a: jp._refine_all(*a, interpret=True),
                  compiler_options={"xla_backend_optimization_level": 0})
    je = jit(*(jnp.asarray(x.numpy()) for x in args))
    jorder = jnp.argsort(je, axis=1, stable=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(je))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jnp.take_along_axis(je, jorder, 1)))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(jnp.isfinite(je).sum(1)))


def test_refine_walk_twin_on_dead_lanes_and_ties():
    """Lanes whose tmin is not below their t-limit (tmin raised to it, and
    above it) never pass, whole warps of them are skipped, and clusters
    with equal entries (duplicated boxes) walk in id order: the twin equals
    the plain version."""
    cb6, s, e_con = _refine_inputs()
    lim = s.lim.clone()
    lim[0, 100:164] = lim[1, 100:164]  # tmin == t-limit: the slab test still passes at near == far
    lim[0, 600:700] = lim[1, 600:700] + 1.0
    cb6 = torch.cat([cb6, cb6[:, :40]], dim=1)  # 40 clusters twice: ties in the entry
    e_con = torch.cat([e_con, e_con[:, :40]], dim=1)
    args = (cb6, s.o_soa, s.inv_soa, lim, e_con)
    got = tp.refine_walk_grouped_torch(*args)
    want = tp.refine_walk_torch(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    e = want[2]
    assert bool(((e[:, 1:] == e[:, :-1]) & torch.isfinite(e[:, 1:])).any())  # ties were sorted
