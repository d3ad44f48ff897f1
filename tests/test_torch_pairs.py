"""PyTorch port, the pair sweep (accel/pairs.py): the plain versions of K2
to K6 against the JAX package's Pallas kernels in interpret mode, the sort
keys' layouts, and intersect_pairs (static and windowed walk) against the
JAX intersect_pairs, all bit-equal.

XLA on the CPU contracts a*b + c into fused multiply-adds, which round
differently from torch's separate ops (and from the CUDA kernels, built
with -fmad=false). The JAX references here are therefore compiled with
xla_backend_optimization_level 0, which keeps every op rounded on its own;
nothing else about them changes. The CUDA kernels against these plain
versions are in test_torch_gpu.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu.accel import pairs as jp
from akari_render_tpu.accel.bvh import build_bvh as j_build_bvh
from akari_render_tpu.accel.cluster import build_clusters as j_build_clusters
from akari_render_tpu_torch.accel import pairs as tp
from akari_render_tpu_torch.native import build_bvh_order
from akari_render_tpu_torch.accel.cluster import build_clusters
from akari_render_tpu_torch.interop import cluster_arrays_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jit_unfused(fn):
    """jax.jit with every op rounded on its own (no FMA contraction)."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


def t_(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.fixture(scope="module")
def soup():
    """The random soup of tests/test_pairs.py."""
    rng = np.random.default_rng(7)
    T = 2500
    c = rng.uniform(-5, 5, (T, 3)).astype(np.float32)
    return (c, rng.normal(0, 0.3, (T, 3)).astype(np.float32),
            rng.normal(0, 0.3, (T, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def clusters(soup):
    """(JAX ClusterArrays, the port's) over the soup, 16 per cluster."""
    v0, e1, e2 = soup
    jcl = j_build_clusters(v0, e1, e2, np.asarray(j_build_bvh(v0, e1, e2).order), cluster_size=16)
    tcl = build_clusters(v0, e1, e2, build_bvh_order(v0, e1, e2), cluster_size=16)
    return jcl, tcl


def _rays(n=700, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.full(n, 1e-3, np.float32), np.full(n, 1e20, np.float32)


def test_cluster_build_matches(clusters):
    jcl, tcl = clusters
    for f in ("cbmin", "cbmax", "tri", "order"):
        np.testing.assert_array_equal(getattr(tcl, f).numpy(), np.asarray(getattr(jcl, f)), err_msg=f)


@pytest.mark.parametrize("mode", ["o", "d0", "d3", "d9"])
def test_sort_key_layouts_match(mode, monkeypatch):
    """The "o" and "dK" sort-key layouts against _morton_keys, bit-equal in
    int64, named by argument and through AKR_SORT_KEY."""
    rng = np.random.default_rng(8)
    n = 20000
    o = rng.uniform(-3.2, 3.2, (n, 3)).astype(np.float32)  # some outside the box: clipped
    d = (rng.normal(size=(n, 3)) * rng.choice([1e-3, 1.0, 1e3], (n, 1))).astype(np.float32)
    d[:50, 2] = 0.0
    lo, hi = np.full((1, 3), -3.0, np.float32), np.full((1, 3), 3.0, np.float32)
    want = np.asarray(jit_unfused(lambda *a: jp._morton_keys(*a, mode=mode))(o, d, lo, hi))
    got = tp.sort_keys(t_(o), t_(d), t_(lo), t_(hi), mode=mode)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    monkeypatch.setenv("AKR_SORT_KEY", mode)
    assert torch.equal(tp.sort_keys(t_(o), t_(d), t_(lo), t_(hi)), got)
    monkeypatch.delenv("AKR_SORT_KEY")
    assert not torch.equal(tp.sort_keys(t_(o), t_(d), t_(lo), t_(hi)), got)  # default "i"


def test_sort_keys_match():
    """The "i" sort keys (origin + |direction| interleave), bit-equal, on
    directions of every scale and sign."""
    rng = np.random.default_rng(5)
    n = 20000
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = (rng.normal(size=(n, 3)) * rng.choice([1e-3, 1.0, 1e3], (n, 1))).astype(np.float32)
    d[:50, 1] = 0.0
    lo, hi = np.full((1, 3), -3.0, np.float32), np.full((1, 3), 3.0, np.float32)
    want = np.asarray(jit_unfused(lambda *a: jp._morton_keys(*a, mode="i"))(o, d, lo, hi))
    got = tp.sort_keys(t_(o), t_(d), t_(lo), t_(hi)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def _cull_inputs(B=5, K=700, seed=11):
    """test_pairs.py's cull inputs: sign-straddling inverse-direction
    intervals, one fully dead block, B and K off the TPU tile."""
    rng = np.random.default_rng(seed)
    olo = rng.uniform(-3, 2, (B, 3)).astype(np.float32)
    ohi = olo + rng.uniform(0, 1, (B, 3)).astype(np.float32)
    ilo = rng.uniform(-8, 4, (B, 3)).astype(np.float32)
    ihi = ilo + rng.uniform(0, 8, (B, 3)).astype(np.float32)
    bt0 = rng.uniform(0, 0.1, (B,)).astype(np.float32)
    bt1 = rng.uniform(0.5, 6, (B,)).astype(np.float32)
    bt1[1] = -1.0
    cbmin = rng.uniform(-4, 3, (K, 3)).astype(np.float32)
    cbmax = cbmin + rng.uniform(0, 2, (K, 3)).astype(np.float32)
    summ = np.concatenate([olo, ohi, ilo, ihi, bt0[:, None], bt1[:, None],
                           np.zeros((B, 2), np.float32)], axis=1)
    cb6 = np.concatenate([cbmin.T, cbmax.T], axis=0)
    return summ, cb6


def test_k2_plain_matches_pallas(monkeypatch):
    """K2's plain version against _cull_einit in interpret mode, and its
    row chunking is transparent."""
    summ, cb6 = _cull_inputs()
    want = np.asarray(jit_unfused(lambda s, c: jp._cull_einit(s, c, interpret=True))(summ, cb6))
    got = tp.cull_einit_torch(t_(summ), t_(cb6)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[1]).all() and np.isfinite(got).any()
    monkeypatch.setattr(tp, "CHUNK_ELEMS", 700)
    np.testing.assert_array_equal(tp.cull_einit_torch(t_(summ), t_(cb6)).numpy(), want)
    before = dict(tp.launches)
    assert torch.equal(tp.cull_einit(t_(summ), t_(cb6)), t_(got))  # CPU: the plain version
    assert tp.launches == before


def _block_lanes(B, seed):
    """B blocks of BLOCK sorted-lane SoA inputs: origins, inverse
    directions and [tmin, t-limit], the last block dead (t-limit -1)."""
    rng = np.random.default_rng(seed)
    n = B * tp.BLOCK
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::97, 0] = 0.0  # axis-parallel lanes
    inv = (1.0 / np.where(np.abs(d) < 1e-20, np.where(d < 0, -1e-20, 1e-20), d)).astype(np.float32)
    tmin = np.zeros(n, np.float32)
    t1 = rng.uniform(0.1, 5.0, n).astype(np.float32)
    t1[::7] = -1.0
    t1[(B - 1) * tp.BLOCK:] = -1.0
    return o, d, inv, np.stack([tmin, t1])


def test_k3_plain_matches_pallas():
    """K3's plain version against _refine_all in interpret mode. e_con is
    the consistent conservative cull of the same lanes; the dead block and
    a block whose e_con row is forced to +inf are rejected in full."""
    B, K = 3, 700
    o, _, inv, lim = _block_lanes(B, seed=5)
    rng = np.random.default_rng(6)
    cbmin = rng.uniform(-3, 2, (K, 3)).astype(np.float32)
    cbmax = cbmin + rng.uniform(0, 1.5, (K, 3)).astype(np.float32)
    cb6 = np.concatenate([cbmin.T, cbmax.T], axis=0)
    ob, ib = o.reshape(B, -1, 3), inv.reshape(B, -1, 3)
    summ = np.concatenate([ob.min(1), ob.max(1), ib.min(1), ib.max(1),
                           lim[0].reshape(B, -1).min(1)[:, None],
                           lim[1].reshape(B, -1).max(1)[:, None], np.zeros((B, 2))],
                          axis=1).astype(np.float32)
    e_con = tp.cull_einit_torch(t_(summ), t_(cb6)).numpy()
    e_con[1] = np.inf
    args = (cb6, o.T.copy(), inv.T.copy(), lim, e_con)
    want = np.asarray(jit_unfused(lambda *a: jp._refine_all(*a, interpret=True))(*args))
    got = tp.refine_all_torch(*(t_(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[1:]).all() and np.isfinite(got[0]).sum() > 50


def test_k5_plain_matches_pallas(monkeypatch):
    """K5's plain version against _refine in interpret mode: a gathered
    window of boxes per block (W 512, two chunks of the TPU kernel), with
    the TPU walk's padding members (min +inf, max -inf: their slabs are
    unbounded, so they pass for any live lane, and the caller slices them
    off), lanes occluded in any hit (limit -inf) and a dead block; exact,
    chunked or not."""
    B, W = 3, 512
    o, _, inv, lim = _block_lanes(B, seed=15)
    lim[1, ::5] = -np.inf
    rng = np.random.default_rng(16)
    bmin = rng.uniform(-3, 2, (B, 3, W)).astype(np.float32)
    wb = np.concatenate([bmin, bmin + rng.uniform(0, 0.4, (B, 3, W)).astype(np.float32)], axis=1)
    wb[:, :3, -70:] = np.inf
    wb[:, 3:, -70:] = -np.inf
    args = (wb, o.T.copy(), inv.T.copy(), lim)
    want = np.asarray(jit_unfused(lambda *a: jp._refine(*a, interpret=True))(*args))
    got = tp.refine_torch(*(t_(a) for a in args))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(got[:B - 1, -70:].all()) and not got[B - 1].any()
    assert 20 < int(got[0, :-70].sum()) < W - 70  # some real members pass, some fail
    monkeypatch.setattr(tp, "CHUNK_ELEMS", tp.BLOCK * W)
    assert torch.equal(tp.refine_torch(*(t_(a) for a in args)), got)
    # the same window by id: each member a column of cb6, every member set
    cb6 = t_(wb.transpose(1, 0, 2).reshape(6, B * W))
    win_i = torch.arange(B * W, dtype=torch.int32).reshape(B, W)
    ok = torch.ones((B, W), dtype=torch.bool)
    before = dict(tp.launches)
    lanes = (t_(o.T.copy()), t_(inv.T.copy()), t_(lim))
    assert torch.equal(tp.refine_window(cb6, win_i, ok, *lanes), got)  # CPU: the plain version
    assert tp.launches == before


def _sweep_inputs(B=2, M=8, C=16, R=12, seed=9):
    """One sweep round's inputs: R triangle rows of C slots (some padding,
    id -1), candidates with instanced transforms (random affine rows and id
    offsets) and identity ones, dummy candidates, ascending entries that
    straddle the block horizons, exclusion ids and per-lane any-hit flags."""
    rng = np.random.default_rng(seed)
    n = B * tp.BLOCK
    tri = np.zeros((R + 1, C, 12), np.float32)
    tri[:R, :, 0:3] = rng.uniform(-1.5, 1.5, (R, C, 3))
    tri[:R, :, 3:9] = rng.normal(0, 0.8, (R, C, 6))
    tri[:R, :, 9] = np.arange(R * C, dtype=np.float32).reshape(R, C)
    tri[:R, -2:, 9] = -1.0  # padding slots
    tri[:R, -2:, 3:9] = 0.0
    tri[R, :, 9] = -1.0  # the dummy row
    KX = 10
    xf = np.zeros((KX + 1, 16), np.float32)
    xf[:, 0] = xf[:, 5] = xf[:, 10] = 1.0
    for k in range(0, KX, 2):  # instanced candidates: affine world->local
        a = np.eye(3) + rng.normal(0, 0.2, (3, 3))
        xf[k, :12] = np.concatenate([a, rng.normal(0, 0.3, (3, 1))], axis=1).reshape(12)
        xf[k, 12] = 1000.0 + 50 * k
    tri_ix = rng.integers(0, R, (B, M)).astype(np.int32)
    tri_ix[:, -1] = R  # dummy
    tri_ix[1, 2] = R
    xf_ix = rng.integers(0, KX, (B, M)).astype(np.int32)
    cent = np.sort(rng.uniform(0.0, 4.0, (B, M)), axis=1).astype(np.float32)
    cent[tri_ix == R] = np.inf
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin = np.zeros(n, np.float32)
    tlim = rng.uniform(0.5, 6.0, n).astype(np.float32)
    tlim[::11] = -1.0
    gid_pool = np.concatenate([np.arange(R * C), 1000 + np.arange(R * C)])
    ex = np.full((4, n), -1.0, np.float32)
    for r, frac in enumerate((0.4, 0.2, 0.1)):
        pick = rng.random(n) < frac
        ex[r, pick] = rng.choice(gid_pool, pick.sum())
    ex[3] = (rng.random(n) < 0.3).astype(np.float32)
    best = np.stack([tlim, np.full(n, -1.0), np.zeros(n), np.zeros(n)]).astype(np.float32)
    return tri_ix, xf_ix, o.T.copy(), d.T.copy(), np.stack([tmin, tlim]), ex, cent[:, None, :], \
        tri, xf, best


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_k4_round_matches_pallas(any_hit):
    """One sweep round (sweep_ent_torch) against _sweep_ent in interpret
    mode: closest and any hit, per-lane any-hit flags, dummy candidates and
    instanced transform rows; all four rows bit-equal."""
    tri_ix, xf_ix, o, d, lim, ex, cent, tri, xf, best = _sweep_inputs()
    want = np.asarray(jit_unfused(
        lambda *a: jp._sweep_ent(*a, any_hit=any_hit, interpret=True)
    )(tri_ix, xf_ix, o, d, lim, ex, cent, tri, xf[:, None, :], best))
    got = tp.sweep_ent_torch(t_(tri_ix), t_(xf_ix), t_(o), t_(d), t_(lim), t_(ex), t_(cent),
                             t_(tri), t_(xf), t_(best), any_hit).numpy()
    np.testing.assert_array_equal(got, want)
    hit = want[1] >= 0
    assert hit.sum() > 100 and (want[1][hit] >= 1000).any()  # instanced ids hit too
    if not any_hit:
        assert (want[0] == np.float32(-3e38)).any()  # retired per-lane any-hit lanes


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_k6_sweep_matches_pallas(any_hit):
    """K6: `sweep` (its plain version on the CPU: one candidate per round,
    no entry cut) against JAX's _sweep in interpret mode, on the round
    inputs above (dummy candidates, instanced transforms, per-lane any-hit
    flags), bit-equal. Without the horizon early-out it tests candidates
    that the entry-cut round skips."""
    tri_ix, xf_ix, o, d, lim, ex, cent, tri, xf, best = _sweep_inputs()
    want = np.asarray(jit_unfused(
        lambda *a: jp._sweep(*a, any_hit=any_hit, interpret=True)
    )(tri_ix, xf_ix, o, d, lim, ex, tri, xf[:, None, :], best))
    got = tp.sweep(t_(tri_ix), t_(xf_ix), t_(o), t_(d), t_(lim), t_(ex), t_(tri), t_(xf),
                   t_(best), any_hit).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want[1] >= 0).sum() > 100


def _jax_pairs(jcl, o, d, tmin, tmax, ex=(None, None, None), **kw):
    fn = jit_unfused(lambda o_, d_, a, b, *e: jp.intersect_pairs(
        jcl, o_, d_, a, b, *e, interpret=True, maxc=6, **kw))
    return fn(o, d, tmin, tmax, *ex)


def _torch_pairs(tcl, o, d, tmin, tmax, ex=(None, None, None), **kw):
    return tp.intersect_pairs(tcl, t_(o), t_(d), t_(tmin), t_(tmax),
                              *(None if e is None else t_(e) for e in ex), **kw)


def _assert_hits_equal(got, want):
    for name in ("tri_id", "t", "bary", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


def _pairs_cases(n):
    """(name, tmax, exclusions, any_hit_mask, any_hit) cases over the rays:
    plain closest hit; finite tmax with dead lanes and exclusion ids; any
    hit; per-lane any hit inside a closest-hit call."""
    rng = np.random.default_rng(11)
    ex0 = rng.integers(0, 2500, n).astype(np.int32)
    ex1 = rng.integers(0, 2500, n).astype(np.int32)
    tmax = rng.uniform(0.5, 10.0, n).astype(np.float32)
    tmax[:40] = -1.0
    mask = (np.arange(n) % 2) == 1
    return [
        ("closest", None, (None, None, None), None, False),
        ("exclusions", tmax, (ex0, ex1, None), None, False),
        ("any_hit", np.full(n, 3.0, np.float32), (ex0, None, None), None, True),
        ("any_hit_mask", None, (None, None, None), mask, False),
    ]


@pytest.mark.parametrize("case", range(4), ids=["closest", "exclusions", "any_hit", "any_hit_mask"])
def test_intersect_pairs_matches_jax(clusters, case):
    """intersect_pairs on the soup of tests/test_pairs.py (16-triangle
    clusters, many candidates per block) against the JAX package's,
    bit-equal on ids, t, u and v."""
    jcl, tcl = clusters
    o, d, tmin, tmax = _rays()
    _, tmax_c, exs, mask, any_hit = _pairs_cases(len(o))[case]
    tmax = tmax if tmax_c is None else tmax_c
    kw = {"any_hit": any_hit}
    if mask is not None:
        kw["any_hit_mask"] = jnp.asarray(mask)
    want = _jax_pairs(jcl, o, d, tmin, tmax, exs, **kw)
    got = _torch_pairs(tcl, o, d, tmin, tmax, exs,
                       **{**kw, "any_hit_mask": None if mask is None else t_(mask)})
    if any_hit:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 20 < int(got.sum()) < len(o)
    else:
        _assert_hits_equal(got, want)
        assert int(got.valid.sum()) > 50


@pytest.mark.parametrize("case", range(3), ids=["closest", "exclusions", "any_hit"])
def test_windowed_walk_matches_jax(clusters, case, monkeypatch):
    """intersect_pairs under AKR_PAIRS_STATIC=0, the legacy windowed walk
    (K2, then rounds of window gather, K5, selection and sweep), against the
    JAX package's under the same switch (maxc 6: a window of 96 of the 157
    clusters, several rounds) and against the port's static walk, bit-equal.
    The port's rounds use the default MAXC, and 6: the result does not
    depend on it."""
    jcl, tcl = clusters
    o, d, tmin, tmax = _rays()
    _, tmax_c, exs, _, any_hit = _pairs_cases(len(o))[case]
    tmax = tmax if tmax_c is None else tmax_c
    static = _torch_pairs(tcl, o, d, tmin, tmax, exs, any_hit=any_hit)
    monkeypatch.setenv("AKR_PAIRS_STATIC", "0")
    calls = []
    real = tp.windowed_walk
    monkeypatch.setattr(tp, "windowed_walk", lambda *a, **k: calls.append(1) or real(*a, **k))
    want = _jax_pairs(jcl, o, d, tmin, tmax, exs, any_hit=any_hit)  # traced under the switch
    got = _torch_pairs(tcl, o, d, tmin, tmax, exs, any_hit=any_hit)
    assert calls == [1]
    s = tp.sort_rays(tcl, t_(o), t_(d), t_(tmin), t_(tmax), *(None if e is None else t_(e) for e in exs))
    e_con = tp.cull_einit(s.summ, tp.cluster_bounds(tcl))
    rounds = []
    small = tp._unsort_hits(real(tcl, s, e_con, any_hit, maxc=6, rounds=rounds), s.perm, len(o),
                            any_hit)
    assert len(rounds) > 1
    if any_hit:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(got, static) and torch.equal(got, small)
    else:
        _assert_hits_equal(got, want)
        for a, b, c in zip(got, static, small):
            assert torch.equal(a, b) and torch.equal(a, c)


def test_nan_lane_matches_jax(clusters):
    """A NaN lane traces as dead and does not poison its block, as in the
    JAX package."""
    jcl, tcl = clusters
    o, d, tmin, tmax = _rays()
    o[5] = np.nan
    d[5] = np.nan
    d[9, 1] = np.inf
    _assert_hits_equal(_torch_pairs(tcl, o, d, tmin, tmax), _jax_pairs(jcl, o, d, tmin, tmax))


def test_walk_round_size_is_transparent(clusters):
    """The plain walk's result does not depend on its round size, and the
    interop copy of the JAX clusters traverses like the port's own."""
    jcl, tcl = clusters
    o, d, tmin, tmax = _rays()
    s = tp.sort_rays(tcl, t_(o), t_(d), t_(tmin), t_(tmax))
    cb6 = tp.cluster_bounds(tcl)
    order = tp.refine_walk(cb6, s.o_soa, s.inv_soa, s.lim, tp.cull_einit(s.summ, cb6))[1:]
    args = (*order, tcl.tri_row, tcl.tri, tcl.xf, s.o_soa, s.d_soa, s.lim, s.ex, s.best0, False)
    one = tp.sweep_walk_torch(*args, maxc=tcl.num_clusters)
    many = tp.sweep_walk_torch(*args, maxc=3)
    assert torch.equal(one, many) and int((one[1] >= 0).sum()) > 50
    fields = {f: None if getattr(jcl, f) is None else np.asarray(getattr(jcl, f))
              for f in ("cbmin", "cbmax", "tri", "order", "xf", "tri_row")}
    via_interop = _torch_pairs(cluster_arrays_from_numpy(fields, "cpu"), o, d, tmin, tmax)
    for a, b in zip(_torch_pairs(tcl, o, d, tmin, tmax), via_interop):
        assert torch.equal(a, b)
