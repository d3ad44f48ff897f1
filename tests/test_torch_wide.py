"""PyTorch port, the wide-BVH walk (accel/wide.py): the node table against
the JAX package's build_wide, one walk round (walk_torch) against the
Pallas walk kernel in interpret mode, intersect_wide against the JAX
intersect_wide, and the routing switch, all bit-equal.

The JAX references are compiled with xla_backend_optimization_level 0 (no
FMA contraction on the CPU), as in test_torch_pairs.py. The fixtures are
those of tests/test_wide.py: a 2,500-triangle soup in 16-triangle clusters
and 700 rays from all octants. The CUDA kernel against these plain versions
is in test_torch_gpu.py and chip_smoke.py."""
import jax
import numpy as np
import pytest
import torch

from akari_render_tpu.accel import wide as jw
from akari_render_tpu.accel.bvh import build_bvh as j_build_bvh
from akari_render_tpu.accel.cluster import build_clusters as j_build_clusters
from akari_render_tpu.accel.instanced import build_instanced as j_build_instanced
from akari_render_tpu.accel.instanced import build_unified_clusters as j_build_unified
from akari_render_tpu_torch import scene as t_scene
from akari_render_tpu_torch.accel import pairs as tp
from akari_render_tpu_torch.accel import wide as tw
from akari_render_tpu_torch.interop import cluster_arrays_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jit_unfused(fn, **kw):
    """jax.jit with every op rounded on its own (no FMA contraction)."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0}, **kw)


def t_(x, dtype=None):
    return None if x is None else torch.as_tensor(np.array(x), dtype=dtype)


def _to_port(jcl):
    """The JAX ClusterArrays (node table attached) through interop."""
    return cluster_arrays_from_numpy(
        {f: None if getattr(jcl, f) is None else np.asarray(getattr(jcl, f)) for f in jcl._fields},
        "cpu")


@pytest.fixture(scope="module")
def flat():
    """(JAX clusters with the node table, the same through interop) over
    the soup of tests/test_wide.py, 16 triangles a cluster."""
    rng = np.random.default_rng(7)
    T = 2500
    v0 = rng.uniform(-5, 5, (T, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.3, (T, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.3, (T, 3)).astype(np.float32)
    jcl = jw.attach_wide(j_build_clusters(v0, e1, e2, np.asarray(j_build_bvh(v0, e1, e2).order),
                                          cluster_size=16))
    return jcl, _to_port(jcl)


@pytest.fixture(scope="module")
def unified():
    """The unified instanced list of tests/test_wide.py: three scaled and
    shifted instances of one 600-triangle mesh (transform rows, virtual
    global ids, shared triangle rows)."""
    rng = np.random.default_rng(5)
    T = 600
    mesh = {
        "v0": rng.uniform(-1, 1, (T, 3)).astype(np.float32),
        "e1": rng.normal(0, 0.2, (T, 3)).astype(np.float32),
        "e2": rng.normal(0, 0.2, (T, 3)).astype(np.float32),
        "ns": np.zeros((T, 3, 3), np.float32), "uv": np.zeros((T, 3, 2), np.float32),
        "tangent": np.zeros((T, 3, 3), np.float32), "mat_slot": np.zeros(T, np.int32),
    }
    insts = []
    for i in range(3):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = rng.uniform(-4, 4, 3)
        m[:3, :3] *= rng.uniform(0.5, 1.5)
        insts.append({"mesh": 0, "matrix": m, "slot_mat": [0], "slot_kind": [0], "inst_index": i})
    ia, _ = j_build_instanced([mesh], insts, tri_base0=0)
    jcl = jw.attach_wide(j_build_unified(ia, None))
    return jcl, _to_port(jcl)


def _rays(n=700, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.full(n, 1e-3, np.float32), np.full(n, 1e20, np.float32)


@pytest.mark.parametrize("which", ["flat", "unified"])
def test_node_table_matches(which, request):
    """build_wide on the same candidate boxes (and triangle rows): the
    node table array_equal to the JAX package's, through attach_wide."""
    jcl, tcl = request.getfixturevalue(which)
    want = np.asarray(jcl.wide)
    got = tw.attach_wide(tcl._replace(wide=None)).wide
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape and want.shape[1] == 128
    np.testing.assert_array_equal(got.numpy(), want)
    assert (tcl.tri_row is not None) == (which == "unified")
    # every candidate is a leaf exactly once
    words = want[:, 48:56]
    leaves = np.sort(-words[words < -1] - 2)
    np.testing.assert_array_equal(leaves, np.arange(tcl.num_clusters))


def _sorted_lanes(tcl, any_hit_tmax=None):
    """The 700 rays sorted as intersect_wide sorts them (2 blocks)."""
    o, d, tmin, tmax = _rays()
    if any_hit_tmax is not None:
        tmax = np.full_like(tmax, any_hit_tmax)
    return tp.sort_rays(tcl, t_(o), t_(d), t_(tmin), t_(tmax), dead_last=False)


def _assert_round_equal(got, want, what):
    """One walk round's outputs: emitted rows, candidate ids and entries,
    both counts, and the live part of the stacks, exact."""
    crow, cxf, cent, sid, se, srow, cnt = (np.asarray(x) for x in want)
    g = [x.numpy() for x in got]
    for name, a, b in zip(("crow", "cxf", "cent"), g[:3], (crow, cxf, cent)):
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")
    np.testing.assert_array_equal(g[6], cnt, err_msg=f"{what} cnt")
    for blk in range(cnt.shape[0]):
        live = int(cnt[blk, 0, 0])
        for name, a, b in zip(("sid", "se", "srow"), g[3:6], (sid, se, srow)):
            np.testing.assert_array_equal(a[blk, 0, :live], b[blk, 0, :live],
                                          err_msg=f"{what} {name} block {blk}")


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_walk_round_matches_pallas(flat, any_hit):
    """walk_torch against _walk in interpret mode, a first round and a
    resumed one (maxc 5 leaves a block stops both blocks with work left on
    their stacks; the resumed round starts from the first one's stacks and
    from limits tightened as a sweep would): every output exact."""
    jcl, tcl = flat
    s = _sorted_lanes(tcl, any_hit_tmax=3.0 if any_hit else None)
    B, SD, maxc = s.summ.shape[0], tw.STACK_DEPTH, 5
    stacks = (np.zeros((B, 1, SD), np.int32), np.full((B, 1, SD), tw.NEG, np.float32),
              np.zeros((B, 1, SD), np.int32), np.ones((B, 1, 1), np.int32))
    lanes = tuple(x.numpy() for x in (s.o_soa, s.d_soa, s.lim))
    best = s.best0.numpy().copy()
    jwalk = jit_unfused(lambda *a: jw._walk(*a, any_hit=any_hit, maxc=maxc, interpret=True))
    for rnd in ("first", "resumed"):
        want = jwalk(np.asarray(jcl.wide), *lanes, best, *stacks)
        got = tw.walk_torch(tcl.wide, s.o_soa, s.d_soa, s.lim, t_(best), *(t_(x) for x in stacks),
                            any_hit, maxc)
        _assert_round_equal(got, want, f"{rnd} round")
        cnt = np.asarray(want[6])
        assert (cnt[:, 0, 1] == maxc).all() and (cnt[:, 0, 0] > 0).all()  # stopped by maxc
        stacks = tuple(np.asarray(x) for x in want[3:6]) + (cnt[:, :, 0:1],)
        # tightened limits: a third of the lanes found a hit at t 2.5
        hit = np.arange(best.shape[1]) % 3 == 0
        best[0, hit] = np.minimum(best[0, hit], 2.5)
        best[1, hit] = 7.0


def _jax_wide(jcl, o, d, tmin, tmax, ex=(None, None, None), **kw):
    fn = jit_unfused(lambda o_, d_, a, b, *e: jw.intersect_wide(jcl, o_, d_, a, b, *e,
                                                                interpret=True, **kw))
    return fn(o, d, tmin, tmax, *ex)


def _torch_wide(tcl, o, d, tmin, tmax, ex=(None, None, None), **kw):
    return tw.intersect_wide(tcl, t_(o), t_(d), t_(tmin), t_(tmax), *(t_(e) for e in ex), **kw)


def _assert_hits_equal(got, want):
    for name in ("valid", "tri_id", "t", "bary"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


def _cases(n):
    """tests/test_wide.py's cases: closest hit; exclusion ids and cut tmax
    with 40 dead lanes; any hit."""
    rng = np.random.default_rng(11)
    ex0 = rng.integers(0, 2500, n).astype(np.int32)
    ex1 = rng.integers(0, 2500, n).astype(np.int32)
    tmax = rng.uniform(0.5, 10.0, n).astype(np.float32)
    tmax[:40] = -1.0
    return {"closest": (None, (None, None, None), False),
            "exclusions": (tmax, (ex0, ex1, None), False),
            "any_hit": (np.full(n, 3.0, np.float32), (ex0, None, None), True)}


@pytest.mark.parametrize("case", ["closest", "exclusions", "any_hit"])
def test_intersect_wide_matches_jax(flat, case):
    """intersect_wide (the plain rounds of walk_torch and sweep_ent_torch)
    against the JAX intersect_wide (Pallas walk and sweep in interpret
    mode): valid and ids exact, t, u and v bit-equal."""
    jcl, tcl = flat
    o, d, tmin, tmax = _rays()
    tmax_c, exs, any_hit = _cases(len(o))[case]
    tmax = tmax if tmax_c is None else tmax_c
    want = _jax_wide(jcl, o, d, tmin, tmax, exs, any_hit=any_hit)
    got = _torch_wide(tcl, o, d, tmin, tmax, exs, any_hit=any_hit)
    if any_hit:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 20 < int(got.sum()) < len(o)
    else:
        _assert_hits_equal(got, want)
        assert int(got.valid.sum()) > 50


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_intersect_wide_unified_matches_jax(unified, any_hit):
    """The unified instanced list (transform rows, virtual ids, shared
    triangle rows) through the wide walk, against the JAX package's."""
    jcl, tcl = unified
    o, d, tmin, tmax = _rays()
    want = _jax_wide(jcl, o, d, tmin, tmax, any_hit=any_hit)
    got = _torch_wide(tcl, o, d, tmin, tmax, any_hit=any_hit)
    if any_hit:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(got.sum()) > 10
    else:
        _assert_hits_equal(got, want)
        assert int(got.valid.sum()) > 10 and int(got.tri_id.max()) >= 600  # a later instance


def test_wide_matches_pair_sweep(flat):
    """The wide walk and the static pair sweep find the same hits on the
    soup: valid and t bit-equal, ids equal (the soup has no exact t tie)."""
    _, tcl = flat
    o, d, tmin, tmax = _rays()
    w = _torch_wide(tcl, o, d, tmin, tmax)
    p = tp.intersect_pairs(tcl, t_(o), t_(d), t_(tmin), t_(tmax))
    for a, b in zip(w, p):
        assert torch.equal(a, b)


@pytest.mark.parametrize("maxc", [1, 7])
def test_round_size_is_transparent(flat, maxc):
    """The plain version's result does not depend on the leaves a round
    emits: for closest hit every row of best equals the default's
    (MAXC_WIDE 128), for any hit the occlusion does (the id an occluded
    lane reports is the last tested leaf's that hit it). The counts say
    that the walk did resume."""
    _, tcl = flat
    for any_hit in (False, True):
        s = _sorted_lanes(tcl, any_hit_tmax=3.0 if any_hit else None)
        args = (tcl.wide, tcl.tri, tcl.xf, s.o_soa, s.d_soa, s.lim, s.ex, s.best0, any_hit)
        counts = torch.zeros((s.summ.shape[0], 2), dtype=torch.int32)
        ref = tw.wide_walk_torch(*args)
        got = tw.wide_walk_torch(*args, maxc=maxc, counts=counts)
        if any_hit:
            assert torch.equal(got[1] >= 0, ref[1] >= 0) and torch.equal(got[0], ref[0])
        else:
            assert torch.equal(got, ref)
        assert int((ref[1] >= 0).sum()) > 50
        assert bool((counts[:, 1] > maxc).all()) and bool((counts[:, 0] > 0).all())
    before = dict(tw.launches)
    assert torch.equal(tw.wide_walk(*args), ref)  # CPU: the plain version
    assert tw.launches == before


def test_routing(flat, monkeypatch):
    """AKR_WIDE=1 reaches the walk, any_hit_mask forces the pair sweep, and
    the default (and AKR_WIDE=0, and clusters without a node table) is the
    pair sweep."""
    _, tcl = flat
    o, d, tmin, tmax = (t_(x) for x in _rays(64))
    calls = []
    monkeypatch.setattr(t_scene, "intersect_wide", lambda *a, **k: calls.append("wide"))
    monkeypatch.setattr(t_scene, "intersect_pairs", lambda *a, **k: calls.append("pairs"))
    mask = torch.zeros(64, dtype=torch.bool)
    monkeypatch.delenv("AKR_WIDE", raising=False)
    t_scene._cluster_trace(tcl, o, d, tmin, tmax)
    monkeypatch.setenv("AKR_WIDE", "0")
    t_scene._cluster_trace(tcl, o, d, tmin, tmax, any_hit=True)
    monkeypatch.setenv("AKR_WIDE", "1")
    t_scene._cluster_trace(tcl, o, d, tmin, tmax)
    t_scene._cluster_trace(tcl, o, d, tmin, tmax, any_hit=True)
    t_scene._cluster_trace(tcl, o, d, tmin, tmax, any_hit_mask=mask)
    t_scene._cluster_trace(tcl._replace(wide=None), o, d, tmin, tmax)
    assert calls == ["pairs", "pairs", "wide", "wide", "pairs", "pairs"]
    with pytest.raises(ValueError, match="attach_wide"):
        tw.intersect_wide(tcl._replace(wide=None), o, d, tmin, tmax)
