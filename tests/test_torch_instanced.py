"""PyTorch port, the cluster tier and instancing: the port's builds (native
BVH, instanced arrays, unified candidate list) against the JAX package's,
_partition_instances under its switches, the unified pair sweep against
the JAX package's, the instanced scene's intersections and interactions,
and that scene rendered through the cluster tier by both packages.

The JAX pair sweep runs in interpret mode, compiled with
xla_backend_optimization_level 0 (no FMA contraction), as in
test_torch_pairs.py."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu import scene as j_scene
from akari_render_tpu.accel import pairs as jp
from akari_render_tpu.accel.bvh import build_bvh as j_build_bvh
from akari_render_tpu.accel.wide import attach_wide as j_attach_wide
from akari_render_tpu.config import PTConfig as JPTConfig
from akari_render_tpu.integrators.pt import render_pt as j_render_pt
from akari_render_tpu.native import get_lib as j_native_lib
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch import scene as t_scene
from akari_render_tpu_torch.accel import pairs as tp
from akari_render_tpu_torch.accel import wide as tw
from akari_render_tpu_torch import native as t_native
from akari_render_tpu_torch.native import build_bvh_order
from akari_render_tpu_torch.config import PTConfig as TPTConfig
from akari_render_tpu_torch.integrators.pt import render_pt as t_render_pt
from akari_render_tpu_torch.interop import cluster_arrays_from_numpy, instanced_arrays_from_numpy
from test_instanced import _build_instanced_scene

ROOT = Path(__file__).resolve().parents[1]
CLASSROOM = ROOT / "scenes/classroom/scene.json"


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


@pytest.fixture(scope="module")
def inst_path(tmp_path_factory):
    """The instanced scene of tests/test_instanced.py: a floor, a lamp and
    five instances of one 576-triangle ball, 32x32 camera."""
    return _build_instanced_scene(tmp_path_factory.mktemp("inst"))


def _load_both(path, table, env, width=None, height=None):
    """(JAX scene, port scene) loaded under the env switches `env`."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        js = j_scene.load_scene(str(path), width, height)
        ts = t_scene.load_scene(str(path), width, height, device="cpu", ggx_table=table)
    return js, ts


@pytest.fixture(scope="module")
def inst_scenes(inst_path, table):
    """{force_bvh: (JAX scene, port scene)}: the balls instanced, the flat
    part below the cluster tier (K1 + unified sweep) or forced into it (one
    unified sweep over flat and instance clusters)."""
    base = {"AKR_INSTANCE_MIN_TRIS": "64"}
    return {
        False: _load_both(inst_path, table, base),
        True: _load_both(inst_path, table, {**base, "AKR_FORCE_BVH": "1"}),
    }


def _np(x):
    return None if x is None else np.asarray(x)


def _assert_clusters_equal(got, want, what):
    """Every field the port keeps, bit-equal (the JAX package's extra
    superclusters are not ported). The port attaches the wide walk's node
    table to every traversed list at load; the JAX package only where its
    pair-sweep tier runs (not on the CPU), so a missing one is built here."""
    if got.wide is not None and want.wide is None:
        want = j_attach_wide(want)
    for f in got._fields:
        g, w = getattr(got, f), _np(getattr(want, f))
        if g is None or w is None:
            assert g is None and w is None, (what, f)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{what}.{f}")


def _assert_instanced_equal(got, want):
    for f in got._fields:
        if f == "clusters":
            _assert_clusters_equal(got.clusters, want.clusters, "instanced.clusters")
        else:
            np.testing.assert_array_equal(getattr(got, f).numpy(), _np(getattr(want, f)),
                                          err_msg=f"instanced.{f}")


def _assert_accel_equal(js, ts):
    ja, ta = js.arrays, ts.arrays
    assert (ta.bvh is None) == (ja.bvh is None)
    if ta.bvh is not None:
        _assert_clusters_equal(ta.bvh["clusters"], ja.bvh["clusters"], "bvh")
    _assert_instanced_equal(ta.instanced, ja.instanced)
    _assert_clusters_equal(ta.unified, ja.unified, "unified")


def test_native_bvh_matches():
    """The native binned-SAH build through the port's loader gives the JAX
    package's native build's leaf order, which cuts the clusters."""
    assert j_native_lib() is not None  # the JAX side used the native builder too
    rng = np.random.default_rng(4)
    v0 = rng.uniform(-5, 5, (3000, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.3, (3000, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.3, (3000, 3)).astype(np.float32)
    np.testing.assert_array_equal(build_bvh_order(v0, e1, e2),
                                  np.asarray(j_build_bvh(v0, e1, e2).order))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed g++ build raises: there is no fallback to a numpy builder,
    whose trees (and so the cluster tables) differ from the JAX package's."""
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(t_native, "GXX_FLAGS", [*t_native.GXX_FLAGS, "-no-such-flag"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build_bvh_order(*(np.zeros((1, 3), np.float32) for _ in range(3)))
    assert not list(tmp_path.iterdir())  # no partial library left behind


@pytest.mark.parametrize("env", [
    {},
    {"AKR_INSTANCING": "0"},
    {"AKR_INSTANCE_MIN": "6"},  # five balls: too few references
    {"AKR_INSTANCE_MIN_TRIS": "1000"},  # 576 triangles: too small, all flatten
], ids=["defaults", "instancing_off", "instance_min", "instance_min_tris"])
def test_partition_instances_matches(inst_path, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    sg = t_scene.load_scene_json(str(inst_path))
    skip, specs, meshes = t_scene._partition_instances(sg)
    j_skip, j_specs, j_meshes = j_scene._partition_instances(j_scene.load_scene_json(str(inst_path)))
    assert skip == j_skip
    assert len(specs) == len(j_specs) and len(meshes) == len(j_meshes)
    for s, js_ in zip(specs, j_specs):
        assert s.keys() == js_.keys()
        for k in s:
            np.testing.assert_array_equal(np.asarray(s[k]), np.asarray(js_[k]), err_msg=k)
    for m, jm in zip(meshes, j_meshes):
        assert m.keys() == jm.keys()
        for k in m:
            np.testing.assert_array_equal(m[k], jm[k], err_msg=k)
    assert len(skip) == (5 if not env else 0)


@pytest.mark.parametrize("force_bvh", [False, True], ids=["flat_k1", "flat_clusters"])
def test_instanced_builds_match(inst_scenes, force_bvh):
    """build_instanced and build_unified_clusters on the instanced scene,
    bit-equal to the JAX package's."""
    js, ts = inst_scenes[force_bvh]
    assert ts.num_tris == js.num_tris
    _assert_accel_equal(js, ts)
    assert (ts.arrays.bvh is not None) == force_bvh


def test_classroom_builds_match(table):
    """Classroom's load-time acceleration state (433 flat clusters, 60
    instances of shared meshes, a unified list of 4,633 candidates over
    573 triangle rows), bit-equal to the JAX package's."""
    js, ts = _load_both(CLASSROOM, table, {}, 96, 96)
    assert ts.num_tris == js.num_tris == 55330
    _assert_accel_equal(js, ts)
    u = ts.arrays.unified
    assert u.num_clusters == 4633 and u.tri.shape[0] == 573
    assert ts.arrays.instanced.tri_base.shape[0] == 60


def test_interop_carries_accel_state(inst_scenes):
    """The JAX package's acceleration arrays, moved through interop, equal
    the port's own."""
    js, ts = inst_scenes[True]
    ja = js.arrays
    ju = j_attach_wide(ja.unified)  # the node table rides along
    unified = cluster_arrays_from_numpy({f: _np(getattr(ju, f)) for f in ju._fields}, "cpu")
    inst = {f: _np(getattr(ja.instanced, f)) for f in ja.instanced._fields if f != "clusters"}
    inst["clusters"] = {f: _np(getattr(ja.instanced.clusters, f))
                        for f in ja.instanced.clusters._fields}
    instanced = instanced_arrays_from_numpy(inst, "cpu")
    for got, want in ((unified, ts.arrays.unified), (instanced.clusters, ts.arrays.instanced.clusters)):
        for g, w in zip(got, want):
            assert (g is None and w is None) or (g.dtype == w.dtype and torch.equal(g, w))
    for f in instanced._fields:
        if f != "clusters":
            g, w = getattr(instanced, f), getattr(ts.arrays.instanced, f)
            assert g.dtype == w.dtype and torch.equal(g, w), f


def _rays(n=256):
    """tests/test_instanced.py's rays: from above the floor, down into the
    balls and the floor."""
    rng = np.random.default_rng(11)
    o = np.asarray([0.0, 5.0, 8.0], np.float32) + rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-3, 3, (n, 3)).astype(np.float32) * np.asarray([1, 0.3, 1], np.float32)
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d, np.zeros(n, np.float32), np.full(n, 1e8, np.float32)


def _jax_pairs(cl, o, d, tmin, tmax, ex=(None, None, None), **kw):
    fn = jax.jit(lambda o_, d_, a, b, *e: jp.intersect_pairs(cl, o_, d_, a, b, *e, interpret=True,
                                                             maxc=6, **kw),
                 compiler_options={"xla_backend_optimization_level": 0})
    return fn(o, d, tmin, tmax, *ex)


def _t(x):
    return None if x is None else torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("case", ["closest", "exclusions", "any_hit", "any_hit_mask", "nan_lane"])
def test_unified_pairs_matches_jax(inst_scenes, case):
    """The port's intersect_pairs over the JAX package's unified table
    (instance clusters with world->local rows, through interop) against the
    JAX intersect_pairs: ids, t, u and v bit-equal."""
    js, _ = inst_scenes[False]
    ju = js.arrays.unified
    cl = cluster_arrays_from_numpy({f: _np(getattr(ju, f)) for f in ju._fields}, "cpu")
    o, d, tmin, tmax = _rays()
    n = len(o)
    ex, kw = (None, None, None), {}
    if case == "exclusions":
        first = _jax_pairs(ju, o, d, tmin, tmax)
        ex = (np.where(np.arange(n) % 3 == 0, np.asarray(first.tri_id), -1).astype(np.int32),
              np.full(n, 5000 + 17, np.int32), None)
        tmax = np.where(np.arange(n) % 5 == 0, 4.0, tmax).astype(np.float32)
    elif case == "any_hit":
        tmax = np.where(np.arange(n) % 2 == 0, 12.0, 4.0).astype(np.float32)  # balls at ~9.4
        kw = {"any_hit": True}
    elif case == "any_hit_mask":
        kw = {"any_hit_mask": np.arange(n) % 2 == 1}
    elif case == "nan_lane":
        o[7] = np.nan
        d[9, 2] = np.inf
    want = _jax_pairs(ju, o, d, tmin, tmax, ex, **{k: (jnp.asarray(v) if k == "any_hit_mask" else v)
                                                   for k, v in kw.items()})
    got = tp.intersect_pairs(cl, _t(o), _t(d), _t(tmin), _t(tmax), *(_t(e) for e in ex),
                             **{k: (_t(v) if k == "any_hit_mask" else v) for k, v in kw.items()})
    if case == "any_hit":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 10 < int(got.sum()) < n
        return
    for name in ("tri_id", "t", "bary", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(got.valid.sum()) > 20 and bool((got.tri_id >= js.num_tris).any())


@pytest.mark.parametrize("force_bvh", [False, True], ids=["flat_k1", "flat_clusters"])
def test_scene_intersections_match(inst_scenes, force_bvh):
    """The port's Scene.intersect, occlude and surface_interaction on the
    instanced scene against the JAX package's (its two-level instanced
    traversal on the CPU), with tests/test_instanced.py's tolerances."""
    js, ts = inst_scenes[force_bvh]
    o, d, tmin, tmax = _rays()
    jh = js.intersect(*(jnp.asarray(x) for x in (o, d, tmin, tmax)))
    th = ts.intersect(*(_t(x) for x in (o, d, tmin, tmax)))
    v = np.asarray(jh.valid)
    np.testing.assert_array_equal(th.valid.numpy(), v)
    np.testing.assert_allclose(th.t.numpy()[v], np.asarray(jh.t)[v], rtol=1e-4, atol=1e-5)
    # a miss reports RAY_TMAX, as the JAX package's TPU routes (pair sweep,
    # Pallas K1) do; its CPU brute force reports min(RAY_TMAX, tmax)
    assert (th.t.numpy()[~v] == np.float32(1e20)).all()
    assert v.sum() > 100 and bool((th.tri_id[th.valid] >= ts.num_tris).any())

    t_seg = np.full_like(tmax, 6.0)
    jo = js.occlude(*(jnp.asarray(x) for x in (o, d, tmin, t_seg)))
    to = ts.occlude(*(_t(x) for x in (o, d, tmin, t_seg)))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))

    jsi = js.surface_interaction(jnp.maximum(jh.tri_id, 0), jh.bary)
    tsi = ts.surface_interaction(torch.clamp(th.tri_id, min=0), th.bary)
    for key in ("p", "ng", "ns", "uv", "area"):
        np.testing.assert_allclose(tsi[key].numpy()[v], np.asarray(jsi[key])[v], rtol=2e-3,
                                   atol=2e-4, err_msg=key)
    for key in ("mat", "kind"):
        np.testing.assert_array_equal(tsi[key].numpy()[v], np.asarray(jsi[key])[v], err_msg=key)


@pytest.fixture(scope="module")
def jax_slice(inst_scenes):
    """The JAX package's 32x32, 4 spp, d5 render of the instanced scene
    with its flat part forced into the cluster tier."""
    jimg, _ = j_render_pt(inst_scenes[True][0], JPTConfig(spp=4, max_depth=5, spp_per_pass=4))
    return np.asarray(jimg)


def test_slice_through_cluster_tier_matches_jax(inst_scenes, jax_slice):
    """The instanced scene with its flat part forced into the cluster tier,
    32x32 at 4 spp, d5, through both packages' path tracers at the same
    seed (tolerance of tests/test_instanced.py's render check)."""
    _, ts = inst_scenes[True]
    timg, stats = t_render_pt(ts, TPTConfig(spp=4, max_depth=5, spp_per_pass=4))
    assert stats["traversal"] == "pairs-static"
    assert timg.shape == jax_slice.shape == (32, 32, 3) and np.isfinite(timg).all()
    assert jax_slice.mean() > 0.0
    np.testing.assert_allclose(timg, jax_slice, rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("switch,traversal", [("AKR_WIDE=1", "wide"),
                                              ("AKR_PAIRS_STATIC=0", "pairs-windowed")])
def test_slice_through_other_traversals_matches_jax(inst_scenes, jax_slice, switch, traversal,
                                                    monkeypatch):
    """The same render through the wide-BVH walk and through the legacy
    windowed walk: the stats name the traversal, its entry point ran, and
    the image is within the same tolerance of the JAX package's (the hits
    are the same whatever the traversal; rtol 1e-3, atol 2e-3 as above)."""
    _, ts = inst_scenes[True]
    monkeypatch.setenv(*switch.split("="))
    calls = []
    for mod, name in ((tw, "wide_walk"), (tp, "windowed_walk")):
        monkeypatch.setattr(mod, name, lambda *a, _f=getattr(mod, name), _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    timg, stats = t_render_pt(ts, TPTConfig(spp=4, max_depth=5, spp_per_pass=4))
    assert stats["traversal"] == traversal
    assert set(calls) == {"wide_walk" if traversal == "wide" else "windowed_walk"}
    assert np.isfinite(timg).all()
    np.testing.assert_allclose(timg, jax_slice, rtol=1e-3, atol=2e-3)
