"""K5, the windowed walk's window refine (accel/pairs.py::refine_window),
through its plain version and its torch twin, on the windows the walk
gathers over classroom's unified candidate list.

- `refine_window_torch`, the plain version (the window's boxes gathered as
  the JAX walk gathers them, `refine_torch`, and the members' flags), must
  equal the JAX package's `_refine` in interpret mode, compiled unfused, on
  the same gathered window.
- `refine_window_grouped_torch`, the kernel step for step (members read by
  id, blocks without a member skipped, slab tests only for the 32-lane
  warps whose interval summary K2's chain passes), must equal the plain
  version on every round of the walk.
- The windowed walk (intersect_pairs with AKR_PAIRS_STATIC=0), which calls
  refine_window each round, must equal the JAX package's under the same
  switch, hits bit for bit.

The windows hold dead lanes, lanes with NaN rays or limits, lanes occluded
in an any-hit walk (limit -inf), members the walk masks, and rays aimed
within 1e-6 to 1e-4 rad of the planes of the triangles that define a
candidate's box (tests/torch_cull_rays.py). The CUDA kernel is held to the
plain version bit for bit on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from akari_render_tpu.accel import pairs as jp
from akari_render_tpu.accel.cluster import ClusterArrays as JClusterArrays
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch.accel import pairs as tp
from akari_render_tpu_torch.camera import generate_rays
from akari_render_tpu_torch.core.math import RAY_TMAX
from akari_render_tpu_torch.scene import load_scene
from torch_cull_rays import aimed_rays

ROOT = Path(__file__).resolve().parents[1]
CLASSROOM = ROOT / "scenes/classroom/scene.json"


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.fixture(scope="module")
def classroom():
    table = np.asarray(j_get_table("ggx_dielectric_s"))
    sc = load_scene(str(CLASSROOM), 96, 96, device="cpu", ggx_table=table)
    return sc, sc.arrays.unified


def _rays(sc, cl):
    """Four blocks of lanes: classroom camera rays from the middle rows of
    its 1080p film, bounce rays from their hits, rays aimed near the planes
    of the triangles that define three candidates' boxes, dead lanes
    (tmax -1) and lanes with a NaN origin or direction."""
    rng = np.random.default_rng(5)
    n = 640
    cam = sc.camera
    p = np.stack([rng.uniform(0, cam.width, n), cam.height * 0.5 + rng.uniform(-40, 40, n)], -1)
    o_c, d_c = generate_rays(cam, _t(p))
    tmin = torch.full((n,), 1e-4)
    h = tp.intersect_pairs(cl, o_c, d_c, tmin, torch.full((n,), RAY_TMAX))
    hit_p = o_c + d_c * torch.where(h.valid, h.t, 0.0)[:, None]
    d_b = _t(rng.normal(size=(n, 3)))
    d_b /= d_b.norm(dim=1, keepdim=True)
    d_b = torch.where(((d_b * d_c).sum(1) > 0)[:, None], -d_b, d_b)
    o_a, d_a, _ = aimed_rays(cl, [0, cl.num_clusters // 2, cl.num_clusters - 1], "plane_grazing", 3)
    m = 2048 - 2 * n
    o_a, d_a = _t(o_a[:m]), _t(d_a[:m])
    o = torch.cat([o_c, hit_p, o_a])
    d = torch.cat([d_c, d_b, d_a])
    tmax = torch.cat([torch.full((n,), RAY_TMAX), torch.where(h.valid, RAY_TMAX, -1.0),
                      torch.full((len(o_a),), RAY_TMAX)])
    tmax[_t(rng.random(len(o)) < 0.05, torch.bool)] = -1.0
    o[7] = float("nan")
    d[900, 1] = float("nan")
    return o, d, torch.full((len(o),), 1e-4), tmax


@pytest.fixture(scope="module")
def windows(classroom):
    """Every K5 call of the windowed walk over _rays, closest hit and any
    hit (whose occluded lanes carry the limit -inf): {mode: [args]}."""
    sc, cl = classroom
    o, d, tmin, tmax = _rays(sc, cl)
    s = tp.sort_rays(cl, o, d, tmin, tmax)
    e_con = tp.cull_einit(s.summ, tp.cluster_bounds(cl))
    real, out = tp.refine_window, {}
    for mode, any_hit in (("closest", False), ("any_hit", True)):
        calls = out.setdefault(mode, [])

        def capture(*a):
            calls.append(a)
            return real(*a)

        tp.refine_window = capture
        try:
            tp.windowed_walk(cl, s, e_con, any_hit)
        finally:
            tp.refine_window = real
    return out


@pytest.mark.parametrize("mode", ["closest", "any_hit"])
def test_twin_equals_plain_on_every_round(windows, mode):
    """The kernel's torch twin equals the plain version on every window of
    the walk; the walk's later rounds hold blocks with no member left, and
    the any-hit walk's windows lanes occluded at -inf."""
    calls = windows[mode]
    assert len(calls) > 2
    tally = {}
    passed = 0
    for a in calls:
        want = tp.refine_window_torch(*a)
        got = tp.refine_window_grouped_torch(*a, tally=tally)
        assert got.dtype == want.dtype == torch.int32
        assert torch.equal(got, want)
        assert not bool(want[~a[2]].any())
        passed += int(want.sum())
    assert passed > 100 and tally["ok"] > passed
    assert passed <= tally["units"] < tally["tests"]
    assert any(not bool(a[2].any(1).all()) for a in calls)  # a block with no member
    if mode == "any_hit":
        assert any(bool((a[5][1] == -float("inf")).any()) for a in calls)


def test_plain_matches_jax_refine(windows):
    """The plain version against the JAX _refine in interpret mode, compiled
    unfused, on the gathered first window of each walk (W = 1024, four of
    the TPU kernel's chunks), with the members' flags applied after it."""
    jit = jax.jit(lambda *a: jp._refine(*a, interpret=True),
                  compiler_options={"xla_backend_optimization_level": 0})
    for mode in ("closest", "any_hit"):
        cb6, win_i, ok, o, i, lim = windows[mode][0]
        wb = cb6[:, win_i.long()].permute(1, 0, 2).contiguous()
        want = np.asarray(jit(*(x.numpy() for x in (wb, o, i, lim))))
        want = np.where(ok.numpy(), want, 0)
        got = tp.refine_window_torch(cb6, win_i, ok, o, i, lim)
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < int(got.sum()) < int(ok.sum())


def test_twin_on_masked_members_and_odd_lanes(windows):
    """On the first window with a third of the members masked, NaN limits,
    a tmin above its limit, tmin at its limit, limits of -inf and a whole
    warp of dead lanes: twin == plain, the masked members 0; on the CPU
    the wrapper takes the plain version and launches nothing."""
    cb6, win_i, ok, o, i, lim = windows["closest"][0]
    rng = np.random.default_rng(9)
    ok = ok & _t(rng.random(tuple(ok.shape)) > 0.33, torch.bool)
    lim = lim.clone()
    lim[0, 3], lim[1, 5] = float("nan"), float("nan")
    lim[0, 40:48] = lim[1, 40:48] + 1.0
    lim[0, 60:70] = lim[1, 60:70]
    lim[1, 100:130] = -float("inf")
    lim[0, 512:544] = 2.0 * RAY_TMAX  # a dead warp
    tally = {}
    want = tp.refine_window_torch(cb6, win_i, ok, o, i, lim)
    assert torch.equal(tp.refine_window_grouped_torch(cb6, win_i, ok, o, i, lim, tally), want)
    assert not bool(want[~ok].any()) and int(want.sum()) > 10
    assert tally["tests"] < 16 * tally["ok"]  # the dead warp tests nothing
    before = dict(tp.launches)
    assert torch.equal(tp.refine_window(cb6, win_i, ok, o, i, lim), want)
    assert tp.launches == before


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_windowed_walk_matches_jax(classroom, any_hit, monkeypatch):
    """intersect_pairs under AKR_PAIRS_STATIC=0 on _rays over classroom's
    unified list against the JAX package's under the same switch (its
    Pallas kernels in interpret mode, compiled unfused; maxc 6, so many
    rounds), given the port's candidate list: ids, t, u, v or occlusion
    bit-equal."""
    _, cl = classroom
    o, d, tmin, tmax = _rays(*classroom)
    jcl = JClusterArrays(**{f: jax.numpy.asarray(getattr(cl, f).numpy())
                            for f in ("cbmin", "cbmax", "tri", "order", "xf", "tri_row")})
    monkeypatch.setenv("AKR_PAIRS_STATIC", "0")
    fn = jax.jit(lambda *a: jp.intersect_pairs(jcl, *a, interpret=True, maxc=6, any_hit=any_hit),
                 compiler_options={"xla_backend_optimization_level": 0})
    want = fn(*(x.numpy() for x in (o, d, tmin, tmax)))
    got = tp.intersect_pairs(cl, o, d, tmin, tmax, any_hit=any_hit)
    if any_hit:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 100 < int(got.sum()) < len(o)
        return
    for name in ("tri_id", "t", "bary", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(got.valid.sum()) > 1000
