"""The skip of the cluster tier's candidate test (K4, K6, K7;
akari_render_tpu_torch/csrc/candidate_test.cuh) through its plain torch
twin in accel/pairs.py: the widened per-lane box test (`box_pass_torch`)
on the boxes of `candidate_test_boxes`, which exempt sliver triangles.
The skip is right only if it never drops a test that `_mt_update`, the
definition, would let change a lane's best hit; these tests hold the twin
to that on walks over the instanced test scene and classroom, on rays
aimed at the triangles that define a cluster's box (down to 1e-6 rad from
a triangle's own plane), and on whole walks.
(A second skip, an early reject of a slot on the numerators of u, v and t,
was tried and taken out again: it saved no time on the card.)

The inputs come from seeded numpy. The CUDA kernels themselves are held to
`_mt_update` bit for bit on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch import scene as t_scene
from akari_render_tpu_torch.accel import pairs as tp
from akari_render_tpu_torch.camera import generate_rays
from akari_render_tpu_torch.core.math import RAY_TMAX
from test_instanced import _build_instanced_scene
from torch_cull_rays import aimed_rays as _aimed_rays

ROOT = Path(__file__).resolve().parents[1]
CLASSROOM = ROOT / "scenes/classroom/scene.json"
L = tp.BLOCK


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def table():
    return np.asarray(j_get_table("ggx_dielectric_s"))


@pytest.fixture(scope="module")
def instanced(tmp_path_factory, table):
    """The unified candidate list of tests/test_instanced.py's scene (a
    floor, a lamp, five scaled instances of one 576-triangle ball), flat
    part forced into the cluster tier: instance candidates with world->local
    rows beside flat ones."""
    path = _build_instanced_scene(tmp_path_factory.mktemp("cull"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AKR_INSTANCE_MIN_TRIS", "64")
        mp.setenv("AKR_FORCE_BVH", "1")
        sc = t_scene.load_scene(str(path), device="cpu", ggx_table=table)
    cl = sc.arrays.unified
    assert cl.xf is not None and cl.num_clusters > 10
    return sc, cl


@pytest.fixture(scope="module")
def classroom(table):
    sc = t_scene.load_scene(str(CLASSROOM), 96, 96, device="cpu", ggx_table=table)
    return sc, sc.arrays.unified


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _scene_rays(sc, cl, n, seed):
    """Half camera rays (coherent), half rays from interior points in random
    directions, a third of those cut short (shadow-like); a few dead lanes."""
    rng = np.random.default_rng(seed)
    cam = sc.camera
    p = rng.random((n // 2, 2)) * [cam.width, cam.height]
    o_c, d_c = generate_rays(cam, _t(p))
    lo, hi = cl.cbmin.amin(0).numpy(), cl.cbmax.amax(0).numpy()
    o_r = lo + (hi - lo) * (0.1 + 0.8 * rng.random((n - n // 2, 3)))
    d_r = rng.normal(size=o_r.shape)
    d_r /= np.linalg.norm(d_r, axis=-1, keepdims=True)
    tmax = np.full(n, RAY_TMAX)
    cut = n // 2 + np.nonzero(rng.random(n - n // 2) < 0.33)[0]
    tmax[cut] = rng.uniform(0.2, 3.0, len(cut))
    tmax[rng.random(n) < 0.02] = -1.0
    o = torch.cat([o_c.contiguous(), _t(o_r)])
    d = torch.cat([d_c, _t(d_r)])
    return o, d, torch.full((n,), 1e-4), _t(tmax)


def _mt_hits(tri, x, o, d, lim, ex, best):
    """The hit mask of pairs._mt_update [nb, C, L], written out again here
    (the definition returns only the folded best): the witness of which
    slots hit."""
    f = [tri[:, :, i:i + 1] for i in range(10)]
    xs = [x[:, i:i + 1, None] for i in range(13)]
    wo, wd = [o[:, i:i + 1] for i in range(3)], [d[:, i:i + 1] for i in range(3)]
    lo = [xs[4 * r] * wo[0] + xs[4 * r + 1] * wo[1] + xs[4 * r + 2] * wo[2] + xs[4 * r + 3]
          for r in range(3)]
    ld = [xs[4 * r] * wd[0] + xs[4 * r + 1] * wd[1] + xs[4 * r + 2] * wd[2] for r in range(3)]
    e1, e2 = f[3:6], f[6:9]
    px = ld[1] * e2[2] - ld[2] * e2[1]
    py = ld[2] * e2[0] - ld[0] * e2[2]
    pz = ld[0] * e2[1] - ld[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    ok = torch.abs(det) > 1e-12
    inv = torch.where(ok, 1.0 / det, 0.0)
    tx, ty, tz = lo[0] - f[0], lo[1] - f[1], lo[2] - f[2]
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    v = (qx * ld[0] + qy * ld[1] + qz * ld[2]) * inv
    t = (qx * e2[0] + qy * e2[1] + qz * e2[2]) * inv
    gidw = f[9] + xs[12]
    return (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > lim[:, 0:1])
            & (t < best[:, 0:1]) & (f[9] >= 0.0)
            & (gidw != ex[:, 0:1]) & (gidw != ex[:, 1:2]) & (gidw != ex[:, 2:3]))


def _check_candidate(tri, x, box, o, d, lim, ex, best, any_hit, tally):
    """One candidate (box [nb, 7]: a row of candidate_test_boxes) against nb
    blocks of lanes: every slot that hits, in a lane whose best `_mt_update`
    may change, lies in a lane that passes the box test, or is a sliver
    slot of a candidate flagged for them; and `mt_update_culled`, the
    kernels' candidate test in torch, gives `_mt_update`'s best. Returns it."""
    new = tp._mt_update(tri, x, o, d, lim, ex, best, any_hit)
    hits = _mt_hits(tri, x, o, d, lim, ex, best)
    changed = (new != best).any(dim=1)
    # the witness is the definition's: a lane changes iff one of its slots hits
    # (an any-hit lane that is hit again may keep the same id)
    assert not bool((changed & ~hits.any(dim=1)).any())
    if not any_hit:
        assert torch.equal(changed, hits.any(dim=1))
    tmin, bt = lim[:, 0], best[:, 0]
    in_box = tp.box_pass_torch(box[:, None, :6], o.permute(0, 2, 1), d.permute(0, 2, 1), tmin, bt)
    sliver = tp.sliver_slots(tri) & (box[:, 6:7] > 0)  # [nb, C]
    outside = hits & ~in_box[:, None, :]
    assert not bool((outside & ~sliver[:, :, None]).any()), "the box test rejected a lane that hits"
    assert torch.equal(tp.mt_update_culled(tri, x, box, o, d, lim, ex, best, any_hit), new)
    live = bt > tmin
    tally["sliver_hits_outside_box"] = tally.get("sliver_hits_outside_box", 0) + int(outside.sum())
    tally["lanes"] += int(live.sum())
    tally["in_box"] += int((in_box & live).sum())
    tally["hits"] += int(hits.sum())
    return new


def _checked_walk(cl, s, any_hit, max_steps):
    """The static walk of intersect_pairs, one candidate a step with the
    lanes' best carried along (so the box test sees limits as fresh as the
    kernel's), _check_candidate at every step."""
    cb6 = tp.cluster_bounds(cl)
    _, worder, went, kcnt = tp.refine_walk(cb6, s.o_soa, s.inv_soa, s.lim,
                                           tp.cull_einit(s.summ, cb6))
    cb6 = tp.candidate_test_boxes(cl, cb6)
    B = worder.shape[0]

    def blocks(a):
        return a.reshape(a.shape[0], B, L).permute(1, 0, 2)

    o, d, lm, ex = blocks(s.o_soa), blocks(s.d_soa), blocks(s.lim), blocks(s.ex)
    best = blocks(s.best0).contiguous()
    tally = dict.fromkeys(("lanes", "in_box", "hits"), 0)
    for k in range(min(max_steps, int(kcnt.max()))):
        t1 = torch.where(best[:, 1] >= 0.0, tp.ANY_HIT_RETIRED, lm[:, 1]) if any_hit else best[:, 0]
        r = torch.nonzero((k < kcnt) & (went[:, k] <= t1.amax(dim=1))).squeeze(1)
        if r.numel() == 0:
            break
        ci = worder[r, k].long()
        rows = cl.tri_row.long()[ci] if cl.tri_row is not None else ci
        best[r] = _check_candidate(cl.tri[rows], cl.xf[ci], cb6[:, ci].T, o[r], d[r], lm[r], ex[r],
                                   best[r], any_hit, tally)
    return tally


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("which", ["instanced", "classroom"])
def test_skips_keep_every_hit_on_walks(which, any_hit, request):
    """Along real walks (instanced scene: every candidate; classroom: the
    first 40 of four blocks), with exclusion ids on a third of the lanes:
    no (lane, candidate) pair that `_mt_update` lets hit fails the widened
    box test. It would catch a margin too small for the local-space
    rounding of instanced candidates; the tallies show that the test does
    cull (a test that passes because nothing is ever skipped is no test)."""
    sc, cl = request.getfixturevalue(which)
    o, d, tmin, tmax = _scene_rays(sc, cl, 4 * L, seed=5)
    first = tp.intersect_pairs(cl, o, d, tmin, tmax)
    ex0 = torch.where(torch.arange(4 * L) % 3 == 0, first.tri_id, -1)
    s = tp.sort_rays(cl, o, d, tmin, tmax, ex0)
    tally = _checked_walk(cl, s, any_hit, max_steps=40)
    assert tally["hits"] > 200
    assert tally["in_box"] < 0.25 * tally["lanes"], tally


@pytest.mark.parametrize("how", ["head_on", "grazing", "random", "plane_grazing"])
@pytest.mark.parametrize("which", ["instanced", "classroom"])
def test_skips_keep_hits_on_rays_aimed_at_box_defining_triangles(which, how, request):
    """Rays through an instance transform at the vertices and edges of the
    triangles that reach a candidate's box faces, where a hit lies on the
    box's surface and the local-space t, u, v round on their own: with the
    t-limit open, cut just behind the target and cut just in front of it.
    Every lane `_mt_update` hits passes the box test. It would catch a box
    test that compares without the margin (these hits fail an exact slab
    test by a rounding) or against a stale or wrong limit. The
    plane_grazing rays lie within 1e-6 to 1e-4 rad of their target
    triangle's own plane, where the solve's t, u and v are worst
    conditioned (their error grows as one over that angle), and are also
    cut well before and behind the target (to a half, 0.9, 0.99, 0.999,
    1.001 and 1.01 of its distance): they would catch a margin that the
    solve's rounding outgrows above 1e-6 rad."""
    _, cl = request.getfixturevalue(which)
    _aimed_tally(cl, how)


def _aimed_tally(cl, how):
    """The body of the test above for one candidate list and one kind of
    aimed ray; returns _check_candidate's tallies."""
    inst = torch.nonzero(cl.xf[:, 12] > 0).squeeze(1).numpy()  # instance candidates
    assert len(inst) > 4
    cands = inst[np.random.default_rng(1).choice(len(inst), 6, replace=False)]
    o, d, dist = _aimed_rays(cl, cands, how, seed=2)
    n = len(o)
    per = n // len(cands)
    tally = dict.fromkeys(("lanes", "in_box", "hits"), 0)
    cb6 = tp.candidate_test_boxes(cl, tp.cluster_bounds(cl))
    scales = (None, 1.0 + 1e-5, 1.0 - 1e-5)
    if how == "plane_grazing":
        scales += (0.5, 0.9, 0.99, 0.999, 1.001, 1.01)
    for scale in scales:
        tlim = np.full(n, RAY_TMAX, np.float32) if scale is None else dist * np.float32(scale)
        for i, ci in enumerate(cands):
            sl = slice(i * per, (i + 1) * per)
            lanes = per
            o_b, d_b = _t(o[sl]).T[None], _t(d[sl]).T[None]
            lim = torch.stack([torch.zeros(lanes), _t(tlim[sl])])[None]
            ex = torch.cat([torch.full((3, lanes), -1.0), torch.zeros((1, lanes))])[None]
            best = torch.stack([_t(tlim[sl]), torch.full((lanes,), -1.0), torch.zeros(lanes),
                                torch.zeros(lanes)])[None]
            row = int(cl.tri_row[ci])
            _check_candidate(cl.tri[row][None], cl.xf[ci][None], cb6[:, ci][None], o_b, d_b, lim,
                             ex, best, False, tally)
    assert tally["hits"] > n // 2, tally  # the aimed rays do hit their targets
    return tally


@pytest.mark.parametrize("mode", ["closest", "any_hit", "any_hit_mask"])
def test_culled_walk_equals_plain_walk(instanced, mode):
    """`sweep_walk_culled_torch`, the K4 kernel step for step with the box
    test applied, against `sweep_walk_torch` on the instanced scene: scene
    rays and aimed rays (head-on, grazing a box face and grazing a
    triangle's plane), exclusion ids, dead lanes,
    the per-lane any-hit flag: `best` (t, id, u, v) array-equal. It would
    catch a skip that changes a hit anywhere along a walk, the order of
    hits with equal t among them."""
    sc, cl = instanced
    o, d, tmin, tmax = _scene_rays(sc, cl, 2 * L - 300, seed=8)
    inst = torch.nonzero(cl.xf[:, 12] > 0).squeeze(1).numpy()
    extra = [_aimed_rays(cl, inst[:3], how, seed=4)
             for how in ("head_on", "grazing", "plane_grazing")]
    o = torch.cat([o] + [_t(e[0]) for e in extra])[:2 * L]
    d = torch.cat([d] + [_t(e[1]) for e in extra])[:2 * L]
    pad = o.shape[0] - tmin.shape[0]
    tmin = torch.cat([tmin, torch.full((pad,), 1e-4)])
    tmax = torch.cat([tmax, torch.full((pad,), RAY_TMAX)])
    first = tp.intersect_pairs(cl, o, d, tmin, tmax)
    ex0 = torch.where(torch.arange(o.shape[0]) % 4 == 0, first.tri_id, -1)
    mask = torch.arange(o.shape[0]) % 2 == 1 if mode == "any_hit_mask" else None
    s = tp.sort_rays(cl, o, d, tmin, tmax, ex0, any_hit_mask=mask)
    cb6 = tp.cluster_bounds(cl)
    order = tp.refine_walk(cb6, s.o_soa, s.inv_soa, s.lim, tp.cull_einit(s.summ, cb6))[1:]
    tail = (s.o_soa, s.d_soa, s.lim, s.ex, s.best0, mode == "any_hit")
    want = tp.sweep_walk_torch(*order, cl.tri_row, cl.tri, cl.xf, *tail)
    got = tp.sweep_walk_culled_torch(*order, cl.tri_row, cl.tri, cl.xf,
                                     tp.candidate_test_boxes(cl, cb6), *tail)
    assert torch.equal(got, want)
    assert int((want[1] >= 0).sum()) > 200


def test_culled_walk_equals_plain_walk_on_classroom(classroom):
    """The same on one block of classroom's camera rays, whose walk runs to
    a few hundred of the 4,633 candidates, most of them instanced."""
    sc, cl = classroom
    o, d, tmin, tmax = _scene_rays(sc, cl, 2 * L, seed=6)
    s = tp.sort_rays(cl, o[:L], d[:L], tmin[:L], tmax[:L])
    cb6 = tp.cluster_bounds(cl)
    order = tp.refine_walk(cb6, s.o_soa, s.inv_soa, s.lim, tp.cull_einit(s.summ, cb6))[1:]
    tail = (s.o_soa, s.d_soa, s.lim, s.ex, s.best0, False)
    want = tp.sweep_walk_torch(*order, cl.tri_row, cl.tri, cl.xf, *tail)
    got = tp.sweep_walk_culled_torch(*order, cl.tri_row, cl.tri, cl.xf,
                                     tp.candidate_test_boxes(cl, cb6), *tail)
    assert torch.equal(got, want)
    assert int((want[1] >= 0).sum()) > L // 2


def test_box_margin_is_needed(instanced):
    """The margin is not decoration: on the aimed rays an exact slab test
    (no margin) does reject lanes that hit. It would catch adversarial
    inputs that have gone soft."""
    sc, cl = instanced
    inst = torch.nonzero(cl.xf[:, 12] > 0).squeeze(1).numpy()
    cb6 = tp.cluster_bounds(cl)
    test_boxes = tp.candidate_test_boxes(cl, cb6)
    lost = 0
    for how in ("head_on", "grazing", "random", "plane_grazing"):
        o, d, dist = _aimed_rays(cl, inst, how, seed=9)
        per = len(o) // len(inst)
        for i, ci in enumerate(inst):
            sl = slice(i * per, (i + 1) * per)
            o_b, d_b = _t(o[sl]).T[None], _t(d[sl]).T[None]
            lim = torch.stack([torch.zeros(per), torch.full((per,), RAY_TMAX)])[None]
            ex = torch.cat([torch.full((3, per), -1.0), torch.zeros((1, per))])[None]
            best = torch.stack([lim[0, 1], torch.full((per,), -1.0), torch.zeros(per),
                                torch.zeros(per)])[None]
            x = cl.xf[ci][None]
            hits = _mt_hits(cl.tri[int(cl.tri_row[ci])][None], x, o_b, d_b, lim, ex, best).any(1)
            box = cb6[:, ci][None, None, :]
            inv = 1.0 / d_b.permute(0, 2, 1)
            a = (box[..., 0:3] - o_b.permute(0, 2, 1)) * inv
            b = (box[..., 3:6] - o_b.permute(0, 2, 1)) * inv
            exact = torch.minimum(a, b).amax(-1).clamp(min=0.0) <= torch.maximum(a, b).amin(-1)
            lost += int((hits & ~exact).sum())
            box = test_boxes[:6, ci][None, None, :]
            assert not bool((hits & ~tp.box_pass_torch(box, o_b.permute(0, 2, 1),
                                                       d_b.permute(0, 2, 1), lim[:, 0],
                                                       best[:, 0])).any())
    assert lost > 0, "no aimed ray hits where an exact slab test fails: the rays are too easy"


def test_sliver_triangles_are_tested_outside_the_box(instanced, classroom):
    """Both scenes hold zero-area triangles (the poles of the instanced
    ball; 384 in classroom), on which `_mt_update` divides by a determinant
    that is rounding noise above its 1e-12 threshold and reports hits
    anywhere along a ray. `candidate_test_boxes` flags exactly the
    candidates whose row holds one, beside the unchanged boxes, and
    `mt_update_culled` then tests those slots for every lane that can still
    be hit. It would catch a box test that culls such a slot: the aimed rays
    do hit sliver slots from outside the (widened) box."""
    for (sc, cl), most in ((instanced, 1.0), (classroom, 0.01)):
        cb6 = tp.cluster_bounds(cl)
        boxes = tp.candidate_test_boxes(cl, cb6)
        assert torch.equal(boxes[:6], cb6)
        e1, e2 = cl.tri[:, :, 3:6].double(), cl.tri[:, :, 6:9].double()
        sin = torch.linalg.cross(e1, e2).norm(dim=-1) / (e1.norm(dim=-1) * e2.norm(dim=-1))
        real = cl.tri[:, :, 9] >= 0
        thin = (real & ~(sin > 2.0 * tp.SLIVER_SIN)).any(dim=1)[cl.tri_row.long()]
        wide_ = (real & ~(sin > 0.5 * tp.SLIVER_SIN)).any(dim=1)[cl.tri_row.long()]
        flag = boxes[6] > 0
        assert bool((flag | ~wide_).all()), "a candidate with a sliver triangle is not flagged"
        assert bool((thin | ~flag).all()), "a candidate without a sliver triangle is flagged"
        assert 0 < int(flag.sum()) <= most * cl.num_clusters
    tally = _aimed_tally(instanced[1], "plane_grazing")
    assert tally["sliver_hits_outside_box"] > 0, tally
