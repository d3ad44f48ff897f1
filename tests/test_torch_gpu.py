"""PyTorch port on the card: the K1-K9 CUDA kernels against their plain
torch versions, and the slices on the card against the slices
on the CPU.

Every test here is marked gpu and skips without CUDA. The file imports no
jax, so it also runs where only torch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from akari_render_tpu_torch.accel import intersect as k1
from akari_render_tpu_torch.accel import nvcc, pairs, wide
from akari_render_tpu_torch.native import build_bvh_order
from akari_render_tpu_torch.accel.cluster import build_clusters
from akari_render_tpu_torch.camera import generate_rays
from akari_render_tpu_torch.config import RenderTask
from akari_render_tpu_torch.core.filters import GaussianFilter
from akari_render_tpu_torch.core.math import RAY_TMAX
from akari_render_tpu_torch.integrators import fused_shade as fs
from akari_render_tpu_torch.integrators import megakernel as mk
from akari_render_tpu_torch.integrators.common import PTSettings
from akari_render_tpu_torch.integrators.pt import render_pt
from akari_render_tpu_torch.scene import load_scene
from torch_cull_rays import adversarial_summaries, aimed_rays, instanced_soup, tile_clusters

ROOT = Path(__file__).resolve().parents[1]
SCENE = ROOT / "scenes/matbox/scene.json"
METHOD = ROOT / "scenes/matbox/pt.json"
BLINDS = ROOT / "scenes/blinds/scene.json"

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rays(scene, n, seed, device):
    """Camera rays and rays from inside the box, with exclusion ids."""
    rng = np.random.default_rng(seed)
    cam = scene.camera
    p = rng.random((n // 2, 2)) * [cam.width, cam.height]
    o_c, d_c = generate_rays(cam, torch.as_tensor(p, dtype=torch.float32, device=device))
    v0 = scene.arrays.v0.cpu().numpy()
    lo, hi = v0.min(0), v0.max(0)
    o_r = lo + (hi - lo) * (0.05 + 0.9 * rng.random((n // 2, 3)))
    d_r = rng.normal(size=(n // 2, 3))
    d_r /= np.linalg.norm(d_r, axis=-1, keepdims=True)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    o = torch.cat([o_c, t(o_r)]).contiguous()
    d = torch.cat([d_c, t(d_r)]).contiguous()
    t_count = scene.num_tris
    tmax = np.where(rng.random(n) < 0.3, rng.random(n) * 3.0, RAY_TMAX)
    tmax[rng.random(n) < 0.05] = -1.0
    exs = [t(np.where(rng.random(n) < f, rng.integers(0, t_count, n), -1), torch.int32)
           for f in (0.5, 0.3, 0.2)]
    return o, d, torch.zeros(n, device=device), t(tmax), *exs


def _check_k1(args, tiles, min_hits):
    """K1 (on `tiles`, and on the tiles it cuts itself) against its plain
    version, closest and any hit, bit-equal, with counters that show the
    box test skipping."""
    n = args[0].shape[0]
    nb = -(-n // k1.BLOCK)
    before = k1.launches
    hk = k1.intersect_tris(*args, tiles=tiles)
    hp = k1.intersect_tris_torch(*args)
    assert k1.launches == before + 1
    assert int(hp.valid.sum()) > min_hits
    for a, b in zip(hk, hp):
        assert torch.equal(a, b)
    for a, b in zip(k1.intersect_tris(*args), hp):
        assert torch.equal(a, b)
    walked = torch.zeros(nb, dtype=torch.int32, device=args[0].device)
    stats = torch.zeros((nb, 4), dtype=torch.int32, device=args[0].device)
    occ = k1.intersect_tris(*args, any_hit=True, tiles=tiles, walked=walked, stats=stats)
    assert torch.equal(occ, k1.intersect_tris_torch(*args, any_hit=True))
    assert bool((walked <= tiles.slots.shape[0]).all()) and int(stats[:, 3].sum()) >= int(occ.sum())
    return stats


def test_kernel_matches_plain_on_card(cuda):
    """K1 on matbox's tiles against its plain version: camera rays and rays
    from inside the box, with exclusion ids, cut and dead lanes."""
    scene = load_scene(str(SCENE), 64, 64, device=cuda)
    a = scene.arrays
    o, d, tmin, tmax, ex0, ex1, ex2 = _rays(scene, 1 << 16, 3, cuda)
    stats = _check_k1((o, d, tmin, tmax, a.v0, a.e1, a.e2, ex0, ex1, ex2), scene.tiles, 1 << 14)
    assert int(stats[:, 1].sum()) < 0.25 * (1 << 16) * scene.tiles.slots.shape[0]


def test_k1_matches_plain_on_aimed_rays_and_blinds_on_card(cuda):
    """K1 against its plain version on rays aimed at the triangles that
    define matbox's tile boxes (head-on, grazing a box face, within 1e-6 to
    1e-4 rad of a triangle's plane, and from random directions; every tile,
    the sliver runs among them) with the t-limit open and cut at the
    target, and on blinds' 28 triangles (one tile)."""
    scene = load_scene(str(SCENE), 64, 64, device=cuda)
    a, tiles = scene.arrays, scene.tiles
    view = tile_clusters(tiles)
    cands = np.arange(tiles.slots.shape[0])
    os_, ds_, cut = [], [], []
    for i, how in enumerate(("head_on", "grazing", "plane_grazing", "random")):
        o, d, dist = aimed_rays(view, cands, how, seed=20 + i)
        os_.append(o)
        ds_.append(d)
        cut.append(np.where(np.arange(len(o)) % 2 == 0, dist * np.float32(1.0 + 1e-5), RAY_TMAX))
    o = torch.as_tensor(np.concatenate(os_), device=cuda)
    d = torch.as_tensor(np.concatenate(ds_), device=cuda)
    tmax = torch.as_tensor(np.concatenate(cut), dtype=torch.float32, device=cuda)
    tmin = torch.zeros_like(tmax)
    _check_k1((o, d, tmin, tmax, a.v0, a.e1, a.e2), tiles, o.shape[0] // 2)
    blinds = load_scene(str(BLINDS), 64, 64, device=cuda)
    assert blinds.tiles.slots.tolist() == [32]
    b = blinds.arrays
    _check_k1((*_rays(blinds, 1 << 15, 4, cuda)[:4], b.v0, b.e1, b.e2), blinds.tiles, 1 << 12)


def test_slice_on_card_matches_cpu(cuda):
    """matbox 16x16, 4 spp on the card and on the CPU with the same GGX
    table: channel means within 1 %."""
    task = RenderTask.from_file(METHOD)
    task.method.spp = 4
    table = load_scene(str(SCENE), 16, 16, device=cuda).ggx_table_np
    imgs = [render_pt(load_scene(str(SCENE), 16, 16, device=dev, ggx_table=table), task.method, task)[0]
            for dev in ("cpu", cuda)]
    assert np.all(np.isfinite(imgs[1]))
    np.testing.assert_allclose(imgs[1].mean(axis=(0, 1)), imgs[0].mean(axis=(0, 1)), rtol=0.01)


def _soup_clusters(seed=7, T=3000, C=128):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-5, 5, (T, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.3, (T, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.3, (T, 3)).astype(np.float32)
    return build_clusters(v0, e1, e2, build_bvh_order(v0, e1, e2), cluster_size=C)


def _pair_rays(n, seed, device):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(rng.random(n) < 0.3, rng.uniform(0.5, 6.0, n), RAY_TMAX).astype(np.float32)
    tmax[rng.random(n) < 0.05] = -1.0
    o[3] = np.nan
    ex0 = np.where(rng.random(n) < 0.3, rng.integers(0, 3000, n), -1).astype(np.int32)
    mask = rng.random(n) < 0.3

    def t(a):
        return torch.as_tensor(a, device=device)

    return t(o), t(d), torch.full((n,), 1e-3, device=device), t(tmax), t(ex0), t(mask)


def test_pair_kernels_match_plain_on_card(cuda):
    """K2, K3 and K4 against their plain versions on the card, on the
    inputs intersect_pairs gives them, bit-equal."""
    cl = _soup_clusters().to(cuda)
    o, d, tmin, tmax, ex0, mask = _pair_rays(1 << 14, 5, cuda)
    before = dict(pairs.launches)
    s = pairs.sort_rays(cl, o, d, tmin, tmax, ex0, any_hit_mask=mask)
    cb6 = pairs.cluster_bounds(cl)
    boxes = pairs.candidate_test_boxes(cl, cb6)
    e_con = pairs.cull_einit(s.summ, cb6)
    assert torch.equal(e_con, pairs.cull_einit_torch(s.summ, cb6))
    e_init, *order = pairs.refine_walk(cb6, s.o_soa, s.inv_soa, s.lim, e_con)
    _check_refine_walk((e_init, *order), pairs.refine_walk_torch(cb6, s.o_soa, s.inv_soa, s.lim,
                                                                 e_con))
    assert torch.isfinite(e_init).any()
    for any_hit in (False, True):
        args = (*order, cl.tri_row, cl.tri, cl.xf, s.o_soa, s.d_soa, s.lim, s.ex, s.best0,
                any_hit)
        assert torch.equal(pairs.sweep_walk(*args, boxes=boxes),
                           pairs.sweep_walk_torch(*args)), any_hit
    assert {k: pairs.launches[k] - before[k] for k in before} == {"K2": 1, "K3": 1, "K4": 2,
                                                                  "K5": 0, "K6": 0}


@pytest.mark.parametrize("inputs", ["sorted rays", "warp summaries", "adversarial"])
def test_cull_kernel_cases_match_plain_on_card(cuda, inputs):
    """K2 (tiled; dead blocks and sign cases) against its plain chain on the
    card: equal (torch.equal), and every element whose bit pattern differs
    is a zero of the other sign (printed). The sorted rays' summaries take
    the sign cases, the warp summaries (K3's, with dead warps) also the dead
    rows, the adversarial inputs every branch and the per-element
    fallback; their boxes are the finite ones (from column 3): an infinite
    or NaN bound against an inverse direction of 0 makes a NaN product,
    which the chain's fminf drops and torch.minimum keeps, in the kernel
    before this design as in this one, and cluster boxes are finite."""
    if inputs == "adversarial":
        summ, cb6 = (x.to(cuda) for x in adversarial_summaries(3, B=333, K=1000))
        cb6 = cb6[:, 3:].contiguous()
    else:
        cl = _soup_clusters().to(cuda)
        o, d, tmin, tmax, ex0, _ = _pair_rays(1 << 14, 5, cuda)
        s = pairs.sort_rays(cl, o, d, tmin, tmax, ex0)
        cb6 = pairs.cluster_bounds(cl)
        summ = (s.summ if inputs == "sorted rays"
                else pairs._warp_lanes(s.o_soa, s.inv_soa, s.lim)[-1].reshape(-1, 16))
    before = pairs.launches["K2"]
    got = pairs.cull_einit(summ, cb6)
    want = pairs.cull_einit_torch(summ, cb6)
    assert pairs.launches["K2"] == before + 1
    tally = {}
    assert torch.equal(pairs.cull_einit_cased_torch(summ, cb6, tally).view(torch.int32),
                       want.view(torch.int32))
    differ = got.view(torch.int32) != want.view(torch.int32)
    print(f"K2 {inputs}: {tuple(got.shape)}, rows' elements {tally}, bit patterns that differ "
          f"{int(differ.sum())}")
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = torch.isnan(want)
    assert torch.equal(got[~ok], want[~ok])
    assert bool((got[differ & ~ok] == 0).all())
    assert tally["cased"] - tally["fallback"] > 0
    if inputs == "adversarial":
        assert tally["dead"] > 0 and tally["full"] > 0 and tally["fallback"] > 0


def _check_refine_walk(got, want):
    """K3 with the walk order against its plain version: e_init bit-equal,
    the walk (worder, went) equal up to each row's kcnt, kcnt equal."""
    (e_init, worder, went, kcnt), (e_p, worder_p, went_p, kcnt_p) = got, want
    assert torch.equal(e_init, e_p) and torch.equal(kcnt, kcnt_p)
    live = torch.arange(e_init.shape[1], device=e_init.device)[None, :] < kcnt[:, None].long()
    assert torch.equal(worder[live], worder_p[live]) and torch.equal(went[live], went_p[live])


def test_refine_walk_keys_in_device_memory_on_card(cuda):
    """K3 with more clusters than its shared-memory key list holds (the
    keys go to a scratch row in device memory) against its plain version."""
    cl = _soup_clusters(seed=9, T=12400 * 8, C=8).to(cuda)
    assert cl.num_clusters > pairs.build().akr_refine_walk_keys()
    o, d, tmin, tmax, ex0, _ = _pair_rays(2 * pairs.BLOCK, 3, cuda)
    s = pairs.sort_rays(cl, o * 0.6, d, tmin, tmax, ex0)
    cb6 = pairs.cluster_bounds(cl)
    e_con = pairs.cull_einit(s.summ, cb6)
    got = pairs.refine_walk(cb6, s.o_soa, s.inv_soa, s.lim, e_con)
    _check_refine_walk(got, pairs.refine_walk_torch(cb6, s.o_soa, s.inv_soa, s.lim, e_con))
    assert int(got[3].max()) > 100


def test_intersect_pairs_card_matches_cpu(cuda):
    """The whole pair sweep on the card (kernels) and on the CPU (plain
    versions) gives the same hits, any hits and per-lane any hits."""
    cl = _soup_clusters(seed=3)
    cpu, gpu = (_pair_rays(5000, 9, dev) for dev in ("cpu", cuda))
    for kw in ({}, {"any_hit": True}, {"any_hit_mask": True}):
        res = []
        for c, (o, d, tmin, tmax, ex0, mask) in ((cl, cpu), (cl.to(cuda), gpu)):
            extra = {"any_hit_mask": mask} if "any_hit_mask" in kw else dict(kw)
            res.append(pairs.intersect_pairs(c, o, d, tmin, tmax, ex0, **extra))
        if kw.get("any_hit"):
            assert torch.equal(res[0], res[1].cpu())
        else:
            for a, b in zip(res[0], res[1]):
                assert torch.equal(a, b.cpu())


def test_window_refine_kernel_matches_plain_on_card(cuda):
    """K5 against its plain version on the card, bit-equal: windows of 160
    member ids (not a multiple of the kernel's chunk) against the sorted
    blocks, with occluded lanes (limit -inf), every member set, then a
    third of them masked and a block with none; its counters against the
    twin's tally."""
    cl = _soup_clusters(C=16).to(cuda)
    o, d, tmin, tmax, ex0, _ = _pair_rays(1 << 13, 7, cuda)
    s = pairs.sort_rays(cl, o, d, tmin, tmax, ex0)
    B, W = s.summ.shape[0], 160
    rng = np.random.default_rng(3)
    cb6 = pairs.cluster_bounds(cl)
    win_i = torch.as_tensor(rng.integers(0, cl.num_clusters, (B, W)), dtype=torch.int32,
                            device=cuda)
    t1 = torch.where(torch.as_tensor(rng.random(s.lim.shape[1]) < 0.2, device=cuda),
                     -float("inf"), s.lim[1])
    lim = torch.stack([s.lim[0], t1])
    masked = torch.as_tensor(rng.random((B, W)) > 0.33, device=cuda)
    masked[1] = False
    for ok in (torch.ones((B, W), dtype=torch.bool, device=cuda), masked):
        args = (cb6, win_i, ok, s.o_soa, s.inv_soa, lim)
        before = pairs.launches["K5"]
        counts = torch.zeros((B, 3), dtype=torch.int32, device=cuda)
        got = pairs.refine_window(*args, counts=counts)
        assert pairs.launches["K5"] == before + 1
        want = pairs.refine_window_torch(*args)
        assert torch.equal(got, want) and torch.equal(pairs.refine_window(*args), want)
        assert 0.02 < float(want.float().mean()) < 0.98 and not bool(want[~ok].any())
        tally = {}
        assert torch.equal(pairs.refine_window_grouped_torch(*args, tally=tally), want)
        c = counts.sum(0).tolist()
        assert c[:2] == [tally["ok"], tally["tests"]]
        assert int(want.sum()) <= c[2] <= tally["units"]


def test_wide_walk_kernel_matches_plain_on_card(cuda):
    """K7 against its plain version on the card: with one leaf a round the
    plain version is the kernel step for step, so best and both counts
    (nodes expanded, leaves tested) are bit-equal, closest and any hit;
    against the default round size closest hit is bit-equal and any hit
    agrees on the occlusion."""
    cl = wide.attach_wide(_soup_clusters(C=16)).to(cuda)
    o, d, tmin, tmax, ex0, _ = _pair_rays(1 << 13, 5, cuda)
    s = pairs.sort_rays(cl, o, d, tmin, tmax, ex0, dead_last=False)
    B = s.summ.shape[0]
    boxes = pairs.candidate_test_boxes(cl, pairs.cluster_bounds(cl))
    before = wide.launches["K7"]
    for any_hit in (False, True):
        args = (cl.wide, cl.tri, cl.xf, s.o_soa, s.d_soa, s.lim, s.ex, s.best0, any_hit)
        ck = torch.zeros((B, 2), dtype=torch.int32, device=cuda)
        cp = torch.zeros((B, 2), dtype=torch.int32, device=cuda)
        got = wide.wide_walk(*args, counts=ck, boxes=boxes)
        assert torch.equal(got, wide.wide_walk_torch(*args, maxc=1, counts=cp)), any_hit
        assert torch.equal(ck, cp) and int(ck[:, 1].max()) > 8
        ref = wide.wide_walk_torch(*args)
        assert torch.equal(got[1] >= 0, ref[1] >= 0) and (any_hit or torch.equal(got, ref))
        assert int((got[1] >= 0).sum()) > 500
    assert wide.launches["K7"] == before + 2


def test_other_traversals_card_match_cpu(cuda, monkeypatch):
    """intersect_wide and the windowed intersect_pairs on the card
    (kernels) and on the CPU (plain versions) give the same hits and any
    hits, which are the static pair sweep's."""
    cl = wide.attach_wide(_soup_clusters(seed=3, C=32))
    cpu, gpu = (_pair_rays(5000, 9, dev) for dev in ("cpu", cuda))
    ref = pairs.intersect_pairs(cl, *cpu[:5])
    ref_any = pairs.intersect_pairs(cl, *cpu[:5], any_hit=True)
    before = {**pairs.launches, **wide.launches}
    for fn, switch in ((wide.intersect_wide, None), (pairs.intersect_pairs, "AKR_PAIRS_STATIC")):
        if switch:
            monkeypatch.setenv(switch, "0")
        for c, (o, d, tmin, tmax, ex0, _) in ((cl, cpu), (cl.to(cuda), gpu)):
            for a, b in zip(fn(c, o, d, tmin, tmax, ex0), ref):
                assert torch.equal(a.cpu(), b), fn.__name__
            assert torch.equal(fn(c, o, d, tmin, tmax, ex0, any_hit=True).cpu(), ref_any)
    after = {**pairs.launches, **wide.launches}
    assert after["K7"] == before["K7"] + 2 and after["K5"] > before["K5"]
    assert after["K3"] == before["K3"]  # the windowed walk runs no static refine


def _cull_case(device, seed=5):
    """An instanced candidate list (zero-area triangles in some of its rows)
    with its node table, and sorted blocks
    of rays that try the candidate test's skips: random rays with dead and
    NaN lanes, exclusion ids and the per-lane any-hit flag, and rays aimed
    head-on, grazing (a box face, and the triangle's own plane down to 1e-6
    rad) and at random at the triangles that define instance candidates'
    boxes. Returns (cl, {dead_last: SortedRays}, walk order)."""
    cl = wide.attach_wide(instanced_soup()).to(device)
    inst = torch.nonzero(cl.xf[:, 12] > 0).squeeze(1).cpu().numpy()
    o, d, tmin, tmax, ex0, mask = _pair_rays(3 * pairs.BLOCK, seed, device)
    aimed = [aimed_rays(cl.to("cpu"), inst[::5], how, seed=seed + i)
             for i, how in enumerate(("head_on", "grazing", "random", "plane_grazing"))]
    o_a = torch.as_tensor(np.concatenate([a[0] for a in aimed]), device=device)
    d_a = torch.as_tensor(np.concatenate([a[1] for a in aimed]), device=device)
    n_a = o_a.shape[0]
    cut = torch.as_tensor(np.concatenate([a[2] for a in aimed]), device=device) * (1.0 + 1e-5)
    o, d = torch.cat([o, o_a]), torch.cat([d, d_a])
    tmin = torch.cat([tmin, torch.zeros(n_a, device=device)])
    tmax = torch.cat([tmax, torch.where(torch.arange(n_a, device=device) % 2 == 0, cut, RAY_TMAX)])
    ex0 = torch.cat([ex0, torch.full((n_a,), -1, dtype=torch.int32, device=device)])
    mask = torch.cat([mask, torch.arange(n_a, device=device) % 3 == 0])
    s = {dl: pairs.sort_rays(cl, o, d, tmin, tmax, ex0, any_hit_mask=mask if dl else None,
                             dead_last=dl) for dl in (True, False)}
    cb6 = pairs.cluster_bounds(cl)
    e_init = pairs.refine_walk(cb6, s[True].o_soa, s[True].inv_soa, s[True].lim,
                               pairs.cull_einit(s[True].summ, cb6))[0]
    return cl, s, pairs.walk_order(e_init)  # whole rows: the plain walks read past kcnt


def test_redesigned_sweep_matches_plain_on_card(cuda):
    """K4 with its per-lane box test, the block's shared slot work and the
    two-buffer ring against its plain version, bit-equal: the whole walk (closest hit with
    the per-lane any-hit flag, and any hit), with and without its counters;
    one round of the windowed walk (the first 64 candidates of each block);
    and the counters, which must show that the skips skipped."""
    cl, s, order = _cull_case(cuda)
    s = s[True]
    boxes = pairs.candidate_test_boxes(cl, pairs.cluster_bounds(cl))
    B = s.summ.shape[0]
    worder, went, kcnt = order
    round_ = (worder[:, :64].contiguous(), went[:, :64].contiguous(), kcnt.clamp(max=64))
    before = pairs.launches["K4"]
    for any_hit in (False, True):
        tail = (cl.tri_row, cl.tri, cl.xf, s.o_soa, s.d_soa, s.lim, s.ex, s.best0, any_hit)
        want = pairs.sweep_walk_torch(*order, *tail)
        walked = torch.zeros(B, dtype=torch.int32, device=cuda)
        stats = torch.zeros((B, 4), dtype=torch.int32, device=cuda)
        assert torch.equal(pairs.sweep_walk(*order, *tail, boxes=boxes, walked=walked, stats=stats),
                           want), any_hit
        assert torch.equal(pairs.sweep_walk(*order, *tail, boxes=boxes), want), any_hit
        assert torch.equal(pairs.sweep_walk(*round_, *tail, boxes=boxes),
                           pairs.sweep_walk_torch(*round_, *tail)), any_hit
        assert int((want[1] >= 0).sum()) > 500
        st = stats.long()
        live = (s.lim[1] > s.lim[0]).reshape(B, pairs.BLOCK).sum(1)
        C = cl.tri.shape[1]
        assert bool((st[:, 1] <= walked.long() * live).all()) and int(st[:, 1].sum()) > 0
        assert int(st[:, 1].sum()) < 0.5 * int((walked.long() * live).sum())  # lanes skipped
        # a unit: a queued lane x 32 slots; the lanes outside a box are queued for slivers
        assert bool((st[:, 0] >= st[:, 1] * (C // 32)).all())
        assert int(st[:, 0].sum()) > int(st[:, 1].sum()) * (C // 32)
        assert bool((st[:, 3] <= st[:, 2]).all()) and bool((st[:, 2] <= st[:, 0] * 32).all())
        assert int(st[:, 3].sum()) >= int((want[1] >= 0).sum())  # every hit lane was hit once
    assert pairs.launches["K4"] == before + 6


def test_redesigned_k6_matches_plain_on_card(cuda):
    """K6 (the K4 kernel with the early-out off, on boxes its wrapper
    computes from the triangle rows) over instanced candidates, dummy rows
    among them, against its plain version, bit-equal, with counters that
    show lanes skipped."""
    cl, s, order = _cull_case(cuda, seed=6)
    s = s[True]
    R, C = cl.tri.shape[0], cl.tri.shape[1]
    cand = order[0][:, :24].long()
    valid = torch.arange(24, device=cuda)[None, :] < order[2][:, None]
    valid &= torch.as_tensor(np.random.default_rng(1).random(tuple(cand.shape)) < 0.8, device=cuda)
    tri = torch.cat([cl.tri, torch.zeros((1, C, 12), device=cuda)])
    tri_ix = torch.where(valid, cl.tri_row.long()[cand], R)
    for any_hit in (False, True):
        args = (tri_ix, cand, s.o_soa, s.d_soa, s.lim, s.ex, tri, cl.xf, s.best0, any_hit)
        stats = torch.zeros((tri_ix.shape[0], 4), dtype=torch.int32, device=cuda)
        got = pairs.sweep(*args, stats=stats)
        assert torch.equal(got, pairs.sweep_torch(*args)), any_hit
        assert torch.equal(pairs.sweep(*args), got)
        assert int((got[1] >= 0).sum()) > 200
        assert 0 < int(stats[:, 1].sum()) < 0.5 * int(valid.sum()) * pairs.BLOCK


def test_redesigned_wide_walk_matches_plain_on_card(cuda):
    """K7 with the candidate test's skips against its plain version at one
    leaf a round (the kernel step for step: best and both counts), closest
    and any hit; the probe form gives the same
    hits and counts with plausible counters and clock cycles, and with the
    leaf test off it changes no hit and pops at least as many leaves."""
    cl, s, _ = _cull_case(cuda)
    s = s[False]
    boxes = pairs.candidate_test_boxes(cl, pairs.cluster_bounds(cl))
    B = s.summ.shape[0]
    for any_hit in (False, True):
        args = (cl.wide, cl.tri, cl.xf, s.o_soa, s.d_soa, s.lim, s.ex, s.best0, any_hit)
        cp = torch.zeros((B, 2), dtype=torch.int32, device=cuda)
        want = wide.wide_walk_torch(*args, maxc=1, counts=cp)
        ck = torch.zeros((B, 2), dtype=torch.int32, device=cuda)
        assert torch.equal(wide.wide_walk(*args, counts=ck, boxes=boxes), want), any_hit
        assert torch.equal(ck, cp)
        probe = {"stats": torch.zeros((B, 4), dtype=torch.int32, device=cuda),
                 "cycles": torch.zeros((B, 2), dtype=torch.int64, device=cuda)}
        ck = torch.zeros((B, 2), dtype=torch.int32, device=cuda)
        assert torch.equal(wide.wide_walk(*args, counts=ck, boxes=boxes, probe=probe), want)
        assert torch.equal(ck, cp)
        st = probe["stats"].long()
        assert 0 < int(st[:, 1].sum()) < 0.5 * int(cp[:, 1].sum()) * pairs.BLOCK
        assert bool((st[:, 3] <= st[:, 2]).all()) and bool((probe["cycles"] > 0).all())
        off = {"stats": torch.zeros_like(probe["stats"]), "cycles": torch.zeros_like(probe["cycles"]),
               "leaf_test": False}
        c0 = torch.zeros((B, 2), dtype=torch.int32, device=cuda)
        assert torch.equal(wide.wide_walk(*args, counts=c0, boxes=boxes, probe=off), s.best0)
        assert bool((c0 >= cp).all()) and int(off["stats"].sum()) == 0
        assert int((want[1] >= 0).sum()) > 500


def test_kernel_info_reports_resources(cuda):
    """The compiler's registers and the resident blocks an SM of every
    kernel (K8 and K9 at blinds' tables): the walks (K1, K4, K7) keep two
    512-thread blocks resident; K4 and K7 spill nothing, K1 one word (8 B
    of stack, ptxas -v)."""
    scene = load_scene(str(BLINDS), 16, 16, device=cuda)
    tb = mk.pass_tables(scene, PTSettings(max_depth=12), GaussianFilter(1.5), 0)
    info = {**k1.kernel_info(), **pairs.kernel_info(), **wide.kernel_info(),
            **mk.kernel_info(tb), **fs.kernel_info(scene.shade_bake)}
    assert set(info) == {"K1", "K2", "K3", "K4", "K5", "K7", "K8", "K9"}
    for k, v in info.items():
        assert 0 < v["registers"] <= 255 and v["blocks_per_sm"] >= 1, (k, v)
    for k in ("K1", "K4", "K7"):
        assert info[k]["threads"] == pairs.BLOCK and info[k]["blocks_per_sm"] >= 2, info[k]
        assert info[k]["local_bytes"] <= (8 if k == "K1" else 0), info[k]


def test_failed_kernel_build_raises(cuda, tmp_path, monkeypatch):
    """A kernel source that does not compile raises at the first launch:
    no fallback to the plain version."""
    bad = tmp_path / "wide.cu"
    bad.write_text(wide.SOURCE.read_text() + "\nthis does not compile;\n")
    monkeypatch.setattr(wide, "SOURCE", bad)
    monkeypatch.setattr(wide, "_lib", None)
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "out")
    cl = wide.attach_wide(_soup_clusters(C=32)).to(cuda)
    o, d, tmin, tmax, ex0, _ = _pair_rays(1024, 2, cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        wide.intersect_wide(cl, o, d, tmin, tmax)


def test_cluster_tier_on_card_matches_cpu(cuda):
    """classroom 12x12, 2 spp, d12 (cluster tier, instancing, K2-K4) on the
    card and on the CPU with the same GGX table: the same samples, so the
    channel means agree to float rounding (within 1e-3)."""
    scene_path = ROOT / "scenes/classroom/scene.json"
    task = RenderTask.from_file(ROOT / "scenes/classroom/pt.json")
    task.method.spp = 2
    table = load_scene(str(scene_path), 12, 12, device=cuda).ggx_table_np
    before = dict(pairs.launches)
    imgs = [render_pt(load_scene(str(scene_path), 12, 12, device=dev, ggx_table=table),
                      task.method, task)[0] for dev in ("cpu", cuda)]
    assert all(pairs.launches[k] > before[k] for k in ("K2", "K3", "K4"))
    assert np.all(np.isfinite(imgs[1])) and imgs[0].mean() > 0.0
    np.testing.assert_allclose(imgs[1].mean(axis=(0, 1)), imgs[0].mean(axis=(0, 1)), rtol=1e-3)


def test_k6_sweep_matches_plain_on_card(cuda):
    """K6 (the K4 kernel with the early-out off) against its plain version
    on the card: every candidate of each block, dummies skipped, bit-equal."""
    cl = _soup_clusters(seed=4).to(cuda)
    o, d, tmin, tmax, ex0, _ = _pair_rays(4 * pairs.BLOCK, 6, cuda)
    s = pairs.sort_rays(cl, o, d, tmin, tmax, ex0)
    rng = np.random.default_rng(2)
    B, R = s.summ.shape[0], cl.tri.shape[0]
    tri = torch.cat([cl.tri, torch.zeros((1,) + tuple(cl.tri.shape[1:]), device=cuda)])
    tri_ix = torch.as_tensor(rng.integers(0, R + 1, (B, 12)), device=cuda)
    xf = torch.eye(4, device=cuda).reshape(1, 16).repeat(3, 1)
    xf[:, 12] = torch.tensor([0.0, 0.0, 5000.0], device=cuda)
    xf_ix = torch.as_tensor(rng.integers(0, 3, (B, 12)), device=cuda)
    before = pairs.launches["K6"]
    for any_hit in (False, True):
        args = (tri_ix, xf_ix, s.o_soa, s.d_soa, s.lim, s.ex, tri, xf, s.best0, any_hit)
        got = pairs.sweep(*args)
        assert torch.equal(got, pairs.sweep_torch(*args)), any_hit
        assert int((got[1] >= 0).sum()) > 50
    assert pairs.launches["K6"] == before + 2


def _blinds_shade_inputs(scene, n, seed, device):
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def unit():
        v = rng.normal(size=(n, 3))
        return t(v / np.linalg.norm(v, axis=-1, keepdims=True))

    si = scene.surface_interaction(t(rng.integers(0, scene.num_tris, n), torch.int64),
                                   t(rng.random((n, 2)) * 0.45))
    return (scene.shade_bake, *si["frame"], si["ng"], unit(), unit(), t(rng.random((n, 3)) * 3.0),
            t(rng.random(n) * 2.0 + 1e-3), t(rng.random((n, 3))), si["mat"])


@pytest.mark.parametrize("layout", ["masked", "masked, strided ng", "all dead",
                                    "unaligned rows, ragged edge"])
def test_fused_shade_kernel_masked_matches_plain_on_card(cuda, layout):
    """K9 with its live mask against the masked plain version on the card,
    every output bit-equal, NaN in the dead lanes' inputs; zeros on the
    dead lanes. The layouts: ng as a strided view (the flat tier's), a
    wavefront with no live lane, and [N, 3] rows whose base is 12 B past a
    16-byte boundary with N not a multiple of 32."""
    scene = load_scene(str(BLINDS), 16, 16, device=cuda)
    n = 3001 if layout.startswith("unaligned") else 1 << 14
    args = list(_blinds_shade_inputs(scene, n + 1, 9, cuda))
    frac = 0.0 if layout == "all dead" else 0.37
    live = torch.as_tensor(np.random.default_rng(4).random(n + 1) < frac, device=cuda)
    for j in range(1, 10):  # NaN in the dead lanes' inputs
        x = args[j]
        args[j] = torch.where(live.reshape((n + 1,) + (1,) * (x.ndim - 1)), x, float("nan"))
    if layout.startswith("unaligned"):  # skip the first row: bases 12 B (or 4 B) off
        args[1:11] = [x[1:] for x in args[1:11]]
        live = live[1:]
    else:
        args[1:11] = [x[:n] for x in args[1:11]]
        live = live[:n]
    if "strided" in layout:
        wide = torch.zeros((n, 41), device=cuda)
        wide[:, 9:12] = args[4]
        args[4] = wide[:, 9:12]
    before = fs.launches
    got = fs.fused_shade(*args, live=live)
    want = fs.fused_shade_torch(*args, live=live)
    assert fs.launches == before + 1
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert not bool(got[k][~live].any()), k
    if frac:
        assert float(want["valid"][live].float().mean()) > 0.3


def test_fused_shade_kernel_matches_plain_on_card(cuda):
    """K9 against its plain version on the card, every output bit-equal."""
    scene = load_scene(str(BLINDS), 16, 16, device=cuda)
    args = _blinds_shade_inputs(scene, 1 << 14, 8, cuda)
    before = fs.launches
    got = fs.fused_shade(*args)
    want = fs.fused_shade_torch(*args)
    assert fs.launches == before + 1
    assert float(want["valid"].float().mean()) > 0.3
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("scene", ["cbox", "blinds"])
@pytest.mark.parametrize("entry", ["roughness", "eval, 1 direction", "eval, 2 directions"])
def test_gpt_shade_entries_match_plain_on_card(cuda, scene, entry):
    """K9's roughness entry (fused_shade with roughness) and its evaluation
    entry (fused_eval, one and two directions), each one masked launch,
    against their masked plain versions on the card at 2^18 lanes of cbox
    (the benchmark's scene) and of blinds (a slat of roughness 0.5): every
    output bit-equal, NaN in the dead lanes' inputs, zeros on the dead
    lanes."""
    path = ROOT / "scenes/cbox/scene.json" if scene == "cbox" else BLINDS
    n = 1 << 18
    args = list(_blinds_shade_inputs(load_scene(str(path), 16, 16, device=cuda), n, 21, cuda))
    live = torch.as_tensor(np.random.default_rng(6).random(n) < 0.37, device=cuda)
    for j in range(1, 10):  # NaN in the dead lanes' inputs
        x = args[j]
        args[j] = torch.where(live.reshape((n,) + (1,) * (x.ndim - 1)), x, float("nan"))
    if entry == "roughness":
        before = fs.rough_launches
        got = fs.fused_shade(*args, live=live, roughness=True)
        want = fs.fused_shade_torch(*args, live=live, roughness=True)
        assert fs.rough_launches == before + 1 and "albedo" not in got
        assert float(want["valid"][live].float().mean()) > 0.3
        assert (scene == "blinds") == bool((want["roughness"][live] < 1.0).any())
        got, want = list(got.items()), list(want.items())
    else:
        bake, t, b, nn, ng, wo, ls_wi = args[:7]
        mirror = 2.0 * (wo * nn).sum(-1, keepdim=True) * nn - wo  # wo reflected about n
        wis = (ls_wi, mirror) if entry.startswith("eval, 2") else (ls_wi,)
        before = fs.eval_launches
        got = fs.fused_eval(bake, t, b, nn, ng, wo, wis, args[10], live=live)
        want = fs.fused_eval_torch(bake, t, b, nn, ng, wo, wis, args[10], live=live)
        assert fs.eval_launches == before + 1 and len(got) == len(wis)
        assert float((want[0][1][live] > 0).float().mean()) > 0.2
        got = [(f"{k}{d}", v) for d, pair in enumerate(got) for k, v in zip("fp", pair)]
        want = [(f"{k}{d}", v) for d, pair in enumerate(want) for k, v in zip("fp", pair)]
    for (k, g), (_, w) in zip(got, want):
        assert torch.equal(g, w), k
        assert not bool(g[~live].any()), k


def test_megakernel_matches_plain_on_card(cuda):
    """One K8 pass (path regeneration) against its plain version on the
    card at 30^2 (the last warp partial), 4 spp, d12: every pixel
    bit-equal, the same rays traced and the same SIMT counts, the
    regenerating loop's iterations below the lockstep loop's."""
    scene = load_scene(str(BLINDS), 30, 30, device=cuda)
    tb = mk.pass_tables(scene, PTSettings(max_depth=12), GaussianFilter(1.5), 0)
    rk, rp = (torch.zeros(2, dtype=torch.int64, device=cuda) for _ in range(2))
    sk, sp = (torch.zeros(5, dtype=torch.int64, device=cuda) for _ in range(2))
    before = mk.launches
    got = mk.megakernel_pass(tb, 0, 4, rk, sk)
    want = mk.megakernel_pass_torch(tb, 0, 4, rp, sp)
    assert mk.launches == before + 1
    assert torch.equal(rk, rp) and int(rk[0]) >= 4 * 30 * 30
    assert torch.equal(sk, sp) and int(sk[0]) < int(sk[2]) and int(sk[1]) == int(rk[0])
    assert torch.equal(got, want)
    assert torch.equal(mk.megakernel_pass(tb, 0, 4), got)


def test_fused_paths_on_card_match_cpu(cuda, monkeypatch):
    """blinds 16^2, 2 spp through the megakernel (AKR_MEGAKERNEL=1) and
    through the fused shade (AKR_PALLAS_SHADE=1) on the card and on the CPU
    with the same GGX table: channel means within 1e-3."""
    table = load_scene(str(BLINDS), 16, 16, device=cuda).ggx_table_np
    task = RenderTask.from_file(ROOT / "scenes/blinds/pt.json")
    task.method.spp = task.method.spp_per_pass = 2
    for switch, tier in (("AKR_MEGAKERNEL", "megakernel"), ("AKR_PALLAS_SHADE", "wavefront")):
        monkeypatch.setenv(switch, "1")
        imgs = []
        for dev in ("cpu", cuda):
            img, stats = render_pt(load_scene(str(BLINDS), 16, 16, device=dev, ggx_table=table),
                                   task.method, task)
            assert stats["tier"] == tier
            imgs.append(img)
        monkeypatch.delenv(switch)
        assert np.all(np.isfinite(imgs[1])) and imgs[0].mean() > 0.0
        np.testing.assert_allclose(imgs[1].mean(axis=(0, 1)), imgs[0].mean(axis=(0, 1)), rtol=1e-3)


def test_default_route_on_card_is_k9(cuda, monkeypatch):
    """cbox 64^2, 4 spp, pmj02bn, d12 (scenes/cbox/pt.json) with no switch
    set: on the card every bounce shades through K9 (fused_shades ==
    bounces, no dispatch group), and the image's channel means are within
    1e-3 of the CPU's render under AKR_PALLAS_SHADE=1 (K9's plain version;
    the CPU's default stays the dispatch)."""
    from akari_render_tpu_torch import stats as akr_stats

    cbox = ROOT / "scenes/cbox/scene.json"
    task = RenderTask.from_file(ROOT / "scenes/cbox/pt.json")
    task.method.spp = task.method.spp_per_pass = 4
    table = load_scene(str(cbox), 64, 64, device=cuda).ggx_table_np
    monkeypatch.delenv("AKR_PALLAS_SHADE", raising=False)
    akr_stats.reset()
    before = fs.launches
    card, stats = render_pt(load_scene(str(cbox), 64, 64, device=cuda, ggx_table=table),
                            task.method, task)
    c = akr_stats.snapshot()["counts"]
    assert stats["shade"] == "fused (K9)" and stats["tier"] == "wavefront"
    assert c["bounces"] > 0 and c["fused_shades"] == c["bounces"] and c["dispatch_groups"] == 0
    assert fs.launches - before == c["bounces"]
    monkeypatch.setenv("AKR_PALLAS_SHADE", "1")
    cpu, cstats = render_pt(load_scene(str(cbox), 64, 64, device="cpu", ggx_table=table),
                            task.method, task)
    assert cstats["shade"] == "fused (K9)"
    assert np.all(np.isfinite(card)) and cpu.mean() > 0.0
    np.testing.assert_allclose(card.mean(axis=(0, 1)), cpu.mean(axis=(0, 1)), rtol=1e-3)


@pytest.mark.parametrize("kind", ["pmj02bn", "sobol", "hash", "independent"])
def test_sampler_draws_on_card_match_cpu(cuda, kind, monkeypatch):
    """make_sampler on the card, 2^16 lanes x 12 dimensions at sample
    index 4,100 (pmj02's epoch 1) and at per-lane indices: bit-equal to the
    same call on the CPU."""
    from akari_render_tpu_torch.core.lds import make_sampler

    if kind == "hash":
        monkeypatch.setenv("AKR_RNG", "hash")
    cfg = {"type": "independent" if kind == "hash" else kind}
    pix = torch.arange(1 << 16)
    for index in (4100, (pix * 2654435761) % (3 * 4096)):
        draws = []
        for dev in ("cpu", cuda):
            s = make_sampler(cfg, pix.to(dev), index.to(dev) if torch.is_tensor(index) else index)
            us = []
            for _ in range(12):
                s, u = s.next_1d()
                us.append(u)
            draws.append(torch.stack(us).cpu().view(torch.int32))
        assert torch.equal(draws[0], draws[1])


@pytest.mark.parametrize("lanes,d", [(65_536, 61), (131_072, 61), (1_000, 1), (33, 7)])
def test_pcg32_draws_kernel_bit_equal(cuda, lanes, d):
    """The pcg32_draws kernel at the mutation step's and the bootstrap's
    shapes (and one draw, and a ragged block) against its plain version on
    the same streams, u and the new state bit-equal; the stream ids span
    all 64 bits (states with the high bit set, increments that wrap); one
    launch a call, and the old state left as it was."""
    from akari_render_tpu_torch import stats
    from akari_render_tpu_torch.core import pcg

    rng = np.random.default_rng(lanes * 1009 + d)
    ids = rng.integers(0, 1 << 64, lanes, dtype=np.uint64).view(np.int64)
    s = pcg.Pcg32.new_seq(torch.as_tensor(ids, device=cuda))
    assert bool((s.state < 0).any() and (s.inc < 0).any())
    before, state0 = pcg.launches, s.state.clone()
    kernel_draws = stats.counts["pcg_kernel_draws"]
    got_rng, got = pcg.pcg32_draws(s, d)
    torch.cuda.synchronize()
    assert pcg.launches == before + 1
    assert stats.counts["pcg_kernel_draws"] == kernel_draws + lanes * d
    assert torch.equal(s.state, state0)
    want_rng, want = pcg.pcg32_draws_torch(s, d)
    assert got.shape == (lanes, d) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(got_rng.state, want_rng.state) and got_rng.inc is s.inc
    info = pcg.kernel_info(d)["pcg32_draws"]
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, info


def test_render_aov_on_card_matches_cpu(cuda):
    """matbox 32x32, 2 spp of the AOVs on the card and on the CPU with the
    same GGX table: every image within 1e-4 on all but 0.1 % of the
    pixels, K1 launched once a sample."""
    from akari_render_tpu_torch.config import AOVConfig
    from akari_render_tpu_torch.integrators.aov import AOV_NAMES, render_aov

    table = load_scene(str(SCENE), 32, 32, device=cuda).ggx_table_np
    out = []
    for dev in ("cpu", cuda):
        before = k1.launches
        _, stats = render_aov(load_scene(str(SCENE), 32, 32, device=dev, ggx_table=table),
                              AOVConfig(spp=2))
        assert k1.launches == before + (2 if dev == cuda else 0)
        out.append(stats["images"])
    for name in AOV_NAMES:
        assert np.all(np.isfinite(out[1][name]))
        off = np.abs(out[1][name] - out[0][name]).max(axis=-1) > 1e-4
        assert off.mean() <= 1e-3, name


def test_fused_route_aux_albedo_on_card(cuda, monkeypatch):
    """The first-hit aux of one cbox 32x32 sample on the card: path B's
    albedo (K9's albedo output) against the dispatch route's closures
    within 1e-5, the normal and t equal."""
    from akari_render_tpu_torch.core.filters import filter_from_config
    from akari_render_tpu_torch.integrators.common import trace_paths
    from akari_render_tpu_torch.integrators.pt import camera_sample

    task = RenderTask.from_file(ROOT / "scenes/cbox/pt.json")
    scene = load_scene(str(ROOT / "scenes/cbox/scene.json"), 32, 32, device=cuda)
    filt = filter_from_config(task.filter_config)
    aux = {}
    for route in ("0", "1"):
        monkeypatch.setenv("AKR_PALLAS_SHADE", route)
        before = fs.launches
        o, d, _, sampler = camera_sample(scene, filt, 0, task.seed, task.sampler)
        _, aux[route], _ = trace_paths(scene, PTSettings(max_depth=2), o, d, sampler)
        assert (fs.launches > before) == (route == "1")
    assert float((aux["1"]["albedo"] - aux["0"]["albedo"]).abs().max()) <= 1e-5
    assert float(aux["1"]["albedo"].max()) > 0.5
    for k in ("normal", "first_t"):
        assert torch.equal(aux["0"][k], aux["1"][k])


def _gpt_on_card_and_cpu(cuda, res: int, modes):
    """render_gpt of cbox res x res, 2 spp, d7 on the CPU and on the card,
    in each shift mode, with the same samples and GGX table; for each mode
    the two sides' reconstruction, primal and gradients, held to each other:
    channel means within 1e-3 (of the image's mean magnitude for the
    gradients) and all but 1 % of the pixels within 1e-3 (a lane whose
    float decision flips moves its pixels). K1 launched on the card.
    Returns the stats of both sides, by mode."""
    from akari_render_tpu_torch.config import GPTConfig
    from akari_render_tpu_torch.integrators.gpt import render_gpt

    cbox = ROOT / "scenes/cbox/scene.json"
    table = load_scene(str(cbox), res, res, device=cuda).ggx_table_np
    seen = {}
    for mode in modes:
        out = []
        for dev in ("cpu", cuda):
            before = k1.launches, fs.launches, fs.rough_launches + fs.eval_launches
            img, stats = render_gpt(load_scene(str(cbox), res, res, device=dev, ggx_table=table),
                                    GPTConfig(spp=2), shift_mode=mode)
            assert (k1.launches > before[0]) == (dev == cuda)
            stats["k9_launches"] = fs.launches - before[1]
            stats["gpt_entry_launches"] = fs.rough_launches + fs.eval_launches - before[2]
            out.append(({"recon": img, **{k: stats[k] for k in ("primal", "gx", "gy")}}, stats))
        for name, want in out[0][0].items():
            got = out[1][0][name]
            assert np.all(np.isfinite(got)), (mode, name)
            scale = np.maximum(np.abs(want.mean((0, 1))), np.abs(want).mean((0, 1)))
            assert np.all(np.abs(got.mean((0, 1)) - want.mean((0, 1))) <= 1e-3 * scale), (mode,
                                                                                          name)
            off = np.abs(got - want).max(axis=-1) > 1e-3 * np.maximum(np.abs(want).max(-1), 1.0)
            assert off.mean() <= 0.01, (mode, name, off.mean())
        seen[mode] = (out[0][1], out[1][1])
    return seen


def test_render_gpt_on_card_matches_cpu(cuda, monkeypatch):
    """cbox 32x32 in each shift mode on the per-kind dispatch on both sides
    (AKR_PALLAS_SHADE=0), held by _gpt_on_card_and_cpu."""
    monkeypatch.setenv("AKR_PALLAS_SHADE", "0")
    for cpu, card in _gpt_on_card_and_cpu(cuda, 32, ("reconnect", "pss")).values():
        assert cpu["shade"] == card["shade"] == "dispatch"


def test_render_gpt_default_route_on_card_matches_cpu(cuda, monkeypatch):
    """cbox 64x64 on the card's default route, held by
    _gpt_on_card_and_cpu against the CPU on the same route (on the CPU the
    plain versions, which AKR_PALLAS_SHADE=1 opts in to there and leaves
    the card's default as it is): the reconnection shift on K9's roughness
    and evaluation entries, the pss shift on K9."""
    monkeypatch.setenv("AKR_PALLAS_SHADE", "1")
    seen = _gpt_on_card_and_cpu(cuda, 64, ("reconnect", "pss"))
    cpu, card = seen["reconnect"]
    assert cpu["shade"] == card["shade"] == "fused (K9)" and card["k9_launches"] == 0
    assert card["gpt_entry_launches"] > 0 and cpu["gpt_entry_launches"] == 0
    cpu, card = seen["pss"]
    assert cpu["shade"] == card["shade"] == "fused (K9)" and card["k9_launches"] > 0
    assert card["gpt_entry_launches"] == 0


def test_graphed_shift_shade_matches_eager_dispatch_on_card(cuda, monkeypatch):
    """cbox 64x64 (4,096 lanes: buckets of 1,024 to 4,096 rows), 2 spp,
    d7, the reconnection shift on the card's dispatch route
    (AKR_PALLAS_SHADE=0): the shift's per-kind shade
    replayed as CUDA graphs (shade_graphs.shade, the card's default)
    against the eager dispatch_shade in its place, the graphed render
    second, after its sites captured in a first: the gradient films
    bit-equal (each path's values are), the primal and the image within
    float32 sums in another order (the primal's filter splats add with
    atomics: two eager renders differ as much), the same dispatch groups
    and the host reads but the closures' constants (three copies a group
    on the eager dispatch, none in a replay), and a graph for every bucket
    of each of the three call sites."""
    from akari_render_tpu_torch import stats
    from akari_render_tpu_torch.config import GPTConfig
    from akari_render_tpu_torch.integrators import common, gpt, gpt_reconnect, shade_graphs

    monkeypatch.setenv("AKR_PALLAS_SHADE", "0")  # cbox bakes: the card's default is fused
    scene = load_scene(str(ROOT / "scenes/cbox/scene.json"), 64, 64, device=cuda)
    cfg = GPTConfig(spp=2, max_depth=7)
    gpt.render_gpt(scene, cfg, None, shift_mode="reconnect")  # the captures
    sites = [v for k, v in scene.shade_graphs.items() if k != "shared"]
    assert len(sites) == 3
    for site in sites:
        assert sorted(site.graphs) == shade_graphs.buckets(64 * 64) == [1024, 1536, 2048,
                                                                          3072, 4096]
    out = {}
    for name, fn in (("graphed", shade_graphs.shade), ("eager", common.dispatch_shade)):
        monkeypatch.setattr(gpt_reconnect, "shade", fn)
        stats.reset()
        img, st = gpt.render_gpt(scene, cfg, None, shift_mode="reconnect")
        torch.cuda.synchronize()
        out[name] = (img, st, dict(stats.counts))
    (gimg, gst, gc), (eimg, est, ec) = out["graphed"], out["eager"]
    for key in ("gx", "gy"):
        np.testing.assert_array_equal(gst[key], est[key], err_msg=key)
    np.testing.assert_allclose(gst["primal"], est["primal"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gimg, eimg, rtol=1e-5, atol=1e-6)
    assert np.abs(est["gx"]).mean() > 0
    for key in ("dispatch_groups", "gpt_shifts", "gpt_shift_lanes"):
        assert gc[key] == ec[key], key
    assert gc["host_reads"] == ec["host_reads"] - 3 * ec["dispatch_groups"]


def test_gpt_fused_route_matches_graphed_dispatch_on_card(cuda, monkeypatch):
    """cbox 64x64, 2 spp, d7, the reconnection shift on the card: the
    default route (K9's roughness and evaluation entries, every call of
    the three sites one launch: gpt_fused_shades, no dispatch group, no
    kind_rows read) against the per-kind dispatch replayed as CUDA graphs
    (AKR_PALLAS_SHADE=0), on the same scene and samples: the
    reconstruction, primal and gradients with channel means within 1e-3
    (of the image's mean magnitude for the gradients) and all but 1 % of
    the pixels within 1e-3, the tolerance of _gpt_on_card_and_cpu."""
    from akari_render_tpu_torch import stats
    from akari_render_tpu_torch.config import GPTConfig
    from akari_render_tpu_torch.integrators import gpt

    scene = load_scene(str(ROOT / "scenes/cbox/scene.json"), 64, 64, device=cuda)
    cfg = GPTConfig(spp=2, max_depth=7)
    out = {}
    for route in ("0", None):
        if route is None:
            monkeypatch.delenv("AKR_PALLAS_SHADE", raising=False)
        else:
            monkeypatch.setenv("AKR_PALLAS_SHADE", route)
        gpt.render_gpt(scene, cfg, None, shift_mode="reconnect")  # captures, builds
        stats.reset()
        before = fs.rough_launches, fs.eval_launches
        img, st = gpt.render_gpt(scene, cfg, None, shift_mode="reconnect")
        torch.cuda.synchronize()
        c = dict(stats.counts)
        c["rough"], c["eval"] = fs.rough_launches - before[0], fs.eval_launches - before[1]
        out[route] = ({"recon": img, **{k: st[k] for k in ("primal", "gx", "gy")}}, st, c)
    (want, wst, wc), (got, gst, gc) = out["0"], out[None]
    assert wst["shade"] == "dispatch" and wc["gpt_fused_shades"] == 0 and wc["dispatch_groups"] > 0
    assert gst["shade"] == "fused (K9)" and gc["dispatch_groups"] == 0
    assert gc["gpt_fused_shades"] == gc["rough"] + gc["eval"] and gc["rough"] > 0 < gc["eval"]
    assert gc["host_reads"] < wc["host_reads"]
    for name, w in want.items():
        g = got[name]
        assert np.all(np.isfinite(g)), name
        scale = np.maximum(np.abs(w.mean((0, 1))), np.abs(w).mean((0, 1)))
        assert np.all(np.abs(g.mean((0, 1)) - w.mean((0, 1))) <= 1e-3 * scale), name
        off = np.abs(g - w).max(axis=-1) > 1e-3 * np.maximum(np.abs(w).max(-1), 1.0)
        assert off.mean() <= 0.01, (name, off.mean())


def test_render_mcmc_on_card_matches_cpu(cuda, monkeypatch):
    """cbox 32x32 render_mcmc on the card and on the CPU (d7, 256 chains,
    4 spp-equivalents, 4,096 bootstrap samples, the direct pass at 2 spp;
    the per-kind dispatch on both: AKR_PALLAS_SHADE=0):
    the image's means and b within 2 % and the acceptance within 0.02 (the
    chains drift apart as the splats' float sums and accept decisions round
    differently); K1 launched on the card."""
    from akari_render_tpu_torch.config import MCMCConfig
    from akari_render_tpu_torch.integrators.mcmc import render_mcmc

    monkeypatch.setenv("AKR_PALLAS_SHADE", "0")
    cbox = ROOT / "scenes/cbox/scene.json"
    table = load_scene(str(cbox), 32, 32, device=cuda).ggx_table_np
    cfg = MCMCConfig(spp=4, n_chains=256, n_bootstrap=4096, direct_spp=2)
    out = []
    for dev in ("cpu", cuda):
        before = k1.launches
        img, stats = render_mcmc(load_scene(str(cbox), 32, 32, device=dev, ggx_table=table), cfg)
        assert (k1.launches > before) == (dev == cuda)
        assert np.all(np.isfinite(img)) and img.mean() > 0.0
        out.append((img, stats))
    (cimg, cst), (gimg, gst) = out
    assert gst["steps"] == cst["steps"] == 32 * 32 * 4 // 256
    np.testing.assert_allclose(gimg.mean(axis=(0, 1)), cimg.mean(axis=(0, 1)), rtol=0.02)
    assert abs(gst["acceptance"] - cst["acceptance"]) <= 0.02
    np.testing.assert_allclose(gst["b"], cst["b"], rtol=0.02)


def test_graphed_mutation_steps_match_eager_on_card(cuda, monkeypatch):
    """cbox 64x64, 4,096 chains, d7, 8 mutation steps on the card's default
    route (K9), from the same bootstrapped carry: GraphedSteps (step 1
    eager, step 2 captured and replayed once, steps 3-8 replayed, the
    traversal called eagerly between two segments) against the eager step.
    pss, cur_*, b, b_cnt, n_acc, n_mut and the chains' PCG32 state
    bit-equal; the splat film within 1e-6 relative (the card's index_add_
    sums in any order); the counters that the captured code adds to
    (bounces, fused_shades, pcg_kernel_draws) equal, 7 steps from graphs."""
    from akari_render_tpu_torch import stats
    from akari_render_tpu_torch.config import MCMCConfig
    from akari_render_tpu_torch.core.film import Film
    from akari_render_tpu_torch.core.samplers import IndependentSampler
    from akari_render_tpu_torch.integrators import mcmc

    monkeypatch.delenv("AKR_PALLAS_SHADE", raising=False)
    scene = load_scene(str(ROOT / "scenes/cbox/scene.json"), 64, 64, device=cuda)
    chains, steps, seed = 4096, 8, 5
    cfg = MCMCConfig(n_chains=chains, n_bootstrap=16384)
    settings, d = mcmc._mcmc_settings(cfg)
    filt = GaussianFilter(1.5)
    assert mcmc.graphs_apply(scene, settings)
    boot = mcmc.bootstrap_chains(scene, settings, filt, cfg, d, chains, seed)

    def run(step):
        zero = torch.zeros((), dtype=torch.int64, device=cuda)
        carry = mcmc.Chains(*(x.clone() for x in boot[:4]),
                            IndependentSampler.new(torch.arange(chains, device=cuda),
                                                   seed=seed ^ 0xC4A1).rng,
                            Film.new(64, 64, cuda), torch.zeros((), device=cuda), zero, zero,
                            zero)
        before = dict(stats.counts)
        for _ in range(steps):
            carry = step(carry)
        torch.cuda.synchronize()
        return carry, {k: v - before[k] for k, v in stats.counts.items()}

    want, want_counts = run(mcmc.make_mutate_step(scene, settings, filt, cfg, d))
    graphed = mcmc.GraphedSteps(mcmc.make_mutate_step(scene, settings, filt, cfg, d))
    got, got_counts = run(graphed)
    graphed.close()
    for name in ("pss", "cur_p", "cur_color", "cur_f", "b", "b_cnt", "n_acc", "n_mut"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(got.rng.state, want.rng.state)
    scale = float(want.film.splat.abs().max())
    assert scale > 0.0
    assert float((got.film.splat - want.film.splat).abs().max()) <= 1e-6 * scale
    for k in ("bounces", "fused_shades", "pcg_kernel_draws", "host_reads"):
        assert got_counts[k] == want_counts[k], k
    assert got_counts["pcg_plain_draws"] == 0
    assert got_counts["mcmc_graph_steps"] == steps - 1
    assert got_counts["mcmc_eager_steps"] == 1


def test_render_mcmc_graphed_on_card_matches_cpu(cuda, monkeypatch):
    """render_mcmc on the card's default route, K9 with the mutation steps
    from CUDA graphs, against the CPU on K9's plain version
    (AKR_PALLAS_SHADE=1; cbox 32x32, d7, 256 chains, 4 spp-equivalents,
    4,096 bootstrap samples, the direct pass at 2 spp): the image's means
    and b within 2 % and the acceptance within 0.02, as the dispatch's test
    holds them; every step but the first from graphs on the card."""
    from akari_render_tpu_torch import stats
    from akari_render_tpu_torch.config import MCMCConfig
    from akari_render_tpu_torch.integrators.mcmc import render_mcmc

    monkeypatch.setenv("AKR_PALLAS_SHADE", "1")
    cbox = ROOT / "scenes/cbox/scene.json"
    table = load_scene(str(cbox), 32, 32, device=cuda).ggx_table_np
    cfg = MCMCConfig(spp=4, n_chains=256, n_bootstrap=4096, direct_spp=2)
    out = []
    for dev in ("cpu", cuda):
        before = dict(stats.counts)
        img, st = render_mcmc(load_scene(str(cbox), 32, 32, device=dev, ggx_table=table), cfg)
        graph_steps = stats.counts["mcmc_graph_steps"] - before["mcmc_graph_steps"]
        assert st["shade"] == "fused (K9)"
        assert graph_steps == (st["steps"] - 1 if dev == cuda else 0)
        assert np.all(np.isfinite(img)) and img.mean() > 0.0
        out.append((img, st))
    (cimg, cst), (gimg, gst) = out
    assert gst["steps"] == cst["steps"] == 32 * 32 * 4 // 256
    np.testing.assert_allclose(gimg.mean(axis=(0, 1)), cimg.mean(axis=(0, 1)), rtol=0.02)
    assert abs(gst["acceptance"] - cst["acceptance"]) <= 0.02
    np.testing.assert_allclose(gst["b"], cst["b"], rtol=0.02)

@pytest.mark.parametrize("shade", ["default", "0"])
def test_split_pass_on_card_bit_exact(cuda, monkeypatch, shade):
    """cbox 64x64, 4 spp, pmj02bn, d12 (pt.json) on the card: the split
    pass at d = 6 equals the pass bit for bit (a row permutation of
    independent lanes), and reports its live counts; K1 launched. On the
    default shade (K9) and on the dispatch (AKR_PALLAS_SHADE=0)."""
    if shade == "default":
        monkeypatch.delenv("AKR_PALLAS_SHADE", raising=False)
    else:
        monkeypatch.setenv("AKR_PALLAS_SHADE", shade)
    task = RenderTask.from_file(ROOT / "scenes/cbox/pt.json")
    task.method.spp = task.method.spp_per_pass = 4
    scene = load_scene(str(ROOT / "scenes/cbox/scene.json"), 64, 64, device=cuda)
    monkeypatch.delenv("AKR_SPLIT_DEPTH", raising=False)
    whole, _ = render_pt(scene, task.method, task)
    monkeypatch.setenv("AKR_SPLIT_DEPTH", "6")
    before = k1.launches
    split, stats = render_pt(scene, task.method, task)
    assert k1.launches > before and stats["split_depth"] == 6
    assert len(stats["split_live"]) == 4
    assert np.isfinite(split).all() and np.array_equal(split, whole)


def test_alpha_traversal_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """The six-sheet alpha fixture (tests/torch_alpha_scene.py): the
    card's intersect_alpha and occlude_alpha equal the CPU's on 2^14
    rays, through K1 and through the pair sweep (AKR_FORCE_BVH)."""
    from torch_alpha_scene import alpha_rays, write_alpha_scene

    path = write_alpha_scene(tmp_path, 77, 6)
    rays = alpha_rays(1 << 14, 9, 1.9)
    for force in ("", "1"):
        if force:
            monkeypatch.setenv("AKR_FORCE_BVH", force)
        out = []
        for dev in ("cpu", cuda):
            scene = load_scene(path, device=dev)
            assert scene.has_alpha and (scene.arrays.bvh is not None) == bool(force)
            t = [torch.as_tensor(x, device=dev) for x in rays]
            hit = scene.intersect_alpha(*t)
            occ = scene.occlude_alpha(*t[:3], torch.full_like(t[3], 6.5))
            out.append((hit.tri_id.cpu(), hit.valid.cpu(), occ.cpu()))
        for a, b in zip(*out):
            assert torch.equal(a, b), force


def test_spectral_functions_on_card_match_cpu(cuda):
    """The uplift, eval_reflectance, the CIE sensor and D65 on the card
    against the CPU on 2^16 seeded inputs: the wavelengths and the uplift's
    scale equal, the rest within 1e-6 of the quantity's scale
    (tests/test_torch_spectral.py's tolerances) but the reflectance and D65
    within 1e-5: the card divides a tensor by a Python constant as a
    product with its rounded reciprocal, and the reflectance's polynomial
    slope amplifies that ulp of the wavelength's position (chip_smoke.py
    phase 28 measured 1.19e-6)."""
    from akari_render_tpu_torch.core import spectral as sp

    rng = np.random.default_rng(31)
    n = 1 << 16
    rgb = rng.uniform(0.0, 3.0, (n, 3)).astype(np.float32)
    rgb[:64] = 0.0
    u = rng.uniform(0.0, 1.0, n).astype(np.float32)
    spec = rng.uniform(0.0, 5.0, (n, 4)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        table = sp.device_table(dev)
        sw = sp.sample_wavelengths(torch.as_tensor(u, device=dev))
        c, s = sp.uplift_unbounded(table, torch.as_tensor(rgb, device=dev))
        out[str(dev)] = {k: v.cpu().numpy() for k, v in {
            "lam": sw.lambdas, "c": c, "s": s, "refl": sp.eval_reflectance(c, sw.lambdas),
            "cmf": sp.cie_xyz_bar(sw.lambdas), "d65": sp.illuminant_d65(sw.lambdas),
            "rgb": sp.spectral_to_rgb(torch.as_tensor(spec, device=dev), sw.lambdas, sw.pdf),
        }.items()}
    want, got = out["cpu"], out[str(cuda)]
    for k in ("lam", "s"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    c_scale = np.abs(want["c"]).max(-1, keepdims=True)
    for k, scale, tol in (("c", c_scale, 1e-6), ("refl", 1.0, 1e-5), ("cmf", 1.0, 1e-6),
                          ("d65", 1.0, 1e-5)):
        err = np.abs(got[k] - want[k])
        assert np.all(err <= tol * np.maximum(np.abs(want[k]), scale)), k
    xyz = np.abs(want["cmf"] * (spec / (1.0 / 470.0))[..., None]).mean(-2).max(-1, keepdims=True)
    assert np.all(np.abs(got["rgb"] - want["rgb"]) <= 1e-6 * np.maximum(np.abs(want["rgb"]), xyz))


@pytest.mark.parametrize("dim", [1, 2, 3, 4])
def test_perlin_hashes_on_card_match_cpu(cuda, dim):
    """Perlin noise's lattice hashes (wrapping uint32 in int64) bit-equal on
    the card and the CPU, and the noise within 1e-6."""
    from akari_render_tpu_torch.svm.texture import lattice_hashes, perlin_noise

    p = np.random.default_rng(dim).uniform(-60.0, 60.0, (1 << 16, dim)).astype(np.float32)
    pc, pg = torch.as_tensor(p), torch.as_tensor(p, device=cuda)
    for a, b in zip(lattice_hashes(pc, dim), lattice_hashes(pg, dim)):
        assert torch.equal(a, b.cpu())
    assert float((perlin_noise(pg, dim).cpu() - perlin_noise(pc, dim)).abs().max()) <= 1e-6


def test_spectral_render_on_card_matches_cpu(cuda, monkeypatch):
    """cbox 16x16, 4 spp, pmj02bn, d12, spectral, on the card and on the CPU
    (the same samples, the same GGX table): within fp-accumulation
    tolerance (channel means within 1e-3, all but 1 % of the pixels within
    1e-3 of max(1, its value): a lane whose float decision flips moves its
    pixel); K1 launched on the card, K8 and K9 never, even
    with AKR_PALLAS_SHADE=1 and AKR_MEGAKERNEL=1 set (spectral takes the
    pass and the per-kind dispatch)."""
    monkeypatch.setenv("AKR_PALLAS_SHADE", "1")
    monkeypatch.setenv("AKR_MEGAKERNEL", "1")
    task = RenderTask.from_file(ROOT / "scenes/cbox/pt.json")
    task.method.spp = task.method.spp_per_pass = 4
    task.method.color = "spectral"
    cbox = ROOT / "scenes/cbox/scene.json"
    table = load_scene(str(cbox), 16, 16, device=cuda).ggx_table_np
    out = []
    for dev in ("cpu", cuda):
        before = (k1.launches, mk.launches, fs.launches)
        img, stats = render_pt(load_scene(str(cbox), 16, 16, device=dev, ggx_table=table),
                               task.method, task)
        assert stats["color"] == "spectral" and stats["tier"] == "wavefront"
        assert stats["shade"] == "dispatch"
        assert (k1.launches > before[0]) == (dev == cuda)
        assert (mk.launches, fs.launches) == before[1:]
        out.append(img)
    _card_matches_cpu(*out)


def _card_matches_cpu(cpu, card, label=""):
    assert np.all(np.isfinite(card)) and card.mean() > 0.0, label
    np.testing.assert_allclose(card.mean(axis=(0, 1)), cpu.mean(axis=(0, 1)), rtol=1e-3,
                               err_msg=label)
    off = np.abs(card - cpu).max(-1) > 1e-3 * np.maximum(np.abs(cpu).max(-1), 1.0)
    assert off.mean() <= 0.01, (label, off.mean())


def test_shader_fixture_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """The noise/plastic/metal/principled fixture (tests/torch_shader_scene.py)
    at 16x16, 4 spp, d5 on the card and the CPU, with the fused and the
    combinator principled, to the spectral cbox test's tolerance."""
    from akari_render_tpu_torch.config import PTConfig
    from torch_shader_scene import write_shader_scene

    path = write_shader_scene(tmp_path, 16)
    table = load_scene(path, device=cuda).ggx_table_np
    for fused in ("1", "0"):
        monkeypatch.setenv("AKR_FUSED_PRINCIPLED", fused)
        out = [render_pt(load_scene(path, device=dev, ggx_table=table),
                         PTConfig(spp=4, spp_per_pass=4, max_depth=5))[0] for dev in ("cpu", cuda)]
        _card_matches_cpu(*out, label=f"AKR_FUSED_PRINCIPLED={fused}")


@pytest.mark.parametrize("shade", ["default", "0"])
def test_syncs_on_card_only_at_read_sites(cuda, monkeypatch, shade):
    """One cbox 1024^2 job of one sample (scenes/cbox/pt.json: pmj02bn, d12)
    under torch.cuda's sync debug mode, with the program's spans on (a host
    profiler collects), on the default shade (K9) and on the per-kind
    dispatch (AKR_PALLAS_SHADE=0): every sync it flags happens inside a
    read.* span, and host_reads counts each. K9 reads nothing, so the
    default route reads only the loop condition's any_live and the job's
    sync and copy (about 12 a sample, against about 60 on the dispatch)."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from akari_render_tpu_torch import stats

    if shade == "default":
        monkeypatch.delenv("AKR_PALLAS_SHADE", raising=False)
    else:
        monkeypatch.setenv("AKR_PALLAS_SHADE", shade)

    scene = load_scene(str(ROOT / "scenes/cbox/scene.json"), device=cuda)
    task = RenderTask.from_file(ROOT / "scenes/cbox/pt.json")
    task.method.spp = task.method.spp_per_pass = 1
    render_pt(scene, task.method, task)  # tables and kernels built
    torch.cuda.synchronize()
    flagged = []

    def note(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            flagged.append(stats._stack[-1].name if stats._stack else None)

    stats.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            torch.cuda.set_sync_debug_mode("warn")
            try:
                render_pt(scene, task.method, task)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    outside = [n for n in flagged if n is None or not n.startswith("read.")]
    assert flagged and not outside, outside
    c = stats.snapshot()["counts"]
    assert len(flagged) <= c["host_reads"]
    # the loop condition's reads and the job's two, as tests/test_torch_stats.py
    # counts them; the dispatch adds a nonzero a kind and the closures' three
    # copies a group
    b, g = c["bounces"], c["dispatch_groups"]
    job = b + (b < task.method.max_depth) + 2
    if shade == "default":
        assert c["fused_shades"] == b and g == 0 and c["host_reads"] == job
    else:
        assert c["fused_shades"] == 0 and g > 0
        assert c["host_reads"] == job + len(scene.kinds) * b + 3 * g
