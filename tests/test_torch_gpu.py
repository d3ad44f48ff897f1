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


def test_kernel_matches_plain_on_card(cuda):
    scene = load_scene(str(SCENE), 64, 64, device=cuda)
    a = scene.arrays
    o, d, tmin, tmax, ex0, ex1, ex2 = _rays(scene, 1 << 16, 3, cuda)
    args = (o, d, tmin, tmax, a.v0, a.e1, a.e2, ex0, ex1, ex2)
    before = k1.launches
    hk = k1.intersect_tris(*args)
    hp = k1.intersect_tris_torch(*args)
    assert k1.launches == before + 1
    assert int(hk.valid.sum()) > 1 << 14
    assert torch.equal(hk.tri_id, hp.tri_id)
    assert torch.equal(hk.t, hp.t) and torch.equal(hk.bary, hp.bary)
    assert torch.equal(k1.intersect_tris(*args, any_hit=True),
                       k1.intersect_tris_torch(*args, any_hit=True))


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
    e_con = pairs.cull_einit(s.summ, cb6)
    assert torch.equal(e_con, pairs.cull_einit_torch(s.summ, cb6))
    e_init = pairs.refine_all(cb6, s.o_soa, s.inv_soa, s.lim, e_con)
    assert torch.equal(e_init, pairs.refine_all_torch(cb6, s.o_soa, s.inv_soa, s.lim, e_con))
    assert torch.isfinite(e_init).any()
    order = pairs.walk_order(e_init)
    for any_hit in (False, True):
        args = (*order, cl.tri_row, cl.tri, cl.xf, s.o_soa, s.d_soa, s.lim, s.ex, s.best0,
                any_hit)
        assert torch.equal(pairs.sweep_walk(*args), pairs.sweep_walk_torch(*args)), any_hit
    assert {k: pairs.launches[k] - before[k] for k in before} == {"K2": 1, "K3": 1, "K4": 2,
                                                                  "K5": 0, "K6": 0}


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
    """K5 against its plain version on the card: windows of 160 gathered
    member boxes (not a multiple of the kernel's tile) against the sorted
    blocks, with occluded lanes (limit -inf), bit-equal."""
    cl = _soup_clusters(C=16).to(cuda)
    o, d, tmin, tmax, ex0, _ = _pair_rays(1 << 13, 7, cuda)
    s = pairs.sort_rays(cl, o, d, tmin, tmax, ex0)
    B, W = s.summ.shape[0], 160
    rng = np.random.default_rng(3)
    win = torch.as_tensor(rng.integers(0, cl.num_clusters, (B, W)), device=cuda)
    wb = pairs.cluster_bounds(cl)[:, win].permute(1, 0, 2).contiguous()
    t1 = torch.where(torch.as_tensor(rng.random(s.lim.shape[1]) < 0.2, device=cuda),
                     -float("inf"), s.lim[1])
    lim = torch.stack([s.lim[0], t1])
    before = pairs.launches["K5"]
    got = pairs.refine(wb, s.o_soa, s.inv_soa, lim)
    assert pairs.launches["K5"] == before + 1
    assert torch.equal(got, pairs.refine_torch(wb, s.o_soa, s.inv_soa, lim))
    assert 0.02 < float(got.float().mean()) < 0.98


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
    before = wide.launches["K7"]
    for any_hit in (False, True):
        args = (cl.wide, cl.tri, cl.xf, s.o_soa, s.d_soa, s.lim, s.ex, s.best0, any_hit)
        ck = torch.zeros((B, 2), dtype=torch.int32, device=cuda)
        cp = torch.zeros((B, 2), dtype=torch.int32, device=cuda)
        got = wide.wide_walk(*args, counts=ck)
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


def test_megakernel_matches_plain_on_card(cuda):
    """One K8 pass against its plain version on the card at 32^2, 4 spp,
    d12: the same rays traced, every pixel within rtol 1e-3, atol 2e-3."""
    scene = load_scene(str(BLINDS), 32, 32, device=cuda)
    tb = mk.pass_tables(scene, PTSettings(max_depth=12), GaussianFilter(1.5), 0)
    rk = torch.zeros(2, dtype=torch.int64, device=cuda)
    rp = torch.zeros(2, dtype=torch.int64, device=cuda)
    before = mk.launches
    got = mk.megakernel_pass(tb, 0, 4, rk)
    want = mk.megakernel_pass_torch(tb, 0, 4, rp)
    assert mk.launches == before + 1
    assert torch.equal(rk, rp) and int(rk[0]) >= 4 * 32 * 32
    torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-3)


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
