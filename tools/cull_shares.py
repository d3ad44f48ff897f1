"""Where the exact skips of K1 and K3 leave work, measured on the CPU
through the kernels' torch twins (no card needed): the numbers behind the
designs of csrc/intersect.cu and csrc/pairs.cu::refine_walk_kernel.

K1 (matbox, chip_smoke.py phase 3's kind of rays, cut to `--rays`):
- the share of live (lane, tile) pairs that pass the widened box test,
  for the tiles of consecutive ids (`intersect.flat_tiles`) against
  spatial clusters of 128 (BVH order), with the box test's limit at the
  lane's best t and widened by BOX_T_REL;
- the share of lanes queued with the sliver runs, and of (block, tile)
  pairs with a passing lane, in pixel order and after the pair sweep's
  Morton sort (`pairs.sort_keys`);
- on rays aimed within 1e-6 to 1e-4 rad of the tiles' box-defining
  triangles (tests/torch_cull_rays.py, four seeds, open and cut), how many
  the tile walk gets wrong against the brute force at each limit.

K3 (classroom at its 1920x1080 camera, `--rays` lanes of camera rays from
the middle rows and of bounce rays from their hits): the clusters per
block that K2 leaves, the (cluster, 32-lane warp) summary tests and those
that pass, against the lane x cluster work of the earlier kernel.

K2 (the same camera and bounce rays, and the shadow rays of NEE from the
camera rays' hits): the dead blocks, the share of live blocks' (block,
axis) summaries whose inverse-direction interval straddles zero, and the
elements K2's sign cases (`pairs.cull_einit_cased_torch`) take, with the
twin held bit for bit against `cull_einit_torch`.

K5 (the same rays through the windowed walk, every round's window through
`pairs.refine_window_grouped_torch`): the share of the members set that
some lane passes, of the (member, warp) pairs tested that pass the warp
summary, and of the blocks with a member set in each round, against the
earlier kernel's work (every member of every block, each member's lanes in
turn up to the first that passes).

    python tools/cull_shares.py [--rays 8192] [--only k1|k2|k3|k5]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def k1_walk(cands, o, d, tmin, tmax, t_rel):
    """The tile walk of intersect_tris_culled_torch over `cands` (tri
    [C, 12], box [7]) in order, with the box test's limit best t + t_rel
    |best t|: (best [4, n], {tallies})."""
    import torch

    from akari_render_tpu_torch.accel import pairs

    n = o.shape[0]
    best = torch.stack([tmax.clone(), torch.full((n,), -1.0), torch.zeros(n), torch.zeros(n)])
    lim = torch.stack([tmin, tmax])
    ex = torch.cat([torch.full((3, n), -1.0), torch.zeros((1, n))])
    ident = torch.tensor(pairs._IDENT)[None]
    B = -(-n // 512)
    tally = dict.fromkeys(("live", "in_box", "queued", "blocks", "blocks_passing"), 0)
    for tri, box in cands:
        live = best[0] > tmin
        t1 = best[0] + t_rel * torch.abs(best[0])
        in_box = live & pairs.box_pass_torch(box[None, :6], o, d, tmin, t1)
        queued = in_box | (live & bool(box[6] > 0))
        pad = torch.zeros(B * 512, dtype=torch.bool)
        pad[:n] = in_box
        tally["live"] += int(live.sum())
        tally["in_box"] += int(in_box.sum())
        tally["queued"] += int(queued.sum())
        tally["blocks"] += B
        tally["blocks_passing"] += int(pad.reshape(B, 512).any(1).sum())
        r = torch.nonzero(queued).squeeze(1)
        for s in range(0, r.numel(), 2048):
            rr = r[s:s + 2048]
            best[:, rr] = pairs.mt_update_culled(
                tri[None], ident, box[None], o[rr].T[None], d[rr].T[None], lim[:, rr][None],
                ex[:, rr][None], best[:, rr][None], False, box_t1=t1[rr][None])[0]
    return best, tally


def k1_shares(n_rays: int):
    import numpy as np
    import torch

    import chip_smoke
    from torch_cull_rays import aimed_rays, tile_clusters

    from akari_render_tpu_torch.accel import intersect as k1
    from akari_render_tpu_torch.accel import pairs
    from akari_render_tpu_torch.accel.cluster import build_clusters
    from akari_render_tpu_torch.core.math import RAY_TMAX
    from akari_render_tpu_torch.native import build_bvh_order
    from akari_render_tpu_torch.scene import load_scene

    sc = load_scene(str(chip_smoke.SCENE), device="cpu")
    a, tiles = sc.arrays, sc.tiles
    chip_smoke.N_RAYS = n_rays
    o, d, _ = chip_smoke.make_rays(sc, "cpu")
    n = o.shape[0]
    tmin, tmax = torch.zeros(n), torch.full((n,), RAY_TMAX)
    tile_cands = [(tiles.tri[k], tiles.boxes[:, k]) for k in range(tiles.slots.shape[0])]
    v0, e1, e2 = (x.numpy() for x in (a.v0, a.e1, a.e2))
    cl = build_clusters(v0, e1, e2, build_bvh_order(v0, e1, e2))
    bx = pairs.candidate_test_boxes(cl, pairs.cluster_bounds(cl))
    cluster_cands = [(cl.tri[k], bx[:, k]) for k in range(cl.num_clusters)]
    perm = torch.argsort(pairs.sort_keys(o, d, a.v0.amin(0)[None], a.v0.amax(0)[None]),
                         stable=True)
    for label, cands in (("tiles of consecutive ids", tile_cands),
                         ("spatial clusters of 128 (BVH order)", cluster_cands)):
        for order, p in (("pixel order", None), ("Morton order", perm)):
            oo, dd = (o, d) if p is None else (o[p], d[p])
            for t_rel in (0.0, k1.BOX_T_REL):
                _, t = k1_walk(cands, oo, dd, tmin, tmax, t_rel)
                print(f"K1, {label}, {order}, box-test limit best t + {t_rel} |best t|: "
                      f"{len(cands)} candidates; live (lane, candidate) pairs {t['live']}, pass "
                      f"the box test {t['in_box'] / t['live']:.4f}, queued with the sliver runs "
                      f"{t['queued'] / t['live']:.4f}; (block, candidate) pairs with a passing "
                      f"lane {t['blocks_passing'] / t['blocks']:.4f}", flush=True)
    view = tile_clusters(tiles)
    for t_rel in (0.0, k1.BOX_T_REL):
        wrong = total = 0
        for seed in range(4):
            oa, da, dist = aimed_rays(view, np.arange(tiles.slots.shape[0]), "plane_grazing", seed)
            oa, da = torch.as_tensor(oa), torch.as_tensor(da)
            m = oa.shape[0]
            for tm in (torch.full((m,), RAY_TMAX), torch.as_tensor(dist * np.float32(1 - 1e-5))):
                want = k1.intersect_tris_torch(oa, da, torch.zeros(m), tm, a.v0, a.e1, a.e2)
                best, _ = k1_walk(tile_cands, oa, da, torch.zeros(m), tm, t_rel)
                wrong += int(((best[1].int() != want.tri_id)
                              | (torch.where(want.valid, best[0], RAY_TMAX) != want.t)).sum())
                total += m
        print(f"K1, rays within 1e-6 to 1e-4 rad of the tiles' box-defining triangles, limit "
              f"best t + {t_rel} |best t|: {wrong} of {total} differ from the brute force",
              flush=True)


def classroom_rays(n_rays: int):
    """(classroom scene, its unified list, tmin, [(label, (o, d, tmax))]):
    `n_rays` camera rays from the middle rows of the 1920x1080 film, and as
    many bounce rays from their hits (directions on the camera's side)."""
    import numpy as np
    import torch

    import chip_smoke
    from akari_render_tpu_torch.accel import pairs
    from akari_render_tpu_torch.camera import generate_rays
    from akari_render_tpu_torch.core.math import RAY_TMAX
    from akari_render_tpu_torch.scene import load_scene

    sc = load_scene(str(chip_smoke.CLASSROOM), device="cpu")
    cl = sc.arrays.unified
    rng = np.random.default_rng(11)
    cam = sc.camera
    pix = np.arange(n_rays) + (cam.width * cam.height) // 2 - n_rays // 2
    p = np.stack([pix % cam.width, pix // cam.width], -1) + rng.random((n_rays, 2))
    o_c, d_c = generate_rays(cam, torch.as_tensor(p, dtype=torch.float32))
    tmin = torch.full((n_rays,), 1e-4)
    h = pairs.intersect_pairs(cl, o_c, d_c, tmin, torch.full((n_rays,), RAY_TMAX))
    hit_p = o_c + d_c * torch.where(h.valid, h.t, 0.0)[:, None]
    d_b = torch.as_tensor(rng.normal(size=(n_rays, 3)), dtype=torch.float32)
    d_b /= d_b.norm(dim=1, keepdim=True)
    d_b = torch.where(((d_b * d_c).sum(1) > 0)[:, None], -d_b, d_b)
    return sc, cl, tmin, [("camera rays", (o_c, d_c, torch.full((n_rays,), RAY_TMAX))),
                          ("bounce rays", (hit_p, d_b, torch.where(h.valid, RAY_TMAX, -1.0)))]


def k3_shares(n_rays: int):
    import torch

    from akari_render_tpu_torch.accel import pairs

    _, cl, tmin, rays = classroom_rays(n_rays)
    K = cl.num_clusters
    cb6 = pairs.cluster_bounds(cl)
    for label, (o, d, tmax) in rays:
        s = pairs.sort_rays(cl, o, d, tmin, tmax)
        B = s.summ.shape[0]
        e_con = pairs.cull_einit_torch(s.summ, cb6)
        tally = {}
        e_init = pairs.refine_walk_grouped_torch(cb6, s.o_soa, s.inv_soa, s.lim, e_con, tally)[0]
        nt = -(-K // pairs.RALL_TILE)
        con = torch.nn.functional.pad(e_con, (0, nt * pairs.RALL_TILE - K), value=float("inf"))
        full = float(torch.isfinite(con).reshape(B, nt, pairs.RALL_TILE).any(2).sum()) * (
            pairs.RALL_TILE * 512)
        print(f"K3, classroom 1080p {label}, {B} blocks x {K} clusters: K2 leaves "
              f"{float(torch.isfinite(e_con).sum(1).float().mean()):.1f} clusters a block "
              f"({float(torch.isfinite(e_con).float().mean()):.4f}), e_init finite "
              f"{float(torch.isfinite(e_init).sum(1).float().mean()):.1f}; (cluster, warp) summary "
              f"tests {tally['tests']}, passed {tally['units']} "
              f"({tally['units'] / max(tally['tests'], 1):.4f}); lane x cluster slab tests left "
              f"{tally['units'] * 32} of the earlier kernel's {full:.4g} "
              f"({tally['units'] * 32 / full:.4f})", flush=True)


def k2_shares(n_rays: int):
    import numpy as np
    import torch

    from akari_render_tpu_torch.accel import pairs
    from akari_render_tpu_torch.integrators.common import nee_light_sample

    sc, cl, tmin, rays = classroom_rays(n_rays)
    K = cl.num_clusters
    cb6 = pairs.cluster_bounds(cl)
    # shadow rays: NEE from the camera rays' hits, as the bounce loop makes them
    o_c, d_c, tmax_c = rays[0][1]
    h = pairs.intersect_pairs(cl, o_c, d_c, tmin, tmax_c)
    si = sc.surface_interaction(h.tri_id, h.bary)
    u = torch.as_tensor(np.random.default_rng(12).random((n_rays, 3)), dtype=torch.float32)
    ls = nee_light_sample(sc, si, u, h.valid)
    rays.insert(1, ("shadow rays", (ls.shadow_ro, ls.wi,
                                    torch.where(ls.valid & h.valid, ls.shadow_dist, -1.0))))
    for label, (o, d, tmax) in rays:
        s = pairs.sort_rays(cl, o, d, tmin, tmax)
        B = s.summ.shape[0]
        dead, cased = pairs.cull_row_cases(s.summ)
        il, ih = s.summ[:, 6:9], s.summ[:, 9:12]
        straddle = ~((il > 0) | (ih < 0))
        live = ~dead
        tally = {}
        got = pairs.cull_einit_cased_torch(s.summ, cb6, tally)
        want = pairs.cull_einit_torch(s.summ, cb6)
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        print(f"K2, classroom 1080p {label}, {B} blocks x {K} clusters: dead blocks "
              f"{int(dead.sum())} ({float(dead.float().mean()):.4f}); of the live blocks' "
              f"(block, axis) summaries, {int(straddle[live].sum())} of {3 * int(live.sum())} "
              f"straddle zero ({float(straddle[live].float().mean()):.4f}); live blocks with a "
              f"straddling axis {int(straddle[live].any(1).sum())}; cased blocks "
              f"{int(cased.sum())} ({float(cased.float().mean()):.4f}); elements: dead "
              f"{tally['dead']}, cased {tally['cased']} (of them the full chain "
              f"{tally['fallback']}), full chain {tally['full']}; twin bit-equal to "
              f"cull_einit_torch: {same}", flush=True)


def k5_shares(n_rays: int):
    import torch

    from akari_render_tpu_torch.accel import pairs

    _, cl, tmin, rays = classroom_rays(n_rays)
    cb6 = pairs.cluster_bounds(cl)
    real = pairs.refine_window
    for label, (o, d, tmax) in rays:
        s = pairs.sort_rays(cl, o, d, tmin, tmax)
        B = s.summ.shape[0]
        tally, live_blocks, earlier = {}, [], [0.0]

        def refine_window(cb6_, win_i, ok, o_soa, i_soa, lim):
            got = pairs.refine_window_grouped_torch(cb6_, win_i, ok, o_soa, i_soa, lim, tally)
            live = (lim[0] <= lim[1]).reshape(B, pairs.BLOCK).sum(1)
            every = torch.ones_like(ok)  # the earlier kernel: every member of every block
            passed = pairs.refine_window_torch(cb6_, win_i, every, o_soa, i_soa, lim)
            earlier[0] += float(passed.sum() + ((passed == 0).sum(1) * live).sum())
            live_blocks.append(int(ok.any(1).sum()))
            tally["passed"] = tally.get("passed", 0) + int(got.sum())
            return got

        pairs.refine_window = refine_window
        try:
            pairs.windowed_walk(cl, s, pairs.cull_einit_torch(s.summ, cb6), False)
        finally:
            pairs.refine_window = real
        shares = ", ".join(f"{x / B:.3f}" for x in live_blocks)
        print(f"K5, classroom 1080p {label}, {B} blocks, window {pairs.MAXC * pairs.WINDOW_MULT}: "
              f"{len(live_blocks)} rounds; members set {tally['ok']}, passed by a lane "
              f"{tally['passed']} ({tally['passed'] / max(tally['ok'], 1):.4f}); (member, warp) "
              f"summary tests {tally['tests']}, passed {tally['units']} "
              f"({tally['units'] / max(tally['tests'], 1):.4f}); lane x member slab tests left "
              f"{tally['units'] * 32} of the earlier kernel's {earlier[0]:.4g} "
              f"({tally['units'] * 32 / earlier[0]:.4f}); blocks with a member set, each round: "
              f"{shares}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=8192)
    ap.add_argument("--only", choices=("k1", "k2", "k3", "k5"))
    args = ap.parse_args()
    import torch

    torch.set_num_threads(8)
    for name, fn in (("k1", k1_shares), ("k2", k2_shares), ("k3", k3_shares),
                     ("k5", k5_shares)):
        if args.only in (None, name):
            fn(args.rays)


if __name__ == "__main__":
    main()
