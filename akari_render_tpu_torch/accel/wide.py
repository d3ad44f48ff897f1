"""Wide-BVH walk, the cluster tier's other traversal (port of
akari_render_tpu/accel/wide.py: build_wide, attach_wide, the walk kernel K7
and intersect_wide; opt-in with AKR_WIDE=1).

Where the pair sweep culls every (block, cluster) pair, sorts each block's
candidates and walks them in entry order, this traversal descends an 8-wide
BVH built over the candidate AABBs, once per sorted 512-ray block: a node's
8 child boxes are slab-tested against every lane's [tmin, t-limit], a
child's entry is the minimum over the lanes that pass, the passing children
go on a per-block stack far-to-near in the block's octant order (fixed at
build time; the block's octant is that of its first lane), and a popped
entry beyond the block horizon (the worst live lane's best t) is dropped
with its subtree: the entry lower-bounds every hit in it, for every lane.

On the TPU the walk emits its leaves (at most MAXC_WIDE a round) to a
second kernel, the pair sweep's candidate test, and the host repeats
rounds; the walk's stack is carried between rounds. That split worked
around a DMA fault there. The CUDA kernel (csrc/wide.cu, `wide_walk`) tests
a leaf where it pops it, with the candidate test it shares with K4, so a
traversal is one launch. The plain version keeps the TPU's rounds:
`walk_torch` is one walk round with the interface of the JAX `_walk`, and
`wide_walk_torch` loops it with `pairs.sweep_ent_torch`. Both compute the
same hits: the push order does not depend on the entries, a dropped or
unpushed child can change no lane, and the candidate test is the same
arithmetic. For closest hit every row of `best` is the same for any round
size; for any hit the occlusion (id >= 0) is, while the id a lane reports
follows the last tested leaf that hit it, which a fresher limit can skip;
with one leaf a round the plain version is step for step the kernel.

Not ported, on purpose: the node-table size limit `_VMEM_NODE_BUDGET` (a
TPU residency limit; on the card the table sits in global memory and L2),
`raw` and `interpret` of intersect_wide (no caller; a CPU tensor takes the
plain version), and MAXC_WIDE as a kernel parameter (the kernel has no
rounds).
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .cluster import ClusterArrays
from .nvcc import CSRC, compile_library, read_kernel_info
from .pairs import (BLOCK, CHUNK_ELEMS, INF, _check, _ptr, _route, _unsort_hits,
                    candidate_test_boxes, cluster_bounds, sort_rays,
                    sweep_ent_torch)

STACK_DEPTH = 192  # >= 7 * tree depth + 8; build_wide asserts
MAXC_WIDE = 128  # leaves emitted per round of the plain version
EMPTY = np.float32(1e38)  # bounds of an empty child slot: its slab entry overflows to +inf
NEG = -3e38  # entry of the root, and the slab test's starting near

SOURCE = CSRC / "wide.cu"
# launches of the K7 kernel since the last reset; only the kernel branch of
# wide_walk adds to it
launches = {"K7": 0}
# seconds the last build took (0.0 when the library came from the cache)
build_seconds = 0.0

_lib = None
_lib_lock = threading.Lock()


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the K7 library."""
    global _lib, build_seconds
    with _lib_lock:
        if _lib is not None:
            return _lib
        so, secs = compile_library(SOURCE, "wide")
        if secs:
            build_seconds = secs
        lib = ctypes.CDLL(str(so))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.akr_wide_walk.argtypes = [vp] * 9 + [ci] * 5 + [vp, vp]
        lib.akr_wide_walk_probe.argtypes = [vp] * 9 + [ci] * 6 + [vp, vp, vp, vp]
        lib.akr_wide_kernel_info.argtypes = [vp, ci, ci]
        for f in (lib.akr_wide_walk, lib.akr_wide_walk_probe, lib.akr_wide_kernel_info):
            f.restype = ci
        _lib = lib
        return lib


# ---------------------------------------------------------------- host build
def build_wide(cbmin: np.ndarray, cbmax: np.ndarray,
               tri_row: np.ndarray | None = None) -> np.ndarray:
    """8-wide BVH over candidate AABBs (host numpy, as the JAX package
    builds it). Returns [Nn, 128] int32, per node 8 child slots:
      cols 0:48   child AABBs as f32 bits (min x[8] | min y | min z | max x | max y | max z)
      cols 48:56  child words: >= 0 an internal node's id; -(cand + 2) a leaf; -1 empty
      cols 56:64  per octant, the slots near-first (8 nibbles a word)
      cols 64:72  a leaf's triangle-table row (tri_row[cand])
    An empty slot's bounds are EMPTY. Octant bit 2 = x < 0, bit 1 = y < 0,
    bit 0 = z < 0, as in the sort key."""
    K = len(cbmin)
    cbmin = np.asarray(cbmin, np.float32)
    cbmax = np.asarray(cbmax, np.float32)
    cent = 0.5 * (cbmin + cbmax)
    rows = (np.arange(K, dtype=np.int64) if tri_row is None
            else np.asarray(tri_row, np.int64))

    nb: list[np.ndarray] = []  # [8, 6] child bounds
    nc: list[np.ndarray] = []  # [8] child words
    nr: list[np.ndarray] = []  # [8] leaf tri rows
    no: list[np.ndarray] = []  # [8] octant order words

    def alloc() -> int:
        nb.append(np.full((8, 6), EMPTY, np.float32))
        nc.append(np.full(8, -1, np.int64))
        nr.append(np.zeros(8, np.int64))
        no.append(np.zeros(8, np.int64))
        return len(nc) - 1

    def split8(ids: np.ndarray) -> list[np.ndarray]:
        groups = [ids]
        while len(groups) < 8:
            gi = max(range(len(groups)), key=lambda i: len(groups[i]))
            g = groups[gi]
            if len(g) <= 1:
                break
            c = cent[g]
            axis = int(np.argmax(c.max(0) - c.min(0)))
            order = np.argsort(c[:, axis], kind="stable")
            h = len(g) // 2
            groups[gi: gi + 1] = [g[order[:h]], g[order[h:]]]
        return [g for g in groups if len(g)]

    root = alloc()
    work = [(np.arange(K, dtype=np.int64), root, 1)]
    max_depth = 1
    while work:
        ids, ni, depth = work.pop()
        max_depth = max(max_depth, depth)
        groups = split8(ids)
        cents = np.zeros((8, 3), np.float32)
        for j, g in enumerate(groups):
            bmin = cbmin[g].min(0)
            bmax = cbmax[g].max(0)
            nb[ni][j] = np.concatenate([bmin, bmax])
            cents[j] = 0.5 * (bmin + bmax)
            if len(g) == 1:
                cand = int(g[0])
                nc[ni][j] = -(cand + 2)
                nr[ni][j] = rows[cand]
            else:
                ci = alloc()
                nc[ni][j] = ci
                work.append((g, ci, depth + 1))
        ng = len(groups)
        for oc in range(8):
            s = np.array(
                [-1.0 if (oc >> 2) & 1 else 1.0,
                 -1.0 if (oc >> 1) & 1 else 1.0,
                 -1.0 if oc & 1 else 1.0], np.float32)
            keys = cents[:ng] @ s
            order = list(np.argsort(keys, kind="stable")) + list(range(ng, 8))
            word = 0
            for r, slot in enumerate(order):
                word |= int(slot) << (4 * r)
            no[ni][oc] = word

    assert 7 * max_depth + 8 <= STACK_DEPTH, (
        f"wide BVH depth {max_depth} exceeds stack budget")
    Nn = len(nc)
    out = np.zeros((Nn, 128), np.int32)
    b = np.stack(nb)  # [Nn, 8, 6]
    for c in range(6):
        out[:, 8 * c: 8 * (c + 1)] = b[:, :, c].view(np.int32)
    out[:, 48:56] = np.stack(nc).astype(np.int32)
    out[:, 56:64] = np.stack(no).astype(np.int32)
    out[:, 64:72] = np.stack(nr).astype(np.int32)
    return out


def kernel_info(C: int = 128) -> dict:
    """K7's resources on the current card (nvcc.read_kernel_info)."""
    return read_kernel_info(build().akr_wide_kernel_info, ("K7",), C, BLOCK)


def attach_wide(cl: ClusterArrays) -> ClusterArrays:
    """Build the node table over cl's candidates and attach it (on cl's
    device)."""
    tri_row = None if cl.tri_row is None else cl.tri_row.cpu().numpy()
    nodes = build_wide(cl.cbmin.cpu().numpy(), cl.cbmax.cpu().numpy(), tri_row)
    return cl._replace(wide=torch.as_tensor(nodes, device=cl.cbmin.device))


# ------------------------------------------------------------- plain versions
def walk_torch(nodes, o_soa, d_soa, lim, best_in, sid, se, srow, sp, any_hit: bool, maxc: int,
               expanded=None):
    """One walk round, the plain version of the JAX `_walk` (same
    interface), for all blocks at once: each block pops its stack (sid
    child words, se entries, srow leaf rows: [B, 1, STACK_DEPTH]; sp
    [B, 1, 1] the depth) until it is empty or maxc leaves are out. A pop
    beyond the block horizon is dropped; an internal node is expanded
    (chunked over blocks: [blocks, 8, BLOCK] slab tests); a leaf is emitted.
    The lanes' limits are fixed for the round: best_in's t, or for any hit
    NEG once occluded, else lim[1]. Returns (crow, cxf, cent [B, 1, maxc]:
    the leaves' triangle rows, candidate ids and entries, -1 / -1 / EMPTY
    beyond the count; sid, se, srow: the stacks; cnt [B, 1, 2]: the depth
    left and the leaves emitted). expanded (int64 [B], or None) is
    increased by the nodes each block expanded."""
    n = o_soa.shape[1]
    B = n // BLOCK
    dev = o_soa.device
    o = o_soa.reshape(3, B, BLOCK).permute(1, 0, 2)  # [B, 3, L]
    d = d_soa.reshape(3, B, BLOCK).permute(1, 0, 2)
    invd = 1.0 / torch.where(torch.abs(d) < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)
    octant = ((d[:, 0, 0] < 0).long() * 4 + (d[:, 1, 0] < 0).long() * 2
              + (d[:, 2, 0] < 0).long())  # the block's first lane
    if any_hit:
        t1 = torch.where(best_in[1] >= 0.0, NEG, lim[1]).reshape(B, BLOCK)
    else:
        t1 = best_in[0].reshape(B, BLOCK)
    horizon = t1.amax(dim=1)
    t0 = lim[0].reshape(B, BLOCK)

    sid, se, srow = sid[:, 0].clone(), se[:, 0].clone(), srow[:, 0].clone()
    spv = sp[:, 0, 0].long().clone()
    nv = torch.zeros((B,), dtype=torch.int64, device=dev)
    crow = torch.full((B, maxc), -1, dtype=torch.int32, device=dev)
    cxf = torch.full((B, maxc), -1, dtype=torch.int32, device=dev)
    cent = torch.full((B, maxc), float(EMPTY), dtype=torch.float32, device=dev)
    rows_max = max(1, CHUNK_ELEMS // (8 * BLOCK))
    while True:
        act = torch.nonzero((spv > 0) & (nv < maxc)).squeeze(1)
        if act.numel() == 0:
            break
        sp1 = spv[act] - 1
        val, ent, row = sid[act, sp1], se[act, sp1], srow[act, sp1]
        alive = ent <= horizon[act]
        spv[act] = sp1
        leaf = alive & (val < -1)
        lb, ln = act[leaf], nv[act[leaf]]
        crow[lb, ln] = row[leaf]
        cxf[lb, ln] = -val[leaf] - 2
        cent[lb, ln] = ent[leaf]
        nv[lb] = ln + 1
        node = alive & (val >= 0)
        nb_all, val_all = act[node], val[node].long()
        if expanded is not None:
            expanded[nb_all] += 1
        for s in range(0, nb_all.numel(), rows_max):
            nb = nb_all[s:s + rows_max]
            nrow = nodes[val_all[s:s + rows_max]]  # [m, 128] int32
            m = nb.numel()
            bounds = nrow[:, :48].contiguous().view(torch.float32).reshape(m, 6, 8)
            near = torch.full((m, 8, BLOCK), NEG, device=dev)
            far = torch.full((m, 8, BLOCK), -NEG, device=dev)
            for a in range(3):
                bmin, bmax = bounds[:, a, :, None], bounds[:, 3 + a, :, None]
                oa, ia = o[nb, a][:, None, :], invd[nb, a][:, None, :]
                ta = (bmin - oa) * ia
                tb = (bmax - oa) * ia
                near = torch.maximum(near, torch.minimum(ta, tb))
                far = torch.minimum(far, torch.maximum(ta, tb))
            near = torch.maximum(near, t0[nb][:, None, :])
            far = torch.minimum(far, t1[nb][:, None, :])
            entry8 = torch.where(near <= far, near, INF).amin(dim=2)  # [m, 8]
            cw, rw = nrow[:, 48:56], nrow[:, 64:72]
            ow = torch.gather(nrow[:, 56:64], 1, octant[nb][:, None])[:, 0]
            top = spv[nb]
            # push far-to-near: the order word's nibbles are near-first
            for k in range(7, -1, -1):
                slot = ((ow >> (4 * k)) & 7).long()[:, None]
                e_s = torch.gather(entry8, 1, slot)[:, 0]
                c_s = torch.gather(cw, 1, slot)[:, 0]
                r_s = torch.gather(rw, 1, slot)[:, 0]
                do = (e_s < 1e30) & (c_s != -1)
                bb, pos = nb[do], top[do]
                sid[bb, pos] = c_s[do]
                se[bb, pos] = e_s[do]
                srow[bb, pos] = r_s[do]
                top = top + do.long()
            spv[nb] = top
    cnt = torch.stack([spv, nv], dim=1).to(torch.int32)[:, None, :]
    return (crow[:, None, :], cxf[:, None, :], cent[:, None, :], sid[:, None, :], se[:, None, :],
            srow[:, None, :], cnt)


def wide_walk_torch(nodes, tri, xf, o_soa, d_soa, lim, ex, best0, any_hit: bool,
                    maxc: int = MAXC_WIDE, counts=None):
    """Plain version of K7: rounds of walk_torch (at most maxc leaves a
    block) and pairs.sweep_ent_torch on the leaves, with each block's stack
    carried between rounds, until every stack is empty. Arguments as
    wide_walk. counts (int32 [B, 2], or None) receives each block's nodes
    expanded and leaves emitted; with maxc 1 they are the kernel's."""
    n = o_soa.shape[1]
    B = n // BLOCK
    dev = o_soa.device
    R = tri.shape[0]
    sid = torch.zeros((B, 1, STACK_DEPTH), dtype=torch.int32, device=dev)
    se = torch.full((B, 1, STACK_DEPTH), NEG, dtype=torch.float32, device=dev)
    srow = torch.zeros((B, 1, STACK_DEPTH), dtype=torch.int32, device=dev)
    sp = torch.ones((B, 1, 1), dtype=torch.int32, device=dev)  # the root, entry NEG
    expanded = torch.zeros((B,), dtype=torch.int64, device=dev)
    emitted = torch.zeros((B,), dtype=torch.int64, device=dev)
    best = best0.clone()
    while bool((sp[:, 0, 0] > 0).any()):
        crow, cxf, cent, sid, se, srow, cnt = walk_torch(
            nodes, o_soa, d_soa, lim, best, sid, se, srow, sp, any_hit, maxc, expanded)
        crow, cxf = crow[:, 0], cxf[:, 0]
        ok = crow >= 0
        best = sweep_ent_torch(torch.where(ok, crow, R), torch.where(ok, cxf, 0), o_soa, d_soa,
                               lim, ex, cent, tri, xf, best, any_hit, dummy_row=R)
        emitted += cnt[:, 0, 1]
        sp = cnt[:, :, 0:1]
    if counts is not None:
        counts.copy_(torch.stack([expanded, emitted], dim=1))
    return best


# ----------------------------------------------------------------------- K7
def wide_walk(nodes, tri, xf, o_soa, d_soa, lim, ex, best0, any_hit: bool, *, boxes, counts=None,
              probe=None):
    """K7 (replaces akari_render_tpu/accel/wide.py::_walk_kernel, via _walk,
    together with the round loop of intersect_wide and the sweep it feeds):
    every block of BLOCK lanes walks the node table [Nn, 128] int32 from
    the root and tests each leaf it reaches. tri [R, C, 12] triangle rows
    (a leaf names its row); xf [K, 16] world->local rows by candidate id
    (or None: identity). Lanes: o/d [3, n], lim [2, n] (tmin, t-limit), ex
    [4, n] (three exclusion ids; row 3 unused here), best0 [4, n]
    (t, id, u, v) -> [4, n]. boxes [7, K] is what the kernel's per-lane box
    test takes (pairs.candidate_test_boxes), a skip that cannot change the
    result (the plain version does not read them). counts (int32 [B, 2], or
    None; the kernel fills it) receives each block's nodes expanded and
    leaves tested.
    probe (the kernel only, on no render's path) asks for the measuring
    form of the kernel: a dict with "stats" (int32 [B, 4], zeroed: the
    candidate test's counters, as pairs.sweep_walk's), "cycles" (int64
    [B, 2], zeroed: thread 0's clock cycles in node and in leaf steps) and
    optionally "leaf_test" (False: leaves are popped and counted, not
    tested)."""
    if _route("wide_walk", o_soa):
        return wide_walk_torch(nodes, tri, xf, o_soa, d_soa, lim, ex, best0, any_hit,
                               counts=counts)
    dev = o_soa.device
    n = o_soa.shape[1]
    if n % BLOCK:
        raise ValueError("wide_walk: lanes must be a multiple of BLOCK")
    B = n // BLOCK
    R, C = tri.shape[0], tri.shape[1]
    nodes = _check("wide_walk nodes", nodes, dev, torch.int32, (nodes.shape[0], 128))
    tri = _check("wide_walk tri", tri, dev, torch.float32, (R, C, 12))
    if xf is not None:
        xf = _check("wide_walk xf", xf, dev, torch.float32, (xf.shape[0], 16))
    o_soa = _check("wide_walk o", o_soa, dev, torch.float32, (3, n))
    d_soa = _check("wide_walk d", d_soa, dev, torch.float32, (3, n))
    lim = _check("wide_walk lim", lim, dev, torch.float32, (2, n))
    ex = _check("wide_walk ex", ex, dev, torch.float32, (4, n))
    best = _check("wide_walk best0", best0, dev, torch.float32, (4, n)).clone()
    if counts is not None:
        counts = _check("wide_walk counts", counts, dev, torch.int32, (B, 2))
    n_cand = boxes.shape[1]
    boxes = _check("wide_walk boxes", boxes, dev, torch.float32, (7, n_cand))
    if B:
        lib = build()
        lanes = (_ptr(nodes), _ptr(tri), _ptr(xf), _ptr(boxes), _ptr(o_soa), _ptr(d_soa), _ptr(lim),
                 _ptr(ex), _ptr(best), B, n_cand, C, BLOCK, int(bool(any_hit)))
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if probe is None:
            err = lib.akr_wide_walk(*lanes, _ptr(counts), stream)
        else:
            stats = _check("wide_walk stats", probe["stats"], dev, torch.int32, (B, 4))
            cycles = _check("wide_walk cycles", probe["cycles"], dev, torch.int64, (B, 2))
            err = lib.akr_wide_walk_probe(*lanes, int(bool(probe.get("leaf_test", True))),
                                          _ptr(counts), _ptr(stats), _ptr(cycles), stream)
        if err != 0:
            raise RuntimeError(f"akr_wide_walk kernel launch failed: CUDA error {err}")
        launches["K7"] += 1
    return best


# ------------------------------------------------------------ intersect_wide
def intersect_wide(cl: ClusterArrays, o, d, tmin, tmax, exclude0=None, exclude1=None,
                   exclude2=None, any_hit=False):
    """Exact closest hit (a Hit) or any hit (bool [n]) through the wide
    walk; drop-in for pairs.intersect_pairs without any_hit_mask. cl.wide
    must be attached (attach_wide, at scene build). The sort is the wide
    walk's own: dead lanes are not sent last."""
    if cl.wide is None:
        raise ValueError("intersect_wide: no node table; call attach_wide(cl) at build time")
    s = sort_rays(cl, o, d, tmin, tmax, exclude0, exclude1, exclude2, dead_last=False)
    best = wide_walk(cl.wide, cl.tri, cl.xf, s.o_soa, s.d_soa, s.lim, s.ex, s.best0, any_hit,
                     boxes=candidate_test_boxes(cl, cluster_bounds(cl)))
    return _unsort_hits(best, s.perm, o.shape[0], any_hit)
