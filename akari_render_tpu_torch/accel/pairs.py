"""Block-coherent pair-sweep intersection, the cluster tier's traversal
(port of akari_render_tpu/accel/pairs.py: intersect_pairs with its default
static-refine walk and its legacy windowed walk, and the kernels K2 to K6).

1. SORT: rays are keyed by direction octant and, by default, a 6-D
   interleave of origin and |direction| (the "i" layout; AKR_SORT_KEY picks
   the "o" or "dK" layout instead), dead lanes last, and cut into blocks of
   BLOCK consecutive rays.
2. K2, the conservative cull (`cull_einit`): each block's interval summary
   (origin box, inverse-direction interval, min tmin, max t-limit) against
   every cluster AABB, by interval arithmetic -> e_con [B, K], +inf where
   rejected. The kernel culls a dead block's row whole and, where a block's
   inverse-direction interval lies on one side of zero on every axis,
   takes each end of an axis's interval product from 4 products, not 8,
   with the same bits (`cull_row_cases`; `cull_einit_cased_torch` is the
   kernel step for step).
3. K3, the per-ray refine: every lane's own slab test against every
   cluster, skipping tiles that K2 rejected in full -> e_init [B, K], each
   cluster's minimum passing-lane entry (`refine_all_torch`).
4. Each block's walk order is the stable argsort of its e_init row
   (`walk_order`). On the card one kernel computes steps 3 and 4
   (`refine_walk`), with exact skips of its own
   (`refine_walk_grouped_torch` is that kernel step for step).
5. K4, the sweep (`sweep_walk`): each block walks its candidates in that
   order; a candidate's 128 triangles (in local space, with the
   candidate's world->local transform and global-id offset applied to the
   ray) are Möller-Trumbored against the block's lanes, and the walk stops
   once the next candidate's entry lies beyond the block horizon (the worst
   live lane's best t). The kernel first box-tests each lane against the
   candidate's world box over [tmin, the lane's best t now] and runs the
   triangles only for the lanes that pass (`box_pass_torch` is that test,
   `candidate_test_boxes` the boxes it takes,
   `sweep_walk_culled_torch` the kernel step for step); the plain version,
   the definition, tests every lane.

Each kernel wrapper takes its plain torch version for CPU tensors and
launches its CUDA kernel (csrc/pairs.cu) for CUDA tensors, or raises; no
fallback. The plain versions compute the same function as the kernels, op
for op, and chunk their [blocks x lanes x clusters] and [C x B] temporaries.

On the TPU the sweep's grid walks MAXC candidates per round and the host
repeats rounds in a while_loop; the plain version keeps that round
structure (`sweep_ent_torch` is one round, with the JAX `_sweep_ent`
interface), while the CUDA kernel walks each block's whole list in one
launch. The TPU's one-candidate `_sweep` (K6) has its counterpart in
`sweep`: the K4 kernel with the horizon early-out switched off, and as
plain version `sweep_ent_torch` with one candidate per round and no entry
cut. Nothing in the package calls it (as in the JAX package).

With AKR_PAIRS_STATIC=0 (read at every call) intersect_pairs takes the
legacy windowed walk instead of steps 3 to 5: each block's walk order is
the stable argsort of K2's conservative entries, and the host repeats
rounds: gather the next WINDOW_MULT * MAXC members of every live block's
order, K5 (`refine_window`, which reads the members by id: which of them
can any lane's current [tmin, best t] slab interval reach?), keep the
first MAXC that pass (members before the cut that fail are consumed without
a test), and sweep those through the K4 kernel. Every round ends in a host
read of "is any block still live". `refine_window_grouped_torch` is K5 step
for step.

Not ported, on purpose: AKR_WMULT (the window multiple stays WINDOW_MULT)
and AKR_PALLAS_CULL (the XLA form of K2), which tune or A/B the TPU code
and select no route.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import NamedTuple

import torch

from ..core.math import RAY_TMAX
from .cluster import ClusterArrays
from .nvcc import CSRC, compile_library, read_kernel_info
from .trace import Hit

BLOCK = 512  # rays per sorted block, one CUDA block of K3 and K4
MAXC = 64  # candidates per round of the plain walk and of the windowed walk
WINDOW_MULT = 16  # members of a block's order examined per candidate swept (windowed walk)
RALL_TILE = 256  # clusters per K3 tile: the unit of its predication
ANY_HIT_RETIRED = -3e38  # best t of a lane with the per-lane any-hit flag, once hit
# the candidate test's box test (csrc/candidate_test.cuh) widens a candidate's
# box by BOX_REL * (|origin| + |bound|) + BOX_ABS a side
BOX_REL, BOX_ABS = 2.0 ** -10, 1e-6
# a triangle whose edges e1, e2 meet at a sine of at most SLIVER_SIN (a
# zero-area triangle among them) has a determinant that is mostly rounding:
# the box test does not cull it (candidate_test_boxes)
SLIVER_SIN = 2.0 ** -10
INF = float("inf")
# plain-version chunk sizes (elements of one temporary)
CHUNK_ELEMS = 1 << 22

SOURCE = CSRC / "pairs.cu"
# kernel launches since the last reset, per kernel; only the kernel
# branches of the wrappers add to them
launches = {"K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0}
# seconds the last build took (0.0 when the library came from the cache)
build_seconds = 0.0

_lib = None
_lib_lock = threading.Lock()


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the K2 to K6 library."""
    global _lib, build_seconds
    with _lib_lock:
        if _lib is not None:
            return _lib
        so, secs = compile_library(SOURCE, "pairs")
        if secs:
            build_seconds = secs
        lib = ctypes.CDLL(str(so))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.akr_cull.argtypes = [vp, vp, vp, ci, ci, vp]
        lib.akr_refine_walk.argtypes = [vp] * 11 + [ci, ci, ci, vp]
        lib.akr_refine_walk_keys.argtypes = []
        lib.akr_refine_window.argtypes = [vp] * 8 + [ci] * 4 + [vp]
        lib.akr_sweep.argtypes = [vp] * 12 + [ci] * 7 + [vp, vp, vp]
        lib.akr_pairs_kernel_info.argtypes = [vp, ci, ci, ci]
        for f in (lib.akr_cull, lib.akr_refine_walk, lib.akr_refine_walk_keys,
                  lib.akr_refine_window, lib.akr_sweep, lib.akr_pairs_kernel_info):
            f.restype = ci
        _lib = lib
        return lib


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else ctypes.c_void_p(0)


def _check(name: str, x, dev, dtype, shape):
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {dev}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    return x.contiguous()


def _route(name: str, x) -> bool:
    """True for the plain version (CPU), False for the kernel (CUDA)."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return False


def _launch(fn, *args):
    lib = build()
    err = getattr(lib, fn)(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")


def kernel_info(C: int = 128, K: int = 4633) -> dict:
    """The resources of K2, K3 (at K clusters: its keys' shared memory),
    K5 and K4 (K6 is K4's kernel) on the current card."""
    return read_kernel_info(build().akr_pairs_kernel_info, ("K2", "K3", "K5", "K4"), C, BLOCK, K)


# ---------------------------------------------------------------- sort keys
def _spread3(x):  # 10 bits -> every 3rd bit of 30 (int64 holds the uint32 math)
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton3(v, bits: int):
    """v [N, 3] in [0, 1) -> interleaved morton, `bits` per axis (int64).
    The float -> int conversion truncates, as uint32 conversion does for
    the non-negative clipped values."""
    g = torch.clamp(v * float(1 << bits), 0.0, float((1 << bits) - 1)).to(torch.int64)
    return (_spread3(g[:, 0]) | (_spread3(g[:, 1]) << 1) | (_spread3(g[:, 2]) << 2)) & (
        (1 << (3 * bits)) - 1)


def _fma_norm(a):
    """sqrt(fma(a2, a2, fma(a1, a1, a0 * a0))) per row of a [N, 3]: what
    jnp.linalg.norm computes on the CPU (XLA contracts the sum of squares
    into FMAs). Each FMA is emulated in float64, where the float32 product
    is exact and the sum rounds once before the float32 rounding."""
    d = a.to(torch.float64)
    s = (d[:, 0] * d[:, 0]).to(torch.float32)
    s = (d[:, 1] * d[:, 1] + s.to(torch.float64)).to(torch.float32)
    s = (d[:, 2] * d[:, 2] + s.to(torch.float64)).to(torch.float32)
    return torch.sqrt(s)


def sort_keys(o, d, lo, hi, mode: str | None = None):
    """Ray sort key (int64 holding the JAX package's uint32 key), octant(3)
    in the top bits and below it, by `mode` (default: AKR_SORT_KEY, read at
    every call, else "i"):
    - "i": a per-level interleave of a 5-bit/axis origin morton and a
      4-bit/axis |direction| morton, origin triple first, the finest origin
      level trailing;
    - "dK", K in 1..9: a K-bit/axis |direction| morton above a
      (9 - K)-bit/axis origin morton, so blocks become narrow cones;
    - "o" (and "d0"): a 9-bit/axis origin morton."""
    mode = mode or os.environ.get("AKR_SORT_KEY", "i")
    on = (o - lo) / torch.clamp(hi - lo, min=1e-20)  # origin in [0,1)^3
    octant = ((d[:, 0] < 0).to(torch.int64) * 4 + (d[:, 1] < 0).to(torch.int64) * 2
              + (d[:, 2] < 0).to(torch.int64))
    ad = torch.abs(d)
    ad = ad / torch.clamp(_fma_norm(ad), min=1e-20)[:, None]
    if mode.startswith("d") and mode != "d0":
        k = max(1, min(9, int(mode[1:] or 3)))
        return (octant << 27) | (_morton3(ad, k) << (3 * (9 - k))) | _morton3(on, 9 - k)
    if mode != "i":
        return (octant << 27) | _morton3(on, 9)
    om = _morton3(on, 5)  # 15 bits
    dm = _morton3(ad, 4)  # 12 bits
    key = torch.zeros_like(om)
    for lvl in range(4):  # msb level first
        osh = (om >> (3 * (4 - lvl))) & 7
        dsh = (dm >> (3 * (3 - lvl))) & 7
        key = (key << 6) | (osh << 3) | dsh
    key = (key << 3) | (om & 7)
    return (octant << 27) | key


# ----------------------------------------------------------------------- K2
def cull_einit_torch(summ, cb6):
    """Plain version of K2: the conservative block-interval cull of
    _cull_kernel, the same 88-operation chain in the same order, chunked
    over blocks. summ [B, 16] (olo|ohi|ilo|ihi|bt0|bt1|pad), cb6 [6, K] ->
    [B, K] entry, +inf where rejected."""
    B, K = summ.shape[0], cb6.shape[1]
    out = torch.empty((B, K), dtype=torch.float32, device=summ.device)
    rows = max(1, CHUNK_ELEMS // max(K, 1))
    for s in range(0, B, rows):
        sm = summ[s:s + rows]
        entry = torch.full((sm.shape[0], K), -INF, device=summ.device)
        exit_ = torch.full((sm.shape[0], K), INF, device=summ.device)
        for a in range(3):
            bmin, bmax = cb6[a][None, :], cb6[3 + a][None, :]
            olo, ohi = sm[:, a:a + 1], sm[:, 3 + a:4 + a]
            il, ih = sm[:, 6 + a:7 + a], sm[:, 9 + a:10 + a]
            n0lo, n0hi = bmin - ohi, bmin - olo
            n1lo, n1hi = bmax - ohi, bmax - olo

            def iprod(nlo, nhi):
                p1, p2, p3, p4 = nlo * il, nlo * ih, nhi * il, nhi * ih
                return (torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
                        torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)))

            t0lo, t0hi = iprod(n0lo, n0hi)
            t1lo, t1hi = iprod(n1lo, n1hi)
            entry = torch.maximum(entry, torch.minimum(t0lo, t1lo))
            exit_ = torch.minimum(exit_, torch.maximum(t0hi, t1hi))
        entry = torch.maximum(entry, sm[:, 12:13])  # block min tmin
        exit_ = torch.minimum(exit_, sm[:, 13:14])  # block max t-limit (horizon)
        out[s:s + rows] = torch.where(entry <= exit_, entry, INF)
    return out


def cull_row_cases(summ):
    """K2's cases of each block summary (csrc/pairs.cu::cull_kernel): (dead
    [B], the block's min tmin above its max t-limit, so that every cluster
    is culled; cased [B], a live block whose inverse-direction interval
    is finite and lies strictly on one side of zero on every axis, and
    whose origin and inverse-direction intervals are ordered)."""
    olo, ohi, il, ih = summ[:, 0:3], summ[:, 3:6], summ[:, 6:9], summ[:, 9:12]
    dead = summ[:, 12] > summ[:, 13]
    cased = (~dead & ((il > 0.0) | (ih < 0.0)).all(1) & (il <= ih).all(1)
             & (torch.isfinite(il) & torch.isfinite(ih)).all(1) & (olo <= ohi).all(1))
    return dead, cased


def cull_einit_cased_torch(summ, cb6, tally=None):
    """The K2 kernel step for step in torch: cull_einit_torch with the
    kernel's exact short cuts, which must give the same bits.
    - A dead block (cull_row_cases) culls every cluster: entry >= min tmin
      > max t-limit >= exit.
    - On a cased block, against a cluster whose box has min <= max on each
      axis, an axis's entry (the least of the chain's 8 products) is the
      least of the 4 products of n0lo = bmin - ohi and n1hi = bmax - olo
      with the inverse direction's ends, and its exit the largest: with the
      inverse direction of one sign a product is monotone in n. Rounding is
      monotone too, so the values are the chain's; a nonzero value has one
      bit pattern, so the bits are the chain's wherever both are nonzero on
      every axis. Elsewhere, and on every other block or cluster, the full
      chain.
    tally (a dict, or None) gains "dead", "cased" and "full" (elements of
    each kind of row) and "fallback" (elements of cased rows that took the
    full chain)."""
    B, K = summ.shape[0], cb6.shape[1]
    dead, cased = cull_row_cases(summ)
    box_ok = (cb6[:3] <= cb6[3:]).all(0)  # [K]
    out = cull_einit_torch(summ, cb6)
    use = torch.zeros((B, K), dtype=torch.bool, device=summ.device)
    fast = torch.full((B, K), INF, device=summ.device)
    rows = max(1, CHUNK_ELEMS // max(K, 1))
    for s in range(0, B, rows):
        sm = summ[s:s + rows]
        entry = torch.full((sm.shape[0], K), -INF, device=summ.device)
        exit_ = torch.full((sm.shape[0], K), INF, device=summ.device)
        ok = torch.ones((sm.shape[0], K), dtype=torch.bool, device=summ.device)
        for a in range(3):
            n0lo = cb6[a][None, :] - sm[:, 3 + a:4 + a]
            n1hi = cb6[3 + a][None, :] - sm[:, a:a + 1]
            il, ih = sm[:, 6 + a:7 + a], sm[:, 9 + a:10 + a]
            p1, p2, p3, p4 = n0lo * il, n0lo * ih, n1hi * il, n1hi * ih
            lo = torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4))
            hi = torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4))
            ok &= (torch.abs(lo) > 0.0) & (torch.abs(hi) > 0.0)
            entry = torch.maximum(entry, lo)
            exit_ = torch.minimum(exit_, hi)
        entry = torch.maximum(entry, sm[:, 12:13])
        exit_ = torch.minimum(exit_, sm[:, 13:14])
        fast[s:s + rows] = torch.where(entry <= exit_, entry, INF)
        use[s:s + rows] = cased[s:s + rows, None] & box_ok[None, :] & ok
    out = torch.where(dead[:, None], INF, torch.where(use, fast, out))
    if tally is not None:
        n_cased = int(cased.sum()) * K
        for key, v in (("dead", int(dead.sum()) * K), ("cased", n_cased),
                       ("full", (B - int(dead.sum()) - int(cased.sum())) * K),
                       ("fallback", n_cased - int(use.sum()))):
            tally[key] = tally.get(key, 0) + v
    return out


def cull_einit(summ, cb6):
    """K2 (replaces akari_render_tpu/accel/pairs.py::_cull_kernel):
    summ [B, 16], cb6 [6, K] -> e_con [B, K]."""
    if _route("cull_einit", summ):
        return cull_einit_torch(summ, cb6)
    dev = summ.device
    B, K = summ.shape[0], cb6.shape[1]
    summ = _check("cull_einit summ", summ, dev, torch.float32, (B, 16))
    cb6 = _check("cull_einit cb6", cb6, dev, torch.float32, (6, K))
    out = torch.empty((B, K), dtype=torch.float32, device=dev)
    if B * K:
        _launch("akr_cull", _ptr(summ), _ptr(cb6), _ptr(out), B, K)
        launches["K2"] += 1
    return out


# ----------------------------------------------------------------------- K3
def refine_all_torch(cb6, o_soa, i_soa, lim, e_con):
    """Plain version of K3: each cluster's minimum passing-lane slab entry
    over the block's lanes (the op order of _refine_all_kernel), +inf where
    no lane passes. A tile of RALL_TILE clusters whose e_con is all +inf
    is +inf without slab math. Chunked over blocks."""
    K = cb6.shape[1]
    n = o_soa.shape[1]
    B = n // BLOCK
    dev = cb6.device
    out = torch.empty((B, K), dtype=torch.float32, device=dev)
    nt = (K + RALL_TILE - 1) // RALL_TILE
    pad = nt * RALL_TILE - K
    con = torch.nn.functional.pad(e_con, (0, pad), value=INF) if pad else e_con
    live_tile = torch.any(con.reshape(B, nt, RALL_TILE) < INF, dim=2)  # [B, nt]
    live = live_tile.repeat_interleave(RALL_TILE, dim=1)[:, :K]  # [B, K]
    bmin = [cb6[a][None, None, :] for a in range(3)]
    bmax = [cb6[3 + a][None, None, :] for a in range(3)]
    nb = max(1, CHUNK_ELEMS // max(BLOCK * K, 1))
    for s in range(0, B, nb):
        e = min(B, s + nb)
        lanes = slice(s * BLOCK, e * BLOCK)
        near = torch.full((e - s, BLOCK, K), -INF, device=dev)
        far = torch.full((e - s, BLOCK, K), INF, device=dev)
        for a in range(3):
            oa = o_soa[a, lanes].reshape(e - s, BLOCK, 1)
            ia = i_soa[a, lanes].reshape(e - s, BLOCK, 1)
            t0 = (bmin[a] - oa) * ia
            t1 = (bmax[a] - oa) * ia
            near = torch.maximum(near, torch.minimum(t0, t1))
            far = torch.minimum(far, torch.maximum(t0, t1))
        near = torch.maximum(near, lim[0, lanes].reshape(e - s, BLOCK, 1))
        far = torch.minimum(far, lim[1, lanes].reshape(e - s, BLOCK, 1))
        entry = torch.where(near <= far, near, INF).amin(dim=1)
        out[s:e] = torch.where(live[s:e], entry, INF)
    return out


def refine_walk_torch(cb6, o_soa, i_soa, lim, e_con):
    """Plain version of K3 with the walk order it feeds: refine_all_torch,
    then walk_order -> (e_init [B, K], worder [B, K] int32, went [B, K],
    kcnt [B] int32)."""
    e_init = refine_all_torch(cb6, o_soa, i_soa, lim, e_con)
    return (e_init, *walk_order(e_init))


def _ordered_bits(x):
    """float32 -> int64 holding the uint32 that orders as x does
    (csrc/candidate_test.cuh::ordered_bits)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)


def _warp_lanes(o_soa, i_soa, lim):
    """The lanes of each 32-lane warp of each block as K3's and K5's kernels
    hold them (csrc/pairs.cu::load_lane_summary): (live [B, G, 32],
    origins and inverse directions [B, G, 32, 3], tmin and t-limit
    [B, G, 32] with a dead lane's at +inf and -inf, the warps' interval
    summaries of their live lanes [B, G, 16] in K2's layout). A lane is
    live when its tmin is at or below its t-limit."""
    B, G = o_soa.shape[1] // BLOCK, BLOCK // 32
    live = lim[0] <= lim[1]
    lv = live.reshape(B, G, 32)
    o = o_soa.T.reshape(B, G, 32, 3)
    iv = i_soa.T.reshape(B, G, 32, 3)
    tmin = torch.where(live, lim[0], INF).reshape(B, G, 32)
    tlim = torch.where(live, lim[1], -INF).reshape(B, G, 32)
    m = lv[..., None]
    summ = torch.cat([torch.where(m, o, INF).amin(2), torch.where(m, o, -INF).amax(2),
                      torch.where(m, iv, INF).amin(2), torch.where(m, iv, -INF).amax(2),
                      tmin.amin(2)[..., None], tlim.amax(2)[..., None],
                      torch.zeros((B, G, 2), device=o_soa.device)], dim=2)
    return lv, o, iv, tmin, tlim, summ


def _unit_slabs(cb6, c, o, iv, tmin, tlim):
    """The slab tests of units: boxes cb6[:, c] against the 32 lanes of a
    warp each (o, iv [U, 32, 3], tmin, tlim [U, 32]) -> near, far [U, 32]."""
    near = torch.full(tmin.shape, -INF, device=cb6.device)
    far = torch.full(tmin.shape, INF, device=cb6.device)
    for a in range(3):
        oa, ia = o[..., a], iv[..., a]
        t0 = (cb6[a, c][:, None] - oa) * ia
        t1 = (cb6[3 + a, c][:, None] - oa) * ia
        near = torch.maximum(near, torch.minimum(t0, t1))
        far = torch.minimum(far, torch.maximum(t0, t1))
    return torch.maximum(near, tmin), torch.minimum(far, tlim)


def refine_walk_grouped_torch(cb6, o_soa, i_soa, lim, e_con, tally=None):
    """The K3 kernel step for step in torch, for tests at small sizes: a
    lane whose tmin is not below its t-limit never passes; of the clusters
    whose K2 entry is finite, each is slab-tested only against the warps of
    32 lanes whose live lanes' interval summary K2's chain passes
    (cull_einit_torch on the summaries); the walk is the ascending sort of
    the keys (entry as ordered bits, +0 for -0; cluster id). Returns what
    refine_walk_torch returns, up to the sign of a zero entry; it must equal
    it. tally (a dict, or None) gains the kernel's counters: "tests"
    ((cluster, warp) summary tests) and "units" (those that pass)."""
    B, K = e_con.shape
    dev = cb6.device
    G = BLOCK // 32
    lv, o, iv, tmin, tlim, summ = _warp_lanes(o_soa, i_soa, lim)
    tested = lv.any(2)[..., None] & torch.isfinite(e_con)[:, None, :]
    unit = tested & torch.isfinite(cull_einit_torch(summ.reshape(B * G, 16), cb6)).reshape(B, G, K)
    if tally is not None:
        tally["tests"] = tally.get("tests", 0) + int(tested.sum())
        tally["units"] = tally.get("units", 0) + int(unit.sum())
    e_init = torch.full((B, K), INF, device=dev)
    for b in range(B):
        g, c = torch.nonzero(unit[b], as_tuple=True)
        if g.numel() == 0:
            continue
        near, far = _unit_slabs(cb6, c, o[b, g], iv[b, g], tmin[b, g], tlim[b, g])
        e_init[b].scatter_reduce_(0, c, torch.where(near <= far, near, INF).amin(1), "amin")
    ids = torch.arange(K, device=dev)[None, :]
    finite = torch.isfinite(e_init)
    # (entry as ordered bits, id) in an int64: +inf entries sort last, by id
    keys = ((_ordered_bits(e_init + 0.0) - (1 << 31)) << 32) + ids
    worder = (torch.sort(keys, dim=1).values & 0xFFFFFFFF).to(torch.int32)
    went = torch.gather(e_init, 1, worder.long()) + 0.0
    return e_init, worder, went, finite.sum(dim=1).to(torch.int32)


def refine_walk(cb6, o_soa, i_soa, lim, e_con, counts=None):
    """K3 with the walk order it feeds (replaces
    akari_render_tpu/accel/pairs.py::_refine_all_kernel, via _refine_all,
    and the stable argsort of its rows): cb6 [6, K], o_soa/i_soa [3, n],
    lim [2, n], e_con [B, K] with n = B * BLOCK -> (e_init [B, K], worder
    [B, K] int32, went [B, K], kcnt [B] int32) as refine_walk_torch gives
    them; from the kernel, worder[b] and went[b] past kcnt[b] are left
    unwritten (nothing reads them). counts (int32 [B, 2], or None; the
    kernel only) receives each block's (cluster, warp) summary tests and
    units of 32 lanes' slab tests run."""
    if _route("refine_walk", cb6):
        return refine_walk_torch(cb6, o_soa, i_soa, lim, e_con)
    dev = cb6.device
    K, n = cb6.shape[1], o_soa.shape[1]
    if n % BLOCK:
        raise ValueError("refine_walk: lanes must be a multiple of BLOCK")
    B = n // BLOCK
    cb6 = _check("refine_walk cb6", cb6, dev, torch.float32, (6, K))
    o_soa = _check("refine_walk o", o_soa, dev, torch.float32, (3, n))
    i_soa = _check("refine_walk inv_d", i_soa, dev, torch.float32, (3, n))
    lim = _check("refine_walk lim", lim, dev, torch.float32, (2, n))
    e_con = _check("refine_walk e_con", e_con, dev, torch.float32, (B, K))
    e_init = torch.empty((B, K), dtype=torch.float32, device=dev)
    worder = torch.empty((B, K), dtype=torch.int32, device=dev)
    went = torch.empty((B, K), dtype=torch.float32, device=dev)
    kcnt = torch.empty((B,), dtype=torch.int32, device=dev)
    if counts is not None:
        counts = _check("refine_walk counts", counts, dev, torch.int32, (B, 2))
    if B:
        keys = (torch.empty((B, K), dtype=torch.int64, device=dev)
                if K > build().akr_refine_walk_keys() else None)
        _launch("akr_refine_walk", _ptr(cb6), _ptr(o_soa), _ptr(i_soa), _ptr(lim), _ptr(e_con),
                _ptr(e_init), _ptr(worder), _ptr(went), _ptr(kcnt), _ptr(keys), _ptr(counts),
                B, K, BLOCK)
        launches["K3"] += 1
    return e_init, worder, went, kcnt


# ----------------------------------------------------------------------- K5
def refine_torch(wb, o_soa, i_soa, lim):
    """The window refine of _refine_kernel with its interface (K5's plain
    version, refine_window_torch, gathers the window and calls it): wb
    [B, 6, W] gathered member boxes (min xyz | max xyz rows, W minor) ->
    [B, W] int32, 1 where any lane of the block has a [lim[0], lim[1]] slab
    interval that overlaps the member. Chunked over blocks."""
    B, _, W = wb.shape
    dev = wb.device
    out = torch.empty((B, W), dtype=torch.int32, device=dev)
    nb = max(1, CHUNK_ELEMS // max(BLOCK * W, 1))
    for s in range(0, B, nb):
        e = min(B, s + nb)
        lanes = slice(s * BLOCK, e * BLOCK)
        near = torch.full((e - s, BLOCK, W), -INF, device=dev)
        far = torch.full((e - s, BLOCK, W), INF, device=dev)
        for a in range(3):
            bmin, bmax = wb[s:e, a][:, None, :], wb[s:e, 3 + a][:, None, :]
            oa = o_soa[a, lanes].reshape(e - s, BLOCK, 1)
            ia = i_soa[a, lanes].reshape(e - s, BLOCK, 1)
            t0 = (bmin - oa) * ia
            t1 = (bmax - oa) * ia
            near = torch.maximum(near, torch.minimum(t0, t1))
            far = torch.minimum(far, torch.maximum(t0, t1))
        near = torch.maximum(near, lim[0, lanes].reshape(e - s, BLOCK, 1))
        far = torch.minimum(far, lim[1, lanes].reshape(e - s, BLOCK, 1))
        out[s:e] = torch.any(near <= far, dim=1).to(torch.int32)
    return out


def refine_window_torch(cb6, win_i, member_ok, o_soa, i_soa, lim):
    """Plain version of K5 with the interface of the kernel: cb6 [6, K],
    win_i [B, W] cluster ids, member_ok [B, W] bool, o_soa/i_soa [3, n],
    lim [2, n], n = B * BLOCK -> [B, W] int32: the members' boxes gathered
    as the JAX walk gathers its window ([B, 6, W]), refine_torch, and
    member_ok. A block with no member set is 0 without slab math."""
    B, W = win_i.shape
    dev = cb6.device
    out = torch.zeros((B, W), dtype=torch.int32, device=dev)
    rows = torch.nonzero(member_ok.any(dim=1)).squeeze(1)
    if rows.numel():
        lanes = (rows[:, None] * BLOCK + torch.arange(BLOCK, device=dev)[None, :]).reshape(-1)
        wb = cb6[:, win_i[rows].long()].permute(1, 0, 2)
        got = refine_torch(wb, o_soa[:, lanes], i_soa[:, lanes], lim[:, lanes])
        out[rows] = torch.where(member_ok[rows], got, 0)
    return out


def refine_window_grouped_torch(cb6, win_i, member_ok, o_soa, i_soa, lim, tally=None):
    """The K5 kernel step for step in torch, for tests at small sizes: of
    the members whose member_ok is set, each is slab-tested only against
    the warps of 32 lanes whose live lanes' interval summary K2's chain
    passes (cull_einit_torch on the summaries); a member passes when a lane
    of such a warp passes it. It must equal refine_window_torch. tally (a
    dict, or None) gains the kernel's counters: "ok" (members with
    member_ok), "tests" ((member, warp) summary tests) and "units" (those
    that pass: the most units the kernel runs; it skips a member another
    warp has passed already)."""
    B, W = win_i.shape
    G = BLOCK // 32
    lv, o, iv, tmin, tlim, summ = _warp_lanes(o_soa, i_soa, lim)
    tested = lv.any(2)[..., None] & member_ok[:, None, :]  # [B, G, W]
    e = cull_einit_torch(summ.reshape(B * G, 16), cb6).reshape(B, G, -1)
    unit = tested & torch.isfinite(torch.gather(e, 2, win_i.long()[:, None, :].expand(B, G, W)))
    if tally is not None:
        tally["ok"] = tally.get("ok", 0) + int(member_ok.sum())
        tally["tests"] = tally.get("tests", 0) + int(tested.sum())
        tally["units"] = tally.get("units", 0) + int(unit.sum())
    out = torch.zeros((B, W), dtype=torch.int32, device=cb6.device)
    for b in range(B):
        g, w = torch.nonzero(unit[b], as_tuple=True)
        if g.numel() == 0:
            continue
        near, far = _unit_slabs(cb6, win_i[b, w].long(), o[b, g], iv[b, g], tmin[b, g], tlim[b, g])
        out[b].index_fill_(0, w[(near <= far).any(1)], 1)
    return out


def refine_window(cb6, win_i, member_ok, o_soa, i_soa, lim, counts=None):
    """K5 (replaces akari_render_tpu/accel/pairs.py::_refine_kernel, via
    _refine, and the gather of the window's boxes in front of it): cb6
    [6, K], win_i [B, W] int32 cluster ids (in [0, K) where member_ok),
    member_ok [B, W] bool, o_soa/i_soa [3, n], lim [2, n] (tmin and the
    lane's current t-limit, -inf once occluded), n = B * BLOCK -> [B, W]
    int32: 1 where member_ok and any lane's slab interval overlaps the
    member's box, as refine_window_torch gives it. counts (int32 [B, 3], or
    None; the kernel only) receives each block's members with member_ok,
    (member, warp) summary tests and units of 32 lanes' slab tests run."""
    if _route("refine_window", cb6):
        return refine_window_torch(cb6, win_i, member_ok, o_soa, i_soa, lim)
    dev = cb6.device
    K, n = cb6.shape[1], o_soa.shape[1]
    B, W = win_i.shape
    if n != B * BLOCK:
        raise ValueError("refine_window: lanes must be B * BLOCK")
    cb6 = _check("refine_window cb6", cb6, dev, torch.float32, (6, K))
    win_i = _check("refine_window win_i", win_i, dev, torch.int32, (B, W))
    member_ok = _check("refine_window member_ok", member_ok, dev, torch.bool, (B, W))
    o_soa = _check("refine_window o", o_soa, dev, torch.float32, (3, n))
    i_soa = _check("refine_window inv_d", i_soa, dev, torch.float32, (3, n))
    lim = _check("refine_window lim", lim, dev, torch.float32, (2, n))
    if counts is not None:
        counts = _check("refine_window counts", counts, dev, torch.int32, (B, 3))
    out = torch.empty((B, W), dtype=torch.int32, device=dev)
    if B * W:
        _launch("akr_refine_window", _ptr(cb6), _ptr(win_i), _ptr(member_ok), _ptr(o_soa),
                _ptr(i_soa), _ptr(lim), _ptr(out), _ptr(counts), B, K, W, BLOCK)
        launches["K5"] += 1
    return out


# ----------------------------------------------------------------------- K4
_IDENT = (1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0)


def _mt_update(tri, x, o, d, lim, ex, best, any_hit: bool):
    """mt_block_update for nb blocks at once: tri [nb, C, 12] candidate
    triangles, x [nb, 16] transform rows, o/d [nb, 3, L], lim [nb, 2, L],
    ex [nb, 4, L], best [nb, 4, L] -> the updated best (a new tensor)."""
    gid = tri[:, :, 9:10]  # [nb, C, 1]
    a_x, a_y, a_z = tri[:, :, 0:1], tri[:, :, 1:2], tri[:, :, 2:3]
    e1x, e1y, e1z = tri[:, :, 3:4], tri[:, :, 4:5], tri[:, :, 5:6]
    e2x, e2y, e2z = tri[:, :, 6:7], tri[:, :, 7:8], tri[:, :, 8:9]
    xs = [x[:, i:i + 1, None] for i in range(13)]  # [nb, 1, 1]
    wo_x, wo_y, wo_z = o[:, 0:1], o[:, 1:2], o[:, 2:3]  # [nb, 1, L]
    wd_x, wd_y, wd_z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    o_x = xs[0] * wo_x + xs[1] * wo_y + xs[2] * wo_z + xs[3]
    o_y = xs[4] * wo_x + xs[5] * wo_y + xs[6] * wo_z + xs[7]
    o_z = xs[8] * wo_x + xs[9] * wo_y + xs[10] * wo_z + xs[11]
    d_x = xs[0] * wd_x + xs[1] * wd_y + xs[2] * wd_z
    d_y = xs[4] * wd_x + xs[5] * wd_y + xs[6] * wd_z
    d_z = xs[8] * wd_x + xs[9] * wd_y + xs[10] * wd_z
    tmin = lim[:, 0:1]
    ex0, ex1, ex2 = ex[:, 0:1], ex[:, 1:2], ex[:, 2:3]
    sh = ex[:, 3] > 0.5  # [nb, L] per-lane any-hit flag
    best_t, best_id, best_u, best_v = best[:, 0], best[:, 1], best[:, 2], best[:, 3]

    px = d_y * e2z - d_z * e2y  # [nb, C, L]
    py = d_z * e2x - d_x * e2z
    pz = d_x * e2y - d_y * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok_det = torch.abs(det) > 1e-12
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    tx = o_x - a_x
    ty = o_y - a_y
    tz = o_z - a_z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (qx * d_x + qy * d_y + qz * d_z) * inv_det
    t = (qx * e2x + qy * e2y + qz * e2z) * inv_det
    gidw = gid + xs[12]  # global virtual id
    hit = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin)
           & (t < best_t[:, None, :]) & (gid >= 0.0)
           & (gidw != ex0) & (gidw != ex1) & (gidw != ex2))
    out = best.clone()
    if any_hit:
        got = torch.any(hit, dim=1)
        gsel = torch.amin(torch.where(hit, gidw, INF), dim=1)
        out[:, 1] = torch.where(got, gsel, best_id)
        return out
    t_m = torch.where(hit, t, INF)
    t_min = torch.amin(t_m, dim=1)  # [nb, L]
    slot = torch.arange(t_m.shape[1], device=t.device)[None, :, None]
    is_min = t_m == t_min[:, None, :]
    s_min = torch.amin(torch.where(is_min, slot, 1 << 30), dim=1, keepdim=True)  # first slot
    better = t_min < best_t
    u_sel = torch.gather(u, 1, s_min.clamp(max=t_m.shape[1] - 1))[:, 0]
    v_sel = torch.gather(v, 1, s_min.clamp(max=t_m.shape[1] - 1))[:, 0]
    g_sel = torch.gather(gidw.expand_as(t_m), 1, s_min.clamp(max=t_m.shape[1] - 1))[:, 0]
    out[:, 0] = torch.where(better, torch.where(sh, ANY_HIT_RETIRED, t_min), best_t)
    out[:, 1] = torch.where(better, g_sel, best_id)
    out[:, 2] = torch.where(better, u_sel, best_u)
    out[:, 3] = torch.where(better, v_sel, best_v)
    return out


def box_pass_torch(box, o, d, tmin, t1):
    """The kernels' per-lane box test (csrc/candidate_test.cuh::box_pass),
    op for op: can the ray reach the candidate's world box, widened on
    every side by BOX_REL * s + BOX_ABS (s the largest |origin| + |box
    bound| over the axes), within [tmin, t1]? box [..., 6] (min xyz | max
    xyz), o/d [..., 3], tmin/t1 [...] broadcast together -> bool [...]."""
    inv = 1.0 / torch.where(torch.abs(d) < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)
    lo, hi = box[..., 0:3], box[..., 3:6]
    s = (torch.abs(o) + torch.maximum(torch.abs(lo), torch.abs(hi))).amax(dim=-1, keepdim=True)
    m = BOX_REL * s + BOX_ABS
    a = ((lo - m) - o) * inv
    b = ((hi + m) - o) * inv
    near = torch.maximum(torch.minimum(a, b).amax(dim=-1), tmin)
    far = torch.minimum(torch.maximum(a, b).amin(dim=-1), t1)
    return near <= far


def sliver_slots(tri):
    """bool [..., C]: the real triangles of tri [..., C, 12] with
    |e1 x e2| <= SLIVER_SIN |e1| |e2| (csrc/candidate_test.cuh::sliver)."""
    e1, e2 = tri[..., 3:6], tri[..., 6:9]
    cr = torch.linalg.cross(e1, e2)
    thin = (cr * cr).sum(-1) <= SLIVER_SIN ** 2 * ((e1 * e1).sum(-1) * (e2 * e2).sum(-1))
    return (tri[..., 9] >= 0.0) & thin


def candidate_test_boxes(cl: ClusterArrays, cb6):
    """What the kernels' per-lane box test takes, [7, K]: the candidates'
    world boxes cb6 and, in row 6, 1.0 for a candidate whose row holds a
    sliver triangle. On such a triangle Möller-Trumbore's determinant is
    rounding noise above its 1e-12 threshold, and _mt_update reports hits
    far from the triangle, for any ray and outside any box; so the kernels
    test a flagged candidate's sliver slots for every lane that can still
    be hit, and only its other slots by the box test."""
    rows = sliver_slots(cl.tri).any(dim=1)
    flag = rows[cl.tri_row.long()] if cl.tri_row is not None else rows
    return torch.cat([cb6, flag[None, :].to(cb6.dtype)]).contiguous()


def mt_update_culled(tri, x, box, o, d, lim, ex, best, any_hit: bool, box_t1=None):
    """_mt_update as the kernels run it: of the lanes that can still be
    hit (best t > tmin), those that pass the box test (box [nb, 7], a row of
    candidate_test_boxes each) over [tmin, box_t1] ([nb, L]; default their
    best t) test the candidate, and the others only its sliver slots. Each
    lane becomes a block of its own, in whose copy of the triangles the
    slots it skips are padding (gid -1), and goes through _mt_update. For
    tests at small sizes: the copy is [nb * L, C, 12]."""
    nb, C, L = tri.shape[0], tri.shape[1], o.shape[2]
    tmin, bt = lim[:, 0], best[:, 0]
    live = bt > tmin
    in_box = live & box_pass_torch(box[:, None, :6], o.permute(0, 2, 1), d.permute(0, 2, 1),
                                   tmin, bt if box_t1 is None else box_t1)
    tested = in_box[:, :, None] | (live[:, :, None] & sliver_slots(tri)[:, None, :])  # [nb, L, C]
    tri1 = tri[:, None].expand(nb, L, C, 12).clone()
    tri1[..., 9] = torch.where(tested, tri1[..., 9], -1.0)

    def lanes(a):  # [nb, r, L] -> [nb * L, r, 1]
        return a.permute(0, 2, 1).reshape(nb * L, a.shape[1], 1)

    out = _mt_update(tri1.reshape(nb * L, C, 12), x[:, None].expand(nb, L, 16).reshape(nb * L, 16),
                     lanes(o), lanes(d), lanes(lim), lanes(ex), lanes(best), any_hit)
    return out.reshape(nb, L, 4).permute(0, 2, 1)


def sweep_walk_culled_torch(worder, went, kcnt, tri_row, tri, xf, boxes, o_soa, d_soa, lim, ex,
                            best0, any_hit: bool):
    """The K4 kernel step for step in torch, for tests at small sizes: one
    candidate at a time with the block horizon refreshed before each, and
    the candidate test with its box test (mt_update_culled). Arguments as
    sweep_walk with boxes [7, K] (candidate_test_boxes). It must equal
    sweep_walk_torch."""
    B, K = worder.shape
    n = o_soa.shape[1]
    L = n // B
    dev = o_soa.device
    best = best0.reshape(4, B, L).permute(1, 0, 2).contiguous()
    o = o_soa.reshape(3, B, L).permute(1, 0, 2)
    d = d_soa.reshape(3, B, L).permute(1, 0, 2)
    lm = lim.reshape(2, B, L).permute(1, 0, 2)
    exb = ex.reshape(4, B, L).permute(1, 0, 2)
    ident = torch.tensor(_IDENT, dtype=torch.float32, device=dev)
    live = torch.ones((B,), dtype=torch.bool, device=dev)
    for k in range(K):
        t1 = (torch.where(best[:, 1] >= 0.0, ANY_HIT_RETIRED, lm[:, 1]) if any_hit
              else best[:, 0])
        live = live & (k < kcnt) & (went[:, k] <= t1.amax(dim=1))
        r = torch.nonzero(live).squeeze(1)
        if r.numel() == 0:
            break
        ci = worder[r, k].long()
        rows = tri_row.long()[ci] if tri_row is not None else ci
        x = xf[ci] if xf is not None else ident.expand(r.shape[0], 16)
        best[r] = mt_update_culled(tri[rows], x, boxes[:, ci].T, o[r], d[r], lm[r], exb[r], best[r],
                                   any_hit)
    return best.permute(1, 0, 2).reshape(4, n)


def sweep_ent_torch(tri_ix, xf_ix, o_soa, d_soa, lim, ex, cent, tri, xf_tab, best_in,
                    any_hit: bool, dummy_row: int | None = None):
    """One sweep round, the plain version of _sweep_ent: tri_ix/xf_ix
    [B, M] candidate rows, cent [B, 1, M] their entries, tri [R, C, 12],
    xf_tab [X, 16] (or None: identity rows), best_in [4, n] -> [4, n].
    A candidate is tested when its tri row is below dummy_row (default
    R - 1, the JAX dummy row) and its entry is within the block horizon,
    refreshed before every candidate."""
    B, M = tri_ix.shape
    n = o_soa.shape[1]
    L = n // B
    dev = o_soa.device
    if dummy_row is None:
        dummy_row = tri.shape[0] - 1
    best = best_in.reshape(4, B, L).permute(1, 0, 2).contiguous()  # [B, 4, L]
    o = o_soa.reshape(3, B, L).permute(1, 0, 2)
    d = d_soa.reshape(3, B, L).permute(1, 0, 2)
    lm = lim.reshape(2, B, L).permute(1, 0, 2)
    exb = ex.reshape(4, B, L).permute(1, 0, 2)
    ident = torch.tensor(_IDENT, dtype=torch.float32, device=dev)
    nb_max = max(1, CHUNK_ELEMS // max(tri.shape[1] * L, 1))
    for m in range(M):
        t1 = (torch.where(best[:, 1] >= 0.0, ANY_HIT_RETIRED, lm[:, 1]) if any_hit
              else best[:, 0])
        horizon = t1.amax(dim=1)
        valid = (tri_ix[:, m] < dummy_row) & (cent[:, 0, m] <= horizon)
        rows = torch.nonzero(valid).squeeze(1)
        for s in range(0, rows.shape[0], nb_max):
            r = rows[s:s + nb_max]
            x = (xf_tab[xf_ix[r, m].long()] if xf_tab is not None
                 else ident.expand(r.shape[0], 16))
            best[r] = _mt_update(tri[tri_ix[r, m].long()], x, o[r], d[r], lm[r], exb[r],
                                 best[r], any_hit)
    return best.permute(1, 0, 2).reshape(4, n)


def _block_lim(best, B: int, any_hit: bool):
    """Each block's horizon [B]: the worst live lane's best t."""
    bt = best[0].reshape(B, -1)
    if any_hit:
        bt = torch.where(best[1].reshape(B, -1) >= 0.0, -INF, bt)
    return bt.amax(dim=1)


def sweep_walk_torch(worder, went, kcnt, tri_row, tri, xf, o_soa, d_soa, lim, ex, best0,
                     any_hit: bool, maxc: int = MAXC):
    """Plain version of K4: the static walk of intersect_pairs as the JAX
    package runs it, in rounds of maxc candidates per block (sweep_ent_torch)
    with each block's cursor and liveness carried between rounds. The
    result does not depend on maxc."""
    B, K = worder.shape
    dev = worder.device
    maxc_eff = max(1, min(maxc, K))
    pos = torch.arange(maxc_eff, device=dev)
    R = tri.shape[0]

    def win_live(cursor, bt1):
        c = torch.clamp(cursor, max=K - 1)
        e_at = torch.gather(went, 1, c[:, None].long())[:, 0]
        return (cursor < kcnt) & (e_at <= bt1)

    best = best0
    if K == 0:
        return best.clone()
    cursor = torch.zeros((B,), dtype=torch.int64, device=dev)
    live = win_live(cursor, _block_lim(best, B, any_hit))
    while bool(live.any()):
        idx = cursor[:, None] + pos[None, :]
        idx_c = torch.clamp(idx, max=K - 1)
        cand_i = torch.gather(worder.long(), 1, idx_c)
        cand_e = torch.gather(went, 1, idx_c)
        ok = (idx < kcnt[:, None]) & live[:, None] & torch.isfinite(cand_e)
        rows = tri_row.long()[cand_i] if tri_row is not None else cand_i
        tri_ix = torch.where(ok, rows, R)
        cent = torch.where(ok, cand_e, INF)[:, None, :]
        best = sweep_ent_torch(tri_ix, cand_i, o_soa, d_soa, lim, ex, cent, tri, xf, best,
                               any_hit, dummy_row=R)
        cursor = torch.where(live, cursor + maxc_eff, cursor)
        live = live & win_live(cursor, _block_lim(best, B, any_hit))
    return best


def sweep_walk(worder, went, kcnt, tri_row, tri, xf, o_soa, d_soa, lim, ex, best0,
               any_hit: bool, *, boxes, walked=None, stats=None):
    """K4 (replaces akari_render_tpu/accel/pairs.py::_sweep_ent_kernel with
    mt_block_update, and the round loop around it): every block walks its
    candidates worder[b, :kcnt[b]] (entries went, ascending) until the next
    entry lies beyond the block horizon. worder [B, M] holds candidate ids
    (M = K for a whole walk, fewer for one round of the windowed walk). tri
    [R, C, 12] triangle rows; tri_row [K] (or None: row = candidate) and xf
    [K, 16] (or None: identity) are indexed by candidate id.
    Lanes: o/d [3, n], lim [2, n] (tmin, t-limit), ex [4, n] (exclusion ids
    and the per-lane any-hit flag), best0 [4, n] (t, id, u, v) -> [4, n].
    boxes [7, K'] is what the kernel's per-lane box test takes, by
    candidate id (candidate_test_boxes): a skip that cannot change the
    result, so the plain version does not read them. walked (int32 [B], or
    None; the kernel only) receives each block's count of candidates
    tested. stats (int32 [B, 4], zeroed, or None; the kernel only) adds each
    block's counters of the candidate test: units of work run (a lane
    that passed the box test x 32 slots), (lane, candidate) pairs that
    passed the box test, (lane, slot) pairs tested and those that hit."""
    if _route("sweep_walk", o_soa):
        return sweep_walk_torch(worder, went, kcnt, tri_row, tri, xf, o_soa, d_soa, lim, ex,
                                best0, any_hit)
    dev = o_soa.device
    B, K = worder.shape
    n = o_soa.shape[1]
    R, C = tri.shape[0], tri.shape[1]
    if n != B * BLOCK:
        raise ValueError("sweep_walk: lanes must be B * BLOCK")
    worder = _check("sweep_walk worder", worder, dev, torch.int32, (B, K))
    went = _check("sweep_walk went", went, dev, torch.float32, (B, K))
    kcnt = _check("sweep_walk kcnt", kcnt, dev, torch.int32, (B,))
    if tri_row is not None:
        tri_row = _check("sweep_walk tri_row", tri_row, dev, torch.int32, (tri_row.shape[0],))
    tri = _check("sweep_walk tri", tri, dev, torch.float32, (R, C, 12))
    if xf is not None:
        xf = _check("sweep_walk xf", xf, dev, torch.float32, (xf.shape[0], 16))
    o_soa = _check("sweep_walk o", o_soa, dev, torch.float32, (3, n))
    d_soa = _check("sweep_walk d", d_soa, dev, torch.float32, (3, n))
    lim = _check("sweep_walk lim", lim, dev, torch.float32, (2, n))
    ex = _check("sweep_walk ex", ex, dev, torch.float32, (4, n))
    best = _check("sweep_walk best0", best0, dev, torch.float32, (4, n)).clone()
    if walked is not None:
        walked = _check("sweep_walk walked", walked, dev, torch.int32, (B,))
    n_cand = boxes.shape[1]
    boxes = _check("sweep_walk boxes", boxes, dev, torch.float32, (7, n_cand))
    if stats is not None:
        stats = _check("sweep_walk stats", stats, dev, torch.int32, (B, 4))
    if B:
        _launch("akr_sweep", _ptr(worder), _ptr(went), _ptr(kcnt), _ptr(tri_row), _ptr(tri),
                _ptr(xf), _ptr(boxes), _ptr(o_soa), _ptr(d_soa), _ptr(lim), _ptr(ex), _ptr(best),
                B, K, n_cand, C, BLOCK, int(bool(any_hit)), 1, _ptr(walked), _ptr(stats))
        launches["K4"] += 1
    return best


# ----------------------------------------------------------------------- K6
def sweep_torch(tri_ix, xf_ix, o_soa, d_soa, lim, ex, tri, xf_tab, best_in, any_hit: bool):
    """Plain version of K6: sweep_ent_torch one candidate per round, with
    no entry cut (every candidate's entry -inf)."""
    B, M = tri_ix.shape
    no_cut = torch.full((B, 1, 1), -INF, device=o_soa.device)
    best = best_in
    for m in range(M):
        best = sweep_ent_torch(tri_ix[:, m:m + 1], xf_ix[:, m:m + 1], o_soa, d_soa, lim, ex,
                               no_cut, tri, xf_tab, best, any_hit)
    return best


def sweep(tri_ix, xf_ix, o_soa, d_soa, lim, ex, tri, xf_tab, best_in, any_hit: bool, stats=None):
    """K6 (replaces akari_render_tpu/accel/pairs.py::_sweep_kernel, via
    _sweep; the interface of _sweep): block b tests its candidates
    tri_ix[b, m] (rows of tri [R, C, 12]; R - 1 and above are dummies) with
    transforms xf_tab[xf_ix[b, m]] in order m, one at a time, with no
    horizon early-out. Lanes as sweep_walk; best_in [4, n] -> [4, n]. On
    CUDA it is the K4 kernel with the early-out off; the interface names
    triangle rows, not candidates with boxes, so the wrapper computes the
    boxes of the kernel's per-lane box test (_candidate_boxes). stats (the
    kernel only): the candidate test's counters, as sweep_walk's."""
    if _route("sweep", o_soa):
        return sweep_torch(tri_ix, xf_ix, o_soa, d_soa, lim, ex, tri, xf_tab, best_in, any_hit)
    dev = o_soa.device
    B, M = tri_ix.shape
    n = o_soa.shape[1]
    R, C = tri.shape[0], tri.shape[1]
    if n != B * BLOCK:
        raise ValueError("sweep: lanes must be B * BLOCK")
    if tri_ix.device != dev or xf_ix.device != dev or tuple(xf_ix.shape) != (B, M):
        raise ValueError("sweep: tri_ix and xf_ix must be [B, M] on the lanes' device")
    tri = _check("sweep tri", tri, dev, torch.float32, (R, C, 12))
    xf_tab = _check("sweep xf_tab", xf_tab, dev, torch.float32, (xf_tab.shape[0], 16))
    o_soa = _check("sweep o", o_soa, dev, torch.float32, (3, n))
    d_soa = _check("sweep d", d_soa, dev, torch.float32, (3, n))
    lim = _check("sweep lim", lim, dev, torch.float32, (2, n))
    ex = _check("sweep ex", ex, dev, torch.float32, (4, n))
    best = _check("sweep best_in", best_in, dev, torch.float32, (4, n)).clone()
    if stats is not None:
        stats = _check("sweep stats", stats, dev, torch.int32, (B, 4))
    # candidate id b * M + m: its tri row and transform, +inf entry for dummies
    valid = tri_ix < R - 1
    cand = torch.arange(B * M, dtype=torch.int32, device=dev).reshape(B, M)
    went = torch.where(valid, 0.0, INF).to(torch.float32)
    kcnt = torch.full((B,), M, dtype=torch.int32, device=dev)
    tri_row = torch.where(valid, tri_ix, 0).reshape(-1).to(torch.int32)
    xf = xf_tab[torch.clamp(xf_ix.reshape(-1).long(), 0, xf_tab.shape[0] - 1)].contiguous()
    if B * M:
        boxes = _candidate_boxes(tri, tri_row.long(), xf)
        _launch("akr_sweep", _ptr(cand), _ptr(went), _ptr(kcnt), _ptr(tri_row), _ptr(tri),
                _ptr(xf), _ptr(boxes), _ptr(o_soa), _ptr(d_soa), _ptr(lim), _ptr(ex), _ptr(best),
                B, M, B * M, C, BLOCK, int(bool(any_hit)), 0, _ptr(None), _ptr(stats))
        launches["K6"] += 1
    return best


def _candidate_boxes(tri, rows, xf):
    """candidate_test_boxes [7, n] for the kernel's box test, for candidates
    given only as triangle rows `rows` [n] of tri [R, C, 12] and
    world->local rows xf [n, 16] (K6's interface names no boxes): each
    row's local box over its real slots, through the inverse of the
    transform by centre and extent, as the unified list's are built, and
    the row's sliver flag. The inverse and the box are taken in float64, so their rounding stays far
    below the box test's margin (2^-10 of the coordinates) for any
    transform with a condition number up to ~1e10; the result is rounded
    to float32 once."""
    sliver = sliver_slots(tri).any(dim=1)[rows]
    tri, xf = tri.double(), xf.double()
    v0, e1, e2 = tri[:, :, 0:3], tri[:, :, 3:6], tri[:, :, 6:9]
    real = (tri[:, :, 9] >= 0.0)[:, :, None]
    verts = torch.stack([v0, v0 + e1, v0 + e2])  # [3, R, C, 3]
    lo = torch.where(real, verts.amin(dim=0), INF).amin(dim=1)  # [R, 3]
    hi = torch.where(real, verts.amax(dim=0), -INF).amax(dim=1)
    c, e = ((lo + hi) * 0.5)[rows], ((hi - lo) * 0.5)[rows]  # [n, 3]
    m = xf[:, :12].reshape(-1, 3, 4)
    c0, c1, c2 = (torch.linalg.cross(m[:, i, :3], m[:, j, :3]) for i, j in ((1, 2), (2, 0), (0, 1)))
    det = (m[:, 0, :3] * c0).sum(dim=1)
    r = torch.stack([c0, c1, c2], dim=2) / det[:, None, None]  # local -> world: the inverse
    wc = (r * (c - m[:, :, 3])[:, None, :]).sum(dim=2)
    we = (torch.abs(r) * e[:, None, :]).sum(dim=2)
    return torch.cat([(wc - we).T, (wc + we).T, sliver[None, :]]).float().contiguous()


# ---------------------------------------------------------- intersect_pairs
class SortedRays(NamedTuple):
    """The rays of one traversal, sorted into blocks of BLOCK lanes (n_pad
    lanes, the tail padded with dead lanes), in the kernels' layouts."""

    perm: torch.Tensor  # [n] sorted position -> ray
    o_soa: torch.Tensor  # [3, n_pad] origins
    d_soa: torch.Tensor  # [3, n_pad] directions
    inv_soa: torch.Tensor  # [3, n_pad] inverse directions (|d| clamped to 1e-20)
    lim: torch.Tensor  # [2, n_pad] tmin, t-limit
    ex: torch.Tensor  # [4, n_pad] three exclusion ids and the per-lane any-hit flag
    summ: torch.Tensor  # [B, 16] block summaries for K2
    best0: torch.Tensor  # [4, n_pad] initial (t, id, u, v)


def sort_rays(cl: ClusterArrays, o, d, tmin, tmax, exclude0=None, exclude1=None, exclude2=None,
              any_hit_mask=None, dead_last: bool = True) -> SortedRays:
    """Sanitise, key and sort the rays, and summarise each block. With
    dead_last (the pair sweep's sort) dead lanes get the largest key; the
    wide walk's sort leaves them where their key puts them."""
    dev = o.device
    n = o.shape[0]
    n_pad = ((n + BLOCK - 1) // BLOCK) * BLOCK
    B = n_pad // BLOCK
    pad = n_pad - n
    tmin = tmin.to(torch.float32)
    tmax = tmax.to(torch.float32)

    # non-finite lanes (a dead lane may carry NaN) would poison their
    # block's interval summaries: they trace as dead (tmax = -1)
    finite = torch.isfinite(o).all(-1) & torch.isfinite(d).all(-1)
    o = torch.where(finite[:, None], o, 0.0)
    d = torch.where(finite[:, None], d, 1.0)
    tmax = torch.where(finite, tmax, -1.0)

    keys = sort_keys(o, d, cl.cbmin.amin(dim=0)[None, :], cl.cbmax.amax(dim=0)[None, :])
    if dead_last:  # into trailing blocks that cull everything
        keys = torch.where(tmax <= tmin, 0xFFFFFFFF, keys)
    perm = torch.argsort(keys, stable=True)

    def srt(x, fill):
        x = x[perm]
        if pad:
            x = torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                                         device=dev)])
        return x

    os_ = srt(o, 0.0)
    ds_ = srt(d, 1.0)
    tmins = srt(tmin, 0.0)
    tlims = srt(torch.clamp(tmax, max=RAY_TMAX), -1.0)  # padding lanes: dead

    def pack_ex(e):
        return srt(e.to(torch.float32), -1.0) if e is not None else torch.full((n_pad,), -1.0,
                                                                               device=dev)

    sh_row = (srt(any_hit_mask.to(torch.float32), 0.0) if any_hit_mask is not None
              else torch.zeros((n_pad,), device=dev))
    ex = torch.stack([pack_ex(exclude0), pack_ex(exclude1), pack_ex(exclude2), sh_row])

    # block interval summaries
    ob = os_.reshape(B, BLOCK, 3)
    inv_d = 1.0 / torch.where(torch.abs(ds_) < 1e-20,
                              torch.where(ds_ < 0, -1e-20, 1e-20), ds_)
    ib = inv_d.reshape(B, BLOCK, 3)
    bt0 = tmins.reshape(B, BLOCK).amin(dim=1)
    # initial horizon: the block's max t-limit (nothing is occluded yet)
    bt1_0 = tlims.reshape(B, BLOCK).amax(dim=1)
    summ = torch.cat([ob.amin(dim=1), ob.amax(dim=1), ib.amin(dim=1), ib.amax(dim=1),
                      bt0[:, None], bt1_0[:, None], torch.zeros((B, 2), device=dev)], dim=1)
    best0 = torch.stack([tlims, torch.full((n_pad,), -1.0, device=dev),
                         torch.zeros((n_pad,), device=dev), torch.zeros((n_pad,), device=dev)])
    return SortedRays(perm=perm, o_soa=os_.T.contiguous(), d_soa=ds_.T.contiguous(),
                      inv_soa=inv_d.T.contiguous(), lim=torch.stack([tmins, tlims]), ex=ex,
                      summ=summ, best0=best0)


def cluster_bounds(cl: ClusterArrays):
    """cb6 [6, K]: the cluster AABBs as min xyz | max xyz rows."""
    return torch.cat([cl.cbmin.T, cl.cbmax.T], dim=0).contiguous()


def walk_order(e_init):
    """Each block's walk: worder [B, K] int32 (stable argsort of e_init, so
    ties go to the lower cluster), went [B, K] its entries, kcnt [B] int32
    the finite ones."""
    worder = torch.argsort(e_init, dim=1, stable=True).to(torch.int32)
    went = torch.gather(e_init, 1, worder.long())
    kcnt = torch.isfinite(e_init).sum(dim=1).to(torch.int32)
    return worder, went, kcnt


def windowed_walk(cl: ClusterArrays, s: SortedRays, e_con, any_hit: bool, maxc: int = MAXC,
                  rounds: list | None = None):
    """The legacy windowed walk of intersect_pairs (AKR_PAIRS_STATIC=0) over
    K2's conservative entries e_con [B, K] -> best [4, n_pad]. Per round and
    live block: the next W = WINDOW_MULT * maxc members of its order, K5 on
    their ids against the lanes' current limits, the first maxc passing
    members swept through the K4 kernel (their entries ascend, so its break
    at the horizon equals the TPU sweep's per-candidate skip), and the
    cursor moved past the last one swept, or past the window when all that
    passed were swept. The result does not depend on maxc. rounds (a list,
    or None) receives one entry per round: the live blocks (a host value
    the loop reads anyway)."""
    B, K = e_con.shape
    dev = e_con.device
    best = s.best0
    if K == 0:
        return best.clone()
    worder, went, kcnt = walk_order(e_con)
    maxc_eff = min(maxc, K)
    W = min(maxc_eff * WINDOW_MULT, K)
    posW = torch.arange(W, device=dev)
    cb6 = cluster_bounds(cl)  # [6, K]
    test_boxes = candidate_test_boxes(cl, cb6)
    kcnt64 = kcnt.long()

    def win_live(cursor, bt1):
        c = torch.clamp(cursor, max=K - 1)
        e_at = torch.gather(went, 1, c[:, None])[:, 0]
        return (cursor < kcnt64) & (e_at <= bt1)

    cursor = torch.zeros((B,), dtype=torch.int64, device=dev)
    live = win_live(cursor, _block_lim(best, B, any_hit))
    while True:
        n_live = int(live.sum())  # the round loop's host read
        if not n_live:
            break
        if rounds is not None:
            rounds.append(n_live)
        idx = cursor[:, None] + posW[None, :]
        idx_c = torch.clamp(idx, max=K - 1)
        win_i = torch.gather(worder, 1, idx_c)  # [B, W] candidate ids
        member_ok = (idx < kcnt64[:, None]) & live[:, None]  # where the entry is finite
        win_e = torch.where(member_ok, torch.gather(went, 1, idx_c), INF)
        lane_t1 = torch.where(best[1] >= 0.0, -INF, best[0]) if any_hit else best[0]
        nonzero = refine_window(cb6, win_i, member_ok, s.o_soa, s.inv_soa,
                                torch.stack([s.lim[0], lane_t1])) > 0

        # the first maxc passing members are swept; failing members before
        # the cut are consumed without a test (no lane can hit them)
        kept_rank = torch.cumsum(nonzero.to(torch.int64), dim=1)
        selected = nonzero & (kept_rank <= maxc_eff)
        cut = torch.where(selected, posW[None, :], -1).amax(dim=1)
        advance = torch.where(kept_rank[:, -1] <= maxc_eff, W, cut + 1)
        # compact the selected members, in order, to the front
        order = torch.argsort(torch.where(selected, posW[None, :], W + posW[None, :]),
                              dim=1)[:, :maxc_eff]
        cand_ok = torch.gather(selected, 1, order)
        cand_i = torch.gather(win_i, 1, order)
        cand_e = torch.where(cand_ok, torch.gather(win_e, 1, order), INF)
        best = sweep_walk(cand_i, cand_e, cand_ok.sum(dim=1).to(torch.int32), cl.tri_row,
                          cl.tri, cl.xf, s.o_soa, s.d_soa, s.lim, s.ex, best, any_hit,
                          boxes=test_boxes)
        cursor = torch.where(live, cursor + advance, cursor)
        live = live & win_live(cursor, _block_lim(best, B, any_hit))
    return best


def static_walk_enabled() -> bool:
    """AKR_PAIRS_STATIC (read at every call): "0" takes the legacy windowed
    walk, anything else the static-refine walk."""
    return os.environ.get("AKR_PAIRS_STATIC", "1") != "0"


def intersect_pairs(cl: ClusterArrays, o, d, tmin, tmax, exclude0=None, exclude1=None,
                    exclude2=None, any_hit=False, any_hit_mask=None):
    """Exact closest hit (a Hit) or any hit (bool [n]) through the pair
    sweep over the clusters `cl` (flat, or the unified flat + instanced
    list). Hit ids are global virtual ids. any_hit_mask: optional [n] bool,
    per-lane any-hit inside a closest-hit call: a flagged lane retires at
    its first in-range hit, and callers read only its `valid`."""
    s = sort_rays(cl, o, d, tmin, tmax, exclude0, exclude1, exclude2, any_hit_mask)
    cb6 = cluster_bounds(cl)
    e_con = cull_einit(s.summ, cb6)
    if static_walk_enabled():
        _, worder, went, kcnt = refine_walk(cb6, s.o_soa, s.inv_soa, s.lim, e_con)
        best = sweep_walk(worder, went, kcnt, cl.tri_row, cl.tri, cl.xf, s.o_soa, s.d_soa,
                          s.lim, s.ex, s.best0, any_hit, boxes=candidate_test_boxes(cl, cb6))
    else:
        best = windowed_walk(cl, s, e_con, any_hit)
    return _unsort_hits(best, s.perm, o.shape[0], any_hit)


def _unsort_hits(best, perm, n, any_hit):
    """Undo the ray sort: sorted position p holds ray perm[p]."""
    inv = torch.empty((n,), dtype=torch.int64, device=perm.device)
    inv[perm] = torch.arange(n, device=perm.device)
    t = best[0][inv]
    tri_id = best[1][inv].to(torch.int32)
    occ = tri_id >= 0
    if any_hit:
        return occ
    return Hit(t=torch.where(occ, t, RAY_TMAX), tri_id=tri_id,
               bary=torch.stack([best[2][inv], best[3][inv]], -1), valid=occ)
