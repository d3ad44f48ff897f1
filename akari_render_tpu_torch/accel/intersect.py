"""K1: the flat tier's brute-force Möller-Trumbore, a hand-written CUDA
kernel and its wrapper.

The kernel (csrc/intersect.cu) replaces the TPU kernel
akari_render_tpu/accel/pallas_intersect.py::_kernel: every ray against
every triangle, closest hit (least t, the first triangle id among equals)
or any hit, with three excluded triangle ids per ray. On the card it cuts
the soup into tiles of at most TILE consecutive ids (`flat_tiles`: each
tile's world box and sliver flag) and runs them, in id order, through the
cluster tier's candidate test (csrc/candidate_test.cuh) with the identity
transform: a lane tests a tile's triangles only when its ray reaches the
tile's widened box within its best t now, or the tile's hittable sliver
triangles. `intersect_tris_culled_torch` is that walk step for step in
torch; the CPU tests hold it to the brute force bit for bit.

`intersect_tris` routes by device: a CPU tensor goes through the plain
torch version (`intersect_tris_torch`, the definition), a CUDA tensor
launches the kernel or raises. There is no fallback from a failed build or
launch.

The kernel is compiled with nvcc on first use into build/torch_kernels/
(keyed by a hash of the source and flags, accel/nvcc.py) and loaded with
ctypes.

On CUDA every flat-tier scene takes the kernel: the JAX package's 16384
triangle limit (Scene.PALLAS_MAX_TRIS) is a TPU compile-time limit.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..core.math import RAY_TMAX
from .cluster import check_float_ids
from .nvcc import CSRC, compile_library, read_kernel_info
from .pairs import INF, _IDENT, _check, _ptr, box_pass_torch, mt_update_culled, sliver_slots
from .trace import Hit, intersect_brute_force, occlude_brute_force

SOURCE = CSRC / "intersect.cu"
# rays per plain-version call: bounds its [512, RAY_CHUNK] f32 temporaries
RAY_CHUNK = 1 << 16
TILE = 128  # triangles a tile holds at most (kTile of csrc/intersect.cu)
BLOCK = 512  # lanes of a CUDA block of the kernel (akr::kMaxLanes)
# ids of consecutive hittable sliver triangles at most this far apart fall
# into one sliver run (a mesh's pole interleaves them with fat triangles)
SLIVER_GAP = 2
TWIN_LANES = 4096  # lanes per mt_update_culled call of the twin
# a lane's box test runs over [tmin, best t + BOX_T_REL |best t|]
# (kBoxTRel of csrc/intersect.cu, which says why)
BOX_T_REL = 0.25

# kernel launches since the last reset (the main path's count is read by
# chip_smoke.py); only the kernel branch of intersect_tris adds to it
launches = 0
# seconds the last build took (0.0 when the library came from the cache)
build_seconds = 0.0

_lib = None
_lib_lock = threading.Lock()


class FlatTiles(NamedTuple):
    """The flat soup cut into tiles of consecutive triangle ids, as the
    kernel stages them."""

    tri: torch.Tensor  # [ntiles, TILE, 12] v0 | e1 | e2 | id | 0 | 0 (id -1: padding)
    boxes: torch.Tensor  # [7, ntiles] world box (min xyz | max xyz) and sliver flag
    slots: torch.Tensor  # [ntiles] int32: the slots staged, the tile's triangles rounded up to 32


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, build_seconds
    with _lib_lock:
        if _lib is not None:
            return _lib
        so, secs = compile_library(SOURCE, "intersect")
        if secs:
            build_seconds = secs
        lib = ctypes.CDLL(str(so))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.akr_intersect.argtypes = [vp] * 10 + [ci, ci, ci] + [vp] * 8
        lib.akr_intersect_kernel_info.argtypes = [vp, ci, ci]
        for f in (lib.akr_intersect, lib.akr_intersect_kernel_info):
            f.restype = ci
        _lib = lib
        return lib


def kernel_info() -> dict:
    """K1's resources on the current card (nvcc.read_kernel_info)."""
    return read_kernel_info(build().akr_intersect_kernel_info, ("K1",), TILE, BLOCK)


def hittable_slivers(v0, e1, e2):
    """bool [T]: the sliver triangles (pairs.sliver_slots) that can hit. A
    triangle with a zero edge never hits: its determinant is +-0 for every
    ray (e1 = 0: every product of e1 . p is zero; e2 = 0: p = d x e2 is),
    which fails |det| > 1e-12."""
    tri = torch.cat([v0, e1, e2, torch.zeros_like(v0)], dim=1)
    return sliver_slots(tri) & (e1 != 0).any(dim=1) & (e2 != 0).any(dim=1)


def tile_ranges(sliver: np.ndarray) -> list[tuple[int, int]]:
    """(first id, count) of each tile over a soup whose hittable slivers
    are `sliver` [T]: each sliver run (slivers at most SLIVER_GAP ids
    apart, with the fat triangles between them) gets tiles of its own, so
    that a lane which misses a tile's box but may hit its slivers queues
    for the run and not for the fat triangles around it; the rest is cut
    into tiles of TILE."""
    T = len(sliver)
    cuts, ids = [0, T], np.nonzero(sliver)[0]
    if len(ids):
        brk = np.nonzero(np.diff(ids) > SLIVER_GAP)[0]
        starts, ends = ids[np.r_[0, brk + 1]], ids[np.r_[brk, len(ids) - 1]] + 1
        cuts += [*starts.tolist(), *ends.tolist()]
    out = []
    bounds = sorted(set(cuts))
    for a, b in zip(bounds[:-1], bounds[1:]):
        out += [(s, min(TILE, b - s)) for s in range(a, b, TILE)]
    return out


def flat_tiles(v0, e1, e2) -> FlatTiles:
    """The kernel's tiles of a soup v0/e1/e2 [T, 3] (T >= 1), on its device.
    A tile's box bounds its triangles' vertices (taken in float64, rounded
    to float32 once: the box test's margin covers that rounding); its
    sliver flag is 1.0 where it holds a hittable sliver triangle, whose
    slots the kernel tests for every lane that can still be hit, as the
    cluster tier's candidate_test_boxes flags a candidate."""
    T = v0.shape[0]
    if T < 1:
        raise ValueError("flat_tiles: the soup has no triangle")
    check_float_ids(T - 1)
    dev = v0.device
    sliver = hittable_slivers(v0, e1, e2)
    ranges = tile_ranges(sliver.cpu().numpy())
    nt = len(ranges)
    starts = torch.tensor([s for s, _ in ranges], dtype=torch.int64, device=dev)
    counts = torch.tensor([c for _, c in ranges], dtype=torch.int64, device=dev)
    slot = torch.arange(TILE, device=dev)
    ids = starts[:, None] + slot[None, :]
    real = slot[None, :] < counts[:, None]  # [nt, TILE]
    src = torch.where(real, ids, 0)
    tri = torch.cat([v0[src], e1[src], e2[src], torch.zeros((nt, TILE, 3), device=dev)], dim=2)
    tri = torch.where(real[..., None], tri, 0.0)  # padding: a degenerate triangle of id -1
    tri[..., 9] = torch.where(real, ids, -1).float()
    a, b, c = v0.double()[src], (v0.double() + e1.double())[src], (v0.double() + e2.double())[src]
    lo = torch.where(real[..., None], torch.minimum(torch.minimum(a, b), c), INF).amin(dim=1)
    hi = torch.where(real[..., None], torch.maximum(torch.maximum(a, b), c), -INF).amax(dim=1)
    flag = (torch.where(real, sliver[src], False).any(dim=1)).double()
    boxes = torch.cat([lo.T, hi.T, flag[None]]).float().contiguous()
    slots = ((counts + 31) // 32 * 32).to(torch.int32)
    return FlatTiles(tri=tri.contiguous(), boxes=boxes, slots=slots)


def _launch(o, d, tmin, tmax, v0, e1, e2, ex0, ex1, ex2, any_hit, tiles, walked, stats):
    global launches
    dev = o.device
    n, num_tris = o.shape[0], v0.shape[0]
    for name, x in (("d", d), ("tmin", tmin), ("tmax", tmax), ("v0", v0), ("e1", e1), ("e2", e2)):
        if x.device != dev:
            raise ValueError(f"intersect_tris: {name} on {x.device}, rays on {dev}")
    if n > (1 << 31) - BLOCK:
        raise ValueError("intersect_tris: the lanes must fit int32")

    def f32(x, shape):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"intersect_tris: expected float32 {shape}, got {x.dtype} {tuple(x.shape)}")
        return x.contiguous()

    def ids(x):
        if x is None:
            return None
        if x.device != dev or tuple(x.shape) != (n,):
            raise ValueError("intersect_tris: exclusion ids must be [N] on the rays' device")
        return x.to(torch.int32).contiguous()

    o, d = f32(o, (n, 3)), f32(d, (n, 3))
    tmin, tmax = f32(tmin, (n,)), f32(tmax, (n,))
    v0, e1, e2 = f32(v0, (num_tris, 3)), f32(e1, (num_tris, 3)), f32(e2, (num_tris, 3))
    ex0, ex1, ex2 = ids(ex0), ids(ex1), ids(ex2)
    if not num_tris:  # nothing to launch: a miss everywhere
        if any_hit:
            return torch.zeros((n,), dtype=torch.bool, device=dev)
        return Hit(t=torch.full((n,), RAY_TMAX, device=dev),
                   tri_id=torch.full((n,), -1, dtype=torch.int32, device=dev),
                   bary=torch.zeros((n, 2), device=dev),
                   valid=torch.zeros((n,), dtype=torch.bool, device=dev))
    if any_hit:
        occ = torch.empty((n,), dtype=torch.bool, device=dev)
        outs = (None, None, None, None, occ)
    else:
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        tri_id = torch.empty((n,), dtype=torch.int32, device=dev)
        u = torch.empty((n,), dtype=torch.float32, device=dev)
        v = torch.empty((n,), dtype=torch.float32, device=dev)
        outs = (t, tri_id, u, v, None)
    if n:
        if tiles is None:
            tiles = flat_tiles(v0, e1, e2)
        nt = tiles.slots.shape[0]
        tri = _check("intersect_tris tiles.tri", tiles.tri, dev, torch.float32, (nt, TILE, 12))
        boxes = _check("intersect_tris tiles.boxes", tiles.boxes, dev, torch.float32, (7, nt))
        slots = _check("intersect_tris tiles.slots", tiles.slots, dev, torch.int32, (nt,))
        nb = -(-n // BLOCK)
        if walked is not None:
            walked = _check("intersect_tris walked", walked, dev, torch.int32, (nb,))
        if stats is not None:
            stats = _check("intersect_tris stats", stats, dev, torch.int32, (nb, 4))
        lib = build()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.akr_intersect(
                _ptr(o), _ptr(d), _ptr(tmin), _ptr(tmax), _ptr(ex0), _ptr(ex1), _ptr(ex2),
                _ptr(tri), _ptr(boxes), _ptr(slots), nt, n, int(bool(any_hit)),
                *(_ptr(x) for x in outs), _ptr(walked), _ptr(stats), ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"intersect kernel launch failed: CUDA error {err}")
        launches += 1
    if any_hit:
        return occ
    return Hit(t=t, tri_id=tri_id, bary=torch.stack([u, v], dim=-1), valid=tri_id >= 0)


def intersect_tris_torch(o, d, tmin, tmax, v0, e1, e2, ex0=None, ex1=None, ex2=None,
                         any_hit=False):
    """The plain torch version of the kernel: the JAX package's brute force,
    chunked over rays as well as triangles. Misses report t = RAY_TMAX.
    Rays whose interval (tmin, tmax) is empty cannot hit and are skipped,
    as the kernel skips them."""
    live = tmax > tmin
    if not bool(torch.all(live)):
        rows = torch.nonzero(live).squeeze(1)
        exs = [e[rows] if e is not None else None for e in (ex0, ex1, ex2)]
        sub = intersect_tris_torch(o[rows], d[rows], tmin[rows], tmax[rows], v0, e1, e2, *exs,
                                   any_hit=any_hit)
        n = o.shape[0]
        if any_hit:
            occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
            occ[rows] = sub
            return occ
        t = torch.full((n,), RAY_TMAX, dtype=torch.float32, device=o.device)
        tri_id = torch.full((n,), -1, dtype=torch.int32, device=o.device)
        bary = torch.zeros((n, 2), dtype=torch.float32, device=o.device)
        t[rows], tri_id[rows], bary[rows] = sub.t, sub.tri_id, sub.bary
        return Hit(t=t, tri_id=tri_id, bary=bary, valid=tri_id >= 0)
    outs = []
    for s in range(0, o.shape[0], RAY_CHUNK):
        sl = slice(s, s + RAY_CHUNK)
        exs = [e[sl] if e is not None else None for e in (ex0, ex1, ex2)]
        if any_hit:
            outs.append(occlude_brute_force(o[sl], d[sl], tmin[sl], tmax[sl], v0, e1, e2, *exs))
        else:
            outs.append(intersect_brute_force(o[sl], d[sl], tmin[sl], tmax[sl], v0, e1, e2, *exs))
    if any_hit:
        return torch.cat(outs) if outs else torch.zeros((0,), dtype=torch.bool, device=o.device)
    if not outs:
        return Hit(*(torch.zeros((0,) + s, dtype=dt, device=o.device) for s, dt in (
            ((), torch.float32), ((), torch.int32), ((2,), torch.float32), ((), torch.bool))))
    tri_id = torch.cat([h.tri_id for h in outs])
    valid = tri_id >= 0
    t = torch.where(valid, torch.cat([h.t for h in outs]), RAY_TMAX)
    return Hit(t=t, tri_id=tri_id, bary=torch.cat([h.bary for h in outs]), valid=valid)


def intersect_tris_culled_torch(o, d, tmin, tmax, tiles: FlatTiles, ex0=None, ex1=None, ex2=None,
                                any_hit=False, tally=None):
    """The kernel's tile walk step for step in torch, for tests at small
    sizes: the tiles in id order, each through the candidate test with its
    box test over [tmin, best t + BOX_T_REL |best t|] (pairs.mt_update_culled,
    the identity transform), a lane retiring at its first hit for any hit. It must equal
    intersect_tris_torch. tally (a dict, or None) gains "lane_tiles" (live
    lanes x tiles reached) and "in_box" (those that passed the box test)."""
    n, dev = o.shape[0], o.device
    tlim = torch.where(tmax > tmin, torch.clamp(tmax, max=RAY_TMAX), -INF)
    best = torch.stack([tlim, torch.full((n,), -1.0, device=dev), torch.zeros(n, device=dev),
                        torch.zeros(n, device=dev)])
    lim = torch.stack([tmin, tlim])

    def ex_row(e):
        return e.float() if e is not None else torch.full((n,), -1.0, device=dev)

    ex = torch.stack([ex_row(ex0), ex_row(ex1), ex_row(ex2),
                      torch.full((n,), float(bool(any_hit)), device=dev)])
    ident = torch.tensor(_IDENT, dtype=torch.float32, device=dev)[None]
    for k in range(tiles.slots.shape[0]):
        live = best[0] > tmin
        if not bool(live.any()):
            break
        box = tiles.boxes[:, k][None]
        t1 = best[0] + BOX_T_REL * torch.abs(best[0])
        in_box = live & box_pass_torch(box[:, :6], o, d, tmin, t1)
        if tally is not None:
            tally["lane_tiles"] = tally.get("lane_tiles", 0) + int(live.sum())
            tally["in_box"] = tally.get("in_box", 0) + int(in_box.sum())
        # the lanes the candidate test queues: no other lane's best can change
        rows = torch.nonzero(live if bool(box[0, 6] > 0) else in_box).squeeze(1)
        for s in range(0, rows.numel(), TWIN_LANES):
            r = rows[s:s + TWIN_LANES]
            best[:, r] = mt_update_culled(tiles.tri[k][None], ident, box, o[r].T[None],
                                          d[r].T[None], lim[:, r][None], ex[:, r][None],
                                          best[:, r][None], False, box_t1=t1[r][None])[0]
    hit = best[1] >= 0
    if any_hit:
        return hit
    return Hit(t=torch.where(hit, best[0], RAY_TMAX), tri_id=best[1].to(torch.int32),
               bary=best[2:4].T.contiguous(), valid=hit)


def intersect_tris(o, d, tmin, tmax, v0, e1, e2, ex0=None, ex1=None, ex2=None, any_hit=False,
                   *, tiles: FlatTiles | None = None, walked=None, stats=None):
    """Closest hit (a Hit) or any hit (bool [N]) of rays o/d [N, 3] with
    interval (tmin, tmax) [N] against triangles v0/e1/e2 [T, 3]; ex0..ex2
    are [N] int32 excluded triangle ids (-1 for none). CPU tensors take the
    plain torch version; CUDA tensors launch the kernel, on `tiles` (the
    soup's flat_tiles, which a Scene keeps; computed here when None).
    walked (int32 [ceil(N / 512)], or None; the kernel only) receives each
    block's tiles tested; stats (int32 [ceil(N / 512), 4], zeroed, or None;
    the kernel only) the candidate test's counters, as pairs.sweep_walk's."""
    if o.device.type == "cpu":
        return intersect_tris_torch(o, d, tmin, tmax, v0, e1, e2, ex0, ex1, ex2, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"intersect_tris: unsupported device {o.device}")
    return _launch(o, d, tmin, tmax, v0, e1, e2, ex0, ex1, ex2, any_hit, tiles, walked, stats)
