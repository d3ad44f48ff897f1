"""K1: brute-force Möller-Trumbore, a hand-written CUDA kernel and its wrapper.

The kernel (csrc/intersect.cu) replaces the TPU kernel
akari_render_tpu/accel/pallas_intersect.py::_kernel. It is FP32-ALU bound
(about 30 flops per ray-triangle test against 40 bytes per ray); it keeps
the triangles in shared memory and each ray's best hit in registers, one
thread per ray. See the source for the exact semantics.

`intersect_tris` routes by device: a CPU tensor goes through the plain
torch version (`intersect_tris_torch`), a CUDA tensor launches the kernel
or raises. There is no fallback from a failed build or launch.

The kernel is compiled with nvcc on first use into build/torch_kernels/
(keyed by a hash of the source and flags, accel/nvcc.py) and loaded with
ctypes.

On CUDA every flat-tier scene takes the kernel: the JAX package's 16384
triangle limit (Scene.PALLAS_MAX_TRIS) is a TPU compile-time limit.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..core.math import RAY_TMAX
from .nvcc import CSRC, compile_library
from .trace import Hit, intersect_brute_force, occlude_brute_force

SOURCE = CSRC / "intersect.cu"
# rays per plain-version call: bounds its [512, RAY_CHUNK] f32 temporaries
RAY_CHUNK = 1 << 16

# kernel launches since the last reset (the main path's count is read by
# chip_smoke.py); only the kernel branch of intersect_tris adds to it
launches = 0
# seconds the last build took (0.0 when the library came from the cache)
build_seconds = 0.0

_lib = None
_lib_lock = threading.Lock()


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
        lib.akr_intersect.argtypes = [vp] * 10 + [ci, ci, ci] + [vp] * 6
        lib.akr_intersect.restype = ci
        _lib = lib
        return lib


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else ctypes.c_void_p(0)


def _launch(o, d, tmin, tmax, v0, e1, e2, ex0, ex1, ex2, any_hit):
    global launches
    dev = o.device
    n, num_tris = o.shape[0], v0.shape[0]
    for name, x in (("d", d), ("tmin", tmin), ("tmax", tmax), ("v0", v0), ("e1", e1), ("e2", e2)):
        if x.device != dev:
            raise ValueError(f"intersect_tris: {name} on {x.device}, rays on {dev}")
    if num_tris >= 1 << 31 or n >= 1 << 31:
        raise ValueError("intersect_tris: sizes must fit int32")

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
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if any_hit:
            occ = torch.empty((n,), dtype=torch.bool, device=dev)
            outs = (None, None, None, None, occ)
        else:
            t = torch.empty((n,), dtype=torch.float32, device=dev)
            tri_id = torch.empty((n,), dtype=torch.int32, device=dev)
            u = torch.empty((n,), dtype=torch.float32, device=dev)
            v = torch.empty((n,), dtype=torch.float32, device=dev)
            outs = (t, tri_id, u, v, None)
        err = lib.akr_intersect(
            _ptr(o), _ptr(d), _ptr(tmin), _ptr(tmax), _ptr(ex0), _ptr(ex1), _ptr(ex2),
            _ptr(v0), _ptr(e1), _ptr(e2), n, num_tris, int(bool(any_hit)),
            *(_ptr(x) for x in outs), ctypes.c_void_p(stream),
        )
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


def intersect_tris(o, d, tmin, tmax, v0, e1, e2, ex0=None, ex1=None, ex2=None, any_hit=False):
    """Closest hit (a Hit) or any hit (bool [N]) of rays o/d [N, 3] with
    interval (tmin, tmax) [N] against triangles v0/e1/e2 [T, 3]; ex0..ex2
    are [N] int32 excluded triangle ids (-1 for none). CPU tensors take the
    plain torch version; CUDA tensors launch the kernel."""
    if o.device.type == "cpu":
        return intersect_tris_torch(o, d, tmin, tmax, v0, e1, e2, ex0, ex1, ex2, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"intersect_tris: unsupported device {o.device}")
    return _launch(o, d, tmin, tmax, v0, e1, e2, ex0, ex1, ex2, any_hit)
