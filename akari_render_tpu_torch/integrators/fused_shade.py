"""K9, the fused shade: one bounce's whole shade in one CUDA kernel (port of
akari_render_tpu/integrators/pallas_shade.py).

For scenes whose every kind bakes into the reduced principled closure
(svm/reduced.py::bake_shading, stored on the Scene as `shade_bake` at load), the
kernel (csrc/fused_shade.cu) evaluates the closure at the NEE direction,
samples a direction and evaluates it there, and computes the directional
albedo, per lane, in place of the per-kind closure dispatch. It returns the
sh dict of dispatch_shade: direct, wi, f, pdf, valid and albedo.

`fused_shade` routes by device: CPU tensors take the plain version
(`fused_shade_torch`, the kernel's per-lane math on [N] tensors), CUDA
tensors launch the kernel or raise. The kernel reads each per-lane input
where it lies ([N, 3] or [N]) and, given the live mask, runs over the
whole wavefront in one launch (zeros on the dead lanes), as the TPU kernel
did; the JAX package's stacking of 26 input rows into one array is not
ported, nor its block knob AKR_PSHADE_BLOCK or the id-keyed bake cache
(_BAKES, for jit traces).

Routing (integrators/common.py): AKR_PALLAS_SHADE other than "0", with a
bake, NEE on, force_diffuse off, RGB transport.
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from ..accel.nvcc import CSRC, compile_library, read_kernel_info
from ..svm.reduced import MAT_COLS, reduced_shade

SOURCE = CSRC / "fused_shade.cu"

# kernel launches since the last reset (the main path's count is read by
# chip_smoke.py); only the kernel branch of fused_shade adds to it
launches = 0
# seconds the last build took (0.0 when the library came from the cache)
build_seconds = 0.0

_lib = None
_lib_lock = threading.Lock()


def fused_shade_enabled() -> bool:
    """The JAX package's switch (AKR_PALLAS_SHADE, default off)."""
    return os.environ.get("AKR_PALLAS_SHADE", "0") != "0"


def _split(x):
    return x[:, 0], x[:, 1], x[:, 2]


def fused_shade_torch(bake, t, b, n, ng, wo, ls_wi, ls_li, ls_pdf, u_bsdf, mat, live=None):
    """The plain version of K9. bake = (table [M, MAT_COLS], has_spec,
    has_metal); t, b, n (the shading frame), ng, wo, ls_wi, ls_li, u_bsdf
    [N, 3]; ls_pdf [N]; mat [N] material ids; live [N] bool or None (every
    lane). Returns dict(direct, wi, f [N, 3], pdf [N], valid [N] bool,
    albedo [N, 3]). With `live`, the lanes it selects are shaded (by index:
    a dead lane's inputs, which may hold NaN, enter no arithmetic) and the
    others get zeros, as from dispatch_shade."""
    if live is not None:
        rows = torch.nonzero(live).squeeze(1)
        res = fused_shade_torch(bake, *(x[rows] for x in (t, b, n, ng, wo, ls_wi, ls_li, ls_pdf,
                                                          u_bsdf, mat)))
        out = {}
        for key, v in res.items():
            out[key] = torch.zeros((live.shape[0],) + v.shape[1:], dtype=v.dtype, device=v.device)
            out[key][rows] = v
        return out
    tab, has_spec, has_metal = bake
    sh = reduced_shade(tab[mat.long()], has_spec, has_metal, (_split(t), _split(b), _split(n)),
                       _split(ng), _split(wo), _split(ls_wi), _split(ls_li), ls_pdf,
                       u_bsdf[:, 0], u_bsdf[:, 1], u_bsdf[:, 2], albedo=True)
    return {k: torch.stack(v, -1) if isinstance(v, tuple) else v for k, v in sh.items()}


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the K9 library."""
    global _lib, build_seconds
    with _lib_lock:
        if _lib is not None:
            return _lib
        so, secs = compile_library(SOURCE, "fused_shade")
        if secs:
            build_seconds = secs
        lib = ctypes.CDLL(str(so))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.akr_fused_shade.argtypes = [vp, ci, ci, ci] + [vp] * 8 + [ci, vp]
        lib.akr_fused_shade.restype = ci
        lib.akr_fused_shade_kernel_info.argtypes = [vp, ci, ci, ci]
        lib.akr_fused_shade_kernel_info.restype = ci
        _lib = lib
        return lib


def kernel_info(bake) -> dict:
    """K9's resources on the current card for a Scene.shade_bake (its
    material table sets the shared memory, its flags the lobes;
    nvcc.read_kernel_info)."""
    tab, has_spec, has_metal = bake
    return read_kernel_info(build().akr_fused_shade_kernel_info, ("K9",), tab.shape[0],
                            int(bool(has_spec)), int(bool(has_metal)))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def fused_shade(bake, t, b, n, ng, wo, ls_wi, ls_li, ls_pdf, u_bsdf, mat, live=None):
    """K9 (replaces akari_render_tpu/integrators/pallas_shade.py::_kernel,
    via _run): the arguments and result of fused_shade_torch. On the card
    one launch reads every input where it lies: [N, 3] rows with any row
    stride (inner stride 1: a strided view such as the flat tier's ng is
    not copied), and writes every lane, zeros where `live` is False."""
    global launches
    dev = t.device
    if dev.type == "cpu":
        return fused_shade_torch(bake, t, b, n, ng, wo, ls_wi, ls_li, ls_pdf, u_bsdf, mat, live)
    if dev.type != "cuda":
        raise ValueError(f"fused_shade: unsupported device {dev}")
    tab, has_spec, has_metal = bake
    N = t.shape[0]
    M = tab.shape[0]

    def f32(name, x, shape):
        if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"fused_shade: {name} must be float32 {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        return x

    def rows3(name, x):  # [N, 3] with inner stride 1: the kernel takes its row stride
        x = f32(name, x, (N, 3))
        return x if x.stride(1) == 1 and x.stride(0) >= 3 else x.contiguous()

    tab = f32("table", tab, (M, MAT_COLS)).contiguous()
    vecs = [rows3(k, x) for k, x in (("t", t), ("b", b), ("n", n), ("ng", ng), ("wo", wo),
                                      ("ls_wi", ls_wi), ("ls_li", ls_li), ("u_bsdf", u_bsdf))]
    ls_pdf = f32("ls_pdf", ls_pdf, (N,)).contiguous()
    if mat.device != dev or tuple(mat.shape) != (N,):
        raise ValueError("fused_shade: mat must be [N] on the lanes' device")
    mat = mat.to(torch.int32).contiguous()  # the scenes store int32: no copy
    if live is not None:
        if live.device != dev or live.dtype != torch.bool or tuple(live.shape) != (N,):
            raise ValueError("fused_shade: live must be bool [N] on the lanes' device")
        live = live.contiguous()
    out = {k: torch.empty(s, dtype=dt, device=dev) for k, s, dt in (
        ("direct", (N, 3), torch.float32), ("wi", (N, 3), torch.float32),
        ("f", (N, 3), torch.float32), ("pdf", (N,), torch.float32),
        ("valid", (N,), torch.bool), ("albedo", (N, 3), torch.float32))}
    if N == 0:
        return out
    lib = build()
    in3 = (ctypes.c_void_p * 8)(*(x.data_ptr() for x in vecs))
    strides = (ctypes.c_int64 * 8)(*(x.stride(0) for x in vecs))
    out3 = (ctypes.c_void_p * 4)(*(out[k].data_ptr() for k in ("direct", "wi", "f", "albedo")))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.akr_fused_shade(
            _ptr(tab), M, int(bool(has_spec)), int(bool(has_metal)), in3, strides, _ptr(ls_pdf),
            _ptr(mat), _ptr(live) if live is not None else ctypes.c_void_p(0), out3, _ptr(out["pdf"]),
            _ptr(out["valid"]), N, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fused shade kernel launch failed: CUDA error {err}")
    launches += 1
    return out
