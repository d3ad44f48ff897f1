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
where it lies ([N, 3] or [N]); the JAX package's stacking of 26 input rows
into one array is not ported, nor its block knob AKR_PSHADE_BLOCK or the
id-keyed bake cache (_BAKES, for jit traces).

Routing (integrators/common.py): AKR_PALLAS_SHADE other than "0", with a
bake, NEE on, force_diffuse off, RGB transport.
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from ..accel.nvcc import CSRC, compile_library
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


def fused_shade_torch(bake, t, b, n, ng, wo, ls_wi, ls_li, ls_pdf, u_bsdf, mat):
    """The plain version of K9. bake = (table [M, MAT_COLS], has_spec,
    has_metal); t, b, n (the shading frame), ng, wo, ls_wi, ls_li, u_bsdf
    [N, 3]; ls_pdf [N]; mat [N] material ids. Returns dict(direct, wi, f
    [N, 3], pdf [N], valid [N] bool, albedo [N, 3])."""
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
        lib.akr_fused_shade.argtypes = [vp, ci, ci, ci] + [vp] * 10 + [vp] * 6 + [ci, vp]
        lib.akr_fused_shade.restype = ci
        _lib = lib
        return lib


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def fused_shade(bake, t, b, n, ng, wo, ls_wi, ls_li, ls_pdf, u_bsdf, mat):
    """K9 (replaces akari_render_tpu/integrators/pallas_shade.py::_kernel,
    via _run): the arguments and result of fused_shade_torch."""
    global launches
    dev = t.device
    if dev.type == "cpu":
        return fused_shade_torch(bake, t, b, n, ng, wo, ls_wi, ls_li, ls_pdf, u_bsdf, mat)
    if dev.type != "cuda":
        raise ValueError(f"fused_shade: unsupported device {dev}")
    tab, has_spec, has_metal = bake
    N = t.shape[0]
    M = tab.shape[0]

    def f32(name, x, shape):
        if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"fused_shade: {name} must be float32 {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        return x.contiguous()

    tab = f32("table", tab, (M, MAT_COLS))
    vecs = [f32(k, x, (N, 3)) for k, x in (("t", t), ("b", b), ("n", n), ("ng", ng), ("wo", wo),
                                           ("ls_wi", ls_wi), ("ls_li", ls_li), ("u_bsdf", u_bsdf))]
    ls_pdf = f32("ls_pdf", ls_pdf, (N,))
    if mat.device != dev or tuple(mat.shape) != (N,):
        raise ValueError("fused_shade: mat must be [N] on the lanes' device")
    mat = mat.to(torch.int32).contiguous()
    out = {k: torch.empty(s, dtype=dt, device=dev) for k, s, dt in (
        ("direct", (N, 3), torch.float32), ("wi", (N, 3), torch.float32),
        ("f", (N, 3), torch.float32), ("pdf", (N,), torch.float32),
        ("valid", (N,), torch.bool), ("albedo", (N, 3), torch.float32))}
    if N == 0:
        return out
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.akr_fused_shade(
            _ptr(tab), M, int(bool(has_spec)), int(bool(has_metal)),
            *(_ptr(x) for x in vecs[:7]), _ptr(ls_pdf), _ptr(vecs[7]), _ptr(mat),
            _ptr(out["direct"]), _ptr(out["wi"]), _ptr(out["f"]), _ptr(out["pdf"]),
            _ptr(out["valid"]), _ptr(out["albedo"]), N, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fused shade kernel launch failed: CUDA error {err}")
    launches += 1
    return out
