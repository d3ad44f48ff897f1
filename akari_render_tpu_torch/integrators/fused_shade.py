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

Two more entries of the same closure serve GPT's reconnection shift
(integrators/gpt_reconnect.py), which reads what K9 does not return:
`fused_shade(..., roughness=True)` (K9r) returns the roughness of the lobe
that the sample picked (the bake's column _MT_ROUGH, else 1) in place of
the albedo, and `fused_eval` (K9e) evaluates the closure at given
directions (one or two a launch: f and pdf each, the leak check
included), the connection's and V's. Each is one masked launch over the
wavefront, as K9, with its plain version (`fused_shade_torch(...,
roughness=True)`, `fused_eval_torch`) built from svm/reduced.py's
helpers; the JAX package has no counterpart (its reconnection shift
shades through the dispatch).

Routing (integrators/common.py::uses_fused_shade): a bake, NEE with a
light, force_diffuse off, RGB transport, and the switch of
`fused_shade_enabled`, which adapts to the lanes' device: on the card K9 is
the default (AKR_PALLAS_SHADE=0 takes the per-kind dispatch instead), on
the CPU it is opt-in (AKR_PALLAS_SHADE other than "0"), the JAX package's
default off. The JAX package keeps K9 off by default for a TPU tool limit
alone (its relay's compile helper ran out of memory on the Pallas kernel
inside the bounce loop), which has no counterpart on the card. No measured
workload runs on the CPU, and none there prefers the dispatch for speed:
the CPU keeps the dispatch as its default only because the CPU's tests of
the default route hold it against the JAX package's default render, which
is the dispatch. K9's plain version, the math of the card's route, is held
on the CPU by the tests that set the switch (tests/test_torch_fused_shade.py:
against JAX's pallas_shade and the port's dispatch on blinds, metal and
cbox, and rendered against JAX's routed render).
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from ..accel.nvcc import CSRC, compile_library, read_kernel_info
from ..svm.reduced import MAT_COLS, reduced_eval, reduced_shade

SOURCE = CSRC / "fused_shade.cu"

# kernel launches since the last reset (the main path's counts are read by
# chip_smoke.py); only the kernel branches of the wrappers add to them: K9
# (fused_shade), its roughness entry (fused_shade with roughness) and its
# evaluation entry (fused_eval)
launches = 0
rough_launches = 0
eval_launches = 0
# seconds the last build took (0.0 when the library came from the cache)
build_seconds = 0.0

_lib = None
_lib_lock = threading.Lock()


def fused_shade_enabled(device) -> bool:
    """The switch AKR_PALLAS_SHADE (read at every call) for lanes on
    `device`: on a CUDA device on unless it is "0", elsewhere (the CPU) on
    only when it is set to anything other than "0"."""
    v = os.environ.get("AKR_PALLAS_SHADE")
    if torch.device(device).type == "cuda":
        return v != "0"
    return v is not None and v != "0"


def _split(x):
    return x[:, 0], x[:, 1], x[:, 2]


def _scatter_live(fn, live, args):
    """fn(*args) on the rows where `live` is True (by index: a dead lane's
    inputs, which may hold NaN, enter no arithmetic), each output scattered
    back with zeros on the other lanes, as from dispatch_shade."""
    rows = torch.nonzero(live).squeeze(1)
    res = fn(*(x[rows] for x in args))

    def back(v):
        out = torch.zeros((live.shape[0],) + v.shape[1:], dtype=v.dtype, device=v.device)
        out[rows] = v
        return out

    return {k: back(v) for k, v in res.items()} if isinstance(res, dict) else \
        [tuple(back(v) for v in pair) for pair in res]


def fused_shade_torch(bake, t, b, n, ng, wo, ls_wi, ls_li, ls_pdf, u_bsdf, mat, live=None,
                      roughness=False):
    """The plain version of K9. bake = (table [M, MAT_COLS], has_spec,
    has_metal); t, b, n (the shading frame), ng, wo, ls_wi, ls_li, u_bsdf
    [N, 3]; ls_pdf [N]; mat [N] material ids; live [N] bool or None (every
    lane). Returns dict(direct, wi, f [N, 3], pdf [N], valid [N] bool,
    albedo [N, 3]); with `roughness`, roughness [N] (the lobe's that the
    sample picked) in place of albedo: the plain version of K9's
    roughness entry. With `live`, the lanes it selects are shaded (by
    index: a dead lane's inputs, which may hold NaN, enter no arithmetic)
    and the others get zeros, as from dispatch_shade."""
    if live is not None:
        return _scatter_live(
            lambda *a: fused_shade_torch(bake, *a, roughness=roughness), live,
            (t, b, n, ng, wo, ls_wi, ls_li, ls_pdf, u_bsdf, mat))
    tab, has_spec, has_metal = bake
    sh = reduced_shade(tab[mat.long()], has_spec, has_metal, (_split(t), _split(b), _split(n)),
                       _split(ng), _split(wo), _split(ls_wi), _split(ls_li), ls_pdf,
                       u_bsdf[:, 0], u_bsdf[:, 1], u_bsdf[:, 2], albedo=not roughness,
                       roughness=roughness)
    return {k: torch.stack(v, -1) if isinstance(v, tuple) else v for k, v in sh.items()}


def fused_eval_torch(bake, t, b, n, ng, wo, wis, mat, live=None):
    """The plain version of K9's evaluation entry: the closure evaluated
    (SurfaceClosure.evaluate, leak check included) at `wo` and each
    direction of `wis` (one or two [N, 3]), the rest as fused_shade_torch.
    Returns [(f [N, 3], pdf [N])], one pair a direction."""
    if live is not None:
        return _scatter_live(lambda *a: fused_eval_torch(bake, *a[:5], a[5:-1], a[-1]), live,
                             (t, b, n, ng, wo, *wis, mat))
    tab, has_spec, has_metal = bake
    res = reduced_eval(tab[mat.long()], has_spec, has_metal, (_split(t), _split(b), _split(n)),
                       _split(ng), _split(wo), [_split(w) for w in wis])
    return [(torch.stack(f, -1), pdf) for f, pdf in res]


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
        lib.akr_fused_shade_rough.argtypes = [vp, ci, ci, ci] + [vp] * 9 + [ci, vp]
        lib.akr_fused_shade_rough.restype = ci
        lib.akr_fused_eval.argtypes = [vp, ci, ci, ci] + [vp] * 6 + [ci, ci, vp]
        lib.akr_fused_eval.restype = ci
        for name in ("akr_fused_shade_kernel_info", "akr_fused_shade_rough_kernel_info",
                     "akr_fused_eval_kernel_info"):
            getattr(lib, name).argtypes = [vp, ci, ci, ci]
            getattr(lib, name).restype = ci
        _lib = lib
        return lib


def kernel_info(bake) -> dict:
    """K9's resources on the current card for a Scene.shade_bake (its
    material table sets the shared memory, its flags the lobes;
    nvcc.read_kernel_info)."""
    tab, has_spec, has_metal = bake
    return read_kernel_info(build().akr_fused_shade_kernel_info, ("K9",), tab.shape[0],
                            int(bool(has_spec)), int(bool(has_metal)))


def entries_info(bake) -> dict:
    """The same for K9's roughness entry (K9r) and its evaluation entry at
    two directions (K9e), the launches of GPT's reconnection shift."""
    tab, has_spec, has_metal = bake
    lib, flags = build(), (int(bool(has_spec)), int(bool(has_metal)))
    return {**read_kernel_info(lib.akr_fused_shade_rough_kernel_info, ("K9r",), tab.shape[0],
                               *flags),
            **read_kernel_info(lib.akr_fused_eval_kernel_info, ("K9e",), 2, *flags)}


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


class _Lanes:
    """The checks of a kernel call's per-lane arguments: every tensor on
    the lanes' device, N rows, float32 but mat (int32) and live (bool)."""

    def __init__(self, name: str, dev, N: int):
        self.name, self.dev, self.N = name, dev, N

    def f32(self, what, x, shape):
        if x.device != self.dev or x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{self.name}: {what} must be float32 {shape} on {self.dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        return x

    def rows3(self, what, x):
        """[N, 3] with inner stride 1: the kernels take its row stride."""
        x = self.f32(what, x, (self.N, 3))
        return x if x.stride(1) == 1 and x.stride(0) >= 3 else x.contiguous()

    def mat(self, mat):
        if mat.device != self.dev or tuple(mat.shape) != (self.N,):
            raise ValueError(f"{self.name}: mat must be [N] on the lanes' device")
        return mat.to(torch.int32).contiguous()  # the scenes store int32: no copy

    def live(self, live):
        if live is None:
            return ctypes.c_void_p(0)
        if live.device != self.dev or live.dtype != torch.bool or tuple(live.shape) != (self.N,):
            raise ValueError(f"{self.name}: live must be bool [N] on the lanes' device")
        return _ptr(live.contiguous())

    def table(self, tab):
        return self.f32("table", tab, (tab.shape[0], MAT_COLS)).contiguous()

    def empty(self, *shape, dtype=torch.float32):
        return torch.empty((self.N,) + shape, dtype=dtype, device=self.dev)


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def fused_shade(bake, t, b, n, ng, wo, ls_wi, ls_li, ls_pdf, u_bsdf, mat, live=None,
                roughness=False):
    """K9 (replaces akari_render_tpu/integrators/pallas_shade.py::_kernel,
    via _run): the arguments and result of fused_shade_torch. On the card
    one launch reads every input where it lies: [N, 3] rows with any row
    stride (inner stride 1: a strided view such as the flat tier's ng is
    not copied), and writes every lane, zeros where `live` is False. With
    `roughness`, K9's roughness entry (K9r, counted in rough_launches)
    returns the roughness in place of the albedo."""
    global launches, rough_launches
    dev = t.device
    if dev.type == "cpu":
        return fused_shade_torch(bake, t, b, n, ng, wo, ls_wi, ls_li, ls_pdf, u_bsdf, mat, live,
                                 roughness)
    if dev.type != "cuda":
        raise ValueError(f"fused_shade: unsupported device {dev}")
    tab, has_spec, has_metal = bake
    N = t.shape[0]
    c = _Lanes("fused_shade", dev, N)
    tab = c.table(tab)
    vecs = [c.rows3(k, x) for k, x in (("t", t), ("b", b), ("n", n), ("ng", ng), ("wo", wo),
                                        ("ls_wi", ls_wi), ("ls_li", ls_li), ("u_bsdf", u_bsdf))]
    ls_pdf = c.f32("ls_pdf", ls_pdf, (N,)).contiguous()
    mat, live_p = c.mat(mat), c.live(live)
    last = "roughness" if roughness else "albedo"
    out = {"direct": c.empty(3), "wi": c.empty(3), "f": c.empty(3), "pdf": c.empty(),
           "valid": c.empty(dtype=torch.bool),
           last: c.empty() if roughness else c.empty(3)}
    if N == 0:
        return out
    lib = build()
    in3 = (ctypes.c_void_p * 8)(*(x.data_ptr() for x in vecs))
    strides = (ctypes.c_int64 * 8)(*(x.stride(0) for x in vecs))
    with torch.cuda.device(dev):
        if roughness:
            out3 = (ctypes.c_void_p * 3)(*(out[k].data_ptr() for k in ("direct", "wi", "f")))
            err = lib.akr_fused_shade_rough(
                _ptr(tab), tab.shape[0], int(bool(has_spec)), int(bool(has_metal)), in3,
                strides, _ptr(ls_pdf), _ptr(mat), live_p, out3, _ptr(out["pdf"]),
                _ptr(out["valid"]), _ptr(out["roughness"]), N, _stream(dev))
        else:
            out3 = (ctypes.c_void_p * 4)(*(out[k].data_ptr() for k in ("direct", "wi", "f",
                                                                       "albedo")))
            err = lib.akr_fused_shade(
                _ptr(tab), tab.shape[0], int(bool(has_spec)), int(bool(has_metal)), in3,
                strides, _ptr(ls_pdf), _ptr(mat), live_p, out3, _ptr(out["pdf"]),
                _ptr(out["valid"]), N, _stream(dev))
    _launched(err, "fused shade kernel")
    if roughness:
        rough_launches += 1
    else:
        launches += 1
    return out


def fused_eval(bake, t, b, n, ng, wo, wis, mat, live=None):
    """K9's evaluation entry (K9e, counted in eval_launches): the arguments
    and result of fused_eval_torch, one or two directions, in one launch
    over the wavefront, zeros where `live` is False."""
    global eval_launches
    dev = t.device
    if dev.type == "cpu":
        return fused_eval_torch(bake, t, b, n, ng, wo, wis, mat, live)
    if dev.type != "cuda":
        raise ValueError(f"fused_eval: unsupported device {dev}")
    if len(wis) not in (1, 2):
        raise ValueError(f"fused_eval: one or two directions, got {len(wis)}")
    tab, has_spec, has_metal = bake
    N = t.shape[0]
    c = _Lanes("fused_eval", dev, N)
    tab = c.table(tab)
    vecs = [c.rows3(k, x) for k, x in (("t", t), ("b", b), ("n", n), ("ng", ng), ("wo", wo),
                                        *((f"wi{d}", w) for d, w in enumerate(wis)))]
    mat, live_p = c.mat(mat), c.live(live)
    out = [(c.empty(3), c.empty()) for _ in wis]
    if N == 0:
        return out
    lib = build()
    k = len(vecs)
    in3 = (ctypes.c_void_p * k)(*(x.data_ptr() for x in vecs))
    strides = (ctypes.c_int64 * k)(*(x.stride(0) for x in vecs))
    f_out = (ctypes.c_void_p * len(wis))(*(f.data_ptr() for f, _ in out))
    pdf_out = (ctypes.c_void_p * len(wis))(*(p.data_ptr() for _, p in out))
    with torch.cuda.device(dev):
        err = lib.akr_fused_eval(_ptr(tab), tab.shape[0], int(bool(has_spec)),
                                 int(bool(has_metal)), in3, strides, _ptr(mat), live_p, f_out,
                                 pdf_out, len(wis), N, _stream(dev))
    _launched(err, "fused evaluation kernel")
    eval_launches += 1
    return out
