"""K8, the path megakernel: whole paths in one CUDA kernel (port of
akari_render_tpu/integrators/megakernel.py).

One thread per pixel carries its paths through camera generation, every
bounce, next-event estimation and film accumulation, for all samples of a
pass, with the scene's tables in shared memory (csrc/megakernel.cu). It is
the reference renderer's own CUDA design (pt.rs:1075-1103). The kernel
regenerates paths: a lane whose path ends starts its next sample in the
next iteration of one loop, so a warp runs as long as its busiest lane's
pass, not as its longest path of each sample; the samples of a pixel are
still taken and summed in order, so the result is the plain version's.

Scope, as in the JAX package (`megakernel_eligible`): flat-tier scenes of at
most 512 triangles, constant emission, at least one light, NEE on, the
independent sampler, a box or Gaussian filter, and shading that bakes into
the reduced principled closure (svm/reduced.py, shared with K9) or
force_diffuse.

This module holds eligibility, the light tables and the pass; the helpers
work on [N] tensors, one per vector component, in the JAX kernel's op
order, and `megakernel_pass_torch` is the kernel's per-lane math
vectorised over lanes with an eager bounce loop.

Samples come from the stateless hash stream of the JAX kernel (key from
sample index and pixel, counter per draw: camera 2, then per bounce light
3, BSDF 3, RR 1), in int64 holding the uint32 arithmetic, bit-exact with
JAX; its two functions are the hash sampler's (core/samplers.py:
hash_u64, hash_draw).

Not ported (TPU-only): the relay-watchdog pass sizing
(AKR_MAX_PASS_SECONDS, AKR_ADAPTIVE_PASS), the block knob AKR_MK_BLOCK,
AKR_MEGAKERNEL_INTERPRET (a CPU tensor takes the plain version), the
one-hot MXU table fetches (plain indexed loads here), the Python-unrolled
MT_CHUNK triangle sweep (a plain loop over the triangles; ties go to the
first slot with a strict `<`) and the _RUNS trace cache.
"""
from __future__ import annotations

import ctypes
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..accel.nvcc import CSRC, compile_library, read_kernel_info
from ..core.samplers import GOLDEN, hash_u64
from ..core.samplers import hash_draw as draw
from ..svm.reduced import (
    MAT_COLS, TWO_PI_F, dot3, force_diffuse_table, normalize3, reduced_shade,
)

RAY_TMAX = 1e20
MASK32 = 0xFFFFFFFF
MAX_TRIS = 512
# lanes per plain-version sweep chunk: bounds its [T, lanes] temporaries
SWEEP_ELEMS = 1 << 22

# offset_ray_origin constants (core/math.py)
_ORIGIN = 1.0 / 32.0
_FLOAT_SCALE = 1.0 / 65536.0
_INT_SCALE = 256.0

# kernel launches since the last reset (the main path's count is read by
# chip_smoke.py); only the kernel branch of megakernel_pass adds to it
launches = 0
# seconds the last build took (0.0 when the library came from the cache)
build_seconds = 0.0

SOURCE = CSRC / "megakernel.cu"
_lib = None
_lib_lock = threading.Lock()


# ------------------------------------------------ the path's own helpers
def onb(nx, ny, nz):
    """orthonormal_basis (core/math.py), component-wise: (t, b)."""
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = (1.0 + sign * nx * nx * a, sign * b, -sign * nx)
    return t, (b, sign + ny * ny * a, -ny)


def offset_ray_origin1(p, n):
    """core/math.py offset_ray_origin for one component."""
    of_i = (_INT_SCALE * n).to(torch.int32)
    ip = p.contiguous().view(torch.int32)
    p_i = (ip + torch.where(p < 0.0, -of_i, of_i)).view(torch.float32)
    return torch.where(torch.abs(p) < _ORIGIN, p + _FLOAT_SCALE * n, p_i)


def megakernel_eligible(scene, settings, sampler_config, filt) -> bool:
    """The JAX package's static predicate for the megakernel's scope."""
    from ..core.filters import BoxFilter, GaussianFilter

    a = scene.arrays
    if a.bvh is not None or a.instanced is not None or a.unified is not None:
        return False
    if scene.num_tris == 0 or scene.num_tris > MAX_TRIS:
        return False
    if scene.has_alpha or a.const_emission is None or a.lights.num_lights < 1:
        return False
    if not isinstance(filt, (BoxFilter, GaussianFilter)):
        return False
    if (sampler_config or {}).get("type", "independent") != "independent":
        return False
    if settings.indirect_only or not settings.use_nee:
        return False
    return settings.force_diffuse or scene.shade_bake is not None


def light_tables(lights):
    """The packed light alias tables: lsel [3, L] (prob, alias, pdf), loff
    [2, L] (offset, count) and ltab [4, S] (prob, alias, pdf, triangle),
    float32 (ids are exact below 2^24)."""
    f = torch.float32
    lsel = torch.stack([lights.sel_prob, lights.sel_alias.to(f), lights.sel_pdf])
    loff = torch.stack([lights.offset.to(f), lights.count.to(f)])
    ltab = torch.stack([lights.tri_prob, lights.tri_alias.to(f), lights.tri_pdf,
                        lights.tri_ids.to(f)])
    return lsel.contiguous(), loff.contiguous(), ltab.contiguous()


# ------------------------------------------------------------- one pass
class PassTables(NamedTuple):
    """What one megakernel pass reads: device tables and static settings."""

    attr: torch.Tensor  # [T, 41]
    ce: torch.Tensor  # [M, 3] constant emission
    lsel: torch.Tensor  # [3, L]
    loff: torch.Tensor  # [2, L]
    ltab: torch.Tensor  # [4, S]
    mat: torch.Tensor  # [M, MAT_COLS]
    cam: torch.Tensor  # [24]: r2c rows 0-2 (12), c2w 3x3 (9), camera origin (3)
    width: int
    npix: int
    max_depth: int
    rr_depth: int
    clamp_indirect: float
    gaussian: bool
    filter_radius: float
    scramble: int  # (seed * 0x9E3779B9) & 0xFFFFFFFF
    has_spec: bool
    has_metal: bool


def pass_tables(scene, settings, filt, seed: int) -> PassTables:
    """Assemble the tables of an eligible scene (megakernel_eligible)."""
    from ..core.filters import GaussianFilter

    a = scene.arrays
    M = int(a.const_emission.shape[0])
    if settings.force_diffuse:
        tab, has_spec, has_metal = force_diffuse_table(M, scene.device), False, False
    else:
        tab, has_spec, has_metal = scene.shade_bake
    lsel, loff, ltab = light_tables(a.lights)
    cam = scene.camera
    c2w = cam.c2w.to(torch.float32)
    cam_vec = torch.cat([cam.r2c[:3, :].reshape(-1), c2w[:3, :3].reshape(-1), c2w[:3, 3]])
    return PassTables(
        attr=a.attr.contiguous(), ce=a.const_emission.contiguous(), lsel=lsel, loff=loff,
        ltab=ltab, mat=tab.contiguous(), cam=cam_vec.to(torch.float32).contiguous(),
        width=cam.width, npix=cam.width * cam.height, max_depth=settings.max_depth,
        rr_depth=settings.rr_depth, clamp_indirect=float(settings.clamp_indirect),
        gaussian=isinstance(filt, GaussianFilter), filter_radius=float(filt.radius),
        scramble=(seed * GOLDEN) & MASK32, has_spec=has_spec, has_metal=has_metal,
    )


def _mt_sweep(attr, ox, oy, oz, dx, dy, dz, tmax, ex0, ex1, any_hit: bool):
    """Möller-Trumbore of every lane against every triangle (tmin 0): the
    closest hit (t, tri or -1, b0, b1; ties to the first triangle) or the
    any-hit flag. Chunked over lanes."""
    T = attr.shape[0]
    n = ox.shape[0]
    step = max(1, SWEEP_ELEMS // max(T, 1))
    if n > step:
        parts = [_mt_sweep(attr, *(x[s:s + step] for x in (ox, oy, oz, dx, dy, dz, tmax, ex0, ex1)),
                           any_hit) for s in range(0, n, step)]
        if any_hit:
            return torch.cat(parts)
        return tuple(torch.cat(p) for p in zip(*parts))
    col = [attr[:, i:i + 1] for i in range(9)]
    a_x, a_y, a_z, e1x, e1y, e1z, e2x, e2y, e2z = col
    wdx, wdy, wdz = dx[None, :], dy[None, :], dz[None, :]
    px = wdy * e2z - wdz * e2y
    py = wdz * e2x - wdx * e2z
    pz = wdx * e2y - wdy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok_det = torch.abs(det) > 1e-12
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    tx = ox[None, :] - a_x
    ty = oy[None, :] - a_y
    tz = oz[None, :] - a_z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (qx * wdx + qy * wdy + qz * wdz) * inv_det
    t = (qx * e2x + qy * e2y + qz * e2z) * inv_det
    rows = torch.arange(T, device=attr.device)[:, None]
    hit = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0) & (t < tmax[None, :])
           & (rows != ex0[None, :]) & (rows != ex1[None, :]))
    if any_hit:
        return torch.any(hit, dim=0)
    t_m = torch.where(hit, t, RAY_TMAX)
    t_min = torch.amin(t_m, dim=0)
    first = torch.amin(torch.where(t_m == t_min[None, :], rows, T), dim=0, keepdim=True)
    got = t_min < RAY_TMAX
    first = torch.clamp(first, max=T - 1)
    b0 = torch.gather(u, 0, first)[0]
    b1 = torch.gather(v, 0, first)[0]
    return (torch.where(got, t_min, RAY_TMAX), torch.where(got, first[0], -1).to(torch.int64),
            torch.where(got, b0, 0.0), torch.where(got, b1, 0.0), got)


def _fetch_si(attr, tri, b0, b1):
    """Attribute row -> p, ng, ns (normalised), area, mat, light_id,
    prim_pdf; tri -1 reads row 0."""
    r = attr[torch.clamp(tri, min=0)]
    w0 = 1.0 - b0 - b1
    p = tuple(r[:, c] + r[:, 3 + c] * b0 + r[:, 6 + c] * b1 for c in range(3))
    ng = (r[:, 9], r[:, 10], r[:, 11])
    ns = normalize3(*(w0 * r[:, 13 + c] + b0 * r[:, 16 + c] + b1 * r[:, 19 + c] for c in range(3)))
    return (p, ng, ns, r[:, 12], r[:, 38].to(torch.int64), r[:, 39].to(torch.int64), r[:, 40])


def _warp_max(x):
    """Each warp's (32 consecutive pixels, as the kernel's blocks of 128
    threads hold them) largest entry of x [npix]."""
    pad = -x.shape[0] % 32
    if pad:
        x = torch.cat([x, torch.zeros(pad, dtype=x.dtype, device=x.device)])
    return x.reshape(-1, 32).amax(dim=1)


def megakernel_pass_torch(tb: PassTables, s0: int, spp: int, rays=None, simt=None):
    """The plain version of K8: `spp` samples of every pixel, starting at
    sample index s0 -> [4, npix] (RGB sums and filter-weight sums). `rays`
    (an int64 [2] tensor, or None) gains the closest-hit and shadow rays
    traced, the count the kernel's FP32 bound is computed from. `simt` (an
    int64 [5] tensor, or None) gains what the kernel's SIMT counters count,
    from each path's closest-hit rays (its loop iterations): the iterations
    the kernel's warps run (each warp's busiest lane's sum over samples), the
    iterations their lanes use, and the iterations the warps would run with
    the samples in lockstep (the sum over samples of a warp's longest path);
    simt[3] and simt[4] take the most one warp runs in either schedule."""
    dev = tb.attr.device
    npix = tb.npix
    cam = [float(x) for x in tb.cam.cpu().tolist()]
    r2c, c2w, cam_o = cam[0:12], cam[12:21], cam[21:24]
    pix = torch.arange(npix, dtype=torch.int64, device=dev)
    pix_x = (pix % tb.width).to(torch.float32)
    pix_y = (pix // tb.width).to(torch.float32)
    sigma = float(np.float32(tb.filter_radius / 3.0))
    radius = float(np.float32(tb.filter_radius))
    acc = torch.zeros((4, npix), dtype=torch.float32, device=dev)
    n_rays = torch.zeros(2, dtype=torch.int64, device=dev)
    lane_iters = torch.zeros(npix, dtype=torch.int64, device=dev)
    lockstep = torch.zeros((npix + 31) // 32, dtype=torch.int64, device=dev)  # per warp
    L = tb.lsel.shape[1]
    none = torch.full((npix,), -1, dtype=torch.int64, device=dev)

    def emission(mat):
        e = tb.ce[mat]
        return e[:, 0], e[:, 1], e[:, 2]

    for s in range(spp):
        key = hash_u64((s0 + s) ^ tb.scramble, pix)
        ctr, u0 = draw(key, 0)
        ctr, u1 = draw(key, ctr)
        if tb.gaussian:
            r = torch.sqrt(-2.0 * torch.log(torch.clamp(u0, min=1e-10)))
            th = TWO_PI_F * u1
            offx = torch.clamp(r * torch.cos(th) * sigma, -radius, radius)
            offy = torch.clamp(r * torch.sin(th) * sigma, -radius, radius)
        else:
            offx = (u0 - 0.5) * radius
            offy = (u1 - 0.5) * radius
        fx = pix_x + 0.5 + offx
        fy = pix_y + 0.5 + offy
        cx, cy, cz = normalize3(*(r2c[4 * i] * fx + r2c[4 * i + 1] * fy + r2c[4 * i + 3]
                                  for i in range(3)))
        d = tuple(c2w[3 * i] * cx + c2w[3 * i + 1] * cy + c2w[3 * i + 2] * cz for i in range(3))
        o = tuple(torch.full((npix,), cam_o[i], device=dev) for i in range(3))
        excl = none
        rad = [torch.zeros(npix, device=dev) for _ in range(3)]
        beta = [torch.ones(npix, device=dev) for _ in range(3)]
        base = [torch.zeros(npix, device=dev) for _ in range(3)]
        active = torch.ones(npix, dtype=torch.bool, device=dev)
        prev_pdf = torch.zeros(npix, device=dev)
        path_len = torch.zeros(npix, dtype=torch.int64, device=dev)

        def add_emission(depth, hit, o, d, active):
            t, tri, b0, b1, got = hit
            p, ng, _, area, mat, light_id, prim_pdf = _fetch_si(tb.attr, tri, b0, b1)
            front = dot3(*ng, *d) < 0.0
            ok = active & got & (light_id >= 0) & front
            le = emission(mat)
            choice = torch.where(light_id >= 0, tb.lsel[2][torch.clamp(light_id, min=0)], 0.0)
            wi = [pc - oc for pc, oc in zip(p, o)]
            d2 = wi[0] * wi[0] + wi[1] * wi[1] + wi[2] * wi[2]
            inv = 1.0 / torch.sqrt(torch.clamp(d2, min=1e-30))
            c = torch.abs(dot3(*ng, wi[0] * inv, wi[1] * inv, wi[2] * inv))
            lpdf = prim_pdf / torch.clamp(area, min=1e-20) * d2 / torch.clamp(c, min=1e-6) * choice
            w = (torch.ones_like(lpdf) if depth == 0
                 else prev_pdf / torch.clamp(prev_pdf + lpdf, min=1e-30))
            for i in range(3):
                rad[i] = rad[i] + torch.where(ok, beta[i] * le[i] * w, 0.0)

        def trace(o, d, excl, active):
            if rays is not None:
                n_rays[0] += active.sum()
            path_len.add_(active.to(torch.int64))
            return _mt_sweep(tb.attr, *o, *d, torch.where(active, RAY_TMAX, -1.0), excl, none,
                             False)

        depth = 0
        while depth < tb.max_depth and bool(active.any()):
            hit = trace(o, d, excl, active)
            _, tri, b0, b1, got = hit
            add_emission(depth, hit, o, d, active)
            if depth == 0:
                base = list(rad)
            active = active & got
            p, ng, ns, _, mat, _, _ = _fetch_si(tb.attr, tri, b0, b1)
            wo = (-d[0], -d[1], -d[2])

            # NEE: alias pick of a light, then of its triangle
            ctr, ul0 = draw(key, ctr)
            ctr, ul1 = draw(key, ctr)
            ctr, ul2 = draw(key, ctr)
            scaled = ul0 * float(L)
            li0 = torch.clamp(scaled.to(torch.int64), 0, L - 1)
            frac = scaled - li0.to(torch.float32)
            p_own = tb.lsel[0][li0]
            take = frac < p_own
            light = torch.where(take, li0, tb.lsel[1][li0].to(torch.int64))
            u_rem = torch.where(take, frac / torch.clamp(p_own, min=1e-20),
                                (frac - p_own) / torch.clamp(1.0 - p_own, min=1e-20))
            choice_pdf = tb.lsel[2][light]
            lbase = tb.loff[0][light].to(torch.int64)
            cnt = tb.loff[1][light].to(torch.int64)
            scaled2 = torch.clamp(u_rem, 0.0, 0.9999999) * cnt.to(torch.float32)
            i2 = torch.minimum(torch.clamp(scaled2.to(torch.int64), min=0), cnt - 1)
            frac2 = scaled2 - i2.to(torch.float32)
            take2 = frac2 < tb.ltab[0][lbase + i2]
            local = torch.where(take2, i2, tb.ltab[1][lbase + i2].to(torch.int64))
            lprim_pdf = tb.ltab[2][lbase + local]
            ltri = tb.ltab[3][lbase + local].to(torch.int64)
            lt = ul1 < ul2
            lb0 = torch.where(lt, ul1 * 0.5, ul1 - ul2 * 0.5)
            lb1 = torch.where(lt, ul2 - ul1 * 0.5, ul2 * 0.5)
            lp, lng, _, larea, lmat, _, _ = _fetch_si(tb.attr, ltri, lb0, lb1)
            wi = [a - b for a, b in zip(lp, p)]
            d2 = wi[0] * wi[0] + wi[1] * wi[1] + wi[2] * wi[2]
            dist = torch.sqrt(torch.clamp(d2, min=1e-30))
            wi = tuple(w / dist for w in wi)
            front_l = dot3(*wi, *lng) < 0.0
            li = tuple(torch.where(front_l, e, 0.0) for e in emission(lmat))
            cos_l = torch.abs(dot3(*lng, *wi))
            ls_pdf = lprim_pdf / torch.clamp(larea, min=1e-20) * d2 / torch.clamp(cos_l, min=1e-20) * choice_pdf
            light_valid = active & torch.isfinite(ls_pdf) & (d2 > 0.0)

            # shade: the reduced closure in the ONB(ns) frame
            ctr, ub0 = draw(key, ctr)
            ctr, ub1 = draw(key, ctr)
            ctr, ub2 = draw(key, ctr)
            t_, b_ = onb(*ns)
            sh = reduced_shade(tb.mat[mat], tb.has_spec, tb.has_metal, (t_, b_, ns), ng, wo, wi,
                               li, ls_pdf, ub0, ub1, ub2)

            # shadow ray, excluding the hit and the light triangle
            back = dot3(*ng, *wi) < 0.0
            sro = tuple(offset_ray_origin1(pc, torch.where(back, -nc, nc)) for pc, nc in zip(p, ng))
            sh_tmax = torch.where(light_valid, dist * 0.999, -1.0)
            if rays is not None:
                n_rays[1] += light_valid.sum()
            occ = _mt_sweep(tb.attr, *sro, *wi, sh_tmax, tri, ltri, True)
            direct_ok = light_valid & ~occ
            for i in range(3):
                rad[i] = rad[i] + torch.where(direct_ok, beta[i] * sh["direct"][i], 0.0)

            # continue, then Russian roulette
            active = active & sh["valid"]
            thr = torch.where(active, 1.0 / torch.clamp(sh["pdf"], min=1e-20), 0.0)
            beta = [b * torch.where(active, f * thr, 1.0) for b, f in zip(beta, sh["f"])]
            ctr, urr = draw(key, ctr)
            bmax = torch.maximum(beta[0], torch.maximum(beta[1], beta[2]))
            if depth + 1 > tb.rr_depth:
                cont = torch.clamp(bmax, 0.0, 1.0) * 0.95
            else:
                cont = torch.ones_like(bmax)
            active = active & (urr < cont)
            inv_c = 1.0 / torch.clamp(cont, min=1e-20)
            beta = [b * inv_c for b in beta]
            prev_pdf = sh["pdf"]
            nw = sh["wi"]
            back = dot3(*ng, *nw) < 0.0
            o = tuple(offset_ray_origin1(pc, torch.where(back, -nc, nc)) for pc, nc in zip(p, ng))
            d = nw
            excl = tri
            depth += 1

        # the final emission tap
        if bool(active.any()):
            add_emission(tb.max_depth, trace(o, d, excl, active), o, d, active)
        for i in range(3):
            v = rad[i]
            if tb.clamp_indirect > 0.0:
                v = base[i] + torch.clamp(v - base[i], max=tb.clamp_indirect)
            acc[i] += torch.where(torch.isfinite(v), v, 0.0)
        acc[3] += 1.0
        lane_iters += path_len
        lockstep += _warp_max(path_len)
    if rays is not None:
        rays += n_rays
    if simt is not None:
        ran = _warp_max(lane_iters)
        simt[:3] += torch.stack([ran.sum(), lane_iters.sum(), lockstep.sum()])
        simt[3:] = torch.maximum(simt[3:], torch.stack([ran.max(), lockstep.max()]))
    return acc


# ------------------------------------------------------------ the kernel
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the K8 library."""
    global _lib, build_seconds
    with _lib_lock:
        if _lib is not None:
            return _lib
        so, secs = compile_library(SOURCE, "megakernel")
        if secs:
            build_seconds = secs
        lib = ctypes.CDLL(str(so))
        vp, ci, cf, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
        lib.akr_megakernel.argtypes = (
            [vp, ci, vp, ci, vp, vp, ci, vp, ci, vp, vp]  # tables, camera
            + [ci, ci, ci, ci, cu]  # width, npix, s0, spp, scramble
            + [ci, ci, cf, ci, cf, cf, ci, ci]  # depth, rr, clamp, gauss, radius, sigma, spec, metal
            + [vp, vp, vp, vp])  # out, rays, simt, stream
        lib.akr_megakernel.restype = ci
        lib.akr_megakernel_kernel_info.argtypes = [vp] + [ci] * 6
        lib.akr_megakernel_kernel_info.restype = ci
        _lib = lib
        return lib


def kernel_info(tb: PassTables) -> dict:
    """K8's resources on the current card at the tables of a pass (their
    sizes set its shared memory) and its lobes (nvcc.read_kernel_info)."""
    return read_kernel_info(build().akr_megakernel_kernel_info, ("K8",), tb.attr.shape[0],
                            tb.ce.shape[0], tb.lsel.shape[1], tb.ltab.shape[1], int(tb.has_spec),
                            int(tb.has_metal))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else ctypes.c_void_p(0)


def megakernel_pass(tb: PassTables, s0: int, spp: int, rays=None, simt=None):
    """K8 (replaces akari_render_tpu/integrators/megakernel.py::kernel, via
    run_pass): one pass of `spp` samples per pixel -> [4, npix]. CPU tables
    take the plain version; CUDA tables launch the kernel or raise. rays
    and simt as megakernel_pass_torch takes them (the kernel counts simt
    itself, as it runs)."""
    global launches
    dev = tb.attr.device
    if dev.type == "cpu":
        return megakernel_pass_torch(tb, s0, spp, rays, simt)
    if dev.type != "cuda":
        raise ValueError(f"megakernel_pass: unsupported device {dev}")
    T, M, L, S = tb.attr.shape[0], tb.ce.shape[0], tb.lsel.shape[1], tb.ltab.shape[1]
    for name, x, shape in (("attr", tb.attr, (T, 41)), ("ce", tb.ce, (M, 3)),
                           ("lsel", tb.lsel, (3, L)), ("loff", tb.loff, (2, L)),
                           ("ltab", tb.ltab, (4, S)), ("mat", tb.mat, (M, MAT_COLS)),
                           ("cam", tb.cam, (24,))):
        if (x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(f"megakernel_pass: {name} must be contiguous float32 {shape} on {dev}")
    if T > MAX_TRIS or L < 1:
        raise ValueError("megakernel_pass: needs 1 to 512 triangles and a light")
    for name, x, n in (("rays", rays, 2), ("simt", simt, 5)):
        if x is not None and (x.device != dev or x.dtype != torch.int64 or x.numel() != n
                              or not x.is_contiguous()):
            raise ValueError(f"megakernel_pass: {name} must be a contiguous int64 [{n}] tensor "
                             "on the device")
    out = torch.empty((4, tb.npix), dtype=torch.float32, device=dev)
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.akr_megakernel(
            _ptr(tb.attr), T, _ptr(tb.ce), M, _ptr(tb.lsel), _ptr(tb.loff), L, _ptr(tb.ltab), S,
            _ptr(tb.mat), _ptr(tb.cam), tb.width, tb.npix, s0, spp, tb.scramble,
            tb.max_depth, tb.rr_depth, tb.clamp_indirect, int(tb.gaussian),
            float(np.float32(tb.filter_radius)), float(np.float32(tb.filter_radius / 3.0)),
            int(tb.has_spec), int(tb.has_metal), _ptr(out), _ptr(rays), _ptr(simt),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    launches += 1
    return out


# ---------------------------------------------------------------- render
def render_pt_megakernel(scene, config, task=None, progress_cb=None, session=None):
    """Megakernel render of an eligible scene (the caller checked
    megakernel_eligible): spp_per_pass samples per launch. Returns (image
    [H, W, 3] numpy, stats dict) like integrators/pt.py::render_pt."""
    from ..core.film import Film, develop
    from ..core.filters import filter_from_config
    from ..stats import RenderStats
    from .common import PTSettings
    from .pt import _sync

    width, height = scene.camera.width, scene.camera.height
    filt = filter_from_config(task.filter_config if task else None)
    settings = PTSettings(
        max_depth=config.max_depth, rr_depth=config.rr_depth, use_nee=config.use_nee,
        indirect_only=config.indirect_only, force_diffuse=config.force_diffuse,
        clamp_indirect=config.clamp_indirect,
    )
    tb = pass_tables(scene, settings, filt, task.seed if task else 0)
    spp_chunk = min(config.spp, config.spp_per_pass)
    render_stats = RenderStats()
    acc = torch.zeros((4, tb.npix), dtype=torch.float32, device=scene.device)
    stats = {"time": [], "spp": []}
    t0 = time.time()
    done = 0
    while done < config.spp:
        chunk = min(spp_chunk, config.spp - done)
        acc += megakernel_pass(tb, done, chunk)
        done += chunk
        if progress_cb:
            _sync(scene.device)
            stats["time"].append(time.time() - t0)
            stats["spp"].append(done)
            progress_cb(done, config.spp, stats)
    _sync(scene.device)
    stats["total_time"] = time.time() - t0
    stats["spp_total"] = done
    if session is not None:
        render_stats.record(stats["total_time"], stats["spp_total"])
        if session.save_stats:
            render_stats.write(session)
    film = Film(accum=acc[:3].T.contiguous(), weight=acc[3].contiguous())
    img = develop(film, width, height).cpu().numpy().astype(np.float32)
    return img, stats
