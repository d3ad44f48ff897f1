"""The reduced principled closure shared by the fused tiers (K8, the path
megakernel, and K9, the fused shade): the per-material table layout, the
bake of a scene's kinds into it, and the closure's per-lane math (port of
the host half and the component-wise helpers of
akari_render_tpu/integrators/megakernel.py, which pallas_shade.py imports).

The helpers work on [N] tensors, one per vector component, in the JAX
kernel's op order; csrc/reduced_closure.cuh is the same closure for the
CUDA kernels, op for op.
"""
from __future__ import annotations

import numpy as np
import torch

from .eval import EvalContext, dispatch_closure
from .principled_fused import FusedPrincipled
from .surface import DiffuseBsdf

# float32 constants, rounded once as the JAX kernel's weak-typed literals are
INV_PI = float(np.float32(1.0 / 3.14159265358979323846))
PI_F = float(np.float32(np.pi))
TWO_PI_F = float(np.float32(2.0 * np.pi))
THIRD_F = float(np.float32(1.0 / 3.0))

# ------------------------------------------------------ material table layout
# Per-material constants of the reduced fused-principled closure (diffuse +
# metal + specular layer; transmission and coat statically zero).
# Pure-diffuse kinds are the rows with metallic 0 and spec_col 0.
NC_ALBEDO = 16  # knots of the GGX albedo table's cos axis
_MT_REFL = 0  # 0:3   base_color / pi
_MT_ALPHA = 3  # GGX alpha = max(roughness^2, MIN_ALPHA)
_MT_METAL = 4  # metallic lobe weight
_MT_SPEC_ETA = 5  # specular layer ior
_MT_SPEC_COL = 6  # 6:9   specular_tint * specular_weight (f0)
_MT_N = 9  # 9:12  conductor Fresnel n (artistic, from base_color)
_MT_K = 12  # 12:15 conductor Fresnel k
_MT_ROUGH = 15  # the roughness of the reflection lobe (FusedPrincipled.dist_r; 1 diffuse)
_MT_LUT = 16  # 16:32 specular-layer GGX albedo at the 16 cos knots
MAT_COLS = _MT_LUT + NC_ALBEDO


# ---------------------------------------------- component-wise helpers
def dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _rnorm(x, y, z):
    """1 / |v|, IEEE sqrt and division (the kernel computes the same)."""
    return 1.0 / torch.sqrt(torch.clamp(x * x + y * y + z * z, min=1e-30))


def normalize3(x, y, z):
    inv = _rnorm(x, y, z)
    return x * inv, y * inv, z * inv

def fr_dielectric1(ci, eta):
    """svm/microfacet.py::fr_dielectric, component-wise."""
    ci = torch.clamp(ci, -1.0, 1.0)
    eta = torch.where(ci > 0.0, eta, 1.0 / eta)
    ci = torch.abs(ci)
    sin2_t = (1.0 - ci * ci) / torch.clamp(eta * eta, min=1e-12)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_parl = (eta * ci - cos_t) / torch.clamp(eta * ci + cos_t, min=1e-12)
    r_perp = (ci - eta * cos_t) / torch.clamp(ci + eta * cos_t, min=1e-12)
    fr = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(sin2_t >= 1.0, 1.0, torch.clamp(fr, 0.0, 1.0))


def fr_complex1(ci, n, k):
    """svm/microfacet.py::fr_complex for one channel, in real arithmetic."""
    ci = torch.clamp(ci, 0.0, 0.999)
    sin2 = 1.0 - ci * ci
    e2r = n * n - k * k
    e2i = 2.0 * n * k
    den = torch.clamp(e2r * e2r + e2i * e2i, min=1e-30)
    s2tr = sin2 * e2r / den
    s2ti = -sin2 * e2i / den
    ar, ai = 1.0 - s2tr, -s2ti
    r = torch.sqrt(torch.clamp(ar * ar + ai * ai, min=0.0))
    ctr = torch.sqrt(torch.clamp((r + ar) * 0.5, min=0.0))
    cti = torch.sign(ai) * torch.sqrt(torch.clamp((r - ar) * 0.5, min=0.0))
    ecr, eci = n * ci, k * ci
    nr, ni = ecr - ctr, eci - cti
    dr, di = ecr + ctr, eci + cti
    rp2 = (nr * nr + ni * ni) / torch.clamp(dr * dr + di * di, min=1e-30)
    ect_r = n * ctr - k * cti
    ect_i = n * cti + k * ctr
    nr, ni = ci - ect_r, -ect_i
    dr, di = ci + ect_r, ect_i
    rs2 = (nr * nr + ni * ni) / torch.clamp(dr * dr + di * di, min=1e-30)
    return 0.5 * (rp2 + rs2)


def ggx_d1(a, whz):
    """Isotropic TrowbridgeReitz.d in local coordinates."""
    cos2 = whz * whz
    cos4 = cos2 * cos2
    sin2 = torch.clamp(1.0 - cos2, min=0.0)
    zero_c = cos2 <= 0.0
    tan2 = sin2 / torch.where(zero_c, 1.0, cos2)
    e = tan2 / (a * a)
    q = 1.0 + e
    inv_d = PI_F * a * a * cos4 * (q * q)
    bad = zero_c | (inv_d == 0.0) | ~torch.isfinite(inv_d)
    return torch.where(bad, 0.0, 1.0 / torch.where(bad, 1.0, inv_d))


def ggx_lambda1(a, wz):
    """Isotropic TrowbridgeReitz.lambda_ (0 at grazing)."""
    cos2 = wz * wz
    sin2 = torch.clamp(1.0 - cos2, min=0.0)
    zero_c = cos2 <= 0.0
    tan2 = sin2 / torch.where(zero_c, 1.0, cos2)
    lam = (-1.0 + torch.sqrt(1.0 + a * a * tan2)) * 0.5
    return torch.where(zero_c, 0.0, lam)


def ggx_refl_base1(a, ox, oy, oz, ix, iy, iz):
    """principled_fused._ggx_refl_base, component-wise: (B, pdf, fcos)."""
    whx, why, whz = ox + ix, oy + iy, oz + iz
    dwho = dot3(whx, why, whz, ox, oy, oz)
    dwhi = dot3(ix, iy, iz, whx, why, whz)
    degen = ((dwho * dwhi < 0.0) | ((whx == 0.0) & (why == 0.0) & (whz == 0.0))
             | (iz == 0.0) | (oz == 0.0) | (oz * iz <= 0.0))
    whx, why, whz = normalize3(whx, why, whz)
    fcos = dot3(ix, iy, iz, whx, why, whz) * torch.where(whz < 0.0, -1.0, 1.0)
    d = ggx_d1(a, whz)
    g = 1.0 / (1.0 + ggx_lambda1(a, oz) + ggx_lambda1(a, iz))
    denom = iz * oz
    B = torch.abs(0.25 * d * g / torch.where(denom == 0.0, 1.0, denom)) * torch.abs(iz)
    dwo_wh = dot3(ox, oy, oz, whx, why, whz)
    g1o = 1.0 / (1.0 + ggx_lambda1(a, oz))
    pdf_wh = d * g1o * torch.abs(dwo_wh) / torch.clamp(torch.abs(oz), min=1e-12)
    pdf = pdf_wh / torch.clamp(4.0 * torch.abs(dwo_wh), min=1e-12)
    return torch.where(degen, 0.0, B), torch.where(degen, 0.0, pdf), fcos


def ggx_sample_wh1(a, ox, oy, oz, u0, u1):
    """TrowbridgeReitz._sample_wh_vndf (Heitz 2018), isotropic, local."""
    hx, hy, hz = normalize3(a * ox, a * oy, oz)
    neg = hz < 0.0
    hx, hy, hz = torch.where(neg, -hx, hx), torch.where(neg, -hy, hy), torch.where(neg, -hz, hz)
    big = hz >= 0.99999
    inv = 1.0 / torch.sqrt(torch.clamp(hx * hx + hy * hy, min=1e-30))
    t1x = torch.where(big, 1.0, -hy * inv)
    t1y = torch.where(big, 0.0, hx * inv)
    t1z = torch.zeros_like(hz)
    t2x, t2y, t2z = normalize3(hy * t1z - hz * t1y, hz * t1x - hx * t1z, hx * t1y - hy * t1x)
    r = torch.sqrt(torch.clamp(u0, min=0.0))
    phi = u1 * TWO_PI_F
    px = r * torch.cos(phi)
    py0 = r * torch.sin(phi)
    h = torch.sqrt(torch.clamp(1.0 - px * px, min=0.0))
    py = h + (py0 - h) * ((1.0 + hz) * 0.5)
    pz = torch.sqrt(torch.clamp(1.0 - px * px - py * py, min=0.0))
    nx = px * t1x + py * t2x + pz * hx
    ny = px * t1y + py * t2y + pz * hy
    nz = px * t1z + py * t2z + pz * hz
    return normalize3(a * nx, a * ny, torch.clamp(nz, min=1e-6))


def lut1(lut, cos):
    """Linear interpolation of the [N, NC_ALBEDO] albedo rows at |cos|: the
    cos axis of ggx_dielectric_albedo (roughness and eta are baked)."""
    c = torch.abs(torch.clamp(cos, -0.999, 0.999)) * float(NC_ALBEDO - 1)
    i0 = torch.clamp(torch.floor(c).to(torch.int64), 0, NC_ALBEDO - 2)
    t = c - i0.to(torch.float32)
    v0 = torch.gather(lut, 1, i0[:, None])[:, 0]
    v1 = torch.gather(lut, 1, (i0 + 1)[:, None])[:, 0]
    return v0 + (v1 - v0) * t


def _sgn(x):
    return torch.where(x > 0.0, 1.0, -1.0)


class _Closure:
    """The reduced closure at a set of lanes for one wo (SurfaceClosure
    around it: the frame and the leak check), the setup that reduced_shade
    and reduced_eval share. rrow [N, MAT_COLS] material rows; frame ((t),
    (b), (n)), ng and wo as component triples of [N] tensors."""

    def __init__(self, rrow, has_spec: bool, has_metal: bool, frame, ng, wo):
        self.rrow, self.has_spec, self.has_metal = rrow, has_spec, has_metal
        self.frame, self.ng = frame, ng
        (nx, ny, nz) = frame[2]
        self.flip = _sgn(dot3(*ng, nx, ny, nz))
        self.lwo = self.to_local(*wo)
        self.wo_ok = self.side_ok(*wo)
        if has_spec:
            self.lut = rrow[:, _MT_LUT:_MT_LUT + NC_ALBEDO]
            self.alb_o = lut1(self.lut, self.lwo[2])

    def to_local(self, vx, vy, vz):
        return tuple(dot3(vx, vy, vz, *axis) for axis in self.frame)

    def side_ok(self, vx, vy, vz):  # one half of SurfaceClosure._valid_wo_wi
        return (_sgn(self.flip * dot3(vx, vy, vz, *self.frame[2]))
                * _sgn(dot3(vx, vy, vz, *self.ng)) > 0.0)

    def bsdf_eval(self, lix, liy, liz):
        """FusedPrincipled.evaluate, reduced, at a local direction: f (a
        triple, |cos_i| included) and pdf, before the leak check."""
        rrow, lwo = self.rrow, self.lwo
        ref = rrow[:, _MT_REFL], rrow[:, _MT_REFL + 1], rrow[:, _MT_REFL + 2]
        sc = rrow[:, _MT_SPEC_COL], rrow[:, _MT_SPEC_COL + 1], rrow[:, _MT_SPEC_COL + 2]
        B_r, pdf_r, fcos = ggx_refl_base1(rrow[:, _MT_ALPHA], lwo[0], lwo[1], lwo[2], lix, liy, liz)
        same = lwo[2] * liz > 0.0
        cos_i = torch.abs(liz)
        f = [torch.where(same, r * cos_i, 0.0) for r in ref]
        pdf = torch.where(same, cos_i * INV_PI, 0.0)
        if self.has_spec:
            alb_i = lut1(self.lut, liz)
            eo = [s * self.alb_o for s in sc]
            ei = [s * alb_i for s in sc]
            p_s = (eo[0] + eo[1] + eo[2]) * THIRD_F
            frd = fr_dielectric1(fcos, rrow[:, _MT_SPEC_ETA])
            f = [B_r * frd * s + fc * torch.minimum(1.0 - o, 1.0 - i)
                 for s, fc, o, i in zip(sc, f, eo, ei)]
            pdf = pdf_r * p_s + pdf * (1.0 - p_s)
        if self.has_metal:
            met = rrow[:, _MT_METAL]
            afc = torch.abs(fcos)
            fm = [B_r * fr_complex1(afc, rrow[:, _MT_N + c], rrow[:, _MT_K + c]) for c in range(3)]
            f = [fc + (m - fc) * met for fc, m in zip(f, fm)]
            pdf = pdf + (pdf_r - pdf) * met
        return f, pdf

    def evaluate(self, wi):
        """SurfaceClosure.evaluate(wo, wi): (f triple, pdf), zeros where the
        leak check fails."""
        f, pdf = self.bsdf_eval(*self.to_local(*wi))
        ok = self.wo_ok & self.side_ok(*wi)
        return tuple(torch.where(ok, e, 0.0) for e in f), torch.where(ok, pdf, 0.0)


def reduced_shade(rrow, has_spec: bool, has_metal: bool, frame, ng, wo, ls_wi, ls_li, ls_pdf,
                  u_sel, u0, u1, albedo: bool = False, roughness: bool = False):
    """One bounce's shade for the reduced principled closure, per lane:
    evaluate at the NEE direction, sample_wi with evaluate, and optionally
    the directional albedo and the roughness of the lobe that the sample's
    pick chose. rrow [N, MAT_COLS] material rows; frame ((t), (b), (n))
    and ng, wo, ls_wi, ls_li as component triples of [N] tensors. Returns
    dict(direct, wi, f (triples), pdf, valid[, albedo][, roughness]): the
    sh dict of pallas_shade, f and pdf zeroed by the leak check, valid =
    sample_wi valid & leak & pdf > 0 (surface.py sample()); roughness as
    FusedPrincipled.roughness(wo, u_sel) (coat and transmission
    statically zero: the metal or specular pick the lobe's, else 1)."""
    (tx, ty, tz), (bx, by, bz), (nx, ny, nz) = frame
    c = _Closure(rrow, has_spec, has_metal, frame, ng, wo)
    lwo = c.lwo
    ref = rrow[:, _MT_REFL], rrow[:, _MT_REFL + 1], rrow[:, _MT_REFL + 2]
    alpha = rrow[:, _MT_ALPHA]
    met = rrow[:, _MT_METAL]
    sc = rrow[:, _MT_SPEC_COL], rrow[:, _MT_SPEC_COL + 1], rrow[:, _MT_SPEC_COL + 2]

    # NEE: closure.evaluate(wo, ls_wi), MIS weight over the light pdf
    lwx, lwy, lwz = ls_wi
    el, pdf_l = c.bsdf_eval(*c.to_local(lwx, lwy, lwz))
    ok_nee = c.wo_ok & c.side_ok(lwx, lwy, lwz)
    pdf_l = torch.where(ok_nee, pdf_l, 0.0)
    w_nee = ls_pdf / torch.clamp(ls_pdf + pdf_l, min=1e-30)
    scale = w_nee / torch.clamp(ls_pdf, min=1e-20)
    direct = tuple(li * torch.where(ok_nee, e, 0.0) * scale for li, e in zip(ls_li, el))

    # sample_wi: the cascade of FusedPrincipled.sample_wi without coat and
    # transmission
    pick_metal = torch.zeros_like(u_sel, dtype=torch.bool)
    if has_metal:
        pick_metal = u_sel < met
        u_sel = torch.clamp(torch.where(pick_metal, u_sel / torch.clamp(met, min=1e-20),
                                        (u_sel - met) / torch.clamp(1.0 - met, min=1e-20)),
                            0.0, 1.0)
    pick_spec = torch.zeros_like(pick_metal)
    if has_spec:
        pick_spec = u_sel < (sc[0] + sc[1] + sc[2]) * THIRD_F * c.alb_o
    use_refl = pick_metal | pick_spec
    whx, why, whz = ggx_sample_wh1(alpha, lwo[0], lwo[1], lwo[2], u0, u1)
    dwh = dot3(lwo[0], lwo[1], lwo[2], whx, why, whz)
    rx = -lwo[0] + 2.0 * dwh * whx
    ry = -lwo[1] + 2.0 * dwh * why
    rz = -lwo[2] + 2.0 * dwh * whz
    rdisk = torch.sqrt(torch.clamp(u0, min=0.0))
    phi = u1 * TWO_PI_F
    sx = rdisk * torch.cos(phi)
    sy = rdisk * torch.sin(phi)
    sz = torch.sqrt(torch.clamp(1.0 - sx * sx - sy * sy, min=0.0))
    flip_wi = torch.where(lwo[2] * sz > 0.0, 1.0, -1.0)
    sx, sy, sz = sx * flip_wi, sy * flip_wi, sz * flip_wi
    lix = torch.where(use_refl, rx, sx)
    liy = torch.where(use_refl, ry, sy)
    liz = torch.where(use_refl, rz, sz)
    valid_s = ~use_refl | (lwo[2] * rz > 0.0)
    nwx = lix * tx + liy * bx + liz * nx
    nwy = lix * ty + liy * by + liz * ny
    nwz = lix * tz + liy * bz + liz * nz
    es, pdf_s = c.bsdf_eval(lix, liy, liz)
    ok_s = c.wo_ok & c.side_ok(nwx, nwy, nwz)
    pdf_s = torch.where(ok_s, pdf_s, 0.0)
    out = {
        "direct": direct,
        "wi": (nwx, nwy, nwz),
        "f": tuple(torch.where(ok_s, e, 0.0) for e in es),
        "pdf": pdf_s,
        "valid": valid_s & ok_s & (pdf_s > 0.0),
    }
    if albedo:  # FusedPrincipled.albedo without coat and transmission
        base = [r * PI_F for r in ref]
        if has_spec:
            al = [s * (s * c.alb_o) + b * (1.0 - s * c.alb_o) for s, b in zip(sc, base)]
        else:
            al = base
        if has_metal:
            al = [x + (1.0 - x) * met for x in al]
        out["albedo"] = tuple(al)
    if roughness:
        out["roughness"] = torch.where(use_refl, rrow[:, _MT_ROUGH], 1.0)
    return out


def reduced_eval(rrow, has_spec: bool, has_metal: bool, frame, ng, wo, wis):
    """SurfaceClosure.evaluate(wo, wi) of the reduced principled closure at
    each direction of `wis`, per lane (the arguments as reduced_shade's,
    each wi a component triple): a list of (f triple, pdf), f and pdf
    zeroed by the leak check."""
    c = _Closure(rrow, has_spec, has_metal, frame, ng, wo)
    return [c.evaluate(wi) for wi in wis]


# -------------------------------------------------------------- the bake
CONST_OPS = frozenset({"float", "float3", "float4", "rgb", "uplift", "diffuse", "principled",
                       "output"})


def bake_shading(scene):
    """(table [M, MAT_COLS] float32 on the scene's device, has_spec,
    has_metal) if every kind statically reduces to the diffuse + metal +
    specular closure (constant-input diffuse, or constant-input principled
    with transmission and coat statically 0), else None.

    The values come from the port's own compiled closures (dispatch_closure
    on one row per material), so srgb->linear, the spectral uplift, f0 and
    spec_eta and the GGX albedo table match the wavefront path. The
    specular layer's albedo is baked at the table's 16 cos knots, along
    which the table is piecewise linear."""
    a = scene.arrays
    if a.const_emission is None:
        return None
    for kind in scene.kinds:
        if any(nd[0] not in CONST_OPS for nd in kind.nodes):
            return None
        if kind.nodes[kind.output][0] != "output":
            return None
    dev = scene.device
    M = int(a.const_emission.shape[0])
    tab = np.zeros((M, MAT_COLS), np.float32)
    tab[:, _MT_N:_MT_N + 3] = 1.0  # benign conductor ior for unused rows
    eye = torch.eye(3, device=dev)
    frame = tuple(eye[i].expand(M, 3).contiguous() for i in range(3))
    eye_np = np.broadcast_to(np.eye(3, dtype=np.float32), (M, 3, 3))
    tri_mat = a.tri_mat.cpu().numpy()
    tri_kind = a.shader_kind.cpu().numpy()

    def host(x):
        return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x, np.float32)

    for ki, kind in enumerate(scene.kinds):
        ctx = EvalContext(
            params=a.param_mats[ki], uv=torch.zeros((M, 2), device=dev),
            p=torch.zeros((M, 3), device=dev), ng=frame[2], frame=frame,
            table=scene.ggx_table, table_np=scene.ggx_table_np, textures=scene.atlas,
            const_ranges=(scene.kind_const_ranges[ki] if scene.kind_const_ranges is not None
                          else None),
        )
        inner = dispatch_closure(kind, ctx)
        # unwrap the nested closures (world frame, then normal map); every
        # inner frame must be the identity for the kernel's single leak check
        depth = 0
        while hasattr(inner, "inner"):
            if depth > 0:
                fr = np.stack([host(inner.t), host(inner.b), host(inner.n)], 1)
                if not np.allclose(fr, eye_np, atol=1e-6):
                    return None
            inner = inner.inner
            depth += 1
        rows = np.unique(tri_mat[tri_kind == ki]).astype(np.int64)
        if isinstance(inner, DiffuseBsdf):
            tab[rows, _MT_REFL:_MT_REFL + 3] = host(inner.reflectance)[rows]
            tab[rows, _MT_ALPHA] = 1.0
            tab[rows, _MT_ROUGH] = 1.0
        elif isinstance(inner, FusedPrincipled):
            if not {"transmission", "coat"} <= inner.static_zero or not inner.dist_r.sample_visible:
                return None
            al = host(inner.dist_r.alpha)
            if not np.allclose(al[:, 0], al[:, 1]):
                return None  # anisotropic
            tab[rows, _MT_REFL:_MT_REFL + 3] = (host(inner.color) * np.float32(INV_PI))[rows]
            tab[rows, _MT_ALPHA] = al[rows, 0]
            tab[rows, _MT_ROUGH] = host(inner.dist_r.roughness)[rows]
            tab[rows, _MT_METAL] = host(inner.metallic)[rows]
            tab[rows, _MT_SPEC_ETA] = host(inner.spec_eta)[rows]
            spec_col = host(inner.specular_tint * inner.specular_weight[..., None])
            tab[rows, _MT_SPEC_COL:_MT_SPEC_COL + 3] = spec_col[rows]
            tab[rows, _MT_N:_MT_N + 3] = host(inner.n_m)[rows]
            tab[rows, _MT_K:_MT_K + 3] = host(inner.k_m)[rows]
            if np.any(spec_col[rows] != 0.0):
                for c in range(NC_ALBEDO):
                    cos_v = torch.full((M,), c / (NC_ALBEDO - 1.0), device=dev)
                    tab[rows, _MT_LUT + c] = host(inner.spec_albedo_fn(cos_v))[rows]
        else:
            return None
    has_metal = bool(np.any(tab[:, _MT_METAL] != 0.0))
    has_spec = bool(np.any(tab[:, _MT_SPEC_COL:_MT_SPEC_COL + 3] != 0.0))
    return torch.as_tensor(tab, device=dev), has_spec, has_metal


def force_diffuse_table(M: int, device):
    """The material table of force_diffuse mode: Lambert 0.8 everywhere."""
    tab = np.zeros((M, MAT_COLS), np.float32)
    tab[:, _MT_REFL:_MT_REFL + 3] = np.float32(0.8 * INV_PI)
    tab[:, _MT_ALPHA] = 1.0
    tab[:, _MT_N:_MT_N + 3] = 1.0
    return torch.as_tensor(tab, device=device)
