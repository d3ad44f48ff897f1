"""Surface (BSDF) combinator tree, batched over shading lanes (port of
akari_render_tpu/svm/surface.py).

The tree structure is built in Python per shader kind; every method is a
batched torch computation over the kind's lanes. Conventions as in the JAX
package: local shading space with +z the shading normal; evaluate(wo, wi)
returns (f * |cos_theta(wi)|, pdf); sample_wi returns (wi, valid).

Not ported: NullSurface and TransparentSurface, the JAX package's closures
of its alpha mode. The port's alpha mode (svm/eval.py::dispatch_alpha)
evaluates a kind straight to its alpha, so nothing builds them.
"""
from __future__ import annotations

import torch

from ..core.color import luminance
from ..core.math import Frame, cross, face_forward, normalize, orthonormal_basis, reflect, refract
from ..core.sampling import INV_PI, PI, cos_sample_hemisphere, weighted_discrete_choice2_and_remap
from .microfacet import TrowbridgeReitz, fr_dielectric


def z_axis_like(v):
    z = torch.zeros_like(v)
    z[..., 2] = 1.0
    return z


class Surface:
    """Base: zero response."""

    def evaluate(self, wo, wi):
        return torch.zeros_like(wo), torch.zeros(wo.shape[:-1], device=wo.device)

    def sample_wi(self, wo, u_select, u_sample):
        return torch.zeros_like(wo), torch.zeros(wo.shape[:-1], dtype=torch.bool, device=wo.device)

    def albedo(self, wo):
        return torch.zeros_like(wo)

    def emission(self, wo):
        return torch.zeros_like(wo)

    def roughness(self, wo, u_select):
        return torch.ones(wo.shape[:-1], device=wo.device)

    def ns(self, shape, device):
        """The shading normal in the closure's local frame: +z."""
        n = torch.zeros(tuple(shape) + (3,), device=device)
        n[..., 2] = 1.0
        return n


class DiffuseBsdf(Surface):
    """Lambert; `reflectance` is pre-divided by pi."""

    def __init__(self, reflectance):
        self.reflectance = reflectance

    def evaluate(self, wo, wi):
        same = Frame.same_hemisphere(wo, wi)
        cos_i = Frame.abs_cos_theta(wi)
        pdf = torch.where(same, cos_i * INV_PI, 0.0)
        f = torch.where(same[..., None], self.reflectance * cos_i[..., None], 0.0)
        return f, pdf

    def sample_wi(self, wo, u_select, u_sample):
        wi = cos_sample_hemisphere(u_sample)
        wi = torch.where(Frame.same_hemisphere(wo, wi)[..., None], wi, -wi)
        return wi, torch.ones(wo.shape[:-1], dtype=torch.bool, device=wo.device)

    def albedo(self, wo):
        return self.reflectance * PI


class MicrofacetReflection(Surface):
    """GGX reflection lobe."""

    def __init__(self, color, fresnel, dist: TrowbridgeReitz):
        self.color = color
        self.fresnel = fresnel  # callable cos_theta_i -> [N, 3]
        self.dist = dist

    def evaluate(self, wo, wi):
        wh = wo + wi
        cos_o = Frame.cos_theta(wo)
        cos_i = Frame.cos_theta(wi)
        degenerate = (
            (torch.sum(wh * wo, -1) * torch.sum(wi * wh, -1) < 0.0)
            | torch.all(wh == 0.0, -1)
            | (cos_i == 0.0)
            | (cos_o == 0.0)
            | ~Frame.same_hemisphere(wo, wi)
        )
        wh = normalize(wh)
        f_cos = self.fresnel(torch.sum(wi * face_forward(wh, z_axis_like(wh)), -1))
        d = self.dist.d(wh)
        g = self.dist.g(wo, wi)
        denom = cos_i * cos_o
        f = (
            self.color
            * f_cos
            * torch.abs(0.25 * d * g / torch.where(denom == 0, 1.0, denom))[..., None]
            * torch.abs(cos_i)[..., None]
        )
        pdf = self.dist.pdf(wo, wh) / torch.clamp(4.0 * torch.abs(torch.sum(wo * wh, -1)), min=1e-12)
        return torch.where(degenerate[..., None], 0.0, f), torch.where(degenerate, 0.0, pdf)

    def sample_wi(self, wo, u_select, u_sample):
        wh = self.dist.sample_wh(wo, u_sample)
        wi = reflect(wo, wh)
        return wi, Frame.same_hemisphere(wo, wi)

    def albedo(self, wo):
        return self.color

    def roughness(self, wo, u_select):
        return torch.broadcast_to(self.dist.roughness, wo.shape[:-1])


class MicrofacetTransmission(Surface):
    """GGX transmission lobe."""

    def __init__(self, color, eta, fresnel, dist: TrowbridgeReitz):
        self.color = color
        self.eta = eta  # [N] relative IOR (t/i for outward-facing wo)
        self.fresnel = fresnel
        self.dist = dist

    def evaluate(self, wo, wi):
        cos_o = Frame.cos_theta(wo)
        cos_i = Frame.cos_theta(wi)
        eta = torch.where(cos_o > 0.0, self.eta, 1.0 / self.eta)
        wh = normalize(wo + wi * eta[..., None])
        wh = face_forward(wh, z_axis_like(wh))
        wh_wi = torch.sum(wh * wi, -1)
        wh_wo = torch.sum(wh * wo, -1)
        backfacing = (wh_wi * cos_i < 0.0) | (wh_wo * cos_o < 0.0)
        invalid = (
            (torch.sum(wh * wo, -1) * torch.sum(wi * wh, -1) > 0.0)
            | (cos_i == 0.0)
            | (cos_o == 0.0)
            | backfacing
            | Frame.same_hemisphere(wo, wi)
        )
        f_cos = self.fresnel(torch.sum(wo * wh, -1))
        denom = (torch.sum(wi * wh, -1) + torch.sum(wo * wh, -1) / eta) ** 2 * cos_i * cos_o
        d = self.dist.d(wh)
        g = self.dist.g(wo, wi)
        mag = torch.abs(
            d * g / torch.clamp(eta**2, min=1e-12) * torch.abs(torch.sum(wi * wh, -1))
            * torch.abs(torch.sum(wo * wh, -1))
            / torch.where(denom == 0.0, 1.0, denom)
        ) * torch.abs(cos_i)
        f = (1.0 - f_cos) * self.color * mag[..., None]
        f = torch.where((denom == 0.0)[..., None], 0.0, f)
        pdf_denom = (torch.sum(wi * wh, -1) + torch.sum(wo * wh, -1) / eta) ** 2
        dwh_dwi = torch.abs(torch.sum(wi * wh, -1)) / torch.clamp(pdf_denom, min=1e-20)
        pdf = torch.where(pdf_denom == 0.0, 0.0, self.dist.pdf(wo, wh) * dwh_dwi)
        return torch.where(invalid[..., None], 0.0, f), torch.where(invalid, 0.0, pdf)

    def sample_wi(self, wo, u_select, u_sample):
        wh = self.dist.sample_wh(wo, u_sample)
        ok, _, wi = refract(wo, wh, self.eta)
        return wi, ok & ~Frame.same_hemisphere(wo, wi)

    def albedo(self, wo):
        return self.color

    def roughness(self, wo, u_select):
        return torch.broadcast_to(self.dist.roughness, wo.shape[:-1])


class EmissiveSurface(Surface):
    """Emission on top of an optional inner BSDF."""

    def __init__(self, inner: Surface | None, emission):
        self.inner = inner
        self._emission = emission

    def evaluate(self, wo, wi):
        if self.inner is None:
            return super().evaluate(wo, wi)
        return self.inner.evaluate(wo, wi)

    def sample_wi(self, wo, u_select, u_sample):
        if self.inner is None:
            return super().sample_wi(wo, u_select, u_sample)
        return self.inner.sample_wi(wo, u_select, u_sample)

    def albedo(self, wo):
        return self.inner.albedo(wo) if self.inner else torch.zeros_like(wo)

    def emission(self, wo):
        e = self._emission * torch.ones_like(wo)
        return e + self.inner.emission(wo) if self.inner else e

    def roughness(self, wo, u_select):
        return self.inner.roughness(wo, u_select) if self.inner else super().roughness(wo, u_select)

    def ns(self, shape, device):
        return self.inner.ns(shape, device) if self.inner else super().ns(shape, device)


class BsdfMixture(Surface):
    """Two-lobe blend. mode 'add': f = fa + fb, pdf lerped by frac;
    mode 'mix': linear interpolation by frac (frac selects b)."""

    def __init__(self, frac_fn, bsdf_a: Surface, bsdf_b: Surface, mode: str):
        if mode not in ("add", "mix"):
            raise ValueError(mode)
        self.frac_fn = frac_fn  # wo -> [N]
        self.a = bsdf_a
        self.b = bsdf_b
        self.mode = mode

    def evaluate(self, wo, wi):
        frac = self.frac_fn(wo)
        fa, pa = self.a.evaluate(wo, wi)
        fb, pb = self.b.evaluate(wo, wi)
        pdf = pa + (pb - pa) * frac
        if self.mode == "add":
            return fa + fb, pdf
        return fa + (fb - fa) * frac[..., None], pdf

    def sample_wi(self, wo, u_select, u_sample):
        frac = self.frac_fn(wo)
        pick_b, remapped = weighted_discrete_choice2_and_remap(frac, u_select)
        wa, va = self.a.sample_wi(wo, remapped, u_sample)
        wb, vb = self.b.sample_wi(wo, remapped, u_sample)
        return torch.where(pick_b[..., None], wb, wa), torch.where(pick_b, vb, va)

    def albedo(self, wo):
        frac = self.frac_fn(wo)[..., None]
        aa, ab = self.a.albedo(wo), self.b.albedo(wo)
        if self.mode == "add":
            return aa + ab
        return aa * (1.0 - frac) + ab * frac

    def emission(self, wo):
        frac = self.frac_fn(wo)[..., None]
        ea, eb = self.a.emission(wo), self.b.emission(wo)
        if self.mode == "add":
            return ea + eb
        return ea * (1.0 - frac) + eb * frac

    def roughness(self, wo, u_select):
        pick_b, remapped = weighted_discrete_choice2_and_remap(self.frac_fn(wo), u_select)
        return torch.where(pick_b, self.b.roughness(wo, remapped), self.a.roughness(wo, remapped))

    def ns(self, shape, device):
        return normalize(self.a.ns(shape, device) + self.b.ns(shape, device))


class ScaledBsdf(Surface):
    """An inner closure's response scaled by weight_fn(wo) [N, 3]."""

    def __init__(self, inner: Surface, weight_fn):
        self.inner = inner
        self.weight_fn = weight_fn

    def evaluate(self, wo, wi):
        f, pdf = self.inner.evaluate(wo, wi)
        return f * self.weight_fn(wo), pdf

    def sample_wi(self, wo, u_select, u_sample):
        return self.inner.sample_wi(wo, u_select, u_sample)

    def albedo(self, wo):
        return self.inner.albedo(wo) * self.weight_fn(wo)

    def emission(self, wo):
        return self.inner.emission(wo) * self.weight_fn(wo)

    def roughness(self, wo, u_select):
        return self.inner.roughness(wo, u_select)

    def ns(self, shape, device):
        return self.inner.ns(shape, device)


class CoatedBsdf(Surface):
    """Energy-split layering: the top lobe plus (1 - E_top) of the bottom
    (surface/mod.rs:476-567); e_top_fn(wo) is the top's directional albedo
    [N, 3]."""

    def __init__(self, top: Surface, bottom: Surface, e_top_fn):
        self.top = top
        self.bottom = bottom
        self.e_top_fn = e_top_fn

    def evaluate(self, wo, wi):
        ft, pt = self.top.evaluate(wo, wi)
        fb, pb = self.bottom.evaluate(wo, wi)
        eo = self.e_top_fn(wo)
        ei = self.e_top_fn(wi)
        p_top = torch.mean(eo, dim=-1)
        return ft + fb * torch.minimum(1.0 - eo, 1.0 - ei), pt * p_top + pb * (1.0 - p_top)

    def sample_wi(self, wo, u_select, u_sample):
        p_top = torch.mean(self.e_top_fn(wo), dim=-1)
        pick_top, remapped = weighted_discrete_choice2_and_remap(p_top, u_select)
        wt, vt = self.top.sample_wi(wo, remapped, u_sample)
        wb, vb = self.bottom.sample_wi(wo, remapped, u_sample)
        return torch.where(pick_top[..., None], wt, wb), torch.where(pick_top, vt, vb)

    def albedo(self, wo):
        eo = self.e_top_fn(wo)
        return self.top.albedo(wo) * eo + self.bottom.albedo(wo) * (1.0 - eo)

    def emission(self, wo):
        eo = self.e_top_fn(wo)
        return self.top.emission(wo) * eo + self.bottom.emission(wo) * (1.0 - eo)

    def roughness(self, wo, u_select):
        p_top = torch.mean(self.e_top_fn(wo), dim=-1)
        pick_top, remapped = weighted_discrete_choice2_and_remap(p_top, u_select)
        return torch.where(pick_top, self.top.roughness(wo, remapped),
                           self.bottom.roughness(wo, remapped))

    def ns(self, shape, device):
        return self.bottom.ns(shape, device)


class ConductorReflection(MicrofacetReflection):
    """Metal GGX lobe whose tint is all in its complex Fresnel: the albedo
    reports F(|cos_o|), the metal's own reflectance, not the white lobe
    colour."""

    def albedo(self, wo):
        return self.fresnel(Frame.abs_cos_theta(wo))


def fr_dielectric_integral(eta):
    """Hemispherical (diffuse) Fresnel reflectance Fdr(eta), the polynomial
    fits of surface/mod.rs:1127-1144. eta: [N]."""
    lt = eta * (eta * (eta * -0.90663979 + 2.23559031) + -2.09069066) + 0.75985009
    inv = 1.0 / torch.clamp(eta, min=1e-6)
    gt = inv * (inv * -1.18995376 + 0.21762732) + 0.97945724
    return torch.where(eta == 1.0, 0.0, torch.where(eta < 1.0, lt, gt))


class PlasticBsdf(Surface):
    """Tungsten's rough plastic with internal scattering (ref
    svm/surface/plastic.rs:38-178): a dielectric GGX coat over a diffuse
    substrate scaled by the both-way Fresnel transmission (1-Fi)(1-Fo), the
    1/eta^2 compression, the multiple-scattering compensation
    kd/(1 - kd Fdr) and the absorption exp(-sigma_a thickness (1/cos_i +
    1/cos_o)). The exps are torch's, which may differ from XLA's in the
    last bit; without sigma_a (the scene graph's default) they are exp(0)."""

    def __init__(self, kd, eta, roughness, sigma_a=None, thickness=None):
        n = kd.shape[:-1]
        dev = kd.device
        sigma_a = torch.zeros(n + (3,), device=dev) if sigma_a is None else sigma_a
        thickness = torch.ones(n, device=dev) if thickness is None else thickness
        fdr = fr_dielectric_integral(eta)
        self.substrate = DiffuseBsdf(kd / torch.clamp(1.0 - kd * fdr[..., None], min=1e-4) * INV_PI)
        dist = TrowbridgeReitz.from_roughness(roughness)
        self._fr = lambda c: fr_dielectric(c, eta)
        self.coat = MicrofacetReflection(
            torch.ones(n + (3,), device=dev),
            lambda c: self._fr(c)[..., None] * torch.ones(3, device=c.device), dist)
        self.eta = eta
        self.sigma_a = sigma_a * thickness[..., None]
        avg_transmittance = torch.exp(-2.0 * luminance(sigma_a) * thickness)
        self.kd_weight = luminance(kd) * avg_transmittance

    def _substrate_weight(self, fo):
        w = self.kd_weight * (1.0 - fo)
        return torch.where(w == 0.0, 0.0, w / torch.clamp(w + fo, min=1e-20))

    def evaluate(self, wo, wi):
        f_coat, pdf_coat = self.coat.evaluate(wo, wi)
        fi = self._fr(Frame.abs_cos_theta(wi))
        fo = self._fr(Frame.abs_cos_theta(wo))
        a = torch.exp(-self.sigma_a * (
            1.0 / torch.clamp(Frame.abs_cos_theta(wi), min=1e-6)
            + 1.0 / torch.clamp(Frame.abs_cos_theta(wo), min=1e-6))[..., None])
        f_sub, pdf_sub = self.substrate.evaluate(wo, wi)
        scale = ((1.0 - fi) * (1.0 - fo) / torch.clamp(self.eta**2, min=1e-6))[..., None]
        w = self._substrate_weight(fo)
        return f_coat + f_sub * scale * a, pdf_coat * (1.0 - w) + pdf_sub * w

    def sample_wi(self, wo, u_select, u_sample):
        w = self._substrate_weight(self._fr(Frame.abs_cos_theta(wo)))
        pick_sub, remapped = weighted_discrete_choice2_and_remap(w, u_select)
        ws, vs = self.substrate.sample_wi(wo, remapped, u_sample)
        wc, vc = self.coat.sample_wi(wo, remapped, u_sample)
        return torch.where(pick_sub[..., None], ws, wc), torch.where(pick_sub, vs, vc)

    def albedo(self, wo):
        w = self._substrate_weight(self._fr(Frame.abs_cos_theta(wo)))
        return self.coat.albedo(wo) * (1.0 - w)[..., None] + self.substrate.albedo(wo) * w[..., None]

    def roughness(self, wo, u_select):
        w = self._substrate_weight(self._fr(Frame.abs_cos_theta(wo)))
        pick_sub, remapped = weighted_discrete_choice2_and_remap(w, u_select)
        return torch.where(pick_sub, self.substrate.roughness(wo, remapped),
                           self.coat.roughness(wo, remapped))


class SurfaceClosure(Surface):
    """Frame transform plus light-leak rejection; nestable (normal_map
    builds an inner closure whose frame lives in the parent's local space)."""

    def __init__(self, inner: Surface, frame, ng):
        self.inner = inner
        self.t, self.b, self.n = frame
        self.ng = ng

    def _valid_wo_wi(self, wo, wi):
        ns, ng = self.n, self.ng

        def sign(x):
            return torch.where(x > 0.0, 1.0, -1.0)

        flipped = sign(torch.sum(ng * ns, -1))
        return (
            sign(flipped * torch.sum(wo * ns, -1)) * sign(torch.sum(wo * ng, -1)) > 0.0
        ) & (sign(flipped * torch.sum(wi * ns, -1)) * sign(torch.sum(wi * ng, -1)) > 0.0)

    def _to_local(self, v):
        return Frame.to_local(self.t, self.b, self.n, v)

    def _to_world(self, v):
        return Frame.to_world(self.t, self.b, self.n, v)

    def evaluate(self, wo, wi):
        f, pdf = self.inner.evaluate(self._to_local(wo), self._to_local(wi))
        ok = self._valid_wo_wi(wo, wi)
        return torch.where(ok[..., None], f, 0.0), torch.where(ok, pdf, 0.0)

    def sample_wi(self, wo, u_select, u_sample):
        wi_l, valid = self.inner.sample_wi(self._to_local(wo), u_select, u_sample)
        wi = self._to_world(wi_l)
        return wi, valid & self._valid_wo_wi(wo, wi)

    def sample(self, wo, u_select, u_sample):
        """dict(wi, f, pdf, valid), the BsdfSample."""
        wi, valid = self.sample_wi(wo, u_select, u_sample)
        f, pdf = self.evaluate(wo, wi)
        return {"wi": wi, "f": f, "pdf": pdf, "valid": valid & (pdf > 0.0)}

    def albedo(self, wo):
        return self.inner.albedo(self._to_local(wo))

    def emission(self, wo):
        return self.inner.emission(self._to_local(wo))

    def roughness(self, wo, u_select):
        return self.inner.roughness(self._to_local(wo), u_select)

    def ns(self, shape=None, device=None):
        """The shading normal in world space (in the parent's local space
        for a nested closure)."""
        shape = self.n.shape[:-1] if shape is None else shape
        return self._to_world(self.inner.ns(shape, self.n.device))


def frame_from_n_t(n, tt):
    """Frame from a normal and a tangent hint, Gram-Schmidt with an ONB
    fallback. Returns (t, b, n)."""
    t = tt - n * torch.sum(n * tt, -1, keepdim=True)
    tlen = torch.sqrt(torch.sum(t * t, -1, keepdim=True))
    good = tlen[..., 0] > 1e-4
    t = torch.where(good[..., None], t / torch.clamp(tlen, min=1e-20), 0.0)
    b = cross(n, t)
    blen = torch.sqrt(torch.sum(b * b, -1, keepdim=True))
    good = good & (blen[..., 0] > 1e-4)
    b = b / torch.clamp(blen, min=1e-20)
    ft, fb = orthonormal_basis(n)
    return torch.where(good[..., None], t, ft), torch.where(good[..., None], b, fb), n


def normal_map(surface: Surface, ns, ng, frame):
    """Tangent-space normal perturbation: ns is the raw [N, 3] shader value
    (all zero means no perturbation). Returns a SurfaceClosure whose frame
    lives in the parent frame's local space."""
    t0, b0, n0 = frame
    is_zero = torch.all(ns == 0.0, dim=-1)
    nrm = normalize(torch.where(is_zero[..., None], z_axis_like(ns), ns))
    n_world = Frame.to_world(t0, b0, n0, nrm)
    nt, nb, nn = frame_from_n_t(n_world, t0)

    def tl(v):
        return Frame.to_local(t0, b0, n0, v)

    ident = torch.eye(3, device=ns.device, dtype=ns.dtype)
    lt = torch.where(is_zero[..., None], ident[0], tl(nt))
    lb = torch.where(is_zero[..., None], ident[1], tl(nb))
    ln = torch.where(is_zero[..., None], ident[2], tl(nn))
    return SurfaceClosure(surface, (lt, lb, ln), tl(ng))
