"""Surface (BSDF) combinator tree, batched over shading lanes (port of
akari_render_tpu/svm/surface.py, the lobes the ported shader ops build).

The tree structure is built in Python per shader kind; every method is a
batched torch computation over the kind's lanes. Conventions as in the JAX
package: local shading space with +z the shading normal; evaluate(wo, wi)
returns (f * |cos_theta(wi)|, pdf); sample_wi returns (wi, valid).

Not ported yet: PlasticBsdf, ConductorReflection, TransparentSurface and
the combinator form of the principled BSDF (CoatedBsdf, ScaledBsdf); the
shader ops that need them are refused at load_scene.
"""
from __future__ import annotations

import torch

from ..core.math import Frame, cross, face_forward, normalize, orthonormal_basis, reflect, refract
from ..core.sampling import INV_PI, PI, cos_sample_hemisphere, weighted_discrete_choice2_and_remap
from .microfacet import TrowbridgeReitz


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
