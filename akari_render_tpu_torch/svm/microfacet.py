"""Trowbridge-Reitz (GGX) microfacet distribution and Fresnel terms (port of
akari_render_tpu/svm/microfacet.py): visible-normal sampling (the default,
the one every closure builds) and the classic NDF sampler with its
analytic inverse (sample_visible=False; only tests build it, in either
package). Local shading space: +z is the normal."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.math import Frame, cross, face_forward, normalize
from ..core.sampling import INV_2PI, PI, TWO_PI, uniform_sample_disk

MIN_ALPHA = 1e-4


class TrowbridgeReitz(NamedTuple):
    alpha: torch.Tensor  # [..., 2] anisotropic alphas
    sample_visible: bool = True

    @staticmethod
    def from_roughness(roughness, sample_visible: bool = True) -> "TrowbridgeReitz":
        """alpha = roughness^2, isotropic from a [...] roughness (the JAX
        package also takes [..., 2]; a shader's roughness is one value a
        lane, and a kind's group of two lanes must not read as [..., 2])."""
        r = torch.stack([roughness, roughness], dim=-1)
        return TrowbridgeReitz(torch.clamp(r * r, min=MIN_ALPHA), sample_visible)

    @property
    def roughness(self):
        return torch.sqrt(torch.sum(self.alpha, dim=-1) * 0.5)

    def d(self, wh):
        ax, ay = self.alpha[..., 0], self.alpha[..., 1]
        tan2 = Frame.tan2_theta(wh)
        cos4 = Frame.cos2_theta(wh) ** 2
        e = tan2 * ((Frame.cos_phi(wh) / ax) ** 2 + (Frame.sin_phi(wh) / ay) ** 2)
        inv_d = PI * ax * ay * cos4 * (1.0 + e) ** 2
        bad = ~torch.isfinite(tan2) | ~torch.isfinite(inv_d) | (inv_d == 0.0)
        return torch.where(bad, 0.0, 1.0 / torch.where(bad, 1.0, inv_d))

    def lambda_(self, w):
        abs_tan = torch.abs(Frame.tan_theta(w))
        a2 = Frame.cos2_phi(w) * self.alpha[..., 0] ** 2 + Frame.sin2_phi(w) * self.alpha[..., 1] ** 2
        l = (-1.0 + torch.sqrt(1.0 + a2 * abs_tan**2)) * 0.5
        return torch.where(torch.isfinite(abs_tan), l, 0.0)

    def g1(self, w):
        return 1.0 / (1.0 + self.lambda_(w))

    def g(self, wo, wi):
        return 1.0 / (1.0 + self.lambda_(wo) + self.lambda_(wi))

    def sample_wh(self, wo, u):
        if self.sample_visible:
            return self._sample_wh_vndf(wo, u)
        return self._sample_wh_classic(u)

    def _sample_wh_vndf(self, w, u):
        """Heitz 2018 visible-normal sampling."""
        ax, ay = self.alpha[..., 0], self.alpha[..., 1]
        wh = normalize(torch.stack([ax * w[..., 0], ay * w[..., 1], w[..., 2]], dim=-1))
        wh = torch.where(wh[..., 2:3] < 0.0, -wh, wh)
        z_axis = torch.zeros_like(wh)
        z_axis[..., 2] = 1.0
        x_axis = torch.zeros_like(wh)
        x_axis[..., 0] = 1.0
        t1 = torch.where(wh[..., 2:3] < 0.99999, normalize(cross(z_axis, wh)), x_axis)
        t2 = normalize(cross(wh, t1))
        p = uniform_sample_disk(u)
        h = torch.sqrt(torch.clamp(1.0 - p[..., 0] ** 2, min=0.0))
        lerp_t = (1.0 + wh[..., 2]) * 0.5
        py = h + (p[..., 1] - h) * lerp_t
        pz = torch.sqrt(torch.clamp(1.0 - p[..., 0] ** 2 - py**2, min=0.0))
        nh = p[..., 0:1] * t1 + py[..., None] * t2 + pz[..., None] * wh
        return normalize(
            torch.stack([ax * nh[..., 0], ay * nh[..., 1], torch.clamp(nh[..., 2], min=1e-6)], dim=-1)
        )

    def _sample_wh_classic(self, u):
        """Classic NDF sampling, isotropic or anisotropic."""
        ax, ay = self.alpha[..., 0], self.alpha[..., 1]
        phi_i = TWO_PI * u[..., 1]
        tan2_i = ax * ax * u[..., 0] / torch.clamp(1.0 - u[..., 0], min=1e-12)
        cos_i = 1.0 / torch.sqrt(1.0 + tan2_i)
        phi_a = torch.arctan(ay / ax * torch.tan(TWO_PI * u[..., 1] + 0.5 * PI))
        phi_a = torch.where(u[..., 1] > 0.5, phi_a + PI, phi_a)
        sp, cp = torch.sin(phi_a), torch.cos(phi_a)
        a2 = 1.0 / (cp**2 / torch.clamp(ax * ax, min=1e-12) + sp**2 / torch.clamp(ay * ay, min=1e-12))
        tan2_a = a2 * u[..., 0] / torch.clamp(1.0 - u[..., 0], min=1e-12)
        cos_a = 1.0 / torch.sqrt(1.0 + tan2_a)
        is_iso = ax == ay
        phi = torch.where(is_iso, phi_i, phi_a)
        cos_t = torch.where(is_iso, cos_i, cos_a)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t**2, min=0.0))
        wh = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)
        z_axis = torch.zeros_like(wh)
        z_axis[..., 2] = 1.0
        return face_forward(wh, z_axis)

    def invert_wh(self, wo, wh):
        """The classic sampler's analytic inverse: wh -> u [..., 2],
        isotropic and anisotropic."""
        if self.sample_visible:
            raise ValueError("invert_wh requires classic sampling")
        ax, ay = self.alpha[..., 0], self.alpha[..., 1]
        x, y, cos_t = wh[..., 0], wh[..., 1], wh[..., 2]
        tan2 = 1.0 / torch.clamp(cos_t**2, min=1e-12) - 1.0
        uy_i = torch.remainder(torch.atan2(y, x) * INV_2PI, 1.0)
        ga_i = tan2 / torch.clamp(ax * ax, min=1e-12)
        ux_i = ga_i / (1.0 + ga_i)
        # sampling sets tan(phi) = (ay/ax) tan(psi), psi = 2 pi u1 + pi/2, and
        # the arctan maps psi to the opposite quadrant of phi
        psi = torch.atan2(ax * y, ay * x) + PI
        uy_a = torch.remainder((psi - 0.5 * PI) * INV_2PI, 1.0)
        r2 = torch.clamp(x * x + y * y, min=1e-24)
        inv_a2 = (x * x / r2) / torch.clamp(ax * ax, min=1e-12) + (y * y / r2) / torch.clamp(
            ay * ay, min=1e-12)
        ga_a = tan2 * inv_a2
        ux_a = ga_a / (1.0 + ga_a)
        is_iso = ax == ay
        return torch.stack([torch.where(is_iso, ux_i, ux_a), torch.where(is_iso, uy_i, uy_a)], -1)

    def pdf(self, wo, wh):
        if not self.sample_visible:
            return self.d(wh) * Frame.abs_cos_theta(wh)
        return (
            self.d(wh) * self.g1(wo) * torch.abs(torch.sum(wo * wh, -1))
            / torch.clamp(Frame.abs_cos_theta(wo), min=1e-12)
        )


def fr_dielectric(cos_theta_i, eta):
    """Dielectric Fresnel; eta = eta_t / eta_i on the cos > 0 side."""
    cos_theta_i = torch.clamp(cos_theta_i, -1.0, 1.0)
    eta = torch.where(cos_theta_i > 0.0, eta, 1.0 / eta)
    cos_theta_i = torch.abs(cos_theta_i)
    sin2_i = 1.0 - cos_theta_i**2
    sin2_t = sin2_i / torch.clamp(eta**2, min=1e-12)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_parl = (eta * cos_theta_i - cos_t) / torch.clamp(eta * cos_theta_i + cos_t, min=1e-12)
    r_perp = (cos_theta_i - eta * cos_t) / torch.clamp(cos_theta_i + eta * cos_t, min=1e-12)
    fr = 0.5 * (r_parl**2 + r_perp**2)
    return torch.where(tir, 1.0, torch.clamp(fr, 0.0, 1.0))


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi):
    d = torch.clamp(br * br + bi * bi, min=1e-30)
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def _csqrt(ar, ai):
    r = torch.sqrt(torch.clamp(ar * ar + ai * ai, min=0.0))
    re = torch.sqrt(torch.clamp((r + ar) * 0.5, min=0.0))
    im = torch.sign(ai) * torch.sqrt(torch.clamp((r - ar) * 0.5, min=0.0))
    return re, im


def fr_complex(cos_theta_i, n, k):
    """Conductor Fresnel with complex IOR n + ik per channel, in real
    arithmetic. cos_theta_i: [N]; n, k: [N, 3] -> [N, 3]."""
    ci = torch.clamp(cos_theta_i, 0.0, 0.999)[..., None]
    sin2 = 1.0 - ci * ci
    e2r, e2i = _cmul(n, k, n, k)
    s2tr, s2ti = _cdiv(sin2, torch.zeros_like(sin2), e2r, e2i)
    ctr, cti = _csqrt(1.0 - s2tr, -s2ti)
    ecr, eci = n * ci, k * ci
    rp_r, rp_i = _cdiv(ecr - ctr, eci - cti, ecr + ctr, eci + cti)
    ect_r, ect_i = _cmul(n, k, ctr, cti)
    rs_r, rs_i = _cdiv(ci - ect_r, -ect_i, ci + ect_r, ect_i)
    return 0.5 * ((rp_r**2 + rp_i**2) + (rs_r**2 + rs_i**2))


def f0_from_ior(ior):
    f0 = (ior - 1.0) / (ior + 1.0)
    return f0 * f0


def ior_from_f0(f0):
    s = torch.sqrt(torch.clamp(f0, 0.0, 0.99))
    return (1.0 + s) / (1.0 - s)


def fr_schlick(f0, f90, cos_theta_i):
    c = torch.abs(torch.clamp(cos_theta_i, -1.0, 1.0))
    return f0 + (f90 - f0) * (1.0 - c)[..., None] ** 5


def artistic_to_conductor_fresnel(color, tint):
    """Gulbrandsen's artistic conductor parametrization."""
    r = torch.clamp(color, 0.0, 0.99)
    r_sqrt = torch.sqrt(r)
    n_min = (1.0 - r) / (1.0 + r)
    n_max = (1.0 + r_sqrt) / torch.clamp(1.0 - r_sqrt, min=1e-6)
    n = n_max + (n_min - n_max) * tint
    k2 = ((n + 1.0) ** 2 * r - (n - 1.0) ** 2) / torch.clamp(1.0 - r, min=1e-6)
    return n, torch.sqrt(torch.clamp(k2, min=0.0))
