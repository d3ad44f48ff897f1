"""Fused principled BSDF (port of akari_render_tpu/svm/principled_fused.py):
one shared GGX reflection base for the specular, dielectric-reflection and
metal lobes, plus coat, transmission and diffuse, with the same f/pdf and
the same lobe-selection cascade as the combinator tree. Statically-zero
lobes (metallic, transmission, coat constant 0 over a kind) are omitted,
bit-exactly, as in the JAX package."""
from __future__ import annotations

import torch

from ..core.math import Frame, face_forward, normalize, reflect, refract
from ..core.sampling import INV_PI, cos_sample_hemisphere, weighted_discrete_choice2_and_remap
from .microfacet import TrowbridgeReitz, artistic_to_conductor_fresnel, fr_complex, fr_dielectric
from .surface import MicrofacetTransmission, Surface, z_axis_like


class FusedPrincipled(Surface):
    def __init__(self, *, base_color, metallic, roughness, eta, transmission,
                 spec_eta, specular_weight, specular_tint,
                 coat_weight, coat_roughness, coat_ior, coat_tint,
                 emission, spec_albedo_fn, coat_albedo_fn,
                 static_zero: frozenset = frozenset()):
        self.static_zero = static_zero
        self.color = base_color
        self.kt = torch.sqrt(torch.clamp(base_color, min=0.0))
        self.metallic = metallic
        self.rough = roughness
        self.eta = eta
        self.transmission = transmission
        self.spec_eta = spec_eta
        self.specular_weight = specular_weight  # f0
        self.specular_tint = specular_tint
        self.coat_weight = coat_weight
        self.coat_roughness = coat_roughness
        self.coat_ior = coat_ior
        self.coat_tint = coat_tint
        self._emission = emission
        self.spec_albedo_fn = spec_albedo_fn  # cos -> [N]
        self.coat_albedo_fn = coat_albedo_fn
        self.dist_r = TrowbridgeReitz.from_roughness(roughness)
        self.dist_c = TrowbridgeReitz.from_roughness(coat_roughness)
        self.n_m, self.k_m = artistic_to_conductor_fresnel(base_color, specular_tint)

    def _eo_s(self, w):
        return self.specular_tint * (
            self.spec_albedo_fn(Frame.abs_cos_theta(w)) * self.specular_weight
        )[..., None]

    def _eo_c(self, w):
        if "coat" in self.static_zero:
            return torch.zeros(w.shape[:-1] + (3,), device=w.device)
        return (self.coat_weight * self.coat_albedo_fn(Frame.abs_cos_theta(w)))[..., None] * torch.ones(
            3, device=w.device
        )

    def _w_tint(self):
        if "coat" in self.static_zero:
            return torch.ones(3, device=self.color.device)
        return 1.0 + (self.coat_tint - 1.0) * self.coat_weight[..., None]

    def _ggx_refl_base(self, dist, wo, wi):
        """(B, pdf, fresnel_cos): GGX reflection without color or Fresnel."""
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
        fcos = torch.sum(wi * face_forward(wh, z_axis_like(wh)), -1)
        d = dist.d(wh)
        g = dist.g(wo, wi)
        denom = cos_i * cos_o
        B = torch.abs(0.25 * d * g / torch.where(denom == 0, 1.0, denom)) * torch.abs(cos_i)
        pdf = dist.pdf(wo, wh) / torch.clamp(4.0 * torch.abs(torch.sum(wo * wh, -1)), min=1e-12)
        return torch.where(degenerate, 0.0, B), torch.where(degenerate, 0.0, pdf), fcos

    def _ggx_trans(self, wo, wi):
        def fresnel(c):
            return fr_dielectric(c, self.eta)[..., None] * torch.ones(3, device=c.device)

        return MicrofacetTransmission(self.kt, self.eta, fresnel, self.dist_r).evaluate(wo, wi)

    def evaluate(self, wo, wi):
        z = self.static_zero
        B_r, pdf_r, fcos_r = self._ggx_refl_base(self.dist_r, wo, wi)
        same_hemi = Frame.same_hemisphere(wo, wi)
        f_spec = (
            B_r[..., None]
            * fr_dielectric(fcos_r, self.spec_eta)[..., None]
            * self.specular_tint
            * self.specular_weight[..., None]
        )
        cos_i = Frame.abs_cos_theta(wi)
        f_diff = torch.where(same_hemi[..., None], self.color * INV_PI * cos_i[..., None], 0.0)
        pdf_d = torch.where(same_hemi, cos_i * INV_PI, 0.0)
        if "transmission" in z:
            f_bot, pdf_bot = f_diff, pdf_d
        else:
            f_diel_refl = B_r[..., None] * fr_dielectric(fcos_r, self.eta)[..., None] * self.color
            f_trans, pdf_t = self._ggx_trans(wo, wi)
            fr_o = fr_dielectric(Frame.cos_theta(wo), self.eta)
            f_diel = f_trans + f_diel_refl
            pdf_diel = pdf_t + (pdf_r - pdf_t) * fr_o
            f_bot = f_diff + (f_diel - f_diff) * self.transmission[..., None]
            pdf_bot = pdf_d + (pdf_diel - pdf_d) * self.transmission
        eo_s, ei_s = self._eo_s(wo), self._eo_s(wi)
        p_s = torch.mean(eo_s, -1)
        f_sc = f_spec + f_bot * torch.minimum(1.0 - eo_s, 1.0 - ei_s)
        pdf_sc = pdf_r * p_s + pdf_bot * (1.0 - p_s)
        if "metallic" in z:
            f_in, pdf_in = f_sc, pdf_sc
        else:
            f_metal = B_r[..., None] * fr_complex(torch.abs(fcos_r), self.n_m, self.k_m)
            f_in = f_sc + (f_metal - f_sc) * self.metallic[..., None]
            pdf_in = pdf_sc + (pdf_r - pdf_sc) * self.metallic
        if "coat" in z:
            return f_in, pdf_in
        B_c, pdf_c, fcos_c = self._ggx_refl_base(self.dist_c, wo, wi)
        f_coat = B_c[..., None] * fr_dielectric(fcos_c, self.coat_ior)[..., None] * self.coat_weight[..., None]
        eo_c, ei_c = self._eo_c(wo), self._eo_c(wi)
        p_c = torch.mean(eo_c, -1)
        f = f_coat + f_in * self._w_tint() * torch.minimum(1.0 - eo_c, 1.0 - ei_c)
        pdf = pdf_c * p_c + pdf_in * (1.0 - p_c)
        return f, pdf

    def sample_wi(self, wo, u_select, u_sample):
        """The tree's weighted-choice cascade, level by level, with the same
        remapped randoms; statically-zero levels are skipped."""
        z = self.static_zero
        false = torch.zeros(wo.shape[:-1], dtype=torch.bool, device=wo.device)
        if "coat" in z:
            pick_coat, u1 = false, u_select
        else:
            pick_coat, u1 = weighted_discrete_choice2_and_remap(torch.mean(self._eo_c(wo), -1), u_select)
        if "metallic" in z:
            pick_metal, u2 = false, u1
        else:
            pick_metal, u2 = weighted_discrete_choice2_and_remap(self.metallic, u1)
        pick_spec, u3 = weighted_discrete_choice2_and_remap(torch.mean(self._eo_s(wo), -1), u2)
        if "transmission" in z:
            pick_diel, pick_refl = false, false
        else:
            pick_diel, u4 = weighted_discrete_choice2_and_remap(self.transmission, u3)
            fr_o = fr_dielectric(Frame.cos_theta(wo), self.eta)
            pick_refl, _ = weighted_discrete_choice2_and_remap(fr_o, u4)

        wh_r = self.dist_r.sample_wh(wo, u_sample)
        wi_refl_r = reflect(wo, wh_r)
        wi_diff = cos_sample_hemisphere(u_sample)
        wi_diff = torch.where(Frame.same_hemisphere(wo, wi_diff)[..., None], wi_diff, -wi_diff)
        same_r = Frame.same_hemisphere(wo, wi_refl_r)
        use_refl_r = ~pick_coat & (pick_metal | pick_spec | (pick_diel & pick_refl))
        use_trans = ~pick_coat & ~pick_metal & ~pick_spec & pick_diel & ~pick_refl
        if "transmission" in z:
            wi_lo = wi_diff
            valid_lo = torch.ones(wo.shape[:-1], dtype=torch.bool, device=wo.device)
        else:
            ok_t, _, wi_trans = refract(wo, wh_r, self.eta)
            valid_t = ok_t & ~Frame.same_hemisphere(wo, wi_trans)
            wi_lo = torch.where(use_trans[..., None], wi_trans, wi_diff)
            valid_lo = torch.where(use_trans, valid_t, True)
        wi_in = torch.where(use_refl_r[..., None], wi_refl_r, wi_lo)
        valid_in = torch.where(use_refl_r, same_r, valid_lo)
        if "coat" in z:
            return wi_in, valid_in
        wi_refl_c = reflect(wo, self.dist_c.sample_wh(wo, u_sample))
        same_c = Frame.same_hemisphere(wo, wi_refl_c)
        return (
            torch.where(pick_coat[..., None], wi_refl_c, wi_in),
            torch.where(pick_coat, same_c, valid_in),
        )

    def albedo(self, wo):
        z = self.static_zero
        eo_s = self._eo_s(wo)
        if "transmission" in z:
            alb_bot = self.color
        else:
            alb_diel = self.color + self.kt
            alb_bot = self.color + (alb_diel - self.color) * self.transmission[..., None]
        alb_sc = (self.specular_tint * self.specular_weight[..., None]) * eo_s + alb_bot * (1.0 - eo_s)
        if "metallic" in z:
            alb_in = alb_sc
        else:
            alb_in = alb_sc + (torch.ones_like(self.color) - alb_sc) * self.metallic[..., None]
        if "coat" in z:
            return alb_in
        eo_c = self._eo_c(wo)
        top = self.coat_weight[..., None] * torch.ones(3, device=wo.device)
        return top * eo_c + (alb_in * self._w_tint()) * (1.0 - eo_c)

    def emission(self, wo):
        if "coat" in self.static_zero:
            return self._emission
        return self._emission * self._w_tint() * (1.0 - self._eo_c(wo))

    def roughness(self, wo, u_select):
        """The roughness of the lobe the selection cascade picks with
        u_select (coat, then metal, specular, dielectric, else diffuse: 1)."""
        z = self.static_zero
        false = torch.zeros(wo.shape[:-1], dtype=torch.bool, device=wo.device)
        if "coat" in z:
            pick_coat, u1 = false, u_select
        else:
            pick_coat, u1 = weighted_discrete_choice2_and_remap(torch.mean(self._eo_c(wo), -1),
                                                                u_select)
        if "metallic" in z:
            pick_metal, u2 = false, u1
        else:
            pick_metal, u2 = weighted_discrete_choice2_and_remap(self.metallic, u1)
        pick_spec, u3 = weighted_discrete_choice2_and_remap(torch.mean(self._eo_s(wo), -1), u2)
        if "transmission" in z:
            pick_diel = false
        else:
            pick_diel, _ = weighted_discrete_choice2_and_remap(self.transmission, u3)
        r = torch.where(pick_coat, self.dist_c.roughness,
                        torch.where(pick_metal | pick_spec | pick_diel, self.dist_r.roughness, 1.0))
        return torch.broadcast_to(r, wo.shape[:-1])
