"""Area lights: power-weighted light selection plus per-light triangle
sampling (port of akari_render_tpu/lights.py).

All per-light triangle alias tables are concatenated into flat tensors
with (offset, count) per light. The compact [S, 14] table (v0, e1, e2, ng,
area, mat at each table slot) feeds the NEE path for constant emission.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .core.distribution import AliasTable
from .core.math import dot, face_forward, length_squared, offset_ray_origin
from .core.sampling import uniform_sample_triangle


class LightArrays(NamedTuple):
    sel_prob: torch.Tensor  # [L] f32
    sel_alias: torch.Tensor  # [L] i32
    sel_pdf: torch.Tensor  # [L] f32
    tri_prob: torch.Tensor  # [S] f32
    tri_alias: torch.Tensor  # [S] i32
    tri_pdf: torch.Tensor  # [S] f32
    tri_ids: torch.Tensor  # [S] i32 global triangle id of each table entry
    offset: torch.Tensor  # [L] i32
    count: torch.Tensor  # [L] i32
    tri_prim_pdf: torch.Tensor  # [T] f32 pdf of a tri within its light (0 if none)
    tri_light_id: torch.Tensor  # [T] i32 light id or -1
    attr: torch.Tensor | None = None  # [S, 14] compact NEE table

    @property
    def num_lights(self) -> int:
        return self.sel_prob.shape[0]

    @staticmethod
    def build_numpy(light_powers: list, light_tri_ids: list, num_tris: int) -> dict:
        """The light tables as numpy arrays (same values as the JAX build)."""
        if not light_powers:
            zf, zi = np.zeros((0,), np.float32), np.zeros((0,), np.int32)
            return dict(
                sel_prob=zf, sel_alias=zi, sel_pdf=zf, tri_prob=zf, tri_alias=zi,
                tri_pdf=zf, tri_ids=zi, offset=zi, count=zi,
                tri_prim_pdf=np.zeros((num_tris,), np.float32),
                tri_light_id=np.full((num_tris,), -1, np.int32),
            )
        totals = np.array([p.sum() for p in light_powers], np.float64)
        sel = AliasTable.build(totals)
        tabs = [AliasTable.build(p) for p in light_powers]
        counts = np.array([len(p) for p in light_powers], np.int32)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
        tri_prim_pdf = np.zeros(num_tris, np.float32)
        tri_light_id = np.full(num_tris, -1, np.int32)
        for l, (tab, ids) in enumerate(zip(tabs, light_tri_ids)):
            tri_prim_pdf[ids] = tab.pdf
            tri_light_id[ids] = l
        return dict(
            sel_prob=sel.prob, sel_alias=sel.alias, sel_pdf=sel.pdf,
            tri_prob=np.concatenate([t.prob for t in tabs]),
            tri_alias=np.concatenate([t.alias for t in tabs]),
            tri_pdf=np.concatenate([t.pdf for t in tabs]),
            tri_ids=np.concatenate(light_tri_ids).astype(np.int32),
            offset=offsets, count=counts,
            tri_prim_pdf=tri_prim_pdf, tri_light_id=tri_light_id,
        )

    @staticmethod
    def from_numpy(arrays: dict, device) -> "LightArrays":
        fields = {k: torch.as_tensor(np.array(v), device=device) for k, v in arrays.items()}
        return LightArrays(**fields)


class LightSample(NamedTuple):
    li: torch.Tensor  # [N, 3] radiance (zero if back-facing)
    pdf: torch.Tensor  # [N] solid-angle pdf times light-choice pdf
    wi: torch.Tensor  # [N, 3]
    shadow_ro: torch.Tensor  # [N, 3]
    shadow_dist: torch.Tensor  # [N]
    dest_tri: torch.Tensor  # [N] i32 sampled triangle (shadow-ray exclusion)
    valid: torch.Tensor  # [N] bool


def _alias_sample(prob, alias, pdf, base, count, u):
    """Sample from the sub-table [base, base + count)."""
    scaled = u * count.to(torch.float32)
    i = torch.minimum(torch.clamp(scaled.to(torch.int32), min=0), count - 1)
    frac = scaled - i.to(torch.float32)
    gi = (base + i).long()
    p = prob[gi]
    take_own = frac < p
    out = torch.where(take_own, i, alias[gi])
    remapped = torch.where(
        take_own, frac / torch.clamp(p, min=1e-20), (frac - p) / torch.clamp(1.0 - p, min=1e-20)
    )
    return out, pdf[(base + out).long()], torch.clamp(remapped, 0.0, 1.0)


def sample_light_point_ex(lights: LightArrays, u_select, u_sample):
    """Pick (light, triangle, barycentric point) plus the table slot:
    returns (light, light_choice_pdf, tri, prim_pdf, bary, slot)."""
    n_lights = lights.num_lights
    scaled = u_select * n_lights
    li_ = torch.clamp(scaled.to(torch.int32), 0, n_lights - 1)
    frac = scaled - li_.to(torch.float32)
    li_l = li_.long()
    p = lights.sel_prob[li_l]
    take_own = frac < p
    light = torch.where(take_own, li_, lights.sel_alias[li_l])
    u_rem = torch.where(
        take_own, frac / torch.clamp(p, min=1e-20), (frac - p) / torch.clamp(1.0 - p, min=1e-20)
    )
    light_l = light.long()
    light_choice_pdf = lights.sel_pdf[light_l]
    base = lights.offset[light_l]
    count = lights.count[light_l]
    local_tri, prim_pdf, _ = _alias_sample(
        lights.tri_prob, lights.tri_alias, lights.tri_pdf, base, count,
        torch.clamp(u_rem, 0.0, 1.0 - 1e-7),
    )
    slot = base + local_tri
    tri = lights.tri_ids[slot.long()]
    bary = uniform_sample_triangle(u_sample)
    return light, light_choice_pdf, tri, prim_pdf, bary, slot


def light_point_attrs(lights: LightArrays, slot, bary):
    """Compact NEE fetch at a sampled table slot: (p, ng, area, mat).
    A row gather takes the place of the JAX package's one-hot matmul; the
    values are the same rows."""
    rows = lights.attr[slot.long()]
    b0 = bary[..., 0:1]
    b1 = bary[..., 1:2]
    p = rows[..., 0:3] + rows[..., 3:6] * b0 + rows[..., 6:9] * b1
    ng = rows[..., 9:12]
    area = rows[..., 12]
    mat = rows[..., 13].to(torch.int32)
    return p, ng, area, mat


def finish_light_sample(light_choice_pdf, prim_pdf, tri, p_light, n_light, area, pn_p, pn_n):
    """Solid-angle pdf conversion and shadow-ray setup. li is left zero:
    the caller fills in the emission."""
    wi_raw = p_light - pn_p
    dist2 = length_squared(wi_raw)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-30))
    wi = wi_raw / dist[..., None]
    cos_theta = torch.abs(dot(n_light, wi))
    pdf = prim_pdf / torch.clamp(area, min=1e-20) * dist2 / torch.clamp(cos_theta, min=1e-20)
    pdf = pdf * light_choice_pdf
    ro = offset_ray_origin(pn_p, face_forward(pn_n, wi))
    valid = torch.isfinite(pdf) & (dist2 > 0.0)
    return LightSample(
        li=torch.zeros_like(wi), pdf=pdf, wi=wi, shadow_ro=ro,
        shadow_dist=dist * (1.0 - 1e-3), dest_tri=tri, valid=valid,
    )


def pdf_direct(lights: LightArrays, light, prim_pdf, area, ng, p_light, pn_p):
    """Solid-angle pdf of having sampled the hit light triangle toward pn."""
    choice_pdf = torch.where(
        light >= 0, lights.sel_pdf[torch.clamp(light, min=0).long()], 0.0
    )
    wi = p_light - pn_p
    dist2 = length_squared(wi)
    wi = wi / torch.sqrt(torch.clamp(dist2, min=1e-30))[..., None]
    pdf = prim_pdf / torch.clamp(area, min=1e-20) * dist2 / torch.clamp(
        torch.abs(dot(ng, wi)), min=1e-6
    )
    return pdf * choice_pdf
