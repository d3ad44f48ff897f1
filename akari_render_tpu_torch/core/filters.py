"""Pixel reconstruction filters, by importance sampling only (port of
akari_render_tpu/core/filters.py): the filter jitters the sample position
and always returns weight 1."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .sampling import TWO_PI


@dataclass(frozen=True)
class BoxFilter:
    radius: float = 0.5

    def sample(self, u):
        """u: [..., 2] uniform -> (offset [..., 2], weight [...])."""
        return (u - 0.5) * self.radius, torch.ones(u.shape[:-1], device=u.device)


@dataclass(frozen=True)
class GaussianFilter:
    radius: float = 1.5

    def sample(self, u):
        sigma = self.radius / 3.0
        r = torch.sqrt(-2.0 * torch.log(torch.clamp(u[..., 0], min=1e-10)))
        theta = TWO_PI * u[..., 1]
        off = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1) * sigma
        off = torch.clamp(off, -self.radius, self.radius)
        return off, torch.ones(u.shape[:-1], device=u.device)


def filter_from_config(cfg: dict | None):
    """Filter from the reference's JSON schema ({"type", "radius"})."""
    if cfg is None:
        return GaussianFilter(1.5)
    t = cfg.get("type", "gaussian")
    if t == "box":
        return BoxFilter(cfg.get("radius", 0.5))
    if t == "gaussian":
        return GaussianFilter(cfg.get("radius", 1.5))
    raise ValueError(f"unknown filter type: {t}")
