"""Film: per-pixel weighted color sums (port of akari_render_tpu/core/film.py,
the parts PT and AOV use). Lane i of a PT wavefront IS pixel i, so its
accumulation is an elementwise add; AOV bins each sample by its raster
position (a scatter add). The film is updated in place."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .color import remove_nan


@dataclass
class Film:
    accum: torch.Tensor  # [H*W, 3] weighted color sum
    weight: torch.Tensor  # [H*W] filter weight sum

    @staticmethod
    def new(width: int, height: int, device) -> "Film":
        n = width * height
        return Film(
            accum=torch.zeros((n, 3), dtype=torch.float32, device=device),
            weight=torch.zeros((n,), dtype=torch.float32, device=device),
        )


def add_samples_aligned(film: Film, color, weight) -> None:
    """Accumulate one sample per pixel, in place (pt.rs:1100 binning: the
    filter jitter perturbs the ray only)."""
    film.accum += remove_nan(color) * weight[..., None]
    film.weight += weight


def linear_index(p, width: int, height: int):
    """Raster position [..., 2] float -> flat pixel index, with clamping."""
    ip = torch.floor(p).to(torch.int64)
    ix = torch.clamp(ip[..., 0], 0, width - 1)
    iy = torch.clamp(ip[..., 1], 0, height - 1)
    return iy * width + ix


def add_samples(film: Film, p, color, weight, width: int, height: int) -> None:
    """Accumulate filter-weighted samples at raster positions p [N, 2], in
    place (ref film.rs add_sample)."""
    idx = linear_index(p, width, height)
    film.accum.index_add_(0, idx, remove_nan(color) * weight[..., None])
    film.weight.index_add_(0, idx, weight)


def develop(film: Film, width: int, height: int):
    """Resolve to an [H, W, 3] image: accum / weight."""
    w = torch.where(film.weight == 0.0, 1.0, film.weight)
    return (film.accum / w[..., None]).reshape(height, width, 3)
