"""Film: per-pixel weighted color sums and splats (port of
akari_render_tpu/core/film.py). Lane i of a PT wavefront IS pixel i, so its
accumulation is an elementwise add; AOV and GPT bin each sample by its
raster position, and MCMC splats there (scatter adds: on the card their
float sums run in any order). The film is updated in place; the splat
buffer is allocated by the first splat (PT and AOV never splat)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .color import remove_nan


@dataclass
class Film:
    accum: torch.Tensor  # [H*W, 3] weighted color sum
    weight: torch.Tensor  # [H*W] filter weight sum
    splat: torch.Tensor | None = None  # [H*W, 3] splat sum (MCMC), or None

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


def add_splats(film: Film, p, color, weight, width: int, height: int, mask=None) -> None:
    """Splat weighted colors at raster positions p [N, 2], in place (no
    weight accumulation; scaled by develop's splat_scale). The index is
    clamped into the film, so JAX's drop of out-of-range indices never
    applies; mask [N] bool zeroes the other lanes."""
    idx = linear_index(p, width, height)
    color = remove_nan(color) * weight[..., None]
    if mask is not None:
        color = torch.where(mask[..., None], color, 0.0)
    if film.splat is None:
        film.splat = torch.zeros_like(film.accum)
    film.splat.index_add_(0, idx, color)


def develop(film: Film, width: int, height: int, splat_scale: float = 1.0):
    """Resolve to an [H, W, 3] image: accum / weight + splat * splat_scale
    (film.rs:120-148)."""
    w = torch.where(film.weight == 0.0, 1.0, film.weight)
    rgb = film.accum / w[..., None]
    if film.splat is not None:
        rgb = rgb + film.splat * splat_scale
    return rgb.reshape(height, width, 3)
