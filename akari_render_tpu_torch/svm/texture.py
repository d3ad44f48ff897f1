"""Texture sampling from an atlas of 2D images (port of
akari_render_tpu/svm/texture.py::TextureAtlas and sample_texture).

Perlin noise is not ported yet: scenes with a noise node are refused at
load_scene (svm/eval.py::check_kind).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TextureAtlas(NamedTuple):
    data: torch.Tensor  # [L, H, W, 4] float32, images padded to the largest
    sizes: torch.Tensor  # [L, 2] int32 (width, height)

    @staticmethod
    def build_numpy(images: list) -> tuple:
        """(data, sizes) numpy arrays from [h, w, 4] float32 images."""
        if not images:
            images = [np.zeros((1, 1, 4), np.float32)]
        mh = max(im.shape[0] for im in images)
        mw = max(im.shape[1] for im in images)
        data = np.zeros((len(images), mh, mw, 4), np.float32)
        sizes = np.zeros((len(images), 2), np.int32)
        for i, im in enumerate(images):
            h, w = im.shape[:2]
            data[i, :h, :w] = im
            sizes[i] = (w, h)
        return data, sizes

    @staticmethod
    def from_numpy(data, sizes, device) -> "TextureAtlas":
        return TextureAtlas(
            torch.as_tensor(np.asarray(data, np.float32), device=device),
            torch.as_tensor(np.asarray(sizes, np.int32), device=device),
        )


def _address(i, n, mode: str):
    if mode == "repeat":
        return torch.remainder(i, n)
    if mode == "mirror":
        period = 2 * n
        j = torch.remainder(i, period)
        return torch.where(j >= n, period - 1 - j, j)
    return torch.minimum(torch.clamp(i, min=0), n - 1)  # extend, and clip's index


def sample_texture(atlas: TextureAtlas | None, layer, uv, extension: str, interpolation: str):
    """Bilinear or nearest sample of [N] layers at [N, 2] uvs -> [N, 4]."""
    if atlas is None:
        return torch.ones(uv.shape[:-1] + (4,), device=uv.device)
    layer = layer.long()
    wi_ = atlas.sizes[layer, 0]
    hi_ = atlas.sizes[layer, 1]
    x = uv[..., 0] * wi_.to(torch.float32) - 0.5
    y = uv[..., 1] * hi_.to(torch.float32) - 0.5

    def fetch(ix, iy):
        cx = _address(ix, wi_, extension)
        cy = _address(iy, hi_, extension)
        val = atlas.data[layer, cy.long(), cx.long()]
        if extension == "clip":
            inside = (ix >= 0) & (ix < wi_) & (iy >= 0) & (iy < hi_)
            val = torch.where(inside[..., None], val, 0.0)
        return val

    if interpolation == "nearest":
        return fetch(torch.round(x).to(torch.int32), torch.round(y).to(torch.int32))
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    return c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy) + c01 * (1 - fx) * fy + c11 * fx * fy
