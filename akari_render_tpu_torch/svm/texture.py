"""Texture sampling from an atlas of 2D images and Blender-compatible
Perlin noise in 1-4D (port of akari_render_tpu/svm/texture.py).

The noise's hashes are Jenkins lookup3 (Blender's hash_uint{,2,3,4}) in
wrapping uint32 arithmetic; uint32 values live in int64 tensors masked to
0xFFFFFFFF, as in core/pcg.py, so they are the JAX package's bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.pcg import MASK32


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


# ---- Perlin noise, Blender-compatible 1-4D ----------------------------------
def _rot(x, k: int):
    return ((x << k) | (x >> (32 - k))) & MASK32


def _jenkins_final(a, b, c):
    c = ((c ^ b) - _rot(b, 14)) & MASK32
    a = ((a ^ c) - _rot(c, 11)) & MASK32
    b = ((b ^ a) - _rot(a, 25)) & MASK32
    c = ((c ^ b) - _rot(b, 16)) & MASK32
    a = ((a ^ c) - _rot(c, 4)) & MASK32
    b = ((b ^ a) - _rot(a, 14)) & MASK32
    c = ((c ^ b) - _rot(b, 24)) & MASK32
    return a, b, c


def _jenkins_mix(a, b, c):
    a = ((a - c) & MASK32) ^ _rot(c, 4)
    c = (c + b) & MASK32
    b = ((b - a) & MASK32) ^ _rot(a, 6)
    a = (a + c) & MASK32
    c = ((c - b) & MASK32) ^ _rot(b, 8)
    b = (b + a) & MASK32
    a = ((a - c) & MASK32) ^ _rot(c, 16)
    c = (c + b) & MASK32
    b = ((b - a) & MASK32) ^ _rot(a, 19)
    a = (a + c) & MASK32
    c = ((c - b) & MASK32) ^ _rot(b, 4)
    b = (b + a) & MASK32
    return a, b, c


def _init(n: int) -> int:
    return (0xDEADBEEF + (n << 2) + 13) & MASK32


def hash_uint(kx):
    init = _init(1)
    return _jenkins_final((init + kx) & MASK32, torch.full_like(kx, init),
                          torch.full_like(kx, init))[2]


def hash_uint2(kx, ky):
    init = _init(2)
    # y goes into a and x into b, as in the JAX package (hash.rs:143-155)
    return _jenkins_final((init + ky) & MASK32, (init + kx) & MASK32,
                          torch.full_like(kx, init))[2]


def hash_uint3(kx, ky, kz):
    init = _init(3)
    return _jenkins_final((init + kx) & MASK32, (init + ky) & MASK32, (init + kz) & MASK32)[2]


def hash_uint4(kx, ky, kz, kw):
    init = _init(4)
    a, b, c = _jenkins_mix((init + kx) & MASK32, (init + ky) & MASK32, (init + kz) & MASK32)
    return _jenkins_final((a + kw) & MASK32, b, c)[2]


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _negate_if(v, cond):
    return torch.where(cond, -v, v)


def _grad1(h, x):
    hh = h & 15
    g = 1.0 + (hh & 7).to(torch.float32)
    return _negate_if(g, (hh & 8) != 0) * x


def _grad2(h, x, y):
    hh = h & 7
    u = torch.where(hh < 4, x, y)
    v = 2.0 * torch.where(hh < 4, y, x)
    return _negate_if(u, (hh & 1) != 0) + _negate_if(v, (hh & 2) != 0)


def _grad3(h, x, y, z):
    hh = h & 15
    u = torch.where(hh < 8, x, y)
    vt = torch.where((hh == 12) | (hh == 14), x, z)
    v = torch.where(hh < 4, y, vt)
    return _negate_if(u, (hh & 1) != 0) + _negate_if(v, (hh & 2) != 0)


def _grad4(h, x, y, z, w):
    hh = h & 31
    u = torch.where(hh < 24, x, y)
    v = torch.where(hh < 16, y, z)
    s = torch.where(hh < 8, z, w)
    return (_negate_if(u, (hh & 1) != 0) + _negate_if(v, (hh & 2) != 0)
            + _negate_if(s, (hh & 4) != 0))


def _floor_split(x):
    """(floor(x) as uint32 bits in int64, the fraction)."""
    i = torch.floor(x)
    return i.to(torch.int32).to(torch.int64) & MASK32, x - i


def _lerp(a, b, t):
    return a * (1 - t) + b * t


def lattice_hashes(p, dim: int) -> list:
    """The hash of each of the 2^dim lattice corners around p [..., dim], in
    the order perlin_noise visits them (x fastest)."""
    cell = [_floor_split(p[..., i])[0] for i in range(dim)]
    fn = (hash_uint, hash_uint2, hash_uint3, hash_uint4)[dim - 1]
    out = []
    for corner in range(1 << dim):
        ks = [(cell[i] + ((corner >> i) & 1)) & MASK32 for i in range(dim)]
        out.append(fn(*ks))
    return out


def perlin_noise(p, dim: int = 2):
    """Blender-compatible Perlin noise in [0, 1]. p: [..., dim]."""
    if not 1 <= dim <= 4:
        raise ValueError(f"perlin dim {dim} unsupported (1-4)")
    fr = [_floor_split(p[..., i])[1] for i in range(dim)]
    grad = (_grad1, _grad2, _grad3, _grad4)[dim - 1]
    vals = [grad(h, *(fr[i] - ((corner >> i) & 1) for i in range(dim)))
            for corner, h in enumerate(lattice_hashes(p, dim))]
    # lerp along x, then y, z and w: adjacent pairs of the corner list
    for i in range(dim):
        t = _fade(fr[i])
        vals = [_lerp(vals[j], vals[j + 1], t) for j in range(0, len(vals), 2)]
    return vals[0] * (0.2500, 0.6616, 0.9820, 0.8344)[dim - 1] * 0.5 + 0.5
