"""Regenerated blue-noise textures for the pmj02bn sampler (a copy of
akari_render_tpu/core/bluenoise.py, numpy only; cached in build/cache/,
not under ~/.cache). Nothing in either package samples them yet.

The reference ships pbrt-v4's pregenerated blue-noise textures
(crates/akari_data bluenoise.rs — git-LFS-missing upstream, like the
pmj02bn tables; consumed by sampler/mod.rs:534-551 as per-pixel
Cranley-Patterson rotations). We REGENERATE equivalent textures with the
classic void-and-cluster algorithm (Ulichney 1993): toroidal Gaussian
energy, three ranking phases, so the resulting dither array's thresholded
point sets are blue-noise at every density. Values are rank/(n*n) in
[0, 1) — exactly the u-offset distribution the rotation needs.

Resolution/count deviation from pbrt's 128^2 x 48: we generate 64^2 x 16
(cached); the rotation wraps pixel coordinates mod the resolution either
way, and a 64^2 tile already decorrelates neighboring pixels at every
dimension — the table cost is paid once per cache lifetime.
"""
from __future__ import annotations

import numpy as np

from .cache import cached_array

RESOLUTION = 64
N_TEXTURES = 16
_SIGMA = 1.9


def _energy(mask: np.ndarray, kernel_f: np.ndarray) -> np.ndarray:
    return np.real(np.fft.ifft2(np.fft.fft2(mask) * kernel_f))


def _kernel_f(n: int) -> np.ndarray:
    ax = np.arange(n)
    d = np.minimum(ax, n - ax).astype(np.float64)
    d2 = d[:, None] ** 2 + d[None, :] ** 2
    k = np.exp(-d2 / (2.0 * _SIGMA * _SIGMA))
    return np.fft.fft2(k)


def _void_and_cluster(n: int, rng: np.random.Generator) -> np.ndarray:
    """One n x n dither array, ranks 0..n*n-1 (Ulichney's three phases)."""
    kf = _kernel_f(n)
    npx = n * n
    n_init = npx // 10
    mask = np.zeros((n, n), bool)
    idx = rng.choice(npx, n_init, replace=False)
    mask.flat[idx] = True
    # phase 0: relax the initial pattern (tightest cluster -> largest void)
    for _ in range(npx):
        e = _energy(mask, kf)
        cluster = np.argmax(np.where(mask, e, -np.inf))
        mask.flat[cluster] = False
        e = _energy(mask, kf)
        void = np.argmin(np.where(mask, np.inf, e))
        if void == cluster:
            mask.flat[cluster] = True
            break
        mask.flat[void] = True
    ranks = np.zeros((n, n), np.int32)
    # phase 1: remove from the prototype, ranking n_init-1 .. 0
    work = mask.copy()
    for rank in range(n_init - 1, -1, -1):
        e = _energy(work, kf)
        cluster = np.argmax(np.where(work, e, -np.inf))
        work.flat[cluster] = False
        ranks.flat[cluster] = rank
    # phase 2: fill voids, ranking n_init .. npx-1
    work = mask.copy()
    for rank in range(n_init, npx):
        e = _energy(work, kf)
        void = np.argmin(np.where(work, np.inf, e))
        work.flat[void] = True
        ranks.flat[void] = rank
    return ranks


_cache: np.ndarray | None = None


def _make() -> np.ndarray:
    rng = np.random.default_rng(0x9e3779b9)
    n = RESOLUTION
    return np.stack(
        [_void_and_cluster(n, rng) for _ in range(N_TEXTURES)]
    ).astype(np.float32) / float(n * n)


def blue_noise_textures() -> np.ndarray:
    """[N_TEXTURES, RESOLUTION, RESOLUTION] float32 in [0, 1) (numpy),
    disk-cached in build/cache/."""
    global _cache
    if _cache is None:
        _cache = cached_array(f"bluenoise_{RESOLUTION}_{N_TEXTURES}.npy", _make)
    return _cache
