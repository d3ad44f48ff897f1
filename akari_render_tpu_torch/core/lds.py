"""Low-discrepancy samplers and the sampler factory (port of
akari_render_tpu/core/lds.py): Owen-scrambled Sobol ("sobol"/"lds"),
table-driven pmj02 ("pmj02bn") and `make_sampler`, which also builds the
independent PCG32 and hash samplers (core/samplers.py).

uint32 arithmetic is done in int64 with masks, as in core/pcg.py: a product
with a constant above 2^31 (0x846CA68B, the Laine-Karras constants) can wrap
the int64 and come out negative, but its low 32 bits are exact, so every
product is masked before anything shifts it. The hash and bit functions
also take Python ints, with the same bits.

A sample index or dimension that is the same on every lane stays a Python
int: the JAX package carries both as [N] arrays, but all lanes of a sampler
draw together, so the dimension counter is one number, and a render's
sample index is one number a wavefront. The draws are those of the [N]
forms bit for bit; what is one value for all lanes is computed once on the
host, and a stashed second component is returned without drawing a new
pair (JAX computes and discards one). A per-lane [N] sample index (a
tensor) takes the [N] path. Every sampler's lanes draw in lockstep, so the
dimension is always one Python int.
"""
from __future__ import annotations

import os
import threading
from typing import NamedTuple

import numpy as np
import torch

from .pcg import MASK32, Pcg32, u64_from_limbs
from .pmj02 import N_PMJ02_SAMPLES, N_PMJ02_SETS, get_pmj02_tables
from .samplers import (
    GOLDEN, HashSampler, IndependentSampler, hash_u64, next_2d, next_3d, take,
)


def _hash(x):
    """finalizer (lowbias32)."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & MASK32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & MASK32
    return x ^ (x >> 16)


def _hash_combine(a, b):
    return _hash(a ^ ((_hash(b) + GOLDEN) & MASK32))


def reverse_bits32(x):
    x = x & MASK32
    x = ((x << 16) | (x >> 16)) & MASK32
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    return ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)


def _laine_karras_permutation(x, seed):
    """Fast-Owen bit permutation (Laine-Karras), on reversed bits."""
    x = (x + seed) & MASK32
    x = x ^ ((x * 0x6C50B47C) & MASK32)
    x = x ^ ((x * 0xB82F1E52) & MASK32)
    x = x ^ ((x * 0xC7AFE638) & MASK32)
    return x ^ ((x * 0x8D22F6E6) & MASK32)


def owen_scramble(x, seed):
    """Owen-scramble a [0, 2^32) sample value."""
    return reverse_bits32(_laine_karras_permutation(reverse_bits32(x), seed))


def sobol_dim1(index):
    """First Sobol dimension: radical inverse base 2."""
    return reverse_bits32(index)


def _sobol2_directions() -> list[int]:
    """The 32 direction numbers of Sobol dimension 2."""
    v = [1 << 31]
    for _ in range(31):
        v.append(v[-1] ^ (v[-1] >> 1))
    return v


_SOBOL2 = _sobol2_directions()
_SOBOL2_BYTES: dict = {}  # device -> [4, 256] int64: the XOR of each byte's directions
_SOBOL2_LOCK = threading.Lock()


def _sobol2_byte_tables(device) -> torch.Tensor:
    with _SOBOL2_LOCK:
        if device not in _SOBOL2_BYTES:
            tab = np.zeros((4, 256), np.int64)
            for byte in range(4):
                for b in range(256):
                    for k in range(8):
                        if (b >> k) & 1:
                            tab[byte, b] ^= _SOBOL2[8 * byte + k]
            _SOBOL2_BYTES[device] = torch.from_numpy(tab).to(device)
        return _SOBOL2_BYTES[device]


def sobol_dim2(index):
    """Second Sobol dimension: the XOR of the direction numbers of index's
    set bits (JAX loops over the 32 bits; XOR is associative, so a table a
    byte gives the same bits in four gathers)."""
    if not isinstance(index, torch.Tensor):
        index &= MASK32
        out = 0
        for k in range(32):
            if (index >> k) & 1:
                out ^= _SOBOL2[k]
        return out
    tab = _sobol2_byte_tables(index.device)
    index = index & MASK32
    out = tab[0][index & 0xFF]
    for byte in range(1, 4):
        out = out ^ tab[byte][(index >> (8 * byte)) & 0xFF]
    return out


def _to_f(bits):
    """A 24-bit fixed-point tensor as float32 in [0, 1)."""
    return bits.to(torch.float32) * (1.0 / (1 << 24))


def sobol02_owen(sample_index, pair_seed):
    """Owen-scrambled (0,2) Sobol pair. sample_index: [N] tensor or int;
    pair_seed: [N] per-(pixel, dimension pair) key. Returns (u0, u1)."""
    x = owen_scramble(sobol_dim1(sample_index), _hash_combine(pair_seed, 0x1234_5678))
    y = owen_scramble(sobol_dim2(sample_index), _hash_combine(pair_seed, 0x8765_4321))
    return _to_f(x >> 8), _to_f(y >> 8)


class SobolSampler(NamedTuple):
    """Padded Owen-Sobol sampler: one lane a pixel, the sample index the
    spp counter, so each pixel's sequence is stratified across passes."""

    pixel_hash: torch.Tensor  # [N] hash of (pixel, seed)
    sample_index: object  # int, or [N] int64 tensor
    dim: int  # dimension counter, one for all lanes
    cache: torch.Tensor | None  # [N] stashed second component of the pair

    @staticmethod
    def new(pixel_ids, sample_index, seed: int = 0) -> "SobolSampler":
        return SobolSampler(_hash_combine(pixel_ids.to(torch.int64) & MASK32, seed & MASK32),
                            _lane_index(sample_index), 0, None)

    def _pair(self, pair):
        return sobol02_owen(self.sample_index, _hash_combine(self.pixel_hash, pair))

    def next_1d(self):
        return _next_1d(self)

    next_2d = next_2d
    next_3d = next_3d
    take = take


_PMJ02: dict = {}  # device -> [S * N, 2] int32 24-bit fixed point
_PMJ02_LOCK = threading.Lock()


def pmj02_tables(device) -> torch.Tensor:
    """The pmj02 tables (core/pmj02.py, built or read from build/cache/ at
    first use) as [S * N, 2] int32 24-bit fixed point on `device`: the
    JAX package's `_pmj02_tables_device` bits. Raises if they cannot be
    built."""
    device = torch.device(device)
    with _PMJ02_LOCK:
        if device not in _PMJ02:
            tabs = get_pmj02_tables()  # [S, N, 2] float32
            s, n, _ = tabs.shape
            # 24-bit fixed point so per-pixel XOR scrambling is exact bit math
            bits = np.minimum((tabs.reshape(s * n, 2) * (1 << 24)).astype(np.uint32),
                              (1 << 24) - 1)
            _PMJ02[device] = torch.from_numpy(bits.astype(np.int32)).to(device)
        return _PMJ02[device]


class Pmj02Sampler(NamedTuple):
    """Table-driven pmj02 sampler (the reference's Pmj02BnSampler with the
    regenerated tables of core/pmj02.py). Dimension pair p of pixel q
    reads set hash(p) % S, point sample_index % N, XOR-scrambled by
    hash(q, p, epoch) with epoch = sample_index // N: a per-pixel random
    digit scramble, which keeps every (0,2) elementary-interval property."""

    tables: torch.Tensor  # [S * N, 2] int32 24-bit fixed point, shared by every lane
    pixel_hash: torch.Tensor  # [N] hash of (pixel, seed)
    sample_index: object  # int, or [N] int64 tensor
    dim: int
    cache: torch.Tensor | None

    _shared = ("tables",)

    @staticmethod
    def new(pixel_ids, sample_index, seed: int = 0) -> "Pmj02Sampler":
        return Pmj02Sampler(
            pmj02_tables(pixel_ids.device),
            _hash_combine(pixel_ids.to(torch.int64) & MASK32, seed & MASK32),
            _lane_index(sample_index), 0, None)

    def _pair(self, pair):
        s, n = N_PMJ02_SETS, N_PMJ02_SAMPLES
        si = self.sample_index  # masked and non-negative: // and % are the uint32 ones
        row = self.tables[_hash(pair) % s * n + si % n]  # [2] or [N, 2]
        scr = _hash_combine(self.pixel_hash, _hash_combine(pair, si // n))
        mask = (1 << 24) - 1
        return _to_f(row[..., 0] ^ (scr & mask)), _to_f(row[..., 1] ^ ((scr >> 8) & mask))

    def next_1d(self):
        return _next_1d(self)

    next_2d = next_2d
    next_3d = next_3d
    take = take


def _next_1d(sampler):
    """next_1d of a pair-drawing sampler (Sobol, pmj02): the stashed second
    component at an odd dimension, else the first of a fresh pair; the
    choice is made once for all lanes."""
    dim = sampler.dim
    if dim % 2 == 1:
        return sampler._replace(dim=dim + 1), sampler.cache
    u0, u1 = sampler._pair(dim // 2)
    return sampler._replace(dim=dim + 1, cache=u1), u0


def _lane_index(sample_index):
    """A sample index as the samplers keep it: a Python int (one for all
    lanes) or an [N] int64 tensor, masked to uint32."""
    if isinstance(sample_index, torch.Tensor):
        return sample_index.to(torch.int64) & MASK32
    return int(sample_index) & MASK32


def make_sampler(config: dict | None, pixel_ids, sample_index, seed_extra: int = 0):
    """Sampler from the reference's sampler JSON ({"type", "seed"}).

    pixel_ids: [N] integer tensor; sample_index: the absolute sample number,
    a Python int or an [N] integer tensor on the lanes' device. The branches
    are the JAX package's: AKR_RNG=hash turns `independent` into the hash
    sampler, "sobol"/"lds" and "pmj02bn" pick theirs, and any other type
    falls to `independent`. The seed handling mirrors the JAX package call
    for call, including its fault: PT passes the task seed as seed_extra,
    which cancels the configured seed (seed ^ seed == 0)."""
    t = (config or {}).get("type", "independent")
    if t == "independent" and os.environ.get("AKR_RNG") == "hash":
        t = "hash"
    seed = int((config or {}).get("seed", 0)) ^ seed_extra
    # scramble the seed before it meets the sample index (seed 0 is unchanged)
    seed = (seed * GOLDEN) & MASK32
    if t == "pmj02bn":
        return Pmj02Sampler.new(pixel_ids, sample_index, seed=seed)
    if t in ("sobol", "lds"):
        return SobolSampler.new(pixel_ids, sample_index, seed=seed)
    pix = pixel_ids.to(torch.int64) & MASK32
    hi = _lane_index(sample_index) ^ seed
    if t == "hash":
        key = hash_u64(hi, pix)
        return HashSampler(key, torch.zeros_like(key))
    if not isinstance(hi, torch.Tensor):
        hi = torch.full_like(pix, hi)
    return IndependentSampler(Pcg32.new_seq(u64_from_limbs(hi, pix)))
