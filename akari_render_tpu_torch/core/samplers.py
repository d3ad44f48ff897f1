"""Per-lane random streams (port of akari_render_tpu/core/samplers.py:
IndependentSampler and HashSampler). A sampler is a NamedTuple of per-lane
state; each draw returns (new sampler, value), as in the JAX package.

uint32 values live in int64 tensors masked to 0xFFFFFFFF (core/pcg.py):
a product of two of them can wrap the int64, but its low 32 bits are
exact, and every shift is taken on a masked, non-negative value.

Every sampler type has one row operation, `sampler.take(ids)` (the rows
ids: the split pass's compaction). It passes a sampler's shared leaves
(pmj02's [S * N, 2] table, named in `_shared`) and its one-for-all-lanes
Python ints through untouched.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .pcg import MASK32, Pcg32, pcg32_next_f32, u64_from_limbs

GOLDEN = 0x9E3779B9


def hash_u64(hi, lo):
    """samplers._hash_u64: mix two uint32s (int64 tensors or Python ints)
    into one uint32 (splitmix-style). The path megakernel's hash stream
    (integrators/megakernel.py) keys its pixels with it too."""
    x = (lo ^ ((hi * GOLDEN) & MASK32)) & MASK32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & MASK32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & MASK32
    return x ^ (x >> 16)


def hash_draw(key, ctr):
    """HashSampler.next_1d on raw state: (ctr + 1, a float32 uniform in
    [0, 1) with 24 bits) from the uint32 key (int64 tensor) and the
    dimension counter (tensor or int)."""
    x = key ^ ((ctr * GOLDEN) & MASK32)
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & MASK32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & MASK32
    x = x ^ (x >> 15)
    return (ctr + 1) & MASK32, (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _map_rows(fn, a, shared=()):
    """Apply fn to every per-lane leaf of the sampler NamedTuple a, nested
    NamedTuples included; shared leaves and Python ints pass through."""
    out = {}
    for name, x in zip(a._fields, a):
        if isinstance(x, tuple):
            out[name] = _map_rows(fn, x, getattr(x, "_shared", ()))
        elif name in shared or not isinstance(x, torch.Tensor):
            out[name] = x
        else:
            out[name] = fn(x)
    return type(a)(**out)


def take(sampler, ids):
    """The sampler of the lanes ids (an index tensor)."""
    return _map_rows(lambda x: x[ids], sampler, getattr(sampler, "_shared", ()))


def next_2d(sampler):
    """Two next_1d draws stacked [N, 2] (every sampler's next_2d)."""
    s, a = sampler.next_1d()
    s, b = s.next_1d()
    return s, torch.stack([a, b], dim=-1)


def next_3d(sampler):
    """Three next_1d draws stacked [N, 3] (every sampler's next_3d)."""
    s, a = sampler.next_1d()
    s, b = s.next_1d()
    s, c = s.next_1d()
    return s, torch.stack([a, b, c], dim=-1)


class IndependentSampler(NamedTuple):
    """One PCG32 stream per lane."""

    rng: Pcg32

    @staticmethod
    def new(lane_ids, seed: int = 0) -> "IndependentSampler":
        lane_ids = lane_ids.to(torch.int64) & MASK32
        seq = hash_u64(seed & MASK32, lane_ids)
        return IndependentSampler(Pcg32.new_seq(u64_from_limbs(lane_ids, seq)))

    def next_1d(self):
        rng, u = pcg32_next_f32(self.rng)
        return IndependentSampler(rng), u

    next_2d = next_2d
    next_3d = next_3d
    take = take


class HashSampler(NamedTuple):
    """Stateless counter-based stream (AKR_RNG=hash): u_i = finalize(key,
    dimension counter), one uint32 key and one counter a lane. Not
    bit-compatible with the PCG32 stream: an opt-in."""

    key: torch.Tensor  # [N] uint32 per-lane stream key (int64)
    ctr: torch.Tensor  # [N] uint32 dimension counter (int64)

    @staticmethod
    def new(lane_ids, seed: int = 0) -> "HashSampler":
        lane_ids = lane_ids.to(torch.int64) & MASK32
        key = hash_u64(seed & MASK32, lane_ids)
        return HashSampler(key, torch.zeros_like(lane_ids))

    def next_1d(self):
        ctr, u = hash_draw(self.key, self.ctr)
        return HashSampler(self.key, ctr), u

    next_2d = next_2d
    next_3d = next_3d
    take = take
