"""Per-lane random streams (port of akari_render_tpu/core/samplers.py:
IndependentSampler). A sampler is a NamedTuple of per-lane state; each
draw returns (new sampler, value), as in the JAX package."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .pcg import MASK32, Pcg32, pcg32_next_f32, u64_from_limbs


def _hash_u64(hi, lo):
    """Mix two uint32s (int64 tensors or ints) into one uint32."""
    x = (lo ^ ((hi * 0x9E3779B9) & MASK32)) & MASK32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & MASK32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & MASK32
    x = x ^ (x >> 16)
    return x


class IndependentSampler(NamedTuple):
    """One PCG32 stream per lane."""

    rng: Pcg32

    @staticmethod
    def new(lane_ids, seed: int = 0) -> "IndependentSampler":
        lane_ids = lane_ids.to(torch.int64) & MASK32
        seq = _hash_u64(seed & MASK32, lane_ids)
        return IndependentSampler(Pcg32.new_seq(u64_from_limbs(lane_ids, seq)))

    def next_1d(self):
        rng, u = pcg32_next_f32(self.rng)
        return IndependentSampler(rng), u

    def next_2d(self):
        s, a = self.next_1d()
        s, b = s.next_1d()
        return s, torch.stack([a, b], dim=-1)

    def next_3d(self):
        s, a = self.next_1d()
        s, b = s.next_1d()
        s, c = s.next_1d()
        return s, torch.stack([a, b, c], dim=-1)
