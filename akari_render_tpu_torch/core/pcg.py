"""PCG32 (PCG-XSH-RR 64/32), batched, bit-exact with the JAX package.

Port of akari_render_tpu/core/pcg.py. torch has no full uint64
arithmetic, so the 64-bit state lives in int64 tensors: multiply and add
wrap modulo 2^64 in two's complement exactly as uint64 does, and right
shifts are made logical by masking. uint32 values live in int64 tensors
masked to 0xFFFFFFFF.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

MASK32 = 0xFFFFFFFF


def to_i64(x: int) -> int:
    """A uint64 Python int as the int64 with the same bits."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >= (1 << 63) else x


_PCG_MULT = to_i64(6364136223846793005)


def shr64(x, n: int):
    """Logical right shift of a uint64 held in int64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def u64_from_limbs(hi, lo):
    """(hi, lo) uint32 limbs (int64 tensors) -> uint64 bits in int64."""
    return (hi << 32) | (lo & MASK32)


class Pcg32(NamedTuple):
    state: torch.Tensor  # [N] int64 (uint64 bits)
    inc: torch.Tensor  # [N] int64 (uint64 bits, odd)

    @staticmethod
    def new_seq(seq: torch.Tensor, seed: int = 0x853C49E6748FEA9B) -> "Pcg32":
        """pcg32_srandom(seed, seq): one generator per lane; seq is the
        per-lane uint64 stream id held in int64."""
        inc = (seq << 1) | 1
        st = Pcg32(torch.zeros_like(inc), inc)
        st, _ = pcg32_next(st)
        st = Pcg32(st.state + to_i64(seed), st.inc)
        st, _ = pcg32_next(st)
        return st


def pcg32_next(rng: Pcg32):
    """Advance one step: (new state, uint32 output in int64)."""
    old = rng.state
    new_state = old * _PCG_MULT + rng.inc
    xorshifted = shr64(shr64(old, 18) ^ old, 27) & MASK32
    rot = shr64(old, 59)
    out = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & MASK32
    return Pcg32(new_state, rng.inc), out


def pcg32_next_f32(rng: Pcg32):
    """Uniform float32 in [0, 1) with 24 bits of precision."""
    rng, bits = pcg32_next(rng)
    return rng, (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
