"""Sampler factory (port of akari_render_tpu/core/lds.py::make_sampler,
independent branch only).

The JAX module also holds Owen-Sobol, pmj02bn and hash samplers; they are
not ported yet and raise NotImplementedError here.
"""
from __future__ import annotations

import torch

from .pcg import MASK32, Pcg32, u64_from_limbs
from .samplers import IndependentSampler


def make_sampler(config: dict | None, pixel_ids, sample_index: int, seed_extra: int = 0):
    """Sampler from the reference's sampler JSON ({"type", "seed"}).

    pixel_ids: [N] integer tensor; sample_index: the absolute sample
    number (a Python int). The seed handling mirrors the JAX package call
    for call, including its fault: PT passes the task seed as seed_extra,
    which cancels the configured seed (seed ^ seed == 0)."""
    t = (config or {}).get("type", "independent")
    if t != "independent":
        raise NotImplementedError(f"sampler {t!r} is not yet ported")
    seed = int((config or {}).get("seed", 0)) ^ seed_extra
    seed = (seed * 0x9E3779B9) & MASK32
    hi = torch.full_like(pixel_ids, (int(sample_index) ^ seed) & MASK32, dtype=torch.int64)
    seq = u64_from_limbs(hi, pixel_ids.to(torch.int64) & MASK32)
    return IndependentSampler(Pcg32.new_seq(seq))
