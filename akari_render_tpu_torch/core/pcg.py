"""PCG32 (PCG-XSH-RR 64/32), batched, bit-exact with the JAX package.

Port of akari_render_tpu/core/pcg.py. torch has no full uint64
arithmetic, so the 64-bit state lives in int64 tensors: multiply and add
wrap modulo 2^64 in two's complement exactly as uint64 does, and right
shifts are made logical by masking. uint32 values live in int64 tensors
masked to 0xFFFFFFFF.

Every float draw goes through `pcg32_draws` (d draws a lane in one call),
which routes by the streams' device: CPU tensors take the plain version
(`pcg32_draws_torch`, d `pcg32_next` steps stacked), CUDA tensors launch the
kernel `pcg32_draws` (csrc/pcg.cu: one launch for the call, not 16 eager
int64 launches a draw) or raise. Both give the same bits. stats.counts
holds the lane-draws each took (`pcg_kernel_draws`, `pcg_plain_draws`).
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from .. import stats
from ..accel.nvcc import CSRC, compile_library, read_kernel_info

MASK32 = 0xFFFFFFFF
SOURCE = CSRC / "pcg.cu"

# kernel launches since the last reset; only the kernel branch of
# pcg32_draws adds to it
launches = 0
# seconds the last build took (0.0 when the library came from the cache)
build_seconds = 0.0

_lib = None
_lib_lock = threading.Lock()


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
    rng, u = pcg32_draws(rng, 1)
    return rng, u[..., 0]


def pcg32_draws_torch(rng: Pcg32, d: int):
    """The plain version of pcg32_draws: d pcg32_next steps, each output
    made a float as pcg32_next_f32 does, stacked."""
    us = []
    for _ in range(d):
        rng, bits = pcg32_next(rng)
        us.append((bits >> 8).to(torch.float32) * (1.0 / (1 << 24)))
    return rng, torch.stack(us, -1)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the pcg32_draws library."""
    global _lib, build_seconds
    with _lib_lock:
        if _lib is not None:
            return _lib
        so, secs = compile_library(SOURCE, "pcg")
        if secs:
            build_seconds = secs
        lib = ctypes.CDLL(str(so))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.akr_pcg32_draws.argtypes = [vp, vp, vp, vp, ctypes.c_int64, ci, vp]
        lib.akr_pcg32_draws.restype = ci
        lib.akr_pcg32_draws_kernel_info.argtypes = [vp, ci]
        lib.akr_pcg32_draws_kernel_info.restype = ci
        _lib = lib
        return lib


def kernel_info(d: int) -> dict:
    """The kernel's resources on the current card at d draws a call (its
    shared memory grows with d up to 64 columns; nvcc.read_kernel_info)."""
    return read_kernel_info(build().akr_pcg32_draws_kernel_info, ("pcg32_draws",), d)


def pcg32_draws(rng: Pcg32, d: int):
    """d draws a lane: (rng advanced d steps, u [..., d] float32), u[..., j]
    the j-th pcg32_next_f32 of the lane. CPU streams take the plain
    version; on the card one launch writes a new state tensor (the old one
    stays as it was: a Pcg32 is an immutable carry) and u."""
    global launches
    if d < 1:
        raise ValueError(f"pcg32_draws: d must be at least 1, got {d}")
    state, inc = rng
    dev = state.device
    if dev.type == "cpu":
        stats.counts["pcg_plain_draws"] += state.numel() * d
        return pcg32_draws_torch(rng, d)
    if dev.type != "cuda":
        raise ValueError(f"pcg32_draws: unsupported device {dev}")
    if (state.dtype != torch.int64 or inc.dtype != torch.int64 or inc.device != dev
            or inc.shape != state.shape):
        raise ValueError(f"pcg32_draws: state and inc must be int64 of one shape on one device, "
                         f"got {state.dtype} {tuple(state.shape)} on {dev} and {inc.dtype} "
                         f"{tuple(inc.shape)} on {inc.device}")
    state, inc = state.contiguous(), inc.contiguous()
    n = state.numel()
    new_state = torch.empty_like(state)
    u = torch.empty(state.shape + (d,), dtype=torch.float32, device=dev)
    if n:
        lib = build()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.akr_pcg32_draws(ctypes.c_void_p(state.data_ptr()),
                                      ctypes.c_void_p(inc.data_ptr()),
                                      ctypes.c_void_p(new_state.data_ptr()),
                                      ctypes.c_void_p(u.data_ptr()), n, d,
                                      ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"pcg32_draws kernel launch failed: CUDA error {err}")
        launches += 1
    stats.counts["pcg_kernel_draws"] += n * d
    return Pcg32(new_state, rng.inc), u
