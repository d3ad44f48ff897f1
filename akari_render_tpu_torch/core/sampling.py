"""Sampling warps (port of akari_render_tpu/core/sampling.py, the parts the
path tracer uses). u is [..., 2] or [...]; outputs broadcast."""
from __future__ import annotations

import math

import numpy as np
import torch

# float32-rounded constants, as the JAX package's jnp.float32 constants
PI = float(np.float32(math.pi))
INV_PI = float(np.float32(1.0 / math.pi))
TWO_PI = float(np.float32(2.0 * math.pi))
INV_2PI = float(np.float32(0.5 / math.pi))


def uniform_sample_disk(u):
    r = torch.sqrt(u[..., 0])
    phi = u[..., 1] * TWO_PI
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def cos_sample_hemisphere(u):
    d = uniform_sample_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    return torch.cat([d, z[..., None]], dim=-1)


def uniform_sample_triangle(u):
    """Low-distortion triangle warp; returns barycentrics (b0, b1)."""
    ux, uy = u[..., 0], u[..., 1]
    lt = ux < uy
    b0 = torch.where(lt, ux * 0.5, ux - uy * 0.5)
    b1 = torch.where(lt, uy - ux * 0.5, uy * 0.5)
    return torch.stack([b0, b1], dim=-1)


def weighted_discrete_choice2_and_remap(weight_a, u):
    """Binary weighted choice: (pick_a mask, remapped u)."""
    first = u < weight_a
    remapped = torch.where(
        first,
        u / torch.clamp(weight_a, min=1e-20),
        (u - weight_a) / torch.clamp(1.0 - weight_a, min=1e-20),
    )
    return first, torch.clamp(remapped, 0.0, 1.0)


def mis_weight(pdf_a, pdf_b):
    """Balance heuristic."""
    return pdf_a / torch.clamp(pdf_a + pdf_b, min=1e-30)
