"""Sampling warps (port of akari_render_tpu/core/sampling.py, the parts the
path tracer and MCMC use). u is [..., 2] or [...]; outputs broadcast."""
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


def erf_inv(x):
    """Inverse error function (Giles 2010 approximation, as in ref util/mod.rs)."""
    x = torch.clamp(x, -0.99999, 0.99999)
    w = -torch.log((1.0 - x) * (1.0 + x))
    small = w < 5.0
    w1 = w - 2.5
    w2 = torch.sqrt(torch.clamp(w, min=1e-12)) - 3.0
    p_small = 2.81022636e-08
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
              -0.00125372503, -0.00417768164, 0.246640727, 1.50140941):
        p_small = c + p_small * w1
    p_big = -0.000200214257
    for c in (0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
              -0.0076224613, 0.00943887047, 1.00167406, 2.83297682):
        p_big = c + p_big * w2
    return torch.where(small, p_small, p_big) * x


def erf(x):
    """Error function (Abramowitz & Stegun 7.1.26)."""
    sign = torch.sign(x)
    x = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t - 0.284496736) * t
                + 0.254829592) * t * torch.exp(-x * x)
    return sign * y


SQRT2 = float(np.float32(math.sqrt(2.0)))


def sample_gaussian(u):
    """A standard normal draw from a uniform u (the inverse CDF)."""
    return SQRT2 * erf_inv(2.0 * u - 1.0)
