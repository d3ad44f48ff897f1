"""Batched 3D math primitives on torch tensors.

Port of akari_render_tpu/core/math.py. Vectors are [..., 3] float32
tensors; every function broadcasts over leading (lane) axes.
"""
from __future__ import annotations

import torch

RAY_TMAX = 1e20


def disable_tf32():
    """Keep float32 matmuls and convolutions in full float32: geometry must
    never pass through TF32 (the TPU package met the bf16 form of this
    fault: terraced silhouettes from bf16 matmul passes)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length(v):
    return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def length_squared(v):
    return dot(v, v)


def normalize(v):
    return v * torch.rsqrt(torch.clamp(dot(v, v), min=1e-30))[..., None]


def face_forward(v, ref):
    """Flip v into the hemisphere of ref."""
    return torch.where(dot(v, ref)[..., None] < 0.0, -v, v)


def reflect(w, n):
    return -w + 2.0 * dot(w, n)[..., None] * n


def refract(wi, n, eta):
    """Refract wi about n with relative IOR eta; returns (ok, eta_eff, wt)."""
    cos_i = dot(wi, n)
    entering = cos_i > 0.0
    eta_eff = torch.where(entering, eta, 1.0 / eta)
    n_eff = torch.where(entering[..., None], n, -n)
    cos_i = torch.abs(cos_i)
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = sin2_i / (eta_eff * eta_eff)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wt = (-wi) / eta_eff[..., None] + (cos_i / eta_eff - cos_t)[..., None] * n_eff
    return ~tir, eta_eff, wt


_ORIGIN = 1.0 / 32.0
_FLOAT_SCALE = 1.0 / 65536.0
_INT_SCALE = 256.0


def offset_ray_origin(p, n):
    """Offset a ray origin along n (Ray Tracing Gems ch. 6), bit-level as
    the JAX package does it: int32 ulp steps away from the surface."""
    of_i = (_INT_SCALE * n).to(torch.int32)
    ip = p.contiguous().view(torch.int32)
    ip_off = ip + torch.where(p < 0.0, -of_i, of_i)
    p_i = ip_off.view(torch.float32)
    return torch.where(torch.abs(p) < _ORIGIN, p + _FLOAT_SCALE * n, p_i)


def orthonormal_basis(n):
    """Branchless ONB from a unit normal (Duff et al. 2017): (t, b)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    bv = n[..., 0] * n[..., 1] * a
    t = torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * bv, -sign * n[..., 0]], dim=-1
    )
    b = torch.stack([bv, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, b


class Frame:
    """TBN helpers on stacked (t, b, n) tensors; local +z is the normal."""

    @staticmethod
    def to_local(t, b, n, v):
        return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)

    @staticmethod
    def to_world(t, b, n, v):
        return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n

    @staticmethod
    def cos_theta(w):
        return w[..., 2]

    @staticmethod
    def abs_cos_theta(w):
        return torch.abs(w[..., 2])

    @staticmethod
    def cos2_theta(w):
        return w[..., 2] * w[..., 2]

    @staticmethod
    def sin2_theta(w):
        return torch.clamp(1.0 - w[..., 2] * w[..., 2], min=0.0)

    @staticmethod
    def sin_theta(w):
        return torch.sqrt(Frame.sin2_theta(w))

    @staticmethod
    def tan_theta(w):
        return Frame.sin_theta(w) / w[..., 2]

    @staticmethod
    def tan2_theta(w):
        return Frame.sin2_theta(w) / torch.clamp(Frame.cos2_theta(w), min=1e-30)

    @staticmethod
    def cos_phi(w):
        s = Frame.sin_theta(w)
        return torch.where(
            s == 0.0, 1.0, torch.clamp(w[..., 0] / torch.clamp(s, min=1e-30), -1.0, 1.0)
        )

    @staticmethod
    def sin_phi(w):
        s = Frame.sin_theta(w)
        return torch.where(
            s == 0.0, 0.0, torch.clamp(w[..., 1] / torch.clamp(s, min=1e-30), -1.0, 1.0)
        )

    @staticmethod
    def cos2_phi(w):
        c = Frame.cos_phi(w)
        return c * c

    @staticmethod
    def sin2_phi(w):
        s = Frame.sin_phi(w)
        return s * s

    @staticmethod
    def same_hemisphere(a, b):
        return a[..., 2] * b[..., 2] > 0.0


def transform_point(m, p):
    """Apply a [4, 4] matrix to points [..., 3] in full float32."""
    return torch.einsum("ij,...j->...i", m[:3, :3], p) + m[:3, 3]


def transform_vector(m, v):
    return torch.einsum("ij,...j->...i", m[:3, :3], v)
