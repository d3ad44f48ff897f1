"""Brute-force Möller-Trumbore in plain torch (port of
akari_render_tpu/accel/trace.py): every ray against every triangle, in
[chunk, N] tensors chunked over triangles.

This is the plain version of the CUDA kernel in accel/intersect.py; the
wrapper there chunks over rays as well, so the [chunk, N] intermediates
stay bounded on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.math import RAY_TMAX


class Hit(NamedTuple):
    t: torch.Tensor  # [N] hit distance (RAY_TMAX if miss)
    tri_id: torch.Tensor  # [N] int32 triangle id (-1 if miss)
    bary: torch.Tensor  # [N, 2] barycentrics (u, v)
    valid: torch.Tensor  # [N] bool


CHUNK_T = 512  # triangles per chunk: bounds the [chunk, N] temporaries


def _chunk_hits(o, d, tmin, tmax, v0, e1, e2, excludes, tri_base: int):
    """All rays x one triangle chunk: (t, u, v, hit), each [T, N]."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    v0x, v0y, v0z = v0[:, 0:1], v0[:, 1:2], v0[:, 2:3]
    e1x, e1y, e1z = e1[:, 0:1], e1[:, 1:2], e1[:, 2:3]
    e2x, e2y, e2z = e2[:, 0:1], e2[:, 1:2], e2[:, 2:3]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok_det = torch.abs(det) > 1e-12
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (qx * dx + qy * dy + qz * dz) * inv_det
    t = (qx * e2x + qy * e2y + qz * e2z) * inv_det
    hit = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin) & (t < tmax)
    tri_ids = tri_base + torch.arange(v0.shape[0], dtype=torch.int32, device=o.device)[:, None]
    for ex in excludes:
        if ex is not None:
            hit = hit & (tri_ids != ex)
    return t, u, v, hit


def intersect_brute_force(o, d, tmin, tmax, v0, e1, e2, exclude0=None, exclude1=None,
                          exclude2=None) -> Hit:
    """Closest hit over the whole triangle list; the first triangle wins
    ties. A miss keeps t = min(RAY_TMAX, tmax), as the JAX version does."""
    n = o.shape[0]
    best_t = torch.clamp(tmax.to(torch.float32), max=RAY_TMAX)
    best_id = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    best_u = torch.zeros((n,), dtype=torch.float32, device=o.device)
    best_v = torch.zeros((n,), dtype=torch.float32, device=o.device)
    exs = [e[None, :] if e is not None else None for e in (exclude0, exclude1, exclude2)]
    for start in range(0, v0.shape[0], CHUNK_T):
        end = min(start + CHUNK_T, v0.shape[0])
        t, u, v, hit = _chunk_hits(
            o, d, tmin, best_t, v0[start:end], e1[start:end], e2[start:end], exs, start
        )
        t_m = torch.where(hit, t, RAY_TMAX)
        ct, am = torch.min(t_m, dim=0)
        cu = torch.gather(u, 0, am[None, :])[0]
        cv = torch.gather(v, 0, am[None, :])[0]
        better = torch.any(hit, dim=0) & (ct < best_t)
        best_t = torch.where(better, ct, best_t)
        best_id = torch.where(better, (start + am).to(torch.int32), best_id)
        best_u = torch.where(better, cu, best_u)
        best_v = torch.where(better, cv, best_v)
    return Hit(t=best_t, tri_id=best_id, bary=torch.stack([best_u, best_v], dim=-1),
               valid=best_id >= 0)


def occlude_brute_force(o, d, tmin, tmax, v0, e1, e2, exclude0=None, exclude1=None,
                        exclude2=None):
    """Any hit: bool [N], True where occluded."""
    occluded = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    exs = [e[None, :] if e is not None else None for e in (exclude0, exclude1, exclude2)]
    for start in range(0, v0.shape[0], CHUNK_T):
        end = min(start + CHUNK_T, v0.shape[0])
        _, _, _, hit = _chunk_hits(
            o, d, tmin, tmax, v0[start:end], e1[start:end], e2[start:end], exs, start
        )
        occluded |= torch.any(hit, dim=0)
    return occluded
