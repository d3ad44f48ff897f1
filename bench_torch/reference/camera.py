"""The pinhole camera of the reference: raster position <-> world direction.

Raster x grows to the right and y downwards, pixel (x, y) spans [x, x + 1)
x [y, y + 1), and the image spans the camera's field of view on its larger
side. A camera ray through raster point p leaves the camera's origin along
c2w applied to (ndc_x * sx, -ndc_y * sy, -1), with ndc = 2 p / size - 1.
"""
from __future__ import annotations

import torch

from .scene import RefCamera
from .traverse import tf32_round


def raster_of(cam: RefCamera, d: torch.Tensor) -> torch.Tensor:
    """Raster positions [R, 2] (float64) where world directions d [R, 3]
    cross the camera's image plane."""
    rot = torch.as_tensor(cam.c2w[:3, :3], dtype=torch.float64, device=d.device)
    dc = d.to(torch.float64) @ rot  # world -> camera: the rotation's transpose
    sx, sy = cam.scales()
    x = dc[:, 0] / -dc[:, 2] / sx
    y = dc[:, 1] / -dc[:, 2] / sy
    return torch.stack([(x + 1.0) * 0.5 * cam.width, (1.0 - y) * 0.5 * cam.height], -1)


def directions(cam: RefCamera, p: torch.Tensor, precision: str = "float64") -> torch.Tensor:
    """World directions [R, 3] of the camera rays through raster points p
    [R, 2]; "tf32" computes them in float32 with the matrix product's
    inputs rounded to TF32 (the control)."""
    dt = torch.float64 if precision == "float64" else torch.float32
    sx, sy = cam.scales()
    p = p.to(dt)
    x = (2.0 * p[:, 0] / cam.width - 1.0) * sx
    y = (1.0 - 2.0 * p[:, 1] / cam.height) * sy
    dc = torch.stack([x, y, -torch.ones_like(x)], -1)
    dc = dc / torch.linalg.vector_norm(dc, dim=-1, keepdim=True)
    rot = torch.as_tensor(cam.c2w[:3, :3], dtype=dt, device=p.device)
    if precision == "tf32":
        dc, rot = tf32_round(dc), tf32_round(rot)
    return dc @ rot.T
