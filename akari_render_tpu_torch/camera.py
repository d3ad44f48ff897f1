"""Perspective camera: host-side matrix build plus batched ray generation
(port of akari_render_tpu/camera.py)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .core.math import normalize, transform_point, transform_vector
from .scenegraph.model import load_transform


class PerspectiveCamera(NamedTuple):
    c2w: torch.Tensor  # [4, 4] f32
    w2c: torch.Tensor  # [4, 4] f32
    r2c: torch.Tensor  # [4, 4] f32 raster -> camera
    width: int
    height: int
    fov: float  # radians
    lens_radius: float
    focal_distance: float


def _raster_to_camera(width: int, height: int, fov_rad: float) -> np.ndarray:
    """Raster -> camera-space point on the z = -1 plane (float64)."""

    def scale(x, y, z):
        m = np.eye(4)
        m[0, 0], m[1, 1], m[2, 2] = x, y, z
        return m

    def translate(x, y, z):
        m = np.eye(4)
        m[:3, 3] = [x, y, z]
        return m

    m = np.eye(4)
    m = scale(1.0 / width, 1.0 / height, 1.0) @ m
    m = scale(2.0, 2.0, 1.0) @ m
    m = translate(-1.0, -1.0, 0.0) @ m
    m = scale(1.0, -1.0, 1.0) @ m
    s = np.tan(fov_rad / 2.0)
    if width > height:
        m = scale(s, s * height / width, 1.0) @ m
    else:
        m = scale(s * width / height, s, 1.0) @ m
    m = translate(0.0, 0.0, -1.0) @ m
    return m


def camera_from_scenegraph(cam: dict, width: int | None, height: int | None, device) -> PerspectiveCamera:
    if cam["type"] != "perspective":
        raise NotImplementedError(f"camera type {cam['type']!r}")
    d = cam["data"]
    c2w = load_transform(d["transform"], is_camera=True)
    fov = float(np.deg2rad(d["fov"]))
    width = width or int(d["sensor_width"])
    height = height or int(d["sensor_height"])
    fstop = float(d.get("fstop", 0.0) or 0.0)
    focal_distance = float(d.get("focal_distance", 0.0) or 0.0)
    lens_radius = focal_distance / (2.0 * fstop) if fstop > 0 else 0.0

    def f32(m):
        return torch.as_tensor(np.asarray(m, np.float32), device=device)

    return PerspectiveCamera(
        c2w=f32(c2w),
        w2c=f32(np.linalg.inv(c2w)),
        r2c=f32(_raster_to_camera(width, height, fov)),
        width=width,
        height=height,
        fov=fov,
        lens_radius=lens_radius,
        focal_distance=focal_distance,
    )


def generate_rays(camera: PerspectiveCamera, p_film):
    """Raster positions [N, 2] (filter-jittered, pixel centres at +0.5) ->
    (ray_o [N, 3], ray_d [N, 3]) in world space."""
    n = p_film.shape[0]
    p = torch.cat([p_film, torch.zeros((n, 1), dtype=p_film.dtype, device=p_film.device)], dim=-1)
    d_cam = normalize(transform_point(camera.r2c, p))
    origin = transform_point(camera.c2w, torch.zeros((3,), dtype=torch.float32, device=p_film.device))
    return origin.expand(n, 3), transform_vector(camera.c2w, d_cam)
