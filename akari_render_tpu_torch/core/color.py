"""Color helpers: RGB colorspaces and transfer functions (port of
akari_render_tpu/core/color.py). Colors are [..., 3] linear RGB tensors."""
from __future__ import annotations

import numpy as np
import torch

SRGB_TO_XYZ = np.array(
    [
        [0.4123907992659595, 0.35758433938387796, 0.1804807884018343],
        [0.21263900587151036, 0.7151686787677559, 0.07219231536073371],
        [0.01933081871559185, 0.11919477979462599, 0.9505321522496607],
    ],
    dtype=np.float32,
)
XYZ_TO_SRGB = np.linalg.inv(SRGB_TO_XYZ.astype(np.float64)).astype(np.float32)
ACESCG_TO_XYZ = np.array(
    [
        [0.6624541811085053, 0.13400420645643313, 0.1561876870049078],
        [0.27222871678091454, 0.6740817658111484, 0.05368951740793705],
        [-0.005574649490394108, 0.004060733528982826, 1.0103391003129971],
    ],
    dtype=np.float32,
)
XYZ_TO_ACESCG = np.linalg.inv(ACESCG_TO_XYZ.astype(np.float64)).astype(np.float32)
SRGB_TO_ACESCG = (XYZ_TO_ACESCG.astype(np.float64) @ SRGB_TO_XYZ.astype(np.float64)).astype(np.float32)
ACESCG_TO_SRGB = (XYZ_TO_SRGB.astype(np.float64) @ ACESCG_TO_XYZ.astype(np.float64)).astype(np.float32)


def srgb_to_linear(c):
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def convert_colorspace(rgb, src: str, dst: str):
    """Convert linear RGB between the 'srgb' and 'aces' working spaces."""
    if src == dst:
        return rgb
    m = {("srgb", "aces"): SRGB_TO_ACESCG, ("aces", "srgb"): ACESCG_TO_SRGB}[(src, dst)]
    return torch.einsum("ij,...j->...i", torch.as_tensor(m, device=rgb.device), rgb)


def luminance(rgb):
    """Relative luminance of linear sRGB."""
    return 0.2126729 * rgb[..., 0] + 0.7151522 * rgb[..., 1] + 0.072175 * rgb[..., 2]


def remove_nan(c):
    return torch.where(torch.isfinite(c), c, 0.0)
