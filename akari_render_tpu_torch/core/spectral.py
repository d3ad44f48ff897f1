"""Hero-wavelength sampling, the rgb2spec uplift and the CIE sensor (port
of akari_render_tpu/core/spectral.py).

The rgb2spec table is the JAX package's: the repo's own
native/rgb2spec_opt.cpp fits the sigmoid-polynomial coefficients, built and
called through native.py, and the raw table is cached in build/cache/ of
this checkout. There is no fallback: if the table cannot be made,
ensure_rgb2spec_table raises, and spectral mode never renders RGB instead.
The table is cached in numpy and moved to a device once per device.

cie_xyz_bar and d65_spd's users compute with torch.exp, which differs
from XLA's exp in the last bit on some inputs. Here that exp feeds only
film values (the sensor's colour-matching weights), never a sample draw or
a path decision, so the port is held to JAX within a float tolerance and
does not need integrators/mcmc.py's exp_f32.
"""
from __future__ import annotations

import os
import tempfile
from typing import NamedTuple

import numpy as np
import torch

from .cache import CACHE_DIR
from .color import XYZ_TO_SRGB

LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0
N_WAVELENGTHS = 4  # hero + 3


class SampledWavelengths(NamedTuple):
    lambdas: torch.Tensor  # [N, 4]
    pdf: torch.Tensor  # [N, 4]


def sample_wavelengths(u) -> SampledWavelengths:
    """Stratified hero-wavelength sampling: u [N] -> 4 rotated wavelengths,
    uniform pdf."""
    offsets = torch.arange(N_WAVELENGTHS, dtype=torch.float32, device=u.device) / N_WAVELENGTHS
    uu = torch.remainder(u[..., None] + offsets, 1.0)
    lam = LAMBDA_MIN + uu * (LAMBDA_MAX - LAMBDA_MIN)
    return SampledWavelengths(lam, torch.full_like(lam, 1.0 / (LAMBDA_MAX - LAMBDA_MIN)))


# ---- rgb2spec table ---------------------------------------------------------
_table_cache: dict = {}  # gamut -> (scale [r], coeffs [3, r, r, r, 3]) numpy
_device_tables: dict = {}  # (gamut, device) -> the same as tensors


def table_path(gamut: str = "srgb"):
    """The raw table's file (the JAX package's name and format)."""
    return CACHE_DIR / f"rgbspectrum_{gamut}_v2"


def _run_optimizer(res: int, gamut: str):
    from ..native import get_lib

    path = table_path(gamut)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=path.name, dir=CACHE_DIR)
    os.close(fd)
    try:
        rc = get_lib().akr_rgb2spec_opt(res, tmp.encode(), gamut.encode())
        if rc != 0:
            raise RuntimeError(f"the rgb2spec optimizer failed ({rc}) for gamut {gamut!r}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def ensure_rgb2spec_table(gamut: str = "srgb", res: int = 24):
    """(scale [r], coeffs [3, r, r, r, 3]) numpy float32, made by the native
    optimizer on first use and read from build/cache/ after that. Raises if
    g++ or the optimizer fails."""
    if gamut in _table_cache:
        return _table_cache[gamut]
    path = table_path(gamut)
    if not path.exists():
        _run_optimizer(res, gamut)
    raw = path.read_bytes()
    r = int(np.frombuffer(raw, np.uint32, 1)[0])
    scale = np.frombuffer(raw, np.float32, r, offset=4)
    coeffs = np.frombuffer(raw, np.float32, 3 * r * r * r * 3, offset=4 + 4 * r)
    _table_cache[gamut] = (scale.copy(), coeffs.reshape(3, r, r, r, 3).copy())
    return _table_cache[gamut]


def device_table(device, gamut: str = "srgb"):
    """The table as tensors on `device`, moved there once."""
    key = (gamut, str(torch.device(device)))
    if key not in _device_tables:
        scale, coeffs = ensure_rgb2spec_table(gamut)
        _device_tables[key] = (torch.as_tensor(scale, device=device),
                               torch.as_tensor(coeffs, device=device))
    return _device_tables[key]


def uplift_coeffs(table, rgb):
    """RGB [N, 3] -> sigmoid-polynomial coefficients [N, 3], trilinear over
    the (scale, b, a) cell of the max channel's sheet. `table` is
    device_table's pair (or ensure_rgb2spec_table's, moved here)."""
    scale, coeffs = table
    scale = torch.as_tensor(scale, device=rgb.device)
    coeffs = torch.as_tensor(coeffs, device=rgb.device)
    r = scale.shape[0]
    maxc = torch.argmax(rgb, dim=-1)  # the first maximum, as jnp.argmax
    mx = torch.clamp(torch.gather(rgb, -1, maxc[..., None])[..., 0], min=1e-4)
    a = torch.gather(rgb, -1, ((maxc + 1) % 3)[..., None])[..., 0] / mx
    b = torch.gather(rgb, -1, ((maxc + 2) % 3)[..., None])[..., 0] / mx
    af = torch.clamp(a, 0.0, 1.0) * (r - 1)
    bf = torch.clamp(b, 0.0, 1.0) * (r - 1)
    a0 = torch.clamp(torch.floor(af).to(torch.int64), 0, r - 2)
    b0 = torch.clamp(torch.floor(bf).to(torch.int64), 0, r - 2)
    fa = torch.clamp(af - a0, 0.0, 1.0)[..., None]
    fb = torch.clamp(bf - b0, 0.0, 1.0)[..., None]
    # the scale axis is smoothstep-spaced: piecewise-linear search of its knots
    z0 = torch.clamp(torch.searchsorted(scale, mx.contiguous(), right=True) - 1, 0, r - 2)
    fz = torch.clamp((mx - scale[z0]) / torch.clamp(scale[z0 + 1] - scale[z0], min=1e-12),
                     0.0, 1.0)[..., None]

    def corner(dz, db, da):
        return coeffs[maxc, z0 + dz, b0 + db, a0 + da]

    c00 = corner(0, 0, 0) * (1 - fa) + corner(0, 0, 1) * fa
    c01 = corner(0, 1, 0) * (1 - fa) + corner(0, 1, 1) * fa
    c10 = corner(1, 0, 0) * (1 - fa) + corner(1, 0, 1) * fa
    c11 = corner(1, 1, 0) * (1 - fa) + corner(1, 1, 1) * fa
    c0 = c00 * (1 - fb) + c01 * fb
    c1 = c10 * (1 - fb) + c11 * fb
    return c0 * (1 - fz) + c1 * fz


def eval_reflectance(c, lambdas):
    """coefficients [N, 3] x wavelengths [N, W] -> reflectance [N, W]."""
    ln = (lambdas - LAMBDA_MIN) / (LAMBDA_MAX - LAMBDA_MIN)
    x = (c[..., 0:1] * ln + c[..., 1:2]) * ln + c[..., 2:3]
    return 0.5 * x / torch.sqrt(1.0 + x * x) + 0.5


def uplift_unbounded(table, rgb):
    """RGB [N, 3] of any non-negative scale -> (coeffs [N, 3], scale [N]):
    normalised by twice the max channel before the uplift; the spectrum at
    lambda is eval_reflectance(coeffs, lambda) * scale."""
    scale = 2.0 * torch.max(rgb, dim=-1).values
    return uplift_coeffs(table, rgb / torch.clamp(scale, min=1e-12)[..., None]), scale


# ---- CIE 1931 sensor + D65 illuminant ---------------------------------------
# Wyman, Sloan & Shirley's multi-lobe Gaussian fits of the CIE 1931 2-degree
# colour-matching functions, as native/rgb2spec_opt.cpp uses them.

def _pw_gauss(lam, mu, s1, s2):
    t = (lam - mu) * torch.where(lam < mu, 1.0 / s1, 1.0 / s2)
    return torch.exp(-0.5 * t * t)


def cie_xyz_bar(lam):
    """lam [...] nm -> (x_bar, y_bar, z_bar) stacked on a new last axis."""
    x = (1.056 * _pw_gauss(lam, 599.8, 37.9, 31.0) + 0.362 * _pw_gauss(lam, 442.0, 16.0, 26.7)
         - 0.065 * _pw_gauss(lam, 501.1, 20.4, 26.2))
    y = 0.821 * _pw_gauss(lam, 568.8, 46.9, 40.5) + 0.286 * _pw_gauss(lam, 530.9, 16.3, 31.1)
    z = 1.217 * _pw_gauss(lam, 437.0, 11.8, 36.0) + 0.681 * _pw_gauss(lam, 459.0, 26.0, 13.8)
    return torch.stack([x, y, z], dim=-1)


# CIE standard illuminant D65, 360..830 nm at 5 nm (CIE 15:2004, relative
# SPD normalised to 100 at 560 nm), as native/rgb2spec_opt.cpp has it.
_D65 = np.array([
    46.64, 49.36, 52.09, 51.03, 49.98, 52.31, 54.65, 68.70, 82.75, 87.12,
    91.49, 92.46, 93.43, 90.06, 86.68, 95.77, 104.86, 110.94, 117.01, 117.41,
    117.81, 116.34, 114.86, 115.39, 115.92, 112.37, 108.81, 109.08, 109.35,
    108.58, 107.80, 106.30, 104.79, 106.24, 107.69, 106.05, 104.41, 104.23,
    104.05, 102.02, 100.00, 98.17, 96.33, 96.06, 95.79, 92.24, 88.69, 89.35,
    90.01, 89.80, 89.60, 88.65, 87.70, 85.49, 83.29, 83.49, 83.70, 81.86,
    80.03, 80.12, 80.21, 81.25, 82.28, 80.28, 78.28, 74.00, 69.72, 70.67,
    71.61, 72.98, 74.35, 67.98, 61.60, 65.74, 69.89, 72.49, 75.09, 69.34,
    63.59, 55.01, 46.42, 56.61, 66.81, 65.09, 63.38, 63.84, 64.30, 61.88,
    59.45, 55.71, 51.96, 54.70, 57.44, 58.88, 60.31,
], dtype=np.float32)  # 95 knots: 360, 365, ..., 830
_d65_tabs: dict = {}


def d65_spd(lam):
    """Relative D65 power at lam (nm), linearly interpolated."""
    key = str(lam.device)
    if key not in _d65_tabs:
        _d65_tabs[key] = torch.as_tensor(_D65, device=lam.device)
    tab = _d65_tabs[key]
    idx = (lam - 360.0) / 5.0
    i0 = torch.clamp(torch.floor(idx).to(torch.int64), 0, _D65.shape[0] - 2)
    f = torch.clamp(idx - i0.to(torch.float32), 0.0, 1.0)
    return tab[i0] * (1 - f) + tab[i0 + 1] * f


def _y_d65_integral() -> float:
    """integral(y_bar * D65) over lambda, in numpy float32 as the JAX
    package computes it at import."""
    lam = np.linspace(LAMBDA_MIN, LAMBDA_MAX, 471, dtype=np.float32)

    def pw(mu, s1, s2):
        t = (lam - mu) * np.where(lam < mu, 1.0 / s1, 1.0 / s2)
        return np.exp(-0.5 * t * t)

    ybar = 0.821 * pw(568.8, 46.9, 40.5) + 0.286 * pw(530.9, 16.3, 31.1)
    idx = (lam - 360.0) / 5.0
    i0 = np.clip(np.floor(idx).astype(np.int32), 0, _D65.shape[0] - 2)
    f = np.clip(idx - i0, 0.0, 1.0)
    d65 = _D65[i0] * (1 - f) + _D65[i0 + 1] * f
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2 names it trapz
    return float(trapezoid(ybar * d65, lam))


Y_D65 = _y_d65_integral()  # XYZ of a D65-white emitter has Y = 1


def illuminant_d65(lam):
    """Normalised D65: the integral of y_bar * illuminant_d65 is 1."""
    return d65_spd(lam) / Y_D65


def spectral_to_rgb(L, lambdas, pdf):
    """The MC sensor estimate: spectral radiance L [N, W] at lambdas with
    pdf -> linear sRGB [N, 3]. XYZ_j = mean_i cmf_j(lam_i) L_i / pdf_i, then
    XYZ -> linear sRGB, written as three products and sums (no matmul, so
    TF32 cannot enter)."""
    cmf = cie_xyz_bar(lambdas)  # [N, W, 3]
    xyz = torch.mean(cmf * (L / torch.clamp(pdf, min=1e-20))[..., None], dim=-2)
    m = torch.as_tensor(XYZ_TO_SRGB, device=L.device)
    return xyz[..., 0:1] * m[:, 0] + xyz[..., 1:2] * m[:, 1] + xyz[..., 2:3] * m[:, 2]
