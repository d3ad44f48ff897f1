"""Named dielectric IOR presets, wavelength-dependent (a copy of
akari_render_tpu/core/ior.py, which holds no JAX code).

Counterpart of the reference's dielectric IOR data table
(crates/akari_data/src/ior.rs: `GLASS_BK7_ETA`, a 29-point (nm, eta)
piecewise-linear table covering 300-916 nm). Each material stores its
published Sellmeier dispersion coefficients (Schott / Malitson / standard
optics-handbook data, the source data the reference's table was sampled
from) and evaluates eta(lambda) analytically; `eta_table(name)` gives the
reference's (nm, eta) sampled layout. Metal (complex n, k) presets live in
svm/eval.py (`METAL_IOR`). The transport takes a glass's eta from its
shader graph; these tables are data-layer parity.
"""
from __future__ import annotations

import numpy as np

# name -> (B1, B2, B3, C1, C2, C3) Sellmeier coefficients, lambda in um:
#   n^2 = 1 + sum_i B_i * l^2 / (l^2 - C_i)
_SELLMEIER = {
    # Schott N-BK7 (the reference's GLASS_BK7_ETA source data)
    "bk7": (1.03961212, 0.231792344, 1.01046945,
            0.00600069867, 0.0200179144, 103.560653),
    # Schott N-SF11 (dense flint)
    "sf11": (1.73759695, 0.313747346, 1.89878101,
             0.013188707, 0.0623068142, 155.23629),
    # Schott F2 (flint)
    "f2": (1.34533359, 0.209073176, 0.937357162,
           0.00997743871, 0.0470450767, 111.886764),
    # Fused silica (Malitson 1965)
    "fused_silica": (0.6961663, 0.4079426, 0.8974794,
                     0.0684043**2, 0.1162414**2, 9.896161**2),
    # Sapphire, ordinary ray (Malitson & Dodge)
    "sapphire": (1.4313493, 0.65054713, 5.3414021,
                 0.0726631**2, 0.1193242**2, 18.028251**2),
}

# Cauchy-form extras where Sellmeier data isn't standard:
# n = A + B/l^2 + C/l^4 (l in um)
_CAUCHY = {
    "water": (1.3199, 6.878e-3, -1.132e-3),  # ~20C visible fit
    "diamond": (2.3818, 1.2198e-2, -5.16e-5),  # Peter 1923 fit
}

PRESETS = tuple(sorted((*_SELLMEIER, *_CAUCHY)))


def eta(name: str, lambda_nm) -> np.ndarray:
    """Refractive index at wavelength(s) in nm (vectorized)."""
    lam_um = np.asarray(lambda_nm, np.float64) / 1000.0
    l2 = lam_um * lam_um
    if name in _SELLMEIER:
        b1, b2, b3, c1, c2, c3 = _SELLMEIER[name]
        n2 = 1.0 + b1 * l2 / (l2 - c1) + b2 * l2 / (l2 - c2) + b3 * l2 / (l2 - c3)
        return np.sqrt(n2).astype(np.float32)
    if name in _CAUCHY:
        a, b, c = _CAUCHY[name]
        return (a + b / l2 + c / (l2 * l2)).astype(np.float32)
    raise KeyError(f"unknown IOR preset {name!r}; have {PRESETS}")


def eta_table(name: str, lo_nm: float = 300.0, hi_nm: float = 916.0,
              n: int = 29) -> np.ndarray:
    """Sampled (nm, eta) pairs in the reference's flat-table layout
    (ior.rs: interleaved [lambda0, eta0, lambda1, eta1, ...])."""
    lam = np.linspace(lo_nm, hi_nm, n).astype(np.float32)
    return np.stack([lam, eta(name, lam)], -1).reshape(-1)
