"""Precomputed GGX dielectric directional-albedo table (port of
akari_render_tpu/svm/precompute.py).

A DIM^3 table over (roughness, mu = cos_theta, z) with ior =
ior_from_f0(z^4); each cell is a Monte Carlo estimate of E[f/pdf] for a GGX
reflection lobe with dielectric Fresnel. The JAX package draws its samples
with jax.random, whose bits torch cannot reproduce: this port computes its
own table from a seeded torch.Generator at the same DIM and sample count,
and caches it as .npy under build/cache/ in the repository checkout. Callers
that need the JAX package's exact table inject it instead (load_scene's
`ggx_table`, interop.scene_arrays_from_numpy).

Lookups use gathers of the two nonzero interpolation weights per axis; the
JAX package contracts dense one-hot weight vectors on the MXU instead. The
values agree to float32 rounding.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.cache import cached_array
from ..core.math import Frame
from .microfacet import TrowbridgeReitz, fr_dielectric, ior_from_f0

DIM = 16
_SAMPLES = 1 << 14
_SEED = 0
_PER_BATCH = 256  # samples per cell per batch: DIM^3 * 256 = 1M lanes
TABLE_NAME = "ggx_dielectric_s"

_cache: dict[str, np.ndarray] = {}


def compute_ggx_dielectric_table(device, cells=None) -> np.ndarray:
    """MC directional albedo of GGX reflection with dielectric Fresnel,
    [DIM, DIM, DIM] float32, _SAMPLES draws per cell from a
    torch.Generator seeded with _SEED on `device`. `cells` (flat indices)
    computes only those cells and returns them as a flat array."""
    grid = np.clip(np.arange(DIM) / (DIM - 1.0), 1e-4, 0.9999)
    rough, mu, z = np.meshgrid(grid, grid, grid, indexing="ij")

    def f32(a):
        a = a.ravel() if cells is None else a.ravel()[np.asarray(cells)]
        return torch.as_tensor(a.astype(np.float32), device=device)

    rough, mu, z = f32(rough), f32(mu), f32(z)
    ior = ior_from_f0(z**4)
    n_cells = rough.shape[0]
    # every cell repeated _PER_BATCH times: lane = (cell, sample)
    rough_l = rough.repeat(_PER_BATCH)
    mu_l = mu.repeat(_PER_BATCH)
    ior_l = ior.repeat(_PER_BATCH)
    dist = TrowbridgeReitz.from_roughness(rough_l)
    wo = torch.stack(
        [torch.sqrt(torch.clamp(1.0 - mu_l * mu_l, min=0.0)), torch.zeros_like(mu_l), mu_l], -1
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(_SEED)
    acc = torch.zeros(n_cells, dtype=torch.float64, device=device)
    n_batches = _SAMPLES // _PER_BATCH
    for _ in range(n_batches):
        u = torch.rand((rough_l.shape[0], 2), generator=gen, device=device, dtype=torch.float32)
        wh = dist.sample_wh(wo, u)
        wi = -wo + 2.0 * torch.sum(wo * wh, -1, keepdim=True) * wh
        valid = Frame.same_hemisphere(wo, wi)
        fr = fr_dielectric(torch.sum(wi * wh, -1), ior_l)
        d = dist.d(wh)
        g = dist.g(wo, wi)
        cos_o = Frame.cos_theta(wo)
        cos_i = Frame.cos_theta(wi)
        f = fr * torch.abs(0.25 * d * g / torch.clamp(torch.abs(cos_o * cos_i), min=1e-12)) * torch.abs(cos_i)
        pdf = dist.pdf(wo, wh) / torch.clamp(4.0 * torch.abs(torch.sum(wo * wh, -1)), min=1e-12)
        val = torch.where(valid & (pdf > 0.0), f / torch.clamp(pdf, min=1e-20), 0.0)
        acc += val.view(_PER_BATCH, n_cells).to(torch.float64).sum(0)
    table = (acc / (n_batches * _PER_BATCH)).to(torch.float32).cpu().numpy()
    return table if cells is not None else table.reshape(DIM, DIM, DIM)


def get_table(device) -> np.ndarray:
    """The port's own table (numpy float32): from the process cache, the
    on-disk cache, or computed on `device` and cached."""
    if TABLE_NAME not in _cache:
        tbl = cached_array(f"{TABLE_NAME}.{DIM}.npy",
                           lambda: compute_ggx_dielectric_table(device))
        _cache[TABLE_NAME] = np.asarray(tbl, np.float32)
    return _cache[TABLE_NAME]


def _lerp_idx(c, size: int):
    """[...] coord in [0, 1] -> (i0, i1, t) interpolation knots."""
    c = torch.clamp(c, 0.0, 1.0) * (size - 1.0)
    i0 = torch.floor(c).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=size - 1)
    return i0, i1, c - i0.to(torch.float32)


def albedo_curve(table, x, z):
    """Contract the [X, Y, Z] table over its view-independent axes (x =
    roughness, z = eta parameter) -> per-lane cos curve [..., Y]."""
    x0, x1, tx = _lerp_idx(x, table.shape[0])
    z0, z1, tz = _lerp_idx(z, table.shape[2])
    tz = tz[..., None]
    tx = tx[..., None]
    c0 = table[x0, :, z0] * (1.0 - tz) + table[x0, :, z1] * tz
    c1 = table[x1, :, z0] * (1.0 - tz) + table[x1, :, z1] * tz
    return c0 * (1.0 - tx) + c1 * tx


def albedo_curve_np(table_np: np.ndarray, x: float, z: float) -> np.ndarray:
    """Static-constant path: [Y] numpy curve for host constants x, z."""
    X, _, Z = table_np.shape

    def prep(v, s):
        vf = float(np.clip(v, 0.0, 1.0)) * (s - 1.0)
        i0 = int(np.clip(np.floor(vf), 0, s - 1))
        return i0, min(i0 + 1, s - 1), vf - i0

    x0, x1, fx = prep(x, X)
    z0, z1, fz = prep(z, Z)
    c0 = table_np[x0, :, z0] * (1 - fz) + table_np[x0, :, z1] * fz
    c1 = table_np[x1, :, z0] * (1 - fz) + table_np[x1, :, z1] * fz
    return c0 * (1 - fx) + c1 * fx


def curve_eval(curve, cos_y):
    """Piecewise-linear eval of a [Y] or [..., Y] knot curve at cos_y [...]."""
    i0, i1, t = _lerp_idx(cos_y, curve.shape[-1])
    if curve.dim() == 1:
        return curve[i0] * (1.0 - t) + curve[i1] * t
    c0 = torch.gather(curve, -1, i0[..., None])[..., 0]
    c1 = torch.gather(curve, -1, i1[..., None])[..., 0]
    return c0 * (1.0 - t) + c1 * t
