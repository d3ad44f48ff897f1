"""Alias tables for O(1) discrete sampling (port of
akari_render_tpu/core/distribution.py::AliasTable): the host-side Vose
build in numpy float64. lights.py samples the tables on the device.
resample_with_f64 is MCMC's bootstrap resampling, copied (numpy)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class AliasTable(NamedTuple):
    prob: np.ndarray  # [N] float32 acceptance probability of own bucket
    alias: np.ndarray  # [N] int32 alias index
    pdf: np.ndarray  # [N] float32 normalized pdf of each entry

    @staticmethod
    def build(weights: np.ndarray) -> "AliasTable":
        w = np.asarray(weights, dtype=np.float64)
        n = len(w)
        if n == 0:
            raise ValueError("alias table needs at least one weight")
        total = w.sum()
        if total <= 0.0:
            w = np.ones(n)
            total = float(n)
        pdf = w / total
        scaled = pdf * n
        prob = np.zeros(n)
        alias = np.zeros(n, dtype=np.int32)
        small = [i for i in range(n) if scaled[i] < 1.0]
        large = [i for i in range(n) if scaled[i] >= 1.0]
        scaled = scaled.copy()
        while small and large:
            s = small.pop()
            l = large.pop()
            prob[s] = scaled[s]
            alias[s] = l
            scaled[l] = (scaled[l] + scaled[s]) - 1.0
            (small if scaled[l] < 1.0 else large).append(l)
        for i in large + small:
            prob[i] = 1.0
            alias[i] = i
        return AliasTable(
            prob=prob.astype(np.float32), alias=alias, pdf=pdf.astype(np.float32)
        )


def resample_with_f64(weights: np.ndarray, us: np.ndarray) -> np.ndarray:
    """CPU bootstrap resampling by inverse-CDF (ref distribution.rs:92-115).

    weights: [N] float; us: [M] uniforms -> [M] indices.
    """
    cdf = np.cumsum(np.asarray(weights, np.float64))
    total = cdf[-1]
    assert total > 0.0, "bootstrap failed: all-zero weights"
    return np.minimum(
        np.searchsorted(cdf, us * total, side="right"), len(weights) - 1
    ).astype(np.uint32)
