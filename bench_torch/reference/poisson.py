"""The screened-Poisson reconstruction of a gradient-domain render, written
from its definition: the image R that minimises

    sum_p |R[p] - P[p]|^2 + sum over pairs (p, p + x) |R[p + x] - R[p] - Gx[p]|^2
                          + sum over pairs (p, p + y) |R[p + y] - R[p] - Gy[p]|^2

with uniform weights, over the pairs that lie inside the image, by Jacobi
sweeps started from R = P: each sweep sets every pixel to the mean of the
primal and of each in-image neighbour's estimate of it (the left
neighbour's R + its Gx, the right neighbour's R - this pixel's Gx, and so
for y). `dtype` float64 is the reference; bfloat16 is the control.
"""
from __future__ import annotations

import numpy as np


def solve(primal, gx, gy, iters: int, dtype=np.float64) -> np.ndarray:
    """R [H, W, 3] after `iters` sweeps, from P, Gx, Gy [H, W, 3]."""
    import torch

    dt = {np.float64: torch.float64, "bfloat16": torch.bfloat16}[dtype]
    p, gx, gy = (torch.as_tensor(np.asarray(a)).to(dt) for a in (primal, gx, gy))
    h, w, _ = p.shape
    r = p.clone()
    for _ in range(iters):
        num = p.clone()
        den = torch.ones((h, w, 1), dtype=dt)
        num[:, 1:] += r[:, :-1] + gx[:, :-1]  # from the left neighbour
        num[:, :-1] += r[:, 1:] - gx[:, :-1]  # from the right neighbour
        num[1:] += r[:-1] + gy[:-1]  # from the row above
        num[:-1] += r[1:] - gy[:-1]  # from the row below
        den[:, 1:] += 1
        den[:, :-1] += 1
        den[1:] += 1
        den[:-1] += 1
        r = num / den
    return r.to(torch.float64).numpy()
