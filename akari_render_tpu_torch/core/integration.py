"""Adaptive Simpson quadrature, batched over many intervals (a copy of
akari_render_tpu/core/integration.py, which holds no JAX code).

The reference's explicit-stack adaptive Simpson
(crates/akari_render/src/util/integration.rs:17-120, used by akari-test's
chi-square harness at akari_api/src/bin/akari_test.rs:70-112 with
eps=1e-6, max_depth=6): per work item, the interval [a, c] with midpoint b
refines into [a, b] and [b, c] until the two-panel estimate agrees with the
one-panel estimate to 15*eps, and each converged panel contributes the
Richardson-extrapolated `ip + (ip - i)/15`. All intervals advance in
lockstep, breadth first: the work list is a struct of numpy arrays, and
every refinement level makes one batched call of the integrand (a BSDF's
pdf over many directions). Only the traversal order differs from the
reference's; the summation order within a bin moves by float rounding.
"""
from __future__ import annotations

import numpy as np


def adaptive_simpson_batch(f, x0, x1, eps: float = 1e-6, max_depth: int = 6):
    """Integrate `f` over each interval [x0[k], x1[k]] adaptively.

    f(points [P], owner [P] int) -> values [P]: batched integrand; `owner`
    maps each evaluation point back to its interval index k so per-interval
    parameters can be looked up. Returns [M] integrals.
    """
    a = np.asarray(x0, np.float64).copy()
    c = np.asarray(x1, np.float64).copy()
    M = a.shape[0]
    owner = np.arange(M)
    b = 0.5 * (a + c)
    pts = np.concatenate([a, b, c])
    vals = np.asarray(f(pts, np.concatenate([owner, owner, owner])),
                      np.float64)
    fa, fb, fc = vals[:M], vals[M : 2 * M], vals[2 * M :]
    i = (c - a) * (1.0 / 6.0) * (fa + 4.0 * fb + fc)
    epss = np.full(M, eps, np.float64)
    depth = np.full(M, max_depth, np.int64)
    res = np.zeros(M, np.float64)

    while owner.size:
        d = 0.5 * (a + b)
        e = 0.5 * (b + c)
        P = owner.size
        vals = np.asarray(
            f(np.concatenate([d, e]), np.concatenate([owner, owner])),
            np.float64,
        )
        fd, fe = vals[:P], vals[P:]
        h = c - a
        i0 = (1.0 / 12.0) * h * (fa + 4.0 * fd + fb)
        i1 = (1.0 / 12.0) * h * (fb + 4.0 * fe + fc)
        ip = i0 + i1
        done = (depth <= 0) | (np.abs(ip - i) < 15.0 * epss)
        np.add.at(res, owner[done], (ip + (ip - i) * (1.0 / 15.0))[done])
        sp = ~done
        owner = np.concatenate([owner[sp], owner[sp]])
        a, b, c = (
            np.concatenate([a[sp], b[sp]]),
            np.concatenate([d[sp], e[sp]]),
            np.concatenate([b[sp], c[sp]]),
        )
        fa, fb, fc = (
            np.concatenate([fa[sp], fb[sp]]),
            np.concatenate([fd[sp], fe[sp]]),
            np.concatenate([fb[sp], fc[sp]]),
        )
        i = np.concatenate([i0[sp], i1[sp]])
        epss = np.concatenate([epss[sp] * 0.5, epss[sp] * 0.5])
        depth = np.concatenate([depth[sp] - 1, depth[sp] - 1])
    return res


def adaptive_simpson_2d_batch(f2, x0, x1, y0, y1, eps: float = 1e-6,
                              max_depth: int = 6):
    """Per-rectangle double integral, x outer / y inner, both adaptive
    (integration.rs:105-137 adaptive_simpson_2d, batched over rectangles).

    f2(xs [P], ys [P], owner [P] int) -> values [P]. Returns [M] integrals
    of f2 over [x0, x1] x [y0, y1] per rectangle.
    """
    y0 = np.asarray(y0, np.float64)
    y1 = np.asarray(y1, np.float64)

    def outer_f(xs, owners):
        return adaptive_simpson_batch(
            lambda ys, io: f2(xs[io], ys, owners[io]),
            y0[owners], y1[owners], eps, max_depth,
        )

    return adaptive_simpson_batch(outer_f, x0, x1, eps, max_depth)
