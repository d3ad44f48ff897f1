"""Progressive multi-jittered (0,2) sample tables with blue-noise ranking
(a copy of akari_render_tpu/core/pmj02.py: numpy only, the same tables bit
for bit; the port caches them in build/cache/, not under AKR_CACHE_DIR).

The reference ships pbrt-v4's pregenerated `PMJ02BN_SAMPLES` tables
(crates/akari_data, git-LFS-missing upstream — SURVEY §2 row 3a) consumed by
`Pmj02BnSampler` (sampler/mod.rs:329-701). We REGENERATE equivalent tables at
first use instead of shipping blobs:

Construction: a pmj02 sequence is exactly an Owen-scrambled (0,2)-sequence
(Christensen, Kensler & Kilpatrick 2018, §5). We take the canonical base
(0,2) pair — x = van-der-Corput radical inverse, y = Sobol' dimension 2 —
and push it through two lazily-materialized random Owen trees. Every
assignment of tree bits is a valid scramble, so the (0,2) stratification
property holds by construction at every power-of-2 prefix (exhaustively
verified in tests/test_core.py).

Deviation from the reference tables, measured and deliberate: pbrt's
blue-noise ranking (best-candidate over the valid placements of each new
sample) is available via `n_candidates > 1` but OFF by default — in this
Owen formulation a new sample's freedom is confined to its finest free
cell, and greedy max-min-distance there pushes points to shared cell
corners (1024-sample set: min toroidal distance 0.0070 plain vs 0.0024
with 10 candidates). The reference's bn gain comes from stratum-pairing
order during batch construction, a freedom the (fixed) base pairing does
not expose; the convergence-critical property — full (0,2) progressive
stratification — is identical.

Tables are float32 [n_sets, n_samples, 2], generated on host (about a
second a set) and disk-cached in build/cache/ (core/cache.py).
"""
from __future__ import annotations

import numpy as np

from .cache import cached_array

N_PMJ02_SETS = 8
N_PMJ02_SAMPLES = 4096
TREE_DEPTH = 24  # scrambled bits per axis; the tail below is uniform random


def _vdc(i: int, bits: int = 32) -> int:
    """Bit-reversed i (van der Corput base 2, fixed-point with `bits` bits)."""
    return int(bin(i)[2:].zfill(bits)[::-1], 2)


def _sobol2_table(n: int, bits: int = 32) -> np.ndarray:
    """Sobol' dimension-2 fixed-point values for indices [0, n), NATURAL
    order (y_i = XOR of direction numbers at i's set bits — Gray-code order
    would break the (vdc(i), sobol2(i)) (0,2) pairing at deep prefixes)."""
    v = np.zeros(bits, np.uint64)
    v[0] = 1 << (bits - 1)
    for k in range(1, bits):
        v[k] = v[k - 1] ^ (v[k - 1] >> 1)
    out = np.zeros(n, np.uint64)
    for i in range(n):
        y = np.uint64(0)
        ii = i
        k = 0
        while ii:
            if ii & 1:
                y ^= v[k]
            ii >>= 1
            k += 1
        out[i] = y
    return out


class _OwenTree:
    """Lazily-fixed per-node flip bits of a binary Owen scrambling tree."""

    def __init__(self, rng):
        self.bits: dict[tuple[int, int], int] = {}  # (level, prefix) -> 0/1
        self.rng = rng

    def missing(self, value: int, depth: int) -> list[tuple[int, int]]:
        """Tree nodes along `value`'s digit path not yet fixed."""
        out = []
        prefix = 0
        for level in range(depth):
            if (level, prefix) not in self.bits:
                out.append((level, prefix))
            bit = (value >> (31 - level)) & 1
            prefix = (prefix << 1) | bit
        return out

    def scramble(self, value: int, depth: int, override=None) -> int:
        """Apply the tree (plus `override` for unfixed nodes) to a 32-bit value."""
        out = 0
        prefix = 0
        for level in range(depth):
            bit = (value >> (31 - level)) & 1
            flip = self.bits.get((level, prefix))
            if flip is None:
                flip = override[(level, prefix)]
            out = (out << 1) | (bit ^ flip)
            prefix = (prefix << 1) | bit
        # uniform random tail below the scrambled depth
        return (out << (32 - depth)) | int(self.rng.integers(0, 1 << (32 - depth)))

    def fix(self, assignment: dict):
        self.bits.update(assignment)


def generate_pmj02(n_samples: int, seed: int = 0, n_candidates: int = 1) -> np.ndarray:
    """One pmj02(bn) set: [n_samples, 2] float64 in [0,1)."""
    rng = np.random.default_rng(seed)
    tx, ty = _OwenTree(rng), _OwenTree(rng)
    base_y = _sobol2_table(n_samples)
    pts = np.empty((n_samples, 2))
    # grid for nearest-neighbor candidate ranking
    gres = max(1, int(np.sqrt(n_samples)))
    grid: dict[tuple[int, int], list[int]] = {}

    def min_dist2(p):
        gx, gy = int(p[0] * gres), int(p[1] * gres)
        best = np.inf
        for r in range(3):  # expand ring search until a neighbor is found
            found = False
            for dx in range(-1 - r, 2 + r):
                for dy in range(-1 - r, 2 + r):
                    cell = ((gx + dx) % gres, (gy + dy) % gres)
                    for j in grid.get(cell, ()):
                        d = pts[j] - p
                        d -= np.round(d)  # toroidal
                        best = min(best, float(d @ d))
                        found = True
            if found:
                return best
        return best

    for i in range(n_samples):
        bx = _vdc(i)
        by = int(base_y[i])
        free_x = tx.missing(bx, TREE_DEPTH)
        free_y = ty.missing(by, TREE_DEPTH)
        best = None
        for _ in range(n_candidates if i > 0 else 1):
            ax = {k: int(rng.integers(0, 2)) for k in free_x}
            ay = {k: int(rng.integers(0, 2)) for k in free_y}
            p = np.array(
                [
                    tx.scramble(bx, TREE_DEPTH, ax) * (1.0 / (1 << 32)),
                    ty.scramble(by, TREE_DEPTH, ay) * (1.0 / (1 << 32)),
                ]
            )
            score = min_dist2(p) if i > 0 else 1.0
            if best is None or score > best[0]:
                best = (score, p, ax, ay)
        _, p, ax, ay = best
        tx.fix(ax)
        ty.fix(ay)
        pts[i] = p
        grid.setdefault((int(p[0] * gres), int(p[1] * gres)), []).append(i)
    return pts


def get_pmj02_tables(n_sets: int = N_PMJ02_SETS,
                     n_samples: int = N_PMJ02_SAMPLES) -> np.ndarray:
    """[n_sets, n_samples, 2] float32, disk-cached."""
    return cached_array(
        f"pmj02bn_{n_sets}x{n_samples}.npy",
        lambda: np.stack(
            [generate_pmj02(n_samples, seed=1000 + s) for s in range(n_sets)]
        ).astype(np.float32),
    )


def is_02_prefix(pts: np.ndarray, k: int) -> bool:
    """Exhaustive (0,2) check: do the first 2^k points one-one cover every
    elementary interval 2^a x 2^b with a+b = k?"""
    n = 1 << k
    p = pts[:n]
    for a in range(k + 1):
        b = k - a
        ix = np.floor(p[:, 0] * (1 << a)).astype(int)
        iy = np.floor(p[:, 1] * (1 << b)).astype(int)
        cells = ix * (1 << b) + iy
        if len(np.unique(cells)) != n:
            return False
    return True
