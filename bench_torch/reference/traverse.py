"""Brute-force ray casting against every world-space triangle, in plain torch.

The triangles come in groups (one an instance); a ray is cast against a
group only where it meets the group's bounding box before its best hit so
far. Each triangle becomes three planes: its supporting plane (t) and two
barycentric planes (u for the second vertex, v for the third), so one ray
against all triangles is six products of [R, 3] by [3, T], done as matrix
products in blocks of triangles. For a point p on the triangle's plane,
u(p) = (p - A) . (e2 x n) / |n|^2 and v(p) = (p - A) . (n x e1) / |n|^2,
with e1 = B - A, e2 = C - A, n = e1 x e2; with p = o + t d both are linear
in o and d.

`precision` is "float64" (the reference) or "tf32": the control, float32
with each matrix product's inputs rounded to TF32's 10-bit mantissa, done
explicitly so that it reads the same on the CPU and on the card.
"""
from __future__ import annotations

import torch

BLOCK_T = 4096  # triangles a block: bounds the [R, BLOCK_T] temporaries


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties away) at TF32's 10 mantissa bits."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


class Triangles:
    """The planes of every triangle, on `device`, in the precision asked."""

    def __init__(self, tris, device, precision: str = "float64", emits=None, groups=None):
        tri = torch.as_tensor(tris, dtype=torch.float64, device=device)
        self.groups = groups or [(0, tri.shape[0])]
        box = [tri[a:b].reshape(-1, 3) for a, b in self.groups]
        self.box_lo = torch.stack([x.min(0).values for x in box])
        self.box_hi = torch.stack([x.max(0).values for x in box])
        a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
        e1, e2 = b - a, c - a
        n = torch.linalg.cross(e1, e2)
        nn = (n * n).sum(-1, keepdim=True)
        gu = torch.linalg.cross(e2, n) / nn
        gv = torch.linalg.cross(n, e1) / nn
        # [3 planes, 3, T] normals and [3 planes, T] offsets (plane(p) = g . p - h)
        g = torch.stack([n, gu, gv])
        h = torch.stack([(n * a).sum(-1), (gu * a).sum(-1), (gv * a).sum(-1)])
        self.precision = precision
        dt = torch.float64 if precision == "float64" else torch.float32
        self.g = g.transpose(1, 2).to(dt).contiguous()
        self.h = h.to(dt)
        self.ng = (n / torch.sqrt(nn)).to(dt)
        if precision == "tf32":
            self.g = tf32_round(self.g)
        self.count = tri.shape[0]
        self.emits = (torch.as_tensor(emits, dtype=torch.bool, device=device) if emits is not None
                      else torch.zeros(self.count, dtype=torch.bool, device=device))

    def _mm(self, x, j0, j1):
        """[R, 3] x every plane of triangles [j0, j1): [3, R, j1 - j0]."""
        if self.precision == "tf32":
            x = tf32_round(x)
        return torch.matmul(x, self.g[:, :, j0:j1])

    def aimed_emitter(self, p, reach: float):
        """For points p [R, 3]: the emitting triangle whose plane passes
        within `reach` of the point and whose face holds its projection
        (the nearest plane wins), else -1. A shadow ray's end lies there."""
        ids = self.emits.nonzero().squeeze(1)
        out = torch.full((p.shape[0],), -1, dtype=torch.int64, device=p.device)
        if ids.numel() == 0:
            return out
        g, h = self.g[:, :, ids].to(torch.float64), self.h[:, ids].to(torch.float64)
        pp = p.to(torch.float64)
        nn = torch.linalg.vector_norm(g[0], dim=0)
        dist = (pp @ g[0] - h[0]).abs() / nn
        u, v = pp @ g[1] - h[1], pp @ g[2] - h[2]
        face = (u >= -0.01) & (v >= -0.01) & (u + v <= 1.01) & (dist < reach)
        dist = torch.where(face, dist, float("inf"))
        best, k = dist.min(1)
        return torch.where(torch.isfinite(best), ids[k], out)

    def cast(self, o, d, tmin, tmax, any_hit: bool = False, skip=None):
        """Closest hit of each ray in the open interval (tmin, tmax):
        (t [R], triangle index [R], -1 and inf for a miss). With any_hit the
        index is that of some hit, and t is its distance. skip: [R] a
        triangle index each ray ignores."""
        dt = self.h.dtype
        o, d, tmin, tmax = (x.to(dt) for x in (o, d, tmin, tmax))
        r = o.shape[0]
        best_t = torch.full((r,), float("inf"), dtype=dt, device=o.device)
        best_i = torch.full((r,), -1, dtype=torch.int64, device=o.device)
        end = tmax
        # slab test of every ray against every group's box (float64, widened)
        o64, d64 = o.to(torch.float64), d.to(torch.float64)
        inv = 1.0 / torch.where(d64 == 0, 1e-300, d64)
        pad = 1e-6 * (self.box_hi - self.box_lo).abs().max() + 1e-9
        t0 = (self.box_lo[None] - pad - o64[:, None]) * inv[:, None]
        t1 = (self.box_hi[None] + pad - o64[:, None]) * inv[:, None]
        near = torch.minimum(t0, t1).max(-1).values
        far = torch.maximum(t0, t1).min(-1).values
        meets = (near <= far) & (far >= tmin[:, None].to(torch.float64)) & (
            near <= end[:, None].to(torch.float64))
        for g, (a, b) in enumerate(self.groups):
            rows = meets[:, g].nonzero().squeeze(1)
            if rows.numel() == 0:
                continue
            if any_hit:
                rows = rows[best_i[rows] < 0]
                if rows.numel() == 0:
                    continue
            t, i = self._cast_range(o[rows], d[rows], tmin[rows], tmax[rows], a, b,
                                    None if skip is None else skip[rows])
            better = t < best_t[rows]
            best_t[rows] = torch.where(better, t, best_t[rows])
            best_i[rows] = torch.where(better, i, best_i[rows])
        return best_t, best_i

    def _cast_range(self, o, d, tmin, tmax, a: int, b: int, skip):
        dt = self.h.dtype
        r = o.shape[0]
        best_t = torch.full((r,), float("inf"), dtype=dt, device=o.device)
        best_i = torch.full((r,), -1, dtype=torch.int64, device=o.device)
        for j0 in range(a, b, BLOCK_T):
            j1 = min(j0 + BLOCK_T, b)
            po = self._mm(o, j0, j1) - self.h[:, None, j0:j1]
            pd = self._mm(d, j0, j1)
            t = -po[0] / pd[0]
            u = po[1] + t * pd[1]
            v = po[2] + t * pd[2]
            ok = ((t > tmin[:, None]) & (t < tmax[:, None]) & (u >= 0) & (v >= 0)
                  & (u + v <= 1) & (pd[0] != 0))
            if skip is not None:
                ids = torch.arange(j0, j1, device=o.device)
                ok &= ids[None, :] != skip[:, None]
            t = torch.where(ok, t, float("inf"))
            tb, ib = t.min(dim=1)
            better = tb < best_t
            best_t = torch.where(better, tb, best_t)
            best_i = torch.where(better, ib + j0, best_i)
        return best_t, best_i
