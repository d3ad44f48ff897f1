"""A plain path tracer of the benchmark's scenes: the reference that the
jobs' images are held against (check.tile_chi2, check.job_chi2) and, cut
into jobs of a GPT job's samples (render_jobs), the reference of a GPT
job's primal and gradient films (check.grad_chi2, check.primal_chi2).

Written from the semantics of the configuration, not from the renderer
under test, whose estimator it does not share:

- the film: a sample of pixel (x, y) is a camera ray through (x + 0.5,
  y + 0.5) plus an offset drawn from the Gaussian filter (sigma = radius / 3,
  each coordinate clamped to the radius), weight 1; a pixel is the mean of
  its samples;
- the PT method (max_depth, rr_depth): emitted radiance where the camera
  ray meets an emitter's front, plus light reaching each of the first
  max_depth scattering vertices; the indirect part (all but the emission
  the camera ray saw) is clamped at CLAMP_INDIRECT a channel;
- the principled BSDF (Blender 4.0) in the subset that
  scene.material_bsdf reads: a Lambert base of the base colour under a GGX
  specular layer (alpha = roughness^2, height-correlated Smith G,
  dielectric Fresnel of the specular IOR, weighted by f0), whose
  directional albedo E takes energy from the base: f = f_spec +
  f_base * min(1 - f0 E(wo), 1 - f0 E(wi)); shading uses the triangle's
  geometric normal, and wo and wi on opposite sides of it scatter nothing;
- emitters are one-sided (the side the triangle's winding faces).

Every scattering vertex samples one emitter point (triangles chosen by
area) with a shadow ray, and continues by a cosine-weighted direction on
wo's side; after rr_depth vertices Russian roulette keeps a path with
probability 0.95 min(1, max throughput). The estimator is unbiased for the
same image, so the jobs' tile means and the reference's differ by noise
alone, which the per-pixel sample variance returned here measures.

`precision` "float64" is the reference. "control" is the same tracer in
the nearest precisions below the configuration's float32 with TF32 off:
traversal's matrix products in TF32 (traverse.Triangles), the camera in
TF32, and every other operation (hit points, directions, BSDF, throughput)
in bfloat16; the film sums stay float64.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .camera import directions
from .traverse import Triangles

CLAMP_INDIRECT = 1000.0
T_EPS = 1e-7  # ray offsets, as a share of the scene's size
LANES = 1 << 17  # camera paths traced together (at least one sample of every pixel)
ALBEDO_KNOTS = 65  # E(cos) knots (linear between them)
ALBEDO_GRID = 512  # quadrature points a side of each knot's hemisphere


def fr_dielectric(c, eta):
    """Unpolarised Fresnel reflectance at cosine c (c < 0: from inside)."""
    eta = torch.where(c > 0, eta, 1.0 / eta)
    c = c.abs().clamp(max=1.0)
    s2t = (1.0 - c * c) / (eta * eta)
    ct = torch.sqrt((1.0 - s2t).clamp(min=0.0))
    rp = (eta * c - ct) / (eta * c + ct)
    rs = (c - eta * ct) / (c + eta * ct)
    return torch.where(s2t >= 1.0, torch.ones_like(c), 0.5 * (rp * rp + rs * rs))


def _lambda(cos, a2):
    tan2 = (1.0 - cos * cos).clamp(min=0.0) / (cos * cos)
    return 0.5 * (torch.sqrt(1.0 + a2 * tan2) - 1.0)


def ggx_spec(co, ci, ch, hdi, a2, eta):
    """GGX reflection times cos(wi), with Fresnel: co, ci the cosines of
    wo and wi with the normal, ch that of the half vector, hdi = wi . h
    with h turned to the normal's side."""
    c2 = ch * ch
    d = a2 / (math.pi * (c2 * (a2 - 1.0) + 1.0) ** 2)
    g = 1.0 / (1.0 + _lambda(co, a2) + _lambda(ci, a2))
    return (d * g / (4.0 * co * ci)).abs() * ci.abs() * fr_dielectric(hdi, eta)


def albedo_curve(a2: float, eta: float, device) -> torch.Tensor:
    """E at ALBEDO_KNOTS cosines in [0, 1]: the directional albedo of
    ggx_spec, by a midpoint rule over (cos theta_i, phi), float64."""
    mu = torch.linspace(0.0, 1.0, ALBEDO_KNOTS, dtype=torch.float64, device=device)
    mu = mu.clamp(1e-4, 0.9999)
    k = (torch.arange(ALBEDO_GRID, dtype=torch.float64, device=device) + 0.5) / ALBEDO_GRID
    ci, phi = k[:, None], 2.0 * math.pi * k[None, :]
    si = torch.sqrt(1.0 - ci * ci)
    out = []
    for m in mu.tolist():
        wo = (math.sqrt(1.0 - m * m), 0.0, m)
        wi = torch.stack(torch.broadcast_tensors(si * torch.cos(phi), si * torch.sin(phi), ci), -1)
        h = wi + wi.new_tensor(wo)
        h = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)
        co = torch.full_like(ci, m).expand_as(h[..., 2])
        f = ggx_spec(co, ci.expand_as(co), h[..., 2], (wi * h).sum(-1), a2, eta)
        out.append(float(f.mean()) * 2.0 * math.pi)
    return torch.tensor(out, dtype=torch.float64, device=device)


class Materials:
    """Per-triangle BSDF inputs and each material's albedo curve."""

    def __init__(self, bsdf: np.ndarray, device, dt):
        p = torch.as_tensor(bsdf, dtype=torch.float64, device=device)
        color, rough, ior, level = p[:, 0:3], p[:, 3], p[:, 4], p[:, 5]
        f0 = ((ior - 1.0) / (ior + 1.0)) ** 2
        f0 = torch.where(level != 0.5, f0 * 2.0 * level, f0)
        s = torch.sqrt(f0.clamp(0.0, 0.99))
        eta = torch.where(level != 0.5, (1.0 + s) / (1.0 - s), ior)
        a2 = (rough * rough).clamp(min=1e-4) ** 2
        keys, inv = torch.unique(torch.stack([a2, eta], 1), dim=0, return_inverse=True)
        curves = torch.stack([albedo_curve(float(a), float(e), device) for a, e in keys.tolist()])
        self.curve = curves[inv]  # [T, ALBEDO_KNOTS]
        self.color, self.f0, self.eta, self.a2 = (x.to(dt) for x in (color, f0, eta, a2))
        self.curve = self.curve.to(dt)

    def albedo(self, tri, c):
        x = torch.nan_to_num(c.abs().to(torch.float64)).clamp(max=1.0) * (ALBEDO_KNOTS - 1)
        i0 = x.floor().long().clamp(0, ALBEDO_KNOTS - 2)
        t = (x - i0).to(self.curve.dtype)
        cv = self.curve[tri]
        return cv.gather(1, i0[:, None])[:, 0] * (1 - t) + cv.gather(1, i0[:, None] + 1)[:, 0] * t

    def f(self, tri, n, wo, wi):
        """f(wo, wi) |cos wi| [R, 3] at triangles tri with normals n."""
        co, ci = (wo * n).sum(-1), (wi * n).sum(-1)
        same = co * ci > 0
        h = wo + wi
        h = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True).clamp(min=1e-30)
        ch = (h * n).sum(-1)
        hdi = (wi * h).sum(-1) * torch.where(ch < 0, -1.0, 1.0).to(h.dtype)
        spec = ggx_spec(co, ci, ch, hdi, self.a2[tri], self.eta[tri]) * self.f0[tri]
        f0 = self.f0[tri]
        keep = torch.minimum(1.0 - f0 * self.albedo(tri, co), 1.0 - f0 * self.albedo(tri, ci))
        base = self.color[tri] * (ci.abs() * keep / math.pi)[:, None]
        f = spec[:, None] + base
        return torch.where((same & torch.isfinite(f).all(-1))[:, None], f, 0.0)


def render(ref, width: int, height: int, spp: int, max_depth: int, rr_depth: int,
           radius: float, seed: int, device, precision: str = "float64") -> dict:
    """{"mean", "var": [H*W, 3] float64 (a pixel's sample mean and the
    variance of one sample), "spp"} of `spp` samples of every pixel."""
    npix = width * height
    s1 = torch.zeros((npix, 3), dtype=torch.float64, device=device)
    s2 = torch.zeros_like(s1)
    for pix, _, value in samples(ref, width, height, spp, max_depth, rr_depth, radius, seed,
                                 device, precision):
        s1.index_add_(0, pix, value)
        s2.index_add_(0, pix, value * value)
    return _moments(s1, s2, spp)


def _moments(s1, s2, spp: int) -> dict:
    mean = s1 / spp
    var = (s2 / spp - mean * mean).clamp(min=0.0) * (spp / max(spp - 1, 1))
    return {"mean": mean, "var": var, "spp": spp}


def render_jobs(ref, width: int, height: int, spp: int, job_spp: int, max_depth: int,
                rr_depth: int, radius: float, seed: int, device, on_job,
                precision: str = "float64") -> dict:
    """The reference's samples cut into spp // job_spp jobs of job_spp
    samples of every pixel, as a GPT job renders them: render's result over
    all of them, and, for each job in turn, on_job(aligned, binned) with
    aligned [H*W, 3] the job's mean of every pixel's own samples (each
    credited to the pixel it was aimed at) and binned [H*W, 3] the job's
    samples binned where they landed on the film: each at floor of its
    jittered raster position, clamped into the image, a pixel the mean of
    the samples that landed in it and 0 where none did."""
    npix = width * height
    s1 = torch.zeros((npix, 3), dtype=torch.float64, device=device)
    s2 = torch.zeros_like(s1)
    j1, b1, bw = torch.zeros_like(s1), torch.zeros_like(s1), torch.zeros_like(s1[:, 0])
    done = 0
    for pix, p_film, value in samples(ref, width, height, spp // job_spp * job_spp, max_depth,
                                      rr_depth, radius, seed, device, precision,
                                      per_chunk=job_spp):
        s1.index_add_(0, pix, value)
        s2.index_add_(0, pix, value * value)
        j1.index_add_(0, pix, value)
        ip = p_film.floor().long()
        at = ip[:, 1].clamp(0, height - 1) * width + ip[:, 0].clamp(0, width - 1)
        b1.index_add_(0, at, value)
        bw.index_add_(0, at, torch.ones_like(value[:, 0]))
        done += pix.numel() // npix
        if done % job_spp == 0:
            on_job(j1 / job_spp, b1 / torch.where(bw == 0, 1.0, bw)[:, None])
            for acc in (j1, b1, bw):
                acc.zero_()
    return _moments(s1, s2, done)


def samples(ref, width: int, height: int, spp: int, max_depth: int, rr_depth: int,
            radius: float, seed: int, device, precision: str = "float64",
            per_chunk: int | None = None):
    """The reference path tracer's samples, a chunk of whole samples of
    every pixel at a time (at most per_chunk of them): yields (pixel [R]
    int64, raster position [R, 2] float64 (pixel centre + the filter's
    offset), value [R, 3] float64)."""
    if ref.unshaded:
        raise ValueError(f"the reference cannot shade materials {ref.unshaded}")
    control = precision == "control"
    dt = torch.bfloat16 if control else torch.float64
    tris = Triangles(ref.tris, device, "tf32" if control else "float64")
    mats = Materials(ref.bsdf, device, dt)
    tri64 = torch.as_tensor(ref.tris, dtype=torch.float64, device=device)
    n_tri = tris.ng.to(dt)
    emit = torch.as_tensor(ref.emission, dtype=torch.float64, device=device)
    lights = (emit > 0).any(1).nonzero().squeeze(1)
    area = 0.5 * torch.linalg.vector_norm(
        torch.linalg.cross(tri64[:, 1] - tri64[:, 0], tri64[:, 2] - tri64[:, 0]), dim=-1)
    l_cdf = torch.cumsum(area[lights], 0)
    l_area = float(l_cdf[-1]) if len(lights) else 0.0
    emit = emit.to(dt)
    lo, hi = ref.tris.reshape(-1, 3).min(0), ref.tris.reshape(-1, 3).max(0)
    eps = T_EPS * float(np.linalg.norm(hi - lo))
    cam_o = torch.as_tensor(ref.camera.origin, dtype=dt, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & ((1 << 63) - 1))
    npix = width * height

    def rand(n, k):
        return torch.rand((n, k), generator=gen, dtype=torch.float64, device=device).to(dt)

    per = max(1, LANES // npix)
    if per_chunk is not None:  # whole chunks of per_chunk samples
        per = per_chunk if per >= per_chunk else 1
    done = 0
    while done < spp:
        k = min(per, spp - done)
        pix = torch.arange(npix, device=device).repeat(k)
        r = pix.numel()
        u = rand(r, 2).to(torch.float64)
        rr = torch.sqrt(-2.0 * torch.log(u[:, 0].clamp(min=1e-10)))
        off = torch.stack([rr * torch.cos(2 * math.pi * u[:, 1]),
                           rr * torch.sin(2 * math.pi * u[:, 1])], 1) * (radius / 3.0)
        p_film = torch.stack([(pix % width).double(), (pix // width).double()], 1) + 0.5 + \
            off.clamp(-radius, radius)
        d = directions(ref.camera, p_film, "tf32" if control else "float64").to(dt)
        o = cam_o.expand(r, 3)
        lane = torch.arange(r, device=device)
        beta = torch.ones((r, 3), dtype=dt, device=device)
        skip = torch.full((r,), -1, dtype=torch.int64, device=device)
        direct = torch.zeros((r, 3), dtype=torch.float64, device=device)
        indirect = torch.zeros((r, 3), dtype=torch.float64, device=device)
        for depth in range(1, max_depth + 1):
            t, tri = tris.cast(o, d, torch.full((o.shape[0],), eps, dtype=dt, device=device),
                               torch.full((o.shape[0],), float("inf"), dtype=dt, device=device),
                               skip=skip)
            keep = (tri >= 0).nonzero().squeeze(1)
            o, d, t, tri, beta, lane = (x[keep] for x in (o, d, t, tri, beta, lane))
            if lane.numel() == 0:
                break
            n = n_tri[tri]
            p = o + t.to(dt)[:, None] * d
            wo = -d
            if depth == 1:
                front = (n * d).sum(-1) < 0
                direct.index_add_(0, lane, torch.where(front[:, None], emit[tri], 0.0).double())
            # one emitter point, with its shadow ray
            if l_area > 0:
                ul = rand(lane.numel(), 3).to(torch.float64)
                j = lights[torch.searchsorted(l_cdf, ul[:, 0] * l_area).clamp(max=len(lights) - 1)]
                su = torch.sqrt(ul[:, 1:2])
                a, b, c = tri64[j, 0], tri64[j, 1], tri64[j, 2]
                pl = (a * (1 - su) + b * (su * (1 - ul[:, 2:3])) + c * (su * ul[:, 2:3])).to(dt)
                to_l = pl - p
                dist = torch.linalg.vector_norm(to_l, dim=-1)
                wi = to_l / dist[:, None]
                cl = (wi * n_tri[j]).sum(-1)
                f = mats.f(tri, n, wo, wi)
                ok = (cl < 0) & (f > 0).any(-1)
                sel = ok.nonzero().squeeze(1)
                if sel.numel():
                    _, hit = tris.cast(p[sel], wi[sel], torch.full((sel.numel(),), eps, dtype=dt,
                                                                   device=device),
                                       dist[sel] * (1 - 1e-6), any_hit=True, skip=tri[sel])
                    seen = sel[hit < 0]
                    w = (-cl[seen]) * l_area / (dist[seen] * dist[seen])
                    li = beta[seen] * emit[j[seen]] * f[seen] * w[:, None]
                    indirect.index_add_(0, lane[seen], li.double())
            if depth == max_depth:
                break
            # continue on wo's side, cosine-weighted
            ub = rand(lane.numel(), 3)
            ct = torch.sqrt(ub[:, 0])
            st_ = torch.sqrt((1 - ub[:, 0]).clamp(min=0))
            ph = 2 * math.pi * ub[:, 1]
            side = torch.where((wo * n).sum(-1) < 0, -1.0, 1.0).to(dt)
            nn = n * side[:, None]
            helper = torch.where((nn[:, 0].abs() > 0.9)[:, None],
                                 nn.new_tensor([0.0, 1.0, 0.0]), nn.new_tensor([1.0, 0.0, 0.0]))
            tx = torch.linalg.cross(helper, nn)
            tx = tx / torch.linalg.vector_norm(tx, dim=-1, keepdim=True)
            ty = torch.linalg.cross(nn, tx)
            wi = (tx * (st_ * torch.cos(ph))[:, None] + ty * (st_ * torch.sin(ph))[:, None]
                  + nn * ct[:, None])
            f = mats.f(tri, n, wo, wi)
            beta = beta * f * (math.pi / ct.clamp(min=1e-30))[:, None]
            live = (f > 0).any(-1) & (ct > 0)
            if depth >= rr_depth + 1:
                q = 0.95 * beta.max(-1).values.clamp(max=1.0)
                live &= ub[:, 2] < q
                beta = beta / q.clamp(min=1e-30)[:, None]
            keep = live.nonzero().squeeze(1)
            o, d, skip, beta, lane = p[keep], wi[keep], tri[keep], beta[keep], lane[keep]
        value = direct + indirect.clamp(max=CLAMP_INDIRECT)
        yield pix, p_film, torch.where(torch.isfinite(value), value, 0.0)
        done += k
