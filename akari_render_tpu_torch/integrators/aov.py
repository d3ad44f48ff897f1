"""AOV (arbitrary output variable) renderer (port of
akari_render_tpu/integrators/aov.py; reference aov.rs:8-173): first-hit
shading normal, geometric normal, tangent, bitangent, albedo (plus
emission), roughness and depth, each into its own film, with the optional
[-1, 1] -> [0, 1] remap of the vectors. The CLI writes one image a name
and albedo as the main image.

Each sample traces one camera ray a pixel, keyed like the JAX package's
(a PCG32 stream on (sample index, pixel), not make_sampler: camera 2D, then
the lobe-selection 1D of `roughness`). The lanes a ray hit are grouped by
shader kind, as dispatch_shade groups them (torch.nonzero per kind), and
each kind's closure gives its albedo, roughness and shading normal; missed
lanes give zeros. Samples are binned by their raster position.

Not ported: the TPU's pixel blocks (max_wavefront_lanes): the port traces
every pixel in one wavefront.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..camera import generate_rays
from ..config import AOVConfig
from ..core.film import Film, add_samples, develop
from ..core.math import RAY_TMAX, disable_tf32
from ..core.pcg import MASK32, Pcg32, u64_from_limbs
from ..core.samplers import IndependentSampler
from ..scene import Scene

AOV_NAMES = ["albedo", "ns", "ng", "tangent", "bitangent", "roughness", "depth"]


def aov_sample(scene: Scene, sample_index: int, remap: bool = True) -> tuple[torch.Tensor, dict]:
    """One sample for every pixel: (raster positions [H*W, 2], dict of the
    seven AOVs [H*W, 3], zero where the camera ray missed)."""
    width, height = scene.camera.width, scene.camera.height
    n = width * height
    dev = scene.device
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    hi = torch.full_like(pix, int(sample_index) & MASK32)
    sampler = IndependentSampler(Pcg32.new_seq(u64_from_limbs(hi, pix)))
    sampler, u_film = sampler.next_2d()
    p_film = torch.stack(
        [(pix % width).to(torch.float32), (pix // width).to(torch.float32)], -1
    ) + 0.5 + (u_film - 0.5)
    ray_o, ray_d = generate_rays(scene.camera, p_film)
    hit = scene.intersect(ray_o, ray_d, torch.zeros(n, device=dev),
                          torch.full((n,), RAY_TMAX, device=dev))
    si = scene.surface_interaction(hit.tri_id, hit.bary)
    wo = -ray_d
    t, b, _ = si["frame"]
    albedo = torch.zeros((n, 3), device=dev)
    roughness = torch.zeros((n,), device=dev)
    ns = torch.zeros((n, 3), device=dev)
    sampler, u_sel = sampler.next_1d()
    for k in range(len(scene.kinds)):
        rows = torch.nonzero(hit.valid & (si["kind"] == k)).squeeze(1)
        if rows.numel() == 0:
            continue
        closure = scene.kind_closure(si, k, rows)
        w = wo[rows]
        albedo[rows] = closure.albedo(w) + closure.emission(w)
        roughness[rows] = closure.roughness(w, u_sel[rows])
        ns[rows] = closure.ns()

    def rm(v):
        return v * 0.5 + 0.5 if remap else v

    outs = {
        "albedo": albedo,
        "ns": rm(ns),
        "ng": rm(si["ng"]),
        "tangent": rm(t),
        "bitangent": rm(b),
        "roughness": roughness[..., None].expand(n, 3),
        "depth": hit.t[..., None].expand(n, 3),
    }
    valid = hit.valid[..., None]
    return p_film, {k: torch.where(valid, v, 0.0) for k, v in outs.items()}


def render_aov(scene: Scene, config: AOVConfig, task=None, remap: bool = True):
    """Render config.spp samples of every AOV; returns (the albedo image
    [H, W, 3] numpy float32, stats with "images": name -> [H, W, 3])."""
    disable_tf32()
    width, height = scene.camera.width, scene.camera.height
    films = {k: Film.new(width, height, scene.device) for k in AOV_NAMES}
    ones = torch.ones(width * height, device=scene.device)
    t0 = time.time()
    for p in range(config.spp):
        p_film, outs = aov_sample(scene, p, remap)
        for k, film in films.items():
            add_samples(film, p_film, outs[k], ones, width, height)
    if scene.device.type == "cuda":
        torch.cuda.synchronize(scene.device)
    stats = {"total_time": time.time() - t0, "spp_total": config.spp, "aovs": list(AOV_NAMES)}
    images = {k: develop(f, width, height).cpu().numpy().astype(np.float32)
              for k, f in films.items()}
    return images["albedo"], {**stats, "images": images}
