"""Persistent wavefront path tracing: stream compaction and queue refill
(port of akari_render_tpu/integrators/wavefront.py).

One pool of lanes at mixed depths: after a bounce the dead lanes retire
(their clamped radiance times the filter weight, and the weight, are
index-added into the film) and are refilled with fresh camera samples from
the render's (pixel, sample) queue, item = sample * npix + pixel. A lane's
sampler is keyed by (pixel, sample) with a per-lane sample index and
per-lane dimensions (core/lds.py `lanewise`), and its bounce is
trace_paths' bounce at the lane's own depth, so each item's radiance is
the pass's (integrators/pt.py); only the film's accumulation order
differs (on the card index_add_ runs in any order), so the two agree to
float tolerance, not bit for bit.

The refill is gated as in the JAX package: it runs when at least a quarter
of the pool is dead, or before the first bounce. It ranks the empty slots
by a cumsum, builds fresh lanes for the whole pool and selects them into
the empty slots the queue still covers. With fused rays (AKR_FUSE_RAYS=1,
common.uses_fused_rays) a lane's shadow ray rides the next bounce's
traversal and a lane with a pending shadow holds its slot until it lands.
Shading goes through the per-kind dispatch only, as in the JAX module.

Pool: min(npix * spp, AKR_MAX_LANES) lanes when AKR_MAX_LANES is set (at
least 1,024), else min(npix * spp, npix), one wavefront of all pixels
(pt.lane_cap). The JAX module's _resolve_pending is common.resolve_pending,
which trace_paths shares.
The host reads one small tensor a bounce (live, dead and pending counts);
the queue head is a host integer, so the refill reads nothing. The loop
runs until the queue is drained and no lane is live or pending, so no
pending shadow is left to flush after it.

The JAX package's jitted step (make_step_fn) is render_pt_wavefront's
loop here. Not ported: the watchdog calibration of iterations a dispatch
(AKR_MAX_PASS_SECONDS, AKR_WF_ITERS) and with it the capped dispatches
and their flush of pending shadows; the _STEPS jit memo; make_step_fn's
sharding arguments (npix_owned, pix_base); the JAX package's
max_wavefront_lanes lids, which are the TPU's.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..camera import generate_rays
from ..config import PTConfig
from ..core.color import remove_nan
from ..core.film import Film, develop
from ..core.filters import filter_from_config
from ..core.lds import lanewise, make_sampler
from ..core.math import RAY_TMAX, disable_tf32, dot, face_forward, offset_ray_origin
from ..core.samplers import select
from ..core.sampling import mis_weight
from ..lights import pdf_direct
from ..scene import Scene
from .common import (
    PTSettings, _emission_at, clamp_radiance, counts, dispatch_shade, fused_trace,
    nee_light_sample, pending_rows, resolve_pending, uses_fused_rays,
)
from .pt import lane_cap

# a refill runs once this share of the pool is dead
REFILL_DEAD_SHARE = 0.25


def _fresh_lanes(scene: Scene, filt, width: int, height: int, item, sampler_config, seed: int,
                 fused: bool = False) -> dict:
    """Lane state of the queue items `item` ([N] int64, sample * npix +
    pixel): camera rays, the sampler after the camera draw with per-lane
    dimensions, depth 0."""
    npix = width * height
    n = item.shape[0]
    dev = item.device
    pix = item % npix
    sampler = make_sampler(sampler_config, pix, item // npix, seed)
    sampler, u_film = sampler.next_2d()
    off, fw = filt.sample(u_film)
    p_film = torch.stack([(pix % width).to(torch.float32), (pix // width).to(torch.float32)],
                         -1) + 0.5 + off
    ray_o, ray_d = generate_rays(scene.camera, p_film)
    lanes = {
        "pix": pix,
        "fw": fw,
        "ray_o": ray_o,
        "ray_d": ray_d,
        "exclude": torch.full((n,), -1, dtype=torch.int32, device=dev),
        "radiance": torch.zeros((n, 3), device=dev),
        "beta": torch.ones((n, 3), device=dev),
        "active": torch.ones((n,), dtype=torch.bool, device=dev),
        "prev_bsdf_pdf": torch.zeros((n,), device=dev),
        "base_replay": torch.zeros((n, 3), device=dev),
        "depth": torch.zeros((n,), dtype=torch.int64, device=dev),
        "sampler": lanewise(sampler, n),
    }
    if fused:  # a pending NEE shadow ray, landed by the next bounce's traversal
        lanes.update(pending_rows(n, dev))
    return lanes


def _lane_select(mask, a: dict, b: dict) -> dict:
    """Lane i of state a where mask[i], else of b; every row, the sampler's
    included (its shared leaves pass through)."""
    out = {}
    for k, x in a.items():
        if k == "sampler":
            out[k] = select(mask, x, b[k])
        else:
            out[k] = torch.where(mask.reshape(mask.shape + (1,) * (x.ndim - 1)), x, b[k])
    return out


def _bounce_perlane(scene: Scene, settings: PTSettings, st: dict, fused: bool = False) -> dict:
    """One bounce at each lane's own depth: trace_paths' bounce and its last
    intersect folded together. A lane at max_depth takes the emission at
    its hit and dies; the others go on through NEE, the BSDF sample and RR.
    Under fused rays the previous bounce's pending shadows ride this
    bounce's traversal and land here."""
    a = scene.arrays
    n = st["pix"].shape[0]
    dev = st["ray_o"].device
    depth = st["depth"]
    zeros_n = torch.zeros((n,), device=dev)
    st = dict(st)
    if fused:
        hit, occluded = fused_trace(scene, st, torch.zeros((2 * n,), device=dev))
        resolve_pending(st, occluded)
    else:
        hit = scene.intersect_alpha(st["ray_o"], st["ray_d"], zeros_n,
                                    torch.where(st["active"], RAY_TMAX, -1.0),
                                    exclude0=st["exclude"])
    lane_hit = st["active"] & hit.valid
    si = scene.surface_interaction(hit.tri_id, hit.bary)
    wo = -st["ray_d"]

    # surface-light emission with MIS (pt.rs:230-258)
    front = dot(si["ng"], st["ray_d"]) < 0.0
    ok = lane_hit & (si["light_id"] >= 0) & front
    le = _emission_at(scene, si, wo, ok)
    if settings.use_nee:
        lpdf = pdf_direct(a.lights, si["light_id"], si["prim_pdf"], si["area"], si["ng"],
                          si["p"], st["ray_o"])
        w = torch.where(depth == 0, 1.0, mis_weight(st["prev_bsdf_pdf"], lpdf))
    else:
        w = torch.ones((n,), device=dev)
    if settings.indirect_only:
        w = torch.where(depth > 1, w, 0.0)
    st["radiance"] = st["radiance"] + torch.where(ok[..., None], st["beta"] * le * w[..., None],
                                                  0.0)
    st["base_replay"] = torch.where((depth == 0)[..., None], st["radiance"], st["base_replay"])

    # lanes at the depth limit stop here (the last intersect's emission only)
    st["active"] = lane_hit & (depth < settings.max_depth)
    cur_depth = depth + 1

    sampler, u_light = st["sampler"].next_3d()
    ls = None
    light_valid = torch.zeros((n,), dtype=torch.bool, device=dev)
    if settings.use_nee and a.lights.num_lights > 0:
        ls = nee_light_sample(scene, si, u_light, st["active"])
        light_valid = ls.valid & st["active"]
        if settings.indirect_only:
            light_valid = light_valid & (cur_depth > 1)

    sampler, u_bsdf = sampler.next_3d()
    extra = {"wo": wo, "u_bsdf": u_bsdf}
    if ls is not None:
        extra.update(ls_wi=ls.wi, ls_li=ls.li, ls_pdf=ls.pdf)

    def shade(closure, ex):
        out = {}
        if "ls_wi" in ex:
            f_l, pdf_l = closure.evaluate(ex["wo"], ex["ls_wi"])
            wl = mis_weight(ex["ls_pdf"], pdf_l)
            out["direct"] = ex["ls_li"] * f_l * (wl / torch.clamp(ex["ls_pdf"], min=1e-20))[
                ..., None]
        out.update(closure.sample(ex["wo"], ex["u_bsdf"][..., 0], ex["u_bsdf"][..., 1:]))
        return out

    sh = dispatch_shade(scene, si, extra, shade, st["active"], settings.force_diffuse)
    if not sh:  # no live lane: every output is zero
        sh = {k: torch.zeros((n,) + s, dtype=dt, device=dev) for k, s, dt in (
            ("wi", (3,), torch.float32), ("f", (3,), torch.float32), ("pdf", (), torch.float32),
            ("valid", (), torch.bool), ("direct", (3,), torch.float32))}

    # the shadow ray and the direct light (pt.rs:504-513)
    if ls is not None and fused:
        st.update(p_ro=ls.shadow_ro, p_wi=ls.wi, p_dist=ls.shadow_dist, p_valid=light_valid,
                  p_contrib=st["beta"] * sh["direct"], p_ex0=si["tri_id"].to(torch.int32),
                  p_ex1=ls.dest_tri)
    elif ls is not None:
        occluded = scene.occlude_alpha(
            ls.shadow_ro, ls.wi, zeros_n, torch.where(light_valid, ls.shadow_dist, -1.0),
            exclude0=si["tri_id"].to(torch.int32), exclude1=ls.dest_tri)
        direct_ok = light_valid & ~occluded
        st["radiance"] = st["radiance"] + torch.where(direct_ok[..., None],
                                                      st["beta"] * sh["direct"], 0.0)

    # continue the path (pt.rs:778-866)
    sample_ok = sh["valid"] & (sh["pdf"] > 0.0) & (torch.min(sh["f"], -1).values >= 0.0)
    st["active"] = st["active"] & sample_ok
    st["beta"] = st["beta"] * torch.where(
        st["active"][..., None], sh["f"] / torch.clamp(sh["pdf"], min=1e-20)[..., None], 1.0)
    # russian roulette (pt.rs:210-224, 843-850)
    sampler, u_rr = sampler.next_1d()
    cont_prob = torch.where(cur_depth > settings.rr_depth,
                            torch.clamp(torch.max(st["beta"], -1).values, 0.0, 1.0) * 0.95, 1.0)
    st["active"] = st["active"] & (u_rr < cont_prob)
    st["beta"] = st["beta"] / torch.clamp(cont_prob, min=1e-20)[..., None]
    st["prev_bsdf_pdf"] = sh["pdf"]
    st["ray_o"] = offset_ray_origin(si["p"], face_forward(si["ng"], sh["wi"]))
    st["ray_d"] = sh["wi"]
    st["exclude"] = si["tri_id"].to(torch.int32)
    st["depth"] = cur_depth
    st["sampler"] = sampler
    return st


def _finish_radiance(settings: PTSettings, st: dict):
    """A path's film value: trace_paths' clamp of the indirect part, then
    remove_nan."""
    return remove_nan(clamp_radiance(settings, st["radiance"], st["base_replay"]))


def _retire(settings: PTSettings, film: Film, lanes: dict, retire) -> None:
    """Add the lanes `retire` into the film (index_add_ at their pixels)."""
    npix = film.weight.shape[0]
    pixc = torch.clamp(lanes["pix"], 0, npix - 1)
    contrib = _finish_radiance(settings, lanes) * lanes["fw"][..., None]
    film.accum.index_add_(0, pixc, torch.where(retire[..., None], contrib, 0.0))
    film.weight.index_add_(0, pixc, torch.where(retire, lanes["fw"], 0.0))


def _refill(scene: Scene, settings: PTSettings, filt, film: Film, lanes: dict, done, qhead: int,
            total: int, sampler_config, seed: int, fused: bool) -> dict:
    """Retire the lanes `done` into the film and refill them from the queue
    items qhead, qhead + 1, ... (a cumsum rank over the empty slots)."""
    width, height = scene.camera.width, scene.camera.height
    _retire(settings, film, lanes, done & (lanes["pix"] >= 0))
    rank = torch.cumsum(done.to(torch.int64), 0) - done.to(torch.int64)
    item = qhead + rank
    fresh = _fresh_lanes(scene, filt, width, height, torch.clamp(item, max=total - 1),
                         sampler_config, seed, fused)
    lanes = dict(lanes, pix=torch.where(done, -1, lanes["pix"]), active=lanes["active"] & ~done)
    return _lane_select(done & (item < total), fresh, lanes)


def _empty_lanes(scene: Scene, filt, width: int, height: int, pool: int, sampler_config,
                 seed: int, fused: bool = False) -> dict:
    """A pool of empty slots (pixel -1, dead), filled by the first refill."""
    lanes = _fresh_lanes(scene, filt, width, height,
                         torch.zeros((pool,), dtype=torch.int64, device=scene.device),
                         sampler_config, seed, fused)
    lanes["pix"] = torch.full((pool,), -1, dtype=torch.int64, device=scene.device)
    lanes["active"] = torch.zeros((pool,), dtype=torch.bool, device=scene.device)
    return lanes


def render_pt_wavefront(scene: Scene, config: PTConfig, task=None, progress_cb=None,
                        session=None):
    """Persistent-wavefront render_pt: the pass's image distribution with
    the pool kept full. Returns (image [H, W, 3] numpy float32, stats)
    with render_pt's series and keys ("tier": "persistent")."""
    disable_tf32()
    width, height = scene.camera.width, scene.camera.height
    npix = width * height
    filt = filter_from_config(task.filter_config if task else None)
    settings = PTSettings(max_depth=config.max_depth, rr_depth=config.rr_depth,
                          use_nee=config.use_nee, indirect_only=config.indirect_only,
                          force_diffuse=config.force_diffuse,
                          clamp_indirect=config.clamp_indirect)
    seed = task.seed if task else 0
    sampler_config = task.sampler if task else None
    pool = min(npix * config.spp, lane_cap(npix))
    fused = uses_fused_rays(scene, settings)
    film = Film.new(width, height, scene.device)
    lanes = _empty_lanes(scene, filt, width, height, pool, sampler_config, seed, fused)
    qhead, total = 0, npix * config.spp
    stats = {"time": [], "spp": [], "tier": "persistent", "shade": "dispatch",
             "traversal": scene.traversal, "fused_rays": fused, "pool": pool, "refills": 0,
             "bounces": 0}
    t0 = time.time()
    while True:
        dead = ~lanes["active"]
        if fused:  # a pending NEE holds its lane until it lands
            dead = dead & ~lanes["p_valid"]
        pending = lanes["p_valid"].sum() if fused else torch.zeros((), dtype=torch.int64,
                                                                   device=scene.device)
        n_active, n_dead, n_pending = torch.stack(
            [lanes["active"].sum(), dead.sum(), pending]).tolist()  # the one host read
        if qhead >= total and n_active == 0 and n_pending == 0:
            break
        if n_dead >= REFILL_DEAD_SHARE * pool or qhead == 0:
            lanes = _refill(scene, settings, filt, film, lanes, dead, qhead, total,
                            sampler_config, seed, fused)
            qhead = min(qhead + n_dead, total)
            stats["refills"] += 1
        lanes = _bounce_perlane(scene, settings, lanes, fused)
        counts["bounces"] += 1
        stats["bounces"] += 1
    # the lanes that died on the last bounce
    _retire(settings, film, lanes, ~lanes["active"] & (lanes["pix"] >= 0))
    if scene.device.type == "cuda":
        torch.cuda.synchronize(scene.device)
    stats["total_time"] = time.time() - t0
    stats["spp_total"] = config.spp
    stats["time"].append(stats["total_time"])
    stats["spp"].append(config.spp)
    if progress_cb is not None:
        progress_cb(config.spp, config.spp, stats)
    if session is not None and session.save_stats:
        from ..stats import RenderStats

        render_stats = RenderStats()
        render_stats.record(stats["total_time"], stats["spp_total"])
        render_stats.write(session)
    img = develop(film, width, height).cpu().numpy().astype(np.float32)
    return img, stats
