"""The comparison that decides `correct`: what the timed jobs produced,
held against the plain reference (bench_torch/reference/), after the window
has closed and the program's state is freed.

Four numbers, each with its limit from the configuration file (an MCMC
configuration's image number is job_chi2, a PT one's tile_chi2):

- `hit_gap_pct`: of the traversal answers kept from the checked jobs (a
  fixed sample of lanes of every Scene.intersect and Scene.occlude call,
  camera rays and every bounce's rays and shadow rays, live lanes only),
  the percentage that disagree with the reference's float64 cast of the
  same ray: a hit where it finds none or the reverse, a closest hit whose t
  differs by more than T_REL of the reference's, or an occlusion answer
  that differs. The program excludes the triangle a ray leaves (and the
  light it aims at) by id; the reference, which knows no ids, ignores hits
  closer than T_NEAR of the scene's size and, for shadow rays, the last
  T_FAR of the segment, and the emitting triangle whose plane passes
  within AIMED of the scene's size of the segment's end (the light it
  aims at: the program offsets a shadow ray's origin off its surface, so a
  grazing ray meets the light's plane well before its end).
- `camera_px`: the farthest a kept camera ray (a ray from the camera's
  origin) strays from its pixel, in pixels beyond the filter's radius; lane
  i of a camera call is pixel i. A camera lane that is not live, or a job
  whose camera calls hold other than spp x width x height lanes, reads the
  image's width. An MCMC job (camera_layout) aims a chain's camera ray at
  a pixel drawn from its own sample vector: its bootstrap's and chains'
  calls are held to the film's footprint (the image padded by the filter's
  radius), its direct pass's calls (the last direct_spp) by the rule
  above, and its camera lanes must number n_bootstrap + n_chains x (1 +
  steps) + direct_spp x width x height, or it reads the width: a job that
  skips its bootstrap, its mutations or its direct pass.
- `tile_chi2`: the image. The mean of every job's image in the window is
  cut into a grid of tiles x tiles tiles; each tile's mean, a channel at a
  time, is held against the mean of the reference path tracer's image
  (reference/render.py, float64, its own estimator and random numbers)
  over the same pixels. z = gap / the gap's standard error, from the
  reference's per-pixel sample variance over both sides' samples (the
  program's stratified samplers only lower theirs); the number is the mean
  of z^2, about 1 when both render the same image and larger for any bias
  (a BSDF, the light, the camera, the film, a lane left out).
- `job_chi2` (MCMC jobs, in place of tile_chi2): the same tiles, the mean
  of the window's job images against the reference path tracer's image;
  the standard error comes from the spread between the jobs (correlated
  chains make the per-pixel variance no measure of a job's error):
  SE^2 = s^2 between the jobs' tile means / jobs + the reference's
  variance of its tile mean.
- `repeat_pct`: of the pixels that are not zero, the percentage equal bit
  for bit between two checked jobs, or the first and the warm-up's image
  (different sampler keys must give different images).

The control (check.control_answers, control.py: the reference in TF32 and
bfloat16 in the program's place) sets the upper readings of the first
three; repeat_pct's comes from the faults of test_checks.py.
"""
from __future__ import annotations

import numpy as np

T_REL = 1e-4
T_NEAR = 1e-5
T_FAR = 1e-4
AIMED = 2e-3  # how near a shadow ray's end an emitter's plane counts as aimed at
FILTER_RADIUS = 1.5


def camera_layout(method: dict, spp: int, width: int, height: int) -> dict | None:
    """The camera calls of a job of `spp` samples where they are not spp
    pixel-indexed calls of every pixel (None: "pt"). For "mcmc_opt":
    {"lanes": n_bootstrap + n_chains x (1 + steps) + direct_spp x W x H,
    "pixel_calls": direct_spp}, steps being the mutations a chain that spp
    mutations a pixel make (W x H x spp // n_chains, at least 1), worked out
    from the configuration, not read from the program."""
    if method["type"] != "mcmc_opt":
        return None
    npix = width * height
    steps = max(1, npix * spp // method["n_chains"])
    direct = max(0, method["direct_spp"])
    return {"lanes": method["n_bootstrap"] + method["n_chains"] * (1 + steps) + direct * npix,
            "pixel_calls": direct}


def compare(ref, jobs: list, width: int, height: int, device, prior=None,
            layout: dict | None = None) -> dict:
    """jobs: [{"spp", "image" [H, W, 3], "records": [(kind, n, rays [k, 8],
    answers [k, 2 or 1]), ...], "lanes": {n: lane index [k]}}]; prior: an
    image rendered before them (the warm-up's), which the first is held
    against for repeat_pct; layout: camera_layout's, for the jobs' camera
    calls. Returns {name: value} of the traversal's, the camera's and the
    repeats' numbers."""
    import torch

    from .reference.camera import raster_of
    from .reference.traverse import Triangles

    tris = Triangles(ref.tris, device, emits=(ref.emission > 0).any(1), groups=ref.groups)
    lo, hi = ref.tris.reshape(-1, 3).min(0), ref.tris.reshape(-1, 3).max(0)
    size = float(np.linalg.norm(hi - lo))
    cam_o = torch.as_tensor(ref.camera.origin, dtype=torch.float64, device=device)
    npix = width * height
    disagree = compared = 0
    camera_px = 0.0
    repeat = 0.0
    prev = None if prior is None else np.asarray(prior)
    for job in jobs:
        cam_lanes = 0
        cams = []  # (live, raster positions, lane index) of each camera call, in order
        for kind, n, rays, ans in job["records"]:
            rays = rays.to(device=device, dtype=torch.float64)
            ans = ans.to(device=device, dtype=torch.float64)
            idx = job["lanes"][n].to(device)
            o, d, tmin, tmax = rays[:, 0:3], rays[:, 3:6], rays[:, 6], rays[:, 7]
            live = (tmax > tmin) & torch.isfinite(rays).all(1)
            is_cam = kind == "intersect" and bool(
                (torch.linalg.vector_norm(o - cam_o, dim=1) < T_NEAR * size).all())
            if is_cam:
                cam_lanes += n
                cams.append((live, raster_of(ref.camera, d), idx))
            if not bool(live.any()):
                continue
            o, d, tmin, tmax, a = o[live], d[live], tmin[live], tmax[live], ans[live]
            near = torch.clamp(tmin, min=T_NEAR * size)
            if kind == "intersect":
                t, i = tris.cast(o, d, near, tmax)
                ref_hit = i >= 0
                got_hit = a[:, 1] > 0.5
                gap = (a[:, 0] - t).abs() > T_REL * torch.clamp(t, min=T_NEAR * size)
                bad = (ref_hit != got_hit) | (ref_hit & got_hit & gap)
            else:
                aim = tris.aimed_emitter(o + d * tmax[:, None], AIMED * size)
                t, i = tris.cast(o, d, near, tmax * (1.0 - T_FAR), any_hit=True, skip=aim)
                bad = (i >= 0) != (a[:, 0] > 0.5)
            disagree += int(bad.sum())
            compared += int(bad.numel())
        pixel_calls = len(cams) if layout is None else layout["pixel_calls"]
        for k, (live, p, idx) in enumerate(cams):
            if not bool(live.all()):
                camera_px = max(camera_px, float(width))
            if k >= len(cams) - pixel_calls:  # lane i is pixel i
                pix = idx % npix
                centre = torch.stack([(pix % width).to(torch.float64) + 0.5,
                                      (pix // width).to(torch.float64) + 0.5], 1)
                off = (p - centre).abs().max(1).values - FILTER_RADIUS
            else:  # inside the image padded by the filter's radius
                off = torch.stack([-p[:, 0], p[:, 0] - width, -p[:, 1], p[:, 1] - height],
                                  1).max(1).values - FILTER_RADIUS
            camera_px = max(camera_px, float(off.clamp(min=0).max()))
        if cam_lanes != (job["spp"] * npix if layout is None else layout["lanes"]):
            camera_px = max(camera_px, float(width))
        if prev is not None:
            a, b = prev.reshape(npix, 3), np.asarray(job["image"]).reshape(npix, 3)
            nz = (a != 0).any(1) | (b != 0).any(1)
            if nz.any():
                repeat = max(repeat, float((a[nz] == b[nz]).all(1).mean()) * 100.0)
        prev = np.asarray(job["image"])
    return {"hit_gap_pct": 100.0 * disagree / max(compared, 1), "camera_px": camera_px,
            "repeat_pct": repeat, "answers_compared": compared}


def mean_image(images: list) -> np.ndarray:
    """The mean of images [H, W, 3] of equal samples, [H*W, 3] float64."""
    acc = np.zeros(np.asarray(images[0]).reshape(-1, 3).shape)
    for img in images:
        acc += np.asarray(img, np.float64).reshape(-1, 3)
    return acc / len(images)


def reference_image(ref, conf: dict, width: int, height: int, seed: int, device,
                    precision: str = "float64", spp: int | None = None) -> dict:
    """The reference path tracer's image of the configuration (its own
    random numbers, drawn from the run's seed): conf["reference"]["spp"]
    samples a pixel, or `spp`."""
    from .reference.render import render

    m = conf["method"]
    return render(ref, width, height, spp or conf["reference"]["spp"], m["max_depth"],
                  m["rr_depth"], conf["film"]["filter"]["radius"], seed ^ 0x5EED, device,
                  precision)


def tile_sums(width: int, height: int, tiles: int):
    """(tsum, count): tsum(v) [tiles^2, 3] sums v [H*W, 3] over each tile of
    a tiles x tiles grid; count [tiles^2, 1] its pixels."""
    y, x = np.divmod(np.arange(width * height), width)
    tile = (y * tiles // height) * tiles + x * tiles // width
    count = np.bincount(tile, minlength=tiles * tiles)[:, None]

    def tsum(v):
        return np.stack([np.bincount(tile, v[:, c], tiles * tiles) for c in range(3)], 1)

    return tsum, count


def tile_chi2(mean, n_samples: int, reference: dict, width: int, height: int,
              tiles: int) -> float:
    """mean: [H*W, 3] the jobs' mean image over n_samples samples a pixel;
    reference: reference_image's. The mean over tiles and channels of z^2
    (module docstring)."""
    ref_mean = reference["mean"].cpu().numpy()
    ref_var = reference["var"].cpu().numpy()
    tsum, count = tile_sums(width, height, tiles)
    gap = (tsum(mean) - tsum(ref_mean)) / count
    var = tsum(ref_var) / (count * count)
    se2 = var / n_samples + var / reference["spp"]
    z2 = np.where(gap == 0, 0.0, gap * gap / np.maximum(se2, 1e-30))
    return float(z2.mean())


def job_chi2(images: list, reference: dict, width: int, height: int, tiles: int) -> float:
    """images: the window's job images [H, W, 3], of equal samples;
    reference: reference_image's. The mean over tiles and channels of z^2,
    z = (the jobs' mean tile value - the reference's) / SE, with SE^2 the
    jobs' sample variance of the tile value over their number plus the
    reference's variance of its tile mean (module docstring). With fewer
    than two jobs there is no spread to judge by: inf."""
    if len(images) < 2:
        return float("inf")
    tsum, count = tile_sums(width, height, tiles)
    jobs = np.stack([tsum(np.asarray(img, np.float64).reshape(-1, 3)) / count for img in images])
    ref_t = tsum(reference["mean"].cpu().numpy()) / count
    ref_var = tsum(reference["var"].cpu().numpy()) / (count * count) / reference["spp"]
    gap = jobs.mean(0) - ref_t
    se2 = jobs.var(0, ddof=1) / len(images) + ref_var
    z2 = np.where(gap == 0, 0.0, gap * gap / np.maximum(se2, 1e-30))
    return float(z2.mean())


def control_answers(ref, jobs: list, device) -> list:
    """The checked jobs with every kept traversal answer replaced by the
    control's: the reference's cast in TF32, with the same exclusions, put
    where the program's answers were."""
    import torch

    from .reference.traverse import Triangles

    tris = Triangles(ref.tris, device, "tf32", emits=(ref.emission > 0).any(1), groups=ref.groups)
    lo, hi = ref.tris.reshape(-1, 3).min(0), ref.tris.reshape(-1, 3).max(0)
    size = float(np.linalg.norm(hi - lo))
    out = []
    for job in jobs:
        recs = []
        for kind, n, rays, ans in job["records"]:
            r = rays.to(device=device, dtype=torch.float32)
            o, d, tmin, tmax = r[:, 0:3], r[:, 3:6], r[:, 6], r[:, 7]
            near = torch.clamp(tmin, min=T_NEAR * size)
            if kind == "intersect":
                t, i = tris.cast(o, d, near, tmax)
                new = torch.stack([torch.where(i >= 0, t, 1e20), (i >= 0).float()], 1)
            else:
                aim = tris.aimed_emitter(o + d * tmax[:, None], AIMED * size)
                _, i = tris.cast(o, d, near, tmax * (1.0 - T_FAR), any_hit=True, skip=aim)
                new = (i >= 0).float()[:, None]
            recs.append((kind, n, rays, new.cpu()))
        out.append(dict(job, records=recs))
    return out
