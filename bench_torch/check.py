"""The comparison that decides `correct`: what the timed jobs produced,
held against the plain reference (bench_torch/reference/), after the window
has closed and the program's state is freed.

Four numbers, each with its limit from the configuration file (an MCMC
configuration's image number is job_chi2, a PT one's tile_chi2; a GPT
configuration has three in place of the image's number: grad_chi2,
primal_chi2 and recon_gap):

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
  skips its bootstrap, its mutations or its direct pass. A GPT job
  (camera_layout) makes 5 x spp camera calls of W x H lanes, a sample's
  base path and then its four shifts, each lane at its pixel moved by the
  shift and reflected at the border (reflect).
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
- `grad_chi2` (GPT): every window job's Gx and Gy films (stats "gx",
  "gy") against what they estimate (grad_expected): for each pair of
  neighbouring tiles of the 16 x 16 grid, the mean over the first tile's
  pixels of the films summed along a window to the pixel a tile further
  on, which estimates the gap between the two tiles' mean radiance taken
  from the reference path tracer, as the solve reads the films; z^2 with the SE of job_chi2.
- `primal_chi2` (GPT): every window job's primal film (stats "primal":
  the base paths binned where they land on the film, not at the pixel
  they were aimed at) against the reference's jobs of as many samples,
  binned alike (reference.render_jobs), in the same tiles; SE^2 = each
  side's spread between its jobs over their number, summed.
- `recon_gap` (GPT): of each checked job, the largest gap between its
  image and a float64 screened-Poisson solve of its own primal, Gx and Gy
  (reference/poisson.py, the same sweeps), over the solve's mean: the
  primal and the gradients alone are unbiased whatever the solve does.
- `repeat_pct`: of the pixels that are not zero, the percentage equal bit
  for bit between two checked jobs, or the first and the warm-up's image
  (different sampler keys must give different images).

The control (check.control_answers, control.py: the reference in TF32 and
bfloat16 in the program's place; for recon_gap a bfloat16 solve) sets the
upper readings of all but repeat_pct, whose comes from the faults of
test_checks.py.
"""
from __future__ import annotations

import numpy as np

T_REL = 1e-4
T_NEAR = 1e-5
T_FAR = 1e-4
AIMED = 2e-3  # how near a shadow ray's end an emitter's plane counts as aimed at
FILTER_RADIUS = 1.5


# a GPT sample's five camera calls: the base path at its pixel, then the
# shifts to the four neighbours in the integrator's order (+x, -x, +y, -y),
# each offset times the method's stride
GPT_SHIFTS = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1))


def reflect(pix, off, width: int, height: int):
    """Pixels pix [N, 2] (x, y) moved by off = (dx, dy) and reflected at the
    image's border, so that -1 becomes 1 and W becomes W - 2 (gpt.rs:126-140,
    written again here)."""
    p = pix + pix.new_tensor(off)
    p = p.abs()
    lim = pix.new_tensor([width - 1, height - 1])
    return (lim - (lim - p).abs())


def camera_layout(method: dict, spp: int, width: int, height: int) -> dict | None:
    """The camera calls of a job of `spp` samples where they are not spp
    pixel-indexed calls of every pixel (None: "pt"). For "mcmc_opt":
    {"lanes": n_bootstrap + n_chains x (1 + steps) + direct_spp x W x H,
    "pixel_calls": direct_spp}, steps being the mutations a chain that spp
    mutations a pixel make (W x H x spp // n_chains, at least 1), worked out
    from the configuration, not read from the program. For "gpt": 5 x spp
    calls of W x H lanes, all live (a shifted path starts live, as the
    base does), call 5s + k holding lane i at pixel i moved by
    GPT_SHIFTS[k] x stride and reflected (`shifts`)."""
    npix = width * height
    if method["type"] == "gpt":
        st = method.get("stride", 1)
        return {"lanes": len(GPT_SHIFTS) * spp * npix, "pixel_calls": len(GPT_SHIFTS) * spp,
                "shifts": [(dx * st, dy * st) for dx, dy in GPT_SHIFTS]}
    if method["type"] != "mcmc_opt":
        return None
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
        shifts = ((0, 0),) if layout is None else layout.get("shifts", ((0, 0),))
        for k, (live, p, idx) in enumerate(cams):
            if not bool(live.all()):
                camera_px = max(camera_px, float(width))
            j = k - (len(cams) - pixel_calls)
            if j >= 0:  # lane i is pixel i, moved by the call's shift
                pix = idx % npix
                xy = reflect(torch.stack([pix % width, pix // width], 1),
                             shifts[j % len(shifts)], width, height)
                centre = xy.to(torch.float64) + 0.5
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


def paired(size: int, stride: int) -> np.ndarray:
    """bool [size]: the columns (rows) c of a gradient film along an axis of
    `size` pixels that hold exactly one pair of contributions a sample:
    base c shifted by +stride, and base c + stride shifted by -stride, the
    pair (c, c + stride) seen from both ends. Worked out from the storage
    rule of the GPT integrator (a shift by +stride is stored at its base
    pixel, one by -stride at its shifted pixel, each reflected at the
    border), written again here. Elsewhere, at the border, a film pixel holds
    one end of a reflected pair alone (the last column's base shifted to the
    one before it; base 0's reflected -stride shift, stored at column
    stride): the expectation of one end depends on the shift's jacobians
    and failures, which no path tracer's image gives, so those pixels are
    not compared."""
    held = {c: [] for c in range(size)}
    for a in range(size):
        for d in (stride, -stride):
            b = abs(a + d)
            b = size - 1 - abs(size - 1 - b)
            held[a if d > 0 else b].append((a, b, d > 0))
    return np.array([sorted(held[c]) == sorted([(c, c + stride, True), (c + stride, c, False)])
                     for c in range(size)])


def _window_sums(g, n: int, step: int, axis: int) -> np.ndarray:
    """sum_{j < n} g[x + j * step] along `axis` of g [H, W, 3], at every x
    where the window fits (0 elsewhere)."""
    g = np.moveaxis(np.asarray(g, np.float64), axis, 0)
    out = np.zeros_like(g)
    for r in range(step):
        c = np.concatenate([np.zeros_like(g[:1]), np.cumsum(g[r::step], 0)])
        w = c[n:] - c[:-n]
        out[r::step][:len(w)] = w
    return np.moveaxis(out, 0, axis)


def grad_pairs(width: int, height: int, tiles: int, stride: int) -> list:
    """For Gx and Gy in turn: (pair [H*W] int, the pair of neighbouring
    tiles (tile, the next to its right or below) that pixel p starts a
    window of, or -1; n, the window's pixels; step, its flat stride). A
    window runs from p over n pixels of the film, `stride` apart along the
    axis, to the pixel one tile further on (p + a tile's width): its sum
    estimates the image's step across it. p counts where every pixel
    of its window is paired and the window stays in the image: all the
    pixels of each tile but the last along the axis, less the border's."""
    if width % tiles or height % tiles:
        raise ValueError(f"{width}x{height} is no whole number of {tiles} tiles a side")
    out = []
    for size, other, axis in ((width, height, 1), (height, width, 0)):
        t = size // tiles
        if t % stride:
            raise ValueError(f"a tile of {t} pixels is no whole number of strides {stride}")
        n = t // stride
        ok = paired(size, stride)
        x = np.arange(size)
        good = np.array([i + t < size and ok[i:i + t:stride].all() for i in x])
        along = np.where(good, x // t, -1)
        across = np.arange(other) // (other // tiles)
        if axis == 1:
            pair = np.where(along[None, :] >= 0, across[:, None] * (tiles - 1) + along[None, :],
                            -1)
        else:
            pair = np.where(along[:, None] >= 0, across[None, :] * (tiles - 1) + along[:, None],
                            -1)
        out.append((pair.reshape(-1), n, stride if axis == 1 else stride * width))
    return out


def grad_tiles(gx, gy, width: int, height: int, tiles: int, stride: int) -> np.ndarray:
    """[2, tiles x (tiles - 1), 3]: for Gx and Gy [H, W, 3] and each pair of
    neighbouring tiles (grad_pairs), the mean over the first tile's pixels
    of the window sums that run from them into the second."""
    out = []
    for g, (pair, n, step), axis in zip((gx, gy), grad_pairs(width, height, tiles, stride),
                                        (1, 0)):
        w = _window_sums(g, n, stride, axis).reshape(-1, 3)
        out.append(_pair_means(pair, w, tiles))
    return np.stack(out)


def _pair_means(pair, v, tiles: int) -> np.ndarray:
    keep = pair >= 0
    k = tiles * (tiles - 1)
    count = np.bincount(pair[keep], minlength=k)[:, None]
    return np.stack([np.bincount(pair[keep], v[keep, c], k) for c in range(3)], 1) / count


def grad_expected(reference: dict, width: int, height: int, tiles: int,
                  stride: int) -> tuple[np.ndarray, np.ndarray]:
    """(mean, var) [2, tiles x (tiles - 1), 3]: what grad_tiles should read,
    and the variance of that reading of the reference. A paired pixel p of
    Gx holds a sample's two ends of the pair (p, q = p + stride): base p's
    shift to q, w (F(q') J - F(p)), and minus base q's shift to p, the two
    MIS weights of a shifted path summing to one (and a failed shift
    weighted 1 against a path that the other end cannot reach). The two
    ends sum to I(q) - I(p) in expectation, I a pixel's radiance through
    its own camera samples (the filter's jitter about its centre). That
    difference is what the screened-Poisson solve reads Gx[p] as (its
    constraint R(q) - R(p) = Gx[p], gpt.rs:487-612, and the upstream
    splats both ends of a pair into one gradient pixel), so it is the
    expectation: E Gx[p] = I(q) - I(p), whatever arithmetic the film uses
    to get there. So for Gy. A window's sum from p to p + a tile's width t
    is then I(p + t) - I(p), and a pair's reading the gap between the mean
    of I over the second tile's pixels and over the first's (those that
    start windows). I comes from the reference path tracer, which
    credits each sample to the pixel it was aimed at; the variance sums
    each of those reference pixels' variance of its mean over count^2.

    A pair of tiles and not a tile alone: a tile's mean of a gradient film
    telescopes along each row to its two edge columns, so it would see an
    error of the image (what the control makes) at those columns alone."""
    var = reference["var"].cpu().numpy() / reference["spp"]
    out_v = []
    for pair, n, step in grad_pairs(width, height, tiles, stride):
        p = np.nonzero(pair >= 0)[0]
        v = np.zeros_like(var)
        v[p] = var[p + n * step] + var[p]
        count = np.bincount(pair[p], minlength=tiles * (tiles - 1))[:, None]
        out_v.append(_pair_means(pair, v, tiles) / count)
    return image_steps(reference["mean"], width, height, tiles, stride), np.stack(out_v)


def image_steps(image, width: int, height: int, tiles: int, stride: int) -> np.ndarray:
    """[2, tiles x (tiles - 1), 3]: what grad_tiles reads of films whose
    every pixel holds its expectation, I(p + t) - I(p) averaged over
    the pair's window starts, for the image I [H*W, 3] (a tensor)."""
    mean = image.cpu().numpy()
    out = []
    for pair, n, step in grad_pairs(width, height, tiles, stride):
        p = np.nonzero(pair >= 0)[0]
        d = np.zeros_like(mean)
        d[p] = mean[p + n * step] - mean[p]
        out.append(_pair_means(pair, d, tiles))
    return np.stack(out)


def grad_chi2(jobs: list, expected: tuple) -> float:
    """jobs: grad_tiles of each job of the window; expected: grad_expected's.
    The mean over Gx and Gy, pairs of tiles and channels of z^2, z = (the
    jobs' mean - the expectation) / SE, SE^2 = the jobs' sample variance /
    jobs + the reference's variance (as job_chi2). With fewer than two
    jobs: inf."""
    if len(jobs) < 2:
        return float("inf")
    g = np.stack(jobs)
    gap = g.mean(0) - expected[0]
    se2 = g.var(0, ddof=1) / len(jobs) + expected[1]
    z2 = np.where(gap == 0, 0.0, gap * gap / np.maximum(se2, 1e-30))
    return float(z2.mean())


def primal_tiles(primal, width: int, height: int, tiles: int) -> np.ndarray:
    """[tiles^2, 3]: the mean of a primal film [H, W, 3] over each tile."""
    tsum, count = tile_sums(width, height, tiles)
    return tsum(np.asarray(primal, np.float64).reshape(-1, 3)) / count


def primal_chi2(jobs: list, reference_jobs: list) -> float:
    """jobs: primal_tiles of each job of the window; reference_jobs: those
    of the reference's jobs of as many samples (reference.render_jobs: its
    samples binned where they land on the film, as a GPT job bins its base
    paths, a pixel 0 where none landed). The mean over tiles and channels
    of z^2, z = the gap of the two sides' means over SE, SE^2 = each side's
    sample variance over its jobs, summed. With fewer than two jobs: inf."""
    if len(jobs) < 2 or len(reference_jobs) < 2:
        return float("inf")
    a, b = np.stack(jobs), np.stack(reference_jobs)
    gap = a.mean(0) - b.mean(0)
    se2 = a.var(0, ddof=1) / len(a) + b.var(0, ddof=1) / len(b)
    z2 = np.where(gap == 0, 0.0, gap * gap / np.maximum(se2, 1e-30))
    return float(z2.mean())


def recon_gap(image, primal, gx, gy, iters: int) -> float:
    """The largest gap between a job's image and the float64 screened-
    Poisson solve of its own primal, Gx and Gy (reference/poisson.py, the
    same sweeps, uniform weights), over the solve's mean."""
    from .reference.poisson import solve

    want = solve(primal, gx, gy, iters)
    return float(np.abs(np.asarray(image, np.float64) - want).max() / abs(want.mean()))


def gpt_reference(ref, conf: dict, width: int, height: int, seed: int, device,
                  precision: str = "float64", spp: int | None = None,
                  job_spp: int | None = None, job_grads: bool = False) -> dict:
    """The reference path tracer's conf["reference"]["spp"] samples (or
    `spp`) of every pixel, cut into jobs of a GPT job's samples
    (conf["spp"], or `job_spp`): render's {"mean", "var", "spp"}, and of each job the
    primal_tiles of its film-binned image ("primal_jobs") and, with
    job_grads, the grad_tiles of its pixel differences ("grad_jobs": the
    control's gradients, I(q) - I(p) from the job's own pixel
    means)."""
    from .reference.render import render_jobs

    m = conf["method"]
    tiles, stride = conf["reference"]["tiles"], m.get("stride", 1)
    primal_jobs, grad_jobs = [], []

    def on_job(aligned, binned):
        primal_jobs.append(primal_tiles(binned.cpu().numpy(), width, height, tiles))
        if job_grads:
            grad_jobs.append(image_steps(aligned, width, height, tiles, stride))

    out = render_jobs(ref, width, height, spp or conf["reference"]["spp"],
                      job_spp or int(conf["spp"]),
                      m["max_depth"], m["rr_depth"], conf["film"]["filter"]["radius"],
                      seed ^ 0x5EED, device, on_job, precision)
    return dict(out, primal_jobs=primal_jobs, grad_jobs=grad_jobs)


def gpt_numbers(reference: dict, conf: dict, width: int, height: int, stats: list,
                recons: list) -> dict:
    """grad_chi2 and primal_chi2 of the films of `stats` (each job's of the
    window: "primal", "gx", "gy" [H, W, 3]) against gpt_reference's
    `reference`, and recon_gap, the largest over `recons` ([(image, stats)]
    of the checked jobs)."""
    tiles, stride = conf["reference"]["tiles"], conf["method"].get("stride", 1)
    grads = [grad_tiles(s["gx"], s["gy"], width, height, tiles, stride) for s in stats]
    primals = [primal_tiles(s["primal"], width, height, tiles) for s in stats]
    iters = conf["method"]["reconstruction_iter"]
    return {"grad_chi2": grad_chi2(grads, grad_expected(reference, width, height, tiles, stride)),
            "primal_chi2": primal_chi2(primals, reference["primal_jobs"]),
            "recon_gap": max(recon_gap(img, s["primal"], s["gx"], s["gy"], iters)
                             for img, s in recons)}
