"""Shared path-tracing core (port of akari_render_tpu/integrators/common.py:
trace_paths, with nee_light_sample, _emission_at and dispatch_shade).

A batch of N lanes steps through the bounce loop together; an eager
Python loop takes the place of lax.while_loop and stops once every lane
has died. Per-bounce sample consumption is the JAX package's (camera 2D;
per bounce: 3D light, 3D BSDF, 1D RR), so with the bit-exact sampler each
lane makes the same path decisions.

Shading groups lanes by shader kind (torch.nonzero per kind, gather,
evaluate, scatter back) in place of the sorted-chunk lax.switch: each lane
still evaluates exactly its own kind's closure. Only live lanes are
shaded; the JAX package shades dead lanes too and discards the results.
Where a scene's kinds all bake into the reduced principled closure
(Scene.shade_bake), with NEE and a light, force_diffuse off and RGB
transport, the wavefront goes through K9 (fused_shade.py) in one launch per
bounce instead, masked by the live lanes, with no host read: by default on
the card (AKR_PALLAS_SHADE=0 keeps the dispatch there), opt-in with
AKR_PALLAS_SHADE (not "0") on the CPU, as in the JAX package
(uses_fused_shade, fused_shade.fused_shade_enabled).

trace_paths returns (radiance, aux, sampler) and takes the per-depth taps
`radiance_cb`, as in the JAX package. The aux is recorded at the first hit:
the albedo of the closure there (the per-kind closures' `albedo`, or K9's
albedo output on the fused route; evaluated at the first bounce only, the
only one that records it), the geometric normal and the hit distance.

Partial tracing (the split-compacted pass, pt.py): depth_end stops the
bounce loop early, finalize=False returns the raw state dict (sampler
included), and resume_state with depth_beg continues it; any row subset
of a state (take_rows) resumes bit-exactly.

Rays go through Scene.intersect_alpha / occlude_alpha, which are
intersect / occlude on opaque scenes: one closest-hit traversal a bounce,
and each NEE shadow ray as its own occlusion query. (The JAX package's
fused shadow rays, which trace with the next bounce's rays, are not
ported: on the H100 they never beat this loop.)

The loop is written as a generator, trace_steps, that yields a request
wherever it needs the host: each traversal call (a Traverse, the Scene
method to call by name with its arguments) and each read of the loop
condition (a LiveRead, with the loop's state at that point, which
trace_paths can resume). trace_paths answers them at once (run_eagerly,
answer); piecewise.py runs the work between two requests as a CUDA graph
and answers them between replays.

Spans and counters (stats.py): each bounce is a `bounce` span (the last
intersect too) holding bounce.surface, .emission, .nee, .shade, .shadow
and .continue. bounce.shade wraps either route: on the dispatch each kind's
group is a shade.<kind> span and counts in dispatch_groups; a bounce shaded
by K9 counts in fused_shades. traversal.intersect and traversal.occlude
wrap the calls here (answer), not Scene's methods, so a benchmark's own
range inside them stays the innermost one. The host reads are
read.any_live (the loop condition) and, on the dispatch, read.kind_rows
(each kind's nonzero); K9 reads nothing.

Spectral transport (`spectral`: the lanes' SampledWavelengths, four hero
wavelengths a lane): the path decisions (BSDF sampling, RR, MIS) run in
RGB exactly as in RGB mode, while a spectral throughput beside the RGB one
multiplies rgb2spec-uplifted factors (core/spectral.py): the emission
through the normalised D65, NEE's BSDF factor and light radiance uplifted
apart, the sampled f. A dispersive glass (a Cauchy term) evaluates its IOR
at the hero wavelength, so a lane that first hits one terminates its
secondary wavelengths: their throughput goes to zero and the hero's is
weighted by their count, once. The clamp acts on the spectral radiance,
and the CIE sensor turns it into linear sRGB. As in the JAX package,
spectral mode never shades through K9 and refuses per-depth taps.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple

import torch

from .. import stats
from ..core.math import RAY_TMAX, dot, face_forward, offset_ray_origin
from ..core.sampling import INV_PI, mis_weight
from ..core.spectral import (
    device_table, eval_reflectance, illuminant_d65, spectral_to_rgb, uplift_unbounded,
)
from ..lights import finish_light_sample, light_point_attrs, pdf_direct, sample_light_point_ex
from ..scene import Scene
from ..svm.surface import DiffuseBsdf, SurfaceClosure
from .fused_shade import fused_shade, fused_shade_enabled

_shade_spans: list[str] = []  # "shade.<k>", the span of kind k's group
_F, _B = torch.float32, torch.bool


def _shade_span(k: int) -> str:
    while len(_shade_spans) <= k:
        _shade_spans.append(f"shade.{len(_shade_spans)}")
    return _shade_spans[k]


def kind_rows(mask):
    """The ids of the lanes where `mask` is True (a host read)."""
    with stats.read("kind_rows"):
        return torch.nonzero(mask).squeeze(1)


def take_rows(state: dict, ids) -> dict:
    """The rows ids of a trace_paths state (every per-lane tensor and the
    sampler's lanes)."""
    return {k: v.take(ids) if k == "sampler" else v[ids] for k, v in state.items()}


class Traverse(NamedTuple):
    """A request of trace_steps: call the Scene method `method` (looked up
    on the scene at the call) on `args` and `kw`, inside the span `span`."""

    span: str
    method: str
    args: tuple
    kw: dict


class LiveRead(NamedTuple):
    """A request of trace_steps: whether any lane of `active` lives (a host
    read). `state` is the loop's state there, the sampler under "sampler":
    trace_paths resumes it (resume_state) where the answer is False."""

    active: torch.Tensor
    state: dict


def answer(scene: Scene, req):
    """The host's answer to a request of trace_steps, made now."""
    if isinstance(req, LiveRead):
        with stats.read("any_live"):
            return bool(torch.any(req.active))
    with stats.span(req.span):
        return getattr(scene, req.method)(*req.args, **req.kw)


def run_eagerly(scene: Scene, steps):
    """Run a generator of requests (trace_steps, or one that yields from
    it) to its end, answering each request as it comes; its return value."""
    reply = None
    while True:
        try:
            req = steps.send(reply)
        except StopIteration as stop:
            return stop.value
        reply = answer(scene, req)
        del req  # its tensors live no longer than the call they are made for


@dataclass
class PTSettings:
    max_depth: int = 7
    rr_depth: int = 5
    use_nee: bool = True
    indirect_only: bool = False
    force_diffuse: bool = False
    clamp_indirect: float = 1000.0
    color: str = "rgb"  # "rgb" | "spectral" (hero-wavelength transport)


def dispatch_shade(scene: Scene, si, extra: dict, fn, lanes, spec, force_diffuse: bool = False):
    """fn(closure, extra_rows) -> dict of per-lane tensors, evaluated for the
    lanes where `lanes` is True, grouped by shader kind. Other lanes get
    zeros, and so does every output that `spec` names ((key, trailing
    shape, dtype) rows) when no lane produced it. With "lambdas" in extra
    (spectral mode), each group's closures take their lanes' hero
    wavelengths."""
    n = lanes.shape[0]
    out: dict = {}

    def scatter(rows, res):
        for key, v in res.items():
            if key not in out:
                out[key] = torch.zeros((n,) + v.shape[1:], dtype=v.dtype, device=v.device)
            out[key][rows] = v

    if force_diffuse:  # every material becomes Lambert 0.8 (pt.rs:268-280)
        rows = kind_rows(lanes)
        stats.counts["dispatch_groups"] += int(rows.numel() > 0)
        with stats.span("shade.diffuse"):
            refl = torch.full((rows.shape[0], 3), 0.8 * INV_PI, device=lanes.device)
            frame = tuple(f[rows] for f in si["frame"])
            closure = SurfaceClosure(DiffuseBsdf(refl), frame, si["ng"][rows])
            scatter(rows, fn(closure, {k: v[rows] for k, v in extra.items()}))
    else:
        for k in range(len(scene.kinds)):
            rows = kind_rows(lanes & (si["kind"] == k))
            if rows.numel() == 0:
                continue
            stats.counts["dispatch_groups"] += 1
            with stats.span(_shade_span(k)):
                lam0 = extra["lambdas"][rows, 0] if "lambdas" in extra else None
                closure = scene.kind_closure(si, k, rows, lambda0=lam0)
                scatter(rows, fn(closure, {key: v[rows] for key, v in extra.items()}))
    for key, shape, dtype in spec:
        if key not in out:
            out[key] = torch.zeros((n,) + shape, dtype=dtype, device=lanes.device)
    return out


def uses_fused_shade(scene: Scene, settings: PTSettings, device=None) -> bool:
    """Whether trace_paths shades lanes on `device` (the scene's by
    default) through K9: the switch for that device
    (fused_shade.fused_shade_enabled: the default on the card, opt-in on
    the CPU), then the JAX package's rule: a bake, NEE with a light, no
    force_diffuse, RGB transport."""
    device = scene.device if device is None else device
    return (fused_shade_enabled(device) and settings.color != "spectral" and settings.use_nee
            and scene.arrays.lights.num_lights > 0 and not settings.force_diffuse
            and scene.shade_bake is not None)


def _fused_shade_live(bake, si, extra: dict, lanes):
    """fused_shade (K9) over the lanes where `lanes` is True; other lanes
    get zeros, as from dispatch_shade. On the card it is one launch over
    the wavefront's rows as they lie (no compaction, no host read)."""
    return fused_shade(bake, *si["frame"], si["ng"], *(extra[k] for k in (
        "wo", "ls_wi", "ls_li", "ls_pdf", "u_bsdf")), si["mat"], live=lanes)


def _emission_at(scene: Scene, si, wo, lanes):
    """Emission of the interaction toward wo: a gather of the constant
    per-material table when every emission is constant, else each kind's
    closure (lanes outside `lanes` get zeros)."""
    ce = scene.arrays.const_emission
    if ce is not None:
        return ce[si["mat"].long()]
    le = torch.zeros_like(wo)
    for k in range(len(scene.kinds)):
        rows = kind_rows(lanes & (si["kind"] == k))
        if rows.numel():
            le[rows] = scene.kind_closure(si, k, rows).emission(wo[rows])
    return le


def nee_light_sample(scene: Scene, si, u_light, lanes):
    """NEE front half: sample a light point and its radiance toward si."""
    a = scene.arrays
    _light, lc_pdf, ltri, lprim_pdf, lbary, lslot = sample_light_point_ex(
        a.lights, u_light[..., 0], u_light[..., 1:]
    )
    if a.lights.attr is not None and a.const_emission is not None:
        # compact fetch: p/ng/area/mat from the [S, 14] light table
        lp, lng, larea, lmat = light_point_attrs(a.lights, lslot, lbary)
        ls = finish_light_sample(lc_pdf, lprim_pdf, ltri, lp, lng, larea, si["p"], si["ng"])
        l_emission = a.const_emission[lmat.long()]
    else:
        lsi = scene.surface_interaction(ltri, lbary)
        lng = lsi["ng"]
        ls = finish_light_sample(lc_pdf, lprim_pdf, ltri, lsi["p"], lng, lsi["area"], si["p"], si["ng"])
        l_emission = _emission_at(scene, lsi, -ls.wi, lanes)
    front_l = dot(ls.wi, lng) < 0.0
    return ls._replace(li=torch.where(front_l[..., None], l_emission, 0.0))


def trace_paths(scene: Scene, settings: PTSettings, ray_o, ray_d, sampler,
                radiance_cb: Callable | None = None, depth_end: int | None = None,
                resume_state: dict | None = None, depth_beg: int = 0, finalize: bool = True,
                spectral=None):
    """Trace one bounce-limited path per lane: returns (radiance [N, 3],
    aux, sampler) with aux = dict(albedo [N, 3], normal [N, 3], first_t
    [N]) of the first hit (zeros and RAY_TMAX where the camera ray missed).

    radiance_cb: optional hook(depth, kind, contribution [N, 3], mask [N])
    called with kind "emission" at every depth (0 to max_depth) and "nee"
    at every bounce's shadow ray (depth + 1), as in the JAX package. With
    it every bounce runs, as the JAX package's unrolled loop does, even
    after every lane has died; without it the loop stops there.

    depth_end bounds the bounce loop below max_depth; with finalize=False
    the raw state dict (the sampler under "sampler") is returned instead,
    before the last intersect and the clamp. resume_state and depth_beg
    continue such a state (ray_o, ray_d and sampler are then ignored).

    spectral: the lanes' SampledWavelengths (lambdas, pdf [N, W]) for
    spectral transport (the module's docstring); the radiance returned is
    then the sensor's linear sRGB."""
    return run_eagerly(scene, trace_steps(scene, settings, ray_o, ray_d, sampler, radiance_cb,
                                          depth_end, resume_state, depth_beg, finalize, spectral))


def trace_steps(scene: Scene, settings: PTSettings, ray_o, ray_d, sampler,
                radiance_cb: Callable | None = None, depth_end: int | None = None,
                resume_state: dict | None = None, depth_beg: int = 0, finalize: bool = True,
                spectral=None):
    """trace_paths as a generator: it yields a Traverse at every traversal
    call and a LiveRead at every test of the loop condition, takes the
    answer back by send(), and returns what trace_paths returns."""
    a = scene.arrays
    if spectral is not None and radiance_cb is not None:
        raise NotImplementedError("spectral transport with per-depth taps")
    if spectral is not None:
        lam = spectral.lambdas
        n_w = lam.shape[-1]
        up_table = device_table(lam.device)  # raises if the table cannot be made
        d65_at_lam = illuminant_d65(lam)

        def up(rgb, lambdas):
            """An RGB factor -> its spectrum at the lanes' wavelengths."""
            c, sc = uplift_unbounded(up_table, rgb)
            return eval_reflectance(c, lambdas) * sc[..., None]

        dispersion = scene.has_dispersion
    if resume_state is not None:
        st = dict(resume_state)
        sampler = st.pop("sampler")
    else:
        n = ray_o.shape[0]
        dev = ray_o.device
        st = {
            "ray_o": ray_o,
            "ray_d": ray_d,
            "exclude": torch.full((n,), -1, dtype=torch.int32, device=dev),
            "radiance": torch.zeros((n, 3), device=dev),
            "beta": torch.ones((n, 3), device=dev),
            "active": torch.ones((n,), dtype=torch.bool, device=dev),
            "prev_bsdf_pdf": torch.zeros((n,), device=dev),
            "base_replay": torch.zeros((n, 3), device=dev),
            "first_albedo": torch.zeros((n, 3), device=dev),
            "first_normal": torch.zeros((n, 3), device=dev),
            "first_t": torch.full((n,), RAY_TMAX, device=dev),
        }
        if spectral is not None:
            st.update(radiance_s=torch.zeros((n, n_w), device=dev),
                      beta_s=torch.ones((n, n_w), device=dev),
                      base_replay_s=torch.zeros((n, n_w), device=dev))
            if dispersion:  # lanes whose secondary wavelengths have terminated
                st["sec_dead"] = torch.zeros((n,), dtype=torch.bool, device=dev)
    n = st["ray_o"].shape[0]
    dev = st["ray_o"].device
    zeros_n = torch.zeros((n,), device=dev)
    nee = settings.use_nee and a.lights.num_lights > 0
    fused = spectral is None and uses_fused_shade(scene, settings, dev)
    # the dispatch's outputs that the loop reads, zeros where no lane is live
    shade_spec = [("wi", (3,), _F), ("f", (3,), _F), ("pdf", (), _F), ("valid", (), _B)]
    if nee:
        shade_spec.append(("direct", (3,), _F))
    if spectral is not None:
        shade_spec.append(("f_s", (n_w,), _F))
        if nee:
            shade_spec.append(("direct_s", (n_w,), _F))
        if dispersion:
            shade_spec.append(("disp", (), _B))

    def intersect_request():
        return Traverse("traversal.intersect", "intersect_alpha",
                        (st["ray_o"], st["ray_d"], zeros_n,
                         torch.where(st["active"], RAY_TMAX, -1.0)), {"exclude0": st["exclude"]})

    def add_emission(depth: int, si, lane_hit, wo):
        """Surface-light hit with MIS weighting (pt.rs:230-258)."""
        front = dot(si["ng"], st["ray_d"]) < 0.0
        ok = lane_hit & (si["light_id"] >= 0) & front
        le = _emission_at(scene, si, wo, ok)
        if settings.use_nee:
            lpdf = pdf_direct(
                a.lights, si["light_id"], si["prim_pdf"], si["area"], si["ng"], si["p"], st["ray_o"]
            )
            w = torch.ones((n,), device=dev) if depth == 0 else mis_weight(st["prev_bsdf_pdf"], lpdf)
        else:
            w = torch.ones((n,), device=dev)
        if settings.indirect_only and depth <= 1:
            w = torch.zeros_like(w)
        contrib = st["beta"] * le * w[..., None]
        st["radiance"] = st["radiance"] + torch.where(ok[..., None], contrib, 0.0)
        if spectral is not None:  # emission uplifts through the D65 white
            contrib_s = st["beta_s"] * (up(le, lam) * d65_at_lam) * w[..., None]
            st["radiance_s"] = st["radiance_s"] + torch.where(ok[..., None], contrib_s, 0.0)
        if radiance_cb is not None:
            radiance_cb(depth, "emission", contrib, ok)

    def record_first_hit(hit, si, lane_hit):
        st["first_normal"] = torch.where(lane_hit[..., None], si["ng"], st["first_normal"])
        st["first_t"] = torch.where(lane_hit, hit.t, st["first_t"])

    def shade(closure, ex, albedo=False):
        out = {}
        if "ls_wi" in ex:
            f_l, pdf_l = closure.evaluate(ex["wo"], ex["ls_wi"])
            w = mis_weight(ex["ls_pdf"], pdf_l)
            wp = (w / torch.clamp(ex["ls_pdf"], min=1e-20))[..., None]
            out["direct"] = ex["ls_li"] * f_l * wp
            if "lambdas" in ex:  # the BSDF factor and the light's radiance uplift apart
                lams = ex["lambdas"]
                out["direct_s"] = up(f_l, lams) * up(ex["ls_li"], lams) * illuminant_d65(lams) * wp
        out.update(closure.sample(ex["wo"], ex["u_bsdf"][..., 0], ex["u_bsdf"][..., 1:]))
        if "lambdas" in ex:
            out["f_s"] = up(out["f"], ex["lambdas"])
            if dispersion:  # the kind's static flag, a column a lane
                out["disp"] = torch.full(ex["wo"].shape[:-1], closure.dispersive,
                                         dtype=torch.bool, device=ex["wo"].device)
        if albedo:  # the first bounce records it (aux)
            out["albedo"] = closure.albedo(ex["wo"])
        return out

    d_end = settings.max_depth if depth_end is None else min(depth_end, settings.max_depth)
    depth = depth_beg
    while depth < d_end:
        if radiance_cb is None and not (yield LiveRead(st["active"], {**st, "sampler": sampler})):
            break
        with stats.span("bounce"):
            stats.counts["bounces"] += 1
            hit = yield intersect_request()
            lane_hit = st["active"] & hit.valid
            st["active"] = lane_hit
            with stats.span("bounce.surface"):
                si = scene.surface_interaction(hit.tri_id, hit.bary)
            wo = -st["ray_d"]
            if depth == 0:
                record_first_hit(hit, si, lane_hit)
            with stats.span("bounce.emission"):
                add_emission(depth, si, lane_hit, wo)
            if depth == 0:
                st["base_replay"] = st["radiance"]
                if spectral is not None:
                    st["base_replay_s"] = st["radiance_s"]
            cur_depth = depth + 1

            sampler, u_light = sampler.next_3d()
            ls = None
            light_valid = torch.zeros((n,), dtype=torch.bool, device=dev)
            if nee:
                with stats.span("bounce.nee"):
                    ls = nee_light_sample(scene, si, u_light, st["active"])
                    light_valid = ls.valid & st["active"]
                    if settings.indirect_only and cur_depth <= 1:
                        light_valid = torch.zeros_like(light_valid)

            sampler, u_bsdf = sampler.next_3d()
            extra = {"wo": wo, "u_bsdf": u_bsdf}
            if ls is not None:
                extra.update(ls_wi=ls.wi, ls_li=ls.li, ls_pdf=ls.pdf)
            if spectral is not None:
                extra["lambdas"] = lam
            with stats.span("bounce.shade"):
                if fused:  # fused implies NEE, so ls is set
                    stats.counts["fused_shades"] += 1
                    sh = _fused_shade_live(scene.shade_bake, si, extra, st["active"])
                else:
                    sh = dispatch_shade(
                        scene, si, extra, partial(shade, albedo=depth == 0), st["active"],
                        shade_spec + [("albedo", (3,), _F)] if depth == 0 else shade_spec,
                        settings.force_diffuse)
            if spectral is not None and dispersion:
                # hero-wavelength dispersion: a lane that newly meets a
                # dispersive closure (its IOR taken at lambda0) terminates its
                # secondary wavelengths and weights the hero by their count, once
                hero_w = torch.zeros((1, n_w), device=dev)
                hero_w[0, 0] = float(n_w)
                mult = torch.where((sh["disp"] & ~st["sec_dead"])[..., None], hero_w, 1.0)
                sh["f_s"] = sh["f_s"] * mult
                if "direct_s" in sh:
                    sh["direct_s"] = sh["direct_s"] * mult
                st["sec_dead"] = st["sec_dead"] | sh["disp"]
            if depth == 0:
                st["first_albedo"] = torch.where(lane_hit[..., None], sh["albedo"],
                                                 st["first_albedo"])

            if ls is not None:
                with stats.span("bounce.shadow"):
                    occluded = yield Traverse(
                        "traversal.occlude", "occlude_alpha",
                        (ls.shadow_ro, ls.wi, zeros_n,
                         torch.where(light_valid, ls.shadow_dist, -1.0)),
                        {"exclude0": si["tri_id"].to(torch.int32), "exclude1": ls.dest_tri})
                    direct_ok = light_valid & ~occluded
                    contrib = st["beta"] * sh["direct"]
                    st["radiance"] = st["radiance"] + torch.where(direct_ok[..., None], contrib,
                                                                  0.0)
                    if spectral is not None:
                        st["radiance_s"] = st["radiance_s"] + torch.where(
                            direct_ok[..., None], st["beta_s"] * sh["direct_s"], 0.0)
                    if radiance_cb is not None:
                        radiance_cb(cur_depth, "nee", contrib, direct_ok)

            # continue the path (pt.rs:778-866)
            with stats.span("bounce.continue"):
                sample_ok = (sh["valid"] & (sh["pdf"] > 0.0)
                             & (torch.min(sh["f"], -1).values >= 0.0))
                st["active"] = st["active"] & sample_ok
                st["beta"] = st["beta"] * torch.where(
                    st["active"][..., None], sh["f"] / torch.clamp(sh["pdf"], min=1e-20)[..., None],
                    1.0)
                if spectral is not None:
                    st["beta_s"] = st["beta_s"] * torch.where(
                        st["active"][..., None],
                        sh["f_s"] / torch.clamp(sh["pdf"], min=1e-20)[..., None], 1.0)
                # russian roulette (pt.rs:210-224, 843-850)
                sampler, u_rr = sampler.next_1d()
                if cur_depth > settings.rr_depth:
                    cont_prob = torch.clamp(torch.max(st["beta"], -1).values, 0.0, 1.0) * 0.95
                else:
                    cont_prob = torch.ones((n,), device=dev)
                st["active"] = st["active"] & (u_rr < cont_prob)
                st["beta"] = st["beta"] / torch.clamp(cont_prob, min=1e-20)[..., None]
                if spectral is not None:
                    st["beta_s"] = st["beta_s"] / torch.clamp(cont_prob, min=1e-20)[..., None]
                st["prev_bsdf_pdf"] = sh["pdf"]
                st["ray_o"] = offset_ray_origin(si["p"], face_forward(si["ng"], sh["wi"]))
                st["ray_d"] = sh["wi"]
                st["exclude"] = si["tri_id"].to(torch.int32)
        depth += 1
    if not finalize:
        return {**st, "sampler": sampler}

    # last iteration: intersect plus surface emission only (depth == max_depth)
    with stats.span("bounce"):
        hit = yield intersect_request()
        lane_hit = st["active"] & hit.valid
        with stats.span("bounce.surface"):
            si = scene.surface_interaction(hit.tri_id, hit.bary)
        if settings.max_depth == 0:
            record_first_hit(hit, si, lane_hit)
        with stats.span("bounce.emission"):
            add_emission(settings.max_depth, si, lane_hit, -st["ray_d"])

    if spectral is not None:  # the clamp acts on the spectrum, then the sensor
        radiance = spectral_to_rgb(
            clamp_radiance(settings, st["radiance_s"], st["base_replay_s"]), lam, spectral.pdf)
    else:
        radiance = clamp_radiance(settings, st["radiance"], st["base_replay"])
    aux = {"albedo": st["first_albedo"], "normal": st["first_normal"], "first_t": st["first_t"]}
    return radiance, aux, sampler


def clamp_radiance(settings: PTSettings, radiance, base_replay):
    """The path-end clamp: the indirect part (all but the emission the
    camera ray saw) at most clamp_indirect."""
    if settings.clamp_indirect > 0.0:
        indirect = torch.clamp(radiance - base_replay, max=settings.clamp_indirect)
        radiance = base_replay + indirect
    return radiance
