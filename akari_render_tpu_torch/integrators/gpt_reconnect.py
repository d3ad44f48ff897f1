"""Reconnection shift mapping for gradient-domain PT (port of
akari_render_tpu/integrators/gpt_reconnect.py; reference pt.rs:328-900 and
gpt.rs:206-349).

The BASE path records its first reconnectible vertex V = x_k: the first
bounce where dist(x_{k-1}, x_k) >= min_dist and both endpoint roughnesses
>= min_roughness. A SHIFT path replays the same primary samples from the
offset pixel up to x'_{k-1} and reconnects to V deterministically, with the
jacobian of pt.rs:683-694 (the pdf ratios at both ends of the connection,
the cosine at V and the squared distances). A shift fails where it dies
early, finds an eligible pair of its own before k, violates the criteria
or is occluded from V; with no valid V it counts as a full PSS replay.

Lanes step together in an eager loop that stops once every lane is dead
(as trace_paths). Every query runs only on the lanes whose result is used:
a dead lane's ray gets tmax -1, so K1 skips it; the closures are evaluated
on the live lanes of a bounce, the connection's on the lanes that connect
(do_connect), V's on those lanes with a valid record;
the connection ray's any-hit query excludes x'_{k-1}'s and V's triangles
and runs where the connection is otherwise eligible. Other lanes get
zeros where the JAX package computes values it then discards.

The three shade calls (a bounce's shade with the sampled lobe's
roughness, the connection's f and pdf at x'_{k-1}, and V's at the
light's and the base path's directions) take the route that trace_paths
takes for these lanes (common.uses_fused_shade: a bake, NEE with a light,
RGB, no force_diffuse, the device's default): the same one for the base
path and its four shifts, so the jacobian's pdf ratios compare like with
like. On it each call is one launch of K9's roughness entry or of its
evaluation entry over the wavefront, masked by the lanes shaded, with no
host read (fused_shade.py; their plain versions on the CPU), each inside a
span shade.fused and counted in gpt_fused_shades. Elsewhere (the CPU's
default, a scene that does not bake) each call goes through the per-kind
dispatch, as in the JAX package, whose groups replay as CUDA graphs on the
card (shade_graphs.shade).

Rays go through Scene.intersect_alpha / occlude_alpha, as in the JAX
package (intersect / occlude on opaque scenes).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import stats
from ..core.math import RAY_TMAX, dot, face_forward, length, offset_ray_origin
from ..core.sampling import mis_weight
from ..lights import pdf_direct
from .common import PTSettings, _emission_at, nee_light_sample, uses_fused_shade
from .fused_shade import fused_eval, fused_shade
from .shade_graphs import shade


class ReconnectionRecord(NamedTuple):
    valid: torch.Tensor
    depth: torch.Tensor  # [N] int32: index k of V (>= 1)
    tri: torch.Tensor
    bary: torch.Tensor
    prev_pdf: torch.Tensor  # [N] base pdf of the x_{k-1} -> V direction
    wi: torch.Tensor  # [N, 3] base's sampled dir at V
    bsdf_pdf: torch.Tensor  # [N] base pdf of wi at V
    direct: torch.Tensor  # [N, 3] NEE li/pdf at V (0 if occluded/invalid)
    direct_wi: torch.Tensor
    direct_light_pdf: torch.Tensor
    indirect: torch.Tensor  # [N, 3] radiance after V at unit throughput
    cos_at_v: torch.Tensor  # [N] |n_V . (dir V->x_{k-1})|
    dist: torch.Tensor  # [N] |x_{k-1} - V|


_F, _B = torch.float32, torch.bool
_SHADE_SPEC = (("direct", (3,), _F), ("wi", (3,), _F), ("f", (3,), _F), ("pdf", (), _F),
               ("valid", (), _B), ("roughness", (), _F))


def _shade(closure, ex):
    """NEE evaluation, BSDF sample and roughness of one bounce."""
    f_l, pdf_l = closure.evaluate(ex["wo"], ex["ls_wi"])
    w = mis_weight(ex["ls_pdf"], pdf_l)
    out = {"direct": ex["ls_li"] * f_l * (w / torch.clamp(ex["ls_pdf"], min=1e-20))[..., None]}
    s = closure.sample(ex["wo"], ex["u_bsdf"][..., 0], ex["u_bsdf"][..., 1:])
    out.update(wi=s["wi"], f=s["f"], pdf=s["pdf"], valid=s["valid"])
    out["roughness"] = closure.roughness(ex["wo"], ex["u_bsdf"][..., 0])
    return out


def _shade_bounce(scene, fused: bool, si, extra: dict, lanes):
    """_shade's outputs at `lanes` (zeros elsewhere): K9's roughness entry
    on the fused route, else the per-kind dispatch."""
    if not fused:
        return shade(scene, si, extra, _shade, lanes, _SHADE_SPEC)
    with stats.span("shade.fused"):
        stats.counts["gpt_fused_shades"] += 1
        return fused_shade(scene.shade_bake, *si["frame"], si["ng"], *(extra[k] for k in (
            "wo", "ls_wi", "ls_li", "ls_pdf", "u_bsdf")), si["mat"], live=lanes, roughness=True)


def _bounce(scene, settings, st, depth: int, sampler, record_mode: bool,
            min_dist=0.03, min_rough=0.2, fused: bool = False):
    """One bounce shared by base/shift. Returns (st, sampler, pre) where
    `pre` carries the pre-continuation quantities the reconnection needs:
    si (this bounce's interaction = x at this index), wo, beta at the
    vertex, shading result, eligibility of the (prev, here) pair."""
    n = st["ray_o"].shape[0]
    dev = st["ray_o"].device
    zeros_n = torch.zeros((n,), device=dev)
    a = scene.arrays
    hit = scene.intersect_alpha(st["ray_o"], st["ray_d"], zeros_n,
                                torch.where(st["active"], RAY_TMAX, -1.0),
                                exclude0=st["exclude"])
    lane_hit = st["active"] & hit.valid
    si = scene.surface_interaction(hit.tri_id, hit.bary)
    wo = -st["ray_d"]

    # emission on hit (MIS, pt.rs:230-258)
    front = dot(si["ng"], st["ray_d"]) < 0.0
    is_light = lane_hit & (si["light_id"] >= 0) & front
    le = _emission_at(scene, si, wo, is_light)
    lpdf = pdf_direct(a.lights, si["light_id"], si["prim_pdf"], si["area"], si["ng"], si["p"],
                      st["ray_o"])
    w_mis = torch.ones((n,), device=dev) if depth == 0 else mis_weight(st["prev_bsdf_pdf"], lpdf)
    contrib = st["beta"] * le * w_mis[..., None]
    st["radiance"] = st["radiance"] + torch.where(is_light[..., None], contrib, 0.0)
    # depth-0 split (pt.rs:415-417): the camera vertex's own contributions
    # pair at weight 1/2 in the separate-weights gradient (gpt.rs:192-204)
    if depth == 0:
        st["radiance0"] = st["radiance0"] + torch.where(is_light[..., None], contrib, 0.0)
    if record_mode:
        rcontrib = st["rbeta"] * le * w_mis[..., None]
        st["rradiance"] = st["rradiance"] + torch.where(
            (is_light & st["rec_valid"])[..., None], rcontrib, 0.0)

    st["active"] = lane_hit
    beta_at_vertex = st["beta"]
    pair_dist = length(si["p"] - st["prev_p"])

    # NEE (pt.rs:470-513)
    sampler, u_light = sampler.next_3d()
    ls = nee_light_sample(scene, si, u_light, st["active"])
    light_valid = ls.valid & st["active"]

    sampler, u_bsdf = sampler.next_3d()
    extra = {"wo": wo, "u_bsdf": u_bsdf, "ls_wi": ls.wi, "ls_li": ls.li, "ls_pdf": ls.pdf}
    sh = _shade_bounce(scene, fused, si, extra, st["active"])

    occluded = scene.occlude_alpha(
        ls.shadow_ro, ls.wi, zeros_n, torch.where(light_valid, ls.shadow_dist, -1.0),
        exclude0=si["tri_id"].to(torch.int32), exclude1=ls.dest_tri,
    )
    direct_ok = light_valid & ~occluded
    direct = st["beta"] * sh["direct"]
    st["radiance"] = st["radiance"] + torch.where(direct_ok[..., None], direct, 0.0)
    if depth == 0:
        st["radiance0"] = st["radiance0"] + torch.where(direct_ok[..., None], direct, 0.0)
    if record_mode:
        st["rradiance"] = st["rradiance"] + torch.where(
            (direct_ok & st["rec_valid"])[..., None], st["rbeta"] * sh["direct"], 0.0)

    eligible = (st["active"] & (depth >= 1) & (pair_dist >= min_dist)
                & (st["prev_roughness"] >= min_rough) & (sh["roughness"] >= min_rough))
    pre = {"si": si, "wo": wo, "beta": beta_at_vertex, "sh": sh, "eligible": eligible,
           "pair_dist": pair_dist, "hit_valid": lane_hit, "ls": ls, "direct_ok": direct_ok,
           "prev_pdf": st["prev_bsdf_pdf"]}

    if record_mode:
        m = eligible & ~st["rec_valid"]
        m3 = m[..., None]
        st["rec_valid"] = st["rec_valid"] | m
        st["rec_depth"] = torch.where(m, depth, st["rec_depth"])
        st["rec_tri"] = torch.where(m, si["tri_id"].to(torch.int32), st["rec_tri"])
        st["rec_bary"] = torch.where(m3, hit.bary, st["rec_bary"])
        st["rec_prev_pdf"] = torch.where(m, st["prev_bsdf_pdf"], st["rec_prev_pdf"])
        st["rec_wi"] = torch.where(m3, sh["wi"], st["rec_wi"])
        st["rec_bsdf_pdf"] = torch.where(m, sh["pdf"], st["rec_bsdf_pdf"])
        st["rec_direct"] = torch.where(
            (m & direct_ok)[..., None], ls.li / torch.clamp(ls.pdf, min=1e-20)[..., None],
            torch.where(m3, 0.0, st["rec_direct"]))
        st["rec_direct_wi"] = torch.where(m3, ls.wi, st["rec_direct_wi"])
        st["rec_direct_light_pdf"] = torch.where(m, ls.pdf, st["rec_direct_light_pdf"])
        st["rec_cos"] = torch.where(m, torch.abs(dot(si["ng"], wo)), st["rec_cos"])
        st["rec_dist"] = torch.where(m, pair_dist, st["rec_dist"])
        st["rbeta"] = torch.where(m3, 1.0, st["rbeta"])
        st["rradiance"] = torch.where(m3, 0.0, st["rradiance"])
    else:
        first_el = eligible & (st["first_eligible"] < 0)
        st["first_eligible"] = torch.where(first_el, depth, st["first_eligible"])

    # continuation
    sample_ok = sh["valid"] & (sh["pdf"] > 0.0) & (torch.min(sh["f"], -1).values >= 0.0)
    st["active"] = st["active"] & sample_ok
    throughput = sh["f"] / torch.clamp(sh["pdf"], min=1e-20)[..., None]
    st["beta"] = st["beta"] * torch.where(st["active"][..., None], throughput, 1.0)
    if record_mode:
        just_rec = st["rec_valid"] & (st["rec_depth"] == depth)
        st["rbeta"] = st["rbeta"] * torch.where(
            (st["active"] & st["rec_valid"] & ~just_rec)[..., None], throughput, 1.0)

    sampler, u_rr = sampler.next_1d()
    if depth + 1 > settings.rr_depth:
        cont_prob = torch.clamp(torch.max(st["beta"], -1).values, 0.0, 1.0) * 0.95
    else:
        cont_prob = torch.ones((n,), device=dev)
    st["active"] = st["active"] & (u_rr < cont_prob)
    inv = torch.clamp(cont_prob, min=1e-20)[..., None]
    st["beta"] = st["beta"] / inv
    if record_mode:
        st["rbeta"] = st["rbeta"] / inv

    st["prev_bsdf_pdf"] = sh["pdf"]
    st["prev_p"] = si["p"]
    st["prev_roughness"] = sh["roughness"]
    st["ray_o"] = offset_ray_origin(si["p"], face_forward(si["ng"], sh["wi"]))
    st["ray_d"] = sh["wi"]
    st["exclude"] = si["tri_id"].to(torch.int32)
    return st, sampler, pre


def _init_state(n: int, record_mode: bool, device):
    def z(*shape, dtype=torch.float32):
        return torch.zeros((n,) + shape, dtype=dtype, device=device)

    def full(v, *shape, dtype=torch.float32):
        return torch.full((n,) + shape, v, dtype=dtype, device=device)

    st = {
        "exclude": full(-1, dtype=torch.int32),
        "radiance": z(3),
        "radiance0": z(3),
        "beta": full(1.0, 3),
        "active": full(True, dtype=torch.bool),
        "prev_bsdf_pdf": z(),
        "prev_p": full(1e10, 3),
        "prev_roughness": z(),
    }
    if record_mode:
        st.update(
            rec_valid=z(dtype=torch.bool), rec_depth=full(-1, dtype=torch.int32),
            rec_tri=full(-1, dtype=torch.int32), rec_bary=z(2), rec_prev_pdf=z(), rec_wi=z(3),
            rec_bsdf_pdf=z(), rec_direct=z(3), rec_direct_wi=z(3), rec_direct_light_pdf=z(),
            rec_cos=z(), rec_dist=z(), rbeta=full(1.0, 3), rradiance=z(3),
        )
    else:
        st.update(first_eligible=full(-1, dtype=torch.int32), connected=z(dtype=torch.bool))
    return st


def trace_base_record(scene, settings: PTSettings, ray_o, ray_d, sampler,
                      min_dist=0.03, min_rough=0.2):
    """Base path; returns ((radiance, radiance0), ReconnectionRecord,
    sampler), radiance0 the camera vertex's own contributions."""
    st = _init_state(ray_o.shape[0], True, ray_o.device)
    st["ray_o"], st["ray_d"] = ray_o, ray_d
    fused = uses_fused_shade(scene, settings, ray_o.device)
    depth = 0
    while depth < settings.max_depth and bool(torch.any(st["active"])):
        st, sampler, _ = _bounce(scene, settings, st, depth, sampler, True,
                                 min_dist=min_dist, min_rough=min_rough, fused=fused)
        depth += 1
    rec = ReconnectionRecord(
        valid=st["rec_valid"], depth=st["rec_depth"], tri=st["rec_tri"], bary=st["rec_bary"],
        prev_pdf=st["rec_prev_pdf"], wi=st["rec_wi"], bsdf_pdf=st["rec_bsdf_pdf"],
        direct=st["rec_direct"], direct_wi=st["rec_direct_wi"],
        direct_light_pdf=st["rec_direct_light_pdf"], indirect=st["rradiance"],
        cos_at_v=st["rec_cos"], dist=st["rec_dist"],
    )
    return (st["radiance"], st["radiance0"]), rec, sampler


def _eval_conn(closure, ex):
    f, pdf = closure.evaluate(ex["wo"], ex["wi"])
    return {"f": f, "pdf": pdf}


def _eval_v(closure, ex):
    fd, pd = closure.evaluate(ex["wo"], ex["dwi"])
    f2, pdf_y2 = closure.evaluate(ex["wo"], ex["wi"])
    return {"fd": fd, "pd": pd, "f2": f2, "pdf_y2": pdf_y2}


def _evaluate(scene, fused: bool, si, wo, wis, lanes):
    """The closure at si evaluated at wo and each direction of `wis` (one
    or two) on `lanes`, zeros elsewhere: [(f, pdf)], by K9's evaluation
    entry on the fused route, else by the per-kind dispatch (_eval_conn,
    _eval_v)."""
    if fused:
        with stats.span("shade.fused"):
            stats.counts["gpt_fused_shades"] += 1
            return fused_eval(scene.shade_bake, *si["frame"], si["ng"], wo, wis, si["mat"],
                              live=lanes)
    if len(wis) == 1:
        out = shade(scene, si, {"wo": wo, "wi": wis[0]}, _eval_conn, lanes,
                    (("f", (3,), _F), ("pdf", (), _F)))
        return [(out["f"], out["pdf"])]
    out = shade(scene, si, {"wo": wo, "dwi": wis[0], "wi": wis[1]}, _eval_v, lanes,
                (("fd", (3,), _F), ("pd", (), _F), ("f2", (3,), _F), ("pdf_y2", (), _F)))
    return [(out["fd"], out["pd"]), (out["f2"], out["pdf_y2"])]


def _pdf_ratio(py, px):
    return torch.where(px <= 0.0, torch.where(py <= 0.0, 1.0, 0.0),
                       py / torch.clamp(px, min=1e-20))


def trace_shift_reconnect(scene, settings: PTSettings, ray_o, ray_d, sampler,
                          rec: ReconnectionRecord, min_dist=0.03, min_rough=0.2):
    """Shifted path with reconnection; returns ((radiance0, rest),
    jacobian, success, sampler), the weighting of pt.rs:536-775: the
    connection's tail divides by the shifted path's pdfs (pdf_y1 at
    x'_{k-1}, pdf_y2 at V) and the jacobian carries the pdf ratios

        J = (pdf_y1/pdf_x1) * (pdf_y2/pdf_x2) * |cos'_V|/|cos_V| * d^2/d'^2

    `rest` has no jacobian applied (gpt.py's pairing applies it,
    gpt.rs:318-331); success=False lanes contribute nothing to the pair."""
    n = ray_o.shape[0]
    dev = ray_o.device
    zeros_n = torch.zeros((n,), device=dev)
    a = scene.arrays
    st = _init_state(n, False, dev)
    st["ray_o"], st["ray_d"] = ray_o, ray_d
    st["conn"] = torch.zeros((n, 3), device=dev)
    jacobian = torch.zeros((n,), device=dev)
    success = torch.zeros((n,), dtype=torch.bool, device=dev)
    v_si = scene.surface_interaction(rec.tri, rec.bary)
    fused = uses_fused_shade(scene, settings, dev)

    depth = 0
    while depth < settings.max_depth and bool(torch.any(st["active"])):
        st, sampler, pre = _bounce(scene, settings, st, depth, sampler, False,
                                   min_dist=min_dist, min_rough=min_rough, fused=fused)
        si = pre["si"]
        do_connect = (rec.valid & pre["hit_valid"] & ~st["connected"] & (rec.depth - 1 == depth)
                      & ((st["first_eligible"] < 0) | (st["first_eligible"] >= rec.depth)))
        xp = si["p"]
        to_v = v_si["p"] - xp
        dist_p = length(to_v)
        wi_p = to_v / torch.clamp(dist_p, min=1e-20)[..., None]
        ok = do_connect & (dist_p >= min_dist) & (pre["sh"]["roughness"] >= min_rough)
        ro = offset_ray_origin(xp, face_forward(si["ng"], wi_p))
        occ = scene.occlude_alpha(ro, wi_p, zeros_n,
                                  torch.where(ok, dist_p * (1.0 - 1e-3), -1.0),
                                  exclude0=si["tri_id"].to(torch.int32), exclude1=rec.tri)
        ok = ok & ~occ

        # f1, pdf_y1 at x'_{k-1} (the shifted connection segment)
        [(f1, pdf_y1)] = _evaluate(scene, fused, si, pre["wo"], (wi_p,), do_connect)

        # V-side with wo'_V = -wi': NEE re-eval (fd, pd) and the base exit
        # direction re-eval (f2, pdf_y2)
        wo_v = -wi_p
        (fd, pd), (f2, pdf_y2) = _evaluate(scene, fused, v_si, wo_v, (rec.direct_wi, rec.wi),
                                           do_connect & rec.valid)
        front_v = (dot(v_si["ng"], wi_p) < 0.0) & (v_si["light_id"] >= 0)
        le_v = _emission_at(scene, v_si, wo_v, do_connect & front_v)
        lpdf_v = pdf_direct(a.lights, v_si["light_id"], v_si["prim_pdf"], v_si["area"],
                            v_si["ng"], v_si["p"], xp)
        # MIS against NEE from the shifted prefix vertex (pt.rs:723-726)
        w_le = mis_weight(pdf_y1, lpdf_v)
        le_term = torch.where(front_v[..., None], le_v * w_le[..., None], 0.0)
        w_nee = mis_weight(rec.direct_light_pdf, pd)
        nee_term = fd * rec.direct * w_nee[..., None]
        ind_term = torch.where(
            (pdf_y2 > 0.0)[..., None],
            f2 / torch.clamp(pdf_y2, min=1e-20)[..., None] * rec.indirect, 0.0)
        tail = le_term + nee_term + ind_term

        # RR continue probability as if the shifted path continued through
        # the connection (pt.rs:737-741)
        beta_conn = pre["beta"] * (f1 / torch.clamp(pdf_y1, min=1e-20)[..., None])
        cont_prob = torch.where(
            rec.depth > settings.rr_depth,
            torch.clamp(torch.max(beta_conn, -1).values, 0.0, 1.0) * 0.95, 1.0)
        conn = beta_conn * tail / torch.clamp(cont_prob, min=1e-20)[..., None]

        # jacobian with pdf ratios (pt.rs:683-694, 762-765)
        pdf_ratio = _pdf_ratio(pdf_y1, rec.prev_pdf) * _pdf_ratio(pdf_y2, rec.bsdf_pdf)
        cos_p = torch.abs(dot(v_si["ng"], wo_v))
        J = (pdf_ratio * (cos_p / torch.clamp(rec.cos_at_v, min=1e-20))
             * (rec.dist ** 2 / torch.clamp(dist_p ** 2, min=1e-20)))
        J = torch.where(torch.isfinite(J), J, 0.0)
        ok = ok & (J > 0.0)

        st["conn"] = st["conn"] + torch.where(ok[..., None], conn, 0.0)
        jacobian = torch.where(ok, J, jacobian)
        success = success | ok
        st["connected"] = st["connected"] | ok
        # connecting lanes (even failed ones at their index) stop replaying
        st["active"] = st["active"] & ~do_connect
        depth += 1

    # No-vertex fallback (pt.rs end of trace): with no valid reconnection
    # vertex the shift ran as a full PSS replay and counts as a successful
    # jacobian-1 shift unless its own replay found an eligible pair
    fallback_ok = ~rec.valid & (st["first_eligible"] < 0)
    success = success | fallback_ok
    jacobian = torch.where(fallback_ok, 1.0, jacobian)
    rest = st["radiance"] - st["radiance0"] + st["conn"]
    return (st["radiance0"], rest), jacobian, success, sampler
