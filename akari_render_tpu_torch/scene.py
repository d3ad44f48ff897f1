"""Scene assembly: scenegraph JSON -> device-resident tensors (port of
akari_render_tpu/scene.py).

load_scene flattens the geometry, compiles the shader graphs into kinds
plus per-kind constant matrices, finds the emissive triangles and their
power, builds the light tables and the camera, all on the host in numpy,
then moves every array to `device` once.

Geometry takes one of the JAX package's tiers:
- flat (fewer than BVH_MIN_TRIS triangles, nothing instanced): every ray
  against every triangle through K1 (accel/intersect.py);
- cluster (BVH_MIN_TRIS or more, or AKR_FORCE_BVH): BVH-ordered clusters
  traversed by the pair sweep (accel/pairs.py, K2-K4; with
  AKR_PAIRS_STATIC=0 its legacy windowed walk, K2, K5 and K4) or, with
  AKR_WIDE=1, by the wide-BVH walk (accel/wide.py, K7);
- instanced: geometry referenced by several non-emissive instances stays
  in local space (accel/instanced.py); the flat clusters (if any) and
  every instance's clusters form one unified candidate list for the pair
  sweep. A flat part below the cluster tier goes through K1 and its hit is
  min-combined with the sweep's, as on the TPU.
When every kind reduces to the diffuse + metal + specular principled
closure with constant inputs, load_scene also bakes the per-material table
the fused tiers read (Scene.shade_bake, svm/reduced.py).

Alpha: an image base color whose texels are not all opaque makes the
scene `has_alpha`. Then intersect_alpha restarts a ray past each candidate
whose alpha rejects it (the commit decision hashes the triangle id and the
barycentrics' bits, as the JAX package does, so it is deterministic), at
most MAX_ALPHA_RESTARTS times, and occlude_alpha stages an any hit before
that chain. Opaque scenes take intersect and occlude unchanged. Neither
fused tier takes an alpha scene.

Where the JAX package fetches attributes or shader constants with one-hot
MXU matmuls, the port gathers rows; the values are the same.
"""
from __future__ import annotations

import io
import os
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from . import stats
from .accel.cluster import build_clusters
from .accel.flatten import TriangleSoup, flatten_scene, local_mesh_arrays
from .accel.instanced import (
    apply_3x3, apply_affine, apply_linear, build_instanced, build_unified_clusters,
)
from .accel.intersect import FlatTiles, flat_tiles, intersect_tris
from .accel.pairs import intersect_pairs, static_walk_enabled
from .accel.trace import Hit
from .accel.wide import attach_wide, intersect_wide
from .camera import PerspectiveCamera, camera_from_scenegraph
from .core.lds import _hash
from .core.math import RAY_TMAX, Frame, normalize, orthonormal_basis
from .core.pcg import MASK32
from .lights import LightArrays
from .native import build_bvh_order
from .scenegraph.model import SceneGraph, load_scene_json, load_transform
from .svm.compiler import CompiledKind, CompilerDriver, _image_key
from .svm.eval import (
    EvalContext, check_kind, dispatch_alpha, dispatch_closure, kind_is_dispersive,
)
from .svm.precompute import get_table
from .svm.reduced import bake_shading
from .svm.surface import frame_from_n_t
from .svm.texture import TextureAtlas

# the JAX package's cluster-tier threshold (Scene.BVH_MIN_TRIS)
BVH_MIN_TRIS = 32768
# AKR_WIDE's default: the pair sweep stays the cluster tier's traversal
# unless the caller asks for the wide walk
_WIDE_DEFAULT = "0"


def _use_wide(cl) -> bool:
    """Route a cluster traversal through the wide-BVH walk (accel/wide.py):
    when the node table is attached and AKR_WIDE (read at every call) is
    not "0"."""
    return cl.wide is not None and os.environ.get("AKR_WIDE", _WIDE_DEFAULT) != "0"


def _cluster_trace(cl, o, d, tmin, tmax, exclude0=None, exclude1=None, exclude2=None,
                   any_hit=False, any_hit_mask=None):
    """One cluster-tier traversal: the wide walk under AKR_WIDE=1, else the
    pair sweep. any_hit_mask (per-lane any hit inside a closest-hit call)
    is the pair sweep's alone and forces it."""
    if any_hit_mask is None and _use_wide(cl):
        return intersect_wide(cl, o, d, tmin, tmax, exclude0, exclude1, exclude2, any_hit=any_hit)
    return intersect_pairs(cl, o, d, tmin, tmax, exclude0, exclude1, exclude2, any_hit=any_hit,
                           any_hit_mask=any_hit_mask)


class SceneArrays(NamedTuple):
    """Device tensors the integrator touches per ray."""

    v0: torch.Tensor  # [T, 3]
    e1: torch.Tensor  # [T, 3]
    e2: torch.Tensor  # [T, 3]
    ng: torch.Tensor  # [T, 3]
    area: torch.Tensor  # [T]
    ns: torch.Tensor  # [T, 3, 3]
    uv: torch.Tensor  # [T, 3, 2]
    tangent: torch.Tensor  # [T, 3, 3]
    inst_id: torch.Tensor  # [T] int32
    shader_kind: torch.Tensor  # [T] int32
    tri_mat: torch.Tensor  # [T] int32
    param_mats: tuple  # per-kind [num_materials, kind_width] f32
    # [T, 41] = v0 e1 e2 ng area ns(9) uv(6) tangent(9) kind mat light_id prim_pdf
    attr: torch.Tensor
    const_emission: torch.Tensor | None  # [M, 3], None if any emission varies
    lights: LightArrays
    # cluster tier: {"clusters": ClusterArrays} over the flat soup, or None
    bvh: dict | None = None
    # instanced geometry (accel/instanced.py InstancedArrays), or None
    instanced: object = None
    # unified flat + instanced candidate list for the pair sweep, or None
    unified: object = None


@dataclass
class Scene:
    arrays: SceneArrays
    kinds: list[CompiledKind]
    camera: PerspectiveCamera
    atlas: TextureAtlas | None
    material_names: list[str]
    num_tris: int
    ggx_table: torch.Tensor  # [16, 16, 16] GGX dielectric albedo table
    ggx_table_np: np.ndarray
    # per-kind [kind_width, 2] host min/max of every constant column
    kind_const_ranges: list | None = None
    # (material table [M, MAT_COLS], has_spec, has_metal) when every kind
    # bakes into the reduced principled closure (K8, K9), else None
    shade_bake: tuple | None = None
    # K1's tiles of the flat soup (accel/intersect.py FlatTiles) when K1
    # traces it, else None
    tiles: FlatTiles | None = None
    # some texel of an image base color is not opaque: rays take the
    # alpha-tested traversal
    has_alpha: bool = False
    # per kind: can its alpha be below 1 (an image node), else None (all can)
    kind_alpha: list | None = None
    # the CUDA graphs of the per-kind shade's call sites, made at a site's
    # first call and kept with the scene (integrators/shade_graphs.py)
    shade_graphs: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    # restarts of the alpha-tested traversal a ray may take; a lane still
    # rejecting after them reports a miss
    MAX_ALPHA_RESTARTS = 64

    @property
    def device(self):
        return self.arrays.v0.device

    @property
    def has_dispersion(self) -> bool:
        """Some kind holds a dispersive (Cauchy) glass: spectral transport
        then terminates the secondary wavelengths at its hits."""
        return any(kind_is_dispersive(k) for k in self.kinds)

    @property
    def traversal(self) -> str:
        """The traversal a ray takes now, under the switches as they stand:
        "flat (K1)" without clusters, else "wide" (AKR_WIDE=1),
        "pairs-windowed" (AKR_PAIRS_STATIC=0) or "pairs-static". A flat part
        below the cluster tier beside instances also goes through K1."""
        a = self.arrays
        cl = a.unified if a.unified is not None else (a.bvh or {}).get("clusters")
        if cl is None:
            return "flat (K1)"
        if _use_wide(cl):
            return "wide"
        return "pairs-static" if static_walk_enabled() else "pairs-windowed"

    def intersect(self, o, d, tmin, tmax, exclude0=None, exclude1=None, exclude2=None,
                  any_hit_mask=None) -> Hit:
        """Closest hit through the scene's tier. With instances, the unified
        cluster traversal covers them (and the flat clusters, on the cluster tier);
        a flat part below the cluster tier goes through K1 up to the sweep's
        hit. any_hit_mask: per-lane any hit for the pair sweep; K1 runs
        closest hit for those lanes (callers read only `valid`)."""
        a = self.arrays
        if a.unified is None:
            return self._trace_flat(o, d, tmin, tmax, exclude0, exclude1, exclude2,
                                    any_hit_mask=any_hit_mask)
        hit_u = _cluster_trace(a.unified, o, d, tmin, tmax, exclude0, exclude1, exclude2,
                               any_hit_mask=any_hit_mask)
        if a.bvh is not None or self.num_tris == 0:
            return hit_u
        hit = self._trace_flat(o, d, tmin, torch.minimum(tmax, hit_u.t), exclude0, exclude1,
                               exclude2)
        better = hit_u.valid & (hit_u.t < hit.t)
        return Hit(*(torch.where(better.reshape(better.shape + (1,) * (x.ndim - 1)), xu, x)
                     for x, xu in zip(hit, hit_u)))

    def occlude(self, o, d, tmin, tmax, exclude0=None, exclude1=None, exclude2=None):
        """Any hit: bool [N]."""
        a = self.arrays
        if a.unified is None:
            return self._trace_flat(o, d, tmin, tmax, exclude0, exclude1, exclude2, any_hit=True)
        occ = _cluster_trace(a.unified, o, d, tmin, tmax, exclude0, exclude1, exclude2,
                             any_hit=True)
        if a.bvh is not None or self.num_tris == 0:
            return occ
        return occ | self._trace_flat(o, d, tmin, tmax, exclude0, exclude1, exclude2,
                                      any_hit=True)

    def _alpha_reject(self, hit):
        """Lanes whose hit the alpha test rejects: u >= alpha at the hit,
        with u hashed from the triangle id and the barycentrics' bits
        (wrapping uint32 in int64, bit-equal to JAX's). Only the kinds that
        can have alpha are evaluated, on their valid lanes."""
        si = self.surface_interaction(hit.tri_id, hit.bary)
        alpha = torch.ones(hit.t.shape, device=hit.t.device)
        for k in range(len(self.kinds)):
            if self.kind_alpha is not None and not self.kind_alpha[k]:
                continue
            mask = hit.valid & (si["kind"] == k)
            with stats.read("alpha_rows"):
                rows = torch.nonzero(mask).squeeze(1)
            if rows.numel():
                sub = {key: si[key][rows] for key in ("mat", "uv", "p", "ng")}
                sub["frame"] = tuple(f[rows] for f in si["frame"])
                alpha[rows] = dispatch_alpha(self.kinds[k], self.eval_context(sub, k))
        bits = hit.bary.contiguous().view(torch.int32).to(torch.int64) & MASK32
        tri = hit.tri_id.to(torch.int64) & MASK32
        u = (_hash(tri ^ _hash(bits[..., 0]) ^ bits[..., 1]) >> 8).to(torch.float32) * (
            1.0 / (1 << 24))
        return hit.valid & (u >= alpha)

    def intersect_alpha(self, o, d, tmin, tmax, exclude0=None, exclude1=None) -> Hit:
        """Closest hit with stochastic alpha: a rejected candidate is
        skipped by tracing again past it (tmin at its t, its id in the third
        exclusion slot; the caller's two stay in force), and lanes with
        nothing to trace again get tmax -1. The loop stops when no lane
        rejects (one host read a restart) or after MAX_ALPHA_RESTARTS; a
        lane still rejecting then reports a miss. Opaque scenes: intersect."""
        if not self.has_alpha:
            return self.intersect(o, d, tmin, tmax, exclude0, exclude1)
        hit = self.intersect(o, d, tmin, tmax, exclude0, exclude1)
        reject = self._alpha_reject(hit)
        for _ in range(self.MAX_ALPHA_RESTARTS):
            with stats.read("alpha_any"):
                if not bool(torch.any(reject)):
                    break
            rehit = self.intersect(o, d, torch.where(reject, hit.t, tmin),
                                   torch.where(reject, tmax, -1.0), exclude0, exclude1,
                                   exclude2=hit.tri_id)
            hit = Hit(*(torch.where(reject.reshape(reject.shape + (1,) * (x.ndim - 1)), y, x)
                        for x, y in zip(hit, rehit)))
            reject = self._alpha_reject(hit)
        return Hit(t=torch.where(reject, RAY_TMAX, hit.t),
                   tri_id=torch.where(reject, -1, hit.tri_id),
                   bary=hit.bary, valid=hit.valid & ~reject)

    def occlude_alpha(self, o, d, tmin, tmax, exclude0=None, exclude1=None):
        """Any hit with stochastic alpha, staged: a plain any hit first, then
        the closest-hit restart chain only for the lanes whose segment holds
        some surface (the others trace with tmax -1). Opaque scenes:
        occlude."""
        if not self.has_alpha:
            return self.occlude(o, d, tmin, tmax, exclude0, exclude1)
        any_surf = self.occlude(o, d, tmin, tmax, exclude0, exclude1)
        hit = self.intersect_alpha(o, d, tmin, torch.where(any_surf, tmax, -1.0), exclude0,
                                   exclude1)
        return any_surf & hit.valid

    def _trace_flat(self, o, d, tmin, tmax, exclude0=None, exclude1=None, exclude2=None,
                    any_hit=False, any_hit_mask=None):
        """The flat soup alone: the cluster traversal over its clusters on
        the cluster tier, else K1. A Hit, or bool [N] for any hit."""
        a = self.arrays
        n = o.shape[0]
        if self.num_tris == 0:
            if any_hit:
                return torch.zeros((n,), dtype=torch.bool, device=o.device)
            return Hit(
                t=torch.full((n,), RAY_TMAX, device=o.device),
                tri_id=torch.full((n,), -1, dtype=torch.int32, device=o.device),
                bary=torch.zeros((n, 2), device=o.device),
                valid=torch.zeros((n,), dtype=torch.bool, device=o.device),
            )
        if a.bvh is not None:
            return _cluster_trace(a.bvh["clusters"], o, d, tmin, tmax, exclude0, exclude1,
                                  exclude2, any_hit=any_hit, any_hit_mask=any_hit_mask)
        return intersect_tris(o, d, tmin, tmax, a.v0, a.e1, a.e2, exclude0, exclude1, exclude2,
                              any_hit=any_hit, tiles=self.tiles)

    def surface_interaction(self, tri_id, bary):
        """Fetch and interpolate hit attributes. Returns dict(p, ng, ns, uv,
        frame, area, kind, mat, light_id, prim_pdf, tri_id). Global virtual
        ids at or above num_tris are instanced triangles."""
        t = torch.clamp(tri_id, min=0)
        b0 = bary[..., 0:1]
        b1 = bary[..., 1:2]
        if self.arrays.instanced is None:
            return self._si_flat(t, b0, b1)
        si_i = self._si_instanced(t, b0, b1)
        if self.num_tris == 0:  # fully instanced scene
            return si_i
        is_inst = t >= self.num_tris
        si_f = self._si_flat(torch.clamp(t, max=self.num_tris - 1), b0, b1)
        si = {}
        for k, x in si_f.items():
            y = si_i[k]
            if k == "frame":
                si[k] = tuple(torch.where(is_inst[..., None], yi, xi) for xi, yi in zip(x, y))
            else:
                si[k] = torch.where(is_inst.reshape(is_inst.shape + (1,) * (x.ndim - 1)), y, x)
        si["tri_id"] = t
        return si

    def _si_flat(self, t, b0, b1):
        """One packed [N, 41] row gather."""
        attr = self.arrays.attr[t.long()]
        return self._finish_si(
            t, b0, b1, attr[..., 0:3], attr[..., 3:6], attr[..., 6:9], attr[..., 9:12],
            attr[..., 12], attr[..., 13:22].reshape(attr.shape[:-1] + (3, 3)),
            attr[..., 22:28].reshape(attr.shape[:-1] + (3, 2)),
            attr[..., 28:37].reshape(attr.shape[:-1] + (3, 3)),
            attr[..., 37].to(torch.int32), attr[..., 38].to(torch.int32),
            attr[..., 39].to(torch.int32), attr[..., 40],
        )

    def _si_instanced(self, t, b0, b1):
        """Attributes of global virtual ids >= num_tris: find the instance
        by tri_base, gather the LOCAL attribute row and transform it with
        the instance's matrices."""
        ia = self.arrays.instanced
        num_i = ia.tri_base.shape[0]
        tb = ia.tri_base.to(torch.int64)
        i = torch.clamp(torch.searchsorted(tb, t.to(torch.int64), right=True) - 1, 0, num_i - 1)
        tl_max = max(int(ia.v0.shape[0]) - 1, 0)
        lt = torch.clamp(t.to(torch.int64) - tb[i] + ia.mesh_tri_start.to(torch.int64)[i],
                         0, tl_max)
        m = ia.m[i]
        mt = ia.minv_t[i]
        al = ia.attr_local[lt]
        l_v0, l_e1, l_e2 = al[..., 0:3], al[..., 3:6], al[..., 6:9]
        nsl = al[..., 9:18].reshape(al.shape[:-1] + (3, 3))
        uv_c = al[..., 18:24].reshape(al.shape[:-1] + (3, 2))
        tanl = al[..., 24:33].reshape(al.shape[:-1] + (3, 3))
        v0 = apply_affine(m, l_v0)
        e1 = apply_linear(m, l_e1)
        e2 = apply_linear(m, l_e2)
        ng = apply_3x3(mt, torch.linalg.cross(l_e1, l_e2))
        ng = ng / torch.clamp(torch.sqrt(torch.sum(ng * ng, -1, keepdim=True)), min=1e-30)
        area = 0.5 * torch.sqrt(torch.sum(torch.linalg.cross(e1, e2) ** 2, -1))
        ns_c = torch.stack([apply_3x3(mt, nsl[:, c, :]) for c in range(3)], dim=-2)
        ns_c = ns_c / torch.clamp(torch.sqrt(torch.sum(ns_c * ns_c, -1, keepdim=True)), min=1e-30)
        tan_c = torch.stack([apply_linear(m, tanl[:, c, :]) for c in range(3)], dim=-2)
        tlen = torch.sqrt(torch.sum(tan_c * tan_c, -1, keepdim=True))
        tan_c = torch.where(tlen > 1e-12, tan_c / torch.clamp(tlen, min=1e-30), 0.0)
        slot = torch.clamp(al[..., 33].to(torch.int64), 0, ia.slot_mat.shape[1] - 1)
        mat = ia.slot_mat[i, slot]
        kind = ia.slot_kind[i, slot]
        light_id = torch.full(t.shape, -1, dtype=torch.int32, device=t.device)  # non-emissive
        prim_pdf = torch.zeros(t.shape, device=t.device)
        return self._finish_si(t, b0, b1, v0, e1, e2, ng, area, ns_c, uv_c, tan_c,
                               kind, mat, light_id, prim_pdf)

    def _finish_si(self, t, b0, b1, v0, e1, e2, ng, area, ns_c, uv_c, tan_c,
                   kind, mat, light_id, prim_pdf):
        p = v0 + e1 * b0 + e2 * b1
        w0 = 1.0 - b0 - b1
        ns = normalize(w0 * ns_c[..., 0, :] + b0 * ns_c[..., 1, :] + b1 * ns_c[..., 2, :])
        uv = w0[..., :1] * uv_c[..., 0, :] + b0[..., :1] * uv_c[..., 1, :] + b1[..., :1] * uv_c[..., 2, :]
        # dpdu tangent (mesh.rs:552-592)
        duv02 = uv_c[..., 0, :] - uv_c[..., 2, :]
        duv12 = uv_c[..., 1, :] - uv_c[..., 2, :]
        dp02 = -e2
        dp12 = e1 - e2
        det = duv02[..., 0] * duv12[..., 1] - duv02[..., 1] * duv12[..., 0]
        degenerate = torch.abs(det) < 1e-8
        inv_det = torch.where(degenerate, 0.0, 1.0 / torch.where(degenerate, 1.0, det))
        tangent = (duv12[..., 1:2] * dp02 - duv02[..., 1:2] * dp12) * inv_det[..., None]
        tlen2 = torch.sum(tangent * tangent, -1)
        fallback_t, _ = orthonormal_basis(ng)
        tangent = torch.where((degenerate | (tlen2 == 0.0))[..., None], fallback_t, tangent)
        # stored per-corner tangents take precedence over the dpdu fallback
        tan_stored = w0 * tan_c[..., 0, :] + b0 * tan_c[..., 1, :] + b1 * tan_c[..., 2, :]
        stored_ok = torch.sum(tan_stored * tan_stored, -1) > 1e-12
        tangent = torch.where(stored_ok[..., None], tan_stored, tangent)
        return {
            "p": p,
            "ng": ng,
            "ns": ns,
            "uv": uv,
            "frame": frame_from_n_t(ns, tangent),
            "area": area,
            "kind": kind,
            "mat": mat,
            "light_id": light_id,
            "prim_pdf": prim_pdf,
            "tri_id": t,
        }

    def eval_context(self, si, kind_idx: int, lambda0=None) -> EvalContext:
        """Per-lane shader constants of one kind: a row gather of its
        [num_materials, kind_width] matrix by material id. lambda0: the
        lanes' hero wavelengths in spectral mode (dispersive glass)."""
        return EvalContext(
            params=self.arrays.param_mats[kind_idx][si["mat"].long()],
            uv=si["uv"],
            p=si["p"],
            ng=si["ng"],
            frame=si["frame"],
            table=self.ggx_table,
            table_np=self.ggx_table_np,
            textures=self.atlas,
            const_ranges=(
                self.kind_const_ranges[kind_idx] if self.kind_const_ranges is not None else None
            ),
            lambda0=lambda0,
        )

    def kind_closure(self, si, kind_idx: int, rows, lambda0=None):
        """The world-space closure of one kind over the lanes `rows`;
        lambda0, if given, holds those lanes' hero wavelengths."""
        sub = {
            "mat": si["mat"][rows], "uv": si["uv"][rows], "p": si["p"][rows],
            "ng": si["ng"][rows], "frame": tuple(f[rows] for f in si["frame"]),
        }
        return self.closure_at(sub, kind_idx, lambda0=lambda0)

    def closure_at(self, sub, kind_idx: int, lambda0=None):
        """The world-space closure of one kind over every lane of `sub`
        (the fields mat, uv, p, ng and frame of an interaction's lanes)."""
        return dispatch_closure(self.kinds[kind_idx],
                                self.eval_context(sub, kind_idx, lambda0=lambda0))


def _kind_may_have_alpha(kind: CompiledKind) -> bool:
    """Whether a kind's alpha can be below 1: alpha comes only from an
    image base color (principled.rs:15-26, diffuse.rs:85-92), so a kind
    with an image node can; the atlas's texels decide at scene level."""
    return any(node[0] == "image" for node in kind.nodes)


def _const_emission_table(sg: SceneGraph, mat_names: list[str]):
    """Per-material constant emission [M, 3] (numpy), or None if any
    material's emission is texture-driven or has a nonzero clearcoat."""
    rows = []
    for name in mat_names:
        graph = sg.materials[name]["shader"]
        nodes = graph["nodes"]
        node = nodes[nodes[graph["output"]["id"]]["node"]["id"]]

        def const_rgb(ref):
            n = nodes[ref["id"]]
            t = n["type"]
            if t == "spectral_uplift":
                return const_rgb(n["rgb"])
            if t == "float":
                v = float(n["value"])
                return [v, v, v]
            if t in ("float3", "rgb"):
                return [float(x) for x in n["value"]]
            return None

        if node["type"] == "principled":
            e = const_rgb(node["emission_color"])
            st = const_rgb(node["emission_strength"])
            cw = const_rgb(node["coat_weight"]) if "coat_weight" in node else [0, 0, 0]
            if e is None or st is None or cw is None or max(cw) != 0.0:
                return None
            rows.append([e[i] * st[0] for i in range(3)])
        elif node["type"] == "emission":
            e = const_rgb(node["color"])
            st = const_rgb(node["strength"])
            if e is None or st is None:
                return None
            rows.append([e[i] * st[0] for i in range(3)])
        else:
            rows.append([0.0, 0.0, 0.0])
    return np.asarray(rows, np.float32)


def _estimate_emission_const(graph: dict) -> float | None:
    """Fast emission scan: max emission * strength if statically known,
    None if texture-driven (conservatively emissive)."""
    nodes = graph["nodes"]
    node = nodes[nodes[graph["output"]["id"]]["node"]["id"]]

    def const_max(ref):
        n = nodes[ref["id"]]
        t = n["type"]
        if t == "spectral_uplift":
            return const_max(n["rgb"])
        if t == "float":
            return float(n["value"])
        if t in ("float3", "rgb"):
            return float(max(n["value"]))
        return None

    if node["type"] == "principled":
        e, s = const_max(node["emission_color"]), const_max(node["emission_strength"])
        cw = const_max(node["coat_weight"]) if "coat_weight" in node else 0.0
        if cw is None or cw != 0.0:
            return None
    elif node["type"] == "emission":
        e, s = const_max(node["color"]), const_max(node["strength"])
    else:
        return 0.0
    if e is None or s is None:
        return None
    return e * s


def _partition_instances(sg: SceneGraph):
    """Pick the instances that stay in local space (the instanced tier)
    instead of being flattened: geometry referenced at least
    AKR_INSTANCE_MIN (default 2) times, by non-emissive instances, with at
    least AKR_INSTANCE_MIN_TRIS (default 128) triangles; all instances of a
    smaller mesh flatten. Emissive instances always flatten (the light
    tables are per world triangle). AKR_INSTANCING=0 disables the tier.
    Returns (skipped instance names, instance specs, local meshes)."""
    if os.environ.get("AKR_INSTANCING", "1") == "0":
        return set(), [], []
    min_refs = int(os.environ.get("AKR_INSTANCE_MIN", "2"))
    min_tris = int(os.environ.get("AKR_INSTANCE_MIN_TRIS", "128"))

    refcount: dict[str, int] = {}
    for inst in sg.instances.values():
        g = inst["geometry"]["id"]
        refcount[g] = refcount.get(g, 0) + 1

    skip: set[str] = set()
    specs: list[dict] = []
    meshes: list[dict] = []
    geom_slot: dict[str, int] = {}
    for idx, (name, inst) in enumerate(sg.instances.items()):
        g = inst["geometry"]["id"]
        if refcount[g] < min_refs:
            continue
        if any(
            (e := _estimate_emission_const(sg.materials[m["id"]]["shader"])) is None or e > 0.0
            for m in inst["materials"]
        ):
            continue
        if g not in geom_slot:
            me = local_mesh_arrays(sg, g)
            if len(me["v0"]) < min_tris:
                refcount[g] = 0  # too small: flatten all its instances
                continue
            geom_slot[g] = len(meshes)
            meshes.append(me)
        skip.add(name)
        specs.append({
            "name": name,
            "mesh": geom_slot[g],
            "matrix": load_transform(inst["transform"], is_camera=False),
            "materials": [m["id"] for m in inst["materials"]],
            "inst_index": idx,
        })
    return skip, specs, meshes


def _build_attr(soup: TriangleSoup, tri_kind: np.ndarray, tri_light_id, tri_prim_pdf) -> np.ndarray:
    """All per-triangle attributes packed into one [T, 41] float32 matrix."""
    t = len(soup.v0)
    cols = [
        soup.v0, soup.e1, soup.e2, soup.ng, soup.area[:, None],
        soup.ns.reshape(t, 9), soup.uv.reshape(t, 6), soup.tangent.reshape(t, 9),
        tri_kind[:, None].astype(np.float32),
        soup.mat_id[:, None].astype(np.float32),
        np.asarray(tri_light_id)[:, None].astype(np.float32),
        np.asarray(tri_prim_pdf)[:, None],
    ]
    return np.concatenate([np.asarray(c, np.float32) for c in cols], axis=1)


def _collect_images(sg: SceneGraph):
    """Decode every image-texture buffer the shader graphs reference."""
    keys: dict = {}
    images: list[np.ndarray] = []
    for mat in sg.materials.values():
        for node in mat["shader"]["nodes"].values():
            if node.get("type") != "image":
                continue
            key = _image_key(node["image"])
            if key in keys:
                continue
            keys[key] = len(images)
            images.append(_decode_image(sg, node["image"]))
    return images, keys


def _decode_image(sg: SceneGraph, img: dict) -> np.ndarray:
    """One image node's buffer -> [h, w, 4] float32 raw values, v-flipped."""
    data = sg.buffer_view(img["data"], np.uint8)
    fmt = img.get("format", "png")
    if fmt == "float":
        w, h, c = int(img["width"]), int(img["height"]), int(img.get("channels", 4))
        arr = np.frombuffer(data.tobytes(), np.float32).reshape(h, w, c)
        if c < 4:
            pad = np.concatenate(
                [np.zeros((h, w, 3 - c), np.float32), np.ones((h, w, 1), np.float32)], -1
            ) if c < 3 else np.ones((h, w, 1), np.float32)
            arr = np.concatenate([arr, pad[..., : 4 - c]], -1)
    elif fmt == "exr":
        from .core.image_io import read_exr_bytes

        rgb = read_exr_bytes(data.tobytes()).astype(np.float32)
        if rgb.shape[-1] >= 4:
            arr = rgb[..., :4]
        else:
            h, w = rgb.shape[:2]
            arr = np.concatenate([rgb, np.ones((h, w, 4 - rgb.shape[-1]), np.float32)], -1)
    else:  # png / jpeg / tiff / tga / dds
        from PIL import Image

        arr = np.asarray(Image.open(io.BytesIO(data.tobytes())).convert("RGBA"), np.float32) / 255.0
    return arr[::-1].copy()


def _mc_emission_power(scene: Scene, tri_ids: np.ndarray, n_samples: int = 16) -> np.ndarray:
    """Per-triangle emission power: mean over sampled points of
    max_rgb(closure.emission(wo)) * area (load.rs:312-343). Draws with the
    bit-exact PCG sampler, so it matches the JAX package."""
    from .core.samplers import IndependentSampler
    from .core.sampling import cos_sample_hemisphere, uniform_sample_triangle

    dev = scene.device
    m = len(tri_ids)
    tri = torch.as_tensor(np.repeat(tri_ids, n_samples), device=dev)
    smp = IndependentSampler.new(torch.arange(m * n_samples, device=dev), seed=1)
    smp, u_tri = smp.next_2d()
    smp, u_dir = smp.next_2d()
    si = scene.surface_interaction(tri, uniform_sample_triangle(u_tri))
    t, b, n = si["frame"]
    wo = Frame.to_world(t, b, n, cos_sample_hemisphere(u_dir))
    acc = torch.zeros(m * n_samples, device=dev)
    for k in range(len(scene.kinds)):
        rows = torch.nonzero(si["kind"] == k).squeeze(1)
        if rows.numel():
            e = scene.kind_closure(si, k, rows).emission(wo[rows])
            acc[rows] = torch.max(e, dim=-1).values
    power = acc * si["area"]
    return power.reshape(m, n_samples).mean(dim=1).cpu().numpy().astype(np.float64)


def load_scene(path: str, width: int | None = None, height: int | None = None,
               device="cuda", ggx_table: np.ndarray | None = None) -> Scene:
    """Load a scene.json onto `device` (the card unless the caller names
    another). ggx_table injects a [16, 16, 16]
    GGX albedo table (for example the JAX package's); by default the port
    computes its own (svm/precompute.py)."""
    device = torch.device(device)
    sg = load_scene_json(path)
    skip, inst_specs, meshes = _partition_instances(sg)
    soup, mat_names, instance_info = flatten_scene(sg, skip=skip or None)
    num_tris = len(soup.v0)
    driver = CompilerDriver()
    images, image_keys = _collect_images(sg)
    refs = {name: driver.compile(sg.materials[name]["shader"], image_keys) for name in mat_names}
    kinds = driver.kind_list
    for kind in kinds:
        check_kind(kind)
    tri_kind = np.array([refs[mat_names[m]].kind for m in soup.mat_id], np.int32)
    param_np = driver.param_matrices()

    atlas = None
    # alpha comes only from an image base color (_kind_may_have_alpha)
    kind_alpha = [_kind_may_have_alpha(k) for k in kinds]
    has_alpha = False
    if images:
        atlas_data, atlas_sizes = TextureAtlas.build_numpy(images)
        has_alpha = any(kind_alpha) and float(atlas_data[..., 3].min()) < 1.0
        atlas = TextureAtlas.from_numpy(atlas_data, atlas_sizes, device)

    table_np = np.asarray(ggx_table if ggx_table is not None else get_table(device), np.float32)

    def dev(a, dtype=None):
        return torch.as_tensor(np.array(a, dtype), device=device)

    # cluster tier over the flat soup
    flat_cl = None
    if num_tris >= BVH_MIN_TRIS or os.environ.get("AKR_FORCE_BVH"):
        order = build_bvh_order(soup.v0, soup.e1, soup.e2)
        flat_cl = attach_wide(build_clusters(soup.v0, soup.e1, soup.e2, order))
    # instanced tier, and the unified candidate list over both
    instanced = unified = None
    if inst_specs:
        name_to_idx = {name: i for i, name in enumerate(mat_names)}
        for spec in inst_specs:
            spec["slot_mat"] = [name_to_idx[m] for m in spec["materials"]] or [0]
            spec["slot_kind"] = [refs[m].kind for m in spec["materials"]] or [0]
        ia, _ = build_instanced(meshes, inst_specs, num_tris)
        unified = attach_wide(build_unified_clusters(ia, flat_cl)).to(device)
        instanced = ia.to(device)
    bvh = {"clusters": flat_cl.to(device)} if flat_cl is not None else None

    no_lights = LightArrays.build_numpy([], [], num_tris)
    arrays = SceneArrays(
        v0=dev(soup.v0, np.float32), e1=dev(soup.e1, np.float32), e2=dev(soup.e2, np.float32),
        ng=dev(soup.ng, np.float32), area=dev(soup.area, np.float32), ns=dev(soup.ns, np.float32),
        uv=dev(soup.uv, np.float32), tangent=dev(soup.tangent, np.float32),
        inst_id=dev(soup.inst_id, np.int32), shader_kind=dev(tri_kind, np.int32),
        tri_mat=dev(soup.mat_id, np.int32),
        param_mats=tuple(dev(m, np.float32) for m in param_np),
        attr=dev(_build_attr(soup, tri_kind, no_lights["tri_light_id"], no_lights["tri_prim_pdf"])),
        const_emission=None,
        lights=LightArrays.from_numpy(no_lights, device),
        bvh=bvh,
        instanced=instanced,
        unified=unified,
    )
    ce = _const_emission_table(sg, mat_names)
    scene = Scene(
        arrays=arrays._replace(const_emission=dev(ce) if ce is not None else None),
        kinds=kinds,
        camera=camera_from_scenegraph(sg.camera, width, height, device),
        atlas=atlas,
        material_names=mat_names,
        num_tris=num_tris,
        ggx_table=dev(table_np),
        ggx_table_np=table_np,
        kind_const_ranges=[np.stack([m.min(axis=0), m.max(axis=0)], axis=-1) for m in param_np],
        tiles=flat_tiles(arrays.v0, arrays.e1, arrays.e2) if bvh is None and num_tris else None,
        has_alpha=has_alpha,
        kind_alpha=kind_alpha,
    )

    # emissive detection and per-triangle power (load.rs:312-414)
    light_powers, light_tris = [], []
    for info in instance_info:
        emissive, needs_mc = False, False
        for mname in info["materials"]:
            e = _estimate_emission_const(sg.materials[mname]["shader"])
            if e is None:
                needs_mc = emissive = True
            elif e > 0:
                emissive = True
        if not emissive:
            continue
        s, c = info["tri_start"], info["tri_count"]
        tri_ids = np.arange(s, s + c, dtype=np.int32)
        if needs_mc:
            powers = _mc_emission_power(scene, tri_ids, n_samples=16)
        else:
            per_mat = np.array([
                _estimate_emission_const(sg.materials[mat_names[m]]["shader"]) or 0.0
                for m in soup.mat_id[s: s + c]
            ])
            powers = (per_mat * soup.area[s: s + c]).astype(np.float64)
        if float(powers.sum()) > 1e-4:
            light_powers.append(powers)
            light_tris.append(tri_ids)
    lights_np = LightArrays.build_numpy(light_powers, light_tris, num_tris)
    attr = _build_attr(soup, tri_kind, lights_np["tri_light_id"], lights_np["tri_prim_pdf"])
    if light_powers:
        rows = attr[lights_np["tri_ids"]]
        if rows[:, 38].max(initial=0.0) >= float(1 << 24):
            raise ValueError("compact light table: material id exceeds float32 exactness")
        lights_np["attr"] = np.concatenate([rows[:, :13], rows[:, 38:39]], axis=1)
    scene.arrays = scene.arrays._replace(
        lights=LightArrays.from_numpy(lights_np, device), attr=dev(attr)
    )
    scene.shade_bake = None if has_alpha else bake_shading(scene)
    return scene
