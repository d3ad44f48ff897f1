"""Scene flattening: scenegraph -> flat HBM-resident world-space arrays.

TPU-native replacement for the reference's MegaHeap + MeshAggregate BLAS/TLAS
(crates/akari_render/src/{heap.rs,mesh.rs:220-333}): instead of bindless
buffers + a two-level hardware BVH over instanced meshes, we bake instance
transforms into one flat world-space triangle soup at load time and address
everything with integer ids — the natural layout for XLA gathers.

Per-corner attributes (normals/uvs/tangents are per-loop in the scenegraph,
matching Blender split attributes — ref mesh.rs:536-599) are interpolated at
hit points from [T, 3, k] arrays.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..scenegraph.model import SceneGraph, load_transform


class TriangleSoup(NamedTuple):
    """Host-side (numpy) flattened geometry, before device upload."""

    v0: np.ndarray  # [T, 3]
    e1: np.ndarray  # [T, 3] v1 - v0
    e2: np.ndarray  # [T, 3] v2 - v0
    ng: np.ndarray  # [T, 3] world geometric normal (normalized)
    area: np.ndarray  # [T]   world-space area
    ns: np.ndarray  # [T, 3, 3] per-corner world shading normals
    uv: np.ndarray  # [T, 3, 2] per-corner uvs
    tangent: np.ndarray  # [T, 3, 3] per-corner world tangents (0 = use dpdu)
    inst_id: np.ndarray  # [T] u32
    mat_id: np.ndarray  # [T] u32 index into scene material list (resolved slot)


def flatten_scene(
    sg: SceneGraph, skip: set[str] | None = None
) -> tuple[TriangleSoup, list[str], list[dict]]:
    """Flatten instances to world space (minus `skip`, which the instanced
    two-level accel handles — accel/instanced.py).

    Returns (soup, material_ids, instance_info) where material_ids is the
    ordered list of material node names (mat_id indexes it) and instance_info
    carries per-instance metadata for light building.
    """
    mat_name_to_idx: dict[str, int] = {}
    mat_names: list[str] = []

    def mat_idx(name: str) -> int:
        if name not in mat_name_to_idx:
            mat_name_to_idx[name] = len(mat_names)
            mat_names.append(name)
        return mat_name_to_idx[name]

    chunks = {k: [] for k in TriangleSoup._fields}
    instance_info = []
    tri_base = 0
    for iid, (inst_name, inst) in enumerate(sg.instances.items()):
        if skip is not None and inst_name in skip:
            # the instanced path still needs deterministic material ids:
            # register them in encounter order, same as the flattened walk
            for mref in inst["materials"]:
                mat_idx(mref["id"])
            continue
        mesh = sg.mesh_arrays(inst["geometry"]["id"])
        m = load_transform(inst["transform"], is_camera=False)
        m3 = m[:3, :3]
        t3 = m[:3, 3]
        det = float(np.linalg.det(m3))
        m_inv_t = np.linalg.inv(m3).T if abs(det) > 1e-20 else np.eye(3)

        verts = mesh["vertices"].astype(np.float64)
        idx = mesh["indices"].astype(np.int64)
        ntri = len(idx)
        v0l, v1l, v2l = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]
        ngl = np.cross(v1l - v0l, v2l - v0l)
        len_l = np.linalg.norm(ngl, axis=-1, keepdims=True)
        area_l = len_l[:, 0] * 0.5
        ngl = ngl / np.maximum(len_l, 1e-30)

        v0 = v0l @ m3.T + t3
        v1 = v1l @ m3.T + t3
        v2 = v2l @ m3.T + t3
        ng = ngl @ m_inv_t.T
        ng_len = np.linalg.norm(ng, axis=-1, keepdims=True)
        ng = ng / np.maximum(ng_len, 1e-30)
        # world area = local area * det / (ng_world . (M ng_local))  (mesh.rs:604-629)
        c = ngl @ m3.T
        denom = (ng * c).sum(-1)
        area = np.where(
            (area_l == 0.0) | (det == 0.0), 0.0, np.abs(area_l * det / np.where(denom == 0, 1, denom))
        )

        # per-corner shading normals (per-loop layout: [3*T, 3])
        if mesh["normals"] is not None:
            nsl = mesh["normals"].astype(np.float64).reshape(ntri, 3, 3)
            ns = nsl @ m_inv_t.T
            ns = ns / np.maximum(np.linalg.norm(ns, axis=-1, keepdims=True), 1e-30)
        else:
            ns = np.repeat(ng[:, None, :], 3, axis=1)

        # per-corner tangent frames: stored tangents when the asset ships
        # them (ref mesh.rs:552-592 interpolates stored mikktspace tangents),
        # else generated by smoothed per-vertex accumulation of the per-face
        # uv-gradient tangent (the mikktspace-generation analog of
        # mesh.rs:118-124; welding is by shared vertex index). Tangents are
        # directions: transform by M, not inverse-transpose.
        if mesh.get("tangents") is not None:
            tanl = mesh["tangents"].astype(np.float64).reshape(ntri, 3, 3)
        elif mesh["uvs"] is not None:
            tanl = _generate_tangents(
                verts, idx, mesh["uvs"].astype(np.float64).reshape(ntri, 3, 2)
            )
        else:
            tanl = np.zeros((ntri, 3, 3))
        tangent = tanl @ m3.T
        tlen = np.linalg.norm(tangent, axis=-1, keepdims=True)
        tangent = np.where(tlen > 1e-12, tangent / np.maximum(tlen, 1e-30), 0.0)

        if mesh["uvs"] is not None:
            uv = mesh["uvs"].astype(np.float32).reshape(ntri, 3, 2)
        else:
            # default uvs (mesh.rs:541-546)
            uv = np.broadcast_to(
                np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 0.1]], np.float32), (ntri, 3, 2)
            ).copy()

        # resolve per-prim material slots -> global material index.
        # The materials buffer holds per-prim slot indices only for
        # multi-material meshes (ref mesh.rs:509-519 HAS_MULTI_MATERIALS);
        # single-material meshes store a single slot entry.
        slots = [mat_idx(mref["id"]) for mref in inst["materials"]]
        slot_arr = np.asarray(slots if slots else [0], np.uint32)
        raw = mesh["materials"].astype(np.int64)
        if len(raw) == ntri:
            prim_slots = raw
        elif len(raw) >= 1:
            prim_slots = np.full(ntri, raw[0], np.int64)
        else:
            prim_slots = np.zeros(ntri, np.int64)
        prim_slots = np.clip(prim_slots, 0, len(slot_arr) - 1)
        tri_mat = slot_arr[prim_slots]

        chunks["v0"].append(v0.astype(np.float32))
        chunks["e1"].append((v1 - v0).astype(np.float32))
        chunks["e2"].append((v2 - v0).astype(np.float32))
        chunks["ng"].append(ng.astype(np.float32))
        chunks["area"].append(area.astype(np.float32))
        chunks["ns"].append(ns.astype(np.float32))
        chunks["uv"].append(uv.astype(np.float32))
        chunks["tangent"].append(tangent.astype(np.float32))
        chunks["inst_id"].append(np.full(ntri, iid, np.uint32))
        chunks["mat_id"].append(tri_mat.astype(np.uint32))

        instance_info.append(
            {
                "name": inst_name,
                "tri_start": tri_base,
                "tri_count": ntri,
                "materials": [mref["id"] for mref in inst["materials"]],
            }
        )
        tri_base += ntri

    if chunks["v0"]:
        soup = TriangleSoup(**{k: np.concatenate(v, axis=0) for k, v in chunks.items()})
    else:  # fully-instanced scene: typed empty soup
        soup = TriangleSoup(
            v0=np.zeros((0, 3), np.float32),
            e1=np.zeros((0, 3), np.float32),
            e2=np.zeros((0, 3), np.float32),
            ng=np.zeros((0, 3), np.float32),
            area=np.zeros((0,), np.float32),
            ns=np.zeros((0, 3, 3), np.float32),
            uv=np.zeros((0, 3, 2), np.float32),
            tangent=np.zeros((0, 3, 3), np.float32),
            inst_id=np.zeros((0,), np.uint32),
            mat_id=np.zeros((0,), np.uint32),
        )
    return soup, mat_names, instance_info


def local_mesh_arrays(sg: SceneGraph, geom_id: str) -> dict:
    """Extract one mesh in LOCAL space for the instanced accel
    (accel/instanced.py) — same attribute conventions as the flattened path,
    without the world transform. Returns numpy dict with v0/e1/e2 [T,3],
    ns/tangent [T,3,3], uv [T,3,2], mat_slot [T]."""
    mesh = sg.mesh_arrays(geom_id)
    verts = mesh["vertices"].astype(np.float64)
    idx = mesh["indices"].astype(np.int64)
    ntri = len(idx)
    v0, v1, v2 = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]
    ngl = np.cross(v1 - v0, v2 - v0)
    ngl = ngl / np.maximum(np.linalg.norm(ngl, axis=-1, keepdims=True), 1e-30)
    if mesh["normals"] is not None:
        ns = mesh["normals"].astype(np.float64).reshape(ntri, 3, 3)
    else:
        ns = np.repeat(ngl[:, None, :], 3, axis=1)
    if mesh["uvs"] is not None:
        uv = mesh["uvs"].astype(np.float32).reshape(ntri, 3, 2)
    else:
        uv = np.broadcast_to(
            np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 0.1]], np.float32), (ntri, 3, 2)
        ).copy()
    if mesh.get("tangents") is not None:
        tangent = mesh["tangents"].astype(np.float64).reshape(ntri, 3, 3)
    elif mesh["uvs"] is not None:
        tangent = _generate_tangents(
            verts, idx, mesh["uvs"].astype(np.float64).reshape(ntri, 3, 2)
        )
    else:
        tangent = np.zeros((ntri, 3, 3))
    raw = mesh["materials"].astype(np.int64)
    if len(raw) == ntri:
        prim_slots = raw
    elif len(raw) >= 1:
        prim_slots = np.full(ntri, raw[0], np.int64)
    else:
        prim_slots = np.zeros(ntri, np.int64)
    return {
        "v0": v0.astype(np.float32),
        "e1": (v1 - v0).astype(np.float32),
        "e2": (v2 - v0).astype(np.float32),
        "ns": ns.astype(np.float32),
        "uv": uv.astype(np.float32),
        "tangent": tangent.astype(np.float32),
        "mat_slot": prim_slots.astype(np.int32),
    }


def _generate_tangents(verts: np.ndarray, idx: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Smoothed tangent generation: per-face uv-gradient tangent (dpdu),
    accumulated per shared vertex and renormalized — so tangents are
    continuous across faces like mikktspace output, unlike raw per-face
    dpdu. verts [V,3], idx [T,3], uv [T,3,2] -> per-corner [T,3,3]."""
    v0, v1, v2 = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]
    duv02 = uv[:, 0] - uv[:, 2]
    duv12 = uv[:, 1] - uv[:, 2]
    dp02 = v0 - v2
    dp12 = v1 - v2
    det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
    ok = np.abs(det) > 1e-12
    inv_det = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    t_face = (duv12[:, 1:2] * dp02 - duv02[:, 1:2] * dp12) * inv_det[:, None]
    acc = np.zeros((len(verts), 3))
    for c in range(3):
        np.add.at(acc, idx[:, c], t_face)
    ln = np.linalg.norm(acc, axis=-1, keepdims=True)
    acc = np.where(ln > 1e-12, acc / np.maximum(ln, 1e-30), 0.0)
    return acc[idx]  # [T, 3, 3]
