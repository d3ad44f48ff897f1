"""Instanced geometry (port of akari_render_tpu/accel/instanced.py, host
side): shared per-mesh clusters in LOCAL space plus per-instance
transforms, and the unified candidate list that the pair sweep traverses.

N instances of an M-triangle mesh cost O(M) memory for geometry plus O(N)
for transforms. Traversal is the unified pair sweep (accel/pairs.py): one
world-space candidate list of the flat clusters and every instance's
clusters, each candidate carrying world->local affine rows and a global-id
offset. The JAX package's two-level `intersect_instanced` is its CPU route
and is not ported.

Global virtual triangle ids: the flat soup holds ids [0, num_tris); the
instance i's triangles follow at tri_base[i] + local id.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..native import build_bvh_order
from .cluster import CLUSTER_SIZE, ClusterArrays, build_clusters, check_float_ids


class InstancedArrays(NamedTuple):
    # ---- per instance, [I, ...] ----
    ibmin: torch.Tensor  # [I, 3] world AABB
    ibmax: torch.Tensor  # [I, 3]
    m: torch.Tensor  # [I, 12] local->world affine rows (3x4)
    minv: torch.Tensor  # [I, 12] world->local affine rows
    minv_t: torch.Tensor  # [I, 9] inverse-transpose 3x3 (normal transform)
    tri_base: torch.Tensor  # [I] first global virtual tri id
    tri_count: torch.Tensor  # [I] mesh tri count
    mesh_tri_start: torch.Tensor  # [I] local-soup start of this instance's mesh
    cluster_lo: torch.Tensor  # [I] first local cluster id of the mesh
    cluster_hi: torch.Tensor  # [I] one-past-last
    inst_index: torch.Tensor  # [I] scene instance index
    # ---- local geometry (concatenated unique meshes) ----
    clusters: ClusterArrays
    v0: torch.Tensor  # [Tl, 3] local
    e1: torch.Tensor
    e2: torch.Tensor
    ns: torch.Tensor  # [Tl, 3, 3] local per-corner shading normals
    uv: torch.Tensor  # [Tl, 3, 2]
    tangent: torch.Tensor  # [Tl, 3, 3] local per-corner tangents (0 = dpdu)
    mat_slot: torch.Tensor  # [Tl] local material slot index
    slot_mat: torch.Tensor  # [I, S] slot -> global material id
    slot_kind: torch.Tensor  # [I, S] slot -> shader kind
    # [Tl, 34]: v0|e1|e2|ns(9)|uv(6)|tangent(9)|mat_slot, one row per lane
    attr_local: torch.Tensor | None = None

    def to(self, device) -> "InstancedArrays":
        return InstancedArrays(*(
            None if x is None else x.to(device) for x in self
        ))


def _affine_rows(mat: np.ndarray) -> np.ndarray:
    """4x4 -> flattened 3x4 rows [12]."""
    return np.asarray(mat, np.float64)[:3, :4].reshape(12).astype(np.float32)


def _matvec(r, v):
    """r [N, 3, k>=3], v [N, 3] -> r[:, :, :3] @ v, summed left to right."""
    return r[:, :, 0] * v[:, None, 0] + r[:, :, 1] * v[:, None, 1] + r[:, :, 2] * v[:, None, 2]


def apply_affine(rows, p):
    """rows: [N, 12] (3x4); p: [N, 3] -> R @ p + t."""
    r = rows.reshape(rows.shape[0], 3, 4)
    return _matvec(r, p) + r[:, :, 3]


def apply_linear(rows, v):
    """rows: [N, 12] (3x4); v: [N, 3] -> R @ v."""
    return _matvec(rows.reshape(rows.shape[0], 3, 4), v)


def apply_3x3(rows9, v):
    """rows9: [N, 9] (3x3); v: [N, 3] -> M @ v."""
    return _matvec(rows9.reshape(rows9.shape[0], 3, 3), v)


def build_instanced(meshes: list[dict], instances: list[dict], tri_base0: int):
    """meshes: [{v0,e1,e2,ns,uv,tangent,mat_slot}] local numpy arrays.
    instances: [{mesh: idx, matrix: 4x4, slot_mat: [S], slot_kind: [S],
    inst_index: int}]. tri_base0: first global virtual id (= num flat tris).
    Returns (InstancedArrays of CPU tensors, one past the last global id)."""
    # clusters are built per mesh, so no cluster spans two meshes
    offs, cl_offs = [], []
    cat = {k: [] for k in ("v0", "e1", "e2", "ns", "uv", "tangent", "mat_slot")}
    all_cbmin, all_cbmax, all_tri = [], [], []
    tstart = 0
    cstart = 0
    for me in meshes:
        T = len(me["v0"])
        order = (build_bvh_order(me["v0"], me["e1"], me["e2"]) if T > CLUSTER_SIZE
                 else np.arange(T))
        cl = build_clusters(me["v0"], me["e1"], me["e2"], order)
        # local tri ids inside cluster rows are mesh-local; shift to soup-local
        tri = cl.tri.numpy().copy()
        ids = tri[..., 9]
        tri[..., 9] = np.where(ids >= 0, ids + tstart, ids)
        all_cbmin.append(cl.cbmin.numpy())
        all_cbmax.append(cl.cbmax.numpy())
        all_tri.append(tri)
        offs.append(tstart)
        cl_offs.append((cstart, cstart + tri.shape[0]))
        cstart += tri.shape[0]
        tstart += T
        for k in cat:
            cat[k].append(me[k])
    check_float_ids(tstart - 1)
    clusters = ClusterArrays(
        cbmin=torch.as_tensor(np.concatenate(all_cbmin)),
        cbmax=torch.as_tensor(np.concatenate(all_cbmax)),
        tri=torch.as_tensor(np.concatenate(all_tri)),
        order=torch.zeros((0,), dtype=torch.int32),  # unused for instances
    )

    S = max(len(i["slot_mat"]) for i in instances)
    rows_m, rows_minv, rows_minvt = [], [], []
    ibmin, ibmax = [], []
    tri_bases, tri_counts, mesh_starts, cl_lo, cl_hi, inst_idx = [], [], [], [], [], []
    slot_mat = np.zeros((len(instances), S), np.int32)
    slot_kind = np.zeros((len(instances), S), np.int32)
    vbase = tri_base0
    for ii, inst in enumerate(instances):
        mi = inst["mesh"]
        me = meshes[mi]
        mat = np.asarray(inst["matrix"], np.float64)
        rows_m.append(_affine_rows(mat))
        inv = np.linalg.inv(mat)
        rows_minv.append(_affine_rows(inv))
        rows_minvt.append(inv[:3, :3].T.reshape(9).astype(np.float32))
        # world AABB: transform the local AABB's 8 corners
        lo = np.minimum(np.minimum(me["v0"], me["v0"] + me["e1"]), me["v0"] + me["e2"]).min(0)
        hi = np.maximum(np.maximum(me["v0"], me["v0"] + me["e1"]), me["v0"] + me["e2"]).max(0)
        corners = np.stack([np.where([(c >> b) & 1 for b in range(3)], hi, lo) for c in range(8)])
        wc = corners @ mat[:3, :3].T + mat[:3, 3]
        ibmin.append(wc.min(0).astype(np.float32))
        ibmax.append(wc.max(0).astype(np.float32))
        T = len(me["v0"])
        tri_bases.append(vbase)
        tri_counts.append(T)
        mesh_starts.append(offs[mi])
        cl_lo.append(cl_offs[mi][0])
        cl_hi.append(cl_offs[mi][1])
        inst_idx.append(inst["inst_index"])
        sm = np.asarray(inst["slot_mat"], np.int32)
        slot_mat[ii, : len(sm)] = sm
        slot_mat[ii, len(sm):] = sm[0] if len(sm) else 0
        sk = np.asarray(inst["slot_kind"], np.int32)
        slot_kind[ii, : len(sk)] = sk
        slot_kind[ii, len(sk):] = sk[0] if len(sk) else 0
        vbase += T
    check_float_ids(vbase - 1)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32))

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    local = {k: np.concatenate(v) for k, v in cat.items()}
    attr_local = np.concatenate(
        [
            local["v0"].astype(np.float32), local["e1"].astype(np.float32),
            local["e2"].astype(np.float32),
            local["ns"].astype(np.float32).reshape(-1, 9),
            local["uv"].astype(np.float32).reshape(-1, 6),
            local["tangent"].astype(np.float32).reshape(-1, 9),
            local["mat_slot"].astype(np.float32)[:, None],
        ],
        axis=1,
    )
    return (
        InstancedArrays(
            ibmin=f32(np.stack(ibmin)), ibmax=f32(np.stack(ibmax)),
            m=f32(np.stack(rows_m)), minv=f32(np.stack(rows_minv)),
            minv_t=f32(np.stack(rows_minvt)),
            tri_base=i32(tri_bases), tri_count=i32(tri_counts),
            mesh_tri_start=i32(mesh_starts), cluster_lo=i32(cl_lo), cluster_hi=i32(cl_hi),
            inst_index=i32(inst_idx),
            clusters=clusters,
            v0=f32(local["v0"]), e1=f32(local["e1"]), e2=f32(local["e2"]),
            ns=f32(local["ns"]), uv=f32(local["uv"]), tangent=f32(local["tangent"]),
            mat_slot=i32(local["mat_slot"]),
            slot_mat=torch.as_tensor(slot_mat), slot_kind=torch.as_tensor(slot_kind),
            attr_local=f32(attr_local),
        ),
        vbase,
    )


def build_unified_clusters(ia: InstancedArrays, flat_cl: ClusterArrays | None) -> ClusterArrays:
    """Fuse the flat-soup clusters and every instance's (shared) local
    clusters into ONE world-space candidate list for the pair sweep:
    candidate k carries a world AABB, a row into the concatenated triangle
    table, and world->local transform rows plus a global-id offset that the
    sweep applies to the ray. N instances of a mesh share its rows."""
    lcb_min = ia.clusters.cbmin.numpy()
    lcb_max = ia.clusters.cbmax.numpy()
    m = ia.m.numpy()
    minv = ia.minv.numpy()
    cl_lo = ia.cluster_lo.numpy()
    cl_hi = ia.cluster_hi.numpy()
    base = ia.tri_base.numpy()
    start = ia.mesh_tri_start.numpy()

    kf = flat_cl.num_clusters if flat_cl is not None else 0
    bmins, bmaxs, xfs, rows = [], [], [], []
    if flat_cl is not None:
        bmins.append(flat_cl.cbmin.numpy())
        bmaxs.append(flat_cl.cbmax.numpy())
        ident = np.zeros((kf, 16), np.float32)
        ident[:, 0] = ident[:, 5] = ident[:, 10] = 1.0
        xfs.append(ident)
        rows.append(np.arange(kf, dtype=np.int32))
    for i in range(len(cl_lo)):
        lo, hi = int(cl_lo[i]), int(cl_hi[i])
        lb, ub = lcb_min[lo:hi], lcb_max[lo:hi]
        R = m[i].reshape(3, 4)
        c = (lb + ub) * 0.5
        e = (ub - lb) * 0.5
        wc = c @ R[:, :3].T + R[:, 3]
        we = e @ np.abs(R[:, :3]).T
        bmins.append((wc - we).astype(np.float32))
        bmaxs.append((wc + we).astype(np.float32))
        xf = np.zeros((hi - lo, 16), np.float32)
        xf[:, :12] = minv[i]
        xf[:, 12] = np.float32(base[i] - start[i])
        xfs.append(xf)
        rows.append(np.arange(kf + lo, kf + hi, dtype=np.int32))

    tri_tabs = ([flat_cl.tri.numpy()] if flat_cl is not None else []) + [ia.clusters.tri.numpy()]
    return ClusterArrays(
        cbmin=torch.as_tensor(np.concatenate(bmins)),
        cbmax=torch.as_tensor(np.concatenate(bmaxs)),
        tri=torch.as_tensor(np.concatenate(tri_tabs)),
        order=torch.zeros((0,), dtype=torch.int32),
        xf=torch.as_tensor(np.concatenate(xfs)),
        tri_row=torch.as_tensor(np.concatenate(rows)),
    )
