"""Triangle clusters for the pair sweep (port of
akari_render_tpu/accel/cluster.py: ClusterArrays and build_clusters).

Triangles are reordered by the binned-SAH BVH's leaf order (spatial
locality) and cut into K clusters of exactly C triangles, the last one
padded with degenerate triangles of id -1; each cluster keeps its tight
AABB. The JAX package's flat cluster rounds and superclusters are its CPU
traversal; the port traverses clusters only with the pair sweep
(accel/pairs.py), whose plain torch version serves the CPU.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

# AKR_CLUSTER_SIZE: triangles per cluster, read at import like the JAX
# package's (scene-build override for end-to-end sweeps)
CLUSTER_SIZE = int(os.environ.get("AKR_CLUSTER_SIZE", "128"))
# global triangle ids ride in the float32 cluster table: exact below 2^24
MAX_FLOAT_ID = 1 << 24


class ClusterArrays(NamedTuple):
    cbmin: torch.Tensor  # [K, 3]
    cbmax: torch.Tensor  # [K, 3]
    tri: torch.Tensor  # [R, C, 12] packed v0|e1|e2|(id, 0, 0); R = K unless tri_row
    order: torch.Tensor  # [K*C] original tri id per slot (-1 padding)
    # unified instancing (accel/instanced.py build_unified_clusters):
    # candidate k's triangles live at tri[tri_row[k]] in LOCAL space and the
    # sweep applies xf[k] (world->local affine rows + global-id offset)
    xf: torch.Tensor | None = None  # [K, 16] minv(12) | id_off | pad(3)
    tri_row: torch.Tensor | None = None  # [K] int32 row into tri
    # packed 8-wide BVH over the candidate AABBs for the wide walk
    # (accel/wide.py attach_wide): [Nn, 128] int32
    wide: torch.Tensor | None = None

    @property
    def num_clusters(self) -> int:
        return self.cbmin.shape[0]

    def to(self, device) -> "ClusterArrays":
        return ClusterArrays(*(None if x is None else x.to(device) for x in self))


def check_float_ids(max_id: int):
    """Raise if a triangle id would not be exact as float32."""
    if max_id >= MAX_FLOAT_ID:
        raise ValueError(f"triangle id {max_id} exceeds float32 exactness (2^24)")


def build_clusters(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, order: np.ndarray,
                   cluster_size: int = CLUSTER_SIZE) -> ClusterArrays:
    """Pack BVH-ordered triangles into padded clusters (host numpy, returned
    as CPU tensors)."""
    T = len(v0)
    check_float_ids(T - 1)
    C = cluster_size
    K = (T + C - 1) // C
    Tp = K * C
    slot_order = np.full(Tp, -1, np.int64)
    slot_order[:T] = order
    sv0 = np.zeros((Tp, 3), np.float32)
    se1 = np.zeros((Tp, 3), np.float32)
    se2 = np.zeros((Tp, 3), np.float32)
    valid = slot_order >= 0
    sv0[valid] = v0[slot_order[valid]]
    se1[valid] = e1[slot_order[valid]]
    se2[valid] = e2[slot_order[valid]]
    # degenerate padding triangles never hit (e1 = e2 = 0)
    lo = np.minimum(np.minimum(sv0, sv0 + se1), sv0 + se2).reshape(K, C, 3)
    hi = np.maximum(np.maximum(sv0, sv0 + se1), sv0 + se2).reshape(K, C, 3)
    vmask = valid.reshape(K, C, 1)
    big = np.float32(1e30)
    cbmin = np.where(vmask, lo, big).min(axis=1)
    cbmax = np.where(vmask, hi, -big).max(axis=1)
    packed = np.concatenate(
        [sv0, se1, se2, slot_order[:, None].astype(np.float32), np.zeros((Tp, 2), np.float32)],
        axis=1,
    ).reshape(K, C, 12)
    return ClusterArrays(
        cbmin=torch.as_tensor(cbmin),
        cbmax=torch.as_tensor(cbmax),
        tri=torch.as_tensor(packed),
        order=torch.as_tensor(slot_order.astype(np.int32)),
    )
