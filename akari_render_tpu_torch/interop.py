"""Carry scene state made elsewhere into the port, as plain numpy.

scene_arrays_from_numpy builds the port's SceneArrays (and albedo tables)
from a dict of numpy arrays, for example one made from the JAX package's
SceneArrays with np.asarray, so both packages can compute with the same
scene and the same GGX table. cluster_arrays_from_numpy and
instanced_arrays_from_numpy do the same for the acceleration state (the
JAX package's ClusterArrays, unified candidate list and InstancedArrays),
so both packages can traverse the same tables. The port never sees a jax
object.
"""
from __future__ import annotations

import numpy as np
import torch

from .accel.cluster import ClusterArrays
from .accel.instanced import InstancedArrays
from .lights import LightArrays
from .scene import SceneArrays

_INT_FIELDS = ("inst_id", "shader_kind", "tri_mat")
_ACCEL_FIELDS = ("bvh", "instanced", "unified")
_CLUSTER_INT_FIELDS = ("order", "tri_row", "wide")
_INSTANCED_INT_FIELDS = ("tri_base", "tri_count", "mesh_tri_start", "cluster_lo",
                         "cluster_hi", "inst_index", "mat_slot", "slot_mat", "slot_kind")


def cluster_arrays_from_numpy(arrays: dict, device) -> ClusterArrays:
    """arrays: the ClusterArrays fields by name (numpy; xf, tri_row and
    wide, the wide walk's node table, may be missing or None). Fields the
    port does not keep (the JAX package's superclusters) are ignored."""
    fields = {}
    for name in ClusterArrays._fields:
        v = arrays.get(name)
        dtype = np.int32 if name in _CLUSTER_INT_FIELDS else np.float32
        fields[name] = None if v is None else torch.as_tensor(np.array(v, dtype), device=device)
    return ClusterArrays(**fields)


def instanced_arrays_from_numpy(arrays: dict, device) -> InstancedArrays:
    """arrays: the InstancedArrays fields by name (numpy), with 'clusters'
    a dict of ClusterArrays fields."""
    fields = {}
    for name in InstancedArrays._fields:
        v = arrays.get(name)
        if name == "clusters":
            fields[name] = cluster_arrays_from_numpy(v, device)
        elif v is not None:
            dtype = np.int32 if name in _INSTANCED_INT_FIELDS else np.float32
            fields[name] = torch.as_tensor(np.array(v, dtype), device=device)
        else:
            fields[name] = None
    return InstancedArrays(**fields)


def scene_arrays_from_numpy(arrays: dict, tables: dict, device):
    """arrays: the SceneArrays fields by name ('param_mats' a list of
    matrices, 'lights' a dict of LightArrays fields, 'const_emission' may
    be None; 'bvh' None or {'clusters': dict}, 'instanced' and 'unified'
    None or dicts of fields, any of the three may be missing); tables:
    name -> numpy table (e.g. 'ggx_dielectric_s'). Returns (SceneArrays,
    {name: float32 tensor})."""

    def dev(a, dtype):
        return torch.as_tensor(np.array(a, dtype), device=device)

    fields = {}
    for name in SceneArrays._fields:
        v = arrays.get(name) if name in _ACCEL_FIELDS else arrays[name]
        if name in _ACCEL_FIELDS and v is None:
            fields[name] = None
        elif name == "bvh":
            fields[name] = {"clusters": cluster_arrays_from_numpy(v["clusters"], device)}
        elif name == "instanced":
            fields[name] = instanced_arrays_from_numpy(v, device)
        elif name == "unified":
            fields[name] = cluster_arrays_from_numpy(v, device)
        elif name == "param_mats":
            fields[name] = tuple(dev(m, np.float32) for m in v)
        elif name == "lights":
            lights = {
                k: (None if x is None else np.asarray(x, np.int32 if k in (
                    "sel_alias", "tri_alias", "tri_ids", "offset", "count", "tri_light_id"
                ) else np.float32))
                for k, x in v.items()
            }
            fields[name] = LightArrays.from_numpy(
                {k: x for k, x in lights.items() if x is not None}, device
            )
        elif name == "const_emission" and v is None:
            fields[name] = None
        else:
            fields[name] = dev(v, np.int32 if name in _INT_FIELDS else np.float32)
    return SceneArrays(**fields), {k: dev(t, np.float32) for k, t in tables.items()}
