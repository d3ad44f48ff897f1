"""Carry scene state made elsewhere into the port, as plain numpy.

scene_arrays_from_numpy builds the port's SceneArrays (and albedo tables)
from a dict of numpy arrays, for example one made from the JAX package's
SceneArrays with np.asarray, so both packages can compute with the same
scene and the same GGX table. The port never sees a jax object.
"""
from __future__ import annotations

import numpy as np
import torch

from .lights import LightArrays
from .scene import SceneArrays

_INT_FIELDS = ("inst_id", "shader_kind", "tri_mat")


def scene_arrays_from_numpy(arrays: dict, tables: dict, device):
    """arrays: the SceneArrays fields by name ('param_mats' a list of
    matrices, 'lights' a dict of LightArrays fields, 'const_emission' may
    be None); tables: name -> numpy table (e.g. 'ggx_dielectric_s').
    Returns (SceneArrays, {name: float32 tensor})."""

    def dev(a, dtype):
        return torch.as_tensor(np.array(a, dtype), device=device)

    fields = {}
    for name in SceneArrays._fields:
        v = arrays[name]
        if name == "param_mats":
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
