"""Scene-description model: the reference's scenegraph JSON schema.

Schema source: crates/akari_scenegraph/src/scene.rs (Scene/Buffer/BufferView/
Transform/Camera serde model) and shader.rs (ShaderGraph/ShaderNode).
We keep the JSON dicts as-is and layer typed accessors + buffer resolution on
top — the scene file format is identical, so reference scenes load verbatim.
"""
from __future__ import annotations

import base64
import json
import os
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


@dataclass
class SceneGraph:
    """Parsed scene.json + resolved binary buffers."""

    raw: dict
    scene_dir: Path
    _buffers: dict = field(default_factory=dict)

    # ---- collections ----
    @property
    def camera(self) -> dict | None:
        return self.raw.get("camera")

    @property
    def instances(self) -> dict:
        return self.raw.get("instances", {})

    @property
    def geometries(self) -> dict:
        return self.raw.get("geometries", {})

    @property
    def materials(self) -> dict:
        return self.raw.get("materials", {})

    @property
    def lights(self) -> dict:
        return self.raw.get("lights", {})

    # ---- buffers ----
    def buffer_bytes(self, buffer_id: str) -> bytes:
        """Load a Buffer node (scene.rs:96-109) as bytes, cached."""
        if buffer_id in self._buffers:
            return self._buffers[buffer_id]
        node = self.raw["buffers"][buffer_id]
        t = node["type"]
        if t == "binary":
            data = bytes(node["data"])
        elif t == "base64":
            data = base64.b64decode(node["data"] + "==")  # tolerate unpadded
        elif t == "path":
            data = self._read_path_buffer(node)
        else:
            raise ValueError(f"unsupported buffer type: {t}")
        if "length" in node:
            assert len(data) == int(node["length"]), (
                f"buffer {buffer_id}: size mismatch {len(data)} != {node['length']}"
            )
        self._buffers[buffer_id] = data
        return data

    def _read_path_buffer(self, node: dict) -> bytes:
        """Resolve a Path buffer.

        Reference scenes store absolute paths from the exporting machine
        (e.g. Windows \\?\\ paths in scenes/cbox/scene.json); the reference's
        MmapScene::open resolves against the scene directory. We try:
        the path as-is, relative to scene dir, then basename in scene dir.
        """
        p = node["path"]
        # strip Windows long-path prefix
        if p.startswith("\\\\?\\"):
            p = p[4:]
        candidates = [Path(p)]
        posix = p.replace("\\", "/")
        candidates.append(self.scene_dir / posix)
        candidates.append(self.scene_dir / os.path.basename(posix))
        for c in candidates:
            if c.is_file():
                return c.read_bytes()
        raise FileNotFoundError(f"buffer file not found: {node['path']} (tried {candidates})")

    def buffer_view(self, view_ref: dict | str, dtype, components: int | None = None) -> np.ndarray:
        """Read a BufferView (scene.rs:111-117) as a numpy array."""
        view_id = view_ref["id"] if isinstance(view_ref, dict) else view_ref
        view = self.raw["buffer_views"][view_id]
        data = self.buffer_bytes(view["buffer"]["id"])
        off, length = int(view["offset"]), int(view["length"])
        arr = np.frombuffer(data, dtype=dtype, count=length // np.dtype(dtype).itemsize, offset=off)
        if components is not None:
            arr = arr.reshape(-1, components)
        return arr

    # ---- geometry ----
    def mesh_arrays(self, geometry_id: str) -> dict:
        """Load a mesh geometry's vertex data (ref load.rs:494-530)."""
        g = self.geometries[geometry_id]
        assert g["type"] == "mesh", f"unsupported geometry type {g['type']}"
        out = {
            "vertices": self.buffer_view(g["vertices"], np.float32, 3),
            "indices": self.buffer_view(g["indices"], np.uint32, 3),
            "materials": self.buffer_view(g["materials"], np.uint32),
        }
        out["normals"] = (
            self.buffer_view(g["normals"], np.float32, 3) if g.get("normals") else None
        )
        out["uvs"] = self.buffer_view(g["uvs"], np.float32, 2) if g.get("uvs") else None
        out["tangents"] = (
            self.buffer_view(g["tangents"], np.float32, 3) if g.get("tangents") else None
        )
        return out


def load_scene_json(path: str | Path) -> SceneGraph:
    path = Path(path)
    raw = json.loads(path.read_text())
    return SceneGraph(raw=raw, scene_dir=path.parent)


# ---- transforms (ref load.rs:129-171) ----------------------------------------
def _rot_axis(axis: np.ndarray, angle: float) -> np.ndarray:
    """4x4 rotation about a unit axis (matches glam Mat4::from_axis_angle)."""
    x, y, z = axis
    c, s = np.cos(angle), np.sin(angle)
    C = 1 - c
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = [
        [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, z * z * C + c],
    ]
    return m


def load_transform(t: dict, is_camera: bool) -> np.ndarray:
    """Build the 4x4 object-to-world matrix (ref load.rs:129-171).

    TRS with Blender coordinates gets the Blender->Akari (Z-up -> Y-up)
    conversion baked in, exactly like the reference; `matrix` transforms are
    taken verbatim (row-major in JSON).
    """
    X = np.array([1.0, 0.0, 0.0])
    Y = np.array([0.0, 1.0, 0.0])
    Z = np.array([0.0, 0.0, 1.0])
    if t["type"] == "matrix":
        return np.array(t["data"], dtype=np.float64)
    assert t["type"] == "trs"
    d = t["data"]
    tr = np.asarray(d["translation"], np.float64)
    r = np.asarray(d["rotation"], np.float64)
    s = np.asarray(d["scale"], np.float64)
    coord = d.get("coordinate_system", "Akari")
    m = np.eye(4)
    if not is_camera:
        sc = np.eye(4)
        sc[0, 0], sc[1, 1], sc[2, 2] = s
        m = sc @ m
    if coord == "Akari":
        m = _rot_axis(Z, r[2]) @ m
        m = _rot_axis(X, r[0]) @ m
        m = _rot_axis(Y, r[1]) @ m
        tm = np.eye(4)
        tm[:3, 3] = tr
        m = tm @ m
    elif coord == "Blender":
        if is_camera:
            # Blender camera looks down -Z(Blender) == down; pre-rotate
            m = _rot_axis(X, -np.pi / 2) @ m
        m = _rot_axis(X, r[0]) @ m
        m = _rot_axis(Z, -r[1]) @ m
        m = _rot_axis(Y, r[2]) @ m
        tm = np.eye(4)
        tm[:3, 3] = [tr[0], tr[2], -tr[1]]
        m = tm @ m
    else:
        raise ValueError(f"unknown coordinate system {coord}")
    return m
