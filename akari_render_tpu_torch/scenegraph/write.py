"""Scene serialization: build + write scenegraph JSON and binary buffers
(a copy of akari_render_tpu/scenegraph/write.py, numpy only).

Reference: crates/akari_scenegraph/src/scene.rs — Buffer::write_to_file /
embed / compact() (scene.rs:462-553). Scenes written here load back through
scenegraph/model.py (of either package) AND through the reference's Rust
loader (same schema).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np


class SceneBuilder:
    """Programmatic scene construction (the host-side scene model)."""

    def __init__(self):
        self.doc = {
            "camera": None,
            "instances": {},
            "geometries": {},
            "materials": {},
            "lights": {},
            "buffers": {},
            "buffer_views": {},
        }
        self._buffers: dict[str, bytes] = {}
        self._view_count = 0

    # ---- buffers ----
    def add_buffer(self, name: str, data: bytes) -> str:
        self.doc["buffers"][name] = {"type": "binary", "data": None}  # placeholder
        self._buffers[name] = bytes(data)
        return name

    def add_view(self, buffer: str, offset: int, length: int) -> dict:
        vid = f"buf_view_{self._view_count}"
        self._view_count += 1
        self.doc["buffer_views"][vid] = {
            "buffer": {"id": buffer},
            "offset": offset,
            "length": length,
        }
        return {"id": vid}

    def add_array(self, name: str, arr: np.ndarray) -> dict:
        """Store one numpy array as its own buffer + full view."""
        data = np.ascontiguousarray(arr).tobytes()
        self.add_buffer(name, data)
        return self.add_view(name, 0, len(data))

    # ---- scene objects ----
    def add_mesh(self, name, vertices, indices, normals=None, uvs=None,
                 tangents=None, materials=None) -> str:
        """Arrays follow the reference layout: vertices [V,3] f32, indices
        [T,3] u32, normals/uvs/tangents per-corner [3T,*], materials u32."""
        g = {
            "type": "mesh",
            "vertices": self.add_array(f"{name}.vert", np.asarray(vertices, np.float32)),
            "indices": self.add_array(f"{name}.ind", np.asarray(indices, np.uint32)),
            "normals": self.add_array(f"{name}.normal", np.asarray(normals, np.float32))
            if normals is not None
            else None,
            "uvs": self.add_array(f"{name}.uv", np.asarray(uvs, np.float32))
            if uvs is not None
            else None,
            "tangents": self.add_array(f"{name}.tangent", np.asarray(tangents, np.float32))
            if tangents is not None
            else None,
            "materials": self.add_array(
                f"{name}.mat",
                np.asarray(materials if materials is not None else [0], np.uint32),
            ),
        }
        self.doc["geometries"][name] = g
        return name

    def add_material(self, name: str, shader_graph: dict) -> str:
        self.doc["materials"][name] = {"shader": shader_graph}
        return name

    def add_instance(self, name: str, geometry: str, matrix, materials: list[str]) -> str:
        self.doc["instances"][name] = {
            "geometry": {"id": geometry},
            "transform": {"type": "matrix", "data": np.asarray(matrix, float).tolist()},
            "materials": [{"id": m} for m in materials],
        }
        return name

    def set_camera_perspective(self, transform_matrix=None, trs=None, fov_deg=40.0,
                               focal_distance=10.0, fstop=2.8, width=1024, height=1024):
        if trs is not None:
            transform = {"type": "trs", "data": trs}
        else:
            transform = {
                "type": "matrix",
                "data": np.asarray(transform_matrix, float).tolist(),
            }
        self.doc["camera"] = {
            "type": "perspective",
            "data": {
                "transform": transform,
                "fov": float(fov_deg),
                "focal_distance": float(focal_distance),
                "fstop": float(fstop),
                "sensor_width": int(width),
                "sensor_height": int(height),
            },
        }

    # ---- output ----
    def compact(self):
        """Merge all buffers into one (scene.rs:513-553)."""
        merged = bytearray()
        offsets = {}
        for name, data in self._buffers.items():
            # 16-byte alignment like the reference's constant packing
            while len(merged) % 16:
                merged.append(0)
            offsets[name] = len(merged)
            merged.extend(data)
        for view in self.doc["buffer_views"].values():
            old = view["buffer"]["id"]
            view["buffer"] = {"id": "Scene"}
            view["offset"] = int(view["offset"]) + offsets[old]
        self._buffers = {"Scene": bytes(merged)}
        self.doc["buffers"] = {"Scene": None}

    def write(self, out_dir: str | Path, compact: bool = True) -> Path:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        if compact:
            self.compact()
        buffers_doc = {}
        for name, data in self._buffers.items():
            fname = f"{name}.bin"
            (out / fname).write_bytes(data)
            buffers_doc[name] = {
                "type": "path",
                "path": str(out / fname),
                "length": len(data),
            }
        doc = dict(self.doc)
        doc["buffers"] = buffers_doc
        path = out / "scene.json"
        path.write_text(json.dumps(doc))
        return path
