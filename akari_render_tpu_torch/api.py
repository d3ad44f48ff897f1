"""Scene import API: the JSON command protocol used by the Blender exporter
(a copy of akari_render_tpu/api.py over the port's SceneBuilder).

Reference: crates/akari_render/src/api.rs:11-115 (SceneImportApi enum
executed against a thread-local scenegraph Scene) exposed to Blender through
a C ABI (`py_akari_import`). Here the API is a plain Python class the
exporter calls in-process; arrays travel as numpy (the reference's raw
DNA-pointer `ExtSlice` trick is deliberately not ported — SURVEY.md §7.4).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .scenegraph.write import SceneBuilder


class SceneImportApi:
    """Command-style scene assembly; one instance per import session."""

    def __init__(self):
        self.builder = SceneBuilder()

    # commands (mirroring api.rs variants)
    def init(self):
        self.builder = SceneBuilder()

    def import_mesh(self, name, vertices, indices, normals=None, uvs=None,
                    tangents=None, materials=None):
        return self.builder.add_mesh(
            name, vertices, indices, normals=normals, uvs=uvs,
            tangents=tangents, materials=materials,
        )

    def import_material(self, name, shader_graph: dict):
        return self.builder.add_material(name, shader_graph)

    def import_instance(self, name, geometry, matrix, materials):
        return self.builder.add_instance(name, geometry, matrix, materials)

    def import_camera(self, **kwargs):
        self.builder.set_camera_perspective(**kwargs)

    def write_scene(self, out_dir, compact=True) -> str:
        return str(self.builder.write(out_dir, compact=compact))

    # JSON dispatch (the reference's serde-tagged command envelope)
    def execute(self, command: dict):
        t = command["type"]
        if t == "init":
            self.init()
            return {}
        if t == "import_mesh":
            args = dict(command["data"])
            for k in ("vertices", "indices", "normals", "uvs", "tangents", "materials"):
                if args.get(k) is not None:
                    args[k] = np.asarray(args[k])
            return {"id": self.import_mesh(**args)}
        if t == "import_material":
            return {"id": self.import_material(**command["data"])}
        if t == "import_instance":
            return {"id": self.import_instance(**command["data"])}
        if t == "import_camera":
            self.import_camera(**command["data"])
            return {}
        if t == "write_scene":
            return {"path": self.write_scene(**command["data"])}
        raise ValueError(f"unknown api command: {t}")
