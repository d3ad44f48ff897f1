"""The reference's own reading of a scene.json: world-space triangles, which
of them emit (and how much), the instances, and the pinhole camera.

Written from the scene format's semantics (AkariRender's scenegraph: buffers
and buffer views, mesh geometries, instances with a matrix or a TRS
transform, the Blender-to-Y-up conversion, principled and emission nodes),
not from the renderer under test: it imports nothing of it and takes no
table it has made. Only what the comparison needs is read: geometry,
constant emission, the constant principled BSDFs the path tracer of
render.py knows, and the camera.
"""
from __future__ import annotations

import base64
import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class RefScene:
    tris: np.ndarray  # [T, 3, 3] float64 world-space vertices
    groups: list  # (first, end) triangle range of each instance
    emission: np.ndarray  # [T, 3] float64 constant emitted radiance (0: none or not constant)
    n_instances: int
    n_unique_tris: int  # triangles of every geometry once (instanced meshes counted once)
    camera: "RefCamera"
    bsdf: np.ndarray  # [T, 6] float64: base colour (3), roughness, ior, specular IOR level
    unshaded: list  # names of the materials render.py cannot shade (see material_bsdf)


@dataclass
class RefCamera:
    c2w: np.ndarray  # [4, 4] float64 camera to world
    width: int
    height: int
    fov: float  # radians, spanning the larger image side

    @property
    def origin(self) -> np.ndarray:
        return self.c2w[:3, 3]

    def scales(self) -> tuple[float, float]:
        """Half extents of the image on the camera's z = -1 plane."""
        s = math.tan(self.fov / 2.0)
        if self.width > self.height:
            return s, s * self.height / self.width
        return s * self.width / self.height, s


def _axis_angle(axis, angle: float) -> np.ndarray:
    x, y, z = axis
    c, s = math.cos(angle), math.sin(angle)
    C = 1.0 - c
    m = np.eye(4)
    m[:3, :3] = [[x * x * C + c, x * y * C - z * s, x * z * C + y * s],
                 [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
                 [z * x * C - y * s, z * y * C + x * s, z * z * C + c]]
    return m


def transform_matrix(t: dict, is_camera: bool) -> np.ndarray:
    """Object to world. A `matrix` is row-major as written; a TRS in the
    Blender system is converted to the renderer's Y-up world (x, z, -y),
    and a Blender camera, which looks down its -Z, is turned to look down
    -Z of the Y-up frame first."""
    if t["type"] == "matrix":
        return np.asarray(t["data"], np.float64)
    d = t["data"]
    tr, r, s = (np.asarray(d[k], np.float64) for k in ("translation", "rotation", "scale"))
    m = np.eye(4)
    if not is_camera:
        m = np.diag([s[0], s[1], s[2], 1.0]) @ m
    if d.get("coordinate_system", "Akari") == "Blender":
        if is_camera:
            m = _axis_angle((1, 0, 0), -math.pi / 2) @ m
        m = _axis_angle((1, 0, 0), r[0]) @ m
        m = _axis_angle((0, 0, 1), -r[1]) @ m
        m = _axis_angle((0, 1, 0), r[2]) @ m
        tr = np.array([tr[0], tr[2], -tr[1]])
    else:
        m = _axis_angle((0, 0, 1), r[2]) @ m
        m = _axis_angle((1, 0, 0), r[0]) @ m
        m = _axis_angle((0, 1, 0), r[1]) @ m
    out = np.eye(4)
    out[:3, 3] = tr
    return out @ m


class _Buffers:
    def __init__(self, raw: dict, scene_dir: Path):
        self.raw, self.dir, self.cache = raw, scene_dir, {}

    def bytes(self, bid: str) -> bytes:
        if bid not in self.cache:
            node = self.raw["buffers"][bid]
            if node["type"] == "path":
                p = Path(node["path"].replace("\\", "/"))
                self.cache[bid] = (self.dir / p.name).read_bytes()
            elif node["type"] == "base64":
                self.cache[bid] = base64.b64decode(node["data"] + "==")
            else:
                self.cache[bid] = bytes(node["data"])
        return self.cache[bid]

    def view(self, ref, dtype, comps: int) -> np.ndarray:
        v = self.raw["buffer_views"][ref["id"]]
        data = self.bytes(v["buffer"]["id"])
        n = int(v["length"]) // np.dtype(dtype).itemsize
        return np.frombuffer(data, dtype, count=n, offset=int(v["offset"])).reshape(-1, comps)


def _const(nodes: dict, ref) -> np.ndarray | None:
    """A node's value when it is a constant (rgb, float, float3, or a
    spectral uplift of one), else None. RGB values are linear in the
    working space, as the format writes them."""
    if ref is None:
        return None
    node = nodes[ref["id"]]
    t = node["type"]
    if t in ("rgb", "float3"):
        return np.asarray(node["value"], np.float64)
    if t == "float":
        return np.full(3, float(node["value"]))
    if t == "spectral_uplift":
        return _const(nodes, node["rgb"])
    return None


def material_emission(material: dict) -> np.ndarray:
    """Constant emitted radiance of a surface material ([3], zeros when it
    does not emit or its emission is not a constant)."""
    shader = material["shader"]
    nodes = shader["nodes"]
    out = nodes[shader["output"]["id"]]
    bsdf = nodes[out["node"]["id"]]
    if bsdf["type"] == "principled":
        color, strength = (_const(nodes, bsdf.get(k)) for k in ("emission_color", "emission_strength"))
    elif bsdf["type"] == "emission":
        color, strength = (_const(nodes, bsdf.get(k)) for k in ("color", "strength"))
    else:
        return np.zeros(3)
    if color is None or strength is None:
        return np.zeros(3)
    return color * strength


# principled inputs that have to hold these constants for material_bsdf
# (the lobes and maps render.py leaves out are then off)
_PRINCIPLED_FIXED = {"metallic": 0.0, "transmission_weight": 0.0, "coat_weight": 0.0,
                     "sheen_weight": 0.0, "subsurface_weight": 0.0, "alpha": 1.0,
                     "anisotropic": 0.0, "normal": 0.0, "specular_tint": 1.0}


def material_bsdf(material: dict) -> np.ndarray | None:
    """[base colour (3), roughness, ior, specular IOR level] of a
    principled material whose inputs are constants and whose metallic,
    transmission, coat, sheen, subsurface, anisotropy and normal map are
    off (alpha 1, specular tint white), else None."""
    shader = material["shader"]
    nodes = shader["nodes"]
    bsdf = nodes[nodes[shader["output"]["id"]]["node"]["id"]]
    if bsdf["type"] != "principled":
        return None
    for key, want in _PRINCIPLED_FIXED.items():
        v = _const(nodes, bsdf.get(key))
        if v is None or not np.all(v == want):
            return None
    vals = [_const(nodes, bsdf.get(k)) for k in ("base_color", "roughness", "ior",
                                                 "specular_ior_level")]
    if any(v is None for v in vals):
        return None
    return np.concatenate([vals[0], [vals[1][0], vals[2][0], vals[3][0]]])


def load(path: str | Path, width: int | None = None, height: int | None = None) -> RefScene:
    path = Path(path)
    raw = json.loads(path.read_text())
    buf = _Buffers(raw, path.parent)
    emit = {name: material_emission(m) for name, m in raw.get("materials", {}).items()}
    shade = {name: material_bsdf(m) for name, m in raw.get("materials", {}).items()}
    unshaded = set()
    geo_cache: dict = {}
    tris, emission, bsdf, groups = [], [], [], []
    first = 0
    for inst in raw["instances"].values():
        gid = inst["geometry"]["id"]
        if gid not in geo_cache:
            g = raw["geometries"][gid]
            if g["type"] != "mesh":
                raise ValueError(f"geometry {gid}: type {g['type']} is not a mesh")
            geo_cache[gid] = (buf.view(g["vertices"], np.float32, 3).astype(np.float64),
                              buf.view(g["indices"], np.uint32, 3).astype(np.int64),
                              buf.view(g["materials"], np.uint32, 1)[:, 0].astype(np.int64))
        verts, idx, mat = geo_cache[gid]
        m = transform_matrix(inst["transform"], is_camera=False)
        world = verts @ m[:3, :3].T + m[:3, 3]
        tris.append(world[idx])
        groups.append((first, first + len(idx)))
        first += len(idx)
        # a slot a triangle for a mesh of several materials, else one slot for all
        slot = mat if len(mat) == len(idx) else np.full(len(idx), mat[0] if len(mat) else 0)
        slots = np.array([emit[s["id"]] for s in inst["materials"]] or [np.zeros(3)])
        slot = np.minimum(slot, len(slots) - 1)
        emission.append(slots[slot])
        params = []
        for s in inst["materials"] or [{"id": None}]:
            if shade.get(s["id"]) is None:
                unshaded.add(str(s["id"]))
            params.append(np.zeros(6) if shade.get(s["id"]) is None else shade[s["id"]])
        bsdf.append(np.array(params)[slot])
    cam = raw["camera"]
    if cam["type"] != "perspective":
        raise ValueError(f"camera type {cam['type']}")
    cd = cam["data"]
    camera = RefCamera(c2w=transform_matrix(cd["transform"], is_camera=True),
                       width=width or int(cd["sensor_width"]),
                       height=height or int(cd["sensor_height"]),
                       fov=math.radians(float(cd["fov"])))
    return RefScene(tris=np.concatenate(tris), groups=groups, emission=np.concatenate(emission),
                    n_instances=len(raw["instances"]),
                    n_unique_tris=sum(len(v[1]) for v in geo_cache.values()),
                    camera=camera, bsdf=np.concatenate(bsdf), unshaded=sorted(unshaded))
