"""Generate the `cbox` fixture: a Cornell box with the reference's layout
(scenes/cbox, read by both packages).

Five walls of a 2 x 2 x 2 box (white floor, ceiling and back, red left,
green right), two white axis-aligned boxes (a tall one at the back left, a
short one at the front right), and a thin ceiling light quad at y = 1.98
emitting the classic Cornell radiance (17, 12, 4). 36 triangles, eight
principled materials with one graph shape (one shader kind), one light, a
Blender camera at (0, -9, 1) looking down the box (Y-up translation (0, 1,
9)), 14 degrees, 1024 x 1024. The wall albedos are the classic Cornell
values; the framing, the light's strip and the boxes' sizes and places are
read off BENCH_MSE_CBOX.gt.exr, a picture of the reference's scene.

    python tools/make_cbox_scene.py [out_dir]   # default scenes/cbox

It writes scene.json and Scene.bin; the method files beside them,
pt.json (the reference's PT configuration: pmj02bn, d12, rr 5, Gaussian
r 1.5, 4096 spp) and aov.json, are kept by hand.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from akari_render_tpu_torch.scenegraph.write import SceneBuilder  # noqa: E402

WHITE = (0.725, 0.71, 0.68)
RED = (0.63, 0.065, 0.05)
GREEN = (0.14, 0.45, 0.091)
LIGHT = (17.0, 12.0, 4.0)  # radiance


def quad(builder, name, a, b, c, d):
    """One quad as two triangles (a, b, c), (a, c, d); its geometric
    normal is (b - a) x (c - a)."""
    v = np.asarray([a, b, c, d], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.uint32)
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]], np.float32)
    builder.add_mesh(name, v, idx, uvs=uv)
    return name


def box(builder, name, lo, hi):
    """An axis-aligned box: six quads in one mesh, normals outward."""
    (x0, y0, z0), (x1, y1, z1) = lo, hi
    faces = [
        [(x0, y1, z0), (x0, y1, z1), (x1, y1, z1), (x1, y1, z0)],  # +y
        [(x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1)],  # -y
        [(x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)],  # +z
        [(x1, y0, z0), (x0, y0, z0), (x0, y1, z0), (x1, y1, z0)],  # -z
        [(x1, y0, z1), (x1, y0, z0), (x1, y1, z0), (x1, y1, z1)],  # +x
        [(x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0)],  # -x
    ]
    v = np.asarray(faces, np.float32).reshape(-1, 3)
    idx = np.asarray([[4 * f, 4 * f + 1, 4 * f + 2] for f in range(6)]
                     + [[4 * f, 4 * f + 2, 4 * f + 3] for f in range(6)], np.uint32)
    uv = np.tile(np.asarray([[0, 0], [1, 0], [1, 1]], np.float32), (12, 1))
    builder.add_mesh(name, v, idx, uvs=uv)
    return name


def principled(base_color, roughness=1.0, emission=(0.0, 0.0, 0.0)):
    """A principled BSDF node graph with constant inputs (the exporter's
    layout); every material of the box has this shape."""
    nodes = {}

    def const(d):
        name = f"$c{len(nodes)}"
        nodes[name] = d
        return {"id": name}

    def f(v):
        return const({"type": "float", "value": float(v)})

    def f3(v):
        return const({"type": "float3", "value": [float(x) for x in v]})

    def spec(v):
        rgb = const({"type": "rgb", "value": [float(x) for x in v], "colorspace": "srgb"})
        return const({"type": "spectral_uplift", "rgb": rgb})

    strength = max(emission)
    nodes["bsdf"] = {
        "type": "principled",
        "preference": "mix",
        "base_color": spec(base_color),
        "metallic": f(0.0),
        "roughness": f(roughness),
        "ior": f(1.45),
        "alpha": f(1.0),
        "normal": f3((0, 0, 0)),
        "subsurface_weight": f(0.0),
        "subsurface_radius": f3((1, 0.2, 0.1)),
        "subsurface_scale": f(0.05),
        "subsurface_anisotropy": f(0.0),
        "specular_ior_level": f(0.5),
        "specular_tint": spec((1, 1, 1)),
        "anisotropic": f(0.0),
        "anisotropic_rotation": f(0.0),
        "tangent": f3((0, 0, 0)),
        "transmission_weight": f(0.0),
        "sheen_weight": f(0.0),
        "sheen_tint": spec((1, 1, 1)),
        "coat_weight": f(0.0),
        "coat_roughness": f(0.03),
        "coat_ior": f(1.5),
        "coat_tint": spec((1, 1, 1)),
        "coat_normal": f3((0, 0, 0)),
        "emission_color": spec([e / strength for e in emission] if strength > 0 else (1, 1, 1)),
        "emission_strength": f(strength),
    }
    nodes["out"] = {"type": "output", "node": {"id": "bsdf"}}
    return {"nodes": nodes, "output": {"id": "out"}, "kind": "surface"}


def build(out_dir: str) -> Path:
    b = SceneBuilder()
    s = 1.0  # half size; the box is y in [0, 2s]
    # walls wound so geometric normals face the interior
    quad(b, "floor", (-s, 0, -s), (-s, 0, s), (s, 0, s), (s, 0, -s))  # +y
    quad(b, "ceiling", (-s, 2 * s, -s), (s, 2 * s, -s), (s, 2 * s, s), (-s, 2 * s, s))  # -y
    quad(b, "back", (-s, 0, -s), (s, 0, -s), (s, 2 * s, -s), (-s, 2 * s, -s))  # +z
    quad(b, "left", (-s, 0, s), (-s, 0, -s), (-s, 2 * s, -s), (-s, 2 * s, s))  # +x
    quad(b, "right", (s, 0, -s), (s, 0, s), (s, 2 * s, s), (s, 2 * s, -s))  # -x
    lx, lz, ly = 0.25, 0.19, 1.98
    quad(b, "lamp", (-lx, ly, -lz), (lx, ly, -lz), (lx, ly, lz), (-lx, ly, lz))  # -y
    box(b, "tall", (-0.6, 0.0, -0.9), (0.0, 1.2, -0.3))
    box(b, "short", (-0.05, 0.0, 0.1), (0.55, 0.6, 0.7))

    mats = {"floor": WHITE, "ceiling": WHITE, "back_wall": WHITE, "left_wall": RED,
            "right_wall": GREEN, "tall_box": WHITE, "short_box": WHITE}
    for name, color in mats.items():
        b.add_material(name, principled(color))
    b.add_material("light", principled((0.0, 0.0, 0.0), emission=LIGHT))

    eye = np.eye(4).tolist()
    for inst, geom, mat in (("floor_i", "floor", "floor"), ("ceiling_i", "ceiling", "ceiling"),
                            ("back_i", "back", "back_wall"), ("left_i", "left", "left_wall"),
                            ("right_i", "right", "right_wall"), ("lamp_i", "lamp", "light"),
                            ("tall_i", "tall", "tall_box"), ("short_i", "short", "short_box")):
        b.add_instance(inst, geom, eye, [mat])

    b.set_camera_perspective(
        trs={
            "translation": [0.0, -9.0, 1.0],
            "rotation": [np.pi / 2, 0.0, 0.0],
            "scale": [1.0, 1.0, 1.0],
            "coordinate_system": "Blender",
        },
        fov_deg=14.0,
        width=1024,
        height=1024,
    )
    return b.write(out_dir, compact=True)


if __name__ == "__main__":
    print(build(sys.argv[1] if len(sys.argv) > 1 else "scenes/cbox"))
