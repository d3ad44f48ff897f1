"""Alpha-tested fixtures written with the port's scenegraph/write.py: quads
with an image base color of one alpha in front of a solid wall, as the JAX
package's tests/test_scene.py builds them (its quad and principled graph,
tools/make_test_scene.py), and the rays it shoots at them. Shared by the
CPU tests (tests/test_torch_alpha.py), the card's tests
(tests/test_torch_gpu.py) and chip_smoke.py. Imports no jax."""
import io

import numpy as np
from PIL import Image

from akari_render_tpu_torch.scenegraph.write import SceneBuilder


def _quad(b, name, z):
    v = np.asarray([(-2, -2, z), (2, -2, z), (2, 2, z), (-2, 2, z)], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.uint32)
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]], np.float32)
    b.add_mesh(name, v, idx, uvs=uv)


def _principled(base_color) -> dict:
    """tools/make_test_scene.py's principled graph at roughness 0.8; base_color
    is an rgb triple or the id of an image node in `extra`."""
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
        return const({"type": "spectral_uplift", "rgb": const(
            {"type": "rgb", "value": [float(x) for x in v], "colorspace": "srgb"})})

    if isinstance(base_color, dict):
        nodes.update(base_color["nodes"])
        bc = const({"type": "spectral_uplift", "rgb": {"id": base_color["id"]}})
    else:
        bc = spec(base_color)
    nodes["bsdf"] = {
        "type": "principled", "preference": "mix", "base_color": bc, "metallic": f(0.0),
        "roughness": f(0.8), "ior": f(1.45), "alpha": f(1.0), "normal": f3((0, 0, 0)),
        "subsurface_weight": f(0.0), "subsurface_radius": f3((1, 0.2, 0.1)),
        "subsurface_scale": f(0.05), "subsurface_anisotropy": f(0.0),
        "specular_ior_level": f(0.5), "specular_tint": spec((1, 1, 1)),
        "anisotropic": f(0.0), "anisotropic_rotation": f(0.0), "tangent": f3((0, 0, 0)),
        "transmission_weight": f(0.0), "sheen_weight": f(0.0), "sheen_tint": spec((1, 1, 1)),
        "coat_weight": f(0.0), "coat_roughness": f(0.03), "coat_ior": f(1.5),
        "coat_tint": spec((1, 1, 1)), "coat_normal": f3((0, 0, 0)),
        "emission_color": spec((1, 1, 1)), "emission_strength": f(0.0),
    }
    nodes["out"] = {"type": "output", "node": {"id": "bsdf"}}
    return {"nodes": nodes, "output": {"id": "out"}, "kind": "surface"}


def write_alpha_scene(out_dir, alpha8: int, sheets: int = 1) -> str:
    """`sheets` quads at z = 0, -0.1, ... whose base color is an 8x8 image
    of alpha alpha8/255 (triangles 0 .. 2 sheets - 1), in front of a solid
    wall at z = -1 (one sheet) or -2 (the last two triangles). Returns the
    scene.json path."""
    b = SceneBuilder()
    for i in range(sheets):
        _quad(b, f"s{i}", -0.1 * i)
    _quad(b, "wall", -1.0 if sheets == 1 else -2.0)
    rgba = np.full((8, 8, 4), 255, np.uint8)
    rgba[..., 3] = alpha8
    buf = io.BytesIO()
    Image.fromarray(rgba).save(buf, format="PNG")
    view = b.add_array("tex.a", np.frombuffer(buf.getvalue(), np.uint8))
    image = {"type": "image", "image": {
        "data": view, "extension": "repeat", "interpolation": "linear", "colorspace": "srgb",
        "format": "png", "width": 8, "height": 8, "channels": 4}}
    b.add_material("amat", _principled({"nodes": {"tex": image}, "id": "tex"}))
    b.add_material("solid", _principled((0.5, 0.5, 0.5)))
    eye = np.eye(4).tolist()
    for i in range(sheets):
        b.add_instance(f"s{i}_i", f"s{i}", eye, ["amat"])
    b.add_instance("wall_i", "wall", eye, ["solid"])
    b.set_camera_perspective(transform_matrix=np.eye(4), width=8, height=8)
    return str(b.write(f"{out_dir}/alpha{alpha8}_{sheets}", compact=True))


def alpha_rays(n: int, seed: int, span: float):
    """n rays from z = 5 straight down -z at seeded (x, y) in [-span, span]^2:
    numpy (o, d, tmin, tmax)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-span, span, (n, 2)).astype(np.float32)
    o = np.concatenate([xy, np.full((n, 1), 5.0, np.float32)], -1)
    d = np.broadcast_to(np.float32([0.0, 0.0, -1.0]), (n, 3)).copy()
    return o, d, np.zeros(n, np.float32), np.full(n, 1e8, np.float32)
