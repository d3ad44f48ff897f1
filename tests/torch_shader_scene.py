"""The shader-ops fixture, written with the port's scenegraph/write.py: a
room lit from its ceiling, its back wall a noise-textured mix of a rough
plastic and gold (Perlin noise in 2D, 3D and 4D), its floor an absorbing
plastic whose roughness follows 1D noise, its side walls copper and a
diffuse, and in its middle a tilted panel of a principled BSDF with every
lobe on (metallic, transmission, coat, a specular level off 0.5), which
AKR_FUSED_PRINCIPLED=0 builds as the combinator tree. Shared by the CPU
tests (tests/test_torch_shader_ops.py), the card's tests
(tests/test_torch_gpu.py) and chip_smoke.py. Imports no jax."""
import numpy as np

from akari_render_tpu_torch.scenegraph.write import SceneBuilder


class _Graph:
    """A shader graph under construction: constant nodes get fresh ids."""

    def __init__(self):
        self.nodes = {}

    def add(self, d) -> dict:
        name = f"$n{len(self.nodes)}"
        self.nodes[name] = d
        return {"id": name}

    def f(self, v):
        return self.add({"type": "float", "value": float(v)})

    def f3(self, v):
        return self.add({"type": "float3", "value": [float(x) for x in v]})

    def color(self, v):
        return self.add({"type": "spectral_uplift", "rgb": self.add(
            {"type": "rgb", "value": [float(x) for x in v], "colorspace": "srgb"})})

    def noise(self, dim: int, scale: float):
        return self.add({"type": "noise", "dim": dim, "scale": self.f(scale)})

    def math(self, op, a, b):
        return self.add({"type": "math", "op": op, "first": a, "second": b})

    def plastic(self, kd, roughness, sigma_a=None, thickness=None):
        d = {"type": "plastic", "kd": self.color(kd), "ks": self.color((1, 1, 1)),
             "eta": self.f(1.5), "roughness": roughness}
        if sigma_a is not None:
            d.update(sigma_a=self.color(sigma_a), thickness=self.f(thickness))
        return self.add(d)

    def metal(self, eta: str, roughness):
        return self.add({"type": "metal", "eta": eta, "roughness": roughness})

    def done(self, bsdf) -> dict:
        self.nodes["out"] = {"type": "output", "node": bsdf}
        return {"nodes": self.nodes, "output": {"id": "out"}, "kind": "surface"}


def _noise_wall() -> dict:
    g = _Graph()
    rough = g.math("add", g.math("mul", g.noise(3, 3.0), g.f(0.5)), g.f(0.05))
    plastic = g.plastic((0.7, 0.3, 0.2), rough)
    gold = g.metal("Au", g.math("add", g.math("mul", g.noise(4, 2.0), g.f(0.4)), g.f(0.1)))
    return g.done(g.add({"type": "mix", "first": plastic, "second": gold,
                         "factor": g.noise(2, 6.0)}))


def _absorbing_floor() -> dict:
    g = _Graph()
    rough = g.math("add", g.math("mul", g.noise(1, 8.0), g.f(0.3)), g.f(0.1))
    return g.done(g.plastic((0.2, 0.5, 0.3), rough, sigma_a=(0.5, 0.2, 0.1), thickness=0.5))


def _metal(eta: str, roughness: float) -> dict:
    g = _Graph()
    return g.done(g.metal(eta, g.f(roughness)))


def _diffuse(rgb) -> dict:
    g = _Graph()
    return g.done(g.add({"type": "diffuse", "color": g.color(rgb)}))


def principled_graph(base, estrength=0.0, **lobes) -> dict:
    """A principled BSDF graph: base colour, emission strength, other lobes
    by name (metallic, roughness, ior, transmission_weight,
    specular_ior_level, coat_weight, coat_roughness, coat_ior)."""
    g = _Graph()
    p = dict(metallic=0.0, roughness=0.5, ior=1.45, transmission_weight=0.0,
             specular_ior_level=0.5, coat_weight=0.0, coat_roughness=0.03, coat_ior=1.5)
    p.update(lobes)
    bsdf = g.add({
        "type": "principled", "preference": "mix", "base_color": g.color(base),
        "metallic": g.f(p["metallic"]), "roughness": g.f(p["roughness"]),
        "ior": g.f(p["ior"]), "alpha": g.f(1.0), "normal": g.f3((0, 0, 0)),
        "subsurface_weight": g.f(0.0), "subsurface_radius": g.f3((1, 0.2, 0.1)),
        "subsurface_scale": g.f(0.05), "subsurface_anisotropy": g.f(0.0),
        "specular_ior_level": g.f(p["specular_ior_level"]),
        "specular_tint": g.color((1, 0.9, 0.8)), "anisotropic": g.f(0.0),
        "anisotropic_rotation": g.f(0.0), "tangent": g.f3((0, 0, 0)),
        "transmission_weight": g.f(p["transmission_weight"]), "sheen_weight": g.f(0.0),
        "sheen_tint": g.color((1, 1, 1)), "coat_weight": g.f(p["coat_weight"]),
        "coat_roughness": g.f(p["coat_roughness"]), "coat_ior": g.f(p["coat_ior"]),
        "coat_tint": g.color((0.9, 1.0, 0.8)), "coat_normal": g.f3((0, 0, 0)),
        "emission_color": g.color((1, 1, 1)), "emission_strength": g.f(estrength),
    })
    return g.done(bsdf)


def _quad(b, name, a, c, d, e):
    v = np.asarray([a, c, d, e], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.uint32)
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]], np.float32)
    b.add_mesh(name, v, idx, uvs=uv)


def write_shader_scene(out_dir, res: int = 16) -> str:
    """Write the fixture at res x res under out_dir; returns the scene.json
    path. Materials: noise_wall (back), floor, copper (left), white (right,
    ceiling), panel (principled, every lobe), light."""
    b = SceneBuilder()
    s = 2.0
    _quad(b, "floor", (-s, 0, -s), (-s, 0, s), (s, 0, s), (s, 0, -s))
    _quad(b, "ceiling", (-s, 2 * s, -s), (s, 2 * s, -s), (s, 2 * s, s), (-s, 2 * s, s))
    _quad(b, "back", (-s, 0, -s), (s, 0, -s), (s, 2 * s, -s), (-s, 2 * s, -s))
    _quad(b, "left", (-s, 0, s), (-s, 0, -s), (-s, 2 * s, -s), (-s, 2 * s, s))
    _quad(b, "right", (s, 0, -s), (s, 0, s), (s, 2 * s, s), (s, 2 * s, -s))
    _quad(b, "light", (-0.6, 2 * s - 0.01, -0.6), (0.6, 2 * s - 0.01, -0.6),
          (0.6, 2 * s - 0.01, 0.6), (-0.6, 2 * s - 0.01, 0.6))
    _quad(b, "panel", (-0.9, 0.3, -0.2), (0.7, 0.3, -0.9), (0.7, 2.2, -0.9), (-0.9, 2.2, -0.2))
    b.add_material("noise_wall", _noise_wall())
    b.add_material("floor", _absorbing_floor())
    b.add_material("copper", _metal("Cu", 0.25))
    b.add_material("white", _diffuse((0.7, 0.7, 0.7)))
    b.add_material("panel", principled_graph((0.8, 0.4, 0.2), metallic=0.4, roughness=0.35,
                                        transmission_weight=0.3, specular_ior_level=0.3,
                                        coat_weight=0.5, coat_roughness=0.1))
    b.add_material("light", principled_graph((1, 1, 1), estrength=15.0))
    eye = np.eye(4).tolist()
    for geo, mat in (("floor", "floor"), ("ceiling", "white"), ("back", "noise_wall"),
                     ("left", "copper"), ("right", "white"), ("light", "light"),
                     ("panel", "panel")):
        b.add_instance(f"{geo}_i", geo, eye, [mat])
    # Blender TRS (z-up) -> renderer (x, z, -y): the camera at (0, 2, 6.5)
    # looking down -z into the room
    b.set_camera_perspective(
        trs={"translation": [0.0, -6.5, 2.0], "rotation": [np.pi / 2, 0.0, 0.0],
             "scale": [1.0, 1.0, 1.0], "coordinate_system": "Blender"},
        fov_deg=40.0, width=res, height=res)
    return str(b.write(f"{out_dir}/shader_ops", compact=True))
