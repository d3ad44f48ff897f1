"""Shader-graph compiler: Cycles-subset ShaderGraph JSON -> SVM bytecode.

Mirrors crates/akari_render/src/svm/compiler.rs: walks the graph from the
output node, emits a linear SSA-ish node list per material, moves all leaf
constants into a per-material data block, and dedupes identical bytecode into
"shader kinds" — polymorphism by compile-time enumeration. Each material gets
a ShaderRef(kind, data_offset).

Differences from the reference (deliberate):
- the data table is float32-indexed (not a byte buffer) — XLA gathers want
  typed arrays;
- Math / MixBsdf / PerlinNoise nodes are implemented (the reference compiler
  `todo!()`s them — compiler.rs:163-165, 258-262).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

_PRINCIPLED_INPUTS = [
    "base_color",
    "metallic",
    "roughness",
    "ior",
    "alpha",
    "normal",
    "specular_ior_level",
    "specular_tint",
    "transmission_weight",
    "coat_weight",
    "coat_roughness",
    "coat_ior",
    "coat_tint",
    "coat_normal",
    "emission_color",
    "emission_strength",
    "sheen_weight",
    "sheen_tint",
    "subsurface_weight",
    "anisotropic",
    "anisotropic_rotation",
]


@dataclass
class CompiledKind:
    """One deduplicated shader variant: a static node program."""

    nodes: tuple  # tuple of node tuples; hashable
    output: int  # index of the output node


@dataclass
class ShaderRef:
    kind: int
    data_offset: int  # float index into the global data table


@dataclass
class CompilerDriver:
    """Dedupes compiled graphs into kinds; packs constants (compiler.rs:16-76).

    TPU layout: instead of the reference's one byte-buffer + per-material
    byte offsets (read with per-lane gathers), constants live in per-kind
    dense matrices [num_materials, kind_width]. At shading time one
    one-hot(material_id) matmul fetches ALL of a lane's constants at once —
    an MXU op instead of dozens of gathers.
    """

    kinds: dict[tuple, int] = field(default_factory=dict)
    kind_list: list[CompiledKind] = field(default_factory=list)
    material_consts: list[tuple[int, list[float]]] = field(default_factory=list)

    def compile(self, graph: dict, images: dict | None = None) -> ShaderRef:
        c = _Compiler(graph, images or {})
        bytecode, consts = c.run()
        key = bytecode
        if key not in self.kinds:
            self.kinds[key] = len(self.kind_list)
            self.kind_list.append(CompiledKind(nodes=bytecode, output=len(bytecode) - 1))
        kind = self.kinds[key]
        mat_index = len(self.material_consts)
        self.material_consts.append((kind, consts))
        return ShaderRef(kind=kind, data_offset=mat_index)

    def param_matrices(self) -> list[np.ndarray]:
        """Per-kind [num_materials, kind_width] constant matrices (rows of
        other kinds are zero; they're masked out at dispatch)."""
        n_mats = len(self.material_consts)
        out = []
        for k, kind in enumerate(self.kind_list):
            width = max(
                (len(c) for kk, c in self.material_consts if kk == k), default=1
            )
            m = np.zeros((max(n_mats, 1), max(width, 1)), np.float32)
            for mi, (kk, consts) in enumerate(self.material_consts):
                if kk == k:
                    m[mi, : len(consts)] = consts
            out.append(m)
        return out


class _Compiler:
    def __init__(self, graph: dict, images: dict):
        self.graph = graph["nodes"]
        self.output_ref = graph["output"]["id"]
        self.images = images  # (image key) -> texture index
        self.env: dict[str, int] = {}
        self.nodes: list[tuple] = []
        self.consts: list[float] = []

    def run(self):
        self.compile_node(self.output_ref)
        return tuple(self.nodes), self.consts

    def push(self, node: tuple) -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1

    def push_data(self, *values) -> int:
        off = len(self.consts)
        self.consts.extend(float(v) for v in values)
        return off

    def compile_node(self, ref: str) -> int:
        if ref in self.env:
            return self.env[ref]
        node = self.graph[ref]
        t = node["type"]
        if t == "float":
            out = ("float", self.push_data(node["value"]))
        elif t == "float3":
            out = ("float3", self.push_data(*node["value"]))
        elif t == "float4":
            out = ("float4", self.push_data(*node["value"]))
        elif t == "rgb":
            data = self.push(("float3", self.push_data(*node["value"])))
            out = ("rgb", data, node.get("colorspace", "srgb"))
        elif t == "spectral_uplift":
            out = ("uplift", self.compile_node(node["rgb"]["id"]))
        elif t == "math":
            out = (
                "math",
                node["op"],
                self.compile_node(node["first"]["id"]),
                self.compile_node(node["second"]["id"]),
            )
        elif t == "image":
            img = node["image"]
            key = _image_key(img)
            tex_idx = self.images.get(key, 0)
            uv = self.compile_node(node["uv"]["id"]) if node.get("uv") else None
            out = (
                "image",
                self.push_data(tex_idx),
                img.get("colorspace", "srgb"),
                uv,
                img.get("extension", "repeat"),
                img.get("interpolation", "linear"),
            )
        elif t == "noise":
            out = ("noise", int(node["dim"]), self.compile_node(node["scale"]["id"]))
        elif t == "checkerboard":
            out = (
                "checker",
                self.compile_node(node["vector"]["id"]) if node.get("vector") else None,
                self.compile_node(node["scale"]["id"]),
                self.compile_node(node["color1"]["id"]),
                self.compile_node(node["color2"]["id"]),
            )
        elif t == "mapping":
            out = (
                "mapping",
                node["mapping"],
                self.compile_node(node["vector"]["id"]),
                self.compile_node(node["location"]["id"]),
                self.compile_node(node["rotation"]["id"]),
                self.compile_node(node["scale"]["id"]),
            )
        elif t == "texcoords":
            out = ("texcoords",)
        elif t == "separate_color":
            out = ("separate_color", node.get("mode", "rgb"), self.compile_node(node["color"]["id"]))
        elif t == "extract":
            out = ("extract", self.compile_node(node["node"]["id"]), node["field"])
        elif t == "normal_map":
            out = (
                "normal_map",
                self.compile_node(node["normal"]["id"]),
                self.compile_node(node["strength"]["id"]),
                node.get("space", "tangent"),
            )
        elif t == "diffuse":
            out = ("diffuse", self.compile_node(node["color"]["id"]))
        elif t == "emission":
            out = (
                "emission",
                self.compile_node(node["color"]["id"]),
                self.compile_node(node["strength"]["id"]),
            )
        elif t == "glass":
            c = self.compile_node(node["color"]["id"])
            # "dispersion": optional Cauchy B coefficient (um^2), a schema
            # extension past the reference (glass.rs has a fixed ior; its
            # spectral eval is todo!()). eta(lambda) = eta_d + B*(1/l^2 -
            # 1/0.5876^2), anchored so the scene's ior holds at the d line.
            # Plain float (not a socket): it must stay a trace-time constant
            # so the spectral path can collapse to the hero wavelength.
            out = ("glass", c, c, self.compile_node(node["ior"]["id"]),
                   self.compile_node(node["roughness"]["id"]),
                   float(node.get("dispersion", 0.0)))
        elif t == "plastic":
            # scenegraph schema: kd/ks/eta/roughness (shader.rs:161-167);
            # optional sigma_a/thickness extend it to the full Tungsten model
            # the reference's PlasticBsdf implements (svm/mod.rs:91-97)
            out = (
                "plastic",
                self.compile_node(node["kd"]["id"]),
                self.compile_node(node["ks"]["id"]),
                self.compile_node(node["eta"]["id"]),
                self.compile_node(node["roughness"]["id"]),
                self.compile_node(node["sigma_a"]["id"]) if "sigma_a" in node else -1,
                self.compile_node(node["thickness"]["id"]) if "thickness" in node else -1,
            )
        elif t == "metal":
            out = ("metal", node["eta"], self.compile_node(node["roughness"]["id"]))
        elif t == "mix":
            out = (
                "mix_bsdf",
                self.compile_node(node["first"]["id"]),
                self.compile_node(node["second"]["id"]),
                self.compile_node(node["factor"]["id"]),
            )
        elif t == "principled":
            inputs = tuple(
                (name, self.compile_node(node[name]["id"])) for name in _PRINCIPLED_INPUTS if name in node
            )
            out = ("principled", inputs)
        elif t == "output":
            out = ("output", self.compile_node(node["node"]["id"]))
        else:
            raise NotImplementedError(f"shader node type: {t}")
        idx = self.push(out)
        self.env[ref] = idx
        return idx


def _image_key(img: dict):
    data = img.get("data")
    data_id = data.get("id") if isinstance(data, dict) else str(data)
    return (
        data_id,
        img.get("format"),
        img.get("extension"),
        img.get("interpolation"),
        img.get("width"),
        img.get("height"),
        img.get("channels"),
    )
