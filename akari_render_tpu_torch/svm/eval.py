"""SVM evaluator: interpret shader bytecode into batched torch ops (port of
akari_render_tpu/svm/eval.py).

Each bytecode node of a kind is evaluated once per call, in SSA order,
over the lanes of that kind; BSDF nodes become Surface combinator trees
(surface.py). Tagged Python values carry the dynamic types.

Every op of the JAX package's compiler is ported: float, float3, float4,
rgb, uplift, math, image, checker, noise, mapping, texcoords,
separate_color, extract, normal_map, output, diffuse, emission, glass
(with its Cauchy dispersion at the hero wavelength in spectral mode),
plastic, metal, mix_bsdf and principled. The principled BSDF is the fused
form unless AKR_FUSED_PRINCIPLED=0 (read at each build, as in the JAX
package) asks for the combinator tree. check_kind still refuses an op that
is not in PORTED_OPS, should the compiler ever emit one.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from .. import stats
from ..core.color import convert_colorspace, srgb_to_linear
from ..core.math import Frame
from ..core.sampling import INV_PI
from .compiler import CompiledKind
from .microfacet import (
    TrowbridgeReitz,
    artistic_to_conductor_fresnel,
    f0_from_ior,
    fr_complex,
    fr_dielectric,
    ior_from_f0,
)
from .precompute import albedo_curve, albedo_curve_np, curve_eval
from .surface import (
    BsdfMixture,
    CoatedBsdf,
    ConductorReflection,
    DiffuseBsdf,
    EmissiveSurface,
    MicrofacetReflection,
    MicrofacetTransmission,
    PlasticBsdf,
    ScaledBsdf,
    Surface,
    SurfaceClosure,
    normal_map,
)

PORTED_OPS = frozenset({
    "float", "float3", "float4", "rgb", "uplift", "math", "image", "checker", "noise",
    "mapping", "texcoords", "separate_color", "extract", "normal_map", "output",
    "diffuse", "emission", "glass", "plastic", "metal", "mix_bsdf", "principled",
})


def check_kind(kind: CompiledKind) -> None:
    """Raise for a kind that uses a shader op the port does not have yet."""
    for node in kind.nodes:
        if node[0] not in PORTED_OPS:
            raise NotImplementedError(f"svm op {node[0]!r} is not yet ported")


class EvalContext(NamedTuple):
    """Per-batch inputs to shader evaluation."""

    params: torch.Tensor  # [N, kind_width] per-lane constants
    uv: torch.Tensor  # [N, 2]
    p: torch.Tensor  # [N, 3] world hit position
    ng: torch.Tensor  # [N, 3] world geometric normal
    frame: tuple  # (t, b, n) world shading frame
    table: torch.Tensor  # [16, 16, 16] GGX dielectric albedo table
    table_np: np.ndarray  # the same table on the host (static-constant path)
    textures: object | None = None  # TextureAtlas or None
    # host [kind_width, 2] min/max of each constant column over the kind's
    # parameter matrix: statically-constant lobes are eliminated
    const_ranges: object = None
    # [N] hero wavelength (nm) in spectral mode, None in RGB mode: a
    # dispersive glass evaluates its IOR there
    lambda0: object = None


# the closure ops: in alpha mode each evaluates to its alpha instead
_CLOSURE_OPS = frozenset({"diffuse", "emission", "glass", "plastic", "metal", "mix_bsdf",
                          "principled"})


class _Evaluator:
    def __init__(self, kind: CompiledKind, ctx: EvalContext, mode: str = "surface"):
        self.kind = kind
        self.ctx = ctx
        self.mode = mode  # "surface" | "alpha"
        self.values: list = [None] * len(kind.nodes)

    def static_const(self, i: int):
        """The value of node i if it is a float constant equal over the
        kind's whole parameter matrix, else None."""
        r = self.ctx.const_ranges
        if r is None:
            return None
        node = self.kind.nodes[i]
        if node[0] == "float":
            lo, hi = float(r[node[1], 0]), float(r[node[1], 1])
            if lo == hi:
                return lo
        return None

    def _get(self, i: int):
        if self.values[i] is None:
            self.values[i] = self._eval(i)
        return self.values[i]

    def f(self, i: int):
        tag, v = self._get(i)
        if tag == "f":
            return v
        if tag in ("f2", "f3", "f4"):
            return v[..., 0]
        if tag == "color":
            return v[0][..., 0]
        raise TypeError(f"cannot convert {tag} to float")

    def f2(self, i: int):
        tag, v = self._get(i)
        if tag == "f2":
            return v
        if tag in ("f3", "f4"):
            return v[..., :2]
        if tag == "f":
            return torch.stack([v, torch.zeros_like(v)], -1)
        raise TypeError(f"cannot convert {tag} to float2")

    def f3(self, i: int):
        tag, v = self._get(i)
        if tag == "f3":
            return v
        if tag == "f4":
            return v[..., :3]
        if tag == "f2":
            return torch.cat([v, torch.zeros_like(v[..., :1])], -1)
        if tag == "f":
            z = torch.zeros_like(v)
            return torch.stack([v, z, z], -1)
        if tag == "color":
            return v[0]
        raise TypeError(f"cannot convert {tag} to float3")

    def f4(self, i: int):
        tag, v = self._get(i)
        if tag == "f4":
            return v
        if tag == "f3":
            return torch.cat([v, torch.ones_like(v[..., :1])], -1)
        raise TypeError(f"cannot convert {tag} to float4")

    def color_alpha(self, i: int):
        tag, v = self._get(i)
        if tag == "color":
            return v
        if tag == "f4":
            return v[..., :3], v[..., 3]
        f3 = self.f3(i)
        return f3, torch.ones(f3.shape[:-1], device=f3.device)

    def color(self, i: int):
        return self.color_alpha(i)[0]

    def surface(self, i: int) -> Surface:
        tag, v = self._get(i)
        if tag != "surface":
            raise TypeError(f"node {i} is {tag}, expected surface")
        return v

    def _eval(self, i: int):
        ctx = self.ctx
        node = self.kind.nodes[i]
        op = node[0]
        if op == "float":
            return "f", ctx.params[..., node[1]]
        if op == "float3":
            return "f3", ctx.params[..., node[1]: node[1] + 3]
        if op == "float4":
            return "f4", ctx.params[..., node[1]: node[1] + 4]
        if op == "rgb":
            rgb = convert_colorspace(self.f3(node[1]), _cs(node[2]), "srgb")
            return "f4", torch.cat([rgb, torch.ones_like(rgb[..., :1])], -1)
        if op == "uplift":
            rgba = self.f4(node[1])
            return "color", (rgba[..., :3], rgba[..., 3])
        if op == "math":
            a, b = self.f(node[2]), self.f(node[3])
            fn = {
                "add": lambda: a + b,
                "sub": lambda: a - b,
                "mul": lambda: a * b,
                "div": lambda: a / torch.where(b == 0, 1.0, b),
                "pow": lambda: torch.pow(torch.clamp(a, min=0.0), b),
            }[node[1]]
            return "f", fn()
        if op == "image":
            from .texture import sample_texture

            tex_idx = ctx.params[..., node[1]].to(torch.int32)
            uv = self.f2(node[3]) if node[3] is not None else ctx.uv
            rgba = sample_texture(ctx.textures, tex_idx, uv, node[4], node[5])
            rgb = rgba[..., :3]
            if node[2] != "none" and _cs(node[2]) == "srgb":
                rgb = srgb_to_linear(rgb)
            return "f4", torch.cat([rgb, rgba[..., 3:4]], -1)
        if op == "checker":
            uv = self.f2(node[1]) if node[1] is not None else ctx.uv
            scale = self.f(node[2])
            c1, a1 = self.color_alpha(node[3])
            c2, a2 = self.color_alpha(node[4])
            pos = torch.floor(uv * scale[..., None] * 2.0).to(torch.int32)
            first = (pos[..., 0] + pos[..., 1]) % 2 == 0
            return "color", (torch.where(first[..., None], c1, c2), torch.where(first, a1, a2))
        if op == "noise":
            from .texture import perlin_noise

            scale = self.f(node[2])
            dim = int(node[1])
            # Blender: 1-2D sample texture space (uv), 3D the position, 4D
            # the position with a w phase of 0 (no socket)
            if dim <= 2:
                coords = ctx.uv[..., :dim]
            elif dim == 3:
                coords = ctx.p
            else:
                coords = torch.cat([ctx.p, torch.zeros_like(ctx.p[..., :1])], dim=-1)
            return "f", perlin_noise(coords * scale[..., None], dim=dim)
        if op == "mapping":
            v = self.f3(node[2])
            loc = self.f3(node[3])
            scale = self.f3(node[5])
            if node[1] == "point":
                return "f3", v * scale + loc
            return "f3", (v - loc) / torch.where(scale == 0, 1.0, scale)
        if op == "texcoords":
            return "f2", ctx.uv
        if op == "separate_color":
            c = self.f3(node[2])
            return "fields", {"Red": c[..., 0], "Green": c[..., 1], "Blue": c[..., 2]}
        if op == "extract":
            tag, v = self._get(node[1])
            if tag != "fields":
                raise TypeError(f"extract from {tag}")
            return "f", v[node[2]]
        if op == "normal_map":
            n = 2.0 * self.f3(node[1]) - 1.0
            strength = self.f(node[2])
            return "f3", n * torch.stack([strength, strength, torch.ones_like(strength)], -1)
        if op == "output":
            return self._get(node[1])
        if self.mode == "alpha" and op in _CLOSURE_OPS:
            return "alpha", self._alpha(node)
        if op == "diffuse":
            refl, _ = self.color_alpha(node[1])
            return "surface", DiffuseBsdf(refl * INV_PI)
        if op == "emission":
            return "surface", EmissiveSurface(None, self.color(node[1]) * self.f(node[2])[..., None])
        if op == "glass":
            return "surface", self._glass(node)
        if op == "plastic":
            return "surface", self._plastic(node)
        if op == "metal":
            return "surface", self._metal(node)
        if op == "mix_bsdf":
            a, b, fac = self.surface(node[1]), self.surface(node[2]), self.f(node[3])
            return "surface", BsdfMixture(lambda wo: fac, a, b, "mix")
        if op == "principled":
            return "surface", self._principled(dict(node[1]))
        raise NotImplementedError(f"svm op {op!r} is not yet ported")

    def _alpha(self, node):
        """A closure node's alpha (eval.rs:27-33): the base color's alpha of
        a diffuse or principled closure, 1 for every other closure."""
        if node[0] == "diffuse":
            return self.color_alpha(node[1])[1]
        if node[0] == "principled":
            return self.color_alpha(dict(node[1])["base_color"])[1]
        return torch.ones(self.ctx.uv.shape[:-1], device=self.ctx.uv.device)

    def _glass(self, node) -> Surface:
        """Fresnel-weighted reflection plus transmission. Dispersion (spectral
        mode only): with a Cauchy B coefficient on the node and a hero
        wavelength in the context, the IOR is evaluated at lambda0 per lane,
        n(l) = n_d + B (1/l^2 - 1/l_d^2) with l in um, anchored at the
        Fraunhofer d line (587.6 nm) where the scene's ior holds."""
        kr = self.color(node[1])
        kt = torch.sqrt(torch.clamp(self.color(node[2]), min=0.0))
        eta = self.f(node[3])
        cauchy_b = float(node[5]) if len(node) > 5 else 0.0
        if cauchy_b > 0.0 and self.ctx.lambda0 is not None:
            lam_um = self.ctx.lambda0 * 1e-3
            eta = eta + cauchy_b * (1.0 / torch.clamp(lam_um * lam_um, min=1e-4)
                                    - 1.0 / 0.5876**2)
        dist = TrowbridgeReitz.from_roughness(self.f(node[4]))

        def fresnel(c):
            return fr_dielectric(c, eta)[..., None] * torch.ones(3, device=c.device)

        refl = MicrofacetReflection(kr, fresnel, dist)
        trans = MicrofacetTransmission(kt, eta, fresnel, dist)
        return BsdfMixture(lambda wo: fr_dielectric(Frame.cos_theta(wo), eta), trans, refl, "add")

    # named complex IORs (n, k) as linear-RGB triples (~615/535/465 nm); the
    # scene graph's metal node carries a preset name (shader.rs:156-160)
    METAL_IOR = {
        "Au": ((0.143, 0.375, 1.442), (3.983, 2.386, 1.603)),
        "Ag": ((0.155, 0.116, 0.138), (3.602, 3.131, 2.621)),
        "Cu": ((0.200, 0.924, 1.102), (3.910, 2.448, 2.331)),
        "Al": ((1.345, 0.965, 0.617), (7.475, 6.400, 5.303)),
        "Fe": ((2.911, 2.950, 2.585), (3.089, 2.931, 2.767)),
        "Cr": ((3.180, 3.182, 2.441), (3.330, 3.330, 3.038)),
        "Ni": ((1.965, 1.824, 1.657), (3.714, 3.382, 3.048)),
        "Ti": ((2.741, 2.542, 2.267), (3.814, 3.435, 3.039)),
    }

    def _metal(self, node) -> Surface:
        """Conductor GGX: complex-Fresnel microfacet reflection with a named
        IOR preset (Al for an unknown name)."""
        name = node[1] if isinstance(node[1], str) else "Al"
        n_rgb, k_rgb = self.METAL_IOR.get(name, self.METAL_IOR["Al"])
        roughness = self.f(node[2])
        shape = roughness.shape + (3,)
        dev = roughness.device
        with stats.read("metal_ior"):  # copies to the device: stream syncs
            n_c = torch.tensor(n_rgb, dtype=torch.float32, device=dev).expand(shape)
        with stats.read("metal_ior"):
            k_c = torch.tensor(k_rgb, dtype=torch.float32, device=dev).expand(shape)
        return ConductorReflection(torch.ones(shape, device=dev),
                                   lambda c: fr_complex(c, n_c, k_c),
                                   TrowbridgeReitz.from_roughness(roughness))

    def _plastic(self, node) -> Surface:
        """Tungsten's rough plastic with internal scattering; the scene
        graph's ks socket is unused, as in the reference (the coat is
        white)."""
        kd = self.color(node[1])
        sigma_a = self.color(node[5]) if len(node) > 5 and node[5] != -1 else None
        thickness = self.f(node[6]) if len(node) > 6 and node[6] != -1 else None
        return PlasticBsdf(kd, self.f(node[3]), self.f(node[4]), sigma_a, thickness)

    def _principled(self, inp: dict) -> Surface:
        """Blender 4.0 Principled BSDF (principled.rs:11-215): the fused
        form, or the combinator tree under AKR_FUSED_PRINCIPLED=0."""
        ctx = self.ctx
        color, _alpha = self.color_alpha(inp["base_color"])
        emission = self.color(inp["emission_color"]) * self.f(inp["emission_strength"])[..., None]
        static_zero = frozenset(
            name
            for name, key in (("metallic", "metallic"), ("transmission", "transmission_weight"),
                              ("coat", "coat_weight"))
            if self.static_const(inp[key]) == 0.0
        )
        static_consts = {
            key: self.static_const(inp[key])
            for key in ("roughness", "ior", "specular_ior_level", "coat_roughness", "coat_ior")
        }
        bsdf = build_principled_surface(
            ctx,
            static_zero=static_zero,
            static_consts=static_consts,
            color=color,
            emission=emission,
            metallic=self.f(inp["metallic"]),
            roughness=self.f(inp["roughness"]),
            eta=self.f(inp["ior"]),
            transmission=self.f(inp["transmission_weight"]),
            specular_ior_level=self.f(inp["specular_ior_level"]),
            specular_tint=self.color(inp["specular_tint"]),
            coat_weight=self.f(inp["coat_weight"]),
            coat_roughness=self.f(inp["coat_roughness"]),
            coat_ior=self.f(inp["coat_ior"]),
            coat_tint=self.color(inp["coat_tint"]),
        )
        # tangent-space normal input: x/y negated (principled.rs:200-215)
        with stats.read("normal_sign"):  # a copy to the device: a stream sync
            sign = torch.tensor([-1.0, -1.0, 1.0], device=color.device)
        return normal_map(bsdf, self.f3(inp["normal"]) * sign, ctx.ng, ctx.frame)


def _albedo_fn(ctx: EvalContext, roughness, eta, roughness_c=None, eta_c=None):
    """Directional-albedo function (cos -> [N]) of a GGX dielectric layer,
    with the view-independent table axes hoisted out of the query."""

    def cmap(cos):
        return torch.abs(torch.clamp(cos, -0.999, 0.999))

    if roughness_c is not None and eta_c is not None:
        zc = math.sqrt(abs((eta_c - 1.0) / (eta_c + 1.0)))
        curve_np = albedo_curve_np(ctx.table_np, roughness_c, zc)
        with stats.read("albedo_curve"):  # a copy to the device: a stream sync
            curve = torch.as_tensor(curve_np, device=roughness.device)
        return lambda cos: curve_eval(curve, cmap(cos))
    z = torch.sqrt(torch.abs((eta - 1.0) / (eta + 1.0)))
    cell = {}

    def fn(cos):
        if "curve" not in cell:
            cell["curve"] = albedo_curve(ctx.table, roughness, z)
        return curve_eval(cell["curve"], cmap(cos))

    return fn


def fused_principled_enabled() -> bool:
    """AKR_FUSED_PRINCIPLED (default on): the fused principled closure; =0
    builds the combinator tree, the JAX package's correctness anchor."""
    return os.environ.get("AKR_FUSED_PRINCIPLED", "1") != "0"


def build_principled_surface(ctx: EvalContext, *, color, emission, metallic, roughness, eta,
                             transmission, specular_ior_level, specular_tint, coat_weight,
                             coat_roughness, coat_ior, coat_tint, fused: bool | None = None,
                             static_zero=frozenset(), static_consts=None) -> Surface:
    """Principled BSDF lobes (principled.rs:11-199), before normal mapping:
    FusedPrincipled, or with fused=False (by default AKR_FUSED_PRINCIPLED=0)
    the combinator tree of five microfacet lobes. Both give the same
    closure to float rounding."""
    from .principled_fused import FusedPrincipled

    if fused is None:
        fused = fused_principled_enabled()

    sc = static_consts or {}
    f0 = f0_from_ior(eta)
    f0 = torch.where(specular_ior_level != 0.5, f0 * 2.0 * specular_ior_level, f0)
    spec_eta = torch.where(specular_ior_level != 0.5, ior_from_f0(f0), eta)
    spec_eta_c = None
    ior_c, siol_c = sc.get("ior"), sc.get("specular_ior_level")
    if ior_c is not None and siol_c is not None:
        if siol_c == 0.5:
            spec_eta_c = ior_c
        else:
            t = (ior_c - 1.0) / (ior_c + 1.0)
            s = math.sqrt(min(max(t * t * 2.0 * siol_c, 0.0), 0.99))
            spec_eta_c = (1.0 + s) / (1.0 - s)
    spec_albedo = _albedo_fn(ctx, roughness, spec_eta, sc.get("roughness"), spec_eta_c)
    coat_albedo = _albedo_fn(ctx, coat_roughness, coat_ior, sc.get("coat_roughness"),
                             sc.get("coat_ior"))
    if not fused:
        return _principled_tree(color, emission, metallic, roughness, eta, transmission, f0,
                                spec_eta, specular_tint, coat_weight, coat_roughness, coat_ior,
                                coat_tint, spec_albedo, coat_albedo)
    return FusedPrincipled(
        static_zero=static_zero,
        base_color=color,
        metallic=metallic,
        roughness=roughness,
        eta=eta,
        transmission=transmission,
        spec_eta=spec_eta,
        specular_weight=f0,
        specular_tint=specular_tint,
        coat_weight=coat_weight,
        coat_roughness=coat_roughness,
        coat_ior=coat_ior,
        coat_tint=coat_tint,
        emission=emission,
        spec_albedo_fn=spec_albedo,
        coat_albedo_fn=coat_albedo,
    )


def _principled_tree(color, emission, metallic, roughness, eta, transmission, f0, spec_eta,
                     specular_tint, coat_weight, coat_roughness, coat_ior, coat_tint,
                     spec_albedo, coat_albedo) -> Surface:
    """The combinator form of the principled BSDF (principled.rs:44-199)."""
    ones3 = torch.ones(3, device=color.device)

    def dielectric_fresnel(e):
        return lambda c: fr_dielectric(c, e)[..., None] * ones3

    diffuse = DiffuseBsdf(color * INV_PI)
    # the specular layer: f0 tweaked by specular_ior_level (principled.rs:55-80)
    specular_brdf = MicrofacetReflection(specular_tint * f0[..., None],
                                         dielectric_fresnel(spec_eta),
                                         TrowbridgeReitz.from_roughness(roughness))
    clearcoat_brdf = MicrofacetReflection(torch.ones_like(color) * coat_weight[..., None],
                                          dielectric_fresnel(coat_ior),
                                          TrowbridgeReitz.from_roughness(coat_roughness))
    # the dielectric: Fresnel-weighted reflection plus transmission
    diel_dist = TrowbridgeReitz.from_roughness(roughness)
    dielectric = BsdfMixture(
        lambda wo: fr_dielectric(Frame.cos_theta(wo), eta),
        MicrofacetTransmission(torch.sqrt(torch.clamp(color, min=0.0)), eta,
                               dielectric_fresnel(eta), diel_dist),
        MicrofacetReflection(color, dielectric_fresnel(eta), diel_dist), "add")
    n_m, k_m = artistic_to_conductor_fresnel(color, specular_tint)
    metal = MicrofacetReflection(torch.ones_like(color),
                                 lambda c: fr_complex(torch.abs(c), n_m, k_m),
                                 TrowbridgeReitz.from_roughness(roughness))
    bsdf = BsdfMixture(lambda wo: transmission, diffuse, dielectric, "mix")
    bsdf = CoatedBsdf(
        specular_brdf, bsdf,
        lambda wo: specular_tint * (spec_albedo(Frame.abs_cos_theta(wo)) * f0)[..., None])
    bsdf = BsdfMixture(lambda wo: metallic, bsdf, metal, "mix")
    bsdf = EmissiveSurface(bsdf, emission)
    return CoatedBsdf(
        clearcoat_brdf,
        ScaledBsdf(bsdf, lambda wo: 1.0 + (coat_tint - 1.0) * coat_weight[..., None]),
        lambda wo: (coat_weight * coat_albedo(Frame.abs_cos_theta(wo)))[..., None] * ones3)


def kind_is_dispersive(kind: CompiledKind) -> bool:
    """Whether a kind holds a glass node with a Cauchy dispersion term (a
    static flag: it decides the hero wavelength's termination of the
    secondary wavelengths)."""
    return any(n is not None and n[0] == "glass" and len(n) > 5 and float(n[5]) > 0.0
               for n in kind.nodes)


def dispatch_closure(kind: CompiledKind, ctx: EvalContext) -> SurfaceClosure:
    """Evaluate a kind over its lanes and wrap it in the world-space
    closure, with the kind's static `dispersive` flag."""
    tag, surf = _Evaluator(kind, ctx)._get(kind.output)
    if tag != "surface":
        raise TypeError(f"shader output is {tag}, expected surface")
    closure = SurfaceClosure(surf, ctx.frame, ctx.ng)
    closure.dispersive = kind_is_dispersive(kind)
    return closure


def dispatch_alpha(kind: CompiledKind, ctx: EvalContext) -> torch.Tensor:
    """The alpha of a kind over its lanes, [N] (the JAX package's
    dispatch_closure(mode="alpha").alpha())."""
    tag, alpha = _Evaluator(kind, ctx, "alpha")._get(kind.output)
    if tag != "alpha":
        raise TypeError(f"shader output is {tag}, expected a closure")
    return alpha


def _cs(name: str) -> str:
    return {"srgb": "srgb", "aces": "aces", "none": "srgb"}.get(name, "srgb")
