"""PyTorch port, the last shader ops against the JAX package: Perlin noise
(svm/texture.py), the conductor (metal) and Tungsten's plastic
(svm/surface.py), the classic GGX sampler with its inverse
(svm/microfacet.py), the combinator principled (AKR_FUSED_PRINCIPLED=0),
the copied core/ior.py, and chi-square tests of the plastic and the
classic sampler with the copied core/integration.py (the JAX package's
harness, tests/test_bsdf.py:49-120)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu.core import ior as j_ior
from akari_render_tpu.svm import eval as j_eval
from akari_render_tpu.svm import microfacet as j_mf
from akari_render_tpu.svm import surface as j_surf
from akari_render_tpu.svm import texture as j_tex
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch.core import ior as t_ior
from akari_render_tpu_torch.core.integration import adaptive_simpson_2d_batch
from akari_render_tpu_torch.svm import eval as t_eval
from akari_render_tpu_torch.svm import microfacet as t_mf
from akari_render_tpu_torch.svm import surface as t_surf
from akari_render_tpu_torch.svm import texture as t_tex

N = 4096


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _dirs(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _close_most(got, want, tol=1e-5, frac=1e-3, cap=1e-2):
    """Sampled directions: within tol (relative plus absolute) on all but
    `frac` of the elements, within `cap` on all. torch's sin, cos and tan
    differ from XLA's in the last bit, and on the sharpest lobes (alpha
    down to 0.0025) a near-grazing draw carries that ulp through the
    normalisation; the throughput weight f/pdf there stays within tol."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert np.mean(err > tol * np.abs(want) + tol) <= frac, np.mean(err > tol * np.abs(want) + tol)
    assert np.all(err <= cap * np.abs(want) + cap), float(err.max())


def _wo(theta_deg):
    t = np.deg2rad(theta_deg)
    return np.array([np.sin(t), 0.0, np.cos(t)], np.float32)


# ---------------------------------------------------------------- Perlin noise
@pytest.mark.parametrize("dim", [1, 2, 3, 4])
def test_perlin_matches_jax(dim):
    """Every lattice corner's hash bit-equal to JAX's (Jenkins lookup3 in
    wrapping uint32), and the noise within 1e-6 (measured: equal)."""
    rng = np.random.default_rng(40 + dim)
    p = rng.uniform(-60.0, 60.0, (N, dim)).astype(np.float32)
    p[:64] = np.round(p[:64])  # lattice points
    got_h = t_tex.lattice_hashes(torch.as_tensor(p), dim)
    cells = [np.asarray(j_tex._floor_split(jnp.asarray(p[:, i]))[0]) for i in range(dim)]
    fn = (j_tex._hash_uint, j_tex._hash_uint2, j_tex._hash_uint3, j_tex._hash_uint4)[dim - 1]
    for corner, h in enumerate(got_h):
        want = fn(*(jnp.asarray(c) + jnp.uint32((corner >> i) & 1) for i, c in enumerate(cells)))
        np.testing.assert_array_equal(h.numpy(), np.asarray(want).astype(np.int64))
    got = t_tex.perlin_noise(torch.as_tensor(p), dim).numpy()
    want = np.asarray(j_tex.perlin_noise(jnp.asarray(p), dim=dim))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dim", [1, 2, 3, 4])
def test_perlin_range_and_continuity(dim):
    """JAX's TestPerlinNoise cases (tests/test_core.py:272-300) on the
    port: in [0, 1], centred on 0.5 with real variation, and continuous."""
    rng = np.random.default_rng(1234)
    p = torch.as_tensor(rng.uniform(-50, 50, (100_000, dim)).astype(np.float32))
    v = t_tex.perlin_noise(p, dim).numpy()
    assert np.isfinite(v).all() and (v >= 0.0).all() and (v <= 1.0).all()
    assert abs(v.mean() - 0.5) < 0.02 and v.std() > 0.05
    p = torch.as_tensor(rng.uniform(-10, 10, (4096, dim)).astype(np.float32))
    v0 = t_tex.perlin_noise(p, dim).numpy()
    v1 = t_tex.perlin_noise(p + 1e-4, dim).numpy()
    assert np.abs(v1 - v0).max() < 0.01


def test_perlin_lattice_and_hash_reference():
    """JAX's cases: exactly 0.5 at lattice points, and hash_uint2 against an
    independent lookup3 evaluation in Python ints."""
    for dim in (1, 2, 3, 4):
        p = torch.arange(4, dtype=torch.float32)[:, None].repeat(1, dim)
        np.testing.assert_allclose(t_tex.perlin_noise(p, dim).numpy(), 0.5, atol=1e-6)

    def rot(x, k):
        return ((x << k) | (x >> (32 - k))) & 0xFFFFFFFF

    def final(a, b, c):
        for x, y, k in (("c", "b", 14), ("a", "c", 11), ("b", "a", 25), ("c", "b", 16),
                        ("a", "c", 4), ("b", "a", 14), ("c", "b", 24)):
            r = {"a": a, "b": b, "c": c}
            r[x] = ((r[x] ^ r[y]) - rot(r[y], k)) & 0xFFFFFFFF
            a, b, c = r["a"], r["b"], r["c"]
        return c

    for kx, ky in [(0, 0), (1, 2), (12345, 67890), (2**31, 7)]:
        init = (0xDEADBEEF + (2 << 2) + 13) & 0xFFFFFFFF
        want = final((init + ky) & 0xFFFFFFFF, (init + kx) & 0xFFFFFFFF, init)
        assert int(t_tex.hash_uint2(torch.tensor([kx]), torch.tensor([ky]))[0]) == want


# ------------------------------------------------------ conductor and plastic
def _closures(kind: str, rng, n=N):
    """The same closure in both packages from seeded parameters."""
    rough = rng.uniform(0.05, 1.0, n).astype(np.float32)
    if kind == "metal":
        n_rgb, k_rgb = j_eval._Evaluator.METAL_IOR["Au"]
        assert t_eval._Evaluator.METAL_IOR["Au"] == (n_rgb, k_rgb)
        nc = np.broadcast_to(np.float32(n_rgb), (n, 3))
        kc = np.broadcast_to(np.float32(k_rgb), (n, 3))
        j = j_surf.ConductorReflection(
            jnp.ones((n, 3)), lambda c: j_mf.fr_complex(c, jnp.asarray(nc), jnp.asarray(kc)),
            j_mf.TrowbridgeReitz.from_roughness(jnp.asarray(rough)))
        t = t_surf.ConductorReflection(
            torch.ones((n, 3)),
            lambda c: t_mf.fr_complex(c, torch.as_tensor(nc.copy()), torch.as_tensor(kc.copy())),
            t_mf.TrowbridgeReitz.from_roughness(torch.as_tensor(rough)))
        return j, t
    kd = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    eta = rng.uniform(1.1, 2.0, n).astype(np.float32)
    sig = th = None
    if kind == "plastic_absorbing":
        sig = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
        th = rng.uniform(0.1, 2.0, n).astype(np.float32)
    j = j_surf.PlasticBsdf(jnp.asarray(kd), jnp.asarray(eta), jnp.asarray(rough),
                           None if sig is None else jnp.asarray(sig),
                           None if th is None else jnp.asarray(th))
    t = t_surf.PlasticBsdf(torch.as_tensor(kd), torch.as_tensor(eta), torch.as_tensor(rough),
                           None if sig is None else torch.as_tensor(sig),
                           None if th is None else torch.as_tensor(th))
    return j, t


@pytest.mark.parametrize("kind", ["metal", "plastic", "plastic_absorbing"])
def test_closure_matches_jax(kind):
    """On the same seeded wo, wi and u: evaluate, albedo and roughness
    within 1e-5 (relative plus absolute; the absorbing plastic's exps are
    torch's, not XLA's); sample_wi's valid flags equal and its directions
    by _close_most (measured: all but 0.033 % of the components within
    1e-5); at JAX's sampled directions both packages' weight f/pdf within
    1e-5. f and pdf there apart are as ill-conditioned as GGX's D near its
    peak: an ulp of the half vector moves D by up to 2/alpha^2 ulps
    (measured: up to 2.0 % on 0.4 % of the lanes)."""
    rng = np.random.default_rng({"metal": 11, "plastic": 12, "plastic_absorbing": 13}[kind])
    j, t = _closures(kind, rng)
    wo, wi = _dirs(rng, N), _dirs(rng, N)
    wo[:, 2] = np.abs(wo[:, 2])
    u_sel = rng.uniform(size=N).astype(np.float32)
    u = rng.uniform(size=(N, 2)).astype(np.float32)
    tw, twi, tus, tu = (torch.as_tensor(x) for x in (wo, wi, u_sel, u))
    jw, jwi, jus, ju = (jnp.asarray(x) for x in (wo, wi, u_sel, u))

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    (f_t, p_t), (f_j, p_j) = t.evaluate(tw, twi), j.evaluate(jw, jwi)
    close(f_t, f_j)
    close(p_t, p_j)
    (s_t, v_t), (s_j, v_j) = t.sample_wi(tw, tus, tu), j.sample_wi(jw, jus, ju)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    _close_most(s_t.numpy(), s_j)
    # both evaluate at JAX's sampled directions
    (f_t, p_t), (f_j, p_j) = t.evaluate(tw, torch.as_tensor(np.asarray(s_j))), j.evaluate(jw, s_j)
    close(f_t / torch.clamp(p_t, min=1e-20)[:, None],
          np.asarray(f_j) / np.maximum(np.asarray(p_j), 1e-20)[:, None])
    close(t.albedo(tw), j.albedo(jw))
    close(t.roughness(tw, tus), j.roughness(jw, jus))


def test_metal_normal_incidence_and_render(tmp_path):
    """JAX's TestMetalBsdf cases (tests/test_scene.py:501-560) on the port:
    gold's albedo at normal incidence red over blue, in (0.5, 1.05]; and a
    copper quad is hit."""
    from akari_render_tpu_torch.scene import load_scene
    from akari_render_tpu_torch.scenegraph.write import SceneBuilder

    def scene(eta):
        b = SceneBuilder()
        v = np.asarray([(-2, -2, 0), (2, -2, 0), (2, 2, 0), (-2, 2, 0)], np.float32)
        uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]], np.float32)
        b.add_mesh("q", v, np.asarray([[0, 1, 2], [0, 2, 3]], np.uint32), uvs=uv)
        b.add_material("m", {"nodes": {
            "r": {"type": "float", "value": 0.2},
            "m": {"type": "metal", "eta": eta, "roughness": {"id": "r"}},
            "out": {"type": "output", "node": {"id": "m"}}},
            "output": {"id": "out"}, "kind": "surface"})
        b.add_instance("qi", "q", np.eye(4).tolist(), ["m"])
        b.set_camera_perspective(transform_matrix=np.eye(4), width=4, height=4)
        return load_scene(str(b.write(tmp_path / eta, compact=True)), device="cpu",
                          ggx_table=np.asarray(j_get_table("ggx_dielectric_s")))

    sc = scene("Au")
    assert len(sc.kinds) == 1
    si = sc.surface_interaction(torch.zeros(4, dtype=torch.int64), torch.full((4, 2), 0.3))
    alb = sc.kind_closure(si, 0, torch.arange(4)).albedo(torch.tensor([[0.0, 0.0, 1.0]] * 4))
    alb = alb.numpy()
    assert alb[0, 0] > alb[0, 2] and 0.5 < alb[0, 0] <= 1.05
    hit = scene("Cu").intersect(torch.tensor([[0.5, 0.5, 3.0]]), torch.tensor([[0.0, 0.0, -1.0]]),
                                torch.zeros(1), torch.full((1,), 1e8))
    assert bool(hit.valid[0])


def test_plastic_cases():
    """JAX's TestPlasticChi2 property cases on the port: energy below 1 in
    a white furnace, absorption darkens, and the internal-scattering
    compensation brightens."""
    def make(kd=(0.6, 0.3, 0.2), sigma_a=None):
        return t_surf.PlasticBsdf(torch.tensor([kd]), torch.tensor([1.5]), torch.tensor([0.3]),
                                  None if sigma_a is None else torch.tensor([sigma_a]), None)

    surf = make(kd=(0.9, 0.9, 0.9))
    n = 100_000
    wo = torch.as_tensor(_wo(35)).expand(n, 3)
    rng = np.random.default_rng(42)
    wi, valid = surf.sample_wi(wo, torch.as_tensor(rng.uniform(size=n).astype(np.float32)),
                               torch.as_tensor(rng.uniform(size=(n, 2)).astype(np.float32)))
    f, pdf = surf.evaluate(wo, wi)
    ok = (valid & (pdf > 0))[:, None]
    est = torch.where(ok, f / torch.clamp(pdf, min=1e-9)[:, None], 0.0)
    assert float(est.mean(0).max()) < 1.05
    wo1, wi1 = torch.as_tensor(_wo(30))[None], torch.as_tensor(_wo(-20))[None]
    assert float(make(sigma_a=(0.5, 0.5, 0.5)).evaluate(wo1, wi1)[0].sum()) < float(
        make().evaluate(wo1, wi1)[0].sum())
    fdr = float(t_surf.fr_dielectric_integral(torch.tensor([1.5]))[0])
    assert 0.55 < fdr < 0.65 and 0.9 / (1 - 0.9 * fdr) > 0.9


# ------------------------------------------------------- classic GGX sampling
def test_classic_sampler_matches_jax():
    """The classic sampler's wh, its pdf and invert_wh against JAX's,
    isotropic and anisotropic, by _close_most: torch's trig is not
    XLA's, and the anisotropic branch takes tan near pi/2."""
    rng = np.random.default_rng(5)
    alpha = rng.uniform(0.02, 1.0, (N, 2)).astype(np.float32)
    alpha[: N // 2, 1] = alpha[: N // 2, 0]  # half isotropic
    u = rng.uniform(1e-3, 1 - 1e-3, (N, 2)).astype(np.float32)
    wo = _dirs(rng, N)
    wo[:, 2] = np.abs(wo[:, 2])
    jd = j_mf.TrowbridgeReitz(jnp.asarray(alpha), sample_visible=False)
    td = t_mf.TrowbridgeReitz(torch.as_tensor(alpha), sample_visible=False)
    jwh = jd.sample_wh(jnp.asarray(wo), jnp.asarray(u))
    twh = td.sample_wh(torch.as_tensor(wo), torch.as_tensor(u))
    _close_most(twh.numpy(), jwh)
    _close_most(td.pdf(torch.as_tensor(wo), twh).numpy(), jd.pdf(jnp.asarray(wo), jwh))
    tu = td.invert_wh(torch.as_tensor(wo), twh).numpy()
    ju = np.asarray(jd.invert_wh(jnp.asarray(wo), jwh))
    ju = np.where(np.abs(tu - ju) > 0.5, ju + np.sign(tu - ju), ju)  # u_y wraps at 1
    _close_most(tu, ju)
    with pytest.raises(ValueError):
        t_mf.TrowbridgeReitz.from_roughness(torch.ones(4)).invert_wh(
            torch.as_tensor(wo[:4]), twh[:4])
    f = t_mf.fr_schlick(torch.full((4, 3), 0.04), 1.0, torch.tensor([1.0, 0.5, 0.0, -0.5]))
    jf = j_mf.fr_schlick(jnp.full((4, 3), 0.04), 1.0, jnp.asarray([1.0, 0.5, 0.0, -0.5]))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-6)


@pytest.mark.parametrize("alphas", [(0.25, 0.25), (0.04, 0.25), (0.5, 0.1)])
def test_classic_invert_round_trip(alphas):
    """JAX's test_ggx_classic_invert_wh and TestGGXInversion cases on the
    port: u -> sample_wh -> invert_wh gives u back (wrap-aware, 1 % of
    draws may be off by 0.01), and resampling the inverse gives wh back."""
    n = 8192
    rng = np.random.default_rng(3)
    dist = t_mf.TrowbridgeReitz(torch.tensor(alphas).expand(n, 2), sample_visible=False)
    u = torch.as_tensor(rng.uniform(0.01, 0.99, (n, 2)).astype(np.float32))
    wo = torch.as_tensor(_wo(30.0)).expand(n, 3)
    wh = dist.sample_wh(wo, u)
    u2 = dist.invert_wh(wo, wh)
    d = (u2 - u).abs().numpy()
    assert ((np.minimum(d, 1.0 - d) > 0.01).any(axis=-1)).mean() < 0.01
    err = (dist.sample_wh(wo, u2) - wh).abs().max(-1).values.numpy()
    assert (err < 5e-3).mean() > 0.99


# ------------------------------------------------------ combinator principled
def _principled_params(rng, n, **overrides):
    def arr(lo, hi):
        return rng.uniform(lo, hi, n).astype(np.float32)

    def col(lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, (n, 3)).astype(np.float32)

    p = dict(color=col(), emission=col(0.0, 2.0), metallic=arr(0, 1), roughness=arr(0.05, 1.0),
             eta=arr(1.1, 2.0), transmission=arr(0, 1), specular_ior_level=arr(0.1, 0.9),
             specular_tint=col(0.2, 1.0), coat_weight=arr(0, 1), coat_roughness=arr(0.05, 0.6),
             coat_ior=arr(1.2, 1.8), coat_tint=col(0.5, 1.0))
    p.update(overrides)
    return p


def _principled(params, fused, package, table):
    """build_principled_surface of either package on the same parameters
    and the same GGX albedo table (JAX's)."""
    if package == "jax":
        return j_eval.build_principled_surface(
            **{k: jnp.asarray(v) for k, v in params.items()}, fused=fused)
    ctx = t_eval.EvalContext(params=None, uv=None, p=None, ng=None, frame=None,
                             table=torch.as_tensor(table), table_np=table)
    return t_eval.build_principled_surface(
        ctx, **{k: torch.as_tensor(v) for k, v in params.items()}, fused=fused)


@pytest.fixture(scope="module")
def table():
    return np.asarray(j_get_table("ggx_dielectric_s"))


@pytest.mark.parametrize("case", ["random", "pure_metal", "pure_glass", "pure_coat"])
def test_combinator_principled(table, case):
    """The port's combinator tree against JAX's combinator tree (within
    1e-5) and against the port's fused principled, by JAX's
    TestFusedPrincipled cases (tests/test_bsdf.py:244-345, their
    tolerances): evaluate over the full sphere, sample_wi, albedo, emission
    and roughness, on random parameters and the degenerate corners."""
    rng = np.random.default_rng({"random": 7, "pure_metal": 17, "pure_glass": 18,
                                 "pure_coat": 19}[case])
    n = 2048
    one, zero = np.ones(n, np.float32), np.zeros(n, np.float32)
    over = {"random": {}, "pure_metal": dict(metallic=one, transmission=zero, coat_weight=zero),
            "pure_glass": dict(metallic=zero, transmission=one, coat_weight=zero),
            "pure_coat": dict(metallic=zero, transmission=zero, coat_weight=one)}[case]
    params = _principled_params(rng, n, **over)
    tree = _principled(params, False, "torch", table)
    fused = _principled(params, True, "torch", table)
    jtree = _principled(params, False, "jax", table)
    assert type(tree).__name__ == "CoatedBsdf"
    wo, wi = _dirs(rng, n), _dirs(rng, n)
    u_sel = rng.uniform(size=n).astype(np.float32)
    u = rng.uniform(size=(n, 2)).astype(np.float32)
    tw, twi, tus, tu = (torch.as_tensor(x) for x in (wo, wi, u_sel, u))
    jw, jwi, jus, ju = (jnp.asarray(x) for x in (wo, wi, u_sel, u))

    f_t, p_t = tree.evaluate(tw, twi)
    f_j, p_j = jtree.evaluate(jw, jwi)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-5, atol=1e-5)
    f_f, p_f = fused.evaluate(tw, twi)
    np.testing.assert_allclose(f_f.numpy(), f_t.numpy(), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(p_f.numpy(), p_t.numpy(), rtol=2e-5, atol=2e-6)
    (wi_t, v_t), (wi_j, v_j) = tree.sample_wi(tw, tus, tu), jtree.sample_wi(jw, jus, ju)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    _close_most(wi_t.numpy()[v_t.numpy()], np.asarray(wi_j)[v_t.numpy()])
    wi_f, v_f = fused.sample_wi(tw, tus, tu)
    np.testing.assert_array_equal(v_f.numpy(), v_t.numpy())
    vt = v_t.numpy()
    np.testing.assert_allclose(wi_f.numpy()[vt], wi_t.numpy()[vt], rtol=1e-5, atol=1e-6)
    for fn in ("albedo", "emission"):
        got = getattr(tree, fn)(tw)
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jtree, fn)(jw)), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(getattr(fused, fn)(tw).numpy(), got.numpy(), rtol=2e-5,
                                   atol=2e-6)
    np.testing.assert_allclose(fused.roughness(tw, tus).numpy(), tree.roughness(tw, tus).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(tree.roughness(tw, tus).numpy(),
                               np.asarray(jtree.roughness(jw, jus)), rtol=1e-6)


def test_fused_principled_switch(table, monkeypatch):
    """AKR_FUSED_PRINCIPLED is read at each build: =0 gives the tree."""
    params = _principled_params(np.random.default_rng(2), 8)
    monkeypatch.setenv("AKR_FUSED_PRINCIPLED", "0")
    assert type(_principled(params, None, "torch", table)).__name__ == "CoatedBsdf"
    monkeypatch.setenv("AKR_FUSED_PRINCIPLED", "1")
    assert type(_principled(params, None, "torch", table)).__name__ == "FusedPrincipled"


def test_ior_presets_match_jax():
    """The copied core/ior.py gives JAX's values and sampled table."""
    lam = np.linspace(380.0, 780.0, 41)
    for name in j_ior.PRESETS:
        np.testing.assert_array_equal(t_ior.eta(name, lam), j_ior.eta(name, lam))
        np.testing.assert_array_equal(t_ior.eta_table(name), j_ior.eta_table(name))
    assert t_ior.PRESETS == j_ior.PRESETS


# ------------------------------------------------------------ chi-square
THETA_BINS, PHI_BINS = 16, 32


def _run_chi2(surface, wo, n=200_000):
    """tests/test_bsdf.py::_run_chi2 on a port closure: sample_wi's
    histogram over the sphere against the pdf that evaluate claims,
    integrated per bin by adaptive Simpson (eps 1e-6, depth 6), pooled
    below 5 expected counts, at the 1e-3 level."""
    rng = np.random.default_rng(42)
    wo_b = torch.as_tensor(wo).expand(n, 3)
    wi, valid = surface.sample_wi(wo_b, torch.as_tensor(rng.uniform(size=n).astype(np.float32)),
                                  torch.as_tensor(rng.uniform(size=(n, 2)).astype(np.float32)))
    _, pdf = surface.evaluate(wo_b, wi)
    wi, valid = wi.numpy(), (valid & (pdf > 0)).numpy()
    theta = np.arccos(np.clip(wi[:, 2], -1, 1))
    phi = np.mod(np.arctan2(wi[:, 1], wi[:, 0]), 2 * np.pi)
    ti = np.minimum((theta / np.pi * THETA_BINS).astype(int), THETA_BINS - 1)
    pi_ = np.minimum((phi / (2 * np.pi) * PHI_BINS).astype(int), PHI_BINS - 1)
    obs = np.zeros((THETA_BINS, PHI_BINS))
    np.add.at(obs, (ti[valid], pi_[valid]), 1.0)

    def pdf_sin(phis, thetas, owners):
        d = np.stack([np.sin(thetas) * np.cos(phis), np.sin(thetas) * np.sin(phis),
                      np.cos(thetas)], -1).astype(np.float32)
        w = torch.as_tensor(wo).expand(d.shape[0], 3)
        return surface.evaluate(w, torch.as_tensor(d))[1].numpy().astype(np.float64) * np.sin(
            thetas)

    t_h, p_h = np.pi / THETA_BINS, 2 * np.pi / PHI_BINS
    tg, pg = np.meshgrid(np.arange(THETA_BINS), np.arange(PHI_BINS), indexing="ij")
    tg, pg = tg.ravel(), pg.ravel()
    exp = adaptive_simpson_2d_batch(pdf_sin, pg * p_h, (pg + 1) * p_h, tg * t_h, (tg + 1) * t_h,
                                    eps=1e-6, max_depth=6) * n
    pooled_obs = pooled_exp = chi2 = 0.0
    dof = 0
    for o, e in zip(obs.ravel(), exp):
        pooled_obs += o
        pooled_exp += e
        if pooled_exp >= 5.0:
            chi2 += (pooled_obs - pooled_exp) ** 2 / pooled_exp
            dof += 1
            pooled_obs = pooled_exp = 0.0
    assert dof > 5, "degenerate chi2 binning"
    thresh = dof * (1 - 2 / (9 * dof) + 3.09 * math.sqrt(2 / (9 * dof))) ** 3
    assert chi2 < thresh, f"chi2={chi2:.1f} > {thresh:.1f} (dof={dof})"


def test_chi2_plastic():
    """JAX's TestPlasticChi2.test_chi2 at roughness 0.5, 30 degrees."""
    surf = t_surf.PlasticBsdf(torch.tensor([[0.6, 0.3, 0.2]]), torch.tensor([1.5]),
                              torch.tensor([0.5]))
    _run_chi2(surf, _wo(30.0))


def test_chi2_classic_sampling():
    """JAX's TestGGXReflectionChi2.test_classic_sampling: a white GGX
    reflection lobe at roughness 0.5 sampled by the classic NDF sampler."""
    dist = t_mf.TrowbridgeReitz.from_roughness(torch.tensor(0.5), sample_visible=False)
    bsdf = t_surf.MicrofacetReflection(torch.ones(3), lambda c: torch.ones(c.shape + (3,)), dist)
    _run_chi2(bsdf, _wo(30.0))
