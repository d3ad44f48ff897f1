"""PyTorch port, core numerics: samplers, camera, alias tables and lights,
filters and film, held against the JAX package on the CPU."""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu import camera as j_camera
from akari_render_tpu import lights as j_lights
from akari_render_tpu.core import lds as j_lds
from akari_render_tpu.core import pcg as j_pcg
from akari_render_tpu.core import samplers as j_samplers
from akari_render_tpu.core.distribution import AliasTable as JAliasTable
from akari_render_tpu.core.filters import GaussianFilter as JGaussian
from akari_render_tpu_torch import camera as t_camera
from akari_render_tpu_torch import lights as t_lights
from akari_render_tpu_torch.core import lds as t_lds
from akari_render_tpu_torch.core import pcg as t_pcg
from akari_render_tpu_torch.core import samplers as t_samplers
from akari_render_tpu_torch.core.distribution import AliasTable as TAliasTable
from akari_render_tpu_torch.core.film import Film, add_samples_aligned, develop
from akari_render_tpu_torch.core.filters import GaussianFilter as TGaussian
from akari_render_tpu_torch.core.math import offset_ray_origin as t_offset
from akari_render_tpu.core.math import offset_ray_origin as j_offset

ROOT = Path(__file__).resolve().parents[1]
N_LANES = 100_000


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a, dtype))


def test_pcg32_bits_and_floats_bit_exact(rng_np):
    """Raw uint32 outputs and float draws over 10^5 lanes with random
    64-bit stream ids."""
    hi = rng_np.integers(0, 1 << 32, N_LANES, dtype=np.uint64).astype(np.uint32)
    lo = rng_np.integers(0, 1 << 32, N_LANES, dtype=np.uint64).astype(np.uint32)
    jr = j_pcg.Pcg32.new_seq(j_pcg.U64(jnp.asarray(hi), jnp.asarray(lo)))
    tr = t_pcg.Pcg32.new_seq(t_pcg.u64_from_limbs(_t(hi, np.int64), _t(lo, np.int64)))
    for _ in range(4):
        jr, jb = j_pcg.pcg32_next(jr)
        tr, tb = t_pcg.pcg32_next(tr)
        np.testing.assert_array_equal(np.asarray(jb, np.int64), tb.numpy())
        jr, jf = j_pcg.pcg32_next_f32(jr)
        tr, tf = t_pcg.pcg32_next_f32(tr)
        np.testing.assert_array_equal(np.asarray(jf), tf.numpy())


@pytest.mark.parametrize("lanes,d", [(1000, 61), (33, 7), (1000, 1)])
def test_pcg32_draws_cpu_takes_plain(rng_np, lanes, d):
    """On CPU streams draw_pss (pcg32_draws) is the plain version: d
    pcg32_next_f32 calls stacked, bit for bit, and the JAX package's d
    draws; no kernel launch, and pcg_plain_draws counts lanes x d. The
    stream ids span all 64 bits, so states have the high bit set and the
    increments wrap."""
    from akari_render_tpu_torch import stats
    from akari_render_tpu_torch.integrators.mcmc import draw_pss

    hi = rng_np.integers(0, 1 << 32, lanes, dtype=np.uint64).astype(np.uint32)
    lo = rng_np.integers(0, 1 << 32, lanes, dtype=np.uint64).astype(np.uint32)
    tr = t_pcg.Pcg32.new_seq(t_pcg.u64_from_limbs(_t(hi, np.int64), _t(lo, np.int64)))
    assert bool((tr.state < 0).any()) and bool((tr.inc < 0).any())
    launches, plain, kernel = (t_pcg.launches, stats.counts["pcg_plain_draws"],
                               stats.counts["pcg_kernel_draws"])
    got_rng, got = draw_pss(tr, d)
    assert stats.counts["pcg_plain_draws"] == plain + lanes * d
    assert t_pcg.launches == launches and stats.counts["pcg_kernel_draws"] == kernel
    assert got.shape == (lanes, d) and got.dtype == torch.float32
    jr = j_pcg.Pcg32.new_seq(j_pcg.U64(jnp.asarray(hi), jnp.asarray(lo)))
    want = []
    for j in range(d):
        tr, u = t_pcg.pcg32_next_f32(tr)
        jr, ju = j_pcg.pcg32_next_f32(jr)
        want.append(u)
        np.testing.assert_array_equal(np.asarray(ju), got[:, j].numpy())
    assert torch.equal(got, torch.stack(want, -1))
    assert torch.equal(got_rng.state, tr.state) and torch.equal(got_rng.inc, tr.inc)


@pytest.mark.parametrize("seed,sample_index", [(0, 0), (0, 37), (5, 1 << 31)])
def test_make_sampler_streams_bit_exact(seed, sample_index):
    cfg = {"type": "independent", "seed": seed}
    pix = np.arange(N_LANES, dtype=np.uint32)
    js = j_lds.make_sampler(cfg, jnp.asarray(pix), jnp.uint32(sample_index), seed_extra=3)
    ts = t_lds.make_sampler(cfg, torch.arange(N_LANES), sample_index, seed_extra=3)
    for draw in ("next_2d", "next_3d", "next_1d", "next_3d"):
        js, ju = getattr(js, draw)()
        ts, tu = getattr(ts, draw)()
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())


def test_independent_sampler_new_bit_exact():
    lanes = np.arange(N_LANES, dtype=np.uint32)
    js = j_samplers.IndependentSampler.new(jnp.asarray(lanes), seed=1)
    ts = t_samplers.IndependentSampler.new(torch.arange(N_LANES), seed=1)
    for _ in range(3):
        js, ju = js.next_2d()
        ts, tu = ts.next_2d()
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())


def test_unported_sampler_raises():
    """Every sampler type is ported now, and an unknown type raises nothing:
    make_sampler falls to the independent sampler, as the JAX package does,
    with JAX's draws bit for bit."""
    cfg = {"type": "bogus", "seed": 2}
    pix = np.arange(4096, dtype=np.uint32)
    js = j_lds.make_sampler(cfg, jnp.asarray(pix), jnp.uint32(7), seed_extra=1)
    ts = t_lds.make_sampler(cfg, torch.arange(4096), 7, seed_extra=1)
    assert isinstance(ts, t_samplers.IndependentSampler)
    for _ in range(3):
        js, ju = js.next_3d()
        ts, tu = ts.next_3d()
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())


def test_camera_rays_match(rng_np):
    from akari_render_tpu.scenegraph.model import load_scene_json

    sg = load_scene_json(ROOT / "scenes/matbox/scene.json")
    jc = j_camera.camera_from_scenegraph(sg.camera, 64, 48)
    tc = t_camera.camera_from_scenegraph(sg.camera, 64, 48, "cpu")
    np.testing.assert_array_equal(np.asarray(jc.r2c), tc.r2c.numpy())
    np.testing.assert_array_equal(np.asarray(jc.c2w), tc.c2w.numpy())
    p = (rng_np.random((4096, 2)) * [64, 48]).astype(np.float32)
    jo, jd = j_camera.generate_rays(jc, jnp.asarray(p))
    to, td = t_camera.generate_rays(tc, _t(p))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)


@pytest.mark.parametrize("n,power", [(1, 1.0), (97, 3.0), (500, 8.0)])
def test_alias_table_build_exact(rng_np, n, power):
    w = rng_np.random(n) ** power
    jt, tt = JAliasTable.build(w), TAliasTable.build(w)
    np.testing.assert_array_equal(np.asarray(jt.prob), tt.prob)
    np.testing.assert_array_equal(np.asarray(jt.alias).astype(np.int32), tt.alias)
    np.testing.assert_array_equal(np.asarray(jt.pdf), tt.pdf)


def test_light_sampling_matches(rng_np):
    """Three lights of unequal power over 40 random triangles: selection,
    triangle ids and slots exact; the compact-table point within 1e-6."""
    n_tris = 40
    v0 = rng_np.normal(size=(n_tris, 3)).astype(np.float32)
    e1 = rng_np.normal(size=(n_tris, 3)).astype(np.float32)
    e2 = rng_np.normal(size=(n_tris, 3)).astype(np.float32)
    ids = [np.arange(0, 5), np.arange(10, 22), np.arange(30, 31)]
    powers = [rng_np.random(len(i)) * s for i, s in zip(ids, (1.0, 3.0, 0.5))]
    jl = j_lights.LightArrays.build(powers, ids, n_tris)
    tnp = t_lights.LightArrays.build_numpy(powers, ids, n_tris)
    for k, v in tnp.items():
        np.testing.assert_array_equal(np.asarray(getattr(jl, k)), v, err_msg=k)
    slots = np.concatenate(ids)
    attr = np.concatenate(
        [v0[slots], e1[slots], e2[slots], np.zeros((len(slots), 4)), np.ones((len(slots), 1))], 1
    ).astype(np.float32)
    jl = jl._replace(attr=jnp.asarray(attr))
    tl = t_lights.LightArrays.from_numpy(dict(tnp, attr=attr), "cpu")
    u = rng_np.random((30_000, 3)).astype(np.float32)
    jr = j_lights.sample_light_point_ex(jl, None, jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1:]))
    tr = t_lights.sample_light_point_ex(tl, _t(u[:, 0]), _t(u[:, 1:]))
    for name, a, b in zip(("light", "choice_pdf", "tri", "prim_pdf"), jr[:4], tr[:4]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(jr[5]), tr[5].numpy())
    jp = j_lights.light_point_attrs(jl, jr[5], jr[4])[0]
    tp = t_lights.light_point_attrs(tl, tr[5], tr[4])[0]
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)


def test_offset_ray_origin_bit_exact(rng_np):
    p = (rng_np.normal(size=(10_000, 3)) * rng_np.choice([1e-3, 1.0, 30.0], (10_000, 1))).astype(np.float32)
    n = rng_np.normal(size=(10_000, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    np.testing.assert_array_equal(t_offset(_t(p), _t(n)).numpy(), np.asarray(j_offset(jnp.asarray(p), jnp.asarray(n))))


def test_gaussian_filter_and_film(rng_np):
    u = rng_np.random((5000, 2)).astype(np.float32)
    jo, _ = JGaussian(1.5).sample(jnp.asarray(u))
    to, tw = TGaussian(1.5).sample(_t(u))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    film = Film.new(4, 2, "cpu")
    color = torch.tensor([[1.0, 2.0, 3.0]] * 8)
    color[3, 0] = float("nan")
    add_samples_aligned(film, color, torch.ones(8))
    add_samples_aligned(film, color * 3.0, torch.ones(8))
    img = develop(film, 4, 2)
    assert img.shape == (2, 4, 3)
    np.testing.assert_allclose(img[0, 0].numpy(), [2.0, 4.0, 6.0])
    assert float(img[0, 3, 0]) == 0.0  # NaN samples are dropped


def test_port_imports_no_jax():
    """Importing the port and its CLI leaves no jax in sys.modules."""
    code = (
        "import sys, akari_render_tpu_torch, akari_render_tpu_torch.cli, "
        "akari_render_tpu_torch.integrators.pt, akari_render_tpu_torch.interop; "
        "bad = sorted(m for m in sys.modules if m in ('jax', 'akari_render_tpu') "
        "or m.startswith(('jax.', 'akari_render_tpu.'))); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
