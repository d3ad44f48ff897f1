"""PyTorch port, the gradient-domain path tracer: screened_poisson, the
replay sampler and PSS vectors, the reconnection shift's base record and
shifted path, and render_gpt on cbox in both shift modes, held against the
JAX package on the CPU (its GPT runs outside Pallas)."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu.camera import generate_rays as j_generate_rays
from akari_render_tpu.config import GPTConfig as JGPTConfig
from akari_render_tpu.core.filters import GaussianFilter as JGaussianFilter
from akari_render_tpu.core.pcg import U64, Pcg32 as JPcg32, pcg32_next_f32 as j_next_f32
from akari_render_tpu.integrators import gpt as jgpt
from akari_render_tpu.integrators import gpt_reconnect as jrec
from akari_render_tpu.integrators.common import PTSettings as JPTSettings
from akari_render_tpu.integrators.mcmc import ReplaySampler as JReplaySampler
from akari_render_tpu.integrators.mcmc import kelemen_mutate as j_kelemen
from akari_render_tpu.integrators.mcmc import sample_dimension as j_sample_dimension
from akari_render_tpu.scene import load_scene as j_load_scene
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch.camera import generate_rays as t_generate_rays
from akari_render_tpu_torch.config import GPTConfig
from akari_render_tpu_torch.core.film import Film, develop
from akari_render_tpu_torch.core.filters import filter_from_config
from akari_render_tpu_torch.core.pcg import Pcg32, u64_from_limbs
from akari_render_tpu_torch.integrators import gpt, gpt_reconnect
from akari_render_tpu_torch.integrators.common import PTSettings
from akari_render_tpu_torch.integrators.mcmc import (ReplaySampler, draw_pss, kelemen_mutate,
                                                      sample_dimension)
from akari_render_tpu_torch.scene import load_scene as t_load_scene
from torch_gpt_checks import assert_full_strength, assert_images_match, paired_pixels

ROOT = Path(__file__).resolve().parents[1]
CBOX = ROOT / "scenes/cbox/scene.json"
RES = 16
DEPTH = 3


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_table():
    return np.asarray(j_get_table("ggx_dielectric_s"))


@pytest.fixture(scope="module")
def scenes(jax_table):
    return (j_load_scene(str(CBOX), RES, RES),
            t_load_scene(str(CBOX), RES, RES, device="cpu", ggx_table=jax_table))


@pytest.mark.parametrize("weighted", [False, True], ids=["uniform", "weighted"])
def test_screened_poisson_matches_jax(weighted):
    """Seeded 16x16x3 primal, gradients and variances: both Jacobi modes
    within 1e-5 of JAX's after 30 iterations."""
    rng = np.random.default_rng(7)
    primal, gx, gy = (rng.random((16, 16, 3), dtype=np.float32) for _ in range(3))
    gx, gy = gx - 0.5, gy - 0.5
    var = tuple(rng.random((16, 16, 3), dtype=np.float32) * 0.1 + 1e-3 for _ in range(3))
    want = jgpt.screened_poisson(jnp.asarray(primal), jnp.asarray(gx), jnp.asarray(gy),
                                 tuple(map(jnp.asarray, var)) if weighted else None, iters=30)
    got = gpt.screened_poisson(torch.as_tensor(primal), torch.as_tensor(gx),
                               torch.as_tensor(gy),
                               tuple(map(torch.as_tensor, var)) if weighted else None, iters=30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float(np.abs(np.asarray(want) - primal).max()) > 1e-2  # the solve moved it


def _gpt_pss(n, sample_idx, seed, d):
    """The GPT key's PSS vectors and fallback streams in both packages:
    (jax rng, jax pss), (torch rng, torch pss)."""
    seed_s = (seed * 0x9E3779B9) & 0xFFFFFFFF
    pix = np.arange(n, dtype=np.uint32)
    jrng = JPcg32.new_seq(U64(jnp.full(n, sample_idx ^ seed_s, jnp.uint32), jnp.asarray(pix)))
    us = []
    for _ in range(d):
        jrng, u = j_next_f32(jrng)
        us.append(u)
    pix_t = torch.as_tensor(pix.astype(np.int64))
    trng, tpss = draw_pss(Pcg32.new_seq(u64_from_limbs(torch.full_like(pix_t, sample_idx ^ seed_s),
                                                      pix_t)), d)
    return (jrng, jnp.stack(us, -1)), (trng, tpss)


def test_pss_replay_sampler_and_mutation_bit_equal():
    """The PSS vectors of a GPT sample, ReplaySampler's draws through and
    past the vector's dimension (the fallback stream), sample_dimension and
    kelemen_mutate: bit-equal to JAX."""
    for depth in (1, 3, 7, 12):
        assert sample_dimension(depth) == j_sample_dimension(depth)
    d = sample_dimension(2)
    (jrng, jpss), (trng, tpss) = _gpt_pss(4096, 5, 3, d)
    np.testing.assert_array_equal(tpss.numpy(), np.asarray(jpss))
    js = JReplaySampler(jpss, jnp.zeros(4096, jnp.int32), jrng)
    ts = ReplaySampler(tpss, 0, trng)
    for k in range(d + 4):  # 1d, 2d and 3d draws, the last ones from the fallback stream
        if k % 3 == 0:
            (js, ju), (ts, tu) = js.next_1d(), ts.next_1d()
        elif k % 3 == 1:
            (js, ju), (ts, tu) = js.next_2d(), ts.next_2d()
        else:
            (js, ju), (ts, tu) = js.next_3d(), ts.next_3d()
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    assert ts.dim == int(js.dim[0]) > d
    u = np.random.default_rng(3).random(tpss.shape, dtype=np.float32)
    np.testing.assert_array_equal(kelemen_mutate(tpss, torch.as_tensor(u)).numpy(),
                                  np.asarray(j_kelemen(jpss, jnp.asarray(u))))


def _near(got, want, rel=1e-4, floor=1e-3):
    """Per lane: the largest component difference within `rel` of the
    lane's largest component (of at least `floor`)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    got, want = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    scale = np.maximum(np.abs(want).max(axis=1), floor)
    return np.abs(got - want).max(axis=1) <= rel * scale


def test_base_record_and_shift_match_jax(scenes):
    """cbox 16x16, d3, sample 0 (seed 0): trace_base_record and
    trace_shift_reconnect (the +x shift, from the same rng state) from the
    same PSS vectors and camera rays. The record's valid, depth and tri
    equal on >= 99 % of the lanes, its floats within 1e-4 relative (a
    vector's to its largest component) where both agree on those (measured
    on the CPU: every lane equal, the floats within 2.6e-6); the
    shift's success equal on >= 99 %, its jacobian and radiance within
    1e-4 where both succeed (measured: success on every lane, the jacobian
    within 4.7e-5 absolute)."""
    js, ts = scenes
    n = RES * RES
    d = sample_dimension(DEPTH)
    (jrng, jpss), (trng, tpss) = _gpt_pss(n, 0, 0, d)
    jsm, ju = JReplaySampler(jpss, jnp.zeros(n, jnp.int32), jrng).next_2d()
    tsm, tu = ReplaySampler(tpss, 0, trng).next_2d()
    off, _ = JGaussianFilter(1.5).sample(ju)
    pix = np.stack([np.arange(n) % RES, np.arange(n) // RES], -1)
    p_film = (pix.astype(np.float32) + 0.5 + np.asarray(off)).astype(np.float32)
    jo, jd = j_generate_rays(js.camera, jnp.asarray(p_film))
    to, td = t_generate_rays(ts.camera, torch.as_tensor(p_film))
    jset, tset = JPTSettings(max_depth=DEPTH, rr_depth=5), PTSettings(max_depth=DEPTH, rr_depth=5)
    (jb, jb0), jr, jsm2 = jrec.trace_base_record(js, jset, jo, jd, jsm)
    (tb, tb0), tr, tsm2 = gpt_reconnect.trace_base_record(ts, tset, to, td, tsm)

    same = np.ones(n, bool)
    for f in ("valid", "depth", "tri"):
        eq = getattr(tr, f).numpy() == np.asarray(getattr(jr, f))
        assert eq.mean() >= 0.99, f
        same &= eq
    valid = same & np.asarray(jr.valid)
    assert valid.mean() > 0.2  # the box's diffuse walls make most paths reconnectible
    for f in ("bary", "prev_pdf", "wi", "bsdf_pdf", "direct", "direct_wi", "direct_light_pdf",
              "indirect", "cos_at_v", "dist"):
        ok = _near(getattr(tr, f).numpy()[valid], np.asarray(getattr(jr, f))[valid])
        assert ok.all(), f"{f}: {np.count_nonzero(~ok)} of {valid.sum()} lanes off"
    assert _near(tb.numpy(), np.asarray(jb)).mean() >= 0.99
    assert _near(tb0.numpy(), np.asarray(jb0)).mean() >= 0.99

    # the +x shift clones the sampler from the base's final rng state
    spix = np.asarray(jgpt._reflect_offset(jnp.asarray(pix, jnp.int32), jnp.asarray([1, 0]), RES,
                                           RES))
    np.testing.assert_array_equal(
        gpt._reflect_offset(torch.as_tensor(pix), (1, 0), RES, RES).numpy(), spix)
    jsh, ju = JReplaySampler(jpss, jnp.zeros(n, jnp.int32), jsm2.rng).next_2d()
    tsh, tu = ReplaySampler(tpss, 0, tsm2.rng).next_2d()
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    sp = (spix.astype(np.float32) + 0.5 + np.asarray(JGaussianFilter(1.5).sample(ju)[0]))
    jo, jd = j_generate_rays(js.camera, jnp.asarray(sp.astype(np.float32)))
    to, td = t_generate_rays(ts.camera, torch.as_tensor(sp.astype(np.float32)))
    (j0, jrest), jjac, jsucc, _ = jrec.trace_shift_reconnect(js, jset, jo, jd, jsh, jr)
    (t0, trest), tjac, tsucc, _ = gpt_reconnect.trace_shift_reconnect(ts, tset, to, td, tsh, tr)
    both = (tsucc.numpy() == np.asarray(jsucc))
    assert both.mean() >= 0.99
    both &= np.asarray(jsucc)
    assert both.mean() > 0.5
    assert _near(tjac.numpy()[both], np.asarray(jjac)[both]).mean() >= 0.99
    assert _near(trest.numpy()[both], np.asarray(jrest)[both]).mean() >= 0.99
    assert _near(t0.numpy(), np.asarray(j0)).mean() >= 0.99


@pytest.mark.parametrize("mode", ["reconnect", "pss"])
def test_render_gpt_matches_jax(scenes, mode):
    """cbox 16x16, 2 spp, d3 in each shift mode, against the JAX package
    (test_slice_matches_jax's standard: channel means within 1 % and >= 95 %
    of the pixels within 1e-3 relative; measured on the CPU before the
    films came to full strength: every pixel within 4.8e-7 absolute).

    The factors. A sample's gradient pixel p that holds the two ends a, b
    of the pair (p, p + e) holds their sum a + b in the port
    (gpt.gpt_sample_films) and their mean (a + b) / 2 in the JAX package,
    which divides by the two splats: so the port's gx and gy are exactly
    2x JAX's at every pixel where JAX's film holds one pair
    (torch_gpt_checks.assert_full_strength; the port's last column of gx
    and last row of gy, which hold no pair, read 0). The primal is JAX's.
    The reconstruction is JAX's screened_poisson (called as it is) fed the
    port's films, which are those 2x films. The square films: at one
    sample the port's gx_sq holds (a + b)^2, the square of its gx, so 4x
    the square of JAX's one-sample gx at those pixels (JAX's own square
    film holds (a^2 + b^2) / 2, no square of a full-strength sample)."""
    js, ts = scenes
    jimg, jstats = jgpt.render_gpt(js, JGPTConfig(spp=2, max_depth=DEPTH), None, shift_mode=mode)
    timg, tstats = gpt.render_gpt(ts, GPTConfig(spp=2, max_depth=DEPTH), None, shift_mode=mode)
    assert tstats["shift_mode"] == mode and tstats["spp_total"] == 2
    assert_images_match(tstats["primal"], jstats["primal"], "primal")
    assert_full_strength(tstats, jstats)
    want = jgpt.screened_poisson(*(jnp.asarray(tstats[k]) for k in ("primal", "gx", "gy")),
                                 None, iters=GPTConfig().reconstruction_iter)
    assert_images_match(timg, np.asarray(want), "recon")
    assert timg.mean() > 0.01 and np.abs(tstats["gx"]).mean() > 1e-3

    _, j1 = jgpt.render_gpt(js, JGPTConfig(spp=1, max_depth=DEPTH), None, shift_mode=mode)
    cfg = GPTConfig(spp=1, max_depth=DEPTH)
    films = tuple(Film.new(RES, RES, "cpu") for _ in range(6))
    gpt.gpt_sample_films(ts, cfg, filter_from_config(None),
                         PTSettings(max_depth=DEPTH, rr_depth=cfg.rr_depth, use_nee=cfg.use_nee),
                         sample_dimension(DEPTH), 0, mode, films, 0,
                         torch.arange(RES * RES, dtype=torch.int64))
    _, gx, gy, _, gx_sq, gy_sq = (develop(f, RES, RES).numpy() for f in films)
    for name, g, sq, axis in (("gx", gx, gx_sq, 1), ("gy", gy, gy_sq, 0)):
        np.testing.assert_array_equal(sq, g * g)
        keep = paired_pixels(RES, RES, axis)
        want_sq = (2.0 * np.asarray(j1[name])) ** 2
        assert_images_match(sq[keep][:, None], want_sq[keep][:, None], f"{name}_sq")
