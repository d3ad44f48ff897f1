"""PyTorch port, Kelemen PSSMLT: the bootstrap, the mutation steps and
render_mcmc on cbox, held against the JAX package on the CPU (its MCMC runs
outside Pallas)."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu.config import MCMCConfig as JMCMCConfig
from akari_render_tpu.core.film import Film as JFilm
from akari_render_tpu.core.filters import GaussianFilter as JGaussianFilter
from akari_render_tpu.core import sampling as j_sampling
from akari_render_tpu.core.samplers import IndependentSampler as JIndependentSampler
from akari_render_tpu.integrators import mcmc as jmcmc
from akari_render_tpu.scene import load_scene as j_load_scene
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch.config import MCMCConfig
from akari_render_tpu_torch.core.film import Film
from akari_render_tpu_torch.core import sampling as t_sampling
from akari_render_tpu_torch.core.filters import GaussianFilter
from akari_render_tpu_torch.core.samplers import IndependentSampler
from akari_render_tpu_torch.integrators import mcmc
from akari_render_tpu_torch.scene import load_scene as t_load_scene

ROOT = Path(__file__).resolve().parents[1]
CBOX = ROOT / "scenes/cbox/scene.json"
RES = 16
# a small configuration: d3, 256 chains from 1,024 bootstrap samples
CFG = dict(spp=4, max_depth=3, rr_depth=5, n_chains=256, n_bootstrap=1024, direct_spp=2,
           spp_per_pass=2)
SEED = 3


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    table = np.asarray(j_get_table("ggx_dielectric_s"))
    return (j_load_scene(str(CBOX), RES, RES),
            t_load_scene(str(CBOX), RES, RES, device="cpu", ggx_table=table))


@pytest.fixture(scope="module")
def boot(scenes):
    """Both packages' bootstrap_chains on the same configuration, with the
    resampled chain indices each drew."""
    js, ts = scenes
    out = {}
    for name, mod, scene, cfg in (("jax", jmcmc, js, JMCMCConfig(**CFG)),
                                  ("torch", mcmc, ts, MCMCConfig(**CFG))):
        settings, d = mod._mcmc_settings(cfg)
        filt = (JGaussianFilter if name == "jax" else GaussianFilter)(1.5)
        drawn = []
        orig = mod.resample_with_f64

        def spy(weights, us, orig=orig, drawn=drawn):
            drawn.append(orig(weights, us))
            return drawn[-1]

        mod.resample_with_f64 = spy
        try:
            res = mod.bootstrap_chains(scene, settings, filt, cfg, d, cfg.n_chains, SEED)
        finally:
            mod.resample_with_f64 = orig
        out[name] = (res, drawn[0], settings, filt, cfg, d)
    return out


def test_bootstrap_matches_jax(boot):
    """n_bootstrap 1,024 PSS vectors (seed ^ 0xB00) traced at d3: the 256
    resampled chain indices equal, b_init within 1e-5 relative, the chains'
    PSS bit-equal and their initial contributions within 1e-4 (measured on
    the CPU: b_init equal, the contributions within 7.3e-7)."""
    (jres, jidx, *_), (tres, tidx, *_) = boot["jax"], boot["torch"]
    np.testing.assert_array_equal(tidx, jidx)
    assert len(np.unique(tidx)) > 16
    np.testing.assert_allclose(tres[4], jres[4], rtol=1e-5)
    assert tres[4] > 0.0 and tres[5] == jres[5] == CFG["n_bootstrap"]
    np.testing.assert_array_equal(tres[0].numpy(), np.asarray(jres[0]))
    np.testing.assert_allclose(tres[3].numpy(), np.asarray(jres[3]), rtol=1e-4, atol=1e-6)


def test_gaussian_helpers_match_jax():
    """erf_inv, erf and sample_gaussian (the non-exponential and the image
    mutations) within 2e-6 of JAX's on 2^16 seeded inputs (their log and
    exp round differently in the last bit)."""
    u = np.random.default_rng(5).random(1 << 16, dtype=np.float32)
    x = u * 4.0 - 2.0
    for jf, tf, arg in ((j_sampling.erf_inv, t_sampling.erf_inv, u * 2.0 - 1.0),
                        (j_sampling.erf, t_sampling.erf, x),
                        (j_sampling.sample_gaussian, t_sampling.sample_gaussian, u)):
        want = np.asarray(jf(jnp.asarray(arg)))
        np.testing.assert_allclose(tf(torch.as_tensor(arg)).numpy(), want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("mutation", ["kelemen", "gaussian+image"])
def test_mutate_steps_match_jax(boot, scenes, mutation):
    """Four mutation steps from the same carry (JAX's bootstrapped chains,
    the chains' stream seed ^ 0xC4A1), with Kelemen's exponential small
    steps, and with Gaussian ones (sigma 0.01) and the image mutation (size
    0.05, probability 0.5): the PSS vectors bit-equal on >= 99 % of the
    chains (the Gaussian ones within 1e-6: erf_inv's log), the splat film
    and counters close (measured on the CPU: every chain's PSS, the
    acceptances and b equal in both, the splat sums within 1.2e-7)."""
    js, ts = scenes
    (jres, _, jset, jfilt, jcfg, d), (_, _, tset, tfilt, tcfg, _) = boot["jax"], boot["torch"]
    if mutation != "kelemen":
        extra = dict(exponential_mutation=False, image_mutation_size=0.05,
                     image_mutation_prob=0.5)
        jcfg, tcfg = JMCMCConfig(**CFG, **extra), MCMCConfig(**CFG, **extra)
    c = jcfg.n_chains
    jcarry = (jres[0], jres[1], jres[2], jres[3],
              JIndependentSampler.new(jnp.arange(c, dtype=jnp.uint32), seed=SEED ^ 0xC4A1).rng,
              JFilm.new(RES, RES), jnp.float32(0.0), jnp.int32(0), jnp.int32(0), jnp.int32(0))
    jstep = jmcmc.make_mutate_step(js, jset, jfilt, jcfg, d)
    jcarry = jax.jit(lambda cr: jax.lax.fori_loop(0, 4, jstep, cr))(jcarry)

    zero = torch.zeros((), dtype=torch.int64)
    tcarry = mcmc.Chains(*(torch.as_tensor(np.array(x)) for x in jres[:4]),
                         IndependentSampler.new(torch.arange(c), seed=SEED ^ 0xC4A1).rng,
                         Film.new(RES, RES, "cpu"), torch.zeros(()), zero, zero, zero)
    tstep = mcmc.make_mutate_step(ts, tset, tfilt, tcfg, d)
    for _ in range(4):
        tcarry = tstep(tcarry)
    tol = 0.0 if mutation == "kelemen" else 1e-6
    same = np.all(np.abs(tcarry.pss.numpy() - np.asarray(jcarry[0])) <= tol, axis=1)
    assert same.mean() >= 0.99
    assert int(tcarry.n_mut) == int(jcarry[9]) and int(tcarry.b_cnt) == int(jcarry[7])
    assert abs(int(tcarry.n_acc) - int(jcarry[8])) <= 0.01 * c * 4
    np.testing.assert_allclose(float(tcarry.b), float(jcarry[6]), rtol=1e-4)
    splat = tcarry.film.splat.numpy()
    np.testing.assert_allclose(splat.sum(0), np.asarray(jcarry[5].splat).sum(0), rtol=1e-3)


def test_render_mcmc_matches_jax(scenes):
    """render_mcmc on cbox 16x16, d3, 256 chains, 4 spp-equivalents, the
    direct pass at 2 spp: the image's channel means within 2 % of JAX's
    and the acceptance within 0.02 (measured on the CPU: the means, b and
    the acceptance equal)."""
    js, ts = scenes
    jimg, jstats = jmcmc.render_mcmc(js, JMCMCConfig(**CFG))
    timg, tstats = mcmc.render_mcmc(ts, MCMCConfig(**CFG))
    assert timg.shape == (RES, RES, 3) and np.all(np.isfinite(timg))
    assert tstats["steps"] == RES * RES * CFG["spp"] // CFG["n_chains"]
    assert tstats["spp_total"] == jstats["spp_total"] and tstats["shade"] == "dispatch"
    np.testing.assert_allclose(timg.mean(axis=(0, 1)), jimg.mean(axis=(0, 1)), rtol=0.02)
    assert abs(tstats["acceptance"] - jstats["acceptance"]) <= 0.02
    np.testing.assert_allclose(tstats["b"], jstats["b"], rtol=0.02)
