"""K2, the pair sweep's conservative cull, and the cases its kernel takes
(csrc/pairs.cu::cull_kernel; accel/pairs.py::cull_einit_cased_torch is the
kernel step for step in torch): dead blocks culled whole, and the sign
cases, where an axis's inverse-direction interval lies strictly on one
side of zero and each end of the axis's interval product is the least
(largest) of 4 products, not 8.

- The twin must give the bits of the plain chain (`cull_einit_torch`,
  compared as int32 views: -0 and +0 differ) on classroom's block
  summaries (camera, shadow and bounce rays), on their 32-lane warp
  summaries (K3's, where an all-dead warp has +-inf limits), and on
  adversarial summaries: intervals touching and straddling zero, signed
  zero bounds, an origin on a box bound (a zero product), underflow and
  overflow, dead blocks, |inv| near 1e20, empty and NaN boxes.
- The plain chain must equal the JAX package's `_cull_einit` in interpret
  mode, compiled unfused, on the same inputs.

The CUDA kernel against the plain chain is in test_torch_gpu.py and
chip_smoke.py (phases 7 and 9), with the count of differing bit patterns."""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from akari_render_tpu.accel import pairs as jp
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch.accel import pairs as tp
from akari_render_tpu_torch.camera import generate_rays
from akari_render_tpu_torch.core.math import RAY_TMAX
from akari_render_tpu_torch.integrators.common import nee_light_sample
from akari_render_tpu_torch.scene import load_scene
from torch_cull_rays import adversarial_summaries

ROOT = Path(__file__).resolve().parents[1]
CLASSROOM = ROOT / "scenes/classroom/scene.json"


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _bit_diffs(a, b) -> int:
    return int((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)).sum())


@pytest.fixture(scope="module")
def classroom():
    """(cb6, {label: block summaries}, {label: warp summaries}) of
    classroom: 1,536 camera rays from the middle rows of its 1080p film,
    the shadow rays of NEE from their hits and bounce rays from the hits,
    each sorted into blocks as intersect_pairs sorts them."""
    table = np.asarray(j_get_table("ggx_dielectric_s"))
    sc = load_scene(str(CLASSROOM), 96, 96, device="cpu", ggx_table=table)
    cl = sc.arrays.unified
    rng = np.random.default_rng(4)
    n = 1536
    cam = sc.camera
    p = np.stack([rng.uniform(0, cam.width, n), cam.height * 0.5 + rng.uniform(-60, 60, n)], -1)
    o_c, d_c = generate_rays(cam, _t(p))
    tmin = torch.full((n,), 1e-4)
    h = tp.intersect_pairs(cl, o_c, d_c, tmin, torch.full((n,), RAY_TMAX))
    si = sc.surface_interaction(h.tri_id, h.bary)
    ls = nee_light_sample(sc, si, _t(rng.random((n, 3))), h.valid)
    d_b = _t(rng.normal(size=(n, 3)))
    d_b /= d_b.norm(dim=1, keepdim=True)
    d_b = torch.where(((d_b * d_c).sum(1) > 0)[:, None], -d_b, d_b)
    hit_p = o_c + d_c * torch.where(h.valid, h.t, 0.0)[:, None]
    rays = {"camera": (o_c, d_c, torch.full((n,), RAY_TMAX)),
            "shadow": (ls.shadow_ro, ls.wi, torch.where(ls.valid & h.valid, ls.shadow_dist, -1.0)),
            "bounce": (hit_p, d_b, torch.where(h.valid & _t(rng.random(n) < 0.8, torch.bool), RAY_TMAX,
                                           -1.0))}
    blocks, warps = {}, {}
    for label, (o, d, tmax) in rays.items():
        s = tp.sort_rays(cl, o, d, tmin, tmax)
        blocks[label] = s.summ
        warps[label] = tp._warp_lanes(s.o_soa, s.inv_soa, s.lim)[-1].reshape(-1, 16)
    return tp.cluster_bounds(cl), blocks, warps


@pytest.mark.parametrize("label", ["camera", "shadow", "bounce"])
def test_cased_twin_bit_equal_on_classroom(classroom, label):
    """The twin against the chain, bit for bit, on classroom's block and
    warp summaries; the sign cases take elements, and the warps of the
    bounce rays' dead lanes are dead rows."""
    cb6, blocks, warps = classroom
    tally = {}
    for summ in (blocks[label], warps[label]):
        got = tp.cull_einit_cased_torch(summ, cb6, tally)
        want = tp.cull_einit_torch(summ, cb6)
        assert _bit_diffs(got, want) == 0
        assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert tally["cased"] - tally["fallback"] > 0
    if label == "bounce":  # the warps of its dead lanes, sorted last
        assert tally["dead"] > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cased_twin_bit_equaladversarial_summaries(seed):
    """The twin against the chain, bit for bit, on adversarial summaries
    and boxes; every kind of row and the per-element fallback occur."""
    summ, cb6 = adversarial_summaries(seed)
    tally = {}
    got = tp.cull_einit_cased_torch(summ, cb6, tally)
    want = tp.cull_einit_torch(summ, cb6)
    assert _bit_diffs(got, want) == 0
    assert tally["dead"] > 0 and tally["full"] > 0 and tally["fallback"] > 0
    assert tally["cased"] - tally["fallback"] > 0
    assert bool((got == 0).any()) and bool(torch.isfinite(got).any())
    dead, cased = tp.cull_row_cases(summ)
    assert bool(dead.any()) and bool(cased.any()) and bool((summ[cased, 9:12] < 0).any())


def _jax_cull(summ, cb6):
    fn = jax.jit(lambda s, c: jp._cull_einit(s, c, interpret=True),
                 compiler_options={"xla_backend_optimization_level": 0})
    return np.asarray(fn(summ.numpy(), cb6.numpy()))


@pytest.mark.parametrize("inputs", ["classroom", "adversarial"])
def test_cull_plain_matches_jax(classroom, inputs):
    """cull_einit_torch against the JAX package's _cull_einit in interpret
    mode (compiled unfused, as tests/test_torch_pairs.py compiles it) on
    classroom's shadow-ray warp summaries and on adversarial inputs without
    denormal origins (XLA on the CPU flushes denormals to zero, torch does
    not) and without the three special boxes."""
    if inputs == "classroom":
        cb6, _, warps = classroom
        summ = warps["shadow"]
    else:
        summ, cb6 = adversarial_summaries(5, B=48, tiny=False)
        cb6 = cb6[:, 3:]
    want = _jax_cull(summ, cb6)
    got = tp.cull_einit_torch(summ, cb6).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got).any() and np.isfinite(got).any()
