"""PyTorch port, the fused shade K9 with its live mask
(integrators/fused_shade.py::fused_shade(..., live=...)): one call over the
whole wavefront, the live lanes shaded and zeros elsewhere.

- The masked plain version equals the compacted call (the live lanes
  gathered, shaded, scattered into zeros) bit for bit, with NaN planted in
  the dead lanes' inputs: a dead lane's inputs enter no arithmetic.
- The bounce loop's `_fused_shade_live`, now one masked call, gives on the
  CPU what its compacting form gave, bit for bit, on the bounces of a
  blinds 32^2 sample.
- JAX's pallas_shade (the Pallas kernel in interpret mode) on the live
  lanes of such a bounce agrees with the port's masked call there, to the
  tolerance of test_torch_fused_shade.py.

The CUDA kernel against the masked plain version is in test_torch_gpu.py
and chip_smoke.py (phase 11)."""
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu.integrators.pallas_shade import pallas_shade
from akari_render_tpu.scene import load_scene as j_load_scene
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch.config import RenderTask
from akari_render_tpu_torch.core.filters import filter_from_config
from akari_render_tpu_torch.integrators import common
from akari_render_tpu_torch.integrators import fused_shade as fs
from akari_render_tpu_torch.integrators.common import PTSettings
from akari_render_tpu_torch.integrators.pt import render_sample
from akari_render_tpu_torch.scene import load_scene

ROOT = Path(__file__).resolve().parents[1]
BLINDS = ROOT / "scenes/blinds/scene.json"
RES = 32
OUT_KEYS = ("direct", "wi", "f", "pdf", "valid", "albedo")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def table():
    return np.asarray(j_get_table("ggx_dielectric_s"))


@pytest.fixture(scope="module")
def bounces(table):
    """(scene, [(bake, si, extra, lanes)] of every K9 call of one path-B
    sample of blinds at 32^2, d12), cloned as the bounce loop hands them
    over."""
    sc = load_scene(str(BLINDS), RES, RES, device="cpu", ggx_table=table)
    task = RenderTask.from_file(ROOT / "scenes/blinds/pt.json")
    m = task.method
    settings = PTSettings(max_depth=m.max_depth, rr_depth=m.rr_depth, use_nee=m.use_nee,
                          clamp_indirect=m.clamp_indirect)
    real, calls = common._fused_shade_live, []

    def capture(bake, si, extra, lanes):
        calls.append((bake, {"frame": tuple(f.clone() for f in si["frame"]),
                             "ng": si["ng"].clone(), "mat": si["mat"].clone(),
                             "kind": si["kind"].clone()},
                      {k: v.clone() for k, v in extra.items()}, lanes.clone()))
        return real(bake, si, extra, lanes)

    old = os.environ.get("AKR_PALLAS_SHADE")
    os.environ["AKR_PALLAS_SHADE"] = "1"
    common._fused_shade_live = capture
    try:
        render_sample(sc, settings, filter_from_config(task.filter_config), 0, task.seed,
                      task.sampler)
    finally:
        common._fused_shade_live = real
        if old is None:
            os.environ.pop("AKR_PALLAS_SHADE")
        else:
            os.environ["AKR_PALLAS_SHADE"] = old
    assert len(calls) >= 3
    return sc, calls


def _args(si, extra):
    return (*si["frame"], si["ng"], *(extra[k] for k in ("wo", "ls_wi", "ls_li", "ls_pdf",
                                                          "u_bsdf")), si["mat"])


def _compacted(bake, si, extra, lanes):
    """The bounce loop's earlier form of _fused_shade_live: gather the live
    lanes, shade them, scatter into zeros."""
    n = lanes.shape[0]
    rows = torch.nonzero(lanes).squeeze(1)
    res = fs.fused_shade(bake, *(x[rows] for x in _args(si, extra)))
    out = {}
    for key, v in res.items():
        out[key] = torch.zeros((n,) + v.shape[1:], dtype=v.dtype, device=v.device)
        out[key][rows] = v
    return out


def _bits_equal(a, b):
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _seeded(sc, n, live_frac, seed):
    """n lanes of seeded blinds shade inputs (the recipe of
    test_torch_fused_shade.py) with a live mask; the dead lanes' inputs
    are NaN, as a missed ray's may be."""
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    def unit():
        v = rng.normal(size=(n, 3))
        return t(v / np.linalg.norm(v, axis=-1, keepdims=True))

    si = sc.surface_interaction(t(rng.integers(0, sc.num_tris, n), torch.int64),
                                t(rng.random((n, 2)) * 0.45))
    extra = {"wo": unit(), "ls_wi": unit(), "ls_li": t(rng.random((n, 3)) * 3.0),
             "ls_pdf": t(rng.random(n) * 2.0 + 1e-3), "u_bsdf": t(rng.random((n, 3)))}
    live = t(rng.random(n) < live_frac, torch.bool)
    si = {"frame": tuple(torch.where(live[:, None], f, float("nan")) for f in si["frame"]),
          "ng": torch.where(live[:, None], si["ng"], float("nan")), "mat": si["mat"]}
    extra = {k: torch.where(live.reshape((n,) + (1,) * (v.ndim - 1)), v, float("nan"))
             for k, v in extra.items()}
    return si, extra, live


@pytest.mark.parametrize("live_frac,mat_dtype", [(0.0, torch.int32), (0.37, torch.int32),
                                                 (0.37, torch.int64), (1.0, torch.int32)])
def test_masked_plain_matches_compacted(bounces, live_frac, mat_dtype):
    """fused_shade(..., live) on the CPU (the masked plain version) against
    the compacted call: every output bit-equal on the live lanes, exact
    zeros (and valid False) on the dead lanes, whose inputs are NaN."""
    sc, _ = bounces
    si, extra, live = _seeded(sc, 3000, live_frac, seed=21)
    si["mat"] = si["mat"].to(mat_dtype)
    got = fs.fused_shade(sc.shade_bake, *_args(si, extra), live=live)
    want = _compacted(sc.shade_bake, si, extra, live)
    for k in OUT_KEYS:
        assert _bits_equal(got[k], want[k]), k
        dead = got[k][~live]
        assert not bool(dead.any()) and not bool(torch.signbit(dead.float()).any()), k
        assert not bool(torch.isnan(got[k].float()).any()), k
    if live_frac > 0:
        assert float(got["valid"][live].float().mean()) > 0.3


def test_fused_shade_live_unchanged_on_cpu(bounces):
    """_fused_shade_live (one masked call) on every K9 call of a blinds
    32^2 sample gives, bit for bit, what the compacting form gave."""
    _, calls = bounces
    for bake, si, extra, lanes in calls:
        got = common._fused_shade_live(bake, si, extra, lanes)
        want = _compacted(bake, si, extra, lanes)
        assert set(got) == set(want)
        for k in OUT_KEYS:
            assert _bits_equal(got[k], want[k]), k


def test_bounce_inputs_need_no_copy(table, monkeypatch):
    """The bounce loop hands K9 rows the kernel reads in place: every
    [N, 3] input has inner stride 1 (the flat tier's ng is a strided view of
    the attribute rows), ls_pdf and the mask are contiguous, mat is int32."""
    seen = []
    real = fs.fused_shade

    def spy(*args, live=None):
        seen.append((args, live))
        return real(*args, live=live)

    monkeypatch.setattr(common, "fused_shade", spy)
    monkeypatch.setenv("AKR_PALLAS_SHADE", "1")
    sc = load_scene(str(BLINDS), 8, 8, device="cpu", ggx_table=table)
    task = RenderTask.from_file(ROOT / "scenes/blinds/pt.json")
    render_sample(sc, PTSettings(max_depth=1), filter_from_config(task.filter_config), 0,
                  task.seed, task.sampler)
    assert len(seen) == 1
    args, live = seen[0]
    for x in args[1:8] + args[9:10]:
        assert x.dtype == torch.float32 and x.stride(1) == 1 and x.stride(0) >= 3
    assert args[8].is_contiguous() and live.is_contiguous() and live.dtype == torch.bool
    assert args[10].dtype == torch.int32 and args[10].is_contiguous()


def test_masked_call_matches_pallas_shade_on_bounce(bounces, table):
    """JAX pallas_shade in interpret mode on the live lanes of the first
    bounce of a blinds 32^2 sample against the port's masked call there:
    valid equal on at least 99.9 % of lanes; every output within atol 1e-5
    and rtol 1e-4 (wi, f and pdf on the lanes whose valid agrees), and
    within 5e-6 absolute."""
    sc, calls = bounces
    bake, si, extra, lanes = calls[0]
    js = j_load_scene(str(BLINDS), RES, RES)
    rows = torch.nonzero(lanes).squeeze(1)
    assert 0 < rows.numel() < lanes.shape[0]
    jsi = {"frame": tuple(jnp.asarray(f[rows].numpy()) for f in si["frame"]),
           "ng": jnp.asarray(si["ng"][rows].numpy()), "mat": jnp.asarray(si["mat"][rows].numpy()),
           "kind": jnp.asarray(si["kind"][rows].numpy())}
    want = pallas_shade(js, jsi, {k: jnp.asarray(v[rows].numpy()) for k, v in extra.items()},
                        interpret=True)
    got = common._fused_shade_live(bake, si, extra, lanes)
    va, vb = np.asarray(want["valid"]), got["valid"][rows].numpy()
    assert (va == vb).mean() >= 0.999 and va.mean() > 0.3
    same = va == vb
    for k in ("direct", "albedo", "wi", "f", "pdf"):
        a, b = np.asarray(want[k]), got[k][rows].numpy()
        if k in ("wi", "f", "pdf"):
            a, b = a[same], b[same]
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=k)
        assert np.abs(b - a).max() < 5e-6, k
