"""PyTorch port, the fused route of GPT's reconnection shift
(integrators/gpt_reconnect.py): the plain versions of K9's roughness and
evaluation entries (integrators/fused_shade.py) against the per-kind
dispatch at the shift's three shade sites (_shade, _eval_conn, _eval_v),
the route rule (the base path and the shifts take trace_paths' route;
matbox, which does not bake, and the CPU's default keep the dispatch) and
its counters. The kernels against their plain versions are in
test_torch_gpu.py and chip_smoke.py."""
from pathlib import Path

import numpy as np
import pytest
import torch

from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch import stats as akr_stats
from akari_render_tpu_torch.config import GPTConfig
from akari_render_tpu_torch.integrators import common, gpt, gpt_reconnect
from akari_render_tpu_torch.integrators import fused_shade as fs
from akari_render_tpu_torch.scene import load_scene
from akari_render_tpu_torch.svm import reduced
from test_torch_megakernel import metal_blinds

ROOT = Path(__file__).resolve().parents[1]
SCENES = {name: ROOT / "scenes" / name / "scene.json" for name in ("blinds", "cbox", "matbox")}
N_LANES = 4096


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def table():
    return np.asarray(j_get_table("ggx_dielectric_s"))


def _inputs(ts, seed):
    """Seeded inputs of the three sites on N_LANES lanes (the recipe of
    tests/test_torch_fused_shade.py) and a mask of about 60 % of them, the
    lanes shaded: hit points, random unit wo and directions, light
    radiance and pdf, three uniforms."""
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    def unit():
        v = rng.normal(size=(N_LANES, 3))
        return t(v / np.linalg.norm(v, axis=-1, keepdims=True))

    si = ts.surface_interaction(t(rng.integers(0, ts.num_tris, N_LANES), torch.int64),
                                t(rng.random((N_LANES, 2)) * 0.45))
    ex = {"wo": unit(), "ls_wi": unit(), "ls_li": t(rng.random((N_LANES, 3)) * 3.0),
          "ls_pdf": t(rng.random(N_LANES) * 2.0 + 1e-3), "u_bsdf": t(rng.random((N_LANES, 3))),
          "wi": unit()}
    return si, ex, t(rng.random(N_LANES) < 0.6, torch.bool)


def _close_f_pdf(fa, pa, fb, pb, label):
    """f and pdf within 2 % relative, their ratio within 2e-3 (the
    tolerances of test_torch_fused_shade.py::test_plain_matches_dispatch_shade)."""
    fa, fb, pa, pb = (x.numpy() for x in (fa, fb, pa, pb))
    scale = np.maximum(np.maximum(np.abs(fa), np.abs(fb)), 1e-4)
    assert (np.abs(fa - fb) / scale).max() < 0.02, label
    assert (np.abs(pa - pb) / np.maximum(np.maximum(pa, pb), 1e-4)).max() < 0.02, label
    sel = (pa > 1e-4) & (pb > 1e-4)
    ra, rb = fa / np.maximum(pa, 1e-20)[..., None], fb / np.maximum(pb, 1e-20)[..., None]
    m = sel & (np.abs(ra).max(-1) < 1e3)
    assert np.abs(ra - rb)[m].max() < 2e-3, label
    return sel


@pytest.mark.parametrize("scene", ["blinds", "metal", "cbox"])
def test_plain_matches_dispatch_at_shift_sites(scene, table, tmp_path):
    """The plain versions of K9's roughness entry (fused_shade with
    roughness) and of its evaluation entry (fused_eval, one direction and
    two) against dispatch_shade of gpt_reconnect's _shade, _eval_conn and
    _eval_v, masked by the same lanes: direct within atol 5e-5, rtol 5e-4;
    f and pdf within 2 %; valid and the roughness equal on at least 99.9 %
    of the lanes; zeros on the lanes not shaded. On blinds (a slat of
    roughness 0.5), blinds with a metal layer, and cbox, the benchmark's
    scene (every material of roughness 1)."""
    path = SCENES.get(scene) or metal_blinds(tmp_path)
    ts = load_scene(str(path), 16, 16, device="cpu", ggx_table=table)
    assert ts.shade_bake is not None and ts.shade_bake[1]
    assert ts.shade_bake[2] == (scene == "metal")
    si, ex, lanes = _inputs(ts, 11)
    bake, frame, dead = ts.shade_bake, si["frame"], ~lanes

    want = common.dispatch_shade(ts, si, {k: ex[k] for k in ("wo", "ls_wi", "ls_li", "ls_pdf",
                                                             "u_bsdf")},
                                 gpt_reconnect._shade, lanes, gpt_reconnect._SHADE_SPEC)
    got = gpt_reconnect._shade_bounce(ts, True, si, ex, lanes)
    assert set(got) == {"direct", "wi", "f", "pdf", "valid", "roughness"}
    np.testing.assert_allclose(got["direct"].numpy(), want["direct"].numpy(), atol=5e-5,
                               rtol=5e-4)
    _close_f_pdf(want["f"], want["pdf"], got["f"], got["pdf"], "shade")
    va, vb = want["valid"].numpy(), got["valid"].numpy()
    assert (va == vb).mean() >= 0.999 and vb[lanes.numpy()].mean() > 0.3
    both = va & vb
    np.testing.assert_allclose(got["wi"].numpy()[both], want["wi"].numpy()[both], atol=2e-5)
    ra, rb = want["roughness"].numpy(), got["roughness"].numpy()
    assert (ra == rb).mean() >= 0.999
    live_r = rb[lanes.numpy()]
    assert (live_r == 1.0).any() and (live_r < 1.0).any() == (scene != "cbox")

    conn = common.dispatch_shade(ts, si, {"wo": ex["wo"], "wi": ex["wi"]},
                                 gpt_reconnect._eval_conn, lanes,
                                 (("f", (3,), torch.float32), ("pdf", (), torch.float32)))
    [(f1, p1)] = fs.fused_eval(bake, *frame, si["ng"], ex["wo"], (ex["wi"],), si["mat"],
                               live=lanes)
    sel = _close_f_pdf(conn["f"], conn["pdf"], f1, p1, "_eval_conn")
    assert sel.mean() > 0.2

    v = common.dispatch_shade(ts, si, {"wo": ex["wo"], "dwi": ex["ls_wi"], "wi": ex["wi"]},
                              gpt_reconnect._eval_v, lanes, ())
    (fd, pd), (f2, p2) = fs.fused_eval(bake, *frame, si["ng"], ex["wo"],
                                       (ex["ls_wi"], ex["wi"]), si["mat"], live=lanes)
    _close_f_pdf(v["fd"], v["pd"], fd, pd, "_eval_v fd")
    _close_f_pdf(v["f2"], v["pdf_y2"], f2, p2, "_eval_v f2")
    assert torch.equal(f2, f1) and torch.equal(p2, p1)  # one closure, the same direction
    for x in (*got.values(), f1, p1, fd, pd):
        assert not bool(x[dead].any())


def test_eval_is_shade_closure(table):
    """reduced_eval at the NEE direction is reduced_shade's own evaluation
    there, bit for bit: the direct light from it with the MIS weight equals
    reduced_shade's on every lane (one closure, one op order)."""
    ts = load_scene(str(SCENES["cbox"]), 16, 16, device="cpu", ggx_table=table)
    si, ex, _ = _inputs(ts, 12)
    sh = fs.fused_shade_torch(ts.shade_bake, *si["frame"], si["ng"], ex["wo"], ex["ls_wi"],
                              ex["ls_li"], ex["ls_pdf"], ex["u_bsdf"], si["mat"], roughness=True)
    [(f, pdf)] = fs.fused_eval_torch(ts.shade_bake, *si["frame"], si["ng"], ex["wo"],
                                     (ex["ls_wi"],), si["mat"])
    ls_pdf = ex["ls_pdf"]
    w = ls_pdf / torch.clamp(ls_pdf + pdf, min=1e-30)
    direct = ex["ls_li"] * f * (w / torch.clamp(ls_pdf, min=1e-20))[:, None]
    assert torch.equal(direct, sh["direct"])
    tab = ts.shade_bake[0]
    rough = tab[si["mat"].long(), reduced._MT_ROUGH]
    assert bool(((sh["roughness"] == rough) | (sh["roughness"] == 1.0)).all())


def _render(ts, fused: bool, monkeypatch, spp=1, max_depth=4):
    """render_gpt (the reconnection shift) with the route switch forced on
    or off for the lanes' device; the image, stats and counters."""
    monkeypatch.setattr(common, "fused_shade_enabled", lambda device: fused)
    akr_stats.reset()
    img, st = gpt.render_gpt(ts, GPTConfig(spp=spp, max_depth=max_depth), None,
                             shift_mode="reconnect")
    return img, st, akr_stats.snapshot()["counts"]


def test_route_on_cbox(table, monkeypatch):
    """cbox 16x16, 2 spp, d4 on the CPU: by default (the switch off) the
    base path and every shift shade through the dispatch, as in the JAX
    package; with the switch on, every call of the three sites takes the
    fused route (gpt_fused_shades > 0, no dispatch group): at least one a
    bounce of the base path and of each shift, and the films agree with the
    dispatch's (channel means within 2 %)."""
    ts = load_scene(str(SCENES["cbox"]), 16, 16, device="cpu", ggx_table=table)
    monkeypatch.delenv("AKR_PALLAS_SHADE", raising=False)
    assert not common.uses_fused_shade(ts, common.PTSettings())
    out = {}
    for fused in (False, True):
        out[fused] = _render(ts, fused, monkeypatch, spp=2)
    _, dst, dc = out[False]
    _, fst, fc = out[True]
    assert dst["shade"] == "dispatch" and dc["gpt_fused_shades"] == 0 and dc["dispatch_groups"] > 0
    assert fst["shade"] == "fused (K9)" and fc["dispatch_groups"] == 0
    assert fc["gpt_fused_shades"] >= fc["gpt_shifts"] + 2 and fc["gpt_shifts"] == 8
    for k in ("primal", "gx", "gy"):
        a, b = dst[k].mean((0, 1)), fst[k].mean((0, 1))
        scale = np.maximum(np.abs(dst[k]).mean((0, 1)), 1e-6)
        assert np.all(np.abs(a - b) <= 0.02 * scale), (k, a, b)


def test_matbox_keeps_dispatch(table, monkeypatch):
    """matbox, whose kinds do not bake, keeps the per-kind dispatch with the
    switch on: no fused call."""
    ts = load_scene(str(SCENES["matbox"]), 8, 8, device="cpu", ggx_table=table)
    assert ts.shade_bake is None
    _, st, c = _render(ts, True, monkeypatch, max_depth=2)
    assert st["shade"] == "dispatch" and c["gpt_fused_shades"] == 0 and c["dispatch_groups"] > 0
