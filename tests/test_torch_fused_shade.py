"""PyTorch port, the fused shade (integrators/fused_shade.py): K9's plain
version against the JAX package's pallas_shade (the Pallas kernel in
interpret mode) and against the port's own per-kind dispatch_shade, the
route rule (K9 by default for lanes on the card, opt-in on the CPU) and
its counters, and the AKR_PALLAS_SHADE routing against JAX's render. The
CUDA kernel against its plain version is in test_torch_gpu.py and
chip_smoke.py."""
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu.config import RenderTask as JRenderTask
from akari_render_tpu.integrators.pallas_shade import pallas_shade
from akari_render_tpu.integrators.pt import render_pt as j_render_pt
from akari_render_tpu.scene import load_scene as j_load_scene
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch import stats as akr_stats
from akari_render_tpu_torch.config import RenderTask
from akari_render_tpu_torch.core.sampling import mis_weight
from akari_render_tpu_torch.integrators import common
from akari_render_tpu_torch.integrators import fused_shade as fs
from akari_render_tpu_torch.integrators.pt import render_pt
from akari_render_tpu_torch.scene import load_scene
from test_torch_megakernel import metal_blinds

ROOT = Path(__file__).resolve().parents[1]
BLINDS = ROOT / "scenes/blinds/scene.json"
CBOX = ROOT / "scenes/cbox/scene.json"  # the source of the benchmark's scene
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


def _inputs(num_tris, n=N_LANES, seed=0):
    """Seeded shade inputs (the recipe of tests/test_pallas_shade.py, drawn
    with numpy): hit points, random unit wo and light directions, light
    radiance and pdf, three uniforms."""
    rng = np.random.default_rng(seed)

    def unit():
        v = rng.normal(size=(n, 3))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)

    tri = rng.integers(0, num_tris, n).astype(np.int32)
    bary = (rng.random((n, 2)) * 0.45).astype(np.float32)
    extra = {"wo": unit(), "ls_wi": unit(),
             "ls_li": (rng.random((n, 3)) * 3.0).astype(np.float32),
             "ls_pdf": (rng.random(n) * 2.0 + 1e-3).astype(np.float32),
             "u_bsdf": rng.random((n, 3)).astype(np.float32)}
    return tri, bary, extra


def _port_shade(ts, tri, bary, extra):
    si = ts.surface_interaction(torch.as_tensor(tri), torch.as_tensor(bary))
    ex = {k: torch.as_tensor(v) for k, v in extra.items()}
    got = fs.fused_shade(ts.shade_bake, *si["frame"], si["ng"], ex["wo"], ex["ls_wi"], ex["ls_li"],
                         ex["ls_pdf"], ex["u_bsdf"], si["mat"])
    return si, ex, got


@pytest.mark.parametrize("variant", ["blinds", "metal", "cbox"])
def test_plain_matches_pallas_shade(variant, table, tmp_path):
    """fused_shade on CPU tensors (the plain version) against JAX's
    pallas_shade in interpret mode on 4,096 lanes: valid equal on at least
    99.9 % of lanes; every output within atol 1e-5 and rtol 1e-4 (wi, f
    and pdf on the lanes whose valid agrees: a flipped sample draws another
    direction). On the CPU valid is equal on every lane and every output
    is within 5e-6 absolute. On blinds, blinds with a metal layer, and
    cbox, the benchmark's scene (eight principled materials with the
    specular layer)."""
    path = {"blinds": BLINDS, "cbox": CBOX}.get(variant) or metal_blinds(tmp_path)
    js = j_load_scene(str(path), 16, 16)
    ts = load_scene(str(path), 16, 16, device="cpu", ggx_table=table)
    assert ts.shade_bake[2] == (variant == "metal")
    tri, bary, extra = _inputs(ts.num_tris)
    jsi = js.surface_interaction(jnp.asarray(tri), jnp.asarray(bary))
    want = pallas_shade(js, jsi, {k: jnp.asarray(v) for k, v in extra.items()}, interpret=True)
    _, _, got = _port_shade(ts, tri, bary, extra)
    va, vb = np.asarray(want["valid"]), got["valid"].numpy()
    assert (va == vb).mean() >= 0.999 and va.mean() > 0.3
    same = va == vb
    for k in ("direct", "albedo", "wi", "f", "pdf"):
        a, b = np.asarray(want[k]), got[k].numpy()
        if k in ("wi", "f", "pdf"):
            a, b = a[same], b[same]
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=k)
        assert np.abs(b - a).max() < 5e-6, k
    assert same.all() and (got["f"].numpy().max(-1) > 0).mean() > 0.3


@pytest.mark.parametrize("path", [BLINDS, CBOX], ids=["blinds", "cbox"])
def test_plain_matches_dispatch_shade(path, table):
    """K9's plain version against the port's per-kind closures
    (dispatch_shade) with the tolerances of tests/test_pallas_shade.py:
    direct and albedo within atol 5e-5, rtol 5e-4; f and pdf within 2 %
    relative, their ratio within 2e-3; valid equal on 99.9 % of lanes. On
    blinds and on cbox, the benchmark's scene (eight principled materials
    with the specular layer)."""
    ts = load_scene(str(path), 16, 16, device="cpu", ggx_table=table)
    assert ts.shade_bake is not None and ts.shade_bake[1]
    tri, bary, extra = _inputs(ts.num_tris, seed=3)
    si, ex, got = _port_shade(ts, tri, bary, extra)

    def shade(closure, e):
        f_l, pdf_l = closure.evaluate(e["wo"], e["ls_wi"])
        w = mis_weight(e["ls_pdf"], pdf_l)
        out = {"direct": e["ls_li"] * f_l * (w / torch.clamp(e["ls_pdf"], min=1e-20))[..., None]}
        out.update(closure.sample(e["wo"], e["u_bsdf"][..., 0], e["u_bsdf"][..., 1:]))
        out["albedo"] = closure.albedo(e["wo"])
        return out

    ref = common.dispatch_shade(ts, si, ex, shade, torch.ones(N_LANES, dtype=torch.bool))
    for k in ("direct", "albedo"):
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=5e-5, rtol=5e-4, err_msg=k)
    fa, fb = ref["f"].numpy(), got["f"].numpy()
    pa, pb = ref["pdf"].numpy(), got["pdf"].numpy()
    assert (np.abs(fa - fb) / np.maximum(np.maximum(np.abs(fa), np.abs(fb)), 1e-4)).max() < 0.02
    assert (np.abs(pa - pb) / np.maximum(np.maximum(pa, pb), 1e-4)).max() < 0.02
    sel = (pa > 1e-4) & (pb > 1e-4)
    ra, rb = fa / np.maximum(pa, 1e-20)[..., None], fb / np.maximum(pb, 1e-20)[..., None]
    m = sel & (np.abs(ra).max(-1) < 1e3)
    assert np.abs(ra - rb)[m].max() < 2e-3
    va, vb = ref["valid"].numpy(), got["valid"].numpy()
    assert (va == vb).mean() > 0.999
    both = va & vb
    np.testing.assert_allclose(got["wi"].numpy()[both], ref["wi"].numpy()[both], atol=2e-5)


def test_routed_render_matches_jax(table, monkeypatch):
    """blinds 16^2, 4 spp, d12 with AKR_PALLAS_SHADE=1 through the port (K9's
    plain version on the CPU, every live lane of every bounce) against
    JAX's render with AKR_PALLAS_SHADE=force (the Pallas kernel in
    interpret mode), at the tolerance of the matbox slice test: channel
    means within 1 %, at least 95 % of pixels within 1e-3 relative."""
    task = RenderTask.from_file(ROOT / "scenes/blinds/pt.json")
    jtask = JRenderTask.from_file(ROOT / "scenes/blinds/pt.json")
    for t in (task, jtask):
        t.method.spp = t.method.spp_per_pass = 4
    monkeypatch.setenv("AKR_PALLAS_SHADE", "force")
    jimg = np.asarray(j_render_pt(j_load_scene(str(BLINDS), 16, 16), jtask.method, jtask)[0])
    monkeypatch.setenv("AKR_PALLAS_SHADE", "1")
    ts = load_scene(str(BLINDS), 16, 16, device="cpu", ggx_table=table)
    akr_stats.counts.update(bounces=0, dispatch_groups=0)
    timg, stats = render_pt(ts, task.method, task)
    assert stats["shade"] == "fused (K9)" and stats["tier"] == "wavefront"
    assert akr_stats.counts["bounces"] > 0 and akr_stats.counts["dispatch_groups"] == 0
    assert np.all(np.isfinite(timg)) and os.environ["AKR_PALLAS_SHADE"] == "1"
    np.testing.assert_allclose(timg.mean(axis=(0, 1)), jimg.mean(axis=(0, 1)), rtol=0.01)
    rel = np.abs(timg - jimg) / np.maximum(np.abs(jimg), 1e-3)
    assert np.mean(np.all(rel <= 1e-3, axis=-1)) >= 0.95


def test_switch_off_and_force_diffuse_take_dispatch(table, monkeypatch):
    """On the CPU without the switch or with it at "0" (the default there is
    unchanged), or with force_diffuse, the per-kind dispatch shades (the
    JAX package's routing rule)."""
    ts = load_scene(str(BLINDS), 8, 8, device="cpu", ggx_table=table)
    task = RenderTask.from_file(ROOT / "scenes/blinds/pt.json")
    task.method.spp = task.method.spp_per_pass = 1
    task.method.max_depth = 2
    monkeypatch.delenv("AKR_PALLAS_SHADE", raising=False)
    assert render_pt(ts, task.method, task)[1]["shade"] == "dispatch"
    monkeypatch.setenv("AKR_PALLAS_SHADE", "0")
    assert render_pt(ts, task.method, task)[1]["shade"] == "dispatch"
    monkeypatch.setenv("AKR_PALLAS_SHADE", "1")
    task.method.force_diffuse = True
    akr_stats.counts.update(bounces=0, dispatch_groups=0)
    assert render_pt(ts, task.method, task)[1]["shade"] == "dispatch"
    assert akr_stats.counts["bounces"] > 0 and akr_stats.counts["dispatch_groups"] > 0


@pytest.mark.parametrize("switch", [None, "0", "1"])
def test_route_rule_by_device(table, monkeypatch, switch):
    """uses_fused_shade on a scene that bakes, with the lanes' device given
    as a stand-in (torch.device("cuda") allocates nothing): on the card K9
    unless AKR_PALLAS_SHADE=0, on the CPU only with the switch set to
    anything but "0"; with force_diffuse, NEE off, spectral transport or
    no bake, neither device."""
    ts = load_scene(str(BLINDS), 8, 8, device="cpu", ggx_table=table)
    if switch is None:
        monkeypatch.delenv("AKR_PALLAS_SHADE", raising=False)
    else:
        monkeypatch.setenv("AKR_PALLAS_SHADE", switch)
    card = torch.device("cuda")
    on = common.PTSettings()
    assert common.uses_fused_shade(ts, on, card) == (switch != "0")
    assert fs.fused_shade_enabled("cuda") == (switch != "0")
    assert common.uses_fused_shade(ts, on) == common.uses_fused_shade(ts, on, "cpu") \
        == (switch == "1")
    assert fs.fused_shade_enabled("cpu") == (switch == "1")
    for off in (common.PTSettings(force_diffuse=True), common.PTSettings(use_nee=False),
                common.PTSettings(color="spectral")):
        assert not common.uses_fused_shade(ts, off, card)
    monkeypatch.setattr(ts, "shade_bake", None)
    assert not common.uses_fused_shade(ts, on, card)


@pytest.mark.parametrize("switch", ["1", "0"])
def test_route_counts_on_cpu(table, monkeypatch, switch):
    """blinds 8^2, 2 spp, d12 on the CPU: with the switch set every bounce
    is shaded through K9 (fused_shades == bounces, no dispatch group, no
    nonzero read), at "0" every group through the dispatch (fused_shades
    0; blinds has one kind, so a group a bounce that shades a live lane)."""
    ts = load_scene(str(BLINDS), 8, 8, device="cpu", ggx_table=table)
    task = RenderTask.from_file(ROOT / "scenes/blinds/pt.json")
    task.method.spp = task.method.spp_per_pass = 2
    monkeypatch.setenv("AKR_PALLAS_SHADE", switch)
    akr_stats.reset()
    img, stats = render_pt(ts, task.method, task)
    c = akr_stats.snapshot()["counts"]
    assert np.all(np.isfinite(img)) and img.mean() > 0.0 and c["bounces"] > 0
    if switch == "1":
        assert stats["shade"] == "fused (K9)"
        assert c["fused_shades"] == c["bounces"] and c["dispatch_groups"] == 0
    else:
        assert stats["shade"] == "dispatch" and len(ts.kinds) == 1
        assert c["fused_shades"] == 0 and 0 < c["dispatch_groups"] <= c["bounces"]
