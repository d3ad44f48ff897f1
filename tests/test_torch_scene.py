"""PyTorch port, scene assembly: load_scene's arrays against the JAX
package's, surface interactions, the interop path, emission power, and the
scenes the port refuses or newly accepts."""
import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu import scene as j_scene
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch import scene as t_scene
from akari_render_tpu_torch.interop import scene_arrays_from_numpy

ROOT = Path(__file__).resolve().parents[1]
MATBOX = ROOT / "scenes/matbox/scene.json"
ACCEL_FIELDS = ("bvh", "instanced", "unified")  # None on matbox (flat tier)
LIGHT_FIELDS = ("sel_prob", "sel_alias", "sel_pdf", "tri_prob", "tri_alias", "tri_pdf",
                "tri_ids", "offset", "count", "tri_prim_pdf", "tri_light_id", "attr")


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
    js = j_scene.load_scene(str(MATBOX), 48, 40)
    ts = t_scene.load_scene(str(MATBOX), 48, 40, device="cpu", ggx_table=table)
    return js, ts, table


def jax_arrays_numpy(js) -> dict:
    """The JAX SceneArrays as plain numpy, in the interop layout."""
    a = js.arrays
    out = {f: (None if getattr(a, f) is None else np.asarray(getattr(a, f)))
           for f in t_scene.SceneArrays._fields if f not in ("param_mats", "lights")}
    out["param_mats"] = [np.asarray(m) for m in a.param_mats]
    out["lights"] = {k: np.asarray(getattr(a.lights, k)) for k in LIGHT_FIELDS}
    return out


def test_load_scene_arrays_exact(scenes):
    js, ts, _ = scenes
    assert ts.num_tris == js.num_tris == 4620
    assert [k.nodes for k in ts.kinds] == [k.nodes for k in js.kinds]
    assert ts.material_names == js.material_names
    ref = jax_arrays_numpy(js)
    for f in t_scene.SceneArrays._fields:
        got = getattr(ts.arrays, f)
        if f in ACCEL_FIELDS:
            assert got is None and ref[f] is None, f
        elif f == "param_mats":
            for g, r in zip(got, ref[f]):
                np.testing.assert_array_equal(g.numpy(), r)
        elif f == "lights":
            for k in LIGHT_FIELDS:
                np.testing.assert_array_equal(getattr(got, k).numpy(), ref[f][k], err_msg=k)
        else:
            np.testing.assert_array_equal(got.numpy(), ref[f].astype(got.numpy().dtype), err_msg=f)
    for a, b in zip(ts.kind_const_ranges, js.kind_const_ranges):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ts.atlas.data.numpy(), np.asarray(js.atlas.data))
    for f in ("c2w", "w2c", "r2c"):
        np.testing.assert_array_equal(getattr(ts.camera, f).numpy(), np.asarray(getattr(js.camera, f)))


def test_interop_rebuilds_the_same_arrays(scenes):
    js, ts, table = scenes
    arrays, tables = scene_arrays_from_numpy(jax_arrays_numpy(js), {"ggx_dielectric_s": table}, "cpu")
    for f in t_scene.SceneArrays._fields:
        got, want = getattr(arrays, f), getattr(ts.arrays, f)
        if f in ACCEL_FIELDS:
            assert got is None and want is None, f
        elif f == "param_mats":
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        elif f == "lights":
            assert all(torch.equal(getattr(got, k), getattr(want, k)) for k in LIGHT_FIELDS)
        else:
            assert got.dtype == want.dtype and torch.equal(got, want), f
    assert torch.equal(tables["ggx_dielectric_s"], ts.ggx_table)


def test_surface_interaction_matches(scenes, rng_np):
    js, ts, _ = scenes
    tri = rng_np.integers(0, js.num_tris, 5000).astype(np.int32)
    bary = rng_np.random((5000, 2)).astype(np.float32) * 0.5
    jsi = js.surface_interaction(jnp.asarray(tri), jnp.asarray(bary))
    tsi = ts.surface_interaction(torch.as_tensor(tri), torch.as_tensor(bary))
    for k in ("kind", "mat", "light_id", "tri_id"):
        np.testing.assert_array_equal(tsi[k].numpy(), np.asarray(jsi[k]), err_msg=k)
    for k in ("p", "ng", "ns", "uv", "area", "prim_pdf"):
        np.testing.assert_allclose(tsi[k].numpy(), np.asarray(jsi[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    for a, b in zip(tsi["frame"], jsi["frame"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_mc_emission_power_matches(scenes):
    """The MC emission estimate (used for texture-driven emitters) draws the
    same PCG samples and gives the JAX package's powers."""
    js, ts, _ = scenes
    tri_ids = np.asarray(js.arrays.lights.tri_ids)
    jp = j_scene._mc_emission_power(js, tri_ids, n_samples=16)
    tp = t_scene._mc_emission_power(ts, tri_ids, n_samples=16)
    np.testing.assert_allclose(tp, jp, rtol=1e-5)


def _scene_copy(tmp_path, edit):
    dst = tmp_path / "scene"
    shutil.copytree(MATBOX.parent, dst)
    doc = json.loads((dst / "scene.json").read_text())
    edit(doc)
    (dst / "scene.json").write_text(json.dumps(doc))
    return dst / "scene.json"


def test_unported_shader_op_is_refused(tmp_path, scenes, monkeypatch):
    """load_scene refuses a kind with an op outside svm/eval.py's
    PORTED_OPS. Every op of the compiler is ported now (noise, which this
    scene uses, since PR 12), so the scene loads; with noise taken out of
    PORTED_OPS the same scene is refused."""
    from akari_render_tpu_torch.svm import eval as t_eval

    _, _, table = scenes

    def to_noise(doc):
        nodes = doc["materials"]["checker"]["shader"]["nodes"]
        scale = next(k for k, n in nodes.items() if n["type"] == "float")
        nodes["noise_tex"] = {"type": "noise", "dim": 2, "scale": {"id": scale}}
        for n in nodes.values():
            if n["type"] == "checkerboard":
                n["color1"] = {"id": "noise_tex"}

    path = str(_scene_copy(tmp_path, to_noise))
    scene = t_scene.load_scene(path, 8, 8, device="cpu", ggx_table=table)
    assert any(node[0] == "noise" for kind in scene.kinds for node in kind.nodes)
    monkeypatch.setattr(t_eval, "PORTED_OPS", t_eval.PORTED_OPS - {"noise"})
    with pytest.raises(NotImplementedError, match="noise"):
        t_scene.load_scene(path, 8, 8, device="cpu", ggx_table=table)


def test_instanced_geometry_takes_unified_sweep(tmp_path, scenes):
    """A second instance of the metal ball makes it instanced: both
    instances stay in local space and the unified pair sweep covers them,
    as in the JAX package (the flat part stays below the cluster tier)."""
    js, _, table = scenes

    def duplicate_metal_ball(doc):
        doc["instances"]["metal_copy"] = dict(doc["instances"]["metal_i"])

    path = _scene_copy(tmp_path, duplicate_metal_ball)
    skip, specs, _ = t_scene._partition_instances(t_scene.load_scene_json(path))
    assert skip == {"metal_i", "metal_copy"} and len(specs) == 2
    ts = t_scene.load_scene(str(path), 8, 8, device="cpu", ggx_table=table)
    a = ts.arrays
    assert a.bvh is None and a.instanced is not None and a.unified is not None
    assert a.unified.xf is not None and ts.num_tris < js.num_tris
