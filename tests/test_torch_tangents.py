"""PyTorch port, stored tangent frames (the JAX package's TestTangents,
tests/test_scene.py:297-339, on the port's scenegraph/write.py and
scene.py::_finish_si): stored per-corner tangents win over the dpdu
tangent on every lane, a mesh without them gets the generated (smoothed
dpdu) tangents, and the shading frames equal the JAX package's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu.accel.flatten import _generate_tangents as j_generate_tangents
from akari_render_tpu.scene import load_scene as j_load_scene
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch.accel.flatten import _generate_tangents as t_generate_tangents
from akari_render_tpu_torch.scene import load_scene as t_load_scene
from akari_render_tpu_torch.scenegraph.write import SceneBuilder
from torch_shader_scene import principled_graph

N = 512


@pytest.fixture(scope="module")
def jax_table():
    return np.asarray(j_get_table("ggx_dielectric_s"))


def _quad_scene(tmp_path, tangents):
    """A unit quad in z = 0 (two triangles, uv dpdu = +x), principled, with
    the given per-corner tangents [6, 3] or none."""
    b = SceneBuilder()
    v = np.asarray([(-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.uint32)
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]], np.float32)
    b.add_mesh("quad", v, idx, uvs=uv, tangents=tangents)
    b.add_material("m", principled_graph((0.5, 0.5, 0.5)))
    b.add_instance("q", "quad", np.eye(4).tolist(), ["m"])
    b.set_camera_perspective(transform_matrix=np.eye(4), width=8, height=8)
    return str(b.write(tmp_path / "tan", compact=True))


def _frames(path, table):
    """(port frame, JAX frame): numpy [3, N, 3] at N seeded points spread
    over both triangles."""
    rng = np.random.default_rng(8)
    tri = rng.integers(0, 2, N).astype(np.int32)
    b = rng.uniform(0.0, 1.0, (N, 2)).astype(np.float32)
    b = np.where(b.sum(-1, keepdims=True) > 1.0, 1.0 - b, b)  # inside the triangle
    t_si = t_load_scene(path, device="cpu", ggx_table=table).surface_interaction(
        torch.as_tensor(tri).long(), torch.as_tensor(b))
    j_si = j_load_scene(path).surface_interaction(jnp.asarray(tri), jnp.asarray(b))
    return (np.stack([f.numpy() for f in t_si["frame"]]),
            np.stack([np.asarray(f) for f in j_si["frame"]]))


def test_stored_tangent_wins_over_dpdu(tmp_path, jax_table):
    """uv gives dpdu = +x; the stored +y wins on every lane."""
    t, j = _frames(_quad_scene(tmp_path, np.tile(np.float32([0, 1, 0]), (6, 1))), jax_table)
    np.testing.assert_allclose(t[0], np.tile([0.0, 1.0, 0.0], (N, 1)), atol=1e-5)
    np.testing.assert_allclose(t, j, atol=1e-6)


def test_stored_tangents_never_fall_back(tmp_path, jax_table):
    """Per-corner tangents of different in-plane directions: every lane's
    tangent is its interpolated stored tangent, normalised (none is the
    dpdu +x), and equals JAX's."""
    ang = np.float32([0.3, 0.9, 1.4, 0.3, 1.4, 2.0])  # corners 0-2, then 0, 2, 3
    stored = np.stack([np.cos(ang), np.sin(ang), np.zeros(6)], -1).astype(np.float32)
    t, j = _frames(_quad_scene(tmp_path, stored), jax_table)
    np.testing.assert_allclose(t, j, atol=1e-6)
    assert np.all(np.abs(t[0, :, 1]) > 0.25)  # far from +x everywhere
    np.testing.assert_allclose(np.linalg.norm(t[0], axis=-1), 1.0, atol=1e-6)


def test_no_tangents_uses_generated(tmp_path, jax_table):
    """Without stored tangents the generated ones (smoothed dpdu) give +x,
    as in the JAX package."""
    t, j = _frames(_quad_scene(tmp_path, None), jax_table)
    np.testing.assert_allclose(np.abs(t[0, :, 0]), 1.0, atol=1e-4)
    np.testing.assert_allclose(t, j, atol=1e-6)


def test_generated_tangents_smooth_on_sphere():
    """JAX's sphere case on the port's copy of the generator: equal to
    JAX's, welded by vertex, unit and nearly orthogonal to the normal."""
    th_, ph_ = np.meshgrid(np.linspace(0, np.pi, 9), np.linspace(0, 2 * np.pi, 17), indexing="ij")
    V = np.stack([np.sin(th_) * np.cos(ph_), np.cos(th_), np.sin(th_) * np.sin(ph_)],
                 -1).reshape(-1, 3)
    I = []
    for i in range(8):
        for k in range(16):
            a, c = i * 17 + k, (i + 1) * 17 + k
            I += [[a, c, c + 1], [a, c + 1, a + 1]]
    I = np.asarray(I, np.int64)
    th = np.arccos(np.clip(V[:, 1], -1, 1))
    ph = np.arctan2(V[:, 2], V[:, 0])
    uvs = np.stack([ph / (2 * np.pi) + 0.5, th / np.pi], -1)[I.reshape(-1)].reshape(len(I), 3, 2)
    tan = t_generate_tangents(V, I, uvs)
    np.testing.assert_array_equal(tan, j_generate_tangents(V, I, uvs))
    flat, ids = tan.reshape(-1, 3), I.reshape(-1)
    for vid in np.unique(ids)[:20]:
        rows = flat[ids == vid]
        assert np.abs(rows - rows[0]).max() < 1e-12
    ok = np.linalg.norm(flat, axis=-1) > 0.5
    assert ok.mean() > 0.9
    assert np.quantile(np.abs((flat * V[ids]).sum(-1))[ok], 0.9) < 0.3
