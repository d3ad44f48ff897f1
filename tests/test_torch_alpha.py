"""PyTorch port, the alpha-tested traversal (Scene.intersect_alpha and
occlude_alpha): JAX's tests/test_scene.py alpha cases on scenes written by
the port's scenegraph/write.py (tests/torch_alpha_scene.py), each held
against the JAX package's traversal on the same rays (hit ids and
occlusion bit-equal, t within 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu.scene import load_scene as j_load_scene
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch.core.filters import BoxFilter
from akari_render_tpu_torch.integrators.common import PTSettings
from akari_render_tpu_torch.integrators.megakernel import megakernel_eligible
from akari_render_tpu_torch.scene import load_scene as t_load_scene
from torch_alpha_scene import alpha_rays, write_alpha_scene


@pytest.fixture(scope="module")
def jax_table():
    return np.asarray(j_get_table("ggx_dielectric_s"))


def _scenes(tmp_path, table, alpha8: int, sheets: int = 1):
    path = write_alpha_scene(tmp_path, alpha8, sheets)
    return j_load_scene(path), t_load_scene(path, device="cpu", ggx_table=table)


def _both(js, ts, fn: str, *arrays, **ex):
    """fn on both scenes with the same inputs; (JAX result, port result)."""
    jr = getattr(js, fn)(*(jnp.asarray(a) for a in arrays),
                         **{k: jnp.asarray(v) for k, v in ex.items()})
    tr = getattr(ts, fn)(*(torch.as_tensor(a) for a in arrays),
                         **{k: torch.as_tensor(v) for k, v in ex.items()})
    return jr, tr


def _hits_equal(jh, th):
    assert np.array_equal(th.tri_id.numpy(), np.asarray(jh.tri_id))
    assert np.array_equal(th.valid.numpy(), np.asarray(jh.valid))
    v = th.valid.numpy()
    np.testing.assert_allclose(th.t.numpy()[v], np.asarray(jh.t)[v], atol=1e-5, rtol=0)


def test_alpha_zero_passes_through(tmp_path, jax_table):
    js, ts = _scenes(tmp_path, jax_table, 0)
    assert ts.has_alpha and js.has_alpha and ts.kind_alpha == js.kind_alpha
    jh, th = _both(js, ts, "intersect_alpha", *alpha_rays(64, 7, 1.5))
    _hits_equal(jh, th)
    assert bool(th.valid.all()) and bool((th.tri_id >= 2).all())
    np.testing.assert_allclose(th.t.numpy(), 6.0, atol=1e-4)


def test_restart_preserves_caller_exclusions(tmp_path, jax_table):
    """Both wall triangles excluded (both caller slots): rays pass the
    alpha-0 sheet and then miss, never hitting an excluded id."""
    js, ts = _scenes(tmp_path, jax_table, 0)
    ex = {"exclude0": np.full(64, 2, np.int32), "exclude1": np.full(64, 3, np.int32)}
    jh, th = _both(js, ts, "intersect_alpha", *alpha_rays(64, 7, 1.5), **ex)
    _hits_equal(jh, th)
    assert not bool(th.valid.any())


def test_alpha_half_is_stochastic(tmp_path, jax_table):
    js, ts = _scenes(tmp_path, jax_table, 128)
    jh, th = _both(js, ts, "intersect_alpha", *alpha_rays(512, 7, 1.5))
    _hits_equal(jh, th)
    front = float((th.tri_id <= 1).float().mean())
    assert 0.3 < front < 0.7


def test_dense_alpha_unbiased(tmp_path, jax_table):
    """Six sheets of alpha 77/255 before a solid wall: the committed hits
    follow the geometric law (a lane still rejecting after the restart
    bound reports a miss, never the rejected sheet), the staged
    occlude_alpha agrees with the closest-hit walk, and ids and
    occlusion equal JAX's."""
    ns = 6
    js, ts = _scenes(tmp_path, jax_table, 77, ns)
    assert ts.has_alpha
    o, d, tmin, tmax = alpha_rays(4096, 9, 1.9)
    jh, th = _both(js, ts, "intersect_alpha", o, d, tmin, tmax)
    _hits_equal(jh, th)
    assert bool(th.valid.all())
    trans = 1.0 - 77.0 / 255.0
    wall = float((th.tri_id >= 2 * ns).float().mean())
    assert abs(wall - trans ** ns) < 0.035
    for i in range(2):
        f_i = float(((th.tri_id // 2) == i).float().mean())
        assert abs(f_i - (trans ** i) * (1.0 - trans)) < 0.04
    for t_end in (1e8, 6.5):
        jo, to = _both(js, ts, "occlude_alpha", o, d, tmin, np.full(4096, t_end, np.float32))
        assert np.array_equal(to.numpy(), np.asarray(jo))
    assert abs(float(to.float().mean()) - (1.0 - trans ** ns)) < 0.035


def test_opaque_scene_skips_restarts(tmp_path, jax_table):
    """Opaque texels: no alpha, the plain traversal; an alpha scene turns
    the shade bake and the megakernel off, as in JAX."""
    js, ts = _scenes(tmp_path, jax_table, 255)
    assert not ts.has_alpha and not js.has_alpha
    jh, th = _both(js, ts, "intersect_alpha", *alpha_rays(64, 7, 1.5))
    _hits_equal(jh, th)
    assert bool((th.tri_id <= 1).all())
    _, ta = _scenes(tmp_path, jax_table, 128)
    assert ta.shade_bake is None
    assert not megakernel_eligible(ta, PTSettings(), None, BoxFilter(0.5))
