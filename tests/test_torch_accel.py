"""PyTorch port, K1 (brute-force Möller-Trumbore): the plain torch version
against the JAX package's brute force and its Pallas kernel (interpret
mode), and the wrapper's device routing. The CUDA kernel against the plain
version on a card is in test_torch_gpu.py."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu.accel.pallas_intersect import intersect_pallas, pack_tris
from akari_render_tpu.accel.trace import intersect_brute_force, occlude_brute_force
from akari_render_tpu.camera import camera_from_scenegraph, generate_rays
from akari_render_tpu.accel.flatten import flatten_scene
from akari_render_tpu.scenegraph.model import load_scene_json
from akari_render_tpu_torch.accel import intersect as k1
from akari_render_tpu_torch.core.math import RAY_TMAX

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def matbox():
    sg = load_scene_json(ROOT / "scenes/matbox/scene.json")
    soup, _, _ = flatten_scene(sg)
    return sg, soup


def _rays(sg, soup, n_cam=2048, n_rand=2048, seed=3):
    """Jittered camera rays plus random rays from inside the box, with
    exclusion ids on some and finite tmax on others."""
    rng = np.random.default_rng(seed)
    cam = camera_from_scenegraph(sg.camera, 64, 64)
    p = (rng.random((n_cam, 2)) * 64).astype(np.float32)
    o_c, d_c = generate_rays(cam, jnp.asarray(p))
    lo, hi = soup.v0.min(0), soup.v0.max(0)
    o_r = (lo + (hi - lo) * (0.05 + 0.9 * rng.random((n_rand, 3)))).astype(np.float32)
    d_r = rng.normal(size=(n_rand, 3))
    d_r = (d_r / np.linalg.norm(d_r, axis=-1, keepdims=True)).astype(np.float32)
    o = np.concatenate([np.asarray(o_c), o_r]).astype(np.float32)
    d = np.concatenate([np.asarray(d_c), d_r]).astype(np.float32)
    n = len(o)
    t_count = len(soup.v0)
    tmin = np.zeros(n, np.float32)
    tmax = np.where(rng.random(n) < 0.3, rng.random(n) * 3.0, 1e20).astype(np.float32)
    tmax[rng.random(n) < 0.05] = -1.0  # dead lanes
    ex0 = np.where(rng.random(n) < 0.5, rng.integers(0, t_count, n), -1).astype(np.int32)
    ex1 = np.where(rng.random(n) < 0.3, rng.integers(0, t_count, n), -1).astype(np.int32)
    ex2 = np.where(rng.random(n) < 0.2, rng.integers(0, t_count, n), -1).astype(np.int32)
    return o, d, tmin, tmax, ex0, ex1, ex2


def _tris(soup, count=None):
    s = slice(0, count)
    return soup.v0[s], soup.e1[s], soup.e2[s]


def _torch_args(o, d, tmin, tmax, tris, exs):
    return [torch.as_tensor(x) for x in (o, d, tmin, tmax, *tris)] + [torch.as_tensor(e) for e in exs]


def _check_closest(hp, jt, jid, ju, jv):
    """Ids exact; t to RTOL; u, v (which lie in [0, 1]) to RTOL of that
    unit range: the Pallas kernel's fused arithmetic rounds differently
    where u or v is a small difference of large products."""
    np.testing.assert_array_equal(hp.tri_id.numpy(), jid)
    hit = jid >= 0
    np.testing.assert_allclose(hp.t.numpy()[hit], jt[hit], rtol=RTOL)
    np.testing.assert_allclose(hp.bary.numpy()[hit], np.stack([ju, jv], -1)[hit], rtol=RTOL, atol=RTOL)
    assert np.all(hp.t.numpy()[~hit] == RAY_TMAX)


def test_plain_matches_jax_brute_force(matbox):
    sg, soup = matbox
    o, d, tmin, tmax, *exs = _rays(sg, soup)
    tris = _tris(soup)
    jh = intersect_brute_force(*(jnp.asarray(x) for x in (o, d, tmin, tmax, *tris, *exs)))
    hp = k1.intersect_tris_torch(*_torch_args(o, d, tmin, tmax, tris, exs))
    _check_closest(hp, np.asarray(jh.t), np.asarray(jh.tri_id), np.asarray(jh.bary[:, 0]),
                   np.asarray(jh.bary[:, 1]))
    assert int((hp.tri_id >= 0).sum()) > 2000  # the rays really hit things
    jo = occlude_brute_force(*(jnp.asarray(x) for x in (o, d, tmin, tmax, *tris, *exs)))
    op = k1.intersect_tris_torch(*_torch_args(o, d, tmin, tmax, tris, exs), any_hit=True)
    np.testing.assert_array_equal(op.numpy(), np.asarray(jo))


def test_plain_matches_pallas_interpret(matbox, monkeypatch):
    """300 triangles through the Pallas kernel's chunked triangle grid: five
    chunks, the last one padded. As in the JAX package's own tests
    (tests/test_accel.py), TRI_CHUNK is cut to 64: interpret mode runs the
    statically unrolled 512-triangle chunk op by op, which takes tens of
    minutes on a CPU."""
    from akari_render_tpu.accel import pallas_intersect

    monkeypatch.setattr(pallas_intersect, "TRI_CHUNK", 64)
    sg, soup = matbox
    o, d, tmin, tmax, *exs = _rays(sg, soup, n_cam=256, n_rand=256, seed=5)
    tris = _tris(soup, 300)
    exs = [np.where(e < 300, e, -1).astype(np.int32) for e in exs]
    packed = pack_tris(*(jnp.asarray(x) for x in tris))
    jargs = [jnp.asarray(x) for x in (o, d, tmin, tmax)] + [jnp.asarray(e) for e in exs]
    jh = intersect_pallas(packed, *jargs, interpret=True, block=512)
    hp = k1.intersect_tris_torch(*_torch_args(o, d, tmin, tmax, tris, exs))
    _check_closest(hp, np.asarray(jh.t), np.asarray(jh.tri_id), np.asarray(jh.bary[:, 0]),
                   np.asarray(jh.bary[:, 1]))
    jo = intersect_pallas(packed, *jargs, any_hit=True, interpret=True, block=512)
    op = k1.intersect_tris_torch(*_torch_args(o, d, tmin, tmax, tris, exs), any_hit=True)
    np.testing.assert_array_equal(op.numpy(), np.asarray(jo))


def test_ray_chunking_is_transparent(matbox, monkeypatch):
    sg, soup = matbox
    o, d, tmin, tmax, *exs = _rays(sg, soup, n_cam=600, n_rand=600, seed=9)
    args = _torch_args(o, d, tmin, tmax, _tris(soup, 900), exs)
    whole = k1.intersect_tris_torch(*args)
    monkeypatch.setattr(k1, "RAY_CHUNK", 128)
    chunked = k1.intersect_tris_torch(*args)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_wrapper_routes_cpu_to_plain(matbox):
    sg, soup = matbox
    o, d, tmin, tmax, *exs = _rays(sg, soup, n_cam=256, n_rand=256)
    args = _torch_args(o, d, tmin, tmax, _tris(soup), exs)
    before = k1.launches
    h = k1.intersect_tris(*args)
    ref = k1.intersect_tris_torch(*args)
    assert k1.launches == before  # only a kernel launch counts
    for a, b in zip(h, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        k1.intersect_tris(*(a.to("meta") for a in args))
