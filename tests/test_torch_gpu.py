"""PyTorch port on the card: the K1 CUDA kernel against its plain torch
version, and the slice on the card against the slice on the CPU.

Every test here is marked gpu and skips without CUDA. The file imports no
jax, so it also runs where only torch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from akari_render_tpu_torch.accel import intersect as k1
from akari_render_tpu_torch.camera import generate_rays
from akari_render_tpu_torch.config import RenderTask
from akari_render_tpu_torch.core.math import RAY_TMAX
from akari_render_tpu_torch.integrators.pt import render_pt
from akari_render_tpu_torch.scene import load_scene

ROOT = Path(__file__).resolve().parents[1]
SCENE = ROOT / "scenes/matbox/scene.json"
METHOD = ROOT / "scenes/matbox/pt.json"

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rays(scene, n, seed, device):
    """Camera rays and rays from inside the box, with exclusion ids."""
    rng = np.random.default_rng(seed)
    cam = scene.camera
    p = rng.random((n // 2, 2)) * [cam.width, cam.height]
    o_c, d_c = generate_rays(cam, torch.as_tensor(p, dtype=torch.float32, device=device))
    v0 = scene.arrays.v0.cpu().numpy()
    lo, hi = v0.min(0), v0.max(0)
    o_r = lo + (hi - lo) * (0.05 + 0.9 * rng.random((n // 2, 3)))
    d_r = rng.normal(size=(n // 2, 3))
    d_r /= np.linalg.norm(d_r, axis=-1, keepdims=True)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    o = torch.cat([o_c, t(o_r)]).contiguous()
    d = torch.cat([d_c, t(d_r)]).contiguous()
    t_count = scene.num_tris
    tmax = np.where(rng.random(n) < 0.3, rng.random(n) * 3.0, RAY_TMAX)
    tmax[rng.random(n) < 0.05] = -1.0
    exs = [t(np.where(rng.random(n) < f, rng.integers(0, t_count, n), -1), torch.int32)
           for f in (0.5, 0.3, 0.2)]
    return o, d, torch.zeros(n, device=device), t(tmax), *exs


def test_kernel_matches_plain_on_card(cuda):
    scene = load_scene(str(SCENE), 64, 64, device=cuda)
    a = scene.arrays
    o, d, tmin, tmax, ex0, ex1, ex2 = _rays(scene, 1 << 16, 3, cuda)
    args = (o, d, tmin, tmax, a.v0, a.e1, a.e2, ex0, ex1, ex2)
    before = k1.launches
    hk = k1.intersect_tris(*args)
    hp = k1.intersect_tris_torch(*args)
    assert k1.launches == before + 1
    assert int(hk.valid.sum()) > 1 << 14
    assert torch.equal(hk.tri_id, hp.tri_id)
    assert torch.equal(hk.t, hp.t) and torch.equal(hk.bary, hp.bary)
    assert torch.equal(k1.intersect_tris(*args, any_hit=True),
                       k1.intersect_tris_torch(*args, any_hit=True))


def test_slice_on_card_matches_cpu(cuda):
    """matbox 16x16, 4 spp on the card and on the CPU with the same GGX
    table: channel means within 1 %."""
    task = RenderTask.from_file(METHOD)
    task.method.spp = 4
    table = load_scene(str(SCENE), 16, 16, device=cuda).ggx_table_np
    imgs = [render_pt(load_scene(str(SCENE), 16, 16, device=dev, ggx_table=table), task.method, task)[0]
            for dev in ("cpu", cuda)]
    assert np.all(np.isfinite(imgs[1]))
    np.testing.assert_allclose(imgs[1].mean(axis=(0, 1)), imgs[0].mean(axis=(0, 1)), rtol=0.01)
