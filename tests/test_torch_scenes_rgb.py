"""PyTorch port, the last two bundled scenes no other port test renders:
scenes/glossy (principled spheres) and scenes/prism (a glass wedge), in
RGB through both packages."""
from pathlib import Path

import numpy as np
import pytest
import torch

from akari_render_tpu.config import RenderTask as JRenderTask
from akari_render_tpu.integrators.pt import render_pt as j_render_pt
from akari_render_tpu.scene import load_scene as j_load_scene
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch.config import RenderTask as TRenderTask
from akari_render_tpu_torch.integrators.pt import render_pt as t_render_pt
from akari_render_tpu_torch.scene import load_scene as t_load_scene

ROOT = Path(__file__).resolve().parents[1]
# d12, rr 5, independent sampler seed 0, Gaussian r 1.5
METHOD = ROOT / "scenes/matbox/pt.json"


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["glossy", "prism"])
def test_scene_matches_jax(name):
    """32x32, 8 spp, d12, rr 5, independent seed 0, RGB, with the same GGX
    table: the same draws and decisions, so the images agree to float
    rounding (channel means within 1 %, 95 % of the pixels within 1e-3
    relative, as tests/test_torch_pt.py holds matbox)."""
    scene = ROOT / "scenes" / name / "scene.json"
    table = np.asarray(j_get_table("ggx_dielectric_s"))
    jtask, ttask = JRenderTask.from_file(METHOD), TRenderTask.from_file(METHOD)
    for task in (jtask, ttask):
        task.method.spp = task.method.spp_per_pass = 8
    jimg, _ = j_render_pt(j_load_scene(str(scene), 32, 32), jtask.method, jtask)
    timg, stats = t_render_pt(t_load_scene(str(scene), 32, 32, device="cpu", ggx_table=table),
                              ttask.method, ttask)
    jimg = np.asarray(jimg)
    assert timg.shape == jimg.shape == (32, 32, 3) and np.all(np.isfinite(timg))
    assert stats["color"] == "rgb" and timg.mean() > 0.0
    np.testing.assert_allclose(timg.mean(axis=(0, 1)), jimg.mean(axis=(0, 1)), rtol=0.01)
    rel = np.abs(timg - jimg) / np.maximum(np.abs(jimg), 1e-3)
    assert np.mean(np.all(rel <= 1e-3, axis=-1)) >= 0.95
