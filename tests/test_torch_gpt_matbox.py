"""PyTorch port, the gradient-domain path tracer on matbox, whose four
shader kinds exercise the per-kind dispatch of the reconnection shift's
bounce, connection and reconnection vertex, held against the JAX package
on the CPU (a file of its own: JAX compiles matbox's GPT graph for about a
minute, and a file is one worker's share)."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akari_render_tpu.config import GPTConfig as JGPTConfig
from akari_render_tpu.integrators import gpt as jgpt
from akari_render_tpu.scene import load_scene as j_load_scene
from akari_render_tpu.svm.precompute import get_table as j_get_table
from akari_render_tpu_torch.config import GPTConfig
from akari_render_tpu_torch.integrators import gpt
from akari_render_tpu_torch.scene import load_scene as t_load_scene
from torch_gpt_checks import assert_full_strength, assert_images_match

MATBOX = Path(__file__).resolve().parents[1] / "scenes/matbox/scene.json"


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_render_gpt_matbox_matches_jax():
    """matbox 16x16, 2 spp, d3, the reconnection shift (the mode whose
    bounces shade through the dispatch), against JAX's, each with channel
    means within 1 % and >= 95 % of the pixels within 1e-3 relative: the
    primal; gx and gy at exactly 2x JAX's wherever JAX's film holds one
    pair's two ends (their mean there, the port's their sum:
    torch_gpt_checks.assert_full_strength), 0 where the port's holds no
    pair; the reconstruction against JAX's screened_poisson fed the port's
    films."""
    table = np.asarray(j_get_table("ggx_dielectric_s"))
    js = j_load_scene(str(MATBOX), 16, 16)
    ts = t_load_scene(str(MATBOX), 16, 16, device="cpu", ggx_table=table)
    assert len(ts.kinds) == 4
    jimg, jstats = jgpt.render_gpt(js, JGPTConfig(spp=2, max_depth=3), None,
                                   shift_mode="reconnect")
    timg, tstats = gpt.render_gpt(ts, GPTConfig(spp=2, max_depth=3), None)
    assert tstats["shift_mode"] == "reconnect"
    assert_images_match(tstats["primal"], jstats["primal"], "primal")
    assert_full_strength(tstats, jstats)
    want = jgpt.screened_poisson(*(jnp.asarray(tstats[k]) for k in ("primal", "gx", "gy")),
                                 None, iters=GPTConfig().reconstruction_iter)
    assert_images_match(timg, np.asarray(want), "recon")
