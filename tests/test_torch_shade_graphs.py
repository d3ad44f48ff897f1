"""The reconnection shift's padded per-kind shade (integrators/shade_graphs.py)
on the CPU, where padded_shade evaluates each bucket eagerly from the fixed
buffers that the card's graphs read: its answers equal dispatch_shade's bit
for bit, for each of the shift's three call-site functions, at group sizes
that land inside, on and beside the buckets, and a whole GPT render through
it equals the default one. The graphs themselves run only on the card
(tests/test_torch_gpu.py). No jax here."""
from pathlib import Path

import numpy as np
import pytest
import torch

from akari_render_tpu_torch.config import GPTConfig
from akari_render_tpu_torch.integrators import common, gpt, gpt_reconnect, shade_graphs
from akari_render_tpu_torch.scene import load_scene

ROOT = Path(__file__).resolve().parents[1]
RES = 64
N = RES * RES  # buckets of 1,024, 1,536, 2,048, 3,072 and 4,096 rows


@pytest.fixture(scope="module")
def cbox():
    return load_scene(str(ROOT / "scenes/cbox/scene.json"), RES, RES, device="cpu")


def test_buckets():
    assert shade_graphs.buckets(256) == [256]
    assert shade_graphs.buckets(4096) == [1024, 1536, 2048, 3072, 4096]
    big = shade_graphs.buckets(1 << 20)
    assert big[0] == 1024 and big[-1] == 1 << 20 and len(big) == 21
    assert all(a < b <= 1.5 * a for a, b in zip(big, big[1:]))
    assert shade_graphs.buckets(3000) == [1024, 1536, 2048, 3000]


def _inputs(scene, seed):
    """A wavefront's interactions (random triangles and barycentrics) and
    the three call sites' extra tensors, all N lanes."""
    g = torch.Generator().manual_seed(seed)
    tri = torch.randint(0, scene.num_tris, (N,), generator=g, dtype=torch.int32)
    bary = torch.rand((N, 2), generator=g) * 0.5
    si = scene.surface_interaction(tri, bary)

    def unit():
        v = torch.randn((N, 3), generator=g)
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)

    shade_ex = {"wo": unit(), "u_bsdf": torch.rand((N, 3), generator=g), "ls_wi": unit(),
                "ls_li": torch.rand((N, 3), generator=g) * 5,
                "ls_pdf": torch.rand((N,), generator=g) + 0.1}
    return si, {"_shade": shade_ex, "_eval_conn": {"wo": unit(), "wi": unit()},
                "_eval_v": {"wo": unit(), "dwi": unit(), "wi": unit()}}


@pytest.mark.parametrize("fn", ["_shade", "_eval_conn", "_eval_v"])
def test_padded_matches_dispatch_bit_exact(cbox, fn):
    """Groups of 0, 1, 1,023, 1,024, 1,025, 1,536, 2,000 and N lanes: every
    output of padded_shade equals
    dispatch_shade's, lanes outside the group included (zeros), and the
    site keeps one buffer set for all of them."""
    si, extra = _inputs(cbox, 3)
    func = getattr(gpt_reconnect, fn)
    spec = gpt_reconnect._SHADE_SPEC if fn == "_shade" else ()
    order = torch.randperm(N, generator=torch.Generator().manual_seed(5))
    before = len(cbox.shade_graphs)
    for r in (0, 1, 1023, 1024, 1025, 1536, 2000, N):
        lanes = torch.zeros((N,), dtype=torch.bool)
        lanes[order[:r]] = True
        want = common.dispatch_shade(cbox, si, extra[fn], func, lanes, spec)
        got = shade_graphs.padded_shade(cbox, si, extra[fn], func, lanes, spec)
        assert got.keys() == want.keys(), r
        for key in want:
            assert got[key].dtype == want[key].dtype, (r, key)
            assert torch.equal(got[key], want[key]), (r, key)
    assert len(cbox.shade_graphs) == before + 1
    (site,) = (s for key, s in cbox.shade_graphs.items() if key[0] is func)
    assert site.sizes == shade_graphs.buckets(N) and not site.graphs


def test_render_gpt_through_padded_shade_bit_exact(cbox, monkeypatch):
    """cbox 64^2, 1 spp, d7, the reconnection shift: the films and the
    image with the shift's shade on the padded path equal the default
    render's (the eager dispatch on the CPU)."""
    cfg = GPTConfig(spp=1, max_depth=7)
    img, want = gpt.render_gpt(cbox, cfg, None, shift_mode="reconnect")
    monkeypatch.setattr(gpt_reconnect, "shade", shade_graphs.padded_shade)
    got_img, got = gpt.render_gpt(cbox, cfg, None, shift_mode="reconnect")
    for key in ("primal", "gx", "gy"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(got_img, img)
    assert np.abs(want["gx"]).mean() > 0
