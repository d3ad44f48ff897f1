"""The benchmark's GPT cell, cbox-gpt-final, driven through
bench_torch.run.measure on the CPU at 32x32 (the kernels' plain versions):
16 jobs of the cell's 2 samples a pixel, each a base path and four shifts,
held against the plain reference with 4 x 4 tiles (64 pixels a tile), the
films read as render_gpt writes them. The gradient check's witness, the
films at half strength, fails it (grad_chi2 66.95 at this size and seed);
a sound run passes every limit of the configuration, on the CPU's default
route (the per-kind dispatch) and on the card's (the fused route of K9's
roughness and evaluation entries, here their plain versions)."""
import os
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELL = "cbox-gpt-final"
SIZE = 32
JOBS = 16
TILES = 4


@pytest.mark.parametrize("route", ["dispatch", "fused"])
def test_gpt_cell_is_correct(monkeypatch, route):
    from akari_render_tpu_torch import stats
    from akari_render_tpu_torch.integrators import common
    from bench_torch import harness, run

    if route == "fused":  # the card's default route (run.measure unsets every AKR_* switch)
        monkeypatch.setattr(common, "fused_shade_enabled", lambda device: True)
    stats.reset()

    real = harness.load_config

    def load_config(name, spec=None):
        c = real(name, spec)
        return dict(c, reference=dict(c["reference"], tiles=TILES))
    monkeypatch.setattr(harness, "load_config", load_config)
    switches = {k: v for k, v in os.environ.items() if k.startswith("AKR_")}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = run.measure(CELL, 987654321012, 1e9, False, device="cpu", width=SIZE, height=SIZE,
                          log=lambda *a, **k: None, max_jobs=JOBS)
    finally:
        os.environ.update(switches)  # measure unsets every AKR_* switch
        torch.set_num_threads(threads)
    assert out["attempted"] == JOBS
    checks = out["checks"]
    for k in ("grad_chi2", "primal_chi2", "recon_gap"):
        assert checks[k]["value"] <= checks[k]["limit"], (k, checks)
    assert out["correct"], checks
    c = stats.counts
    if route == "fused":
        assert c["gpt_fused_shades"] > 0 and c["dispatch_groups"] == 0, c
    else:
        assert c["gpt_fused_shades"] == 0 and c["dispatch_groups"] > 0, c
