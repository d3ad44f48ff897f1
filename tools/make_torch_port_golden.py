"""Render the matbox reference images that chip_smoke.py holds the PyTorch
port against, with the JAX package on the CPU.

Writes akari_render_tpu_torch/testdata/matbox64_spp{16,256}.npy: matbox at
64x64 through scenes/matbox/pt.json (d12, rr 5, independent sampler seed 0,
gaussian filter r 1.5) at 16 and at 256 spp, as [64, 64, 3] float32.

Usage:
    python tools/make_torch_port_golden.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from akari_render_tpu.config import RenderTask
    from akari_render_tpu.integrators.pt import render_pt
    from akari_render_tpu.scene import load_scene

    scene = load_scene(str(ROOT / "scenes/matbox/scene.json"), width=64, height=64)
    out_dir = ROOT / "akari_render_tpu_torch" / "testdata"
    out_dir.mkdir(parents=True, exist_ok=True)
    for spp in (16, 256):
        task = RenderTask.from_file(ROOT / "scenes/matbox/pt.json")
        task.method.spp = spp
        img, stats = render_pt(scene, task.method, task)
        path = out_dir / f"matbox64_spp{spp}.npy"
        np.save(path, np.asarray(img, np.float32))
        print(f"wrote {path}: mean {img.mean(axis=(0, 1))} ({stats['total_time']:.1f}s)")


if __name__ == "__main__":
    main()
