"""Render the reference images that chip_smoke.py holds the PyTorch port
against, with the JAX package on the CPU.

Writes into akari_render_tpu_torch/testdata/, as [H, W, 3] float32:
- matbox64_spp{16,256}.npy: matbox at 64x64 through scenes/matbox/pt.json
  (d12, rr 5, independent sampler seed 0, gaussian filter r 1.5) at 16 and
  at 256 spp (about 7 minutes);
- classroom96_spp16.npy: classroom at 96x96 through
  scenes/classroom/pt.json (d12, rr 5, independent sampler seed 0,
  gaussian filter r 1.5) at 16 spp, the resolution of the committed
  BENCH_MSE_CLASSROOM.gt.exr;
- blinds64_spp{16,256}.npy: blinds at 64x64 through scenes/blinds/pt.json
  (the same settings) with the wavefront path tracer at 16 and 256 spp,
  and blinds64_mk_spp16.npy: the same 16 spp through the megakernel
  (render_pt_megakernel, the Pallas kernel in interpret mode; about 20 s
  for the three);
- cbox64_spp{16,256}.npy: the cbox fixture at 64x64 through
  scenes/cbox/pt.json (d12, rr 5, pmj02bn sampler seed 0, gaussian filter
  r 1.5) at 16 and 256 spp, and matbox64_aov_spp2.npz: matbox's seven AOV
  images (integrators/aov.py, remapped; one array a name) at 64x64, 2 spp
  (about 3 minutes for the three);
- cbox64_gpt_spp4.npz (--only cbox_gpt): the cbox fixture at 64x64
  through scenes/cbox/gpt.json (d7, rr 5, the reconnection shift with
  separate weights, 30 uniform Jacobi iterations, Gaussian r 1.5) at 4
  spp: the reconstruction (`recon`), `primal`, `gx` and `gy` (about
  30 s);
- cbox64_mcmc.npy (--only cbox_mcmc): the cbox fixture at 64x64 through
  scenes/cbox/mcmc.json (mcmc_opt, d7, rr 5, 100,000 bootstrap samples,
  the 64-spp direct pass) with 256 chains (the 1024x1024 ratio of 1/16 a
  pixel) at 16 spp-equivalents, and its b and acceptance in
  cbox64_mcmc_stats.json (about 5 minutes: the mutation steps run
  eagerly, _render_mcmc_eager_steps);
- cbox64_spectral_spp{16,256}.npy (--only cbox_spectral): the cbox
  fixture at 64x64 through scenes/cbox/pt.json with "color": "spectral"
  (hero-wavelength transport; pmj02bn seed 0, d12) at 16 and 256 spp
  (about 50 s for the two);
- prism64_spectral_spp{16,256}.npy (--only prism_spectral): scenes/prism
  at 64x64 through scenes/prism/spectral.json (spectral, the Cauchy
  dispersion of its glass; independent seed 0, d12, Gaussian r 1.5) at 16
  and 256 spp (about 50 s for the two).

Usage:
    python tools/make_torch_port_golden.py
        [--only matbox|classroom|blinds|cbox|cbox_gpt|cbox_mcmc|cbox_spectral|prism_spectral]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (scene dir, resolution, spp list, megakernel spp list) per reference set
SETS = {
    "matbox": ("matbox", 64, (16, 256), ()),
    "classroom": ("classroom", 96, (16,), ()),
    "blinds": ("blinds", 64, (16, 256), (16,)),
    "cbox": ("cbox", 64, (16, 256), ()),
}
# AOV reference sets written with a set: (scene dir, resolution, spp)
AOV_SETS = {"cbox": ("matbox", 64, 2)}
# the other integrators on cbox 64x64: name -> (method file, overrides)
METHOD_SETS = {
    "cbox_gpt": ("gpt.json", {"spp": 4}),
    "cbox_mcmc": ("mcmc.json", {"spp": 16, "n_chains": 256}),
}
# spectral PT at 64x64: name -> (scene dir, method file, spp list)
SPECTRAL_SETS = {
    "cbox_spectral": ("cbox", "pt.json", (16, 256)),
    "prism_spectral": ("prism", "spectral.json", (16, 256)),
}


def _render_mcmc_eager_steps(render_mcmc, scene, task):
    """The JAX package's render_mcmc with its mutation steps run eagerly
    around a jitted path trace (_evaluate) and a jitted direct pass: on the
    CPU, XLA's build of the whole jitted mutation step at d7 (61 PSS
    dimensions) runs for over a minute a step, where d3's compiles in ~20 s
    and runs in milliseconds. The same functions compute the same values;
    only the compilation boundaries move."""
    import jax

    from akari_render_tpu.integrators import mcmc, pt

    orig_eval, orig_pt = mcmc._evaluate, pt.render_pt
    traced = {}

    def evaluate(scene, settings, filt, pss, rng):
        if pss.shape not in traced:
            traced[pss.shape] = jax.jit(lambda p, r: orig_eval(scene, settings, filt, p, r))
        with jax.disable_jit(False):
            return traced[pss.shape](pss, rng)

    def render_pt(*args, **kwargs):
        with jax.disable_jit(False):
            return orig_pt(*args, **kwargs)

    mcmc._evaluate, pt.render_pt = evaluate, render_pt
    try:
        with jax.disable_jit():
            return render_mcmc(scene, task.method, task)
    finally:
        mcmc._evaluate, pt.render_pt = orig_eval, orig_pt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=sorted(SETS) + sorted(METHOD_SETS) + sorted(SPECTRAL_SETS),
                    default=None)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from akari_render_tpu.config import AOVConfig, RenderTask
    from akari_render_tpu.integrators.aov import render_aov
    from akari_render_tpu.integrators.gpt import render_gpt
    from akari_render_tpu.integrators.mcmc import render_mcmc
    from akari_render_tpu.integrators.megakernel import render_pt_megakernel
    from akari_render_tpu.integrators.pt import render_pt
    from akari_render_tpu.scene import load_scene

    out_dir = ROOT / "akari_render_tpu_torch" / "testdata"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, (scene_dir, res, spps, mk_spps) in SETS.items():
        if args.only not in (None, name):
            continue
        scene = load_scene(str(ROOT / "scenes" / scene_dir / "scene.json"), width=res, height=res)
        runs = [(spp, "", render_pt) for spp in spps]
        runs += [(spp, "_mk", render_pt_megakernel) for spp in mk_spps]
        for spp, tag, render in runs:
            task = RenderTask.from_file(ROOT / "scenes" / scene_dir / "pt.json")
            task.method.spp = spp
            img, stats = render(scene, task.method, task)
            path = out_dir / f"{name}{res}{tag}_spp{spp}.npy"
            np.save(path, np.asarray(img, np.float32))
            print(f"wrote {path}: mean {img.mean(axis=(0, 1))} ({stats['total_time']:.1f}s)")
        if name in AOV_SETS:
            scene_dir, res, spp = AOV_SETS[name]
            scene = load_scene(str(ROOT / "scenes" / scene_dir / "scene.json"), width=res,
                               height=res)
            _, stats = render_aov(scene, AOVConfig(spp=spp))
            path = out_dir / f"{scene_dir}{res}_aov_spp{spp}.npz"
            np.savez_compressed(path, **{k: np.asarray(v, np.float32)
                                         for k, v in stats["images"].items()})
            print(f"wrote {path}: {stats['aovs']} ({stats['total_time']:.1f}s)")
    for name, (method, overrides) in METHOD_SETS.items():
        if args.only not in (None, name):
            continue
        scene = load_scene(str(ROOT / "scenes" / "cbox" / "scene.json"), width=64, height=64)
        task = RenderTask.from_file(ROOT / "scenes" / "cbox" / method)
        for k, v in overrides.items():
            setattr(task.method, k, v)
        t0 = time.time()
        if name == "cbox_gpt":
            img, stats = render_gpt(scene, task.method, task)
            path = out_dir / f"cbox64_gpt_spp{task.method.spp}.npz"
            np.savez_compressed(path, recon=np.asarray(img, np.float32),
                                **{k: np.asarray(stats[k], np.float32)
                                   for k in ("primal", "gx", "gy")})
        else:
            img, stats = _render_mcmc_eager_steps(render_mcmc, scene, task)
            path = out_dir / "cbox64_mcmc.npy"
            np.save(path, np.asarray(img, np.float32))
            (out_dir / "cbox64_mcmc_stats.json").write_text(json.dumps(
                {k: float(stats[k]) for k in ("b", "acceptance", "spp_total")}))
        print(f"wrote {path}: mean {np.asarray(img).mean(axis=(0, 1))} "
              f"({time.time() - t0:.1f}s)")
    for name, (scene_dir, method, spps) in SPECTRAL_SETS.items():
        if args.only not in (None, name):
            continue
        scene = load_scene(str(ROOT / "scenes" / scene_dir / "scene.json"), width=64, height=64)
        for spp in spps:
            task = RenderTask.from_file(ROOT / "scenes" / scene_dir / method)
            task.method.spp = spp
            task.method.color = "spectral"
            t0 = time.time()
            img, _ = render_pt(scene, task.method, task)
            path = out_dir / f"{scene_dir}64_spectral_spp{spp}.npy"
            np.save(path, np.asarray(img, np.float32))
            print(f"wrote {path}: mean {np.asarray(img).mean(axis=(0, 1))} "
                  f"({time.time() - t0:.1f}s)")


if __name__ == "__main__":
    main()
