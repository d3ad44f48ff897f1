"""akari_render_tpu_torch — the PyTorch/CUDA port of akari_render_tpu.

The JAX package `akari_render_tpu` beside this one is the reference; this
package mirrors its module paths and computes the same things with torch
tensors on an explicit `device`. Host-only modules (scene JSON model,
method config, shader compiler, scene flattening, EXR IO) are carried over
as numpy code, because importing anything from `akari_render_tpu` imports
jax (its `__init__` sets up the XLA compile cache).

Ported so far: the CLI with every method type (pt, aov, gpt, mcmc,
mcmc_opt) on flat-tier and cluster-tier scenes with instancing and alpha,
every shader op of the JAX package's compiler, RGB and spectral transport
(hero wavelengths, dispersive glass), and the PT pass shapes. The
hand-written CUDA kernels (csrc/) are the brute-force Möller-Trumbore
intersector K1 (`accel/intersect.py`), the pair sweep's cull, refine,
candidate walk and window refine K2-K6 (`accel/pairs.py`), the wide-BVH
walk K7 (`accel/wide.py`), the path megakernel K8
(`integrators/megakernel.py`) and the fused shade K9
(`integrators/fused_shade.py`), and, in place of no TPU kernel, the PCG32
draws (`core/pcg.py`). Nothing here imports jax.
"""

__version__ = "0.1.0"
