"""akari_render_tpu_torch — the PyTorch/CUDA port of akari_render_tpu.

The JAX package `akari_render_tpu` beside this one is the reference; this
package mirrors its module paths and computes the same things with torch
tensors on an explicit `device`. Host-only modules (scene JSON model,
method config, shader compiler, scene flattening, EXR IO) are carried over
as numpy code, because importing anything from `akari_render_tpu` imports
jax (its `__init__` sets up the XLA compile cache).

Ported so far: `cli -s scene.json -m pt.json` with the path tracer on
flat-tier and cluster-tier scenes with instancing (no alpha or spectral
transport). The hand-written CUDA kernels are the brute-force
Möller-Trumbore intersector (`csrc/intersect.cu`, wrapper
`accel/intersect.py`) and the pair sweep's cull, refine and candidate walk
(`csrc/pairs.cu`, wrappers in `accel/pairs.py`). Nothing here imports jax.
"""

__version__ = "0.1.0"
