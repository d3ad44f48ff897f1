"""akari_render_tpu_torch — the PyTorch/CUDA port of akari_render_tpu.

The JAX package `akari_render_tpu` beside this one is the reference; this
package mirrors its module paths and computes the same things with torch
tensors on an explicit `device`. Host-only modules (scene JSON model,
method config, shader compiler, scene flattening, EXR IO) are carried over
as numpy code, because importing anything from `akari_render_tpu` imports
jax (its `__init__` sets up the XLA compile cache).

Ported so far (the first slice): `cli -s scene.json -m pt.json` with the
path tracer on flat-tier scenes (no BVH, instancing, alpha or spectral
transport), with the brute-force Möller-Trumbore intersector as a
hand-written CUDA kernel (`csrc/intersect.cu`, wrapper
`accel/intersect.py`). Nothing here imports jax.
"""

__version__ = "0.1.0"
