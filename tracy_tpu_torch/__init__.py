"""tracy_tpu_torch: the PyTorch + CUDA port of tracy_tpu for NVIDIA Hopper.

The package mirrors `tracy_tpu`'s layout (core, scene, accel, render, ops)
and holds the same untextured progressive path tracer in plain PyTorch. The
two hot spots of a bounce, closest-hit intersection (ops/intersect.py) and
shading (ops/shade.py), are hand-written CUDA kernels under csrc/, built for
sm_90a on first use. On CPU tensors each kernel's wrapper runs its plain
PyTorch version instead, which is what the CPU tests hold against the JAX
package.

This package imports torch and never jax. From `tracy_tpu` it imports only
the jax-free `config.RenderConfig`, `utils.native` and `utils.log`.
"""

from tracy_tpu.config import RenderConfig

__all__ = ["RenderConfig"]
