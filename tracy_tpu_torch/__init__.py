"""tracy_tpu_torch: the PyTorch + CUDA port of tracy_tpu for NVIDIA Hopper.

The package mirrors `tracy_tpu`'s layout (core, scene, accel, render, ops)
and holds the same progressive path tracer, untextured and textured, in
plain PyTorch. The hot spots of a bounce, closest-hit intersection
(ops/intersect.py), the texel fetch (ops/texfetch.py) and shading
(ops/shade.py), are hand-written CUDA kernels under csrc/, built for sm_90a
on first use. On CPU tensors each kernel's wrapper runs its plain PyTorch
version instead, which is what the CPU tests hold against the JAX package.

This package imports torch and nothing of jax or `tracy_tpu`: it keeps its
own copies of what it needs (config, utils.log, utils.native). Scenes and
cameras go to the card (cuda:0) unless the caller passes device="cpu".
"""

from tracy_tpu_torch.config import RenderConfig
from tracy_tpu_torch.version import __version__

__all__ = ["RenderConfig", "__version__"]
