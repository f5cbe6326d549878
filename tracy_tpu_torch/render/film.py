"""Film: progressive accumulation, tonemapping, quantization.

Port of tracy_tpu/render/film.py (reference CPUDetails::UpdateOutput, a
running average lerp(color, old, n/(n+1)), and CPUDetails::Tonemap,
exposure -> operator -> clamp(255.99 * x, 0, 255); cpu_details.cpp:187-243).
"""

from __future__ import annotations

import numpy as np
import torch

from tracy_tpu_torch.config import RenderConfig
from tracy_tpu_torch.core import math as tm


def accumulate(prev, new, frame_counter: int):
    """Running average; frame_counter counts completed frames. The blend
    weight is divided in float32, as the JAX package divides it."""
    blend = float(np.float32(frame_counter) / np.float32(frame_counter + 1.0))
    return tm.lerp(new, prev, blend)


def tonemap(color, cfg: RenderConfig):
    """HDR -> display in [0, 1] (quantize with to_u8)."""
    x = color * cfg.exposure
    if cfg.tonemap == "reinhard":
        out = tm.srgb_from_linear(tm.reinhard(x))
    elif cfg.tonemap == "aces":
        out = tm.srgb_from_linear(tm.aces(x))
    elif cfg.tonemap == "srgb":
        out = tm.srgb_from_linear(x)
    else:
        out = color
    return torch.clamp(out, 0.0, 1.0)


def to_u8(display):
    """Reference quantization: u8(clamp(255.99 * x, 0, 255))."""
    return torch.clamp(display * 255.99, 0.0, 255.0).to(torch.uint8)
