"""What every kernel wrapper shares: launch counts and argument checks."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass
class LaunchCount:
    """How often a wrapper launched its kernel, and how often it ran the
    plain PyTorch version instead (only ever for CPU tensors)."""

    kernel: int = 0
    plain: int = 0

    def reset(self):
        self.kernel = 0
        self.plain = 0


def check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: Sequence[int],
          device: torch.device):
    """Raise unless x is a contiguous `dtype` tensor of `shape` on `device`."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def raise_on_error(kernel: str, code: int):
    if code != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t {code}")
