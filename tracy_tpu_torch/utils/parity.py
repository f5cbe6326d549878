"""Image parity metrics for renders, in linear radiance.

The same metric as tests/test_ref_parity.py: images are compared in linear
radiance (sRGB inverted), as 16x16 block means, by the global mean, the
95th percentile and the maximum of the block differences.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def srgb_to_linear(s: np.ndarray) -> np.ndarray:
    return np.where(s <= 0.04045, s / 12.92, ((s + 0.055) / 1.055) ** 2.4)


def load_golden(path: str) -> np.ndarray:
    """A reference golden (.npz, 0..255 tonemapped, bottom row first) as
    linear radiance."""
    img = np.load(path)["image"].astype(np.float32)
    return srgb_to_linear(img / 255.99)


def block_means(img: np.ndarray, bs: int = 16) -> np.ndarray:
    h, w, _ = img.shape
    return img[: h // bs * bs, : w // bs * bs].reshape(
        h // bs, bs, w // bs, bs, 3).mean(axis=(1, 3))


def compare(ref: np.ndarray, ours: np.ndarray) -> Tuple[float, float, float]:
    """(|mean diff|, p95 of |block diff|, max |block diff|)."""
    if ref.shape != ours.shape:
        raise ValueError(f"shapes differ: {ref.shape} vs {ours.shape}")
    d = np.abs(block_means(ref) - block_means(ours))
    return (abs(float(ref.mean()) - float(ours.mean())),
            float(np.percentile(d, 95)), float(d.max()))
