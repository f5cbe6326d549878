"""Counter-based stateless RNG, bit-identical to tracy_tpu/core/rng.py.

Every draw is a pure hash of (seed, pixel, frame, bounce, draw). torch has
no full uint32 arithmetic, so the hashes run on int64 tensors holding values
in [0, 2^32), masked back to 32 bits after every step that can carry past
bit 31. Products of two 32-bit values are split into 16-bit halves so that
no int64 product overflows.

`threefry` is `jax.random` in the JAX package and has no counterpart here.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
# Weyl constants for the counter dimensions (tracy_tpu/core/rng.py).
K_PIXEL = 0x9E3779B9
K_FRAME = 0x85EBCA6B
K_BOUNCE = 0xC2B2AE35
K_DRAW = 0x27D4EB2F

KINDS = ("fast", "xorshift", "lcg")


def mul32(x, k: int):
    """(x * k) mod 2^32 for an int64 tensor x in [0, 2^32) and int k."""
    k &= MASK32
    lo = x * (k & 0xFFFF)
    hi = ((x * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _pcg_hash(x):
    """PCG output permutation (RXS-M-XS)."""
    x = (mul32(x, 747796405) + 2891336453) & MASK32
    x = mul32((x >> ((x >> 28) + 4)) ^ x, 277803737)
    return (x >> 22) ^ x


def _xorshift_hash(x):
    x = x ^ ((x << 13) & MASK32)
    x = x ^ (x >> 17)
    return x ^ ((x << 5) & MASK32)


def _lcg_hash(x):
    return (mul32(x, 1664525) + 1013904223) & MASK32


def _xor_fold16(x):
    return x ^ (x >> 16)


HASHES = {
    "fast": _pcg_hash,
    "xorshift": lambda x: _xorshift_hash(_xorshift_hash(x)),
    "lcg": lambda x: _xor_fold16(_lcg_hash(_xor_fold16(_lcg_hash(x)))),
}


def mix(seed: int, pixel, frame: int, bounce: int, draw: int, kind: str = "fast"):
    """32 hashed bits per pixel, as int64 in [0, 2^32). `pixel` is a tensor;
    seed/frame/bounce/draw are Python ints."""
    hh = HASHES[kind]
    h = (mul32(pixel.to(torch.int64) & MASK32, K_PIXEL) + (seed & MASK32)) & MASK32
    h = hh((h + ((frame * K_FRAME) & MASK32)) & MASK32)
    h = hh((h + ((bounce * K_BOUNCE + draw * K_DRAW) & MASK32)) & MASK32)
    return hh(h)


def uniform_fast(seed: int, pixel, frame: int, bounce: int, draw: int,
                 kind: str = "fast"):
    """Uniform float32 in [0, 1) from the top 24 hashed bits (exact)."""
    bits = mix(seed, pixel, frame, bounce, draw, kind)
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


class RngSpec:
    """Per-render RNG: uniform draws keyed by logical counters."""

    def __init__(self, kind: str, seed: int):
        if kind == "threefry":
            raise ValueError(
                "rng='threefry' is jax.random and cannot be reproduced in "
                "torch; pick one of " + ", ".join(KINDS))
        if kind not in KINDS:
            raise ValueError(f"unknown rng kind {kind!r}")
        self.kind = kind
        self.seed = seed

    def uniform(self, pixel_idx, frame: int, bounce: int, draw: int):
        """Uniform [0,1) shaped like pixel_idx."""
        return uniform_fast(self.seed, pixel_idx, frame, bounce, draw, self.kind)
