"""Counter-based stateless RNG, bit-identical to tracy_tpu/core/rng.py.

Every draw is a pure hash of (seed, pixel, frame, bounce, draw). torch has
no full uint32 arithmetic, so the hashes run on int64 tensors holding values
in [0, 2^32), masked back to 32 bits after every step that can carry past
bit 31. Products of two 32-bit values are split into 16-bit halves so that
no int64 product overflows.

`threefry` is tracy_tpu's `jax.random` setting (core/rng.py:109-117), kept
there for auditing the fast path. Here it is its own Threefry-2x32 (20
rounds), with jax.random's key, fold_in and partitionable uniform, bit for
bit with jax's default `jax_threefry_partitionable=True`, plus the 'fast'
mix of seed ^ 0x5BD1E995. Its counter is the element's flat row-major
position in `pixel_idx`, not the pixel id: a draw depends on the shape of
the array the caller draws over, as in tracy_tpu, so a band, a chunk or a
shard draws other numbers than the whole frame does.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
# Weyl constants for the counter dimensions (tracy_tpu/core/rng.py).
K_PIXEL = 0x9E3779B9
K_FRAME = 0x85EBCA6B
K_BOUNCE = 0xC2B2AE35
K_DRAW = 0x27D4EB2F

KINDS = ("fast", "xorshift", "lcg", "threefry")
# Threefry-2x32's rotations and key-schedule parity (jax/_src/prng.py).
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA
THREEFRY_MIX_SEED = 0x5BD1E995  # the 'fast' mix's seed is seed ^ this


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


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds (jax/_src/prng.py::_threefry2x32_lowering).
    Keys and counts are Python ints or int64 tensors holding uint32; returns
    the pair of output words in the same form."""
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x1, x2


def threefry_key(seed: int, frame: int, bounce: int, draw: int):
    """The key of one draw, as two uint32 ints: jax.random.key(seed) =
    (seed >> 32, seed & 0xFFFFFFFF), then fold_in of frame, bounce and draw,
    fold_in(k, d) = threefry2x32(k, (0, d))."""
    key = ((seed >> 32) & MASK32, seed & MASK32)
    for d in (frame, bounce, draw):
        key = threefry2x32(*key, 0, d & MASK32)
    return key


def threefry_keys(seed: int, frame: int, bounce: int):
    """The keys of a bounce's 4 draws, flat: [k1, k2] per draw (what K2, K4
    and K5 take as launch arguments)."""
    return [k for draw in range(4) for k in threefry_key(seed, frame, bounce, draw)]


def uniform_threefry(seed: int, pixel_idx, frame: int, bounce: int, draw: int,
                     position=None):
    """tracy_tpu's threefry draw, shaped like pixel_idx: jax.random.uniform
    of the draw's key over pixel_idx's shape (each element's counter its
    flat position, split into high and low words; bits = x1 ^ x2; a float
    in [1, 2) from the top 23 bits, minus 1), plus the 'fast' draw of seed
    ^ 0x5BD1E995, modulo 1. position: the counters, an integer tensor
    shaped like pixel_idx, for lanes that do not sit at their own position
    (compacted slots); None for pixel_idx's own positions."""
    if position is None:
        position = torch.arange(pixel_idx.numel(), dtype=torch.int64,
                                device=pixel_idx.device).view(pixel_idx.shape)
    pos = position.to(torch.int64)
    k1, k2 = threefry_key(seed, frame, bounce, draw)
    y1, y2 = threefry2x32(k1, k2, (pos >> 32) & MASK32, pos & MASK32)
    bits = ((y1 ^ y2) >> 9) | 0x3F800000
    base = bits.to(torch.int32).view(torch.float32) - 1.0
    mixed = uniform_fast((seed ^ THREEFRY_MIX_SEED) & MASK32, pixel_idx, frame, bounce,
                         draw)
    out = base + mixed
    return torch.where(out >= 1.0, out - 1.0, out)


class RngSpec:
    """Per-render RNG: uniform draws keyed by logical counters."""

    def __init__(self, kind: str, seed: int):
        if kind not in KINDS:
            raise ValueError(f"unknown rng kind {kind!r}")
        self.kind = kind
        self.seed = seed

    def uniform(self, pixel_idx, frame: int, bounce: int, draw: int, position=None):
        """Uniform [0,1) shaped like pixel_idx. position: threefry's
        counters (uniform_threefry); the counter hashes ignore it."""
        if self.kind == "threefry":
            return uniform_threefry(self.seed, pixel_idx, frame, bounce, draw, position)
        return uniform_fast(self.seed, pixel_idx, frame, bounce, draw, self.kind)
