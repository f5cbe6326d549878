"""Runtime render configuration of the port.

The fields the port reads, with the names, defaults and string constants of
tracy_tpu/config.py::RenderConfig. The JAX package's TPU-only knobs (the
other `pallas_*` fields, `use_pallas`, `use_pallas_shade`, `packet_*`,
`dtype`) have no meaning here and are left out. `ray_chunk` keeps its
meaning: under rng 'threefry' a chunk draws over its own lane positions.
`use_pallas_bounce` keeps its name: in the port it selects the fused bounce
kernel K5 (csrc/bounce.cu) on untextured scenes. `pallas_bvh_width` keeps
its name too: the branching factor of the tree that K1 and K5 walk.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

AOV_BEAUTY = "beauty"
AOV_BASECOLOR = "basecolor"
AOV_NORMALS = "normals"
AOV_METALNESS = "metalness"
AOV_ROUGHNESS = "roughness"
AOV_EMISSIVE = "emissive"
AOV_DEPTH = "depth"
AOVS = (AOV_BEAUTY, AOV_BASECOLOR, AOV_NORMALS, AOV_METALNESS, AOV_ROUGHNESS,
        AOV_EMISSIVE, AOV_DEPTH)

TONEMAP_NONE = "none"
TONEMAP_SRGB = "srgb"
TONEMAP_ACES = "aces"
TONEMAP_REINHARD = "reinhard"
TONEMAPS = (TONEMAP_NONE, TONEMAP_SRGB, TONEMAP_ACES, TONEMAP_REINHARD)

ACCEL_NONE = "none"
ACCEL_BVH = "bvh"
ACCEL_PACKET = "packet"
ACCEL_TLAS = "tlas"
ACCELS = (ACCEL_NONE, ACCEL_BVH, ACCEL_PACKET, ACCEL_TLAS)

RNG_FAST = "fast"
RNG_XORSHIFT = "xorshift"
RNG_LCG = "lcg"
RNG_THREEFRY = "threefry"
RNGS = (RNG_FAST, RNG_XORSHIFT, RNG_LCG, RNG_THREEFRY)

# tracy_tpu's packet_size default: wave compaction groups are multiples of it.
PACKET_SIZE = 1024


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of a render (reference CMakeLists.txt:92-116
    defaults for the path-tracing knobs)."""

    width: int = 640
    height: int = 480
    max_bounces: int = 5
    russian_roulette: bool = True
    accumulate: bool = True
    spp: int = 1  # samples per pixel per step
    tonemap: str = TONEMAP_SRGB
    exposure: float = 1.0
    aov: str = AOV_BEAUTY
    accel: str = ACCEL_PACKET
    bvh_leaf_size: int = 8
    traversal_stack_depth: int = 40
    rng: str = RNG_FAST
    seed: int = 0xABCDEF  # reference random.h fixed seed
    # Per-bounce live-ray compaction (accel/reorder.py): each block of this
    # many lanes moves its live rays to its front; a power of two multiple
    # of PACKET_SIZE, 0 = off.
    wave_compact_group: int = 0
    wave_compact_skip_first: bool = True  # bounce 0 (all live) uncompacted
    use_pallas_bounce: bool = False  # fused bounce K5 on untextured scenes
    # The BVH K1 and K5 walk: 4- or 8-wide (accel/tables.py's collapsed
    # trees) or binary (2), as tracy_tpu's (config.py:346-347).
    pallas_bvh_width: int = 4
    # Trace each sample's lanes in chunks of this many (render/renderer.py::
    # trace_chunked) when it divides them; 0 = whole.
    ray_chunk: int = 0

    def __post_init__(self):
        if self.pallas_bvh_width not in (2, 4, 8):
            raise ValueError(f"pallas_bvh_width must be 2, 4 or 8, got {self.pallas_bvh_width}")
        if self.tonemap not in TONEMAPS:
            raise ValueError(f"unknown tonemap {self.tonemap!r}; pick one of {TONEMAPS}")
        if self.aov not in AOVS:
            raise ValueError(f"unknown AOV {self.aov!r}; pick one of {AOVS}")
        if self.accel not in ACCELS:
            raise ValueError(f"unknown accel {self.accel!r}; pick one of {ACCELS}")
        if self.rng not in RNGS:
            raise ValueError(f"unknown rng {self.rng!r}; pick one of {RNGS}")
        if self.max_bounces < 1:
            raise ValueError("max_bounces must be >= 1")
        if self.spp < 1:
            raise ValueError("spp must be >= 1")
        g = self.wave_compact_group
        if g and (g & (g - 1) or g % PACKET_SIZE):
            raise ValueError("wave_compact_group must be a power of two multiple of "
                             f"{PACKET_SIZE}, got {g}")

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.width, self.height)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
