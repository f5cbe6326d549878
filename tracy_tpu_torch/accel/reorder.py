"""Wave compaction: move each block's live rays to its front, then back.

Port of tracy_tpu/accel/reorder.py. After the first bounce rays scatter and
die (sky misses, Russian roulette). A kernel that runs one thread per lane
lets a dead lane exit at once, but its warp still holds an SM slot, and a
warp with a few live lanes costs as much as a full one. Compaction packs
the live rays of each `group`-lane block into its first lanes, so that the
kernel runs fewer, fuller warps, and routes the results back to the
original lane order.

The JAX package routes with a butterfly of shifts and selects, because
gathers serialise on the TPU. On the card a gather is cheap, so the port
routes with one prefix-sum permutation: per block, a live lane goes to
`base + (live lanes before it)` and a dead lane to
`base + live_in_block + (dead lanes before it)`. Both counts come from one
`cumsum` of the alive mask; the permutation is stable and exact, live
lanes keep the JAX order, and the dead slots hold the dead lanes
themselves, so no `valid` plane is needed. The wave's last block is
padded in the mask only: its padding lanes are dead and rank last, so
they take the last slots and the real lanes fill slots [0, N), and no
state needs padding. Each tensor moves with one `index_select`: down on
the inverse permutation, back on the permutation itself. (Packing the
planes into one [N, C] tensor first, as the JAX wrapper does, measured
slower on the H100: the `cat` of narrow columns and the copies back out
cost more than the gathers they save; PERF.md.) A gather copies
bits, so a wrapped intersector or bounce is bit-exact per ray against the
unwrapped one.

Nothing here reads a tensor back to the host (no `.item()`, `nonzero` or
`int(tensor)`): on CUDA tensors the routing is device work that never
synchronises.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from tracy_tpu_torch.config import PACKET_SIZE
from tracy_tpu_torch.ops.intersect import SurfaceHit
from tracy_tpu_torch.render.intersect import Hit

# The thresholds of tracy_tpu/accel/reorder.py:45-63, unchanged. They were
# calibrated on a TPU, where routing costs log2(group) passes; whether they
# suit the H100 is measured by chip_smoke.py, not assumed.
COMPACT_MIN_TRIS = 16384


def pick_compact_group(n_rays: int, max_group: int = 262144,
                       max_pad: float = 0.125,
                       num_tris: Optional[int] = None,
                       has_translucent: Optional[bool] = None) -> int:
    """Largest power-of-two compaction group <= max_group whose wave
    padding stays under max_pad; 0 (compaction off) for traversal-light
    opaque scenes when scene statistics are given (translucent scenes keep
    rays alive too long to skip it). tracy_tpu's pick_compact_group."""
    if (num_tris is not None and num_tris < COMPACT_MIN_TRIS
            and has_translucent is False):
        return 0
    g = max_group
    while g > 2048:
        npad = -(-n_rays // g) * g
        if (npad - n_rays) / n_rays <= max_pad:
            return g
        g //= 2
    return g


def _check_group(group: int):
    if group <= 0 or group & (group - 1) or group % PACKET_SIZE:
        raise ValueError(f"group must be a power of two multiple of {PACKET_SIZE}, "
                         f"got {group}")


def route_index(alive: torch.Tensor, group: int) -> Tuple[torch.Tensor, torch.Tensor,
                                                            torch.Tensor]:
    """The compaction permutation of one wave.

    alive: [N] bool. Returns (dest [N] int64: the slot each lane moves to;
    src [N] int64: the lane each slot takes, dest's inverse; alive_c [N]
    bool: which slots hold a live lane, i.e. each block's first
    live_in_block slots)."""
    n = alive.shape[0]
    npad = -(-n // group) * group
    dev = alive.device
    live = torch.nn.functional.pad(alive, (0, npad - n)).to(torch.int32)
    upto = torch.cumsum(live, dim=0, dtype=torch.int32).view(-1, group)
    live = live.view(-1, group)
    start = upto[:, :1] - live[:, :1]  # live lanes before the block
    before = upto - live - start  # live lanes before this one in its block
    total = upto[:, -1:] - start
    pos = torch.arange(group, dtype=torch.int32, device=dev)
    local = torch.where(live.bool(), before, total + (pos - before))
    base = torch.arange(0, npad, group, dtype=torch.int64, device=dev)[:, None]
    dest = (local + base).view(npad)[:n]
    src = torch.empty_like(dest).index_copy_(0, dest, torch.arange(n, device=dev))
    return dest, src, (pos < total).view(npad)[:n]


def compact_rays(origin, direction, active, group: int):
    """Compact live rays to the front of each `group`-lane block. Returns
    (origin_c, direction_c, active_c, dest); a result x_c of the compacted
    rays routes back as x_c.index_select(0, dest)."""
    dest, src, active_c = route_index(active, group)
    return origin.index_select(0, src), direction.index_select(0, src), active_c, dest


def scatter_results(planes: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """Route a result [N, ...] of the compacted rays back to ray order
    (tracy_tpu's scatter_results, which undoes its butterfly; here the
    permutation `dest` that compact_rays returns)."""
    return planes.index_select(0, dest)


def _hit_back(sh: SurfaceHit, dest) -> SurfaceHit:
    """Every field of a SurfaceHit of the compacted rays, back in ray order."""

    def back(x):
        return None if x is None else scatter_results(x, dest)

    return SurfaceHit(Hit(*(back(x) for x in sh.hit)), back(sh.normal), back(sh.material),
                      back(sh.tex_uv), back(sh.tangent))


def compact_intersector(intersect_fn: Callable[..., SurfaceHit], group: int):
    """Wrap an intersector (origin, direction, active) -> SurfaceHit with
    per-wave live-ray compaction. Every SurfaceHit field routes back, the
    triangle id, tex_uv and tangent included (tracy_tpu's wrapper zeroes
    `tri`)."""
    _check_group(group)

    def wrapped(origin, direction, active):
        o_c, d_c, a_c, dest = compact_rays(origin, direction, active, group)
        return _hit_back(intersect_fn(o_c, d_c, a_c), dest)

    return wrapped


def compact_intersector_slot(intersect_fn, group: int):
    """compact_intersector for an intersector that also returns each ray's
    winner slot, (origin, direction, active) -> (SurfaceHit, slot [N]
    int32), as tracy_tpu's compact_intersector_slot: the slot routes back
    with the hit record, and is -1 where the ray missed (an inactive ray
    misses). diff/gradients.py's geometry intersector reads the winner
    through it."""
    _check_group(group)

    def wrapped(origin, direction, active):
        o_c, d_c, a_c, dest = compact_rays(origin, direction, active, group)
        sh, slot = intersect_fn(o_c, d_c, a_c)
        sh = _hit_back(sh, dest)
        minus = torch.full((), -1, dtype=slot.dtype, device=slot.device)
        return sh, torch.where(sh.hit.mask, scatter_results(slot, dest), minus)

    return wrapped


def compact_bounce(bounce_fn, group: int):
    """Wrap a fused bounce (o, d, thr, rad, alive, pix, sample_key, bounce,
    position=) -> next (o, d, thr, rad, alive) with per-wave live-ray
    compaction. The whole state and the pixel id route down, the next state
    routes back; dead lanes sit in dead slots, which the bounce passes
    through, so they keep their input state verbatim. `position` is each
    slot's lane index in the wave (route_index's `src`), the counter of the
    bounce's threefry draws (ops/bounce.py)."""
    _check_group(group)

    def wrapped(origin, direction, throughput, radiance, alive, pix, sample_key, bounce):
        dest, src, alive_c = route_index(alive, group)
        state = (x.index_select(0, src) for x in (origin, direction, throughput, radiance))
        nxt = bounce_fn(*state, alive_c, pix.index_select(0, src), sample_key, bounce,
                        position=src)
        return tuple(scatter_results(x, dest) for x in nxt)

    return wrapped
