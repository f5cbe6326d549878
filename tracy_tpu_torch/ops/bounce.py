"""K5: one whole untextured bounce (K1's traversal + K2's shading) in one
kernel.

`trace_bounce` is the wrapper the renderer binds with
`RenderConfig(use_pallas_bounce=True)` on untextured scenes. On CUDA
tensors it launches the hand-written kernel csrc/bounce.cu; on CPU
tensors, and only there, it runs `trace_bounce_plain`: K1's plain version
followed by K2's. The kernel replaces
tracy_tpu/ops/pallas_packet.py::pallas_trace_bounce. It takes the state and
returns the next one; the hit record never leaves the kernel. Under
rng 'threefry' a lane draws at its position in the wave: `position`, which
accel/reorder.py::compact_bounce passes for its compacted slots, or the
lane's own index.
"""

from __future__ import annotations

import torch

from tracy_tpu_torch.accel.tables import BVHTables
from tracy_tpu_torch.core.rng import MASK32
from tracy_tpu_torch.ops.build import LIBRARY
from tracy_tpu_torch.ops.intersect import check_tables, intersect_plain
from tracy_tpu_torch.ops.launch import LaunchCount, check, raise_on_error
from tracy_tpu_torch.ops.shade import MTAB_COLS, rng_args, shade_plain

COUNT = LaunchCount()


def trace_bounce(origin, direction, throughput, radiance, alive, pixel_idx,
                 sample_key: int, bounce: int, *, tables: BVHTables, mtab, seed: int,
                 russian_roulette: bool, rng: str = "fast", position=None):
    """One bounce of every lane: returns the next (origin, direction,
    throughput, radiance, alive). Lanes that are not alive pass through.

    [N, 3] float32 origin, direction, throughput, radiance; [N] bool alive;
    [N] int32 pixel_idx; tables without texture uv or tangent (K5 is
    untextured), walked at their width; mtab from
    ops/shade.py::build_material_table; rng: the RNG kind (core/rng.py
    KINDS); position: [N] integer positions of the lanes in the wave, the
    counters of threefry's draws (None: each lane's own index; read only
    under threefry).
    """
    if tables.vertex_uv is not None or tables.vertex_tangent is not None:
        raise ValueError("trace_bounce: untextured scenes only (the tables carry "
                         "texture uv or tangent)")
    if origin.device.type == "cpu":
        COUNT.plain += 1
        return trace_bounce_plain(origin, direction, throughput, radiance, alive,
                                  pixel_idx, sample_key, bounce, tables=tables, mtab=mtab,
                                  seed=seed, russian_roulette=russian_roulette, rng=rng,
                                  position=position)
    n = origin.shape[0]
    dev = origin.device
    for name, x in (("origin", origin), ("direction", direction),
                    ("throughput", throughput), ("radiance", radiance)):
        check(name, x, torch.float32, (n, 3), dev)
    check("alive", alive, torch.bool, (n,), dev)
    check("pixel_idx", pixel_idx, torch.int32, (n,), dev)
    check("mtab", mtab, torch.float32, (mtab.shape[0], MTAB_COLS), dev)
    if mtab.shape[0] < 1:
        raise ValueError("mtab: needs at least the sky material")
    check_tables(tables, dev)
    if n >= 2**31 // 3:
        raise ValueError(f"{n} lanes overflow the kernel's int32 indexing")
    pos = None
    if rng == "threefry" and position is not None:
        pos = position.to(torch.int32).contiguous()
        check("position", pos, torch.int32, (n,), dev)

    out = tuple(torch.empty_like(x) for x in (origin, direction, throughput, radiance, alive))
    tb = tables
    code = LIBRARY.get().tracy_bounce(
        *(x.data_ptr() for x in (origin, direction, throughput, radiance, alive, pixel_idx)),
        0 if pos is None else pos.data_ptr(), n, tb.node_bounds.data_ptr(),
        tb.node_meta.data_ptr(), 0 if tb.wide is None else tb.wide.data_ptr(), tb.width,
        tb.tri.data_ptr(),
        tb.tri_meta.data_ptr(), tb.vertex_normal.data_ptr(), 0, 0, mtab.data_ptr(),
        mtab.shape[0], sample_key & MASK32, bounce & MASK32, seed & MASK32,
        int(bool(russian_roulette)), *rng_args(rng, seed, sample_key, bounce),
        *(x.data_ptr() for x in out),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("bounce", code)
    COUNT.kernel += 1
    return out


def trace_bounce_plain(origin, direction, throughput, radiance, alive, pixel_idx,
                       sample_key: int, bounce: int, *, tables: BVHTables, mtab,
                       seed: int, russian_roulette: bool, rng: str = "fast", position=None,
                       counts=None):
    """K5's bounce in PyTorch: intersect_plain (at the tables' width), then
    shade_plain on a copy of the state (K5 returns the next state in fresh
    tensors). position: as trace_bounce's. counts: as intersect_plain's
    (the traversal work)."""
    sh = intersect_plain(origin, direction, alive, tables, counts=counts)
    state = (x.clone() for x in (origin, direction, throughput, radiance, alive))
    return shade_plain(*state, pixel_idx, sh.hit.mask, sh.hit.t, sh.normal, sh.material,
                       mtab, sample_key, bounce, seed=seed,
                       russian_roulette=russian_roulette, rng=rng, position=position)
