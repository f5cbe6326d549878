"""K2 and K4: one shading bounce of the wavefront, untextured and textured.

`shade` (K2) and `shade_textured` (K4) are the wrappers the integrator
calls. On CUDA tensors they launch the hand-written kernels of csrc/shade.cu;
on CPU tensors, and only there, they run `shade_plain` and
`shade_textured_plain`, the same bounce in PyTorch built from
render/material.py. K2 replaces tracy_tpu/ops/pallas_shade.py::_kernel
(entered through shade_packets). K4 replaces the whole of
shade_packets_textured: the texel fetch (ops/texfetch.py, K3's addresses)
and pallas_shade.py::_kernel_tex in one launch. Both draw from the counter
hash `rng` names ('fast', 'xorshift' or 'lcg', core/rng.py).

Both update the state in place, as it saves memory traffic: a dead lane
moves only its alive flag, a miss lane only radiance and alive, and no
lane copies its state through. Their plain versions keep the same
contract. The caller must not need the old state (render/integrator.py's
trace_paths works on its own copies).

`shade_diff` is the same bounce, untextured or textured, out of place:
it returns new tensors and writes none, so autograd can differentiate
through it (an in-place write into a tensor that the graph saved raises,
or breaks the graph). It is what tracy_tpu's XLA shading is to its
training path, chosen by diff/gradients.py::render_loss and by nothing
else; it is not a stand-in for K2 or K4, which have no backward.
"""

from __future__ import annotations

import torch

from tracy_tpu_torch.core import math as tm
from tracy_tpu_torch.core.rng import KINDS, MASK32, RngSpec
from tracy_tpu_torch.ops.build import LIBRARY
from tracy_tpu_torch.ops.launch import LaunchCount, check, raise_on_error
from tracy_tpu_torch.ops.texfetch import (
    COUNT as TEX_COUNT, SMEM_LIMIT, check_texture_tables, fetch_texels_plain)
from tracy_tpu_torch.render.material import SurfaceParams, apply_textures, scatter
from tracy_tpu_torch.render.texture import TX_EMR
from tracy_tpu_torch.scene.scene import NUM_TEX_SLOTS, SKY_MATERIAL_ID, TEX_EMISSIVE

COUNT = LaunchCount()  # K2
COUNT_TEX = LaunchCount()  # K4
# Calls of the differentiable bounce, counted as `plain`: it has no kernel.
COUNT_DIFF = LaunchCount()
# RNG draw ids within a bounce (tracy_tpu/render/integrator.py).
DRAW_SPHERE_Z, DRAW_SPHERE_PHI, DRAW_SPECULAR, DRAW_ROULETTE = range(4)
MTAB_COLS = 10  # albedo rgb, roughness, metalness, ior, emissive rgb, translucent
# K4's table: MTAB_COLS, then one slot-present flag per texture slot (TEX_*
# order, pallas_shade.py _M_HAS*), then a zero pad column.
MTAB_TEX_COLS = 16
HAS_COL = MTAB_COLS


def build_material_table(materials) -> torch.Tensor:
    """[M, 10] float32 rows, one per material (columns as MTAB_COLS)."""
    m = materials
    return torch.cat([m.albedo, m.roughness[:, None], m.metalness[:, None],
                      m.ior[:, None], m.emissive, m.translucent[:, None]],
                     dim=1).contiguous()


def build_material_table_tex(materials) -> torch.Tensor:
    """[M, 16] float32 rows: build_material_table's, then 1.0 where the
    material has a texture in that slot (tracy_tpu's
    build_material_table_tex flag rows), then a zero pad."""
    base = build_material_table(materials)
    flags = (materials.tex_index >= 0).to(base.dtype)
    pad = torch.zeros((base.shape[0], 1), dtype=base.dtype, device=base.device)
    return torch.cat([base, flags, pad], dim=1).contiguous()


def shade(origin, direction, throughput, radiance, alive, pixel_idx, hit_mask,
          t, normal, mat_id, mtab, sample_key: int, bounce: int, *, seed: int,
          russian_roulette: bool, rng: str = "fast"):
    """One untextured bounce (K2), IN PLACE: origin, direction, throughput,
    radiance and alive are updated to the next state and returned. A lane
    that is not alive keeps its state; a miss lane changes only radiance
    and alive.

    [N, 3] float32: origin, direction, throughput, radiance, normal;
    [N] float32 t; [N] bool alive, hit_mask; [N] int32 pixel_idx, mat_id;
    mtab from build_material_table, which the kernel stages in shared
    memory; rng: the counter hash (core/rng.py KINDS).
    """
    if origin.device.type == "cpu":
        COUNT.plain += 1
        return shade_plain(origin, direction, throughput, radiance, alive,
                           pixel_idx, hit_mask, t, normal, mat_id, mtab,
                           sample_key, bounce, seed=seed,
                           russian_roulette=russian_roulette, rng=rng)
    n = origin.shape[0]
    _check_bounce(origin, direction, throughput, radiance, alive, pixel_idx, hit_mask,
                  t, normal, mat_id, mtab, MTAB_COLS)
    state = _check_state(origin, direction, throughput, radiance, alive, "shade")
    smem = 4 * MTAB_COLS * mtab.shape[0]
    if smem > SMEM_LIMIT:
        raise ValueError(f"shade: {mtab.shape[0]} materials need {smem} bytes of shared "
                         f"memory, more than the kernel's {SMEM_LIMIT}")
    code = LIBRARY.get().tracy_shade(
        *(x.data_ptr() for x in (origin, direction, throughput, radiance, alive,
                                 pixel_idx, hit_mask, t, normal, mat_id)),
        n, mtab.data_ptr(), mtab.shape[0], sample_key & MASK32, bounce & MASK32,
        seed & MASK32, int(bool(russian_roulette)), rng_index(rng), smem,
        torch.cuda.current_stream(origin.device).cuda_stream)
    raise_on_error("shade", code)
    COUNT.kernel += 1
    return state


def shade_plain(origin, direction, throughput, radiance, alive, pixel_idx,
                hit_mask, t, normal, mat_id, mtab, sample_key: int, bounce: int,
                *, seed: int, russian_roulette: bool, rng: str = "fast"):
    """The kernel's bounce in PyTorch (tracy_tpu's integrator bounce_step),
    in place as the kernel."""
    state = (origin, direction, throughput, radiance, alive)
    nxt = _next_state(*state, pixel_idx, hit_mask, t, normal, None, None, mat_id, mtab,
                      None, sample_key, bounce, seed, russian_roulette, rng)
    return _store(state, nxt, hit_mask)


def shade_textured(origin, direction, throughput, radiance, alive, pixel_idx,
                   hit_mask, t, normal, tangent, tex_uv, mat_id, mtab, tex_data,
                   tex_table, tex_index, sample_key: int, bounce: int, *, seed: int,
                   russian_roulette: bool, rng: str = "fast"):
    """One textured bounce (K4), IN PLACE: fetches each live lane's texels
    from the atlas (a hit lane the slots of its material at tex_uv, a miss
    lane the textured sky's), applies render/material.py::apply_textures'
    overrides and normal mapping, and runs shade's bounce. origin,
    direction, throughput, radiance and alive are updated in place and
    returned; a lane that is not alive keeps its state, a miss lane changes
    only radiance and alive. The caller must not need the old state.

    tangent: [N, 3] float32 interpolated, unnormalised, or None when no
    material has a normal map (read as zero); tex_uv: [N, 2] float32, or
    None when no material is textured (read as zero); mtab from
    build_material_table_tex; tex_data [P, 4] float32, tex_table [K, 4] and
    tex_index [M, 5] int32 (scene/scene.py), which the kernel stages in
    shared memory. The other arguments are shade's.
    """
    if origin.device.type == "cpu":
        COUNT_TEX.plain += 1
        return shade_textured_plain(origin, direction, throughput, radiance, alive,
                                    pixel_idx, hit_mask, t, normal, tangent, tex_uv,
                                    mat_id, mtab, tex_data, tex_table, tex_index,
                                    sample_key, bounce, seed=seed,
                                    russian_roulette=russian_roulette, rng=rng)
    n = origin.shape[0]
    dev = origin.device
    _check_bounce(origin, direction, throughput, radiance, alive, pixel_idx, hit_mask,
                  t, normal, mat_id, mtab, MTAB_TEX_COLS)
    if tangent is not None:
        check("tangent", tangent, torch.float32, (n, 3), dev)
    if tex_uv is not None:
        check("tex_uv", tex_uv, torch.float32, (n, 2), dev)
    check_texture_tables(tex_data, tex_table, tex_index, dev)
    if tex_index.shape[0] != mtab.shape[0]:
        raise ValueError(f"tex_index has {tex_index.shape[0]} materials, mtab "
                         f"{mtab.shape[0]}")
    state = _check_state(origin, direction, throughput, radiance, alive, "shade_textured")
    # Shared memory: mtab, tex_table (16-byte rows), then tex_index.
    smem = 4 * MTAB_TEX_COLS * mtab.shape[0] + 16 * tex_table.shape[0] + \
        4 * NUM_TEX_SLOTS * tex_index.shape[0]
    if smem > SMEM_LIMIT:
        raise ValueError(f"shade_textured: {mtab.shape[0]} materials and "
                         f"{tex_table.shape[0]} textures need {smem} bytes of shared "
                         f"memory, more than the kernel's {SMEM_LIMIT}")
    code = LIBRARY.get().tracy_shade_textured(
        *(x.data_ptr() for x in (origin, direction, throughput, radiance, alive,
                                 pixel_idx, hit_mask, t, normal)),
        0 if tangent is None else tangent.data_ptr(),
        0 if tex_uv is None else tex_uv.data_ptr(), mat_id.data_ptr(), n,
        mtab.data_ptr(), mtab.shape[0], tex_data.data_ptr(), tex_table.data_ptr(),
        tex_table.shape[0], tex_index.data_ptr(), sample_key & MASK32,
        bounce & MASK32, seed & MASK32, int(bool(russian_roulette)), rng_index(rng),
        smem, torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("shade_textured", code)
    COUNT_TEX.kernel += 1
    return state


def shade_textured_plain(origin, direction, throughput, radiance, alive, pixel_idx,
                         hit_mask, t, normal, tangent, tex_uv, mat_id, mtab, tex_data,
                         tex_table, tex_index, sample_key: int, bounce: int, *,
                         seed: int, russian_roulette: bool, rng: str = "fast"):
    """K4 in PyTorch, in place as the kernel: K3's plain fetch
    (ops/texfetch.py::fetch_texels_plain), then tracy_tpu's textured
    bounce_step on those texel rows."""
    state = (origin, direction, throughput, radiance, alive)
    nxt = _next_state(*state, pixel_idx, hit_mask, t, normal, tangent, tex_uv, mat_id, mtab,
                      (tex_data, tex_table, tex_index), sample_key, bounce, seed,
                      russian_roulette, rng)
    return _store(state, nxt, hit_mask)


def shade_diff(origin, direction, throughput, radiance, alive, pixel_idx, hit_mask, t,
               normal, tangent, tex_uv, mat_id, mtab, tex, sample_key: int, bounce: int, *,
               seed: int, russian_roulette: bool, rng: str = "fast"):
    """One bounce, OUT OF PLACE and differentiable: returns the next
    (origin, direction, throughput, radiance, alive) as new tensors, equal
    to what shade_plain (tex None) or shade_textured_plain (tex =
    (tex_data, tex_table, tex_index), mtab from build_material_table_tex)
    leave in their state. Gradients reach mtab (so the material table
    must be built from the trained parameters at every call), the atlas's
    texels, and t, normal and tangent; the Russian-roulette decision and
    its 1/p weight are detached, as in tracy_tpu (integrator.py:216-224).
    Arguments as shade_textured's; runs on any device, in PyTorch. A
    textured bounce gathers its texels with K3's plain version (K3 has no
    backward), counted in K3's plain count.
    """
    COUNT_DIFF.plain += 1
    if tex is not None:
        TEX_COUNT.plain += 1
    return _next_state(origin, direction, throughput, radiance, alive, pixel_idx, hit_mask,
                       t, normal, tangent, tex_uv, mat_id, mtab, tex, sample_key, bounce,
                       seed, russian_roulette, rng)


def rng_index(rng: str) -> int:
    """The kernels' id of a counter hash kind (csrc/shade_lane.cuh RNG_*)."""
    if rng not in KINDS:
        RngSpec(rng, 0)  # raises, with the reason for threefry
    return KINDS.index(rng)


def _check_bounce(origin, direction, throughput, radiance, alive, pixel_idx, hit_mask,
                  t, normal, mat_id, mtab, mtab_cols: int):
    """Check the arguments K2 and K4 share."""
    n = origin.shape[0]
    dev = origin.device
    for name, x in (("origin", origin), ("direction", direction),
                    ("throughput", throughput), ("radiance", radiance),
                    ("normal", normal)):
        check(name, x, torch.float32, (n, 3), dev)
    check("alive", alive, torch.bool, (n,), dev)
    check("hit_mask", hit_mask, torch.bool, (n,), dev)
    check("pixel_idx", pixel_idx, torch.int32, (n,), dev)
    check("t", t, torch.float32, (n,), dev)
    check("mat_id", mat_id, torch.int32, (n,), dev)
    check("mtab", mtab, torch.float32, (mtab.shape[0], mtab_cols), dev)
    if mtab.shape[0] < 1:
        raise ValueError("mtab: needs at least the sky material")


def _check_state(origin, direction, throughput, radiance, alive, kernel: str):
    """The state K2 and K4 update in place, refused if two of its tensors
    share memory."""
    state = (origin, direction, throughput, radiance, alive)
    if len({x.data_ptr() for x in state}) < len(state):
        raise ValueError(f"{kernel} updates the state in place: origin, direction, "
                         "throughput, radiance and alive must not share memory")
    return state


def _store(state, nxt, hit_mask):
    """Write a bounce's next state into `state` as the kernels do: a hit
    lane its whole state, a miss lane radiance and alive, a dead lane
    nothing. Returns `state`."""
    origin, direction, throughput, radiance, alive = state
    hit = (alive & hit_mask)[:, None]
    for x, y in zip((origin, direction, throughput), nxt[:3]):
        x.copy_(torch.where(hit, y, x))
    radiance.copy_(torch.where(alive[:, None], nxt[3], radiance))
    alive.copy_(nxt[4])
    return state


def _material_rows(mtab, mat_id):
    """mtab's row per lane; ids out of range read row 0, as in the kernels."""
    mat = mat_id.long()
    return tm.gather_rows(mtab, torch.where((mat >= 0) & (mat < mtab.shape[0]), mat, 0))


def _params(m, normal) -> SurfaceParams:
    return SurfaceParams(basecolor=m[:, 0:3], roughness=m[:, 3], metalness=m[:, 4],
                         ior=m[:, 5], emissive=m[:, 6:9], translucent=m[:, 9],
                         normal=normal)


def _next_state(origin, direction, throughput, radiance, alive, pixel_idx, hit_mask, t,
                normal, tangent, tex_uv, mat_id, mtab, tex, sample_key: int, bounce: int,
                seed: int, russian_roulette: bool, rng: str):
    """The next state of one bounce, out of place: the untextured bounce
    when tex is None, else K4's (K3's plain fetch, the textured overrides
    and the textured sky)."""
    m = _material_rows(mtab, mat_id)
    params = _params(m, normal)
    sky = mtab[SKY_MATERIAL_ID, 6:9]
    if tex is not None:
        texels = fetch_texels_plain(mat_id, tex_uv, direction, hit_mask, alive, *tex)
        if tangent is None:
            tangent = torch.zeros_like(normal)
        has = m[:, HAS_COL:HAS_COL + NUM_TEX_SLOTS] > 0.0
        params = apply_textures(params, texels, has, tangent)
        if bool(mtab[SKY_MATERIAL_ID, HAS_COL + TEX_EMISSIVE] > 0.0):
            sky = texels[:, TX_EMR:TX_EMR + 3]
    return _bounce_plain(origin, direction, throughput, radiance, alive, pixel_idx, hit_mask,
                         t, params, sky, sample_key, bounce, seed, russian_roulette, rng)


def _bounce_plain(origin, direction, throughput, radiance, alive, pixel_idx,
                  hit_mask, t, params: SurfaceParams, sky, sample_key: int,
                  bounce: int, seed: int, russian_roulette: bool, rng: str):
    """Scatter, emission, throughput and Russian roulette of one bounce;
    sky: [3] or [N, 3], the radiance a miss lane gathers."""
    spec = RngSpec(rng, seed)

    def rand(draw):
        return spec.uniform(pixel_idx, sample_key, bounce, draw)

    point = origin + t[:, None] * direction
    res = scatter(direction, point, params, rand(DRAW_SPHERE_Z),
                  rand(DRAW_SPHERE_PHI), rand(DRAW_SPECULAR))

    hit = hit_mask & alive
    miss = alive & ~hit_mask
    zero = torch.zeros((), dtype=origin.dtype, device=origin.device)
    emission = (torch.where(hit[:, None], res.emission, zero)
                + torch.where(miss[:, None], sky, zero))
    radiance = radiance + emission * throughput
    throughput = torch.where(hit[:, None], throughput * res.attenuation, throughput)

    alive2 = hit
    if russian_roulette:
        p = (tm.EPS + throughput.amax(dim=-1)).detach()
        keep = alive2 & (rand(DRAW_ROULETTE) <= p)
        throughput = torch.where(keep[:, None],
                                 throughput / torch.clamp(p[:, None], min=tm.EPS),
                                 throughput)
        alive2 = keep
    return (torch.where(hit[:, None], res.origin, origin),
            torch.where(hit[:, None], res.direction, direction),
            throughput, radiance, alive2)
