"""K2 and K4: one shading bounce of the wavefront, untextured and textured.

`shade` (K2) and `shade_textured` (K4) are the wrappers the integrator
calls. On CUDA tensors they launch the hand-written kernels of csrc/shade.cu;
on CPU tensors, and only there, they run `shade_plain` and
`shade_textured_plain`, the same bounce in PyTorch built from
render/material.py. K2 replaces tracy_tpu/ops/pallas_shade.py::_kernel
(entered through shade_packets), K4 replaces pallas_shade.py::_kernel_tex
(entered through shade_packets_textured); both share shade_planes' math, as
the two CUDA kernels share one device function. The RNG is the 'fast'
counter hash.
"""

from __future__ import annotations

import torch

from tracy_tpu_torch.core import math as tm
from tracy_tpu_torch.core.rng import MASK32, RngSpec
from tracy_tpu_torch.ops.build import LIBRARY
from tracy_tpu_torch.ops.launch import LaunchCount, check, raise_on_error
from tracy_tpu_torch.render.material import SurfaceParams, apply_textures, scatter
from tracy_tpu_torch.render.texture import TEXEL_COLS, TX_EMR
from tracy_tpu_torch.scene.scene import NUM_TEX_SLOTS, SKY_MATERIAL_ID, TEX_EMISSIVE

COUNT = LaunchCount()  # K2
COUNT_TEX = LaunchCount()  # K4
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
          russian_roulette: bool):
    """One bounce: returns the next (origin, direction, throughput,
    radiance, alive). Lanes that are not alive pass through unchanged.

    [N, 3] float32: origin, direction, throughput, radiance, normal;
    [N] float32 t; [N] bool alive, hit_mask; [N] int32 pixel_idx, mat_id;
    mtab from build_material_table.
    """
    if origin.device.type == "cpu":
        COUNT.plain += 1
        return shade_plain(origin, direction, throughput, radiance, alive,
                           pixel_idx, hit_mask, t, normal, mat_id, mtab,
                           sample_key, bounce, seed=seed,
                           russian_roulette=russian_roulette)
    return _launch("shade", COUNT, origin, direction, throughput, radiance, alive,
                   pixel_idx, hit_mask, t, normal, mat_id, mtab, MTAB_COLS, sample_key,
                   bounce, seed, russian_roulette)


def shade_plain(origin, direction, throughput, radiance, alive, pixel_idx,
                hit_mask, t, normal, mat_id, mtab, sample_key: int, bounce: int,
                *, seed: int, russian_roulette: bool):
    """The kernel's bounce in PyTorch (tracy_tpu's integrator bounce_step)."""
    m = _material_rows(mtab, mat_id)
    return _bounce_plain(origin, direction, throughput, radiance, alive, pixel_idx,
                         hit_mask, t, _params(m, normal), mtab[SKY_MATERIAL_ID, 6:9],
                         sample_key, bounce, seed, russian_roulette)


def shade_textured(origin, direction, throughput, radiance, alive, pixel_idx,
                   hit_mask, t, normal, tangent, mat_id, texels, mtab,
                   sample_key: int, bounce: int, *, seed: int, russian_roulette: bool):
    """One textured bounce (K4): shade's bounce after the texture overrides
    and normal mapping of render/material.py::apply_textures; a miss lane
    takes the sky from its texel row when the sky is textured.

    tangent: [N, 3] float32 interpolated, unnormalised, or None when no
    material has a normal map (read as zero); texels: [N, TEXEL_COLS] rows
    from ops/texfetch.py (K3); mtab from build_material_table_tex. The other
    arguments are shade's.
    """
    if origin.device.type == "cpu":
        COUNT_TEX.plain += 1
        return shade_textured_plain(origin, direction, throughput, radiance, alive,
                                    pixel_idx, hit_mask, t, normal, tangent, mat_id,
                                    texels, mtab, sample_key, bounce, seed=seed,
                                    russian_roulette=russian_roulette)
    return _launch("shade_textured", COUNT_TEX, origin, direction, throughput, radiance,
                   alive, pixel_idx, hit_mask, t, normal, mat_id, mtab, MTAB_TEX_COLS,
                   sample_key, bounce, seed, russian_roulette, tangent=tangent,
                   texels=texels)


def _launch(kernel: str, count: LaunchCount, origin, direction, throughput, radiance,
            alive, pixel_idx, hit_mask, t, normal, mat_id, mtab, mtab_cols: int,
            sample_key: int, bounce: int, seed: int, russian_roulette: bool, *,
            tangent=None, texels=None):
    """Check the arguments of K2 (texels None) or K4, launch it through the
    library's tracy_<kernel> entry point and count the launch."""
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
    textured = ()
    if texels is not None:
        if tangent is not None:
            check("tangent", tangent, torch.float32, (n, 3), dev)
        check("texels", texels, torch.float32, (n, TEXEL_COLS), dev)
        if texels.data_ptr() % 16:
            raise ValueError("texels: the kernel reads rows as 16-byte vectors; "
                             "it must be 16-byte aligned")
        textured = (0 if tangent is None else tangent.data_ptr(), texels.data_ptr())

    out = tuple(torch.empty_like(x) for x in (origin, direction, throughput, radiance, alive))
    code = getattr(LIBRARY.get(), f"tracy_{kernel}")(
        *(x.data_ptr() for x in (origin, direction, throughput, radiance, alive,
                                 pixel_idx, hit_mask, t, normal, mat_id)),
        *textured, n, mtab.data_ptr(), mtab.shape[0], sample_key & MASK32,
        bounce & MASK32, seed & MASK32, int(bool(russian_roulette)),
        *(x.data_ptr() for x in out), torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(kernel, code)
    count.kernel += 1
    return out


def shade_textured_plain(origin, direction, throughput, radiance, alive, pixel_idx,
                         hit_mask, t, normal, tangent, mat_id, texels, mtab,
                         sample_key: int, bounce: int, *, seed: int,
                         russian_roulette: bool):
    """K4's bounce in PyTorch: tracy_tpu's textured bounce_step."""
    m = _material_rows(mtab, mat_id)
    if tangent is None:
        tangent = torch.zeros_like(normal)
    has = m[:, HAS_COL:HAS_COL + NUM_TEX_SLOTS] > 0.0
    params = apply_textures(_params(m, normal), texels, has, tangent)
    sky = mtab[SKY_MATERIAL_ID, 6:9]
    if bool(mtab[SKY_MATERIAL_ID, HAS_COL + TEX_EMISSIVE] > 0.0):
        sky = texels[:, TX_EMR:TX_EMR + 3]
    return _bounce_plain(origin, direction, throughput, radiance, alive, pixel_idx,
                         hit_mask, t, params, sky, sample_key, bounce, seed,
                         russian_roulette)


def _material_rows(mtab, mat_id):
    """mtab's row per lane; ids out of range read row 0, as in the kernels."""
    mat = mat_id.long()
    return mtab[torch.where((mat >= 0) & (mat < mtab.shape[0]), mat, 0)]


def _params(m, normal) -> SurfaceParams:
    return SurfaceParams(basecolor=m[:, 0:3], roughness=m[:, 3], metalness=m[:, 4],
                         ior=m[:, 5], emissive=m[:, 6:9], translucent=m[:, 9],
                         normal=normal)


def _bounce_plain(origin, direction, throughput, radiance, alive, pixel_idx,
                  hit_mask, t, params: SurfaceParams, sky, sample_key: int,
                  bounce: int, seed: int, russian_roulette: bool):
    """Scatter, emission, throughput and Russian roulette of one bounce;
    sky: [3] or [N, 3], the radiance a miss lane gathers."""
    rng = RngSpec("fast", seed)

    def rand(draw):
        return rng.uniform(pixel_idx, sample_key, bounce, draw)

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
        p = tm.EPS + throughput.amax(dim=-1)
        keep = alive2 & (rand(DRAW_ROULETTE) <= p)
        throughput = torch.where(keep[:, None],
                                 throughput / torch.clamp(p[:, None], min=tm.EPS),
                                 throughput)
        alive2 = keep
    return (torch.where(hit[:, None], res.origin, origin),
            torch.where(hit[:, None], res.direction, direction),
            throughput, radiance, alive2)
