"""K2: one untextured shading bounce of the wavefront.

`shade` is the wrapper the integrator calls. On CUDA tensors it launches the
hand-written kernel csrc/shade.cu; on CPU tensors, and only there, it runs
`shade_plain`, the same bounce in PyTorch built from render/material.py.
The kernel replaces tracy_tpu/ops/pallas_shade.py::_kernel/shade_planes
(entered through shade_packets). Its RNG is the 'fast' counter hash.
"""

from __future__ import annotations

import torch

from tracy_tpu_torch.core import math as tm
from tracy_tpu_torch.core.rng import MASK32, RngSpec
from tracy_tpu_torch.ops.build import LIBRARY
from tracy_tpu_torch.ops.launch import LaunchCount, check, raise_on_error
from tracy_tpu_torch.render.material import SurfaceParams, scatter
from tracy_tpu_torch.scene.scene import SKY_MATERIAL_ID

COUNT = LaunchCount()
# RNG draw ids within a bounce (tracy_tpu/render/integrator.py).
DRAW_SPHERE_Z, DRAW_SPHERE_PHI, DRAW_SPECULAR, DRAW_ROULETTE = range(4)
MTAB_COLS = 10  # albedo rgb, roughness, metalness, ior, emissive rgb, translucent


def build_material_table(materials) -> torch.Tensor:
    """[M, 10] float32 rows, one per material (columns as MTAB_COLS)."""
    m = materials
    return torch.cat([m.albedo, m.roughness[:, None], m.metalness[:, None],
                      m.ior[:, None], m.emissive, m.translucent[:, None]],
                     dim=1).contiguous()


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
    check("mtab", mtab, torch.float32, (mtab.shape[0], MTAB_COLS), dev)
    if mtab.shape[0] < 1:
        raise ValueError("mtab: needs at least the sky material")

    o2 = torch.empty_like(origin)
    d2 = torch.empty_like(direction)
    thr2 = torch.empty_like(throughput)
    rad2 = torch.empty_like(radiance)
    alive2 = torch.empty_like(alive)
    lib = LIBRARY.get()
    code = lib.tracy_shade(
        *(x.data_ptr() for x in (origin, direction, throughput, radiance, alive,
                                 pixel_idx, hit_mask, t, normal, mat_id)),
        n, mtab.data_ptr(), mtab.shape[0], sample_key & MASK32, bounce & MASK32,
        seed & MASK32, int(bool(russian_roulette)),
        *(x.data_ptr() for x in (o2, d2, thr2, rad2, alive2)),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("shade", code)
    COUNT.kernel += 1
    return o2, d2, thr2, rad2, alive2


def shade_plain(origin, direction, throughput, radiance, alive, pixel_idx,
                hit_mask, t, normal, mat_id, mtab, sample_key: int, bounce: int,
                *, seed: int, russian_roulette: bool):
    """The kernel's bounce in PyTorch (tracy_tpu's integrator bounce_step)."""
    rng = RngSpec("fast", seed)

    def rand(draw):
        return rng.uniform(pixel_idx, sample_key, bounce, draw)

    mat = mat_id.long()
    m = mtab[torch.where((mat >= 0) & (mat < mtab.shape[0]), mat, 0)]  # else row 0
    params = SurfaceParams(basecolor=m[:, 0:3], roughness=m[:, 3], metalness=m[:, 4],
                           ior=m[:, 5], emissive=m[:, 6:9], translucent=m[:, 9],
                           normal=normal)
    point = origin + t[:, None] * direction
    res = scatter(direction, point, params, rand(DRAW_SPHERE_Z),
                  rand(DRAW_SPHERE_PHI), rand(DRAW_SPECULAR))

    hit = hit_mask & alive
    miss = alive & ~hit_mask
    sky = mtab[SKY_MATERIAL_ID, 6:9]
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

