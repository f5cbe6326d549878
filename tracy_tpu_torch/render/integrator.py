"""Wavefront path-tracing integrator.

Port of tracy_tpu/render/integrator.py (reference CpuTrace::Trace,
cpu_trace.cpp:107-170). All rays advance together through a Python loop
over bounces with masked lanes. Each bounce runs an intersector and then
a shade stage, given as `shade_fn` as in tracy_tpu (integrator.py:124).
The render path's (make_shade_fn) updates the state in place: on an
untextured scene K2 (ops/shade.py::shade), on a textured one K4
(ops/shade.py::shade_textured, which fetches each lane's texels itself).
Training passes the out-of-place, differentiable ops/shade.py::shade_diff
(diff/gradients.py::render_loss). A fused bounce (ops/bounce.py, K5) may
take the place of both stages. On CUDA tensors these launch the kernels;
on CPU tensors, their plain versions. The counter RNG is cfg.rng's hash
('fast', 'xorshift' or 'lcg'). `trace_aov` renders the first-hit AOVs
(one intersection, then the surface parameters: K3 on textured scenes).

* radiance += emission * throughput on hit; throughput *= attenuation;
* a miss adds the sky (material slot 0's emissive, or its equirect texture
  at uv = (atan2(z, x) / 2pi, asin(y) / pi) + .5, cpu_trace.cpp:149) and
  ends;
* Russian roulette with p = EPS + max(throughput), survivors reweighted 1/p;
* one ray is counted per live lane per bounce (cpu_trace.cpp:113-116).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from tracy_tpu_torch.config import RenderConfig
from tracy_tpu_torch.core import math as tm
from tracy_tpu_torch.ops.intersect import SurfaceHit
from tracy_tpu_torch.ops.shade import (
    build_material_table,
    build_material_table_tex,
    shade,
    shade_textured,
)
from tracy_tpu_torch.render.intersect import intersect_bruteforce
from tracy_tpu_torch.render.material import gather_surface_params, scene_has_textures
from tracy_tpu_torch.render.texture import sample_nearest, sky_uv
from tracy_tpu_torch.scene.scene import SKY_MATERIAL_ID, TEX_EMISSIVE, SceneArrays

# Pseudo-bounce id of the camera jitter draws.
JITTER_BOUNCE = 255

IntersectFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], SurfaceHit]
# (origin [N,3], direction [N,3], active [N]) -> SurfaceHit
BounceFn = Callable[..., Tuple[torch.Tensor, ...]]
# (origin, direction, throughput, radiance, alive, pixel_idx, sample_key,
#  bounce) -> next (origin, direction, throughput, radiance, alive)
ShadeFn = Callable[..., Tuple[torch.Tensor, ...]]
# (origin, direction, throughput, radiance, alive, pixel_idx, hit_mask, t,
#  normal, tangent, tex_uv, material, sample_key, bounce) -> next (origin,
#  direction, throughput, radiance, alive)


class HitAttributes(NamedTuple):
    point: torch.Tensor  # [N, 3]
    normal: torch.Tensor  # [N, 3] interpolated, NOT normalized (reference quirk)
    tangent: torch.Tensor  # [N, 3] interpolated, NOT normalized
    uv: torch.Tensor  # [N, 2] texture coords
    material: torch.Tensor  # [N] int32


def interpolate_hit(scene: SceneArrays, hit, origin, direction) -> HitAttributes:
    """Barycentric attribute interpolation (cpu_details.cpp:169-182)."""
    tri = hit.tri.long()
    idx = scene.indices[tri].long()
    u = hit.uv[..., 0:1]
    v = hit.uv[..., 1:2]
    w = 1.0 - u - v

    def interp(attr):
        return w * attr[idx[:, 0]] + u * attr[idx[:, 1]] + v * attr[idx[:, 2]]

    return HitAttributes(
        point=origin + hit.t[:, None] * direction,
        normal=interp(scene.vertex_normal),
        tangent=interp(scene.vertex_tangent),
        uv=interp(scene.vertex_uv),
        material=scene.tri_material[tri],
    )


def sky_emission(scene: SceneArrays, direction) -> torch.Tensor:
    """Sky radiance for miss lanes via material slot 0 (cpu_trace.cpp:
    147-156): its constant emissive, or on a textured scene whose sky has an
    emissive texture, that equirect texture's nearest texel."""
    m = scene.materials
    const = m.emissive[SKY_MATERIAL_ID].expand(direction.shape)
    if not scene_has_textures(scene):
        return const
    tid = int(m.tex_index[SKY_MATERIAL_ID, TEX_EMISSIVE])
    if tid < 0:
        return const
    tids = torch.full(direction.shape[:-1], tid, dtype=torch.int32, device=direction.device)
    return sample_nearest(scene.tex_data, scene.tex_table, tids, sky_uv(direction))[:, :3]


def make_bruteforce_intersector(scene: SceneArrays, tri_chunk: int = 512) -> IntersectFn:
    """The exact oracle as an intersector: every triangle, every ray."""
    p0, p1, p2 = scene.triangle_vertices()
    e1, e2 = p1 - p0, p2 - p0

    def intersect(origin, direction, active):
        hit = intersect_bruteforce(origin, direction, p0, e1, e2,
                                   tri_chunk=tri_chunk, active=active)
        attrs = interpolate_hit(scene, hit, origin, direction)
        return SurfaceHit(hit, attrs.normal, attrs.material, attrs.uv, attrs.tangent)

    return intersect


def make_shade_fn(scene: SceneArrays, cfg: RenderConfig, mtab=None) -> ShadeFn:
    """The render path's shade stage, in place: K2 on an untextured scene,
    K4 on a textured one. mtab: the material table (build_material_table,
    or build_material_table_tex on a textured scene), None to build it."""
    textured = scene_has_textures(scene)
    if mtab is None:
        mtab = (build_material_table_tex if textured else build_material_table)(scene.materials)
    kw = dict(seed=cfg.seed, russian_roulette=cfg.russian_roulette, rng=cfg.rng)
    if textured:
        tex = (scene.tex_data, scene.tex_table, scene.materials.tex_index)

        def shade_fn(o, d, thr, rad, alive, pix, hit_mask, t, normal, tangent, tex_uv, mat,
                     sample_key, bounce):
            return shade_textured(o, d, thr, rad, alive, pix, hit_mask, t, normal, tangent,
                                  tex_uv, mat, mtab, *tex, sample_key, bounce, **kw)
    else:
        def shade_fn(o, d, thr, rad, alive, pix, hit_mask, t, normal, tangent, tex_uv, mat,
                     sample_key, bounce):
            return shade(o, d, thr, rad, alive, pix, hit_mask, t, normal, mat, mtab,
                         sample_key, bounce, **kw)
    return shade_fn


class PathState(NamedTuple):
    origin: torch.Tensor  # [N, 3]
    direction: torch.Tensor  # [N, 3]
    throughput: torch.Tensor  # [N, 3]
    radiance: torch.Tensor  # [N, 3]
    alive: torch.Tensor  # [N] bool


def trace_paths(scene: SceneArrays, origin, direction, pixel_idx, sample_key: int,
                cfg: RenderConfig, intersect_fn: IntersectFn, active0=None,
                shade_fn: Optional[ShadeFn] = None, bounce_fn: Optional[BounceFn] = None,
                first_intersect_fn: Optional[IntersectFn] = None,
                first_bounce_fn: Optional[BounceFn] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trace N paths for cfg.max_bounces bounces.

    pixel_idx: [N] int32 global pixel ids keying the RNG; sample_key: the
    frame/sample counter. active0: [N] bool, None = all live; dead lanes
    (tile-padding rows) are never counted and gather no radiance.
    shade_fn: the shade stage (ShadeFn), None for the render path's
    (make_shade_fn: K2 or K4, in place). bounce_fn: a fused bounce
    (ops/bounce.py, maybe compaction-wrapped); it supersedes intersect_fn
    and the shade stage. first_intersect_fn / first_bounce_fn: what bounce
    0 runs instead (the wave is all live there, so the Renderer gives the
    uncompacted function); the result is the same. Rays are counted before
    any routing, over the real lanes. The render path's shade stage
    updates the state in place, so the state starts as copies of origin,
    direction and active0: the caller's tensors are left as they were.
    Returns (radiance [N, 3], rays: a 0-d int64 tensor).
    """
    n = origin.shape[0]
    dev = origin.device
    if shade_fn is None and bounce_fn is None:
        shade_fn = make_shade_fn(scene, cfg)

    def own(x):
        return x.clone(memory_format=torch.contiguous_format)

    s = PathState(
        origin=own(origin),
        direction=own(direction),
        throughput=torch.ones((n, 3), dtype=origin.dtype, device=dev),
        radiance=torch.zeros((n, 3), dtype=origin.dtype, device=dev),
        alive=(torch.ones((n,), dtype=torch.bool, device=dev) if active0 is None
               else own(active0)),
    )
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for bounce in range(cfg.max_bounces):
        rays = rays + s.alive.sum()
        if bounce_fn is not None:
            fn = first_bounce_fn if bounce == 0 and first_bounce_fn is not None else bounce_fn
            s = PathState(*fn(s.origin, s.direction, s.throughput, s.radiance, s.alive,
                              pixel_idx, sample_key, bounce))
            continue
        fn = (first_intersect_fn if bounce == 0 and first_intersect_fn is not None
              else intersect_fn)
        sh = fn(s.origin, s.direction, s.alive)
        s = PathState(*shade_fn(*s, pixel_idx, sh.hit.mask, sh.hit.t, sh.normal, sh.tangent,
                                sh.tex_uv, sh.material, sample_key, bounce))
    return s.radiance, rays


def trace_aov(scene: SceneArrays, origin, direction, cfg: RenderConfig,
              intersect_fn: IntersectFn, active=None, fetch_fn=None) -> torch.Tensor:
    """First-hit AOV views (tracy_tpu's trace_aov, reference DEBUG_SHOW_*,
    cpu_trace.cpp:127-137): [N, 3] of cfg.aov, 0 where the ray misses.

    basecolor, metalness, roughness and emissive are the hit's surface
    parameters (textures applied); normals the shading normal through the
    view rotation as .5 * normalize(1 + Vn) (cpu_trace.cpp:130); depth the
    hit distance. active: [N] bool, the lanes to trace (None = all; the
    others miss). fetch_fn: gather_surface_params' texel fetch (None = K3's
    wrapper).
    """
    n = origin.shape[0]
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=origin.device)
    sh = intersect_fn(origin, direction, active)
    hit = sh.hit
    params = gather_surface_params(scene, sh.material, sh.tex_uv, sh.normal, sh.tangent,
                                   direction, hit.mask, fetch_fn)
    if cfg.aov == "basecolor":
        out = params.basecolor
    elif cfg.aov == "normals":
        # Explicit mul-adds in the JAX package's order.
        v = scene.camera.view[:3, :3]
        nrm = params.normal
        view_n = nrm[:, 0:1] * v[:, 0] + nrm[:, 1:2] * v[:, 1] + nrm[:, 2:3] * v[:, 2]
        out = 0.5 * tm.normalize(1.0 + view_n)
    elif cfg.aov == "metalness":
        out = params.metalness[:, None].expand(n, 3)
    elif cfg.aov == "roughness":
        out = params.roughness[:, None].expand(n, 3)
    elif cfg.aov == "emissive":
        out = params.emissive
    elif cfg.aov == "depth":
        zero = torch.zeros((), dtype=hit.t.dtype, device=hit.t.device)
        out = torch.where(hit.mask, hit.t, zero)[:, None].expand(n, 3)
    else:
        raise ValueError(f"not an AOV mode: {cfg.aov}")
    return torch.where(hit.mask[:, None], out, torch.zeros((), dtype=out.dtype,
                                                           device=out.device))
