"""Differentiable rendering: pixel gradients -> scene parameters.

Port of tracy_tpu/diff/gradients.py, on autograd. The light path is
differentiable in the materials, the texture atlas and the vertices:

* the intersector's closest-hit choice is detached (K1 under
  ops/intersect.py::nondiff_intersector); material and texture gradients
  flow through the material ids and texture uv it returns, which select
  table rows and texels;
* vertex gradients come from GeometryDiffIntersector, which recomputes
  the winner's t, barycentrics, normal, uv and tangent in torch from the
  traced vertices at K1's detached winner;
* each bounce shades with ops/shade.py::shade_diff, out of place (K2 and
  K4 write their state in place and have no backward), on a material
  table built from the traced parameters at every call; the specular and
  Russian-roulette decisions compare detached numbers, so the estimator
  stays unbiased;
* the counter RNG gives f(theta +/- h) the same random numbers, so
  central differences converge (tests/test_torch_gradients.py).

`TrainableParams` selects the leaves (albedo, roughness, metalness, ior,
emissive, translucency, texture atlas, vertices); `make_train_step`
returns an inverse-rendering step on torch.optim.Adam, whose update and
defaults (betas 0.9, 0.999, eps 1e-8) are optax.adam's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from tracy_tpu_torch.accel.reorder import compact_intersector
from tracy_tpu_torch.accel.tables import build_tables
from tracy_tpu_torch.config import RenderConfig
from tracy_tpu_torch.core import math as tm
from tracy_tpu_torch.ops import texfetch
from tracy_tpu_torch.ops.intersect import SurfaceHit, intersect, nondiff_intersector
from tracy_tpu_torch.ops.shade import build_material_table, build_material_table_tex, shade_diff
from tracy_tpu_torch.render.intersect import Hit
from tracy_tpu_torch.render.material import scene_has_textures
from tracy_tpu_torch.render.renderer import sample_radiance
from tracy_tpu_torch.scene.scene import SceneArrays
from tracy_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


class TrainableParams(NamedTuple):
    """The differentiable leaves of a scene."""

    albedo: torch.Tensor  # [M, 3]
    roughness: torch.Tensor  # [M]
    metalness: torch.Tensor  # [M]
    ior: torch.Tensor  # [M]
    emissive: torch.Tensor  # [M, 3]
    translucent: torch.Tensor  # [M]
    tex_data: torch.Tensor  # [P, 4]
    vertex_pos: torch.Tensor  # [V, 3]


def extract_params(scene: SceneArrays) -> TrainableParams:
    m = scene.materials
    return TrainableParams(albedo=m.albedo, roughness=m.roughness, metalness=m.metalness,
                           ior=m.ior, emissive=m.emissive, translucent=m.translucent,
                           tex_data=scene.tex_data, vertex_pos=scene.vertex_pos)


def apply_params(scene: SceneArrays, params: TrainableParams) -> SceneArrays:
    materials = dataclasses.replace(
        scene.materials, albedo=params.albedo, roughness=params.roughness,
        metalness=params.metalness, ior=params.ior, emissive=params.emissive,
        translucent=params.translucent)
    return dataclasses.replace(scene, materials=materials, tex_data=params.tex_data,
                               vertex_pos=params.vertex_pos)


def params_from_jax(src, device=DEFAULT_DEVICE) -> TrainableParams:
    """The port's TrainableParams from tracy_tpu's (each leaf read through
    np.asarray, so no jax is needed), float32, on the card by default
    (device="cpu" for the CPU)."""
    device = resolve_device(device)
    return TrainableParams(*(torch.tensor(np.asarray(x, np.float32), device=device)
                             for x in src))


class GeometryDiffIntersector:
    """Winner-recompute differentiable intersector (tracy_tpu's, :78-177).

    The base intersector (K1 under nondiff_intersector, maybe compacted)
    finds each ray's winning triangle, detached. bind(scene) gives an
    intersector that recomputes, in torch, from the scene's traced
    vertices at that winner: Möller–Trumbore's t and barycentrics, and the
    interpolated normal, texture uv and tangent. Misses keep the base
    values. The choice of winner is not differentiated (it changes only on
    visibility boundaries, of measure zero), as with the brute-force
    intersector's argmin.

    The base's BVH is built once, from the geometry it was given: winners
    come from that geometry while t, uv and the normal follow the traced
    vertices, as in tracy_tpu. The base's triangle id is the global one
    (compaction routes it back: accel/reorder.py), so no slot map is
    needed, as tracy_tpu's compact_intersector_slot gives one.
    """

    def __init__(self, base, first_base=None):
        self._base = base
        # An uncompacted base for bounce 0, bound as `.first`.
        self._first_base = first_base

    def bind(self, s: SceneArrays):
        def make_isect(base):
            def isect(o, d, act):
                sh = base(o, d, act)
                hit0 = sh.hit
                mask = hit0.mask
                vidx = s.indices[hit0.tri.long()].long()
                p0, p1, p2 = (tm.gather_rows(s.vertex_pos, vidx[:, c]) for c in range(3))
                e1, e2 = p1 - p0, p2 - p0
                # Möller–Trumbore on the winner (collision.h:33-74).
                pvec = tm.cross(d, e2)
                det = tm.dot(e1, pvec, keepdim=False)
                safe = mask & (det.abs() > 1e-12)
                inv_det = torch.where(safe, 1.0 / torch.where(safe, det, 1.0), 0.0)
                tvec = o - p0
                u = tm.dot(tvec, pvec, keepdim=False) * inv_det
                qvec = tm.cross(tvec, e1)
                v = tm.dot(d, qvec, keepdim=False) * inv_det
                t = tm.dot(e2, qvec, keepdim=False) * inv_det
                t = torch.where(safe, t, hit0.t)
                u = torch.where(safe, u, hit0.uv[:, 0])
                v = torch.where(safe, v, hit0.uv[:, 1])
                w = 1.0 - u - v

                def interp(table, base_val):
                    a0, a1, a2 = (tm.gather_rows(table, vidx[:, c]) for c in range(3))
                    val = w[:, None] * a0 + u[:, None] * a1 + v[:, None] * a2
                    return torch.where(mask[:, None], val,
                                       0.0 if base_val is None else base_val)

                hit = Hit(t=t, tri=hit0.tri, uv=torch.stack([u, v], dim=-1), mask=mask)
                return SurfaceHit(hit, interp(s.vertex_normal, sh.normal), sh.material,
                                  interp(s.vertex_uv, sh.tex_uv),
                                  interp(s.vertex_tangent, sh.tangent))

            return isect

        isect = make_isect(self._base)
        if self._first_base is not None:
            isect.first = make_isect(self._first_base)
        return isect

    def __call__(self, o, d, act) -> SurfaceHit:
        """Unbound: the base's values (no geometry gradients)."""
        return self._base(o, d, act)


def make_training_intersector(scene: SceneArrays, cfg: RenderConfig,
                              needs_geometry_grads: bool):
    """The intersector for inverse rendering (tracy_tpu's :180-281).

    K1 (ops/intersect.py: the kernel on CUDA tensors, its plain version on
    CPU ones) over BVH tables built once from `scene`, at
    cfg.pallas_bvh_width, under nondiff_intersector; with
    cfg.wave_compact_group, wrapped in accel/reorder.py's compaction, with
    the uncompacted base as `.first` for bounce 0 when
    cfg.wave_compact_skip_first (render_loss passes it on).
    needs_geometry_grads: a GeometryDiffIntersector around that (compacted)
    base, for vertex gradients.
    """
    tables = build_tables(scene, leaf_size=cfg.bvh_leaf_size,
                          max_depth=max(cfg.traversal_stack_depth - 4, 8),
                          width=cfg.pallas_bvh_width)
    base = nondiff_intersector(functools.partial(intersect, tables=tables))
    group = cfg.wave_compact_group
    inner = compact_intersector(base, group) if group else base
    first = base if group and cfg.wave_compact_skip_first else None
    if needs_geometry_grads:
        return GeometryDiffIntersector(inner, first_base=first)
    if first is not None:
        inner.first = first
    return inner


def differentiable_shade_fn(scene: SceneArrays, cfg: RenderConfig):
    """trace_paths' shade stage for training: ops/shade.py::shade_diff on
    a material table built from `scene`'s (traced) materials, textured
    when the scene is."""
    textured = scene_has_textures(scene)
    mtab = (build_material_table_tex if textured else build_material_table)(scene.materials)
    tex = (scene.tex_data, scene.tex_table, scene.materials.tex_index) if textured else None
    kw = dict(seed=cfg.seed, russian_roulette=cfg.russian_roulette, rng=cfg.rng)

    def shade_fn(o, d, thr, rad, alive, pix, hit_mask, t, normal, tangent, tex_uv, mat,
                 sample_key, bounce):
        return shade_diff(o, d, thr, rad, alive, pix, hit_mask, t, normal, tangent, tex_uv,
                          mat, mtab, tex, sample_key, bounce, **kw)

    return shade_fn


def _fetch_texels_diff(*args):
    """K3's plain gather, counted in K3's plain count as shade_diff's is."""
    texfetch.COUNT.plain += 1
    return texfetch.fetch_texels_plain(*args)


def render_loss(params: TrainableParams, scene: SceneArrays, target: torch.Tensor,
                cfg: RenderConfig, frame: int, intersect_fn=None) -> torch.Tensor:
    """MSE between a frame (cfg.spp samples at RNG position `frame`) and
    target [H, W, 3], differentiable in `params`. intersect_fn: None for
    the brute-force intersector, built here from the traced scene (vertex
    gradients reach it); a GeometryDiffIntersector is bound to the traced
    scene here; `.first`, if present, runs bounce 0. Each bounce shades
    with ops/shade.py::shade_diff, and a textured AOV reads its texels
    with K3's plain gather (fetch_texels_plain, on any device), since K3
    has no backward."""
    s = apply_params(scene, params)
    if hasattr(intersect_fn, "bind"):
        intersect_fn = intersect_fn.bind(s)
    radiance, _ = sample_radiance(s, cfg, frame, intersect_fn,
                                  shade_fn=differentiable_shade_fn(s, cfg),
                                  first_intersect_fn=getattr(intersect_fn, "first", None),
                                  fetch_fn=_fetch_texels_diff)
    return torch.mean((radiance - target) ** 2)


def make_train_step(scene: SceneArrays, cfg: RenderConfig, optimizer=None,
                    intersect_fn=None, trainable_mask: Optional[TrainableParams] = None):
    """Returns (step_fn, params, opt_state).

    params: TrainableParams of fresh leaf tensors, copies of the scene's,
    that require grad where trainable_mask allows an update; opt_state:
    optimizer over them (a callable taking the list of tensors; default
    torch.optim.Adam at lr 1e-2). step_fn(params, opt_state, target,
    frame) -> (params, opt_state, loss): render, loss, backward through
    the bounce loop, optimizer step, in place on params.

    trainable_mask: TrainableParams of bool (or 0/1) entries broadcastable
    to each leaf, None = all trainable. Gradients are multiplied by it,
    and the masked-out entries are set back to the scene's values after
    each step, so they stay bit for bit what they were (tracy_tpu's
    :307-346). A leaf with no entry set gets no gradient at all.
    """
    base = extract_params(scene)
    masks = (None if trainable_mask is None else
             [torch.as_tensor(m, device=b.device).to(torch.bool).expand(b.shape)
              for m, b in zip(trainable_mask, base)])
    params = TrainableParams(*(
        b.detach().clone().requires_grad_(masks is None or bool(m.any()))
        for b, m in zip(base, masks or base)))
    if optimizer is None:
        optimizer = functools.partial(torch.optim.Adam, lr=1e-2)
    opt_state = optimizer([p for p in params if p.requires_grad])

    def step(params: TrainableParams, opt_state, target, frame: int):
        opt_state.zero_grad(set_to_none=True)
        loss = render_loss(params, scene, target, cfg, frame, intersect_fn)
        loss.backward()
        with torch.no_grad():
            if masks is not None:
                for p, m in zip(params, masks):
                    if p.grad is not None:
                        p.grad.mul_(m.to(p.dtype))
            opt_state.step()
            if masks is not None:
                for p, b, m in zip(params, base, masks):
                    p.copy_(torch.where(m, p, b))
        return params, opt_state, loss.detach()

    return step, params, opt_state
