"""Renderer: progressive render steps over a whole image.

Port of tracy_tpu/render/renderer.py. One step is one progressive frame of
cfg.spp samples per pixel: jittered camera rays, the bounce loop,
accumulation. MRays/s counts one ray per live lane per bounce, the
reference's accounting (win_raytracer.cpp:521-553).

Each bounce runs an intersector, then on an untextured scene K2
(ops/shade.py), on a textured one K4 (ops/shade.py::shade_textured, which
fetches the texels itself), the intersector then also interpolating the
texture uv and, with normal maps, the tangent: the "two-stage" path. The
intersector follows cfg.accel as tracy_tpu's does (tracy_tpu/render/
renderer.py:468-482): 'packet' is K1 (ops/intersect.py) over the BVH
tables (4-wide, or 8-wide or binary with pallas_bvh_width=8 or 2), 'bvh'
K1 over the binary tables (tracy_tpu's 'bvh' walks a binary tree), 'none' the
brute-force intersector (render/integrator.py; XLA code in tracy_tpu, no
kernel). With use_pallas_bounce on an untextured scene and accel 'packet',
K5 (ops/bounce.py) runs the whole bounce instead: the "fused" path
(`Renderer.path` says which was bound). With wave_compact_group > 0 and
accel 'packet', K1 (or K5) runs inside accel/reorder.py's compaction, and
K4 on the routed-back lanes, as tracy_tpu binds them (tracy_tpu/render/
renderer.py:488-512, :619-689); with wave_compact_skip_first, bounce 0 runs
uncompacted. The image is folded into 32x32-pixel tiles, so that
neighbouring rays of a wave are neighbours on screen. On CUDA tensors the
stages launch their kernels; on CPU tensors, their plain versions.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tracy_tpu_torch.config import RenderConfig
from tracy_tpu_torch.accel.reorder import compact_bounce, compact_intersector
from tracy_tpu_torch.accel.tables import BVHTables, build_tables
from tracy_tpu_torch.core.camera import pixel_samples_rows
from tracy_tpu_torch.core.rng import RngSpec
from tracy_tpu_torch.ops.bounce import trace_bounce
from tracy_tpu_torch.ops.intersect import intersect
from tracy_tpu_torch.ops.shade import build_material_table, build_material_table_tex
from tracy_tpu_torch.render import film
from tracy_tpu_torch.render.integrator import (
    JITTER_BOUNCE,
    make_bruteforce_intersector,
    trace_paths,
)
from tracy_tpu_torch.render.material import scene_has_textures
from tracy_tpu_torch.scene.scene import SceneArrays


class RenderState(NamedTuple):
    """Progressive accumulation state."""

    accum: torch.Tensor  # [H, W, 3] linear radiance running average
    frame: int  # completed frames


def init_state(cfg: RenderConfig, device) -> RenderState:
    return RenderState(
        accum=torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device=device),
        frame=0,
    )


def pick_tile(num_rows: int, w: int) -> Tuple[int, int]:
    """Tile shape (th, tw) with th*tw = 1024 rays.

    32x32 (the most compact footprint) whenever its dead-row padding is at
    most 2% of the rows; otherwise the candidate that pads least, taller
    first on ties. (0, 0) when no tile width divides w (scanline order)."""
    best = (0, 0)
    best_pad = None
    for th, tw in ((32, 32), (16, 64), (8, 128)):
        if w % tw:
            continue
        pad = (-num_rows) % th
        if th == 32 and pad * 50 <= num_rows:
            return (32, 32)
        if best_pad is None or pad < best_pad:
            best, best_pad = (th, tw), pad
    return best


def sample_radiance_rows(scene: SceneArrays, cfg: RenderConfig, frame: int,
                         intersect_fn, mtab=None, **paths) -> Tuple[torch.Tensor, torch.Tensor]:
    """cfg.spp jittered samples of every pixel.

    Returns (mean radiance [H, W, 3], rays: a 0-d int64 tensor). RNG streams
    are keyed by the global pixel index and the global sample id. Row counts
    that are not a multiple of the tile height (1080 % 32 = 24) are padded
    with dead rows, which trace nothing and are not counted. paths:
    trace_paths' bounce_fn, first_intersect_fn and first_bounce_fn.
    """
    h, w = cfg.height, cfg.width
    dev = scene.device
    rng = RngSpec(cfg.rng, cfg.seed)
    tile_h, tile_w = pick_tile(h, w)
    rows_r = h + ((-h) % tile_h if tile_h else 0)
    rows = torch.arange(rows_r, dtype=torch.int32, device=dev)
    cols = torch.arange(w, dtype=torch.int32, device=dev)
    pixel_idx = rows[:, None] * w + cols[None, :]
    live = (rows < h)[:, None].expand(rows_r, w)

    def fold(x):  # [R, W, ...] -> [R*W, ...], tile-major when tiled
        extra = x.shape[2:]
        if tile_h:
            x = x.reshape((rows_r // tile_h, tile_h, w // tile_w, tile_w) + extra)
            x = x.transpose(1, 2)
        return x.reshape((rows_r * w,) + extra)

    def unfold(x):  # inverse of fold
        extra = x.shape[1:]
        if tile_h:
            x = x.reshape((rows_r // tile_h, w // tile_w, tile_h, tile_w) + extra)
            x = x.transpose(1, 2)
        return x.reshape((rows_r, w) + extra)

    acc = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(cfg.spp):
        sample_key = (frame * cfg.spp + s) & 0xFFFFFFFF
        ju = rng.uniform(pixel_idx, sample_key, JITTER_BOUNCE, 0)
        jv = rng.uniform(pixel_idx, sample_key, JITTER_BOUNCE, 1)
        ss, tt = pixel_samples_rows(w, h, rows, ju, jv)
        origin, direction = scene.camera.generate_rays(ss, tt)
        radiance, r = trace_paths(
            scene, fold(origin), fold(direction), fold(pixel_idx).contiguous(),
            sample_key, cfg, intersect_fn,
            active0=fold(live).contiguous() if rows_r > h else None, mtab=mtab, **paths)
        acc = acc + unfold(radiance)[:h]
        rays = rays + r
    return (acc if cfg.spp == 1 else acc / cfg.spp), rays


def render_step(scene: SceneArrays, state: RenderState, cfg: RenderConfig,
                intersect_fn, mtab=None, **paths) -> Tuple[RenderState, torch.Tensor]:
    """One progressive frame: sample, accumulate, bump the frame counter."""
    radiance, rays = sample_radiance_rows(scene, cfg, state.frame, intersect_fn, mtab,
                                          **paths)
    accum = film.accumulate(state.accum, radiance, state.frame) if cfg.accumulate else radiance
    return RenderState(accum=accum, frame=state.frame + 1), rays


class Renderer:
    """Holds a config and the per-scene acceleration data.

    Usage:
        r = Renderer(cfg)
        state = init_state(cfg, device)
        for _ in range(frames): state, rays = r.step(scene, state)
        img = r.display(state)     # tonemapped [H, W, 3] float
    """

    def __init__(self, cfg: RenderConfig):
        if cfg.accel == "tlas":
            raise NotImplementedError("accel='tlas': the two-level BVH is not ported yet "
                                      "(ROADMAP queue 1)")
        if cfg.aov != "beauty":
            raise NotImplementedError(f"aov={cfg.aov!r}: the port renders beauty only")
        RngSpec(cfg.rng, cfg.seed)  # refuses threefry (jax.random) with its reason
        self.cfg = cfg
        self.tables: Optional[BVHTables] = None
        self.path: Optional[str] = None  # "two-stage" or "fused", once prepared
        self._intersect = None
        self._paths = {}
        self._mtab = None
        self.total_rays = 0
        self.total_seconds = 0.0

    def prepare(self, scene: SceneArrays):
        """Build the BVH tables (host side) and the material table, and bind
        the bounce path, once per renderer; step and step_many call it."""
        if self._intersect is not None:
            return
        cfg = self.cfg
        packet = cfg.accel == "packet"
        if cfg.accel == "none":
            isect = make_bruteforce_intersector(scene)
        else:
            self.tables = build_tables(scene, leaf_size=cfg.bvh_leaf_size,
                                       max_depth=max(cfg.traversal_stack_depth - 4, 8),
                                       width=cfg.pallas_bvh_width if packet else 2)
            isect = functools.partial(intersect, tables=self.tables)
        textured = scene_has_textures(scene)
        self._mtab = (build_material_table_tex if textured
                      else build_material_table)(scene.materials)
        # Compaction wraps the packet intersector only (tracy_tpu's
        # renderer.py:492-494): 'bvh' and 'none' trace every lane.
        group = cfg.wave_compact_group if packet else 0
        peel = group > 0 and cfg.wave_compact_skip_first
        self._intersect = compact_intersector(isect, group) if group else isect
        self._paths = {"first_intersect_fn": isect} if peel else {}
        self.path = "two-stage"
        if cfg.use_pallas_bounce and packet and not textured:
            # The fused bounce is untextured only: a textured scene keeps the
            # two-stage path, as in tracy_tpu (renderer.py:635-640).
            bounce = functools.partial(trace_bounce, tables=self.tables, mtab=self._mtab,
                                       seed=cfg.seed, russian_roulette=cfg.russian_roulette,
                                       rng=cfg.rng)
            self._paths = {"bounce_fn": compact_bounce(bounce, group) if group else bounce}
            if peel:
                self._paths["first_bounce_fn"] = bounce
            self.path = "fused"

    def reset(self, device) -> RenderState:
        self.total_rays = 0
        self.total_seconds = 0.0
        return init_state(self.cfg, device)

    def step(self, scene: SceneArrays, state: RenderState):
        return self.step_many(scene, state, 1)

    def step_many(self, scene: SceneArrays, state: RenderState, num_steps: int):
        """num_steps progressive frames; waits for the device at the end."""
        self.prepare(scene)
        t0 = time.perf_counter()
        rays = torch.zeros((), dtype=torch.int64, device=scene.device)
        for _ in range(num_steps):
            state, r = render_step(scene, state, self.cfg, self._intersect, self._mtab,
                                   **self._paths)
            rays = rays + r
        if scene.device.type == "cuda":
            torch.cuda.synchronize(scene.device)
        rays = int(rays)
        self.total_seconds += time.perf_counter() - t0
        self.total_rays += rays
        return state, rays

    def display(self, state: RenderState) -> np.ndarray:
        return film.tonemap(state.accum, self.cfg).cpu().numpy()

    def display_u8(self, state: RenderState) -> np.ndarray:
        return film.to_u8(film.tonemap(state.accum, self.cfg)).cpu().numpy()

    @property
    def mrays_per_sec(self) -> float:
        t = self.total_seconds
        return (self.total_rays / 1e6) / t if t > 0 else 0.0
