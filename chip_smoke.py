#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (tracy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card's name and power limit;
2. build: nvcc builds the two kernels of csrc/ for sm_90a;
3. kernel vs plain: K1 (intersect) and K2 (shade) against their plain
   PyTorch versions on the same CUDA tensors, then each one's time beside
   its plain version's at the 1080p wave shape;
4. main path: Renderer.step_many at 1920x1080, 4 progressive frames of
   1 spp, 5 bounces, on the grid64x28 scene (100,748 triangles); both
   kernels must have launched and neither plain version run;
5. physics: furnace.scn at 256x192 for 24 frames against the reference's
   own render (tests/goldens/ref/furnace.npz), linear block means.

Prints a JSON line of per-kernel results, then as its last line
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result. Imports nothing of jax.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0xABCDEF
WIDTH, HEIGHT, FRAMES = 1920, 1080, 4


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from tracy_tpu_torch import RenderConfig
    from tracy_tpu_torch.ops import build, compare
    from tracy_tpu_torch.ops import intersect as k1
    from tracy_tpu_torch.ops import shade as k2
    from tracy_tpu_torch.render.renderer import Renderer, init_state, pick_tile
    from tracy_tpu_torch.scene import load_scene, sphere_grid
    from tracy_tpu_torch.utils import parity

    dev = torch.device("cuda", 0)

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {name}, capability {torch.cuda.get_device_capability(0)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    # 2. build
    t0 = time.perf_counter()
    build.LIBRARY.get()
    secs = build.LIBRARY.build_seconds
    print(f"build: target {build.ARCH}, flags {' '.join(build.NVCC_FLAGS)}; "
          f"K1 intersect.cu {secs.get('intersect.cu', 0.0):.1f} s, "
          f"K2 shade.cu {secs.get('shade.cu', 0.0):.1f} s, "
          f"total with link and load {time.perf_counter() - t0:.1f} s"
          + ("" if secs else " (cached)"))

    # 3. kernel vs plain
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=1, max_bounces=5,
                       russian_roulette=True, tonemap="srgb", accel="packet",
                       use_pallas_shade=True, rng="fast", wave_compact_group=0)
    t0 = time.perf_counter()
    builder = sphere_grid(WIDTH, HEIGHT, nsph=64, steps=28)
    scene = builder.build(device=dev)
    r = Renderer(cfg)
    r.prepare(scene)
    tables = r.tables
    print(f"scene grid64x28: {scene.num_triangles} triangles, {tables.node_meta.shape[0]} "
          f"BVH nodes, depth {tables.max_depth}; host build {time.perf_counter() - t0:.1f} s")
    if scene.num_triangles != 100_748:
        raise RuntimeError(f"grid64x28 should hold 100,748 triangles, got {scene.num_triangles}")

    # Both kernels are held against their plain versions and timed at the
    # main path's wave shape: 1080 rows padded to the 32-row tile ->
    # 1088 x 1920 = 2,088,960 lanes.
    th, _ = pick_tile(HEIGHT, WIDTH)
    wave = (HEIGHT + (-HEIGHT) % th) * WIDTH
    o, d, a = compare.intersect_rays(scene, tables, wave, seed=1)
    c1 = compare.compare_intersect(o, d, a, tables)
    print(f"K1 vs plain, {c1['rays']} rays (half secondary): mask agreement "
          f"{c1['mask_agree']:.6f} (>= 0.9999), max |dt| {c1['max_abs_err']:.3g} "
          f"(<= 1e-5 t + 1e-6), normal max err {c1['normal_max_abs_err']:.3g}, "
          f"hit fraction {c1['hit_fraction']:.3f}")

    dscene = load_scene(os.path.join(REPO, "data", "scenes", "default.scn")).build(device=dev)
    mtab = k2.build_material_table(dscene.materials)
    lanes = compare.canned_lanes(mtab.shape[0], wave, seed=2, device=dev)
    c2 = {}
    for rr in (True, False):
        c2[rr] = compare.compare_shade(lanes, mtab, 3, 1, seed=SEED, russian_roulette=rr)
        print(f"K2 vs plain, {c2[rr]['lanes']} lanes, default.scn materials, RR {rr}: "
              f"decisions flipped {c2[rr]['flipped']:.6f} (<= 1e-4), max abs err "
              f"{c2[rr]['max_abs_err']:.3g} (rtol 1e-5, atol 1e-6)")

    t_k1 = compare.cuda_ms(lambda: k1.intersect(o, d, a, tables), 10)
    t_p1 = compare.cuda_ms(lambda: k1.intersect_plain(o, d, a, tables), 1)
    args = [lanes[k] for k in compare.SHADE_ARGS]
    kw = dict(seed=SEED, russian_roulette=True)
    t_k2 = compare.cuda_ms(lambda: k2.shade(*args, mtab, 3, 1, **kw), 20)
    t_p2 = compare.cuda_ms(lambda: k2.shade_plain(*args, mtab, 3, 1, **kw), 3)
    print(f"time at the 1080p wave ({wave} lanes; K1 on half camera, half secondary "
          f"rays): K1 {t_k1:.3f} ms vs plain {t_p1:.1f} ms; K2 {t_k2:.3f} ms vs "
          f"plain {t_p2:.3f} ms {card}")

    # 4. main path
    print("config: " + json.dumps({"width": cfg.width, "height": cfg.height, "spp": cfg.spp,
                                   "frames": FRAMES, "max_bounces": cfg.max_bounces,
                                   "russian_roulette": cfg.russian_roulette,
                                   "tonemap": cfg.tonemap, "accel": cfg.accel,
                                   "rng": cfg.rng, "wave_compact_group": 0,
                                   "bvh_leaf_size": cfg.bvh_leaf_size,
                                   "scene": "grid64x28"}))
    r.step_many(scene, init_state(cfg, dev), 1)  # warm-up frame
    r.reset(dev)
    state = init_state(cfg, dev)
    k1.COUNT.reset()
    k2.COUNT.reset()
    state, nrays = r.step_many(scene, state, FRAMES)
    launches = {"K1": (k1.COUNT.kernel, k1.COUNT.plain), "K2": (k2.COUNT.kernel, k2.COUNT.plain)}
    img = r.display(state)
    if img.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(state.accum.cpu().numpy()).all():
        raise RuntimeError(f"main path image: shape {img.shape} or non-finite values")
    for kname, (kern, plain) in launches.items():
        if kern < cfg.max_bounces * FRAMES or plain != 0:
            raise RuntimeError(f"{kname}: {kern} kernel launches, {plain} plain runs")
    print(f"main path: {scene.num_triangles} triangles, {FRAMES} frames, {nrays} rays in "
          f"{r.total_seconds:.4f} s = {r.mrays_per_sec:.2f} MRays/s {card}; launches "
          f"K1 {launches['K1'][0]}, K2 {launches['K2'][0]}, plain {launches['K1'][1]}"
          f"+{launches['K2'][1]}; image mean {float(state.accum.mean()):.4f}")

    # 5. physics: furnace against the reference's own render
    fb = load_scene(os.path.join(REPO, "tests", "goldens", "scn", "furnace.scn"))
    fcfg = RenderConfig(width=fb.width, height=fb.height, spp=1)
    fr = Renderer(fcfg)
    fst, _ = fr.step_many(fb.build(device=dev), init_state(fcfg, dev), 24)
    ours = np.clip(fr.display(fst) * 255.99, 0.0, 255.0)
    ours = parity.srgb_to_linear(ours / 255.99)[::-1]  # goldens are bottom row first
    ref = parity.load_golden(os.path.join(REPO, "tests", "goldens", "ref", "furnace.npz"))
    dmean, p95, dmax = parity.compare(ref, ours)
    print(f"furnace 256x192, 24 frames vs tests/goldens/ref/furnace.npz: mean diff "
          f"{dmean:.5f} (<= 0.01), block p95 {p95:.5f} (<= 0.02), block max {dmax:.5f} (<= 0.05)")
    if dmean > 0.01 or p95 > 0.02 or dmax > 0.05:
        raise RuntimeError("furnace parity failed")

    kernels = [
        {"name": "K1 intersect", "route": "cuda", "source": "tracy_tpu_torch/csrc/intersect.cu",
         "replaces": "tracy_tpu/ops/pallas_packet.py:519", "launches": launches["K1"][0],
         "max_abs_err": c1["max_abs_err"], "ms": t_k1, "plain_ms": t_p1},
        {"name": "K2 shade", "route": "cuda", "source": "tracy_tpu_torch/csrc/shade.cu",
         "replaces": "tracy_tpu/ops/pallas_shade.py:72", "launches": launches["K2"][0],
         "max_abs_err": max(c["max_abs_err"] for c in c2.values()), "ms": t_k2,
         "plain_ms": t_p2},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
