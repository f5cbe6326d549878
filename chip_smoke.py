#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (tracy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card's name and power limit;
2. build: nvcc builds the three kernel sources of csrc/ for sm_90a, one
   process per source, all at once;
3. kernel vs plain: K1 (intersect), K2 (shade), K3 (texel fetch) and K4
   (textured shade) against their plain PyTorch versions on the same CUDA
   tensors at the main path's wave shape (2,088,960 lanes), K3 and K4 on
   both canned lanes and the real lanes of the textured scene; then each
   one's time beside its plain version's, its bound and, for K3, a
   `tex_data.index_select` of the same texels as a yardstick;
4. main path: Renderer.step_many at 1920x1080, 4 progressive frames of
   1 spp, 5 bounces, on grid64x28 (100,748 triangles: K1 + K2) and on
   grid64x28-tex, the same geometry with helmet-sized maps (K1 + K3 + K4);
   each path must launch its kernels and no plain version; then where the
   device time of one more such run goes (torch.profiler);
5. physics: furnace.scn (untextured) and spheres.scn (HDR equirect sky,
   textured path) at 256x192 for 24 frames against the reference's own
   renders (tests/goldens/ref/*.npz), linear block means.

Prints a JSON line of per-kernel results, then as its last line
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result. Imports nothing of jax.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0xABCDEF
WIDTH, HEIGHT, FRAMES = 1920, 1080, 4
MAP_SIZE = 2048  # helmet.scn's maps are 2048x2048
SKY_SIZE = (1024, 2048)  # rows, columns of the equirect sky


def textured_grid(width: int, height: int, map_size: int = MAP_SIZE,
                  sky_size=SKY_SIZE, seed: int = SEED):
    """grid64x28-tex: sphere_grid(64, 28) with textures made with numpy
    from `seed`, modelled on helmet.scn's five maps. Material 1 (grey)
    gets basecolor (sRGB), normal, roughness, metalness and emissive (sRGB)
    maps; material 3 (floor) a basecolor map; material 2 (metal) none; the
    sky is a float equirect with a bright sun. Returns the builder."""
    from tracy_tpu_torch.scene import sphere_grid
    from tracy_tpu_torch.scene.scene import (
        TEX_BASECOLOR, TEX_EMISSIVE, TEX_METALNESS, TEX_NORMAL, TEX_ROUGHNESS)

    b = sphere_grid(width, height, nsph=64, steps=28)
    b.name = "grid64x28-tex"
    rng = np.random.default_rng(seed)
    shape = (map_size, map_size)

    def rgba(*channels):
        ch = [np.broadcast_to(np.float32(c), shape) for c in channels]
        ch += [np.ones(shape, np.float32)] * (4 - len(ch))
        return np.stack(ch, axis=-1).astype(np.float32)

    def noise(lo, hi):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    grey, floor = 1, 3
    maps = {
        TEX_BASECOLOR: (rgba(noise(0.2, 0.9), noise(0.2, 0.9), noise(0.2, 0.9)), True),
        TEX_NORMAL: (rgba(noise(0.4, 0.6), noise(0.4, 0.6), 1.0), False),
        TEX_ROUGHNESS: (rgba(noise(0.1, 1.0)), False),
        TEX_METALNESS: (rgba(noise(0.0, 1.0)), False),
        TEX_EMISSIVE: (rgba(*([np.where(noise(0.0, 1.0) < 0.005, 1.0, 0.0)] * 3)), True),
    }
    for slot, (img, srgb) in maps.items():
        b.set_material_texture(grey, slot, b.add_texture(img, srgb=srgb))
    b.set_material_texture(floor, TEX_BASECOLOR, b.add_texture(
        rgba(noise(0.1, 0.6), noise(0.1, 0.6), noise(0.1, 0.6)), srgb=True))

    rows, cols = sky_size
    elev = 1.0 - (np.arange(rows, dtype=np.float32) + 0.5) / rows  # 1 at the top row
    sky = np.empty((rows, cols, 4), np.float32)
    for c, (lo, hi) in enumerate(((0.35, 0.3), (0.4, 0.5), (0.45, 0.9))):
        sky[..., c] = np.where(elev >= 0.5, lo + (hi - lo) * (2.0 * elev - 1.0), 0.2)[:, None]
    sky[..., 3] = 1.0
    jj, ii = np.ogrid[:rows, :cols]
    sun = (jj - rows * 0.2) ** 2 + (ii - cols * 0.3) ** 2 <= (rows / 80.0) ** 2
    sky[sun, :3] = 50.0
    b.set_sky_texture(b.add_texture(sky))
    return b


# The __global__ name of each kernel in csrc/, as the profiler's demangled
# kernel names give it after the return type and namespace.
KERNEL_NAMES = {"intersect_kernel": "K1", "shade_kernel": "K2",
                "texfetch_kernel": "K3", "shade_textured_kernel": "K4"}


def device_breakdown(run, counts) -> str:
    """Where the device time of run() goes: our kernels, the torch ops
    around them, and the device's idle share of the span from the first
    kernel's start to the last one's end, all from one torch.profiler
    window (the profiler adds its own launch overhead). Fails unless each
    kernel shows exactly the launches its wrapper counted."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for c in counts.values():
        c.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3

    ms, launches, glue = {}, {}, {}
    first, last = float("inf"), 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = e.time_range.elapsed_us() / 1e3
        first, last = min(first, e.time_range.start), max(last, e.time_range.end)
        base = re.split(r"[<(]", re.sub(r"^void |\(anonymous namespace\)::", "", e.name), 1)[0]
        k = KERNEL_NAMES.get(base)
        if k is None:  # label a torch kernel by its functor
            label = re.sub(r"^void at::native::(\w+::)*\w+<\d+, (at::native::)?", "", e.name)
            glue[label[:70]] = glue.get(label[:70], 0.0) + t
        else:
            ms[k] = ms.get(k, 0.0) + t
            launches[k] = launches.get(k, 0) + 1
    for k, c in counts.items():
        if launches.get(k, 0) != c.kernel:
            raise RuntimeError(f"profile shows {launches.get(k, 0)} launches of {k}, "
                               f"its wrapper counted {c.kernel}")
    busy = sum(ms.values()) + sum(glue.values())
    span = (last - first) / 1e3
    top = sorted(glue.items(), key=lambda kv: -kv[1])[:4]
    return (", ".join(f"{k} {ms[k]:.3f} ms ({launches[k]} launches)" for k in sorted(ms))
            + f", torch ops {sum(glue.values()):.3f} ms in {len(glue)} kinds (largest: "
            + "; ".join(f"{n} {t:.3f} ms" for n, t in top)
            + f"); busy {busy:.3f} ms of a {span:.3f} ms device span, idle "
            f"{max(0.0, 1.0 - busy / span):.1%}; host wall {wall_ms:.3f} ms, all under the profiler")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from tracy_tpu_torch import RenderConfig
    from tracy_tpu_torch.ops import build, compare
    from tracy_tpu_torch.ops import intersect as k1
    from tracy_tpu_torch.ops import shade as k2
    from tracy_tpu_torch.ops import texfetch as k3
    from tracy_tpu_torch.render.renderer import Renderer, init_state, pick_tile
    from tracy_tpu_torch.scene import load_scene, sphere_grid
    from tracy_tpu_torch.utils import parity

    dev = torch.device("cuda", 0)
    counts = {"K1": k1.COUNT, "K2": k2.COUNT, "K3": k3.COUNT, "K4": k2.COUNT_TEX}

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
    print(f"build: target {build.ARCH}, flags {' '.join(build.NVCC_FLAGS)}; nvcc in parallel: "
          + ", ".join(f"{src} {secs.get(src, 0.0):.1f} s" for src in build.SOURCES)
          + f"; total with link and load {time.perf_counter() - t0:.1f} s"
          + ("" if secs else " (cached)"))
    for src, log in build.LIBRARY.build_log.items():
        print(f"  ptxas {src}: registers per kernel "
              + ", ".join(re.findall(r"Used (\d+) registers", log))
              + "; bytes of spill stores " + ", ".join(re.findall(r"(\d+) bytes spill stores", log)))

    # 3. kernel vs plain
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=1, max_bounces=5,
                       russian_roulette=True, tonemap="srgb", accel="packet",
                       rng="fast", wave_compact_group=0)
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

    t0 = time.perf_counter()
    tbuilder = textured_grid(WIDTH, HEIGHT)
    tscene = tbuilder.build(device=dev)
    rt = Renderer(cfg)
    rt.prepare(tscene)
    ttables = rt.tables
    atlas_mb = tscene.tex_data.numel() * 4 / 1e6
    print(f"scene grid64x28-tex: {tscene.num_triangles} triangles, "
          f"{tscene.tex_table.shape[0]} textures, atlas {atlas_mb:.1f} MB on the card, "
          f"uv {ttables.vertex_uv is not None}, tangent {ttables.vertex_tangent is not None}; "
          f"host build {time.perf_counter() - t0:.1f} s")
    if tbuilder.fallbacks:
        raise RuntimeError(f"grid64x28-tex substituted files: {tbuilder.fallbacks}")
    if ttables.vertex_uv is None or ttables.vertex_tangent is None:
        raise RuntimeError("grid64x28-tex: K1 must interpolate uv and tangent")

    # Every kernel is held against its plain version and timed at the main
    # path's wave shape: 1080 rows padded to the 32-row tile -> 1088 x 1920 =
    # 2,088,960 lanes.
    th, _ = pick_tile(HEIGHT, WIDTH)
    wave = (HEIGHT + (-HEIGHT) % th) * WIDTH
    o, d, a = compare.intersect_rays(scene, tables, wave, seed=1)
    c1 = compare.compare_intersect(o, d, a, tables)
    print(f"K1 vs plain, grid64x28, {c1['rays']} rays (half secondary): mask agreement "
          f"{c1['mask_agree']:.6f} (>= 0.9999), max |dt| {c1['max_abs_err']:.3g} "
          f"(<= 1e-5 t + 1e-6), normal max err {c1['normal_max_abs_err']:.3g}, "
          f"hit fraction {c1['hit_fraction']:.3f}; {c1['inner_visits']} inner-node visits, "
          f"{c1['tri_tests']} triangle tests")
    to, td, ta = compare.intersect_rays(tscene, ttables, wave, seed=1)
    c1t = compare.compare_intersect(to, td, ta, ttables)
    print(f"K1 vs plain, grid64x28-tex (uv + tangent), {c1t['rays']} rays: mask agreement "
          f"{c1t['mask_agree']:.6f}, max |dt| {c1t['max_abs_err']:.3g}, uv max err "
          f"{c1t['tex_uv_max_abs_err']:.3g}, tangent max err {c1t['tangent_max_abs_err']:.3g}")

    dscene = load_scene(os.path.join(REPO, "data", "scenes", "default.scn")).build(device=dev)
    mtab = k2.build_material_table(dscene.materials)
    lanes = compare.canned_lanes(mtab.shape[0], wave, seed=2, device=dev)
    c2 = {}
    for rr in (True, False):
        c2[rr] = compare.compare_shade(lanes, mtab, 3, 1, seed=SEED, russian_roulette=rr)
        print(f"K2 vs plain, {c2[rr]['lanes']} lanes, default.scn materials, RR {rr}: "
              f"decisions flipped {c2[rr]['flipped']:.6f} (<= 1e-4), max abs err "
              f"{c2[rr]['max_abs_err']:.3g} (rtol 1e-5, atol 1e-6)")

    # K3 and K4 on grid64x28-tex: canned lanes (random materials, uv with
    # repeats, 30% misses), and the real lanes of the K1 wave above.
    mtab_t = k2.build_material_table_tex(tscene.materials)
    canned = compare.textured_lanes(mtab_t.shape[0], wave, seed=3, device=dev)
    hit = k1.intersect(to, td, ta, ttables)
    real = dict(canned, origin=to, direction=td, alive=ta, hit_mask=hit.hit.mask,
                t=hit.hit.t, normal=hit.normal, mat_id=hit.material, tex_uv=hit.tex_uv,
                tangent=hit.tangent)
    c3, c4 = {}, {}
    for kind, ln in (("canned", canned), ("real", real)):
        c3[kind] = compare.compare_texfetch(ln, tscene)
        print(f"K3 vs plain, {kind} lanes, {c3[kind]['lanes']}: hit lanes differing "
              f"{c3[kind]['hit_lanes_differ']} of {c3[kind]['hit_lanes']} (must be 0), sky "
              f"lanes differing {c3[kind]['sky_lanes_differ']} of {c3[kind]['sky_lanes']} "
              f"(<= 1e-4 of lanes), {c3[kind]['texels_fetched']} texels fetched, "
              f"{c3[kind]['texels_distinct']} distinct")
        for rr in (True, False):
            c = compare.compare_shade_textured(ln, c3[kind]["texels"], mtab_t, 3, 1,
                                               seed=SEED, russian_roulette=rr)
            c4[(kind, rr)] = c
            print(f"K4 vs plain, {kind} lanes, RR {rr}: decisions flipped "
                  f"{c['flipped']:.6f} (<= 1e-4), max abs err {c['max_abs_err']:.3g} "
                  f"(rtol 1e-5, atol 1e-6)")

    t_k1 = compare.cuda_ms(lambda: k1.intersect(o, d, a, tables), 10)
    t_p1 = compare.cuda_ms(lambda: k1.intersect_plain(o, d, a, tables), 1)
    t_k1t = compare.cuda_ms(lambda: k1.intersect(to, td, ta, ttables), 10)
    args = [lanes[k] for k in compare.SHADE_ARGS]
    kw = dict(seed=SEED, russian_roulette=True)
    t_k2 = compare.cuda_ms(lambda: k2.shade(*args, mtab, 3, 1, **kw), 20)
    t_p2 = compare.cuda_ms(lambda: k2.shade_plain(*args, mtab, 3, 1, **kw), 3)
    fargs = [real[k] for k in compare.TEXFETCH_ARGS]
    tex = (tscene.tex_data, tscene.tex_table, tscene.materials.tex_index)
    t_k3 = compare.cuda_ms(lambda: k3.fetch_texels(*fargs, *tex), 20)
    t_p3 = compare.cuda_ms(lambda: k3.fetch_texels_plain(*fargs, *tex), 3)
    flat = c3["real"]["addresses"]
    t_l3 = compare.cuda_ms(lambda: tscene.tex_data.index_select(0, flat), 20)
    sargs = [real[k] for k in compare.SHADE_TEX_ARGS]
    texels = c3["real"]["texels"]
    t_k4 = compare.cuda_ms(lambda: k2.shade_textured(*sargs, texels, mtab_t, 3, 1, **kw), 20)
    t_p4 = compare.cuda_ms(lambda: k2.shade_textured_plain(*sargs, texels, mtab_t, 3, 1, **kw), 3)
    b3, b4 = c3["real"], c4[("real", True)]
    print(f"time at the 1080p wave ({wave} lanes; K1 on half camera, half secondary rays; "
          f"K3/K4 on the real lanes of grid64x28-tex) {card}:")
    print(f"  K1 {t_k1:.3f} ms vs plain {t_p1:.1f} ms, bound {c1['bound_ms']:.4f} ms "
          f"({c1['bound_by']}: {c1['bytes']:.4g} B, {c1['ops']:.4g} ops); "
          f"K1 uv+tangent on grid64x28-tex {t_k1t:.3f} ms, bound {c1t['bound_ms']:.4f} ms")
    print(f"  K2 {t_k2:.3f} ms vs plain {t_p2:.3f} ms, bound {c2[True]['bound_ms']:.4f} ms "
          f"({c2[True]['bound_by']}: {c2[True]['bytes']:.4g} B)")
    print(f"  K3 {t_k3:.3f} ms vs plain {t_p3:.3f} ms, index_select of the same "
          f"{flat.numel()} texels {t_l3:.3f} ms, bound {b3['bound_ms']:.4f} ms "
          f"({b3['bound_by']}: {b3['bytes']:.4g} B, {b3['ops']:.4g} ops)")
    print(f"  K4 {t_k4:.3f} ms vs plain {t_p4:.3f} ms, bound {b4['bound_ms']:.4f} ms "
          f"({b4['bound_by']}: {b4['bytes']:.4g} B)")

    # 4. main paths
    print("config: " + json.dumps({"width": cfg.width, "height": cfg.height, "spp": cfg.spp,
                                   "frames": FRAMES, "max_bounces": cfg.max_bounces,
                                   "russian_roulette": cfg.russian_roulette,
                                   "tonemap": cfg.tonemap, "accel": cfg.accel,
                                   "rng": cfg.rng, "wave_compact_group": 0,
                                   "bvh_leaf_size": cfg.bvh_leaf_size,
                                   "scenes": ["grid64x28", "grid64x28-tex"]}))
    launches = {}
    for sname, sc, rend, need in (("grid64x28", scene, r, ("K1", "K2")),
                                  ("grid64x28-tex", tscene, rt, ("K1", "K3", "K4"))):
        rend.step_many(sc, init_state(cfg, dev), 1)  # warm-up frame
        rend.reset(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for c in counts.values():
            c.reset()
        state, nrays = rend.step_many(sc, init_state(cfg, dev), FRAMES)
        got = {k: (c.kernel, c.plain) for k, c in counts.items()}
        launches[sname] = {k: kern for k, (kern, _) in got.items()}
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        img = rend.display(state)
        if img.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(state.accum.cpu().numpy()).all():
            raise RuntimeError(f"{sname} image: shape {img.shape} or non-finite values")
        for kname, (kern, plain) in got.items():
            want = cfg.max_bounces * FRAMES if kname in need else 0
            if (kern < want if want else kern != 0) or plain != 0:
                raise RuntimeError(f"{sname}: {kname} {kern} kernel launches, {plain} plain runs")
        print(f"main path {sname}: {sc.num_triangles} triangles, {FRAMES} frames, {nrays} rays "
              f"in {rend.total_seconds:.4f} s = {rend.mrays_per_sec:.2f} MRays/s {card}; "
              f"launches " + ", ".join(f"{k} {v[0]}" for k, v in got.items())
              + f", plain {sum(v[1] for v in got.values())}; peak device memory "
              f"{peak:.2f} GB; image mean {float(state.accum.mean()):.4f}")
        print(f"  device time of {FRAMES} more frames {card}: " + device_breakdown(
            lambda: rend.step_many(sc, init_state(cfg, dev), FRAMES), counts))

    # 5. physics against the reference's own renders
    for gname in ("furnace", "spheres"):
        gb = load_scene(os.path.join(REPO, "tests", "goldens", "scn", f"{gname}.scn"))
        if gb.fallbacks:
            raise RuntimeError(f"{gname}.scn substituted files: {gb.fallbacks}")
        gcfg = RenderConfig(width=gb.width, height=gb.height, spp=1)
        gr = Renderer(gcfg)
        for c in counts.values():
            c.reset()
        gst, _ = gr.step_many(gb.build(device=dev), init_state(gcfg, dev), 24)
        ours = np.clip(gr.display(gst) * 255.99, 0.0, 255.0)
        ours = parity.srgb_to_linear(ours / 255.99)[::-1]  # goldens are bottom row first
        ref = parity.load_golden(os.path.join(REPO, "tests", "goldens", "ref", f"{gname}.npz"))
        dmean, p95, dmax = parity.compare(ref, ours)
        print(f"{gname} {gb.width}x{gb.height}, 24 frames vs tests/goldens/ref/{gname}.npz: "
              f"mean diff {dmean:.5f} (<= 0.01), block p95 {p95:.5f} (<= 0.02), block max "
              f"{dmax:.5f} (<= 0.05); launches "
              + ", ".join(f"{k} {c.kernel}" for k, c in counts.items()))
        if dmean > 0.01 or p95 > 0.02 or dmax > 0.05:
            raise RuntimeError(f"{gname} parity failed")
        if any(c.plain for c in counts.values()):
            raise RuntimeError(f"{gname}: a plain version ran on the card")

    def entry(kname, label, source, replaces, err, ms, plain_ms, bound, library_ms):
        return {"name": f"{kname} {label}", "route": "cuda",
                "source": f"tracy_tpu_torch/csrc/{source}", "replaces": replaces,
                "launches": sum(p[kname] for p in launches.values()),
                "launches_by_path": {p: v[kname] for p, v in launches.items()},
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                "library_ms": library_ms}

    kernels = [
        entry("K1", "intersect", "intersect.cu", "tracy_tpu/ops/pallas_packet.py:519",
              max(c1["max_abs_err"], c1t["max_abs_err"]), t_k1, t_p1, c1, None),
        entry("K2", "shade", "shade.cu", "tracy_tpu/ops/pallas_shade.py:72",
              max(c["max_abs_err"] for c in c2.values()), t_k2, t_p2, c2[True], None),
        entry("K3", "texfetch", "texfetch.cu", "tracy_tpu/ops/pallas_texfetch.py:231",
              max(c["max_abs_err"] for c in c3.values()), t_k3, t_p3, b3, t_l3),
        entry("K4", "shade_textured", "shade.cu", "tracy_tpu/ops/pallas_shade.py:355",
              max(c["max_abs_err"] for c in c4.values()), t_k4, t_p4, b4, None),
    ]
    kernels[0]["textured_ms"] = t_k1t
    kernels[0]["textured_bound_ms"] = c1t["bound_ms"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
