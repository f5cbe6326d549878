#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (tracy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card's name and power limit;
2. build: nvcc builds the five kernel sources of csrc/ for sm_90a, one
   process per source, all at once;
3. kernel vs plain: K1 (intersect), K2 (shade, in place), K3 (texel
   fetch), K4 (texel fetch + textured shade, in place) and K5 (fused
   bounce) against their plain PyTorch versions on the same CUDA tensors
   at the main path's wave shape (2,088,960 lanes), K1 and K5 at each BVH
   width (4, the default, 8 and 2), K2 (bit for bit, dead lanes untouched,
   miss lanes changing only radiance and alive) at each counter hash
   ('fast', 'xorshift', 'lcg') with Russian roulette on and off, K4 and K5
   at each hash, K3 and K4 on both canned lanes and the real lanes of the
   textured scene, K5 on the real lanes of grid64x28 and also against K1
   then K2 on a copy of the same lanes (all five outputs equal); then each
   one's time beside its plain version's, its bound and, for K3, a
   `tex_data.index_select` of the same texels as a yardstick; K1 and K5
   timed at the three widths in turns, K2 on the canned wave and on the
   real lanes of each bounce of a grid64x28 frame, K4 also on the same
   lanes without texel gathers and with every lane dead;
4. main paths: Renderer.step_many at 1920x1080, 4 progressive frames of
   1 spp, 5 bounces, on the 4-wide BVH (pallas_bvh_width's default), on
   grid64x28 (100,748 triangles) compacted as bench.py's main path is
   (pick_compact_group: group 262,144, bounce 0 uncompacted; K1 + K2),
   uncompacted, and fused (K5, compacted), and on grid64x28-tex, the same
   geometry with helmet-sized maps (K1 + K4; K3 is not launched there),
   compacted and uncompacted; grid64x28 compacted on the 8-wide BVH, and
   compacted and uncompacted on the binary BVH, for the A/B of the widths;
   each path must launch exactly its kernels and no plain version, and
   each path's accumulator must equal the other paths' of its scene and
   width; each path is timed 5 times, in turn with the others; then where
   the device time of one more such run goes (torch.profiler), with each
   kernel's time per bounce of frame 0, and the live-lane fraction of each
   bounce of one frame with the compaction round trip's time at that wave;
5. physics: furnace.scn (untextured; also on the fused, compacted path,
   with accel 'none' and rng 'lcg', and on the 8-wide BVH) and spheres.scn
   (HDR equirect sky, textured path; also with accel 'bvh' and rng
   'xorshift') at 256x192 for 24 frames against the reference's own
   renders (tests/goldens/ref/*.npz), linear block means;
6. K6: each variant of the leaf-visit microbenchmark against its plain
   version, and its nanoseconds per iteration;
7. AOVs: each of the six first-hit AOVs at 1920x1080 on grid64x28
   (compacted config) and grid64x28-tex, 4 frames timed 5 times: K1 once
   a frame, K3 once a frame on the textured scene, nothing else; frame 0
   equal to the same AOV through the plain versions on the card, bit for
   bit; MRays/s at num_rows * W rays a frame;
8. bands: the compacted 1080p beauty frame as 4 bands of 270 rows equals
   the full frame bit for bit; two 1-spp halves of an spp=2 frame average
   to it within 1e-6;
9. gradients: furnace.scn at 64x48 with K1 in the forward: the albedo
   gradient and the depth AOV's vertex gradient (GeometryDiffIntersector)
   against central differences and against the port's CPU gradient;
10. training: tools/tpu_grad_bench.py's configuration (640x480, 1 spp, 5
   bounces, RR on, accel packet, pick_compact_group) on grid64x28: 20
   Adam steps (RR off) move the grey spheres' halved albedo toward the
   truth and lower the loss;
   the "materials" and "geometry" steps timed (median of 5), with primary
   MRays/s and peak memory, then where one more step's device time goes
   (torch.profiler); K1 5 launches a step (zero-gradient wrapper,
   compacted, bounce 0 peeled), the differentiable bounce 5 times, no
   other kernel;
11. one "materials + texture" step on grid64x28-tex at 640x480 with the
   436 MB atlas trainable: time, peak memory, a finite texel gradient,
   nonzero on the grey spheres' maps.

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
REPEATS = 5  # timed runs of each main path
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
                "texfetch_kernel": "K3", "shade_textured_kernel": "K4",
                "bounce_kernel": "K5", "micro_kernel": "K6"}
# The torch kernels of wave compaction's routing (accel/reorder.py): the
# alive mask's cumsum, the inverse permutation's index_copy_, and the
# index_select gathers down and back.
ROUTING = re.compile(r"index_copy|indexSelect|index_select|scatter_gather|scan",
                     re.IGNORECASE)


def device_breakdown(run, counts):
    """Where the device time of run() goes: our kernels, the torch ops
    around them, and the device's idle share of the span from the first
    kernel's start to the last one's end, all from one torch.profiler
    window (the profiler adds its own launch overhead). Fails unless each
    kernel shows exactly the launches its wrapper counted. Returns the
    summary line and each of our kernels' launch times (ms) in launch
    order."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for c in counts.values():
        c.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3

    ms, launches, glue, seq = {}, {}, {}, {}
    routing = 0.0
    first, last = float("inf"), 0.0
    for e in sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        t = e.time_range.elapsed_us() / 1e3
        first, last = min(first, e.time_range.start), max(last, e.time_range.end)
        base = re.split(r"[<(]", re.sub(r"^void |\(anonymous namespace\)::", "", e.name), 1)[0]
        k = KERNEL_NAMES.get(base)
        if k is None:  # label a torch kernel by its functor
            if ROUTING.search(e.name):
                routing += t
            label = re.sub(r"^void at::native::(\w+::)*\w+<\d+, (at::native::)?", "", e.name)
            glue[label[:70]] = glue.get(label[:70], 0.0) + t
        else:
            ms[k] = ms.get(k, 0.0) + t
            launches[k] = launches.get(k, 0) + 1
            seq.setdefault(k, []).append(t)
    for k, c in counts.items():
        if launches.get(k, 0) != c.kernel:
            raise RuntimeError(f"profile shows {launches.get(k, 0)} launches of {k}, "
                               f"its wrapper counted {c.kernel}")
    busy = sum(ms.values()) + sum(glue.values())
    span = (last - first) / 1e3
    top = sorted(glue.items(), key=lambda kv: -kv[1])[:4]
    return (", ".join(f"{k} {ms[k]:.3f} ms ({launches[k]} launches)" for k in sorted(ms))
            + f", torch ops {sum(glue.values()):.3f} ms in {len(glue)} kinds (of which "
            f"compaction routing {routing:.3f} ms; largest: "
            + "; ".join(f"{n} {t:.3f} ms" for n, t in top)
            + f"); busy {busy:.3f} ms of a {span:.3f} ms device span, idle "
            f"{max(0.0, 1.0 - busy / span):.1%}; host wall {wall_ms:.3f} ms, all under the "
            "profiler"), seq


def ptxas_summary(log: str) -> str:
    """Registers, stack frame and spill stores of each kernel in nvcc's
    -Xptxas -v output, by __global__ name and template arguments."""
    out = []
    for fn, stack, spill, regs in re.findall(
            r"Function properties for (\S+)\s+(\d+) bytes stack frame, (\d+) bytes "
            r"spill stores.*?Used (\d+) registers", log, re.S):
        base = next((k for k in KERNEL_NAMES if k in fn), fn)
        tmpl = re.search(re.escape(base) + r"I(\w+?)EEv", fn)
        label = base + (f"<{tmpl.group(1)}>" if tmpl else "")
        out.append(f"{label} {regs} registers, {stack} B stack, {spill} B spilled")
    return "; ".join(out)


def live_lanes(scene, cfg, tables, frame: int = 0):
    """Per bounce of one frame (uncompacted, K1 + K2): the live lanes, the
    32-lane warps that hold a live lane, and the warps that would hold one
    after compaction with cfg.wave_compact_group; and the rays of bounce 1,
    to time the compaction round trip on."""
    from tracy_tpu_torch.ops import intersect as k1
    from tracy_tpu_torch.render.renderer import sample_radiance_rows

    group = cfg.wave_compact_group
    seen = []

    def record(o, d, a):
        # Copies: the shade stage updates these tensors in place.
        seen.append((o.clone(), d.clone(), a.clone()))
        return k1.intersect(o, d, a, tables)

    sample_radiance_rows(scene, cfg.replace(wave_compact_group=0), frame, record)
    rows = []
    for _, _, a in seen:
        n = a.numel()
        npad = -(-n // group) * group
        per_block = torch.nn.functional.pad(a.int(), (0, npad - n)).view(-1, group).sum(1)
        rows.append({"live": int(a.sum()), "lanes": n,
                     "warps_live": int(a.view(-1, 32).any(1).sum()), "warps": n // 32,
                     "warps_live_compacted": int(((per_block + 31) // 32).sum())})
    return rows, seen


AOVS = ("basecolor", "normals", "metalness", "roughness", "emissive", "depth")
TRAIN_W, TRAIN_H = 640, 480  # tools/tpu_grad_bench.py's training frame


def reset(counts):
    for c in counts.values():
        c.reset()


def check_training(label, counts, steps, bounces, textured):
    """The counters after `steps` training steps since they were reset:
    K1 `bounces` launches a step and the differentiable bounce `bounces`
    calls a step; no other kernel, and no plain version but K3's on a
    textured scene, where each differentiable bounce gathers its texels
    with K3's plain version (K3 has no backward). Returns the kernel
    launches."""
    from tracy_tpu_torch.ops import shade as k2

    got = {k: c.kernel for k, c in counts.items()}
    plain = {k: c.plain for k, c in counts.items()}
    want = {k: 0 for k in counts}
    want_plain = dict(want)
    want["K1"] = steps * bounces
    if textured:
        want_plain["K3"] = steps * bounces
    if got != want or plain != want_plain or k2.COUNT_DIFF.plain != steps * bounces:
        raise RuntimeError(f"{label}: launches {got} (want {want}), plain {plain} (want "
                           f"{want_plain}), differentiable bounce {k2.COUNT_DIFF.plain} "
                           f"(want {steps * bounces})")
    return got


def aov_phase(named_scenes, ccfg, counts, dev, card):
    """Every AOV of each scene at ccfg (1080p, compacted: the AOV runs
    bounce 0, uncompacted): 1 warm-up frame, then REPEATS timed runs of
    FRAMES frames; each must launch K1 once a frame, K3 once a frame on a
    textured scene, nothing else, and no plain version. Frame 0's image
    must equal, bit for bit, the same AOV through the plain versions on the
    card (intersect_plain, fetch_texels_plain). Returns {path: launches}."""
    from tracy_tpu_torch.ops import intersect as k1
    from tracy_tpu_torch.ops import texfetch as k3
    from tracy_tpu_torch.render.material import scene_has_textures
    from tracy_tpu_torch.render.renderer import Renderer, init_state, sample_radiance_rows

    launches = {}
    for sname, sc in named_scenes:
        textured = scene_has_textures(sc)
        for aov in AOVS:
            acfg = ccfg.replace(aov=aov, tonemap="none")
            rend = Renderer(acfg)
            first, _ = rend.step_many(sc, init_state(acfg, dev), 1)
            if rend.path != "aov":
                raise RuntimeError(f"AOV {aov} on {sname}: the renderer bound {rend.path}")
            ref, ref_rays = sample_radiance_rows(
                sc, acfg, 0, lambda o, d, a: k1.intersect_plain(o, d, a, rend.tables),
                fetch_fn=k3.fetch_texels_plain)
            if not torch.equal(first.accum, ref) or int(ref_rays) != WIDTH * HEIGHT:
                raise RuntimeError(f"AOV {aov} on {sname}: the kernels' frame differs from the "
                                   f"plain versions' by up to "
                                   f"{float((first.accum - ref).abs().max()):.3g}")
            rates = []
            for rep in range(REPEATS):
                rend.reset(dev)
                reset(counts)
                st, nrays = rend.step_many(sc, init_state(acfg, dev), FRAMES)
                rates.append(rend.mrays_per_sec)
                want = {k: 0 for k in counts}
                want["K1"] = FRAMES
                want["K3"] = FRAMES if textured else 0
                got = {k: c.kernel for k, c in counts.items()}
                if got != want or any(c.plain for c in counts.values()):
                    raise RuntimeError(f"AOV {aov} on {sname}: launches {got}, want {want}, "
                                       f"plain {[c.plain for c in counts.values()]}")
                if nrays != FRAMES * WIDTH * HEIGHT or not torch.isfinite(st.accum).all():
                    raise RuntimeError(f"AOV {aov} on {sname}: {nrays} rays or non-finite")
            launches[f"aov {aov} {sname}"] = got
            r_ = sorted(rates)
            miss = float((ref[..., 0] == 0).float().mean()) if aov == "depth" else None
            print(f"AOV {aov} {sname} 1920x1080 ({FRAMES} frames, {WIDTH * HEIGHT} rays a "
                  f"frame) {card}: MRays/s median {r_[len(r_) // 2]:.2f}, min {r_[0]:.2f}, "
                  f"max {r_[-1]:.2f} over {REPEATS} runs; launches a run "
                  + ", ".join(f"{k} {v}" for k, v in got.items() if v)
                  + f"; frame 0 equal to the plain versions' bit for bit; image mean "
                  f"{float(first.accum.mean()):.4f}"
                  + (f", miss fraction {miss:.4f}" if miss is not None else ""))
    return launches


def band_phase(scene, rend, cfg):
    """The compacted 1080p beauty frame as 4 bands of 270 rows equals the
    full frame bit for bit; two spp_count=1 halves of an spp=2 frame
    average to the full frame within 1e-6."""
    from tracy_tpu_torch.render.renderer import pick_tile, sample_radiance_rows

    paths = dict(shade_fn=rend._shade, **rend._paths)
    rows = HEIGHT // 4
    full, rays = sample_radiance_rows(scene, cfg, 0, rend._intersect, **paths)
    bands = [sample_radiance_rows(scene, cfg, 0, rend._intersect, row_offset=o, num_rows=rows,
                                  **paths) for o in range(0, HEIGHT, rows)]
    same = torch.equal(torch.cat([b for b, _ in bands]), full)
    band_rays = sum(int(r) for _, r in bands)
    cfg2 = cfg.replace(spp=2)
    full2, _ = sample_radiance_rows(scene, cfg2, 0, rend._intersect, **paths)
    halves = [sample_radiance_rows(scene, cfg2, 0, rend._intersect, spp_offset=s, spp_count=1,
                                   total_spp=2, **paths)[0] for s in (0, 1)]
    err = float(((halves[0] + halves[1]) / 2 - full2).abs().max())
    print(f"bands: 4 x {rows} rows (tile {pick_tile(rows, WIDTH)}, full frame "
          f"{pick_tile(HEIGHT, WIDTH)}) equal to the compacted 1080p frame bit for bit: {same}; "
          f"rays {band_rays} vs {int(rays)}; two 1-spp halves of an spp=2 frame vs the full "
          f"frame: max |difference| {err:.3g} (<= 1e-6)")
    if not same or band_rays != int(rays) or err > 1e-6:
        raise RuntimeError("bands or sample halves differ from the full frame")


def gradient_phase(dev, card):
    """furnace.scn at 64x48, accel 'packet' with K1 in the forward: the
    albedo gradient and the depth AOV's vertex gradient (through
    GeometryDiffIntersector) against central differences (h 1e-3, rtol
    2e-2), and both against the port's CPU gradient on the same inputs
    (relative 1e-4 of the largest entry). Returns {path: launches}."""
    from tracy_tpu_torch import RenderConfig
    from tracy_tpu_torch.diff import extract_params, make_training_intersector, render_loss
    from tracy_tpu_torch.ops import intersect as k1
    from tracy_tpu_torch.scene import load_scene

    gb = load_scene(os.path.join(REPO, "tests", "goldens", "scn", "furnace.scn"))
    gb.width, gb.height = 64, 48
    out, launches = {}, {}
    for kind, kw, geom, leaf, axis in (
            ("albedo", dict(spp=2, max_bounces=3, russian_roulette=False), False, "albedo", None),
            ("vertex (depth AOV)", dict(aov="depth"), True, "vertex_pos", 1)):
        cfg = RenderConfig(width=64, height=48, tonemap="none", accel="packet", **kw)
        grads = {}
        for where in ("cpu", dev):
            sc = gb.build(device=where)
            isect = make_training_intersector(sc, cfg, needs_geometry_grads=geom)
            params = extract_params(sc)
            target = torch.full((48, 64, 3), 0.5 if leaf == "albedo" else 0.0, device=sc.device)

            def f(x):
                return render_loss(params._replace(**{leaf: x}), sc, target, cfg, 0, isect)

            x = getattr(params, leaf).clone().requires_grad_(True)
            k1.COUNT.reset()
            f(x).backward()
            if where == dev:
                launches[f"gradients {kind}"] = {"K1": k1.COUNT.kernel}
                if k1.COUNT.kernel == 0 or k1.COUNT.plain:
                    raise RuntimeError(f"gradient {kind}: K1 {k1.COUNT.kernel}, plain "
                                       f"{k1.COUNT.plain} on the card")
            grads[str(where)] = x.grad.cpu()
            if where == dev:
                h = 1e-3
                e = torch.zeros_like(x)
                if axis is None:
                    e[1, 0] = 1.0
                    g = float(x.grad[1, 0])
                else:
                    e[:, axis] = 1.0
                    g = float(x.grad[:, axis].sum())
                base = getattr(params, leaf)
                with torch.no_grad():
                    fd = float((f(base + h * e) - f(base - h * e)) / (2 * h))
        cpu, gpu = grads["cpu"], grads[str(dev)]
        rel = float((gpu - cpu).abs().max() / cpu.abs().max())
        print(f"gradient {kind}, furnace.scn 64x48, K1 forward {card}: autograd {g:.6g}, "
              f"central difference {fd:.6g} (rtol 2e-2), vs the CPU gradient: max |difference| "
              f"{rel:.3g} of the largest entry (<= 1e-4)")
        if not (abs(g - fd) <= 2e-2 * abs(fd)) or g == 0.0 or not (rel <= 1e-4):
            raise RuntimeError(f"gradient {kind} failed")
        out[kind] = (g, fd, rel)
    return launches


def training_phase(grid, counts, dev, card):
    """tools/tpu_grad_bench.py's training configuration on grid64x28 at
    640x480 (1 spp, 5 bounces, RR on, tonemap none, accel packet, BVH
    width 4, pick_compact_group(640*480)): 20 Adam steps (lr 1e-2) from the
    grey spheres' albedo halved, albedo only trained, must lower the loss
    and move that albedo toward the truth; then the "materials" and the
    "geometry" steps (every leaf trained) timed, 1 warm-up and the median
    of 5. Each step launches K1 5 times and runs the differentiable bounce 5
    times, with no other kernel and no plain version; the counters are
    reset once before each loop of steps and checked after every step.
    Returns {path: launches} (the counters' sums) and the timings.

    The 20 steps run with Russian roulette off, as tracy_tpu's own
    recovery test does (tests/test_gradients.py:139): with it on, a
    survivor's throughput is divided by the detached p = max(throughput),
    which brings a grey throughput back to 1 whatever the albedo's level,
    so the frame's values do not depend on a grey albedo and its gradient
    is 0 (only the lanes' fates would change, which nothing
    differentiates)."""
    import dataclasses

    from tracy_tpu_torch import RenderConfig
    from tracy_tpu_torch.accel.reorder import pick_compact_group
    from tracy_tpu_torch.diff import (
        TrainableParams, extract_params, make_train_step, make_training_intersector)
    from tracy_tpu_torch.ops import shade as k2
    from tracy_tpu_torch.render.renderer import sample_radiance

    grid.width, grid.height = TRAIN_W, TRAIN_H
    scene = grid.build(device=dev)
    cfg = RenderConfig(width=TRAIN_W, height=TRAIN_H, spp=1, max_bounces=5, tonemap="none",
                       accel="packet", russian_roulette=True, pallas_bvh_width=4,
                       wave_compact_group=pick_compact_group(TRAIN_W * TRAIN_H))
    fwd = make_training_intersector(scene, cfg, needs_geometry_grads=False)
    fit = cfg.replace(russian_roulette=False)
    with torch.no_grad():
        target, _ = sample_radiance(scene, cfg, 0, fwd, first_intersect_fn=fwd.first)
        fit_target, _ = sample_radiance(scene, fit, 0, fwd, first_intersect_fn=fwd.first)
    grey = 1  # default_scene's grey sphere material, also every third grid sphere's
    truth = scene.materials.albedo[grey].clone()
    start = scene.materials.albedo.clone()
    start[grey] *= 0.5
    half = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials,
                                                                    albedo=start))
    mask = TrainableParams(*(False,) * 8)._replace(albedo=True)
    step, params, opt = make_train_step(half, fit, intersect_fn=fwd, trainable_mask=mask)

    losses = []
    reset(counts)
    k2.COUNT_DIFF.reset()
    for i in range(20):
        params, opt, loss = step(params, opt, fit_target, 0)
        losses.append(float(loss))
        got = check_training(f"training step {i}", counts, i + 1, cfg.max_bounces, False)
    launches = {"training albedo (20 steps)": got}
    moved = float((params.albedo[grey].detach() - truth).abs().max())
    print(f"training grid64x28 {TRAIN_W}x{TRAIN_H} (RR off, group {cfg.wave_compact_group}, K1 5 "
          f"launches and the differentiable bounce 5 times a step, checked each step): loss "
          f"{losses[0]:.6g} -> {losses[-1]:.6g} over 20 Adam steps; grey albedo "
          f"{start[grey].tolist()} -> {params.albedo[grey].detach().tolist()} (truth "
          f"{truth.tolist()}, max |error| {float((start[grey] - truth).abs().max()):.4f} -> "
          f"{moved:.4f})")
    if not (losses[-1] < losses[0]) or not moved < float((start[grey] - truth).abs().max()):
        raise RuntimeError("training did not lower the loss and move the albedo toward the truth")

    timings = {}
    for label, geom in (("materials", False), ("geometry", True)):
        isect = make_training_intersector(scene, cfg, needs_geometry_grads=geom)
        step, params, opt = make_train_step(scene, cfg, intersect_fn=isect)
        times = []
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev) / 1e9
        torch.cuda.reset_peak_memory_stats(dev)
        reset(counts)
        k2.COUNT_DIFF.reset()
        for i in range(6):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            params, opt, loss = step(params, opt, target, 0)
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            got = check_training(f"{label} step {i}", counts, i + 1, cfg.max_bounces, False)
        launches[f"training {label} (6 steps)"] = got
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        holder = [params, opt]

        def one_step():
            holder[0], holder[1], _ = step(holder[0], holder[1], target, 0)

        breakdown, _ = device_breakdown(one_step, counts)
        t_ = sorted(times[1:])
        med = t_[len(t_) // 2]
        timings[label] = {"ms": med, "min_ms": t_[0], "max_ms": t_[-1], "warm_ms": times[0],
                          "primary_mrays_s": TRAIN_W * TRAIN_H / 1e6 / (med / 1e3),
                          "peak_gb": peak, "held_before_gb": held, "loss": float(loss)}
        timings[label]["device_breakdown"] = breakdown
        print(f"training step {label} grid64x28 {TRAIN_W}x{TRAIN_H} {card}: median "
              f"{med:.3f} ms of 5 (min {t_[0]:.3f}, max {t_[-1]:.3f}; warm-up {times[0]:.3f}), "
              f"{timings[label]['primary_mrays_s']:.3f} primary MRays/s, peak device memory "
              f"{peak:.3f} GB ({peak - held:.3f} GB above the {held:.3f} GB held before), loss "
              f"{float(loss):.6g}")
        print(f"  training step {label}: device time of one more step {card}: {breakdown}")
    return launches, timings


def textured_step_phase(grid, counts, dev, card):
    """One "materials + texture" step on grid64x28-tex at 640x480 with
    tex_data trainable (every leaf but the vertices): its time and peak
    memory (the first step, and a second); the texel gradient must be
    finite, and nonzero on the grey spheres' maps. The counters are reset
    once and checked after each step: K1 5 launches a step, and K3's plain
    gather 5 times a step inside the differentiable bounce. Returns {path:
    launches} (the counters' sums) and the timings."""
    from tracy_tpu_torch import RenderConfig
    from tracy_tpu_torch.accel.reorder import pick_compact_group
    from tracy_tpu_torch.diff import (
        TrainableParams, make_train_step, make_training_intersector)
    from tracy_tpu_torch.ops import shade as k2

    grid.width, grid.height = TRAIN_W, TRAIN_H
    scene = grid.build(device=dev)
    cfg = RenderConfig(width=TRAIN_W, height=TRAIN_H, spp=1, max_bounces=5, tonemap="none",
                       accel="packet", russian_roulette=True, pallas_bvh_width=4,
                       wave_compact_group=pick_compact_group(TRAIN_W * TRAIN_H))
    isect = make_training_intersector(scene, cfg, needs_geometry_grads=False)
    target = torch.full((TRAIN_H, TRAIN_W, 3), 0.5, device=dev)
    mask = TrainableParams(*(True,) * 8)._replace(vertex_pos=False)
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    step, params, opt = make_train_step(scene, cfg, intersect_fn=isect, trainable_mask=mask)
    times = []
    reset(counts)
    k2.COUNT_DIFF.reset()
    for i in range(2):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, target, 0)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        got = check_training(f"textured step {i}", counts, i + 1, cfg.max_bounces, True)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    g = params.tex_data.grad
    maps = [scene.tex_table[t].tolist() for t in scene.materials.tex_index[1].tolist() if t >= 0]
    texels = sum(w * h for _, w, h, _ in maps)  # the grey spheres' five maps
    nonzero = sum(int((g[o:o + w * h] != 0).any(-1).sum()) for o, w, h, _ in maps)
    finite = bool(torch.isfinite(g).all())
    print(f"textured step grid64x28-tex {TRAIN_W}x{TRAIN_H}, atlas "
          f"{scene.tex_data.numel() * 4 / 1e6:.1f} MB trainable {card}: first step "
          f"{times[0]:.3f} ms, second {times[1]:.3f} ms, peak device memory {peak:.3f} GB "
          f"({peak - held:.3f} GB above the {held:.3f} GB held before); "
          f"launches over the 2 steps {got}, K3's plain gather {counts['K3'].plain} (in the "
          f"differentiable bounce, checked each step); texel gradient finite {finite}, nonzero "
          f"on {nonzero} of the grey spheres' {texels} texels; loss {float(loss):.6g}")
    if not finite or nonzero == 0:
        raise RuntimeError("the textured step's texel gradient is not finite, or zero")
    return ({"training textured (2 steps)": got},
            {"first_ms": times[0], "second_ms": times[1], "peak_gb": peak,
             "k3_plain_gathers": counts["K3"].plain,
             "held_before_gb": held})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from tracy_tpu_torch import RenderConfig
    from tracy_tpu_torch.accel.reorder import pick_compact_group
    from tracy_tpu_torch.ops import bounce as k5
    from tracy_tpu_torch.ops import build, compare
    from tracy_tpu_torch.ops import intersect as k1
    from tracy_tpu_torch.ops import shade as k2
    from tracy_tpu_torch.ops import texfetch as k3
    from tracy_tpu_torch.render.renderer import Renderer, init_state, pick_tile
    from tracy_tpu_torch.scene import load_scene, sphere_grid
    from tracy_tpu_torch.tools import micro as k6
    from tracy_tpu_torch.utils import parity

    dev = torch.device("cuda", 0)
    counts = {"K1": k1.COUNT, "K2": k2.COUNT, "K3": k3.COUNT, "K4": k2.COUNT_TEX,
              "K5": k5.COUNT}

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
        print(f"  ptxas {src}: " + ptxas_summary(log))

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
    tables2 = tables.binary()  # the same tree walked binary, for the A/B
    r8 = Renderer(cfg.replace(pallas_bvh_width=8))
    r8.prepare(scene)
    tables8 = r8.tables
    print(f"scene grid64x28: {scene.num_triangles} triangles, {tables.node_meta.shape[0]} "
          f"binary BVH nodes, depth {tables.max_depth}; {tables.wide.shape[0]} 4-wide nodes, "
          f"depth4 {tables.depth4}, stack {tables.stack_size} entries; "
          f"{tables8.wide.shape[0]} 8-wide nodes, depth8 {tables8.depth4}, stack "
          f"{tables8.stack_size} entries (kernel {tables8.stack_max}); host build of both "
          f"{time.perf_counter() - t0:.1f} s")
    if tables8.width != 8 or not torch.equal(tables8.node_meta, tables.node_meta):
        raise RuntimeError("the 8-wide tables should collapse the same binary tree")
    if scene.num_triangles != 100_748:
        raise RuntimeError(f"grid64x28 should hold 100,748 triangles, got {scene.num_triangles}")
    if cfg.pallas_bvh_width != 4 or tables.width != 4:
        raise RuntimeError(f"the main path should walk the 4-wide BVH, not width {tables.width}")
    # bench.py's compaction group for this scene at this resolution.
    group = pick_compact_group(WIDTH * HEIGHT, num_tris=builder.num_triangles,
                               has_translucent=builder.has_translucent)
    if group != 262_144:
        raise RuntimeError(f"pick_compact_group gave {group} for grid64x28, not 262,144")

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
    if ttables.width != 4:
        raise RuntimeError(f"grid64x28-tex should walk the 4-wide BVH, not width {ttables.width}")

    # Every kernel is held against its plain version and timed at the main
    # path's wave shape: 1080 rows padded to the 32-row tile -> 1088 x 1920 =
    # 2,088,960 lanes.
    th, _ = pick_tile(HEIGHT, WIDTH)
    wave = (HEIGHT + (-HEIGHT) % th) * WIDTH
    o, d, a = compare.intersect_rays(scene, tables, wave, seed=1)
    c1 = compare.compare_intersect(o, d, a, tables)
    c1e = compare.compare_intersect(o, d, a, tables8)
    c1b = compare.compare_intersect(o, d, a, tables2)
    for c in (c1, c1e, c1b):
        print(f"K1 vs plain, grid64x28, width {c['width']}, {c['rays']} rays (half secondary): "
              f"mask agreement {c['mask_agree']:.6f} (>= 0.9999), max |dt| "
              f"{c['max_abs_err']:.3g} (<= 1e-5 t + 1e-6), normal max err "
              f"{c['normal_max_abs_err']:.3g}, materials equal {c['material_equal']}, hit "
              f"fraction {c['hit_fraction']:.3f}")
    print(f"  bound's yardstick (binary traversal of these rays): {c1['inner_visits']} inner-node "
          f"visits, {c1['tri_tests']} triangle tests; the 4-wide tree's own work: "
          f"{c1['wide_inner_visits']} node visits, {c1['wide_box_tests']} box tests, "
          f"{c1['wide_tri_tests']} triangle tests, {c1['wide_culled_pops']} pops culled; the "
          f"8-wide tree's: {c1e['wide_inner_visits']} node visits, {c1e['wide_box_tests']} box "
          f"tests, {c1e['wide_tri_tests']} triangle tests, {c1e['wide_culled_pops']} pops "
          f"culled; lanes busy in a warp's node / triangle iterations (as the plain traversal "
          f"steps warps of 32): width 4 {c1['wide_simt']['node']:.3f} / "
          f"{c1['wide_simt']['tri']:.3f}, width 8 {c1e['wide_simt']['node']:.3f} / "
          f"{c1e['wide_simt']['tri']:.3f}, width 2 "
          f"{c1['binary_simt']['node']:.3f} / {c1['binary_simt']['tri']:.3f}")
    to, td, ta = compare.intersect_rays(tscene, ttables, wave, seed=1)
    c1t = compare.compare_intersect(to, td, ta, ttables)
    print(f"K1 vs plain, grid64x28-tex (uv + tangent), {c1t['rays']} rays: mask agreement "
          f"{c1t['mask_agree']:.6f}, max |dt| {c1t['max_abs_err']:.3g}, uv max err "
          f"{c1t['tex_uv_max_abs_err']:.3g}, tangent max err {c1t['tangent_max_abs_err']:.3g}")

    dscene = load_scene(os.path.join(REPO, "data", "scenes", "default.scn")).build(device=dev)
    mtab = k2.build_material_table(dscene.materials)
    lanes = compare.canned_lanes(mtab.shape[0], wave, seed=2, device=dev)
    c2 = {}
    for rng in ("fast", "xorshift", "lcg"):
        for rr in (True, False):
            c = compare.compare_shade(lanes, mtab, 3, 1, seed=SEED, russian_roulette=rr,
                                      rng=rng)
            c2[(rng, rr)] = c
            print(f"K2 (in place) vs plain, each on its own copy, {c['lanes']} lanes, "
                  f"default.scn materials, rng {rng}, RR {rr}: bit for bit {c['bit_equal']} "
                  f"(must be), decisions flipped {c['flipped']:.6f}, max abs err "
                  f"{c['max_abs_err']:.3g}; dead lanes changed {c['dead_lanes_changed']}, "
                  f"miss lanes' origin/direction/throughput changed {c['miss_lanes_changed']} "
                  f"(both must be 0)")
            if not c["bit_equal"]:
                raise RuntimeError(f"K2 differs from its plain version: {c}")

    # K3 and K4 on grid64x28-tex: canned lanes (random materials, uv with
    # repeats, 30% misses), and the real lanes of the K1 wave above. K4
    # fetches its own texels (K3's addresses) and updates its state in
    # place: each side of a comparison and each timed launch gets its own
    # copy of the lanes.
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
    for kind, rng, rr in (("canned", "fast", True), ("canned", "fast", False),
                          ("real", "fast", True), ("real", "fast", False),
                          ("canned", "xorshift", True), ("canned", "lcg", True)):
        c = compare.compare_shade_textured(canned if kind == "canned" else real, tscene, mtab_t,
                                           3, 1, seed=SEED, russian_roulette=rr, rng=rng)
        c4[(kind, rng, rr)] = c
        print(f"K4 (fetch + textured bounce, in place) vs "
              f"plain, {kind} lanes, rng {rng}, RR {rr}: decisions flipped "
              f"{c['flipped']:.6f} (<= 1e-4), max abs err {c['max_abs_err']:.3g} "
              f"(rtol 1e-5, atol 1e-6)")

    # K5 on the real lanes of the grid64x28 wave, with grid64x28's materials
    # and the canned lanes' throughput, radiance and pixel ids.
    mtab_g = k2.build_material_table(scene.materials)
    glanes = compare.canned_lanes(mtab_g.shape[0], wave, seed=4, device=dev)
    blanes = dict(glanes, origin=o, direction=d, alive=a)
    c5 = {}
    for tb, rng, rr in ((tables, "fast", True), (tables, "fast", False), (tables2, "fast", True),
                        (tables2, "fast", False), (tables8, "fast", True),
                        (tables8, "fast", False), (tables, "xorshift", True),
                        (tables, "lcg", True)):
        c = compare.compare_bounce(blanes, tb, mtab_g, 3, 1, seed=SEED, russian_roulette=rr,
                                   rng=rng)
        c5[(tb.width, rng, rr)] = c
        print(f"K5 vs plain, width {tb.width}, {c['lanes']} real lanes of grid64x28, rng "
              f"{rng}, RR {rr}: decisions flipped {c['flipped']:.6f} (<= 1e-4), max abs err "
              f"{c['max_abs_err']:.3g} (rtol 1e-5, atol 1e-6); vs K1 then K2 on a copy of "
              f"the same lanes, outputs equal {c['equal_to_k1_k2']} (all must be)")

    # K1 and K5 at the three widths, in turns (2, 4, 8, 8, 4, 2): the A/B
    # of the widths on one card; K1 also on each half of the wave (the
    # camera rays at random pixels, the secondary rays).
    t1w, t5w, t1h = {2: [], 4: [], 8: []}, {2: [], 4: [], 8: []}, {}
    bargs = [blanes[k] for k in compare.BOUNCE_ARGS]
    kw = dict(seed=SEED, russian_roulette=True)
    half = {"camera": slice(0, wave // 2), "secondary": slice(wave // 2, wave)}
    for tb in (tables2, tables, tables8, tables8, tables, tables2):
        t1w[tb.width].append(compare.cuda_ms(lambda: k1.intersect(o, d, a, tb), 10))
        t5w[tb.width].append(compare.cuda_ms(
            lambda: k5.trace_bounce(*bargs, 3, 1, tables=tb, mtab=mtab_g, **kw), 10))
        for hname, sl in half.items():
            ho, hd, ha = o[sl].contiguous(), d[sl].contiguous(), a[sl].contiguous()
            t1h.setdefault(f"{hname} width {tb.width}", []).append(
                compare.cuda_ms(lambda: k1.intersect(ho, hd, ha, tb), 10))
    t1w = {w: sum(v) / len(v) for w, v in t1w.items()}
    t5w = {w: sum(v) / len(v) for w, v in t5w.items()}
    t1h = {h: sum(v) / len(v) for h, v in t1h.items()}
    t_k1, t_k5 = t1w[4], t5w[4]
    t_p1 = compare.cuda_ms(lambda: k1.intersect_plain(o, d, a, tables), 1)
    t_k1t = compare.cuda_ms(lambda: k1.intersect(to, td, ta, ttables), 10)
    t_k2 = compare.inplace_ms(lambda a: k2.shade(*a, mtab, 3, 1, **kw), lanes, 20,
                              compare.SHADE_ARGS)
    t_p2 = compare.inplace_ms(lambda a: k2.shade_plain(*a, mtab, 3, 1, **kw), lanes, 3,
                              compare.SHADE_ARGS)
    fargs = [real[k] for k in compare.TEXFETCH_ARGS]
    tex = (tscene.tex_data, tscene.tex_table, tscene.materials.tex_index)
    t_k3 = compare.cuda_ms(lambda: k3.fetch_texels(*fargs, *tex), 20)
    t_p3 = compare.cuda_ms(lambda: k3.fetch_texels_plain(*fargs, *tex), 3)
    flat = c3["real"]["addresses"]
    t_l3 = compare.cuda_ms(lambda: tscene.tex_data.index_select(0, flat), 20)
    t_k4 = compare.inplace_ms(lambda a: k2.shade_textured(*a, mtab_t, *tex, 3, 1, **kw),
                              real, 20)
    # Where K4's time goes on these lanes: the same lanes with no texture
    # flag set (no gathers: the state traffic and the math alone), and
    # with every lane dead (the launch, the staged tables, the alive flags).
    mtab_flat = mtab_t.clone()
    mtab_flat[:, k2.HAS_COL:k2.HAS_COL + 5] = 0.0
    t4_parts = {
        "no texel gathers": compare.inplace_ms(
            lambda a: k2.shade_textured(*a, mtab_flat, *tex, 3, 1, **kw), real, 20),
        "all lanes dead": compare.inplace_ms(
            lambda a: k2.shade_textured(*a, mtab_t, *tex, 3, 1, **kw),
            dict(real, alive=torch.zeros_like(ta)), 20)}
    t_p4 = compare.inplace_ms(
        lambda a: k2.shade_textured_plain(*a, mtab_t, *tex, 3, 1, **kw), real, 3)
    bkw = dict(tables=tables, mtab=mtab_g, **kw)
    t_p5 = compare.cuda_ms(lambda: k5.trace_bounce_plain(*bargs, 3, 1, **bkw), 1)

    def two_stage(state):
        sh = k1.intersect(state[0], state[1], state[4], tables)
        return k2.shade(*state[:5], state[5], sh.hit.mask, sh.hit.t, sh.normal, sh.material,
                        mtab_g, 3, 1, **kw)

    t_k12 = compare.inplace_ms(two_stage, blanes, 10, compare.BOUNCE_ARGS)
    b3, b4, b5 = c3["real"], c4[("real", "fast", True)], c5[(4, "fast", True)]
    print(f"time at the 1080p wave ({wave} lanes; K1 and K5 on half camera, half secondary "
          f"rays; K3/K4 on the real lanes of grid64x28-tex) {card}:")
    print(f"  K1 width 4 {t1w[4]:.3f} ms, width 8 {t1w[8]:.3f} ms, width 2 {t1w[2]:.3f} ms "
          f"(means of 2 turns each) vs "
          f"plain {t_p1:.1f} ms, bound {c1['bound_ms']:.4f} ms ({c1['bound_by']}: "
          f"{c1['bytes']:.4g} B, {c1['ops']:.4g} ops, the binary yardstick at every width); "
          f"K1 uv+tangent on grid64x28-tex, width 4, {t_k1t:.3f} ms, bound "
          f"{c1t['bound_ms']:.4f} ms; K1 on each half of the wave ({wave // 2} lanes): "
          + ", ".join(f"{h} {t:.3f} ms" for h, t in t1h.items()))
    b2 = c2[("fast", True)]
    print(f"  K2 (in place, canned lanes: 90% alive, 70% hit) {t_k2:.3f} ms vs plain "
          f"{t_p2:.3f} ms, bound {b2['bound_ms']:.4f} ms ({b2['bound_by']}: {b2['bytes']:.4g} B)")
    print(f"  K3 {t_k3:.3f} ms vs plain {t_p3:.3f} ms, index_select of the same "
          f"{flat.numel()} texels {t_l3:.3f} ms, bound {b3['bound_ms']:.4f} ms "
          f"({b3['bound_by']}: {b3['bytes']:.4g} B, {b3['ops']:.4g} ops)")
    print(f"  K4 (fetch + textured bounce, in place) {t_k4:.3f} ms vs plain {t_p4:.3f} ms, "
          f"bound {b4['bound_ms']:.4f} ms ({b4['bound_by']}: {b4['bytes']:.4g} B, "
          f"{b4['ops']:.4g} ops); the same lanes with "
          + ", ".join(f"{k} {t:.3f} ms" for k, t in t4_parts.items()))
    print(f"  K5 width 4 {t5w[4]:.3f} ms, width 8 {t5w[8]:.3f} ms, width 2 {t5w[2]:.3f} ms vs "
          f"plain {t_p5:.1f} ms, "
          f"bound {b5['bound_ms']:.4f} ms "
          f"({b5['bound_by']}: {b5['bytes']:.4g} B, {b5['ops']:.4g} ops; {b5['hit_lanes']} hit, "
          f"{b5['miss_lanes']} miss, {b5['dead_lanes']} dead lanes); K1 then K2 (in place, "
          f"on copies) on the same lanes, width 4, {t_k12:.3f} ms")

    # 4. main paths
    ccfg = cfg.replace(wave_compact_group=group)
    paths = (("grid64x28 compacted", scene, ccfg, ("K1", "K2")),
             ("grid64x28", scene, cfg, ("K1", "K2")),
             ("grid64x28 fused", scene, ccfg.replace(use_pallas_bounce=True), ("K5",)),
             ("grid64x28-tex compacted", tscene, ccfg, ("K1", "K4")),
             ("grid64x28-tex", tscene, cfg, ("K1", "K4")),
             ("grid64x28 compacted width 8", scene, ccfg.replace(pallas_bvh_width=8),
              ("K1", "K2")),
             ("grid64x28 compacted width 2", scene, ccfg.replace(pallas_bvh_width=2),
              ("K1", "K2")),
             ("grid64x28 width 2", scene, cfg.replace(pallas_bvh_width=2), ("K1", "K2")))
    print("config: " + json.dumps({"width": cfg.width, "height": cfg.height, "spp": cfg.spp,
                                   "frames": FRAMES, "max_bounces": cfg.max_bounces,
                                   "russian_roulette": cfg.russian_roulette,
                                   "tonemap": cfg.tonemap, "accel": cfg.accel,
                                   "rng": cfg.rng, "wave_compact_group": group,
                                   "wave_compact_skip_first": ccfg.wave_compact_skip_first,
                                   "bvh_leaf_size": cfg.bvh_leaf_size,
                                   "pallas_bvh_width": cfg.pallas_bvh_width,
                                   "paths": [p[0] for p in paths]}))
    # Every path is timed REPEATS times, the paths in turn, before any of
    # them runs under the profiler (a profiled window leaves the host
    # slower for later runs).
    rends, launches, accum, rates, peak = {}, {}, {}, {}, {}
    for pname, sc, pcfg, need in paths:
        rend = Renderer(pcfg)
        rend.step_many(sc, init_state(pcfg, dev), 1)  # warm-up frame
        want_path = "fused" if "K5" in need else "two-stage"
        if rend.path != want_path:
            raise RuntimeError(f"{pname}: the renderer bound the {rend.path} path")
        if rend.tables.width != pcfg.pallas_bvh_width:
            raise RuntimeError(f"{pname}: the tables have width {rend.tables.width}, "
                               f"not {pcfg.pallas_bvh_width}")
        rends[pname] = rend
        rates[pname] = []
    for rep in range(REPEATS):
        for pname, sc, pcfg, need in paths:
            rend = rends[pname]
            rend.reset(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            for c in counts.values():
                c.reset()
            state, nrays = rend.step_many(sc, init_state(pcfg, dev), FRAMES)
            got = {k: (c.kernel, c.plain) for k, c in counts.items()}
            for kname, (kern, plain) in got.items():
                want = pcfg.max_bounces * FRAMES if kname in need else 0
                if kern != want or plain != 0:
                    raise RuntimeError(f"{pname}: {kname} {kern} kernel launches (want "
                                       f"{want}), {plain} plain runs")
            rates[pname].append(rend.mrays_per_sec)
            if rep == 0:
                launches[pname] = {k: kern for k, (kern, _) in got.items()}
                accum[pname] = state.accum
                peak[pname] = torch.cuda.max_memory_allocated(dev) / 1e9
                img = rend.display(state)
                if (img.shape != (HEIGHT, WIDTH, 3)
                        or not np.isfinite(state.accum.cpu().numpy()).all()):
                    raise RuntimeError(f"{pname} image: shape {img.shape} or non-finite values")
                print(f"main path {pname} ({rend.path}, group {pcfg.wave_compact_group}, "
                      f"BVH width {rend.tables.width}): "
                      f"{sc.num_triangles} triangles, {FRAMES} frames, {nrays} rays; launches "
                      + ", ".join(f"{k} {v[0]}" for k, v in got.items())
                      + f", plain {sum(v[1] for v in got.values())}; peak device memory "
                      f"{peak[pname]:.2f} GB; image mean {float(state.accum.mean()):.4f}")
    for pname, sc, pcfg, _ in paths:
        r_ = sorted(rates[pname])
        print(f"main path {pname}: MRays/s over {REPEATS} runs of {FRAMES} frames, taken in "
              f"turn with the other paths {card}: median {r_[len(r_) // 2]:.2f}, min "
              f"{r_[0]:.2f}, max {r_[-1]:.2f}")
    by_bounce = {"K1": {}, "K2": {}}
    for pname, sc, pcfg, _ in paths:
        rend = rends[pname]
        line, seq = device_breakdown(
            lambda: rend.step_many(sc, init_state(pcfg, dev), FRAMES), counts)
        print(f"  {pname}: device time of {FRAMES} more frames {card}: {line}")
        for kname in sorted(seq):  # frame 0's launches are bounces 0..max_bounces-1
            per_bounce = seq[kname][:pcfg.max_bounces]
            if kname in ("K1", "K2"):
                by_bounce[kname][pname] = per_bounce
            print(f"  {pname}: {kname} ms per bounce of frame 0 {card}: "
                  + ", ".join(f"{t:.3f}" for t in per_bounce))
    for p2 in ("grid64x28 compacted width 8", "grid64x28 compacted width 2",
               "grid64x28 width 2"):
        a2, a4 = accum[p2], accum["grid64x28"]
        print(f"{p2} vs width 4: {int((a2 != a4).any(-1).sum())} of "
              f"{a4.shape[0] * a4.shape[1]} pixels differ, max |difference| "
              f"{float((a2 - a4).abs().max()):.3g} (the widths may break an equal-t tie apart)")
    for ref, others in (("grid64x28", ("grid64x28 compacted", "grid64x28 fused")),
                        ("grid64x28-tex", ("grid64x28-tex compacted",)),
                        ("grid64x28 width 2", ("grid64x28 compacted width 2",))):
        same = {p: bool(torch.equal(accum[p], accum[ref])) for p in others}
        print(f"accumulators equal to {ref}'s: {same}")
        if not all(same.values()):
            raise RuntimeError(f"accumulators differ from {ref}'s: {same}")

    rows, seen = live_lanes(scene, ccfg, tables)
    lo, ld, la = seen[1]
    print(f"live lanes per bounce of frame 0, grid64x28, {rows[0]['lanes']} lanes in "
          f"{rows[0]['warps']} warps of 32 (warps holding a live lane: as traced uncompacted / "
          f"after compaction in groups of {group}):")
    for b, row in enumerate(rows):
        print(f"  bounce {b}: live {row['live']} ({row['live'] / row['lanes']:.4f}), warps "
              f"{row['warps_live']} / {row['warps_live_compacted']}")
    zeros = torch.zeros_like(lo)
    pix = torch.arange(la.numel(), dtype=torch.int32, device=dev)
    rt_ms = compare.compaction_ms(lo, ld, zeros, zeros, la, pix, group)
    print(f"compaction round trip at the {la.numel()}-lane wave (bounce 1's live lanes, group "
          f"{group}) {card}: rays down + hit record back {rt_ms['intersector_ms']:.3f} ms, "
          f"state down + next state back {rt_ms['bounce_ms']:.3f} ms")
    # K2 on the real lanes of each bounce of that frame: its rays, alive
    # flags and K1's hit record, with the canned throughput, radiance and
    # pixel ids; every launch on its own copy of the state.
    t2b, b2b = [], []
    for b, (bo, bd, ba) in enumerate(seen):
        sh = k1.intersect(bo, bd, ba, tables)
        bl = dict(glanes, origin=bo, direction=bd, alive=ba, hit_mask=sh.hit.mask, t=sh.hit.t,
                  normal=sh.normal, mat_id=sh.material)
        t2b.append(compare.inplace_ms(lambda x, b=b: k2.shade(*x, mtab_g, 0, b, **kw), bl, 20,
                                      compare.SHADE_ARGS))
        b2b.append(compare.bound_ms(*compare._bounce_work(bl, mtab_g, textured=False)))
    print(f"K2 (in place) on the real lanes of bounces 0-{len(seen) - 1} of frame 0, grid64x28, "
          f"uncompacted {card}: "
          + ", ".join(f"{t:.4f} ms (bound {b['bound_ms']:.4f})" for t, b in zip(t2b, b2b)))

    # 5. physics against the reference's own renders; the last two gates on
    # the other intersectors and counter hashes.
    for gname, fused, extra in (("furnace", False, {}), ("spheres", False, {}),
                                ("furnace", True, {}),
                                ("spheres", False, dict(accel="bvh", rng="xorshift")),
                                ("furnace", False, dict(accel="none", rng="lcg")),
                                ("furnace", False, dict(pallas_bvh_width=8))):
        gb = load_scene(os.path.join(REPO, "tests", "goldens", "scn", f"{gname}.scn"))
        if gb.fallbacks:
            raise RuntimeError(f"{gname}.scn substituted files: {gb.fallbacks}")
        gcfg = RenderConfig(width=gb.width, height=gb.height, spp=1, **extra)
        if fused:
            gcfg = gcfg.replace(use_pallas_bounce=True,
                                wave_compact_group=pick_compact_group(gb.width * gb.height))
        gr = Renderer(gcfg)
        for c in counts.values():
            c.reset()
        gst, _ = gr.step_many(gb.build(device=dev), init_state(gcfg, dev), 24)
        ours = np.clip(gr.display(gst) * 255.99, 0.0, 255.0)
        ours = parity.srgb_to_linear(ours / 255.99)[::-1]  # goldens are bottom row first
        ref = parity.load_golden(os.path.join(REPO, "tests", "goldens", "ref", f"{gname}.npz"))
        dmean, p95, dmax = parity.compare(ref, ours)
        print(f"{gname} {gb.width}x{gb.height} ({gr.path}, group {gcfg.wave_compact_group}, "
              f"accel {gcfg.accel}, rng {gcfg.rng}, BVH width "
              f"{gr.tables.width if gr.tables is not None else '-'}), "
              f"24 frames vs tests/goldens/ref/{gname}.npz: mean diff {dmean:.5f} (<= 0.01), "
              f"block p95 {p95:.5f} (<= 0.02), block max {dmax:.5f} (<= 0.05); launches "
              + ", ".join(f"{k} {c.kernel}" for k, c in counts.items()))
        if dmean > 0.01 or p95 > 0.02 or dmax > 0.05:
            raise RuntimeError(f"{gname} parity failed")
        if any(c.plain for c in counts.values()):
            raise RuntimeError(f"{gname}: a plain version ran on the card")
        if fused and (k5.COUNT.kernel != 24 * gcfg.max_bounces or k1.COUNT.kernel):
            raise RuntimeError(f"{gname}: the fused path did not run on K5 alone")
        if gcfg.pallas_bvh_width == 8 and gr.tables.width != 8:
            raise RuntimeError(f"{gname}: the tables have width {gr.tables.width}, not 8")

    # 6. K6, the leaf-visit microbenchmark, through its own entry point's
    # measurement (tools/micro.py: time each variant at 270,336 rays x 2000
    # visits); then each variant against its plain version.
    leaves = k6.make_leaves(device=dev)
    mrays = k6.make_rays(device=dev)
    k6.COUNT.reset()
    t6 = {v: k6.time_variant(v, mrays, leaves) for v in k6.VARIANTS}
    k6_launches = k6.COUNT.kernel
    c6 = {v: k6.check_variant(v, mrays, leaves) for v in k6.VARIANTS}
    t_p6 = compare.cuda_ms(lambda: k6.micro_plain("vres", mrays, leaves), 1)
    b6 = k6.bound(mrays, leaves)
    print(f"K6 vs plain, {mrays.shape[0]} rays x {k6.ITERS} visits of {k6.NUM_LEAVES} leaves of "
          f"{k6.LEAF_SIZE} triangles (hit fraction {c6['vres']['hit_fraction']:.3f}, "
          f"improving warp-visits {c6['vred']['improving_warp_visits']}): every variant equal "
          f"to its plain version; {k6_launches} timed launches {card}:")
    for v in k6.VARIANTS:
        print(f"  {v:5s} {t6[v]['ns_per_iter']:.3f} ns/iter, {t6[v]['ns_per_ray_visit']:.6f} ns "
              f"per ray-visit, {t6[v]['ms']:.3f} ms a launch")
    print(f"  vres bound {b6['bound_ms']:.4f} ms ({b6['bound_by']}: {b6['ops']:.4g} ops), "
          f"plain {t_p6:.1f} ms")
    launches["tools.micro"] = {k: 0 for k in counts}
    launches["tools.micro"]["K6"] = k6_launches

    # 7. AOVs, 8. bands, 9. gradients, 10. training, 11. one textured step.
    launches.update(aov_phase((("grid64x28", scene), ("grid64x28-tex", tscene)), ccfg, counts,
                              dev, card))
    band_phase(scene, rends["grid64x28 compacted"], ccfg)
    launches.update(gradient_phase(dev, card))
    more, train_ms = training_phase(builder, counts, dev, card)
    launches.update(more)
    more, tex_ms = textured_step_phase(tbuilder, counts, dev, card)
    launches.update(more)
    print("training: " + json.dumps({"device": smi, **train_ms, "textured": tex_ms}))

    def entry(kname, label, source, replaces, err, ms, plain_ms, bound, library_ms):
        return {"name": f"{kname} {label}", "route": "cuda",
                "source": f"tracy_tpu_torch/csrc/{source}", "replaces": replaces,
                "launches": sum(p.get(kname, 0) for p in launches.values()),
                "launches_by_path": {p: v.get(kname, 0) for p, v in launches.items()},
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                "library_ms": library_ms}

    kernels = [
        entry("K1", "intersect", "intersect.cu", "tracy_tpu/ops/pallas_packet.py:519",
              max(c1["max_abs_err"], c1e["max_abs_err"], c1b["max_abs_err"],
                  c1t["max_abs_err"]), t_k1, t_p1, c1, None),
        entry("K2", "shade", "shade.cu", "tracy_tpu/ops/pallas_shade.py:72",
              max(c["max_abs_err"] for c in c2.values()), t_k2, t_p2, c2[("fast", True)], None),
        entry("K3", "texfetch", "texfetch.cu", "tracy_tpu/ops/pallas_texfetch.py:231",
              max(c["max_abs_err"] for c in c3.values()), t_k3, t_p3, b3, t_l3),
        entry("K4", "shade_textured (texel fetch + textured bounce)", "shade.cu",
              "tracy_tpu/ops/pallas_shade.py:355",
              max(c["max_abs_err"] for c in c4.values()), t_k4, t_p4, b4, None),
        entry("K5", "bounce", "bounce.cu", "tracy_tpu/ops/pallas_packet.py:2292",
              max(c["max_abs_err"] for c in c5.values()), t_k5, t_p5, b5, None),
        entry("K6", "micro (vres)", "micro.cu", "tools/tpu_micro.py:213",
              c6["vres"]["max_abs_err"], t6["vres"]["ms"], t_p6, b6, None),
    ]
    kernels[2]["note"] = ("launched on the textured AOV path, once a frame; inlined into K4 "
                          "on the beauty paths (0 launches there); the textured training "
                          "step gathers with its plain version inside the differentiable "
                          "bounce, once a bounce (K3 has no backward)")
    kernels[3]["fuses"] = "tracy_tpu/ops/pallas_texfetch.py:231"
    kernels[3].update(no_gathers_ms=t4_parts["no texel gathers"],
                      all_dead_ms=t4_parts["all lanes dead"])
    kernels[0]["textured_ms"] = t_k1t
    kernels[0]["textured_bound_ms"] = c1t["bound_ms"]
    kernels[0]["ms_per_bounce_frame0"] = by_bounce["K1"]
    kernels[0]["half_wave_ms"] = t1h
    b5e = c5[(8, "fast", True)]
    for kern, tw, c, c8 in ((kernels[0], t1w, c1, c1e), (kernels[4], t5w, b5, b5e)):
        kern.update(width4_ms=tw[4], width8_ms=tw[8], width2_ms=tw[2],
                    width8_bound_ms=c8["bound_ms"],
                    binary_inner_visits=c["inner_visits"],
                    binary_tri_tests=c["tri_tests"], wide_inner_visits=c["wide_inner_visits"],
                    wide_box_tests=c["wide_box_tests"], wide_tri_tests=c["wide_tri_tests"],
                    wide_culled_pops=c["wide_culled_pops"], wide_simt=c["wide_simt"],
                    wide8_inner_visits=c8["wide_inner_visits"],
                    wide8_box_tests=c8["wide_box_tests"], wide8_tri_tests=c8["wide_tri_tests"],
                    wide8_culled_pops=c8["wide_culled_pops"], wide8_simt=c8["wide_simt"],
                    binary_simt=c["binary_simt"])
    kernels[1].update(ms_per_bounce_frame0=by_bounce["K2"], real_lanes_ms_per_bounce_frame0=t2b,
                      real_lanes_bound_ms_per_bounce_frame0=[b["bound_ms"] for b in b2b])
    kernels[4]["k1_then_k2_ms"] = t_k12
    kernels[5]["ns_per_iter"] = {v: t6[v]["ns_per_iter"] for v in k6.VARIANTS}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
