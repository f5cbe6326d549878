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
   lanes without texel gathers and with every lane dead; at rng 'threefry'
   K2 and K5 bit for bit against their plain versions, K4 too but for sky
   lanes that address another texel (K3's contract), K5 under compaction
   (a third of the lanes live) equal to K1 then K2 and to its plain
   version, each timed beside its 'fast' twin in turns;
4. main paths: Renderer.step_many at 1920x1080, 4 progressive frames of
   1 spp, 5 bounces, on the 4-wide BVH (pallas_bvh_width's default), on
   grid64x28 (100,748 triangles) compacted as bench.py's main path is
   (pick_compact_group: group 262,144, bounce 0 uncompacted; K1 + K2),
   uncompacted, and fused (K5, compacted), and on grid64x28-tex, the same
   geometry with helmet-sized maps (K1 + K4; K3 is not launched there),
   compacted and uncompacted; grid64x28 compacted on the 8-wide BVH, and
   compacted and uncompacted on the binary BVH, for the A/B of the widths;
   grid64x28 compacted at rng 'threefry' (K1 + K2), held against the
   'fast' compacted path by the block-mean contract over 24 frames each;
   each path must launch exactly its kernels and no plain version, and
   each path's accumulator must equal the other paths' of its scene and
   width; each path is timed 5 times, in turn with the others; then where
   the device time of one more such run goes (torch.profiler), with each
   kernel's time per bounce of frame 0, and the live-lane fraction of each
   bounce of one frame with the compaction round trip's time at that wave;
   one compacted frame at ray_chunk = a quarter wave equals the whole
   frame bit for bit;
5. physics: furnace.scn (untextured; also on the fused, compacted path,
   with accel 'none' and rng 'lcg', on the 8-wide BVH and at rng
   'threefry', two-stage and fused) and spheres.scn (HDR equirect sky,
   textured path; also with accel 'bvh' and rng 'xorshift', and at rng
   'threefry') at 256x192 for 24 frames against the reference's own
   renders (tests/goldens/ref/*.npz), linear block means;
6. K6: each variant of the leaf-visit microbenchmark against its plain
   version, and its ms, nanoseconds per iteration and per ray-visit and
   registers;
7. AOVs: each of the six first-hit AOVs at 1920x1080 on grid64x28
   (compacted config) and grid64x28-tex, 4 frames timed 5 times: K1 once
   a frame, K3 once a frame on the textured scene, nothing else; frame 0
   equal to the same AOV through the plain versions on the card, bit for
   bit; MRays/s at num_rows * W rays a frame;
8. bands: the compacted 1080p beauty frame as 4 bands of 270 rows equals
   the full frame bit for bit; two 1-spp halves of an spp=2 frame average
   to it within 1e-6; at rng 'threefry' (a band draws over its own lanes,
   as in tracy_tpu) the 4 bands equal the same bands through the plain
   versions on the card, bit for bit;
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
   nonzero on the grey spheres' maps;
12. accel 'tlas' on grid64x28 at 1080p, compacted as the CLI binds it: host
   seconds of build_two_level, of update_object after one sphere moves
   (equal to a fresh build) and of a full build_tables; K1 on the stitched
   tables against its plain version on frame 0's camera rays, bit for
   bit; 5 runs of 4 frames in turn with the packet compacted path (K1 and
   K2 only, no plain version), the two accumulators held by the
   block-mean contract; furnace.scn at accel 'tlas' joins phase 5's gates;
13. the raster preview, plain and shaded, at 640x480 and 1080p on
   grid64x28 and grid64x28-tex: ms of each, coverage equal to K1's hit
   mask through the pixel centres on >= 99% of pixels;
14. the entry points as subprocesses (exit 0, outputs that decode):
   render_cli on spheres.scn at 1080p with -accel tlas and on the default
   scene at 640x480, -kernel raster and raster-gl, a -checkpoint run of 8
   frames resumed to 16 (equal bit for bit to an uninterrupted 16-frame
   run), the viewer's headless burst and optimize_cli's albedo self-test
   (the loss must fall); each run's MRays/s line is logged;
15. the mesh (tracy_tpu_torch/parallel) at 1080p on grid64x28, compacted:
   in-process meshes on this card, 1x1 and 4x1 at spp 1 equal to
   Renderer.step_many bit for bit (rays too), 2x2 at spp 2 within atol
   3e-6, rtol 1e-5 of the single-device frames, each launching K1 and K2
   alone; 4x1 timed against the single-device path, 5 runs each in turn;
   grid64x28-tex at 2x1 (K1 and K4) equal bit for bit; a 4x1 checkpoint
   resumed under 2x1 equal to the uninterrupted run; this script as two
   gloo ranks on this card (`--mesh-worker`): host rows disjoint and
   covering, 2 frames equal to one process bit for bit, one sharded
   640x480 "materials" step with gradients within 1e-4 of the largest
   entry of one process's; render_cli -mesh 2x2 -spp 2 on spheres.scn at
   1080p, and a -mesh 4x1 checkpoint resumed under -mesh 2x1 equal to
   phase 14's uninterrupted run;
16. image textures without PIL (blocked in this process from the start,
   if installed): each map of tests/goldens/textured/ (2048x2048 4:2:0
   JPEG, 4:4:4 JPEG, progressive grey JPEG, palette PNG, 16-bit PNG) and
   of tests/goldens/formats/ (RLE TGA, palette BMP, interlaced GIF with a
   transparency index, binary PGM, PackBits PSD) decoded on this host by
   csrc/image_decode.cpp and image_formats.cpp, with its seconds;
   textured.scn and formats.scn each loaded with no fallback, rendered at
   256x192 for 24 frames through K1 + K4 and held against tracy_tpu's CPU
   render (textured.npz, formats.npz) by phase 5's contract, and each
   one's basecolor AOV through K1 + K3, frame 0 equal to the plain
   versions'; the same for tests/goldens/tiffdds/ (DXT5 and BC5 DDS, LZW
   and tiled deflate TIFF, QOI; csrc/image_blocks.cpp, image_tiff.cpp)
   and tiffdds.scn, and for tests/goldens/webp/ (lossy, lossless, lossy
   with alpha, lossless palette and animated WebP; csrc/image_webp.cpp)
   and webp.scn, with the decode seconds of its two 2048x2048 maps (lossy
   with alpha, lossless), and for tests/goldens/containers/ (Adobe CMYK
   progressive JPEG, 4:1:1 JPEG, ICO, BLP1 JPEG of four components, ICNS
   it32; csrc/image_decode.cpp, image_containers.cpp) and containers.scn,
   with the decode seconds of its 2048x2048 Adobe CMYK JPEG and of a YCCK
   JPEG, a CUR, a DIB, an FTEX and two BLP2 files, and for
   tests/goldens/legacy/ and legacy.scn, and tests/goldens/jpeg2000/ (9/7
   ICT JP2 in tiles, 5/3 RCT codestream in RPCL, grey JP2, signed
   codestream in PCRL, RGBA JP2 in CPRL with PLT; csrc/image_jpeg2000.cpp)
   and jpeg2000.scn, with the decode seconds of its 2048x2048 9/7 JP2, and
   tests/goldens/avif/ (4:2:0 at PIL's defaults, 4:4:4 in 2x2 tiles with
   CDEF and loop restoration, screen content with palettes and intra block
   copy, quantizer matrices with delta q, RGBA with an alpha item;
   csrc/image_avif.cpp, av1_decode.cpp, av1_recon.cpp) and avif.scn, with
   the decode seconds of its 2048x2048 4:2:0 map, and tests/goldens/avif/
   deep/ (the same slots at 10 and 12 bits: 4:2:0, 4:4:4 in tiles with
   CDEF, screen content, grey, RGBA) and avif10.scn, with the decode
   seconds of its 2048x2048 10-bit 4:2:0 map, and tests/goldens/tiffkinds/
   (JPEG YCbCr 2x2, ZSTD with predictor 2, float LZMA with the
   floating-point predictor, CCITT Group 4, YCbCr 2x1 TIFFs;
   csrc/image_tiff.cpp, image_xz.cpp, image_zstd.cpp) and tiffkinds.scn,
   with the decode seconds of its 2048x2048 float, JPEG, LZMA and ZSTD
   TIFFs; the small files of tests/goldens/kinds/ (IM YCC, RGB3, RYB3, B2
   and B4, IPTC holding PNG, BMP, TIFF, GIF and WebP streams, JP2
   palettes of one and two columns) each decoded equal to its recorded
   RGBA;
   grid64x28 with the JPEG/PNG maps in place of
   the numpy maps at 1080p, compacted, 4 frames, timed (no gain claimed), and
   grid64x28-dds, the same with 2048x2048 DDS maps made here from random
   blocks (BC7 basecolor and emissive, BC5 normal, BC4 roughness and
   metalness), decoded on this host;
17. the table routes of K2, K3 and K4 (ops/launch.py: shared memory
   within 48 KB, opted-in shared memory, global memory): scenes of 2,000
   and 8,000 materials and of 520 and 3,000 textured ones (five 4x4 maps
   each); at the 1080p canned wave each kernel on every route that holds
   its tables (the main path's on 'shared' and 'global') against its plain
   version and against its other routes bit for bit (K3 and K4 but for the
   main path's textured-sky lanes, K3's contract), each route timed in
   turns; the 8,000-material scene rendered two-stage and fused (K5) and
   the 3,000-material one compacted and uncompacted, with equal
   accumulators.

The main paths' K2 and K4 launches must all take the 48 KB staged route.
Prints a JSON line of per-kernel results, then as its last line
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result. Imports nothing of jax, and runs without PIL.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import struct
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
                  sky_size=SKY_SIZE, seed: int = SEED, maps=None, name="grid64x28-jpeg"):
    """grid64x28-tex: sphere_grid(64, 28) with textures made with numpy
    from `seed`, modelled on helmet.scn's five maps. Material 1 (grey)
    gets basecolor (sRGB), normal, roughness, metalness and emissive (sRGB)
    maps; material 3 (floor) a basecolor map; material 2 (metal) none; the
    sky is a float equirect with a bright sun. maps: {slot: (float RGBA
    image, srgb)} in place of the numpy maps (the floor then takes the
    basecolor map) and the scene is called `name`. Returns the builder."""
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
    if maps is None:
        maps = {
            TEX_BASECOLOR: (rgba(noise(0.2, 0.9), noise(0.2, 0.9), noise(0.2, 0.9)), True),
            TEX_NORMAL: (rgba(noise(0.4, 0.6), noise(0.4, 0.6), 1.0), False),
            TEX_ROUGHNESS: (rgba(noise(0.1, 1.0)), False),
            TEX_METALNESS: (rgba(noise(0.0, 1.0)), False),
            TEX_EMISSIVE: (rgba(*([np.where(noise(0.0, 1.0) < 0.005, 1.0, 0.0)] * 3)), True),
        }
        floor_map = (rgba(noise(0.1, 0.6), noise(0.1, 0.6), noise(0.1, 0.6)), True)
    else:
        b.name = name
        floor_map = maps[TEX_BASECOLOR]
    for slot, (img, srgb) in maps.items():
        b.set_material_texture(grey, slot, b.add_texture(img, srgb=srgb))
    b.set_material_texture(floor, TEX_BASECOLOR, b.add_texture(*floor_map))

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


def threefry_band_phase(scene, rend, cfg):
    """At rng 'threefry' a band draws over its own lanes (as in tracy_tpu),
    so the banded frame is not the full frame; it must equal the same 4
    bands through the plain versions on the card (K1's and K2's, under the
    same compaction), bit for bit."""
    import functools

    from tracy_tpu_torch.accel.reorder import compact_intersector
    from tracy_tpu_torch.ops import intersect as k1
    from tracy_tpu_torch.ops import shade as k2
    from tracy_tpu_torch.render.renderer import sample_radiance_rows

    plain_isect = functools.partial(k1.intersect_plain, tables=rend.tables)

    def plain_shade(o, d, thr, rad, alive, pix, hit_mask, t, normal, tangent, tex_uv, mat,
                    skey, bounce):
        return k2.shade_plain(o, d, thr, rad, alive, pix, hit_mask, t, normal, mat, rend._mtab,
                              skey, bounce, seed=cfg.seed,
                              russian_roulette=cfg.russian_roulette, rng=cfg.rng)

    rows = HEIGHT // 4
    kern = torch.cat([sample_radiance_rows(scene, cfg, 0, rend._intersect, row_offset=o,
                                           num_rows=rows, shade_fn=rend._shade,
                                           **rend._paths)[0]
                      for o in range(0, HEIGHT, rows)])
    plain = torch.cat([sample_radiance_rows(
        scene, cfg, 0, compact_intersector(plain_isect, cfg.wave_compact_group),
        row_offset=o, num_rows=rows, shade_fn=plain_shade, first_intersect_fn=plain_isect)[0]
        for o in range(0, HEIGHT, rows)])
    full, _ = sample_radiance_rows(scene, cfg, 0, rend._intersect, shade_fn=rend._shade,
                                   **rend._paths)
    same = bool(torch.equal(kern, plain))
    differ = int((kern != full).any(-1).sum())
    print(f"bands at rng threefry: 4 x {rows} rows through K1 and K2 equal to the same bands "
          f"through their plain versions on the card bit for bit: {same}; {differ} of "
          f"{WIDTH * HEIGHT} pixels differ from the full frame (each band draws over its own "
          f"lanes, as in tracy_tpu)")
    if not same:
        raise RuntimeError("threefry bands differ from their plain versions' "
                           f"by up to {float((kern - plain).abs().max()):.3g}")


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

    from tracy_tpu_torch.diff import (
        TrainableParams, extract_params, make_train_step, make_training_intersector)
    from tracy_tpu_torch.ops import shade as k2
    from tracy_tpu_torch.render.renderer import sample_radiance

    grid.width, grid.height = TRAIN_W, TRAIN_H
    scene = grid.build(device=dev)
    cfg = train_config()
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
    from tracy_tpu_torch.diff import (
        TrainableParams, make_train_step, make_training_intersector)
    from tracy_tpu_torch.ops import shade as k2

    grid.width, grid.height = TRAIN_W, TRAIN_H
    scene = grid.build(device=dev)
    cfg = train_config()
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


def tlas_phase(scene, ccfg, packet_rend, counts, dev, card):
    """accel 'tlas' on grid64x28 at 1080p, compacted as the CLI binds it:
    host seconds of build_two_level, of update_object after one grid sphere
    moves and of a full single-level build_tables; K1 on the stitched
    tables against its plain version on frame 0's camera rays, bit for bit;
    then REPEATS runs of FRAMES frames, in turn with the packet compacted
    path, each launching K1 and K2 max_bounces * FRAMES times and no plain
    version; the tlas accumulator against the packet one by the block-mean
    contract (mean 1e-3, p95 5e-3, max 0.05 in linear radiance). Returns
    {path: launches} and the timings."""
    from tracy_tpu_torch.accel.tables import build_tables, tree_depth
    from tracy_tpu_torch.accel.tlas import build_two_level, transform_object, update_object
    from tracy_tpu_torch.core import math as tm
    from tracy_tpu_torch.ops import intersect as k1
    from tracy_tpu_torch.render.renderer import Renderer, init_state, sample_radiance_rows
    from tracy_tpu_torch.utils.parity import block_means

    tcfg = ccfg.replace(accel="tlas")
    leaf, cap = tcfg.bvh_leaf_size, max(tcfg.traversal_stack_depth - 8, 8)
    t0 = time.perf_counter()
    two = build_two_level(scene, leaf_size=leaf, max_depth=cap)
    t_two = time.perf_counter() - t0
    obj = 3  # the first grid sphere (objects 0-2: default_scene's spheres and floor)
    moved = transform_object(scene, obj, tm.translate((0.0, 0.25, 0.0)))
    t0 = time.perf_counter()
    update_object(two, moved, obj)
    t_upd = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_tables(scene, leaf_size=leaf, max_depth=max(tcfg.traversal_stack_depth - 4, 8),
                 width=tcfg.pallas_bvh_width)
    t_full = time.perf_counter() - t0
    fresh = build_two_level(moved, leaf_size=leaf, max_depth=cap)
    same = all(np.array_equal(getattr(two.stitched, k), getattr(fresh.stitched, k))
               for k in ("node_bounds", "node_meta", "tri_order"))
    counts_ok = two.rebuild_counts == {i: 2 if i == obj else 1 for i in two.blas}
    if not same or not counts_ok:
        raise RuntimeError(f"update_object differs from a fresh build ({same}) or rebuilt "
                           f"other objects ({two.rebuild_counts})")

    rend = Renderer(tcfg)
    t0 = time.perf_counter()
    rend.prepare(scene)
    t_prep = time.perf_counter() - t0
    tb = rend.tables
    st = rend.two_level.stitched
    print(f"tlas grid64x28: {len(rend.two_level.blas)} objects, stitched tree "
          f"{st.num_nodes} nodes, depth bound {st.max_depth}, real depth "
          f"{tree_depth(st.node_meta)} (tables {tb.max_depth}), width {tb.width}, depth4 "
          f"{tb.depth4}, stack {tb.stack_size} of {tb.stack_max}; host {card}: "
          f"build_two_level {t_two:.3f} s, update_object of object {obj} ({moved.object_tri_ranges[obj][1]} "
          f"triangles) {t_upd:.3f} s, full build_tables {t_full:.3f} s, the renderer's "
          f"prepare (two-level build and tables) {t_prep:.3f} s; update equal to a fresh "
          f"build array for array, rebuild counts {sorted(set(two.rebuild_counts.values()))}")
    if rend.path != "two-stage" or tb.width != tcfg.pallas_bvh_width:
        raise RuntimeError(f"tlas: path {rend.path}, width {tb.width}")

    seen = []

    def record(o, d, a):
        seen.append((o.clone(), d.clone(), a.clone()))
        return k1.intersect(o, d, a, tb)

    sample_radiance_rows(scene, tcfg.replace(wave_compact_group=0, max_bounces=1), 0, record)
    o, d, a = seen[0]
    got, ref = k1.intersect(o, d, a, tb), k1.intersect_plain(o, d, a, tb)
    fields = lambda sh: list(sh.hit) + [sh.normal, sh.material]  # noqa: E731
    bit = all(torch.equal(x, y) for x, y in zip(fields(got), fields(ref)))
    print(f"K1 vs plain on the stitched tables, frame 0's {a.numel()} camera rays "
          f"({int(a.sum())} live): every output equal bit for bit {bit}; hit fraction "
          f"{float(got.hit.mask.float().mean()):.4f}")
    if not bit:
        raise RuntimeError("K1 on the stitched tables differs from its plain version")

    rend.step_many(scene, init_state(tcfg, dev), 1)  # warm-up frame
    rates = {"tlas": [], "packet": []}
    accum = {}
    for rep in range(REPEATS):
        for name, r_, c_ in (("tlas", rend, tcfg), ("packet", packet_rend, ccfg)):
            r_.reset(dev)
            reset(counts)
            state, nrays = r_.step_many(scene, init_state(c_, dev), FRAMES)
            got = {k: c.kernel for k, c in counts.items()}
            want = {k: c_.max_bounces * FRAMES if k in ("K1", "K2") else 0 for k in counts}
            if got != want or any(c.plain for c in counts.values()):
                raise RuntimeError(f"{name}: launches {got}, want {want}, plain "
                                   f"{[c.plain for c in counts.values()]}")
            rates[name].append(r_.mrays_per_sec)
            if rep == 0:
                accum[name] = state.accum
                if name == "tlas":
                    launches = got
                    print(f"main path grid64x28 tlas compacted (two-stage, group "
                          f"{tcfg.wave_compact_group}, BVH width {tb.width}): {FRAMES} frames, "
                          f"{nrays} rays; launches " + ", ".join(f"{k} {v}" for k, v in got.items())
                          + "; plain 0")
    for name in rates:
        r_ = sorted(rates[name])
        print(f"grid64x28 {name} compacted: MRays/s over {REPEATS} runs of {FRAMES} frames, in "
              f"turn {card}: median {r_[len(r_) // 2]:.2f}, min {r_[0]:.2f}, max {r_[-1]:.2f}")
    got_, ref_ = accum["tlas"].cpu().numpy(), accum["packet"].cpu().numpy()
    dblk = np.abs(block_means(got_) - block_means(ref_))
    dmean, p95, dmax = abs(float(got_.mean() - ref_.mean())), float(np.percentile(dblk, 95)), \
        float(dblk.max())
    differ = int((accum["tlas"] != accum["packet"]).any(-1).sum())
    print(f"tlas vs packet accumulators: {differ} of {WIDTH * HEIGHT} pixels differ; |mean| "
          f"{dmean:.3g} (<= 1e-3), block p95 {p95:.3g} (<= 5e-3), block max {dmax:.3g} (<= 0.05)")
    if dmean > 1e-3 or p95 > 5e-3 or dmax > 0.05:
        raise RuntimeError("tlas render outside the block-mean contract")
    med = {n: sorted(v)[len(v) // 2] for n, v in rates.items()}
    return {"tlas grid64x28 compacted": launches}, {
        "build_two_level_s": t_two, "update_object_s": t_upd, "build_tables_s": t_full,
        "mrays_s_tlas": med["tlas"], "mrays_s_packet": med["packet"]}


def raster_phase(named, dev, card):
    """render_raster plain and shaded at 640x480 and 1920x1080 on each of
    `named` ((name, builder, scene at 1080p, its BVH tables)): the ms of
    each (a warm-up, then the median of 3), finite images of the right
    shape, and raster coverage (the depth view > 0) equal on >= 99% of
    pixels to the hit mask of K1 on rays through the pixel centres (the
    check of tests/test_raster.py:51). Returns the timings."""
    import dataclasses

    from tracy_tpu_torch import RenderConfig
    from tracy_tpu_torch.core.camera import Camera, pixel_samples_rows
    from tracy_tpu_torch.ops import intersect as k1
    from tracy_tpu_torch.raster import render_raster

    out = {}
    for name, builder, sc1080, tables in named:
        for w, h in ((640, 480), (WIDTH, HEIGHT)):
            cam = Camera.setup(aspect_ratio=w / h, device=dev, **builder.camera_params)
            sc = dataclasses.replace(sc1080, camera=cam, width=w, height=h)
            cfg = RenderConfig(width=w, height=h, tonemap="srgb")
            for shaded in (False, True):
                render_raster(sc, cfg, shaded=shaded)
                times = []
                for _ in range(3):
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    img = render_raster(sc, cfg, shaded=shaded)
                    torch.cuda.synchronize(dev)
                    times.append((time.perf_counter() - t0) * 1e3)
                if img.shape != (h, w, 3) or not bool(torch.isfinite(img).all()):
                    raise RuntimeError(f"raster {name} {w}x{h}: shape {tuple(img.shape)} "
                                       "or non-finite")
                out[f"{name} {w}x{h} {'shaded' if shaded else 'plain'}"] = sorted(times)[1]
            depth = render_raster(sc, cfg.replace(aov="depth"))[..., 0] > 0
            rows = torch.arange(h, dtype=torch.int32, device=dev)
            half = torch.full((h, w), 0.5, device=dev)
            s, t = pixel_samples_rows(w, h, rows, half, half)
            o, dirs = cam.generate_rays(s.reshape(-1), t.reshape(-1))
            hit = k1.intersect(o.contiguous(), dirs.contiguous(),
                               torch.ones((w * h,), dtype=torch.bool, device=dev), tables)
            agree = float((hit.hit.mask.view(h, w) == depth).float().mean())
            print(f"raster {name} {w}x{h} {card}: plain "
                  f"{out[f'{name} {w}x{h} plain']:.3f} ms, shaded "
                  f"{out[f'{name} {w}x{h} shaded']:.3f} ms (median of 3); coverage equal "
                  f"to K1's pixel-centre hit mask on {agree:.5f} of pixels (>= 0.99)")
            if agree < 0.99:
                raise RuntimeError(f"raster {name} {w}x{h}: coverage agreement {agree}")
    return out


SMOKE_DIR = os.path.join(REPO, "build", "smoke")
SPHERES = os.path.join(REPO, "tests", "goldens", "scn", "spheres.scn")


def run_entry(label, module, args, card, result, shape=None):
    """One of the port's entry points as a subprocess in build/smoke/: it
    must exit 0 and, with `shape`, write a PNG of that shape that is not
    flat. Logs its MRays/s and other lines into result[label]; returns its
    standard error."""
    from tracy_tpu_torch.utils.image_io import decode_png

    os.makedirs(SMOKE_DIR, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", f"tracy_tpu_torch.apps.{module}"] + args,
                       cwd=SMOKE_DIR, env=env, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    lines = [ln for ln in p.stderr.splitlines() if "MRays/s" in ln or "raster frame" in ln
             or "resumed" in ln or "loss" in ln or "selftest" in ln or "mesh" in ln]
    print(f"entry {label}: exit {p.returncode} in {secs:.1f} s {card}"
          + "".join(f"\n    {ln}" for ln in lines[-3:]))
    if p.returncode != 0:
        raise RuntimeError(f"entry {label} exited {p.returncode}: {p.stderr[-2000:]}")
    if shape is not None:
        outp = os.path.join(SMOKE_DIR, args[args.index("-out") + 1])
        with open(outp, "rb") as f:
            img = decode_png(f.read())
        if img.shape != shape or img.std() == 0:
            raise RuntimeError(f"entry {label}: output {img.shape}, std {img.std()}")
    result[label] = {"seconds": secs, "log": lines}
    return p.stderr


def entry_phase(card):
    """The port's entry points as a user runs them, each a subprocess with
    exit code 0 and an output that decodes: render_cli on spheres.scn at
    1080p with -accel tlas and on the default scene at 640x480, -kernel
    raster and raster-gl, -checkpoint (8 frames, then a resume to 16,
    whose accumulator must equal an uninterrupted 16-frame run's bit for
    bit), the viewer's headless burst and the optimiser's albedo self-test,
    whose loss must fall. Outputs go to build/smoke/ in the checkout."""
    out_dir = SMOKE_DIR
    spheres = SPHERES
    result = {}

    def run(label, module, args, shape=None):
        return run_entry(label, module, args, card, result, shape)

    run("render_cli spheres.scn 1920x1080 tlas", "render_cli",
        ["-scene", spheres, "-width", "1920", "-height", "1080", "-frames", "4", "-accel",
         "tlas", "-out", "spheres_tlas.png"], (1080, 1920, 3))
    run("render_cli default 640x480", "render_cli",
        ["-frames", "16", "-out", "default.png"], (480, 640, 3))
    for kernel in ("raster", "raster-gl"):
        run(f"render_cli -kernel {kernel}", "render_cli",
            ["-kernel", kernel, "-out", f"{kernel}.png"], (480, 640, 3))
    ck_a, ck_b = (os.path.join(out_dir, n) for n in ("resume.npz", "straight.npz"))
    for f in (ck_a, ck_b):
        if os.path.exists(f):
            os.remove(f)
    ck = ["-checkpoint-every", "8"]
    run("render_cli -checkpoint 8 frames", "render_cli",
        ["-frames", "8", "-checkpoint", ck_a, "-out", "ck8.png"] + ck)
    log = run("render_cli -checkpoint resume to 16", "render_cli",
              ["-frames", "16", "-checkpoint", ck_a, "-out", "ck16.png"] + ck)
    run("render_cli -checkpoint 16 frames straight", "render_cli",
        ["-frames", "16", "-checkpoint", ck_b, "-out", "straight16.png"] + ck)
    with np.load(ck_a) as a, np.load(ck_b) as b:
        same = bool(np.array_equal(a["accum"], b["accum"])) and int(a["frame"]) == int(
            b["frame"]) == 16
    print(f"checkpoint: resumed at frame 8 ({'resumed' in log}), 16 frames equal to an "
          f"uninterrupted 16-frame run bit for bit: {same}")
    if not same or "resumed" not in log:
        raise RuntimeError("the checkpoint resume differs from the uninterrupted run")
    run("viewer -frames 4", "viewer", ["-frames", "4", "-out", "viewer.png"], (480, 640, 3))
    log = run("optimize_cli -selftest albedo", "optimize_cli",
              ["-selftest", "albedo", "-steps", "40", "-out", "recovered.png"], (72, 96, 3))
    losses = [float(m) for m in re.findall(r"step \d+: loss ([0-9.eE+-]+)", log)]
    print(f"optimize_cli: loss {losses[0]:.6g} -> {losses[-1]:.6g} over 40 Adam steps")
    if not losses[-1] < losses[0]:
        raise RuntimeError("the optimiser's loss did not fall")
    result["checkpoint_bit_equal"] = same
    result["optimize_losses"] = [losses[0], losses[-1]]
    return result


def check_launches(label, counts, want):
    """The counters since their reset: exactly `want` kernel launches (0
    for a kernel not named) and no plain version. Returns the launches."""
    got = {k: c.kernel for k, c in counts.items()}
    plain = {k: c.plain for k, c in counts.items() if c.plain}
    full = {k: want.get(k, 0) for k in counts}
    if got != full or plain:
        raise RuntimeError(f"{label}: launches {got} (want {full}), plain runs {plain}")
    return got


FIXTURE_DIR = os.path.join(REPO, "tests", "goldens", "textured")
# The fixture's maps as helmet.scn lays them out: file, slot name, sRGB.
FIXTURE_MAPS = (("basecolor.jpg", "B", True), ("normal.jpg", "N", False),
                ("roughness.jpg", "R", False), ("metalness.png", "M", False),
                ("emissive.png", "E", True))
# The same slots in the formats of csrc/image_formats.cpp.
FORMATS_DIR = os.path.join(REPO, "tests", "goldens", "formats")
FORMAT_MAPS = ("basecolor.tga", "normal.bmp", "roughness.gif", "metalness.pgm", "emissive.psd")
# And in the formats of csrc/image_blocks.cpp, image_tiff.cpp and QOI.
TIFFDDS_DIR = os.path.join(REPO, "tests", "goldens", "tiffdds")
TIFFDDS_MAPS = ("basecolor.dds", "normal.dds", "roughness.tif", "metalness.tif", "emissive.qoi")
# And as WebP (csrc/image_webp.cpp): lossy, lossless, lossy with alpha,
# lossless palette, animated; and two 2048x2048 maps, decode timing only.
WEBP_DIR = os.path.join(REPO, "tests", "goldens", "webp")
WEBP_MAPS = ("basecolor.webp", "normal.webp", "roughness.webp", "metalness.webp",
             "emissive.webp")
WEBP_BIG = ("big_lossy_alpha.webp", "big_lossless.webp")
# And as JPEG's four-component and 4:1:1 kinds and the containers
# (csrc/image_decode.cpp, image_containers.cpp): Adobe CMYK progressive
# JPEG, 4:1:1 JPEG, ICO, BLP1 JPEG of four components, ICNS it32; besides,
# decode timing only: a 2048x2048 Adobe CMYK JPEG, YCCK, CUR, DIB, FTEX and
# two BLP2 files (DXT5, palette).
CONTAINERS_DIR = os.path.join(REPO, "tests", "goldens", "containers")
CONTAINER_MAPS = ("basecolor.jpg", "normal_411.jpg", "roughness.ico", "metalness.blp",
                  "emissive.icns")
CONTAINER_EXTRA = ("big_cmyk.jpg", "ycck.jpg", "cursor.cur", "bitmap.dib", "texture.ftc",
                   "dxt5.blp", "palette.blp")
# And in PIL's small raw and run-length formats (csrc/image_legacy.cpp):
# 24-bit PCX, run-length SGI, IM, run-length Sun raster, XPM; besides,
# decode timing only: DCX, MSP, XBM, PIXAR, SPIDER, FITS (BITPIX 8 and 16),
# GBR, McIdas, XV thumbnail, IMT, IPTC and FLC files, and a Photo CD image
# and a 2048x2048 PCX made here (legacy_big).
LEGACY_DIR = os.path.join(REPO, "tests", "goldens", "legacy")
LEGACY_MAPS = ("basecolor.pcx", "normal.sgi", "roughness.im", "metalness.ras", "emissive.xpm")
LEGACY_EXTRA = ("pages.dcx", "paint.msp", "mask.xbm", "image.pxr", "density.spi", "plate8.fits",
                "plate16.fits", "brush.gbr", "area.mcidas", "thumb.xv", "tools.imt", "photo.iim",
                "anim.flc")
# And as JPEG 2000 (csrc/image_jpeg2000.cpp): a 9/7 ICT JP2 in 128-px tiles
# with 3 layers, a 5/3 RCT raw codestream in RPCL with precincts, a grey
# JP2, a signed raw codestream in PCRL, an RGBA JP2 in CPRL with PLT;
# besides, decode timing only: a 2048x2048 9/7 JP2 of 3 layers and 5
# resolution levels (tools/make_jpeg2000_fixtures.py).
JPEG2000_DIR = os.path.join(REPO, "tests", "goldens", "jpeg2000")
JPEG2000_MAPS = ("basecolor.jp2", "normal.j2k", "roughness.jp2", "metalness.j2k", "emissive.jp2")
JPEG2000_BIG = ("big.jp2",)
# And as AVIF (csrc/image_avif.cpp, av1_decode.cpp, av1_recon.cpp): 4:2:0 at
# PIL's defaults, 4:4:4 in 2x2 tiles with CDEF and loop restoration, screen
# content with palettes and intra block copy, quantizer matrices with delta
# q, RGBA with an alpha item; besides, decode timing only: a 2048x2048
# 4:2:0 map at quality 75 (tools/make_avif_fixtures.py).
AVIF_DIR = os.path.join(REPO, "tests", "goldens", "avif")
AVIF_MAPS = ("basecolor.avif", "normal.avif", "roughness.avif", "metalness.avif", "emissive.avif")
AVIF_BIG = ("big.avif",)
# And at 10 and 12 bits (tests/goldens/avif/deep/, written through OpenCV's
# libavif): 4:2:0 at 10 bits, 4:4:4 at 12 in 2x2 tiles with CDEF, screen
# content at 10, grey at 12, RGBA at 10 with an alpha item; besides, decode
# timing only: a 2048x2048 10-bit 4:2:0 map at quality 75.
AVIF10_MAPS = tuple("deep/" + name for name in AVIF_MAPS)
AVIF10_BIG = ("deep/big10.avif",)
# And as TIFF kinds (csrc/image_tiff.cpp, image_xz.cpp, image_zstd.cpp):
# JPEG YCbCr 2x2, ZSTD with predictor 2, float LZMA with the floating-point
# predictor, CCITT Group 4, YCbCr 2x1; besides, decode timing only:
# 2048x2048 float (deflate, floating-point predictor), JPEG, LZMA and ZSTD
# TIFFs (tools/make_tiffkinds_fixtures.py).
TIFFKINDS_DIR = os.path.join(REPO, "tests", "goldens", "tiffkinds")
TIFFKINDS_MAPS = ("basecolor.tif", "normal.tif", "roughness.tif", "metalness.tif",
                  "emissive.tif")
TIFFKINDS_BIG = ("big_float.tif", "big_jpeg.tif", "big_lzma.tif", "big_zstd.tif")
# And the kinds that the port once refused (tools/make_kind_fixtures.py):
# IM YCC, RGB3, RYB3, B2 and B4, IPTC holding PNG, BMP, TIFF, GIF and WebP
# streams (two in a band), JP2 palettes of one and two columns; each held
# to its uint8 RGBA in expected.npz (tracy_tpu's, the format's for the
# palettes, which tracy_tpu turns black).
KINDS_DIR = os.path.join(REPO, "tests", "goldens", "kinds")
# grid64x28-dds's maps: slot name, DXGI block format, sRGB.
DDS_GRID_MAPS = (("B", "BC7", True), ("N", "BC5", False), ("R", "BC4", False),
                 ("M", "BC4", False), ("E", "BC7", True))


def random_dds(size: int, fmt: str, seed: int) -> bytes:
    """A size x size DDS file of random blocks from `seed`: a DX10 header
    naming DXGI BC4, BC5 or BC7 UNORM, then the blocks (BC7's first byte
    set to one of its eight modes)."""
    dxgi, block = {"BC4": (80, 8), "BC5": (83, 16), "BC7": (98, 16)}[fmt]
    rng = np.random.default_rng(seed)
    n = (size // 4) ** 2
    data = rng.integers(0, 256, (n, block), dtype=np.uint8)
    if fmt == "BC7":
        data[:, 0] = ((data[:, 0] | 1) << rng.integers(0, 8, n)).astype(np.uint8)
    pf = struct.pack("<II4sI4I", 32, 0x4, b"DX10", 0, 0, 0, 0, 0)
    head = (struct.pack("<7I", 124, 0x81007, size, size, n * block, 0, 0) + bytes(44) + pf
            + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    return b"DDS " + head + struct.pack("<5I", dxgi, 3, 0, 1, 0) + data.tobytes()


def big_pcx(size: int, seed: int):
    """(a size x size 24-bit PCX file, its RGB [size, size, 3]) from `seed`:
    each row's three planes as 64 pieces of a 48-byte run of a random value
    (one packet, 0xF0 v) and 48 random literal bytes below 0xC0."""
    rng = np.random.default_rng(seed)
    pieces = 3 * size // 96
    vals = rng.integers(0, 256, (size, pieces, 1), dtype=np.uint8)
    lits = rng.integers(0, 0xC0, (size, pieces, 48), dtype=np.uint8)
    coded = np.concatenate([np.full_like(vals, 0xC0 | 48), vals, lits], axis=2)
    rows = np.concatenate([np.repeat(vals, 48, axis=2), lits], axis=2).reshape(size, 3, size)
    head = struct.pack("<BBBBHHHHHH", 10, 5, 1, 8, 0, 0, size - 1, size - 1, 72, 72)
    head += bytes(49) + bytes([3]) + struct.pack("<HH", size, 1)
    return head.ljust(128, b"\0") + coded.tobytes(), rows.transpose(0, 2, 1)


def random_pcd(seed: int, orientation: int) -> bytes:
    """A Kodak Photo CD file (786,432 bytes) of random luma and chroma from
    `seed`: the 768x512 base image at 96 x 2048, each pair of rows Y, Y,
    C1, C2; the orientation byte at 2048 + 1538."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    return bytes(head) + np.random.default_rng(seed).integers(0, 256, 256 * 2304,
                                                              dtype=np.uint8).tobytes()


def kind_files(res, card):
    """Each file of KINDS_DIR decoded on the host and held to its recorded
    RGBA, bit for bit."""
    from tracy_tpu_torch.utils.image_io import decode_image_rgba

    expected = np.load(os.path.join(KINDS_DIR, "expected.npz"))
    for name in sorted(expected.files):
        with open(os.path.join(KINDS_DIR, name), "rb") as f:
            data = f.read()
        t0 = time.perf_counter()
        rgba = decode_image_rgba(data)
        secs = time.perf_counter() - t0
        if not np.array_equal(rgba, expected[name]):
            raise RuntimeError(f"{name} decoded to another picture than its recorded RGBA")
        res[f"decode_s {name}"] = secs
    total = sum(res[f"decode_s {n}"] for n in expected.files)
    print(f"decode the {len(expected.files)} files of tests/goldens/kinds "
          f"({', '.join(sorted(expected.files))}) on this card's host {card}: each equal to its "
          f"recorded RGBA, {total:.4f} s together")


def legacy_big(res, card):
    """The 2048x2048 PCX and the Photo CD image, decoded and timed on the
    host: the PCX equal to the picture it was made from, the Photo CD's
    orientation 1 equal to its orientation 0 turned by 90 degrees."""
    from tracy_tpu_torch.utils.image_io import decode_image_rgba

    data, want = big_pcx(MAP_SIZE, SEED)
    t0 = time.perf_counter()
    rgba = decode_image_rgba(data)
    img = rgba.astype(np.float32) / 255.0
    secs = time.perf_counter() - t0
    if not np.array_equal(rgba[..., :3], want) or (rgba[..., 3] != 255).any() or img.max() > 1:
        raise RuntimeError("the 2048x2048 PCX decoded to another picture")
    res[f"decode_s big_pcx {MAP_SIZE}"] = secs
    print(f"decode big.pcx ({MAP_SIZE}x{MAP_SIZE} 24-bit, {len(data)} bytes, made here) with "
          f"the float conversion on this card's host {card}: {secs:.4f} s; equal to its picture")
    flat = decode_image_rgba(random_pcd(SEED, 0))
    t0 = time.perf_counter()
    rgba = decode_image_rgba(random_pcd(SEED, 1))
    img = rgba.astype(np.float32) / 255.0
    secs = time.perf_counter() - t0
    if rgba.shape != (768, 512, 4) or not np.array_equal(rgba, np.rot90(flat)) or img.std() == 0:
        raise RuntimeError("the Photo CD image's orientation 1 is not its orientation 0 turned")
    res["decode_s photo.pcd"] = secs
    print(f"decode photo.pcd (768x512 PhotoYCC turned to 512x768, made here) with the float "
          f"conversion on this card's host {card}: {secs:.4f} s")


def fixture_gate(directory, scn, counts, dev, card):
    """One image-texture fixture scene (`scn` in `directory`, beside its
    tracy_tpu CPU render of the same name, .npz) loaded with no fallback,
    rendered at its 256x192 for 24 frames through K1 + K4 and held against
    the render by the block-mean contract; its basecolor AOV through K1 +
    K3, frame 0 equal to the plain versions' on the card. Returns
    ({path: launches}, results)."""
    from tracy_tpu_torch import RenderConfig
    from tracy_tpu_torch.ops import intersect as k1
    from tracy_tpu_torch.ops import texfetch as k3
    from tracy_tpu_torch.render.renderer import Renderer, init_state, sample_radiance_rows
    from tracy_tpu_torch.scene import load_scene
    from tracy_tpu_torch.utils import parity

    res, launches = {}, {}
    b = load_scene(os.path.join(directory, scn))
    if b.fallbacks:
        raise RuntimeError(f"{scn} substituted files: {b.fallbacks}")
    fscene = b.build(device=dev)
    res["atlas_bytes"] = fscene.tex_data.numel() * 4
    gcfg = RenderConfig(width=b.width, height=b.height, spp=1)
    gr = Renderer(gcfg)
    reset(counts)
    gst, _ = gr.step_many(fscene, init_state(gcfg, dev), 24)
    launches[f"fixture {scn} 24 frames"] = check_launches(
        f"{scn} render", counts, {"K1": 24 * gcfg.max_bounces, "K4": 24 * gcfg.max_bounces})
    ours = np.clip(gr.display(gst) * 255.99, 0.0, 255.0)
    ours = parity.srgb_to_linear(ours / 255.99)[::-1]
    golden = os.path.splitext(scn)[0] + ".npz"
    ref = parity.load_golden(os.path.join(directory, golden))
    dmean, p95, dmax = parity.compare(ref, ours)
    res["gate"] = [dmean, p95, dmax]
    print(f"{scn} {b.width}x{b.height} ({gr.path}) {card}, {len(b.atlas)} maps, atlas "
          f"{res['atlas_bytes']} bytes on the card, 24 frames vs tracy_tpu's CPU render "
          f"({golden}): mean diff {dmean:.5f} (<= 0.01), block p95 {p95:.5f} (<= 0.02), "
          f"block max {dmax:.5f} (<= 0.05); no fallback")
    if dmean > 0.01 or p95 > 0.02 or dmax > 0.05:
        raise RuntimeError(f"{scn} parity failed")

    acfg = gcfg.replace(aov="basecolor", tonemap="none")
    arend = Renderer(acfg)
    reset(counts)
    ast, _ = arend.step_many(fscene, init_state(acfg, dev), 4)
    launches[f"fixture {scn} basecolor AOV 4 frames"] = check_launches(
        f"{scn} basecolor AOV", counts, {"K1": 4, "K3": 4})
    first, _ = arend.step_many(fscene, init_state(acfg, dev), 1)
    aref, _ = sample_radiance_rows(
        fscene, acfg, 0, lambda o, d, a: k1.intersect_plain(o, d, a, arend.tables),
        fetch_fn=k3.fetch_texels_plain)
    if not torch.equal(first.accum, aref) or float(first.accum.std()) == 0.0:
        raise RuntimeError(f"{scn}'s basecolor AOV differs from the plain versions' or is flat")
    print(f"{scn} basecolor AOV ({arend.path}): K1 and K3 once a frame, frame 0 equal "
          f"to the plain versions' bit for bit; image std {float(ast.accum.std()):.4f}")
    return launches, res


def image_phase(ccfg, counts, dev, card):
    """16. Image textures on the card's machine, with PIL blocked (main()
    blocks it before any phase): each map's decode seconds on the host
    (csrc/image_decode.cpp, image_formats.cpp, image_tiff.cpp,
    image_blocks.cpp, image_webp.cpp, image_containers.cpp,
    image_legacy.cpp, image_jpeg2000.cpp and image_avif.cpp with
    av1_decode.cpp and av1_recon.cpp, image_xz.cpp and image_zstd.cpp,
    built by g++), the JPEG/PNG
    fixture's, the TGA/BMP/GIF/PGM/PSD fixture's, the DDS/TIFF/QOI
    fixture's, the WebP fixture's and the two 2048x2048 WebP maps', the
    CMYK/4:1:1 JPEG, ICO, BLP and ICNS fixture's with the 2048x2048 CMYK
    JPEG and the YCCK, CUR, DIB, FTEX and BLP2 files, the
    PCX/SGI/IM/Sun/XPM fixture's with its thirteen files of PIL's other
    small formats, a 2048x2048 PCX and a Photo CD image (`legacy_big`), the
    small files of the kinds the port once refused (`kind_files`, each
    held to its recorded RGBA), the
    JPEG 2000 fixture's with its 2048x2048 9/7 JP2, the AVIF fixture's
    with its 2048x2048 4:2:0 map, the 10- and 12-bit AVIF fixture's with
    its 2048x2048 10-bit map, and the TIFF-kind fixture's (image_tiff.cpp
    with image_xz.cpp and image_zstd.cpp) with its 2048x2048 float, JPEG,
    LZMA and ZSTD TIFFs;
    each fixture scene through `fixture_gate` (K1 + K4 against tracy_tpu's
    CPU render, its basecolor AOV through K1 + K3 against the plain
    versions);
    grid64x28 with the JPEG/PNG fixture's maps in place of the numpy maps,
    and grid64x28-dds with 2048x2048 DDS maps of random blocks decoded
    here, each 1080p compacted, 4 frames, timed (beside-numbers). Returns
    ({path: launches}, results)."""
    from tracy_tpu_torch.render.renderer import Renderer, init_state
    from tracy_tpu_torch.scene.scene import (
        TEX_BASECOLOR, TEX_EMISSIVE, TEX_METALNESS, TEX_NORMAL, TEX_ROUGHNESS)
    from tracy_tpu_torch.scene.textures import load_image_rgba
    from tracy_tpu_torch.utils.image_io import decode_image_rgba

    res, launches = {}, {}
    decoded = {}
    maps = [(FIXTURE_DIR, name) for name, _, _ in FIXTURE_MAPS]
    for directory, name in (maps + [(FORMATS_DIR, name) for name in FORMAT_MAPS]
                            + [(TIFFDDS_DIR, name) for name in TIFFDDS_MAPS]
                            + [(WEBP_DIR, name) for name in WEBP_MAPS + WEBP_BIG]
                            + [(CONTAINERS_DIR, name)
                               for name in CONTAINER_MAPS + CONTAINER_EXTRA]
                            + [(LEGACY_DIR, name) for name in LEGACY_MAPS + LEGACY_EXTRA]
                            + [(JPEG2000_DIR, name) for name in JPEG2000_MAPS + JPEG2000_BIG]
                            + [(AVIF_DIR, name) for name in AVIF_MAPS + AVIF_BIG]
                            + [(AVIF_DIR, name) for name in AVIF10_MAPS + AVIF10_BIG]
                            + [(TIFFKINDS_DIR, name) for name in TIFFKINDS_MAPS + TIFFKINDS_BIG]):
        t0 = time.perf_counter()
        img = load_image_rgba(os.path.join(directory, name))
        secs = time.perf_counter() - t0
        if img is None or img.shape[-1] != 4 or not np.isfinite(img).all():
            raise RuntimeError(f"map {name} did not decode")
        decoded[name] = img
        res[f"decode_s {name}"] = secs
        print(f"decode {name} ({img.shape[1]}x{img.shape[0]}) on this card's host {card}: "
              f"{secs:.4f} s")
    legacy_big(res, card)
    kind_files(res, card)

    for directory, scn in ((FIXTURE_DIR, "textured.scn"), (FORMATS_DIR, "formats.scn"),
                           (TIFFDDS_DIR, "tiffdds.scn"), (WEBP_DIR, "webp.scn"),
                           (CONTAINERS_DIR, "containers.scn"), (LEGACY_DIR, "legacy.scn"),
                           (JPEG2000_DIR, "jpeg2000.scn"), (AVIF_DIR, "avif.scn"),
                           (os.path.join(AVIF_DIR, "deep"), "avif10.scn"),
                           (TIFFKINDS_DIR, "tiffkinds.scn")):
        more, gate = fixture_gate(directory, scn, counts, dev, card)
        launches.update(more)
        res[scn] = gate

    slots = {"B": TEX_BASECOLOR, "N": TEX_NORMAL, "R": TEX_ROUGHNESS, "M": TEX_METALNESS,
             "E": TEX_EMISSIVE}

    def grid_path(label, grid_maps):
        """grid64x28 with grid_maps ({slot: (float RGBA, srgb)}), 1080p
        compacted, FRAMES frames, 3 timed runs: K1 and K4 once a bounce."""
        t0 = time.perf_counter()
        jb = textured_grid(WIDTH, HEIGHT, maps=grid_maps, name=label)
        jscene = jb.build(device=dev)
        jrend = Renderer(ccfg)
        jrend.step_many(jscene, init_state(ccfg, dev), 1)
        setup = time.perf_counter() - t0
        rates = []
        for _ in range(3):
            jrend.reset(dev)
            reset(counts)
            jst, nrays = jrend.step_many(jscene, init_state(ccfg, dev), FRAMES)
            rates.append(jrend.mrays_per_sec)
        launches[f"{label} compacted"] = check_launches(
            label, counts, {"K1": FRAMES * ccfg.max_bounces, "K4": FRAMES * ccfg.max_bounces})
        if not torch.isfinite(jst.accum).all():
            raise RuntimeError(f"{label}: non-finite image")
        r_ = sorted(rates)
        res[f"{label} MRays/s"] = r_
        return r_, nrays, setup, jscene.tex_data.numel() * 4

    r_, nrays, setup, atlas = grid_path("grid64x28-jpeg", {
        slots[slot]: (decoded[name], srgb) for name, slot, srgb in FIXTURE_MAPS})
    print(f"grid64x28-jpeg (grid64x28 with the fixture's decoded maps), 1920x1080 compacted, "
          f"{FRAMES} frames {card}: MRays/s median {r_[1]:.2f} (min {r_[0]:.2f}, max "
          f"{r_[2]:.2f}) over 3 runs, {nrays} rays; set-up {setup:.1f} s, atlas "
          f"{atlas} bytes; no gain claimed")

    dds_maps = {}
    for k, (slot, fmt, srgb) in enumerate(DDS_GRID_MAPS):
        data = random_dds(MAP_SIZE, fmt, SEED + k)
        t0 = time.perf_counter()
        img = decode_image_rgba(data).astype(np.float32) / 255.0
        secs = time.perf_counter() - t0
        res[f"decode_s grid64x28-dds {slot} {fmt}"] = secs
        print(f"decode grid64x28-dds {slot} map ({MAP_SIZE}x{MAP_SIZE} {fmt}, {len(data)} "
              f"bytes) on this card's host {card}: {secs:.4f} s")
        dds_maps[slots[slot]] = (img, srgb)
    r_, nrays, setup, atlas = grid_path("grid64x28-dds", dds_maps)
    print(f"grid64x28-dds (grid64x28 with 2048x2048 BC7/BC5/BC4 maps decoded here), 1920x1080 "
          f"compacted, {FRAMES} frames {card}: MRays/s median {r_[1]:.2f} (min {r_[0]:.2f}, "
          f"max {r_[2]:.2f}) over 3 runs, {nrays} rays; set-up {setup:.1f} s, atlas "
          f"{atlas} bytes; no gain claimed")
    return launches, res


def material_grid(n: int, textured: bool, width: int, height: int, seed: int):
    """n boxes in a grid before the camera, each with its own material
    (random albedo, roughness, metalness); textured: five 4x4 maps a
    material (basecolor and emissive sRGB). A constant sky. Returns the
    builder."""
    from tracy_tpu_torch.scene import SceneBuilder

    b = SceneBuilder(width, height, f"materials{n}{'-tex' if textured else ''}")
    b.set_sky_color((0.7, 0.8, 1.0))
    rng = np.random.default_rng(seed)
    cols = int(np.ceil(np.sqrt(n * width / height)))
    rows = -(-n // cols)
    for i in range(n):
        m = b.add_material(tuple(rng.uniform(0.1, 0.9, 3)), roughness=float(rng.uniform(0.2, 1)),
                           metalness=float(rng.uniform() < 0.3))
        if textured:
            for slot in range(5):
                hi = 0.2 if slot == 4 else 1.0  # dim emissive
                img = rng.uniform(0.0, hi, (4, 4, 4)).astype(np.float32)
                b.set_material_texture(m, slot, b.add_texture(img, srgb=slot in (0, 4)))
        x, y = i % cols, i // cols
        b.add_box((x - cols / 2, y - rows / 2, -0.4), (x - cols / 2 + 0.8, y - rows / 2 + 0.8, 0.4),
                  m)
    b.set_camera((0.0, 0.0, 1.2 * max(cols, rows)), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 60.0)
    return b


# The many-material scenes of the table-route phase: (materials, textured).
# 520 textured materials put K3's tables (52,000 bytes) past the 48 KB
# default, so each kernel meets the global route on these scenes and the
# shared one on the main path's.
ROUTE_SCENES = ((2000, False), (8000, False), (520, True), (3000, True))


def route_phase(wave, ccfg, small, counts, dev, card):
    """17. The table routes of K2, K3 and K4 (ops/launch.py): scenes whose
    tables land in each route. At the 1080p canned wave each kernel is held
    against its plain version bit for bit on every route that holds its
    tables (the main path's tables, `small`, on 'shared' and 'global';
    each scene's, beyond 48 KB, on 'global'), and timed on each, in
    turns. small: the main path's (untextured, textured) scenes.
    Then the largest untextured scene renders two-stage
    (K1 + K2) and fused (K5), compacted, and the largest textured one
    (K1 + K4) compacted and uncompacted: each path's accumulator must equal
    the others'. Returns ({path: launches}, results)."""
    from tracy_tpu_torch.ops import compare
    from tracy_tpu_torch.ops import shade as k2
    from tracy_tpu_torch.ops import texfetch as k3
    from tracy_tpu_torch.ops.launch import SMEM_DEFAULT, table_route
    from tracy_tpu_torch.render.renderer import Renderer, init_state

    kw = dict(seed=SEED, russian_roulette=True)
    res = {"checks": {}, "ms": {}}
    scenes = {}
    t0 = time.perf_counter()
    for n, textured in ROUTE_SCENES:
        b = material_grid(n, textured, WIDTH, HEIGHT, seed=SEED + n)
        scenes[b.name] = b.build(device=dev)
    print(f"route scenes built in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} ({v.materials.albedo.shape[0]} materials, {v.tex_table.shape[0]} "
                      f"textures)" for k, v in scenes.items()))

    def tables_of(kern, sc):
        m, t = sc.materials.albedo.shape[0], sc.tex_table.shape[0]
        return {"K2": 4 * k2.MTAB_COLS * m, "K3": k3.table_bytes(m, t),
                "K4": 4 * k2.MTAB_TEX_COLS * m + k3.table_bytes(m, t)}[kern]

    # (kernel, scene name, scene, table bytes, route): every route that
    # holds the kernel's tables.
    subjects = [("K2", "main path", small[0]), ("K3", "main path", small[1]),
                ("K4", "main path", small[1])]
    for sname, sc in scenes.items():
        subjects += [(k, sname, sc) for k in (("K3", "K4") if "-tex" in sname else ("K2",))]
    jobs = []
    for kern, sname, sc in subjects:
        nbytes = tables_of(kern, sc)
        for route in ("shared", "global"):
            if route == "global" or nbytes <= SMEM_DEFAULT:
                jobs.append((kern, sname, sc, nbytes, route))

    def run(kern, sc, lanes, route):
        """One launch on fresh copies of the lanes' state; its outputs."""
        tex = (sc.tex_data, sc.tex_table, sc.materials.tex_index)
        if kern == "K2":
            return k2.shade(*compare.state_args(lanes, compare.SHADE_ARGS),
                            k2.build_material_table(sc.materials), 3, 1, route=route, **kw)
        if kern == "K3":
            return (k3.fetch_texels(*(lanes[k] for k in compare.TEXFETCH_ARGS), *tex,
                                    route=route),)
        return k2.shade_textured(*compare.textured_args(lanes),
                                 k2.build_material_table_tex(sc.materials), *tex, 3, 1,
                                 route=route, **kw)

    # Against the plain version on each route: K2 bit for bit; K3 and K4
    # by K3's contract (hit lanes bit for bit; a sky lane may address
    # another texel, <= 1e-4 of lanes), which is bit for bit where the sky
    # is not textured (the route scenes). And the routes bit for bit
    # against each other.
    lane_cache, outs = {}, {}
    for kern, sname, sc, nbytes, route in jobs:
        m = sc.materials.albedo.shape[0]
        key = (sname, kern == "K2")
        if key not in lane_cache:
            lane_cache[key] = (compare.canned_lanes(m, wave, seed=21, device=dev) if kern == "K2"
                               else compare.textured_lanes(m, wave, seed=22, device=dev))
        lanes = lane_cache[key]
        if kern == "K2":
            c = compare.compare_shade(lanes, k2.build_material_table(sc.materials), 3, 1,
                                      route=route, **kw)
            equal = c["bit_equal"]
            ok = equal
        elif kern == "K3":
            c = compare.compare_texfetch(lanes, sc, route=route)
            equal = c["max_abs_err"] == 0.0
            ok = equal or sname == "main path"  # compare_texfetch raised on a broken contract
        else:
            c = compare.compare_shade_textured(lanes, sc, k2.build_material_table_tex(sc.materials),
                                               3, 1, route=route, **kw)
            equal = c["bit_equal"]
            ok = equal or (sname == "main path" and not c["hit_lanes_differing"]
                           and c["lanes_differing"] <= 1e-4 * wave)
        label = f"{kern} {sname} {route}"
        res["checks"][label] = {"bytes": nbytes, "equal_to_plain": bool(equal),
                                "picked": table_route(nbytes),
                                "max_abs_err": c["max_abs_err"], "bound_ms": c["bound_ms"]}
        if not ok:
            raise RuntimeError(f"{label}: the kernel differs from its plain version: {c}")
        got = run(kern, sc, lanes, route)
        first = outs.setdefault((kern, sname), (route, got))
        if not all(torch.equal(a, b) for a, b in zip(first[1], got)):
            raise RuntimeError(f"{kern} {sname}: route {route} differs from route {first[0]}")
    outs.clear()
    # Time each (kernel, scene) on each of its routes, in turns (a, b, b, a).
    for kern, sname, sc, nbytes, _ in jobs:
        label = f"{kern} {sname}"
        if label in res["ms"]:
            continue
        mine = [j[4] for j in jobs if j[0] == kern and j[1] == sname]
        order = mine + mine[::-1]
        lanes = lane_cache[(sname, kern == "K2")]
        tex = (sc.tex_data, sc.tex_table, sc.materials.tex_index)
        times = {r: [] for r in mine}
        for route in order:
            if kern == "K2":
                mtab = k2.build_material_table(sc.materials)
                t = compare.inplace_ms(lambda a: k2.shade(*a, mtab, 3, 1, route=route, **kw),
                                       lanes, 20, compare.SHADE_ARGS)
            elif kern == "K3":
                fargs = [lanes[k] for k in compare.TEXFETCH_ARGS]
                t = compare.cuda_ms(lambda: k3.fetch_texels(*fargs, *tex, route=route), 20)
            else:
                mtab = k2.build_material_table_tex(sc.materials)
                t = compare.inplace_ms(
                    lambda a: k2.shade_textured(*a, mtab, *tex, 3, 1, route=route, **kw),
                    lanes, 20)
            times[route].append(t)
        res["ms"][label] = {r: sum(v) / len(v) for r, v in times.items()}
        res["ms"][label]["bytes"] = nbytes
    print(f"table routes at the {wave}-lane 1080p canned wave {card}; on every route each "
          f"kernel equals its plain version "
          f"(K2 bit for bit; K3 and K4 bit for bit but for the main path's textured-sky lanes, "
          f"K3's contract) and its other routes bit for bit; ms, in turns:")
    for label, t in res["ms"].items():
        picked = table_route(t["bytes"])
        print(f"  {label} ({t['bytes']} bytes of tables, table_route picks {picked}): "
              + ", ".join(f"{r} {v:.4f} ms" for r, v in t.items() if r != "bytes"))

    launches = {}
    big = f"materials{max(n for n, tex in ROUTE_SCENES if not tex)}"
    big_tex = f"materials{max(n for n, tex in ROUTE_SCENES if tex)}-tex"
    accum = {}
    for pname, sname, pcfg, want in (
            (f"{big} compacted", big, ccfg, ("K1", "K2")),
            (f"{big} fused", big, ccfg.replace(use_pallas_bounce=True), ("K5",)),
            (f"{big_tex} compacted", big_tex, ccfg, ("K1", "K4")),
            (big_tex, big_tex, ccfg.replace(wave_compact_group=0), ("K1", "K4"))):
        rend = Renderer(pcfg)
        reset(counts)
        st, nrays = rend.step_many(scenes[sname], init_state(pcfg, dev), 2)
        launches[pname] = check_launches(pname, counts, {k: 2 * pcfg.max_bounces for k in want})
        routes = {k: dict(counts[k].routes) for k in ("K2", "K4") if counts[k].kernel}
        accum[pname] = st.accum
        print(f"  {pname} ({rend.path}), {pcfg.width}x{pcfg.height}, 2 frames: {nrays} rays, "
              f"launches " + ", ".join(f"{k} {v}" for k, v in launches[pname].items() if v)
              + f", table routes {routes}; image mean {float(st.accum.mean()):.4f}")
        if not torch.isfinite(st.accum).all():
            raise RuntimeError(f"{pname}: non-finite image")
    for a, b_ in ((f"{big} compacted", f"{big} fused"), (f"{big_tex} compacted", big_tex)):
        if not torch.equal(accum[a], accum[b_]):
            raise RuntimeError(f"{a} and {b_} accumulators differ")
    print(f"  accumulators equal: {big} two-stage = fused (K5 reads its table from global "
          f"memory, unchanged), {big_tex} compacted = uncompacted")
    return launches, res


def mesh_run(step, copies, state, frames):
    """`frames` sharded steps from `state`; (state, rays, host seconds to
    the end of the device's work)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rays = 0
    for _ in range(frames):
        state, r = step(copies, state)
        rays = rays + r
    torch.cuda.synchronize()
    return state, int(rays), time.perf_counter() - t0


def mesh_phase(scene, tscene, ccfg, rends, accum, rays_of, counts, dev, card):
    """15. The ('data', 'sample') mesh (tracy_tpu_torch/parallel) at 1080p:
    (a) in-process meshes on this card, compacted, FRAMES frames: 1x1 and
    4x1 at spp 1 equal Renderer.step_many's accumulator and rays bit for
    bit, 2x2 at spp 2 the single-device spp-2 frames within atol 3e-6,
    rtol 1e-5, launching K1 and K2 alone; 4x1 against the single-device
    path, REPEATS runs each in turn; (b) grid64x28-tex at 2x1, 1 frame,
    K1 and K4, equal bit for bit; (c) 4x1 for 2 frames, saved, resumed
    under 2x1 for 2 more, equal to the uninterrupted 4x1 run bit for bit;
    (d) two processes over gloo on this card, mesh 2x1: host_rows disjoint
    and covering, 2 compacted 1080p frames equal to one process bit for
    bit, and one sharded "materials" step at 640x480 whose gradients lie
    within 1e-4 of the largest entry of the single-process gradient on the
    card; (e) render_cli -mesh 2x2 -spp 2 on spheres.scn at 1080p, and a
    -checkpoint run under -mesh 4x1 for 8 frames resumed under -mesh 2x1
    to 16, equal bit for bit to phase 14's uninterrupted 16 frames.
    Returns {path: launches} and the figures."""
    from tracy_tpu_torch.parallel import (
        make_render_mesh, make_sharded_render_step, replicate_scene)
    from tracy_tpu_torch.render.renderer import Renderer, init_state
    from tracy_tpu_torch.utils.checkpoint import load_render_state, save_render_state

    launches, out = {}, {}
    head = "grid64x28 compacted"
    bounces = ccfg.max_bounces

    def sharded(cfg, nd, ns, sc):
        mesh = make_render_mesh(nd, ns, devices=[dev] * (nd * ns))
        return mesh, make_sharded_render_step(cfg, mesh), replicate_scene(sc, mesh)

    # (a) 1x1, 4x1 and 2x2 at spp 2.
    cfg2 = ccfg.replace(spp=2)
    ref2, rays2 = Renderer(cfg2).step_many(scene, init_state(cfg2, dev), FRAMES)
    steps = {}
    for label, cfg, nd, ns, ref, ref_rays in (
            ("mesh 1x1", ccfg, 1, 1, accum[head], rays_of[head]),
            ("mesh 4x1", ccfg, 4, 1, accum[head], rays_of[head]),
            ("mesh 2x2 spp 2", cfg2, 2, 2, ref2.accum, rays2)):
        mesh, step, copies = sharded(cfg, nd, ns, scene)
        steps[label] = (step, copies, cfg)
        mesh_run(step, copies, init_state(cfg, dev), 1)  # binds the stages
        reset(counts)
        st, rays, secs = mesh_run(step, copies, init_state(cfg, dev), FRAMES)
        want = nd * ns * FRAMES * bounces * (cfg.spp // ns)
        launches[label] = check_launches(label, counts, {"K1": want, "K2": want})
        if ns == 1:
            same = bool(torch.equal(st.accum, ref))
            err = 0.0
        else:
            err = float(((st.accum - ref).abs() - 1e-5 * ref.abs()).max())
            same = err <= 3e-6
        print(f"{label} on {dev} (group {cfg.wave_compact_group}, spp {cfg.spp}), {FRAMES} "
              f"frames: {rays} rays (single device {ref_rays}); "
              + ("equal to Renderer.step_many bit for bit" if ns == 1 else
                 "within atol 3e-6 + rtol 1e-5 of the single-device frames (excess "
                 f"{err:.3g})")
              + f": {same}; launches K1 {launches[label]['K1']}, K2 {launches[label]['K2']}, "
              f"others 0, plain 0; {rays / 1e6 / secs:.2f} MRays/s {card}")
        if not same or rays != ref_rays:
            raise RuntimeError(f"{label} differs from the single-device render")
        out[label] = st
    rates = {"mesh 4x1": [], head: []}
    step, copies, _ = steps["mesh 4x1"]
    rend = rends[head]
    for _ in range(REPEATS):
        rend.reset(dev)
        rend.step_many(scene, init_state(ccfg, dev), FRAMES)
        rates[head].append(rend.mrays_per_sec)
        _, rays, secs = mesh_run(step, copies, init_state(ccfg, dev), FRAMES)
        rates["mesh 4x1"].append(rays / 1e6 / secs)
    summary = {}
    for label, r_ in rates.items():
        r_ = sorted(r_)
        summary[label] = {"median": r_[len(r_) // 2], "min": r_[0], "max": r_[-1]}
        print(f"{label}: MRays/s over {REPEATS} runs of {FRAMES} frames in turn {card}: median "
              f"{r_[len(r_) // 2]:.2f}, min {r_[0]:.2f}, max {r_[-1]:.2f}")

    # (b) the textured scene at 2x1, one frame.
    _, tstep, tcopies = sharded(ccfg, 2, 1, tscene)
    ref_t, ref_trays = rends["grid64x28-tex compacted"].step_many(
        tscene, init_state(ccfg, dev), 1)
    mesh_run(tstep, tcopies, init_state(ccfg, dev), 1)
    reset(counts)
    st, rays, _ = mesh_run(tstep, tcopies, init_state(ccfg, dev), 1)
    want = 2 * bounces
    launches["mesh tex 2x1"] = check_launches("mesh tex 2x1", counts, {"K1": want, "K4": want})
    same = bool(torch.equal(st.accum, ref_t.accum)) and rays == ref_trays
    print(f"mesh tex 2x1, grid64x28-tex, 1 frame: equal to Renderer.step_many bit for bit "
          f"(rays {rays} vs {ref_trays}): {same}; launches K1 {want}, K4 {want}, others 0")
    if not same:
        raise RuntimeError("the textured 2x1 mesh differs from the single-device frame")

    # (c) elastic: 4x1 for 2 frames, saved, resumed under 2x1.
    os.makedirs(SMOKE_DIR, exist_ok=True)
    path = os.path.join(SMOKE_DIR, "mesh_elastic.npz")
    half = FRAMES // 2
    reset(counts)
    st, _, _ = mesh_run(step, copies, init_state(ccfg, dev), half)
    save_render_state(path, st)
    mesh_b, step_b, copies_b = sharded(ccfg, 2, 1, scene)
    st = load_render_state(path, mesh=mesh_b)
    st, _, _ = mesh_run(step_b, copies_b, st, FRAMES - half)
    want = (4 * half + 2 * (FRAMES - half)) * bounces
    launches["mesh elastic 4x1 then 2x1"] = check_launches(
        "mesh elastic", counts, {"K1": want, "K2": want})
    same = st.frame == FRAMES and bool(torch.equal(st.accum, out["mesh 4x1"].accum))
    print(f"mesh elastic: 4x1 for {half} frames -> {os.path.basename(path)} -> "
          f"load_render_state(mesh=2x1) -> {FRAMES - half} frames, equal to the uninterrupted "
          f"{FRAMES}-frame 4x1 run bit for bit: {same}")
    if not same:
        raise RuntimeError("the elastic resume differs from the uninterrupted run")

    # (d) two processes over gloo on this card.
    more, mp = two_process_check(scene, ccfg, rends[head], dev, card)
    launches.update(more)

    # (e) render_cli -mesh.
    entries = {}
    run_entry("render_cli -mesh 2x2 -spp 2 spheres.scn 1920x1080", "render_cli",
              ["-scene", SPHERES, "-width", "1920", "-height", "1080", "-mesh", "2x2", "-spp",
               "2", "-frames", "4", "-out", "mesh_spheres.png"], card, entries, (1080, 1920, 3))
    ck = os.path.join(SMOKE_DIR, "mesh_resume.npz")
    if os.path.exists(ck):
        os.remove(ck)
    every = ["-checkpoint", ck, "-checkpoint-every", "8"]
    run_entry("render_cli -mesh 4x1 -checkpoint 8 frames", "render_cli",
              ["-mesh", "4x1", "-frames", "8", "-out", "mesh_ck8.png"] + every, card, entries)
    log = run_entry("render_cli -mesh 2x1 -checkpoint resume to 16", "render_cli",
                    ["-mesh", "2x1", "-frames", "16", "-out", "mesh_ck16.png"] + every, card,
                    entries)
    with np.load(ck) as a, np.load(os.path.join(SMOKE_DIR, "straight.npz")) as b:
        same = (bool(np.array_equal(a["accum"], b["accum"]))
                and int(a["frame"]) == int(b["frame"]) == 16)
    print(f"render_cli mesh checkpoint: 4x1 for 8 frames, resumed under 2x1 ({'resumed' in log})"
          f" to 16, equal to phase 14's uninterrupted 16-frame run bit for bit: {same}")
    if not same or "resumed" not in log:
        raise RuntimeError("the CLI's mesh resume differs from the uninterrupted run")
    return launches, {"rates": summary, "two_process": mp, "entries": entries}


def two_process_check(scene, ccfg, rend, dev, card):
    """(d) of mesh_phase: this script as two gloo ranks on this card
    (mesh_worker), held against this process."""
    import socket

    from tracy_tpu_torch.diff import make_train_step
    from tracy_tpu_torch.parallel import make_render_mesh, make_sharded_train_step
    from tracy_tpu_torch.render.renderer import init_state

    os.makedirs(SMOKE_DIR, exist_ok=True)
    outp = os.path.join(SMOKE_DIR, "mesh_2proc.npz")
    if os.path.exists(outp):
        os.remove(outp)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = str(sk.getsockname()[1])
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-u", os.path.abspath(__file__), "--mesh-worker",
                               str(r), "2", port, outp], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    secs = time.perf_counter() - t0
    for r, (p, lg) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"mesh worker {r} exited {p.returncode}:\n{lg[-3000:]}")
    ref, ref_rays = rend.step_many(scene, init_state(ccfg, dev), 2)
    tcfg, tscene, isect, target = training_setup(dev)
    # One device (the reference), once more (its run-to-run spread), and the
    # 2x1 mesh in this process (the band split without the ranks).
    grads = []
    for mesh in (None, None, make_render_mesh(2, 1, devices=[dev, dev])):
        if mesh is None:
            step, params, opt = make_train_step(tscene, tcfg, optimizer=sgd_one,
                                                intersect_fn=isect)
        else:
            step, params, opt = make_sharded_train_step(tscene, tcfg, mesh, optimizer=sgd_one,
                                                        intersect_fn=isect)
        step(params, opt, target, 0)
        grads.append({n: p.grad.cpu().numpy() for n, p in zip(params._fields, params)
                      if p.grad is not None})

    def rel_err(a, b):
        """max |a - b| per leaf over the largest entry of b."""
        out = {}
        for n, g in b.items():
            d = float(np.abs(a[n] - g).max())
            out[n] = d / float(np.abs(g).max()) if d else 0.0
        return out

    with np.load(outp) as got:
        rows = [tuple(int(x) for x in got[f"rows{r}"]) for r in range(2)]
        covered = sorted(rows) == [(0, HEIGHT // 2), (HEIGHT // 2, HEIGHT)]
        same = (bool(np.array_equal(got["accum"], ref.accum.cpu().numpy()))
                and int(got["rays"]) == ref_rays)
        two = {k[2:]: got[k] for k in got.files if k.startswith("g_")}
        names_ok = sorted(two) == sorted(grads[0])
        rel = rel_err(two, grads[0]) if names_ok else {}
        launches = {f"mesh 2 processes, rank {r}": json.loads(str(got[f"launches{r}"]))
                    for r in range(2)}
    again, inproc = rel_err(grads[1], grads[0]), rel_err(grads[2], grads[0])
    print(f"mesh 2 processes over gloo on {dev}, 2x1 ({secs:.1f} s with start-up): host_rows "
          f"{rows} disjoint and covering: {covered}; 2 compacted 1080p frames equal to one "
          f"process bit for bit: {same}; one sharded 'materials' step {TRAIN_W}x{TRAIN_H}, "
          f"gradients vs one process on the card, max |difference| of the largest entry: "
          + ", ".join(f"{n} {v:.3g}" for n, v in rel.items())
          + f" (<= 1e-4); one process again: "
          + ", ".join(f"{n} {v:.3g}" for n, v in again.items())
          + "; the 2x1 mesh in one process: "
          + ", ".join(f"{n} {v:.3g}" for n, v in inproc.items())
          + f"; launches {launches} {card}")
    worst = max(rel.values()) if rel else 1.0
    if not (covered and same and names_ok and worst <= 1e-4):
        raise RuntimeError("the two-process mesh run differs from one process")
    return launches, {"seconds": secs, "rows": rows, "grad_rel": rel,
                      "grad_rel_one_process_again": again, "grad_rel_in_process_2x1": inproc}


def sgd_one(ps):
    return torch.optim.SGD(ps, lr=1.0)


def train_config():
    """tools/tpu_grad_bench.py's training configuration: 640x480, 1 spp, 5
    bounces, RR on, tonemap none, accel packet, BVH width 4,
    pick_compact_group(640*480)."""
    from tracy_tpu_torch import RenderConfig
    from tracy_tpu_torch.accel.reorder import pick_compact_group

    return RenderConfig(width=TRAIN_W, height=TRAIN_H, spp=1, max_bounces=5, tonemap="none",
                        accel="packet", russian_roulette=True, pallas_bvh_width=4,
                        wave_compact_group=pick_compact_group(TRAIN_W * TRAIN_H))


def render_config(group: int = 0):
    """The main path's configuration at 1920x1080, compaction group `group`."""
    from tracy_tpu_torch import RenderConfig

    return RenderConfig(width=WIDTH, height=HEIGHT, spp=1, max_bounces=5,
                        russian_roulette=True, tonemap="srgb", accel="packet", rng="fast",
                        wave_compact_group=group)


def training_setup(dev):
    """train_config() on grid64x28 at 640x480 (training_phase's): (cfg,
    scene, K1 intersector, target)."""
    from tracy_tpu_torch.diff import make_training_intersector
    from tracy_tpu_torch.scene import sphere_grid

    scene = sphere_grid(TRAIN_W, TRAIN_H, nsph=64, steps=28).build(device=dev)
    cfg = train_config()
    isect = make_training_intersector(scene, cfg, needs_geometry_grads=False)
    return cfg, scene, isect, torch.full((TRAIN_H, TRAIN_W, 3), 0.5, device=dev)


def main_cfg(dev):
    """The main path's compacted config and grid64x28 on `dev`."""
    from tracy_tpu_torch.accel.reorder import pick_compact_group
    from tracy_tpu_torch.scene import sphere_grid

    builder = sphere_grid(WIDTH, HEIGHT, nsph=64, steps=28)
    cfg = render_config(pick_compact_group(WIDTH * HEIGHT, num_tris=builder.num_triangles,
                                           has_translucent=builder.has_translucent))
    return cfg, builder.build(device=dev)


def mesh_worker(rank: int, nproc: int, port: str, outp: str) -> int:
    """One rank of mesh_phase (d): joins the gloo group on this card, checks
    nothing itself but that every row is owned once, renders 2 compacted
    1080p frames and takes one sharded SGD(1.0) "materials" step over the
    2x1 mesh; rank 0 writes the frame, the rays, both ranks' rows and
    launches, and the summed gradients."""
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from tracy_tpu_torch.ops import intersect as k1
    from tracy_tpu_torch.ops import shade as k2
    from tracy_tpu_torch.parallel import (
        make_render_mesh, make_sharded_render_step, make_sharded_train_step, replicate_scene)
    from tracy_tpu_torch.parallel.distributed import all_sum, host_rows, initialize_multihost
    from tracy_tpu_torch.render.renderer import init_state

    dev = torch.device("cuda", 0)
    if not initialize_multihost(f"localhost:{port}", nproc, rank, backend="gloo"):
        raise RuntimeError("initialize_multihost did not join two processes")
    try:
        mesh = make_render_mesh(2, 1, devices=[dev])
        cfg, scene = main_cfg(dev)
        lo, hi = host_rows(cfg.height, mesh)
        owned = torch.zeros(cfg.height, dtype=torch.int64, device=dev)
        owned[lo:hi] = 1
        all_sum(owned)
        if hi <= lo or not bool((owned == 1).all()):
            raise RuntimeError(f"rank {rank}: rows {lo}..{hi} do not split the image")
        step = make_sharded_render_step(cfg, mesh)
        copies = replicate_scene(scene, mesh)
        counts = {"K1": k1.COUNT, "K2": k2.COUNT, "K4": k2.COUNT_TEX}
        reset(counts)
        st, rays, _ = mesh_run(step, copies, init_state(cfg, dev), 2)
        got = check_launches(f"rank {rank}", counts, {"K1": 2 * cfg.max_bounces,
                                                      "K2": 2 * cfg.max_bounces})
        tcfg, tscene, isect, target = training_setup(dev)
        tstep, params, opt = make_sharded_train_step(tscene, tcfg, mesh, optimizer=sgd_one,
                                                     intersect_fn=isect)
        reset(counts)
        tstep(params, opt, target, 0)
        got_t = {k: c.kernel for k, c in counts.items()}
        info = torch.tensor([lo, hi, got["K1"], got["K2"], got_t["K1"]], device=dev)
        both = torch.zeros((2, 5), dtype=torch.int64, device=dev)
        both[rank] = info
        all_sum(both)
        if rank == 0:
            rows = {f"rows{r}": both[r, :2].cpu().numpy() for r in range(2)}
            lch = {f"launches{r}": json.dumps({"K1": int(both[r, 2]), "K2": int(both[r, 3]),
                                               "K1 training step": int(both[r, 4])})
                   for r in range(2)}
            np.savez(outp, accum=st.accum.cpu().numpy(), rays=rays, **rows, **lch,
                     **{f"g_{n}": p.grad.cpu().numpy() for n, p in zip(params._fields, params)
                        if p.grad is not None})
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def main() -> int:
    t_start = time.perf_counter()

    def stamp(phases: str):  # where the script's time goes
        print(f"[phases {phases} done at {time.perf_counter() - t_start:.1f} s]")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2
    # The card's machine has no PIL, and the port must not need it: block it
    # for every phase of this process.
    pil_found = importlib.util.find_spec("PIL") is not None
    for mod in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        sys.modules[mod] = None
    sys.modules["PIL"] = None
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
    from tracy_tpu_torch.utils import native, parity

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
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; PIL "
          f"{'installed, blocked for this run' if pil_found else 'not installed'}")
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
    t0 = time.perf_counter()
    native.get_image_lib()  # the image decoders, g++ at first use
    print(f"build: {', '.join(os.path.basename(s) for s in native.IMAGE_SOURCES)} with g++ "
          f"{' '.join(native.IMAGE_CXXFLAGS)}, built or loaded in "
          f"{time.perf_counter() - t0:.2f} s")

    stamp("1-2")

    # 3. kernel vs plain
    cfg = render_config()
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

    # rng 'threefry' (jax.random's Threefry-2x32 plus the 'fast' mix; the
    # four keys of a launch folded on the host) in K2, K4 and K5: each
    # against its plain version on the same lanes, and K5 under compaction
    # (a third of the real grid64x28 lanes live, as at bounce 1) against K1
    # then K2 and its plain version; then each timed beside its 'fast' twin,
    # in turns, and its plain version once.
    tkw = dict(seed=SEED, russian_roulette=True, rng="threefry")
    tf2 = compare.compare_shade(lanes, mtab, 3, 1, **tkw)
    tf4 = compare.compare_shade_textured(real, tscene, mtab_t, 3, 1, **tkw)
    tf5 = compare.compare_bounce(blanes, tables, mtab_g, 3, 1, **tkw)
    third = torch.as_tensor(np.random.default_rng(5).uniform(size=wave) < 0.35, device=dev)
    tf5c = compare.compare_bounce_compacted(dict(blanes, alive=blanes["alive"] & third), tables,
                                            mtab_g, group, 3, 1, **tkw)
    print(f"rng threefry, {wave} lanes: K2 (canned lanes) vs plain bit for bit "
          f"{tf2['bit_equal']} (must be); K4 (real grid64x28-tex lanes) vs plain bit for bit "
          f"{tf4['bit_equal']}, lanes differing {tf4['lanes_differing']} (hit lanes "
          f"{tf4['hit_lanes_differing']}, must be 0; sky lanes may address another texel, "
          f"<= 1e-4 of lanes), max abs err {tf4['max_abs_err']:.3g}; K5 (real grid64x28 lanes) "
          f"vs plain bit for bit {tf5['bit_equal']} (must be), vs K1 then K2 "
          f"{tf5['equal_to_k1_k2']}; K5 compacted (group {group}, {tf5c['live_lanes']} live) "
          f"vs K1 then K2 uncompacted {tf5c['equal_to_k1_k2']}, vs its plain version "
          f"compacted {tf5c['equal_to_plain']}")
    if not (tf2["bit_equal"] and tf5["bit_equal"]) or tf4["hit_lanes_differing"] \
            or tf4["lanes_differing"] > 1e-4 * wave:
        raise RuntimeError("a kernel at rng threefry differs from its plain version")
    t_tf = {kn: {"fast": [], "threefry": []} for kn in ("K2", "K4", "K5")}
    for rng in ("fast", "threefry", "threefry", "fast"):
        rk = dict(kw, rng=rng)
        t_tf["K2"][rng].append(compare.inplace_ms(lambda a: k2.shade(*a, mtab, 3, 1, **rk),
                                                  lanes, 20, compare.SHADE_ARGS))
        t_tf["K4"][rng].append(compare.inplace_ms(
            lambda a: k2.shade_textured(*a, mtab_t, *tex, 3, 1, **rk), real, 20))
        t_tf["K5"][rng].append(compare.cuda_ms(
            lambda: k5.trace_bounce(*bargs, 3, 1, tables=tables, mtab=mtab_g, **rk), 10))
    t_tf = {kn: {r: sum(v) / len(v) for r, v in d.items()} for kn, d in t_tf.items()}
    tp_tf = {"K2": compare.inplace_ms(lambda a: k2.shade_plain(*a, mtab, 3, 1, **tkw), lanes,
                                      1, compare.SHADE_ARGS),
             "K4": compare.inplace_ms(
                 lambda a: k2.shade_textured_plain(*a, mtab_t, *tex, 3, 1, **tkw), real, 1),
             "K5": compare.cuda_ms(lambda: k5.trace_bounce_plain(
                 *bargs, 3, 1, tables=tables, mtab=mtab_g, **tkw), 1)}
    print(f"  threefry vs fast, each the mean of 2 turns (fast, threefry, threefry, fast) "
          f"{card}: " + ", ".join(
              f"{kn} {t['threefry']:.4f} ms vs {t['fast']:.4f} ms "
              f"({t['threefry'] / t['fast']:.2f} x), plain {tp_tf[kn]:.2f} ms"
              for kn, t in t_tf.items())
          + " (the bounds count bytes and float32 operations: Threefry's integer work, "
          "about 4 x 20 rounds a hit lane, is not in them)")

    stamp("3")

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
             ("grid64x28 width 2", scene, cfg.replace(pallas_bvh_width=2), ("K1", "K2")),
             ("grid64x28 compacted threefry", scene, ccfg.replace(rng="threefry"),
              ("K1", "K2")))
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
    rends, launches, accum, rates, peak, rays_of = {}, {}, {}, {}, {}, {}
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
                # The main paths' few materials keep the 48 KB staged route.
                if kname in ("K2", "K4") and kern and counts[kname].routes != {"shared": kern}:
                    raise RuntimeError(f"{pname}: {kname} routes {counts[kname].routes}")
            rates[pname].append(rend.mrays_per_sec)
            if rep == 0:
                launches[pname] = {k: kern for k, (kern, _) in got.items()}
                accum[pname] = state.accum
                rays_of[pname] = nrays
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
    # threefry draws other numbers than 'fast': its frames are another
    # estimate of the same image. Both paths run on to 24 frames, as phase
    # 5's gates do, and are held by tests/test_ref_parity.py's block-mean
    # contract on the 8-bit images (4 frames leave a 16x16 block's mean
    # too noisy for it: on the CPU at 320x180, block p95 0.023).
    imgs = {}
    for pname in ("grid64x28 compacted", "grid64x28 compacted threefry"):
        rend = rends[pname]
        st24, _ = rend.step_many(scene, init_state(rend.cfg, dev), 24)
        imgs[pname] = parity.srgb_to_linear(np.clip(rend.display(st24) * 255.99, 0.0, 255.0)
                                            / 255.99)
    dmean, p95, dmax = parity.compare(imgs["grid64x28 compacted"],
                                      imgs["grid64x28 compacted threefry"])
    print(f"grid64x28 compacted, threefry vs fast, 24 frames each: mean diff {dmean:.5f} "
          f"(<= 0.01), block p95 {p95:.5f} (<= 0.02), block max {dmax:.5f} (<= 0.05)")
    if dmean > 0.01 or p95 > 0.02 or dmax > 0.05:
        raise RuntimeError("the threefry render is outside the block-mean contract")
    # ray_chunk: a compacted frame traced in 4 chunks of a quarter wave
    # equals the whole frame bit for bit ('fast').
    chunk = wave // 4
    crend = Renderer(ccfg.replace(ray_chunk=chunk))
    whole, wrays = rends["grid64x28 compacted"].step_many(scene, init_state(ccfg, dev), 1)
    reset(counts)
    chunked, crays = crend.step_many(scene, init_state(ccfg, dev), 1)
    got = {k: (c.kernel, c.plain) for k, c in counts.items()}
    same = bool(torch.equal(chunked.accum, whole.accum)) and crays == wrays
    print(f"ray_chunk {chunk} (4 chunks of the {wave}-lane wave), compacted, 1 frame: equal "
          f"to the whole frame bit for bit {same} (rays {crays} vs {wrays}); launches "
          + ", ".join(f"{k} {v[0]}" for k, v in got.items() if v[0]))
    if not same or got["K1"] != (4 * ccfg.max_bounces, 0) or got["K2"][1]:
        raise RuntimeError(f"ray_chunk: frame equal {same}, launches {got}")

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

    stamp("4")

    # 5. physics against the reference's own renders; the last two gates on
    # the other intersectors and counter hashes.
    for gname, fused, extra in (("furnace", False, {}), ("spheres", False, {}),
                                ("furnace", True, {}),
                                ("spheres", False, dict(accel="bvh", rng="xorshift")),
                                ("furnace", False, dict(accel="none", rng="lcg")),
                                ("furnace", False, dict(pallas_bvh_width=8)),
                                ("furnace", False, dict(accel="tlas")),
                                ("furnace", False, dict(rng="threefry")),
                                ("furnace", True, dict(rng="threefry")),
                                ("spheres", False, dict(rng="threefry"))):
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
        if gcfg.rng == "threefry":
            launches[f"gate {gname} {gr.path} threefry"] = {k: c.kernel for k, c in counts.items()}

    stamp("5")

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
    regs6 = k6.kernel_resources(build.LIBRARY.build_log.get("micro.cu", ""))

    def k6_line(label, t):
        r = regs6.get(label, {})
        return (f"  {label:5s} {t['ms']:.4f} ms a launch, {t['ns_per_iter']:.3f} ns/iter, "
                f"{t['ns_per_ray_visit']:.6f} ns per ray-visit; {r.get('registers', '?')} "
                f"registers, {r.get('spill_stores', '?')} B spilled {card}")

    print(f"K6 vs plain, {mrays.shape[0]} rays x {k6.ITERS} visits of {k6.NUM_LEAVES} leaves of "
          f"{k6.LEAF_SIZE} triangles (hit fraction {c6['vres']['hit_fraction']:.3f}, "
          f"improving warp-visits {c6['vred']['improving_warp_visits']}): every variant equal "
          f"to its plain version bit for bit; {k6_launches} timed launches {card}:")
    for v in k6.VARIANTS:
        print(k6_line(v, t6[v]))
    print(f"  vres bound {b6['bound_ms']:.4f} ms ({b6['bound_by']}: {b6['ops']:.4g} ops), "
          f"{b6['bound_ms'] / t6['vres']['ms']:.1%} of it reached; plain {t_p6:.1f} ms {card}")
    launches["tools.micro"] = {k: 0 for k in counts}
    launches["tools.micro"]["K6"] = k6_launches

    stamp("6")

    # 7. AOVs, 8. bands, 9. gradients, 10. training, 11. one textured step.
    launches.update(aov_phase((("grid64x28", scene), ("grid64x28-tex", tscene)), ccfg, counts,
                              dev, card))
    band_phase(scene, rends["grid64x28 compacted"], ccfg)
    threefry_band_phase(scene, rends["grid64x28 compacted threefry"], ccfg.replace(rng="threefry"))
    launches.update(gradient_phase(dev, card))
    more, train_ms = training_phase(builder, counts, dev, card)
    launches.update(more)
    more, tex_ms = textured_step_phase(tbuilder, counts, dev, card)
    launches.update(more)
    print("training: " + json.dumps({"device": smi, **train_ms, "textured": tex_ms}))

    stamp("7-11")

    # 12. accel 'tlas', 13. the raster preview, 14. the entry points.
    more, tlas_s = tlas_phase(scene, ccfg, rends["grid64x28 compacted"], counts, dev, card)
    launches.update(more)
    raster_ms = raster_phase((("grid64x28", builder, scene, tables),
                              ("grid64x28-tex", tbuilder, tscene, ttables)), dev, card)
    entries = entry_phase(card)
    print("slice 9: " + json.dumps({"device": smi, "tlas": tlas_s, "raster_ms": raster_ms,
                                    "entries": entries}))

    stamp("12-14")

    # 15. the mesh.
    more, mesh_s = mesh_phase(scene, tscene, ccfg, rends, accum, rays_of, counts, dev, card)
    launches.update(more)
    print("slice 10: " + json.dumps({"device": smi, **mesh_s}))

    stamp("15")

    # 16. image textures without PIL, 17. the table routes.
    more, image_res = image_phase(ccfg, counts, dev, card)
    launches.update(more)
    stamp("16")
    more, route_res = route_phase(wave, ccfg, (dscene, tscene), counts, dev, card)
    launches.update(more)
    print("slice 12: " + json.dumps({"device": smi, "pil_installed": pil_found,
                                     "images": image_res, "routes": route_res}))
    stamp("17")

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
    for kern in kernels[1:4]:  # K2, K3, K4: ms on each table route (phase 17)
        kn = kern["name"].split()[0]
        kern["table_routes_ms"] = {k: v for k, v in route_res["ms"].items()
                                   if k.startswith(kn + " ")}
    # The threefry variants: launches on the paths and gates at rng threefry.
    for kn, label, src, rep, c in (
            ("K2", "shade, rng threefry", "shade.cu", "tracy_tpu/ops/pallas_shade.py:72", tf2),
            ("K4", "shade_textured, rng threefry", "shade.cu",
             "tracy_tpu/ops/pallas_shade.py:355", tf4),
            ("K5", "bounce, rng threefry", "bounce.cu", "tracy_tpu/ops/pallas_packet.py:2292",
             tf5)):
        e = entry(kn, label, src, rep, c["max_abs_err"], t_tf[kn]["threefry"], tp_tf[kn], c,
                  None)
        e["launches_by_path"] = {p: v.get(kn, 0) for p, v in launches.items() if "threefry" in p}
        e["launches"] = sum(e["launches_by_path"].values())
        e.update(fast_ms=t_tf[kn]["fast"], bit_equal=c["bit_equal"])
        kernels.append(e)
    kernels[-1]["compacted_equal_to_k1_k2"] = all(tf5c["equal_to_k1_k2"])
    kernels[5]["ns_per_iter"] = {v: t6[v]["ns_per_iter"] for v in k6.VARIANTS}
    kernels[5]["registers"] = {k: r["registers"] for k, r in regs6.items()}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:  # one rank of phase 15 (d)
        sys.exit(mesh_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    sys.exit(main())
