"""Command-line renderer of the port: the framework's `main()`.

Port of tracy_tpu/apps/render_cli.py (reference entry point,
win_raytracer.cpp:431-589), with its flags and log lines: parses -scene and
-kernel, loads the scene, runs progressive frames, reports MRays/s and fps,
and writes the image (PNG, PPM or .npy, no PIL needed).

Kernels (reference -kernel CPURTX|CUDA|OpenGL|CPU, win_raytracer.cpp:48-56):
  pt         path tracer over the BVH (the default)
  pt-bf      path tracer, brute-force intersection
  raster     software rasterizer preview (albedo or -aov)
  raster-gl  the rasterizer's shaded mode (bilinear textures, sky)

The scene renders on the card. There the defaults are accel 'packet' with
wave compaction sized by pick_compact_group (on 'packet' and 'tlas'); with
-cpu, accel 'bvh' and no compaction, as tracy_tpu picks by backend. Without
a card and without -cpu the CLI exits with an error that names -cpu.

-width and -height, when given, override the scene's OUT size (in
tracy_tpu's CLI the OUT tag wins), so a scene renders at any size.

-mesh DATAxSAMPLE renders over a mesh of cells (parallel/mesh.py): the
image rows split over DATA cells, the samples per pixel over SAMPLE. The
cells are spread evenly over the visible cards (their count must be a
multiple of the cards'; 2x2 on one card runs four cells on it), or all on
the CPU with -cpu. Each card gets the same stages as a render on one
device (tracy_tpu's -mesh renders brute force whatever -accel says), and
-checkpoint resumes under any mesh shape, or none.

-ray-chunk N traces each sample's lanes in chunks of N (RenderConfig.
ray_chunk) when N divides them.

Left out: tracy_tpu's TPU-only flags -rb-mode and -packet-rays (mechanics
the port does not have).

Usage:
  python -m tracy_tpu_torch.apps.render_cli -scene data/scenes/cornell.scn \\
      -frames 64 -spp 4 -out cornell.png [-kernel pt] [-aov normals] ...
  python -m tracy_tpu_torch.apps.render_cli -cpu -width 64 -height 48 -frames 2 -out a.ppm
  python -m tracy_tpu_torch.apps.render_cli -cpu -mesh 2x2 -spp 2 -width 64 -height 48 -out m.ppm
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch


def human_count(n: float) -> str:
    """Reference TracySizeToHumanReadableString (win_raytracer.cpp:402-423)."""
    for unit, div in (("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if n >= div:
            return f"{n / div:.2f}{unit}"
    return str(int(n))


def pick_device(parser: argparse.ArgumentParser, cpu: bool) -> torch.device:
    """The CPU with -cpu, else the card; without one the parser exits (code
    2) with an error that names -cpu: never a quiet fall back to the CPU."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        parser.error("no CUDA device is available; pass -cpu to render on the CPU")
    return torch.device("cuda", 0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-scene", default=None, help=".scn file (default: builtin scene)")
    p.add_argument("-kernel", default="pt", choices=["pt", "pt-bf", "raster", "raster-gl"])
    p.add_argument("-width", type=int, default=None,
                   help="image width (default: the scene's OUT, else 640)")
    p.add_argument("-height", type=int, default=None,
                   help="image height (default: the scene's OUT, else 480)")
    p.add_argument("-frames", type=int, default=16)
    p.add_argument("-spp", type=int, default=1)
    p.add_argument("-bounces", type=int, default=5)
    p.add_argument("-out", default="render.png")
    p.add_argument("-aov", default="beauty")
    p.add_argument("-tonemap", default="srgb", choices=["none", "srgb", "aces", "reinhard"])
    p.add_argument("-exposure", type=float, default=1.0)
    p.add_argument("-data-root", default=None)
    p.add_argument("-no-rr", action="store_true", help="disable russian roulette")
    p.add_argument("-ray-chunk", type=int, default=0,
                   help="lanes traced at once (0: a whole sample's)")
    p.add_argument("-accel", default=None, choices=["packet", "tlas", "bvh", "none"],
                   help="acceleration tier (default: packet for -kernel pt on the card, "
                        "bvh with -cpu; none for pt-bf)")
    p.add_argument("-compact", type=int, default=None,
                   help="per-wave live-ray compaction group (rays; default "
                        "pick_compact_group's on the card's packet and tlas paths, 0 otherwise)")
    p.add_argument("-bvh-width", type=int, default=4, choices=[2, 4, 8],
                   help="branching factor of the BVH K1 walks (default: 4)")
    p.add_argument("-cpu", action="store_true", help="render on the CPU")
    p.add_argument("-mesh", default=None,
                   help="mesh of cells as DATAxSAMPLE, e.g. 4x2: rows split over DATA, "
                        "samples over SAMPLE, the cells spread evenly over the cards")
    p.add_argument("-checkpoint", default=None,
                   help="checkpoint npz path: resume if it exists, save every "
                        "-checkpoint-every frames (a resume is bit-identical)")
    p.add_argument("-checkpoint-every", type=int, default=8,
                   help="frames between checkpoint saves (with -checkpoint)")
    args = p.parse_args(argv)

    dev = pick_device(p, args.cpu)

    from tracy_tpu_torch.accel.reorder import pick_compact_group
    from tracy_tpu_torch.config import RenderConfig
    from tracy_tpu_torch.render.renderer import Renderer
    from tracy_tpu_torch.scene.scn_parser import default_scene, load_scene
    from tracy_tpu_torch.utils.log import log
    from tracy_tpu_torch.utils.timer import Timer

    if args.scene:
        builder = load_scene(args.scene, data_root=args.data_root)
    else:
        builder = default_scene()
    # A size given on the command line wins over the scene's OUT tag (in
    # tracy_tpu's CLI the OUT tag wins).
    builder.width = args.width or builder.width
    builder.height = args.height or builder.height
    mesh_shape = parse_mesh(p, args)
    scene = builder.build(device=dev)
    log("objects: %s, triangles: %s" % (human_count(builder.num_objects),
                                         human_count(builder.num_triangles)))

    card = dev.type == "cuda"
    if args.accel is not None:
        accel = args.accel
    elif args.kernel == "pt-bf":
        accel = "none"
    else:
        accel = "packet" if card else "bvh"
    compact = args.compact
    if compact is None:
        compact = (pick_compact_group(builder.width * builder.height,
                                      num_tris=builder.num_triangles,
                                      has_translucent=builder.has_translucent)
                   if card and accel in ("packet", "tlas") else 0)
    cfg = RenderConfig(width=builder.width, height=builder.height, spp=args.spp,
                       max_bounces=args.bounces, tonemap=args.tonemap,
                       exposure=args.exposure, aov=args.aov, accel=accel,
                       russian_roulette=not args.no_rr, wave_compact_group=compact,
                       pallas_bvh_width=args.bvh_width, ray_chunk=args.ray_chunk)

    if args.kernel in ("raster", "raster-gl"):
        from tracy_tpu_torch.raster.rasterizer import render_raster
        from tracy_tpu_torch.render import film

        shaded = args.kernel == "raster-gl"
        t0 = time.perf_counter()
        img = render_raster(scene, cfg, shaded=shaded)
        if shaded:
            img = film.tonemap(img, cfg)
        img = img.cpu().numpy()
        dt = time.perf_counter() - t0
        log("raster frame: %.3fs" % dt)
        _save(img, args.out)
        return 0

    if mesh_shape is None:
        r = Renderer(cfg)
        mesh = None

        def advance(state):
            return r.step(scene, state)
    else:
        from tracy_tpu_torch.parallel import (
            make_render_mesh, make_sharded_render_step, replicate_scene)

        nd, ns = mesh_shape
        cards = torch.cuda.device_count() if card else 1
        per_card = nd * ns // cards
        try:
            # Cells spread evenly over the cards, each card's cells in a run.
            mesh = make_render_mesh(nd, ns, devices=[
                torch.device("cuda", c // per_card) if card else dev for c in range(nd * ns)])
            step = make_sharded_render_step(cfg, mesh)
        except ValueError as e:  # an axis that does not divide the height or -spp
            p.error(f"-mesh {args.mesh}: {e}")
        copies = replicate_scene(scene, mesh)
        log(f"mesh {nd}x{ns}: {nd * ns} cells on {cards} "
            f"{'card' if card else 'CPU'}{'s' if cards > 1 else ''}")

        def advance(state):
            state, rays = step(copies, state)
            return state, int(rays)

    state, start = _resume_or_init(args, cfg, dev, mesh)
    timer, total_rays = Timer(), 0
    last_report = time.perf_counter()
    for f in range(start, args.frames):
        timer.begin()
        state, rays = advance(state)
        timer.end()
        total_rays += rays
        _maybe_checkpoint(args, state, f)
        now = time.perf_counter()
        if now - last_report > 1.0 or f == args.frames - 1:
            # Reference window-title telemetry (win_raytracer.cpp:521-553).
            log("frame %d/%d: %.2f MRays/s @ %.2f fps"
                % (f + 1, args.frames, total_rays / 1e6 / max(timer.total, 1e-9),
                   (f + 1 - start) / max(timer.total, 1e-9)))
            last_report = now
    log("*** Performance: %.2f MRays/s and %.2f fps on average - Run time: %.1fs ***"
        % (total_rays / 1e6 / max(timer.total, 1e-9),
           (args.frames - start) / max(timer.total, 1e-9), timer.total))
    from tracy_tpu_torch.render import film

    _save(film.to_u8(film.tonemap(state.accum, cfg)).cpu().numpy(), args.out)
    return 0


def parse_mesh(parser: argparse.ArgumentParser, args):
    """(DATA, SAMPLE) of -mesh, None without it; the parser exits (code 2)
    on a malformed mesh or one whose cells the cards do not divide."""
    if not args.mesh:
        return None
    try:
        nd, ns = (int(x) for x in args.mesh.lower().split("x"))
    except ValueError:
        parser.error(f"-mesh {args.mesh}: expected DATAxSAMPLE, e.g. 4x2")
    cards = 1 if args.cpu else torch.cuda.device_count()
    if (nd * ns) % cards:
        parser.error(f"-mesh {args.mesh}: {nd * ns} cells do not spread evenly over "
                     f"{cards} cards")
    return nd, ns


def _resume_or_init(args, cfg, dev, mesh=None):
    """(state, start frame): resumed from -checkpoint when the file exists
    (on the mesh's home device under -mesh), else a fresh state."""
    from tracy_tpu_torch.render.renderer import init_state
    from tracy_tpu_torch.utils.log import log

    if args.checkpoint and os.path.exists(args.checkpoint):
        from tracy_tpu_torch.utils.checkpoint import load_render_state

        state = load_render_state(args.checkpoint, device=dev, mesh=mesh)
        log(f"resumed {args.checkpoint} at frame {state.frame}")
        return state, state.frame
    return init_state(cfg, mesh.home if mesh is not None else dev), 0


def _maybe_checkpoint(args, state, frame_idx: int):
    if args.checkpoint and args.checkpoint_every > 0 and (
            (frame_idx + 1) % args.checkpoint_every == 0):
        from tracy_tpu_torch.utils.checkpoint import save_render_state

        save_render_state(args.checkpoint, state)


def _save(img, path: str):
    from tracy_tpu_torch.utils.image_io import save_image
    from tracy_tpu_torch.utils.log import log

    save_image(img, path)
    log(f"saved {path}")


if __name__ == "__main__":
    sys.exit(main())
