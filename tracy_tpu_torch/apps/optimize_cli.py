"""Inverse-rendering CLI of the port: the differentiable-rendering showcase.

Port of tracy_tpu/apps/optimize_cli.py, on the port's diff package and
torch.optim.Adam: optimises scene parameters (material albedo, roughness,
metalness, ior, emissive, translucency, the texture atlas, or the vertex
positions) so that a re-render matches a target image.

  # recover a material's albedo from a render of the scene
  python -m tracy_tpu_torch.apps.optimize_cli -scene data/scenes/default.scn \\
      -target target.ppm -params albedo -steps 200 -out recovered.png

  # self-test: perturb the scene's parameter, then recover it
  python -m tracy_tpu_torch.apps.optimize_cli -selftest albedo -steps 100

-target reads .npy and .hdr by name (linear radiance as stored; 8-bit
.npy as display values, taken to linear radiance through the sRGB curve)
and any file of utils/image_io.py's READ_FORMATS (PNG, JPEG, BMP, TIFF,
WebP, JPEG 2000, the icon and game-texture containers, and PIL's small raw
and run-length formats, PCX to FLI) by its content, as display values the same
way, without PIL (utils/image_io.py::read_image).
The scene renders on the card; -cpu asks for the CPU. A self-test exits 0
when the largest error of the observable entries is under 0.1, else 1.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

MATERIAL_FIELDS = ("albedo", "roughness", "metalness", "ior", "emissive", "translucent")
CLIPPED_FIELDS = ("albedo", "roughness", "metalness", "translucent")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-scene", default=None)
    p.add_argument("-data-root", default=None)
    p.add_argument("-width", type=int, default=96)
    p.add_argument("-height", type=int, default=72)
    p.add_argument("-spp", type=int, default=4)
    p.add_argument("-bounces", type=int, default=3)
    p.add_argument("-target", default=None,
                   help="target image: .npy, .hdr, or a PNG, JPEG, BMP, GIF, PNM, PSD or "
                        "TGA file (told apart by content)")
    p.add_argument("-params", default="albedo",
                   help="comma list: albedo,roughness,metalness,ior,emissive,"
                        "translucent,tex_data,vertex_pos")
    p.add_argument("-steps", type=int, default=100)
    p.add_argument("-lr", type=float, default=5e-2)
    p.add_argument("-out", default="recovered.png")
    p.add_argument("-selftest", default=None,
                   help="perturb and recover this parameter instead of using -target")
    p.add_argument("-cpu", action="store_true", help="render on the CPU")
    p.add_argument("-accel", default="auto", choices=("auto", "none"),
                   help="auto = K1 over the BVH (vertex gradients through the "
                        "winner-recompute intersector); none = brute force")
    args = p.parse_args(argv)

    from tracy_tpu_torch.apps.render_cli import pick_device
    from tracy_tpu_torch.config import RenderConfig
    from tracy_tpu_torch.diff import (
        TrainableParams, apply_params, extract_params, make_train_step,
        make_training_intersector)
    from tracy_tpu_torch.render import film
    from tracy_tpu_torch.render.renderer import sample_radiance
    from tracy_tpu_torch.scene.scn_parser import default_scene, load_scene
    from tracy_tpu_torch.utils.image_io import read_image, save_image
    from tracy_tpu_torch.utils.log import log
    from tracy_tpu_torch.utils.parity import srgb_to_linear

    dev = pick_device(p, args.cpu)
    if args.scene:
        builder = load_scene(args.scene, data_root=args.data_root, width=args.width,
                             height=args.height)
        builder.width, builder.height = args.width, args.height
    else:
        builder = default_scene(args.width, args.height)
    scene = builder.build(device=dev)
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_bounces=args.bounces, tonemap="none",
                       accel="none" if args.accel == "none" else "packet",
                       russian_roulette=False)
    names = (args.selftest or args.params).split(",")
    unknown = [n for n in names if n not in TrainableParams._fields]
    if unknown:
        p.error(f"unknown parameters {unknown}; pick from {TrainableParams._fields}")
    intersect_fn = None
    if args.accel == "auto":
        # K1 in the forward under a zero-gradient wrapper; vertex gradients
        # recompute the winner in torch.
        intersect_fn = make_training_intersector(
            scene, cfg, needs_geometry_grads="vertex_pos" in names)
    frame = 7
    base = extract_params(scene)

    observable = None
    if args.selftest:
        # The target is a render of the true scene; the start perturbs the
        # parameter's observable rows: materials some triangle uses (the sky,
        # slot 0, shows only through its emissive).
        with torch.no_grad():
            target, _ = sample_radiance(scene, cfg, frame, intersect_fn)
        field = getattr(base, args.selftest)
        used = np.zeros(scene.materials.albedo.shape[0], bool)
        used[np.unique(scene.tri_material.cpu().numpy())] = True
        used[0] = False
        noise = np.random.default_rng(0).uniform(-0.3, 0.3, size=tuple(field.shape))
        noise = noise.astype(np.float32)
        if args.selftest in MATERIAL_FIELDS:
            observable = used.reshape((-1,) + (1,) * (field.dim() - 1))
            noise = np.where(observable, noise, np.float32(0.0))
        start = field + torch.as_tensor(noise, device=dev)
        if args.selftest in CLIPPED_FIELDS:
            start = torch.clamp(start, 0.01, 1.0)
        train_fields = [args.selftest]
    else:
        if not args.target:
            p.error("need -target or -selftest")
        try:
            img, linear = read_image(args.target)
        except (OSError, ValueError) as e:
            p.error(f"-target: {e}")
        if not linear:
            img = srgb_to_linear(img)  # display values -> approximately linear
        target = torch.as_tensor(np.asarray(img, np.float32), device=dev)
        if tuple(target.shape) != (args.height, args.width, 3):
            p.error(f"-target is {tuple(target.shape)[:2]} pixels, the render "
                    f"{(args.height, args.width)}")
        start = None
        train_fields = names

    mask = TrainableParams(*(f in train_fields for f in TrainableParams._fields))
    step, params, opt = make_train_step(
        scene, cfg, optimizer=lambda ps: torch.optim.Adam(ps, lr=args.lr),
        intersect_fn=intersect_fn, trainable_mask=mask)
    if start is not None:
        with torch.no_grad():
            getattr(params, args.selftest).copy_(start)

    t0 = time.perf_counter()
    for i in range(args.steps):
        params, opt, loss = step(params, opt, target, frame)
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            log(f"step {i}: loss {float(loss):.6f}")
    log(f"optimized {args.steps} steps in {time.perf_counter() - t0:.1f}s")

    with torch.no_grad():
        recovered, _ = sample_radiance(apply_params(scene, params), cfg, frame, intersect_fn)
        shown = film.to_u8(film.tonemap(recovered, cfg.replace(tonemap="srgb")))
    save_image(shown.cpu().numpy(), args.out)
    log(f"saved {args.out}")

    if args.selftest:
        diff = (getattr(params, args.selftest).detach()
                - getattr(base, args.selftest)).abs().cpu().numpy()
        if observable is not None:
            diff = diff * observable
        err = float(diff.max())
        log(f"selftest max observable param error vs truth: {err:.4f}")
        return 0 if err < 0.1 else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
