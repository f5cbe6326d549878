"""Interactive progressive viewer.

Port of tracy_tpu/apps/viewer.py (the reference's windowed main loop,
win_raytracer.cpp:494-556): the image keeps accumulating samples while
WASDQE moves the camera and left-drag looks around; any camera change is a
camera cut that resets accumulation. While the camera moves, frames render
at a preview resolution (1/4 in each dimension, -preview-scale) and are
upscaled for display; the first still frame goes back to full resolution
and restarts accumulation. A window resize re-derives the render
resolution and the camera projection (WM_SIZE -> Camera::UpdateProjection,
win_raytracer.cpp:118-124), once per new size.

ViewerSession holds the per-tick logic with no GUI (tests drive it
headless). `-frames N -out img.png` renders a burst and saves it, with no
window; otherwise main() opens a matplotlib window, importing matplotlib
only then. Run:

    python -m tracy_tpu_torch.apps.viewer -scene data/scenes/cornell.scn
    python -m tracy_tpu_torch.apps.viewer -frames 16 -out viewer.png   # headless
    python -m tracy_tpu_torch.apps.viewer -cpu -frames 2 -width 64 -height 48

The scene renders on the card; -cpu asks for the CPU (the plain PyTorch
versions of the kernels), and without a card and without -cpu the viewer
exits with an error.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional, Tuple

import numpy as np


def preview_config(cfg, scale: int):
    """Downscaled copy of cfg for camera-motion preview frames (None when
    scale <= 1 or the image is already tiny). Dimensions snap to multiples
    of 32, so the frame folds into whole 32x32 tiles."""
    if scale <= 1:
        return None
    w = max(64, (cfg.width // scale) // 32 * 32)
    h = max(32, (cfg.height // scale) // 32 * 32)
    if w >= cfg.width or h >= cfg.height:
        return None
    return dataclasses.replace(cfg, width=w, height=h)


class ViewerSession:
    """One viewer's state and the per-frame tick, with no GUI.

    The reference's loop body: process events, process inputs (a camera
    cut resets accumulation), one frame of tracing, present. The GUI layer
    feeds events to .controller and .request_resize() and shows what
    tick() returns."""

    def __init__(self, cfg, scene, controller, preview_scale: int = 4):
        from tracy_tpu_torch.render.renderer import Renderer

        self._Renderer = Renderer
        self.cfg = cfg
        self.scene = scene
        self.controller = controller
        self.preview_scale = preview_scale
        self.renderer = Renderer(cfg)
        self.state = self._init_state(cfg)
        self.pcfg = preview_config(cfg, preview_scale)
        self.prenderer = Renderer(self.pcfg) if self.pcfg is not None else None
        self.pstate = self._init_state(self.pcfg) if self.pcfg is not None else None
        self.previewing = False
        self._resize_req: Optional[Tuple[int, int]] = None

    def _init_state(self, cfg):
        from tracy_tpu_torch.render.renderer import init_state

        return init_state(cfg, self.scene.device)

    def request_resize(self, width: int, height: int):
        """Window resize: the render resolution and the camera projection
        re-derive on the next tick, snapped to multiples of 32."""
        self._resize_req = (max(64, int(width) // 32 * 32), max(32, int(height) // 32 * 32))

    def _camera(self):
        return self.controller.state.to_camera(device=self.scene.device)

    def _apply_resize(self) -> bool:
        w2, h2 = self._resize_req
        self._resize_req = None
        if (w2, h2) == (self.cfg.width, self.cfg.height):
            return False
        self.cfg = dataclasses.replace(self.cfg, width=w2, height=h2)
        self.controller.state = dataclasses.replace(self.controller.state,
                                                    aspect=w2 / max(h2, 1))
        self.scene = dataclasses.replace(self.scene, camera=self._camera())
        self.renderer = self._Renderer(self.cfg)
        self.state = self._init_state(self.cfg)
        self.pcfg = preview_config(self.cfg, self.preview_scale)
        self.prenderer = self._Renderer(self.pcfg) if self.pcfg is not None else None
        self.pstate = self._init_state(self.pcfg) if self.pcfg is not None else None
        return True

    def tick(self, dt: float, mouse_pos=None) -> np.ndarray:
        """One frame: inputs, maybe a camera cut, render; returns the uint8
        image at the current display resolution (preview frames upscaled)."""
        if self._resize_req is not None:
            self._apply_resize()
        if self.controller.update(dt, mouse_pos):
            # Camera cut (TracyEvent::eCameraCut, cpu_trace.cpp:76-78).
            self.scene = dataclasses.replace(self.scene, camera=self._camera())
            self.state = self._init_state(self.cfg)
            self.renderer.total_rays = 0
            self.renderer.timer.reset()
            if self.prenderer is not None:
                self.pstate = self._init_state(self.pcfg)
                self.previewing = True
        elif self.previewing:
            self.previewing = False  # the first still frame: back to full resolution
            self.state = self._init_state(self.cfg)

        if self.previewing and self.prenderer is not None:
            self.pstate, _ = self.prenderer.step(self.scene, self.pstate)
            img = self.prenderer.display_u8(self.pstate)
            return img.repeat(self.preview_scale, axis=0).repeat(
                self.preview_scale, axis=1)[:self.cfg.height, :self.cfg.width]
        self.state, _ = self.renderer.step(self.scene, self.state)
        return self.renderer.display_u8(self.state)

    def title(self) -> str:
        preview = self.previewing and self.prenderer is not None
        r = self.prenderer if preview else self.renderer
        st = self.pstate if preview else self.state
        return (f"{r.mrays_per_sec:.2f} MRays/s @ "
                f"{st.frame / max(r.timer.total, 1e-9):.2f} fps"
                f"{' [preview]' if self.previewing else ''}")


def make_session(builder, scene, cfg, preview_scale: int = 4) -> ViewerSession:
    from tracy_tpu_torch.apps.input import CameraController, CameraState

    cam = builder.camera_params
    controller = CameraController(CameraState(
        eye=np.asarray(cam["eye"], dtype=np.float64),
        target=np.asarray(cam["center"], dtype=np.float64),
        up=np.asarray(cam["up"], dtype=np.float64),
        fov_degrees=float(cam["fov_degrees"]),
        aspect=builder.width / max(builder.height, 1),
    ))
    return ViewerSession(cfg, scene, controller, preview_scale)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-scene", default=None)
    p.add_argument("-data-root", default=None)
    p.add_argument("-width", type=int, default=640)
    p.add_argument("-height", type=int, default=480)
    p.add_argument("-spp", type=int, default=1)
    p.add_argument("-bounces", type=int, default=5)
    p.add_argument("-cpu", action="store_true", help="render on the CPU")
    p.add_argument("-frames", type=int, default=0,
                   help="headless: render N frames, save and exit")
    p.add_argument("-preview-scale", type=int, default=4,
                   help="camera-motion preview downscale (1 = off)")
    p.add_argument("-out", default="viewer.png")
    args = p.parse_args(argv)

    from tracy_tpu_torch.apps.render_cli import pick_device
    from tracy_tpu_torch.config import RenderConfig
    from tracy_tpu_torch.accel.reorder import pick_compact_group
    from tracy_tpu_torch.render.renderer import Renderer, init_state
    from tracy_tpu_torch.scene.scn_parser import default_scene, load_scene
    from tracy_tpu_torch.utils.image_io import save_image
    from tracy_tpu_torch.utils.log import log

    dev = pick_device(p, args.cpu)
    if args.scene:
        builder = load_scene(args.scene, data_root=args.data_root, width=args.width,
                             height=args.height)
    else:
        builder = default_scene(args.width, args.height)
    scene = builder.build(device=dev)
    # On the card, accel 'packet' with wave compaction sized to the frame;
    # on the CPU 'bvh', uncompacted (tracy_tpu's viewer picks by backend).
    card = dev.type == "cuda"
    compact = pick_compact_group(builder.width * builder.height,
                                 num_tris=builder.num_triangles,
                                 has_translucent=builder.has_translucent) if card else 0
    cfg = RenderConfig(width=builder.width, height=builder.height, spp=args.spp,
                       max_bounces=args.bounces, accel="packet" if card else "bvh",
                       wave_compact_group=compact)

    if args.frames > 0:
        renderer = Renderer(cfg)
        state = init_state(cfg, dev)
        for _ in range(args.frames):
            state, _ = renderer.step(scene, state)
        log("%d frames: %.2f MRays/s" % (args.frames, renderer.mrays_per_sec))
        save_image(renderer.display_u8(state), args.out)
        log(f"saved {args.out}")
        return 0

    sess = make_session(builder, scene, cfg, args.preview_scale)
    import matplotlib

    matplotlib.use("TkAgg" if matplotlib.get_backend() == "agg" else matplotlib.get_backend())
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.set_axis_off()
    im = ax.imshow(np.zeros((cfg.height, cfg.width, 3), np.uint8))
    mouse_pos = [None]
    controller = sess.controller
    fig.canvas.mpl_connect("key_press_event", lambda e: controller.key_down(e.key or ""))
    fig.canvas.mpl_connect("key_release_event", lambda e: controller.key_up(e.key or ""))
    fig.canvas.mpl_connect("button_press_event",
                           lambda e: controller.mouse_press(e.x, e.y) if e.button == 1 else None)
    fig.canvas.mpl_connect("button_release_event", lambda e: controller.mouse_release())
    fig.canvas.mpl_connect("motion_notify_event",
                           lambda e: mouse_pos.__setitem__(0, (e.x, e.y)))
    fig.canvas.mpl_connect("resize_event", lambda e: sess.request_resize(e.width, e.height))

    last_title = last_frame = time.perf_counter()
    plt.show(block=False)
    while plt.fignum_exists(fig.number):
        now = time.perf_counter()
        dt = min(now - last_frame, 0.25) * 60.0  # the reference's dt is in frames, about
        last_frame = now
        w0, h0 = sess.cfg.width, sess.cfg.height
        img = sess.tick(dt, mouse_pos[0])
        if (sess.cfg.width, sess.cfg.height) != (w0, h0):
            log(f"resize -> {sess.cfg.width}x{sess.cfg.height} (projection updated)")
        im.set_data(img)
        if now - last_title > 1.0:
            fig.suptitle(f"{builder.name} - {sess.title()}")
            last_title = now
        fig.canvas.draw_idle()
        fig.canvas.flush_events()
    return 0


if __name__ == "__main__":
    sys.exit(main())
