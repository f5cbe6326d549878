"""The port's entry points (tracy_tpu_torch.apps) on the CPU.

* CameraController against tracy_tpu's on one sequence of key and mouse
  events: the same eye after every update, bit for bit (both are float64
  numpy), and the same camera cut flags; CameraState.to_camera gives
  tracy_tpu's matrices.
* ViewerSession: the behaviours tests/test_viewer.py holds tracy_tpu's to
  (preview sizes, a camera cut resets accumulation, the preview snaps back
  to full resolution, a resize re-derives the resolution and projection,
  mouse look is a camera cut), at 1 bounce to keep the frames cheap.
* render_cli.main in process: pt to .ppm (accel 'bvh' and 'tlas'), raster
  and raster-gl to .png (read back with the port's own decoder), a bad
  kernel and -mesh exit 2, no card without -cpu exits 2 naming -cpu, and
  a 2-frame run resumed from its checkpoint to 4 frames ends bit for bit
  where an uninterrupted 4-frame run does.
* optimize_cli: a 4-step albedo self-test lowers the loss and exits by its
  error; a -target .ppm run exits 0. viewer.main's headless burst.
"""

import logging
import re

import numpy as np
import pytest
import torch

from tracy_tpu.apps.input import CameraController as JController
from tracy_tpu.apps.input import CameraState as JState
from tracy_tpu_torch import RenderConfig
from tracy_tpu_torch.apps import optimize_cli, render_cli, viewer
from tracy_tpu_torch.apps.input import CameraController, CameraState
from tracy_tpu_torch.apps.viewer import make_session, preview_config
from tracy_tpu_torch.scene import default_scene
from tracy_tpu_torch.utils.image_io import decode_png, decode_ppm

torch.set_num_threads(2)

W, H = 128, 64
SMALL = ["-cpu", "-width", "32", "-height", "24", "-bounces", "2"]


def _state(cls):
    return cls(eye=np.array([0.0, 1.0, 10.0]), target=np.array([0.0, 0.5, 0.0]),
               up=np.array([0.0, 1.0, 0.0]), fov_degrees=60.0, aspect=4 / 3)


def test_camera_controller_matches_jax():
    from tracy_tpu.core.camera import Camera as JCamera

    ours, ref = CameraController(_state(CameraState)), JController(_state(JState))
    events = [("key", "w", 0.1, None), ("key", "d", 1.0, None), ("key", "e", 0.5, None),
              ("none", None, 0.5, (5.0, 5.0)), ("press", (100.0, 100.0), 0.0, None),
              ("move", None, 1.0, (130.0, 80.0)), ("move", None, 0.25, (90.0, 120.0)),
              ("release", None, 0.5, (10.0, 10.0)), ("key", "q", 2.0, None),
              ("key", "x", 1.0, None)]
    for kind, arg, dt, mouse in events:
        for c in (ours, ref):
            if kind == "key":
                c.key_down(arg)
            elif kind == "press":
                c.mouse_press(*arg)
            elif kind == "release":
                c.mouse_release()
        assert ours.update(dt, mouse) == ref.update(dt, mouse)
        np.testing.assert_array_equal(ours.state.eye, ref.state.eye)
    assert not np.allclose(ours.state.eye, [0.0, 1.0, 10.0])
    cam, jcam = ours.state.to_camera(device="cpu"), ref.state.to_camera()
    assert isinstance(jcam, JCamera)
    for k in ("eye", "view", "projection", "inv_view_projection"):
        np.testing.assert_array_equal(getattr(cam, k).numpy(), np.asarray(getattr(jcam, k)))


@pytest.fixture(scope="module")
def session_parts():
    builder = default_scene(W, H)
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=1, accel="bvh")
    return builder, builder.build(device="cpu"), cfg


def test_preview_config_downscale_and_snap():
    p = preview_config(RenderConfig(width=1920, height=1080), 4)
    assert (p.width, p.height) == (480, 256)
    assert preview_config(RenderConfig(width=1920, height=1080), 1) is None
    assert preview_config(RenderConfig(width=64, height=32), 4) is None


def test_camera_cut_resets_accumulation(session_parts):
    sess = make_session(*session_parts)
    for _ in range(2):
        img = sess.tick(dt=0.0)
    assert sess.state.frame == 2 and img.shape == (H, W, 3) and img.dtype == np.uint8
    eye = sess.controller.state.eye.copy()
    sess.controller.key_down("w")
    img = sess.tick(dt=0.5)
    assert sess.previewing and sess.state.frame == 0 and sess.pstate.frame == 1
    assert not np.allclose(sess.controller.state.eye, eye)
    assert img.shape == (H, W, 3)  # the preview, upscaled to the display size
    assert "[preview]" in sess.title()


def test_preview_snaps_back_to_full_res(session_parts):
    sess = make_session(*session_parts)
    sess.tick(dt=0.0)
    sess.controller.key_down("w")
    sess.tick(dt=0.5)
    assert sess.previewing and (sess.pcfg.width < W or sess.pcfg.height < H)
    img = sess.tick(dt=0.5)
    assert not sess.previewing and sess.state.frame == 1 and img.shape == (H, W, 3)
    sess.tick(dt=0.5)
    assert sess.state.frame == 2


def test_resize_rederives_resolution_and_projection(session_parts):
    sess = make_session(*session_parts)
    sess.tick(dt=0.0)
    old_cam = sess.scene.camera
    sess.request_resize(200, 150)
    img = sess.tick(dt=0.0)
    assert (sess.cfg.width, sess.cfg.height) == (192, 128)
    assert sess.controller.state.aspect == pytest.approx(192 / 128)
    assert sess.state.frame == 1 and img.shape == (128, 192, 3)
    assert sess.scene.camera is not old_cam
    r_before = sess.renderer
    sess.request_resize(193, 129)  # the same size once snapped: nothing rebuilt
    sess.tick(dt=0.0)
    assert sess.renderer is r_before and sess.state.frame == 2


def test_mouse_look_is_camera_cut(session_parts):
    sess = make_session(*session_parts)
    sess.tick(dt=0.0)
    sess.controller.mouse_press(10.0, 10.0)
    sess.tick(dt=0.5, mouse_pos=(40.0, 25.0))
    assert sess.previewing and sess.state.frame == 0
    sess.controller.mouse_release()
    sess.tick(dt=0.5)
    assert not sess.previewing and sess.state.frame == 1


@pytest.mark.parametrize("accel", ["bvh", "tlas"])
def test_render_cli_pt_to_ppm(tmp_path, accel):
    out = str(tmp_path / "out.ppm")
    assert render_cli.main(SMALL + ["-frames", "2", "-accel", accel, "-out", out]) == 0
    with open(out, "rb") as f:
        img = decode_ppm(f.read())
    assert img.shape == (24, 32, 3) and img.std() > 1


@pytest.mark.parametrize("kernel", ["raster", "raster-gl"])
def test_render_cli_raster_to_png(tmp_path, kernel):
    out = str(tmp_path / "raster.png")
    assert render_cli.main(SMALL + ["-kernel", kernel, "-out", out]) == 0
    with open(out, "rb") as f:
        img = decode_png(f.read())
    assert img.shape == (24, 32, 3) and img.std() > 1


@pytest.mark.parametrize("args,message", [
    (["-kernel", "bogus"], "invalid choice"),
    (["-cpu", "-mesh", "7x1"], "height 480 not divisible by data axis 7"),
    (["-frames", "1"], "-cpu"),
])
def test_render_cli_refusals_exit_2(monkeypatch, capsys, args, message):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        render_cli.main(args)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_render_cli_checkpoint_resume_bit_identical(tmp_path, caplog):
    resume, straight = str(tmp_path / "resume.npz"), str(tmp_path / "straight.npz")
    every = ["-checkpoint-every", "2", "-out", str(tmp_path / "x.ppm")]
    caplog.set_level(logging.INFO)
    assert render_cli.main(SMALL + ["-frames", "2", "-checkpoint", resume] + every) == 0
    assert render_cli.main(SMALL + ["-frames", "4", "-checkpoint", resume] + every) == 0
    assert f"resumed {resume} at frame 2" in caplog.text
    assert render_cli.main(SMALL + ["-frames", "4", "-checkpoint", straight] + every) == 0
    with np.load(resume) as a, np.load(straight) as b:
        assert int(a["frame"]) == int(b["frame"]) == 4
        np.testing.assert_array_equal(a["accum"], b["accum"])


def test_optimize_cli_selftest_lowers_the_loss(tmp_path, caplog):
    caplog.set_level(logging.INFO)
    rc = optimize_cli.main(["-cpu", "-selftest", "albedo", "-steps", "4", "-width", "16",
                            "-height", "12", "-spp", "1", "-bounces", "2",
                            "-out", str(tmp_path / "o.png")])
    losses = [float(x) for x in re.findall(r"step \d+: loss ([0-9.]+)", caplog.text)]
    err = float(re.search(r"vs truth: ([0-9.]+)", caplog.text).group(1))
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert rc == (0 if err < 0.1 else 1)
    with open(tmp_path / "o.png", "rb") as f:
        assert decode_png(f.read()).shape == (12, 16, 3)


def test_optimize_cli_target_and_viewer_burst(tmp_path):
    target = str(tmp_path / "target.ppm")
    assert render_cli.main(["-cpu", "-width", "24", "-height", "18", "-bounces", "2",
                            "-frames", "1", "-out", target]) == 0
    assert optimize_cli.main(["-cpu", "-target", target, "-params", "albedo,roughness",
                              "-steps", "2", "-width", "24", "-height", "18", "-spp", "1",
                              "-bounces", "2", "-out", str(tmp_path / "rec.ppm")]) == 0
    out = str(tmp_path / "viewer.ppm")
    assert viewer.main(["-cpu", "-frames", "2", "-width", "32", "-height", "24",
                        "-bounces", "2", "-out", out]) == 0
    with open(out, "rb") as f:
        assert decode_ppm(f.read()).shape == (24, 32, 3)
