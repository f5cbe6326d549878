"""The port's raster preview (raster/rasterizer.py) against tracy_tpu's,
on the CPU: the triangle set-up, every AOV view on the default scene and
cornell, and the port's own checks. Shaded mode, the bilinear filter and a
scene around the eye are in tests/test_torch_raster_shaded.py, the
triangle set-up in tests/test_torch_raster_setup.py.

tracy_tpu's render_raster runs under jax.jit, where XLA fuses the edge,
depth and interpolation arithmetic (multiply-adds contracted); the port's
plain torch ops round each operation, as XLA's eager ops do. So:

* the triangle set-up equals tracy_tpu's eager one bit for bit
  (tests/test_torch_raster_setup.py); the z interpolator, an XLA dot
  there whose terms cancel, is held through the depth view below;
* against the jitted render_raster at 64x48, for each AOV on the default
  scene and on cornell: coverage (the depth view > 0) equal on >= 99.5% of
  pixels; where both cover, colours within 1e-5 (normals, a
  perspective-correct interpolation that magnifies the inverse matrix's
  ulps, within 1e-3) on >= 99.5% of those pixels (an ulp can move the
  winner on an edge);
* the port's own checks of tests/test_raster.py: coverage and depth order,
  back-face culling, chunking invariance, and coverage equal to K1's hit
  mask on rays through the pixel centres (>= 99.5% of pixels).
"""

import os

import numpy as np
import pytest
import torch

from tracy_tpu.config import RenderConfig as JConfig
from tracy_tpu.raster import render_raster as j_render_raster
from tracy_tpu.scene.scn_parser import default_scene as j_default_scene
from tracy_tpu.scene.scn_parser import load_scene as j_load_scene
from tracy_tpu_torch import RenderConfig
from tracy_tpu_torch.accel.tables import build_tables
from tracy_tpu_torch.core.camera import pixel_samples_rows
from tracy_tpu_torch.ops import intersect as k1
from tracy_tpu_torch.raster import render_raster
from tracy_tpu_torch.scene import SceneBuilder, default_scene, from_jax_arrays
from test_torch_textures import textured_builders

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCN = os.path.join(REPO, "tests", "goldens", "scn")
AOVS = ("beauty", "normals", "metalness", "roughness", "emissive", "depth")
W, H = 64, 48


def _jax_scene(name):
    if name == "default":
        return j_default_scene(W, H).build()
    if name == "around":  # spheres behind the eye (z = 4) and one through its plane
        b = j_default_scene(W, H)
        for i, (x, z) in enumerate(((-1.5, 6.0), (1.0, 7.5), (2.0, 4.0), (0.0, 5.0))):
            b.add_sphere((x, 0.5, z), 0.8, 1 + i % 3, steps=12)
        return b.build()
    if name == "textured":
        return textured_builders()[0].build()
    b = j_load_scene(os.path.join(SCN, f"{name}.scn"))
    b.width, b.height = W, H
    return b.build()


@pytest.fixture(scope="module")
def raster_both():
    """(scene name, aov, shaded) -> (tracy_tpu's image, the port's), cached."""
    scenes, out = {}, {}

    def get(name, aov, shaded=False):
        if name not in scenes:
            js = _jax_scene(name)
            scenes[name] = (js, from_jax_arrays(js, device="cpu"))
        key = (name, aov, shaded)
        if key not in out:
            js, s = scenes[name]
            ref = j_render_raster(js, JConfig(width=js.width, height=js.height, aov=aov,
                                              tonemap="none"), shaded=shaded)
            got = render_raster(s, RenderConfig(width=js.width, height=js.height, aov=aov,
                                                tonemap="none"), shaded=shaded)
            assert got.shape == (js.height, js.width, 3) and got.dtype == torch.float32
            out[key] = (np.asarray(ref), got.numpy())
        return out[key]

    return get


@pytest.mark.parametrize("name", ["default", "cornell"])
@pytest.mark.parametrize("aov", AOVS)
def test_raster_matches_jax(raster_both, name, aov):
    ref_d, got_d = raster_both(name, "depth")
    cov_r, cov_g = ref_d[..., 0] > 0, got_d[..., 0] > 0
    assert (cov_r == cov_g).mean() >= 0.995
    assert 0.05 < cov_g.mean() < 0.999
    ref, got = raster_both(name, aov)
    both = cov_r & cov_g
    tol = 1e-3 if aov == "normals" else 1e-5
    close = (np.abs(got - ref) <= tol).all(-1)
    assert close[both].mean() >= 0.995, close[both].mean()
    assert (got[~cov_g] == 0).all()


def _two_triangles(w=64, h=48):
    b = SceneBuilder(w, h)
    b.set_sky_color((0, 0, 0))
    red = b.add_material((0.8, 0.1, 0.1), 1.0, 0.0)
    blue = b.add_material((0.1, 0.1, 0.8), 1.0, 0.0)
    b.add_triangle((-3, -3, -5), (3, -3, -5), (0, 3, -5), red)
    b.add_triangle((-1, 0.2, -3), (1, 0.2, -3), (0, 1.5, -3), blue)
    b.set_camera(eye=(0, 0, 2), center=(0, 0, -5), up=(0, 1, 0), fov_degrees=60)
    return b.build(device="cpu")


def test_raster_coverage_and_depth_order():
    img = render_raster(_two_triangles(), RenderConfig(width=64, height=48, tonemap="none"))
    assert img.shape == (48, 64, 3)
    assert img[35, 32, 0] > 0.5 and img[35, 32, 2] < 0.3  # the red one below
    assert img[18, 32, 2] > 0.5 and img[18, 32, 0] < 0.3  # the blue one wins in front
    assert (img[0, 0] == 0).all() and (img[-1, -1] == 0).all()


def test_raster_backface_culled():
    b = SceneBuilder(32, 32)
    m = b.add_material((1, 1, 1), 1.0, 0.0)
    b.add_triangle((-2, -2, -5), (0, 2, -5), (2, -2, -5), m)  # faces away
    b.set_camera(eye=(0, 0, 2), center=(0, 0, -5), up=(0, 1, 0), fov_degrees=60)
    img = render_raster(b.build(device="cpu"), RenderConfig(width=32, height=32))
    assert (img == 0).all()


def test_raster_chunking_invariance():
    scene = default_scene(32, 24).build(device="cpu")
    cfg = RenderConfig(width=32, height=24, tonemap="none")
    a = render_raster(scene, cfg, tri_chunk=16)
    b = render_raster(scene, cfg, tri_chunk=999)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_raster_coverage_matches_pixel_centre_hits():
    scene = default_scene(W, H).build(device="cpu")
    cfg = RenderConfig(width=W, height=H, aov="depth")
    covered = render_raster(scene, cfg)[..., 0] > 0
    half = torch.full((H, W), 0.5)
    s, t = pixel_samples_rows(W, H, torch.arange(H, dtype=torch.int32), half, half)
    o, d = scene.camera.generate_rays(s.reshape(-1), t.reshape(-1))
    hit = k1.intersect(o.contiguous(), d.contiguous(), torch.ones(W * H, dtype=torch.bool),
                       build_tables(scene))
    assert (hit.hit.mask.view(H, W) == covered).float().mean() >= 0.995
