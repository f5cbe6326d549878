"""The port's raster preview in shaded mode, its bilinear texture filter,
and a scene around the eye, against tracy_tpu's on the CPU (the contract
of tests/test_torch_raster.py, whose fixture this file shares).

* Shaded mode (the ubershader, the sky pass) on spheres.scn: the same
  colours where both cover and where neither does, within 1e-5. Its
  49,600 triangles put about 50 triangle edges in each covered pixel, and
  the jitted edges leave cracks between neighbours an ulp apart: every
  pixel tracy_tpu covers the port covers, and tracy_tpu misses at most
  1.5% of the port's (1.2% measured).
* Shaded mode on the textured fixture of tests/test_torch_textures.py
  (bilinear basecolor, normal, roughness, metalness and emissive maps of
  20x24 noise): coverage equal on >= 99.5% of pixels; where both cover at
  the same depth, colours within 2e-3 on >= 98% of pixels (the uv carries
  the interpolation's ulps, and the noise maps turn 1e-5 of uv into up to
  about 1e-3 of colour; 2 of 146 such pixels measured beyond it, both in
  the sphere's thin pole triangles, whose perspective-correct uv is
  ill-conditioned); the background equal.
* A scene around the eye (spheres behind it, one crossing its plane): the
  port's image equals its own with every chunk evaluated over the whole
  image, bit for bit (the box culling skips no covered pixel), and
  tracy_tpu's under the contract of tests/test_torch_raster.py.
* sample_bilinear on random uv (wrapping both ways) and texture ids (-1
  included) within 1e-6 of tracy_tpu's jitted one, and equal to its eager
  one bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracy_tpu.render.texture import sample_bilinear as j_sample_bilinear
from tracy_tpu_torch import RenderConfig
from tracy_tpu_torch.raster import render_raster
from tracy_tpu_torch.render.texture import sample_bilinear
from tracy_tpu_torch.scene import from_jax_arrays
from test_torch_raster import H, W, _jax_scene, raster_both  # noqa: F401 (a fixture)
from test_torch_textures import textured_builders

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["spheres", "textured"])
def test_raster_shaded_matches_jax(raster_both, name):
    ref_d, got_d = raster_both(name, "depth")
    cov_r, cov_g = ref_d[..., 0] > 0, got_d[..., 0] > 0
    ref, got = raster_both(name, "beauty", shaded=True)
    neither = ~cov_r & ~cov_g
    np.testing.assert_allclose(got[neither], ref[neither], rtol=0, atol=1e-5)
    assert got[neither].std() > 0  # the sky pass, not a constant
    if name == "spheres":
        assert (cov_g | ~cov_r).mean() >= 0.999
        assert (cov_g & ~cov_r).mean() <= 0.015
        both = cov_r & cov_g
        np.testing.assert_allclose(got[both], ref[both], rtol=0, atol=1e-5)
    else:
        assert (cov_r == cov_g).mean() >= 0.995
        same = cov_r & cov_g & (ref_d[..., 0] == got_d[..., 0])
        assert same.mean() > 0.1
        close = (np.abs(got - ref) <= 2e-3).all(-1)
        assert close[same].mean() >= 0.98, close[same].mean()


def test_raster_around_the_eye(raster_both, monkeypatch):
    from tracy_tpu_torch.raster import rasterizer

    aov = "beauty"  # every material's albedo is > 0: coverage is any channel > 0
    ref, got = raster_both("around", aov)
    cov_r, cov_g = ref[..., 0] > 0, got[..., 0] > 0
    assert (cov_r == cov_g).mean() >= 0.995
    close = (np.abs(got - ref) <= 1e-5).all(-1)
    assert close[cov_r & cov_g].mean() >= 0.995
    setup = rasterizer._triangle_setup

    def whole_image(*args):
        *rest, boxes = setup(*args)
        return (*rest, torch.full_like(boxes, float("nan")))

    monkeypatch.setattr(rasterizer, "_triangle_setup", whole_image)
    s = from_jax_arrays(_jax_scene("around"), device="cpu")
    full = render_raster(s, RenderConfig(width=W, height=H, aov=aov, tonemap="none"))
    np.testing.assert_array_equal(full.numpy(), got)


def test_sample_bilinear_matches_jax():
    js = textured_builders()[0].build()
    s = from_jax_arrays(js, device="cpu")
    rng = np.random.default_rng(3)
    n = 4096
    uv = rng.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)
    tid = rng.integers(-1, js.tex_table.shape[0], n).astype(np.int32)
    got = sample_bilinear(s.tex_data, s.tex_table, torch.as_tensor(tid),
                          torch.as_tensor(uv)).numpy()
    args = (js.tex_data, js.tex_table, jnp.asarray(tid), jnp.asarray(uv))
    np.testing.assert_allclose(got, np.asarray(jax.jit(j_sample_bilinear)(*args)),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got, np.asarray(j_sample_bilinear(*args)))
