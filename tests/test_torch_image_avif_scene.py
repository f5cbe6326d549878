"""The AVIF fixture scene (tests/goldens/avif/, made by
tools/make_avif_fixtures.py: helmet.scn's five map slots as 4:2:0 at PIL's
defaults, 4:4:4 in 2x2 tiles with CDEF and loop restoration, screen
content with palettes and intra block copy, quantizer matrices with delta
q, and RGBA with an alpha item) through the port on the CPU, by the checks
of tests/test_torch_image_scene.py:

* in a fresh interpreter, loading it imports no PIL module (and no jax),
  substitutes no file, and its maps have the sizes the generator wrote;
* its textured render at 64x48, 4 frames of 1 spp, against tracy_tpu's
  (XLA, accel 'bvh') on the CPU by the linear block means of
  tests/test_ref_parity.py: |mean| <= 0.01, p95 <= 0.02, max <= 0.05.
"""

import os

from test_torch_image_scene import REPO, loads_without_pil, render_matches_tracy_tpu

SCN = os.path.join(REPO, "tests", "goldens", "avif", "avif.scn")
MAPS = [(256, 256), (256, 256), (192, 256), (128, 128), (128, 128)]


def test_avif_fixture_loads_without_pil():
    loads_without_pil(SCN, MAPS)


def test_avif_fixture_render_matches_tracy_tpu():
    render_matches_tracy_tpu(SCN)


# The same slots as 10- and 12-bit files (tests/goldens/avif/deep/: 4:2:0 at
# 10 bits, 4:4:4 at 12 in 2x2 tiles with CDEF, screen content at 10 bits,
# grey at 12, RGBA at 10 with an alpha item).
SCN10 = os.path.join(REPO, "tests", "goldens", "avif", "deep", "avif10.scn")


def test_avif10_fixture_loads_without_pil():
    loads_without_pil(SCN10, MAPS)


def test_avif10_fixture_render_matches_tracy_tpu():
    render_matches_tracy_tpu(SCN10)
