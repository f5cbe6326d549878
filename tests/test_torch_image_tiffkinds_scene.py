"""The TIFF-kind fixture scene (tests/goldens/tiffkinds/, made by
tools/make_tiffkinds_fixtures.py: helmet.scn's five map slots as JPEG
YCbCr 2x2, ZSTD with predictor 2, float LZMA with the floating-point
predictor, CCITT Group 4 and YCbCr 2x1 TIFFs) through the port on the CPU,
by the checks of tests/test_torch_image_scene.py:

* in a fresh interpreter, loading it imports no PIL module (and no jax),
  substitutes no file, and its maps have the sizes the generator wrote;
* its textured render at 64x48, 4 frames of 1 spp, against tracy_tpu's
  (XLA, accel 'bvh') on the CPU by the linear block means of
  tests/test_ref_parity.py: |mean| <= 0.01, p95 <= 0.02, max <= 0.05.
"""

import os

from test_torch_image_scene import REPO, loads_without_pil, render_matches_tracy_tpu

SCN = os.path.join(REPO, "tests", "goldens", "tiffkinds", "tiffkinds.scn")
MAPS = [(256, 256), (256, 256), (192, 256), (128, 128), (128, 128)]


def test_tiffkinds_fixture_loads_without_pil():
    loads_without_pil(SCN, MAPS)


def test_tiffkinds_fixture_render_matches_tracy_tpu():
    render_matches_tracy_tpu(SCN)
