"""The TIFF/DDS/QOI fixture scene (tests/goldens/tiffdds/, made by
tools/make_tiffdds_fixtures.py: helmet.scn's five map slots as a DXT5 DDS,
a BC5 DDS, an LZW TIFF with predictor 2 in strips, a tiled big-endian
deflate TIFF and an RGBA QOI) through the port on the CPU, by the checks
of tests/test_torch_image_scene.py:

* in a fresh interpreter, loading it imports no PIL module (and no jax),
  substitutes no file, and its maps have the sizes the generator wrote;
* its textured render at 64x48, 4 frames of 1 spp, against tracy_tpu's
  (XLA, accel 'bvh') on the CPU by the linear block means of
  tests/test_ref_parity.py: |mean| <= 0.01, p95 <= 0.02, max <= 0.05.
"""

import os

from test_torch_image_scene import REPO, loads_without_pil, render_matches_tracy_tpu

SCN = os.path.join(REPO, "tests", "goldens", "tiffdds", "tiffdds.scn")
MAPS = [(256, 256), (256, 256), (200, 200), (96, 128), (256, 256)]


def test_tiffdds_fixture_loads_without_pil():
    loads_without_pil(SCN, MAPS)


def test_tiffdds_fixture_render_matches_tracy_tpu():
    render_matches_tracy_tpu(SCN)
