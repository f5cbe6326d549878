"""The JPEG 2000 fixture scene (tests/goldens/jpeg2000/, made by
tools/make_jpeg2000_fixtures.py: helmet.scn's five map slots as a 9/7 ICT
JP2 in 128-px tiles with 3 layers, a 5/3 RCT raw codestream in RPCL with
precincts, a grey JP2, a signed raw codestream in PCRL and an RGBA JP2 in
CPRL with PLT markers) through the port on the CPU, by the checks of
tests/test_torch_image_scene.py:

* in a fresh interpreter, loading it imports no PIL module (and no jax),
  substitutes no file, and its maps have the sizes the generator wrote;
* its textured render at 64x48, 4 frames of 1 spp, against tracy_tpu's
  (XLA, accel 'bvh') on the CPU by the linear block means of
  tests/test_ref_parity.py: |mean| <= 0.01, p95 <= 0.02, max <= 0.05.
"""

import os

from test_torch_image_scene import REPO, loads_without_pil, render_matches_tracy_tpu

SCN = os.path.join(REPO, "tests", "goldens", "jpeg2000", "jpeg2000.scn")
MAPS = [(256, 256), (256, 256), (256, 256), (128, 128), (128, 128)]


def test_jpeg2000_fixture_loads_without_pil():
    loads_without_pil(SCN, MAPS)


def test_jpeg2000_fixture_render_matches_tracy_tpu():
    render_matches_tracy_tpu(SCN)
