"""Make the IPTC/NAA texture fixture of tests/goldens/iptc/.

    cd tools && JAX_PLATFORMS=cpu python make_iptc_fixtures.py

Writes, from seed 2222, five maps laid out as helmet.scn's (B and E sRGB,
N, R, M), each an IPTC/NAA image whose embedded stream is of a format that
tracy_tpu reads through PIL's IptcImageFile and the port decodes without
it (utils/image_io.py::_iptc_rgba):

- basecolor.iim: a 256x256 run-length TGA, the picture;
- normal.iim: a 256x256 QOI, the picture;
- roughness.iim: a 256x256 grey SGI in a CMYK image's band field 0, which
  PIL reads as the last band, K (so the map is 255 - grey in every
  channel);
- metalness.iim: a 128x128 grey JP2 in band 1 (R) of an RGB image;
- emissive.iim: a 128x128 AVIF, the picture;

then iptc.scn, which uses them on a sphere and a box over an untextured
floor, and iptc.npz: tracy_tpu's render of that scene on the CPU
(tools/make_texture_fixtures.py's settings: accel 'bvh', rng 'fast',
256x192, 24 frames of 1 spp) in tests/goldens/ref's format. The IPTC and
SGI writers are the tests' (tests/test_torch_image_legacy_kinds.py,
test_torch_image_legacy.py). Checks that the port loads each map as
tracy_tpu does. Needs PIL and jax.
"""

from __future__ import annotations

import io
import os
import sys

import numpy as np
from PIL import Image

from make_format_fixtures import rect_pattern, render_golden
from make_texture_fixtures import REPO, u8

sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
from test_torch_image_legacy import sgi  # noqa: E402
from test_torch_image_legacy_kinds import iptc  # noqa: E402

OUT = os.path.join(REPO, "tests", "goldens", "iptc")
SEED = 2222
SIZES = [(256, 256), (256, 256), (256, 256), (128, 128), (128, 128)]  # rows, columns

SCN = """# IPTC/NAA fixture: helmet.scn's five map slots (B and E sRGB, N, R, M) as
# IPTC images holding a TGA, a QOI, a grey SGI in band field 0 of CMYK, a
# grey JP2 in band 1 of RGB and an AVIF, made by tools/make_iptc_fixtures.py.
SCN IPTC fixture
OUT 256 192
CAM (0, 1.0, 3.2) (0.0, 0.55, 0.0) (0.0, 1.0, 0.0) 45.0
MTL Textured (1.0, 1.0, 1.0) 1 0
MTL Floor (0.4, 0.4, 0.4) 1 0
TEX Textured B basecolor.iim SRGB
TEX Textured N normal.iim
TEX Textured R roughness.iim
TEX Textured M metalness.iim
TEX Textured E emissive.iim SRGB
SKY (0.7, 0.8, 1.0)
OBJ S (-0.45, 0.6, 0) 0.6 Textured
OBJ B (0.35, 0.0, -0.4) (1.15, 0.8, 0.4) Textured
OBJ B (-20.0, -0.2, -20.0) (20.0, 0, 20.0) Floor
"""


def pil(img: np.ndarray, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt, **kw)
    return buf.getvalue()


def put(name: str, data: bytes):
    with open(os.path.join(OUT, name), "wb") as f:
        f.write(data)


def write_maps(rng):
    os.makedirs(OUT, exist_ok=True)
    (bh, bw), (nh, nw), (rh, rw), (mh, mw), (eh, ew) = SIZES
    put("basecolor.iim", iptc(bw, bh, pil(u8(rect_pattern(bh, bw, rng, 3)), "TGA", rle=True),
                              compression=5))
    bump = rect_pattern(nh, nw, rng, 2) - 0.5
    nrm = np.concatenate([0.5 + 0.3 * bump, np.ones_like(bump[..., :1])], axis=-1)
    put("normal.iim", iptc(nw, nh, pil(u8(nrm), "QOI"), compression=5))
    rough = u8(0.2 + 0.6 * rect_pattern(rh, rw, rng, 1))
    put("roughness.iim", iptc(rw, rh, sgi(rough), 4, 1, 0, compression=5))
    metal = u8(rect_pattern(mh, mw, rng, 1))[..., 0]
    put("metalness.iim", iptc(mw, mh, pil(metal, "JPEG2000"), 3, 1, 1, compression=5))
    glow = rect_pattern(eh, ew, rng, 3)
    put("emissive.iim", iptc(ew, eh, pil(u8(np.where(glow > 0.6, glow, 0.0)), "AVIF",
                                         quality=90), compression=5))
    with open(os.path.join(OUT, "iptc.scn"), "w") as f:
        f.write(SCN)


def check_port():
    """Each map through the port equals tracy_tpu's load."""
    from tracy_tpu.scene.textures import load_image_rgba as jax_load
    from tracy_tpu_torch.utils.image_io import decode_image_rgba

    for name in ("basecolor.iim", "normal.iim", "roughness.iim", "metalness.iim",
                 "emissive.iim"):
        path = os.path.join(OUT, name)
        with open(path, "rb") as f:
            got = decode_image_rgba(f.read()).astype(np.float32) / 255.0
        np.testing.assert_array_equal(got, jax_load(path), err_msg=name)


def main():
    write_maps(np.random.default_rng(SEED))
    check_port()
    render_golden(OUT, "iptc", SIZES)
    sizes = {n: os.path.getsize(os.path.join(OUT, n)) for n in sorted(os.listdir(OUT))}
    print(sizes, sum(sizes.values()), "bytes")


if __name__ == "__main__":
    main()
