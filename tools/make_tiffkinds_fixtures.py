"""Make the TIFF-kind texture fixtures of tests/goldens/tiffkinds/.

    cd tools && JAX_PLATFORMS=cpu python make_tiffkinds_fixtures.py

Writes, from seed 6543, five maps laid out as helmet.scn's (B and E sRGB,
N, R, M), each a TIFF kind that tracy_tpu reads through PIL's libtiff and
the port decodes without it (csrc/image_tiff.cpp, image_xz.cpp,
image_zstd.cpp, image_decode.cpp):

- basecolor.tif: 256x256 JPEG YCbCr 2x2, 16-row strips, libtiff's encoder;
- normal.tif: 256x256 RGB, ZSTD with predictor 2, PIL's writer;
- roughness.tif: 192x256 32-bit float grey, LZMA with the floating-point
  predictor, PIL's writer;
- metalness.tif: 128x128 1-bit, CCITT Group 4, PIL's writer;
- emissive.tif: 128x128 YCbCr 2x1, deflate, libtiff's encoder;

then tiffkinds.scn, which uses them on a sphere and a box over an
untextured floor, and tiffkinds.npz: tracy_tpu's render of that scene on
the CPU (tools/make_texture_fixtures.py's settings: accel 'bvh', rng
'fast', 256x192, 24 frames of 1 spp). Besides, four 2048x2048 maps that
chip_smoke.py decodes and times on the card's host: big_float.tif (float,
deflate with the floating-point predictor), big_jpeg.tif (JPEG YCbCr 2x2),
big_lzma.tif and big_zstd.tif (RGB). The encoders are
tests/test_torch_image_tiff_kinds.py's. Needs PIL and jax.
"""

from __future__ import annotations

import os
import sys

import numpy as np
from PIL import Image

from make_format_fixtures import rect_pattern, render_golden
from make_texture_fixtures import REPO, u8

sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
from test_torch_image_tiff_kinds import jpeg_ycbcr_tiff, libtiff_file, pil_tiff, ycbcr_strips  # noqa: E402

OUT = os.path.join(REPO, "tests", "goldens", "tiffkinds")
SEED = 6543
SIZES = [(256, 256), (256, 256), (192, 256), (128, 128), (128, 128)]  # rows, columns
BIG = 2048

SCN = """# TIFF-kind fixture: helmet.scn's five map slots (B and E sRGB, N, R, M)
# as JPEG, ZSTD, float LZMA, CCITT Group 4 and YCbCr TIFFs, made by
# tools/make_tiffkinds_fixtures.py.
SCN TIFF kinds fixture
OUT 256 192
CAM (0, 1.0, 3.2) (0.0, 0.55, 0.0) (0.0, 1.0, 0.0) 45.0
MTL Textured (1.0, 1.0, 1.0) 1 0
MTL Floor (0.4, 0.4, 0.4) 1 0
TEX Textured B basecolor.tif SRGB
TEX Textured N normal.tif
TEX Textured R roughness.tif
TEX Textured M metalness.tif
TEX Textured E emissive.tif SRGB
SKY (0.7, 0.8, 1.0)
OBJ S (-0.45, 0.6, 0) 0.6 Textured
OBJ B (0.35, 0.0, -0.4) (1.15, 0.8, 0.4) Textured
OBJ B (-20.0, -0.2, -20.0) (20.0, 0, 20.0) Floor
"""


def put(name: str, data: bytes):
    with open(os.path.join(OUT, name), "wb") as f:
        f.write(data)


def ycbcr_of(rgb: np.ndarray, sub):
    """BT.601 full-range Y, Cb, Cr of uint8 RGB, chroma averaged over each
    sub_h x sub_v block."""
    f = rgb.astype(np.float64)
    y = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    cb, cr = (f[..., 2] - y) / 1.772 + 128, (f[..., 0] - y) / 1.402 + 128
    (sh, sv), (h, w) = sub, y.shape

    def down(c):
        c = np.pad(c, ((0, -h % sv), (0, -w % sh)), mode="edge")
        return c.reshape(c.shape[0] // sv, sv, c.shape[1] // sh, sh).mean((1, 3))

    return [np.clip(np.round(c), 0, 255).astype(np.uint8) for c in (y, down(cb), down(cr))]


def write_maps(rng):
    os.makedirs(OUT, exist_ok=True)
    (bh, bw), (nh, nw), (rh, rw), (mh, mw), (eh, ew) = SIZES
    put("basecolor.tif", jpeg_ycbcr_tiff(u8(rect_pattern(bh, bw, rng, 3)), (2, 2), quality=85))
    bump = rect_pattern(nh, nw, rng, 2) - 0.5
    nrm = np.concatenate([0.5 + 0.3 * bump, np.ones_like(bump[..., :1])], axis=-1)
    put("normal.tif", pil_tiff(Image.fromarray(u8(nrm)), compression="zstd",
                               tiffinfo={317: 2}))
    rough = (rect_pattern(rh, rw, rng, 1)[..., 0] * 255).astype(np.float32)
    put("roughness.tif", pil_tiff(Image.fromarray(rough), compression="lzma",
                                  tiffinfo={317: 3}))
    metal = rect_pattern(mh, mw, rng, 1)[..., 0] > 0.5
    put("metalness.tif", pil_tiff(Image.fromarray(metal), compression="group4"))
    glow = rect_pattern(eh, ew, rng, 3)
    glow = u8(np.where(glow > 0.6, glow, 0.0))
    y, cb, cr = ycbcr_of(glow, (2, 1))
    put("emissive.tif", libtiff_file(ew, eh, 8, 3, 8, 6, 16, ycbcr_strips(y, cb, cr, (2, 1), 16),
                                     [(530, 2, 1)]))
    with open(os.path.join(OUT, "tiffkinds.scn"), "w") as f:
        f.write(SCN)


def write_big(rng):
    """The four 2048x2048 maps of chip_smoke.py's decode timing: a smooth
    pattern of three sinusoids (predictor 2 leaves small differences, so
    the files stay small), the float one at a quarter of the size's steps."""
    y, x = np.mgrid[0:BIG, 0:BIG].astype(np.float32) / BIG
    chans = []
    for _ in range(3):
        a, b, c = rng.uniform(2, 9, 3)
        chans.append(0.5 + 0.3 * np.sin(a * x + c) * np.cos(b * y)
                     + 0.15 * np.sin((a + b) * (x + y)))
    smooth = np.clip(np.stack(chans, -1), 0, 1)
    rgb = u8(smooth)
    put("big_float.tif", pil_tiff(Image.fromarray(np.round(smooth[..., 0] * 1020) / 4),
                                  compression="tiff_adobe_deflate", tiffinfo={317: 3}))
    put("big_jpeg.tif", jpeg_ycbcr_tiff(rgb, (2, 2), rows_per_strip=64, quality=80))
    put("big_lzma.tif", pil_tiff(Image.fromarray(rgb), compression="lzma", tiffinfo={317: 2}))
    put("big_zstd.tif", pil_tiff(Image.fromarray(rgb), compression="zstd", tiffinfo={317: 2}))


def main():
    rng = np.random.default_rng(SEED)
    write_maps(rng)
    write_big(rng)
    render_golden(OUT, "tiffkinds", SIZES)
    sizes = {n: os.path.getsize(os.path.join(OUT, n)) for n in sorted(os.listdir(OUT))}
    print(sizes, sum(sizes.values()), "bytes")


if __name__ == "__main__":
    main()
