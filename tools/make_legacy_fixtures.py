"""Make the small raw and run-length texture fixtures of tests/goldens/legacy/.

    cd tools && JAX_PLATFORMS=cpu python make_legacy_fixtures.py

Writes, from seed 4321, five maps laid out as helmet.scn's (B and E sRGB,
N, R, M), each a format that tracy_tpu reads through PIL and the port
decodes without it (csrc/image_legacy.cpp):

- basecolor.pcx: 256x256 24-bit PCX, three planes, run-length coded (PIL's
  writer);
- normal.sgi: 256x256 RGB SGI, run-length coded;
- roughness.im: 256x256 IM, mode L (PIL's writer);
- metalness.ras: 128x128 8-bit Sun raster with a palette, run-length coded
  (type 2);
- emissive.xpm: 128x128 XPM of at most 256 colours, two characters a
  pixel;

then legacy.scn, which uses them on a sphere and a box over an untextured
floor, and legacy.npz: tracy_tpu's render of that scene on the CPU
(tools/make_texture_fixtures.py's settings: accel 'bvh', rng 'fast',
256x192, 24 frames of 1 spp) in tests/goldens/ref's format. Besides, small
files of the other formats, which chip_smoke.py decodes and times on the
card's host, not in the scene: DCX, MSP v2, XBM, PIXAR, SPIDER, FITS
(BITPIX 8 and 16), GBR, McIdas, XV thumbnail, IMT, IPTC and FLC. The
packers are the tests' (tests/test_torch_image_legacy.py and
test_torch_image_legacy_kinds.py). No map uses a variant where the
packages part (ROADMAP, hazards). Needs PIL and jax.
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
from test_torch_image_legacy import (dcx, fits, gbr, hex_colours, imt, mcidas,  # noqa: E402
                                     msp_v2, pixar, sgi, spider, sun, xpm, xvthumb)
from test_torch_image_legacy_kinds import brun, colour_chunk, fli, iptc  # noqa: E402

OUT = os.path.join(REPO, "tests", "goldens", "legacy")
SEED = 4321
SIZES = [(256, 256), (256, 256), (256, 256), (128, 128), (128, 128)]  # rows, columns
# Decoded and timed on the card's host; not in the scene.
EXTRA = ("pages.dcx", "paint.msp", "mask.xbm", "image.pxr", "density.spi", "plate8.fits",
         "plate16.fits", "brush.gbr", "area.mcidas", "thumb.xv", "tools.imt", "photo.iim",
         "anim.flc")

SCN = """# Legacy-format fixture: helmet.scn's five map slots (B and E sRGB, N, R,
# M) as a PCX, an SGI, an IM, a Sun raster and an XPM, made by
# tools/make_legacy_fixtures.py.
SCN Legacy fixture
OUT 256 192
CAM (0, 1.0, 3.2) (0.0, 0.55, 0.0) (0.0, 1.0, 0.0) 45.0
MTL Textured (1.0, 1.0, 1.0) 1 0
MTL Floor (0.4, 0.4, 0.4) 1 0
TEX Textured B basecolor.pcx SRGB
TEX Textured N normal.sgi
TEX Textured R roughness.im
TEX Textured M metalness.ras
TEX Textured E emissive.xpm SRGB
SKY (0.7, 0.8, 1.0)
OBJ S (-0.45, 0.6, 0) 0.6 Textured
OBJ B (0.35, 0.0, -0.4) (1.15, 0.8, 0.4) Textured
OBJ B (-20.0, -0.2, -20.0) (20.0, 0, 20.0) Floor
"""


def put(name: str, data: bytes):
    with open(os.path.join(OUT, name), "wb") as f:
        f.write(data)


def pil(img: Image.Image, fmt: str) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt)
    return buf.getvalue()


def quantized(rgb: np.ndarray, colours: int):
    """(index rows, palette RGB) of rgb at most `colours` colours."""
    p = Image.fromarray(rgb).quantize(colours)
    pal = np.asarray(p.getpalette()[:3 * colours], np.uint8).reshape(-1, 3)
    return np.asarray(p), pal


def write_maps(rng):
    os.makedirs(OUT, exist_ok=True)
    (bh, bw), (nh, nw), (rh, rw), (mh, mw), (eh, ew) = SIZES
    put("basecolor.pcx", pil(Image.fromarray(u8(rect_pattern(bh, bw, rng, 3))), "PCX"))
    bump = rect_pattern(nh, nw, rng, 2) - 0.5
    nrm = np.concatenate([0.5 + 0.3 * bump, np.ones_like(bump[..., :1])], axis=-1)
    put("normal.sgi", sgi(u8(nrm)))
    put("roughness.im", pil(Image.fromarray(u8(rect_pattern(rh, rw, rng, 1))[..., 0]), "IM"))
    idx, pal = quantized(u8(rect_pattern(mh, mw, rng, 3)), 64)
    put("metalness.ras", sun(mw, mh, 8, idx, 2, pal))
    glow = rect_pattern(eh, ew, rng, 3)
    idx, pal = quantized(u8(np.where(glow > 0.6, glow, 0.0)), 200)
    put("emissive.xpm", xpm(idx, hex_colours(pal), cpp=2))
    with open(os.path.join(OUT, "legacy.scn"), "w") as f:
        f.write(SCN)


def write_extra(rng):
    """The files the card's host decodes and times beside the maps."""
    def rgb(h, w):
        return u8(rect_pattern(h, w, rng, 3))

    def grey(h, w):
        return u8(rect_pattern(h, w, rng, 1))[..., 0]

    put("pages.dcx", dcx([pil(Image.fromarray(rgb(96, 96)), "PCX"),
                          pil(Image.fromarray(rgb(32, 32)), "PCX")]))
    put("paint.msp", msp_v2(grey(96, 120) > 128))
    put("mask.xbm", pil(Image.fromarray(grey(64, 72)).convert("1"), "XBM"))
    put("image.pxr", pixar(rgb(64, 64)))
    put("density.spi", spider(grey(64, 64).astype(np.float32) * 1.25 - 20.0))
    put("plate8.fits", fits(grey(64, 80), 8))
    put("plate16.fits", fits(grey(64, 80).astype(np.int64) * 3 - 100, 16))
    put("brush.gbr", gbr(u8(rect_pattern(48, 48, rng, 4))))
    put("area.mcidas", mcidas(grey(64, 64).astype(np.int64) * 2, 2, pad=8))
    idx, _ = quantized(rgb(48, 64), 256)
    put("thumb.xv", xvthumb(idx))
    put("tools.imt", imt(grey(64, 64)))
    put("photo.iim", iptc(64, 48, grey(48, 64).tobytes(), 3, 1, 2))
    frame = rgb(60, 80)
    idx, pal = quantized(frame, 256)
    put("anim.flc", fli(80, 60, [colour_chunk(pal), brun(idx)]))


def main():
    rng = np.random.default_rng(SEED)
    write_maps(rng)
    write_extra(rng)
    render_golden(OUT, "legacy", SIZES)
    sizes = {n: os.path.getsize(os.path.join(OUT, n)) for n in sorted(os.listdir(OUT))}
    print(sizes, sum(sizes.values()), "bytes")


if __name__ == "__main__":
    main()
