"""Make the JPEG-kind and container texture fixtures of tests/goldens/containers/.

    cd tools && JAX_PLATFORMS=cpu python make_container_fixtures.py

Writes, from seed 7654, five maps laid out as helmet.scn's (B and E sRGB,
N, R, M), each a kind that tracy_tpu reads through PIL and the port decodes
without it (csrc/image_decode.cpp, image_containers.cpp):

- basecolor.jpg: 256x256 Adobe CMYK JPEG (PIL's writer), progressive;
- normal_411.jpg: 256x256 4:1:1 JPEG written by OpenCV;
- roughness.ico: an ICO of 24-bit BMP entries at 16, 32 and 256 pixels,
  each with an AND mask (PIL opens the 256-pixel one);
- metalness.blp: a 128x128 BLP1 of the JPEG kind, four components;
- emissive.icns: a 128x128 it32 RLE entry with its t8mk mask beside a
  32x32 PNG entry (icp5);

then containers.scn, which uses them on a sphere and a box over an
untextured floor, and containers.npz: tracy_tpu's render of that scene on
the CPU (tools/make_texture_fixtures.py's settings: accel 'bvh', rng
'fast', 256x192, 24 frames of 1 spp) in tests/goldens/ref's format.
Besides, the files that tests/test_torch_image_jpeg_kinds.py reads and
chip_smoke.py times the decode of, not in the scene: OpenCV's 4:1:1 JPEGs
at odd sizes (baseline, progressive, with restart intervals), a 2048x2048
Adobe CMYK JPEG (big_cmyk.jpg, under 400 KB), a YCCK JPEG, a CUR, a DIB,
an FTEX (BC1) and two BLP2 files (DXT5, palette). The packers are the
tests' (tests/test_torch_image_containers.py). No map uses a variant where
the packages part (ROADMAP, hazards). Needs PIL, OpenCV and jax.
"""

from __future__ import annotations

import io
import os
import sys

import cv2
import numpy as np
from PIL import Image

from make_format_fixtures import rect_pattern, render_golden
from make_texture_fixtures import REPO, pattern, u8

sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
from test_torch_image_containers import (blp1_jpeg, blp2, dib, ftex, icns,  # noqa: E402
                                         icns_rgb, icon_bmp, icon_dir)

OUT = os.path.join(REPO, "tests", "goldens", "containers")
SEED = 7654
SIZES = [(256, 256), (256, 256), (256, 256), (128, 128), (128, 128)]  # rows, columns
# OpenCV's 4:1:1 files at odd sizes: name, (rows, columns), progressive,
# restart interval (MCUs).
JPEG_411 = (("411_37x53.jpg", (37, 53), False, 0),
            ("411_37x53_progressive.jpg", (37, 53), True, 0),
            ("411_29x61_restart.jpg", (29, 61), False, 3),
            ("411_70x9_progressive_restart.jpg", (70, 9), True, 2))
# Decoded and timed on the card's host; not in the scene.
EXTRA = ("big_cmyk.jpg", "ycck.jpg", "cursor.cur", "bitmap.dib", "texture.ftc", "dxt5.blp",
         "palette.blp")

SCN = """# Container fixture: helmet.scn's five map slots (B and E sRGB, N, R, M)
# as an Adobe CMYK JPEG, a 4:1:1 JPEG, an ICO, a BLP1 JPEG and an ICNS,
# made by tools/make_container_fixtures.py.
SCN Container fixture
OUT 256 192
CAM (0, 1.0, 3.2) (0.0, 0.55, 0.0) (0.0, 1.0, 0.0) 45.0
MTL Textured (1.0, 1.0, 1.0) 1 0
MTL Floor (0.4, 0.4, 0.4) 1 0
TEX Textured B basecolor.jpg SRGB
TEX Textured N normal_411.jpg
TEX Textured R roughness.ico
TEX Textured M metalness.blp
TEX Textured E emissive.icns SRGB
SKY (0.7, 0.8, 1.0)
OBJ S (-0.45, 0.6, 0) 0.6 Textured
OBJ B (0.35, 0.0, -0.4) (1.15, 0.8, 0.4) Textured
OBJ B (-20.0, -0.2, -20.0) (20.0, 0, 20.0) Floor
"""


def put(name: str, data: bytes):
    with open(os.path.join(OUT, name), "wb") as f:
        f.write(data)


def jpeg(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


def cmyk(rgb: np.ndarray) -> Image.Image:
    return Image.fromarray(rgb).convert("CMYK")


def cv2_411(rgb: np.ndarray, progressive=False, restart=0, quality=90) -> bytes:
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]), [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive), cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    data = enc.tobytes()
    sof = data.index(b"\xff\xc2" if progressive else b"\xff\xc0")
    assert ok and data[sof + 11] == 0x41  # component 1: h 4, v 1
    return data


def write_maps(rng):
    os.makedirs(OUT, exist_ok=True)
    (bh, bw), (nh, nw), (rh, rw), (mh, mw), (eh, ew) = SIZES
    put("basecolor.jpg", jpeg(cmyk(u8(rect_pattern(bh, bw, rng, 3))), quality=90,
                              progressive=True))
    bump = rect_pattern(nh, nw, rng, 2) - 0.5
    nrm = np.concatenate([0.5 + 0.3 * bump, np.ones_like(bump[..., :1])], axis=-1)
    put("normal_411.jpg", cv2_411(u8(nrm)))
    rough = u8(rect_pattern(rh, rw, rng, 3))
    entries = []
    for n in (16, 32, 256):
        img = np.asarray(Image.fromarray(rough).resize((n, n), Image.Resampling.BOX))
        entries.append(icon_bmp(img[..., ::-1], 24, mask=rng.random((n, n)) < 0.05))
    put("roughness.ico", icon_dir(1, entries))
    metal = u8(rect_pattern(mh, mw, rng, 3))
    put("metalness.blp", blp1_jpeg(jpeg(cmyk(metal), quality=90), mw, mh))
    glow = rect_pattern(eh, ew, rng, 3)
    glow = u8(np.where(glow > 0.6, glow, 0.0))
    small = np.asarray(Image.fromarray(glow).resize((32, 32), Image.Resampling.BOX))
    png = io.BytesIO()
    Image.fromarray(small).save(png, "PNG")
    put("emissive.icns", icns([(b"icp5", png.getvalue()),
                               (b"it32", b"\0\0\0\0" + icns_rgb(glow)),
                               (b"t8mk", np.full((eh, ew), 255, np.uint8).tobytes())]))
    with open(os.path.join(OUT, "containers.scn"), "w") as f:
        f.write(SCN)


def write_extra(rng):
    """The 4:1:1 files of the CPU tests and the maps the card's host times."""
    for name, (h, w), progressive, restart in JPEG_411:
        put(name, cv2_411(u8(rect_pattern(h, w, rng, 3)), progressive, restart))
    put("big_cmyk.jpg", jpeg(cmyk(u8(pattern(2048, rng, 3))), quality=60))
    data = bytearray(jpeg(cmyk(u8(rect_pattern(256, 256, rng, 3))), quality=90))
    data[data.index(b"\xff\xee") + 4 + 11] = 2  # the Adobe transform: YCCK
    put("ycck.jpg", bytes(data))
    bgra = u8(rect_pattern(128, 128, rng, 4))[..., [2, 1, 0, 3]]
    put("cursor.cur", icon_dir(2, [icon_bmp(bgra, 32)], (64, 64)))
    put("bitmap.dib", dib(128, 128, 24, u8(rect_pattern(128, 128, rng, 3))[..., ::-1]))
    put("texture.ftc", ftex(256, 256, 0, rng.integers(0, 256, 64 * 64 * 8, np.uint8).tobytes()))
    put("dxt5.blp", blp2(256, 256, 2, 8, 7, rng.integers(0, 256, 64 * 64 * 16,
                                                          np.uint8).tobytes()))
    pal = Image.fromarray(u8(rect_pattern(256, 256, rng, 3))).quantize(256)
    buf = io.BytesIO()
    pal.save(buf, "BLP")
    put("palette.blp", buf.getvalue())


def main():
    rng = np.random.default_rng(SEED)
    write_maps(rng)
    write_extra(rng)
    render_golden(OUT, "containers", SIZES)
    sizes = {n: os.path.getsize(os.path.join(OUT, n)) for n in sorted(os.listdir(OUT))}
    print(sizes, sum(sizes.values()), "bytes")


if __name__ == "__main__":
    main()
