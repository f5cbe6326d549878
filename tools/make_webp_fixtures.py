"""Make the WebP texture fixtures of tests/goldens/webp/.

    JAX_PLATFORMS=cpu python tools/make_webp_fixtures.py

Writes, from seed 6543, five maps laid out as helmet.scn's (B and E sRGB,
N, R, M), each a kind of WebP that tracy_tpu reads through PIL and the port
decodes without it (csrc/image_webp.cpp), all written by PIL's encoder:

- basecolor.webp: 256x256 lossy RGB (a simple VP8 file);
- normal.webp: 256x256 lossless RGB (VP8L);
- roughness.webp: 200x200 lossy with alpha (VP8X, ALPH through VP8L);
- metalness.webp: 128x96 lossless of 12 grey levels (VP8L colour indexing);
- emissive.webp: a 256x256 two-frame animation whose first frame, the one
  both packages read, covers a 160x96 rectangle of a transparent canvas;

then webp.scn, which uses them on a sphere and a box over an untextured
floor, and webp.npz: tracy_tpu's render of that scene on the CPU
(tools/make_texture_fixtures.py's settings: accel 'bvh', rng 'fast',
256x192, 24 frames of 1 spp) in tests/goldens/ref's format. Besides, two
2048x2048 maps that chip_smoke.py times the decode of (not in the scene):
big_lossy_alpha.webp (lossy with alpha) and big_lossless.webp (lossless,
the fixture pattern at 16 levels a channel), each under 400 KB. No map
uses a variant where the packages part (ROADMAP, hazards). Needs PIL and
jax.
"""

from __future__ import annotations

import io
import os

import numpy as np
from PIL import Image

from make_format_fixtures import rect_pattern, render_golden
from make_texture_fixtures import REPO, pattern, u8

OUT = os.path.join(REPO, "tests", "goldens", "webp")
SEED = 6543
SIZES = [(256, 256), (256, 256), (200, 200), (96, 128), (256, 256)]  # rows, columns
BIG = ("big_lossy_alpha.webp", "big_lossless.webp")

SCN = """# WebP fixture: helmet.scn's five map slots (B and E sRGB, N, R, M) as
# lossy, lossless, lossy with alpha, lossless palette and animated WebP,
# made by tools/make_webp_fixtures.py.
SCN WebP fixture
OUT 256 192
CAM (0, 1.0, 3.2) (0.0, 0.55, 0.0) (0.0, 1.0, 0.0) 45.0
MTL Textured (1.0, 1.0, 1.0) 1 0
MTL Floor (0.4, 0.4, 0.4) 1 0
TEX Textured B basecolor.webp SRGB
TEX Textured N normal.webp
TEX Textured R roughness.webp
TEX Textured M metalness.webp
TEX Textured E emissive.webp SRGB
SKY (0.7, 0.8, 1.0)
OBJ S (-0.45, 0.6, 0) 0.6 Textured
OBJ B (0.35, 0.0, -0.4) (1.15, 0.8, 0.4) Textured
OBJ B (-20.0, -0.2, -20.0) (20.0, 0, 20.0) Floor
"""


def save(img: np.ndarray, name: str, **kw):
    Image.fromarray(img).save(os.path.join(OUT, name), "WEBP", **kw)


def write_maps(rng):
    os.makedirs(OUT, exist_ok=True)
    (bh, bw), (nh, nw), (rh, rw), (mh, mw), (eh, ew) = SIZES
    save(u8(rect_pattern(bh, bw, rng, 3)), "basecolor.webp", quality=85, method=4)
    bump = rect_pattern(nh, nw, rng, 2) - 0.5
    nrm = np.concatenate([0.5 + 0.3 * bump, np.ones_like(bump[..., :1])], axis=-1)
    save(u8(nrm), "normal.webp", lossless=True, method=4)
    rough = u8(rect_pattern(rh, rw, rng, 4))
    save(rough, "roughness.webp", quality=80, alpha_quality=100)
    levels = np.round(rect_pattern(mh, mw, rng, 1)[..., 0] * 11) / 11
    save(u8(levels), "metalness.webp", lossless=True, method=6)
    glow = rect_pattern(eh, ew, rng, 3)
    first = np.zeros((eh, ew, 4), np.uint8)
    first[80:176, 48:208, :3] = u8(np.where(glow > 0.6, glow, 0.0))[80:176, 48:208]
    first[80:176, 48:208, 3] = 255
    second = np.concatenate([u8(glow), np.full((eh, ew, 1), 255, np.uint8)], -1)
    buf = io.BytesIO()
    Image.fromarray(first).save(buf, "WEBP", save_all=True,
                                append_images=[Image.fromarray(second)], duration=100,
                                quality=90)
    with open(os.path.join(OUT, "emissive.webp"), "wb") as f:
        f.write(buf.getvalue())
    with open(os.path.join(OUT, "webp.scn"), "w") as f:
        f.write(SCN)


def write_big(rng):
    """The two 2048x2048 maps of the card's decode timing."""
    n = 2048
    img = u8(pattern(n, rng, 4))
    img[..., 3] = np.where(img[..., 3] > 128, 255, img[..., 3] // 2)
    save(img, BIG[0], quality=40, method=4, alpha_quality=100)
    save(u8(np.round(pattern(n, rng, 3) * 15) / 15), BIG[1], lossless=True, method=4)


def main():
    rng = np.random.default_rng(SEED)
    write_maps(rng)
    write_big(rng)
    render_golden(OUT, "webp", SIZES)
    sizes = {n: os.path.getsize(os.path.join(OUT, n)) for n in sorted(os.listdir(OUT))}
    print(sizes, sum(sizes.values()), "bytes")


if __name__ == "__main__":
    main()
