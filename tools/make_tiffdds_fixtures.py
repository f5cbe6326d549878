"""Make the TIFF, DDS and QOI texture fixtures of tests/goldens/tiffdds/.

    JAX_PLATFORMS=cpu python tools/make_tiffdds_fixtures.py

Writes, from seed 5432, five maps laid out as helmet.scn's (B and E sRGB,
N, R, M), each in a format tracy_tpu reads through PIL and the port
decodes without it (csrc/image_blocks.cpp, image_tiff.cpp,
image_formats.cpp):

- basecolor.dds: 256x256 DXT5, written by PIL;
- normal.dds: 256x256 BC5, written by PIL from RGB;
- roughness.tif: 200x200 8-bit grey, LZW with predictor 2, 16-row strips,
  little-endian;
- metalness.tif: 128x96 grey, 64x64 tiles, Adobe deflate, big-endian;
- emissive.qoi: 256x256 RGBA, written by PIL;

the two TIFFs by tests/test_torch_image_tiff.py's encoder (PIL writes no
tiles and no predictor). Then tiffdds.scn, which uses them on a sphere and
a box over an untextured floor, and tiffdds.npz: tracy_tpu's render of that
scene on the CPU (tools/make_texture_fixtures.py's settings: accel 'bvh',
rng 'fast', 256x192, 24 frames of 1 spp) in tests/goldens/ref's format. No
map uses a variant where the packages part (ROADMAP, hazards). Needs PIL
and jax.
"""

from __future__ import annotations

import os
import sys

import numpy as np
from PIL import Image

from make_format_fixtures import rect_pattern, render_golden
from make_texture_fixtures import REPO, u8

sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
from test_torch_image_tiff import tiff  # noqa: E402

OUT = os.path.join(REPO, "tests", "goldens", "tiffdds")
SEED = 5432
SIZES = [(256, 256), (256, 256), (200, 200), (96, 128), (256, 256)]  # rows, columns

SCN = """# TIFF/DDS/QOI fixture: helmet.scn's five map slots (B and E sRGB, N, R,
# M) as DXT5 and BC5 DDS, LZW and deflate TIFF and QOI, made by
# tools/make_tiffdds_fixtures.py.
SCN TIFF DDS QOI fixture
OUT 256 192
CAM (0, 1.0, 3.2) (0.0, 0.55, 0.0) (0.0, 1.0, 0.0) 45.0
MTL Textured (1.0, 1.0, 1.0) 1 0
MTL Floor (0.4, 0.4, 0.4) 1 0
TEX Textured B basecolor.dds SRGB
TEX Textured N normal.dds
TEX Textured R roughness.tif
TEX Textured M metalness.tif
TEX Textured E emissive.qoi SRGB
SKY (0.7, 0.8, 1.0)
OBJ S (-0.45, 0.6, 0) 0.6 Textured
OBJ B (0.35, 0.0, -0.4) (1.15, 0.8, 0.4) Textured
OBJ B (-20.0, -0.2, -20.0) (20.0, 0, 20.0) Floor
"""


def write_maps(rng):
    os.makedirs(OUT, exist_ok=True)
    (bh, bw), (nh, nw), (rh, rw), (mh, mw), (eh, ew) = SIZES
    base = u8(rect_pattern(bh, bw, rng, 3))
    alpha = np.full((bh, bw, 1), 255, np.uint8)
    Image.fromarray(np.concatenate([base, alpha], -1)).save(
        os.path.join(OUT, "basecolor.dds"), pixel_format="DXT5")
    bump = rect_pattern(nh, nw, rng, 2) - 0.5
    nrm = np.concatenate([0.5 + 0.3 * bump, np.ones_like(bump[..., :1])], axis=-1)
    Image.fromarray(u8(nrm)).save(os.path.join(OUT, "normal.dds"), pixel_format="BC5")
    with open(os.path.join(OUT, "roughness.tif"), "wb") as f:
        f.write(tiff(u8(rect_pattern(rh, rw, rng, 1)[..., 0]), 8, 1, "<", compression=5,
                     predictor=2, rows_per_strip=16))
    with open(os.path.join(OUT, "metalness.tif"), "wb") as f:
        f.write(tiff(u8(rect_pattern(mh, mw, rng, 1)[..., 0]), 8, 1, ">", compression=32946,
                     tile=(64, 64)))
    glow = rect_pattern(eh, ew, rng, 3)
    glow = u8(np.where(glow > 0.75, glow, 0.0))
    Image.fromarray(np.concatenate([glow, np.full((eh, ew, 1), 255, np.uint8)], -1)).save(
        os.path.join(OUT, "emissive.qoi"))
    with open(os.path.join(OUT, "tiffdds.scn"), "w") as f:
        f.write(SCN)


def main():
    write_maps(np.random.default_rng(SEED))
    render_golden(OUT, "tiffdds", SIZES)
    sizes = {n: os.path.getsize(os.path.join(OUT, n)) for n in sorted(os.listdir(OUT))}
    print(sizes, sum(sizes.values()), "bytes")


if __name__ == "__main__":
    main()
