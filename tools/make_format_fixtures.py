"""Make the texture-format fixtures of tests/goldens/formats/.

    JAX_PLATFORMS=cpu python tools/make_format_fixtures.py

Writes, from seed 4321, five maps laid out as helmet.scn's (B and E sRGB,
N, R, M), each in a format the C++ reference's stb_image and tracy_tpu's
PIL both read and the port decodes without PIL (csrc/image_formats.cpp):

- basecolor.tga: 256x256 24-bit RLE TGA, top-down;
- normal.bmp: 256x128 8-bit palette BMP (PIL's 256-colour quantisation);
- roughness.gif: 200x200 interlaced GIF of 32 grey levels on a palette
  that is not the grey ramp, with a transparency index;
- metalness.pgm: 128x96 binary PGM (P5, maxval 255);
- emissive.psd: 256x256 RGB PSD with PackBits data, encoded here (PIL
  cannot write PSD);

then formats.scn, which uses them on a sphere and a box over an untextured
floor, and formats.npz: tracy_tpu's render of that scene on the CPU
(tools/make_texture_fixtures.py's settings: accel 'bvh', rng 'fast',
256x192, 24 frames of 1 spp) in tests/goldens/ref's format. No map uses a
variant where the packages part (ROADMAP, hazards). Needs PIL and jax.
"""

from __future__ import annotations

import os
import struct
import sys

import numpy as np
from PIL import Image

from make_texture_fixtures import FRAMES, REPO, pattern, u8

OUT = os.path.join(REPO, "tests", "goldens", "formats")
SEED = 4321
SIZES = [(256, 256), (128, 256), (200, 200), (96, 128), (256, 256)]  # rows, columns

SCN = """# Texture-format fixture: helmet.scn's five map slots (B and E sRGB, N,
# R, M) as TGA, BMP, GIF, PGM and PSD, made by tools/make_format_fixtures.py.
SCN Formats fixture
OUT 256 192
CAM (0, 1.0, 3.2) (0.0, 0.55, 0.0) (0.0, 1.0, 0.0) 45.0
MTL Textured (1.0, 1.0, 1.0) 1 0
MTL Floor (0.4, 0.4, 0.4) 1 0
TEX Textured B basecolor.tga SRGB
TEX Textured N normal.bmp
TEX Textured R roughness.gif
TEX Textured M metalness.pgm
TEX Textured E emissive.psd SRGB
SKY (0.7, 0.8, 1.0)
OBJ S (-0.45, 0.6, 0) 0.6 Textured
OBJ B (0.35, 0.0, -0.4) (1.15, 0.8, 0.4) Textured
OBJ B (-20.0, -0.2, -20.0) (20.0, 0, 20.0) Floor
"""


def rect_pattern(h: int, w: int, rng, channels: int) -> np.ndarray:
    """pattern() resampled to [h, w, channels] (nearest)."""
    n = max(h, w)
    full = pattern(n, rng, channels)
    return full[(np.arange(h) * n) // h][:, (np.arange(w) * n) // w]


def packbits(row: bytes) -> bytes:
    """PackBits of one row: runs of 2-128 equal bytes, else literals."""
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and row[j + 1] == row[i] and j + 1 - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), row[i]])
        else:
            while j + 1 < n and j + 1 - i < 127 and not (j + 2 < n and row[j + 1] == row[j + 2]):
                j += 1
            out += bytes([j - i]) + row[i:j + 1]
        i = j + 1
    return bytes(out)


def psd_rgb(img: np.ndarray) -> bytes:
    """A version-1 8-bit RGB PSD of uint8 [H, W, 3], PackBits, no layers."""
    h, w, c = img.shape
    rows = [packbits(img[y, :, k].tobytes()) for k in range(c) for y in range(h)]
    return (b"8BPS" + struct.pack(">H6xHIIHH", 1, c, h, w, 8, 3) + struct.pack(">III", 0, 0, 0)
            + struct.pack(">H", 1) + b"".join(struct.pack(">H", len(r)) for r in rows)
            + b"".join(rows))


def write_maps(rng):
    os.makedirs(OUT, exist_ok=True)
    (bh, bw), (nh, nw), (rh, rw), (mh, mw), (eh, ew) = SIZES
    Image.fromarray(u8(rect_pattern(bh, bw, rng, 3))).save(
        os.path.join(OUT, "basecolor.tga"), rle=True, orientation=1)
    bump = rect_pattern(nh, nw, rng, 2) - 0.5
    nrm = np.concatenate([0.5 + 0.3 * bump, np.ones_like(bump[..., :1])], axis=-1)
    Image.fromarray(u8(nrm)).quantize(256).save(os.path.join(OUT, "normal.bmp"))
    levels = np.floor(rect_pattern(rh, rw, rng, 1)[..., 0] * 31.99).astype(np.uint8)
    grey = Image.fromarray(levels, "P")
    grey.putpalette([v for k in range(32) for v in (8 * k + 4,) * 3])
    grey.save(os.path.join(OUT, "roughness.gif"), transparency=int(levels[0, 0]), interlace=True)
    Image.fromarray(u8(rect_pattern(mh, mw, rng, 1)[..., 0])).save(
        os.path.join(OUT, "metalness.pgm"))
    glow = rect_pattern(eh, ew, rng, 3)
    with open(os.path.join(OUT, "emissive.psd"), "wb") as f:
        f.write(psd_rgb(u8(np.where(glow > 0.75, glow, 0.0))))
    with open(os.path.join(OUT, "formats.scn"), "w") as f:
        f.write(SCN)


def render_golden(out=OUT, name="formats", want=SIZES):
    """tracy_tpu's CPU render of out/name.scn into out/name.npz, after
    checking that it loaded maps of the sizes `want`."""
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tracy_tpu.config import RenderConfig
    from tracy_tpu.render import film
    from tracy_tpu.render.renderer import Renderer, init_state
    from tracy_tpu.scene.scn_parser import load_scene

    b = load_scene(os.path.join(out, f"{name}.scn"))
    sizes = [img.shape[:2] for img in b.atlas.pixels]
    if sizes != want:
        raise RuntimeError(f"tracy_tpu did not load the five maps: {sizes}")
    cfg = RenderConfig(width=b.width, height=b.height, spp=1, accel="bvh", use_pallas=False)
    r = Renderer(cfg)
    st = r.render_progressive(b.build(), FRAMES, state=init_state(cfg),
                              steps_per_dispatch=FRAMES)
    img = np.clip(np.asarray(film.tonemap(st.accum, cfg)) * 255.99, 0.0, 255.0)
    np.savez_compressed(os.path.join(out, f"{name}.npz"), image=img[::-1].astype(np.float16),
                        frames=np.int32(FRAMES))


def main():
    write_maps(np.random.default_rng(SEED))
    render_golden()
    sizes = {n: os.path.getsize(os.path.join(OUT, n)) for n in sorted(os.listdir(OUT))}
    print(sizes, sum(sizes.values()), "bytes")


if __name__ == "__main__":
    main()
