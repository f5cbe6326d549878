"""Make the image-texture fixtures of tests/goldens/textured/.

    JAX_PLATFORMS=cpu python tools/make_texture_fixtures.py

Writes, from seed 1234, five maps laid out as helmet.scn's (B and E sRGB,
N, R, M), each in a format the port's decoders must read as PIL does:

- basecolor.jpg: 2048x2048 baseline JPEG, 4:2:0;
- normal.jpg: 1024x1024 baseline JPEG, 4:4:4;
- roughness.jpg: 512x512 progressive grey JPEG;
- metalness.png: 512x512 palette PNG (PIL picks 4 bits for its 16 colours);
- emissive.png: 256x256 16-bit RGB PNG (PIL cannot write 16-bit RGB, so
  this script encodes it; PIL and stb_image both keep the high byte);

then textured.scn, which uses them on a sphere and a box over an
untextured floor, and textured.npz: tracy_tpu's render of that scene on
the CPU (accel 'bvh', rng 'fast', 256x192, 24 frames of 1 spp) in
tests/goldens/ref's format (the 0..255 tonemapped image as float16,
bottom row first, and the frame count). The content is smooth procedural
patterns with hard edges. Needs PIL and jax; the port reads the outputs
without either.
"""

from __future__ import annotations

import os
import struct
import sys
import zlib

import numpy as np
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "goldens", "textured")
SEED = 1234
FRAMES = 24

SCN = """# Image-texture fixture: helmet.scn's five map slots (B and E sRGB, N, R,
# M) in the formats the decoders must read, made by
# tools/make_texture_fixtures.py.
SCN Textured fixture
OUT 256 192
CAM (0, 1.0, 3.2) (0.0, 0.55, 0.0) (0.0, 1.0, 0.0) 45.0
MTL Textured (1.0, 1.0, 1.0) 1 0
MTL Floor (0.4, 0.4, 0.4) 1 0
TEX Textured B basecolor.jpg SRGB
TEX Textured N normal.jpg
TEX Textured R roughness.jpg
TEX Textured M metalness.png
TEX Textured E emissive.png SRGB
SKY (0.7, 0.8, 1.0)
OBJ S (-0.45, 0.6, 0) 0.6 Textured
OBJ B (0.35, 0.0, -0.4) (1.15, 0.8, 0.4) Textured
OBJ B (-20.0, -0.2, -20.0) (20.0, 0, 20.0) Floor
"""


def pattern(n: int, rng, channels: int) -> np.ndarray:
    """[n, n, channels] floats in [0, 1]: sines over checker and disc edges."""
    y, x = (np.mgrid[0:n, 0:n].astype(np.float32) + 0.5) / n
    out = []
    for _ in range(channels):
        fx, fy, ph = rng.uniform(2.0, 9.0), rng.uniform(2.0, 9.0), rng.uniform(0, 6.3)
        cells = rng.integers(4, 12)
        cx, cy, r = rng.uniform(0.2, 0.8), rng.uniform(0.2, 0.8), rng.uniform(0.1, 0.3)
        v = 0.5 + 0.25 * np.sin(2 * np.pi * fx * x + ph) * np.cos(2 * np.pi * fy * y)
        v += 0.15 * (((x * cells).astype(int) + (y * cells).astype(int)) % 2 - 0.5)
        v += np.where((x - cx) ** 2 + (y - cy) ** 2 < r * r, 0.2, 0.0)
        out.append(v)
    return np.clip(np.stack(out, -1), 0.0, 1.0)


def u8(v: np.ndarray) -> np.ndarray:
    return np.round(v * 255.0).astype(np.uint8)


def png16_rgb(img: np.ndarray) -> bytes:
    """A 16-bit RGB PNG of uint16 [H, W, 3] (filter 0 on every row)."""
    h, w, _ = img.shape
    rows = img.astype(">u2").view(np.uint8).reshape(h, w * 6)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))


def write_maps(rng):
    os.makedirs(OUT, exist_ok=True)
    Image.fromarray(u8(pattern(2048, rng, 3))).save(
        os.path.join(OUT, "basecolor.jpg"), quality=85, subsampling=2)
    # Tangent-space normals: a gentle bump field, z up.
    bump = pattern(1024, rng, 2) - 0.5
    nrm = np.concatenate([0.5 + 0.3 * bump, np.ones_like(bump[..., :1])], axis=-1)
    Image.fromarray(u8(nrm)).save(os.path.join(OUT, "normal.jpg"), quality=90,
                                  subsampling=0)
    Image.fromarray(u8(pattern(512, rng, 1)[..., 0])).save(
        os.path.join(OUT, "roughness.jpg"), quality=90, progressive=True)
    metal = np.floor(pattern(512, rng, 1)[..., 0] * 15.99).astype(np.uint8)
    pal = Image.fromarray(metal, "P")
    pal.putpalette([v for k in range(16) for v in (k * 17,) * 3])
    pal.save(os.path.join(OUT, "metalness.png"))
    glow = pattern(256, rng, 3)
    glow = np.where(glow > 0.75, glow, 0.0) * 65535.0
    with open(os.path.join(OUT, "emissive.png"), "wb") as f:
        f.write(png16_rgb(np.round(glow).astype(np.uint16)))
    with open(os.path.join(OUT, "textured.scn"), "w") as f:
        f.write(SCN)


def render_golden():
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tracy_tpu.config import RenderConfig
    from tracy_tpu.render import film
    from tracy_tpu.render.renderer import Renderer, init_state
    from tracy_tpu.scene.scn_parser import load_scene

    b = load_scene(os.path.join(OUT, "textured.scn"))
    sizes = [img.shape[:2] for img in b.atlas.pixels]
    if sizes != [(2048, 2048), (1024, 1024), (512, 512), (512, 512), (256, 256)]:
        raise RuntimeError(f"tracy_tpu did not load the five maps: {sizes}")
    cfg = RenderConfig(width=b.width, height=b.height, spp=1, accel="bvh", use_pallas=False)
    r = Renderer(cfg)
    st = r.render_progressive(b.build(), FRAMES, state=init_state(cfg),
                              steps_per_dispatch=FRAMES)
    img = np.clip(np.asarray(film.tonemap(st.accum, cfg)) * 255.99, 0.0, 255.0)
    np.savez_compressed(os.path.join(OUT, "textured.npz"), image=img[::-1].astype(np.float16),
                        frames=np.int32(FRAMES))


def main():
    write_maps(np.random.default_rng(SEED))
    render_golden()
    sizes = {n: os.path.getsize(os.path.join(OUT, n)) for n in sorted(os.listdir(OUT))}
    print(sizes, sum(sizes.values()), "bytes")


if __name__ == "__main__":
    main()
