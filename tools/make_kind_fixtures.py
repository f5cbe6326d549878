"""Make the small files of tests/goldens/kinds/ and their recorded RGBA.

    cd tools && JAX_PLATFORMS=cpu python make_kind_fixtures.py

Writes, from seed 2121, one small file of each texture kind that tracy_tpu
reads through PIL and the port once refused (csrc/image_legacy.cpp,
utils/image_io.py's IPTC streams, csrc/image_jpeg2000.cpp's palettes):

- IM of the YCC, RGB3, RYB3, B2 and B4 kinds (B2/B4 without a Lut);
- IPTC holding a PNG, BMP, TIFF, GIF or WebP stream as the picture, and a
  grey PNG in band 2 of an RGB image and a GIF without a colour table in
  band 4 of a CMYK image;
- JP2 with a pclr palette of one column and of two;

each a few hundred bytes, and expected.npz: the uint8 RGBA of each, as
tracy_tpu's load_image_rgba gives it, but for the two palettes, which
tracy_tpu turns black (ROADMAP, hazards): there the palette as the format
defines it (grey, grey + alpha). Checks that the port decodes every file
to its array. chip_smoke.py's phase 16 decodes the files on the card's
host, where there is no PIL, and holds them to the arrays. The writers are
the tests'. Needs PIL and jax.
"""

from __future__ import annotations

import os
import sys

import numpy as np
from PIL import Image

from make_texture_fixtures import REPO

sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
from test_torch_image_decode import pil_bytes  # noqa: E402
from test_torch_image_formats import gif  # noqa: E402
from test_torch_image_jpeg2000 import cmap, j2k, jp2, pclr  # noqa: E402
from test_torch_image_legacy import im_file  # noqa: E402
from test_torch_image_legacy_kinds import iptc  # noqa: E402
from tracy_tpu.scene.textures import load_image_rgba as jax_load  # noqa: E402
from tracy_tpu_torch.utils.image_io import decode_image_rgba  # noqa: E402

OUT = os.path.join(REPO, "tests", "goldens", "kinds")
SEED = 2121
W, H = 9, 7


def files(rng):
    """{name: bytes} of the fixtures, and {name: uint8 RGBA} where the
    format, not tracy_tpu, gives the picture."""
    def u8(*shape, high=256):
        return rng.integers(0, high, shape).astype(np.uint8)

    out = {}
    for kind in ("YCC", "RGB3", "RYB3", "B2", "B4"):
        out[f"im_{kind.lower()}.im"] = im_file(kind, W, H, u8(3 * W * H).tobytes())
    rgb, grey = u8(H, W, 3), u8(H, W)
    pal = Image.fromarray(rgb).convert("P")
    for name, stream, bands in (
            ("png", pil_bytes(Image.fromarray(u8(H, W, 4)), format="PNG"), (1, 0, None)),
            ("bmp", pil_bytes(pal, format="BMP"), (1, 0, None)),
            ("tiff", pil_bytes(Image.fromarray(rgb), format="TIFF"), (1, 0, None)),
            ("gif", pil_bytes(pal, format="GIF", transparency=1), (1, 0, None)),
            ("webp", pil_bytes(Image.fromarray(rgb), format="WEBP", lossless=True),
             (1, 0, None)),
            ("png_band2", pil_bytes(Image.fromarray(grey), format="PNG"), (3, 1, 2)),
            ("gif_band4", gif((W, H), [dict(idx=u8(H, W, high=4), min_bits=2)]), (4, 1, 4))):
        out[f"iptc_{name}.iim"] = iptc(W, H, stream, *bands, compression=5)
    formats = {}
    idx = u8(H, W, high=8)
    for cols in (1, 2):
        entries = [tuple(int(v) for v in e) for e in u8(8, cols)]
        name = f"pclr{cols}.jp2"
        out[name] = jp2(j2k(idx, no_jp2=True), 1, extra=pclr(entries, (7,) * cols) + cmap(cols))
        p = np.asarray(entries, np.uint8)[idx]
        alpha = p[..., 1] if cols == 2 else np.full(idx.shape, 255, np.uint8)
        formats[name] = np.stack([p[..., 0]] * 3 + [alpha], axis=-1)
    return out, formats


def main():
    os.makedirs(OUT, exist_ok=True)
    data, formats = files(np.random.default_rng(SEED))
    expected = {}
    for name, raw in data.items():
        path = os.path.join(OUT, name)
        with open(path, "wb") as f:
            f.write(raw)
        ref = jax_load(path)
        assert ref is not None, name
        pil = np.round(ref * 255.0).astype(np.uint8)
        if name in formats:
            assert (pil[..., :3] == 0).all(), f"{name}: PIL no longer maps the palette to black"
            want = formats[name]
        else:
            want = pil
        np.testing.assert_array_equal(decode_image_rgba(raw), want, err_msg=name)
        expected[name] = want
        print(f"{name}: {len(raw)} bytes, {want.shape[1]}x{want.shape[0]}")
    np.savez_compressed(os.path.join(OUT, "expected.npz"), **expected)


if __name__ == "__main__":
    main()
