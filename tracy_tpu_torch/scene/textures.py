"""Texture loading and the flat texture atlas.

A numpy copy of tracy_tpu/scene/textures.py. The reference stores each
texture as a float RGBA array converted at load (u8 / 255 or float straight
through, optional sRGB -> linear; src/texture.h:93-108). All textures of a
scene live in ONE flat `[P, 4]` float32 atlas plus an int table
`[K, 4] = (offset, width, height, 0)`.

Files named .hdr go through the own Radiance decoder below (numpy only)
and .exr through imageio, by name, as tracy_tpu decides them; every other
file by its content: PNG, JPEG, BMP, GIF, PNM (P1-P6), PSD and TGA files
(every 8-bit format that stb_image, the C++ reference's loader, and PIL,
tracy_tpu's, both read) and TIFF, DDS, QOI, WebP, DIB, ICO, CUR, FTEX,
BLP, ICNS, PCX, DCX, SGI, SUN, MSP, IM, XBM, XPM, PIXAR, SPIDER, FITS,
GBR, MCIDAS, XVTHUMB, IMT, IPTC, PCD and FLI files (which PIL reads)
through csrc/image_decode.cpp, image_formats.cpp, image_tiff.cpp,
image_blocks.cpp, image_webp.cpp, image_containers.cpp and
image_legacy.cpp (utils/image_io.py), told apart by their first bytes,
whatever their name says. Nothing here imports PIL, which the GPU machine
lacks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from tracy_tpu_torch.utils.image_io import decode_image_rgba
from tracy_tpu_torch.utils.log import log


def load_image_rgba(path: str) -> Optional[np.ndarray]:
    """Decode an image to float32 RGBA [H, W, 4] in [0,1] (u8) or raw (HDR).

    Equivalent of stb_image's stbi_load/stbi_loadf with 4 forced channels
    (scene.cpp:28-45). Returns None if the file can't be read (missing,
    corrupt, or a format or coding the decoders refuse). Raises
    RuntimeError (ImageDecoderUnavailable when the decoder library cannot
    be built, else a failure inside it): that is not the file's fault, and
    must not turn a texture grey.
    """
    try:
        # .hdr and .exr by name first, whatever the file holds, as tracy_tpu
        # decides them; every other file by its content.
        if path.lower().endswith(".hdr"):
            img = _load_radiance_hdr(path)
            return np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
        if path.lower().endswith(".exr"):
            import imageio.v2 as imageio

            img = np.asarray(imageio.imread(path)).astype(np.float32)
            if img.ndim == 2:
                img = img[..., None].repeat(3, axis=-1)
            if img.shape[-1] == 3:
                img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
            return img
        with open(path, "rb") as f:
            data = f.read()
        return decode_image_rgba(data).astype(np.float32) / 255.0
    except RuntimeError:
        raise
    except Exception as e:  # missing file, bad or refused format
        log(f"texture load failed for '{path}': {e}")
        return None


def _load_radiance_hdr(path: str) -> np.ndarray:
    """Radiance RGBE (.hdr) decoder -> float32 RGB [H, W, 3].

    Matches stb_image's semantics (the reference loads sky probes through
    stbi_loadf, scene.cpp:28-33): component = mantissa * 2^(exponent-136),
    supports both flat scanlines and new-style per-channel RLE.
    """
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance file")
    # header: lines until the blank line, then the resolution line.
    pos = data.index(b"\n\n") + 2
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported resolution line {res!r}")
    h, w = int(res[1]), int(res[3])
    body = np.frombuffer(data, np.uint8, offset=eol + 1)

    rgbe = np.zeros((h, w, 4), np.uint8)
    if w < 8 or w >= 32768 or not (
        len(body) >= 4 and body[0] == 2 and body[1] == 2
        and (int(body[2]) << 8 | int(body[3])) == w
    ):
        rgbe = body[: h * w * 4].reshape(h, w, 4)
    else:
        off = 0
        for y in range(h):
            if not (body[off] == 2 and body[off + 1] == 2):
                raise ValueError("mixed RLE/flat scanlines unsupported")
            off += 4
            for c in range(4):
                x = 0
                while x < w:
                    n = int(body[off])
                    off += 1
                    if n > 128:  # run
                        rgbe[y, x : x + n - 128, c] = body[off]
                        off += 1
                        x += n - 128
                    else:  # literal
                        rgbe[y, x : x + n, c] = body[off : off + n]
                        off += n
                        x += n
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.exp2(e - 136.0), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def srgb_to_linear_np(x: np.ndarray) -> np.ndarray:
    x = np.maximum(x, 0.0)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


@dataclasses.dataclass
class TextureAtlas:
    """Host-side accumulating atlas; `pack()` yields the flat arrays."""

    pixels: List[np.ndarray] = dataclasses.field(default_factory=list)  # each [H,W,4]

    def add(self, image: np.ndarray, srgb: bool = False) -> int:
        """Add a float RGBA image; returns its texture id. sRGB->linear is
        applied on RGB at load like texture.h:106 (alpha untouched)."""
        img = np.asarray(image, dtype=np.float32)
        if srgb:
            img = np.concatenate(
                [srgb_to_linear_np(img[..., :3]), img[..., 3:4]], axis=-1
            ).astype(np.float32)
        self.pixels.append(np.ascontiguousarray(img))
        return len(self.pixels) - 1

    def __len__(self) -> int:
        return len(self.pixels)

    def pack(self) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (data [P,4] float32, table [K,4] int32 (offset,w,h,0)).

        Always emits at least one 1x1 white texel so shapes are never empty.
        """
        if not self.pixels:
            return (np.ones((1, 4), dtype=np.float32),
                    np.array([[0, 1, 1, 0]], dtype=np.int32))
        chunks, rows = [], []
        offset = 0
        for img in self.pixels:
            h, w = img.shape[:2]
            chunks.append(img.reshape(-1, 4))
            rows.append((offset, w, h, 0))
            offset += w * h
        return (np.concatenate(chunks, axis=0).astype(np.float32, copy=False),
                np.asarray(rows, dtype=np.int32))


def fallback_sky(width: int = 256, height: int = 128) -> np.ndarray:
    """Procedural gradient sky used when an HDR probe file is missing.

    Equirect layout: row 0 = top of the image = +Y after the sampler's v-flip.
    """
    v = np.linspace(0.0, 1.0, height, endpoint=False)  # [h], 0 = top row
    elevation = 1.0 - v  # 1 at top
    horizon = np.array([0.8, 0.85, 0.95], dtype=np.float32)
    zenith = np.array([0.25, 0.45, 0.85], dtype=np.float32)
    ground = np.array([0.35, 0.30, 0.25], dtype=np.float32)
    sky = horizon[None, :] + (zenith - horizon)[None, :] * np.clip(
        2.0 * elevation - 1.0, 0.0, 1.0
    )[:, None]  # [h, 3]
    rgb = np.where((elevation < 0.5)[:, None], ground[None, :], sky)
    rgb = np.broadcast_to(rgb[:, None, :], (height, width, 3)).astype(np.float32)
    alpha = np.ones((height, width, 1), dtype=np.float32)
    return np.concatenate([rgb, alpha], axis=-1)
