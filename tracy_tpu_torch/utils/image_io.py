"""Image files: PNG, PPM and .npy, written and read without PIL.

Port of tracy_tpu/utils/image_io.py. The JAX package writes PNG through
PIL; the GPU machine has no PIL, and the command-line default output is
`render.png`, so the port writes PNG with the standard library (zlib and
struct: 8-bit RGB, one IDAT chunk, filter 0 on every row). `read_image`
reads back what the inverse-rendering CLI takes as a target: .npy, .hdr
(scene/textures.py's Radiance decoder), binary PPM (P6, maxval 255) and
PNG, through PIL where it is installed, else the decoder below (8-bit
grey, grey+alpha, RGB or RGBA, not interlaced).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Channels of each PNG colour type at 8 bits.
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def to_u8(img) -> np.ndarray:
    """uint8 [H, W, 3] as it is, or floats in [0, 1] quantised the
    reference's way, u8(clip(255.99 x, 0, 255))."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.99, 0, 255).astype(np.uint8)
    return img


def save_image(img, path: str):
    """Write img (uint8 [H, W, 3], or floats in [0, 1]) to `path`: .ppm as
    binary PPM, .npy as the uint8 array, anything else as PNG."""
    img = to_u8(img)
    if path.endswith(".ppm"):
        _save_ppm(img, path)
    elif path.endswith(".npy"):
        np.save(path, img)
    else:
        with open(path, "wb") as f:
            f.write(encode_png(img))


def _save_ppm(img: np.ndarray, path: str):
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(img[..., :3]).tobytes())


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of a uint8 [H, W, 3] image."""
    img = np.ascontiguousarray(img[..., :3], dtype=np.uint8)
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """uint8 [H, W, C] of an 8-bit, non-interlaced PNG (colour types grey,
    grey+alpha, RGB, RGBA; every row filter). Raises on anything else."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(f"PNG: bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace} not read (8-bit, non-interlaced only)")
    c = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    out = np.zeros((h, w * c), np.int32)
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 0:
            row = line
        elif f == 2:
            row = (line + prev) & 0xFF
        else:  # sub, average and Paeth depend on the pixel to the left
            row = np.zeros_like(line)
            for x in range(w * c):
                a = row[x - c] if x >= c else 0
                b = prev[x]
                cc = prev[x - c] if x >= c else 0
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) // 2
                elif f == 4:
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
                else:
                    raise ValueError(f"PNG row filter {f}")
                row[x] = (line[x] + pred) & 0xFF
        out[y] = row
        prev = row
    return out.astype(np.uint8).reshape(h, w, c)


def decode_ppm(data: bytes) -> np.ndarray:
    """uint8 [H, W, 3] of a binary PPM (P6, maxval 255; # comments allowed)."""
    fields, pos = [], 0
    while len(fields) < 4:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    magic, w, h, maxval = fields[0], int(fields[1]), int(fields[2]), int(fields[3])
    if magic != b"P6" or maxval != 255:
        raise ValueError(f"PPM: {magic!r} with maxval {maxval} not read (P6, 255 only)")
    pos += 1  # the single whitespace after maxval
    return np.frombuffer(data[pos:pos + w * h * 3], np.uint8).reshape(h, w, 3).copy()


def load_npy_state(path: str) -> np.ndarray:
    """An array saved as .npy (save_image's raw float output), as
    tracy_tpu's load_npy_state."""
    return np.load(path)


def read_image(path: str):
    """(float32 RGB [H, W, 3], linear): 8-bit files scaled to [0, 1]
    (display values, linear False), .hdr and float .npy as stored (linear
    True)."""
    low = path.lower()
    if low.endswith(".npy"):
        img = np.load(path)
        if img.dtype == np.uint8:
            return img[..., :3].astype(np.float32) / 255.0, False
        return np.asarray(img, np.float32)[..., :3], True
    if low.endswith(".hdr"):
        from tracy_tpu_torch.scene.textures import _load_radiance_hdr

        return _load_radiance_hdr(path), True
    with open(path, "rb") as f:
        data = f.read()
    if low.endswith(".ppm"):
        img = decode_ppm(data)
    elif low.endswith(".png"):
        try:
            from PIL import Image
        except ImportError:
            img = decode_png(data)
            if img.shape[-1] < 3:  # grey (+ alpha) -> RGB
                img = img[..., :1].repeat(3, axis=-1)
        else:
            with Image.open(path) as im:
                img = np.asarray(im.convert("RGB"))
    else:
        raise ValueError(f"{path}: read .npy, .hdr, .ppm or .png")
    return img[..., :3].astype(np.float32) / 255.0, False
