"""Image files: PNG and PPM written, every 8-bit format of stb_image,
WebP and the icon and game-texture containers read, without PIL.

Port of tracy_tpu/utils/image_io.py. The JAX package writes PNG through
PIL; the GPU machine has no PIL, and the command-line default output is
`render.png`, so the port writes PNG with the standard library (zlib and
struct: 8-bit RGB, one IDAT chunk, filter 0 on every row). Files are read
by the decoders of csrc/image_decode.cpp (PNG, JPEG; Python's zlib
inflates PNG data), csrc/image_formats.cpp (TGA, BMP, GIF, PNM, PSD, QOI),
csrc/image_tiff.cpp (TIFF), csrc/image_blocks.cpp (DDS),
csrc/image_webp.cpp (WebP) and csrc/image_containers.cpp (DIB, ICO, CUR,
FTEX, BLP, ICNS; their PNG and JPEG entries go to the PNG and JPEG
decoders), built by g++ at first use (utils/native.py::get_image_lib),
never by PIL; `image_format` tells them apart by their first bytes, as PIL
does.
`read_image` reads back what the inverse-rendering CLI takes as a target:
.npy and .hdr (scene/textures.py's Radiance decoder) by name, any of those
formats by content.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from tracy_tpu_torch.utils.native import STREAM_FORMATS, get_image_lib

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# Classic TIFF and BigTIFF, little- and big-endian.
TIFF_SIGNATURES = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")
READ_FORMATS = ("PNG, JPEG, BMP, DIB, GIF, PNM, PSD, TGA, TIFF, DDS, QOI, WebP, ICO, CUR, "
                "FTEX, BLP or ICNS")
# The first u32 (little-endian) of a DIB: its info header's size, as PIL's
# _dib_accept takes it.
DIB_HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)
# The chunks after RIFF....WEBP that PIL's WebP plugin accepts.
WEBP_CHUNKS = (b"VP8 ", b"VP8X", b"VP8L")
# Larger images are refused as corrupt headers (PIL's decompression-bomb
# error starts at twice its 89.5 M-pixel warning); csrc/image_common.h
# holds the other formats to the same limit (kMaxPixels).
MAX_PIXELS = 2 * 89_478_485


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


def _png_chunks(data: bytes):
    """(IHDR fields, PLTE, tRNS, IDAT bytes) of a PNG file; checks each
    chunk's CRC."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header, plte, trns = 8, [], None, b"", b""
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("PNG without IHDR")
    return header, plte, trns, b"".join(idat)


def _decode_error(lib, what: str, code: int):
    """Raise for a decoder's return code: 1 is the file's fault
    (ValueError), anything else a failure inside the decoder
    (RuntimeError)."""
    if code != 0:
        msg = f"{what}: {lib.tracy_decode_error().decode(errors='replace')}"
        raise ValueError(msg) if code == 1 else RuntimeError(msg)


def _png_rgba(data: bytes):
    """(uint8 RGBA [H, W, 4], colour type, has tRNS) of a PNG file, decoded
    by csrc/image_decode.cpp after zlib inflates the image data."""
    header, plte, trns, idat = _png_chunks(data)
    w, h, depth, ctype, compression, filt, interlace = header
    if compression != 0 or filt != 0:
        raise ValueError(f"PNG: compression {compression}, filter method {filt} not read")
    if w == 0 or h == 0 or w * h > MAX_PIXELS:
        raise ValueError(f"PNG: {w}x{h} pixels not read")
    try:
        raw = bytearray(zlib.decompress(idat))
    except zlib.error as e:
        raise ValueError(f"PNG: image data does not inflate: {e}") from e
    lib = get_image_lib()
    out = np.empty((h, w, 4), np.uint8)
    buf = (ctypes.c_uint8 * len(raw)).from_buffer(raw)
    code = lib.tracy_png_decode(ctypes.addressof(buf), len(raw), w, h, depth, ctype, interlace,
                                plte or None, len(plte), trns or None, len(trns),
                                out.ctypes.data)
    del buf
    _decode_error(lib, "PNG", code)
    return out, ctype, bool(trns)


def decode_png(data: bytes) -> np.ndarray:
    """uint8 [H, W, C] of a PNG file, C the channels it holds: grey 1, grey
    + alpha 2, RGB 3, RGBA 4; a palette gives RGB, and a tRNS chunk adds
    alpha to grey, RGB and palette images. Every colour type, bit depth
    (16-bit samples keep their high byte), Adam7 and every row filter.
    Raises ValueError on a file it cannot read."""
    rgba, ctype, has_trns = _png_rgba(data)
    grey = ctype in (0, 4)
    alpha = ctype in (4, 6) or has_trns
    return rgba[..., [0, 3] if alpha else [0]] if grey else rgba[..., :4 if alpha else 3]


def decode_jpeg(data: bytes, four_as_cmyk: bool = False) -> np.ndarray:
    """uint8 RGBA [H, W, 4] of a JPEG file (grey replicated, alpha 255):
    baseline, extended and progressive Huffman coding, 1, 3 or 4 components
    (CMYK, Adobe-inverted CMYK, YCCK) at sampling factors 1-4, decoded by
    csrc/image_decode.cpp as libjpeg decodes them and PIL converts them.
    `four_as_cmyk` reads four components as CMYK whatever the Adobe marker
    says, as PIL opens BLP1's JPEG. Raises ValueError on a file it cannot
    read, naming what it refuses (arithmetic coding, lossless, 12-bit,
    non-integral sampling ratios)."""
    lib = get_image_lib()
    w, h, comps, prog = (ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int())
    _decode_error(lib, "JPEG", lib.tracy_jpeg_info(data, len(data), ctypes.byref(w),
                                                   ctypes.byref(h), ctypes.byref(comps),
                                                   ctypes.byref(prog)))
    if w.value * h.value > MAX_PIXELS:
        raise ValueError(f"JPEG: {w.value}x{h.value} pixels not read")
    out = np.empty((h.value, w.value, 4), np.uint8)
    _decode_error(lib, "JPEG", lib.tracy_jpeg_decode(data, len(data), out.ctypes.data,
                                                     w.value, h.value, int(four_as_cmyk)))
    return out


def _tga_header_ok(data: bytes) -> bool:
    """Whether an 18-byte TGA header is one PIL's TGA plugin takes (its
    colour-map type, a size, a depth and an image type it knows); the port
    adds the 15-bit depth, which stb_image reads. TGA has no magic number,
    so PIL tries it after every format that has one."""
    if len(data) < 18:
        return False
    cm_type, itype = data[1], data[2]
    w, h = struct.unpack("<HH", data[12:16])
    return (cm_type in (0, 1) and w > 0 and h > 0 and data[16] in (1, 8, 15, 16, 24, 32)
            and itype in (1, 2, 3, 9, 10, 11))


def _icon_directory_ok(data: bytes) -> bool:
    """Whether an ICO or CUR file's directory holds at least one whole
    entry: else PIL's plugin raises an error that Image.open takes for "not
    this format" (no entry, a short one) and tries the next plugin."""
    n = struct.unpack("<H", data[4:6])[0] if len(data) >= 6 else 0
    return n > 0 and len(data) >= 6 + 16 * n


def image_format(data: bytes):
    """The format of an image file by its first bytes, as PIL tells them
    apart, in PIL's order (the formats it loads first, then its plugins by
    name): "bmp" (BM), "dib" (a first u32 that is a BMP info header's size),
    "gif" (GIF87a/GIF89a), "jpeg", "pnm" (P and a kind), "png", "blp" (BLP1,
    BLP2), "cur" (0 0 2 0), "dds" (DDS and a space), "ftex" (FTEX), "icns",
    "ico" (0 0 1 0; "cur" and "ico" with a whole directory of at least one
    entry, else PIL's plugins give way), "psd" (8BPS), "qoi" (qoif), "tiff"
    (II*, MM*, and BigTIFF's II+, MM+), "webp" (RIFF, WEBP at byte 8 and a
    VP8, VP8L or VP8X chunk at 12), else "tga" if the header passes TGA's
    checks (it has no magic, so it comes last), else None. The decoders may
    still refuse a kind they do not read."""
    head4 = data[:4]
    if data[:2] == b"BM":
        return "bmp"
    if len(data) >= 4 and struct.unpack("<I", head4)[0] in DIB_HEADER_SIZES:
        return "dib"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    if data[:3] == JPEG_SIGNATURE:
        return "jpeg"
    if data[:1] == b"P" and len(data) > 1 and data[1] in b"0123456fy":
        return "pnm"
    if data[:8] == PNG_SIGNATURE:
        return "png"
    magic = {b"BLP1": "blp", b"BLP2": "blp", b"\0\0\2\0": "cur", b"DDS ": "dds",
             b"FTEX": "ftex", b"icns": "icns", b"\0\0\1\0": "ico", b"8BPS": "psd",
             b"qoif": "qoi"}.get(head4)
    if magic and (magic not in ("cur", "ico") or _icon_directory_ok(data)):
        return magic
    if head4 in TIFF_SIGNATURES:
        return "tiff"
    if head4 == b"RIFF" and data[8:12] == b"WEBP" and data[12:16] in WEBP_CHUNKS:
        return "webp"
    return "tga" if _tga_header_ok(data) else None


def _native_size(lib, fmt: str, data: bytes):
    """(width, height) from tracy_<fmt>_info, which refuses sizes beyond
    MAX_PIXELS."""
    w, h = ctypes.c_int(), ctypes.c_int()
    info = getattr(lib, f"tracy_{fmt}_info")
    _decode_error(lib, fmt.upper(), info(data, len(data), ctypes.byref(w), ctypes.byref(h)))
    return w.value, h.value


def _decode_native(fmt: str, data: bytes) -> np.ndarray:
    """uint8 RGBA [H, W, 4] from tracy_<fmt>_info and tracy_<fmt>_decode of
    csrc/image_formats.cpp, image_tiff.cpp, image_blocks.cpp, image_webp.cpp
    or image_containers.cpp."""
    lib = get_image_lib()
    w, h = _native_size(lib, fmt, data)
    out = np.empty((h, w, 4), np.uint8)
    decode = getattr(lib, f"tracy_{fmt}_decode")
    _decode_error(lib, fmt.upper(), decode(data, len(data), out.ctypes.data, w, h))
    return out


def _embedded_stream(fmt: str, data: bytes):
    """The PNG or JPEG stream that the ICO, ICNS or BLP entry PIL opens is
    (csrc/image_containers.cpp's tracy_<fmt>_stream), or None when that
    entry is pixels of the container's own."""
    lib = get_image_lib()
    parts = (ctypes.c_int64 * 4)()
    _decode_error(lib, fmt.upper(), getattr(lib, f"tracy_{fmt}_stream")(data, len(data), parts))
    if parts[1] == 0:
        return None
    return data[parts[0]:parts[0] + parts[1]] + data[parts[2]:parts[2] + parts[3]]


def _blp_jpeg(data: bytes, stream: bytes) -> np.ndarray:
    """BLP1's JPEG kind as PIL reads it: the JPEG (four components as CMYK
    whatever its Adobe marker says) converted to RGB, its bytes laid out at
    the BLP header's size and read as BGR, alpha 255."""
    w, h = _native_size(get_image_lib(), "blp", data)
    rgb = decode_jpeg(stream, four_as_cmyk=True)[..., :3].reshape(-1)
    if rgb.size < w * h * 3:
        raise ValueError(f"BLP: the JPEG holds fewer than the header's {w}x{h} pixels")
    out = np.full((h, w, 4), 255, np.uint8)
    out[..., :3] = rgb[:w * h * 3].reshape(h, w, 3)[..., ::-1]
    return out


def decode_image_rgba(data: bytes) -> np.ndarray:
    """uint8 RGBA [H, W, 4] of a PNG, JPEG, BMP, DIB, GIF, PNM, PSD, TGA,
    TIFF, DDS, QOI, WebP, ICO, CUR, FTEX, BLP or ICNS file, told apart by its
    first bytes (not its name; `image_format`), as PIL's
    open(...).convert("RGBA") gives it but for ROADMAP's hazards. Raises
    ValueError for anything else, or for a kind the decoders refuse, named."""
    fmt = image_format(data)
    if fmt == "png":
        return _png_rgba(data)[0]
    if fmt == "jpeg":
        return decode_jpeg(data)
    if fmt is None:
        raise ValueError(f"not a {READ_FORMATS} file")
    if fmt in STREAM_FORMATS:
        stream = _embedded_stream(fmt, data)
        if stream is not None:
            return _blp_jpeg(data, stream) if fmt == "blp" else _png_rgba(stream)[0]
    return _decode_native(fmt, data)


def decode_ppm(data: bytes) -> np.ndarray:
    """uint8 RGB [H, W, 3] of a PNM file: P1-P6, ASCII or binary, any
    maxval (csrc/image_formats.cpp; grey replicated)."""
    if image_format(data) != "pnm":
        raise ValueError("not a PNM file")
    return _decode_native("pnm", data)[..., :3]


def load_npy_state(path: str) -> np.ndarray:
    """An array saved as .npy (save_image's raw float output), as
    tracy_tpu's load_npy_state."""
    return np.load(path)


def read_image(path: str):
    """(float32 RGB [H, W, 3], linear): .npy and .hdr by name, .hdr and
    float .npy as stored (linear True); any other file by its content, a
    file of any of READ_FORMATS scaled to [0, 1] (display values, linear
    False), as tracy_tpu's optimize_cli reads its target
    (PIL's convert("RGB"), alpha dropped)."""
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
    return decode_image_rgba(data)[..., :3].astype(np.float32) / 255.0, False
