"""Image files: PNG and PPM written, every 8-bit format of stb_image,
WebP, JPEG 2000, AVIF, the icon and game-texture containers and the small
raw and run-length formats of PIL's plugins read, without PIL.

Port of tracy_tpu/utils/image_io.py. The JAX package writes PNG through
PIL; the GPU machine has no PIL, and the command-line default output is
`render.png`, so the port writes PNG with the standard library (zlib and
struct: 8-bit RGB, one IDAT chunk, filter 0 on every row). Files are read
by the decoders of csrc/image_decode.cpp (PNG, JPEG; Python's zlib
inflates PNG data), csrc/image_formats.cpp (TGA, BMP, GIF, PNM, PSD, QOI),
csrc/image_tiff.cpp (TIFF; its LZMA and ZSTD strips through
csrc/image_xz.cpp and image_zstd.cpp, its JPEG strips through the JPEG
decoder), csrc/image_blocks.cpp (DDS),
csrc/image_webp.cpp (WebP), csrc/image_jpeg2000.cpp (JP2 and raw J2K
codestreams), csrc/image_avif.cpp (AVIF, its AV1 decoder in
csrc/av1_decode.cpp and av1_recon.cpp), csrc/image_containers.cpp (DIB,
ICO, CUR, FTEX, BLP, ICNS;
their PNG, JPEG and JPEG 2000 entries go to those decoders) and
csrc/image_legacy.cpp (PCX, DCX, SGI, SUN, MSP, IM, XBM, XPM, PIXAR,
SPIDER, FITS, GBR, MCIDAS, XVTHUMB, IMT, IPTC, PCD, FLI; IPTC's embedded
stream goes to the decoder of its format), built by g++ at first
use (utils/native.py::get_image_lib), never by PIL; `image_format` tells
them apart by their first bytes, in the order PIL tries its plugins.
`read_image` reads back what the inverse-rendering CLI takes as a target:
.npy and .hdr (scene/textures.py's Radiance decoder) by name, any of those
formats by content.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from tracy_tpu_torch.utils.native import LEGACY_FORMATS, STREAM_FORMATS, get_image_lib

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# Classic TIFF and BigTIFF, little- and big-endian.
TIFF_SIGNATURES = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")
READ_FORMATS = ("PNG, JPEG, BMP, DIB, GIF, PNM, PSD, TGA, TIFF, DDS, QOI, WebP, JPEG 2000, AVIF, "
                "ICO, "
                "CUR, FTEX, BLP, ICNS, PCX, DCX, SGI, SUN, MSP, IM, XBM, XPM, PIXAR, SPIDER, FITS, "
                "GBR, MCIDAS, XVTHUMB, IMT, IPTC, PCD or FLI")
# The first u32 (little-endian) of a DIB: its info header's size, as PIL's
# _dib_accept takes it.
DIB_HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)
# The chunks after RIFF....WEBP that PIL's WebP plugin accepts.
WEBP_CHUNKS = (b"VP8 ", b"VP8X", b"VP8L")
# A raw JPEG 2000 codestream (SOC, SIZ) and a JP2 file's signature box, as
# PIL's Jpeg2KImagePlugin._accept takes them.
JPEG2000_SIGNATURES = (b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a")
# The major brands of an AVIF file's ftyp box that PIL's AvifImagePlugin
# accepts (a mif1 or msf1 file that holds no AV1 image is given up).
AVIF_BRANDS = (b"avif", b"avis", b"mif1", b"msf1")
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


def _decode_error(lib, code: int):
    """Raise for a decoder's return code: 1 (the file's fault) and 3 (not a
    file of the format) as ValueError, 2 (a failure inside the decoder) as
    RuntimeError, with the C source's message, which starts with the format
    ("IM: ...", "Sun raster: ...")."""
    if code != 0:
        msg = lib.tracy_decode_error().decode(errors="replace")
        raise RuntimeError(msg) if code == 2 else ValueError(msg)


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
    _decode_error(lib, code)
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
    w, h, _ = _jpeg_info(lib, data)
    if w * h > MAX_PIXELS:
        raise ValueError(f"JPEG: {w}x{h} pixels not read")
    out = np.empty((h, w, 4), np.uint8)
    _decode_error(lib, lib.tracy_jpeg_decode(data, len(data), out.ctypes.data, w, h,
                                             int(four_as_cmyk)))
    return out


def _jpeg_info(lib, data: bytes):
    """(width, height, components) of a JPEG file."""
    w, h, comps, prog = (ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int())
    _decode_error(lib, lib.tracy_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                                           ctypes.byref(comps), ctypes.byref(prog)))
    return w.value, h.value, comps.value


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


def _be32(data: bytes, at: int) -> int:
    return struct.unpack(">I", data[at:at + 4])[0] if len(data) >= at + 4 else -1


# The formats the port reads, in the order PIL's Image.open tries them: the
# formats it loads first (BMP, DIB, GIF, JPEG, PPM, PNG), then its plugins
# in the order they register (Image.ID: AVIF first, then by name, but
# JPEG2000 ahead of ICNS, whose plugin imports it), each with its plugin's
# _accept test on the first 16 bytes. IM, IMT, IPTC, PCD and SPIDER have none: PIL tries their
# _open on every file that reaches them.
FORMAT_ORDER = (
    ("bmp", lambda d: d[:2] == b"BM"),
    ("dib", lambda d: len(d) >= 4 and struct.unpack("<I", d[:4])[0] in DIB_HEADER_SIZES),
    ("gif", lambda d: d[:6] in (b"GIF87a", b"GIF89a")),
    ("jpeg", lambda d: d[:3] == JPEG_SIGNATURE),
    ("pnm", lambda d: d[:1] == b"P" and len(d) > 1 and d[1] in b"0123456fy"),
    ("png", lambda d: d[:8] == PNG_SIGNATURE),
    ("avif", lambda d: d[4:8] == b"ftyp" and d[8:12] in AVIF_BRANDS),
    ("blp", lambda d: d[:4] in (b"BLP1", b"BLP2")),
    ("cur", lambda d: d[:4] == b"\0\0\2\0" and _icon_directory_ok(d)),
    ("pcx", lambda d: len(d) >= 2 and d[0] == 10 and d[1] in (0, 2, 3, 5)),
    ("dcx", lambda d: d[:4] == struct.pack("<I", 987654321)),
    ("dds", lambda d: d[:4] == b"DDS "),
    ("fits", lambda d: d[:6] == b"SIMPLE"),
    ("fli", lambda d: len(d) >= 16 and d[4:6] in (b"\x11\xaf", b"\x12\xaf")
     and d[14:16] in (b"\0\0", b"\3\0")),
    ("ftex", lambda d: d[:4] == b"FTEX"),
    ("gbr", lambda d: _be32(d, 0) >= 20 and _be32(d, 4) in (1, 2)),
    ("jpeg2000", lambda d: d.startswith(JPEG2000_SIGNATURES)),
    ("icns", lambda d: d[:4] == b"icns"),
    ("ico", lambda d: d[:4] == b"\0\0\1\0" and _icon_directory_ok(d)),
    ("im", None),
    ("imt", None),
    ("iptc", None),
    ("mcidas", lambda d: d[:8] == b"\0\0\0\0\0\0\0\4"),
    ("tiff", lambda d: d[:4] in TIFF_SIGNATURES),
    ("msp", lambda d: d[:4] in (b"DanM", b"LinS")),
    ("pcd", None),
    ("pixar", lambda d: d[:4] == b"\x80\xe8\0\0"),
    ("psd", lambda d: d[:4] == b"8BPS"),
    ("qoi", lambda d: d[:4] == b"qoif"),
    ("sgi", lambda d: d[:2] == b"\x01\xda"),
    ("spider", None),
    ("sun", lambda d: d[:4] == b"\x59\xa6\x6a\x95"),
    ("tga", _tga_header_ok),
    ("webp", lambda d: d[:4] == b"RIFF" and d[8:12] == b"WEBP" and d[12:16] in WEBP_CHUNKS),
    ("xbm", lambda d: d[:16].lstrip().startswith(b"#define")),
    ("xpm", lambda d: d[:9] == b"/* XPM */"),
    ("xvthumb", lambda d: d[:6] == b"P7 332"),
)


# Formats whose plugin's _open may give the file up to the next plugin
# (tracy_<fmt>_info answers 3): csrc/image_legacy.cpp's, and AVIF, where
# libavif's parser fails on a file type without the avif or avis brand, a
# malformed box or no AV1 primary item (PIL's SyntaxError).
GIVE_WAY_FORMATS = LEGACY_FORMATS + ("avif",)


def _plugin_opens(fmt: str, data: bytes) -> bool:
    """Whether PIL's plugin for one of GIVE_WAY_FORMATS keeps the file
    past its _open checks (tracy_<fmt>_info does not answer
    3, "not this format"): else Image.open tries its next plugin."""
    lib = get_image_lib()
    w, h = ctypes.c_int(), ctypes.c_int()
    return getattr(lib, f"tracy_{fmt}_info")(data, len(data), ctypes.byref(w),
                                              ctypes.byref(h)) != 3


def image_format(data: bytes):
    """The format of an image file by its first bytes, as PIL tells them
    apart: the first of FORMAT_ORDER whose test passes, PIL's order ("cur"
    and "ico" with a whole directory of at least one entry, else PIL's
    plugins give way; "tga" by its header's checks, as the port reads it).
    For GIVE_WAY_FORMATS the header must also pass the checks of the
    plugin's _open (which decide alone for IM, IMT, IPTC, PCD and SPIDER,
    which have no magic number). None for any other file. The decoders may
    still refuse a kind they do not read."""
    for fmt, accept in FORMAT_ORDER:
        if (accept is None or accept(data)) and (fmt not in GIVE_WAY_FORMATS
                                                 or _plugin_opens(fmt, data)):
            return fmt
    return None


def _native_size(lib, fmt: str, data: bytes):
    """(width, height) from tracy_<fmt>_info, which refuses sizes beyond
    MAX_PIXELS."""
    w, h = ctypes.c_int(), ctypes.c_int()
    info = getattr(lib, f"tracy_{fmt}_info")
    _decode_error(lib, info(data, len(data), ctypes.byref(w), ctypes.byref(h)))
    return w.value, h.value


def _decode_native(fmt: str, data: bytes) -> np.ndarray:
    """uint8 RGBA [H, W, 4] from tracy_<fmt>_info and tracy_<fmt>_decode of
    csrc/image_formats.cpp, image_tiff.cpp, image_blocks.cpp, image_webp.cpp,
    image_jpeg2000.cpp, image_containers.cpp or image_legacy.cpp."""
    lib = get_image_lib()
    w, h = _native_size(lib, fmt, data)
    out = np.empty((h, w, 4), np.uint8)
    decode = getattr(lib, f"tracy_{fmt}_decode")
    _decode_error(lib, decode(data, len(data), out.ctypes.data, w, h))
    return out


def _embedded_stream(fmt: str, data: bytes):
    """The PNG, JPEG or JPEG 2000 stream that the ICO, ICNS or BLP entry
    PIL opens is (csrc/image_containers.cpp's tracy_<fmt>_stream), or None
    when that entry is pixels of the container's own."""
    lib = get_image_lib()
    parts = (ctypes.c_int64 * 4)()
    _decode_error(lib, getattr(lib, f"tracy_{fmt}_stream")(data, len(data), parts))
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


# The formats of an IPTC image's embedded stream that the port reads: every
# format PIL opens, as IptcImageFile.load opens the stream with Image.open
# whatever it is, a nested IPTC image too. `_pil_mode` gives PIL's mode of
# each, on which the band rule and the conversion depend.
IPTC_STREAMS = tuple(fmt for fmt, _ in FORMAT_ORDER)
# PIL's modes whose core conversion to RGBA Pillow lacks. The IPTC picture
# takes the stream's core image as its own, and Image.convert then tries
# the IPTC image's mode, L, not the stream's own routes: PIL loses such a
# picture (tests/test_torch_image_iptc.py builds this set from Pillow).
UNCONVERTIBLE_MODES = frozenset(("La", "RGBX", "YCbCr", "LAB", "HSV", "F", "I;16", "I;16L",
                                 "I;16B", "I;16N"))
# Formats whose alpha PIL takes from the file's info["transparency"] (PNG's
# tRNS, GIF's transparent index), which the IPTC image does not carry: as
# its picture they are opaque.
INFO_TRANSPARENCY = ("png", "gif")
# PNM magic -> PIL's mode (PpmImagePlugin's MODES; P2/P5 above maxval 255
# are I).
_PNM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
              b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
# TgaImagePlugin's raw modes: (image type & 7, depth) it reads.
_TGA_KINDS = ((1, 8), (3, 1), (3, 8), (3, 16), (2, 16), (2, 24), (2, 32))
# PsdImagePlugin's (colour mode, bits) -> (mode, channels it needs).
_PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
              (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
              (9, 8): ("LAB", 3)}
# DdsImagePlugin's FourCC and DXGI formats -> mode (the SRGB kinds of BC1-3
# and every other format it does not implement are absent).
_DDS_FOURCC = {b"DXT1": "RGBA", b"DXT3": "RGBA", b"DXT5": "RGBA", b"BC4U": "L", b"ATI1": "L",
               b"BC5S": "RGB", b"BC5U": "RGB", b"ATI2": "RGB"}
_DDS_DXGI = {70: "RGBA", 71: "RGBA", 73: "RGBA", 74: "RGBA", 76: "RGBA", 77: "RGBA", 79: "L",
             80: "L", 82: "RGB", 83: "RGB", 84: "RGB", 95: "RGB", 96: "RGB", 97: "RGBA",
             98: "RGBA", 99: "RGBA", 27: "RGBA", 28: "RGBA", 29: "RGBA"}
# BmpImagePlugin's 32-bit bitfield masks (r, g, b, a) -> whether they hold
# alpha, and its 24- and 16-bit masks (r, g, b).
_BMP_MASKS32 = {(0xFF0000, 0xFF00, 0xFF, 0): False, (0xFF000000, 0xFF0000, 0xFF00, 0): False,
                (0xFF000000, 0xFF00, 0xFF, 0): False, (0xFF000000, 0xFF0000, 0xFF00, 0xFF): True,
                (0xFF, 0xFF00, 0xFF0000, 0xFF000000): True,
                (0xFF0000, 0xFF00, 0xFF, 0xFF000000): True,
                (0xFF000000, 0xFF00, 0xFF, 0xFF0000): True, (0, 0, 0, 0): True}
_BMP_MASKS = {24: ((0xFF0000, 0xFF00, 0xFF),), 16: ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F))}


def _pnm_maxval(data: bytes) -> int:
    """The third number of a PNM header (its maxval), comments skipped."""
    words = []
    at = 2
    while len(words) < 3 and at < len(data):
        c = data[at:at + 1]
        if c == b"#":
            at = data.find(b"\n", at)
            at = len(data) if at < 0 else at + 1
        elif c.isspace():
            at += 1
        else:
            end = at
            while end < len(data) and not data[end:end + 1].isspace() and data[end] != 0x23:
                end += 1
            words.append(data[at:end])
            at = end
    return int(words[2]) if len(words) == 3 and words[2].isdigit() else 255


def _pil_mode(kind: str, data: bytes) -> str:
    """The mode PIL opens a file of one of IPTC_STREAMS in,
    Image.open(...).mode, from its header ("L" for PNG grey at 2-8 bits,
    BMP whose palette is the grey ramp, GIF without a colour table, ...).
    Raises ValueError where PIL's plugin cannot open the file."""
    try:
        return _header_mode(kind, data)
    except (IndexError, struct.error) as e:
        raise ValueError(f"IPTC: the embedded {kind} stream's header is truncated") from e


def _unopened(kind: str, why: str):
    raise ValueError(f"IPTC: the embedded {kind} stream {why} (PIL cannot open it)")


def _bmp_mode(kind: str, data: bytes, at: int, raw_alpha: bool = False) -> str:
    """BmpImagePlugin._bitmap's mode of the info header at `at` (14 in a BMP
    file, 0 in a DIB; `raw_alpha` for a cursor's image at 22): a 1-, 4- or
    8-bit palette whose entries are the ramp (0 and 255 for two colours) is
    "1" or "L", else "P"; bitfields with an alpha mask, and a cursor's
    32-bit image, "RGBA"."""
    hsize = struct.unpack_from("<I", data, at)[0]
    if hsize == 12:
        bits, compression, colors, pad = struct.unpack_from("<H", data, at + 10)[0], 0, 0, 3
    elif hsize in DIB_HEADER_SIZES:
        bits, compression, colors = struct.unpack_from("<HI12xI", data, at + 14)
        pad = 4
    else:
        _unopened(kind, f"has an info header of {hsize} bytes")
    if bits not in (1, 4, 8, 16, 24, 32):
        _unopened(kind, f"has {bits} bits a pixel")
    mode = "P" if bits <= 8 else "RGB"
    if compression == 3:
        if bits == 32:
            masks = struct.unpack_from("<4I" if hsize >= 56 else "<3I", data, at + 40) + (0,) * (
                hsize < 56)
            if masks not in _BMP_MASKS32:
                _unopened(kind, "has bitfields PIL does not read")
            mode = "RGBA" if _BMP_MASKS32[masks] else "RGB"
        elif struct.unpack_from("<3I", data, at + 40) not in _BMP_MASKS.get(bits, ()):
            _unopened(kind, "has bitfields PIL does not read")
    elif compression == 0:
        mode = "RGBA" if bits == 32 and raw_alpha else mode
    elif compression not in (1, 2):
        _unopened(kind, f"has compression {compression}")
    if mode != "P":
        return mode
    colors = colors or 1 << bits
    if not 0 < colors <= 65536:
        _unopened(kind, f"has a palette of {colors} colours")
    pal = data[at + hsize:at + hsize + pad * colors]
    ramp = (0, 255) if colors == 2 else range(colors)
    grey = all(pal[k * pad:k * pad + 3] == bytes([v]) * 3 for k, v in enumerate(ramp))
    return ("1" if colors == 2 else "L") if grey else "P"


def _gif_mode(data: bytes) -> str:
    """GifImagePlugin's mode of the first frame: "P" where its colour table
    (its own, else the global one) is not the grey ramp, else "L"."""
    def needed(table):
        return any(not k // 3 == table[k] == table[k + 1] == table[k + 2]
                   for k in range(0, len(table), 3))

    at, palette = 13, False
    if data[10] & 0x80:
        at += 3 << (data[10] & 7) + 1
        palette = needed(data[13:at])
    while at < len(data) and data[at] == 0x21:  # extensions: skip their sub-blocks
        at += 2
        while at < len(data) and data[at]:
            at += data[at] + 1
        at += 1
    if data[at] == 0x2C and data[at + 9] & 0x80:
        palette = needed(data[at + 10:at + 10 + (3 << (data[at + 9] & 7) + 1)])
    return "P" if palette else "L"


def _webp_mode(data: bytes) -> str:
    """WebPImagePlugin's mode, "RGBA" where libwebp's WebPGetFeatures finds
    alpha: an animation's VP8X flag; else a VP8L bitstream's alpha_is_used
    bit, or a VP8 frame's VP8X flag or ALPH chunk."""
    def vp8l_alpha(at):  # after the VP8L chunk's signature byte
        return bool(struct.unpack_from("<I", data, at)[0] >> 28 & 1)

    if data[12:16] == b"VP8L":
        return "RGBA" if vp8l_alpha(21) else "RGB"
    if data[12:16] != b"VP8X":
        return "RGB"
    alpha = bool(data[20] & 0x10)
    if data[20] & 0x02:  # an animation
        return "RGBA" if alpha else "RGB"
    at = 30
    while at + 8 <= len(data):
        kind, size = data[at:at + 4], struct.unpack_from("<I", data, at + 4)[0]
        if kind == b"VP8L":
            alpha = vp8l_alpha(at + 9)
            break
        if kind == b"VP8 ":
            break
        alpha |= kind == b"ALPH"
        at += 8 + size + (size & 1)
    return "RGBA" if alpha else "RGB"


def _dds_mode(data: bytes) -> str:
    """DdsImagePlugin's mode, from the pixel format's flags, FourCC or DXGI
    format."""
    size, flags, fourcc, bits = struct.unpack_from("<I72xI4sI", data, 4)
    if size != 124 or len(data) < 128:
        _unopened("dds", "has a short or unknown header")
    if flags & 0x40:  # RGB
        return "RGBA" if flags & 0x1 else "RGB"
    if flags & 0x20000:  # luminance
        if bits == 8:
            return "L"
        if bits == 16 and flags & 0x1:
            return "LA"
        _unopened("dds", f"has {bits}-bit luminance")
    if flags & 0x20:  # 8-bit palette
        return "P"
    if not flags & 0x4:
        _unopened("dds", f"has pixel format flags {flags}")
    if fourcc == b"DX10":
        dxgi = struct.unpack_from("<I", data, 128)[0]
        if dxgi not in _DDS_DXGI:
            _unopened("dds", f"has DXGI format {dxgi}")
        return _DDS_DXGI[dxgi]
    if fourcc not in _DDS_FOURCC:
        _unopened("dds", f"has FourCC {fourcc!r}")
    return _DDS_FOURCC[fourcc]


def _jp2_box(data: bytes, at: int, end: int):
    """(type, body start, box end) of the box at `at`, which must end by
    `end`, as Jpeg2KImagePlugin's BoxReader reads it."""
    if at + 8 > end:
        _unopened("jpeg2000", "has a box header cut short")
    size, kind = struct.unpack_from(">I4s", data, at)
    head = 8
    if size == 1:
        if at + 16 > end:
            _unopened("jpeg2000", "has a box header cut short")
        size, head = struct.unpack_from(">Q", data, at + 8)[0], 16
    if size < head or at + size > end:
        _unopened("jpeg2000", f"has a {kind!r} box of a bad length")
    return kind, at + head, at + size


def _jpeg2000_mode(data: bytes) -> str:
    """Jpeg2KImagePlugin's mode: a codestream's by its SIZ component count
    and first depth; a JP2 file's by its header box (ihdr; colr for CMYK;
    pclr of at most 8-bit columns over L or LA for P or PA)."""
    if data.startswith(JPEG2000_SIGNATURES[0]):
        count, depth = struct.unpack_from(">HB", data, 40)
        if count == 1:
            return "I;16" if (depth & 0x7F) + 1 > 8 else "L"
        if not 2 <= count <= 4:
            _unopened("jpeg2000", f"has {count} components")
        return ("LA", "RGB", "RGBA")[count - 2]
    at = 12
    while True:
        kind, body, end = _jp2_box(data, at, len(data))
        if kind == b"jp2h":
            break
        at = end
    mode = count = None
    at = body
    while True:
        kind, field, box_end = _jp2_box(data, at, end)
        fields = data[field:box_end]
        if kind == b"ihdr":
            count, depth = struct.unpack_from(">HB", fields, 8)
            mode = {1: "I;16" if (depth & 0x7F) > 8 else "L", 2: "LA", 3: "RGB",
                    4: "RGBA"}.get(count, mode)
        elif kind == b"colr" and count == 4:
            meth, enumcs = struct.unpack_from(">B2xI", fields)
            mode = "CMYK" if meth == 1 and enumcs == 12 else mode
        elif kind == b"pclr" and mode in ("L", "LA"):
            entries, columns = struct.unpack_from(">HB", fields)
            if max(struct.unpack_from(f">{columns}B", fields, 3), default=0) <= 8:
                if 3 + columns * (entries + 1) > len(fields):
                    _unopened("jpeg2000", "has a pclr box cut short")
                mode = "P" if mode == "L" else "PA"
        if box_end >= end:
            break
        at = box_end
    if mode is None:
        _unopened("jpeg2000", "has a malformed header box")
    return mode


def _cur_mode(data: bytes) -> str:
    """CurImagePlugin's mode: the bitmap of the largest cursor (the first
    entry unless a later one is wider and taller)."""
    pick = None
    for k in range(struct.unpack_from("<H", data, 4)[0]):
        entry = data[6 + 16 * k:22 + 16 * k]
        if pick is None or entry[0] > pick[0] and entry[1] > pick[1]:
            pick = entry
    at = struct.unpack_from("<I", pick, 12)[0]
    return _bmp_mode("cur", data, at, raw_alpha=at == 22)


def _native_mode(lib, fmt: str, data: bytes) -> str:
    """PIL's mode from a decoder's header reader (csrc/image_tiff.cpp,
    image_avif.cpp, image_legacy.cpp)."""
    mode = ctypes.create_string_buffer(16)
    if fmt in LEGACY_FORMATS:
        _decode_error(lib, lib.tracy_legacy_mode(fmt.encode(), data, len(data), mode, 16))
    else:
        _decode_error(lib, getattr(lib, f"tracy_{fmt}_mode")(data, len(data), mode, 16))
    return mode.value.decode()


def _header_mode(kind: str, data: bytes) -> str:
    lib = get_image_lib()
    if kind == "jpeg":
        return {1: "L", 3: "RGB"}.get(_jpeg_info(lib, data)[2], "CMYK")
    if kind == "pnm":
        magic = data[:6].split()[0] if data[:6].strip() else b""
        if magic not in _PNM_MODES:
            _unopened("pnm", f"of magic {magic!r}")
        mode = _PNM_MODES[magic]
        return "I" if mode == "L" and _pnm_maxval(data) > 255 else mode
    if kind == "png":
        depth, ctype = data[24], data[25]
        if ctype == 0:
            return {1: "1", 16: "I;16"}.get(depth, "L")
        return {2: "RGB", 3: "P", 4: "LA"}.get(ctype, "RGBA")
    if kind in ("bmp", "dib"):
        return _bmp_mode(kind, data, 14 if kind == "bmp" else 0)
    if kind == "gif":
        return _gif_mode(data)
    if kind == "tga":
        itype, depth = data[2], data[16]
        if (depth not in (1, 8, 16, 24, 32) or (itype & 7, depth) not in _TGA_KINDS
                or data[1] and data[7] not in (16, 24, 32)):
            _unopened("tga", f"of image type {itype} at depth {depth}")
        if itype in (3, 11):
            return {1: "1", 16: "LA"}.get(depth, "L")
        if itype in (1, 9):
            return "P" if data[1] else "L"
        return "RGB" if depth == 24 else "RGBA"
    if kind == "psd":
        channels, bits, colour = struct.unpack_from(">H8xHH", data, 12)
        if data[4:6] != b"\0\1" or (colour, bits) not in _PSD_MODES:
            _unopened("psd", f"of version {data[4:6].hex()}, colour mode {colour} at {bits} bits")
        mode, need = _PSD_MODES[colour, bits]
        if need > channels:
            _unopened("psd", f"of {channels} channels")
        return "RGBA" if mode == "RGB" and channels == 4 else mode
    if kind == "qoi":
        return "RGB" if data[12] == 3 else "RGBA"
    if kind == "dds":
        return _dds_mode(data)
    if kind == "jpeg2000":
        return _jpeg2000_mode(data)
    if kind == "ico":
        # IcoImagePlugin loads on opening: a PNG entry's mode, a bitmap's
        # RGBA (its AND mask or alpha bytes put in as alpha).
        entry = _embedded_stream("ico", data)
        return "RGBA" if entry is None else _header_mode("png", entry)
    if kind == "cur":
        return _cur_mode(data)
    if kind == "blp":
        alpha = data[8:12] != b"\0\0\0\0" if data[:4] == b"BLP1" else data[9] != 0
        return "RGBA" if alpha else "RGB"
    if kind == "ftex":
        fmt = struct.unpack_from("<i", data, 24)[0]
        if fmt not in (0, 1):
            _unopened("ftex", f"of texture format {fmt}")
        return "RGBA" if fmt == 0 else "RGB"
    if kind == "icns":
        return "RGBA"  # IcnsImagePlugin's until it loads (`_core_mode`)
    if kind in ("tiff", "avif") or kind in LEGACY_FORMATS:
        return _native_mode(lib, kind, data)
    return _webp_mode(data)


def _core_mode(kind: str, data: bytes, mode: str) -> str:
    """The mode of the image that PIL's plugin loads, where it is not the
    mode it opened the file in (`mode`): an ICNS file's PNG or JPEG 2000
    entry's; a nested IPTC image's picture's, whose own mode is its
    header's."""
    if kind == "icns":
        entry = _embedded_stream("icns", data)
        return mode if entry is None else _pil_mode(image_format(entry), entry)
    if kind != "iptc":
        return mode
    (compression, _, whole, _, has_data), stream = _iptc_parts(data)
    if not whole:
        return mode  # merged into an RGB or CMYK image
    if not has_data or compression == 1:
        return "L"
    inner = _iptc_kind(stream)
    return _core_mode(inner, stream, _pil_mode(inner, stream))


def _iptc_parts(data: bytes):
    """((compression, bands, whole, band, has data), stream) of an IPTC/NAA
    image: csrc/image_legacy.cpp's tracy_iptc_stream, the (8, 10) fields'
    data joined."""
    lib = get_image_lib()
    meta = (ctypes.c_int64 * 5)()
    cap = len(data) // 5 + 1
    spans = (ctypes.c_int64 * (2 * cap))()
    count = ctypes.c_int64()
    _decode_error(lib, lib.tracy_iptc_stream(data, len(data), meta, spans, cap,
                                             ctypes.byref(count)))
    stream = b"".join(data[spans[2 * k]:spans[2 * k] + spans[2 * k + 1]]
                      for k in range(count.value))
    return tuple(meta), stream


def _iptc_kind(stream: bytes) -> str:
    kind = image_format(stream)
    if kind is None:
        raise ValueError("IPTC: the embedded stream is of no format PIL opens")
    return kind


def _iptc_rgba(data: bytes) -> np.ndarray:
    """An IPTC/NAA image as IptcImageFile.load reads it: the (8, 10) fields'
    data joined (behind a P5 header for compression "raw") and opened as an
    image of its own (any of IPTC_STREAMS), which is the picture or fills
    one band of an RGB or CMYK image whose other bands are 0. A band field
    of 0 fills the last band, as PIL indexes it. In a band PIL's mode of the
    stream must be L, as Image.merge requires, or 1 in the first band, where
    merge gives the same (ROADMAP, hazards: the first band takes any other
    one-band image's raw samples). As the picture it is converted from the
    IPTC image's mode, L, not its own: PIL has no such conversion from
    UNCONVERTIBLE_MODES, and the stream's info["transparency"] is lost."""
    (compression, bands, whole, band, has_data), stream = _iptc_parts(data)
    if not has_data:
        return _decode_native("iptc", data)  # no image data: PIL's image stays black
    if compression == 1:
        stream = b"P5\n%d %d\n255\n" % _native_size(get_image_lib(), "iptc", data) + stream
        kind = "pnm"
    else:
        kind = _iptc_kind(stream)
    mode = _pil_mode(kind, stream)
    core = _core_mode(kind, stream, mode)
    named = mode if core == mode else f"{mode} (its loaded image {core})"
    if whole:
        if core in UNCONVERTIBLE_MODES:
            raise ValueError(f"IPTC: an embedded image of PIL mode {named} (PIL cannot convert "
                             "it from the IPTC image's mode)")
        img = decode_image_rgba(stream)
        if kind in INFO_TRANSPARENCY and mode not in ("LA", "RGBA"):
            img[..., 3] = 255
        return img
    if not -bands <= band < bands:
        raise ValueError(f"IPTC: band {band + 1} of a {bands}-band image")
    if core not in ("L", "1") or not (band == 0 or mode == "L"):
        # Image.merge checks the mode of every band but the first, where
        # PIL copies the raw samples of any one-band image: a palette's
        # indices, a 16-bit image's row bytes, and crashes on I and F.
        raise ValueError(f"IPTC: band {band + 1} filled by an image of PIL mode {named}, not "
                         "grey (PIL cannot merge it, or merges its raw samples)")
    img = decode_image_rgba(stream)
    planes = np.zeros(img.shape[:2] + (bands,), np.int64)
    planes[..., band] = img[..., 0]
    out = np.full(img.shape[:2] + (4,), 255, np.uint8)
    # PIL's cmyk2rgb with one band set: 255 - C (M, Y), or 255 - K in all three.
    out[..., :3] = planes if bands == 3 else 255 - planes[..., :3] - planes[..., 3:]
    return out


def decode_image_rgba(data: bytes) -> np.ndarray:
    """uint8 RGBA [H, W, 4] of a file of any of READ_FORMATS, told apart by
    its first bytes (not its name; `image_format`), as PIL's
    open(...).convert("RGBA") gives it but for ROADMAP's hazards. Raises
    ValueError for anything else, or for a kind the decoders refuse, named."""
    fmt = image_format(data)
    if fmt == "png":
        return _png_rgba(data)[0]
    if fmt == "jpeg":
        return decode_jpeg(data)
    if fmt is None:
        raise ValueError(f"not a {READ_FORMATS} file")
    if fmt == "iptc":
        try:
            return _iptc_rgba(data)
        except RecursionError as e:  # PIL's Image.open of the nested streams fails alike
            raise ValueError("IPTC: images nested beyond Python's recursion limit") from e
    if fmt in STREAM_FORMATS:
        stream = _embedded_stream(fmt, data)
        if stream is not None:
            if fmt == "blp":
                return _blp_jpeg(data, stream)
            if stream.startswith(JPEG2000_SIGNATURES):  # an ICNS entry
                return _decode_native("jpeg2000", stream)
            return _png_rgba(stream)[0]
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
