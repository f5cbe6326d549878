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
stream goes to the PNM or JPEG decoder), built by g++ at first
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


# The formats of an IPTC image's embedded stream that the port reads, and
# the mode PIL opens each in (`_pil_mode`).
IPTC_STREAMS = ("jpeg", "pnm", "png", "bmp", "tiff", "gif", "webp")
# PNM magic -> PIL's mode where it is not colour (PpmImagePlugin; P2/P5
# above maxval 255 are I).
_PNM_MODES = {b"P1": "1", b"P4": "1", b"P2": "L", b"P5": "L", b"Pf": "F"}


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
    """The mode PIL opens a file of one of IPTC_STREAMS in, from its header
    ("L" for PNG grey at 2-8 bits, BMP whose palette is the grey ramp, GIF
    without a colour table, ...)."""
    try:
        return _header_mode(kind, data)
    except (IndexError, struct.error) as e:
        raise ValueError(f"IPTC: the embedded {kind} stream's header is truncated") from e


def _header_mode(kind: str, data: bytes) -> str:
    lib = get_image_lib()
    if kind == "jpeg":
        return {1: "L", 3: "RGB"}.get(_jpeg_info(lib, data)[2], "CMYK")
    if kind == "pnm":
        mode = _PNM_MODES.get(data[:2], "RGB")
        return "I" if mode == "L" and _pnm_maxval(data) > 255 else mode
    if kind == "png":
        depth, ctype = data[24], data[25]
        if ctype == 0:
            return {1: "1", 16: "I;16"}.get(depth, "L")
        return {2: "RGB", 3: "P", 4: "LA"}.get(ctype, "RGBA")
    if kind == "bmp":
        # BmpImagePlugin: a 1-, 4- or 8-bit palette whose entries are the
        # ramp (0 and 255 for two colours) is "1" or "L", else "P".
        hsize = struct.unpack_from("<I", data, 14)[0]
        core = hsize == 12
        bits = struct.unpack_from("<H", data, 24 if core else 28)[0]
        if bits not in (1, 4, 8):
            return "RGB"
        colors = struct.unpack_from("<I", data, 46)[0] if hsize >= 40 else 0
        colors = colors or 1 << bits
        pad = 3 if core else 4
        pal = data[14 + hsize:14 + hsize + pad * colors]
        ramp = (0, 255) if colors == 2 else range(colors)
        grey = all(pal[k * pad:k * pad + 3] == bytes([v]) * 3 for k, v in enumerate(ramp))
        return ("1" if colors == 2 else "L") if grey else "P"
    if kind == "gif":
        # GifImagePlugin: "L" where the first frame has no colour table.
        if data[10] & 0x80:
            return "P"
        at = 13
        while at < len(data) and data[at] == 0x21:  # extensions: skip their sub-blocks
            at += 2
            while at < len(data) and data[at]:
                at += data[at] + 1
            at += 1
        return "P" if at + 9 < len(data) and data[at] == 0x2C and data[at + 9] & 0x80 else "L"
    if kind == "tiff":
        mode = ctypes.create_string_buffer(16)
        _decode_error(lib, lib.tracy_tiff_mode(data, len(data), mode, 16))
        return mode.value.decode()
    return "RGB"  # webp: RGB or RGBA, never grey


def _iptc_rgba(data: bytes) -> np.ndarray:
    """An IPTC/NAA image as IptcImageFile.load reads it: the (8, 10) fields'
    data joined (behind a P5 header for compression "raw") and opened as an
    image of its own (any of IPTC_STREAMS), which is the picture or fills
    one band of an RGB or CMYK image whose other bands are 0 (then PIL's
    mode of it must be L, as Image.merge requires, or 1 in the first band,
    where merge gives the same). As the picture it is
    converted from the IPTC image's mode, L, not its own: PIL has no such
    conversion from I;16 or F."""
    lib = get_image_lib()
    meta = (ctypes.c_int64 * 4)()
    cap = len(data) // 5 + 1
    spans = (ctypes.c_int64 * (2 * cap))()
    count = ctypes.c_int64()
    _decode_error(lib, lib.tracy_iptc_stream(data, len(data), meta, spans, cap,
                                                     ctypes.byref(count)))
    compression, bands, band, has_data = meta
    if not has_data:
        return _decode_native("iptc", data)  # no image data: PIL's image stays black
    stream = b"".join(data[spans[2 * k]:spans[2 * k] + spans[2 * k + 1]]
                      for k in range(count.value))
    if compression == 1:
        stream = b"P5\n%d %d\n255\n" % _native_size(lib, "iptc", data) + stream
        mode = "L"
    else:
        kind = image_format(stream)
        if kind not in IPTC_STREAMS:
            raise ValueError(f"IPTC: the embedded {kind or 'unknown'} stream is not read "
                             f"(the port reads {', '.join(IPTC_STREAMS)} streams)")
        mode = _pil_mode(kind, stream)
    if band == -1 and (mode == "F" or mode.startswith("I;16")):
        raise ValueError(f"IPTC: an embedded image of PIL mode {mode} (PIL cannot convert it "
                         "from the IPTC image's mode)")
    img = decode_image_rgba(stream)
    if band == -1:
        return img
    if mode != "L" and not (band == 0 and mode == "1"):
        # Image.merge checks the mode of every band but the first, where
        # PIL copies the raw samples of any one-band image: a palette's
        # indices, a 16-bit image's row bytes, and crashes on I and F.
        raise ValueError(f"IPTC: band {band + 1} filled by an image of PIL mode {mode}, not "
                         "grey (PIL cannot merge it, or merges its raw samples)")
    if not -bands <= band < bands:
        raise ValueError(f"IPTC: band {band + 1} of a {bands}-band image")
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
        return _iptc_rgba(data)
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
