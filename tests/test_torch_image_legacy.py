"""The small raw and run-length formats of PIL's plugins (PCX, DCX, SGI,
SUN, MSP, IM, XBM, XPM, PIXAR, SPIDER, FITS, GBR, MCIDAS, XVTHUMB, IMT,
IPTC, PCD, FLI) decoded without PIL (csrc/image_legacy.cpp; IPTC's
embedded stream through the PNM and JPEG decoders) against PIL's
open(...).convert("RGBA"), which tracy_tpu's texture loader runs.

Each file is made from a seeded numpy array, written by PIL where PIL
writes the kind (PCX, SGI verbatim, IM, XBM, SPIDER, MSP v1), else packed
with struct by the writers below, at odd sizes, with runs that cross plane
and row ends. Contracts:

* Equal to PIL bit for bit (uint8 RGBA) for every kind PIL reads as the
  format means it. A few cases also go through tracy_tpu's
  load_image_rgba: the float arrays are equal.
* Where PIL loses the picture (ROADMAP, hazards) the port reads the
  format: PCX 24-bit images of width 1 or 3, Sun run-length rows padded
  to 16 bits, FITS deep samples (big-endian, signed, scaled); each case is
  held against the picture the format defines and shown to differ from
  PIL's.
* Kinds PIL refuses raise ValueError naming them and fall back (None) in
  both packages (IM's RLB among them); truncated files fall back in both
  packages.

tests/test_torch_image_legacy_kinds.py holds the formats' recognition,
IPTC, Photo CD and FLI; tools/make_legacy_fixtures.py reuses the writers.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from test_torch_image_decode import pil_bytes, port_load, smooth, write
from tracy_tpu.scene.textures import load_image_rgba as jax_load
from tracy_tpu_torch.utils import image_io


def pil_rgba(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def rand(seed, *shape, high=256):
    return np.random.default_rng(seed).integers(0, high, shape).astype(np.uint8)


def runs(seed, *shape, high=256):
    """Random values in runs of 1-70 along the last axis (so that the
    run-length writers emit both kinds of packets, and runs longer than a
    packet holds)."""
    rng = np.random.default_rng(seed)
    flat = np.repeat(rng.integers(0, high, shape[-1]), rng.integers(1, 71, shape[-1]))
    n = int(np.prod(shape))
    return np.resize(flat, n).reshape(shape).astype(np.uint8)


# --- writers for what PIL does not write

def pcx_rle(data: bytes) -> bytes:
    """PCX run-length coding of a byte string, runs of up to 63 (0xC0 | n,
    v), bytes of 0xC0 and above always in a run."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and data[j] == data[i] and j - i < 63:
            j += 1
        if j - i > 1 or data[i] >= 0xC0:
            out += bytes([0xC0 | (j - i), data[i]])
        else:
            out.append(data[i])
        i = j
    return bytes(out)


def pcx(w, h, bits, planes, rows, version=5, palette16=b"", palette256=None, stride=None,
        whole=True):
    """A PCX file of `rows` (uint8 [h, planes * stride], each row's planes
    one after another). `whole`: each row coded in one piece, so that runs
    cross plane ends (else each plane alone)."""
    stride = stride if stride is not None else (w * bits + 7) // 8
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, w - 1, h - 1, 72, 72)
    head += palette16.ljust(48, b"\0") + bytes([0, planes]) + struct.pack("<HH", stride, 1)
    body = b"".join(pcx_rle(r.tobytes()) if whole else
                    b"".join(pcx_rle(r[k * stride:(k + 1) * stride].tobytes()) for k in range(planes))
                    for r in rows)
    tail = b"" if palette256 is None else b"\x0c" + bytes(palette256)
    return head.ljust(128, b"\0") + body + tail


def planes_of(img, stride):
    """[h, w, c] uint8 as PCX rows: each channel a plane of `stride` bytes."""
    h, w, c = img.shape
    rows = np.zeros((h, c, stride), np.uint8)
    rows[:, :, :w] = img.transpose(0, 2, 1)
    return rows.reshape(h, c * stride)


def bitplanes(idx, planes, stride):
    """Index rows [h, w] as `planes` 1-bit planes of `stride` bytes."""
    h, w = idx.shape
    out = np.zeros((h, planes, stride), np.uint8)
    for k in range(planes):
        bits = np.zeros((h, stride * 8), np.uint8)
        bits[:, :w] = (idx >> k) & 1
        out[:, k] = np.packbits(bits, axis=1)
    return out.reshape(h, planes * stride)


def dcx(pages):
    at = 4 + 4 * (len(pages) + 1)
    offsets, body = [], b""
    for p in pages:
        offsets.append(at + len(body))
        body += p
    return struct.pack("<I", 987654321) + struct.pack(f"<{len(pages) + 1}I", *offsets, 0) + body


def sgi_rle_row(row: bytes, bpc: int) -> bytes:
    """One channel row of SGI RLE: runs (n < 128, one value) and literals
    (0x80 | n, n values) of up to 127 samples, then a 0 stop."""
    vals = [row[i:i + bpc] for i in range(0, len(row), bpc)]
    out, i, lit = bytearray(), 0, []

    def word(v):
        return bytes([v]) if bpc == 1 else bytes([0, v])

    def flush():
        while lit:
            k = min(len(lit), 127)
            out.extend(word(0x80 | k) + b"".join(lit[:k]))
            del lit[:k]

    while i < len(vals):
        j = i
        while j < len(vals) and vals[j] == vals[i] and j - i < 127:
            j += 1
        if j - i >= 3:
            flush()
            out.extend(word(j - i) + vals[i])
            i = j
        else:
            lit.append(vals[i])
            i += 1
    flush()
    return bytes(out) + word(0)


def sgi(img, bpc=1, rle=True):
    """An SGI file of img ([h, w, c] uint8, or uint16 at bpc 2), stored
    bottom row first, verbatim or run-length coded."""
    h, w, z = img.shape
    dim = 3 if z > 1 else 2
    head = struct.pack(">HBBHHHH", 474, int(rle), bpc, dim, w, h, z).ljust(512, b"\0")
    raw = img.astype(">u2" if bpc == 2 else np.uint8)[::-1]
    if not rle:
        return head + b"".join(raw[..., c].tobytes() for c in range(z))
    rows = [[sgi_rle_row(raw[y, :, c].tobytes(), bpc) for y in range(h)] for c in range(z)]
    at = 512 + 8 * h * z
    starts, lens, body = [], [], b""
    for c in range(z):
        for y in range(h):
            starts.append(at + len(body))
            lens.append(len(rows[c][y]))
            body += rows[c][y]
    return head + struct.pack(f">{h * z}I", *starts) + struct.pack(f">{h * z}I", *lens) + body


def sun_rle(data: bytes) -> bytes:
    """Sun byte encoding: 0x80 n v for n + 1 copies (runs of 3-256, or any
    run of 0x80), 0x80 0 for one 0x80; runs cross row ends."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and data[j] == data[i] and j - i < 256:
            j += 1
        n = j - i
        if n >= 3 or (data[i] == 0x80 and n > 1):
            out += bytes([0x80, n - 1, data[i]])
        elif data[i] == 0x80:
            out += b"\x80\x00"
        else:
            out += data[i:j]
        i = j
    return bytes(out)


def sun(w, h, depth, pixels, file_type=1, palette=None, padded=True):
    """A Sun raster file; pixels the row bytes ([h, row bytes]), padded to
    16 bits (unless `padded` is False) and run-length coded at type 2;
    palette RGB [n, 3]."""
    row = (w * depth + 7) // 8
    stride = (w * depth + 15) // 16 * 2 if padded else row
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :row] = pixels
    data = rows.tobytes()
    if file_type == 2:
        data = sun_rle(data)
    pal = b"" if palette is None else np.asarray(palette, np.uint8).T.tobytes()
    head = struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), file_type,
                       1 if palette is not None else 0, len(pal))
    return head + pal + data


def msp_v2(bits):
    """An MSP v2 (LinS) file of bool [h, w] (True: PIL's white): a row map,
    then each row as runs (0 n v) and literals (n, bytes)."""
    h, w = bits.shape
    rows = []
    for r in np.packbits(bits, axis=1):
        out, i = bytearray(), 0
        while i < len(r):
            j = i
            while j < len(r) and r[j] == r[i] and j - i < 255:
                j += 1
            if j - i >= 3:
                out += bytes([0, j - i, r[i]])
                i = j
            else:
                k = min(len(r) - i, 5)
                out += bytes([k]) + r[i:i + k].tobytes()
                i += k
        rows.append(bytes(out))
    head = list(struct.unpack("<16H", b"LinS" + struct.pack("<HHHHHH", w, h, 1, 1, w, h)
                              .ljust(28, b"\0")))
    check = 0
    for v in head[:12] + head[13:]:
        check ^= v
    head[12] = check
    return struct.pack("<16H", *head) + struct.pack(f"<{h}H", *map(len, rows)) + b"".join(rows)


def xpm(idx, colours, cpp=1, keys=None, lines=None):
    """An XPM of index rows [h, w] into colours (["#RRGGBB" or "None" ...]),
    `cpp` characters a pixel; `lines`: extra text for a colour line."""
    h, w = idx.shape
    alphabet = ".#abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789+@"
    if keys is None:
        keys = []
        for i in range(len(colours)):
            k, n = "", i
            for _ in range(cpp):
                k, n = alphabet[n % len(alphabet)] + k, n // len(alphabet)
            keys.append(k)
    out = ["/* XPM */", "static char *img[] = {", f'"{w} {h} {len(colours)} {cpp}",']
    for k, c in zip(keys, colours):
        out.append(f'"{k} {(lines or {}).get(k, "c")} {c}",')
    out.append("/* pixels */")
    out += ['"' + "".join(keys[i] for i in row) + '",' for row in idx]
    out.append("};")
    return ("\n".join(out) + "\n").encode()


def hex_colours(rgb):
    return ["#%02X%02X%02X" % tuple(int(v) for v in c) for c in rgb]


IM_TYPES = ("0 1", "L 1", "B1", "Greyscale", "Grayscale", "X 24", "RGB", "RGBA", "RGBX", "LA",
            "PA", "CMYK", "L 8", "L 8S", "L 16", "L 16S", "L 16L", "L 16B", "L 32", "L 32S",
            "L 32F", "L 32 S", "L 32 F", "L*8", "L*16", "L*32", "L*8S", "L*16B", "L*32S",
            "YCC", "RGB3", "RYB3", "B2", "B4")


def im_file(kind, w, h, body, lut=False):
    """An IM file of `kind` ("<kind> image"), `body` after the header (the
    768-byte palette first when `lut`)."""
    head = b"Image type: %s image\r\nImage size (x*y): %d*%d\r\n" % (kind.encode(), w, h)
    return (head + (b"Lut: 1\r\n" if lut else b"")).ljust(511, b"\0") + b"\x1a" + body


def pixar(rgb, layout=(14, 2)):
    h, w = rgb.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\0\0"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, *layout)
    return bytes(head) + rgb.tobytes()


def spider(img, big=True):
    """A SPIDER 2D image (float32 [h, w]) in either byte order."""
    h, w = img.shape
    lenbyt = w * 4
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt
    hdr = [0.0] * (labbyt // 4)
    for i, v in ((0, 1), (1, h), (2, h), (4, 1), (11, w), (12, labrec), (21, labbyt), (22, lenbyt)):
        hdr[i] = float(v)
    order = ">" if big else "<"
    return struct.pack(f"{order}{len(hdr)}f", *hdr) + img.astype(order + "f4").tobytes()


def fits_cards(cards):
    text = "".join((f"{k:<8}= {v:>20}" if v is not None else k).ljust(80) for k, v in cards)
    text += "END".ljust(80)
    return text.encode().ljust(-(-len(text) // 2880) * 2880, b" ")


def fits(arr, bitpix, extra=()):
    """A FITS primary image of arr [h, w], stored bottom row first."""
    h, w = arr.shape
    dtype = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    head = fits_cards([("SIMPLE", "T"), ("BITPIX", bitpix), ("NAXIS", 2), ("NAXIS1", w),
                       ("NAXIS2", h), *extra])
    data = np.ascontiguousarray(arr[::-1]).astype(dtype).tobytes()
    return head + data.ljust(-(-len(data) // 2880) * 2880, b"\0")


def fits_gzip(arr, bitpix=8):
    """A GZIP_1 tile-compressed image in a BINTABLE, laid out as PIL's
    FitsGzipDecoder reads it: one gzip member per row of 4-byte big-endian
    words, after a table of one 8-byte descriptor per row."""
    h, w = arr.shape
    rows = [zlib_gzip(arr[::-1][y].astype(">i4").tobytes()) for y in range(h)]
    table = b"".join(struct.pack(">ii", len(r), 0) for r in rows)
    primary = fits_cards([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 0)])
    ext = fits_cards([("XTENSION", "'BINTABLE'"), ("BITPIX", 8), ("NAXIS", 2), ("NAXIS1", 8),
                      ("NAXIS2", h), ("ZIMAGE", "T"), ("ZCMPTYPE", "'GZIP_1  '"),
                      ("ZBITPIX", bitpix), ("ZNAXIS", 2), ("ZNAXIS1", w), ("ZNAXIS2", h)])
    data = table + b"".join(rows)
    return primary + ext + data.ljust(-(-len(data) // 2880) * 2880, b"\0")


def zlib_gzip(raw: bytes) -> bytes:
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    body = c.compress(raw) + c.flush()
    return (b"\x1f\x8b\x08\0\0\0\0\0\0\xff" + body
            + struct.pack("<II", zlib.crc32(raw), len(raw) & 0xFFFFFFFF))


def gbr(img, version=2, comment=b"brush\0"):
    """A GIMP brush of img ([h, w] grey or [h, w, 4] RGBA)."""
    h, w = img.shape[:2]
    depth = 1 if img.ndim == 2 else 4
    if version == 1:
        head = struct.pack(">5I", 20 + len(comment), 1, w, h, depth)
    else:
        head = struct.pack(">5I", 28 + len(comment), 2, w, h, depth) + b"GIMP" + struct.pack(">I", 25)
    return head + comment + img.tobytes()


def mcidas(arr, nbytes, pad=0):
    """A McIdas area of arr [h, w] at 1, 2 or 4 bytes a sample (big-endian),
    each row after a `pad`-byte prefix."""
    h, w = arr.shape
    words = [0] * 64
    words[1] = 4
    for i, v in ((9, h), (10, w), (11, nbytes), (14, 1), (15, pad), (34, 256)):
        words[i - 1] = v
    rows = [bytes(pad) + arr[y].astype({1: ">u1", 2: ">u2", 4: ">i4"}[nbytes]).tobytes()
            for y in range(h)]
    return struct.pack(">64i", *words) + b"".join(rows)


def xvthumb(idx, comments=(b"#XVVERSION:Version 2.28",)):
    h, w = idx.shape
    head = b"P7 332\n" + b"".join(c + b"\n" for c in comments) + b"#END_OF_COMMENTS\n"
    return head + b"%d %d 255\n" % (w, h) + idx.tobytes()


def imt(img, extra=b""):
    h, w = img.shape
    return b"width %d\nheight %d\npixel n8\n%s\x0c" % (w, h, extra) + img.tobytes()


# --- the corpus

def _cases():
    c = {}
    for w, h in ((37, 23), (64, 16), (2, 7), (130, 5)):
        base = Image.fromarray(smooth(h, w, 3, w))
        for mode in ("1", "L", "P", "RGB"):
            c[f"PCX {mode} {w}x{h} (PIL)"] = pil_bytes(base.convert(mode), format="PCX")
        for mode in ("L", "RGB", "RGBA"):
            c[f"SGI {mode} {w}x{h} (PIL)"] = pil_bytes(base.convert(mode), format="SGI")
        c[f"XBM {w}x{h} (PIL)"] = pil_bytes(base.convert("1"), format="XBM")
        c[f"MSP v1 {w}x{h} (PIL)"] = pil_bytes(base.convert("1"), format="MSP")
    for mode in ("1", "L", "P", "RGB", "RGBA", "LA", "PA", "I", "F", "CMYK"):
        im = Image.fromarray(smooth(13, 29, 4, 5), "RGBA").convert(mode)
        c[f"IM {mode} (PIL)"] = pil_bytes(im, format="IM")
    deep = (smooth(9, 21, 1, 6)[..., 0].astype(np.int32) - 60) * 3
    c["IM I;16 (PIL)"] = pil_bytes(Image.fromarray(np.abs(deep).astype(np.uint16)), format="IM")
    c["IM F negative and over 255 (PIL)"] = pil_bytes(
        Image.fromarray(deep.astype(np.float32) * 1.37, "F"), format="IM")
    grey_lut = Image.fromarray(smooth(13, 29, 1, 7)[..., 0], "L").convert("P")
    grey_lut.putpalette(bytes(np.repeat(np.arange(256)[::-1], 3).astype(np.uint8)))
    c["IM P with a grey palette that is not a ramp (PIL)"] = pil_bytes(grey_lut, format="IM")
    # Every image type of ImImagePlugin's table that the port reads, over
    # random bytes (so floats include NaN and infinities), with and without
    # a palette (Lut).
    for k, kind in enumerate(IM_TYPES):
        for lut in (False, True) if kind != "PA" else (True,):  # PA needs a palette
            body = rand(90 + 2 * k + lut, 768 * lut + 7 * 5 * 8).tobytes()
            c[f"IM '{kind} image'{' with a Lut' if lut else ''}"] = im_file(kind, 7, 5, body, lut)
    # YCC through PIL's YCbCr tables over many samples; B2/B4 with a grey
    # Lut keep PIL's empty palette (black), as they do without one.
    c["IM 'YCC image' over random samples"] = im_file("YCC", 64, 48,
                                                      rand(99, 3 * 64 * 48).tobytes())
    grey = np.repeat(rand(98, 1, 256), 3, axis=0).tobytes()
    c["IM 'B4 image' with a grey Lut"] = im_file("B4", 7, 5, grey + rand(97, 20).tobytes(), True)
    for n in (2, 5, 12, 24, 31):  # PIL's bit decoder; mostly zero bytes, so small samples too
        body = rand(110 + n, 7 * 5 * 4 + 8)
        body[rand(111 + n, body.size) > 60] = 0
        c[f"IM 'L*{n} image' (bit-packed)"] = im_file(f"L*{n}", 7, 5, body.tobytes())
    c["SPIDER big-endian (PIL)"] = pil_bytes(Image.fromarray(deep.astype(np.float32) * 1.37, "F"),
                                             format="SPIDER")
    c["SPIDER little-endian"] = spider(deep.astype(np.float32) * 0.71 + 0.5, big=False)
    # PCX kinds PIL does not write: planar 1-bit palettes, runs across planes.
    rng = np.random.default_rng(8)
    for planes in (2, 4):
        idx = runs(9 + planes, 11, 21, high=1 << planes)
        stride = (21 + 7) // 8
        c[f"PCX {planes} planes"] = pcx(21, 11, 1, planes, bitplanes(idx, planes, stride), version=2,
                                        palette16=rand(planes, 48).tobytes(), stride=stride)
    rgb = runs(12, 19, 33, 3, high=4)
    c["PCX RGB runs across planes"] = pcx(33, 19, 8, 3, planes_of(rgb, 34), stride=34)
    c["PCX RGB planes coded alone"] = pcx(33, 19, 8, 3, planes_of(rgb, 34), stride=34, whole=False)
    idx = runs(13, 17, 25)
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    c["PCX 8-bit palette"] = pcx(25, 17, 8, 1, planes_of(idx[..., None], 26), stride=26,
                                 palette256=pal.tobytes())
    noisy = rand(13, 31, 42)
    c["PCX 8-bit, no palette"] = pcx(42, 31, 8, 1, planes_of(noisy[..., None], 42))
    page = pil_bytes(Image.fromarray(smooth(14, 22, 3, 14)), format="PCX")
    c["DCX of two pages"] = dcx([page, pil_bytes(Image.fromarray(smooth(5, 5, 3, 15)), format="PCX")])
    c["DCX 8-bit palette page"] = dcx([pil_bytes(Image.fromarray(smooth(14, 22, 3, 16)).convert("P"),
                                                 format="PCX")])
    for z, name in ((1, "L"), (3, "RGB"), (4, "RGBA")):
        img = runs(17 + z, 21, 37, z, high=6) * 40
        c[f"SGI RLE {name}"] = sgi(img)
        c[f"SGI RLE {name} 16-bit"] = sgi(img.astype(np.uint16) * 251 + 3, bpc=2)
        c[f"SGI verbatim {name} 16-bit"] = sgi(img.astype(np.uint16) * 251 + 3, bpc=2, rle=False)
    c["SGI RLE long runs"] = sgi(np.full((9, 300, 3), 77, np.uint8))
    pal = rng.integers(0, 256, (256, 3))
    for w in (24, 33):
        idx = runs(20 + w, 13, w)
        idx[3, :5] = 0x80
        # Run-length rows of an odd byte count are a hazard (below).
        kinds = (1, 2) if w % 2 == 0 else (1,)
        for t in kinds:
            c[f"SUN 8-bit palette type {t} {w}x13"] = sun(w, 13, 8, idx, t, pal)
            c[f"SUN 8-bit grey type {t} {w}x13"] = sun(w, 13, 8, idx, t)
        bgr = runs(21 + w, 13, w * 3)
        for t in kinds + (3,):
            c[f"SUN 24-bit type {t} {w}x13"] = sun(w, 13, 24, bgr, t)
        for t in (1, 2, 3):
            c[f"SUN 32-bit type {t} {w}x13"] = sun(w, 13, 32, runs(22 + w, 13, w * 4), t)
        c[f"SUN 1-bit {w}x13"] = sun(w, 13, 1, rand(23, 13, (w + 7) // 8))
        c[f"SUN 4-bit palette {w}x13"] = sun(w, 13, 4, rand(24, 13, (w + 1) // 2), 1, pal[:16])
        c[f"SUN 4-bit grey {w}x13"] = sun(w, 13, 4, rand(25, 13, (w + 1) // 2))
    c["SUN 8-bit short palette"] = sun(16, 4, 8, rand(26, 4, 16), 1, pal[:7])
    for w in (37, 16, 300):
        bits = runs(28 + w, 9, w, high=2).astype(bool)
        c[f"MSP v2 {w}x9"] = msp_v2(bits)
    blank = msp_v2(np.ones((5, 16), bool))
    head, rows = blank[:32], blank[32 + 10:]
    c["MSP v2 blank rows"] = head + struct.pack("<5H", 0, 0, 0, 0, 0)
    xb = pil_bytes(Image.fromarray(smooth(6, 13, 3, 29)).convert("1"), format="XBM")
    c["XBM with a hotspot"] = xb.replace(b"_height 6\n", b"_height 6\n#define im_x_hot 1\n"
                                         b"#define im_y_hot 2\n")
    # Headers as XbmImagePlugin's expression takes them: leading space, CR
    # LF, tabs, a name holding "_width", a lone x hotspot, two "_bits[]".
    for k, head in enumerate((b"  \n#define a_width 8\n#define a_height 2\n",
                              b"#define a_width_x_width 8\r\n\r\n#define b_height 2\n"
                              b"#define c_x_hot 1\n#define c_y_hot 1\n",
                              b"#define\ta_width\t8\n#define a_height 2\n#define c_x_hot 1\n")):
        c[f"XBM header variant {k}"] = head + b"char a_bits[]={0x05,0x50};\n_bits[] = 0x77, 0x7e,"
    c["XBM one-digit bytes"] = (b"#define a_width 8\n#define a_height 2\nstatic char a_bits[] = {"
                                b" 0x5, 0xa1 };\n")
    idx = runs(30, 13, 27, high=40)
    cols = hex_colours(rand(31, 40, 3))
    c["XPM 40 colours, 1 char"] = xpm(idx, cols)
    c["XPM 40 colours, 2 chars"] = xpm(idx, cols, cpp=2)
    big = runs(32, 11, 19, high=300).astype(np.int64) + (rand(33, 11, 19) > 200) * 5
    c["XPM 305 colours (RGB)"] = xpm(np.minimum(big, 304), hex_colours(rand(34, 305, 3)), cpp=2)
    c["XPM colours with other keys"] = xpm(idx, cols, lines={".": "s background c",
                                                            "#": "m #000000 c"})
    c["XPM unused None colour"] = xpm(idx, cols + ["None"])
    c["PIXAR RGB"] = pixar(smooth(15, 23, 3, 35))
    for bitpix in (8,):
        c[f"FITS BITPIX {bitpix}"] = fits(smooth(11, 17, 1, 36)[..., 0], bitpix)
    c["FITS BITPIX 8, BZERO ignored"] = fits(smooth(11, 17, 1, 37)[..., 0], 8, [("BZERO", 10)])
    c["FITS GZIP_1 BITPIX 8"] = fits_gzip(smooth(12, 9, 1, 38)[..., 0])
    c["FITS one axis"] = fits_cards([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 1),
                                     ("NAXIS1", 13)]) + rand(39, 13).tobytes().ljust(2880, b"\0")
    c["GBR v1 grey"] = gbr(smooth(9, 14, 1, 40)[..., 0], version=1)
    c["GBR v2 grey"] = gbr(smooth(9, 14, 1, 41)[..., 0])
    c["GBR v2 RGBA"] = gbr(smooth(9, 14, 4, 42))
    deep16 = (smooth(10, 13, 1, 43)[..., 0].astype(np.int64) - 100) ** 2
    c["MCIDAS 1 byte"] = mcidas(smooth(10, 13, 1, 44)[..., 0], 1)
    c["MCIDAS 2 bytes"] = mcidas(deep16, 2, pad=4)
    c["MCIDAS 4 bytes, negative"] = mcidas(deep16 - 5000, 4)
    c["XVTHUMB"] = xvthumb(rand(45, 12, 17))
    c["IMT"] = imt(smooth(11, 14, 1, 46)[..., 0])
    c["IMT with a comment"] = imt(smooth(11, 14, 1, 47)[..., 0], b"* made by hand\n")
    return c


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_legacy_format_equals_pil(name):
    data = CASES[name]
    np.testing.assert_array_equal(image_io.decode_image_rgba(data), pil_rgba(data))


FORMATS = {"PCX": "pcx", "DCX": "dcx", "SGI": "sgi", "SUN": "sun", "MSP": "msp", "IM": "im",
           "XBM": "xbm", "XPM": "xpm", "PIXAR": "pixar", "SPIDER": "spider", "FITS": "fits",
           "GBR": "gbr", "MCIDAS": "mcidas", "XVTHUMB": "xvthumb", "IMT": "imt"}
SUFFIX = {"pcx": ".pcx", "dcx": ".dcx", "sgi": ".sgi", "sun": ".ras", "msp": ".msp", "im": ".im",
          "xbm": ".xbm", "xpm": ".xpm", "pixar": ".pxr", "spider": ".spi", "fits": ".fits",
          "gbr": ".gbr", "mcidas": ".area", "xvthumb": ".thumb", "imt": ".imt"}


@pytest.mark.parametrize("name", ["PCX 4 planes", "DCX of two pages", "SGI RLE RGBA 16-bit",
                                  "SUN 24-bit type 2 24x13", "MSP v2 37x9", "IM P (PIL)",
                                  "XPM 305 colours (RGB)", "FITS GZIP_1 BITPIX 8",
                                  "MCIDAS 2 bytes"])
def test_texture_loaders_agree(tmp_path, monkeypatch, name):
    """The file through both packages' load_image_rgba (tracy_tpu's opens it
    with PIL): the float32 RGBA arrays are equal, and the port's format is
    the one PIL names."""
    data = CASES[name]
    fmt = FORMATS[name.split()[0]]
    assert image_io.image_format(data) == fmt
    path = write(tmp_path, "a" + SUFFIX[fmt], data)
    ref = jax_load(path)
    assert ref is not None
    np.testing.assert_array_equal(port_load(path, monkeypatch), ref)
    assert Image.open(path).format.lower() == fmt


@pytest.mark.parametrize("name", ["PCX RGB 37x23 (PIL)", "SGI RLE RGB", "SUN 8-bit palette type 2 24x13",
                                  "MSP v2 16x9", "IM RGB (PIL)", "XBM 37x23 (PIL)", "XPM 40 colours, 1 char",
                                  "PIXAR RGB", "SPIDER big-endian (PIL)", "FITS BITPIX 8",
                                  "GBR v2 RGBA", "MCIDAS 1 byte", "XVTHUMB", "IMT", "DCX of two pages"])
def test_file_without_a_suffix_loads_in_both_packages(tmp_path, monkeypatch, name):
    """Told apart by content alone, as PIL tells it."""
    data = CASES[name]
    path = write(tmp_path, "texture", data)
    ref = jax_load(path)
    assert ref is not None
    np.testing.assert_array_equal(port_load(path, monkeypatch), ref)


# --- where PIL loses the picture: the format's (ROADMAP, hazards)

def test_pcx_rgb_of_width_3_reads_the_format():
    """PIL writes a 24-bit PCX with each plane's row padded to even bytes,
    and reads green and blue of its own file of width 3 at the width, not
    at the stride. The port reads each plane at its stride."""
    img = rand(53, 6, 3, 3)
    data = pil_bytes(Image.fromarray(img), format="PCX")
    got = image_io.decode_image_rgba(data)
    np.testing.assert_array_equal(got[..., :3], img)
    assert not np.array_equal(got, pil_rgba(data))


def test_im_ycc_is_refused_by_name(tmp_path, monkeypatch):
    """IM's YCC kind, which the port once refused by name, reads through
    PIL's YCbCr tables (csrc/image_jpeg2000.cpp's, shared): PIL's own IM
    file of a YCbCr image loads in both packages alike."""
    data = pil_bytes(Image.fromarray(smooth(6, 9, 3, 56)).convert("YCbCr"), format="IM")
    np.testing.assert_array_equal(image_io.decode_image_rgba(data), pil_rgba(data))
    path = write(tmp_path, "a.im", data)
    np.testing.assert_array_equal(port_load(path, monkeypatch), jax_load(path))


@pytest.mark.parametrize("kind", ["YCC", "RGB3", "RYB3", "B2", "B4"])
def test_im_kind_loads_in_both_packages(tmp_path, monkeypatch, kind):
    """IM's YCC, RGB3 and RYB3 kinds (three whole planes, green first) and
    B2/B4 without a Lut (PIL's empty palette: black) through both
    packages' load_image_rgba: the float32 arrays are equal."""
    path = write(tmp_path, "a.im", CASES[f"IM '{kind} image'"])
    ref = jax_load(path)
    assert ref is not None and ref.shape == (5, 7, 4)
    np.testing.assert_array_equal(port_load(path, monkeypatch), ref)


def test_sun_rle_rows_are_padded_as_the_format_says():
    """A run-length Sun raster of odd width holds its rows padded to 16
    bits, as a raw one does; PIL cuts the decoded stream into unpadded
    rows and shears the picture. The port reads it as the raw file."""
    idx = runs(54, 9, 23)
    raw = image_io.decode_image_rgba(sun(23, 9, 8, idx, 1))
    np.testing.assert_array_equal(raw[..., 0], idx)
    rle = sun(23, 9, 8, idx, 2)
    np.testing.assert_array_equal(image_io.decode_image_rgba(rle), raw)
    assert not np.array_equal(raw, pil_rgba(rle))


@pytest.mark.parametrize("bitpix, extra", [(16, ()), (32, ()), (-32, ()), (-64, ()),
                                           (16, (("BZERO", 32768),)),
                                           (16, (("BSCALE", 0.5), ("BZERO", 3.25)))])
def test_fits_deep_samples_read_the_format(bitpix, extra):
    """FITS samples are big-endian, signed (IEEE at BITPIX -32 and -64),
    then BSCALE * v + BZERO; PIL reads them little-endian, unsigned at 16
    bits, 4-byte at -64 and unscaled. The port reads the format, then takes
    the values to 8 bits as PIL takes modes I and F (clip; truncate and
    clip)."""
    rng = np.random.default_rng(55)
    h, w = 7, 11
    vals = rng.integers(-300, 600, (h, w)).astype(np.float64)
    vals[0, :4] = [0.6, 254.5, 255.5, -0.5]
    stored = vals if bitpix < 0 else np.round(vals)
    opts = dict(extra)
    scale, zero = opts.get("BSCALE", 1.0), opts.get("BZERO", 0.0)
    if zero == 32768:  # unsigned 16-bit samples, stored offset by -32768
        stored = np.abs(stored) - 32768
    data = fits(stored, bitpix, extra)
    phys = (stored.astype(np.float32) if bitpix == -32 else stored) * scale + zero
    want = np.where(np.isnan(phys), 0, np.clip(np.trunc(phys.astype(np.float32)), 0, 255))
    got = image_io.decode_image_rgba(data)
    np.testing.assert_array_equal(got[..., 0], want.astype(np.uint8))
    try:
        assert not np.array_equal(got, pil_rgba(data))
    except OSError:  # PIL finds the -64 data too short for 4-byte floats read as pixels
        assert bitpix == -64


# --- refusals and truncation

REFUSED = {
    "PCX 8-bit version 3": (pcx(4, 4, 8, 1, np.zeros((4, 4), np.uint8), version=3), "unknown PCX mode"),
    "PCX 2 bits": (pcx(4, 4, 2, 1, np.zeros((4, 1), np.uint8), version=5), "unknown PCX mode"),
    "SGI 3 channels at dimension 2": (struct.pack(">HBBHHHH", 474, 0, 1, 2, 4, 4, 3).ljust(560, b"\0"),
                                      "unsupported SGI image mode"),
    "XPM named colour": (xpm(np.zeros((2, 2), int), ["red"]), "colour 'red'"),
    "XPM None colour in a pixel": (xpm(np.array([[0, 1], [1, 0]]), ["#102030", "None"]),
                                   "has no colour"),
    "XPM colour without a c key": (xpm(np.zeros((2, 2), int), ["#102030"], lines={".": "m"}),
                                   "without a 'c' key"),
    "PCX RGB of width 1 (PIL)": (pil_bytes(Image.fromarray(rand(57, 6, 1, 3)), format="PCX"),
                                 "truncated"),
    "IM PA without a palette": (im_file("PA", 7, 5, bytes(70)), "raw mode PA;L"),
    "IM RLB": (im_file("RLB", 7, 5, bytes(105)), "raw mode RLB"),
    "SUN 1-bit with a palette": (sun(16, 4, 1, rand(27, 4, 2), 1, rand(28, 2, 3)),
                                 "1-bit image with a palette"),
    "PCX 8-bit shorter than a palette": (pcx(4, 4, 8, 1, np.zeros((4, 4), np.uint8)),
                                         "shorter than a palette"),
    "MSP v2 corrupt row": (msp_v2(np.ones((2, 16), bool))[:32] + struct.pack("<2H", 2, 2)
                           + b"\x00\x05" * 2, "corrupt"),
    "FITS GZIP_1 BITPIX -32": (fits_gzip(np.zeros((2, 2)), -32), "GZIP_1 image of BITPIX -32"),
    "XVTHUMB one number": (b"P7 332\n#END_OF_COMMENTS\n12\n" + bytes(12), "header '12'"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_kind_falls_back_in_both_packages(tmp_path, monkeypatch, name):
    data, what = REFUSED[name]
    with pytest.raises(ValueError, match=what):
        image_io.decode_image_rgba(data)
    path = write(tmp_path, "a" + SUFFIX[FORMATS[name.split()[0]]], data)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusal_names_its_format_once(name):
    """The message starts with the format's name once: the C source names
    it and nothing names it again ("IM: IM: ..." before)."""
    fmt = {"SUN": "Sun raster", "XVTHUMB": "XV thumbnail"}.get(name.split()[0], name.split()[0])
    with pytest.raises(ValueError) as e:
        image_io.decode_image_rgba(REFUSED[name][0])
    assert str(e.value).startswith(f"{fmt}: ")
    assert not str(e.value).startswith(f"{fmt}: {fmt}: ")


TRUNCATED = ("PCX RGB 37x23 (PIL)", "PCX 4 planes", "DCX of two pages", "SGI RLE RGB",
             "SGI L 37x23 (PIL)", "SGI verbatim RGB 16-bit", "SUN 24-bit type 2 24x13",
             "SUN 8-bit palette type 1 24x13", "MSP v1 37x23 (PIL)", "MSP v2 37x9", "IM RGB (PIL)",
             "IM F negative and over 255 (PIL)", "XBM 37x23 (PIL)", "XPM 40 colours, 2 chars",
             "PIXAR RGB", "SPIDER big-endian (PIL)", "FITS BITPIX 8", "FITS GZIP_1 BITPIX 8",
             "GBR v2 RGBA", "MCIDAS 2 bytes", "XVTHUMB", "IMT")


@pytest.mark.parametrize("name", TRUNCATED)
def test_truncated_file_falls_back_in_both_packages(tmp_path, monkeypatch, name):
    data = CASES[name]
    if name.startswith("FITS") and "GZIP" not in name:
        data = data[:len(data) - 2880 + 50]  # inside the data, not its padding
    cut = data[:len(data) * 3 // 5] if not name.startswith("FITS") else data
    if name.startswith("FITS GZIP"):
        cut = data[:2880 * 2 + 60]
    with pytest.raises(ValueError, match="truncated|not enough|overrun|ends early"):
        image_io.decode_image_rgba(cut)
    path = write(tmp_path, "a" + SUFFIX[FORMATS[name.split()[0]]], cut)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


@pytest.mark.parametrize("kind, keep", [("RGB3", 2 * 35 + 9), ("YCC", 3 * 7 * 4 + 5)])
def test_truncated_im_planes_fall_back_in_both_packages(tmp_path, monkeypatch, kind, keep):
    """RGB3 cut inside its blue plane, YCC inside its top row (the last
    stored): both packages give up."""
    cut = CASES[f"IM '{kind} image'"][:512 + keep]
    with pytest.raises(ValueError, match="truncated"):
        image_io.decode_image_rgba(cut)
    path = write(tmp_path, "a.im", cut)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None
