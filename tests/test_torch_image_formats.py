"""TGA, BMP, GIF, PNM and PSD decoding without PIL (csrc/image_formats.cpp)
against tracy_tpu's, which decodes every 8-bit texture through PIL.

Each image is made from a seeded numpy array and written by PIL where PIL
writes the variant, else by the small encoders below, then loaded by
tracy_tpu's `load_image_rgba` and by the port's with PIL blocked in
sys.modules. Contracts:

* Equal bit for bit (float32 RGBA, u8 / 255) for every variant PIL reads
  as the format and stb_image mean it, including the two alpha channels
  where the port follows PIL and not stb_image (32-bit BI_RGB BMP: 255;
  16-bit TGA: PIL's inverted attribute bit), each pinned by its own test.
* Where PIL loses the picture (ROADMAP, hazards), the port follows
  stb_image or the format, each case held against the picture it should
  give and shown to differ from PIL's: 16-bit grey PNM (the high byte),
  TGA 15-bit pixels and 15- and 32-bit colour maps, RLE runs across rows
  and a colour map on a grey image, BMP RLE deltas and odd RLE4 absolute
  runs, and PSD PackBits with more channels than the colour mode uses.
* Kinds the decoders refuse raise ValueError naming them and fall back
  (None) in both packages; truncated files fall back and are listed in builder.fallbacks; a
  decoder library that cannot be built raises for every format.
* A TGA is found by its header, whatever its name; a 2048x2048 TGA, BMP
  and GIF each decode in under a second; read_image and optimize_cli
  -target take BMP, TGA and ASCII PPM as tracy_tpu's optimize_cli does.
"""

import io
import logging
import struct
import time

import numpy as np
import pytest
from PIL import Image

from test_torch_image_decode import pil_bytes, port_load, write
from tracy_tpu.scene.textures import load_image_rgba as jax_load
from tracy_tpu_torch.utils import image_io, native


def u8(rng, *shape):
    return rng.integers(0, 256, shape).astype(np.uint8)


def rgba_of(rgb, alpha=255):
    """float32 RGBA in [0, 1] of uint8 RGB [..., 3] (and alpha)."""
    a = np.broadcast_to(np.asarray(alpha, np.uint8), rgb.shape[:-1])[..., None]
    return np.concatenate([rgb, a], -1).astype(np.float32) / 255.0


# --- encoders for what PIL does not write

def tga(w, h, itype, depth, pixels, cmap=b"", cmstart=0, cmlen=0, cmdepth=0, desc=0x20,
        idf=b""):
    """A TGA file; desc 0x20 top-down, 0x10 right-to-left."""
    return struct.pack("<BBBHHBHHHHBB", len(idf), 1 if cmdepth else 0, itype, cmstart, cmlen,
                       cmdepth, 0, 0, w, h, depth, desc) + idf + cmap + pixels


def tga_rle(pixels: bytes, bpp: int, row=None) -> bytes:
    """RLE packets of pixels (bpp bytes each), breaking at every `row`
    pixels unless row is None (packets then run across rows)."""
    px = [pixels[i:i + bpp] for i in range(0, len(pixels), bpp)]
    rows = [px] if row is None else [px[i:i + row] for i in range(0, len(px), row)]
    out = bytearray()
    for r in rows:
        i = 0
        while i < len(r):
            j = i
            while j + 1 < len(r) and r[j + 1] == r[i] and j + 1 - i < 127:
                j += 1
            if j > i:
                out += bytes([0x80 | (j - i)]) + r[i]
            else:
                while (j + 1 < len(r) and j + 1 - i < 127
                       and not (j + 2 < len(r) and r[j + 1] == r[j + 2])):
                    j += 1
                out += bytes([j - i]) + b"".join(r[i:j + 1])
            i = j + 1
    return bytes(out)


def bmp(w, h, bits, pixels, pal=b"", comp=0, colors=0, hsize=40, masks=None, top_down=False):
    """A BMP file: hsize 12 (OS/2 core), 40, 108 or 124; masks (r, g, b[, a])
    for BI_BITFIELDS (after a 40-byte header, inside the longer ones)."""
    if hsize == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", hsize, w, -h if top_down else h, 1, bits, comp,
                           len(pixels), 2835, 2835, colors, 0)
        m = list(masks or ()) + [0] * (4 - len(masks or ()))
        if hsize == 40:
            info += struct.pack("<III", *m[:3]) if masks else b""
        else:  # V3 (56): the four masks; V4 (108) and V5 (124): a colour space
            info += struct.pack("<IIII", *m)
            info += b"BGRs" + bytes(hsize - 60) if hsize > 56 else b""
    off = 14 + len(info) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off) + info + pal + pixels


def bmp_rows(rows, top_down=False):
    """Rows of bytes, each padded to 4 bytes, bottom-up unless top_down."""
    return b"".join(r + bytes(-len(r) % 4) for r in (rows if top_down else rows[::-1]))


def lzw(indices, min_bits, clear_at=4096) -> bytes:
    """GIF LZW data of a flat index sequence, packed LSB first; a clear code
    whenever the table reaches clear_at entries."""
    clear, end = 1 << min_bits, (1 << min_bits) + 1
    acc = nbits = 0
    out = bytearray()

    def emit(code, size):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    size, table, nxt = min_bits + 1, {(i,): i for i in range(clear)}, end + 1
    emit(clear, size)
    cur = None
    for px in np.asarray(indices).ravel().tolist():
        if cur is None or cur + (px,) in table:
            cur = (px,) if cur is None else cur + (px,)
            continue
        emit(table[cur], size)
        if nxt < clear_at:
            table[cur + (px,)] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        else:
            emit(clear, size)
            size, table, nxt = min_bits + 1, {(i,): i for i in range(clear)}, end + 1
        cur = (px,)
    emit(table[cur], size)
    emit(end, size)
    return bytes(out) + (bytes([acc]) if nbits else b"")


def gif_table(pal):
    """(flags, bytes) of a colour table, padded to a power of two."""
    pal = np.asarray(pal, np.uint8).reshape(-1, 3)
    bits = max(1, int(np.ceil(np.log2(max(len(pal), 2)))))
    full = np.zeros((1 << bits, 3), np.uint8)
    full[:len(pal)] = pal
    return 0x80 | (bits - 1), full.tobytes()


def gif(size, frames, global_pal=None, prefix=b""):
    """A GIF89a file. frames: dicts of idx ([h, w]), pos, pal (local table),
    interlace, trns, min_bits, clear_at; prefix: blocks before the first."""
    flags, table = gif_table(global_pal) if global_pal is not None else (0, b"")
    out = b"GIF89a" + struct.pack("<HHBBB", *size, flags, 0, 0) + table + prefix
    for f in frames:
        idx = np.asarray(f["idx"], np.uint8)
        if f.get("trns") is not None:
            out += b"!\xf9\x04" + struct.pack("<BHB", 1, 0, f["trns"]) + b"\0"
        lflags, ltable = gif_table(f["pal"]) if f.get("pal") is not None else (0, b"")
        if f.get("interlace"):
            lflags |= 0x40
            idx = idx[[r for start, step in ((0, 8), (4, 8), (2, 4), (1, 2))
                       for r in range(start, idx.shape[0], step)]]
        bits = f.get("min_bits", 8)
        data = lzw(idx, bits, f.get("clear_at", 4096))
        out += b"," + struct.pack("<HHHHB", *f.get("pos", (0, 0)), idx.shape[1], idx.shape[0],
                                  lflags) + ltable + bytes([bits])
        out += b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                        for i in range(0, len(data), 255)) + b"\0"
    return out + b";"


def packbits(row: bytes) -> bytes:
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


def psd(planes, mode, rle=True, palette=b"", depth=8, version=1, width=None):
    """A PSD file of planes [c, h, w] (mode 0 bitmap, 1 grey, 2 indexed, 3
    RGB, 4 CMYK, 9 Lab) with one image resource and no layers; `width` the
    pixels of a 1-bit row of w bytes."""
    planes = np.asarray(planes, np.uint8)
    c, h, w = planes.shape
    w = width or w
    res = b"8BIM" + struct.pack(">HHI", 1005, 0, 4) + b"abcd"
    out = (b"8BPS" + struct.pack(">H6xHIIHH", version, c, h, w, depth, mode)
           + struct.pack(">I", len(palette)) + palette + struct.pack(">I", len(res)) + res
           + struct.pack(">I", 0))
    if not rle:
        return out + struct.pack(">H", 0) + planes.tobytes()
    rows = [packbits(planes[k, y].tobytes()) for k in range(c) for y in range(h)]
    return (out + struct.pack(">H", 1) + b"".join(struct.pack(">H", len(r)) for r in rows)
            + b"".join(rows))


# --- the cases held equal to tracy_tpu's decode

def _tga_cases(rng):
    rgb, rgba = u8(rng, 13, 21, 3), u8(rng, 13, 21, 4)
    pal_im = Image.fromarray(rng.integers(0, 40, (13, 21)).astype(np.uint8), "P")
    pal_im.putpalette(u8(rng, 120).tolist())
    ims = {"RGB": Image.fromarray(rgb), "RGBA": Image.fromarray(rgba),
           "L": Image.fromarray(rgb[..., 0]), "LA": Image.fromarray(rgba[..., :2], "LA"),
           "P": pal_im}
    cases = {}
    for mode, im in ims.items():
        cases[f"TGA {mode} written by PIL"] = pil_bytes(im, format="TGA")
        cases[f"TGA {mode} RLE top-down written by PIL"] = pil_bytes(im, format="TGA", rle=True,
                                                                    orientation=1)
    px16 = rng.integers(0, 1 << 16, 13 * 21).astype("<u2").tobytes()
    cases["TGA 16-bit"] = tga(21, 13, 2, 16, px16)
    cases["TGA 16-bit RLE"] = tga(21, 13, 10, 16, tga_rle(px16, 2, row=21), desc=0)
    smooth = np.repeat(rgb[:, ::3], 3, axis=1).tobytes()  # runs for RLE
    cases["TGA 24-bit RLE, literal packets across rows"] = tga(21, 13, 10, 24,
                                                               tga_rle(rgb.tobytes(), 3))
    cases["TGA 24-bit RLE bottom-up"] = tga(21, 13, 10, 24, tga_rle(smooth, 3, row=21), desc=0)
    for desc in (0x10, 0x30):
        cases[f"TGA 32-bit descriptor {desc:#x} (right to left)"] = tga(
            21, 13, 2, 32, rgba.tobytes(), desc=desc | 8)
    cases["TGA image-ID field"] = tga(21, 13, 3, 8, rgb[..., 0].tobytes(), idf=b"tracy id")
    idx = rng.integers(0, 40, 13 * 21).astype(np.uint8).tobytes()
    map16 = rng.integers(0, 1 << 16, 32).astype("<u2").tobytes()
    cases["TGA colour map 16-bit, first index 4"] = tga(21, 13, 1, 8, idx, map16, 4, 32, 16)
    map24 = u8(rng, 30, 3).tobytes()
    cases["TGA colour map 24-bit RLE, first index 3"] = tga(
        21, 13, 9, 8, tga_rle(idx, 1, row=21), map24, 3, 30, 24)
    return cases


def _bmp_cases(rng):
    rgb, rgba = u8(rng, 11, 19, 3), u8(rng, 11, 19, 4)
    pal_im = Image.fromarray(rng.integers(0, 200, (11, 19)).astype(np.uint8), "P")
    pal_im.putpalette(u8(rng, 600).tolist())
    cases = {f"BMP {k} written by PIL": pil_bytes(im, format="BMP") for k, im in {
        "RGB": Image.fromarray(rgb), "L": Image.fromarray(rgb[..., 0]), "P": pal_im,
        "1-bit": Image.fromarray(rgb[..., 0]).convert("1")}.items()}
    pal = b"".join(bytes([*u8(rng, 3), 0]) for _ in range(16))
    idx = rng.integers(0, 16, (11, 19)).astype(np.uint8)
    nib = [bytes(((r[0::2] << 4) | np.append(r[1::2], 0)[:len(r[0::2])]).astype(np.uint8))
           for r in idx]
    cases["BMP 4-bit"] = bmp(19, 11, 4, bmp_rows(nib), pal)
    cases["BMP 4-bit palette of 9 entries"] = bmp(19, 11, 4, bmp_rows(nib), pal[:36], colors=9)
    pal3 = b"".join(e[:3] for e in (pal[i:i + 4] for i in range(0, 64, 4))) * 16
    cases["BMP 12-byte header, 8-bit"] = bmp(19, 11, 8, bmp_rows([bytes(r) for r in idx]), pal3,
                                             hsize=12)
    cases["BMP 8-bit top-down"] = bmp(19, 11, 8, bmp_rows([bytes(r) for r in idx], True), pal,
                                      colors=16, top_down=True)
    cases["BMP 108-byte header, 24-bit"] = bmp(19, 11, 24, bmp_rows(
        [r[:, ::-1].tobytes() for r in rgb]), hsize=108)
    px16 = rng.integers(0, 1 << 16, (11, 19)).astype("<u2")
    cases["BMP 16-bit 5-5-5"] = bmp(19, 11, 16, bmp_rows([r.tobytes() for r in px16]))
    cases["BMP 16-bit 5-6-5 bitfields"] = bmp(19, 11, 16, bmp_rows([r.tobytes() for r in px16]),
                                              comp=3, masks=(0xF800, 0x7E0, 0x1F))
    px32 = bmp_rows([r.tobytes() for r in rgba])
    cases["BMP 32-bit bitfields BGRA, 124-byte header"] = bmp(
        19, 11, 32, px32, comp=3, hsize=124, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    cases["BMP 32-bit bitfields XBGR, 40-byte header"] = bmp(
        19, 11, 32, px32, comp=3, masks=(0xFF000000, 0xFF0000, 0xFF00))
    # RLE8: a run, an absolute run that runs on into the next row, a row cut
    # short by end-of-line, a run clipped at the row's end; RLE4 the same.
    rle8 = bytes([3, 5, 0, 3, 1, 2, 7, 0, 0, 0, 30, 9, 0, 0, 0, 21, *range(21), 0,
                  2, 4, 0, 0, 0, 1])
    cases["BMP RLE8"] = bmp(19, 4, 8, rle8, pal, comp=1, colors=16)
    rle4 = bytes([5, 0x1F, 0, 4, 0x23, 0x45, 0, 0, 40, 0x67, 0, 0, 0, 6, 0x89, 0xAB, 0xCD, 0,
                  3, 0x42, 0, 0, 0, 1])
    cases["BMP RLE4"] = bmp(19, 3, 4, rle4, pal, comp=2, colors=16)
    return cases


def _gif_cases(rng):
    pal = u8(rng, 256, 3)
    big = rng.integers(0, 256, (23, 37)).astype(np.uint8)
    small = rng.integers(0, 4, (9, 14)).astype(np.uint8)
    p_im = Image.fromarray(big, "P")
    p_im.putpalette(pal.ravel().tolist())
    grey_ramp = np.repeat(np.arange(4), 3).reshape(4, 3)
    ext = (b"!\xfe\x05hello\x00"  # a comment, then NETSCAPE's loop count
           + b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")
    return {
        "GIF P written by PIL": pil_bytes(p_im, format="GIF"),
        "GIF P interlaced written by PIL": pil_bytes(p_im, format="GIF", interlace=True),
        "GIF L written by PIL": pil_bytes(Image.fromarray(big), format="GIF"),
        "GIF transparency written by PIL": pil_bytes(p_im, format="GIF", transparency=7),
        "GIF interlaced, clear codes": gif((37, 23), [dict(idx=big, interlace=True,
                                                          clear_at=300)], pal),
        "GIF local table, frame inside the screen, transparency": gif(
            (20, 13), [dict(idx=small, pos=(3, 2), pal=pal[:4], trns=2, min_bits=2)], pal),
        "GIF frame beyond the screen": gif((10, 5), [dict(idx=small, pos=(2, 1), min_bits=2)],
                                           pal[:4]),
        "GIF no colour table": gif((14, 9), [dict(idx=small, min_bits=2)]),
        "GIF grey-ramp table, indices beyond it": gif(
            (14, 9), [dict(idx=small * 2 + 1, min_bits=3)], grey_ramp),
        "GIF indices beyond the table": gif((14, 9), [dict(idx=small * 2 + 1, min_bits=3)],
                                            pal[:4]),
        "GIF two frames, extensions first": gif(
            (14, 9), [dict(idx=small, min_bits=2), dict(idx=small[::-1], min_bits=2)],
            pal[:4], prefix=ext),
    }


def _pnm_cases(rng):
    rgb = u8(rng, 7, 9, 3)
    cases = {f"PNM {k} written by PIL": pil_bytes(im, format="PPM") for k, im in {
        "P6": Image.fromarray(rgb), "P5": Image.fromarray(rgb[..., 0]),
        "P4": Image.fromarray(rgb[..., 0]).convert("1")}.items()}
    grey = rng.integers(0, 101, (7, 9))
    ascii_rows = b"\n".join(b" ".join(b"%d" % v for v in r) for r in grey)
    cases["PNM P2 maxval 100, comments"] = (b"P2\n# made by a test\n9 7 # size\n100\n"
                                            + ascii_rows + b"\n")
    cases["PNM P3"] = b"P3 9 7 255\n" + b" ".join(b"%d" % v for v in rgb.ravel()) + b"\n"
    cases["PNM P1, digits without spaces"] = (
        b"P1\n9 7\n" + b"\n".join(b"".join(b"%d" % (v > 127) for v in r) for r in rgb[..., 1]))
    cases["PNM P6 maxval 100, CR separators"] = (b"P6\r9\r7\r100\r"
                                                 + (rgb * 100 // 255).astype(np.uint8).tobytes())
    cases["PNM P5 maxval 7"] = b"P5 9 7 7\n" + (rgb[..., 0] % 8).tobytes()
    cases["PNM P6 16-bit"] = (b"P6\n9 7\n65535\n"
                              + rng.integers(0, 65536, (7, 9, 3)).astype(">u2").tobytes())
    cases["PNM P3 maxval 1000"] = (b"P3\n9 7\n1000\n"
                                   + b" ".join(b"%d" % v for v in rng.integers(0, 1001, 189)))
    return cases


def _psd_cases(rng):
    planes = u8(rng, 5, 11, 17)
    planes[:, :, 3:9] = 77  # runs for PackBits
    pal = u8(rng, 768).tobytes()
    return {
        "PSD RGB raw": psd(planes[:3], 3, rle=False),
        "PSD RGB PackBits": psd(planes[:3], 3),
        "PSD RGBA raw": psd(planes[:4], 3, rle=False),
        "PSD RGBA PackBits": psd(planes[:4], 3),
        "PSD RGB and two extra channels, raw": psd(planes, 3, rle=False),
        "PSD grey raw": psd(planes[:1], 1, rle=False),
        "PSD grey PackBits": psd(planes[:1], 1),
        "PSD grey and alpha, raw": psd(planes[:2], 1, rle=False),
        "PSD indexed PackBits": psd(planes[:1], 2, palette=pal),
    }


def _kind_cases(rng):
    """1-bit TGA, PFM and Pillow's own PNM kinds, CMYK, Lab and 1-bit PSD
    (Lab through PIL's LittleCMS transform, every input checked by
    tools/make_lab_table.py)."""
    grey = u8(rng, 13, 21)
    bits = Image.fromarray(grey).convert("1")
    packed = np.packbits(grey > 127, axis=1)
    f = (rng.normal(100, 120, (7, 9)) * rng.choice([1, 0.01], (7, 9))).astype(np.float32)
    f.ravel()[:4] = [np.nan, np.inf, -np.inf, 254.99]
    cmyk = u8(rng, 7, 9, 4)
    planes = u8(rng, 5, 11, 17)
    planes[:, :, 3:9] = 77  # runs for PackBits
    bitmap = np.packbits(u8(rng, 11, 17) > 127, axis=1)
    return {
        "TGA 1-bit written by PIL": pil_bytes(bits, format="TGA"),
        "TGA 1-bit top-down, right to left": tga(21, 13, 3, 1, packed.tobytes(), desc=0x30),
        "PNM Pf written by PIL": pil_bytes(Image.fromarray(f, "F"), format="PPM"),
        "PNM Pf big-endian, scale 2.5": b"Pf\n9 7\n2.5\n" + f[::-1].astype(">f4").tobytes(),
        "PNM P0CMYK": b"P0CMYK 9 7 255\n" + cmyk.tobytes(),
        "PNM PyCMYK maxval 1000": (b"PyCMYK\n9 7\n1000\n"
                                   + rng.integers(0, 1001, (7, 9, 4)).astype(">u2").tobytes()),
        "PNM PyRGBA": b"PyRGBA 9 7 255\n" + cmyk.tobytes(),
        "PNM PyRGBA maxval 100": b"PyRGBA 9 7 100\n" + (cmyk % 101).tobytes(),
        "PNM PyP, a P image without a palette": b"PyP 9 7 255\n" + cmyk[..., 0].tobytes(),
        "PSD CMYK raw": psd(planes[:4], 4, rle=False),
        "PSD CMYK PackBits": psd(planes[:4], 4),
        "PSD CMYK and alpha, raw": psd(planes, 4, rle=False),
        "PSD 1-bit bitmap raw": psd(bitmap[None], 0, rle=False, depth=1, width=17),
        "PSD 1-bit bitmap PackBits": psd(bitmap[None], 0, depth=1, width=17),
        "PSD Lab raw": psd(planes[:3], 9, rle=False),
        "PSD Lab PackBits": psd(planes[:3], 9),
    }


def _cases():
    rng = np.random.default_rng(2026)
    out = {}
    for make in (_tga_cases, _bmp_cases, _gif_cases, _pnm_cases, _psd_cases):
        out.update(make(rng))
    out.update(_kind_cases(np.random.default_rng(2020)))
    return out


CASES = _cases()
SUFFIX = {"TGA": ".tga", "BMP": ".bmp", "GIF": ".gif", "PNM": ".pnm", "PSD": ".psd"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_format_equals_tracy_tpu(tmp_path, monkeypatch, name):
    path = write(tmp_path, "map" + SUFFIX[name[:3]], CASES[name])
    ref = jax_load(path)
    got = port_load(path, monkeypatch)
    assert ref is not None and got is not None
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_tga_without_its_suffix_loads_in_both_packages(tmp_path, monkeypatch):
    """TGA has no magic number: both packages take the header."""
    data = CASES["TGA RGB RLE top-down written by PIL"]
    path = write(tmp_path, "texture.bin", data)
    assert image_io.image_format(data) == "tga"
    np.testing.assert_array_equal(port_load(path, monkeypatch), jax_load(path))


# --- hazards: the port follows PIL's alpha ...

def test_bmp_32_bit_bi_rgb_alpha_is_pils_255(tmp_path, monkeypatch):
    """PIL writes RGBA as 32-bit BI_RGB and reads the fourth byte as padding
    (alpha 255); stb_image keeps it. The port follows PIL."""
    rgba = u8(np.random.default_rng(1), 6, 5, 4)
    path = write(tmp_path, "a.bmp", pil_bytes(Image.fromarray(rgba), format="BMP"))
    got = port_load(path, monkeypatch)
    np.testing.assert_array_equal(got, rgba_of(rgba[..., :3]))
    np.testing.assert_array_equal(got, jax_load(path))


def test_tga_16_bit_alpha_is_pils_inverted_bit(tmp_path, monkeypatch):
    """PIL reads a 16-bit TGA's top bit as inverted alpha (set: 0);
    stb_image ignores it. The port follows PIL; 5-bit channels scale as
    v * 255 / 31 in both."""
    v = np.random.default_rng(2).integers(0, 1 << 16, (4, 6)).astype("<u2")
    path = write(tmp_path, "a.tga", tga(6, 4, 2, 16, v.tobytes()))
    got = port_load(path, monkeypatch)
    rgb = np.stack([(v >> s & 31) * 255 // 31 for s in (10, 5, 0)], -1).astype(np.uint8)
    np.testing.assert_array_equal(got, rgba_of(rgb, np.where(v & 0x8000, 0, 255)))
    np.testing.assert_array_equal(got, jax_load(path))


# --- ... and stb_image or the format where PIL loses the picture

def _pil_differs(path, want):
    ref = jax_load(path)
    assert ref is None or ref.shape != want.shape or not np.array_equal(ref, want)


@pytest.mark.parametrize("maxval", [65535, 1000])
@pytest.mark.parametrize("kind", ["P5", "P2"])
def test_pnm_16_bit_grey_keeps_the_high_byte(tmp_path, monkeypatch, kind, maxval):
    """PIL opens grey above maxval 255 as mode I and clips it to white; the
    port keeps the high byte of PIL's 16-bit sample, round(v / maxval *
    65535) >> 8 (stb_image's high byte at maxval 65535)."""
    v = np.random.default_rng(3).integers(0, maxval + 1, (5, 8))
    body = (v.astype(">u2").tobytes() if kind == "P5"
            else b" ".join(b"%d" % x for x in v.ravel()))
    path = write(tmp_path, "a.pgm", b"%s\n8 5\n%d\n" % (kind.encode(), maxval) + body)
    high = (np.round(v / maxval * 65535).astype(np.int64) >> 8).astype(np.uint8)
    want = rgba_of(np.repeat(high[..., None], 3, -1))
    np.testing.assert_array_equal(port_load(path, monkeypatch), want)
    if maxval == 65535:
        np.testing.assert_array_equal(high, v >> 8)
    _pil_differs(path, want)


def _tga_hazards(rng):
    v = rng.integers(0, 1 << 16, (4, 6)).astype("<u2")
    five = np.stack([(v >> s & 31) * 255 // 31 for s in (10, 5, 0)], -1).astype(np.uint8)
    idx = rng.integers(0, 24, (4, 6)).astype(np.uint8)
    map32 = u8(rng, 24, 4)
    runs = np.repeat(u8(rng, 6, 3), 4, axis=0)  # runs of 4 pixels in rows of 6
    grey = u8(rng, 4, 6)
    return {
        "15-bit pixels (PIL refuses)": (tga(6, 4, 2, 15, v.tobytes()), rgba_of(five)),
        "15-bit colour map (PIL refuses)": (
            tga(6, 4, 1, 8, idx.tobytes(), v.ravel()[:24].tobytes(), 0, 24, 15),
            rgba_of(five.reshape(-1, 3)[idx])),
        "32-bit colour map (PIL refuses)": (
            tga(6, 4, 1, 8, idx.tobytes(), map32.tobytes(), 0, 24, 32),
            rgba_of(map32[idx][..., 2::-1], map32[idx][..., 3])),
        "RLE runs across rows (PIL refuses)": (
            tga(6, 4, 10, 24, tga_rle(runs[:, ::-1].tobytes(), 3)), rgba_of(runs.reshape(4, 6, 3))),
        "colour map on a grey image (PIL gives black)": (
            tga(6, 4, 3, 8, grey.tobytes(), map32[:3, :3].tobytes(), 0, 3, 24),
            rgba_of(np.repeat(grey[..., None], 3, -1))),
    }


TGA_HAZARDS = _tga_hazards(np.random.default_rng(4))


@pytest.mark.parametrize("name", sorted(TGA_HAZARDS))
def test_tga_read_as_stb_image_where_pil_loses_it(tmp_path, monkeypatch, name):
    data, want = TGA_HAZARDS[name]
    path = write(tmp_path, "a.tga", data)
    np.testing.assert_array_equal(port_load(path, monkeypatch), want)
    _pil_differs(path, want)


def test_bmp_rle_delta_and_odd_rle4_runs_follow_the_format(tmp_path, monkeypatch):
    """An RLE8 delta (dx, dy) skips dx + dy * w pixels, left at index 0 (PIL
    reads two more bytes and loses the rows that follow); an odd RLE4
    absolute run keeps its last pixel (PIL drops it and loses step)."""
    pal = u8(np.random.default_rng(6), 16, 4)
    rgb = pal[:, 2::-1]
    # Bottom-up: index 1, a delta of 2 right and 1 up (to column 3 of the
    # next row), a run of two 3s, end of line, end of bitmap.
    delta = bytes([1, 1, 0, 2, 2, 1, 2, 3, 0, 0, 0, 1])
    path = write(tmp_path, "d.bmp", bmp(5, 2, 8, delta, pal.tobytes(), comp=1, colors=16))
    want = rgba_of(rgb[np.array([[0, 0, 0, 3, 3], [1, 0, 0, 0, 0]])])
    np.testing.assert_array_equal(port_load(path, monkeypatch), want)
    _pil_differs(path, want)

    odd = bytes([0, 5, 0x12, 0x34, 0x50, 0, 0, 0, 0, 1])
    path = write(tmp_path, "o.bmp", bmp(5, 1, 4, odd, pal.tobytes(), comp=2, colors=16))
    want = rgba_of(rgb[np.array([[1, 2, 3, 4, 5]])])
    np.testing.assert_array_equal(port_load(path, monkeypatch), want)
    _pil_differs(path, want)


@pytest.mark.parametrize("mode,channels", [(1, 2), (3, 5)])
def test_psd_packbits_with_extra_channels(tmp_path, monkeypatch, mode, channels):
    """PIL reads the PackBits counts of the channels its mode uses only, so
    the data of a grey + alpha or 5-channel RGB file lands in the wrong
    place; the port reads every channel's counts. Raw data agrees."""
    planes = u8(np.random.default_rng(5), channels, 6, 9)
    path = write(tmp_path, "a.psd", psd(planes, mode))
    raw = write(tmp_path, "raw.psd", psd(planes, mode, rle=False))
    got = port_load(path, monkeypatch)
    want = rgba_of(np.repeat(planes[0][..., None], 3, -1) if mode == 1
                   else planes[:3].transpose(1, 2, 0))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_load(raw, monkeypatch), jax_load(raw))
    np.testing.assert_array_equal(got, jax_load(raw))
    _pil_differs(path, want)


def test_psd_lab_every_input_equals_pil():
    """Every 8-bit (L, a, b) in one 4096x4096 Lab PSD: the port's LittleCMS
    table and tetrahedra against PIL's own transform (ties and rounding
    included)."""
    L, a, b = np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij")
    data = psd(np.stack([v.reshape(4096, 4096) for v in (L, a, b)]), 9, rle=False)
    np.testing.assert_array_equal(image_io.decode_image_rgba(data),
                                  np.asarray(Image.open(io.BytesIO(data)).convert("RGBA")))


# --- refusals, truncation, the library, speed

REFUSED = {
    "TGA 1-bit RLE": (tga(8, 1, 11, 1, b"\x80\xaa"), "run-length 1-bit"),
    "TGA 1-bit colour-mapped": (tga(8, 1, 1, 1, b"\xaa", bytes(6), 0, 2, 24), "1-bit image"),
    "TGA colour-mapped without a map": (tga(8, 1, 1, 8, bytes(8)), "without a colour map"),
    "BMP JPEG compression": (bmp(2, 2, 24, bytes(16), comp=4), "compression 4"),
    "BMP 4-4-4-4 bitfields": (bmp(2, 2, 16, bytes(8), comp=3, hsize=56,
                                  masks=(0xF00, 0xF0, 0xF, 0xF000)), "bitfields layout"),
    "PNM PFM scale 0": (b"Pf\n2 1\n0.0\n" + bytes(8), "scale"),
    "PSD 16-bit": (psd(np.zeros((3, 2, 2)), 3, depth=16), "16-bit"),
    "PSD PSB": (psd(np.zeros((3, 2, 2)), 3, version=2), "PSB"),
    "GIF without an image": (b"GIF89a" + struct.pack("<HHBBB", 2, 2, 0, 0, 0) + b";",
                             "no image"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_kind_falls_back_by_name(tmp_path, monkeypatch, name):
    data, what = REFUSED[name]
    with pytest.raises(ValueError, match=what):
        image_io.decode_image_rgba(data)
    path = write(tmp_path, "a" + SUFFIX[name[:3]], data)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None  # grey in tracy_tpu too


TRUNCATED = {
    "TGA": "TGA 24-bit RLE bottom-up", "BMP": "BMP 108-byte header, 24-bit",
    "GIF": "GIF interlaced, clear codes", "PNM": "PNM P6 16-bit", "PSD": "PSD RGB PackBits",
}


@pytest.mark.parametrize("fmt", sorted(TRUNCATED))
def test_truncated_file_falls_back_in_both_packages(tmp_path, monkeypatch, fmt):
    data = CASES[TRUNCATED[fmt]]
    path = write(tmp_path, "a" + SUFFIX[fmt], data[:len(data) * 2 // 3])
    with pytest.raises(ValueError, match="truncated|ends before"):
        image_io.decode_image_rgba(data[:len(data) * 2 // 3])
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


def test_truncated_maps_are_listed_as_fallbacks(tmp_path):
    from tracy_tpu_torch.scene import load_scene

    lines = []
    for slot, fmt in zip("BNRME", sorted(TRUNCATED)):
        data = CASES[TRUNCATED[fmt]]
        write(tmp_path, "t" + SUFFIX[fmt], data[:len(data) // 2])
        lines.append(f"TEX M {slot} t{SUFFIX[fmt]}")
    scn = tmp_path / "t.scn"
    scn.write_text("SCN T\nOUT 8 6\nCAM (0, 0, 3) (0, 0, 0) (0, 1, 0) 45\n"
                   "MTL M (1, 1, 1) 1 0\n" + "\n".join(lines) + "\nOBJ S (0, 0, 0) 0.5 M\n")
    b = load_scene(str(scn))
    assert sorted(b.fallbacks) == sorted(f"texture t{s}" for s in SUFFIX.values())
    assert all(p.shape == (1, 1, 4) and np.all(p[..., :3] == 0.5) for p in b.atlas.pixels)


@pytest.mark.parametrize("fmt", sorted(TRUNCATED))
def test_missing_compiler_raises_instead_of_grey(tmp_path, monkeypatch, fmt):
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_image_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    path = write(tmp_path, "a" + SUFFIX[fmt], CASES[TRUNCATED[fmt]])
    with pytest.raises(native.ImageDecoderUnavailable, match="no-such-compiler"):
        port_load(path, monkeypatch)


def _big(fmt):
    y, x = np.mgrid[0:2048, 0:2048]
    img = np.stack([(x // 7) % 256, (y // 5) % 256, ((x + y) // 9) % 256], -1).astype(np.uint8)
    if fmt == "GIF":
        return pil_bytes(Image.fromarray(img).quantize(64), format="GIF")
    return pil_bytes(Image.fromarray(img), format=fmt, **({"rle": True} if fmt == "TGA" else {}))


@pytest.mark.parametrize("fmt", ["TGA", "BMP", "GIF"])
def test_2048_map_decodes_in_under_a_second(fmt):
    data = _big(fmt)
    image_io.decode_image_rgba(data)  # builds the library if needed
    t0 = time.perf_counter()
    img = image_io.decode_image_rgba(data)
    secs = time.perf_counter() - t0
    assert img.shape == (2048, 2048, 4)
    assert secs < 1.0, f"{secs:.3f} s"


@pytest.mark.parametrize("name", ["BMP 108-byte header, 24-bit", "TGA P written by PIL",
                                  "PNM P3", "GIF transparency written by PIL"])
def test_read_image_and_optimize_cli_target(tmp_path, monkeypatch, caplog, name):
    """optimize_cli -target of a BMP, a TGA, an ASCII PPM and a GIF: the
    target the train step gets equals what tracy_tpu's optimize_cli makes
    of the file (PIL's convert("RGB") / 255, then linear_from_srgb)."""
    import jax.numpy as jnp
    import tracy_tpu_torch.diff as tdiff
    from tracy_tpu.core.math import linear_from_srgb
    from tracy_tpu_torch.apps import optimize_cli

    data = CASES[name]
    path = write(tmp_path, "target" + SUFFIX[name[:3]], data)
    with Image.open(io.BytesIO(data)) as im:
        shown = np.asarray(im.convert("RGB"), np.float32) / 255.0
    got, linear = image_io.read_image(path)
    assert not linear
    np.testing.assert_array_equal(got, shown)

    seen = []
    make = tdiff.make_train_step

    def spy(*args, **kw):
        step, params, opt = make(*args, **kw)

        def wrapped(params, opt, target, frame):
            seen.append(target.detach().cpu().numpy())
            return step(params, opt, target, frame)

        return wrapped, params, opt

    monkeypatch.setattr(tdiff, "make_train_step", spy)
    h, w = shown.shape[:2]
    caplog.set_level(logging.INFO)
    rc = optimize_cli.main(["-cpu", "-width", str(w), "-height", str(h), "-bounces", "1",
                            "-spp", "1", "-steps", "1", "-target", path,
                            "-out", str(tmp_path / "out.npy")])
    assert rc == 0 and len(seen) == 1
    ref = np.asarray(linear_from_srgb(jnp.asarray(shown)))
    np.testing.assert_allclose(seen[0], ref, rtol=1e-6, atol=1e-7)


def test_optimize_cli_names_the_formats_it_reads(tmp_path, capsys):
    from tracy_tpu_torch.apps import optimize_cli

    path = write(tmp_path, "target.heic", struct.pack(">I", 28) + b"ftypheic" + bytes(16))
    with pytest.raises(SystemExit):
        optimize_cli.main(["-cpu", "-width", "8", "-height", "6", "-target", path])
    assert ("PNG, JPEG, BMP, DIB, GIF, PNM, PSD, TGA, TIFF, DDS, QOI, WebP, JPEG 2000, AVIF, ICO, "
            "CUR, FTEX, BLP, ICNS, PCX, DCX, SGI, SUN, MSP, IM, XBM, XPM, PIXAR, SPIDER, FITS, "
            "GBR, MCIDAS, XVTHUMB, IMT, IPTC, PCD or FLI" in capsys.readouterr().err)
