"""TIFF kinds decoded without PIL (csrc/image_tiff.cpp with image_xz.cpp,
image_zstd.cpp and image_decode.cpp's JPEG decoder) against tracy_tpu's
load_image_rgba, which reads them through PIL and its libtiff 4.7.1.

The files come from PIL's writer (JPEG, CCITT, LZMA, ZSTD, mode I and F,
the floating-point predictor), from libtiff's own writer driven by ctypes
here (`libtiff_file`: YCbCr subsampled and JPEG YCbCr, the CCITT options
and fill orders), and from tests/test_torch_image_tiff.py's `tiff()`
encoder with codecs of this file (zstd frames through Pillow's bundled
libzstd at several levels, xz streams of Python's lzma with delta filters
and every check, ThunderScan's 4-bit coding, old-style JPEG around a JPEG
file). Contracts:

* Each kind equals tracy_tpu's float32 RGBA (u8 / 255) bit for bit.
* Where PIL loses the picture, the port reads the format, each pinned
  with the picture it should give and shown to differ from PIL's:
  compressed big-endian signed and float samples, which libtiff hands PIL
  in native order and PIL unpacks as big-endian; uncompressed YCbCr, which
  PIL unpacks as RGBX; planar CIELab, whose signed a and b PIL's band
  unpacking leaves without their offset.
* Kinds PIL does not open are refused by name in the port and fall back in
  both packages: WebP in TIFF (Pillow's libtiff has no WebP codec),
  SGILog, ICCLab and ITULab, big-endian 12-bit and 32-bit unsigned grey,
  signed WhiteIsZero bytes, YCbCr subsampled 2x4.
* CIELab goes through PIL's LittleCMS transform (csrc/lab_table.h, from
  tools/make_lab_table.py, which checks it on every 8-bit input).

The small helpers here are what tools/make_tiffkinds_fixtures.py uses to
write tests/goldens/tiffkinds/.
"""

import ctypes as C
import glob
import io
import lzma
import os
import struct
import tempfile

import numpy as np
import PIL
import pytest
from PIL import Image

from test_torch_image_decode import port_load, write
from test_torch_image_tiff import tiff
from tracy_tpu.scene.textures import load_image_rgba as jax_load
from tracy_tpu_torch.utils import image_io

# --- encoders

_LIBS = {}


def _pillow_lib(name):
    if name not in _LIBS:
        path = glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs",
                                      f"lib{name}-*.so*"))[0]
        _LIBS[name] = C.CDLL(path)
    return _LIBS[name]


def zstd(data: bytes, level=3) -> bytes:
    """A zstd frame of data by Pillow's bundled libzstd."""
    lib = _pillow_lib("zstd")
    lib.ZSTD_compressBound.restype = C.c_size_t
    lib.ZSTD_compress.restype = C.c_size_t
    lib.ZSTD_compress.argtypes = [C.c_void_p, C.c_size_t, C.c_char_p, C.c_size_t, C.c_int]
    cap = lib.ZSTD_compressBound(C.c_size_t(len(data)))
    out = C.create_string_buffer(cap)
    n = lib.ZSTD_compress(out, cap, data, len(data), level)
    assert n < cap
    return out.raw[:n]


def xz(data: bytes, preset=6, delta=None, check=lzma.CHECK_CRC64) -> bytes:
    """An xz stream of data (LZMA2, after a byte delta filter of distance
    `delta`), as libtiff's LZMA codec writes one a strip."""
    filters = ([{"id": lzma.FILTER_DELTA, "dist": delta}] if delta else []) + [
        {"id": lzma.FILTER_LZMA2, "preset": preset}]
    return lzma.compress(data, format=lzma.FORMAT_XZ, check=check, filters=filters)


def thunder(samples) -> bytes:
    """ThunderScan's coding of 4-bit samples [rows, cols]: runs of the last
    value, pairs of 3-bit deltas, single 2-bit deltas (the others skipped)
    and raw values."""
    t2, t3 = {0: 0, 1: 1, -1: 3}, {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    out = bytearray()
    for row in np.asarray(samples).reshape(len(samples), -1):
        last, i, n = 0, 0, len(row)
        while i < n:
            v = int(row[i])
            j = i
            while j < n and row[j] == last and j - i < 63:
                j += 1
            if j - i >= 2:
                out.append(j - i)
                i = j
                continue
            d = (v - last + 8) % 16 - 8
            if i + 1 < n:
                d2 = (int(row[i + 1]) - v + 8) % 16 - 8
                if abs(d) <= 3 and abs(d2) <= 3:
                    out.append(0x80 | t3[d] << 3 | t3[d2])
                    last, i = int(row[i + 1]), i + 2
                    continue
            if abs(d) <= 1:
                out.append(0x40 | t2[d] << 4 | 2 << 2 | 2)
            else:
                out.append(0xC0 | v)
            last, i = v, i + 1
    return bytes(out)


def libtiff_file(w, h, bits, spp, compression, photometric, rows_per_strip, strips, fields=()):
    """A TIFF written by Pillow's bundled libtiff: each strip's bytes as
    libtiff takes them to encode (TIFFWriteEncodedStrip), `fields` more
    (tag, ctypes values...) set with TIFFSetField (65537 JPEGQUALITY, 65538
    JPEGCOLORMODE among them)."""
    lib = _pillow_lib("tiff")
    lib.TIFFOpen.restype = C.c_void_p
    lib.TIFFOpen.argtypes = [C.c_char_p, C.c_char_p]
    lib.TIFFClose.argtypes = [C.c_void_p]
    lib.TIFFWriteEncodedStrip.argtypes = [C.c_void_p, C.c_uint32, C.c_char_p, C.c_ssize_t]
    lib.TIFFWriteEncodedStrip.restype = C.c_ssize_t
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "a.tif")
        t = lib.TIFFOpen(path.encode(), b"w")
        assert t
        for tag, *args in [(256, w), (257, h), (258, bits), (277, spp), (259, compression),
                           (262, photometric), (284, 1), (278, rows_per_strip), *fields]:
            args = [C.c_int(a) if isinstance(a, int) else a for a in args]
            assert lib.TIFFSetField(C.c_void_p(t), C.c_uint32(tag), *args) == 1, tag
        for i, s in enumerate(strips):
            assert lib.TIFFWriteEncodedStrip(C.c_void_p(t), i, s, len(s)) >= 0, i
        lib.TIFFClose(C.c_void_p(t))
        with open(path, "rb") as f:
            return f.read()


def ycbcr_strips(y, cb, cr, sub, rows_per_strip):
    """libtiff's packing of YCbCr samples (luma [h, w], chroma at the
    subsampled size) in strips: blocks of sub_h x sub_v luma samples, edge
    samples repeated, then Cb and Cr."""
    (sh, sv), (h, w) = sub, y.shape
    yp = np.pad(y, ((0, -h % sv), (0, -w % sh)), mode="edge")
    out = []
    for y0 in range(0, h, rows_per_strip):
        rows = min(rows_per_strip, h - y0)
        s = bytearray()
        for by in range(y0 // sv, (y0 + rows + sv - 1) // sv):
            for bx in range((w + sh - 1) // sh):
                s += yp[by * sv:(by + 1) * sv, bx * sh:(bx + 1) * sh].astype(np.uint8).tobytes()
                s += bytes([cb[by, bx], cr[by, bx]])
        out.append(bytes(s))
    return out


def ycbcr_tiff(rng, h, w, sub, compression, rows_per_strip=8, refbw=None, coefficients=None):
    """Random YCbCr samples subsampled `sub`, compressed by libtiff."""
    y = rng.integers(0, 256, (h, w)).astype(np.uint8)
    cshape = (-(-h // sub[1]), -(-w // sub[0]))
    cb, cr = (rng.integers(0, 256, cshape).astype(np.uint8) for _ in range(2))
    fields = [(530, *sub)]
    if refbw is not None:
        fields.append((532, (C.c_float * 6)(*refbw)))
    if coefficients is not None:
        fields.append((529, (C.c_float * 3)(*coefficients)))
    return libtiff_file(w, h, 8, 3, compression, 6, rows_per_strip,
                        ycbcr_strips(y, cb, cr, sub, rows_per_strip), fields)


def jpeg_ycbcr_tiff(rgb, sub, rows_per_strip=16, quality=75):
    """RGB [h, w, 3] as JPEG YCbCr subsampled `sub`, libjpeg converting."""
    h, w, _ = rgb.shape
    strips = [rgb[y0:y0 + rows_per_strip].tobytes() for y0 in range(0, h, rows_per_strip)]
    return libtiff_file(w, h, 8, 3, 7, 6, rows_per_strip, strips,
                        [(530, *sub), (65538, 1), (65537, quality)])


def ccitt_tiff(black, compression, t4=0, photometric=0, fillorder=1, rows_per_strip=4):
    """Bits [h, w] (1 black in the fax's sense, libtiff's 1 bits) CCITT-coded
    by libtiff."""
    h, w = black.shape
    strips = [np.packbits(black[y0:y0 + rows_per_strip].astype(np.uint8), axis=1).tobytes()
              for y0 in range(0, h, rows_per_strip)]
    fields = [(266, fillorder)] + ([(292, t4)] if compression == 3 else [])
    return libtiff_file(w, h, 1, 1, compression, photometric, rows_per_strip, strips, fields)


def ojpeg_tiff(rgb, subsampling, photometric=6, quality=90):
    """Old-style JPEG: PIL's JPEG file of rgb as the strip, pointed at by
    JPEGInterchangeFormat (513, 514), YCbCrSubSampling as it holds."""
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", quality=quality, subsampling=subsampling)
    jpg = buf.getvalue()
    sub = {0: [1, 1], 1: [2, 1], 2: [2, 2]}[subsampling]

    def make(at):
        return tiff(rgb, 8, photometric, compression=6, codec=lambda r, b: jpg,
                    more={513: (4, [at]), 514: (4, [len(jpg)]), 530: (3, sub)})

    data = make(0)
    return make(data.index(jpg))


def pil_tiff(img, **kw):
    buf = io.BytesIO()
    img.save(buf, format="TIFF", **kw)
    return buf.getvalue()


def smooth(h, w, seed=0):
    y, x = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    base = np.stack([(x * 5 + y * 2) % 256, (y * 6) % 256, ((x + y) * 3) % 256], -1)
    return np.clip(base + rng.integers(-3, 4, base.shape), 0, 255).astype(np.uint8)


def run_rows(w=2700):
    """Rows of white and black runs of every length T.4 codes: one row of
    the terminating lengths 1-63 in turn, then for each makeup length
    (64-2560, and sums past them) a row that opens with a white run of it
    and one whose black run is it (1 black in the fax's sense)."""
    rows, row, colour = [], [], 0
    for r in range(1, 64):
        row += [colour] * r
        colour ^= 1
    rows.append((row * 2)[:w])
    for r in [*range(64, 2561, 64), 1729, 2600, w - 1]:
        rows.append(([0] * r + [1] * w)[:w])
        rows.append(([0] + [1] * r + [0] * w)[:w])
    return np.array(rows, np.uint8)


# --- the cases held equal to tracy_tpu's decode

def _cases():
    rng = np.random.default_rng(2020)
    h, w = 23, 37
    rgb, grey = smooth(h, w, 1), smooth(h, w, 2)[..., 0]
    cases = {}
    # (a) sample formats: PIL's writer, then the encoder's other layouts.
    ints = rng.integers(-300, 600, (h, w)).astype(np.int32)
    floats = (rng.normal(100, 150, (h, w)) * rng.choice([1, 0.01], (h, w))).astype(np.float32)
    floats.ravel()[:4] = [np.nan, np.inf, -np.inf, 254.99]
    for comp in ("raw", "tiff_lzw", "tiff_adobe_deflate", "lzma", "zstd"):
        cases[f"I written by PIL, {comp}"] = pil_tiff(Image.fromarray(ints), compression=comp)
        cases[f"F written by PIL, {comp}"] = pil_tiff(Image.fromarray(floats), compression=comp)
    for comp in ("tiff_lzw", "tiff_adobe_deflate", "lzma", "zstd"):
        cases[f"F floating-point predictor, {comp}"] = pil_tiff(
            Image.fromarray(floats), compression=comp, tiffinfo={317: 3})
        cases[f"I horizontal predictor, {comp}"] = pil_tiff(
            Image.fromarray(ints), compression=comp, tiffinfo={317: 2})
    i16 = rng.integers(-40000, 40000, (h, w)).clip(-32768, 32767).astype(np.int16)
    cases["signed 8-bit grey"] = tiff(grey, sampleformat=2)
    cases["signed 16-bit grey"] = tiff(i16, 16, sampleformat=2)
    cases["signed 16-bit grey, big-endian, uncompressed"] = tiff(i16, 16, sampleformat=2,
                                                                 order=">")
    cases["signed 16-bit grey, LZW"] = tiff(i16, 16, sampleformat=2, compression=5)
    cases["12-bit grey"] = tiff(rng.integers(0, 4096, (h, w)), 12)
    cases["12-bit grey, odd width, LZW strips"] = tiff(rng.integers(0, 600, (h, 9)), 12,
                                                       compression=5, rows_per_strip=5)
    cases["32-bit unsigned grey"] = tiff(rng.integers(0, 1 << 32, (h, w), dtype=np.uint64)
                                         .astype(np.uint32) % 700, 32)
    cases["32-bit unsigned grey above 2^31"] = tiff(
        rng.integers(1 << 31, 1 << 32, (h, w), dtype=np.uint64).astype(np.uint32), 32)
    cases["float WhiteIsZero, tiles"] = tiff(floats, 32, 0, sampleformat=3, tile=(16, 16))
    cases["float big-endian, uncompressed"] = tiff(floats, 32, sampleformat=3, order=">")
    cases["float floating-point predictor, deflate, strips"] = pil_tiff(
        Image.fromarray(floats), compression="tiff_adobe_deflate", tiffinfo={317: 3, 278: 5})
    # (b) YCbCr through libtiff's RGBA interface.
    for sub in ((2, 2), (2, 1), (1, 1), (4, 2), (4, 4), (4, 1), (1, 2)):
        cases[f"YCbCr {sub[0]}x{sub[1]}, LZW"] = ycbcr_tiff(rng, h, w, sub, 5)
    cases["YCbCr 2x2, deflate, odd strips"] = ycbcr_tiff(rng, h, w, (2, 2), 8, rows_per_strip=6)
    cases["YCbCr 2x2, ZSTD"] = ycbcr_tiff(rng, h, w, (2, 2), 50000)
    cases["YCbCr 2x2, limited ReferenceBlackWhite"] = ycbcr_tiff(
        rng, h, w, (2, 2), 5, refbw=[16, 235, 128, 240, 128, 240])
    cases["YCbCr 2x1, fractional ReferenceBlackWhite"] = ycbcr_tiff(
        rng, h, w, (2, 1), 5, refbw=[15.5, 236.7, 100.2, 200, 130, 250.5])
    cases["YCbCr 2x2, BT.709 coefficients"] = ycbcr_tiff(
        rng, h, w, (2, 2), 5, coefficients=[0.2126, 0.7152, 0.0722])
    # (c) JPEG: PIL's RGB, grey and YCbCr; libtiff's subsampled YCbCr.
    for mode in ("RGB", "L", "YCbCr"):
        img = Image.fromarray(rgb if mode != "L" else grey)
        cases[f"JPEG {mode} written by PIL"] = pil_tiff(img.convert(mode), compression="jpeg")
        cases[f"JPEG {mode} written by PIL, quality 40, strips"] = pil_tiff(
            img.convert(mode), compression="jpeg", quality=40, tiffinfo={278: 8})
    for sub in ((2, 2), (2, 1), (1, 1), (4, 2)):
        cases[f"JPEG YCbCr {sub[0]}x{sub[1]} by libtiff"] = jpeg_ycbcr_tiff(smooth(40, 45, 3), sub)
    cases["JPEG YCbCr 4x1 by libtiff"] = jpeg_ycbcr_tiff(smooth(40, 45, 4), (4, 1), 32)
    noisy = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    for ss in (0, 1, 2):
        for ph in (6, 2):
            cases[f"old-style JPEG, PIL's subsampling {ss}, photometric {ph}"] = ojpeg_tiff(
                noisy if ss == 1 else rgb, ss, ph)
    # (d) CCITT: PIL's writer, then libtiff's options and fill orders.
    bits = Image.fromarray(rng.integers(0, 2, (h, w)).astype(np.uint8) * 255).convert("1")
    for comp in ("group3", "group4", "tiff_ccitt"):
        cases[f"CCITT {comp} written by PIL"] = pil_tiff(bits, compression=comp)
    noise = rng.integers(0, 2, (h, w)).astype(np.uint8)
    long_runs = run_rows()
    for comp, t4 in ((2, 0), (3, 0), (3, 1), (3, 4), (3, 5), (4, 0)):
        for ph, fill in ((0, 1), (1, 2)):
            cases[f"CCITT {comp} T4Options {t4}, photometric {ph}, FillOrder {fill}"] = ccitt_tiff(
                noise, comp, t4, ph, fill)
        cases[f"CCITT {comp} T4Options {t4}, every run length"] = ccitt_tiff(long_runs, comp, t4)
    # (e, f) LZMA and ZSTD of other encoders' settings.
    for preset in (0, 6, 9 | lzma.PRESET_EXTREME):
        cases[f"LZMA preset {preset & 15}"] = tiff(rgb, 8, 2, compression=34925,
                                                   codec=lambda r, b, p=preset: xz(r, p))
    for check in (lzma.CHECK_NONE, lzma.CHECK_CRC32, lzma.CHECK_SHA256):
        cases[f"LZMA check {check}, delta 3, predictor 2"] = tiff(
            rgb, 8, 2, compression=34925, predictor=2, rows_per_strip=9,
            codec=lambda r, b, c=check: xz(r, 6, 3, c))
    noisy = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    cases["LZMA incompressible (LZMA2 stored chunks)"] = tiff(noisy, 8, 2, compression=34925,
                                                              codec=lambda r, b: xz(r))
    text = np.frombuffer((b"the port reads TIFF kinds " * 200)[:h * w * 3], np.uint8)
    for level in (1, 3, 9, 19):
        cases[f"ZSTD level {level}, smooth"] = tiff(rgb, 8, 2, compression=50000,
                                                    codec=lambda r, b, l=level: zstd(r, l))
        cases[f"ZSTD level {level}, text"] = tiff(text.reshape(h, w, 3), 8, 2, compression=50000,
                                                  codec=lambda r, b, l=level: zstd(r, l))
    cases["ZSTD incompressible (raw blocks)"] = tiff(noisy, 8, 2, compression=50000,
                                                     codec=lambda r, b: zstd(r))
    # 70,000 bytes of noise, then a copy of its start: literal lengths past
    # 65,536 (the last literal-length code) in one compressed block.
    lits = rng.integers(0, 256, 70000).astype(np.uint8)
    long_lits = np.concatenate([lits, lits[:50000]]).reshape(200, 200, 3)
    cases["ZSTD literal run past 65,536"] = tiff(long_lits, 8, 2, compression=50000,
                                                 codec=lambda r, b: zstd(r, 3))
    cases["ZSTD 16-bit RGB, predictor 2, tiles"] = tiff(
        rng.integers(0, 65536, (h, w, 3)), 16, 2, compression=50000, predictor=2, tile=(16, 16),
        codec=lambda r, b: zstd(r, 5))
    big = smooth(256, 300, 5)
    cases["ZSTD 256x300 RGB, several blocks"] = tiff(big, 8, 2, compression=50000,
                                                     codec=lambda r, b: zstd(r, 7))
    cases["LZMA 256x300 RGB"] = tiff(big, 8, 2, compression=34925, codec=lambda r, b: xz(r, 2))
    for comp in ("lzma", "zstd"):
        for mode, img in (("RGB", Image.fromarray(rgb)), ("1", bits),
                          ("RGBA", Image.fromarray(smooth(h, w, 6)).convert("RGBA"))):
            cases[f"{comp} {mode} written by PIL"] = pil_tiff(img, compression=comp)
    # CIELab, through PIL's LittleCMS transform.
    lab = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    cases["CIELab"] = tiff(lab, 8, 8)
    cases["CIELab, big-endian, LZW strips"] = tiff(lab, 8, 8, order=">", compression=5,
                                                   rows_per_strip=7)
    cases["CIELab, deflate tiles"] = tiff(lab, 8, 8, compression=8, tile=(16, 16))
    # (g) ThunderScan.
    nib = np.cumsum(rng.integers(-2, 3, (h, w)), axis=1) % 16
    nib[2:5, 3:20] = nib[2, 3]
    cases["ThunderScan 4-bit grey"] = tiff(nib, 4, compression=32809, codec=lambda r, b: thunder(b[..., 0]))
    cases["ThunderScan WhiteIsZero, strips"] = tiff(nib, 4, 0, compression=32809, rows_per_strip=7,
                                                    codec=lambda r, b: thunder(b[..., 0]))
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_kind_equals_tracy_tpu(tmp_path, monkeypatch, name):
    path = write(tmp_path, "map.tif", CASES[name])
    ref = jax_load(path)
    got = port_load(path, monkeypatch)
    assert ref is not None and got is not None
    np.testing.assert_array_equal(got, ref)


GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "tiffkinds")
FIXTURES = sorted(n for n in os.listdir(GOLDENS) if n.endswith(".tif") and not n.startswith("big"))


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_map_equals_tracy_tpu(monkeypatch, name):
    path = os.path.join(GOLDENS, name)
    np.testing.assert_array_equal(port_load(path, monkeypatch), jax_load(path))


# --- where PIL loses the picture

def _hazards():
    rng = np.random.default_rng(7)
    i16 = rng.integers(-500, 500, (9, 11)).astype(np.int16)
    i32 = rng.integers(-500, 500, (9, 11)).astype(np.int32)
    f32 = rng.normal(120, 90, (9, 11)).astype(np.float32)
    clip = lambda v: np.clip(v, 0, 255).astype(np.uint8)  # noqa: E731
    return {
        "signed 16-bit, big-endian, LZW": (tiff(i16, 16, sampleformat=2, order=">",
                                                compression=5), clip(i16)),
        "signed 32-bit, big-endian, deflate": (tiff(i32, 32, sampleformat=2, order=">",
                                                    compression=8), clip(i32)),
        "float, big-endian, LZW": (tiff(f32, 32, sampleformat=3, order=">", compression=5),
                                   clip(np.trunc(f32))),
    }


HAZARDS = _hazards()


def test_planar_cielab_read_as_the_format(tmp_path, monkeypatch):
    """PIL reads a planar CIELab file band by band, without the offset it
    gives the signed a and b of a chunky one, and its alpha is then 0; the
    port reads the samples as the chunky file's."""
    lab = np.random.default_rng(9).integers(0, 256, (9, 11, 3)).astype(np.uint8)
    chunky = jax_load(write(tmp_path, "chunky.tif", tiff(lab, 8, 8)))
    path = write(tmp_path, "planar.tif", tiff(lab, 8, 8, planar=2))
    np.testing.assert_array_equal(port_load(path, monkeypatch), chunky)
    ref = jax_load(path)
    assert ref is not None and not np.array_equal(ref, chunky)


def test_uncompressed_ycbcr_read_as_libtiff_reads_it(tmp_path, monkeypatch):
    """PIL's raw reader unpacks uncompressed YCbCr as RGBX; the port reads
    it through libtiff's RGBA interface, as the same samples LZW-coded."""
    rng = np.random.default_rng(8)
    y = rng.integers(0, 256, (10, 14)).astype(np.uint8)
    cb, cr = (rng.integers(0, 256, (5, 7)).astype(np.uint8) for _ in range(2))
    strips = ycbcr_strips(y, cb, cr, (2, 2), 10)
    raw = libtiff_file(14, 10, 8, 3, 1, 6, 10, strips, [(530, 2, 2)])
    lzw = libtiff_file(14, 10, 8, 3, 5, 6, 10, strips, [(530, 2, 2)])
    want = jax_load(write(tmp_path, "lzw.tif", lzw))
    path = write(tmp_path, "raw.tif", raw)
    np.testing.assert_array_equal(port_load(path, monkeypatch), want)
    ref = jax_load(path)
    assert ref is None or not np.array_equal(ref, want)


@pytest.mark.parametrize("name", sorted(HAZARDS))
def test_read_as_the_format_where_pil_loses_it(tmp_path, monkeypatch, name):
    """libtiff swaps compressed big-endian samples to native order and PIL's
    I;16BS, I;32BS and F;32BF unpackers swap them again: the port reads the
    samples the file holds."""
    data, want = HAZARDS[name]
    path = write(tmp_path, "a.tif", data)
    grey = np.repeat(want[..., None], 3, -1)
    rgba = np.concatenate([grey, np.full(want.shape + (1,), 255, np.uint8)], -1)
    np.testing.assert_array_equal(port_load(path, monkeypatch), rgba.astype(np.float32) / 255)
    ref = jax_load(path)
    assert ref is not None and not np.array_equal(ref, rgba.astype(np.float32) / 255)


# --- kinds PIL does not open: refused by name, grey in both packages

def _refused():
    g = np.zeros((4, 6), np.uint8)
    rgb = np.zeros((4, 6, 3), np.uint8)
    webp = io.BytesIO()
    Image.fromarray(rgb).save(webp, format="WEBP", lossless=True)
    return {
        "WebP in TIFF": (tiff(rgb, 8, 2, compression=50001, codec=lambda r, b: webp.getvalue()),
                         "WebP in TIFF"),
        "SGILog": (tiff(np.zeros((4, 6)), 16, 32844, compression=34676), "SGILog"),
        "ICCLab": (tiff(rgb, 8, 9), "photometric 9"),
        "ITULab": (tiff(rgb, 8, 10), "photometric 10"),
        "12-bit big-endian": (tiff(g, 12, order=">"), "12-bit samples"),
        "32-bit unsigned big-endian": (tiff(g, 32, order=">"), "32-bit samples"),
        "signed WhiteIsZero bytes": (tiff(g, 8, 0, sampleformat=2), "SampleFormat 2"),
        "YCbCr 2x4": (tiff(rgb, 8, 6, compression=5, more={530: (3, [2, 4])}),
                      "YCbCr subsampling 2x4"),
        "CCITT of 8-bit samples": (tiff(g, 8, compression=4), "CCITT compression"),
    }


REFUSED = _refused()


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_in_both_packages(tmp_path, monkeypatch, name):
    data, what = REFUSED[name]
    with pytest.raises(ValueError, match=what):
        image_io.decode_image_rgba(data)
    path = write(tmp_path, "a.tif", data)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


@pytest.mark.parametrize("codec", ["xz", "zstd"])
def test_codec_data_cut_short_falls_back_in_both_packages(tmp_path, monkeypatch, codec):
    """An xz or zstd strip cut in its middle (the IFD first, so that the
    tags survive): both packages give up."""
    encode = xz if codec == "xz" else zstd
    data = tiff(smooth(40, 50, 8), 8, 2, compression=34925 if codec == "xz" else 50000,
                ifd_first=True, codec=lambda r, b: encode(r))
    path = write(tmp_path, "a.tif", data[:len(data) * 3 // 4])
    with pytest.raises(ValueError, match="ends early|end early|truncated"):
        image_io.decode_image_rgba(data[:len(data) * 3 // 4])
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None
