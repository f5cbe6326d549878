"""TIFF decoding without PIL (csrc/image_tiff.cpp) against tracy_tpu's,
which decodes every 8-bit texture through PIL (libtiff for compressed
data).

Each file is made from seeded numpy samples by the TIFF encoder below (it
writes what PIL cannot: tiles, LZW with predictor 2 at 16 bits, BigTIFF,
FillOrder 2, PlanarConfiguration 2) or by PIL, then loaded by tracy_tpu's
`load_image_rgba` and by the port's with PIL blocked in sys.modules.
Contracts:

* Equal bit for bit (float32 RGBA, u8 / 255) for every pixel kind PIL has
  a mode for: WhiteIsZero and BlackIsZero at 1, 2, 4 and 8 bits, grey +
  alpha, RGB at 8 and 16 bits with ExtraSamples 0, 1 (associated alpha), 2
  and 999, palette at 1-8 bits (and with a second sample), CMYK at 8 and
  16 bits; in both byte orders, strips and tiles (cropped at the edges),
  both planar configurations, compression none, LZW, deflate (8 and
  32946) and PackBits, with and without predictor 2, FillOrder 2, and
  little-endian BigTIFF.
* Where PIL loses the picture (ROADMAP, hazards), the port follows the
  format, each case held against the picture its samples make and shown
  to differ from PIL's: 16-bit grey (the high byte; PIL clips to white),
  big-endian BigTIFF, FillOrder 2 in uncompressed files PIL has no raw
  mode for, and PlanarConfiguration 2 where PIL's band unpacking breaks.
* Kinds the decoder refuses raise ValueError naming them and fall back
  (None) in both packages; the kinds it once refused and now reads (JPEG, old-style JPEG
  with JPEGInterchangeFormat, CCITT, LZMA, ZSTD, ThunderScan, YCbCr,
  CIELab, signed, 12-bit, 32-bit and float samples) are
  held to PIL's decode in test_torch_image_tiff_kinds.py; truncated files
  fall back in both packages (test_torch_image_dds.py
  lists both kinds of map in builder.fallbacks); a decoder library that
  cannot be built raises.
* A 2048x2048 LZW TIFF decodes in under a second; read_image takes a TIFF
  by content.
"""

import io
import itertools
import struct
import time
import zlib

import numpy as np
import pytest
from PIL import Image

from test_torch_image_decode import pil_bytes, port_load, write
from tracy_tpu.scene.textures import load_image_rgba as jax_load
from tracy_tpu_torch.utils import image_io, native

# --- a TIFF encoder


def lzw(data: bytes) -> bytes:
    """TIFF LZW of data: MSB-first codes of 9 to 12 bits that widen one
    code early, a clear code first and whenever the table fills, then the
    end code."""
    out = bytearray()
    acc = nbits = 0

    def emit(code, width):
        nonlocal acc, nbits
        acc = (acc << width) | code
        nbits += width
        while nbits >= 8:
            out.append((acc >> (nbits - 8)) & 255)
            nbits -= 8
        acc &= (1 << nbits) - 1

    def width(k):  # the width of the k-th code after a clear (k from 1)
        free = 258 + k - 2
        return 9 if k == 1 or free < 511 else 10 if free < 1023 else 11 if free < 2047 else 12

    table = {bytes([i]): i for i in range(256)}
    k = 0
    emit(256, 9)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        k += 1
        emit(table[w], width(k))
        table[wc] = 258 + k - 1
        w = bytes([c])
        if 258 + k == 4094:
            emit(256, width(k + 1))
            table = {bytes([i]): i for i in range(256)}
            k = 0
    if w:
        k += 1
        emit(table[w], width(k))
    emit(257, width(k + 1))
    if nbits:
        out.append((acc << (8 - nbits)) & 255)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 2-128 equal bytes, else literals of up to 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j + 1 - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
        else:
            while j + 1 < n and j + 1 - i < 127 and not (j + 2 < n and data[j + 1] == data[j + 2]):
                j += 1
            out += bytes([j - i]) + data[i:j + 1]
        i = j + 1
    return bytes(out)


REVERSE = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))
TYPES = {3: "H", 4: "I", 16: "Q"}


def pack_rows(block: np.ndarray, bits: int, order: str) -> bytes:
    """Samples [rows, cols, spp] as TIFF bytes; each row starts on a byte."""
    rows, cols, spp = block.shape
    if bits == 8:
        return block.astype(np.uint8).tobytes()
    if bits == 16:
        return block.astype(order + ("i2" if block.dtype.kind == "i" else "u2")).tobytes()
    if bits == 32:
        return block.astype(order + {"f": "f4", "i": "i4"}.get(block.dtype.kind, "u4")).tobytes()
    out = bytearray()
    for r in block.reshape(rows, cols * spp):
        acc = n = 0
        for v in r:
            acc = (acc << bits) | int(v)
            n += bits
            while n >= 8:
                out.append((acc >> (n - 8)) & 255)
                n -= 8
            acc &= (1 << n) - 1
        if n:
            out.append((acc << (8 - n)) & 255)
    return bytes(out)


def tiff(samples, bits=8, photometric=1, order="<", big=False, compression=1, predictor=None,
         fillorder=None, tile=None, rows_per_strip=None, planar=1, extra=None, colormap=None,
         sampleformat=None, more=None, ifd_first=False, codec=None):
    """A TIFF file of samples [H, W, S] (or [H, W]) in one IFD: strips of
    rows_per_strip rows (default all) or tiles (tw, th) padded with zeros;
    PlanarConfiguration 1 or 2; compression 1, 5 (LZW), 8 or 32946
    (deflate), 32773 (PackBits) or any other number (the data then left
    raw, or passed through `codec(bytes, samples) -> bytes`); Predictor 2
    differences each row of a strip or tile before LZW or deflate (or
    `codec`); FillOrder 2 bit-reverses the stored bytes. `more`: {tag:
    (type, [values])} added to the IFD or replacing a tag. The IFD follows
    the data, or comes first with ifd_first."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, nsamp = s.shape
    mask = (1 << bits) - 1

    def encode(block):
        if predictor == 2 and (compression in (5, 8, 32946) or codec):
            block = block.astype(np.int64)
            block[:, 1:] = (block[:, 1:] - block[:, :-1]) & mask
        raw = pack_rows(block, bits, order)
        if codec:
            raw = codec(raw, block)
        elif compression == 5:
            raw = lzw(raw)
        elif compression in (8, 32946):
            raw = zlib.compress(raw, 6)
        elif compression == 32773:
            raw = packbits(raw)
        return raw.translate(REVERSE) if fillorder == 2 else raw

    planes = [s] if planar == 1 else [s[..., k:k + 1] for k in range(nsamp)]
    chunks = []
    for p in planes:
        if tile:
            tw, th = tile
            for y0 in range(0, h, th):
                for x0 in range(0, w, tw):
                    blk = np.zeros((th, tw, p.shape[2]), p.dtype)
                    part = p[y0:y0 + th, x0:x0 + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    chunks.append(encode(blk))
        else:
            for y0 in range(0, h, rows_per_strip or h):
                chunks.append(encode(p[y0:y0 + (rows_per_strip or h)]))

    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * nsamp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [nsamp]), 284: (3, [planar])}
    if tile:
        tags[322], tags[323] = (3, [tile[0]]), (3, [tile[1]])
    elif rows_per_strip:
        tags[278] = (4, [rows_per_strip])
    for tag, value in ((317, predictor), (266, fillorder), (339, sampleformat)):
        if value:
            tags[tag] = (3, [value] * (nsamp if tag == 339 else 1))
    if extra is not None:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, [int(v) for v in colormap])
    tags.update(more or {})
    head, off = (16, 16) if big else (8, 4)
    cnt, inline = ("Q", 8) if big else ("I", 4)
    tags[324 if tile else 273] = (off, [0] * len(chunks))
    tags[325 if tile else 279] = (off, [len(c) for c in chunks])

    def layout(data_at):
        """The IFD and the values that do not fit in it, at ifd_at."""
        offsets, at = [], data_at
        for c in chunks:
            offsets.append(at)
            at += len(c) + len(c) % 2
        tags[324 if tile else 273] = (off, offsets)
        ifd = bytearray(struct.pack(order + ("Q" if big else "H"), len(tags)))
        blob = bytearray()
        blob_at = ifd_at + len(ifd) + len(tags) * (20 if big else 12) + inline
        for tag in sorted(tags):
            typ, vals = tags[tag]
            body = struct.pack(order + TYPES[typ] * len(vals), *vals)
            ifd += struct.pack(order + "HH" + cnt, tag, typ, len(vals))
            if len(body) <= inline:
                ifd += body.ljust(inline, b"\0")
            else:
                ifd += struct.pack(order + cnt, blob_at + len(blob))
                blob += body + b"\0" * (len(body) % 2)
        return ifd + bytes(inline) + blob

    data = b"".join(c + b"\0" * (len(c) % 2) for c in chunks)
    if ifd_first:  # the IFD, then the data: a cut file keeps its tags
        ifd_at = head
        ifd = layout(head + len(layout(head)))
        body = ifd + data
    else:
        ifd_at = head + len(data)
        body = data + layout(head)
    magic = b"II" if order == "<" else b"MM"
    header = magic + (struct.pack(order + "HHHQ", 43, 8, 0, ifd_at) if big
                      else struct.pack(order + "HI", 42, ifd_at))
    return header + body


# --- the cases: each kind, then the layouts

H, W = 19, 37


def rgba_of(rgb, alpha=255):
    """float32 RGBA in [0, 1] of uint8 RGB [..., 3] (and alpha)."""
    rgb = np.asarray(rgb)
    a = np.broadcast_to(np.asarray(alpha), rgb.shape[:-1])[..., None]
    return np.concatenate([rgb, a], -1).astype(np.float32) / 255.0


def _kinds(rng):
    """One file per pixel kind PIL has a mode for, spread over byte
    orders, layouts and compressions."""
    layouts = itertools.cycle([dict(order="<", rows_per_strip=5, compression=5),
                               dict(order=">", tile=(16, 16), compression=8, predictor=2),
                               dict(order="<", rows_per_strip=7, compression=32773),
                               dict(order=">", rows_per_strip=4, compression=1),
                               dict(order="<", tile=(32, 16), compression=32946)])
    out = {}

    def add(name, samples, bits, photometric, **kw):
        lay = dict(next(layouts))
        if bits < 8:
            lay.pop("predictor", None)
        out[f"{name}, {lay['order']} {lay['compression']}"] = tiff(
            samples, bits, photometric, **lay, **kw)

    for bits in (1, 2, 4, 8):
        for ph, what in ((1, "BlackIsZero"), (0, "WhiteIsZero")):
            add(f"{what} {bits}-bit", rng.integers(0, 1 << bits, (H, W)), bits, ph)
    add("grey + alpha", rng.integers(0, 256, (H, W, 2)), 8, 1, extra=(2,))
    for bits in (8, 16):
        extras = [None, (0,), (1,), (2,)] + ([(999,), (0, 0), (1, 0), (2, 0, 0)] if bits == 8 else [])
        for extra in extras:
            s = rng.integers(0, 1 << bits, (H, W, 3 + len(extra or ())))
            add(f"RGB {bits}-bit extra {extra}", s, bits, 2, extra=extra)
        add(f"RGBA {bits}-bit without ExtraSamples", rng.integers(0, 1 << bits, (H, W, 4)), bits, 2)
    for bits in (1, 2, 4, 8):
        n = 1 << bits
        add(f"palette {bits}-bit", rng.integers(0, n, (H, W)), bits, 3,
            colormap=rng.integers(0, 65536, 3 * n))
    for extra in ((0,), (2,)):
        add(f"palette + sample {extra}", rng.integers(0, 256, (H, W, 2)), 8, 3, extra=extra,
            colormap=rng.integers(0, 65536, 768))
    for bits, extra in ((8, None), (8, (0,)), (8, (0, 0)), (16, None)):
        add(f"CMYK {bits}-bit extra {extra}", rng.integers(0, 1 << bits, (H, W, 4 + len(extra or ()))),
            bits, 5, extra=extra)
    return out


COMPRESSIONS = [(1, None), (5, None), (5, 2), (8, None), (32946, 2), (32773, None)]


def _layouts(rng):
    """8-bit RGB and 16-bit grey in both byte orders, strips and tiles,
    both planar configurations (RGB), every compression with and without
    predictor; 16-bit RGB with LZW and deflate under predictor 2."""
    out = {}
    rgb = rng.integers(0, 256, (H, W, 3))
    for (comp, pred), order, tile, planar in itertools.product(
            COMPRESSIONS, "<>", [None, (16, 16)], [1, 2]):
        lay = f"tiles 16x16" if tile else "strips of 5"
        out[f"RGB {order} {lay} planar {planar} compression {comp} predictor {pred}"] = tiff(
            rgb, 8, 2, order, compression=comp, predictor=pred, tile=tile,
            rows_per_strip=None if tile else 5, planar=planar)
    rgb16 = rng.integers(0, 65536, (H, W, 3))
    for comp, order, planar in itertools.product((5, 8), "<>", (1, 2)):
        out[f"RGB 16-bit {order} planar {planar} compression {comp} predictor 2"] = tiff(
            rgb16, 16, 2, order, compression=comp, predictor=2, tile=(16, 32), planar=planar)
    for comp in (1, 5, 8, 32773):
        out[f"RGB little-endian BigTIFF compression {comp}"] = tiff(
            rgb, 8, 2, "<", big=True, compression=comp, rows_per_strip=6)
    for bits, ph, comp in ((1, 0, 5), (1, 1, 1), (2, 1, 8), (4, 0, 32773), (8, 1, 5),
                           (8, 1, 1), (4, 3, 5), (8, 3, 1)):
        cmap = rng.integers(0, 65536, 3 << bits) if ph == 3 else None
        out[f"FillOrder 2, photometric {ph} {bits}-bit compression {comp}"] = tiff(
            rng.integers(0, 1 << bits, (H, W)), bits, ph, ">", compression=comp, fillorder=2,
            rows_per_strip=8, colormap=cmap)
    out["FillOrder 2, RGB compression 1"] = tiff(rgb, 8, 2, fillorder=2)
    return out


def _pil_written(rng):
    """Files PIL writes itself (through libtiff for the compressed ones)."""
    y, x = np.mgrid[0:H, 0:W]
    img = np.stack([x * 6, y * 13, (x + y) * 4, 255 - x * 3], -1).astype(np.uint8)
    out = {}
    for comp in ("raw", "tiff_lzw", "tiff_adobe_deflate", "packbits"):
        out[f"RGBA {comp} written by PIL"] = pil_bytes(Image.fromarray(img), format="TIFF",
                                                       compression=comp)
    out["grey written by PIL"] = pil_bytes(Image.fromarray(img[..., 0]), format="TIFF",
                                           compression="tiff_lzw")
    out["1-bit written by PIL"] = pil_bytes(Image.fromarray(img[..., 0] > 100), format="TIFF")
    out["palette written by PIL"] = pil_bytes(Image.fromarray(img[..., :3]).quantize(40),
                                              format="TIFF", compression="tiff_lzw")
    out["CMYK written by PIL"] = pil_bytes(Image.fromarray(img, "CMYK"), format="TIFF")
    return out


def _cases():
    rng = np.random.default_rng(2027)
    return {**_kinds(rng), **_layouts(rng), **_pil_written(rng)}


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_tiff_equals_tracy_tpu(tmp_path, monkeypatch, name):
    path = write(tmp_path, "map.tif", CASES[name])
    ref = jax_load(path)
    got = port_load(path, monkeypatch)
    assert ref is not None and got is not None
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_first_bytes_name_the_new_formats():
    """TIFF, DDS and QOI are told apart by their first bytes, before the
    TGA header check (TGA has no magic)."""
    for data, fmt in ((b"II*\0", "tiff"), (b"MM\0*", "tiff"), (b"II+\0", "tiff"),
                      (b"MM\0+", "tiff"), (b"DDS |", "dds"), (b"qoif", "qoi")):
        assert image_io.image_format(data + bytes(40)) == fmt


# --- hazards: the port follows the format where PIL loses the picture


def _pil_differs(path, want):
    ref = jax_load(path)
    assert ref is None or ref.shape != want.shape or not np.array_equal(ref, want)


@pytest.mark.parametrize("order", "<>")
@pytest.mark.parametrize("photometric", [1, 0])
def test_tiff_16_bit_grey_keeps_the_high_byte(tmp_path, monkeypatch, order, photometric):
    """PIL opens 16-bit grey as I;16 and clips it to white (it has no mode
    for big-endian WhiteIsZero); the port keeps the high byte, inverted for
    WhiteIsZero, as it does for 16-bit PNG and PNM."""
    v = np.random.default_rng(5).integers(0, 65536, (H, W))
    v[0, :4] = (300, 1000, 65535, 255)
    path = write(tmp_path, "a.tif", tiff(v, 16, photometric, order, compression=5, predictor=2,
                                         rows_per_strip=8))
    hi = (v >> 8) if photometric == 1 else 255 - (v >> 8)
    want = rgba_of(np.repeat(hi[..., None], 3, -1))
    np.testing.assert_array_equal(port_load(path, monkeypatch), want)
    _pil_differs(path, want)


def _hazards(rng):
    """(file, the picture its samples make) where PIL fails or garbles."""
    out = {}
    rgb = rng.integers(0, 256, (H, W, 3))
    out["big-endian BigTIFF"] = (tiff(rgb, 8, 2, ">", big=True, compression=5, rows_per_strip=4),
                                 rgba_of(rgb))
    for bits in (1, 2, 4):
        n = 1 << bits
        v, cmap = rng.integers(0, n, (H, W)), rng.integers(0, 65536, 3 * n)
        pal = (cmap >> 8).reshape(3, n).T
        out[f"FillOrder 2 uncompressed {bits}-bit palette"] = (
            tiff(v, bits, 3, fillorder=2, colormap=cmap), rgba_of(pal[v]))
    v = rng.integers(0, 256, (H, W))
    out["FillOrder 2 uncompressed 8-bit WhiteIsZero"] = (
        tiff(v, 8, 0, fillorder=2), rgba_of(np.repeat(255 - v[..., None], 3, -1)))
    rgb16 = rng.integers(0, 65536, (H, W, 3))
    out["planar 16-bit RGB uncompressed"] = (tiff(rgb16, 16, 2, planar=2), rgba_of(rgb16 >> 8))
    la = rng.integers(0, 256, (H, W, 2))
    out["planar grey + alpha"] = (tiff(la, 8, 1, compression=5, planar=2, extra=(2,)),
                                  rgba_of(np.repeat(la[..., :1], 3, -1), la[..., 1]))
    cmap = rng.integers(0, 65536, 768)
    out["planar palette + alpha"] = (
        tiff(la, 8, 3, compression=5, planar=2, extra=(2,), colormap=cmap),
        rgba_of((cmap >> 8).reshape(3, 256).T[la[..., 0]], la[..., 1]))
    rgbx = rng.integers(0, 256, (H, W, 4))
    out["planar RGB + unused sample"] = (tiff(rgbx, 8, 2, compression=8, planar=2, extra=(0,)),
                                         rgba_of(rgbx[..., :3]))
    out["planar RGBA without ExtraSamples, LZW"] = (tiff(rgbx, 8, 2, compression=5, planar=2),
                                                    rgba_of(rgbx[..., :3], rgbx[..., 3]))
    return out


HAZARDS = _hazards(np.random.default_rng(6))


@pytest.mark.parametrize("name", sorted(HAZARDS))
def test_tiff_read_as_the_format_where_pil_loses_it(tmp_path, monkeypatch, name):
    data, want = HAZARDS[name]
    path = write(tmp_path, "a.tif", data)
    np.testing.assert_array_equal(port_load(path, monkeypatch), want)
    _pil_differs(path, want)


# --- refusals, truncation, the library, speed

GREY = np.zeros((4, 6), np.uint8)
REFUSED = {
    "old-style JPEG": (tiff(GREY, compression=6), "old-style JPEG"),
    "SGILog": (tiff(GREY, compression=34676), "SGILog"),
    "WebP": (tiff(GREY, compression=50001), "WebP"),
    "floating-point predictor": (tiff(GREY, compression=5, predictor=3), "floating-point predictor"),
    "no mode in PIL": (tiff(np.zeros((4, 6, 2)), 8, 0, extra=(2,)), "photometric 0"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_tiff_falls_back_by_name(tmp_path, monkeypatch, name):
    data, what = REFUSED[name]
    with pytest.raises(ValueError, match=what):
        image_io.decode_image_rgba(data)
    path = write(tmp_path, "a.tif", data)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None  # grey in tracy_tpu too


TRUNCATED = {"LZW + predictor strips": dict(compression=5, predictor=2, rows_per_strip=5),
             "deflate planar tiles": dict(compression=8, tile=(16, 16), planar=2),
             "PackBits strips": dict(compression=32773, rows_per_strip=5),
             "uncompressed strips": dict(compression=1, rows_per_strip=5)}


@pytest.mark.parametrize("name", sorted(TRUNCATED))
def test_truncated_tiff_falls_back_in_both_packages(tmp_path, monkeypatch, name):
    rgb = np.random.default_rng(7).integers(0, 256, (H, W, 3))
    data = tiff(rgb, 8, 2, ">", ifd_first=True, **TRUNCATED[name])
    cut = data[:len(data) * 2 // 3]
    path = write(tmp_path, "a.tif", cut)
    assert np.array_equal(image_io.decode_image_rgba(data)[..., :3], rgb)
    with pytest.raises(ValueError, match="truncated|ends early"):
        image_io.decode_image_rgba(cut)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


def test_missing_compiler_raises_instead_of_grey(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_image_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    path = write(tmp_path, "a.tif", CASES[sorted(CASES)[0]])
    with pytest.raises(native.ImageDecoderUnavailable, match="no-such-compiler"):
        port_load(path, monkeypatch)


def test_2048_lzw_tiff_decodes_in_under_a_second():
    y, x = np.mgrid[0:2048, 0:2048]
    img = np.stack([(x // 7) % 256, (y // 5) % 256, ((x + y) // 9) % 256], -1).astype(np.uint8)
    data = pil_bytes(Image.fromarray(img), format="TIFF", compression="tiff_lzw")
    image_io.decode_image_rgba(data)  # builds the library if needed
    t0 = time.perf_counter()
    got = image_io.decode_image_rgba(data)
    secs = time.perf_counter() - t0
    np.testing.assert_array_equal(got[..., :3], img)
    assert secs < 1.0, f"{secs:.3f} s"


@pytest.mark.parametrize("name", ["RGBA tiff_lzw written by PIL", "palette 4-bit, < 5"])
def test_read_image_takes_a_tiff(tmp_path, name):
    """read_image (optimize_cli -target) reads a TIFF by content as
    tracy_tpu's optimize_cli does: PIL's convert("RGB") / 255."""
    name = next(k for k in CASES if k.startswith(name))
    path = write(tmp_path, "target.tiff", CASES[name])
    with Image.open(io.BytesIO(CASES[name])) as im:
        shown = np.asarray(im.convert("RGB"), np.float32) / 255.0
    got, linear = image_io.read_image(path)
    assert not linear
    np.testing.assert_array_equal(got, shown)
