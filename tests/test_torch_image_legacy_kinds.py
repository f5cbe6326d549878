"""The rest of the small PIL formats decoded without PIL
(csrc/image_legacy.cpp) against PIL's open(...).convert("RGBA"): IPTC/NAA
(its embedded raw stream, or a stream of any format PIL opens, through the
port's decoders, placed in its band where PIL's mode of it allows, the
rest refused in both packages but for PIL's raw first band, a hazard),
Kodak Photo CD (the PhotoYCC tables held
over a seeded sample of every (Y, C1, C2) kind, each orientation) and
FLI/FLC (each chunk kind of a first frame). Then how the formats are told
apart: PIL's plugin order (a TGA still reads as TGA; a file that one
plugin's _open gives up on goes to the next), files without a suffix, and
.hdr and .exr decided by name before content, as tracy_tpu decides them.
"""

import io
import os
import re
import struct

import numpy as np
import pytest
from PIL import Image

from test_torch_image_containers import dib, ftex, icon_dir, icon_entry
from test_torch_image_dds import dds
from test_torch_image_decode import REPO, pil_bytes, port_load, smooth, write
from test_torch_image_formats import gif, psd
from test_torch_image_legacy import CASES as LEGACY_CASES
from test_torch_image_legacy import (FORMATS, dcx, fits, gbr, hex_colours, imt, mcidas, pcx,
                                     pil_rgba, pixar, rand, runs, sgi, sun, xpm, xvthumb)
from tracy_tpu.scene.textures import load_image_rgba as jax_load
from tracy_tpu_torch.utils import image_io


# --- writers

def iptc_field(rec, ds, data: bytes) -> bytes:
    return struct.pack(">BBBH", 0x1C, rec, ds, len(data)) + data


def iptc(w, h, stream: bytes, layers=1, component=0, band=None, compression=1, piece=4000):
    """An IPTC/NAA file: the image record's fields, then the picture's
    stream in (8, 10) fields of at most `piece` bytes."""
    fields = [iptc_field(2, 0, b"\0\2"), iptc_field(3, 60, bytes([layers, component]))]
    if band is not None:
        fields.append(iptc_field(3, 65, bytes([band])))
    fields += [iptc_field(3, 20, struct.pack(">H", w)), iptc_field(3, 30, struct.pack(">H", h)),
               iptc_field(3, 120, bytes([compression]))]
    fields += [iptc_field(8, 10, stream[i:i + piece]) for i in range(0, len(stream), piece)]
    return b"".join(fields)


def pcd(y, c1, c2, orientation=0):
    """A Photo CD file of luma y [512, 768] and chroma c1, c2 [256, 384]
    (one sample for each 2x2 pixels): the base image at 96 x 2048, each pair
    of rows as Y, Y, C1, C2."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    rows = np.concatenate([y.reshape(256, 2 * 768), c1, c2], axis=1)
    return bytes(head) + rows.astype(np.uint8).tobytes()


def pcd_sample(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (512, 768)), *rng.integers(0, 256, (2, 256, 384)))


def fli_chunk(kind, body: bytes) -> bytes:
    return struct.pack("<IH", 6 + len(body), kind) + body


def fli(w, h, chunks, magic=0xAF12):
    """An FLI/FLC file of one frame of `chunks` (fli_chunk bytes)."""
    frame = b"".join(chunks)
    frame = struct.pack("<IHH8x", 16 + len(frame), 0xF1FA, len(chunks)) + frame
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 128 + len(frame), magic, 1, w, h, 8, 3, 5)
    return bytes(head) + frame


def colour_chunk(rgb, kind=4, skip=0):
    """COLOR_256 (4) or COLOR_64 (11): one packet of len(rgb) entries
    after `skip` (256 written as 0)."""
    n = len(rgb)
    return fli_chunk(kind, struct.pack("<HBB", 1, skip, n % 256) + np.asarray(rgb, np.uint8).tobytes())


def brun(img):
    """BRUN: each line as byte runs (count, value) and literals (-count,
    bytes), a packet count byte first."""
    out = bytearray()
    for row in img:
        packets, i, w = bytearray(), 0, len(row)
        n = 0
        while i < w:
            j = i
            while j < w and row[j] == row[i] and j - i < 127:
                j += 1
            if j - i >= 3:
                packets += bytes([j - i, row[i]])
                i = j
            else:
                k = min(w - i, 3)
                packets += bytes([256 - k]) + row[i:i + k].tobytes()
                i += k
            n += 1
        out += bytes([n % 256]) + packets
    return fli_chunk(15, bytes(out))


def lc(img, first=0):
    """LC (byte deltas) of rows `first`.. of img over a black frame: per line
    a packet count, then (skip, count, bytes) or (skip, -count, value)."""
    out = bytearray(struct.pack("<HH", first, len(img) - first))
    for row in img[first:]:
        packets, x, w, n = bytearray(), 0, len(row), 0
        while x < w:
            skip = 0
            while x < w and row[x] == 0 and skip < 255:
                x += 1
                skip += 1
            if x >= w:
                break
            j = x
            while j < w and row[j] == row[x] and j - x < 127:
                j += 1
            if j - x >= 3:
                packets += bytes([skip, 256 - (j - x), row[x]])
                x = j
            else:
                k = min(w - x, 4)
                packets += bytes([skip, k]) + row[x:x + k].tobytes()
                x += k
            n += 1
        out += bytes([n]) + packets
    return fli_chunk(12, bytes(out))


def ss2(img, skip_first=1):
    """SS2 (word deltas) of img (even width) over a black frame: the first
    `skip_first` lines skipped with a 0xC000 word, then each line's packets
    (0, count, words) or (0, -count, word)."""
    h, w = img.shape
    lines = bytearray()
    for y in range(skip_first, h):
        words = img[y].reshape(-1, 2)
        packets, i, n = bytearray(), 0, 0
        while i < len(words):
            j = i
            while j < len(words) and (words[j] == words[i]).all() and j - i < 127:
                j += 1
            if j - i >= 2:
                packets += bytes([0, 256 - (j - i)]) + words[i].tobytes()
                i = j
            else:
                k = min(len(words) - i, 3)
                packets += bytes([0, k]) + words[i:i + k].tobytes()
                i += k
            n += 1
        prefix = struct.pack("<H", 65536 - skip_first) if y == skip_first and skip_first else b""
        lines += prefix + struct.pack("<H", n) + packets
    return fli_chunk(7, struct.pack("<H", h - skip_first) + bytes(lines))


# --- the corpus

def _iptc_streams():
    """(name, stream, (layers, component, band)) of IPTC's embedded PNG, BMP,
    TIFF, GIF and WebP streams, each as the picture or in a band where PIL
    takes it: a grey image (PIL's mode L), or mode 1 in the first band."""
    rgb, rgba = smooth(13, 19, 3, 66), smooth(13, 19, 4, 67)
    grey = rgb[..., 0]
    pal = Image.fromarray(rgb).convert("P")
    small = runs(68, 13, 19, high=4)
    whole, g2, c4, one = (1, 0, None), (3, 1, 2), (4, 1, 4), (3, 1, 1)
    return [
        ("PNG RGBA", pil_bytes(Image.fromarray(rgba), format="PNG"), whole),
        ("PNG palette with tRNS", pil_bytes(pal, format="PNG", transparency=3), whole),
        ("PNG 1-bit", pil_bytes(Image.fromarray(grey).convert("1"), format="PNG"), whole),
        ("PNG grey, band 2 of RGB", pil_bytes(Image.fromarray(grey), format="PNG"), g2),
        ("PNG 4-bit grey, band 4 of CMYK", pil_bytes(Image.fromarray(grey // 16 * 17), format="PNG",
                                                     bits=4), c4),
        ("PNG 1-bit, band 1 of RGB", pil_bytes(Image.fromarray(grey).convert("1"), format="PNG"),
         one),
        ("BMP RGB", pil_bytes(Image.fromarray(rgb), format="BMP"), whole),
        ("BMP palette", pil_bytes(pal, format="BMP"), whole),
        ("BMP grey ramp, band 2 of RGB", pil_bytes(Image.fromarray(grey), format="BMP"), g2),
        ("BMP 1-bit, band 1 of RGB", pil_bytes(Image.fromarray(grey).convert("1"), format="BMP"),
         one),
        ("TIFF RGBA", pil_bytes(Image.fromarray(rgba), format="TIFF"), whole),
        ("TIFF palette, LZW", pil_bytes(pal, format="TIFF", compression="tiff_lzw"), whole),
        ("TIFF 32-bit grey", pil_bytes(Image.fromarray(grey.astype(np.int32) * 3 - 90),
                                       format="TIFF"), whole),
        ("TIFF grey, band 4 of CMYK", pil_bytes(Image.fromarray(grey), format="TIFF"), c4),
        ("GIF palette", pil_bytes(pal, format="GIF"), whole),
        ("GIF transparency", pil_bytes(pal, format="GIF", transparency=2), whole),
        ("GIF without a colour table, band 2 of RGB", gif((19, 13), [dict(idx=small, min_bits=2)]),
         g2),
        ("GIF without a colour table, extensions first, band 4 of CMYK",
         gif((19, 13), [dict(idx=small, min_bits=2)],
             prefix=b"!\xfe\x05hello\x00!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"), c4),
        ("WebP lossless RGBA", pil_bytes(Image.fromarray(rgba), format="WEBP", lossless=True),
         whole),
        ("WebP lossy", pil_bytes(Image.fromarray(rgb), format="WEBP", quality=80), whole),
    ] + _iptc_other_streams()


def _iptc_other_streams():
    """(name, stream, (layers, component, band)) of one stream of each
    other format family PIL opens there: as the picture, and grey (PIL's
    mode L, or 1 in the first band) in a band, a field of 0 (the last band)
    among them."""
    rgb, rgba = smooth(13, 19, 3, 80), smooth(13, 19, 4, 81)
    grey = rgb[..., 1]
    pal = Image.fromarray(rgb).quantize(40)
    idx, colours = np.asarray(pal), np.asarray(pal.getpalette()[:120], np.uint8).reshape(-1, 3)
    whole, g2, c4, one, last = (1, 0, None), (3, 1, 2), (4, 1, 4), (3, 1, 1), (3, 1, 0)

    def pil(img, fmt, **kw):
        return pil_bytes(img if isinstance(img, Image.Image) else Image.fromarray(img), format=fmt,
                         **kw)

    return [
        ("TGA RGB", pil(rgb, "TGA"), whole),
        ("TGA grey, band 3 of RGB", pil(grey, "TGA"), (3, 1, 3)),
        ("PSD RGB", psd(rgb.transpose(2, 0, 1), 3), whole),
        ("PSD grey, band field 0 of CMYK", psd(grey[None], 1), (4, 1, 0)),
        ("QOI RGBA", pil(rgba, "QOI"), whole),
        ("DDS RGBA", pil(rgba, "DDS"), whole),
        ("DDS grey, band 2 of RGB", pil(grey, "DDS"), g2),
        ("JPEG 2000 codestream RGB", pil(rgb, "JPEG2000", no_jp2=True), whole),
        ("JP2 grey, band 4 of CMYK", pil(grey, "JPEG2000"), c4),
        ("AVIF", pil(rgb, "AVIF", quality=90), whole),
        ("DIB palette", dib(19, 13, 8, idx, colours, colours=len(colours)), whole),
        ("DIB grey, band field 0 of RGB", pil(grey, "DIB"), last),
        ("ICO 24-bit", icon_dir(1, [icon_entry(19, 13, 24, 82)]), whole),
        ("CUR 8-bit", icon_dir(2, [icon_entry(19, 13, 8, 83)]), whole),
        ("BLP palette", pil(pal, "BLP"), whole),
        ("FTEX", ftex(19, 13, 1, rgb.tobytes()), whole),
        ("PCX RGB", pil(rgb, "PCX"), whole),
        ("PCX grey, band 1 of RGB", pil(grey, "PCX"), one),
        ("DCX", dcx([pil(rgb, "PCX")]), whole),
        ("SGI RGB", pil(rgb, "SGI"), whole),
        ("SGI 16-bit grey, band field 0 of RGB", sgi(grey[..., None].astype(np.uint16) * 257 + 3,
                                                    bpc=2), last),
        ("SUN palette", sun(19, 13, 8, idx, palette=colours), whole),
        ("SUN grey, band 4 of CMYK", sun(19, 13, 8, grey), c4),
        ("MSP", pil(Image.fromarray(grey).convert("1"), "MSP"), whole),
        ("MSP, band 1 of CMYK", pil(Image.fromarray(grey).convert("1"), "MSP"), (4, 1, 1)),
        ("IM RGB", pil(rgb, "IM"), whole),
        ("IM grey, band 2 of RGB", pil(grey, "IM"), g2),
        ("XBM", pil(Image.fromarray(grey).convert("1"), "XBM"), whole),
        ("XPM", xpm(idx, hex_colours(colours)), whole),
        ("PIXAR", pixar(rgb), whole),
        ("FITS 8-bit", fits(grey, 8), whole),
        ("FITS 8-bit, band 2 of RGB", fits(grey, 8), g2),
        ("GBR RGBA", gbr(rgba), whole),
        ("GBR grey, band field 0 of CMYK", gbr(grey), (4, 1, 0)),
        ("McIdas 4-byte", mcidas(grey.astype(np.int64) * 2 - 60, 4), whole),
        ("McIdas 1-byte, band 3 of RGB", mcidas(grey, 1), (3, 1, 3)),
        ("XV thumbnail", xvthumb(idx), whole),
        ("IMT, band 2 of RGB", imt(grey), g2),
        ("FLI", fli(19, 13, [colour_chunk(colours), brun(idx)]), whole),
        ("IPTC in IPTC, PNG RGB", iptc(19, 13, pil(rgb, "PNG"), compression=5), whole),
        ("IPTC in IPTC, raw grey, band 4 of CMYK", iptc(19, 13, grey.tobytes()), c4),
    ]


def _cases():
    c = {}
    grey = smooth(13, 19, 1, 60)[..., 0]
    raw = grey.tobytes()
    c["IPTC L raw"] = iptc(19, 13, raw)
    c["IPTC L raw in small fields"] = iptc(19, 13, raw, piece=50)
    head = iptc(19, 13, b"")
    # An extended length: byte 3 is 0x80 + n, and n bytes of length follow
    # the 5-byte field header (PIL ignores byte 4).
    c["IPTC L raw, extended field length"] = (head + struct.pack(">BBBBB", 0x1C, 8, 10, 0x82, 0x7F)
                                              + struct.pack(">H", len(raw)) + raw)
    for layers, band in ((3, 1), (3, 2), (3, 3), (4, 1), (4, 3), (4, 4)):
        kind = "RGB" if layers == 3 else "CMYK"
        c[f"IPTC {kind} band {band} raw"] = iptc(19, 13, raw, layers, 1, band)
    c["IPTC RGB without a band"] = iptc(19, 13, raw, 3, 1)
    jpg = pil_bytes(Image.fromarray(grey), format="JPEG", quality=90)
    c["IPTC L JPEG"] = iptc(19, 13, jpg, compression=5)
    c["IPTC RGB band 2 JPEG"] = iptc(19, 13, jpg, 3, 1, 2, compression=5)
    c["IPTC L colour JPEG"] = iptc(19, 13, pil_bytes(Image.fromarray(smooth(13, 19, 3, 61)),
                                                     format="JPEG"), compression=5)
    for name, stream, bands in _iptc_streams():
        c[f"IPTC {name}"] = iptc(19, 13, stream, *bands, compression=5)
    pal = rand(62, 256, 3)
    img = runs(63, 12, 26)
    c["FLI COLOR_256 + BRUN"] = fli(26, 12, [colour_chunk(pal[:200], skip=7), brun(img)])
    c["FLC COLOR_256 of 256 + BRUN"] = fli(26, 12, [colour_chunk(pal), brun(img)])
    c["FLI COLOR_64 + COPY"] = fli(26, 12, [colour_chunk(pal // 4, kind=11), fli_chunk(16, img.tobytes())],
                                   magic=0xAF11)
    c["FLI BRUN, grey palette"] = fli(26, 12, [brun(img)])
    c["FLI BLACK + LC"] = fli(26, 12, [colour_chunk(pal), fli_chunk(13, b""), lc(img * (img > 90), 2)])
    c["FLI SS2"] = fli(26, 12, [colour_chunk(pal), ss2(runs(64, 12, 26, high=3) * 70)])
    c["FLI SS2, odd width"] = fli(27, 5, [colour_chunk(pal), fli_chunk(7, struct.pack(
        "<HHH", 1, 0x8000 | 0x5A, 1) + bytes([0, 2, 1, 2, 3, 4]))])
    c["FLI COPY then a stamp"] = fli(26, 12, [fli_chunk(18, b"\0" * 10), colour_chunk(pal),
                                              fli_chunk(16, img.tobytes())])
    return c


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_legacy_kind_equals_pil(name):
    data = CASES[name]
    np.testing.assert_array_equal(image_io.decode_image_rgba(data), pil_rgba(data))


@pytest.mark.parametrize("orientation", [0, 1, 2, 3])
def test_pcd_equals_pil(orientation):
    """A Photo CD base image of seeded random luma and chroma: every output
    byte, clipped or not, as Pillow's YCC tables give it (the tables of
    csrc/image_legacy.cpp, recovered by tools/make_pcd_tables.py), turned
    by the orientation byte (1: 90, 3: 270 degrees)."""
    data = pcd(*pcd_sample(70 + orientation), orientation)
    assert image_io.image_format(data) == "pcd"
    np.testing.assert_array_equal(image_io.decode_image_rgba(data), pil_rgba(data))


@pytest.mark.parametrize("name", [n for n, _, _ in _iptc_streams()])
def test_iptc_stream_loads_in_both_packages(tmp_path, monkeypatch, name):
    """IPTC's embedded PNG, BMP, TIFF, GIF and WebP streams through both
    packages' load_image_rgba: the float32 arrays are equal."""
    path = write(tmp_path, "a.iim", CASES[f"IPTC {name}"])
    ref = jax_load(path)
    assert ref is not None and ref.shape == (13, 19, 4)
    np.testing.assert_array_equal(port_load(path, monkeypatch), ref)


def _raw_first_bands():
    """{case: (stream, PIL's mode as the refusal names it)} of one-band
    images other than L and 1: PNG's palette and 16-bit grey, a PCX
    palette, and an IPTC image whose picture is a palette PNG (its mode L,
    its loaded image P)."""
    grey = smooth(13, 19, 1, 69)[..., 0]
    pal = Image.fromarray(smooth(13, 19, 3, 69)).convert("P")
    png = pil_bytes(pal, format="PNG")
    return {"P": (png, "P"),
            "I;16": (pil_bytes(Image.fromarray(grey.astype(np.uint16) * 251), format="PNG"), "I;16"),
            "PCX P": (pil_bytes(pal, format="PCX"), "P"),
            "IPTC of a palette PNG": (iptc(19, 13, png, compression=5), "L (its loaded image P)")}


RAW_FIRST_BANDS = _raw_first_bands()


@pytest.mark.parametrize("mode", sorted(RAW_FIRST_BANDS))
def test_iptc_band_1_of_raw_samples_is_refused_by_name(tmp_path, monkeypatch, mode):
    """Image.merge checks every band's mode but the first's, and there
    copies the embedded image's raw samples: a palette's indices, the bytes
    of a 16-bit image's rows (and crashes the process on I and F). PIL
    loses the picture; the port refuses every mode but L and 1 there, by
    name (ROADMAP, hazards), whatever the stream's format."""
    stream, named = RAW_FIRST_BANDS[mode]
    data = iptc(19, 13, stream, 3, 1, 1, compression=5)
    with pytest.raises(ValueError, match=re.escape(f"band 1 filled by an image of PIL mode {named}")):
        image_io.decode_image_rgba(data)
    path = write(tmp_path, "a.iim", data)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is not None


def test_pcd_loads_in_both_packages(tmp_path, monkeypatch):
    path = write(tmp_path, "photo.pcd", pcd(*pcd_sample(75)))
    np.testing.assert_array_equal(port_load(path, monkeypatch), jax_load(path))


# --- refusals and truncation

REFUSED = {
    "IPTC compression 3": (iptc(4, 4, bytes(16), compression=3), "compression 3"),
    "IPTC RGB band 2 of a colour JPEG": (iptc(19, 13, pil_bytes(Image.fromarray(smooth(13, 19, 3, 65)),
                                                                format="JPEG"), 3, 1, 2, compression=5),
                                         "not grey"),
    "IPTC band 5 of RGB": (iptc(4, 4, bytes(16), 3, 1, 5), "band 5"),
    "IPTC compression 2": (iptc(4, 4, bytes(16), compression=2), "compression 2"),
    "IPTC RGB band 2 of a palette PNG": (iptc(19, 13, pil_bytes(
        Image.fromarray(smooth(13, 19, 3, 70)).convert("P"), format="PNG"), 3, 1, 2,
        compression=5), "not grey"),
    "IPTC CMYK band 3 of a WebP": (iptc(19, 13, pil_bytes(Image.fromarray(smooth(13, 19, 3, 71)),
                                                          format="WEBP"), 4, 1, 3, compression=5),
                                   "not grey"),
    "IPTC PNG cut inside its header": (iptc(4, 4, pil_bytes(Image.fromarray(rand(74, 4, 4)),
                                                           format="PNG")[:20], 3, 1, 2,
                                            compression=5), "header is truncated"),
    "IPTC 16-bit grey TIFF": (iptc(19, 13, pil_bytes(Image.fromarray(
        smooth(13, 19, 1, 72)[..., 0].astype(np.uint16) * 257), format="TIFF"), compression=5),
        "PIL mode I;16"),
    "IPTC float TIFF": (iptc(19, 13, pil_bytes(Image.fromarray(
        smooth(13, 19, 1, 73)[..., 0].astype(np.float32) * 0.5), format="TIFF"), compression=5),
        "PIL mode F"),
    "IPTC trailing garbage": (iptc(4, 4, bytes(16)) + b"\x1dxyzw", "invalid IPTC"),
    "IPTC CIELab TIFF": (iptc(19, 13, pil_bytes(Image.fromarray(smooth(13, 19, 3, 74), "LAB"),
                                                format="TIFF"), compression=5), "PIL mode LAB"),
    # PIL's ICO writer keeps no entry of a 19x13 image: PIL cannot identify it.
    "IPTC ICO of no entry": (iptc(19, 13, pil_bytes(Image.fromarray(smooth(13, 19, 3, 75)),
                                                    format="ICO"), compression=5), "no format"),
    "IPTC EPS": (iptc(19, 13, b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 19 13\n",
                      compression=5), "no format"),
    # Streams the port reads alone (ROADMAP, hazards) but PIL's plugin
    # refuses at its header: refused inside IPTC too.
    "IPTC 15-bit TGA": (iptc(4, 4, struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, 4, 4, 15,
                                               0x20) + bytes(32), compression=5), "depth 15"),
    "IPTC DDS BC1 SRGB": (iptc(4, 4, dds(4, 4, bytes(8), dxgi=72), compression=5),
                          "DXGI format 72"),
    "FLI unknown chunk": (fli(8, 4, [fli_chunk(99, bytes(8))]), "chunk type 99"),
    "FLI BRUN short of a line": (fli(8, 2, [fli_chunk(15, b"\1\4\7" + b"\1\4\7")]), "overruns"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_kind_falls_back_in_both_packages(tmp_path, monkeypatch, name):
    data, what = REFUSED[name]
    with pytest.raises(ValueError, match=what):
        image_io.decode_image_rgba(data)
    path = write(tmp_path, "a." + name.split()[0].lower(), data)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusal_names_its_format_once(name):
    """The message starts with the format's name once: the C source names
    it and nothing names it again ("IPTC: IPTC: ..." before)."""
    fmt = name.split()[0]
    with pytest.raises(ValueError) as e:
        image_io.decode_image_rgba(REFUSED[name][0])
    assert str(e.value).startswith(f"{fmt}: ")
    assert not str(e.value).startswith(f"{fmt}: {fmt}: ")


@pytest.mark.parametrize("name", ["IPTC L raw", "IPTC L JPEG", "FLI COLOR_256 + BRUN", "FLI SS2",
                                  "PCD"])
def test_truncated_file_falls_back_in_both_packages(tmp_path, monkeypatch, name):
    data = pcd(*pcd_sample(76)) if name == "PCD" else CASES[name]
    cut = data[:len(data) * 4 // 5]
    with pytest.raises(ValueError, match="truncated|ends early|overrun|not enough"):
        image_io.decode_image_rgba(cut)
    path = write(tmp_path, "a." + name.split()[0].lower(), cut)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


# --- telling the formats apart

KINDS = {"IPTC": "iptc", "FLI": "fli", "FLC": "fli"}


def test_formats_are_told_apart_as_pil_tells_them():
    """image_format names each file's format as PIL's Image.open does."""
    for name, data in LEGACY_CASES.items():
        fmt = FORMATS[name.split()[0]]
        assert image_io.image_format(data) == fmt, name
        assert Image.open(io.BytesIO(data)).format.lower() == fmt, name
    for name, data in CASES.items():
        assert image_io.image_format(data) == KINDS[name.split()[0]], name


def tga(id_len=0, w=5, h=3):
    """A 24-bit true-colour TGA of random pixels with an ID field of
    `id_len` bytes."""
    head = struct.pack("<BBBHHBHHHHBB", id_len, 0, 2, 0, 0, 0, 0, 0, w, h, 24, 0x20)
    return head + bytes(range(65, 65 + id_len)) + rand(77, h, w, 3).tobytes()


def test_tga_still_reads_as_tga_after_every_plugin(tmp_path, monkeypatch):
    """TGA has no magic: PIL tries it after every plugin above, IM, IMT,
    IPTC, PCD and SPIDER among them, and so does the port."""
    data = tga()
    assert image_io.image_format(data) == "tga"
    path = write(tmp_path, "texture", data)
    np.testing.assert_array_equal(port_load(path, monkeypatch), jax_load(path))


def test_a_tga_with_a_10_byte_id_is_a_pcx_to_pil(tmp_path, monkeypatch):
    """Byte 0 of 10 and byte 1 of 0 pass PCX's _accept, and its header
    checks: PIL opens such a TGA as a PCX of an unknown mode and fails, and
    so does the port, in the same order."""
    data = tga(id_len=10, w=300, h=200)
    assert image_io.image_format(data) == "pcx"
    with pytest.raises(ValueError, match="unknown PCX mode"):
        image_io.decode_image_rgba(data)
    path = write(tmp_path, "a.tga", data)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


def test_a_header_that_a_plugin_gives_up_on_goes_to_the_next():
    """A PCX whose size is empty fails PcxImageFile._open with the error
    Image.open takes for "not this format": the file is then not a PCX to
    either package (here nothing else takes it)."""
    data = bytearray(LEGACY_CASES["PCX L 37x23 (PIL)"])
    data[4:6] = struct.pack("<H", 100)  # xmin beyond xmax
    assert image_io.image_format(bytes(data)) is None
    with pytest.raises(Exception):
        Image.open(io.BytesIO(bytes(data)))


@pytest.mark.parametrize("name", ["IPTC RGB band 2 raw", "FLI COLOR_256 + BRUN"])
def test_file_without_a_suffix_loads_in_both_packages(tmp_path, monkeypatch, name):
    path = write(tmp_path, "texture", CASES[name])
    ref = jax_load(path)
    assert ref is not None
    np.testing.assert_array_equal(port_load(path, monkeypatch), ref)


# --- .hdr and .exr by name, as tracy_tpu decides them

def test_png_named_hdr_falls_back_in_both_packages(tmp_path, monkeypatch):
    """tracy_tpu reads any .hdr file as Radiance: a PNG of that name is not
    one, and both packages return None (the port used to decode it)."""
    path = write(tmp_path, "x.hdr", pil_bytes(Image.fromarray(smooth(4, 5, 3, 78)), format="PNG"))
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


def test_radiance_sky_still_loads_by_name(monkeypatch):
    path = os.path.join(REPO, "tests", "goldens", "data", "sky.hdr")
    ref = jax_load(path)
    assert ref is not None and ref.shape[-1] == 4
    np.testing.assert_array_equal(port_load(path, monkeypatch), ref)


KIND_FIXTURES = os.path.join(REPO, "tests", "goldens", "kinds")


@pytest.mark.parametrize("name", sorted(np.load(os.path.join(KIND_FIXTURES, "expected.npz")).files))
def test_kind_fixture_equals_its_recorded_rgba(tmp_path, monkeypatch, name):
    """tests/goldens/kinds (tools/make_kind_fixtures.py), which chip_smoke.py
    decodes on the card's host: each file decodes to its recorded RGBA, and
    loads as tracy_tpu loads it but for the palettes (black in tracy_tpu)."""
    want = np.load(os.path.join(KIND_FIXTURES, "expected.npz"))[name]
    path = os.path.join(KIND_FIXTURES, name)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(image_io.decode_image_rgba(f.read()), want)
    ref = jax_load(path)
    if name.startswith("pclr"):
        assert (ref[..., :3] == 0).all()
    else:
        np.testing.assert_array_equal(port_load(path, monkeypatch), ref)
