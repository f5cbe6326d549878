"""The icon and game-texture containers (DIB, ICO, CUR, FTEX, BLP, ICNS)
decoded without PIL (csrc/image_containers.cpp, their PNG, JPEG and JPEG
2000 entries through those decoders) against PIL's
open(...).convert("RGBA"), which tracy_tpu's texture loader runs.

Each file is made from a seeded numpy array, written by PIL where PIL
writes the kind (ICO with PNG and BMP entries, DIB, BLP palettes, ICNS
with PNG entries), else packed with struct by the writers below (CUR,
FTEX, BLP1 JPEG, BLP2 DXT, ICNS RLE, and the bit depths and headers PIL's
writers never produce). Contracts:

* Equal to PIL bit for bit (uint8 RGBA) for every kind PIL reads as the
  format means it: ICO entries at 1, 4, 8, 24 and 32 bits with their AND
  masks or alpha bytes, and PNG entries, picked as IcoFile picks; CUR's
  entry rule and its alpha at byte 22; DIB with 12-, 40- and 124-byte
  headers; FTEX BC1 and raw RGB; BLP1 JPEG (RGB, CMYK and YCCK streams)
  and palette kinds; BLP2 palette at alpha depths 0, 1, 4 and 8 and DXT1,
  DXT3 and DXT5; ICNS RLE, raw, PNG and JPEG 2000 entries and PIL's best
  size. A few
  cases also through tracy_tpu's load_image_rgba: the float arrays equal.
* Where PIL's rows go astray (ROADMAP, hazards) the port reads the format:
  BLP2 DXT at a width that is not a multiple of 4, and DXT3/DXT5 with an
  alpha depth of 0; each case is held against the picture the format
  defines and shown to differ from PIL's.
* Refused kinds raise ValueError naming them and fall back (None) in both
  packages; truncated files fall back in both packages.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from test_torch_image_decode import pil_bytes, port_load, smooth, write
from tracy_tpu.scene.textures import load_image_rgba as jax_load
from tracy_tpu_torch.utils import image_io


def pil_rgba(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def rand(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


# --- writers for what PIL does not write

def dib(w, h, bits, pixels, palette=None, hsize=40, top_down=False, colours=0):
    """A DIB (a BMP's info header, palette and rows, no file header):
    `pixels` uint8 rows of indices [h, w] (bits <= 8), BGR [h, w, 3] (24)
    or BGRA [h, w, 4] (32), top row first; `palette` RGB [n, 3]."""
    if hsize == 12:
        head = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        head = struct.pack("<IiiHHIIiiII", hsize, w, -h if top_down else h, 1, bits, 0, 0,
                           2835, 2835, colours, 0).ljust(hsize, b"\0")
    pal = b""
    if palette is not None:
        entry = 3 if hsize == 12 else 4
        pal = b"".join(bytes([b, g, r, 0][:entry]) for r, g, b in palette)
    stride = (w * bits + 31) // 32 * 4
    rows = []
    for row in pixels:
        if bits <= 8:
            vals = np.zeros(stride * 8 // bits, np.uint8)
            vals[:w] = row
            packed = np.packbits(np.unpackbits(vals[:, None], axis=1)[:, 8 - bits:].reshape(-1))
            rows.append(packed.tobytes()[:stride])
        else:
            rows.append(np.ascontiguousarray(row).tobytes().ljust(stride, b"\0"))
    return head + pal + b"".join(rows if top_down else rows[::-1])


def and_mask(mask):
    """The 1-bit AND mask of bool [h, w] (True: transparent), rows padded to
    32 bits, bottom-up."""
    h, w = mask.shape
    stride = (w + 31) // 32 * 4
    rows = [np.packbits(r).tobytes().ljust(stride, b"\0") for r in mask]
    return b"".join(rows[::-1])


def icon_bmp(pix, bits, palette=None, mask=None):
    """(directory fields, payload) of a BMP icon entry of `pix` (as dib()
    takes them): a DIB of twice the height, then the AND mask of `mask`
    (bool [h, w], True transparent) unless it is None."""
    h, w = pix.shape[:2]
    body = dib(w, h, bits, pix, palette)
    body = body[:8] + struct.pack("<i", 2 * h) + body[12:]
    if mask is not None:
        body += and_mask(mask)
    return (w % 256, h % 256, (1 << bits) % 256 if bits <= 8 else 0, bits), body


def icon_entry(w, h, bits, seed, mask=True):
    """A BMP icon entry of random pixels (and a random AND mask)."""
    rng = np.random.default_rng(seed)
    if bits <= 8:
        pal = rng.integers(0, 256, (1 << bits, 3))
        pix = rng.integers(0, 1 << bits, (h, w)).astype(np.uint8)
    else:
        pal, pix = None, rng.integers(0, 256, (h, w, bits // 8)).astype(np.uint8)
    return icon_bmp(pix, bits, pal, rng.random((h, w)) < 0.3 if mask else None)


def icon_dir(magic, entries, hotspot=(0, 0)):
    """An ICO (magic 1) or CUR (magic 2) of [(fields, payload)]; a CUR
    entry's planes and bit count are its hotspot."""
    head = struct.pack("<HHH", 0, magic, len(entries))
    at = 6 + 16 * len(entries)
    dirs, bodies = b"", b""
    for (w, h, colours, bits), body in entries:
        p, b = hotspot if magic == 2 else (1, bits)
        dirs += struct.pack("<BBBBHHII", w, h, colours, 0, p, b, len(body), at + len(bodies))
        bodies += body
    return head + dirs + bodies


def ftex(w, h, fmt, data, formats=1):
    return (b"FTEX" + struct.pack("<iiiiiii", 1, w, h, 1, formats, fmt, 32)
            + struct.pack("<i", len(data)) + data)


def blp1(w, h, compression, alpha, encoding, body, offset0, length0):
    return (b"BLP1" + struct.pack("<iIIIii", compression, alpha, w, h, encoding, 0)
            + struct.pack("<16I", offset0, *[0] * 15) + struct.pack("<16I", length0, *[0] * 15)
            + body)


def blp1_jpeg(jpeg: bytes, w, h, alpha=0):
    """BLP1's JPEG kind: the JPEG cut before its first SOF into the shared
    header and mip 0."""
    cut = min(jpeg.index(m) for m in (b"\xff\xc0", b"\xff\xc2") if m in jpeg)
    head, mip = jpeg[:cut], jpeg[cut:]
    body = struct.pack("<I", len(head)) + head + b"\0" * 3
    return blp1(w, h, 0, alpha, 5, body + mip, 156 + len(body), len(mip))


def blp2(w, h, encoding, alpha_depth, alpha_encoding, mip, palette=None, compression=1):
    pal = palette if palette is not None else rand(1, 1024).tobytes()
    at = 20 + 128 + len(pal)
    return (b"BLP2" + struct.pack("<ibbbbII", compression, encoding, alpha_depth,
                                  alpha_encoding, 0, w, h)
            + struct.pack("<16I", at, *[0] * 15) + struct.pack("<16I", len(mip), *[0] * 15)
            + pal + mip)


def packbits(chan: bytes) -> bytes:
    """ICNS RLE of one channel: runs of 3-130 as (n + 125, v), the rest as
    literals of up to 128 bytes (n - 1, bytes)."""
    out, i, lit = bytearray(), 0, bytearray()

    def flush():
        while lit:
            out.append(min(len(lit), 128) - 1)
            out.extend(lit[:128])
            del lit[:128]

    while i < len(chan):
        j = i
        while j < len(chan) and chan[j] == chan[i] and j - i < 130:
            j += 1
        if j - i >= 3:
            flush()
            out.extend([j - i + 125, chan[i]])
            i = j
        else:
            lit.append(chan[i])
            i += 1
    flush()
    return bytes(out)


def icns(blocks):
    """An ICNS file of [(type, payload)]."""
    body = b"".join(t + struct.pack(">I", len(p) + 8) + p for t, p in blocks)
    return b"icns" + struct.pack(">I", len(body) + 8) + body


def icns_rgb(rgb, rle=True):
    """An is32/il32/ih32 payload: three RLE channels, or RGB raw."""
    if not rle:
        return rgb.tobytes()
    return b"".join(packbits(rgb[..., c].tobytes()) for c in range(3))


def flat_rgb(n, seed):
    """n x n RGB with runs (so that the RLE has both kinds of packets)."""
    img = np.repeat(rand(seed, n, n // 4 + 1, 3), 4, axis=1)[:, :n]
    img[::3] = rand(seed + 1, len(img[::3]), n, 3)
    return img


def dxt_blocks(n, size, seed):
    return rand(seed, n * size).tobytes()


# --- the corpus

def _pil_ico(img, **kw):
    return pil_bytes(Image.fromarray(img), format="ICO", **kw)


def _cases():
    c = {}
    rgba = smooth(64, 64, 4, 3)
    c["ICO PNG entries (PIL)"] = _pil_ico(rgba)
    for mode in ("1", "L", "P", "RGB", "RGBA"):
        im = Image.fromarray(smooth(32, 32, 3, 4)).convert(mode)
        c[f"ICO BMP entries mode {mode} (PIL)"] = pil_bytes(im, format="ICO",
                                                         bitmap_format="bmp")
    for bits in (1, 4, 8, 24, 32):
        c[f"ICO BMP {bits}-bit"] = icon_dir(1, [icon_entry(16, 16, bits, bits),
                                                icon_entry(48, 48, bits, bits + 1),
                                                icon_entry(32, 32, bits, bits + 2)])
    c["ICO 256 px entry"] = icon_dir(1, [icon_entry(256, 256, 24, 7)])
    # Equal areas: the least colour depth wins, whatever the file order.
    c["ICO equal areas"] = icon_dir(1, [icon_entry(16, 16, 32, 8), icon_entry(16, 16, 8, 9),
                                        icon_entry(8, 32, 4, 10)])
    png = pil_bytes(Image.fromarray(smooth(24, 24, 4, 5)), format="PNG")
    c["ICO PNG beside BMP"] = icon_dir(1, [icon_entry(16, 16, 24, 11),
                                           ((24, 24, 0, 32), png)])
    c["CUR 32-bit at byte 22"] = icon_dir(2, [icon_entry(32, 32, 32, 12, mask=False)], (3, 4))
    c["CUR 24-bit two entries"] = icon_dir(2, [icon_entry(16, 16, 24, 13),
                                               icon_entry(32, 32, 24, 14)])
    c["CUR 32-bit second entry"] = icon_dir(2, [icon_entry(16, 16, 8, 15),
                                                icon_entry(32, 32, 32, 16, mask=False)])
    c["CUR first entry kept"] = icon_dir(2, [icon_entry(32, 16, 8, 17),
                                             icon_entry(48, 8, 4, 18)])
    c["CUR equal sizes keep the first"] = icon_dir(2, [icon_entry(16, 16, 24, 19),
                                                       icon_entry(16, 16, 8, 20)])
    for mode in ("1", "L", "P", "RGB"):
        im = Image.fromarray(smooth(21, 19, 3, 6)).convert(mode)
        c[f"DIB 40-byte mode {mode} (PIL)"] = pil_bytes(im, format="DIB")
    rng = np.random.default_rng(19)
    c["DIB 12-byte 24-bit"] = dib(13, 7, 24, rand(20, 7, 13, 3), hsize=12)
    c["DIB 12-byte 8-bit"] = dib(13, 7, 8, rand(21, 7, 13), rng.integers(0, 256, (256, 3)),
                                 hsize=12)
    c["DIB 124-byte 24-bit"] = dib(11, 9, 24, rand(22, 9, 11, 3), hsize=124)
    c["DIB 124-byte 4-bit, 5 colours"] = dib(11, 9, 4, rand(23, 9, 11) % 5,
                                             rng.integers(0, 256, (5, 3)), hsize=124, colours=5)
    c["DIB 40-byte top-down"] = dib(9, 5, 24, rand(24, 5, 9, 3), top_down=True)
    for w, h in ((8, 8), (10, 6)):
        c[f"FTEX BC1 {w}x{h}"] = ftex(w, h, 0, dxt_blocks((w + 3) // 4 * ((h + 3) // 4), 8, w))
        c[f"FTEX raw {w}x{h}"] = ftex(w, h, 1, rand(w + h, h, w, 3).tobytes())
    for kind, mode in (("RGB", "RGB"), ("CMYK", "CMYK"), ("grey", "L")):
        arr = smooth(16, 24, {"RGB": 3, "CMYK": 4, "grey": 1}[kind], 25)
        jpg = pil_bytes(Image.fromarray(arr.squeeze(), mode), format="JPEG", quality=90)
        c[f"BLP1 JPEG {kind}"] = blp1_jpeg(jpg, 24, 16)
    cmyk = pil_bytes(Image.fromarray(smooth(16, 24, 4, 26), "CMYK"), format="JPEG")
    at = cmyk.index(b"\xff\xee") + 4 + 11
    c["BLP1 JPEG YCCK, alpha"] = blp1_jpeg(cmyk[:at] + b"\x02" + cmyk[at + 1:], 24, 16, alpha=8)
    c["BLP1 JPEG larger than its header"] = blp1_jpeg(
        pil_bytes(Image.fromarray(smooth(20, 24, 3, 27)), format="JPEG"), 16, 16)
    p_rgb = Image.fromarray(smooth(12, 10, 3, 28)).quantize(32)
    c["BLP1 palette (PIL)"] = pil_bytes(p_rgb, format="BLP", blp_version="BLP1")
    c["BLP2 palette (PIL)"] = pil_bytes(p_rgb, format="BLP")
    p_rgba = Image.fromarray(smooth(12, 10, 4, 29)).quantize(32, method=Image.Quantize.FASTOCTREE)
    c["BLP2 palette with alpha (PIL)"] = pil_bytes(p_rgba, format="BLP")
    pal = rand(30, 1024).tobytes()
    for enc in (4, 5):
        idx = rand(31 + enc, 6 * 10).tobytes()
        c[f"BLP1 encoding {enc}, alpha"] = blp1(10, 6, 1, 8, enc, pal + idx, 1180, len(idx))
    for depth, plane in ((0, 0), (1, 8), (4, 30), (8, 60)):
        idx = rand(40 + depth, 6 * 10).tobytes() + rand(50, plane).tobytes()
        c[f"BLP2 palette alpha depth {depth}"] = blp2(10, 6, 1, depth, 0, idx, pal)
    for w, h in ((8, 8), (16, 12), (8, 6)):
        n = (w // 4) * ((h + 3) // 4)
        c[f"BLP2 DXT1 {w}x{h}"] = blp2(w, h, 2, 0, 0, dxt_blocks(n, 8, 60 + w))
        c[f"BLP2 DXT1 alpha {w}x{h}"] = blp2(w, h, 2, 1, 0, dxt_blocks(n, 8, 61 + w))
        c[f"BLP2 DXT3 {w}x{h}"] = blp2(w, h, 2, 8, 1, dxt_blocks(n, 16, 62 + w))
        c[f"BLP2 DXT5 {w}x{h}"] = blp2(w, h, 2, 8, 7, dxt_blocks(n, 16, 63 + w))
    same = bytearray(dxt_blocks(4, 8, 64))
    for k in range(0, 32, 8):  # c1 = c0: DXT1's three-colour table
        same[k + 2:k + 4] = same[k:k + 2]
    c["BLP2 DXT1 equal endpoints"] = blp2(8, 8, 2, 1, 0, bytes(same))
    icon = Image.fromarray(smooth(128, 128, 4, 32))
    c["ICNS PNG entries (PIL)"] = pil_bytes(icon, format="ICNS")
    for t, m, n in ((b"is32", b"s8mk", 16), (b"il32", b"l8mk", 32), (b"ih32", b"h8mk", 48)):
        c[f"ICNS {t.decode()} RLE and mask"] = icns([(t, icns_rgb(flat_rgb(n, n))),
                                                     (m, rand(n + 1, n, n).tobytes())])
    c["ICNS il32 raw, no mask"] = icns([(b"il32", icns_rgb(rand(33, 32, 32, 3), rle=False))])
    c["ICNS it32 and t8mk beside a PNG icp5"] = icns([
        (b"icp5", pil_bytes(Image.fromarray(smooth(32, 32, 4, 34)), format="PNG")),
        (b"it32", b"\0\0\0\0" + icns_rgb(flat_rgb(128, 35))),
        (b"t8mk", rand(36, 128, 128).tobytes())])
    c["ICNS ic07 PNG beside it32"] = icns([
        (b"it32", b"\0\0\0\0" + icns_rgb(flat_rgb(128, 37))),
        (b"ic07", pil_bytes(Image.fromarray(smooth(128, 128, 3, 38)), format="PNG"))])
    return c


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_container_equals_pil(name):
    data = CASES[name]
    np.testing.assert_array_equal(image_io.decode_image_rgba(data), pil_rgba(data))


FORMATS = {"ICO": "ico", "CUR": "cur", "DIB": "dib", "FTEX": "ftex", "BLP1": "blp",
           "BLP2": "blp", "ICNS": "icns"}
SUFFIX = {"ico": ".ico", "cur": ".cur", "dib": ".dib", "ftex": ".ftc", "blp": ".blp",
          "icns": ".icns"}


@pytest.mark.parametrize("name", ["ICO BMP 4-bit", "CUR 32-bit at byte 22",
                                  "DIB 12-byte 8-bit", "FTEX BC1 10x6", "BLP1 JPEG CMYK",
                                  "BLP2 DXT5 16x12", "ICNS it32 and t8mk beside a PNG icp5"])
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
    assert Image.open(path).format.lower() == {"blp": "blp", "ftex": "ftex"}.get(fmt, fmt)


# --- where PIL's rows go astray: the format's picture (ROADMAP, hazards)

def test_blp2_dxt_width_not_a_multiple_of_4_reads_the_format():
    """PIL lays each 4-pixel-wide block row out at the header's width, so
    a 6-wide DXT1 image comes out sheared; the port crops the blocks."""
    blocks = dxt_blocks(2 * 2, 8, 70)
    wide = image_io.decode_image_rgba(blp2(8, 8, 2, 1, 0, blocks))
    np.testing.assert_array_equal(wide, pil_rgba(blp2(8, 8, 2, 1, 0, blocks)))
    got = image_io.decode_image_rgba(blp2(6, 8, 2, 1, 0, blocks))
    np.testing.assert_array_equal(got, wide[:, :6])
    assert not np.array_equal(got, pil_rgba(blp2(6, 8, 2, 1, 0, blocks)))


@pytest.mark.parametrize("alpha_encoding", [1, 7])
def test_blp2_dxt3_dxt5_without_alpha_reads_the_format(alpha_encoding):
    """DXT3/DXT5 blocks under an alpha depth of 0: PIL reads their RGBA as
    RGB and shears the picture; the port keeps the colours, alpha 255."""
    blocks = dxt_blocks(4, 16, 71)
    with_alpha = image_io.decode_image_rgba(blp2(8, 8, 2, 8, alpha_encoding, blocks))
    got = image_io.decode_image_rgba(blp2(8, 8, 2, 0, alpha_encoding, blocks))
    np.testing.assert_array_equal(got[..., :3], with_alpha[..., :3])
    assert (got[..., 3] == 255).all()
    assert not np.array_equal(got, pil_rgba(blp2(8, 8, 2, 0, alpha_encoding, blocks)))


@pytest.mark.parametrize("kind", ["JP2", "raw codestream"])
def test_icns_jpeg2000_entry_matches_pil(tmp_path, monkeypatch, kind):
    """An ic08 entry in JPEG 2000, which PIL reads through OpenJPEG and
    converts to RGBA (csrc/image_jpeg2000.cpp in the port), at the entry's
    own size: equal through both packages' load_image_rgba."""
    entry = pil_bytes(Image.fromarray(smooth(64, 64, 4 if kind == "JP2" else 3, 39)),
                      format="JPEG2000", no_jp2=kind != "JP2")
    data = icns([(b"ic08", entry), (b"is32", icns_rgb(flat_rgb(16, 40)))])
    path = write(tmp_path, "a.icns", data)
    ref = jax_load(path)
    assert ref is not None and ref.shape == (64, 64, 4)
    np.testing.assert_array_equal(port_load(path, monkeypatch), ref)


# --- refusals and truncation

REFUSED = {
    "FTEX format 2": (ftex(4, 4, 2, bytes(8)), "format 2"),
    "FTEX two formats": (ftex(4, 4, 0, bytes(8), formats=2), "2 formats"),
    "BLP1 encoding 3": (blp1(4, 4, 1, 0, 3, bytes(1024 + 16), 1180, 16), "BLP1 encoding 3"),
    "BLP1 compression 2": (blp1(4, 4, 2, 0, 5, bytes(1024 + 16), 1180, 16), "compression 2"),
    "BLP2 raw BGRA": (blp2(4, 4, 3, 8, 8, bytes(64)), r"encoding 3 \(raw BGRA\)"),
    "BLP2 DXT alpha encoding 5": (blp2(4, 4, 2, 8, 5, bytes(16)), "alpha encoding 5"),
    "BLP2 JPEG": (blp2(4, 4, 1, 0, 0, bytes(16), compression=0), "compression 0"),
    "ICNS unknown entry": (icns([(b"ic07", b"not a PNG at all")]), "neither PNG"),
    "ICNS it32 signature": (icns([(b"it32", b"\1\0\0\0" + bytes(99))]), "signature"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_kind_falls_back_in_both_packages(tmp_path, monkeypatch, name):
    data, what = REFUSED[name]
    with pytest.raises(ValueError, match=what):
        image_io.decode_image_rgba(data)
    path = write(tmp_path, "a" + SUFFIX[FORMATS[name.split()[0]]], data)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


TRUNCATED = ("ICO BMP 24-bit", "ICO PNG entries (PIL)", "CUR 24-bit two entries",
             "DIB 124-byte 24-bit", "FTEX BC1 8x8", "BLP1 JPEG CMYK", "BLP1 encoding 5, alpha",
             "BLP2 DXT3 16x12", "BLP2 palette alpha depth 8", "ICNS il32 RLE and mask",
             "ICNS PNG entries (PIL)")


@pytest.mark.parametrize("name", TRUNCATED)
def test_truncated_file_falls_back_in_both_packages(tmp_path, monkeypatch, name):
    data = CASES[name]
    cut = data[:len(data) * 3 // 5]
    with pytest.raises(ValueError, match="truncated|not enough|overrun"):
        image_io.decode_image_rgba(cut)
    path = write(tmp_path, "a" + SUFFIX[FORMATS[name.split()[0]]], cut)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


def test_formats_are_told_apart_as_pil_tells_them():
    """image_format's answer for each magic PIL's plugins accept; a DIB by
    its first u32 (a BMP info header's size), before the TGA guess."""
    for name, data in CASES.items():
        assert image_io.image_format(data) == FORMATS[name.split()[0]], name
    for size in (12, 40, 52, 56, 64, 108, 124):
        assert image_io.image_format(struct.pack("<I", size) + bytes(40)) == "dib"
    assert image_io.image_format(struct.pack("<I", 41) + bytes(40)) is None
    # A directory of no entry (or a short one) is not an icon to PIL: a
    # true-colour TGA starts with CUR's magic and is read as TGA.
    tga = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, 2, 1, 24, 0x20) + bytes(6)
    assert tga[:4] == b"\0\0\2\0" and image_io.image_format(tga) == "tga"
    assert image_io.image_format(icon_dir(1, [])) is None
    assert image_io.image_format(CASES["ICO BMP 8-bit"][:40]) is None


def test_read_image_takes_an_icon_target(tmp_path):
    """read_image (optimize_cli -target) reads a container as tracy_tpu's
    optimize_cli does: PIL's convert("RGB") / 255, display values."""
    path = write(tmp_path, "target.ico", CASES["ICO BMP 24-bit"])
    img, linear = image_io.read_image(path)
    want = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    assert not linear
    np.testing.assert_array_equal(img, want)
