"""AVIF decoded without PIL (csrc/image_avif.cpp, av1_decode.cpp,
av1_recon.cpp) against tracy_tpu's load_image_rgba, which opens it through
PIL's libavif 1.3 (dav1d 1.5.1 decodes; aom 3.12.1 encoded the corpus).

The corpus is tests/goldens/avif/, written by
tools/make_avif_fixtures.py: PIL's writer at qualities 0-100, speeds 0-10,
4:2:0, 4:2:2, 4:4:4 and 4:0:0, odd sizes, limited range, 2x2 tiles, CDEF,
quantizer matrices, delta q and delta loop filter levels, 64-sample
transforms, screen content (palette, intra block copy), alpha
(premultiplied too), film grain, two-frame sequences (one segmented by
variance AQ); and through libavif's encoder what PIL's writer cannot
make (grids, other matrix coefficients and ranges, limited-range grey).
Contracts:

* The decoded Y, U, V and alpha planes equal dav1d's, bit for bit (read
  through libavif by ctypes here).
* The RGBA equals tracy_tpu's float32 RGBA (u8 / 255), bit for bit:
  libyuv's fixed-point matrices and bilinear chroma upsampling, libavif's
  own float conversion (built without FMA contraction) for the matrices
  libyuv does not take, and libyuv's unattenuate for premultiplied alpha.
  No residual is left.
* The corpus covers the coding tools it names (av1::kTool bits).
* irot, imir and clap leave the pixels as they are (PIL turns the first
  two into an EXIF orientation); an item without ispe or av1C gives way,
  one without pixi or colr reads, as PIL sets libavif's checks.
* A mif1 file without the avif brand, or an avis file without tracks,
  gives way to the next formats, as PIL's plugin does; an avis file is read
  as its first frame; what the port does not read (superres) is refused by
  name and the texture falls back, as do truncated
  files in both packages.
"""

import ctypes as C
import glob
import io
import os
import struct

import numpy as np
import PIL
import pytest
from PIL import Image

from test_torch_image_decode import port_load, write
from tracy_tpu.scene.textures import load_image_rgba as jax_load
from tracy_tpu_torch.utils import image_io, native

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "avif")
CORPUS = sorted(n for n in os.listdir(GOLDENS) if n.endswith(".avif") and n != "big.avif")
TOOLS = ("palette", "intrabc", "filter_intra", "cfl", "cdef", "wiener", "sgrproj", "qm",
         "delta_q", "delta_lf", "lossless", "tx64", "sb128", "tiles", "segments", "var_tx",
         "idtx_1d", "flipadst", "deblock")


def golden(name) -> bytes:
    with open(os.path.join(GOLDENS, name), "rb") as f:
        return f.read()


def _libavif():
    lib = C.CDLL(glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                                        "pillow.libs", "libavif-*.so*"))[0])
    vp = C.c_void_p
    lib.avifDecoderCreate.restype = lib.avifImageCreateEmpty.restype = vp
    lib.avifDecoderReadMemory.argtypes = [vp, vp, C.c_char_p, C.c_size_t]
    lib.avifImageDestroy.argtypes = lib.avifDecoderDestroy.argtypes = [vp]
    return lib


def dav1d_image(data: bytes):
    """(depth, dav1d's planes, alpha or None) of an AVIF file, read through
    libavif: the avifImage of libavif 1.3 has width, height, depth and
    format at 0-12, the plane pointers at 24, their row bytes at 48, alpha
    at 64 and 72; samples of 8 bits, or of 16 above 8 bits."""
    lib = _libavif()
    dec, im = lib.avifDecoderCreate(), lib.avifImageCreateEmpty()
    try:
        assert lib.avifDecoderReadMemory(dec, im, data, len(data)) == 0
        w, h, depth, fmt = struct.unpack("<4I", C.string_at(im, 16))
        ptr = struct.unpack("<3Q", C.string_at(im + 24, 24))
        rows = struct.unpack("<3I", C.string_at(im + 48, 12))
        aptr, arow = struct.unpack("<QI", C.string_at(im + 64, 12))
        sx, sy = {1: (0, 0), 2: (1, 0), 3: (1, 1), 4: (1, 1)}[fmt]
        dtype = np.uint8 if depth == 8 else np.uint16
        planes = []
        for k in range(1 if fmt == 4 else 3):
            pw, ph = (w, h) if k == 0 else ((w + sx) >> sx, (h + sy) >> sy)
            raw = np.frombuffer(C.string_at(ptr[k], rows[k] * ph), dtype)
            planes.append(raw.reshape(ph, -1)[:, :pw])
        alpha = None
        if aptr:
            alpha = np.frombuffer(C.string_at(aptr, arow * h), dtype).reshape(h, -1)[:, :w]
        return depth, planes, alpha
    finally:
        lib.avifImageDestroy(im)
        lib.avifDecoderDestroy(dec)


def dav1d_planes(data: bytes):
    """dav1d's planes and alpha (or None) of an AVIF file."""
    return dav1d_image(data)[1:]


def port_planes(data: bytes):
    """(planes, alpha or None, tool bits) of the port's decode."""
    lib = native.get_image_lib()
    meta = (C.c_int * 10)()
    assert lib.tracy_avif_planes(data, len(data), meta, None, None, None, None) == 0
    w, h, _, sx, sy, n, has_alpha, _, _, tools = list(meta)
    shapes = [(h, w)] + [((h + sy) >> sy, (w + sx) >> sx)] * 2
    planes = [np.zeros(s, np.uint16) for s in shapes]
    alpha = np.zeros((h, w), np.uint16)
    ptrs = [p.ctypes.data for p in planes] + [alpha.ctypes.data]
    assert lib.tracy_avif_planes(data, len(data), meta, *ptrs) == 0
    return planes[:n], (alpha if has_alpha else None), tools


@pytest.mark.parametrize("name", CORPUS)
def test_planes_equal_dav1d(name):
    data = golden(name)
    ref, ref_alpha = dav1d_planes(data)
    got, got_alpha, _ = port_planes(data)
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    assert (ref_alpha is None) == (got_alpha is None)
    if ref_alpha is not None:
        np.testing.assert_array_equal(got_alpha, ref_alpha)


@pytest.mark.parametrize("name", CORPUS)
def test_rgba_equals_tracy_tpu(tmp_path, name):
    data = golden(name)
    ref = jax_load(write(tmp_path, name, data))
    assert ref is not None
    np.testing.assert_array_equal(image_io.decode_image_rgba(data).astype(np.float32) / 255.0,
                                  ref)


# What each file must exercise (the tools aom chose at those settings).
EXPECTED_TOOLS = {
    "q100.avif": {"lossless"}, "speed0.avif": {"sb128", "wiener"},
    "speed2.avif": {"wiener", "idtx_1d"}, "tiles.avif": {"tiles"}, "cdef.avif": {"cdef"},
    "qm.avif": {"qm"}, "deltaq.avif": {"delta_q"}, "tx64.avif": {"tx64"},
    "deltalf.avif": {"delta_q", "delta_lf", "deblock"}, "segments.avif": {"segments"},
    "palette.avif": {"palette"}, "intrabc.avif": {"intrabc", "var_tx", "palette"},
    "normal.avif": {"tiles", "cdef"}, "roughness.avif": {"palette", "intrabc"},
    "metalness.avif": {"qm", "delta_q"}, "basecolor.avif": {"cfl", "deblock"},
}


def test_corpus_covers_the_coding_tools():
    """Each file uses the tools named for it, and the corpus as a whole
    every tool but the flipped ADSTs (only intra block copy's inter sets
    reach them, and aom chose none here; ROADMAP, queue 3)."""
    seen = set()
    for name in CORPUS:
        bits = port_planes(golden(name))[2]
        tools = {t for k, t in enumerate(TOOLS) if bits >> k & 1}
        assert EXPECTED_TOOLS.get(name, set()) <= tools, (name, tools)
        seen |= tools
    assert seen >= set(TOOLS) - {"flipadst"}, set(TOOLS) - seen


def _pil(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="AVIF", **kw)
    return buf.getvalue()


def _noise(h, w, c, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 70 * np.sin(x[..., None] / (3.0 + np.arange(c)) + y[..., None] / 9.0)
    return np.clip(base + rng.normal(0, 20, (h, w, c)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kw", [dict(subsampling="4:2:0"), dict(subsampling="4:2:2", speed=9),
                                dict(subsampling="4:4:4", quality=30),
                                dict(subsampling="4:2:0", quality=90, range="limited")],
                         ids=["420", "422", "444", "limited"])
def test_random_content_equals_tracy_tpu(tmp_path, kw):
    """Noise through PIL's writer here at speed 10 (fast), 37x45."""
    data = _pil(_noise(37, 45, 3, len(str(kw))), speed=kw.pop("speed", 10), **kw)
    ref = jax_load(write(tmp_path, "a.avif", data))
    np.testing.assert_array_equal(image_io.decode_image_rgba(data).astype(np.float32) / 255.0,
                                  ref)


def _with_brands(data: bytes, major: bytes, compatible) -> bytes:
    """The file with the brands of its ftyp box replaced in place (as many
    compatible brands as it had)."""
    size = struct.unpack(">I", data[:4])[0]
    assert len(compatible) == (size - 16) // 4
    return data[:8] + major + data[12:16] + b"".join(compatible) + data[size:]


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def _boxes(b: bytes):
    out, at = [], 0
    while at < len(b):
        size = struct.unpack(">I", b[at:at + 4])[0]
        out.append((b[at + 4:at + 8], b[at + 8:at + size]))
        at += size
    return out


def _with_property(data: bytes, prop: bytes) -> bytes:
    """The file with property box `prop` added to ipco and associated with
    item 1 (the primary item of libavif's files), its item data moved
    along."""
    def rebuild(kind, body):
        if kind == b"meta":
            return _box(kind, body[:4] + b"".join(rebuild(*k) for k in _boxes(body[4:])))
        if kind == b"iprp":
            return _box(kind, b"".join(rebuild(*k) for k in _boxes(body)))
        if kind == b"ipco":
            return _box(kind, body + prop)
        if kind == b"ipma":
            count, at, out = struct.unpack(">I", body[4:8])[0], 8, body[:8]
            index = len(_boxes(ipco)) + 1
            for _ in range(count):
                item, n = struct.unpack(">HB", body[at:at + 3])
                extra = bytes([0x80 | index]) if item == 1 else b""
                out += struct.pack(">HB", item, n + len(extra)) + body[at + 3:at + 3 + n] + extra
                at += 3 + n
            return _box(kind, out)
        return _box(kind, body)

    meta = dict(_boxes(data))[b"meta"]
    ipco = dict(_boxes(dict(_boxes(meta[4:]))[b"iprp"]))[b"ipco"]
    return _moved(data, b"".join(rebuild(*k) for k in _boxes(data)))


def _moved(data: bytes, new: bytes) -> bytes:
    """`new` (data with its meta box rewritten) with the iloc extents moved
    by the change in length (iloc version 0, 4-byte offsets, as libavif
    writes it)."""
    new = bytearray(new)
    delta, at = len(new) - len(data), new.index(b"iloc") + 4
    assert new[at] == 0 and new[at + 4] == 0x44
    p = at + 8
    for _ in range(struct.unpack(">H", new[at + 6:at + 8])[0]):
        p += 6
        for _ in range(struct.unpack(">H", new[p - 2:p])[0]):
            new[p:p + 4] = struct.pack(">I", struct.unpack(">I", new[p:p + 4])[0] + delta)
            p += 8
    return bytes(new)


def _without_property(data: bytes, kind: bytes, item: int) -> bytes:
    """The file with item `item`'s associations to `kind` properties
    dropped from ipma (the item data moved along)."""
    meta = dict(_boxes(data))[b"meta"]
    ipco = dict(_boxes(dict(_boxes(meta[4:]))[b"iprp"]))[b"ipco"]
    drop = {k + 1 for k, (t, _) in enumerate(_boxes(ipco)) if t == kind}

    def rebuild(k, body):
        if k in (b"meta", b"iprp"):
            head = body[:4] if k == b"meta" else b""
            return _box(k, head + b"".join(rebuild(*x) for x in _boxes(body[len(head):])))
        if k == b"ipma":
            count, at, out = struct.unpack(">I", body[4:8])[0], 8, body[:8]
            for _ in range(count):
                i, n = struct.unpack(">HB", body[at:at + 3])
                keep = bytes(a for a in body[at + 3:at + 3 + n]
                             if i != item or a & 0x7F not in drop)
                out += struct.pack(">HB", i, len(keep)) + keep
                at += 3 + n
            return _box(k, out)
        return _box(k, body)

    return _moved(data, b"".join(rebuild(*k) for k in _boxes(data)))


@pytest.mark.parametrize("kind", [b"ispe", b"av1C", b"pixi", b"colr"])
@pytest.mark.parametrize("item", [1, 2], ids=["colour", "alpha"])
def test_missing_property_as_pil(tmp_path, kind, item):
    """libavif's checks as PIL sets them: an image or alpha item without
    ispe (its strict default) or av1C fails the parse, so PIL's plugin and
    the port's reader give way and no format claims the file; pixi and
    colr may be missing (PIL lifts libavif's pixi check), and the pixels
    are the same in both packages."""
    data = _without_property(golden("alpha.avif"), kind, item)
    if kind in (b"ispe", b"av1C"):
        assert image_io.image_format(data) is None
        with pytest.raises(PIL.UnidentifiedImageError):
            Image.open(io.BytesIO(data))
    else:
        np.testing.assert_array_equal(image_io.decode_image_rgba(data).astype(np.float32) / 255.0,
                                      jax_load(write(tmp_path, "a.avif", data)))


@pytest.mark.parametrize("prop", [_box(b"irot", b"\x01"), _box(b"imir", b"\x00"),
                                  _box(b"clap", struct.pack(">8I", 40, 1, 32, 1, 0, 1, 0, 1))],
                         ids=["irot", "imir", "clap"])
def test_transform_properties_leave_the_pixels(tmp_path, prop):
    """PIL reports irot and imir as an EXIF orientation (tracy_tpu calls no
    exif_transpose) and crops nothing for clap: the pixels are the plain
    file's, in both packages."""
    data = _with_property(golden("q50.avif"), prop)
    plain = image_io.decode_image_rgba(golden("q50.avif"))
    np.testing.assert_array_equal(image_io.decode_image_rgba(data), plain)
    np.testing.assert_array_equal(jax_load(write(tmp_path, "a.avif", data)),
                                  plain.astype(np.float32) / 255.0)


@pytest.mark.parametrize("major", [b"avif", b"mif1", b"msf1", b"avis"])
def test_pil_brands_are_avif(major):
    """PIL's four brands; libavif reads the tracks of an avis file (its
    first frame; PIL's save_all wrote this one) and the primary item of the
    others (which have no tracks)."""
    name = "sequence.avif" if major == b"avis" else "q50.avif"
    data = golden(name)
    if major != b"avis":
        data = _with_brands(data, major, [b"mif1", b"avif", b"miaf", b"MA1B"])
    assert image_io.image_format(data) == "avif"
    assert Image.open(io.BytesIO(data)).format == "AVIF"
    np.testing.assert_array_equal(image_io.decode_image_rgba(data),
                                  image_io.decode_image_rgba(golden(name)))


@pytest.mark.parametrize("major, compatible", [(b"mif1", [b"mif1", b"heic", b"miaf", b"MA1B"]),
                                               (b"mif1", [b"mif1", b"miaf", b"MA1B", b"MiHE"]),
                                               (b"avis", [b"avis", b"avif", b"mif1", b"miaf"])],
                         ids=["heic", "no avif brand", "avis without tracks"])
def test_gives_way_as_pil_does(tmp_path, monkeypatch, major, compatible):
    """A mif1 file without the avif brand (HEIC, say), or an avis file
    without tracks: libavif fails to parse it, PIL's _open raises
    SyntaxError and Image.open tries its next plugins, none of which reads
    it; the port's AVIF reader gives way too (tracy_avif_info answers 3)
    and no format claims the file."""
    data = _with_brands(golden("q50.avif"), major, compatible)
    assert image_io.image_format(data) is None
    with pytest.raises(PIL.UnidentifiedImageError):
        Image.open(io.BytesIO(data))
    path = write(tmp_path, "a.avif", data)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


def _sequence_header_bits(data: bytes):
    """(offset of the payload, bit index of high_bitdepth, bit index of
    enable_superres) of the reduced still-picture sequence header OBU at
    the start of the item data (after libavif's temporal delimiter). The
    10- and 12-bit samples this file once refused are decoded now
    (tests/test_torch_image_avif_deep.py)."""
    at = data.index(b"\x0a", data.index(b"mdat") + 4)
    assert data[at + 2] >> 3 & 3 == 3  # still_picture and reduced_still_picture_header
    bits = np.unpackbits(np.frombuffer(data[at + 2:at + 2 + data[at + 1]], np.uint8))
    wbits = int("".join(map(str, bits[10:14])), 2) + 1
    hbits = int("".join(map(str, bits[14:18])), 2) + 1
    superres = 18 + wbits + hbits + 3
    return at + 2, superres + 3, superres


def _set_bits(data: bytes, at: int, values: dict) -> bytes:
    out = bytearray(data)
    for bit, v in values.items():
        byte, shift = at + bit // 8, 7 - bit % 8
        out[byte] = (out[byte] & ~(1 << shift)) | (v << shift)
    return bytes(out)


def _refused():
    base = golden("q50.avif")
    at, _, superres = _sequence_header_bits(base)
    sres = _set_bits(base, at, {superres: 1})
    frame = at + base[at - 1]  # the frame OBU after the sequence header
    assert base[frame] == 0x32
    payload = frame + 2
    while base[payload - 1] & 0x80:  # its size, leb128
        payload += 1
    screen = base[payload] >> 6 & 1
    sres = _set_bits(sres, payload, {2 + screen: 1})  # use_superres
    return {"superres": (sres, "superres not read")}


REFUSED = _refused()


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_by_name(tmp_path, monkeypatch, name):
    """What no encoder here writes, so that no decode of it could be
    checked, is refused by name (ROADMAP, queue 3) and the texture falls
    back: superres, which aom refuses to write ("superres-mode" answers
    AVIF_RESULT_INVALID_CODEC_SPECIFIC_OPTION, in Pillow's libavif and in
    OpenCV's 1.4.2 alike)."""
    data, what = REFUSED[name]
    with pytest.raises(ValueError, match=what):
        image_io.decode_image_rgba(data)
    assert port_load(write(tmp_path, "a.avif", data), monkeypatch) is None


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusal_names_its_format_once(name):
    """The message starts with "AVIF: " once: the AV1 decoder's refusals
    are named as the AVIF file's."""
    fmt = "AVIF"
    with pytest.raises(ValueError) as e:
        image_io.decode_image_rgba(REFUSED[name][0])
    assert str(e.value).startswith(f"{fmt}: ")
    assert not str(e.value).startswith(f"{fmt}: {fmt}: ")


@pytest.mark.parametrize("cut", [0.1, 0.5, 0.9])
def test_truncated_file_falls_back_in_both_packages(tmp_path, monkeypatch, cut):
    data = golden("q50.avif")
    path = write(tmp_path, "a.avif", data[:int(len(data) * cut)])
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


def test_scene_with_avif_textures_loads_in_both_packages(tmp_path):
    """A .scn whose maps are AVIF files: no package substitutes grey, and
    both atlases hold the same texels."""
    from tracy_tpu.scene.scn_parser import load_scene as jax_scene
    from tracy_tpu_torch.scene import load_scene

    write(tmp_path, "b.avif", golden("alpha.avif"))
    write(tmp_path, "r.avif", golden("sub400.avif"))
    scn = write(tmp_path, "s.scn", (
        "SCN avif\nOUT 32 24\nCAM (0, 0, 3) (0, 0, 0) (0, 1, 0) 45.0\n"
        "MTL T (1.0, 1.0, 1.0) 1 0\nTEX T B b.avif SRGB\nTEX T R r.avif\n"
        "OBJ S (0, 0, 0) 0.5 T\n").encode())
    ours, ref = load_scene(scn), jax_scene(scn)
    assert ours.fallbacks == []
    assert [p.shape for p in ours.atlas.pixels] == [p.shape for p in ref.atlas.pixels]
    for a, b in zip(ours.atlas.pixels, ref.atlas.pixels):
        np.testing.assert_array_equal(a, b)
