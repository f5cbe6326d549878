"""JPEG 2000 decoded without PIL (csrc/image_jpeg2000.cpp): JP2 files, raw
J2K codestreams and ICNS's JPEG 2000 entries (their sizes; their pixels in
tests/test_torch_image_containers.py), against tracy_tpu's
load_image_rgba, which opens them through PIL's OpenJPEG (2.5.4 here).

Each file is at most 64x64: written here by PIL's JPEG 2000 writer (its
options irreversible, no_jp2, mct, the five progressions, quality_layers,
num_resolutions 1-6, codeblock_size, precinct_size, tile_size,
tile_offset, offset, signed, plt and comment, in modes L, LA, RGB, RGBA
and I;16), or as JP2 boxes built around such a codestream (sYCC, CMYK,
pclr + cmap, other colr kinds), or read from tests/goldens/jpeg2000/,
where tools/make_jpeg2000_fixtures.py wrote what PIL's writer cannot
through OpenJPEG itself (code-block styles, SOP/EPH, POC, ROI,
subsampling, tile-parts of one tile or interleaved over several, TLM,
PLM, CRG, PPM/PPT, COC/QCC, tile-part COD/QCD/COC/QCC/RGN/POC, 4- and
12-bit samples). Contracts:

* Equal bit for bit to tracy_tpu's float32 RGBA (u8 / 255): the 5/3 and
  9/7 wavelets, RCT and ICT alike (the 9/7 lifting is OpenJPEG's float32
  sequence, built without FMA contraction; no residual is left).
* Where PIL loses the picture (ROADMAP, hazards), the port reads the
  format, each case shown to differ from PIL: grey above 8 bits (PIL's
  I;16, which convert clips to 255) keeps the high byte; a pclr palette
  with a repeated entry, which PIL's palette folds, maps each index to
  its entry.
* Kinds PIL refuses fall back (None) in both packages, named by the
  port; HTJ2K is refused by name by the port alone. A pclr of one or two
  columns, which PIL maps to black, reads as the format defines it.
"""

import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from test_torch_image_containers import icns
from test_torch_image_decode import pil_bytes, port_load, smooth, write
from tracy_tpu.scene.textures import load_image_rgba as jax_load
from tracy_tpu_torch.utils import image_io, native

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "jpeg2000")


def j2k(img, **kw) -> bytes:
    buf = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(buf, format="JPEG2000",
                                                                       **kw)
    return buf.getvalue()


def golden(name) -> bytes:
    with open(os.path.join(GOLDENS, name), "rb") as f:
        return f.read()


def against_tracy_tpu(tmp_path, data, name="a.jp2"):
    """The port's decode (uint8 RGBA) against tracy_tpu's load_image_rgba of
    the same file: equal float32 arrays."""
    got = image_io.decode_image_rgba(data)
    ref = jax_load(write(tmp_path, name, data))
    assert ref is not None
    np.testing.assert_array_equal(got.astype(np.float32) / 255.0, ref)


def box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def jp2(cs: bytes, nc: int, bpc=7, enumcs=16, meth=1, extra=b"", colr=True, size=None):
    """A JP2 file around codestream cs: signature, ftyp, jp2h (ihdr of nc
    components at bpc + 1 bits, colr, then `extra` boxes) and jp2c."""
    x1, y1, x0, y0 = struct.unpack(">IIII", cs[8:24])
    w, h = size or (x1 - x0, y1 - y0)
    ihdr = box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
    body = struct.pack(">BBBI", meth, 0, 0, enumcs) if meth == 1 else bytes([meth, 0, 0]) + b"icc" * 9
    return (b"\0\0\0\x0cjP  \r\n\x87\n" + box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + box(b"jp2h", ihdr + (box(b"colr", body) if colr else b"") + extra)
            + box(b"jp2c", cs))


def pclr(entries, bits=(7, 7, 7)):
    return box(b"pclr", struct.pack(">HB", len(entries), len(bits)) + bytes(bits)
               + b"".join(bytes(e) for e in entries))


def cmap(n):
    return box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, k) for k in range(n)))


# --- files of PIL's writer

def _pil_cases():
    rgb, rgba, grey = smooth(40, 36, 3, 1), smooth(33, 41, 4, 2), smooth(37, 29, 1, 3)[..., 0]
    la = smooth(30, 26, 2, 4)
    sq = smooth(64, 64, 3, 5)
    c = {
        "RGB 5/3": (rgb, {}),
        "RGB 9/7": (rgb, {"irreversible": True}),
        "RGB 5/3 no MCT": (rgb, {"mct": 0}),
        "RGB 9/7 no MCT": (rgb, {"irreversible": True, "mct": 0}),
        "RGB raw codestream": (rgb, {"no_jp2": True}),
        "L 5/3": (grey, {}),
        "L 9/7 raw codestream": (grey, {"irreversible": True, "no_jp2": True}),
        "LA": (Image.fromarray(la, "LA"), {}),
        "LA 9/7": (Image.fromarray(la, "LA"), {"irreversible": True}),
        "RGBA 5/3": (rgba, {}),
        "RGBA 9/7 layers": (rgba, {"irreversible": True, "quality_layers": [30, 10, 3]}),
        "RGB 5/3 layers": (sq, {"quality_layers": [40, 12, 4]}),
        "RGB 9/7 layers (dB)": (sq, {"irreversible": True, "quality_mode": "dB",
                                     "quality_layers": [22, 30, 38]}),
        "RGB 9/7 one lossy layer": (sq, {"irreversible": True, "quality_layers": [60]}),
        "code-blocks 4x4": (rgb, {"codeblock_size": (4, 4)}),
        "code-blocks 64x4": (rgb, {"codeblock_size": (64, 4), "irreversible": True}),
        "code-blocks 1024x4": (sq, {"codeblock_size": (1024, 4), "num_resolutions": 3}),
        "precincts 16 (3 levels)": (sq, {"precinct_size": (16, 16), "num_resolutions": 3,
                                         "quality_layers": [20, 5]}),
        "precincts 32x64": (sq, {"precinct_size": (32, 64), "irreversible": True}),
        "tiles 16": (rgb, {"tile_size": (16, 16), "num_resolutions": 3}),
        "tiles, offsets": (rgb, {"tile_size": (24, 16), "tile_offset": (3, 2), "offset": (5, 7),
                                 "num_resolutions": 3}),
        "tiles, offsets 9/7": (rgba, {"tile_size": (16, 24), "tile_offset": (1, 4),
                                      "offset": (8, 6), "num_resolutions": 3,
                                      "irreversible": True}),
        "signed RGB": (rgb, {"signed": True}),
        "signed L 9/7": (grey, {"signed": True, "irreversible": True, "no_jp2": True}),
        "PLT": (rgba, {"plt": True}),
        "comment": (grey, {"comment": "a texture"}),
        "1x1": (rgb[:1, :1], {}),
        "1x23": (rgb[:1, :23], {"irreversible": True}),
        "23x1": (rgb[:23, :1], {}),
    }
    for order in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        c[f"{order}"] = (sq, {"progression": order, "precinct_size": (32, 32),
                              "quality_layers": [20, 6, 2]})
        c[f"{order} tiles 9/7"] = (rgba, {"progression": order, "precinct_size": (16, 16),
                                          "num_resolutions": 3, "tile_size": (24, 20),
                                          "tile_offset": (2, 3), "offset": (4, 5),
                                          "irreversible": True})
    for n in range(1, 7):
        c[f"{n} resolutions"] = (sq, {"num_resolutions": n, "irreversible": n % 2 == 0})
    return c


PIL_CASES = _pil_cases()


@pytest.mark.parametrize("name", sorted(PIL_CASES))
def test_pil_writer_file_equals_tracy_tpu(tmp_path, name):
    img, kw = PIL_CASES[name]
    against_tracy_tpu(tmp_path, j2k(img, **kw))


# --- what PIL's writer cannot make (tests/goldens/jpeg2000/)

FIXTURES = sorted(
    ["style_%s%s.j2k" % (s, k) for s in ("bypass", "reset", "termall", "causal", "pterm",
                                         "segsym", "all") for k in ("", "_97")]
    + ["sop_eph.j2k", "ppt.j2k", "ppm.j2k", "ppt_tileparts.j2k", "ppm_tileparts.j2k",
       "poc.j2k", "poc_tile.j2k", "roi.j2k", "roi_97.j2k", "roi_tile.j2k", "cod_tile.j2k",
       "sub420.j2k", "sub422.jp2", "sub420_tiles.j2k", "tileparts_r.j2k", "tileparts_c.j2k",
       "tileparts_interleaved.j2k", "tlm_plt.j2k", "plm_crg.j2k", "coc_qcc.j2k",
       "coc_qcc_tile.j2k", "rgb12.j2k", "rgb12_signed.j2k", "rgb4.j2k"])


@pytest.mark.parametrize("name", FIXTURES)
def test_openjpeg_fixture_equals_tracy_tpu(tmp_path, name):
    against_tracy_tpu(tmp_path, golden(name), name)


# --- JP2 boxes around a codestream

def _box_cases():
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 12, (20, 24)).astype(np.uint8)
    one = j2k(idx, no_jp2=True)
    pal = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(12)]
    pal4 = [tuple(int(v) for v in rng.integers(0, 256, 4)) for _ in range(12)]
    two = j2k(Image.fromarray(np.stack([idx, rng.integers(0, 256, idx.shape, np.uint8)], -1),
                              "LA"), no_jp2=True)
    rgb, rgba = j2k(smooth(20, 24, 3, 8), no_jp2=True), j2k(smooth(20, 24, 4, 9), no_jp2=True)
    rgba97 = j2k(smooth(20, 24, 4, 9), no_jp2=True, irreversible=True)
    return {
        "P, RGB palette": jp2(one, 1, extra=pclr(pal) + cmap(3)),
        "P, no cmap": jp2(one, 1, extra=pclr(pal)),
        "P, RGBA palette": jp2(one, 1, extra=pclr(pal4, (7, 7, 7, 7)) + cmap(4)),
        "P, indices past the palette": jp2(one, 1, extra=pclr(pal[:6]) + cmap(3)),
        "PA": jp2(two, 2, extra=pclr(pal) + cmap(3)),
        "CMYK": jp2(rgba, 4, enumcs=12),
        "CMYK 9/7": jp2(rgba97, 4, enumcs=12),
        "sYCC": jp2(rgb, 3, enumcs=18),
        "sYCC with alpha": jp2(rgba, 4, enumcs=18),
        "ICC colr": jp2(rgb, 3, meth=2),
        "no colr": jp2(rgb, 3, colr=False),
        "unknown enumerated space": jp2(rgb, 3, enumcs=20),
        "colr method 3": jp2(rgb, 3, meth=3),
        "ihdr of 3 components, grey codestream": jp2(one, 3, enumcs=17),
    }


BOX_CASES = _box_cases()


@pytest.mark.parametrize("name", sorted(BOX_CASES))
def test_jp2_boxes_equal_tracy_tpu(tmp_path, name):
    against_tracy_tpu(tmp_path, BOX_CASES[name])


# --- where PIL loses the picture: the format's (ROADMAP, hazards)

I16 = {
    "JP2": lambda a: j2k(Image.fromarray(a)),
    "raw codestream 9/7": lambda a: j2k(Image.fromarray(a), irreversible=True, no_jp2=True),
    "12-bit raw codestream": lambda a: golden("grey12.j2k"),
}


@pytest.mark.parametrize("kind", sorted(I16))
def test_grey_above_8_bits_keeps_the_high_byte(kind):
    """PIL opens grey above 8 bits as I;16 and convert("RGBA") clips it to
    255; the port keeps the high byte of PIL's I;16 value, as for PNG, PNM
    and TIFF."""
    a = np.random.default_rng(11).integers(0, 65536, (20, 24)).astype(np.uint16)
    data = I16[kind](a)
    im = Image.open(io.BytesIO(data))
    assert im.mode == "I;16"
    wide = np.asarray(im).astype(np.int64)
    got = image_io.decode_image_rgba(data)
    np.testing.assert_array_equal(got[..., :3], np.repeat((wide >> 8)[..., None], 3, -1))
    assert (got[..., 3] == 255).all()
    assert not np.array_equal(got, np.asarray(Image.open(io.BytesIO(data)).convert("RGBA")))


def test_repeated_palette_entry_reads_the_format():
    """PIL's palette folds a repeated pclr entry (getcolor), so later
    indices map to other colours; the port maps each index to its entry."""
    rng = np.random.default_rng(12)
    idx = rng.integers(0, 8, (16, 16)).astype(np.uint8)
    pal = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(8)]
    pal[3] = pal[1]
    data = jp2(j2k(idx, no_jp2=True), 1, extra=pclr(pal) + cmap(3))
    got = image_io.decode_image_rgba(data)
    np.testing.assert_array_equal(got[..., :3], np.asarray(pal, np.uint8)[idx])
    assert not np.array_equal(got, np.asarray(Image.open(io.BytesIO(data)).convert("RGBA")))


# --- ICNS's JPEG 2000 entries (the JP2 and raw codestream entries are held
# against PIL in tests/test_torch_image_containers.py)

@pytest.mark.parametrize("kind", ["JPEG 2000", "PNG"])
def test_icns_entry_outside_the_icon_sizes_falls_back(tmp_path, monkeypatch, kind):
    """PIL refuses an embedded image whose size is no whole fraction of one
    of the icon's sizes ("not one of the allowed sizes"); so does the port,
    for JPEG 2000 and PNG entries alike."""
    img = Image.fromarray(smooth(100, 100, 3, 41))
    entry = j2k(img) if kind == "JPEG 2000" else pil_bytes(img, format="PNG")
    data = icns([(b"ic08", entry)])
    with pytest.raises(ValueError, match="not one of the allowed sizes"):
        image_io.decode_image_rgba(data)
    path = write(tmp_path, "a.icns", data)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


# --- telling the format apart

@pytest.mark.parametrize("kind", ["JP2", "raw codestream"])
def test_jpeg2000_is_told_apart_as_pil_tells_it(kind):
    """image_format names both signatures "jpeg2000", at PIL's place for
    its plugin (after GBR, before ICNS, which imports it); IM, IMT and
    IPTC, which have no magic number, give such a file up (code 3)."""
    data = j2k(smooth(8, 8, 3, 13), no_jp2=kind != "JP2")
    assert image_io.image_format(data) == "jpeg2000"
    assert Image.open(io.BytesIO(data)).format == "JPEG2000"
    order = [fmt for fmt, _ in image_io.FORMAT_ORDER]
    assert order[order.index("jpeg2000") - 1:order.index("jpeg2000") + 2] == ["gbr", "jpeg2000",
                                                                              "icns"]
    lib = native.get_image_lib()
    for fmt in ("im", "imt", "iptc"):
        w, h = image_io.ctypes.c_int(), image_io.ctypes.c_int()
        info = getattr(lib, f"tracy_{fmt}_info")
        assert info(data, len(data), image_io.ctypes.byref(w), image_io.ctypes.byref(h)) == 3


# --- refusals, truncation and the scene

def _refused():
    sq = smooth(40, 40, 3, 14)
    rgb = j2k(smooth(20, 24, 3, 15), no_jp2=True)
    grey = j2k(smooth(20, 24, 1, 16)[..., 0], no_jp2=True)
    pal = [(k, 2 * k, 3 * k) for k in range(8)]
    return {
        "precincts too small for the levels (PIL's file)": (j2k(sq, precinct_size=(16, 16)),
                                                            "invalid precinct size"),
        "PPM marker splitting an Nppm": (golden("ppm_split_nppm.j2k"), "room for Nppm"),
        "PPT index repeated in a later tile-part": (golden("ppt_repeated_index.j2k"),
                                                    "read twice"),
        "POC entry ending at component 0": (golden("poc_cepoc0.j2k"), "truncated"),
        "five components": (golden("five.j2k"), "5 components"),
        "codestream without EOC": (rgb[:-2], "EOC"),
        "eYCC": (jp2(rgb, 3, enumcs=24), "no unpacker for mode RGB"),
        "grey under an sRGB colr": (jp2(grey, 1, enumcs=16), "no unpacker for mode L"),
        "cmap before pclr": (jp2(grey, 1, extra=cmap(3) + pclr(pal)), "cmap box before"),
        "pclr shorter than its 9-bit entries": (jp2(grey, 1, extra=pclr(pal, (8, 8, 8))),
                                                "pclr box is truncated"),
        "ihdr larger than the codestream": (jp2(rgb, 3, size=(30, 25)), "size differs"),
        "no jp2h": (b"\0\0\0\x0cjP  \r\n\x87\n" + box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
                    + box(b"jp2c", rgb), "no jp2h"),
    }


REFUSED = _refused()


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_kind_falls_back_in_both_packages(tmp_path, monkeypatch, name):
    data, what = REFUSED[name]
    with pytest.raises(ValueError, match=what):
        image_io.decode_image_rgba(data)
    path = write(tmp_path, "a.jp2", data)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusal_names_its_format_once(name):
    """The message starts with "JPEG 2000: " once, as the C source writes
    it."""
    fmt = "JPEG 2000"
    with pytest.raises(ValueError) as e:
        image_io.decode_image_rgba(REFUSED[name][0])
    assert str(e.value).startswith(f"{fmt}: ")
    assert not str(e.value).startswith(f"{fmt}: {fmt}: ")


def _htj2k():
    cs = j2k(smooth(16, 16, 3, 17), no_jp2=True)
    rsiz = cs[:6] + struct.pack(">H", 0x4000) + cs[8:]
    siz_end = 4 + struct.unpack(">H", cs[4:6])[0]
    cap = cs[:siz_end] + struct.pack(">HHI", 0xFF50, 6, 0x20000) + cs[siz_end:]
    cod = cs.index(b"\xff\x52")
    style = cs[:cod + 12] + bytes([cs[cod + 12] | 0x40]) + cs[cod + 13:]
    return {"Rsiz bit 14": rsiz, "CAP marker": cap, "code-block style bit 6": style}


HTJ2K = _htj2k()


@pytest.mark.parametrize("name", sorted(HTJ2K))
def test_htj2k_is_refused_by_name(tmp_path, monkeypatch, name):
    """Part 15 (HTJ2K), which OpenJPEG 2.5 decodes but nothing here can
    write, is refused by name (ROADMAP, queue 3) and the texture falls
    back."""
    with pytest.raises(ValueError, match="HTJ2K"):
        image_io.decode_image_rgba(HTJ2K[name])
    assert port_load(write(tmp_path, "a.j2k", HTJ2K[name]), monkeypatch) is None


def test_one_column_palette_is_refused_by_name(tmp_path, monkeypatch):
    """PIL builds a broken palette from one-column pclr entries and maps
    every index to black (ROADMAP, hazards); the port, which once refused
    the file by name, reads the palette as the format defines it: each
    index to its entry's grey."""
    idx = smooth(12, 12, 1, 18)[..., 0] // 32
    entries = [(31 * k + 11,) for k in range(8)]
    data = jp2(j2k(idx, no_jp2=True), 1, extra=pclr(entries, (7,)) + cmap(1))
    path = write(tmp_path, "a.jp2", data)
    ref = jax_load(path)
    assert (ref[..., :3] == 0).all()
    want = np.full(idx.shape + (4,), 255, np.uint8)
    want[..., :3] = np.asarray(entries, np.uint8)[idx]
    np.testing.assert_array_equal(image_io.decode_image_rgba(data), want)
    np.testing.assert_array_equal(port_load(path, monkeypatch), want / np.float32(255.0))
    assert not np.array_equal(port_load(path, monkeypatch), ref)


def test_two_column_palette_reads_grey_and_alpha(tmp_path, monkeypatch):
    """Two pclr columns, which PIL maps to black too, are each index's grey
    and alpha, as a file of two components is read."""
    idx = smooth(12, 14, 1, 19)[..., 0] // 32
    entries = [(29 * k + 5, 255 - 31 * k) for k in range(8)]
    data = jp2(j2k(idx, no_jp2=True), 1, extra=pclr(entries, (7, 7)) + cmap(2))
    path = write(tmp_path, "a.jp2", data)
    assert (jax_load(path)[..., :3] == 0).all()
    pal = np.asarray(entries, np.uint8)[idx]
    want = np.stack([pal[..., 0]] * 3 + [pal[..., 1]], axis=-1)
    np.testing.assert_array_equal(image_io.decode_image_rgba(data), want)


@pytest.mark.parametrize("cut", [0.3, 0.7, 0.97])
def test_truncated_file_falls_back_in_both_packages(tmp_path, monkeypatch, cut):
    data = j2k(smooth(40, 40, 3, 19), quality_layers=[30, 10, 2])
    path = write(tmp_path, "a.jp2", data[:int(len(data) * cut)])
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


def test_scene_with_jpeg2000_textures_loads_in_both_packages(tmp_path):
    """A .scn whose maps are a JP2 file and a raw codestream: no package
    substitutes grey, and both atlases hold the same texels."""
    from tracy_tpu.scene.scn_parser import load_scene as jax_scene
    from tracy_tpu_torch.scene import load_scene

    write(tmp_path, "b.jp2", j2k(smooth(24, 20, 3, 20), irreversible=True))
    write(tmp_path, "r.j2k", j2k(smooth(16, 16, 1, 21)[..., 0], no_jp2=True))
    scn = write(tmp_path, "s.scn", (
        "SCN j2k\nOUT 32 24\nCAM (0, 0, 3) (0, 0, 0) (0, 1, 0) 45.0\n"
        "MTL T (1.0, 1.0, 1.0) 1 0\nTEX T B b.jp2 SRGB\nTEX T R r.j2k\n"
        "OBJ S (0, 0, 0) 0.5 T\n").encode())
    ours, ref = load_scene(scn), jax_scene(scn)
    assert ours.fallbacks == []
    assert [p.shape for p in ours.atlas.pixels] == [p.shape for p in ref.atlas.pixels]
    for a, b in zip(ours.atlas.pixels, ref.atlas.pixels):
        np.testing.assert_array_equal(a, b)
