"""PNG and JPEG decoding without PIL (csrc/image_decode.cpp) against
tracy_tpu's, which decodes through PIL (libjpeg-turbo for JPEG).

Each image is made from a seeded numpy array and written with PIL (or, for
what PIL cannot write, by the small PNG encoder below), then decoded by
tracy_tpu's `load_image_rgba` and by the port's with PIL blocked in
sys.modules. Contracts:

* PNG: equal bit for bit (float32 RGBA, u8 / 255), for colour types
  0/2/3/4/6 at 8 bits, 1/2/4-bit grey and palette, palette with tRNS,
  Adam7 at several types, and PIL's adaptive row filters. 16-bit files are
  held against the high byte of their samples, which stb_image (the C++
  reference) keeps; PIL clips 16-bit grey instead (ROADMAP, hazards).
* JPEG: grey and 4:4:4 equal bit for bit; 4:2:2, 4:2:0 and 4:4:0 within
  max |diff| <= 2/255 and mean |diff| <= 0.25/255 (measured against PIL
  12.1 over libjpeg-turbo 3: max 0 and mean 0 in every case, so the
  decoder reproduces libjpeg's fancy upsampling and colour tables), at
  qualities 50 and 95, baseline, progressive, optimised Huffman tables and
  restart intervals, at odd sizes.
* Files the decoders refuse (arithmetic coding, lossless, 12-bit) raise
  ValueError naming it (CMYK, YCCK and 4:1:1 are read:
  test_torch_image_jpeg_kinds.py), and the texture loader falls back (None);
  a decoder library that cannot be built raises instead.
* The fixture's 2048x2048 JPEG decodes in under 1 s on the CPU; a -target .jpg
  drives optimize_cli's albedo recovery.
"""

import io
import logging
import os
import re
import struct
import sys
import time
import zlib

import numpy as np
import pytest
from PIL import Image

from tracy_tpu.scene.textures import load_image_rgba as jax_load
from tracy_tpu_torch.scene import textures as ttex
from tracy_tpu_torch.utils import image_io, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "goldens", "textured")
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def port_load(path, monkeypatch):
    """The port's load_image_rgba with every PIL module blocked."""
    with monkeypatch.context() as m:
        for name in [k for k in sys.modules if k == "PIL" or k.startswith("PIL.")]:
            m.setitem(sys.modules, name, None)
        m.setitem(sys.modules, "PIL", None)
        return ttex.load_image_rgba(path)


def write(tmp_path, name, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def pil_bytes(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, **kw)
    return buf.getvalue()


def smooth(h, w, c, seed):
    """uint8 [h, w, c]: sines, a checker edge and a little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    chans = [127 + 80 * np.sin(rng.uniform(0.05, 0.3) * x + k) * np.cos(rng.uniform(0.05, 0.3) * y)
             + 40 * ((x // 7 + y // 5 + k) % 2) + rng.normal(0, 6, (h, w)) for k in range(c)]
    return np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)


# --- a PNG encoder for what PIL cannot write (2/4-bit grey, 16-bit RGB(A), Adam7)

def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _pack(samples, depth):
    """Rows [h, n] of samples -> packed bytes [h, rowbytes]."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    s = np.concatenate([samples, np.zeros((h, (-n) % per), samples.dtype)], 1)
    s = s.reshape(h, -1, per).astype(np.int64)
    return sum(s[..., k] << (8 - depth * (k + 1)) for k in range(per)).astype(np.uint8)


def _filter(rows, bpp, rng):
    """Each row under a random one of the five filters."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for r in rows.astype(np.int64):
        a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])[:len(r)]
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])[:len(r)]
        f = int(rng.integers(0, 5))
        p = a + prev - c
        pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
        pred = [0, a, prev, (a + prev) // 2,
                np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))][f]
        out.append(np.concatenate([[f], (r - pred) & 255]).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def encode_png(img, depth, ctype, interlace=False, plte=None, trns=None, seed=0):
    h, w = img.shape[:2]
    img = img.reshape(h, w, CHANNELS[ctype])
    bpp = max(1, CHANNELS[ctype] * depth // 8)
    rng = np.random.default_rng(seed)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b""
    for x0, y0, dx, dy in passes:
        sub = img[y0::dy, x0::dx]
        if sub.size:
            data += _filter(_pack(sub.reshape(sub.shape[0], -1), depth), bpp, rng)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                             0, 0, int(interlace)))
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b"")


def _palette_image(h, w, bits, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << bits, (h, w)).astype(np.uint8)
    im = Image.fromarray(idx, "P")
    im.putpalette(rng.integers(0, 256, 3 << bits, dtype=np.uint8).tolist())
    return im


def _pil_png_cases():
    grey = smooth(23, 37, 1, 1)[..., 0]
    rgb = smooth(23, 37, 4, 2)
    cases = {
        "L 8-bit": Image.fromarray(grey, "L"),
        "RGB 8-bit (adaptive filters)": Image.fromarray(rgb[..., :3], "RGB"),
        "LA 8-bit": Image.fromarray(rgb[..., :2], "LA"),
        "RGBA 8-bit": Image.fromarray(rgb, "RGBA"),
        "1-bit grey": Image.fromarray(grey, "L").convert("1"),
        "palette 8-bit": _palette_image(23, 37, 8, 3),
        "palette 4-bit": _palette_image(23, 37, 4, 4),
        "palette 2-bit": _palette_image(23, 37, 2, 5),
        "palette 1-bit": _palette_image(23, 37, 1, 6),
    }
    trns = _palette_image(23, 37, 4, 7)
    trns.info["transparency"] = bytes(np.random.default_rng(8).integers(0, 256, 10,
                                                                        dtype=np.uint8))
    cases["palette 4-bit with tRNS"] = trns
    return cases


PIL_PNG = _pil_png_cases()


@pytest.mark.parametrize("name", sorted(PIL_PNG))
def test_png_written_by_pil_equals_tracy_tpu(tmp_path, monkeypatch, name):
    im = PIL_PNG[name]
    path = write(tmp_path, "a.png", pil_bytes(im, format="PNG",
                                              **({"transparency": im.info["transparency"]}
                                                 if "transparency" in im.info else {})))
    ref = jax_load(path)
    got = port_load(path, monkeypatch)
    assert got.dtype == np.float32 and got.shape == ref.shape == (23, 37, 4)
    np.testing.assert_array_equal(got, ref)


def _hand_png_cases():
    rng = np.random.default_rng(9)
    cases = {}
    for depth in (2, 4):
        cases[f"grey {depth}-bit"] = (rng.integers(0, 1 << depth, (23, 37)), depth, 0, False)
    for ctype, depth in ((0, 8), (2, 8), (3, 4), (4, 8), (6, 8), (0, 1)):
        img = rng.integers(0, 1 << depth, (29, 19, CHANNELS[ctype]))
        cases[f"Adam7 type {ctype} {depth}-bit"] = (img, depth, ctype, True)
    cases["Adam7 1x1"] = (rng.integers(0, 256, (1, 1, 3)), 8, 2, True)
    return cases


HAND_PNG = _hand_png_cases()


@pytest.mark.parametrize("name", sorted(HAND_PNG))
def test_png_interlaced_and_sub_byte_equal_tracy_tpu(tmp_path, monkeypatch, name):
    img, depth, ctype, interlace = HAND_PNG[name]
    plte = np.random.default_rng(10).integers(0, 256, 3 << depth,
                                              dtype=np.uint8).tobytes() if ctype == 3 else None
    path = write(tmp_path, "a.png", encode_png(img, depth, ctype, interlace, plte=plte))
    ref = jax_load(path)
    got = port_load(path, monkeypatch)
    assert got.shape == ref.shape == img.shape[:2] + (4,)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
@pytest.mark.parametrize("interlace", [False, True])
def test_png_16_bit_keeps_the_high_byte(tmp_path, monkeypatch, ctype, interlace):
    rng = np.random.default_rng(11 + ctype)
    img = rng.integers(0, 65536, (17, 26, CHANNELS[ctype]))
    if ctype == 0 and not interlace:  # PIL writes 16-bit grey itself
        data = pil_bytes(Image.fromarray(img[..., 0].astype(np.uint16)), format="PNG")
        assert Image.open(io.BytesIO(data)).mode == "I;16"
    else:
        data = encode_png(img, 16, ctype, interlace)
    high = (img >> 8).astype(np.uint8)
    rgba = {0: lambda g: [g[..., 0]] * 3 + [np.full_like(g[..., 0], 255)],
            2: lambda g: [g[..., k] for k in range(3)] + [np.full_like(g[..., 0], 255)],
            4: lambda g: [g[..., 0]] * 3 + [g[..., 1]],
            6: lambda g: [g[..., k] for k in range(4)]}[ctype](high)
    got = port_load(write(tmp_path, "a.png", data), monkeypatch)
    np.testing.assert_array_equal(got, np.stack(rgba, -1).astype(np.float32) / 255.0)
    if ctype != 0:  # PIL keeps the high byte too, except for grey, which it clips
        np.testing.assert_array_equal(got, jax_load(str(tmp_path / "a.png")))


def test_decode_png_gives_the_files_channels():
    rng = np.random.default_rng(12)
    grey = rng.integers(0, 256, (5, 7))
    assert image_io.decode_png(encode_png(grey, 8, 0)).shape == (5, 7, 1)
    assert image_io.decode_png(encode_png(grey, 8, 0, trns=b"\x00\x05")).shape == (5, 7, 2)
    assert image_io.decode_png(encode_png(rng.integers(0, 256, (5, 7, 3)), 8, 2)).shape \
        == (5, 7, 3)
    pal = bytes(range(12))
    got = image_io.decode_png(encode_png(rng.integers(0, 4, (5, 7)), 2, 3, plte=pal))
    assert got.shape == (5, 7, 3)
    with pytest.raises(ValueError, match="bad CRC"):
        data = bytearray(encode_png(grey, 8, 0))
        data[20] ^= 1
        image_io.decode_png(bytes(data))


JPEG_KINDS = {"grey": None, "4:4:4": 0, "4:2:2": 1, "4:2:0": 2}
JPEG_CODINGS = {"baseline": {}, "progressive": {"progressive": True},
                "optimized": {"optimize": True}, "restart": {"restart_marker_blocks": 2}}


def _jpeg(kind, quality, coding, size):
    h, w = size
    if kind == "grey":
        img = Image.fromarray(smooth(h, w, 1, 13)[..., 0], "L")
        return pil_bytes(img, format="JPEG", quality=quality, **JPEG_CODINGS[coding])
    return pil_bytes(Image.fromarray(smooth(h, w, 3, 14)), format="JPEG", quality=quality,
                     subsampling=JPEG_KINDS[kind], **JPEG_CODINGS[coding])


def _hold(got, ref, exact):
    d = np.abs(got.astype(np.float64) - ref)
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        assert d.max() <= 2 / 255 + 1e-7 and d.mean() <= 0.25 / 255


@pytest.mark.parametrize("coding", sorted(JPEG_CODINGS))
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("kind", sorted(JPEG_KINDS))
def test_jpeg_equals_tracy_tpu(tmp_path, monkeypatch, kind, quality, coding):
    size = (23, 37) if quality == 50 else (70, 53)  # odd sizes: partial MCUs
    path = write(tmp_path, "a.jpg", _jpeg(kind, quality, coding, size))
    ref = jax_load(path)
    got = port_load(path, monkeypatch)
    assert got.shape == ref.shape == size + (4,)
    _hold(got, ref, exact=kind in ("grey", "4:4:4"))


def test_jpeg_4_4_0(tmp_path, monkeypatch):
    """4:4:4 luma over 4:4:0 chroma: PIL cannot write it, so a 4:2:2 file's
    luma sampling factors are rewritten from 2x1 to 1x2 (the same entropy
    data, read as blocks stacked in a column; with sides that are multiples
    of 16 both layouts hold the same number of MCUs)."""
    data = bytearray(_jpeg("4:2:2", 90, "baseline", (32, 48)))
    sof = data.index(b"\xff\xc0")
    assert data[sof + 11] == 0x21  # component 1: h 2, v 1
    data[sof + 11] = 0x12
    path = write(tmp_path, "a.jpg", bytes(data))
    ref = jax_load(path)
    got = port_load(path, monkeypatch)
    _hold(got, ref, exact=False)


def _rewrite_sof(data: bytes, marker: int, precision=None) -> bytes:
    out = bytearray(data)
    sof = out.index(b"\xff\xc0")
    out[sof + 1] = marker
    if precision is not None:
        out[sof + 4] = precision
    return bytes(out)


@pytest.mark.parametrize("what,make", [
    ("arithmetic coding", lambda d: _rewrite_sof(d, 0xC9)),
    ("lossless", lambda d: _rewrite_sof(d, 0xC3)),
    ("12-bit", lambda d: _rewrite_sof(d, 0xC0, precision=12)),
])
def test_refused_jpeg_falls_back_by_name(tmp_path, monkeypatch, what, make):
    data = make(_jpeg("4:2:0", 90, "baseline", (16, 16)))
    with pytest.raises(ValueError, match=what):
        image_io.decode_jpeg(data)
    assert port_load(write(tmp_path, "a.jpg", data), monkeypatch) is None


def test_magic_bytes_win_over_the_extension(tmp_path, monkeypatch):
    jpeg = write(tmp_path, "really_a_jpeg.png", _jpeg("4:4:4", 90, "baseline", (9, 11)))
    png = write(tmp_path, "really_a_png.JPG", encode_png(np.arange(99).reshape(9, 11), 8, 0))
    for path in (jpeg, png):
        np.testing.assert_array_equal(port_load(path, monkeypatch), jax_load(path))
    assert port_load(str(tmp_path / "missing.jpg"), monkeypatch) is None
    assert port_load(write(tmp_path, "text.png", b"not an image"), monkeypatch) is None


def test_missing_compiler_raises_instead_of_grey(tmp_path, monkeypatch):
    """With CXX pointing at nothing and no library built, a PNG or JPEG
    load raises, naming the compiler; it never turns into a grey texel."""
    from tracy_tpu_torch.scene import load_scene

    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_image_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    png = write(tmp_path, "t.png", encode_png(np.zeros((2, 2)), 8, 0))
    with pytest.raises(native.ImageDecoderUnavailable, match="no-such-compiler"):
        port_load(png, monkeypatch)
    scn = tmp_path / "t.scn"
    scn.write_text("SCN T\nOUT 8 6\nCAM (0, 0, 3) (0, 0, 0) (0, 1, 0) 45\n"
                   "MTL M (1, 1, 1) 1 0\nTEX M B t.png\nOBJ S (0, 0, 0) 0.5 M\n")
    with pytest.raises(native.ImageDecoderUnavailable):
        load_scene(str(scn))


def test_fixture_2048_jpeg_decodes_in_under_a_second():
    with open(os.path.join(FIXTURES, "basecolor.jpg"), "rb") as f:
        data = f.read()
    image_io.decode_jpeg(data)  # builds the library if needed
    t0 = time.perf_counter()
    img = image_io.decode_jpeg(data)
    secs = time.perf_counter() - t0
    assert img.shape == (2048, 2048, 4)
    assert secs < 1.0, f"{secs:.3f} s"


def test_read_image_and_optimize_cli_take_a_jpeg_target(tmp_path, caplog, monkeypatch):
    """optimize_cli -target .jpg: the default scene rendered with the
    floor's albedo raised from (0.3, 0.3, 0.3) to (0.7, 0.4, 0.2), saved as
    a JPEG, is the target; from the scene's own albedo the loss falls and
    the recovered render moves toward the target."""
    from tracy_tpu_torch.apps import optimize_cli, render_cli

    scn = tmp_path / "red.scn"
    with open(os.path.join(REPO, "data", "scenes", "default.scn")) as f:
        scn.write_text(f.read().replace("MTL Floor (0.3, 0.3, 0.3)", "MTL Floor (0.7, 0.4, 0.2)"))
    small = ["-cpu", "-width", "24", "-height", "18", "-bounces", "2"]
    target_png = str(tmp_path / "target.png")
    assert render_cli.main(small + ["-scene", str(scn), "-frames", "4", "-out",
                                    target_png]) == 0
    shown = image_io.read_image(target_png)[0]
    target = str(tmp_path / "target.jpg")
    Image.fromarray(np.round(shown * 255).astype(np.uint8)).save(target, quality=95,
                                                                  subsampling=0)
    got, linear = image_io.read_image(target)
    assert not linear and got.shape == (18, 24, 3)
    with Image.open(target) as im:  # the same decode as PIL's, 4:4:4
        np.testing.assert_array_equal(got, np.asarray(im.convert("RGB"), np.float32) / 255.0)
    assert np.abs(got - shown).mean() < 0.02

    start = str(tmp_path / "start.npy")
    caplog.set_level(logging.INFO)
    rc = optimize_cli.main(small + ["-target", target, "-params", "albedo", "-steps", "25",
                                    "-spp", "1", "-lr", "0.05", "-out", start])
    assert rc == 0
    losses = [float(x) for x in re.findall(r"step \d+: loss ([0-9.]+)", caplog.text)]
    # Measured: loss 0.0381 -> 0.0259, the recovered render's mean |diff|
    # from the target 0.087 against the start's 0.144 (spp 1 keeps a noise
    # floor under both).
    assert losses[-1] < 0.8 * losses[0]
    rec = np.load(start).astype(np.float32) / 255.0
    base = str(tmp_path / "base.ppm")
    assert render_cli.main(small + ["-frames", "4", "-out", base]) == 0
    before = image_io.read_image(base)[0]
    assert np.abs(rec - got).mean() < 0.75 * np.abs(before - got).mean()
