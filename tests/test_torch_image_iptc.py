"""IPTC/NAA images whose embedded stream is of any format PIL opens, through
the port (utils/image_io.py::_iptc_rgba) against PIL and tracy_tpu's
load_image_rgba:

* a band field (3, 65) of 0 fills the last band, as PIL indexes it (the
  port once read it as the whole picture);
* a picture of a mode whose core conversion to RGBA Pillow lacks falls
  back in both packages, named (the port's set equals Pillow's here);
* a picture loses the stream's info["transparency"] (PNG's tRNS, GIF's
  transparent index), as in PIL;
* `_pil_mode` equals Image.open(...).mode for every format, over the other
  image tests' corpora and headers rewritten for the modes they lack;
* ICNS and Photo CD pictures; a nested IPTC image's palette picture in a
  band, and a stream's own hazards inside IPTC (ROADMAP, hazards).
"""

import io
import re

import numpy as np
import pytest
from PIL import Image

import test_torch_image_avif as avif_tests
import test_torch_image_containers as container_tests
import test_torch_image_dds as dds_tests
import test_torch_image_formats as format_tests
import test_torch_image_jpeg2000 as jpeg2000_tests
import test_torch_image_legacy as legacy_tests
import test_torch_image_legacy_kinds as kind_tests
import test_torch_image_tiff as tiff_tests
import test_torch_image_webp as webp_tests
from test_torch_image_decode import pil_bytes, port_load, smooth, write
from test_torch_image_legacy_kinds import iptc, pcd, pcd_sample
from tracy_tpu.scene.textures import load_image_rgba as jax_load
from tracy_tpu_torch.utils import image_io

GREY = smooth(13, 19, 1, 90)[..., 0]
RGB = smooth(13, 19, 3, 91)


def both_load_equal(tmp_path, monkeypatch, data):
    """The IPTC file through both packages' load_image_rgba: equal float32
    arrays; returns the port's."""
    path = write(tmp_path, "a.iim", data)
    ref = jax_load(path)
    assert ref is not None
    got = port_load(path, monkeypatch)
    np.testing.assert_array_equal(got, ref)
    return got


# --- repair: a band field of 0

STREAMS = {"PNG": (pil_bytes(Image.fromarray(GREY), format="PNG"), 5),
           "JPEG": (pil_bytes(Image.fromarray(GREY), format="JPEG", quality=90), 5),
           "raw": (GREY.tobytes(), 1)}


@pytest.mark.parametrize("layers", [3, 4])
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_band_field_0_fills_the_last_band(tmp_path, monkeypatch, stream, layers):
    """PIL's band is the field less 1: a field of 0 is band -1, the last
    one (B of RGB, K of CMYK), not the whole picture."""
    data, compression = STREAMS[stream]
    got = both_load_equal(tmp_path, monkeypatch, iptc(19, 13, data, layers, 1, 0, compression))
    grey = image_io.decode_image_rgba(data if compression == 5 else iptc(19, 13, data))[..., 0]
    if layers == 3:
        want = np.zeros((13, 19, 3))
        want[..., 2] = grey
    else:  # PIL's cmyk2rgb of K alone: 255 - K in every channel
        want = np.repeat(255.0 - grey[..., None], 3, axis=-1)
    np.testing.assert_array_equal(got[..., :3] * 255.0, want)


# --- repair: picture modes PIL cannot convert

def test_unconvertible_modes_are_pillows():
    """The modes whose core conversion to RGBA this Pillow lacks."""
    lacking = set()
    for mode in Image.MODES:
        try:
            Image.new(mode, (1, 1)).im.convert("RGBA")
        except ValueError:
            lacking.add(mode)
    assert lacking == set(image_io.UNCONVERTIBLE_MODES)


def _unconvertible():
    big = (GREY.astype(np.uint16) * 257 + 3)
    return {
        "LAB TIFF": (pil_bytes(Image.fromarray(RGB, "LAB"), format="TIFF"), "LAB"),
        "LAB PSD": (format_tests.psd(RGB.transpose(2, 0, 1), 9), "LAB"),
        "YCbCr IM": (pil_bytes(Image.fromarray(RGB, "YCbCr"), format="IM"), "YCbCr"),
        "I;16L IM": (legacy_tests.im_file("L 16L", 19, 13, big.astype("<u2").tobytes()),
                     "I;16L"),
        "I;16 JP2": (pil_bytes(Image.fromarray(big), format="JPEG2000"), "I;16"),
        "I;16 FITS": (legacy_tests.fits(GREY.astype(np.int64) * 100, 16), "I;16"),
        "I;16B McIdas": (legacy_tests.mcidas(big, 2), "I;16B"),
        "F SPIDER": (legacy_tests.spider(GREY.astype(np.float32) * 0.5), "F"),
    }


UNCONVERTIBLE = _unconvertible()


@pytest.mark.parametrize("name", sorted(UNCONVERTIBLE))
def test_unconvertible_picture_falls_back_in_both_packages(tmp_path, monkeypatch, name):
    stream, mode = UNCONVERTIBLE[name]
    data = iptc(19, 13, stream, compression=5)
    with pytest.raises(ValueError, match=re.escape(f"embedded image of PIL mode {mode} (PIL")):
        image_io.decode_image_rgba(data)
    path = write(tmp_path, "a.iim", data)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


# --- the picture loses info["transparency"]

def _transparent():
    pal = Image.fromarray(RGB).convert("P")
    first = int(np.asarray(pal)[0, 0])
    return {
        "PNG grey with tRNS": pil_bytes(Image.fromarray(GREY), format="PNG",
                                        transparency=int(GREY[0, 0])),
        "PNG RGB with tRNS": pil_bytes(Image.fromarray(RGB), format="PNG",
                                       transparency=tuple(int(v) for v in RGB[0, 0])),
        "PNG palette with tRNS": pil_bytes(pal, format="PNG", transparency=first),
        "GIF transparent index": pil_bytes(pal, format="GIF", transparency=first),
    }


TRANSPARENT = _transparent()


@pytest.mark.parametrize("name", sorted(TRANSPARENT))
def test_picture_is_opaque_without_the_streams_info(tmp_path, monkeypatch, name):
    """The stream alone has transparent pixels; as the IPTC picture PIL
    converts its core image, which does not carry them."""
    stream = TRANSPARENT[name]
    assert (image_io.decode_image_rgba(stream)[..., 3] == 0).any()
    got = both_load_equal(tmp_path, monkeypatch, iptc(19, 13, stream, compression=5))
    assert (got[..., 3] == 1.0).all()


# --- PIL's mode of every format

def _corpus():
    """{kind: [stream, ...]} of the other image tests' files and of headers
    they lack: FITS and McIdas depths, grey and 16-bit JPEG 2000, WebP with
    and without alpha, GIF whose own table is the grey ramp."""
    files = []
    for cases in (format_tests.CASES, container_tests.CASES, dds_tests.CASES, legacy_tests.CASES,
                  kind_tests.CASES, jpeg2000_tests.BOX_CASES, tiff_tests.CASES, webp_tests.CASES):
        files += [v for v in cases.values() if isinstance(v, bytes)]
    files += [jpeg2000_tests.golden(n) for n in jpeg2000_tests.FIXTURES]
    files += [avif_tests.golden(n) for n in avif_tests.CORPUS]
    grey, rgba = GREY, smooth(13, 19, 4, 92)
    files += [legacy_tests.fits(grey.astype(np.int64) * k, bits)
              for k, bits in ((1, 8), (100, 16), (-9000, 32), (1, -32), (1, -64))]
    files += [legacy_tests.mcidas(grey, n) for n in (1, 2, 4)]
    files += [jpeg2000_tests.j2k(img, **kw) for img in (grey, grey.astype(np.uint16) * 200,
                                                        Image.fromarray(rgba[..., :2], "LA"), rgba)
              for kw in ({}, {"no_jp2": True})]
    files += [pil_bytes(Image.fromarray(img), format="WEBP", lossless=lossless)
              for img in (RGB, rgba) for lossless in (True, False)]
    files += [pil_bytes(Image.fromarray(img).convert(mode), format=fmt)
              for img in (RGB,) for mode in ("1", "L", "P", "RGB", "RGBA", "LA", "I;16", "CMYK")
              for fmt in ("PNG", "JPEG") if (fmt, mode) not in (("PNG", "CMYK"), ("JPEG", "1"),
                                                               ("JPEG", "P"), ("JPEG", "RGBA"),
                                                               ("JPEG", "LA"), ("JPEG", "I;16"))]
    files.append(pcd(*pcd_sample(96)))
    ramp = [(k, k, k) for k in range(4)]
    files.append(format_tests.gif((19, 13), [dict(idx=legacy_tests.runs(93, 13, 19, high=4),
                                                  min_bits=2, pal=ramp)],
                                  global_pal=[(9, 200, 3)] * 4))
    out = {}
    for data in files:
        out.setdefault(image_io.image_format(data), []).append(data)
    return out


CORPUS = _corpus()


@pytest.mark.parametrize("kind", image_io.IPTC_STREAMS)
def test_pil_mode_equals_pils(kind):
    modes = set()
    for data in CORPUS[kind]:
        try:
            want = Image.open(io.BytesIO(data)).mode
        except Exception:
            continue  # PIL cannot open it: no mode to hold
        assert image_io._pil_mode(kind, data) == want
        modes.add(want)
    assert modes


# --- pictures of fixed sizes, and a hazard

def test_icns_picture_loads_in_both_packages(tmp_path, monkeypatch):
    stream = pil_bytes(Image.fromarray(smooth(32, 32, 4, 94)), format="ICNS")
    both_load_equal(tmp_path, monkeypatch, iptc(32, 32, stream, compression=5))


def test_pcd_picture_loads_in_both_packages(tmp_path, monkeypatch):
    both_load_equal(tmp_path, monkeypatch, iptc(768, 512, pcd(*pcd_sample(95)), compression=5))


@pytest.mark.parametrize("band", [2, 0])
def test_nested_palette_picture_in_a_band_is_refused_by_name(tmp_path, monkeypatch, band):
    """A nested IPTC image is mode L to Image.merge whatever its picture,
    and merge then copies that picture's raw samples into any band: a
    palette's indices. PIL loses the picture; the port refuses it by name
    (ROADMAP, hazards)."""
    inner = iptc(19, 13, pil_bytes(Image.fromarray(RGB).convert("P"), format="PNG"),
                 compression=5)
    data = iptc(19, 13, inner, 3, 1, band, compression=5)
    with pytest.raises(ValueError, match=re.escape("PIL mode L (its loaded image P)")):
        image_io.decode_image_rgba(data)
    path = write(tmp_path, "a.iim", data)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is not None


def test_a_streams_hazard_holds_inside_iptc(tmp_path, monkeypatch):
    """A deep FITS picture reads as the format says inside IPTC as alone
    (big-endian samples, clipped), where PIL reads them otherwise."""
    stream = legacy_tests.fits(GREY.astype(np.int64) * 3 - 100, 32)
    data = iptc(19, 13, stream, compression=5)
    np.testing.assert_array_equal(image_io.decode_image_rgba(data),
                                  image_io.decode_image_rgba(stream))
    ref = jax_load(write(tmp_path, "a.iim", data))
    assert ref is not None
    assert not np.array_equal(port_load(write(tmp_path, "b.iim", data), monkeypatch), ref)


def test_nesting_beyond_the_recursion_limit_falls_back_in_both_packages(tmp_path, monkeypatch):
    """PIL opens each nested stream in turn until Python's recursion limit
    stops it; the port's decode fails there too, as a refused file, not as
    a failure of the decoder."""
    data = iptc(4, 4, bytes(16))
    for _ in range(1500):
        data = iptc(4, 4, data, compression=5)
    with pytest.raises(ValueError, match="recursion limit"):
        image_io.decode_image_rgba(data)
    path = write(tmp_path, "a.iim", data)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None
