"""JPEG's four-component kinds (CMYK, Adobe-inverted CMYK, YCCK) and
sampling factors beyond 2 (4:1:1) decoded without PIL
(csrc/image_decode.cpp) against PIL's open(...).convert("RGBA"), which
tracy_tpu's texture loader runs (libjpeg-turbo under PIL 12.1).

Four-component files are written by PIL (its CMYK writer adds an Adobe
marker with transform 0); the marker is cut out for plain CMYK, and its
transform byte set to 2 (or 1) for YCCK, which leaves a valid stream whose
entropy data means YCCK. 4:1:1 files come from OpenCV and are committed
(tests/goldens/containers/, tools/make_container_fixtures.py), so that the
tests need no cv2. Contracts:

* Equal to PIL bit for bit (uint8 RGBA): CMYK with and without the Adobe
  marker (PIL inverts both: its "CMYK;I" rawmode), YCCK at transforms 2
  and 1 (libjpeg takes any transform but 0 as YCCK), baseline, progressive
  and with restart intervals, subsampled, at odd sizes; OpenCV's 4:1:1
  files (int_upsample's replication, the fancy filters elsewhere).
* Pillow's cmyk2rgb for every (c, k) pair, through the decoder: a JPEG of
  flat 8x8 tiles at quality 100 decodes exactly, so its tiles cover every
  pair.
* A non-integral sampling ratio is refused by name in both packages; a
  file cut before its EOI falls back in both (PIL calls it truncated).
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

from test_torch_image_decode import REPO, pil_bytes, port_load, smooth, write
from tracy_tpu.scene.textures import load_image_rgba as jax_load
from tracy_tpu_torch.utils import image_io

CONTAINERS = os.path.join(REPO, "tests", "goldens", "containers")
OPENCV_411 = ("411_37x53.jpg", "411_37x53_progressive.jpg", "411_29x61_restart.jpg",
              "411_70x9_progressive_restart.jpg", "normal_411.jpg")


def pil_rgba(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def read(name: str) -> bytes:
    with open(os.path.join(CONTAINERS, name), "rb") as f:
        return f.read()


def adobe_at(data: bytes) -> int:
    """Offset of the Adobe APP14 marker's transform byte."""
    at = data.index(b"\xff\xee")
    assert data[at + 4:at + 9] == b"Adobe"
    return at + 4 + 11


def variant(data: bytes, kind: str) -> bytes:
    """PIL's Adobe CMYK file as `kind`: adobe (as written), plain (the
    marker cut out), ycck (transform 2), transform1."""
    at = adobe_at(data)
    if kind == "adobe":
        return data
    if kind == "plain":
        start = data.index(b"\xff\xee")
        return data[:start] + data[start + 2 + int.from_bytes(data[start + 2:start + 4], "big"):]
    return data[:at] + bytes([{"ycck": 2, "transform1": 1}[kind]]) + data[at + 1:]


CODINGS = {"baseline": {}, "progressive": {"progressive": True},
           "restart": {"restart_marker_blocks": 3}, "subsampled": {"subsampling": 2}}


@pytest.mark.parametrize("size", [(48, 64), (37, 53)])
@pytest.mark.parametrize("coding", sorted(CODINGS))
@pytest.mark.parametrize("kind", ["adobe", "plain", "ycck", "transform1"])
def test_four_components_equal_pil(kind, coding, size):
    img = Image.fromarray(smooth(*size, 4, 41), "CMYK")
    data = variant(pil_bytes(img, format="JPEG", quality=85, **CODINGS[coding]), kind)
    np.testing.assert_array_equal(image_io.decode_image_rgba(data), pil_rgba(data))


def test_plain_and_adobe_cmyk_read_alike():
    """PIL inverts CMYK with or without the Adobe marker, so cutting the
    marker changes nothing; YCCK reads differently from the same data."""
    data = pil_bytes(Image.fromarray(smooth(16, 16, 4, 42), "CMYK"), format="JPEG")
    adobe = image_io.decode_image_rgba(data)
    np.testing.assert_array_equal(image_io.decode_image_rgba(variant(data, "plain")), adobe)
    assert not np.array_equal(image_io.decode_image_rgba(variant(data, "ycck")), adobe)


@pytest.mark.parametrize("name", OPENCV_411)
def test_opencv_411_equals_pil(name):
    data = read(name)
    sof = max(data.find(b"\xff\xc0"), data.find(b"\xff\xc2"))
    assert data[sof + 11] == 0x41  # component 1: h 4, v 1
    np.testing.assert_array_equal(image_io.decode_image_rgba(data), pil_rgba(data))


def test_fixture_ycck_and_big_cmyk_equal_pil():
    for name in ("ycck.jpg", "big_cmyk.jpg", "basecolor.jpg"):
        data = read(name)
        np.testing.assert_array_equal(image_io.decode_image_rgba(data), pil_rgba(data), name)


def test_cmyk_to_rgb_for_every_c_k_pair():
    """Pillow's cmyk2rgb through the decoder: 256 x 86 flat 8x8 tiles, each
    of one K and three of the 256 C values in C, M and Y, at quality 100
    (all-ones quantisation, so flat tiles decode exactly) cover every
    (c, k) pair of what PIL hands cmyk2rgb."""
    k = np.repeat(np.arange(256), 8)[:, None] * np.ones((1, 86 * 8), int)
    c = np.repeat(np.arange(86 * 3).reshape(86, 3) % 256, 8, axis=0)[None] * np.ones((2048, 1, 1),
                                                                                   int)
    tiles = np.concatenate([c, k[..., None]], -1).astype(np.uint8)
    data = pil_bytes(Image.fromarray(tiles, "CMYK"), format="JPEG", quality=100, subsampling=0)
    im = Image.open(io.BytesIO(data))
    seen = np.asarray(im)  # what cmyk2rgb is given, after PIL's inversion
    pairs = {(int(v), int(kk)) for ch in range(3)
             for v, kk in zip(seen[::8, ::8, ch].ravel(), seen[::8, ::8, 3].ravel())}
    assert len(pairs) == 256 * 256
    np.testing.assert_array_equal(image_io.decode_image_rgba(data),
                                  np.asarray(im.convert("RGBA")))


def test_non_integral_sampling_ratio_is_refused_by_name(tmp_path, monkeypatch):
    """Luma at 3x2 over chroma at 2x1: libjpeg's "fractional sampling"
    refusal, by name in the port, and PIL fails too."""
    data = bytearray(pil_bytes(Image.fromarray(smooth(32, 32, 3, 43)), format="JPEG",
                               subsampling="4:2:0"))
    sof = data.index(b"\xff\xc0")
    data[sof + 11], data[sof + 14] = 0x32, 0x21
    with pytest.raises(ValueError, match="non-integral sampling ratio"):
        image_io.decode_image_rgba(bytes(data))
    path = write(tmp_path, "a.jpg", bytes(data))
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


@pytest.mark.parametrize("cut", [2, 200])
def test_cut_file_falls_back_in_both_packages(tmp_path, monkeypatch, cut):
    """A CMYK file without its last `cut` bytes (EOI and, at 200, some of
    the entropy data): PIL calls it truncated, and so does the port."""
    data = pil_bytes(Image.fromarray(smooth(40, 40, 4, 44), "CMYK"), format="JPEG")[:-cut]
    with pytest.raises(ValueError, match="truncated"):
        image_io.decode_image_rgba(data)
    path = write(tmp_path, "a.jpg", data)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


@pytest.mark.parametrize("name", ["basecolor.jpg", "411_29x61_restart.jpg"])
def test_texture_loaders_agree(tmp_path, monkeypatch, name):
    path = os.path.join(CONTAINERS, name)
    np.testing.assert_array_equal(port_load(path, monkeypatch), jax_load(path))
