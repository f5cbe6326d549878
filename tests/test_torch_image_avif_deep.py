"""10- and 12-bit AVIF decoded without PIL (csrc/av1_decode.cpp,
av1_recon.cpp, image_avif.cpp) against tracy_tpu's load_image_rgba, which
opens it through PIL's libavif 1.3 (dav1d decodes).

The corpus is tests/goldens/avif/deep/, written by
tools/make_avif_fixtures.py through OpenCV's libavif 1.4.2 and aom 3.14.1
(the aom inside Pillow's libavif has no high bit depth): 4:2:0, 4:2:2,
4:4:4 lossy and lossless, grey, odd sizes, limited range, tiles, 64-sample
transforms, 128-sample superblocks, Wiener and self-guided restoration (at
10 bits: aom chose neither at 12), screen content (palette, intra block
copy), film grain, alpha (premultiplied too), the matrices libavif
converts in float, and avif10.scn's five maps. Contracts:

* the decoded Y, U, V and alpha planes equal dav1d's, bit for bit (read
  through libavif by ctypes, 16-bit samples);
* the RGBA equals tracy_tpu's float32 RGBA (u8 / 255), bit for bit, on
  each route of libavif's conversion into 8 bits (libyuv after
  Convert16To8Plane into RGB; its high-depth rows into RGBA from 10-bit
  colour and 12-bit 4:2:0; I400 for grey with alpha; libavif's float rows
  at the depth and their unpremultiply; tools/check_avif_colour.py);
* the corpus covers the coding tools it names at each depth.
"""

import os

import numpy as np
import pytest

from test_torch_image_avif import dav1d_image, port_planes
from test_torch_image_decode import port_load, write
from tracy_tpu.scene.textures import load_image_rgba as jax_load
from tracy_tpu_torch.utils import image_io

DEEP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "avif", "deep")
CORPUS = sorted(n for n in os.listdir(DEEP) if n.endswith(".avif") and n != "big10.avif")
TOOLS = ("palette", "intrabc", "filter_intra", "cfl", "cdef", "wiener", "sgrproj", "qm",
         "delta_q", "delta_lf", "lossless", "tx64", "sb128", "tiles", "segments", "var_tx",
         "idtx_1d", "flipadst", "deblock")


def deep(name) -> bytes:
    with open(os.path.join(DEEP, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", CORPUS)
def test_planes_equal_dav1d(name):
    data = deep(name)
    depth, ref, ref_alpha = dav1d_image(data)
    got, got_alpha, _ = port_planes(data)
    assert depth in (8, 10, 12) and len(got) == len(ref)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    assert (ref_alpha is None) == (got_alpha is None)
    if ref_alpha is not None:
        np.testing.assert_array_equal(got_alpha, ref_alpha)


@pytest.mark.parametrize("name", CORPUS)
def test_rgba_equals_tracy_tpu(tmp_path, name):
    data = deep(name)
    ref = jax_load(write(tmp_path, name, data))
    assert ref is not None
    np.testing.assert_array_equal(image_io.decode_image_rgba(data).astype(np.float32) / 255.0,
                                  ref)


# What the corpus must exercise at each depth (what aom chose at its settings).
EXPECTED_TOOLS = {
    10: {"palette", "intrabc", "filter_intra", "cfl", "cdef", "wiener", "sgrproj", "qm",
         "delta_q", "lossless", "tx64", "sb128", "tiles", "idtx_1d", "deblock"},
    12: {"palette", "intrabc", "filter_intra", "cfl", "cdef", "qm", "delta_q", "lossless",
         "tx64", "sb128", "tiles", "deblock"},
}


def test_corpus_covers_the_coding_tools():
    """Each depth's files use the tools named for it; 12 bits lack loop
    restoration (aom chose none in 48 settings; ROADMAP, queue 3)."""
    seen = {8: set(), 10: set(), 12: set()}
    for name in CORPUS:
        data = deep(name)
        depth = dav1d_image(data)[0]
        bits = port_planes(data)[2]
        seen[depth] |= {t for k, t in enumerate(TOOLS) if bits >> k & 1}
    for depth, want in EXPECTED_TOOLS.items():
        assert want <= seen[depth], (depth, want - seen[depth])


def test_deep_map_loads_in_both_packages(tmp_path, monkeypatch):
    """A 12-bit texture through each package's loader (the port with PIL
    blocked): the same texels."""
    path = write(tmp_path, "n.avif", deep("normal.avif"))
    np.testing.assert_array_equal(port_load(path, monkeypatch), jax_load(path))
