"""DDS (csrc/image_blocks.cpp) and QOI (csrc/image_formats.cpp) decoding
without PIL against tracy_tpu's, which decodes every 8-bit texture through
PIL.

Each file is made from seeded numpy bytes by the DDS writer below (random
blocks reach modes, partitions and edge cases that no encoder writes) or
by PIL, then loaded by tracy_tpu's `load_image_rgba` and by the port's
with PIL blocked in sys.modules. Contracts:

* Equal bit for bit (float32 RGBA, u8 / 255): random blocks of BC1-BC7
  (BC6H UF16 and SF16; BC7's eight modes and its reserved mode), at least
  64 a file and at sizes that cut the last blocks; the legacy FourCCs;
  uncompressed layouts with bit masks, grey, grey + alpha, palette and
  DX10 R8G8B8A8; a file with mipmaps and a cube map (its first surface).
* Where PIL refuses a block format (DXGI BC1-BC3 SRGB, BC4 SNORM and the
  BC4S FourCC; ROADMAP, hazards), the port reads it as its UNORM form.
* QOI: RGB and RGBA files that use all six ops, written by PIL and by
  hand, equal to PIL's.
* Refused kinds raise ValueError naming them and fall back in both
  packages; truncated
  files fall back in both packages; refused and truncated maps of a scene
  are listed in builder.fallbacks; a decoder library that cannot be built
  raises. A 2048x2048 BC7 DDS and a 2048x2048 QOI each decode in under a
  second.
"""

import io
import struct
import time

import numpy as np
import pytest
from PIL import Image

from test_torch_image_decode import pil_bytes, port_load, write
from test_torch_image_tiff import tiff
from tracy_tpu.scene.textures import load_image_rgba as jax_load
from tracy_tpu_torch.utils import image_io, native

# DXGI format numbers (dxgiformat.h).
DXGI = {"R8G8B8A8": 28, "BC1": 71, "BC1 TYPELESS": 70, "BC1 SRGB": 72, "BC2": 74,
        "BC2 TYPELESS": 73, "BC2 SRGB": 75, "BC3": 77, "BC3 TYPELESS": 76, "BC3 SRGB": 78,
        "BC4": 80, "BC4 TYPELESS": 79, "BC4 SNORM": 81, "BC5": 83, "BC5 TYPELESS": 82,
        "BC5 SNORM": 84, "BC6H TYPELESS": 94, "BC6H UF16": 95, "BC6H SF16": 96,
        "BC7 TYPELESS": 97, "BC7": 98, "BC7 SRGB": 99}


def dds(w, h, data, fourcc=None, dxgi=None, flags=0x4, bitcount=0, masks=(0, 0, 0, 0),
        mipmaps=0, caps2=0, palette=b""):
    """A DDS file: the 124-byte header (a FourCC, or DX10 and its 20-byte
    header when dxgi is given; else `flags` with bitcount and masks), a
    palette, then data."""
    pf = struct.pack("<II4sI4I", 32, flags, b"DX10" if dxgi is not None else (fourcc or bytes(4)),
                     bitcount, *masks)
    head = (struct.pack("<7I", 124, 0x1007 | (0x20000 if mipmaps else 0), h, w, 0, 0, mipmaps)
            + bytes(44) + pf + struct.pack("<5I", 0x1000, caps2, 0, 0, 0))
    dx10 = struct.pack("<5I", dxgi, 3, 0, 1, 0) if dxgi is not None else b""
    return b"DDS " + head + dx10 + palette + data


# 38x26 pixels: 10x7 = 70 blocks, the last column and row cut.
BW, BH = 38, 26
NBLOCKS = ((BW + 3) // 4) * ((BH + 3) // 4)


def blocks(rng, fmt):
    """NBLOCKS random blocks of fmt; BC6H's first five bits cycle through
    all 32 mode codes, BC7's first byte through its eight modes and the
    reserved 0."""
    size = 8 if fmt.split()[0] in ("BC1", "BC4") else 16
    b = rng.integers(0, 256, (NBLOCKS, size)).astype(np.uint8)
    if fmt.startswith("BC6H"):
        b[:, 0] = (b[:, 0] & 0xE0) | np.arange(NBLOCKS) % 32
    if fmt.startswith("BC7"):
        mode = np.arange(NBLOCKS) % 9
        b[:, 0] = np.where(mode < 8, (b[:, 0] | 1) << np.minimum(mode, 7), 0).astype(np.uint8)
    return b.tobytes()


def _block_cases(rng):
    out = {}
    for name in ("BC1", "BC1 TYPELESS", "BC2", "BC2 TYPELESS", "BC3", "BC3 TYPELESS", "BC4",
                 "BC4 TYPELESS", "BC5", "BC5 TYPELESS", "BC5 SNORM", "BC6H UF16", "BC6H SF16",
                 "BC7", "BC7 TYPELESS", "BC7 SRGB"):
        out[f"DX10 {name}"] = dds(BW, BH, blocks(rng, name), dxgi=DXGI[name])
    for cc, fmt in ((b"DXT1", "BC1"), (b"DXT3", "BC2"), (b"DXT5", "BC3"), (b"ATI1", "BC4"),
                    (b"BC4U", "BC4"), (b"ATI2", "BC5"), (b"BC5U", "BC5"), (b"BC5S", "BC5")):
        out[f"FourCC {cc.decode()}"] = dds(BW, BH, blocks(rng, fmt), fourcc=cc)
    return out


def _raw_cases(rng):
    out = {}
    for bits, masks, flags, name in (
            (16, (0xF800, 0x7E0, 0x1F, 0), 0x40, "RGB 5-6-5"),
            (16, (0x7C00, 0x3E0, 0x1F, 0x8000), 0x41, "RGBA 5-5-5-1"),
            (16, (0xF00, 0xF0, 0xF, 0xF000), 0x41, "RGBA 4-4-4-4"),
            (24, (0xFF0000, 0xFF00, 0xFF, 0), 0x40, "BGR 24-bit"),
            (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000), 0x41, "RGBA 32-bit"),
            (32, (0xFF0000, 0xFF00, 0xFF, 0), 0x40, "BGRX 32-bit"),
            (32, (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000), 0x41, "RGBA 10-10-10-2"),
            (32, (0xFF0000, 0xFF00, 0xFF, 0), 0x41, "alpha flag without a mask")):
        data = rng.integers(0, 256, BW * BH * bits // 8).astype(np.uint8).tobytes()
        out[f"masks {name}"] = dds(BW, BH, data, flags=flags, bitcount=bits, masks=masks)
    u8 = lambda n: rng.integers(0, 256, n).astype(np.uint8).tobytes()  # noqa: E731
    out["luminance 8-bit"] = dds(BW, BH, u8(BW * BH), flags=0x20000, bitcount=8)
    out["luminance + alpha 16-bit"] = dds(BW, BH, u8(2 * BW * BH), flags=0x20001, bitcount=16)
    out["palette 8-bit"] = dds(BW, BH, u8(BW * BH), flags=0x20, bitcount=8, palette=u8(1024))
    out["DX10 R8G8B8A8"] = dds(BW, BH, u8(4 * BW * BH), dxgi=DXGI["R8G8B8A8"])
    # Mipmaps 16, 8, 4, 2, 1 of six faces: the first surface is the top
    # level of the first face.
    faces = b"".join(blocks(rng, "BC3")[:16 * k] for k in (16, 4, 1, 1, 1)) * 6
    out["mipmaps and a cube map"] = dds(16, 16, faces, fourcc=b"DXT5", mipmaps=5, caps2=0xFE00)
    img = np.stack(np.mgrid[0:BH, 0:BW], -1).repeat(2, -1)[..., :3] * 6
    img = np.concatenate([img, 255 - img[..., :1]], -1).astype(np.uint8)
    for fmt in ("DXT1", "DXT3", "DXT5", "BC2", "BC3"):
        out[f"{fmt} written by PIL"] = pil_bytes(Image.fromarray(img), format="DDS",
                                                 pixel_format=fmt)
    out["BC5 written by PIL"] = pil_bytes(Image.fromarray(img[..., :3]), format="DDS",
                                          pixel_format="BC5")
    out["RGBA written by PIL"] = pil_bytes(Image.fromarray(img), format="DDS")
    return out


def qoi_ops(channels):
    """A hand-made QOI stream that uses every op: RGB, RGBA (in an RGB file
    too), INDEX (of a slot never written: 0, 0, 0, 0), DIFF, LUMA, and RUN,
    the last one passing the end of the image."""
    ops = bytearray()
    ops += bytes([0xFE, 10, 200, 30])                      # RGB
    ops += bytes([0xFF, 1, 2, 3, 77])                      # RGBA
    ops += bytes([0x40 | (3 << 4) | (0 << 2) | 1])         # DIFF +1, -2, -1
    ops += bytes([0x80 | 40, (3 << 4) | 12])               # LUMA dg +8
    ops += bytes([0xC0 | 5])                               # RUN 6
    ops += bytes([0x00 | 53])                              # INDEX (never written)
    ops += bytes([0xFE, 10, 200, 30])                      # RGB again
    ops += bytes([0x00 | ((10 * 3 + 200 * 5 + 30 * 7 + 77 * 11) % 64)])  # INDEX, seen
    for k in range(40):
        ops += bytes([0x40 | (k % 64)]) if k % 3 else bytes([0x80 | (k % 64), k * 7 % 256])
    ops += bytes([0xC0 | 61])                              # RUN 62, past the end
    w, h = 9, 8
    return b"qoif" + struct.pack(">IIBB", w, h, channels, 0) + bytes(ops) + bytes(7) + b"\1"


def _qoi_cases(rng):
    y, x = np.mgrid[0:40, 0:57]
    img = np.stack([(x * 3) % 256, (y * 5) % 256, ((x + y) // 3) % 256, (x // 9) * 40 % 256],
                   -1).astype(np.uint8)
    img[5:9, 10:30] = rng.integers(0, 256, (4, 20, 4))            # RGB/RGBA ops
    img[20:22] += rng.integers(0, 3, (2, 57, 4)).astype(np.uint8)  # DIFF
    img[30:33] += rng.integers(0, 20, (3, 57, 1)).astype(np.uint8)  # LUMA
    img[34:36, 5:15] = img[5:7, 10:20]                              # INDEX
    out = {}
    for mode in ("RGB", "RGBA"):
        out[f"QOI {mode} written by PIL"] = pil_bytes(Image.fromarray(img[..., :len(mode)], mode),
                                                      format="QOI")
        out[f"QOI {mode} every op by hand"] = qoi_ops(len(mode))
    return out


def _cases():
    rng = np.random.default_rng(2028)
    return {**_block_cases(rng), **_raw_cases(rng), **_qoi_cases(rng)}


CASES = _cases()


def suffix(name):
    return ".qoi" if name.startswith("QOI") else ".dds"


@pytest.mark.parametrize("name", sorted(CASES))
def test_dds_and_qoi_equal_tracy_tpu(tmp_path, monkeypatch, name):
    path = write(tmp_path, "map" + suffix(name), CASES[name])
    ref = jax_load(path)
    got = port_load(path, monkeypatch)
    assert ref is not None and got is not None
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert float(got.std()) > 0.0


# --- hazards: block formats PIL refuses are read as their UNORM forms

UNORM_OF = {"BC1 SRGB": "BC1", "BC2 SRGB": "BC2", "BC3 SRGB": "BC3"}


@pytest.mark.parametrize("name", sorted(UNORM_OF) + ["BC4 SNORM", "BC4S FourCC"])
def test_block_formats_pil_refuses(tmp_path, monkeypatch, name):
    """PIL raises NotImplementedError on these (tracy_tpu turns them grey);
    the port reads them as the format says: the SRGB forms as UNORM (the
    scene's SRGB flag, not the file, says how a map is linearised), signed
    BC4 as PIL reads each channel of signed BC5."""
    rng = np.random.default_rng(8)
    data = blocks(rng, "BC4" if "BC4" in name else name)
    path = write(tmp_path, "a.dds", dds(BW, BH, data, fourcc=b"BC4S") if name == "BC4S FourCC"
                 else dds(BW, BH, data, dxgi=DXGI[name]))
    got = port_load(path, monkeypatch)
    if "BC4" in name:
        # Signed BC4 is signed BC5's red channel, as grey.
        bc5 = np.frombuffer(data, np.uint8).reshape(-1, 8)
        bc5 = np.concatenate([bc5, bc5], 1).tobytes()
        red = port_load(write(tmp_path, "b.dds", dds(BW, BH, bc5, dxgi=DXGI["BC5 SNORM"])),
                        monkeypatch)
        want = np.concatenate([red[..., :1].repeat(3, -1), np.ones_like(red[..., :1])], -1)
    else:
        want = jax_load(write(tmp_path, "b.dds", dds(BW, BH, data, dxgi=DXGI[UNORM_OF[name]])))
    np.testing.assert_array_equal(got, want)
    assert jax_load(path) is None


# --- refusals, truncation, fallbacks, the library, speed

REFUSED = {
    "DXT2": (dds(4, 4, bytes(16), fourcc=b"DXT2"), "FourCC 'DXT2'"),
    "DXT4": (dds(4, 4, bytes(16), fourcc=b"DXT4"), "FourCC 'DXT4'"),
    "BC6H TYPELESS": (dds(4, 4, bytes(16), dxgi=94), "BC6H TYPELESS"),
    "float RGBA": (dds(4, 4, bytes(256), dxgi=2), "DXGI format 2"),
    "alpha only": (dds(4, 4, bytes(16), flags=0x2, bitcount=8), "pixel format flags 2"),
    "16-bit luminance": (dds(4, 4, bytes(32), flags=0x20000, bitcount=16), "luminance"),
    "header size": (b"DDS " + struct.pack("<I", 100) + bytes(200), "header size 100"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_dds_falls_back_by_name(tmp_path, monkeypatch, name):
    data, what = REFUSED[name]
    with pytest.raises(ValueError, match=what):
        image_io.decode_image_rgba(data)
    path = write(tmp_path, "a.dds", data)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None  # grey in tracy_tpu too


TRUNCATED = ["DX10 BC7", "FourCC DXT5", "DX10 BC6H SF16", "QOI RGBA written by PIL",
             "luminance 8-bit"]


@pytest.mark.parametrize("name", TRUNCATED)
def test_truncated_file_falls_back_in_both_packages(tmp_path, monkeypatch, name):
    data = CASES[name]
    cut = data[:len(data) * 2 // 3]
    path = write(tmp_path, "a" + suffix(name), cut)
    with pytest.raises(ValueError, match="truncated"):
        image_io.decode_image_rgba(cut)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


def test_refused_and_truncated_maps_are_listed_as_fallbacks(tmp_path):
    from tracy_tpu_torch.scene import load_scene

    files = {"a.tif": tiff(np.zeros((4, 6)), compression=7),
             "b.tif": tiff(np.zeros((4, 6), np.uint8), compression=5, ifd_first=True)[:-12],
             "c.dds": REFUSED["DXT2"][0],
             "d.dds": CASES["DX10 BC7"][:400],
             "e.qoi": CASES["QOI RGB written by PIL"][:300]}
    for name, data in files.items():
        write(tmp_path, name, data)
    lines = [f"TEX M {slot} {name}" for slot, name in zip("BNRME", files)]
    scn = tmp_path / "t.scn"
    scn.write_text("SCN T\nOUT 8 6\nCAM (0, 0, 3) (0, 0, 0) (0, 1, 0) 45\n"
                   "MTL M (1, 1, 1) 1 0\n" + "\n".join(lines) + "\nOBJ S (0, 0, 0) 0.5 M\n")
    b = load_scene(str(scn))
    assert sorted(b.fallbacks) == sorted(f"texture {n}" for n in files)
    assert all(p.shape == (1, 1, 4) and np.all(p[..., :3] == 0.5) for p in b.atlas.pixels)


@pytest.mark.parametrize("name", ["DX10 BC7", "QOI RGB written by PIL"])
def test_missing_compiler_raises_instead_of_grey(tmp_path, monkeypatch, name):
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_image_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    path = write(tmp_path, "a" + suffix(name), CASES[name])
    with pytest.raises(native.ImageDecoderUnavailable, match="no-such-compiler"):
        port_load(path, monkeypatch)


def _big(fmt):
    rng = np.random.default_rng(9)
    if fmt == "BC7":
        b = rng.integers(0, 256, (512 * 512, 16)).astype(np.uint8)
        b[:, 0] = ((b[:, 0] | 1) << rng.integers(0, 8, len(b))).astype(np.uint8)
        return dds(2048, 2048, b.tobytes(), dxgi=DXGI["BC7"]), None
    # QOI: a QOI_OP_RGBA for every pixel (PIL's QOI writer is Python and
    # slow at this size), a valid stream that no op shortens.
    img = rng.integers(0, 256, (2048, 2048, 4)).astype(np.uint8)
    ops = np.concatenate([np.full((2048 * 2048, 1), 0xFF, np.uint8), img.reshape(-1, 4)], 1)
    return b"qoif" + struct.pack(">IIBB", 2048, 2048, 4, 0) + ops.tobytes() + bytes(7) + b"\1", img


@pytest.mark.parametrize("fmt", ["BC7", "QOI"])
def test_2048_map_decodes_in_under_a_second(fmt):
    data, img = _big(fmt)
    image_io.decode_image_rgba(data)  # builds the library if needed
    t0 = time.perf_counter()
    got = image_io.decode_image_rgba(data)
    secs = time.perf_counter() - t0
    assert got.shape == (2048, 2048, 4)
    if img is not None:
        np.testing.assert_array_equal(got, img)
    assert secs < 1.0, f"{secs:.3f} s"


@pytest.mark.parametrize("name", ["DX10 BC7", "QOI RGBA written by PIL"])
def test_read_image_takes_dds_and_qoi(tmp_path, name):
    """read_image (optimize_cli -target) reads DDS and QOI by content as
    tracy_tpu's optimize_cli does: PIL's convert("RGB") / 255."""
    path = write(tmp_path, "target.bin", CASES[name])
    with Image.open(io.BytesIO(CASES[name])) as im:
        shown = np.asarray(im.convert("RGB"), np.float32) / 255.0
    got, linear = image_io.read_image(path)
    assert not linear
    np.testing.assert_array_equal(got, shown)
