"""Make the AVIF texture fixtures of tests/goldens/avif/.

    cd tools && JAX_PLATFORMS=cpu python make_avif_fixtures.py

Writes, from seed 9191, five maps laid out as helmet.scn's (B and E sRGB,
N, R, M), each an AVIF kind that tracy_tpu reads through PIL's libavif
(dav1d decodes, aom encoded) and the port decodes without it
(csrc/image_avif.cpp, av1_decode.cpp, av1_recon.cpp):

- basecolor.avif: 256x256 4:2:0 at PIL's defaults (speed 6, quality 75);
- normal.avif: 256x256 4:4:4 in 2x2 tiles, CDEF and loop restoration;
- roughness.avif: 192x256 flat text-like content: palette and intra block
  copy (screen content tools);
- metalness.avif: 128x128 with quantizer matrices and delta q;
- emissive.avif: 128x128 RGBA with an alpha item;

then avif.scn, which uses them on a sphere and a box over an untextured
floor, and avif.npz: tracy_tpu's render of that scene on the CPU
(tools/make_texture_fixtures.py's settings: accel 'bvh', rng 'fast',
256x192, 24 frames of 1 spp). Besides, big.avif: a 2048x2048 map (4:2:0,
quality 75) of a smooth pattern with fine grain, which chip_smoke.py decodes and times on
the card's host; and the small files of `kinds` (PIL's writer at other
settings, film grain and a two-frame sequence included, and through
Pillow's bundled libavif by ctypes what PIL's writer cannot make: grids,
other matrices and ranges, limited-range grey), which
tests/test_torch_image_avif.py holds against PIL and dav1d.

The aom in Pillow's libavif is built without high bit depth; the 10- and
12-bit files of tests/goldens/avif/deep/ come from OpenCV's bundled libavif
1.4.2 and aom 3.14.1 instead, driven by ctypes (`deep_kinds`, `write_deep`):
4:2:0, 4:2:2, 4:4:4 (lossy and lossless), grey, limited range, alpha
(premultiplied too), speed 0 (CDEF and loop restoration), film grain,
screen content, other matrices; avif10.scn, five such maps on helmet.scn's
slots, with its render avif10.npz; and big10.avif, a 2048x2048 10-bit map
for chip_smoke.py's decode timing. aom answers "superres-mode" with
AVIF_RESULT_INVALID_CODEC_SPECIFIC_OPTION in both libraries, so no
superres file can be written here (the port refuses it by name).

    cd tools && JAX_PLATFORMS=cpu python make_avif_fixtures.py [--deep]

(--deep writes deep/ alone.) Needs PIL, cv2 and jax.
"""

from __future__ import annotations

import ctypes as C
import glob
import io
import os
import struct
import sys

import numpy as np
import PIL
from PIL import Image

from make_format_fixtures import rect_pattern, render_golden
from make_texture_fixtures import REPO, u8

OUT = os.path.join(REPO, "tests", "goldens", "avif")
DEEP = os.path.join(OUT, "deep")
DEEP_SEED = 1012
SEED = 9191
SIZES = [(256, 256), (256, 256), (192, 256), (128, 128), (128, 128)]  # rows, columns

SCN = """# AVIF fixture: helmet.scn's five map slots (B and E sRGB, N, R, M) as
# AVIF files of the kinds aom writes, made by tools/make_avif_fixtures.py.
SCN AVIF fixture
OUT 256 192
CAM (0, 1.0, 3.2) (0.0, 0.55, 0.0) (0.0, 1.0, 0.0) 45.0
MTL Textured (1.0, 1.0, 1.0) 1 0
MTL Floor (0.4, 0.4, 0.4) 1 0
TEX Textured B basecolor.avif SRGB
TEX Textured N normal.avif
TEX Textured R roughness.avif
TEX Textured M metalness.avif
TEX Textured E emissive.avif SRGB
SKY (0.7, 0.8, 1.0)
OBJ S (-0.45, 0.6, 0) 0.6 Textured
OBJ B (0.35, 0.0, -0.4) (1.15, 0.8, 0.4) Textured
OBJ B (-20.0, -0.2, -20.0) (20.0, 0, 20.0) Floor
"""

# ---------------------------------------------------------------- libavif

_FORMATS = {"444": 1, "422": 2, "420": 3, "400": 4}
_libs = {}


def _bind(path):
    lib = C.CDLL(path)
    vp = C.c_void_p
    for name, res, args in (
            ("avifImageCreate", vp, [C.c_uint32] * 3 + [C.c_int]),
            ("avifImageCreateEmpty", vp, []),
            ("avifImageAllocatePlanes", C.c_int, [vp, C.c_int]),
            ("avifImageDestroy", None, [vp]),
            ("avifEncoderCreate", vp, []),
            ("avifEncoderDestroy", None, [vp]),
            ("avifEncoderSetCodecSpecificOption", C.c_int, [vp, C.c_char_p, C.c_char_p]),
            ("avifEncoderAddImage", C.c_int, [vp, vp, C.c_uint64, C.c_uint32]),
            ("avifEncoderAddImageGrid", C.c_int, [vp, C.c_uint32, C.c_uint32, vp, C.c_uint32]),
            ("avifEncoderFinish", C.c_int, [vp, vp]),
            ("avifRWDataFree", None, [vp]),
            ("avifDecoderCreate", vp, []),
            ("avifDecoderDestroy", None, [vp]),
            ("avifDecoderReadMemory", C.c_int, [vp, vp, C.c_char_p, C.c_size_t]),
            ("avifRGBImageSetDefaults", None, [vp, vp]),
            ("avifRGBImageAllocatePixels", C.c_int, [vp]),
            ("avifRGBImageFreePixels", None, [vp]),
            ("avifImageYUVToRGB", C.c_int, [vp, vp])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def libavif():
    """Pillow's bundled libavif 1.3 (dav1d to decode, aom to encode)."""
    if "pil" not in _libs:
        _libs["pil"] = _bind(glob.glob(os.path.join(
            os.path.dirname(PIL.__file__), os.pardir, "pillow.libs", "libavif-*.so*"))[0])
    return _libs["pil"]


def cv2_libavif():
    """OpenCV's bundled libavif 1.4.2 (aom 3.14.1, built with high bit
    depth), whose avifImage and avifEncoder begin as 1.3's do."""
    if "cv2" not in _libs:
        import cv2

        libs = os.path.join(os.path.dirname(cv2.__file__), os.pardir, "opencv_python.libs")
        _libs["cv2"] = _bind(glob.glob(os.path.join(libs, "libavif-*.so*"))[0])
    return _libs["cv2"]


# avifImage (libavif 1.3): width, height, depth, yuvFormat, yuvRange at 0-16,
# yuvPlanes at 24, yuvRowBytes at 48, alphaPlane at 64, alphaRowBytes at 72,
# alphaPremultiplied at 80, colorPrimaries, transferCharacteristics and
# matrixCoefficients (uint16) at 104.
def avif_image(planes, depth=8, fmt="420", full=True, mc=6, cp=1, tc=13, alpha=None,
               premultiplied=False, lib=None):
    """An avifImage of `planes` (Y, or Y, U, V at the chroma size), by
    `lib` (Pillow's libavif by default)."""
    lib = lib or libavif()
    h, w = planes[0].shape
    im = lib.avifImageCreate(w, h, depth, _FORMATS[fmt])
    C.memmove(im + 16, struct.pack("<I", int(full)), 4)
    C.memmove(im + 104, struct.pack("<3H", cp, tc, mc), 6)
    lib.avifImageAllocatePlanes(im, 1 if alpha is None else 3)
    ptr = struct.unpack("<3Q", C.string_at(im + 24, 24))
    rows = struct.unpack("<3I", C.string_at(im + 48, 12))
    dtype = np.uint16 if depth > 8 else np.uint8
    pairs = list(zip(planes, ptr, rows))
    if alpha is not None:
        aptr, arow = struct.unpack("<QI", C.string_at(im + 64, 12))
        pairs.append((alpha, aptr, arow))
        C.memmove(im + 80, struct.pack("<I", int(premultiplied)), 4)
    for p, at, rb in pairs:
        p = np.ascontiguousarray(p, dtype)
        for r in range(p.shape[0]):
            C.memmove(at + r * rb, p[r].ctypes.data, p.shape[1] * p.itemsize)
    return im


def encode(images, grid=None, single=True, lib=None, speed=None, quality=None, tiles=None,
           options=None) -> bytes:
    """An AVIF file of avifImages by libavif's encoder: one image, a grid
    (cols, rows) of cells, or a sequence; aom at its defaults but for
    avifEncoder's speed (at byte 8), quality and qualityAlpha (32),
    tileRowsLog2 and tileColsLog2 (56), and aom options by name."""
    lib = lib or libavif()
    enc = lib.avifEncoderCreate()
    try:
        if speed is not None:
            C.memmove(enc + 8, struct.pack("<i", speed), 4)
        if quality is not None:
            C.memmove(enc + 32, struct.pack("<ii", quality, quality), 8)
        if tiles is not None:
            C.memmove(enc + 56, struct.pack("<ii", *tiles), 8)
        for k, v in (options or {}).items():
            if lib.avifEncoderSetCodecSpecificOption(enc, k.encode(), v.encode()):
                raise RuntimeError(f"option {k}")
        if grid:
            cells = (C.c_void_p * len(images))(*images)
            rc = lib.avifEncoderAddImageGrid(enc, grid[0], grid[1], cells, 2)
        else:
            for im in images:
                rc = lib.avifEncoderAddImage(enc, im, 1, 2 if single else 0)
                if rc:
                    break
        if rc:
            raise RuntimeError(f"avifEncoderAddImage: {rc}")
        rw = (C.c_uint8 * 16)()
        rc = lib.avifEncoderFinish(enc, rw)
        if rc:
            raise RuntimeError(f"avifEncoderFinish: {rc}")
        data_ptr, size = struct.unpack("<QQ", bytes(rw))
        out = C.string_at(data_ptr, size)
        lib.avifRWDataFree(rw)
        return out
    finally:
        lib.avifEncoderDestroy(enc)
        for im in images:
            lib.avifImageDestroy(im)


def encode_deep(planes, depth, fmt="420", full=True, mc=6, cp=1, speed=6, quality=60,
                options=None, alpha=None, premultiplied=False, tiles=(0, 0)) -> bytes:
    """An AVIF file of planes at `depth` bits by OpenCV's libavif."""
    lib = cv2_libavif()
    image = avif_image(planes, depth, fmt, full, mc, cp, alpha=alpha,
                       premultiplied=premultiplied, lib=lib)
    return encode([image], lib=lib, speed=speed, quality=quality, tiles=tiles, options=options)


def rgb_to_yuv(rgb: np.ndarray, depth: int, fmt: str, full=True) -> list:
    """BT.601 planes at `depth` bits of float RGB in [0, 1], chroma
    averaged over each 2x2 or 2x1 block."""
    top = (1 << depth) - 1
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb, cr = (b - y) / 1.772 + 0.5, (r - y) / 1.402 + 0.5
    if full:
        planes = [y * top, cb * top, cr * top]
    else:
        s = 1 << (depth - 8)
        planes = [(16 + 219 * y) * s, (16 + 224 * cb) * s, (16 + 224 * cr) * s]
    if fmt == "400":
        planes = planes[:1]
    sx, sy = {"444": (0, 0), "422": (1, 0), "420": (1, 1), "400": (0, 0)}[fmt]
    out = [planes[0]]
    for c in planes[1:]:
        h, w = c.shape
        c = np.pad(c, ((0, h % (1 + sy)), (0, w % (1 + sx))), mode="edge")
        c = c.reshape(c.shape[0] >> sy, 1 + sy, c.shape[1] >> sx, 1 + sx).mean((1, 3))
        out.append(c)
    return [np.clip(np.round(p), 0, top).astype(np.uint16) for p in out]


def deep_photo(h, w, rng, depth, fmt="420", full=True):
    return rgb_to_yuv(photo(h, w, rng).astype(np.float64) / 255.0, depth, fmt, full)


def deep_kinds(rng):
    """The small 10- and 12-bit files of deep/, by name."""
    out = {}
    for depth in (10, 12):
        out[f"yuv420_{depth}.avif"] = encode_deep(deep_photo(64, 80, rng, depth), depth)
        out[f"mono{depth}.avif"] = encode_deep(deep_photo(48, 56, rng, depth, "400"), depth,
                                               "400")
        out[f"speed0_{depth}.avif"] = encode_deep(deep_photo(96, 112, rng, depth, "444"), depth,
                                                  "444", speed=0, quality=50)
        out[f"lossless444_{depth}.avif"] = encode_deep(deep_photo(40, 48, rng, depth, "444"),
                                                       depth, "444", mc=0, quality=100)
        out[f"screen{depth}.avif"] = encode_deep(
            rgb_to_yuv(text(96, 160, rng) / 255.0, depth, "444"), depth, "444", speed=2,
            options={"tune-content": "screen"})
        out[f"alpha{depth}.avif"] = encode_deep(
            deep_photo(48, 64, rng, depth), depth,
            alpha=rgb_to_yuv(rect_pattern(48, 64, rng, 3), depth, "400")[0])
        out[f"film_grain{depth}.avif"] = encode_deep(deep_photo(64, 64, rng, depth), depth,
                                                     options={"film-grain-test": "1"})
    out["yuv422_10.avif"] = encode_deep(deep_photo(50, 66, rng, 10, "422"), 10, "422")
    out["yuv444_10.avif"] = encode_deep(deep_photo(50, 66, rng, 10, "444"), 10, "444", quality=40)
    out["odd420_12.avif"] = encode_deep(deep_photo(37, 45, rng, 12), 12, speed=3)
    out["limited10.avif"] = encode_deep(deep_photo(48, 64, rng, 10, full=False), 10, full=False)
    out["tiles10.avif"] = encode_deep(deep_photo(160, 160, rng, 10), 10, tiles=(1, 1),
                                      options={"enable-qm": "1", "deltaq-mode": "2"})
    out["tx64_12.avif"] = encode_deep(deep_photo(160, 160, rng, 12), 12, speed=1, quality=5)
    # Wiener and self-guided restoration, at 10 bits only: aom chose neither
    # at 12 bits in any of 48 settings tried (ROADMAP, queue 3).
    out["restoration10.avif"] = encode_deep(deep_photo(128, 160, rng, 10), 10, speed=0,
                                            quality=60, options={"tune": "psnr"})
    out["sb128_12.avif"] = encode_deep(deep_photo(160, 192, rng, 12), 12, speed=0,
                                       options={"sb-size": "128"})
    out["intrabc12.avif"] = encode_deep(rgb_to_yuv(text(128, 256, rng) / 255.0, 12, "420"), 12,
                                        speed=2, options={"tune-content": "screen"})
    out["speed4_10.avif"] = encode_deep(deep_photo(128, 160, rng, 10), 10, speed=4)
    for depth, fmt in ((10, "444"), (12, "444"), (12, "422"), (10, "400")):
        out[f"alpha{depth}_{fmt}.avif"] = encode_deep(
            deep_photo(33, 41, rng, depth, fmt), depth, fmt,
            alpha=rgb_to_yuv(rect_pattern(33, 41, rng, 3), depth, "400")[0])
    for depth in (10, 12):
        out[f"premultiplied{depth}.avif"] = encode_deep(
            deep_photo(33, 41, rng, depth), depth, premultiplied=True,
            alpha=rgb_to_yuv(rect_pattern(33, 41, rng, 3), depth, "400")[0])
    # Routes of libavif's conversion that 8-bit files take too: grey into
    # RGBA (libyuv's I400), and the float rows' unpremultiply.
    out["alpha8_400.avif"] = encode_deep(
        deep_photo(33, 41, rng, 8, "400"), 8, "400",
        alpha=rgb_to_yuv(rect_pattern(33, 41, rng, 3), 8, "400")[0])
    for depth, mc in ((8, 8), (10, 4)):
        out[f"premultiplied{depth}_matrix{mc}.avif"] = encode_deep(
            yuv(rng, 33, 41, depth, "420"), depth, mc=mc, premultiplied=True,
            alpha=rgb_to_yuv(rect_pattern(33, 41, rng, 3), depth, "400")[0])
    for mc, full, fmt in ((4, True, "420"), (7, False, "444"), (8, True, "420"), (9, False, "420"),
                          (1, True, "422")):
        out[f"matrix{mc}_{'full' if full else 'limited'}_{fmt}_10.avif"] = encode_deep(
            yuv(rng, 40, 48, 10, fmt), 10, fmt, full=full, mc=mc, cp=9 if mc == 9 else 1)
    return out


def dav1d_planes(data: bytes):
    """dav1d's planes of an AVIF file through libavif: ([Y] or [Y, U, V],
    alpha or None), uint16."""
    lib = libavif()
    dec, im = lib.avifDecoderCreate(), lib.avifImageCreateEmpty()
    try:
        rc = lib.avifDecoderReadMemory(dec, im, data, len(data))
        if rc:
            raise RuntimeError(f"avifDecoderReadMemory: {rc}")
        w, h, depth, fmt = struct.unpack("<4I", C.string_at(im, 16))
        ptr = struct.unpack("<3Q", C.string_at(im + 24, 24))
        rows = struct.unpack("<3I", C.string_at(im + 48, 12))
        aptr, arow = struct.unpack("<QI", C.string_at(im + 64, 12))
        sx, sy = {1: (0, 0), 2: (1, 0), 3: (1, 1), 4: (1, 1)}[fmt]
        dtype = np.uint16 if depth > 8 else np.uint8
        planes = []
        for k in range(1 if fmt == 4 else 3):
            pw, ph = (w, h) if k == 0 else ((w + sx) >> sx, (h + sy) >> sy)
            raw = np.frombuffer(C.string_at(ptr[k], rows[k] * ph), dtype)
            planes.append(raw.reshape(ph, -1)[:, :pw].astype(np.uint16))
        alpha = None
        if aptr:
            raw = np.frombuffer(C.string_at(aptr, arow * h), dtype)
            alpha = raw.reshape(h, -1)[:, :w].astype(np.uint16)
        return planes, alpha
    finally:
        lib.avifImageDestroy(im)
        lib.avifDecoderDestroy(dec)


# ---------------------------------------------------------------- content

def photo(h: int, w: int, rng, channels=3) -> np.ndarray:
    """Smooth gradients with noise: camera-like content."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    phase = rng.uniform(0, 6, channels)
    img = np.stack([128 + 60 * np.sin(x / 7 + phase[k]) + 40 * np.cos(y / 11 * (k + 1))
                    for k in range(channels)], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)


def text(h: int, w: int, rng) -> np.ndarray:
    """Glyphs of five shapes repeated on a flat page: screen content, where
    aom uses palettes and intra block copy."""
    glyphs = [rng.integers(0, 2, (16, 12)) * 255 for _ in range(5)]
    page = np.full((h, w), 255, np.uint8)
    for r in range(4, h - 16, 20):
        for c in range(4, w - 12, 14):
            page[r:r + 16, c:c + 12] = glyphs[rng.integers(0, 5)]
    return np.stack([page, page // 2 + 64, page], -1)


def pil(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="AVIF", **kw)
    return buf.getvalue()


def put(name: str, data: bytes):
    with open(os.path.join(OUT, name), "wb") as f:
        f.write(data)


def yuv(rng, h, w, depth, fmt):
    """Random smooth planes at a bit depth and subsampling."""
    top = (1 << depth) - 1
    sx, sy = {"444": (0, 0), "422": (1, 0), "420": (1, 1), "400": (1, 1)}[fmt]
    y, x = np.mgrid[0:h, 0:w]
    luma = top * (0.5 + 0.35 * np.sin(x / 5.0) * np.cos(y / 7.0)) + rng.normal(0, top / 40, (h, w))
    planes = [np.clip(luma, 0, top).astype(np.uint16)]
    if fmt != "400":
        ch, cw = (h + sy) >> sy, (w + sx) >> sx
        for k in range(2):
            c = top * (0.5 + 0.3 * np.cos(np.arange(cw)[None] / (4.0 + k) + k)) * np.ones((ch, 1))
            planes.append(np.clip(c + rng.normal(0, top / 30, (ch, cw)), 0, top).astype(np.uint16))
    return planes


def kinds(rng):
    """The small files of the corpus, by name."""
    out = {}
    img = photo(64, 80, rng)
    for q in (0, 10, 50, 100):
        out[f"q{q}.avif"] = pil(img, quality=q)
    for speed in (0, 2, 4, 8, 10):
        out[f"speed{speed}.avif"] = pil(img, speed=speed)
    for ss in ("4:2:2", "4:4:4", "4:0:0"):
        out[f"sub{ss.replace(':', '')}.avif"] = pil(img, subsampling=ss)
    odd = photo(67, 53, rng)
    out["odd420.avif"] = pil(odd)
    out["odd422.avif"] = pil(odd, subsampling="4:2:2", speed=3)
    out["limited.avif"] = pil(img, range="limited")
    big = photo(160, 160, rng)
    out["tiles.avif"] = pil(big, tile_rows=1, tile_cols=1)
    out["cdef.avif"] = pil(img, advanced={"enable-cdef": "1"})
    out["qm.avif"] = pil(img, advanced={"enable-qm": "1"})
    out["deltaq.avif"] = pil(img, advanced={"deltaq-mode": "2"})
    # Loop filter levels that change by block (of its own seed, whose frame filters).
    out["deltalf.avif"] = pil(photo(128, 160, np.random.default_rng(2)), speed=4,
                              advanced={"deltaq-mode": "3", "delta-lf-mode": "1"})
    # Segments: libavif encodes a sequence's key frame with aom's good-quality
    # usage, where variance AQ segments the frame (its own seed, 128x160).
    seg = photo(128, 160, np.random.default_rng(3))
    out["segments.avif"] = pil(seg, save_all=True, append_images=[Image.fromarray(seg[::-1])],
                               advanced={"aq-mode": "1"})
    out["chroma_deltaq.avif"] = pil(img, advanced={"enable-chroma-deltaq": "1", "enable-qm": "1"})
    out["tx64.avif"] = pil(big, speed=1, quality=5)
    out["palette.avif"] = pil(text(64, 80, rng))
    # A page (of its own seed) whose block copies carry residuals in split transforms.
    out["intrabc.avif"] = pil(text(256, 512, np.random.default_rng(1)), speed=2)
    rgba = np.concatenate([img, u8(rect_pattern(64, 80, rng, 1))], -1)
    out["alpha.avif"] = pil(rgba)
    out["premultiplied.avif"] = pil(rgba, alpha_premultiplied=True)
    out["film_grain.avif"] = pil(img, advanced={"film-grain-test": "1"})
    out["film_grain444.avif"] = pil(img, subsampling="4:4:4", advanced={"film-grain-test": "10"})
    out["sequence.avif"] = pil(img, save_all=True, append_images=[Image.fromarray(img[::-1])])
    # Through libavif's encoder: what PIL's writer cannot make.
    out["mono_limited.avif"] = encode([avif_image(yuv(rng, 40, 48, 8, "400"), fmt="400",
                                                  full=False)])
    for mc, full, fmt in ((1, True, "420"), (1, False, "422"), (9, True, "444"), (9, False, "420"),
                          (0, True, "444"), (5, False, "420"), (2, True, "420"), (4, True, "420"),
                          (7, False, "422"), (8, True, "420")):
        cp = 9 if mc == 9 else 1
        out[f"matrix{mc}_{'full' if full else 'limited'}_{fmt}.avif"] = encode(
            [avif_image(yuv(rng, 40, 48, 8, fmt), fmt=fmt, full=full, mc=mc, cp=cp)])
    cells = [avif_image(yuv(rng, 64, 64, 8, "420")) for _ in range(4)]
    out["grid.avif"] = encode(cells, grid=(2, 2))
    cells = [avif_image(yuv(rng, 64, 80, 8, "444"), fmt="444") for _ in range(6)]
    out["grid444.avif"] = encode(cells, grid=(3, 2))
    return out


def write_maps(rng):
    os.makedirs(OUT, exist_ok=True)
    (bh, bw), (nh, nw), (rh, rw), (mh, mw), (eh, ew) = SIZES
    put("basecolor.avif", pil(u8(rect_pattern(bh, bw, rng, 3))))
    bump = rect_pattern(nh, nw, rng, 2) - 0.5
    nrm = np.concatenate([0.5 + 0.3 * bump, np.ones_like(bump[..., :1])], axis=-1)
    noisy = np.clip(u8(nrm).astype(int) + rng.integers(-6, 7, (nh, nw, 3)), 0, 255)
    put("normal.avif", pil(noisy.astype(np.uint8), subsampling="4:4:4", tile_rows=1, tile_cols=1,
                           speed=4, advanced={"enable-cdef": "1"}))
    put("roughness.avif", pil(text(rh, rw, rng), speed=2))
    put("metalness.avif", pil(photo(mh, mw, rng), advanced={"enable-qm": "1",
                                                             "deltaq-mode": "2"}))
    glow = rect_pattern(eh, ew, rng, 4)
    glow[..., :3] = np.where(glow[..., :3] > 0.6, glow[..., :3], 0.0)
    put("emissive.avif", pil(u8(glow)))
    with open(os.path.join(OUT, "avif.scn"), "w") as f:
        f.write(SCN)


def write_big(rng):
    """2048x2048 4:2:0 map of a smooth pattern with fine grain, quality 75."""
    y, x = np.mgrid[0:2048, 0:2048].astype(np.float32) / 2048
    chans = []
    for _ in range(3):
        a, b, c = rng.uniform(2, 9, 3)
        chans.append(0.5 + 0.3 * np.sin(a * x + c) * np.cos(b * y)
                     + 0.15 * np.sin((a + b) * (x + y)))
    img = np.stack(chans, -1) + rng.normal(0, 0.02, (2048, 2048, 3))  # grain: about 260 KB
    put("big.avif", pil(u8(np.clip(img, 0, 1))))


def write_deep(rng):
    """deep/: avif10.scn's five maps at 10 and 12 bits, big10.avif, the
    small files of `deep_kinds` and the scene's render."""
    os.makedirs(DEEP, exist_ok=True)

    def put_deep(name, data):
        with open(os.path.join(DEEP, name), "wb") as f:
            f.write(data)

    (bh, bw), (nh, nw), (rh, rw), (mh, mw), (eh, ew) = SIZES
    put_deep("basecolor.avif", encode_deep(rgb_to_yuv(rect_pattern(bh, bw, rng, 3), 10, "420"),
                                           10))
    bump = rect_pattern(nh, nw, rng, 2) - 0.5
    nrm = np.concatenate([0.5 + 0.3 * bump, np.ones_like(bump[..., :1])], axis=-1)
    noisy = np.clip(nrm + rng.normal(0, 0.02, nrm.shape), 0, 1)
    put_deep("normal.avif", encode_deep(rgb_to_yuv(noisy, 12, "444"), 12, "444", speed=4,
                                        tiles=(1, 1), options={"enable-cdef": "1"}))
    put_deep("roughness.avif", encode_deep(rgb_to_yuv(text(rh, rw, rng) / 255.0, 10, "444"), 10,
                                           "444", speed=2, options={"tune-content": "screen"}))
    put_deep("metalness.avif", encode_deep(deep_photo(mh, mw, rng, 12, "400"), 12, "400"))
    glow = rect_pattern(eh, ew, rng, 4)
    glow[..., :3] = np.where(glow[..., :3] > 0.6, glow[..., :3], 0.0)
    put_deep("emissive.avif", encode_deep(rgb_to_yuv(glow[..., :3], 10, "420"), 10,
                                          alpha=rgb_to_yuv(glow[..., 3:].repeat(3, -1), 10,
                                                           "400")[0]))
    with open(os.path.join(DEEP, "avif10.scn"), "w") as f:
        f.write(SCN.replace("AVIF fixture", "10- and 12-bit AVIF fixture").replace(
            "AVIF files of the kinds aom writes", "10- and 12-bit AVIF files"))
    y, x = np.mgrid[0:2048, 0:2048].astype(np.float32) / 2048
    chans = []
    for _ in range(3):
        a, b, c = rng.uniform(2, 9, 3)
        chans.append(0.5 + 0.3 * np.sin(a * x + c) * np.cos(b * y)
                     + 0.15 * np.sin((a + b) * (x + y)))
    img = np.clip(np.stack(chans, -1) + rng.normal(0, 0.02, (2048, 2048, 3)), 0, 1)
    put_deep("big10.avif", encode_deep(rgb_to_yuv(img, 10, "420"), 10, quality=75))
    for name, data in deep_kinds(rng).items():
        put_deep(name, data)
    render_golden(DEEP, "avif10", SIZES)


def main():
    if "--deep" not in sys.argv:
        rng = np.random.default_rng(SEED)
        write_maps(rng)
        write_big(rng)
        for name, data in kinds(rng).items():
            put(name, data)
        render_golden(OUT, "avif", SIZES)
    write_deep(np.random.default_rng(DEEP_SEED))
    for d in (OUT, DEEP):
        sizes = {n: os.path.getsize(os.path.join(d, n)) for n in sorted(os.listdir(d))
                 if os.path.isfile(os.path.join(d, n))}
        print(sizes, sum(sizes.values()), "bytes")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
