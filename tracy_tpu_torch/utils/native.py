"""Loaders of the port's two native host libraries, built by g++.

`get_native_lib`: the port's own copy of tracy_tpu/utils/native.py. g++
compiles native/bvh_builder.cpp and obj_loader.cpp with native/Makefile's
flags (`-ffp-contract=off` keeps the SAH cost sums bit-equal to the numpy
builder) into build/native/<hash>/libtracy_native.so; without a compiler
the callers take their numpy versions.

`get_image_lib`: the image decoders of csrc/image_decode.cpp (PNG, JPEG),
csrc/image_formats.cpp (TGA, BMP, GIF, PNM, PSD, QOI), image_tiff.cpp
(TIFF), image_blocks.cpp (DDS), image_webp.cpp (WebP),
image_containers.cpp (DIB, ICO, CUR, FTEX, BLP, ICNS), image_legacy.cpp
(PCX, DCX, SGI, SUN, MSP, IM, XBM, XPM, PIXAR, SPIDER, FITS, GBR, MCIDAS,
XVTHUMB, IMT, IPTC, PCD, FLI), image_jpeg2000.cpp (JP2, J2K) and
image_avif.cpp with av1_decode.cpp and av1_recon.cpp (AVIF), in
build/native/<hash>/libtracy_image.so: each source compiled to its own
object, all at once, then linked. g++ (not nvcc), so that the CPU
tests run the same code as the card's host; `-ffp-contract=off` keeps
the 9/7 wavelet's float32 lifting unfused, as OpenJPEG computes it. They have no other version:
if the library cannot be built, `get_image_lib` raises
ImageDecoderUnavailable with the compiler's output.

Both live at the repository root, keyed by a hash of the sources and
flags; `CXX` names the compiler, else g++ on the PATH. A library is
written under a temporary name and renamed into place; the image library
is built by one process at a time (an flock), the others waiting for it.
The builds happen at first use, never at import.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from tracy_tpu_torch.utils.log import log, warn

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
CSRC_DIR = os.path.join(_REPO_ROOT, "tracy_tpu_torch", "csrc")
BUILD_ROOT = os.path.join(_REPO_ROOT, "build", "native")
SOURCES = tuple(os.path.join(NATIVE_DIR, s) for s in ("bvh_builder.cpp", "obj_loader.cpp"))
CXXFLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fPIC", "-shared",
            "-std=c++17", "-Wall"]
IMAGE_SOURCES = tuple(os.path.join(CSRC_DIR, s) for s in ("image_decode.cpp",
                                                          "image_formats.cpp",
                                                          "image_tiff.cpp",
                                                          "image_blocks.cpp",
                                                          "image_webp.cpp",
                                                          "image_containers.cpp",
                                                          "image_legacy.cpp",
                                                          "image_jpeg2000.cpp",
                                                          "image_avif.cpp", "av1_decode.cpp",
                                                          "av1_recon.cpp", "image_xz.cpp",
                                                          "image_zstd.cpp"))
# Included by the sources: part of the library's hash, not of the command.
IMAGE_HEADERS = tuple(os.path.join(CSRC_DIR, h) for h in ("image_common.h", "av1_decode.h",
                                                         "av1_tables.h", "lab_table.h"))
# Formats of csrc/image_legacy.cpp, whose tracy_<fmt>_info also says (code
# 3) that a file is not of the format, as PIL's plugin decides it.
LEGACY_FORMATS = ("pcx", "dcx", "sgi", "sun", "msp", "im", "xbm", "xpm", "pixar", "spider", "fits",
                  "gbr", "mcidas", "xvthumb", "imt", "iptc", "pcd", "fli")
# Formats of csrc/image_formats.cpp, image_tiff.cpp, image_blocks.cpp,
# image_webp.cpp, image_containers.cpp, image_legacy.cpp, image_jpeg2000.cpp
# and image_avif.cpp, each with tracy_<fmt>_info/_decode.
IMAGE_FORMATS = ("tga", "bmp", "gif", "pnm", "psd", "qoi", "tiff", "dds", "webp", "dib", "ico",
                 "cur", "ftex", "blp", "icns", "jpeg2000", "avif") + LEGACY_FORMATS
# Containers whose opened entry may be a PNG, JPEG or JPEG 2000 stream,
# each with tracy_<fmt>_stream (csrc/image_containers.cpp).
STREAM_FORMATS = ("ico", "icns", "blp")
# No -march=native: the same code on this machine and on the card's host.
IMAGE_CXXFLAGS = ["-O2", "-ffp-contract=off", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False
_image_lib: Optional[ctypes.CDLL] = None


class ImageDecoderUnavailable(RuntimeError):
    """The image decoder library could not be built or loaded."""


def _so_path(name: str, sources, flags, headers=()) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in (*sources, *headers):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], name)


def _run(cmd) -> Optional[str]:
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        return f"{' '.join(cmd)}: {e}"
    if res.returncode != 0:
        return f"{' '.join(cmd)} exited {res.returncode}:\n{res.stderr[-2000:]}"
    return None


@contextlib.contextmanager
def _build_lock():
    """One build at a time across processes (test workers start together):
    an flock on build/native/.lock, released when its holder exits."""
    os.makedirs(BUILD_ROOT, exist_ok=True)
    with open(os.path.join(BUILD_ROOT, ".lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _compile(so_path: str, sources, flags) -> Optional[str]:
    """Build so_path: each source to an object of its own, all at once,
    then one link (`-shared` applies to the link only); None on success,
    else what went wrong (with the compiler's output)."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        return "no C++ compiler: CXX is unset and g++ is not on the PATH"
    out_dir = os.path.dirname(so_path)
    os.makedirs(out_dir, exist_ok=True)
    compile_flags = [f for f in flags if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objects = [os.path.join(tmp, f"{i}_{os.path.basename(s)}.o") for i, s in enumerate(sources)]
        with ThreadPoolExecutor(max_workers=min(len(sources), os.cpu_count() or 1)) as pool:
            errors = list(pool.map(lambda so: _run([cxx, *compile_flags, "-c", so[0], "-o", so[1]]),
                                   zip(sources, objects)))
        err = next((e for e in errors if e is not None), None)
        if err is not None:
            return err
        tmp_so = os.path.join(tmp, os.path.basename(so_path))
        err = _run([cxx, *flags, "-o", tmp_so, *objects])
        if err is not None:
            return err
        os.replace(tmp_so, so_path)
    log(f"built {so_path}")
    return None


def get_native_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built if needed; None if it cannot be built."""
    global _lib, _failed
    with _lock:
        if _lib is not None:
            return _lib
        if _failed:
            return None
        so_path = _so_path("libtracy_native.so", SOURCES, CXXFLAGS)
        err = None if os.path.exists(so_path) else _compile(so_path, SOURCES, CXXFLAGS)
        if err is not None:
            warn(f"native build failed: {err}")
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError as e:
            warn(f"native library load failed: {e}")
            _failed = True
            return None

        lib.tracy_build_bvh.restype = ctypes.c_int
        lib.tracy_build_bvh.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,  # ..., max_depth, cost_mode
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.tracy_obj_scan.restype = ctypes.c_int64
        lib.tracy_obj_scan.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.tracy_obj_fill.restype = ctypes.c_int
        lib.tracy_obj_fill.argtypes = [ctypes.c_int64] + [ctypes.c_void_p] * 7
        lib.tracy_obj_free.restype = None
        lib.tracy_obj_free.argtypes = [ctypes.c_int64]

        _lib = lib
        return _lib


def get_image_lib() -> ctypes.CDLL:
    """The loaded decoder library, built if needed. Raises
    ImageDecoderUnavailable, naming the compiler's output, if it cannot be
    built or loaded; a later call tries again."""
    global _image_lib
    with _lock:
        if _image_lib is not None:
            return _image_lib
        so_path = _so_path("libtracy_image.so", IMAGE_SOURCES, IMAGE_CXXFLAGS, IMAGE_HEADERS)
        err = None
        if not os.path.exists(so_path):
            with _build_lock():
                if not os.path.exists(so_path):
                    err = _compile(so_path, IMAGE_SOURCES, IMAGE_CXXFLAGS)
        if err is not None:
            raise ImageDecoderUnavailable(f"the image decoder library cannot be built: {err}")
        try:
            lib = ctypes.CDLL(so_path)
        except OSError as e:
            raise ImageDecoderUnavailable(f"the image decoder library cannot be loaded: {e}")
        u8p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.tracy_decode_error.restype = ctypes.c_char_p
        lib.tracy_decode_error.argtypes = []
        lib.tracy_png_decode.restype = i32
        lib.tracy_png_decode.argtypes = [u8p, i64, i32, i32, i32, i32, i32, u8p, i32, u8p, i32,
                                         u8p]
        lib.tracy_jpeg_info.restype = i32
        lib.tracy_jpeg_info.argtypes = [u8p, i64, ip, ip, ip, ip]
        lib.tracy_jpeg_decode.restype = i32
        lib.tracy_jpeg_decode.argtypes = [u8p, i64, u8p, i32, i32, i32]
        for fmt in IMAGE_FORMATS:
            info, decode = getattr(lib, f"tracy_{fmt}_info"), getattr(lib, f"tracy_{fmt}_decode")
            info.restype = decode.restype = i32
            info.argtypes = [u8p, i64, ip, ip]
            decode.argtypes = [u8p, i64, u8p, i32, i32]
        for fmt in STREAM_FORMATS:
            stream = getattr(lib, f"tracy_{fmt}_stream")
            stream.restype = i32
            stream.argtypes = [u8p, i64, ctypes.POINTER(ctypes.c_int64)]
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.tracy_avif_planes.restype = i32
        lib.tracy_avif_planes.argtypes = [u8p, i64, ip] + [u8p] * 4
        lib.tracy_iptc_stream.restype = i32
        lib.tracy_tiff_mode.restype = i32
        lib.tracy_tiff_mode.argtypes = [u8p, i64, ctypes.c_char_p, i32]
        lib.tracy_iptc_stream.argtypes = [u8p, i64, i64p, i64p, i64, i64p]
        _image_lib = lib
        return _image_lib
