"""Loader of the native host library (native/bvh_builder.cpp, obj_loader.cpp).

The port's own copy of tracy_tpu/utils/native.py. g++ compiles the two
sources with native/Makefile's flags (`-ffp-contract=off` keeps the SAH
cost sums bit-equal to the numpy builder) into
build/native/<hash>/libtracy_native.so at the repository root, keyed by a
hash of the sources and flags. The library is written under a temporary
name and renamed into place, so several processes may build at once. The
build happens at first use, never at import; without a compiler the
callers take their numpy versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

from tracy_tpu_torch.utils.log import log, warn

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
BUILD_ROOT = os.path.join(_REPO_ROOT, "build", "native")
SOURCES = ("bvh_builder.cpp", "obj_loader.cpp")
CXXFLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fPIC", "-shared",
            "-std=c++17", "-Wall"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def _build(so_path: str) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        warn("native build skipped: no g++")
        return False
    out_dir = os.path.dirname(so_path)
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_so = os.path.join(tmp, "libtracy_native.so")
        cmd = [cxx, *CXXFLAGS, "-o", tmp_so,
               *(os.path.join(NATIVE_DIR, s) for s in SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            warn(f"native build failed:\n{res.stderr[-2000:]}")
            return False
        os.replace(tmp_so, so_path)
    log("native library built")
    return True


def get_native_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built if needed; None if it cannot be built."""
    global _lib, _failed
    with _lock:
        if _lib is not None:
            return _lib
        if _failed:
            return None
        so_path = os.path.join(BUILD_ROOT, _digest(), "libtracy_native.so")
        if not os.path.exists(so_path) and not _build(so_path):
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
