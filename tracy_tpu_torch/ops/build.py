"""Build and load the CUDA kernels of csrc/ as one ctypes library.

`nvcc` compiles each kernel source to an object for sm_90a, one process per
source, all started together, then links them into one shared library with
a plain C interface. The library is cached under build/kernels/<hash>/ in
the repository root, keyed by a hash of the sources, the headers they share
and the flags, and is written to a temporary name and renamed into place,
so several test workers may build at once. The build happens at first use,
never at import.

Flags: no FMA contraction (--fmad=false) and IEEE division and square root
(nvcc's defaults, no fast math), so that a kernel and its plain PyTorch
version round alike (K6 asks for fmaf explicitly, and its plain version
rounds each as the card does); `-Xptxas -v`, so that each kernel's
registers and spills are kept in `LIBRARY.build_log` (and in
`<source>.log` beside the library, for a cached build).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
SOURCES = ("intersect.cu", "shade.cu", "texfetch.cu", "bounce.cu", "micro.cu")
HEADERS = ("traverse.cuh", "shade_lane.cuh", "texfetch_lane.cuh")
ARCH = "sm_90a"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_C = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
# C signatures (csrc/*.cu): every pointer and the stream as c_void_p.
SIGNATURES = {
    "tracy_intersect": [_C, _C, _C, _I] + [_C] * 3 + [_I] + [_C] * 6 + [_C] * 8 + [_C],
    "tracy_shade": [_C] * 10 + [_I, _C, _I, _U, _U, _U, _I, _I, _C, _I] + [_C],
    "tracy_shade_textured": ([_C] * 12 + [_I, _C, _I, _C, _C, _I, _C, _U, _U, _U, _I, _I, _C,
                                          _I] + [_C]),
    "tracy_texfetch": [_C] * 5 + [_I, _C, _C, _I, _C, _I, _C, _I, _C],
    "tracy_bounce": ([_C] * 7 + [_I] + [_C] * 3 + [_I] + [_C] * 6 + [_I, _U, _U, _U, _I, _I, _C]
                     + [_C] * 5 + [_C]),
    "tracy_micro": [_I, _C, _I, _C, _C, _C, _I, _I, _I, _C, _C, _C],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


class KernelLibrary:
    """The loaded library plus how its build went."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.path = ""
        self.build_seconds: Dict[str, float] = {}  # per source; empty if cached
        self.build_log: Dict[str, str] = {}  # per source: nvcc's output, kept beside the library

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._load()
            return self._lib

    def _load(self) -> ctypes.CDLL:
        out_dir = os.path.join(BUILD_ROOT, _digest())
        self.path = os.path.join(out_dir, "libtracy_kernels.so")
        if not os.path.exists(self.path):
            self._build(out_dir)
        for name in SOURCES:
            log = os.path.join(out_dir, name + ".log")
            if name not in self.build_log and os.path.exists(log):
                with open(log) as f:
                    self.build_log[name] = f.read()
        lib = ctypes.CDLL(self.path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return lib

    def _build(self, out_dir: str):
        nvcc = _nvcc()
        os.makedirs(out_dir, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            objs = [os.path.join(tmp, name + ".o") for name in SOURCES]
            t0 = time.perf_counter()
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC_DIR, name),
                                       "-o", obj], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for name, obj in zip(SOURCES, objs)]
            failed = []
            for name, proc in zip(SOURCES, procs):
                out, _ = proc.communicate()
                self.build_seconds[name] = time.perf_counter() - t0
                self.build_log[name] = out
                if proc.returncode != 0:
                    failed.append(f"nvcc {name} failed:\n{out}")
            if failed:
                raise RuntimeError("\n".join(failed))
            so = os.path.join(tmp, "libtracy_kernels.so")
            _run([nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs])
            for name in SOURCES:
                with open(os.path.join(tmp, name + ".log"), "w") as f:
                    f.write(self.build_log[name])
                os.replace(os.path.join(tmp, name + ".log"), os.path.join(out_dir, name + ".log"))
            os.replace(so, self.path)


def _run(cmd):
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{res.stdout}{res.stderr}")


LIBRARY = KernelLibrary()
