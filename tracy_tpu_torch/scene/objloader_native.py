"""Native-backed wavefront OBJ loading (same contract as objloader.load_obj).

The port's copy of tracy_tpu/scene/objloader_native.py, over the port's own
native library (utils/native.py). The C++ scanner (native/obj_loader.cpp)
does the line parsing; the reference-quirk dedup is objloader.shape_from_flat.
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from tracy_tpu_torch.scene.objloader import ObjShape, load_obj, shape_from_flat
from tracy_tpu_torch.utils.native import get_native_lib


def load_obj_native(path: str) -> List[ObjShape]:
    lib = get_native_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")

    counts = np.zeros((4,), dtype=np.int64)
    handle = lib.tracy_obj_scan(path.encode(), counts.ctypes.data_as(ctypes.c_void_p))
    if handle < 0:
        raise FileNotFoundError(path)
    try:
        nv, nn, nt, nc = (int(x) for x in counts)
        v = np.empty((nv, 3), dtype=np.float32)
        vn = np.empty((nn, 3), dtype=np.float32)
        vt = np.empty((nt, 2), dtype=np.float32)
        f_v = np.empty((nc,), dtype=np.int32)
        f_vt = np.empty((nc,), dtype=np.int32)
        f_vn = np.empty((nc,), dtype=np.int32)
        shape_id = np.empty((nc,), dtype=np.int32)
        rc = lib.tracy_obj_fill(
            handle, *(a.ctypes.data_as(ctypes.c_void_p)
                      for a in (v, vn, vt, f_v, f_vt, f_vn, shape_id)))
        if rc != 0:
            raise RuntimeError("tracy_obj_fill failed")
    finally:
        lib.tracy_obj_free(handle)

    positions = v.astype(np.float64)
    normals = vn.astype(np.float64)
    uvs = vt.astype(np.float64)
    return [shape_from_flat("", f_v[sel], f_vt[sel], f_vn[sel], positions, normals, uvs)
            for sel in (shape_id == sid for sid in np.unique(shape_id))]


def load_obj_fast(path: str) -> List[ObjShape]:
    """The native loader when its library builds, else the numpy loader
    (the JAX package's load_obj_fast)."""
    if get_native_lib() is None:
        return load_obj(path)
    return load_obj_native(path)
