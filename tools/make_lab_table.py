"""Write tracy_tpu_torch/csrc/lab_table.h: the colour lookup table through
which PIL converts LAB images (CIELab TIFF, Lab PSD) to RGB.

    python tools/make_lab_table.py

PIL's `Image.convert` sends LAB to RGB(A) through ImageCms: a LittleCMS
transform from `cmsCreateLab2Profile(NULL)` (D50) to `cmsCreate_sRGBProfile()`,
perceptual intent, no flags, 8-bit LAB (PT_LabV2, its a and b offset by 128
as PIL holds them) to 8-bit RGB. LittleCMS optimizes that transform into one
CLUT stage of 33 x 33 x 33 nodes of three 16-bit outputs, which its 8-bit
evaluator (PrelinEval8: the inputs x 257 into the fixed domain, then
tetrahedral interpolation) reads. This script builds the same transform
through Pillow's bundled LittleCMS by ctypes, takes that CLUT from the
transform's optimized pipeline (`_cmsTRANSFORM.Lut` at byte 112, checked by
its stage count and type), holds the evaluator (`lab_rgb` below, as
csrc/image_formats.cpp computes it) to PIL's convert on all 2^24 inputs, and
writes the table. Needs PIL.
"""

from __future__ import annotations

import ctypes as C
import glob
import os
import struct
import sys

import numpy as np
import PIL
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tracy_tpu_torch", "csrc", "lab_table.h")
GRID = 33


def lcms_clut() -> np.ndarray:
    """The optimized transform's CLUT, uint16 [33 * 33 * 33 * 3], L slowest."""
    path = glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs",
                                  "liblcms2-*.so*"))[0]
    lib = C.CDLL(path)
    vp = C.c_void_p
    for name, res, args in (("cmsCreateLab2Profile", vp, [vp]), ("cmsCreate_sRGBProfile", vp, []),
                            ("cmsCreateTransform", vp, [vp, C.c_uint32, vp, C.c_uint32,
                                                        C.c_uint32, C.c_uint32]),
                            ("cmsPipelineStageCount", C.c_uint32, [vp]),
                            ("cmsPipelineGetPtrToFirstStage", vp, [vp]),
                            ("cmsStageType", C.c_uint32, [vp]), ("cmsStageData", vp, [vp])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args

    def fmt(space, extra):  # COLORSPACE_SH | CHANNELS_SH(3) | BYTES_SH(1) | EXTRA_SH
        return space << 16 | 3 << 3 | 1 | extra << 7

    # Pillow's "LAB" (PT_LabV2 = 30, one extra byte) and "RGB" (PT_RGB = 4).
    xform = lib.cmsCreateTransform(lib.cmsCreateLab2Profile(None), fmt(30, 1),
                                   lib.cmsCreate_sRGBProfile(), fmt(4, 1), 0, 0)
    lut = struct.unpack("<Q", C.string_at(xform + 112, 8))[0]
    if lib.cmsPipelineStageCount(lut) != 1:
        raise SystemExit("the optimized LAB transform is not one stage")
    stage = lib.cmsPipelineGetPtrToFirstStage(lut)
    if struct.pack(">I", lib.cmsStageType(stage)) != b"clut":
        raise SystemExit("the optimized LAB transform's stage is not a CLUT")
    table, _, entries = struct.unpack("<QQI", C.string_at(lib.cmsStageData(stage), 20))
    if entries != GRID ** 3 * 3:
        raise SystemExit(f"a CLUT of {entries} entries, not 33^3 x 3")
    return np.frombuffer(C.string_at(table, entries * 2), "<u2").astype(np.int64)


def lab_rgb(tab: np.ndarray, L, A, B) -> np.ndarray:
    """LittleCMS's PrelinEval8 of `tab` at 8-bit (L, a + 128, b + 128), then
    its 16- to 8-bit output rounding: uint8 RGB [..., 3]."""
    opta = (3, 3 * GRID, 3 * GRID * GRID)
    v = np.arange(256) * 257 * (GRID - 1)
    v = v + (v + 0x7FFF) // 0xFFFF  # _cmsToFixedDomain
    node, rest = v >> 16, v & 0xFFFF
    X0, Y0, Z0 = opta[2] * node[L], opta[1] * node[A], opta[0] * node[B]
    rx, ry, rz = rest[L], rest[A], rest[B]
    X1 = X0 + np.where(rx == 0, 0, opta[2])
    Y1 = Y0 + np.where(ry == 0, 0, opta[1])
    Z1 = Z0 + np.where(rz == 0, 0, opta[0])
    out = []
    for ch in range(3):
        def d(x, y, z):
            return tab[x + y + z + ch]
        c0 = d(X0, Y0, Z0)
        cases = [
            ((rx >= ry) & (ry >= rz), d(X1, Y0, Z0) - c0, d(X1, Y1, Z0) - d(X1, Y0, Z0),
             d(X1, Y1, Z1) - d(X1, Y1, Z0)),
            ((rx >= rz) & (rz >= ry), d(X1, Y0, Z0) - c0, d(X1, Y1, Z1) - d(X1, Y0, Z1),
             d(X1, Y0, Z1) - d(X1, Y0, Z0)),
            ((rz >= rx) & (rx >= ry), d(X1, Y0, Z1) - d(X0, Y0, Z1),
             d(X1, Y1, Z1) - d(X1, Y0, Z1), d(X0, Y0, Z1) - c0),
            ((ry >= rx) & (rx >= rz), d(X1, Y1, Z0) - d(X0, Y1, Z0), d(X0, Y1, Z0) - c0,
             d(X1, Y1, Z1) - d(X1, Y1, Z0)),
            ((ry >= rz) & (rz >= rx), d(X1, Y1, Z1) - d(X0, Y1, Z1), d(X0, Y1, Z0) - c0,
             d(X0, Y1, Z1) - d(X0, Y1, Z0)),
            ((rz >= ry) & (ry >= rx), d(X1, Y1, Z1) - d(X0, Y1, Z1),
             d(X0, Y1, Z1) - d(X0, Y0, Z1), d(X0, Y0, Z1) - c0),
        ]
        c1, c2, c3 = (np.zeros_like(c0) for _ in range(3))
        done = np.zeros(c0.shape, bool)
        for cond, v1, v2, v3 in cases:
            sel = cond & ~done
            c1, c2, c3 = np.where(sel, v1, c1), np.where(sel, v2, c2), np.where(sel, v3, c3)
            done |= sel
        r = c1 * rx + c2 * ry + c3 * rz + 0x8001
        o16 = (c0 + ((r + (r >> 16)) >> 16)) & 0xFFFF
        out.append((o16 * 65281 + 8388608) >> 24 & 0xFF)  # FROM_16_TO_8
    return np.stack(out, -1)


def check(tab: np.ndarray):
    """lab_rgb against PIL's LAB -> RGB on every 8-bit input."""
    for L0 in range(0, 256, 16):
        L, A, B = np.meshgrid(np.arange(L0, L0 + 16), np.arange(256), np.arange(256),
                              indexing="ij")
        raw = np.stack([L, A ^ 128, B ^ 128], -1).astype(np.uint8)  # PIL's "LAB" rawmode
        ref = np.asarray(Image.frombytes("LAB", (256, 16 * 256), raw.tobytes()).convert("RGB"))
        if not np.array_equal(lab_rgb(tab, L, A, B), ref.reshape(16, 256, 256, 3)):
            raise SystemExit(f"the evaluator differs from PIL at L {L0}-{L0 + 15}")
    print("every 2^24 LAB input equal to PIL's convert")


def main():
    tab = lcms_clut()
    check(tab)
    lines = [", ".join(str(int(v)) for v in tab[i:i + 16]) + "," for i in range(0, len(tab), 16)]
    with open(OUT, "w") as f:
        f.write("// PIL's LAB -> sRGB colour lookup table (LittleCMS's optimized transform\n"
                "// from its Lab2 D50 profile to its sRGB profile, perceptual intent):\n"
                "// 33 x 33 x 33 nodes of 16-bit R, G, B, L slowest, then a + 128, then\n"
                "// b + 128. Written by tools/make_lab_table.py, which takes it from\n"
                "// Pillow's bundled LittleCMS and checks its evaluation against PIL on\n"
                "// every 8-bit input. Do not edit.\n\n#pragma once\n\n#include <cstdint>\n\n"
                f"static const uint16_t kLabClut[{len(tab)}] = {{\n")
        f.write("\n".join("    " + ln for ln in lines) + "\n};\n")
    print(f"wrote {OUT} ({len(tab)} entries)")


if __name__ == "__main__":
    sys.exit(main())
