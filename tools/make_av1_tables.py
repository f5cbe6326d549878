"""Write tracy_tpu_torch/csrc/av1_tables.h: the constant tables of the AV1
Bitstream & Decoding Process Specification (2019, with errata) that the
port's AVIF decoder (csrc/av1_decode.cpp) needs.

    python tools/make_av1_tables.py   (needs Pillow's wheel, about 2 s)

The specification lists its default CDFs, quantizer lookups, quantizer
matrices, intra filter taps and weights, loop-restoration parameters and
film grain's Gaussian sequence as literal tables. libaom and dav1d carry
the same tables, and both are inside the libavif that Pillow's wheel
bundles (pillow.libs/libavif-*.so; BSD-2-Clause). This script reads each
table from libaom's copy in that library, located by the first values the
specification gives it and held to the table's shape (every CDF a
non-increasing run of 32768 - cdf values ending in 0 and a zero counter,
a quantizer lookup increasing, the matrices positive), and checks the
small CDFs it writes from the specification against dav1d's copy. CDFs
are written as libaom lays them out: 32768 - cdf[i] for each symbol but
the last, 0, then the adaptation counter (also 0), each padded to the
table's largest symbol count. The scan orders, which the specification
derives by a rule, are computed by it here (the decoder computes them
again) and checked against libaom's tables, which store them transposed.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import PIL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tracy_tpu_torch", "csrc", "av1_tables.h")


def library() -> bytes:
    libs = glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs",
                                  "libavif-*.so*"))
    if not libs:
        raise SystemExit("Pillow's wheel carries no libavif")
    with open(libs[0], "rb") as f:
        return f.read()


LIB = library()


def find(values, dtype) -> list:
    """Offsets in the library of the run of `values` as `dtype`."""
    pat = np.asarray(values, dtype=dtype).tobytes()
    hits, i = [], LIB.find(pat)
    while i != -1:
        hits.append(i)
        i = LIB.find(pat, i + 1)
    return hits


def read(off: int, count: int, dtype) -> np.ndarray:
    return np.frombuffer(LIB[off:off + count * np.dtype(dtype).itemsize], dtype=dtype).copy()


def icdf(*cum) -> list:
    return [32768 - c for c in cum]


def cdf_table(first: list, shape: tuple, symbols) -> np.ndarray:
    """A table of CDFs in libaom's layout whose first entry begins with the
    32768 - cdf values `first`: shape[-1] is the stride (largest symbol count
    + 1); `symbols(index)` the symbol count of the CDF at that index. The one
    run of `first` at which every CDF of the shape is well formed."""
    count = int(np.prod(shape))
    found = []
    for off in find(first, "<u2"):
        t = read(off, count, "<u2").reshape(shape)
        ok = True
        for idx in np.ndindex(*shape[:-1]):
            n, c = symbols(idx), t[idx]
            v = c[:n - 1].astype(int)
            if n < 2 or not ((v > 0).all() and (v < 32768).all() and (np.diff(v) <= 0).all()
                             and (c[n - 1:] == 0).all()):
                ok = False
                break
        if ok:
            found.append(t)
    if len(found) < 1 or any((f != found[0]).any() for f in found):
        raise SystemExit(f"table starting {first} not found once ({len(found)} runs)")
    return found[0]


def small_cdfs(rows: list, n: int) -> np.ndarray:
    """CDFs the specification gives, padded to libaom's layout, each checked
    to occur in the library (dav1d's copy)."""
    out = np.zeros((len(rows), n + 1), np.uint16)
    for k, r in enumerate(rows):
        if not find(r, "<u2"):
            raise SystemExit(f"CDF {r} is not in the library")
        out[k, :len(r)] = r
    return out


def scan(w: int, h: int, kind: str) -> np.ndarray:
    """The specification's scan of a w x h block as raster positions
    (row * w + col): 'row' and 'col' in raster and column order; 'default'
    by anti-diagonals, alternating on squares, each from the top row on
    tall blocks and from the left column on wide ones."""
    if kind == "row":
        return np.arange(w * h)
    if kind == "col":
        return np.array([r * w + c for c in range(w) for r in range(h)])
    out = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(h) if 0 <= d - r < w]  # row increasing
        if (w == h and d % 2 == 0) or w > h:
            cells.reverse()
        out += [r * w + c for r, c in cells]
    return np.array(out)


def check_scans():
    """Each default scan (and row, col) of the sizes up to 32, transposed as
    libaom stores them (column-major positions), is in the library."""
    for w, h in ((4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16), (16, 8),
                 (16, 32), (32, 16), (4, 16), (16, 4), (8, 32), (32, 8)):
        for kind in ("default",) + (("row", "col") if max(w, h) <= 16 else ()):
            s = scan(w, h, kind)
            aom = [(p % w) * h + p // w for p in s]
            if not find(aom, "<i2"):
                raise SystemExit(f"{kind} scan {w}x{h} not found")


def c_array(name: str, ctype: str, arr: np.ndarray) -> str:
    dims = "".join(f"[{d}]" for d in arr.shape)
    flat = arr.reshape(-1)
    lines, line = [], ""
    for v in flat:
        item = f"{int(v)},"
        if len(line) + len(item) > 96:
            lines.append(line)
            line = ""
        line += item
    lines.append(line)
    return f"static const {ctype} {name}{dims} = {{\n" + "\n".join(lines) + "\n};\n"


def main():
    check_scans()
    T = []  # (name, ctype, array)
    u16 = "uint16_t"

    # Mode CDFs (specification section 9.4 / libaom entropymode.c).
    T.append(("kKfYModeCdf", u16, cdf_table(icdf(15588, 17027, 19338), (5, 5, 14), lambda i: 13)))
    T.append(("kAngleDeltaCdf", u16, cdf_table(icdf(2180, 5032, 7567), (8, 8), lambda i: 7)))
    T.append(("kUvModeCdf", u16, cdf_table(icdf(22631, 24152, 25378), (2, 13, 15),
                                            lambda i: 13 + i[0])))
    T.append(("kPartitionCdf", u16, cdf_table(icdf(19132, 25510, 30392), (20, 11),
                                               lambda i: 4 if i[0] < 4 else 8 if i[0] >= 16
                                               else 10)))
    intra_tx = np.zeros((3, 4, 13, 17), np.uint16)
    intra_tx[1:] = cdf_table(icdf(1535, 8035, 9461), (2, 4, 13, 17), lambda i: 7 if i[0] == 0
                             else 5)
    T.append(("kIntraTxTypeCdf", u16, intra_tx))
    inter_tx = np.zeros((4, 4, 17), np.uint16)
    inter_tx[1:] = cdf_table(icdf(4458, 5560, 7695), (3, 4, 17), lambda i: (16, 12, 2)[i[0]])
    T.append(("kInterTxTypeCdf", u16, inter_tx))
    T.append(("kCflAlphaCdf", u16, cdf_table(icdf(7637, 20719, 31401), (6, 17), lambda i: 16)))
    T.append(("kCflSignCdf", u16, small_cdfs([icdf(1418, 2123, 13340, 18405, 26972, 28343,
                                                       32294)], 8)[0]))
    T.append(("kFilterIntraCdf", u16, cdf_table(icdf(4621), (22, 3), lambda i: 2)))
    T.append(("kFilterIntraModeCdf", u16, small_cdfs([icdf(8949, 12776, 17211, 29558)], 5)[0]))
    T.append(("kPaletteYSizeCdf", u16, cdf_table(icdf(7952, 13000, 18149), (7, 8), lambda i: 7)))
    T.append(("kPaletteUvSizeCdf", u16, cdf_table(icdf(8713, 19979, 27128), (7, 8),
                                                   lambda i: 7)))
    T.append(("kPaletteYModeCdf", u16, cdf_table(icdf(31676) + [0, 0] + icdf(3419), (7, 3, 3),
                                                  lambda i: 2)))
    T.append(("kPaletteUvModeCdf", u16, small_cdfs([icdf(32461), icdf(21488)], 2)))
    pal_sym = lambda i: i[0] + 2  # noqa: E731
    T.append(("kPaletteYColorCdf", u16, cdf_table(icdf(28710) + [0] * 8 + icdf(16384), (7, 5, 9),
                                                   pal_sym)))
    T.append(("kPaletteUvColorCdf", u16, cdf_table(icdf(29089) + [0] * 8 + icdf(16384),
                                                    (7, 5, 9), pal_sym)))
    T.append(("kTxfmSplitCdf", u16, cdf_table(icdf(28581), (21, 3), lambda i: 2)))
    T.append(("kTxSizeCdf", u16, cdf_table(icdf(19968) + [0, 0, 0] + icdf(19968), (4, 3, 4),
                                            lambda i: 2 if i[0] == 0 else 3)))
    T.append(("kSkipCdf", u16, small_cdfs([icdf(31671), icdf(16515), icdf(4576)], 2)))
    T.append(("kIntrabcCdf", u16, small_cdfs([icdf(30531)], 2)[0]))
    T.append(("kDeltaQCdf", u16, small_cdfs([icdf(28160, 32120, 32677)], 4)[0]))
    T.append(("kSegmentIdCdf", u16, small_cdfs([icdf(5622, 7893, 16093, 18233, 27809, 28373, 32533),
                                                 icdf(14274, 18230, 22557, 24935, 29980, 30851,
                                                      32344),
                                                 icdf(27527, 28487, 28723, 28890, 32397, 32647,
                                                      32679)], 8)))
    T.append(("kRestoreSwitchableCdf", u16, small_cdfs([icdf(9413, 22581)], 3)[0]))
    T.append(("kRestoreWienerCdf", u16, small_cdfs([icdf(11570)], 2)[0]))
    T.append(("kRestoreSgrprojCdf", u16, small_cdfs([icdf(16855)], 2)[0]))
    # The motion vector CDFs (intra block copy's vectors): joints, then per
    # component classes, class0_fp[2], fp, sign, class0_hp, hp, class0,
    # bits[10], contiguous in libaom's nmv_context.
    mv = cdf_table(icdf(4096, 11264, 19328), (1, 5), lambda i: 4)
    off = find(icdf(4096, 11264, 19328) + [0, 0] + icdf(28672, 30976, 31858), "<u2")[0]
    comp = read(off + 10, 12 + 10 + 5 + 3 * 4 + 30, "<u2")
    if not (comp[:12] == cdf_table(icdf(28672, 30976, 31858), (1, 12), lambda i: 11)[0]).all():
        raise SystemExit("mv classes do not follow the joints")
    T.append(("kMvJointCdf", u16, mv[0]))
    T.append(("kMvClassCdf", u16, comp[:12]))
    T.append(("kMvClass0Cdf", u16, comp[12 + 10 + 5 + 9:12 + 10 + 5 + 12]))
    T.append(("kMvBitsCdf", u16, comp[12 + 10 + 5 + 12:].reshape(10, 3)))
    if not (T[-1][2][:, 0] == [32768 - 128 * x for x in (136, 140, 148, 160, 176, 192, 224, 234,
                                                         234, 240)]).all():
        raise SystemExit("mv bits CDFs are not the specification's")

    # Coefficient CDFs, by q-index context (libaom token_cdfs.h).
    T.append(("kTxbSkipCdf", u16, cdf_table(icdf(31849), (4, 5, 13, 3), lambda i: 2)))
    T.append(("kEobExtraCdf", u16, cdf_table(icdf(16961) + [0, 0] + icdf(17223), (4, 5, 2, 9, 3),
                                              lambda i: 2)))
    T.append(("kDcSignCdf", u16, cdf_table(icdf(128 * 125) + [0, 0] + icdf(128 * 102),
                                            (4, 2, 3, 3), lambda i: 2)))
    for n, first in ((16, icdf(840, 1039, 1980, 4895)), (32, icdf(400, 520, 977, 2102, 6542)),
                     (64, icdf(329, 498, 1101, 1784, 3265, 7758)),
                     (128, icdf(219, 482, 1140, 2091, 3680, 6028, 12586)),
                     (256, icdf(310, 584, 1887, 3589, 6168, 8611, 11352, 15652)),
                     (512, icdf(641, 983, 3707, 5430, 10234, 14958, 18788, 23412, 26061)),
                     (1024, icdf(393, 421, 751, 1623, 3160, 6352, 13345, 18047, 22571, 25830))):
        syms = {16: 5, 32: 6, 64: 7, 128: 8, 256: 9, 512: 10, 1024: 11}[n]
        T.append((f"kEobPt{n}Cdf", u16, cdf_table(first, (4, 2, 2, syms + 1), lambda i: syms)))
    T.append(("kCoeffBaseEobCdf", u16, cdf_table(icdf(17837, 29055), (4, 5, 2, 4, 4),
                                                  lambda i: 3)))
    T.append(("kCoeffBaseCdf", u16, cdf_table(icdf(4034, 8930, 12727), (4, 5, 2, 42, 5),
                                               lambda i: 4)))
    T.append(("kCoeffBrCdf", u16, cdf_table(icdf(14298, 20718, 24174), (4, 5, 2, 21, 5),
                                             lambda i: 4)))

    # Quantizer lookups (Dc_Qlookup, Ac_Qlookup) at 8, 10 and 12 bits.
    dc = np.stack([read(find(f, "<i2")[0], 256, "<i2") for f in
                   ([4, 8, 8, 9, 10, 11, 12, 12, 13], [4, 9, 10, 13, 15, 17, 20, 22, 25],
                    [4, 12, 18, 25, 33, 41, 50, 60, 70])])
    ac = np.stack([read(find(f, "<i2")[0], 256, "<i2") for f in
                   ([4, 8, 9, 10, 11, 12, 13, 14, 15], [4, 9, 11, 13, 16, 18, 21, 24, 27],
                    [4, 13, 19, 27, 35, 44, 54, 64, 75])])
    for t in (dc, ac):
        if not (np.diff(t.astype(int), axis=1) >= 0).all():
            raise SystemExit("a quantizer lookup does not increase")
    T.append(("kDcQLookup", "int16_t", dc))
    T.append(("kAcQLookup", "int16_t", ac))
    # Quantizer_Matrix[15][2][3344] (the decoder's weights of levels 0-14;
    # level 15 is flat and not stored).
    qm_off = find([32, 43, 73, 97, 43, 67, 94, 110, 73, 94, 137, 150, 97, 110, 150, 200], "u1")
    qm = read(qm_off[0], 15 * 2 * 3344, "u1").reshape(15, 2, 3344)
    if not ((qm > 0).all() and (abs(qm[14].astype(int) - 32) <= 2).all()):
        raise SystemExit("quantizer matrices malformed")
    T.append(("kQuantizerMatrix", "uint8_t", qm))

    # Intra prediction.
    sm = read(find([255, 149, 85, 64, 255, 197, 146, 105], "u1")[0], 4 + 8 + 16 + 32 + 64, "u1")
    T.append(("kSmWeights", "uint8_t", sm))  # 4, 8, 16, 32 and 64 entries in turn
    T.append(("kDrIntraDerivative", "int16_t",
              read(find([0, 0, 0, 1023, 0, 0, 547, 0, 0, 372], "<i2")[0], 90, "<i2")))
    T.append(("kFilterIntraTaps", "int8_t",
              read(find([-6, 10, 0, 0, 0, 12, 0, 0, -5, 2, 10], "i1")[0], 5 * 8 * 7 + 40,
                   "i1")[:5 * 8 * 8].reshape(5, 8, 8)[..., :7].copy()))
    # Loop restoration: Sgr_Params[16][4] (r0, e0, r1, e1), x / (x + 1)
    # scaled by 256, and the reciprocals 4096 / n.
    sgr = read(find([2, 1, 140, 3236, 2, 1, 112, 2158], "<i4")[0], 64, "<i4").reshape(16, 4)
    T.append(("kSgrParams", "int32_t", sgr[:, [0, 2, 1, 3]].copy()))
    T.append(("kXByXPlus1", "int32_t",
              read(find([1, 128, 171, 192, 205, 213, 219, 224], "<i4")[0], 256, "<i4")))
    T.append(("kOneByX", "int32_t",
              read(find([4096, 2048, 1365, 1024, 819, 683], "<i4")[0], 25, "<i4")))
    # Transforms: cos128 and sin128 of multiples of pi / 128 at 12 bits, and
    # the four sinpi constants of the 4-point ADST.
    T.append(("kCos128", "int32_t",
              read(find([4096, 4095, 4091, 4085, 4076, 4065], "<i4")[0], 65, "<i4")[:64]))
    T.append(("kSinPi", "int32_t", read(find([0, 1321, 2482, 3344, 3803], "<i4")[0], 5, "<i4")))
    # Film grain.
    T.append(("kGaussianSequence", "int16_t",
              read(find([56, 568, -180, 172, 124, -84, 172, -64, -900, 24], "<i2")[0], 2048,
                   "<i2")))

    with open(OUT, "w") as f:
        f.write("// The constant tables of the AV1 Bitstream & Decoding Process Specification\n"
                "// (default CDFs, quantizer lookups and matrices, intra filter taps and\n"
                "// weights, loop-restoration and transform constants, film grain's Gaussian\n"
                "// sequence) used by av1_decode.cpp. Written by tools/make_av1_tables.py,\n"
                "// which reads them from libaom's copy in Pillow's bundled libavif and\n"
                "// checks them there; do not edit. CDFs are in libaom's layout: 32768 - cdf\n"
                "// per symbol but the last, 0, then the adaptation counter.\n\n"
                "#pragma once\n\n#include <cstdint>\n\nnamespace av1 {\n\n")
        for name, ctype, arr in T:
            f.write(c_array(name, ctype, np.asarray(arr)) + "\n")
        f.write("}  // namespace av1\n")
    print(f"wrote {OUT}: {len(T)} tables")


if __name__ == "__main__":
    main()
