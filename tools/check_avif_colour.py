"""Check csrc/image_avif.cpp's colour arithmetic against libavif's own
avifImageYUVToRGB, the function PIL's AVIF decoder calls, through ctypes
on Pillow's bundled libavif 1.3:

- libyuv's integer rows, for every (y, u, v) of 8 bits (4096x4096 4:4:4
  images): y1 = (y * 0x0101 * yg >> 16) + yb, then (y1 + chroma terms)
  >> 6, with the constants of each matrix and range that libavif hands to
  libyuv (BT.601 as 2, 5 and 6; BT.709; BT.2020 NCL);
- libyuv's bilinear chroma upsampling of 4:2:0 and 4:2:2 (3:1 and
  9:3:3:1 toward the nearer sample, an odd width's last column
  unfiltered), on random planes of odd and even sizes;
- libavif's float path (matrices 4, 7, 8 and limited-range grey) on
  random planes, 4:2:0 included;
- libyuv's x86 unattenuate of premultiplied alpha for every (c, a);
- the routes of 10- and 12-bit samples (`check_deep`): into RGB, libyuv
  after Convert16To8Plane (v >> (depth - 8)); into RGBA from 10-bit colour
  (and 12-bit 4:2:0, chroma repeated), libyuv's high-depth rows, whose
  luma repeats its bits to 16 and whose chroma, filtered at the depth, is
  >> (depth - 8). Over every (y, u) and every (y, v) of 10 bits with the
  other sample random, and 2^22 random triples of 10 and 12 bits, besides
  random planes of each route: grey into RGBA (I400 and libavif's alpha),
  libavif's float rows at the depth, its slow rows' float unpremultiply.

    cd tools && python check_avif_colour.py   (about 30 s, 2 GB)

Prints one line per check and exits non-zero at the first difference.
These are the constants and rules of the port's decoder: they were
fitted by searching integer values against these same outputs, and this
script checks them on every input.
"""

from __future__ import annotations

import ctypes as C
import struct
import sys

import numpy as np

from make_avif_fixtures import libavif

# (full range, matrix coefficients) -> (yg, yb, vr, ub, ug, vg), as
# image_avif.cpp's libyuv_constants.
LIBYUV = {(1, 6): (16320, 32, 90, 113, 22, 46), (1, 1): (16320, 32, 101, 119, 12, 30),
          (1, 9): (16320, 32, 94, 120, 11, 37), (0, 6): (18997, -1160, 102, 128, 25, 52),
          (0, 1): (18997, -1160, 115, 128, 14, 34), (0, 9): (19003, -1160, 107, 128, 12, 42)}
KR_KB = {4: (0.30, 0.11), 7: (0.212, 0.087), 1: (0.2126, 0.0722), 6: (0.299, 0.114)}


def convert(planes, fmt, full, mc, alpha=None, premultiplied=False, depth=8):
    """avifImageYUVToRGB of planes into RGB(A)8, as PIL asks for it."""
    lib = libavif()
    formats = {"444": 1, "422": 2, "420": 3, "400": 4}
    h, w = planes[0].shape
    im = lib.avifImageCreate(w, h, depth, formats[fmt])
    C.memmove(im + 16, struct.pack("<I", full), 4)
    C.memmove(im + 104, struct.pack("<3H", 9 if mc == 9 else 1, 13, mc), 6)
    lib.avifImageAllocatePlanes(im, 1 if alpha is None else 3)
    ptr = struct.unpack("<3Q", C.string_at(im + 24, 24))
    rows = struct.unpack("<3I", C.string_at(im + 48, 12))
    pairs = list(zip(planes, ptr, rows))
    if alpha is not None:
        aptr, arow = struct.unpack("<QI", C.string_at(im + 64, 12))
        pairs.append((alpha, aptr, arow))
        C.memmove(im + 80, struct.pack("<I", int(premultiplied)), 4)
    for p, at, rb in pairs:
        p = np.ascontiguousarray(p, np.uint8 if depth == 8 else np.uint16)
        for r in range(p.shape[0]):
            C.memmove(at + r * rb, p[r].ctypes.data, p.shape[1] * p.itemsize)
    rgb = C.create_string_buffer(64)
    lib.avifRGBImageSetDefaults(rgb, im)
    channels = 3 if alpha is None else 4
    C.memmove(C.addressof(rgb) + 8, struct.pack("<II", 8, 0 if alpha is None else 1), 8)
    lib.avifRGBImageAllocatePixels(rgb)
    if lib.avifImageYUVToRGB(im, rgb):
        raise RuntimeError("avifImageYUVToRGB failed")
    pix, rowb = struct.unpack("<QI", rgb.raw[48:60])
    out = np.frombuffer(C.string_at(pix, rowb * h), np.uint8).reshape(h, rowb)
    out = out[:, :w * channels].reshape(h, w, channels).astype(np.int64)
    lib.avifRGBImageFreePixels(rgb)
    lib.avifImageDestroy(im)
    return out


def integer_rgb(y, u, v, k, depth=8):
    """libyuv's rows of 8-bit chroma and luma of `depth` bits (its bits
    repeated to 16)."""
    yg, yb, vr, ub, ug, vg = k
    y16 = y * 0x0101 if depth == 8 else (y << (16 - depth)) | (y >> (2 * depth - 16))
    y1 = ((y16 * yg) >> 16) + yb
    return np.clip(np.stack([(y1 + (v - 128) * vr) >> 6,
                             (y1 - ((u - 128) * ug + (v - 128) * vg)) >> 6,
                             (y1 + (u - 128) * ub) >> 6], -1), 0, 255)


def upsample_libyuv(c, sx, sy, h, w):
    ch, cw = c.shape
    y, x = np.mgrid[0:h, 0:w]
    last = sx & (w & 1) & (x == w - 1)
    cx = np.where(sx == 0, x, np.where(last, x >> 1, (x - 1) >> 1))
    wx1 = np.where(sx & ~last, np.where(x & 1, 1, 3), 0)
    cy = (y - 1) >> 1 if sy else y
    wy1 = np.where(y & 1, 1, 3) if sy else np.zeros_like(y)
    at = lambda yy, xx: c[np.clip(yy, 0, ch - 1), np.clip(xx, 0, cw - 1)].astype(np.int64)  # noqa
    if sx and sy:
        return (at(cy, cx) * (4 - wx1) * (4 - wy1) + at(cy, cx + 1) * wx1 * (4 - wy1)
                + at(cy + 1, cx) * (4 - wx1) * wy1 + at(cy + 1, cx + 1) * wx1 * wy1 + 8) >> 4
    return (at(cy, cx) * (4 - wx1) + at(cy, cx + 1) * wx1 + 2) >> 2


def float_rgb(planes, fmt, full, mc, depth=8, alpha=None, premultiplied=False):
    """libavif's avifImageYUVAnyToRGBAnySlow in float32 (numpy float32
    operations round each step as the library does without contraction);
    with `premultiplied` alpha, its float unpremultiply, min(c / a, 1)."""
    f = np.float32
    s, top = depth - 8, f((1 << depth) - 1)
    y = planes[0].astype(f)
    h, w = y.shape
    yf = (y - f(0 if full else 16 << s)) / (top if full else f(219 << s))
    if fmt == "400":
        r = g = b = yf
    elif mc == 0:
        g, b, r = (p.astype(f) / top for p in planes)
    else:
        sx, sy = {"444": (0, 0), "422": (1, 0), "420": (1, 1)}[fmt]
        uv = [(p.astype(f) - f(128 << s)) / (top if full else f(224 << s)) for p in planes[1:]]
        jj, ii = np.mgrid[0:h, 0:w]
        ui, uj = ii >> sx, jj >> sy
        if sx or sy:
            adj_c = np.where((ii == 0) | ((ii == w - 1) & (ii & 1 == 1)), 0,
                             np.where(ii & 1, 1, -1))
            adj_r = np.zeros_like(jj) if not sy else np.where(
                (jj == 0) | ((jj == h - 1) & (jj & 1 == 1)), 0, np.where(jj & 1, 1, -1))
            cb, cr = [p[uj, ui] * f(9 / 16) + p[uj, ui + adj_c] * f(3 / 16)
                      + p[uj + adj_r, ui] * f(3 / 16) + p[uj + adj_r, ui + adj_c] * f(1 / 16)
                      for p in uv]
        else:
            cb, cr = uv[0][uj, ui], uv[1][uj, ui]
        if mc == 8:
            t = yf - cb
            g, b, r = yf + cb, t - cr, t + cr
        else:
            kr, kb = (f(x) for x in KR_KB[mc])
            kg = f(1) - kr - kb
            r = yf + (f(2) * (f(1) - kr)) * cr
            b = yf + (f(2) * (f(1) - kb)) * cb
            g = yf - ((f(2) * ((kr * (f(1) - kr) * cr) + (kb * (f(1) - kb) * cb))) / kg)
    out = [np.clip(c, f(0), f(1)) for c in (r, g, b)]
    if premultiplied:
        a = alpha.astype(f) / top
        with np.errstate(divide="ignore", invalid="ignore"):
            out = [np.where(a >= f(1), c, np.where(a > f(0), np.minimum(c / a, f(1)), f(0)))
                   for c in out]
    return np.stack([(f(0.5) + c * f(255)).astype(np.int64) for c in out], -1)


def unattenuate(c, a):
    ia = np.where(a == 0, 0, np.where(a == 1, 0xFFFF, 0x10000 // np.maximum(a, 1)))
    x = (c * 257 * ia) >> 16
    return np.where(a == 255, c, np.where(x > 32767, 0, np.minimum(x, 255)))


def alpha_float(a, depth):
    f = np.float32
    return (f(0.5) + a.astype(f) / f((1 << depth) - 1) * f(255)).astype(np.int64)


def check_deep(rng):
    """The routes of 10- and 12-bit samples (image_avif.cpp's to_rgba)."""
    # Into RGB: Convert16To8Plane, then the 8-bit rows.
    for depth in (10, 12):
        y, u, v = (rng.integers(0, 1 << depth, (2048, 2048)) for _ in range(3))
        for (full, mc), k in LIBYUV.items():
            s = depth - 8
            check(f"libyuv 4:4:4 full={full} mc={mc} {depth}-bit into RGB, 2^22 random",
                  integer_rgb(y >> s, u >> s, v >> s, k), convert([y, u, v], "444", full, mc,
                                                                  depth=depth))
    # Into RGBA at 10 bits: the high-depth rows, over every (y, u) and (y, v).
    yy, cc = (a.reshape(1024, 1024) for a in np.meshgrid(np.arange(1024), np.arange(1024),
                                                          indexing="ij"))
    other = rng.integers(0, 1024, (1024, 1024))
    a = rng.integers(0, 1024, (1024, 1024))
    for (full, mc), k in LIBYUV.items():
        for u, v in ((cc, other), (other, cc)):
            got = convert([yy, u, v], "444", full, mc, alpha=a, depth=10)
            check(f"libyuv I410Alpha full={full} mc={mc}, every (y, {'u' if u is cc else 'v'})",
                  np.concatenate([integer_rgb(yy, u >> 2, v >> 2, k, 10), (a >> 2)[..., None]],
                                 -1), got)
    # Chroma filtered at the depth (10 bits), or repeated (12-bit 4:2:0), then
    # premultiplied; 12-bit 4:2:2 and 4:4:4 go down to 8 bits, alpha too.
    k = LIBYUV[(0, 1)]
    for depth, fmt in ((10, "420"), (10, "422"), (12, "420"), (12, "422"), (12, "444")):
        sx, sy = {"444": (0, 0), "422": (1, 0), "420": (1, 1)}[fmt]
        for prem in (False, True):
            h, w = 37, 45
            y, a = (rng.integers(0, 1 << depth, (h, w)) for _ in range(2))
            u, v = (rng.integers(0, 1 << depth, ((h + sy) >> sy, (w + sx) >> sx)) for _ in range(2))
            s = depth - 8
            if depth == 12 and fmt == "420":
                jj, ii = np.mgrid[0:h, 0:w]
                rgb = integer_rgb(y, u[jj >> 1, ii >> 1] >> s, v[jj >> 1, ii >> 1] >> s, k, 12)
                a8 = alpha_float(a, depth)
            elif depth == 10:
                up = [upsample_libyuv(c, sx, sy, h, w) >> s for c in (u, v)]
                rgb, a8 = integer_rgb(y, *up, k, 10), a >> s
            else:
                up = [upsample_libyuv(c >> s, sx, sy, h, w) if sx else c >> s for c in (u, v)]
                rgb, a8 = integer_rgb(y >> s, *up, k), a >> s
            if prem:
                rgb = unattenuate(rgb, a8[..., None])
            check(f"libyuv {depth}-bit {fmt} RGBA, premultiplied={prem}",
                  np.concatenate([rgb, a8[..., None]], -1),
                  convert([y, u, v], fmt, 0, 1, alpha=a, premultiplied=prem, depth=depth))
    # Grey into RGBA: I400 (chroma 128) after the shift, libavif's alpha.
    for depth in (8, 10, 12):
        y, a = (rng.integers(0, 1 << depth, (41, 47)) for _ in range(2))
        for full in (0, 1):
            a8 = alpha_float(a, depth)
            rgb = integer_rgb(y >> (depth - 8), 128, 128, LIBYUV[(full, 6)])
            check(f"libyuv I400 {depth}-bit full={full} RGBA, premultiplied",
                  np.concatenate([unattenuate(rgb, a8[..., None]), a8[..., None]], -1),
                  convert([y], "400", full, 6, alpha=a, premultiplied=True, depth=depth))
    # libavif's float rows at the depth: fast rows (grey, 4:4:4) store, then
    # unattenuate; slow rows (subsampled, YCgCo, deep identity) unpremultiply.
    for depth in (8, 10, 12):
        for fmt, full, mc in (("444", 1, 4), ("420", 0, 7), ("422", 1, 8), ("400", 0, 6),
                              ("444", 1, 0), ("444", 1, 8)):
            if mc == 0 and depth == 8:
                continue
            sx, sy = {"444": (0, 0), "422": (1, 0), "420": (1, 1), "400": (1, 1)}[fmt]
            h, w = 41, 47
            planes = [rng.integers(0, 1 << depth, (h, w))]
            if fmt != "400":
                planes += [rng.integers(0, 1 << depth, ((h + sy) >> sy, (w + sx) >> sx))
                           for _ in range(2)]
            check(f"libavif float {fmt} full={full} mc={mc} {depth}-bit RGB",
                  float_rgb(planes, fmt, full, mc, depth),
                  convert(planes, fmt, full, mc, depth=depth))
            if fmt == "400":
                continue
            a = rng.integers(0, 1 << depth, (h, w))
            a8 = alpha_float(a, depth)[..., None]
            slow = mc == 8 or fmt != "444" or mc == 0
            rgb = (float_rgb(planes, fmt, full, mc, depth, a, True) if slow
                   else unattenuate(float_rgb(planes, fmt, full, mc, depth), a8))
            check(f"libavif float {fmt} full={full} mc={mc} {depth}-bit RGBA, premultiplied",
                  np.concatenate([rgb, a8], -1),
                  convert(planes, fmt, full, mc, alpha=a, premultiplied=True, depth=depth))


def check(name, got, want):
    if not np.array_equal(got, want):
        print(f"{name}: differs at {np.argwhere(got != want)[:4].tolist()}")
        sys.exit(1)
    print(f"{name}: equal")


def main():
    rng = np.random.default_rng(1)
    yy, uu, vv = (a.reshape(4096, 4096) for a in np.meshgrid(*[np.arange(256)] * 3,
                                                              indexing="ij"))
    for (full, mc), k in LIBYUV.items():
        for m in ((2, 5, 6) if mc == 6 else (mc,)):
            want = convert([yy, uu, vv], "444", full, m)
            check(f"libyuv 4:4:4 full={full} mc={m}, all 2^24 inputs",
                  integer_rgb(yy, uu, vv, k), want)
    for fmt, sx, sy in (("420", 1, 1), ("422", 1, 0)):
        for h, w in ((10, 14), (11, 15)):
            y = rng.integers(0, 256, (h, w))
            u, v = (rng.integers(0, 256, ((h + sy) >> sy, (w + sx) >> sx)) for _ in range(2))
            want = convert([y, u, v], fmt, 1, 6)
            up = [upsample_libyuv(c, sx, sy, h, w) for c in (u, v)]
            check(f"libyuv bilinear {fmt} {h}x{w}", integer_rgb(y, *up, LIBYUV[(1, 6)]), want)
    for fmt, full, mc in (("444", 1, 4), ("420", 0, 7), ("422", 1, 8), ("420", 1, 8),
                          ("400", 0, 6)):
        h, w = 41, 47
        sx, sy = {"444": (0, 0), "422": (1, 0), "420": (1, 1), "400": (1, 1)}[fmt]
        planes = [rng.integers(0, 256, (h, w))]
        if fmt != "400":
            planes += [rng.integers(0, 256, ((h + sy) >> sy, (w + sx) >> sx)) for _ in range(2)]
        check(f"libavif float {fmt} full={full} mc={mc}", float_rgb(planes, fmt, full, mc),
              convert(planes, fmt, full, mc))
    c, a = np.meshgrid(np.arange(256), np.arange(256))
    got = convert([c, np.full_like(c, 128), np.full_like(c, 128)], "444", 1, 6, alpha=a,
                  premultiplied=True)[..., 0]
    ia = np.where(a == 0, 0, np.where(a == 1, 0xFFFF, 0x10000 // np.maximum(a, 1)))
    x = (c * 257 * ia) >> 16
    want = np.where(a == 255, c, np.where(x > 32767, 0, np.minimum(x, 255)))
    check("libyuv x86 unattenuate, every (c, a)", want, got)
    check_deep(rng)


if __name__ == "__main__":
    main()
