"""WebP decoding without PIL (csrc/image_webp.cpp) against tracy_tpu's,
which decodes every 8-bit texture through PIL (libwebp's WebPAnimDecoder).

The corpus is made from seeded numpy images: by PIL's encoder (lossy at
qualities 0-100 and methods 0 and 6, lossy with alpha at alpha_quality 100
and 40, lossless at methods 0-6 with 2, 4, 16, 200 and many colours, an
animation whose first frame is smaller than its canvas, a VP8X still with
ICCP and EXIF), by hand around PIL's bitstreams (ALPH chunks raw and
through VP8L with each filter, VP8X flag variants), and by the VP8 key
frame writer below for what PIL's encoder never writes (the simple loop
filter, filter level 0 under segment strengths, sharpness 1-7, segment and
mode deltas, 2, 4 and 8 token partitions, probability updates, scale
bits, every intra mode at every edge). Contracts:

* Every file decodes to PIL's open(...).convert("RGBA"), uint8 for uint8;
  the fixture maps and a few corpus files also through both packages'
  load_image_rgba (float32, equal).
* A file cut short, or a bitstream cut inside a consistent container,
  fails in the port exactly where PIL fails, and decodes to PIL's picture
  where PIL decodes it.
* Refused kinds (an interframe, a bad start code, truncation, a frame
  outside its canvas) raise ValueError naming them, fall back in both
  packages and are listed in builder.fallbacks; read_image takes WebP by
  content; a 1024x1024 lossy and a lossless map decode in under 1 s each.
"""

import io
import os
import struct
import time

import numpy as np
import pytest
from PIL import Image

from test_torch_image_decode import pil_bytes, port_load, smooth, write
from tracy_tpu.scene.textures import load_image_rgba as jax_load
from tracy_tpu_torch.utils import image_io

# --- RIFF containers


def chunk(kind: bytes, body: bytes) -> bytes:
    return kind + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")


def riff(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", len(body) + 4) + b"WEBP" + body


def vp8x(flags: int, w: int, h: int) -> bytes:
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
                 + (h - 1).to_bytes(3, "little"))


def chunks(data: bytes):
    """[(fourcc, payload)] of a RIFF WEBP file's top-level chunks."""
    out, at = [], 12
    while at + 8 <= len(data):
        (n,) = struct.unpack("<I", data[at + 4:at + 8])
        out.append((data[at:at + 4], data[at + 8:at + 8 + n]))
        at += 8 + n + (n & 1)
    return out


def payload(data: bytes, kind: bytes) -> bytes:
    return next(body for k, body in chunks(data) if k == kind)


def webp(img, **kw) -> bytes:
    return pil_bytes(Image.fromarray(img), format="WEBP", **kw)


def pil_rgba(data: bytes):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"))


# --- a VP8 key frame writer (RFC 6386), for what PIL's encoder never writes

# default token probabilities [4][8][3][11]
PROBA0 = np.frombuffer(bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080"
    "bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a808080"
    "4e86caf7c6b4ffdb80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece68080808080"
    "0165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080"
    "cfa0faffee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae18080808080"
    "5081d3ffc2e080808080800101ff8080808080808080f601ff8080808080808080ff80808080808080808080"
    "c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf800195f1ffdde0ffff808080"
    "b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080"
    "175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9ffe8eb8080808080"
    "7c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ffff808080"
    "2d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080"
    "fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080"
    "ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba8080808080"
    "452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff808080808080"
    "0110f8ffff808080808080be24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080"
    "f7c0ff8080808080808080f080ff80808080808080800186fcffff808080808080d53efaffff808080808080"
    "375dff8080808080808080808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff79fffff80"
    "a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80"
    "184782db9aaaf3b6ffff8001b6e1f9dbf0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff80"
    "0151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8ffd8d58080808080"
    "a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caffdb808080"
    "2a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080"
), np.uint8)
# their update probabilities, same layout
UPDATE = np.frombuffer(bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffff"
    "dff1fcfffffffffffffffff9fdfdfffffffffffffffffff4fcffffffffffffffffeafefeffffffffffffffff"
    "fdfffffffffffffffffffffff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffffffffffff"
    "fff8fefffffffffffffffffbfffefffffffffffffffffffffffffffffffffffffffffdfeffffffffffffffff"
    "fbfefefffffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffeffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "d9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafaf1fafdfffdfefffffffffeffffffffffffffffff"
    "dffefeffffffffffffffffeefdfefefffffffffffffffff8fefffffffffffffffff9feffffffffffffffffff"
    "fffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefeffffffffffffffff"
    "fdfffffffffffffffffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "bafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffff"
    "ecfdfefffffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffffffffffff"
    "fffffffffffffffffffffffffefffffffffffffffffffefefffffffffffffffffffeffffffffffffffffffff"
    "fffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdffffffffffffffff"
    "f6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcfffffffffffffffff8fefdffffffffffffffff"
    "fdfffefefffffffffffffffffbfefffffffffffffffff5fbfefffffffffffffffffdfdfeffffffffffffffff"
    "fffbfdfffffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcffffffffffffffffff"
    "f9fffefffffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff"
), np.uint8)
# 4x4 mode probabilities [top][left][9]
BMODES = np.frombuffer(bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150a"
    "ad791850c31a3e2c405590470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d"
    "102486b7598962656aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a6"
    "31179d412669a033341f7380684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5"
    "bd171216585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab"
    "3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24e1722213156684bc104c7c3e124e"
    "5f5539323033c165239fd76f592e6f3c941facdbe415126f70714d55b3ff267872282a01c4f5d10a196d582b"
    "1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd33"
    "3211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af"
    "2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd2803097333c01206"
    "df572509733b4d40152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a8598740a"
    "2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd"
    "2d25c03726467c49660122627d622a58685575af525f543559806471652d4b4f7b2f338051ab013911054766"
    "3935293126210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a39120a66"
    "66d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113"
    "469255373e46252b259a64a355a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808"
    "118489ff3774803a0f145287391a7928a4321f899a851923da33672c83837b1f069e5628408794e02db78016"
    "1a1183f09a0e01d12d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab"
    "120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b76927480"
    "5538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e9224131eabff611b148a2d3d3edb0151"
    "bc4020291475978e1415a370130c3dc380300418"
), np.uint8)
# Dequantisation factors by quantiser index (RFC 6386 14.1).
DC_Q = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
)
AC_Q = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
)
PROBA0 = PROBA0.reshape(4, 8, 3, 11)
UPDATE = UPDATE.reshape(4, 8, 3, 11)
BMODES = BMODES.reshape(10, 10, 9)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
CATS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
        (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# The 4x4 mode tree in libwebp's mode order (DC, TM, VE, HE, RD, VR, LD, VL,
# HD, HU): a leaf is -mode, a node the index of its pair.
TREE4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)


def _tree_paths():
    """{mode: [(node, bit)]}: the branches from the root to each leaf."""
    paths, todo = {}, [(0, [])]
    while todo:
        node, path = todo.pop()
        for bit in (0, 1):
            nxt = TREE4[2 * node + bit]
            if nxt > 0:
                todo.append((nxt, path + [(node, bit)]))
            else:
                paths[-nxt] = path + [(node, bit)]
    return paths


PATHS4 = _tree_paths()


class BoolWriter:
    """RFC 6386 7.3's boolean entropy encoder; `data` pads with 32 zero
    bits at probability 1/2, as libvpx's encoder ends a partition."""

    def __init__(self):
        self.out, self.range, self.bottom, self.count = bytearray(), 255, 0, 24

    def put(self, bit, prob):
        split = 1 + (((self.range - 1) * int(prob)) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):  # carry into the bytes written
                i = len(self.out) - 1
                while self.out[i] == 255:
                    self.out[i] = 0
                    i -= 1
                self.out[i] += 1
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if self.count == 0:
                self.out.append(self.bottom >> 24)
                self.bottom &= 0xFFFFFF
                self.count = 8

    def literal(self, v, n):
        for k in range(n - 1, -1, -1):
            self.put((v >> k) & 1, 128)

    def signed(self, v, n):
        self.literal(abs(v), n)
        self.put(v < 0, 128)

    def optional(self, v, n):
        """A flag, then (if v) a signed n-bit value."""
        self.put(v != 0, 128)
        if v:
            self.signed(v, n)

    def data(self) -> bytes:
        for _ in range(32):
            self.put(0, 128)
        return bytes(self.out)


def put_coeffs(bw, probs, ctx, first, coeffs):
    """The tokens of one block (coefficients in zigzag order) from `first`;
    whether any of them is non-zero."""
    nonzero = [n for n in range(first, 16) if coeffs[n]]
    last = nonzero[-1] if nonzero else -1
    n, p = first, probs[BANDS[first]][ctx]
    while n < 16:
        if n > last:
            bw.put(0, p[0])
            break
        bw.put(1, p[0])
        while coeffs[n] == 0:
            bw.put(0, p[1])
            n += 1
            p = probs[BANDS[n]][0]
        bw.put(1, p[1])
        v = abs(int(coeffs[n]))
        if v == 1:
            bw.put(0, p[2])
            nxt = 1
        else:
            bw.put(1, p[2])
            if v <= 4:
                bw.put(0, p[3])
                bw.put(v > 2, p[4])
                if v > 2:
                    bw.put(v - 3, p[5])
            elif v <= 10:
                bw.put(1, p[3])
                bw.put(0, p[6])
                bw.put(v > 6, p[7])
                if v <= 6:
                    bw.put(v - 5, 159)
                else:
                    bw.put((v - 7) >> 1, 165)
                    bw.put((v - 7) & 1, 145)
            else:
                bw.put(1, p[3])
                bw.put(1, p[6])
                cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
                bw.put(cat >> 1, p[8])
                bw.put(cat & 1, p[9 + (cat >> 1)])
                extra, tab = v - (3 + (8 << cat)), CATS[cat]
                for i, pr in enumerate(tab):
                    bw.put((extra >> (len(tab) - 1 - i)) & 1, pr)
            nxt = 2
        bw.put(coeffs[n] < 0, 128)
        n += 1
        p = probs[BANDS[n]][nxt]
    return last >= first


def random_block(rng, density, limit):
    """16 coefficients in zigzag order: sparse, magnitudes of every token
    category up to `limit`."""
    c = np.zeros(16, np.int64)
    k = int(rng.binomial(16, density))
    if k:
        pos = rng.choice(16, k, replace=False)
        mag = np.where(rng.random(k) < 0.8, rng.integers(1, 11, k),
                       rng.choice([11, 18, 19, 34, 35, 66, 67, 300, 2114], k))
        c[pos] = np.minimum(mag, limit) * rng.choice([-1, 1], k)
    return c


def token_limits(q, q_deltas, segment_q, absolute):
    """The largest token of each block type (Y after Y2, Y2, chroma, Y)
    whose dequantised value stays in a conforming stream's range: 2047,
    and 1023 for Y2, whose inverse WHT doubles it. libwebp's SIMD
    transforms wrap beyond it, which no encoder's stream reaches."""
    dy1, dy2, dy2a, duv, duva = q_deltas
    qi = q if segment_q is None else segment_q + (0 if absolute else q)

    def clip(v, m=127):
        return min(max(v, 0), m)

    y1 = max(DC_Q[clip(qi + dy1)], AC_Q[clip(qi)])
    y2 = max(2 * DC_Q[clip(qi + dy2)], max(8, AC_Q[clip(qi + dy2a)] * 101581 >> 16))
    uv = max(DC_Q[clip(qi + duv, 117)], AC_Q[clip(qi + duva)])
    return 2047 // y1, 1023 // y2, 2047 // uv, 2047 // y1


def vp8_frame(rng, w, h, *, simple=False, level=20, sharpness=0, parts=1, q=40,
              q_deltas=(0, 0, 0, 0, 0), segments=None, absolute=True, lf_deltas=None,
              skip_prob=None, updates=0.0, scale=(0, 0), density=0.2, modes="all",
              keyframe=True, block_hook=None):
    """One VP8 key frame: random intra modes (`modes` "all", or "dc" for
    DC_PRED everywhere) and random coefficient tokens under the default
    probabilities (a share `updates` of them replaced by random ones).
    `segments`: (quantiser, filter strength) of each of 4 segments, each
    macroblock in a random one; `lf_deltas`: (reference deltas, mode
    deltas); `block_hook(k, coeffs)` may replace the k-th block's."""
    mbw, mbh = (w + 15) // 16, (h + 15) // 16
    count = iter(range(1 << 30))

    def block(limit):
        c = random_block(rng, density, limit)
        return block_hook(next(count), c) if block_hook else c

    b0 = BoolWriter()
    b0.literal(0, 2)  # colour space, clamping type
    b0.put(segments is not None, 128)
    seg_probs = rng.integers(1, 256, 3)
    if segments is not None:
        b0.put(1, 128)  # update the map
        b0.put(1, 128)  # update the data
        b0.put(absolute, 128)
        for qs, _ in segments:
            b0.optional(qs, 7)
        for _, fs in segments:
            b0.optional(fs, 6)
        for pr in seg_probs:
            b0.put(1, 128)
            b0.literal(int(pr), 8)
    b0.put(simple, 128)
    b0.literal(level, 6)
    b0.literal(sharpness, 3)
    b0.put(lf_deltas is not None, 128)
    if lf_deltas is not None:
        b0.put(1, 128)
        for d in (*lf_deltas[0], *lf_deltas[1]):
            b0.optional(d, 6)
    b0.literal(int(np.log2(parts)), 2)
    b0.literal(q, 7)
    for d in q_deltas:
        b0.optional(d, 4)
    b0.put(0, 128)  # refresh entropy probabilities
    probs = PROBA0.copy()
    for t, b, c, i in np.ndindex(4, 8, 3, 11):
        upd = rng.random() < updates
        b0.put(upd, UPDATE[t, b, c, i])
        if upd:
            probs[t, b, c, i] = rng.integers(1, 256)
            b0.literal(int(probs[t, b, c, i]), 8)
    b0.put(skip_prob is not None, 128)
    if skip_prob is not None:
        b0.literal(skip_prob, 8)

    tokens = [BoolWriter() for _ in range(parts)]
    intra_t = [0] * (4 * mbw)
    top_nz, top_dc = [0] * mbw, [0] * mbw
    for mby in range(mbh):
        intra_l = [0] * 4
        left_nz = left_dc = 0
        tw = tokens[mby % parts]
        for mbx in range(mbw):
            s = 0
            if segments is not None:
                s = int(rng.integers(4))
                b0.put(s >= 2, seg_probs[0])
                b0.put(s & 1, seg_probs[1 + (s >> 1)])
            lim = token_limits(q, q_deltas, None if segments is None else segments[s][0],
                               absolute)
            skip = skip_prob is not None and rng.random() < 0.3
            if skip_prob is not None:
                b0.put(skip, skip_prob)
            i4x4 = modes == "all" and rng.random() < 0.4
            b0.put(not i4x4, 145)
            top = intra_t[4 * mbx:4 * mbx + 4]
            if not i4x4:
                ymode = int(rng.integers(4)) if modes == "all" else 0  # DC, TM, V, H
                b0.put(ymode in (1, 3), 156)
                b0.put(ymode in (1, 2), 128 if ymode in (1, 3) else 163)
                intra_t[4 * mbx:4 * mbx + 4] = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                for y in range(4):
                    for x in range(4):
                        m = int(rng.integers(10))
                        prob = BMODES[top[x], intra_l[y]]
                        for node, bit in PATHS4[m]:
                            b0.put(bit, prob[node])
                        top[x] = intra_l[y] = m
                intra_t[4 * mbx:4 * mbx + 4] = top
            uv = int(rng.integers(4)) if modes == "all" else 0
            b0.put(uv != 0, 142)
            if uv:
                b0.put(uv != 2, 114)  # V
                if uv != 2:
                    b0.put(uv == 1, 183)  # TM, else H
            if skip:
                top_nz[mbx] = left_nz = 0
                if not i4x4:
                    top_dc[mbx] = left_dc = 0
                continue
            if not i4x4:
                nz = put_coeffs(tw, probs[1], top_dc[mbx] + left_dc, 0,
                                block(lim[1]))
                top_dc[mbx] = left_dc = int(nz)
                first, yprobs = 1, probs[0]
            else:
                first, yprobs = 0, probs[3]
            tnz, lnz = top_nz[mbx] & 15, left_nz & 15
            for y in range(4):
                l_ = lnz & 1
                for x in range(4):
                    l_ = int(put_coeffs(tw, yprobs, l_ + (tnz & 1), first,
                                        block(lim[0 if first else 3])))
                    tnz = (tnz >> 1) | (l_ << 7)
                tnz >>= 4
                lnz = (lnz >> 1) | (l_ << 7)
            out_t, out_l = tnz, lnz >> 4
            for ch in (0, 2):
                tnz, lnz = top_nz[mbx] >> (4 + ch), left_nz >> (4 + ch)
                for y in range(2):
                    l_ = lnz & 1
                    for x in range(2):
                        l_ = int(put_coeffs(tw, probs[2], l_ + (tnz & 1), 0,
                                            block(lim[2])))
                        tnz = (tnz >> 1) | (l_ << 3)
                    tnz >>= 2
                    lnz = (lnz >> 1) | (l_ << 5)
                out_t |= (tnz << 4) << ch
                out_l |= (lnz & 0xF0) << ch
            top_nz[mbx], left_nz = out_t & 255, out_l & 255
    first = b0.data()
    parts_data = [t.data() for t in tokens]
    tag = (0 if keyframe else 1) | (0 << 1) | (1 << 4) | (len(first) << 5)
    head = (tag.to_bytes(3, "little") + b"\x9d\x01\x2a"
            + struct.pack("<HH", w | scale[0] << 14, h | scale[1] << 14))
    sizes = b"".join(len(p).to_bytes(3, "little") for p in parts_data[:-1])
    return head + first + sizes + b"".join(parts_data)


# --- a VP8L writer, for what PIL's encoder never writes


class BitWriter:
    """LSB-first bits, as VP8L reads them."""

    def __init__(self):
        self.acc, self.n = 0, 0

    def put(self, v, n):
        self.acc |= int(v) << self.n
        self.n += n

    def data(self) -> bytes:
        return self.acc.to_bytes((self.n + 7) // 8, "little")


def put_fixed_codes(bw):
    """Five prefix codes: green, red, blue and alpha of 256 symbols, each
    8 bits long, through a code-length code of the one symbol 8 (which
    takes no bits, so no length is written); distance a simple code of
    one symbol."""
    for alphabet in (280, 256, 256, 256):
        bw.put(0, 1)  # normal code
        bw.put(12 - 4, 4)  # 12 code-length code lengths, in kCodeLengthCodeOrder
        for sym in (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8):
            bw.put(1 if sym == 8 else 0, 3)
        if alphabet == 256:
            bw.put(0, 1)  # every symbol has a length
        else:
            bw.put(1, 1)  # lengths for the first 256 symbols only
            bw.put(3, 3)  # ... in 2 + 2 * 3 bits
            bw.put(256 - 2, 8)
    bw.put(1, 1)  # simple code
    bw.put(0, 1)  # one symbol
    bw.put(0, 1)  # of 1 bit
    bw.put(0, 1)  # symbol 0


def put_literals(bw, argb):
    """Each pixel's green, red, blue, alpha as 8-bit canonical codes (the
    code of a symbol is the symbol, first bit first)."""
    for px in argb.reshape(-1, 4):  # (a, r, g, b)
        for v in (px[2], px[1], px[3], px[0]):
            for k in range(7, -1, -1):
                bw.put((int(v) >> k) & 1, 1)


def vp8l_predicted(rng, w, h, bits=2):
    """A VP8L stream of random residuals under a predictor transform whose
    tiles take random modes 0-15 (libwebp reads 14 and 15 as 0); no colour
    cache, no meta codes."""
    bw = BitWriter()
    bw.put(0x2F, 8)
    bw.put(w - 1, 14)
    bw.put(h - 1, 14)
    bw.put(1, 1)  # alpha hint
    bw.put(0, 3)
    bw.put(1, 1)  # a transform:
    bw.put(0, 2)  # predictor
    bw.put(bits - 2, 3)
    tw, th = -(-w // (1 << bits)), -(-h // (1 << bits))
    modes = rng.integers(0, 256, (th, tw, 4), dtype=np.uint8)
    modes[..., 2] = rng.permutation(np.resize(np.arange(16), tw * th)).reshape(th, tw)
    bw.put(0, 1)  # no colour cache
    put_fixed_codes(bw)
    put_literals(bw, modes)
    bw.put(0, 1)  # no more transforms
    bw.put(0, 1)  # no colour cache
    bw.put(0, 1)  # no meta codes
    put_fixed_codes(bw)
    put_literals(bw, rng.integers(0, 256, (h, w, 4), dtype=np.uint8))
    return bw.data()


# --- ALPH chunks written by hand


def alpha_filter(a, kind):
    """The deltas whose inverse (dsp/filters.c) is `a`: kind 0 none, 1
    horizontal, 2 vertical, 3 gradient; row 0 from the left, column 0 from
    above."""
    a = a.astype(np.int64)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    pred[1:, 0] = a[:-1, 0]
    if kind == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif kind == 2:
        pred[1:, 1:] = a[:-1, 1:]
    elif kind == 3:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    if kind == 0:
        pred[:] = 0
    return ((a - pred) & 255).astype(np.uint8)


def alph(a, kind, lossless, rgb=None):
    """An ALPH payload: the filtered plane raw, or as a headerless VP8L
    stream (PIL's lossless encoding of an image whose green is the filtered
    plane, its 5-byte header dropped)."""
    d = alpha_filter(a, kind)
    if not lossless:
        return bytes([kind << 2]) + d.tobytes()
    img = np.zeros(a.shape + (3,), np.uint8) if rgb is None else rgb.copy()
    img[..., 1] = d
    stream = payload(webp(img, lossless=True, method=4), b"VP8L")
    return bytes([1 | kind << 2]) + stream[5:]


def with_alph(vp8: bytes, alph_payload: bytes, w: int, h: int, flags=0x10) -> bytes:
    return riff(vp8x(flags, w, h) + chunk(b"ALPH", alph_payload) + chunk(b"VP8 ", vp8))


# --- the corpus


def _pil_cases(rng):
    cases = {}
    for h, w in ((1, 1), (5, 3), (33, 17), (130, 250)):
        rgb, rgba = smooth(h, w, 3, int(rng.integers(1 << 30))), smooth(h, w, 4, 7)
        for q in (0, 30, 75, 100):
            for m in (0, 6):
                cases[f"lossy {w}x{h} q{q} m{m}"] = webp(rgb, quality=q, method=m)
        for aq in (100, 40):
            cases[f"lossy+alpha {w}x{h} aq{aq}"] = webp(rgba, quality=70, alpha_quality=aq)
        for m in range(7):
            cases[f"lossless {w}x{h} m{m}"] = webp(rgba, lossless=True, method=m)
    for n in (2, 4, 16, 200):
        pal = rng.integers(0, 256, (n, 4), dtype=np.uint8)
        for h, w in ((17, 33), (64, 61)):
            idx = rng.integers(0, n, (h, w))
            for m in (0, 4, 6):
                cases[f"lossless {n} colours {w}x{h} m{m}"] = webp(pal[idx], lossless=True,
                                                                     method=m, exact=True)
    noise = rng.integers(0, 256, (40, 52, 4), dtype=np.uint8)
    noise[..., 3] = rng.choice([0, 255], (40, 52))
    cases["lossless noise exact"] = webp(noise, lossless=True, exact=True)
    cases["lossless noise m6 q100"] = webp(noise, lossless=True, method=6, quality=100)
    return cases


def _animation():
    """Frame 0 opaque on a transparent canvas: PIL's encoder crops it to
    36x20 at (14, 10)."""
    canvas = np.zeros((48, 64, 4), np.uint8)
    canvas[10:30, 14:50] = smooth(20, 36, 4, 3)
    canvas[10:30, 14:50, 3] = 255
    frames = [Image.fromarray(canvas), Image.fromarray(smooth(48, 64, 4, 4))]
    out = {}
    for kind, kw in (("lossy", {}), ("lossless", {"lossless": True})):
        out[f"animation {kind}"] = pil_bytes(frames[0], format="WEBP", save_all=True,
                                             append_images=frames[1:], duration=100, **kw)
    return out


def _container_cases(rng):
    """ALPH and VP8X variants around PIL's bitstreams."""
    h, w = 37, 45
    rgba = smooth(h, w, 4, 11)
    vp8 = payload(webp(rgba[..., :3], quality=60), b"VP8 ")
    vp8l = payload(webp(rgba, lossless=True), b"VP8L")
    a = rgba[..., 3]
    cases = {}
    for kind in range(4):
        cases[f"ALPH raw filter {kind}"] = with_alph(vp8, alph(a, kind, False), w, h)
        cases[f"ALPH VP8L filter {kind}"] = with_alph(vp8, alph(a, kind, True), w, h)
    cases["ALPH VP8L of many colours"] = with_alph(vp8, alph(a, 3, True, rgba[..., :3]), w, h)
    cases["ALPH pre-processing set"] = with_alph(vp8, bytes([1 << 4]) + a.tobytes(), w, h)
    cases["VP8X alpha flag, no ALPH"] = riff(vp8x(0x10, w, h) + chunk(b"VP8 ", vp8))
    cases["VP8X ALPH without the flag"] = with_alph(vp8, alph(a, 1, False), w, h, flags=0)
    cases["VP8X VP8L without the flag"] = riff(vp8x(0, w, h) + chunk(b"VP8L", vp8l))
    hint0 = vp8l[:4] + bytes([vp8l[4] & ~0x10]) + vp8l[5:]
    cases["VP8L alpha hint 0"] = riff(chunk(b"VP8L", hint0))
    cases["VP8X VP8L alpha hint 0"] = riff(vp8x(0x10, w, h) + chunk(b"VP8L", hint0))
    icc, exif = rng.bytes(101), b"Exif\0\0" + rng.bytes(40)
    cases["VP8X ICCP EXIF XMP"] = riff(vp8x(0x10 | 0x20 | 0x08 | 0x04, w, h)
                                       + chunk(b"ICCP", icc) + chunk(b"ALPH", alph(a, 2, True))
                                       + chunk(b"VP8 ", vp8) + chunk(b"EXIF", exif)
                                       + chunk(b"XMP ", b"<x/>"))
    cases["VP8X written by PIL with ICC and EXIF"] = webp(rgba, quality=50, icc_profile=icc,
                                                          exif=exif)
    cases["simple file, trailing chunk"] = riff(chunk(b"VP8 ", vp8) + chunk(b"JUNK", b"abc"))
    return cases


WRITER = {
    "normal filter": {},
    "normal filter, level 63, 4 partitions": dict(level=63, parts=4),
    "simple filter": dict(simple=True, level=30),
    "simple filter, sharpness 4, 2 partitions": dict(simple=True, level=12, sharpness=4,
                                                      parts=2),
    "level 0 under segment strengths": dict(level=0, segments=[(30, 20), (40, 40), (50, 0),
                                                               (20, 63)]),
    "segments absolute, DC only": dict(segments=[(10, 5), (60, 30), (90, 50), (127, 63)],
                                       modes="dc"),
    "segments delta, 8 partitions": dict(segments=[(-10, -5), (5, 10), (20, -20), (0, 3)],
                                         absolute=False, parts=8),
    "segment and mode deltas": dict(level=25, lf_deltas=((7, -3, 5, 9), (-12, 4, 2, -6)),
                                    segments=[(0, 0), (4, 8), (-4, -8), (9, 30)],
                                    absolute=False),
    "negative deltas to level 0": dict(level=8, lf_deltas=((-20, 0, 0, 0), (10, 0, 0, 0))),
    "skip probability, 2 partitions": dict(skip_prob=120, parts=2),
    "probability updates": dict(updates=0.3, density=0.4),
    "quantiser deltas, Y2 and UV clamps": dict(q=1, q_deltas=(-8, 7, -8, 7, -3)),
    "high quantiser, UV DC clamp": dict(q=125, q_deltas=(3, -2, 5, 7, 7)),
    "scale bits": dict(scale=(1, 3)),
    "dense tokens": dict(density=0.7, q=2),
}
WRITER.update({f"sharpness {s}": dict(sharpness=s, level=10 + 7 * s) for s in range(1, 8)})
SIZES = {"normal filter": (40, 36), "simple filter": (33, 17), "dense tokens": (1, 1),
         "scale bits": (18, 50), "skip probability, 2 partitions": (75, 50)}


def _writer_cases():
    cases = {}
    for k, (name, kw) in enumerate(WRITER.items()):
        w, h = SIZES.get(name, (52, 40))
        cases[f"writer {name}"] = riff(chunk(b"VP8 ", vp8_frame(np.random.default_rng(k), w, h,
                                                               **kw)))
    rng = np.random.default_rng(99)
    frame = vp8_frame(rng, 45, 37, level=30, parts=2)
    a = rng.integers(0, 256, (37, 45), dtype=np.uint8)
    cases["writer with ALPH gradient"] = with_alph(frame, alph(a, 3, False), 45, 37)
    for w, h in ((37, 29), (16, 16)):
        cases[f"writer VP8L predictor modes 0-15 {w}x{h}"] = riff(
            chunk(b"VP8L", vp8l_predicted(rng, w, h)))
    return cases


def _cases():
    rng = np.random.default_rng(15)
    cases = _pil_cases(rng)
    cases.update(_animation())
    cases.update(_container_cases(rng))
    cases.update(_writer_cases())
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_webp_equals_pil(name):
    data = CASES[name]
    ref = pil_rgba(data)
    got = image_io.decode_image_rgba(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


BOTH_LOADERS = ["lossy 250x130 q75 m6", "lossy+alpha 250x130 aq40", "lossless 250x130 m4",
                "lossless 16 colours 61x64 m6", "animation lossy", "writer with ALPH gradient"]


@pytest.mark.parametrize("name", BOTH_LOADERS)
def test_webp_through_both_packages_loaders(tmp_path, monkeypatch, name):
    path = write(tmp_path, "map.webp", CASES[name])
    ref = jax_load(path)
    got = port_load(path, monkeypatch)
    assert ref is not None and got is not None
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert float(got.std()) > 0.0


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "webp")


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(FIXTURES) if f.endswith(".webp")))
def test_fixture_map_equals_tracy_tpu(monkeypatch, name):
    path = os.path.join(FIXTURES, name)
    ref = jax_load(path)
    got = port_load(path, monkeypatch)
    assert ref is not None and got is not None and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# --- cut bitstreams: the port fails where PIL fails


def _cut(data: bytes, kind: bytes, keep: int) -> bytes:
    """data with its `kind` chunk's payload cut to `keep` bytes, the
    container's sizes made consistent again."""
    body = b""
    for k, p in chunks(data):
        body += chunk(k, p[:keep] if k == kind else p)
    return riff(body)


CUTS = {"writer segments delta, 8 partitions": b"VP8 ", "lossy 250x130 q30 m6": b"VP8 ",
        "lossless 250x130 m6": b"VP8L", "lossless 16 colours 61x64 m0": b"VP8L",
        "ALPH VP8L filter 2": b"ALPH", "ALPH VP8L of many colours": b"ALPH",
        "ALPH raw filter 1": b"ALPH"}


@pytest.mark.parametrize("name", sorted(CUTS))
def test_cut_bitstream_fails_where_pil_fails(name):
    data, kind = CASES[name], CUTS[name]
    n = len(payload(data, kind))
    outcomes = []
    for keep in sorted({n // 10, n // 3, 2 * n // 3, n - 9, n - 4, n - 2, n - 1}):
        cut = _cut(data, kind, keep)
        try:
            ref = pil_rgba(cut)
        except Exception:
            ref = None
        if ref is None:
            with pytest.raises(ValueError, match="truncated"):
                image_io.decode_image_rgba(cut)
        else:
            np.testing.assert_array_equal(image_io.decode_image_rgba(cut), ref)
        outcomes.append(ref is None)
    assert outcomes[0]  # a tenth of the stream never decodes


# --- the hazard: coefficients past a conforming stream's range


def test_nonconforming_coefficients_follow_the_c_reference():
    """A V block of the last macroblock whose dequantised DC (2114 x 132)
    wraps int16, which no encoder writes: the port computes it as RFC
    6386's reference decoder and libwebp's C transforms do (32-bit
    intermediates); PIL's libwebp runs its x86 SIMD transforms, whose
    16-bit lanes differ there (ROADMAP, hazards). Everywhere else, beyond
    the reach of that macroblock's chroma (2 pixels of fancy upsampling),
    the two agree."""
    seen = []
    kw = dict(q=127, level=0, modes="dc")
    vp8_frame(np.random.default_rng(5), 48, 48, block_hook=lambda k, c: seen.append(k) or c, **kw)
    target = seen[-1] - 3  # the last macroblock's first V block

    def big(k, c):
        if k == target:
            c[:] = 0
            c[:3] = (2114, -2114, 1500)
        return c

    data = riff(chunk(b"VP8 ", vp8_frame(np.random.default_rng(5), 48, 48, block_hook=big,
                                         **kw)))
    ref, got = pil_rgba(data), image_io.decode_image_rgba(data)
    differ = (ref != got).any(-1)
    assert differ.any()
    assert not differ[:31].any() and not differ[:, :31].any()


# --- refusals


def _refused():
    rgba = smooth(20, 24, 4, 5)
    lossy = CASES["lossy 17x33 q75 m0"]
    vp8 = payload(lossy, b"VP8 ")
    bad_code = vp8[:3] + b"\x9d\x01\x2b" + vp8[6:]
    anim = CASES["animation lossy"]
    big = riff(vp8x(0, 16384, 16384) + chunk(b"VP8 ", vp8))
    outside = bytearray(anim)
    at = anim.index(b"ANMF") + 8
    outside[at:at + 3] = (20).to_bytes(3, "little")  # x offset 40: 40 + 36 > 64
    return {
        "interframe": (riff(chunk(b"VP8 ", vp8_frame(np.random.default_rng(1), 24, 20,
                                                     keyframe=False))), "interframe"),
        "bad start code": (riff(chunk(b"VP8 ", bad_code)), "start code"),
        "file cut short": (lossy[:len(lossy) - 7], "truncated"),
        "header cut short": (lossy[:30], "truncated"),
        "frame outside its canvas": (bytes(outside), "canvas"),
        "still larger than its canvas": (riff(vp8x(0, 10, 10) + chunk(b"VP8 ", vp8)),
                                         "canvas"),
        "canvas beyond the pixel limit": (big, "pixels not read"),
        "ALPH after its image": (riff(vp8x(0x10, 17, 33) + chunk(b"VP8 ", vp8)
                                      + chunk(b"ALPH", b"\0" + bytes(17 * 33))), "after"),
        "VP8L after ALPH": (riff(vp8x(0x10, 24, 20) + chunk(b"ALPH", b"\0" + bytes(480))
                                 + chunk(b"VP8L", payload(webp(rgba, lossless=True),
                                                          b"VP8L"))), "VP8L"),
    }


REFUSED = _refused()


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_webp_falls_back_by_name(tmp_path, monkeypatch, name):
    data, what = REFUSED[name]
    with pytest.raises(Exception):
        pil_rgba(data)  # PIL cannot read it either
    with pytest.raises(ValueError, match=what):
        image_io.decode_image_rgba(data)
    path = write(tmp_path, "a.webp", data)
    assert port_load(path, monkeypatch) is None
    assert jax_load(path) is None


def test_refused_webp_maps_are_listed_as_fallbacks(tmp_path):
    from tracy_tpu_torch.scene import load_scene

    files = {"a.webp": REFUSED["interframe"][0], "b.webp": REFUSED["file cut short"][0],
             "c.webp": REFUSED["frame outside its canvas"][0], "d.webp": CASES["lossless 3x5 m2"]}
    for name, data in files.items():
        write(tmp_path, name, data)
    lines = [f"TEX M {slot} {name}" for slot, name in zip("BNRME", files)]
    scn = tmp_path / "t.scn"
    scn.write_text("SCN T\nOUT 8 6\nCAM (0, 0, 3) (0, 0, 0) (0, 1, 0) 45\n"
                   "MTL M (1, 1, 1) 1 0\n" + "\n".join(lines) + "\nOBJ S (0, 0, 0) 0.5 M\n")
    b = load_scene(str(scn))
    assert sorted(b.fallbacks) == ["texture a.webp", "texture b.webp", "texture c.webp"]
    assert [p.shape for p in b.atlas.pixels][-1] == (5, 3, 4)


def test_image_format_takes_what_pils_webp_plugin_accepts():
    head = b"RIFF" + struct.pack("<I", 100) + b"WEBP"
    for kind in (b"VP8 ", b"VP8L", b"VP8X"):
        assert image_io.image_format(head + kind + bytes(8)) == "webp"
    for other in (head + b"ALPH" + bytes(8), head + b"ANIM" + bytes(8),
                  b"RIFF" + struct.pack("<I", 100) + b"WAVEfmt " + bytes(8)):
        assert image_io.image_format(other) is None


@pytest.mark.parametrize("name", ["lossless 250x130 m4", "lossy+alpha 250x130 aq100"])
def test_read_image_takes_webp(tmp_path, name):
    """read_image (optimize_cli -target) reads WebP by content as tracy_tpu's
    optimize_cli does: PIL's convert("RGB") / 255."""
    path = write(tmp_path, "target.bin", CASES[name])
    with Image.open(io.BytesIO(CASES[name])) as im:
        shown = np.asarray(im.convert("RGB"), np.float32) / 255.0
    got, linear = image_io.read_image(path)
    assert not linear
    np.testing.assert_array_equal(got, shown)


@pytest.mark.parametrize("kind", ["lossy", "lossless"])
def test_1024_map_decodes_in_under_a_second(kind):
    img = smooth(1024, 1024, 4, 21)
    data = (webp(img, lossless=True, method=0, quality=0) if kind == "lossless"
            else webp(img, quality=80, method=0))
    image_io.decode_image_rgba(CASES["lossless 1x1 m0"])  # builds the library if needed
    t0 = time.perf_counter()
    got = image_io.decode_image_rgba(data)
    secs = time.perf_counter() - t0
    np.testing.assert_array_equal(got, pil_rgba(data))
    assert secs < 1.0, f"{secs:.3f} s"
