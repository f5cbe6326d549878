// DDS decoding on the host, for the texture loader and read_image: the
// first surface of a file (the top mip level; the first face of a cube map
// or array), as PIL's DdsImagePlugin opens it and convert("RGBA") gives it
// (tracy_tpu reads every 8-bit texture through PIL), but where ROADMAP's
// hazards say otherwise.
//
// Built into the decoder library beside image_formats.cpp
// (utils/native.py::get_image_lib), with its conventions: tracy_dds_info
// (width and height) and tracy_dds_decode (RGBA8 [h, w, 4]) return 0, 1 for
// a fault of the file, or 2 for a failure inside the decoder, with the
// message in tracy_decode_error().
//
// Pixel formats, checked in PIL's order:
// - DDPF_RGB: 16-, 24- or 32-bit pixels with bit masks (and an alpha mask
//   with DDPF_ALPHAPIXELS), each channel (v >> shift) / (mask >> shift) *
//   255 in double precision, truncated, as PIL's DdsRgbDecoder;
// - DDPF_LUMINANCE: 8-bit grey, 16-bit grey + alpha;
// - DDPF_PALETTEINDEXED8: 8-bit indices into a 256-entry RGBA palette;
// - FourCC DXT1/DXT3/DXT5 (BC1-BC3), ATI1/BC4U and BC4S (BC4: grey),
//   ATI2/BC5U and BC5S (BC5: red and green), and DX10 headers with
//   DXGI BC1-BC7 (TYPELESS, UNORM and SRGB; BC6H UF16 and SF16) and
//   R8G8B8A8.
//
// The block decoders are PIL's (its BcnDecode.c), integer for integer: BC1
// keeps PIL's interpolation ((2 c0 + c1) / 3, truncated) and its
// punch-through alpha (index 3 is 0, 0, 0, 0 when c0 <= c1); BC2 and BC3
// colour blocks always take four colours; BC4/BC5 signed endpoints are
// offset by 128 (and signed BC5's blue is 128); BC6H gives 8-bit RGB
// through PIL's half floats, clamped to [0, 1] and truncated, with PIL's
// signed arithmetic (delta sums not sign-extended, 16-bit endpoints
// unsigned); BC7 covers its eight modes with partitions, rotations and
// index selection, and a block whose first byte is 0 (no mode) gives
// PIL's opaque black.
//
// Hazards, where PIL loses the picture and this file follows the format:
// PIL refuses DXGI BC1, BC2 and BC3 SRGB, BC4 SNORM and the BC4S FourCC;
// they are read as their UNORM forms (BC4 signed as PIL reads BC5S). A
// truncated DDPF_RGB file is refused here (PIL pads it with black).
//
// Refused by name: DXT2/DXT4 and other FourCCs, BC6H TYPELESS and other
// DXGI formats, and any other pixel format flags. A volume texture gives
// its first slice, as in PIL.

#include "image_common.h"

namespace {

constexpr uint32_t kRgbFlag = 0x40, kAlphaPixels = 0x1, kLuminance = 0x20000,
                   kPalette8 = 0x20, kFourCC = 0x4;

constexpr uint32_t fourcc(const char* s) {
  return uint32_t(uint8_t(s[0])) | uint32_t(uint8_t(s[1])) << 8 |
         uint32_t(uint8_t(s[2])) << 16 | uint32_t(uint8_t(s[3])) << 24;
}

enum Codec { kRawMasks, kRawL, kRawLA, kRawP, kRawRGBA, kBC1, kBC2, kBC3, kBC4, kBC4S, kBC5,
             kBC5S, kBC6, kBC6S, kBC7 };

struct Dds {
  int64_t w, h;
  Codec codec;
  size_t data_at;
  int bytes_pp;        // kRawMasks
  uint32_t masks[4];   // kRawMasks: r, g, b, and a (0 without alpha)
  bool alpha;          // kRawMasks: DDPF_ALPHAPIXELS
};

Dds dds_header(const Bytes& b) {
  b.need(0, 4);
  if (std::memcmp(b.p, "DDS ", 4) != 0) fail("DDS: not a DDS file");
  const uint32_t size = b.le32(4);
  if (size != 124) fail("DDS: header size " + std::to_string(size) + " not read");
  b.need(0, 128);
  Dds d{};
  d.h = b.le32(12);
  d.w = b.le32(16);
  check_size("DDS", d.w, d.h);
  const uint32_t flags = b.le32(80), cc = b.le32(84), bitcount = b.le32(88);
  d.data_at = 128;
  if (flags & kRgbFlag) {
    d.codec = kRawMasks;
    d.alpha = (flags & kAlphaPixels) != 0;
    if (bitcount != 16 && bitcount != 24 && bitcount != 32) {
      fail("DDS: RGB pixels of " + std::to_string(bitcount) + " bits not read");
    }
    d.bytes_pp = static_cast<int>(bitcount / 8);
    for (int i = 0; i < 4; ++i) d.masks[i] = b.le32(92 + 4 * i);
    if (!d.alpha) d.masks[3] = 0;
  } else if (flags & kLuminance) {
    if (bitcount == 8) {
      d.codec = kRawL;
    } else if (bitcount == 16 && (flags & kAlphaPixels)) {
      d.codec = kRawLA;
    } else {
      fail("DDS: luminance pixels of " + std::to_string(bitcount) + " bits not read");
    }
  } else if (flags & kPalette8) {
    d.codec = kRawP;
    d.data_at = 128 + 1024;
  } else if (flags & kFourCC) {
    if (cc == fourcc("DXT1")) {
      d.codec = kBC1;
    } else if (cc == fourcc("DXT3")) {
      d.codec = kBC2;
    } else if (cc == fourcc("DXT5")) {
      d.codec = kBC3;
    } else if (cc == fourcc("BC4U") || cc == fourcc("ATI1")) {
      d.codec = kBC4;
    } else if (cc == fourcc("BC4S")) {
      d.codec = kBC4S;
    } else if (cc == fourcc("BC5U") || cc == fourcc("ATI2")) {
      d.codec = kBC5;
    } else if (cc == fourcc("BC5S")) {
      d.codec = kBC5S;
    } else if (cc == fourcc("DX10")) {
      const uint32_t dxgi = b.le32(128);
      d.data_at = 148;
      switch (dxgi) {
        case 27: case 28: case 29: d.codec = kRawRGBA; break;
        case 70: case 71: case 72: d.codec = kBC1; break;
        case 73: case 74: case 75: d.codec = kBC2; break;
        case 76: case 77: case 78: d.codec = kBC3; break;
        case 79: case 80: d.codec = kBC4; break;
        case 81: d.codec = kBC4S; break;
        case 82: case 83: d.codec = kBC5; break;
        case 84: d.codec = kBC5S; break;
        case 94: fail("DDS: BC6H TYPELESS (DXGI 94) not read");
        case 95: d.codec = kBC6; break;
        case 96: d.codec = kBC6S; break;
        case 97: case 98: case 99: d.codec = kBC7; break;
        default: fail("DDS: DXGI format " + std::to_string(dxgi) + " not read");
      }
    } else {
      std::string name(reinterpret_cast<const char*>(b.p + 84), 4);
      for (char& c : name) {
        if (c < 32 || c > 126) c = '?';
      }
      fail("DDS: FourCC '" + name + "' not read");
    }
  } else {
    fail("DDS: pixel format flags " + std::to_string(flags) + " not read");
  }
  return d;
}

// ---------------------------------------------------------------- BC1-BC5

struct Rgba {
  uint8_t r, g, b, a;
};

Rgba decode_565(uint32_t x) {
  int r = (x & 0xf800) >> 8;
  r |= r >> 5;
  int g = (x & 0x7e0) >> 3;
  g |= g >> 6;
  int b = (x & 0x1f) << 3;
  b |= b >> 5;
  return {uint8_t(r), uint8_t(g), uint8_t(b), 255};
}

void bc1_colour(Rgba* dst, const uint8_t* src, bool separate_alpha) {
  const uint32_t c0 = src[0] | src[1] << 8, c1 = src[2] | src[3] << 8;
  const uint32_t lut = src[4] | src[5] << 8 | src[6] << 16 | uint32_t(src[7]) << 24;
  Rgba p[4];
  p[0] = decode_565(c0);
  p[1] = decode_565(c1);
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || separate_alpha) {
    p[2] = {uint8_t((2 * r0 + r1) / 3), uint8_t((2 * g0 + g1) / 3), uint8_t((2 * b0 + b1) / 3), 255};
    p[3] = {uint8_t((r0 + 2 * r1) / 3), uint8_t((g0 + 2 * g1) / 3), uint8_t((b0 + 2 * b1) / 3), 255};
  } else {
    p[2] = {uint8_t((r0 + r1) / 2), uint8_t((g0 + g1) / 2), uint8_t((b0 + b1) / 2), 255};
    p[3] = {0, 0, 0, 0};
  }
  for (int n = 0; n < 16; ++n) dst[n] = p[3 & (lut >> (2 * n))];
}

// BC3 alpha / BC4 / BC5 channel: 8 interpolated values of two endpoints,
// 3-bit indices; `sign` offsets signed endpoints by 128.
void bc3_alpha(uint8_t* dst, int stride, const uint8_t* src, bool sign) {
  const int a0 = sign ? int8_t(src[0]) + 128 : src[0];
  const int a1 = sign ? int8_t(src[1]) + 128 : src[1];
  int a[8];
  a[0] = a0;
  a[1] = a1;
  if (a0 > a1) {
    for (int k = 1; k < 7; ++k) a[k + 1] = ((7 - k) * a0 + k * a1) / 7;
  } else {
    for (int k = 1; k < 5; ++k) a[k + 1] = ((5 - k) * a0 + k * a1) / 5;
    a[6] = 0;
    a[7] = 255;
  }
  const uint32_t lut1 = src[2] | src[3] << 8 | src[4] << 16;
  const uint32_t lut2 = src[5] | src[6] << 8 | src[7] << 16;
  for (int n = 0; n < 8; ++n) dst[stride * n] = uint8_t(a[7 & (lut1 >> (3 * n))]);
  for (int n = 0; n < 8; ++n) dst[stride * (8 + n)] = uint8_t(a[7 & (lut2 >> (3 * n))]);
}

// ---------------------------------------------------------------- BC6H, BC7

int get_bit(const uint8_t* src, int bit) { return (src[bit >> 3] >> (bit & 7)) & 1; }

int get_bits(const uint8_t* src, int bit, int count) {
  if (count == 0) return 0;
  const int by = bit >> 3;
  bit &= 7;
  if (bit + count <= 8) return (src[by] >> bit) & ((1 << count) - 1);
  const int x = src[by] | src[by + 1] << 8;
  return (x >> bit) & ((1 << count) - 1);
}

// BC7's partition tables: two subsets at one bit an index, three at two.
const uint16_t kP2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80,
    0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310,
    0x3100, 0x8cce, 0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa,
    0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc,
    0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6,
    0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
const uint32_t kP3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0,
    0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4,
    0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454,
    0x6a6a4040, 0xa4a45000, 0x1a1a0500, 0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400,
    0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050,
    0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600, 0xaa444444,
    0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
    0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44,
    0x2a4a5254};
// Anchor indices: of subset 1 of two; of subsets 1 and 2 of three.
const uint8_t kA2[64] = {15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
                         15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
                         15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
                         6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kA3a[64] = {3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
                          3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
                          8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
                          3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kA3b[64] = {15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
                          15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
                          15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
                          15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};
const uint8_t kW2[4] = {0, 21, 43, 64};
const uint8_t kW3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t kW4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int bits) { return bits == 2 ? kW2 : bits == 3 ? kW3 : kW4; }

int subset_of(int ns, int partition, int n) {
  if (ns == 2) return 1 & (kP2[partition] >> n);
  if (ns == 3) return 3 & (kP3[partition] >> (2 * n));
  return 0;
}

bool is_anchor(int ns, int partition, int i) {
  if (i == 0) return true;
  if (ns == 2) return i == kA2[partition];
  if (ns == 3) return i == kA3a[partition] || i == kA3b[partition];
  return false;
}

struct Bc7Mode {
  int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode kBc7[8] = {{3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
                         {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
                         {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
                         {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

uint8_t expand(int v, int bits) {
  const uint8_t x = uint8_t(v << (8 - bits));
  return uint8_t(x | (x >> bits));
}

void bc7_lerp(Rgba& dst, const Rgba* e, int s0, int s1) {
  const int t0 = 64 - s0, t1 = 64 - s1;
  dst.r = uint8_t((t0 * e[0].r + s0 * e[1].r + 32) >> 6);
  dst.g = uint8_t((t0 * e[0].g + s0 * e[1].g + 32) >> 6);
  dst.b = uint8_t((t0 * e[0].b + s0 * e[1].b + 32) >> 6);
  dst.a = uint8_t((t1 * e[0].a + s1 * e[1].a + 32) >> 6);
}

void bc7_block(Rgba* col, const uint8_t* src) {
  if (src[0] == 0) {  // no mode: PIL's black
    for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 255};
    return;
  }
  int mode = 0;
  while (!(src[0] & (1 << mode))) ++mode;
  const Bc7Mode& m = kBc7[mode];
  int bit = mode + 1;
  auto load = [&](int n) {
    const int v = get_bits(src, bit, n);
    bit += n;
    return v;
  };
  const int partition = load(m.pb), rotation = load(m.rb), index_sel = load(m.isb);
  const int numep = 2 * m.ns;
  Rgba e[6];
  for (int i = 0; i < numep; ++i) e[i].r = uint8_t(load(m.cb));
  for (int i = 0; i < numep; ++i) e[i].g = uint8_t(load(m.cb));
  for (int i = 0; i < numep; ++i) e[i].b = uint8_t(load(m.cb));
  for (int i = 0; i < numep; ++i) e[i].a = m.ab ? uint8_t(load(m.ab)) : 255;
  int cb = m.cb, ab = m.ab;
  auto with_p = [](uint8_t& x, int p) { x = uint8_t((x << 1) | p); };
  if (m.epb) {
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < numep; ++i) {
      const int p = load(1);
      with_p(e[i].r, p);
      with_p(e[i].g, p);
      with_p(e[i].b, p);
      if (ab) with_p(e[i].a, p);
    }
  }
  if (m.spb) {
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < numep; i += 2) {
      const int p = load(1);
      for (int j = i; j < i + 2; ++j) {
        with_p(e[j].r, p);
        with_p(e[j].g, p);
        with_p(e[j].b, p);
        if (ab) with_p(e[j].a, p);
      }
    }
  }
  for (int i = 0; i < numep; ++i) {
    e[i].r = expand(e[i].r, cb);
    e[i].g = expand(e[i].g, cb);
    e[i].b = expand(e[i].b, cb);
    if (ab) e[i].a = expand(e[i].a, ab);
  }
  const uint8_t* cw = weights(m.ib);
  const uint8_t* aw = weights(ab && m.ib2 ? m.ib2 : m.ib);
  int cibit = bit, aibit = cibit + 16 * m.ib - m.ns;
  for (int i = 0; i < 16; ++i) {
    const int s = subset_of(m.ns, partition, i) << 1;
    const int ib = m.ib - (is_anchor(m.ns, partition, i) ? 1 : 0);
    const int i0 = get_bits(src, cibit, ib);
    cibit += ib;
    if (ab && m.ib2) {
      const int ib2 = m.ib2 - (i == 0 ? 1 : 0);
      const int i1 = get_bits(src, aibit, ib2);
      aibit += ib2;
      if (index_sel) {
        bc7_lerp(col[i], e + s, aw[i1], cw[i0]);
      } else {
        bc7_lerp(col[i], e + s, cw[i0], aw[i1]);
      }
    } else {
      bc7_lerp(col[i], e + s, cw[i0], cw[i0]);
    }
    if (rotation == 1) std::swap(col[i].r, col[i].a);
    if (rotation == 2) std::swap(col[i].g, col[i].a);
    if (rotation == 3) std::swap(col[i].b, col[i].a);
  }
}

struct Bc6Mode {
  int ns, tr, pb, epb, rb, gb, bb;
  const char* layout;  // the endpoint bits in the order the block holds them
};
// Fields: r/g/b and w, x (subset 0's endpoints), y, z (subset 1's); "a:b"
// the bits a to b, in the order written (descending where a > b).
const Bc6Mode kBc6[14] = {
    {2, 1, 5, 10, 5, 5, 5,
     "gy4 by4 bz4 rw0:9 gw0:9 bw0:9 rx0:4 gz4 gy0:3 gx0:4 bz0 gz0:3 bx0:4 bz1 by0:3 ry0:4 bz2 "
     "rz0:4 bz3"},
    {2, 1, 5, 7, 6, 6, 6,
     "gy5 gz4 gz5 rw0:6 bz0 bz1 by4 gw0:6 by5 bz2 gy4 bw0:6 bz3 bz5 bz4 rx0:5 gy0:3 gx0:5 gz0:3 "
     "bx0:5 by0:3 ry0:5 rz0:5"},
    {2, 1, 5, 11, 5, 4, 4,
     "rw0:9 gw0:9 bw0:9 rx0:4 rw10 gy0:3 gx0:3 gw10 bz0 gz0:3 bx0:3 bw10 bz1 by0:3 ry0:4 bz2 "
     "rz0:4 bz3"},
    {2, 1, 5, 11, 4, 5, 4,
     "rw0:9 gw0:9 bw0:9 rx0:3 rw10 gz4 gy0:3 gx0:4 gw10 gz0:3 bx0:3 bw10 bz1 by0:3 ry0:3 bz0 "
     "bz2 rz0:3 gy4 bz3"},
    {2, 1, 5, 11, 4, 4, 5,
     "rw0:9 gw0:9 bw0:9 rx0:3 rw10 by4 gy0:3 gx0:3 gw10 bz0 gz0:3 bx0:4 bw10 by0:3 ry0:3 bz1 "
     "bz2 rz0:3 bz4 bz3"},
    {2, 1, 5, 9, 5, 5, 5,
     "rw0:8 by4 gw0:8 gy4 bw0:8 bz4 rx0:4 gz4 gy0:3 gx0:4 bz0 gz0:3 bx0:4 bz1 by0:3 ry0:4 bz2 "
     "rz0:4 bz3"},
    {2, 1, 5, 8, 6, 5, 5,
     "rw0:7 gz4 by4 gw0:7 bz2 gy4 bw0:7 bz3 bz4 rx0:5 gy0:3 gx0:4 bz0 gz0:3 bx0:4 bz1 by0:3 "
     "ry0:5 rz0:5"},
    {2, 1, 5, 8, 5, 6, 5,
     "rw0:7 bz0 by4 gw0:7 gy5 gy4 bw0:7 gz5 bz4 rx0:4 gz4 gy0:3 gx0:5 gz0:3 bx0:4 bz1 by0:3 "
     "ry0:4 bz2 rz0:4 bz3"},
    {2, 1, 5, 8, 5, 5, 6,
     "rw0:7 bz1 by4 gw0:7 by5 gy4 bw0:7 bz5 bz4 rx0:4 gz4 gy0:3 gx0:4 bz0 gz0:3 bx0:5 by0:3 "
     "ry0:4 bz2 rz0:4 bz3"},
    {2, 0, 5, 6, 6, 6, 6,
     "rw0:5 gz4 bz0 bz1 by4 gw0:5 gy5 by5 bz2 gy4 bw0:5 gz5 bz3 bz5 bz4 rx0:5 gy0:3 gx0:5 "
     "gz0:3 bx0:5 by0:3 ry0:5 rz0:5"},
    {1, 0, 0, 10, 10, 10, 10, "rw0:9 gw0:9 bw0:9 rx0:9 gx0:9 bx0:9"},
    {1, 1, 0, 11, 9, 9, 9, "rw0:9 gw0:9 bw0:9 rx0:8 rw10 gx0:8 gw10 bx0:8 bw10"},
    {1, 1, 0, 12, 8, 8, 8, "rw0:9 gw0:9 bw0:9 rx0:7 rw11:10 gx0:7 gw11:10 bx0:7 bw11:10"},
    {1, 1, 0, 16, 4, 4, 4, "rw0:9 gw0:9 bw0:9 rx0:3 rw15:10 gx0:3 gw15:10 bx0:3 bw15:10"},
};

// Each mode's endpoint bits as (endpoint value index << 4 | bit): value
// index 3 * endpoint + channel, endpoints w, x, y, z.
struct Bc6Layouts {
  uint8_t bits[14][80];
  int count[14];
  Bc6Layouts() {
    for (int m = 0; m < 14; ++m) {
      int n = 0;
      for (const char* s = kBc6[m].layout; *s;) {
        while (*s == ' ') ++s;
        if (!*s) break;
        const int ch = s[0] == 'r' ? 0 : s[0] == 'g' ? 1 : 2;
        const int ep = s[1] == 'w' ? 0 : s[1] == 'x' ? 1 : s[1] == 'y' ? 2 : 3;
        s += 2;
        int a = 0;
        while (*s >= '0' && *s <= '9') a = 10 * a + (*s++ - '0');
        int b = a;
        if (*s == ':') {
          ++s;
          b = 0;
          while (*s >= '0' && *s <= '9') b = 10 * b + (*s++ - '0');
        }
        for (int k = a;; k += (b >= a ? 1 : -1)) {
          bits[m][n++] = uint8_t((3 * ep + ch) << 4 | k);
          if (k == b) break;
        }
      }
      count[m] = n;
    }
  }
};

int sign_extend(int v, int bits) {
  v &= (1 << bits) - 1;
  return v & (1 << (bits - 1)) ? v - (1 << bits) : v;
}

int bc6_unquantize(int v, int bits, bool sign) {
  if (!sign) {
    if (bits >= 15) return v;
    if (v == 0) return 0;
    if (v == (1 << bits) - 1) return 0xffff;
    return ((v << 16) + 0x8000) >> bits;
  }
  if (bits >= 16) return v & 0xffff;  // PIL's 16-bit store drops the sign
  int s = 0, x = v;
  if (x < 0) {
    s = 1;
    x = -x;
  }
  if (x != 0) {
    if (x >= (1 << (bits - 1)) - 1) {
      x = 0x7fff;
    } else {
      x = ((x << 15) + 0x4000) >> (bits - 1);
    }
  }
  return s ? -x : x;
}

float half_to_float(uint16_t h) {
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000;
  o.u = uint32_t(h & 0x7fff) << 13;
  o.f *= m.f;
  m.u = 0x47800000;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= uint32_t(h & 0x8000) << 16;
  return o.f;
}

float bc6_finalize(int v, bool sign) {
  if (sign) {
    if (v < 0) return half_to_float(uint16_t(0x8000 | ((-v) * 31) / 32));
    return half_to_float(uint16_t((v * 31) / 32));
  }
  return half_to_float(uint16_t((v * 31) / 64));
}

uint8_t bc6_clamp(float v) {
  if (v != v || v < 0.0f) return 0;
  if (v > 1.0f) return 255;
  return uint8_t(v * 255.0f);
}

void bc6_block(Rgba* col, const uint8_t* src, bool sign) {
  static const Bc6Layouts layouts;
  int mode = src[0] & 0x1f, bit = 5, epbits = 75, ib = 3;
  if ((mode & 3) < 2) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
    epbits = 72;
  } else {
    mode = 10 + (mode >> 2);
    epbits = 60;
    ib = 4;
  }
  if (mode >= 14) {
    for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 255};
    return;
  }
  const Bc6Mode& m = kBc6[mode];
  int ep[12] = {};
  for (int i = 0; i < epbits; ++i) {
    const int d = layouts.bits[mode][i];
    ep[d >> 4] |= get_bit(src, bit + i) << (d & 15);
  }
  bit += epbits;
  const int partition = get_bits(src, bit, m.pb);
  bit += m.pb;
  const int numep = m.ns == 2 ? 12 : 6;
  const int dbits[3] = {m.rb, m.gb, m.bb};
  if (sign) {
    for (int c = 0; c < 3; ++c) ep[c] = sign_extend(ep[c], m.epb);
  }
  if (sign || m.tr) {
    for (int i = 3; i < numep; ++i) ep[i] = sign_extend(ep[i], dbits[i % 3]);
  }
  if (m.tr) {
    const int mask = (1 << m.epb) - 1;
    // PIL does not sign-extend the sums, signed or not.
    for (int i = 3; i < numep; ++i) ep[i] = (ep[i] + ep[i % 3]) & mask;
  }
  int u[12];
  for (int i = 0; i < numep; ++i) u[i] = bc6_unquantize(ep[i], m.epb, sign);
  const uint8_t* w = weights(ib);
  for (int i = 0; i < 16; ++i) {
    const int s = subset_of(m.ns, partition, i) * 6;
    const int bits = ib - (is_anchor(m.ns, partition, i) ? 1 : 0);
    const int idx = get_bits(src, bit, bits);
    bit += bits;
    const int wt = w[idx], t = 64 - wt;
    int v[3];
    for (int c = 0; c < 3; ++c) v[c] = (u[s + c] * t + u[s + 3 + c] * wt) >> 6;
    col[i] = {bc6_clamp(bc6_finalize(v[0], sign)), bc6_clamp(bc6_finalize(v[1], sign)),
              bc6_clamp(bc6_finalize(v[2], sign)), 255};
  }
}

// ---------------------------------------------------------------- decode

int block_bytes(Codec c) { return c == kBC1 || c == kBC4 || c == kBC4S ? 8 : 16; }

void dds_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Dds d = dds_header(b);
  check_out("DDS", d.w, d.h, out_w, out_h);
  const size_t n = static_cast<size_t>(d.w * d.h);
  const uint8_t* p = b.p + d.data_at;
  switch (d.codec) {
    case kRawMasks: {
      b.need(d.data_at, n * d.bytes_pp);
      int shift[4];
      uint32_t total[4];
      for (int c = 0; c < 4; ++c) {
        shift[c] = 0;
        if (d.masks[c]) {
          while (!((d.masks[c] >> shift[c]) & 1)) ++shift[c];
        }
        total[c] = d.masks[c] >> shift[c];
      }
      for (size_t i = 0; i < n; ++i, p += d.bytes_pp) {
        uint32_t v = 0;
        for (int k = 0; k < d.bytes_pp; ++k) v |= uint32_t(p[k]) << (8 * k);
        int o[4];
        for (int c = 0; c < 4; ++c) {
          o[c] = total[c] ? static_cast<int>(
                                static_cast<double>((v & d.masks[c]) >> shift[c]) / total[c] * 255.0)
                          : 0;
        }
        put(out + 4 * i, o[0], o[1], o[2], d.alpha ? o[3] : 255);
      }
      return;
    }
    case kRawL:
      b.need(d.data_at, n);
      for (size_t i = 0; i < n; ++i) put(out + 4 * i, p[i], p[i], p[i], 255);
      return;
    case kRawLA:
      b.need(d.data_at, 2 * n);
      for (size_t i = 0; i < n; ++i) put(out + 4 * i, p[2 * i], p[2 * i], p[2 * i], p[2 * i + 1]);
      return;
    case kRawP: {
      b.need(d.data_at, n);
      const uint8_t* pal = b.p + 128;
      for (size_t i = 0; i < n; ++i) {
        const uint8_t* e = pal + 4 * p[i];
        put(out + 4 * i, e[0], e[1], e[2], e[3]);
      }
      return;
    }
    case kRawRGBA:
      b.need(d.data_at, 4 * n);
      std::memcpy(out, p, 4 * n);
      return;
    default:
      break;
  }
  const int64_t bw = (d.w + 3) / 4, bh = (d.h + 3) / 4;
  const int bytes = block_bytes(d.codec);
  b.need(d.data_at, static_cast<size_t>(bw * bh * bytes));
  Rgba col[16];
  for (int64_t by = 0; by < bh; ++by) {
    for (int64_t bx = 0; bx < bw; ++bx, p += bytes) {
      for (Rgba& c : col) c = {0, 0, 0, 255};
      switch (d.codec) {
        case kBC1: bc1_colour(col, p, false); break;
        case kBC2:
          bc1_colour(col, p + 8, true);
          for (int i = 0; i < 16; ++i) {
            const int v = (p[i >> 1] >> (4 * (i & 1))) & 15;
            col[i].a = uint8_t(v << 4 | v);
          }
          break;
        case kBC3:
          bc1_colour(col, p + 8, true);
          bc3_alpha(&col[0].a, 4, p, false);
          break;
        case kBC4:
        case kBC4S:
          bc3_alpha(&col[0].r, 4, p, d.codec == kBC4S);
          for (Rgba& c : col) c.g = c.b = c.r;
          break;
        case kBC5:
        case kBC5S:
          bc3_alpha(&col[0].r, 4, p, d.codec == kBC5S);
          bc3_alpha(&col[0].g, 4, p + 8, d.codec == kBC5S);
          for (Rgba& c : col) c.b = d.codec == kBC5S ? 128 : 0;
          break;
        case kBC6:
        case kBC6S: bc6_block(col, p, d.codec == kBC6S); break;
        default: bc7_block(col, p); break;
      }
      for (int j = 0; j < 4; ++j) {
        const int64_t y = 4 * by + j;
        if (y >= d.h) break;
        for (int i = 0; i < 4; ++i) {
          const int64_t x = 4 * bx + i;
          if (x >= d.w) break;
          const Rgba& c = col[4 * j + i];
          put(out + 4 * (y * d.w + x), c.r, c.g, c.b, c.a);
        }
      }
    }
  }
}

}  // namespace

namespace tracy_image {

void bc1_decode(const uint8_t* p, int64_t w, int64_t h, uint8_t* out) {
  Rgba col[16];
  for (int64_t by = 0; by < (h + 3) / 4; ++by) {
    for (int64_t bx = 0; bx < (w + 3) / 4; ++bx, p += 8) {
      bc1_colour(col, p, false);
      for (int j = 0; j < 4 && 4 * by + j < h; ++j) {
        for (int i = 0; i < 4 && 4 * bx + i < w; ++i) {
          const Rgba& c = col[4 * j + i];
          put(out + 4 * ((4 * by + j) * w + 4 * bx + i), c.r, c.g, c.b, c.a);
        }
      }
    }
  }
}

}  // namespace tracy_image

extern "C" {

// Width and height of the first surface (0, or 1 with a message when the
// decoder refuses it); then tracy_dds_decode writes RGBA8 [h, w, 4].
int tracy_dds_info(const uint8_t* data, int64_t len, int* w, int* h) {
  return info("DDS", data, len, w, h, dds_header);
}
int tracy_dds_decode(const uint8_t* data, int64_t len, uint8_t* out, int w, int h) {
  return guarded("DDS", [&] { dds_decode({data, static_cast<size_t>(len), "DDS"}, out, w, h); });
}

}  // extern "C"
