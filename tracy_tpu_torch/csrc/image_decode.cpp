// PNG and JPEG decoding on the host, for the texture loader and read_image
// (TGA, BMP, GIF, PNM and PSD: image_formats.cpp, in the same library).
//
// Plain C++17 with an extern "C" interface, built by g++ at first use
// (utils/native.py::get_image_lib) and loaded through ctypes, so the
// machine that runs the card needs no PIL. The JAX package decodes both
// formats through PIL (tracy_tpu/scene/textures.py), whose JPEG decoder is
// libjpeg-turbo; the C++ reference uses stb_image. The output is 8-bit
// RGBA, as stbi_load(..., 4) and PIL's convert("RGBA") give it.
//
// PNG: colour types 0, 2, 3 (palette, with tRNS), 4 and 6 at every bit
// depth the format allows (1, 2, 4, 8, 16), Adam7 interlacing and the five
// row filters. The caller parses the chunks and inflates IDAT (Python's
// zlib); tracy_png_decode takes the inflated, still filtered bytes.
// Sub-byte grey is scaled to 8 bits as both PIL and stb_image scale it
// (x 255, 85, 17). 16-bit samples keep their high byte, as stb_image does;
// PIL clips 16-bit grey instead (ROADMAP, hazards).
//
// JPEG: baseline (SOF0), extended Huffman 8-bit (SOF1) and progressive
// (SOF2) with spectral selection and successive approximation; 1, 3 or 4
// components with sampling factors 1 to 4 in integral ratios; restart
// intervals; any Huffman tables. The arithmetic follows libjpeg's, so that
// the pixels equal PIL's: the ISLOW integer IDCT (jidctint.c) with its
// range-limit table, "fancy" triangle upsampling (jdsample.c: h2v1, h1v2,
// h2v2, with box replication where libjpeg takes it; every other integral
// ratio, 4:1:1's among them, replicated as int_upsample does) and the JFIF
// YCbCr -> RGB fixed-point tables (jdcolor.c). Four components are CMYK,
// or YCCK when an Adobe marker's transform is not 0 (libjpeg's rule), and
// reach RGB as PIL takes them: libjpeg's CMYK, inverted (PIL's "CMYK;I"
// rawmode, with or without the marker), through Pillow's cmyk2rgb.
// Arithmetic coding, lossless, hierarchical, 12-bit files and non-integral
// sampling ratios are refused by name.
//
// Every entry point returns 0, or a nonzero code with a message that
// tracy_decode_error() returns (per thread).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

struct DecodeError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw DecodeError(msg); }

// ---------------------------------------------------------------- PNG

int png_channels(int ctype) {
  switch (ctype) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

bool png_depth_ok(int ctype, int depth) {
  switch (ctype) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo the row filters of one pass in place: rows of 1 + rowbytes bytes,
// the filter byte first; bpp the filter's byte distance.
void unfilter(uint8_t* data, int rows, int rowbytes, int bpp) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < rows; ++y) {
    uint8_t* row = data + static_cast<size_t>(y) * (rowbytes + 1);
    const int f = row[0];
    uint8_t* cur = row + 1;
    switch (f) {
      case 0:
        break;
      case 1:
        for (int x = bpp; x < rowbytes; ++x) cur[x] = static_cast<uint8_t>(cur[x] + cur[x - bpp]);
        break;
      case 2:
        if (prev) {
          for (int x = 0; x < rowbytes; ++x) cur[x] = static_cast<uint8_t>(cur[x] + prev[x]);
        }
        break;
      case 3:
        for (int x = 0; x < rowbytes; ++x) {
          const int a = x >= bpp ? cur[x - bpp] : 0;
          const int b = prev ? prev[x] : 0;
          cur[x] = static_cast<uint8_t>(cur[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int x = 0; x < rowbytes; ++x) {
          const int a = x >= bpp ? cur[x - bpp] : 0;
          const int b = prev ? prev[x] : 0;
          const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
          cur[x] = static_cast<uint8_t>(cur[x] + paeth(a, b, c));
        }
        break;
      default:
        fail("PNG: row filter " + std::to_string(f) + " does not exist");
    }
    prev = cur;
  }
}

// Sample k (0-based, counting channels) of an unfiltered row at `depth`.
inline int sample(const uint8_t* row, int k, int depth) {
  switch (depth) {
    case 8: return row[k];
    case 16: return (row[2 * k] << 8) | row[2 * k + 1];
    default: {
      const int bit = k * depth;
      return (row[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
    }
  }
}

struct PngInfo {
  int w, h, depth, ctype;
  const uint8_t* plte;
  int plte_len;
  const uint8_t* trns;
  int trns_len;
};

// One pixel of an unfiltered row to RGBA8.
inline void png_pixel(const PngInfo& p, const uint8_t* row, int x, uint8_t* out) {
  const int d = p.depth;
  // 8-bit value of a raw sample: sub-byte grey scaled up, 16-bit's high byte.
  auto to8 = [d](int v) -> uint8_t {
    if (d == 16) return static_cast<uint8_t>(v >> 8);
    if (d == 8) return static_cast<uint8_t>(v);
    return static_cast<uint8_t>(v * (255 / ((1 << d) - 1)));
  };
  auto trns16 = [&p](int i) { return (p.trns[2 * i] << 8) | p.trns[2 * i + 1]; };
  switch (p.ctype) {
    case 0: {
      const int v = sample(row, x, d);
      out[0] = out[1] = out[2] = to8(v);
      out[3] = (p.trns_len >= 2 && v == (trns16(0) & ((d == 16) ? 0xFFFF : (1 << d) - 1)))
                   ? 0 : 255;
      break;
    }
    case 2: {
      int v[3];
      for (int c = 0; c < 3; ++c) v[c] = sample(row, 3 * x + c, d);
      for (int c = 0; c < 3; ++c) out[c] = to8(v[c]);
      out[3] = (p.trns_len >= 6 && v[0] == trns16(0) && v[1] == trns16(1) && v[2] == trns16(2))
                   ? 0 : 255;
      break;
    }
    case 3: {
      const int i = sample(row, x, d);
      if (3 * i + 2 < p.plte_len) {
        for (int c = 0; c < 3; ++c) out[c] = p.plte[3 * i + c];
      } else {
        out[0] = out[1] = out[2] = 0;
      }
      out[3] = i < p.trns_len ? p.trns[i] : 255;
      break;
    }
    case 4:
      out[0] = out[1] = out[2] = to8(sample(row, 2 * x, d));
      out[3] = to8(sample(row, 2 * x + 1, d));
      break;
    default:  // 6
      for (int c = 0; c < 4; ++c) out[c] = to8(sample(row, 4 * x + c, d));
      break;
  }
}

void png_decode(const PngInfo& p, uint8_t* raw, int64_t raw_len, int interlace, uint8_t* out) {
  if (p.w <= 0 || p.h <= 0) fail("PNG: empty image");
  if (!png_depth_ok(p.ctype, p.depth)) {
    fail("PNG: colour type " + std::to_string(p.ctype) + " at bit depth " +
         std::to_string(p.depth) + " is not a valid combination");
  }
  if (interlace != 0 && interlace != 1) fail("PNG: unknown interlace method");
  if (p.ctype == 3 && p.plte_len < 3) fail("PNG: palette image without PLTE");
  const int bits = png_channels(p.ctype) * p.depth;
  const int bpp = bits >= 8 ? bits / 8 : 1;
  static const int X0[7] = {0, 4, 0, 2, 0, 1, 0}, Y0[7] = {0, 0, 4, 0, 2, 0, 1};
  static const int DX[7] = {8, 8, 4, 4, 2, 2, 1}, DY[7] = {8, 8, 8, 4, 4, 2, 2};
  const int passes = interlace ? 7 : 1;
  int64_t pos = 0;
  for (int k = 0; k < passes; ++k) {
    const int x0 = interlace ? X0[k] : 0, y0 = interlace ? Y0[k] : 0;
    const int dx = interlace ? DX[k] : 1, dy = interlace ? DY[k] : 1;
    const int pw = (p.w - x0 + dx - 1) / dx, ph = (p.h - y0 + dy - 1) / dy;
    if (pw <= 0 || ph <= 0) continue;  // an empty pass has no filter bytes
    const int rowbytes = static_cast<int>((static_cast<int64_t>(pw) * bits + 7) / 8);
    const int64_t need = static_cast<int64_t>(ph) * (rowbytes + 1);
    if (pos + need > raw_len) fail("PNG: image data is truncated");
    uint8_t* data = raw + pos;
    unfilter(data, ph, rowbytes, bpp);
    for (int y = 0; y < ph; ++y) {
      const uint8_t* row = data + static_cast<size_t>(y) * (rowbytes + 1) + 1;
      uint8_t* orow = out + (static_cast<size_t>(y0 + y * dy) * p.w) * 4;
      for (int x = 0; x < pw; ++x) png_pixel(p, row, x, orow + static_cast<size_t>(x0 + x * dx) * 4);
    }
    pos += need;
  }
}

// ---------------------------------------------------------------- JPEG

// Natural order of the zigzag index, padded so that a corrupt run past 63
// lands on 63 (as libjpeg's jpeg_natural_order).
const int ZIGZAG[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int FAST_BITS = 9;

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int maxcode[18] = {};  // largest code of each length, -1 if none
  int valptr[17] = {};
  int mincode[17] = {};
  uint16_t fast[1 << FAST_BITS] = {};  // (length << 8) | value, 0 if longer

  void build(const uint8_t counts[16], const uint8_t* symbols, int n) {
    std::memcpy(vals, symbols, n);
    int code = 0, k = 0;
    std::memset(fast, 0, sizeof(fast));
    for (int len = 1; len <= 16; ++len) {
      valptr[len] = k;
      mincode[len] = code;
      for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
        if (len <= FAST_BITS) {
          const int shift = FAST_BITS - len;
          for (int j = 0; j < (1 << shift); ++j) {
            fast[(code << shift) | j] = static_cast<uint16_t>((len << 8) | vals[k]);
          }
        }
      }
      maxcode[len] = counts[len - 1] ? code - 1 : -1;
      if (code > (1 << len)) fail("JPEG: bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;           // Huffman tables of the current scan
  int bw = 0, bh = 0;           // blocks across and down, MCU-padded
  int dw = 0, dh = 0;           // samples across and down (downsampled size)
  std::vector<int16_t> coef;    // bw * bh blocks of 64, natural order
  uint16_t quant[64] = {};      // latched at the component's first scan
  bool quant_set = false;
  int dc_pred = 0;
  std::vector<uint8_t> pix;     // bw * 8 by bh * 8 samples after the IDCT
};

struct BitReader {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  uint32_t buf = 0;
  int cnt = 0;
  bool at_marker = false;

  void fill() {
    while (cnt <= 24) {
      uint32_t b = 0;
      if (!at_marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          const uint8_t nx = pos + 1 < n ? d[pos + 1] : 0xD9;
          if (nx == 0x00) {
            pos += 2;
          } else {
            at_marker = true;  // feed zeros until the scan ends or restarts
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= b << (24 - cnt);
      cnt += 8;
    }
  }
  int bits(int k) {  // k in 0..16
    if (k == 0) return 0;
    fill();
    const int v = static_cast<int>(buf >> (32 - k));
    buf <<= k;
    cnt -= k;
    return v;
  }
  int bit() { return bits(1); }
  int decode(const Huffman& t) {
    fill();
    const int f = t.fast[buf >> (32 - FAST_BITS)];
    if (f) {
      const int len = f >> 8;
      buf <<= len;
      cnt -= len;
      return f & 0xFF;
    }
    for (int len = FAST_BITS + 1; len <= 16; ++len) {
      const int code = static_cast<int>(buf >> (32 - len));
      if (code <= t.maxcode[len]) {
        buf <<= len;
        cnt -= len;
        return t.vals[t.valptr[len] + code - t.mincode[len]];
      }
    }
    fail("JPEG: corrupt Huffman code");
  }
  // Skip to just past the next RSTn marker, emptying the bit buffer.
  void restart() {
    buf = 0;
    cnt = 0;
    at_marker = false;
    while (pos + 1 < n) {
      if (d[pos] == 0xFF && d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7) {
        pos += 2;
        return;
      }
      ++pos;
    }
    fail("JPEG: restart marker missing");
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Jpeg {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool progressive = false, frame_seen = false;
  bool adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {};
  Huffman dc[4], ac[4];
  Component comp[4];
  int eobrun = 0;

  Jpeg(const uint8_t* data, size_t len) : d(data), n(len) {}

  int u8() {
    if (pos >= n) fail("JPEG: file is truncated");
    return d[pos++];
  }
  int u16() {
    const int a = u8();
    return (a << 8) | u8();
  }
  // The next marker code; skips fill bytes.
  int marker() {
    while (u8() != 0xFF) {
    }  // libjpeg skips stray bytes between segments too
    int m = u8();
    while (m == 0xFF) m = u8();
    return m;
  }

  void read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      const int pq_tq = u8();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("JPEG: bad quantisation table");
      for (int k = 0; k < 64; ++k) qt[tq][ZIGZAG[k]] = static_cast<uint16_t>(pq ? u16() : u8());
      qt_defined[tq] = true;
      len -= 1 + 64 * (pq + 1);
    }
    if (len != 0) fail("JPEG: bad DQT length");
  }

  void read_dht() {
    int len = u16() - 2;
    while (len > 0) {
      const int tc_th = u8();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("JPEG: bad Huffman table class or id");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = static_cast<uint8_t>(u8());
      if (total > 256) fail("JPEG: bad Huffman table");
      uint8_t symbols[256];
      for (int i = 0; i < total; ++i) symbols[i] = static_cast<uint8_t>(u8());
      (tc == 0 ? dc[th] : ac[th]).build(counts, symbols, total);
      len -= 17 + total;
    }
    if (len != 0) fail("JPEG: bad DHT length");
  }

  void read_app14() {
    const size_t start = pos;
    const int len = u16();
    if (len >= 14 && pos + 12 <= n && std::memcmp(d + pos, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = d[pos + 11];
    }
    pos = start + len;
  }

  void skip_segment() {
    const int len = u16();
    if (len < 2) fail("JPEG: bad segment length");
    pos += len - 2;
  }

  void read_sof(int m) {
    if (frame_seen) fail("JPEG: more than one frame");
    frame_seen = true;
    progressive = m == 0xC2;
    u16();
    const int precision = u8();
    if (precision != 8) fail("JPEG: " + std::to_string(precision) + "-bit samples are not read");
    height = u16();
    width = u16();
    ncomp = u8();
    if (height == 0) fail("JPEG: DNL-defined height is not read");
    if (width == 0) fail("JPEG: empty image");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) {
      fail("JPEG: " + std::to_string(ncomp) + " components are not read");
    }
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = u8();
      const int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("JPEG: bad sampling factors");
      if (c.tq > 3) fail("JPEG: bad quantisation table id");
    }
    if (ncomp == 1) comp[0].h = comp[0].v = 1;  // one component: one block an MCU
    for (int i = 0; i < ncomp; ++i) {
      hmax = std::max(hmax, comp[i].h);
      vmax = std::max(vmax, comp[i].v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v) {  // libjpeg's JERR_FRACT_SAMPLE_NOTIMPL
        fail("JPEG: non-integral sampling ratio " + std::to_string(hmax) + "x" +
             std::to_string(vmax) + " over " + std::to_string(c.h) + "x" + std::to_string(c.v) +
             " is not read");
      }
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    }
  }

  // One block of a sequential scan.
  void block_baseline(BitReader& br, Component& c, int16_t* blk) {
    const int t = br.decode(dc[c.td]);
    if (t > 11) fail("JPEG: corrupt DC coefficient");
    c.dc_pred += t ? extend(br.bits(t), t) : 0;
    blk[0] = static_cast<int16_t>(c.dc_pred);
    const Huffman& h = ac[c.ta];
    for (int k = 1; k < 64;) {
      const int rs = br.decode(h);
      const int r = rs >> 4, s = rs & 15;
      if (s == 0) {
        if (r != 15) break;
        k += 16;
        continue;
      }
      k += r;
      if (k > 63) fail("JPEG: corrupt AC coefficients");
      blk[ZIGZAG[k]] = static_cast<int16_t>(extend(br.bits(s), s));
      ++k;
    }
  }

  void block_dc_first(BitReader& br, Component& c, int16_t* blk, int al) {
    const int t = br.decode(dc[c.td]);
    if (t > 11) fail("JPEG: corrupt DC coefficient");
    c.dc_pred += t ? extend(br.bits(t), t) : 0;
    blk[0] = static_cast<int16_t>(c.dc_pred * (1 << al));
  }

  void block_dc_refine(BitReader& br, int16_t* blk, int al) {
    if (br.bit()) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }

  void block_ac_first(BitReader& br, const Component& c, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huffman& h = ac[c.ta];
    for (int k = ss; k <= se; ++k) {
      const int rs = br.decode(h);
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("JPEG: corrupt AC coefficients");
        blk[ZIGZAG[k]] = static_cast<int16_t>(extend(br.bits(s), s) * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = (1 << r) - 1;
        if (r) eobrun += br.bits(r);
        break;
      }
    }
  }

  void block_ac_refine(BitReader& br, const Component& c, int16_t* blk, int ss, int se,
                       int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    const Huffman& h = ac[c.ta];
    int k = ss;
    auto correct = [&](int16_t& coef) {
      if (br.bit() && (coef & p1) == 0) coef = static_cast<int16_t>(coef >= 0 ? coef + p1 : coef + m1);
    };
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = br.decode(h);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          if (s != 1) fail("JPEG: corrupt refinement coefficient");
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t& coef = blk[ZIGZAG[k]];
          if (coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) {
          if (k > 63) fail("JPEG: corrupt refinement coefficients");
          blk[ZIGZAG[k]] = static_cast<int16_t>(s);
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = blk[ZIGZAG[k]];
        if (coef != 0) correct(coef);
      }
      --eobrun;
    }
  }

  void read_sos() {
    const int len = u16();
    const int ns = u8();
    if (ns < 1 || ns > ncomp || len != 6 + 2 * ns) fail("JPEG: bad scan header");
    int blocks = 0;
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      const int id = u8(), tables = u8();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; ++j) {
        if (comp[j].id == id) c = &comp[j];
      }
      if (!c) fail("JPEG: scan names an unknown component");
      c->td = tables >> 4;
      c->ta = tables & 15;
      if (c->td > 3 || c->ta > 3) fail("JPEG: bad Huffman table id");
      if (!c->quant_set) {
        if (!qt_defined[c->tq]) fail("JPEG: quantisation table missing");
        std::memcpy(c->quant, qt[c->tq], sizeof(c->quant));
        c->quant_set = true;
      }
      sc[i] = c;
      blocks += c->h * c->v;
    }
    // libjpeg's D_MAX_BLOCKS_IN_MCU: an interleaved scan's MCU holds 10
    // blocks at most.
    if (ns > 1 && blocks > 10) fail("JPEG: sampling factors too large for an interleaved scan");
    const int ss = u8(), se = u8(), ahal = u8();
    const int ah = ahal >> 4, al = ahal & 15;
    if (progressive) {
      if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) || al > 13) {
        fail("JPEG: bad progressive scan parameters");
      }
    } else if (ss != 0 || se != 63 || ahal != 0) {
      fail("JPEG: bad sequential scan parameters");
    }
    const bool dc_scan = ss == 0;
    for (int i = 0; i < ns; ++i) {
      const bool need_dc = !progressive || (dc_scan && ah == 0);
      const bool need_ac = !progressive || !dc_scan;
      if (need_dc && !dc[sc[i]->td].defined) fail("JPEG: DC Huffman table missing");
      if (need_ac && !ac[sc[i]->ta].defined) fail("JPEG: AC Huffman table missing");
      sc[i]->dc_pred = 0;
    }
    eobrun = 0;

    BitReader br;
    br.d = d;
    br.n = n;
    br.pos = pos;

    auto decode_block = [&](Component& c, int bx, int by) {
      int16_t* blk = c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64;
      if (!progressive) {
        block_baseline(br, c, blk);
      } else if (dc_scan) {
        if (ah == 0) block_dc_first(br, c, blk, al);
        else block_dc_refine(br, blk, al);
      } else if (ah == 0) {
        block_ac_first(br, c, blk, ss, se, al);
      } else {
        block_ac_refine(br, c, blk, ss, se, al);
      }
    };

    // Non-interleaved scans cover the component's own blocks; interleaved
    // ones whole MCUs.
    int units_x, units_y;
    if (ns == 1) {
      units_x = (sc[0]->dw + 7) / 8;
      units_y = (sc[0]->dh + 7) / 8;
    } else {
      units_x = mcux;
      units_y = mcuy;
    }
    const int64_t total = static_cast<int64_t>(units_x) * units_y;
    int64_t left = restart_interval;
    for (int64_t u = 0; u < total; ++u) {
      if (restart_interval && left == 0) {
        br.restart();
        for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
        eobrun = 0;
        left = restart_interval;
      }
      const int ux = static_cast<int>(u % units_x), uy = static_cast<int>(u / units_x);
      if (ns == 1) {
        decode_block(*sc[0], ux, uy);
      } else {
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          for (int y = 0; y < c.v; ++y) {
            for (int x = 0; x < c.h; ++x) decode_block(c, ux * c.h + x, uy * c.v + y);
          }
        }
      }
      --left;
    }
    // On to the next marker: the entropy-coded data ends at a 0xFF that is
    // neither stuffing nor a restart marker.
    pos = br.pos;
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0x00 &&
                            !(d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7))) {
      ++pos;
    }
  }

  // Parse up to the frame header (info) or through EOI (decode).
  void parse(bool headers_only) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("JPEG: not a JPEG file");
    pos = 2;
    bool scanned = false;
    for (;;) {
      // PIL reads no file that ends before its EOI marker (libjpeg
      // suspends for more data, and PIL calls that truncation).
      if (pos >= n) fail("JPEG: file is truncated");
      const int m = marker();
      if (m == 0xD9) break;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        read_sof(m);
        if (headers_only) return;
      } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
        fail("JPEG: lossless coding is not read");
      } else if (m == 0xC5 || m == 0xC6) {
        fail("JPEG: hierarchical coding is not read");
      } else if (m == 0xC9 || m == 0xCA || m == 0xCD || m == 0xCE) {
        fail("JPEG: arithmetic coding is not read");
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xCC) {
        fail("JPEG: arithmetic coding is not read");
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        u16();
        restart_interval = u16();
      } else if (m == 0xDA) {
        if (!frame_seen) fail("JPEG: scan before the frame header");
        read_sos();
        scanned = true;
      } else if (m == 0xEE) {
        read_app14();
      } else if (m >= 0xD0 && m <= 0xD7) {
        // a stray restart marker between scans: no payload
      } else if (m == 0xDC) {
        skip_segment();  // DNL after the first scan; the height is known
      } else {
        skip_segment();  // APPn, COM and the rest
      }
    }
    if (!frame_seen) fail("JPEG: no frame header");
    if (!scanned) fail("JPEG: no scan");
  }
};

// ISLOW inverse DCT of one block (libjpeg's jidctint.c, 8-bit samples).
constexpr int CONST_BITS = 13, PASS1_BITS = 2;
inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// libjpeg's post-IDCT range limit: index (x & 1023) of x without the +128.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      const int x = i < 512 ? i : i - 1024;  // the wrap of x & RANGE_MASK
      const int v = x + 128;
      t[i] = static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
};
const RangeLimit RANGE_LIMIT;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      const int dcval = (ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * 4433;                 // FIX_0_541196100
    int64_t tmp2 = z1 + z3 * -15137;               // FIX_1_847759065
    int64_t tmp3 = z1 + z2 * 6270;                 // FIX_0_765366865
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * 9633;           // FIX_1_175875602
    tmp0 *= 2446;                                  // FIX_0_298631336
    tmp1 *= 16819;                                 // FIX_2_053119869
    tmp2 *= 25172;                                 // FIX_3_072711026
    tmp3 *= 12299;                                 // FIX_1_501321110
    z1 *= -7373;                                   // FIX_0_899976223
    z2 *= -20995;                                  // FIX_2_562915447
    z3 *= -16069;                                  // FIX_1_961570560
    z4 *= -3196;                                   // FIX_0_390180644
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CONST_BITS - PASS1_BITS;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, S));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, S));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, S));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, S));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, S));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, S));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, S));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, S));
  }
  constexpr int S2 = CONST_BITS + PASS1_BITS + 3;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137;
    int64_t tmp3 = z1 + z2 * 6270;
    int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (1 << CONST_BITS);
    int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (1 << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    auto lim = [](int64_t x) { return RANGE_LIMIT.t[static_cast<int>(x) & 1023]; };
    op[0] = lim(descale(tmp10 + tmp3, S2));
    op[7] = lim(descale(tmp10 - tmp3, S2));
    op[1] = lim(descale(tmp11 + tmp2, S2));
    op[6] = lim(descale(tmp11 - tmp2, S2));
    op[2] = lim(descale(tmp12 + tmp1, S2));
    op[5] = lim(descale(tmp12 - tmp1, S2));
    op[3] = lim(descale(tmp13 + tmp0, S2));
    op[4] = lim(descale(tmp13 - tmp0, S2));
  }
}

// The component's samples of row y (clamped to its real rows, as libjpeg's
// context rows replicate the first and last).
inline const uint8_t* comp_row(const Component& c, int y) {
  y = y < 0 ? 0 : (y >= c.dh ? c.dh - 1 : y);
  return c.pix.data() + static_cast<size_t>(y) * c.bw * 8;
}

// One output row (image row y) of component c upsampled to full width
// `out_w` (>= the image width), libjpeg-turbo's way with fancy upsampling on
// (jdsample.c's jinit_upsampler): ratio 1x1 copied, 2x1 and 2x2 through the
// triangle filters when the component is wider than 2 samples (else
// replicated), 1x2 through its filter, every other integral ratio rh x rv
// replicated (int_upsample).
void upsample_row(const Component& c, int rh, int rv, int y, uint8_t* out, int out_w) {
  const int dw = c.dw;
  if (rh == 1 && rv == 1) {
    std::memcpy(out, comp_row(c, y), out_w);
  } else if (rh == 2 && rv == 1 && dw > 2) {  // h2v1 fancy
    const uint8_t* in = comp_row(c, y);
    out[0] = in[0];
    out[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
    for (int x = 1; x < dw - 1; ++x) {
      const int v = in[x] * 3;
      out[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
      out[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
    }
    out[2 * dw - 2] = static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
    out[2 * dw - 1] = in[dw - 1];
  } else if (rh == 1 && rv == 2) {  // h1v2 fancy: the nearer row and the next nearer
    const int iy = y >> 1;
    const uint8_t* in0 = comp_row(c, iy);
    const uint8_t* in1 = comp_row(c, (y & 1) ? iy + 1 : iy - 1);
    const int bias = (y & 1) ? 2 : 1;
    for (int x = 0; x < dw; ++x) out[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
  } else if (rh == 2 && rv == 2 && dw > 2) {  // h2v2 fancy
    const int iy = y >> 1;
    const uint8_t* in0 = comp_row(c, iy);
    const uint8_t* in1 = comp_row(c, (y & 1) ? iy + 1 : iy - 1);
    int thiscol = in0[0] * 3 + in1[0];
    int nextcol = in0[1] * 3 + in1[1];
    out[0] = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
    out[1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
    int lastcol = thiscol;
    thiscol = nextcol;
    for (int x = 1; x < dw - 1; ++x) {
      nextcol = in0[x + 1] * 3 + in1[x + 1];
      out[2 * x] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
      out[2 * x + 1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
      lastcol = thiscol;
      thiscol = nextcol;
    }
    out[2 * dw - 2] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
    out[2 * dw - 1] = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
  } else {  // replication: each sample rh times, each row rv times
    const uint8_t* in = comp_row(c, y / rv);
    for (int x = 0; x < dw; ++x) std::memset(out + static_cast<size_t>(x) * rh, in[x], rh);
  }
}

// jdcolor.c's YCbCr -> RGB tables (SCALEBITS 16).
struct YccTables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    constexpr int SCALEBITS = 16;
    constexpr int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1 << SCALEBITS) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = static_cast<int>(-fix(0.71414) * x);
      cb_g[i] = static_cast<int>(-fix(0.34414) * x + ONE_HALF);
    }
  }
};
const YccTables YCC;

inline uint8_t clamp8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// Pillow's cmyk2rgb (Convert.c): MULDIV255 rounding, alpha 255.
inline uint8_t cmyk_channel(int v, int nk) {
  const int t = v * nk + 128;
  return clamp8(nk - (((t >> 8) + t) >> 8));
}

// IDCT every block of every component (libjpeg's raw data: each component at
// its own sampling, MCU-padded).
void idct_all(Jpeg& j) {
  for (int i = 0; i < j.ncomp; ++i) {
    Component& c = j.comp[i];
    const int stride = c.bw * 8;
    c.pix.assign(static_cast<size_t>(stride) * c.bh * 8, 0);
    for (int by = 0; by < c.bh; ++by) {
      for (int bx = 0; bx < c.bw; ++bx) {
        idct_islow(c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64, c.quant,
                   c.pix.data() + static_cast<size_t>(by) * 8 * stride + bx * 8, stride);
      }
    }
    std::vector<int16_t>().swap(c.coef);
  }
}

// How the components reach the output: as libjpeg guesses the colour space
// (kGuess), YCbCr forced (libtiff's JPEGCOLORMODE_RGB), or as they are
// (libtiff's JCS_UNKNOWN: up to four, the fourth in the alpha byte).
enum ColorMode { kGuess, kYcc, kRaw };

// `four_as_cmyk`: four components are CMYK whatever the Adobe marker says
// (PIL's jpegmode "CMYK", which BLP1's JPEG reader sets).
void jpeg_decode(const uint8_t* data, size_t len, uint8_t* out, int out_w, int out_h,
                 bool four_as_cmyk, ColorMode mode = kGuess) {
  Jpeg j(data, len);
  j.parse(false);
  if (j.width != out_w || j.height != out_h) fail("JPEG: size changed between calls");
  const int W = j.width, H = j.height;
  idct_all(j);
  // Upsample row by row and convert.
  const int row_w = j.mcux * j.hmax * 8;  // >= W, room for every upsampled row
  std::vector<uint8_t> rows(static_cast<size_t>(4) * row_w);
  int rh[4], rv[4];
  for (int i = 0; i < j.ncomp; ++i) {
    rh[i] = j.hmax / j.comp[i].h;
    rv[i] = j.vmax / j.comp[i].v;
  }
  // Three components are YCbCr unless an Adobe marker says transform 0 or
  // the component ids spell R, G, B (libjpeg's and stb_image's rules); four
  // are YCCK when an Adobe marker's transform is not 0 (jdapimin.c).
  const bool rgb = mode == kRaw ||
                   (mode == kGuess && j.ncomp == 3 &&
                    ((j.adobe && j.adobe_transform == 0) ||
                     (j.comp[0].id == 'R' && j.comp[1].id == 'G' && j.comp[2].id == 'B')));
  const bool ycck = mode == kGuess && j.ncomp == 4 && j.adobe && j.adobe_transform != 0 &&
                    !four_as_cmyk;
  if (mode == kYcc && j.ncomp != 3) {
    fail("JPEG: YCbCr output of " + std::to_string(j.ncomp) + " components");
  }
  for (int y = 0; y < H; ++y) {
    uint8_t* orow = out + static_cast<size_t>(y) * W * 4;
    if (j.ncomp == 1) {
      const uint8_t* g = comp_row(j.comp[0], y);
      for (int x = 0; x < W; ++x) {
        orow[4 * x] = orow[4 * x + 1] = orow[4 * x + 2] = g[x];
        orow[4 * x + 3] = 255;
      }
      continue;
    }
    for (int i = 0; i < j.ncomp; ++i) {
      upsample_row(j.comp[i], rh[i], rv[i], y, rows.data() + static_cast<size_t>(i) * row_w,
                   row_w);
    }
    const uint8_t* c0 = rows.data();
    const uint8_t* c1 = c0 + row_w;
    const uint8_t* c2 = c1 + row_w;
    const uint8_t* c3 = c2 + row_w;
    for (int x = 0; x < W; ++x) {
      uint8_t* o = orow + 4 * x;
      int r = c0[x], g = c1[x], b = c2[x];
      if (!rgb && (j.ncomp == 3 || ycck)) {
        const int yy = c0[x], cb = c1[x], cr = c2[x];
        r = clamp8(yy + YCC.cr_r[cr]);
        g = clamp8(yy + ((YCC.cb_g[cb] + YCC.cr_g[cr]) >> 16));
        b = clamp8(yy + YCC.cb_b[cb]);
      }
      if (j.ncomp == 4 && mode == kRaw) {
        o[0] = static_cast<uint8_t>(r), o[1] = static_cast<uint8_t>(g);
        o[2] = static_cast<uint8_t>(b), o[3] = c3[x];
        continue;
      }
      if (j.ncomp == 4) {
        // libjpeg's CMYK (YCCK: 255 - R, 255 - G, 255 - B and K), inverted
        // by PIL's "CMYK;I", then cmyk2rgb with 255 - K' = K.
        const int nk = c3[x];
        if (!ycck) r = 255 - r, g = 255 - g, b = 255 - b;
        r = cmyk_channel(r, nk), g = cmyk_channel(g, nk), b = cmyk_channel(b, nk);
      }
      o[0] = static_cast<uint8_t>(r);
      o[1] = static_cast<uint8_t>(g);
      o[2] = static_cast<uint8_t>(b);
      o[3] = 255;
    }
  }
}

// `fmt` names the format in a failure inside the decoder; a fault's message
// names it already.
template <class F>
int guarded(const char* fmt, F&& f) {
  try {
    f();
    return 0;
  } catch (const DecodeError& e) {
    g_error = e.what();
    return 1;
  } catch (const std::exception& e) {
    g_error = std::string(fmt) + ": decoder failure: " + e.what();
    return 2;
  }
}

}  // namespace

namespace tracy_image {

// Set the calling thread's message (image_formats.cpp's entry points).
void set_error(const std::string& msg) { g_error = msg; }

std::string jpeg_planes(const uint8_t* p, size_t n, std::vector<std::vector<uint8_t>>& planes,
                        std::vector<int>& layout, int* w, int* h) {
  try {
    Jpeg j(p, n);
    j.parse(false);
    idct_all(j);
    *w = j.width, *h = j.height;
    planes.clear(), layout.clear();
    for (int i = 0; i < j.ncomp; ++i) {
      Component& c = j.comp[i];
      planes.push_back(std::move(c.pix));
      layout.insert(layout.end(), {j.hmax / c.h, j.vmax / c.v, c.bw * 8});
    }
    return "";
  } catch (const std::exception& e) {
    return e.what();
  }
}

std::string jpeg_components(const uint8_t* p, size_t n, bool ycc_to_rgb,
                            std::vector<uint8_t>& out, int* w, int* h, int* comps) {
  try {
    Jpeg j(p, n);
    j.parse(true);
    *w = j.width, *h = j.height, *comps = j.ncomp;
    std::vector<uint8_t> rgba(size_t(4) * j.width * j.height);
    jpeg_decode(p, n, rgba.data(), j.width, j.height, false, ycc_to_rgb ? kYcc : kRaw);
    const int c = j.ncomp;
    out.resize(size_t(c) * j.width * j.height);
    for (size_t i = 0; i < size_t(j.width) * j.height; ++i)
      for (int k = 0; k < c; ++k) out[i * c + k] = rgba[4 * i + k];
    return "";
  } catch (const std::exception& e) {
    return e.what();
  }
}

}  // namespace tracy_image

extern "C" {

// The message of the calling thread's last failed call.
const char* tracy_decode_error() { return g_error.c_str(); }

// Unfilter and convert an inflated PNG image (the concatenated IDAT data,
// decompressed) to RGBA8 [h, w, 4] in `out`. raw is modified in place.
// plte/trns may be null with length 0.
int tracy_png_decode(uint8_t* raw, int64_t raw_len, int w, int h, int depth, int ctype,
                     int interlace, const uint8_t* plte, int plte_len, const uint8_t* trns,
                     int trns_len, uint8_t* out) {
  return guarded("PNG", [&] {
    const PngInfo p{w, h, depth, ctype, plte, plte_len, trns, trns_len};
    png_decode(p, raw, raw_len, interlace, out);
  });
}

// Width, height, component count and whether the file is progressive, read
// from the frame header.
int tracy_jpeg_info(const uint8_t* data, int64_t len, int* w, int* h, int* comps,
                    int* progressive) {
  return guarded("JPEG", [&] {
    Jpeg j(data, static_cast<size_t>(len));
    j.parse(true);
    *w = j.width;
    *h = j.height;
    *comps = j.ncomp;
    *progressive = j.progressive ? 1 : 0;
  });
}

// Decode a JPEG to RGBA8 [h, w, 4] in `out` (w, h from tracy_jpeg_info);
// `four_as_cmyk` nonzero reads four components as CMYK whatever the Adobe
// marker's transform (BLP1's JPEG kind, as PIL opens it).
int tracy_jpeg_decode(const uint8_t* data, int64_t len, uint8_t* out, int w, int h,
                      int four_as_cmyk) {
  return guarded(
      "JPEG", [&] { jpeg_decode(data, static_cast<size_t>(len), out, w, h, four_as_cmyk != 0); });
}

}  // extern "C"
