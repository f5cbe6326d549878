// The small raw and run-length formats that PIL (tracy_tpu's loader) opens
// through its plugins, decoded on the host: PCX and DCX, SGI, Sun raster,
// MSP, IM, XBM, XPM, PIXAR, SPIDER, FITS, GIMP brushes (GBR), McIdas area
// files, XV thumbnails, IM Tools (IMT), IPTC/NAA, Kodak Photo CD (PCD) and
// FLI/FLC. Built into the decoder library beside image_decode.cpp
// (utils/native.py::get_image_lib), with its conventions:
// `tracy_<fmt>_info` (width and height, as the plugin's _open finds them)
// and `tracy_<fmt>_decode` (RGBA8 [h, w, 4], as open(...).convert("RGBA")
// gives it) return 0; 1 for a fault of the file or a kind that PIL refuses
// too, named; 2 for a failure inside the decoder; or 3 where the plugin's
// _open raises an error that Image.open takes for "not this format" and so
// tries its next plugin (utils/image_io.py::image_format asks
// tracy_<fmt>_info for that); `tracy_legacy_mode` gives PIL's mode of each.
// IPTC's picture is an embedded stream of any format PIL opens:
// `tracy_iptc_stream` lists its pieces, and utils/image_io.py hands them to
// the decoders.
//
// Pillow decodes PCX, SGI RLE, Sun RLE, XBM, FLI, PCD and IM's bit-packed
// types in C that is not installed as source; these readers follow what
// its output shows. The
// output equals PIL's but where ROADMAP's hazards say otherwise, where
// PIL loses a picture that the format defines:
//
// PCX: 24-bit images of width 1 (which PIL finds truncated) or 3 (whose
//   green and blue planes PIL reads at the width, not at the padded
//   stride) read each plane at the row's stride.
// Sun raster: a run-length image's rows are padded to 16 bits in the
//   decoded stream, as in a raw one (PIL cuts its rows unpadded).
// FITS: BITPIX 16, 32, -32 and -64 are big-endian two's-complement or IEEE
//   samples, scaled by BSCALE and BZERO (PIL reads them little-endian,
//   unsigned at 16 bits, 4-byte at -64, unscaled), then taken to 8 bits as
//   PIL takes modes I and F.
//
// Where PIL reads a sample of more than 8 bits to 8 (modes I, I;16 and F:
// SPIDER, IM's deep kinds, McIdas, FITS), integers are clipped to [0, 255]
// and floats truncated toward zero and clipped, NaN 0.

#include <array>
#include <cctype>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <map>

#include "image_common.h"

namespace {

struct Size {
  int64_t w, h;
};

// Up to 256 RGB entries; entries a file does not give are black, as PIL
// pads a short palette.
struct Palette {
  uint8_t rgb[256][3] = {};

  void set(int i, int r, int g, int b) {
    rgb[i][0] = static_cast<uint8_t>(r);
    rgb[i][1] = static_cast<uint8_t>(g);
    rgb[i][2] = static_cast<uint8_t>(b);
  }
  void put(uint8_t* o, int i, int a = 255) const { ::put(o, rgb[i][0], rgb[i][1], rgb[i][2], a); }
  // A grey ramp: PIL's default palette (FLI's before its colour chunk).
  static Palette grey() {
    Palette p;
    for (int i = 0; i < 256; ++i) p.set(i, i, i, i);
    return p;
  }
};

inline void put_grey(uint8_t* o, int v, int a = 255) { put(o, v, v, v, a); }

inline int bit_msb(const uint8_t* row, int64_t x) { return (row[x >> 3] >> (7 - (x & 7))) & 1; }

using tracy_image::be16;
using tracy_image::be32;
using tracy_image::f32;
using tracy_image::f_to_u8;
using tracy_image::i_to_u8;
using tracy_image::le16;
using tracy_image::le32;

// The image's own pixels from `at` on: `rows` rows of `row` bytes each
// `stride` apart (the last one needs only its `row` bytes, as PIL's raw
// decoder reads it).
const uint8_t* raw_rows(const Bytes& b, size_t at, int64_t rows, int64_t row, int64_t stride) {
  if (rows > 0) b.need(at, static_cast<size_t>((rows - 1) * stride + row));
  return b.p + at;
}

std::string str(const uint8_t* p, size_t n) { return std::string(reinterpret_cast<const char*>(p), n); }

// Python's bytes.strip(): ASCII whitespace off both ends.
std::string strip(const std::string& s) {
  const char* ws = " \t\n\r\x0b\x0c";
  const size_t a = s.find_first_not_of(ws);
  if (a == std::string::npos) return "";
  return s.substr(a, s.find_last_not_of(ws) - a + 1);
}

// Python's int() of a str or bytes: optional whitespace and sign, decimal
// digits (single underscores between them). False where int() raises.
bool py_int(const std::string& text, int64_t* v) {
  const std::string s = strip(text);
  size_t i = 0;
  bool neg = false;
  if (i < s.size() && (s[i] == '+' || s[i] == '-')) neg = s[i++] == '-';
  if (i == s.size()) return false;
  int64_t r = 0;
  bool digit = false;
  for (; i < s.size(); ++i) {
    if (s[i] == '_' && digit && i + 1 < s.size() && std::isdigit(static_cast<unsigned char>(s[i + 1]))) continue;
    if (!std::isdigit(static_cast<unsigned char>(s[i]))) return false;
    digit = true;
    r = r * 10 + (s[i] - '0');
    if (r > (int64_t(1) << 40)) r = int64_t(1) << 40;  // far beyond any size read
  }
  *v = neg ? -r : r;
  return true;
}

// Python's float() (decimal, exponent, inf, nan); false where it raises.
bool py_float(const std::string& text, double* v) {
  const std::string s = strip(text);
  if (s.empty()) return false;
  char* end = nullptr;
  *v = std::strtod(s.c_str(), &end);
  return end == s.c_str() + s.size() && s.find_first_of("xXpP") == std::string::npos;
}

// ---------------------------------------------------------------- PCX, DCX

enum class PcxKind { Bits1, Planar, Grey, Palette8, Rgb };

struct Pcx {
  int64_t w, h;
  PcxKind kind;
  int planes;
  int64_t stride;  // one plane's row
  size_t data;     // where the run-length data starts
  Palette pal;
};

// The PCX header at `at` (0, or a DCX page), as PcxImageFile._open reads
// it: its 8-bit palette, when there is one, is the file's last 769 bytes.
Pcx pcx_head(const Bytes& b, size_t at, const char* fmt) {
  const std::string F(fmt);
  if (at > b.n || b.n - at < 68) not_format(F + ": header is truncated");
  const uint8_t* s = b.p + at;
  if (s[0] != 10 || !(s[1] == 0 || s[1] == 2 || s[1] == 3 || s[1] == 5)) {
    not_format(F + ": not a PCX header");
  }
  const int64_t x0 = le16(s + 4), y0 = le16(s + 6), x1 = le16(s + 8) + 1, y1 = le16(s + 10) + 1;
  if (x1 <= x0 || y1 <= y0) not_format(F + ": bad image size");
  const int version = s[1], bits = s[3], planes = s[65];
  const int64_t provided = le16(s + 66);
  Pcx m{};
  m.w = x1 - x0;
  m.h = y1 - y0;
  m.planes = planes;
  if (bits == 1 && planes == 1) {
    m.kind = PcxKind::Bits1;
  } else if (bits == 1 && (planes == 2 || planes == 4)) {
    m.kind = PcxKind::Planar;
    for (int i = 0; i < 16; ++i) m.pal.set(i, s[16 + 3 * i], s[17 + 3 * i], s[18 + 3 * i]);
  } else if (version == 5 && bits == 8 && planes == 1) {
    m.kind = PcxKind::Grey;
    if (b.n < 769) fail(F + ": file is shorter than a palette");
    const uint8_t* t = b.p + b.n - 769;
    if (t[0] == 12) {
      for (int i = 0; i < 256; ++i) {
        if (t[1 + 3 * i] != i || t[2 + 3 * i] != i || t[3 + 3 * i] != i) m.kind = PcxKind::Palette8;
      }
      for (int i = 0; i < 256; ++i) m.pal.set(i, t[1 + 3 * i], t[2 + 3 * i], t[3 + 3 * i]);
    }
  } else if (version == 5 && bits == 8 && planes == 3) {
    m.kind = PcxKind::Rgb;
  } else {
    fail(F + ": version " + std::to_string(version) + ", " + std::to_string(bits) + " bits, " +
         std::to_string(planes) + " planes not read (PIL: unknown PCX mode)");
  }
  m.stride = (m.w * bits + 7) / 8;
  if (provided != m.stride) m.stride += m.stride % 2;
  m.data = at + 128;
  check_size(fmt, m.w, m.h);
  return m;
}

void pcx_read(const Bytes& b, const Pcx& m, uint8_t* out) {
  const int64_t row = m.planes * m.stride, w = m.w;
  std::vector<uint8_t> buf(static_cast<size_t>(row));
  size_t pos = m.data;
  for (int64_t y = 0; y < m.h; ++y) {
    for (int64_t x = 0; x < row;) {
      const uint8_t c = b.u8(pos);
      if ((c & 0xC0) == 0xC0) {
        const int64_t n = c & 0x3F;
        const uint8_t v = b.u8(pos + 1);
        if (x + n > row) fail(std::string(b.fmt) + ": a run overruns its row");
        std::memset(buf.data() + x, v, static_cast<size_t>(n));
        x += n;
        pos += 2;
      } else {
        buf[x++] = c;
        ++pos;
      }
    }
    uint8_t* o = out + 4 * y * w;
    const uint8_t* r = buf.data();
    for (int64_t x = 0; x < w; ++x, o += 4) {
      switch (m.kind) {
        case PcxKind::Bits1: put_grey(o, bit_msb(r, x) ? 255 : 0); break;
        case PcxKind::Planar: {
          int i = 0;
          for (int k = 0; k < m.planes; ++k) i |= bit_msb(r + k * m.stride, x) << k;
          m.pal.put(o, i);
          break;
        }
        case PcxKind::Grey: put_grey(o, r[x]); break;
        case PcxKind::Palette8: m.pal.put(o, r[x]); break;
        case PcxKind::Rgb: put(o, r[x], r[m.stride + x], r[2 * m.stride + x], 255); break;
      }
    }
  }
}

Size pcx_header(const Bytes& b) {
  const Pcx m = pcx_head(b, 0, "PCX");
  return {m.w, m.h};
}

void pcx_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Pcx m = pcx_head(b, 0, "PCX");
  check_out("PCX", m.w, m.h, out_w, out_h);
  pcx_read(b, m, out);
}

// DCX: u32 987654321, then page offsets up to a 0 (at most 1024); PIL opens
// the first page.
size_t dcx_page(const Bytes& b) {
  if (b.n < 4 || le32(b.p) != 987654321u) not_format("DCX: not a DCX file");
  size_t first = 0;
  for (size_t i = 0; i < 1024; ++i) {
    const size_t at = 4 + 4 * i;
    if (at + 4 > b.n) not_format("DCX: page directory is truncated");
    const uint32_t off = le32(b.p + at);
    if (off == 0) break;
    if (i == 0) first = off;
  }
  if (first == 0) not_format("DCX: no page");
  return first;
}

Size dcx_header(const Bytes& b) {
  const Pcx m = pcx_head(b, dcx_page(b), "DCX");
  return {m.w, m.h};
}

void dcx_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Pcx m = pcx_head(b, dcx_page(b), "DCX");
  check_out("DCX", m.w, m.h, out_w, out_h);
  pcx_read(b, m, out);
}

// ---------------------------------------------------------------- SGI

struct Sgi {
  int64_t w, h;
  int bpc, bands;
  bool rle;
};

Sgi sgi_head(const Bytes& b) {
  if (b.n < 12) not_format("SGI: header is truncated");
  if (be16(b.p) != 474) not_format("SGI: not an SGI file");
  const int compression = b.p[2], bpc = b.p[3];
  const int dimension = static_cast<int>(be16(b.p + 4)), zsize = static_cast<int>(be16(b.p + 10));
  Sgi m{static_cast<int64_t>(be16(b.p + 6)), static_cast<int64_t>(be16(b.p + 8)), bpc, 0,
        compression == 1};
  const bool known = (bpc == 1 || bpc == 2) &&
                     ((zsize == 1 && (dimension == 1 || dimension == 2)) ||
                      (dimension == 3 && (zsize == 3 || zsize == 4)));
  if (!known) {
    fail("SGI: " + std::to_string(bpc) + " bytes a sample, dimension " +
         std::to_string(dimension) + ", " + std::to_string(zsize) +
         " channels not read (PIL: unsupported SGI image mode)");
  }
  m.bands = zsize;
  if (m.w <= 0 || m.h <= 0) not_format("SGI: empty image");
  if (compression > 1) {
    fail("SGI: storage " + std::to_string(compression) + " not read");
  }
  check_size("SGI", m.w, m.h);
  return m;
}

Size sgi_header(const Bytes& b) {
  const Sgi m = sgi_head(b);
  return {m.w, m.h};
}

// One row of SgiRleDecode: `n` control bytes (or 2-byte words at bpc 2)
// from src; returns -1 on an overrun, 1 where the last word is not a stop
// (PIL then ends the image there, silently), else 0.
int sgi_expand(uint8_t* dest, const uint8_t* src, int64_t n, int z, int64_t xsize,
               const uint8_t* last, int bpc) {
  int64_t x = 0;
  for (; n > 0; --n) {
    if (src + (bpc - 1) > last) return -1;
    const uint8_t pixel = src[bpc - 1];
    src += bpc;
    if (n == 1 && pixel != 0) return 1;
    int count = pixel & 0x7f;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + bpc * count > last) return -1;
      while (count--) {
        std::memcpy(dest, src, bpc);
        src += bpc;
        dest += z * bpc;
      }
    } else {
      if (src + (bpc - 1) > last) return -1;
      while (count--) {
        std::memcpy(dest, src, bpc);
        dest += z * bpc;
      }
      src += bpc;
    }
  }
  return 0;
}

void sgi_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Sgi m = sgi_head(b);
  check_out("SGI", m.w, m.h, out_w, out_h);
  const int64_t w = m.w, h = m.h, z = m.bands, bpc = m.bpc;
  std::fill(out, out + 4 * w * h, 0);
  // The high byte of each sample (PIL's ;16B raw modes) into the RGBA row.
  const auto store = [&](int64_t y, const uint8_t* row) {
    uint8_t* o = out + 4 * y * w;
    for (int64_t x = 0; x < w; ++x, o += 4) {
      const uint8_t* s = row + x * z * bpc;
      if (z == 1) put_grey(o, s[0]);
      else put(o, s[0], s[bpc], s[2 * bpc], z == 4 ? s[3 * bpc] : 255);
    }
  };
  std::vector<uint8_t> row(static_cast<size_t>(w * z * bpc), 0);
  if (!m.rle) {
    const int64_t page = w * h * bpc;
    b.need(512, static_cast<size_t>(page * z));
    for (int64_t y = 0; y < h; ++y) {  // bottom row first
      for (int64_t c = 0; c < z; ++c) {
        const uint8_t* src = b.p + 512 + c * page + (h - 1 - y) * w * bpc;
        for (int64_t x = 0; x < w; ++x) std::memcpy(&row[(x * z + c) * bpc], src + x * bpc, bpc);
      }
      store(y, row.data());
    }
    return;
  }
  const int64_t tablen = z * h, bufsize = static_cast<int64_t>(b.n) - 512;
  if (bufsize < 8 * tablen) fail("SGI: offset tables are truncated");
  const uint8_t* buf = b.p + 512;
  const uint8_t* last = buf + bufsize - 1;
  for (int64_t r = 0; r < h; ++r) {
    for (int64_t c = 0; c < z; ++c) {
      const int64_t k = r + c * h;
      const int64_t start = be32(buf + 4 * k), len = be32(buf + 4 * (tablen + k));
      if (start < 512 || start - 512 + len > bufsize) fail("SGI: a row lies outside the file");
      const int s = sgi_expand(row.data() + c * bpc, buf + start - 512, len, static_cast<int>(z),
                               w, last, static_cast<int>(bpc));
      if (s < 0) fail("SGI: a run overruns its row");
      if (s == 1) return;
    }
    store(h - 1 - r, row.data());
  }
}

// ---------------------------------------------------------------- Sun raster

struct Sun {
  int64_t w, h;
  int depth, type;
  bool palette;
  Palette pal;
  size_t data;
  int64_t stride;
};

Sun sun_head(const Bytes& b) {
  if (b.n < 32 || be32(b.p) != 0x59a66a95u) not_format("Sun raster: not a Sun raster file");
  Sun m{};
  m.w = be32(b.p + 4);
  m.h = be32(b.p + 8);
  m.depth = static_cast<int>(std::min<uint32_t>(be32(b.p + 12), 1u << 30));
  const uint32_t type = be32(b.p + 20), pal_type = be32(b.p + 24), pal_len = be32(b.p + 28);
  if (m.depth != 1 && m.depth != 4 && m.depth != 8 && m.depth != 24 && m.depth != 32) {
    not_format("Sun raster: depth " + std::to_string(m.depth) + " not read");
  }
  m.data = 32;
  if (pal_len) {
    if (pal_len > 1024) not_format("Sun raster: palette of more than 1024 bytes");
    if (pal_type != 1) not_format("Sun raster: palette type " + std::to_string(pal_type));
    m.data += pal_len;
    // Planar RGB of pal_len / 3 entries (PIL's "RGB;L"), the rest black.
    const int64_t n = std::min<int64_t>(pal_len / 3, 256);
    const int64_t have = std::min<int64_t>(pal_len, static_cast<int64_t>(b.n) - 32);
    const uint8_t* p = b.p + 32;
    const auto at = [&](int64_t i) { return i < have ? p[i] : 0; };
    for (int64_t i = 0; i < n; ++i) m.pal.set(static_cast<int>(i), at(i), at(n + i), at(2 * n + i));
    m.palette = m.depth == 4 || m.depth == 8;
  }
  if (type > 5) not_format("Sun raster: file type " + std::to_string(type));
  m.type = static_cast<int>(type);
  if (m.w <= 0 || m.h <= 0) not_format("Sun raster: empty image");
  if (m.depth == 1 && pal_len) fail("Sun raster: a 1-bit image with a palette (PIL cannot read it)");
  check_size("Sun raster", m.w, m.h);
  m.stride = (m.w * m.depth + 15) / 16 * 2;
  return m;
}

Size sun_header(const Bytes& b) {
  const Sun m = sun_head(b);
  return {m.w, m.h};
}

void sun_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Sun m = sun_head(b);
  check_out("SUN", m.w, m.h, out_w, out_h);
  const int64_t w = m.w, h = m.h, stride = m.stride;
  const uint8_t* rows;
  std::vector<uint8_t> flat;
  if (m.type == 2) {
    // Byte-encoded: 0x80 n v is n + 1 copies of v, 0x80 0 a literal 0x80;
    // runs cross rows, and the stream holds the padded rows.
    flat.resize(static_cast<size_t>(stride * h));
    size_t pos = m.data, o = 0;
    while (o < flat.size()) {
      const uint8_t c = b.u8(pos);
      if (c != 0x80) {
        flat[o++] = c;
        ++pos;
        continue;
      }
      const uint8_t n = b.u8(pos + 1);
      if (n == 0) {
        flat[o++] = 0x80;
        pos += 2;
        continue;
      }
      const uint8_t v = b.u8(pos + 2);
      const size_t k = std::min<size_t>(n + 1u, flat.size() - o);
      std::memset(flat.data() + o, v, k);
      o += k;
      pos += 3;
    }
    rows = flat.data();
  } else {
    rows = raw_rows(b, m.data, h, (w * m.depth + 7) / 8, stride);
  }
  const bool rgb = m.type == 3;
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* r = rows + y * stride;
    uint8_t* o = out + 4 * y * w;
    for (int64_t x = 0; x < w; ++x, o += 4) {
      switch (m.depth) {
        case 1: put_grey(o, bit_msb(r, x) ? 0 : 255); break;  // PIL's "1;I"
        case 4: {
          const int v = (r[x >> 1] >> ((x & 1) ? 0 : 4)) & 15;
          if (m.palette) m.pal.put(o, v);
          else put_grey(o, v * 17);
          break;
        }
        case 8:
          if (m.palette) m.pal.put(o, r[x]);
          else put_grey(o, r[x]);
          break;
        default: {
          const uint8_t* s = r + x * (m.depth / 8);
          if (rgb) put(o, s[0], s[1], s[2], 255);
          else put(o, s[2], s[1], s[0], 255);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- MSP

struct Msp {
  int64_t w, h;
  bool v2;
};

Msp msp_head(const Bytes& b) {
  if (b.n < 4 || !(std::memcmp(b.p, "DanM", 4) == 0 || std::memcmp(b.p, "LinS", 4) == 0)) {
    not_format("MSP: not an MSP file");
  }
  if (b.n < 32) not_format("MSP: header is truncated");
  uint32_t sum = 0;
  for (int i = 0; i < 32; i += 2) sum ^= le16(b.p + i);
  if (sum != 0) not_format("MSP: bad header checksum");
  Msp m{le16(b.p + 4), le16(b.p + 6), b.p[0] == 'L'};
  if (m.w <= 0 || m.h <= 0) not_format("MSP: empty image");
  return m;
}

Size msp_header(const Bytes& b) {
  const Msp m = msp_head(b);
  return {m.w, m.h};
}

void msp_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Msp m = msp_head(b);
  check_out("MSP", m.w, m.h, out_w, out_h);
  const int64_t w = m.w, h = m.h, stride = (w + 7) / 8;
  std::vector<uint8_t> img;
  const uint8_t* bits;
  if (!m.v2) {
    bits = raw_rows(b, 32, h, stride, stride);
  } else {
    // A map of each row's encoded length, then the rows: 0 n v is n copies
    // of v, k > 0 then k literal bytes; a row of length 0 is white.
    if (b.n < 32 + 2 * static_cast<size_t>(h)) fail("MSP: row map is truncated");
    size_t pos = 32 + 2 * static_cast<size_t>(h);
    for (int64_t y = 0; y < h; ++y) {
      const size_t len = le16(b.p + 32 + 2 * y);
      if (len == 0) {
        img.insert(img.end(), static_cast<size_t>(stride), 0xff);
        continue;
      }
      if (pos + len > b.n) fail("MSP: row " + std::to_string(y) + " is truncated");
      const uint8_t* row = b.p + pos;
      for (size_t i = 0; i < len;) {
        const uint8_t t = row[i++];
        if (t == 0) {
          if (i + 2 > len) fail("MSP: row " + std::to_string(y) + " is corrupt");
          img.insert(img.end(), row[i], row[i + 1]);
          i += 2;
        } else {
          const size_t k = std::min<size_t>(t, len - i);
          img.insert(img.end(), row + i, row + i + k);
          i += t;
        }
      }
      pos += len;
    }
    if (img.size() < static_cast<size_t>(stride * h)) fail("MSP: not enough image data");
    bits = img.data();
  }
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) put_grey(out + 4 * (y * w + x), bit_msb(bits + y * stride, x) ? 255 : 0);
  }
}

// ---------------------------------------------------------------- IM

// ImImagePlugin's OPEN table: image type -> (mode, rawmode). The port
// refuses RLB by name, as PIL does (it has no unpacker for it).
const std::map<std::string, std::pair<std::string, std::string>>& im_types() {
  static const std::map<std::string, std::pair<std::string, std::string>> t = [] {
    std::map<std::string, std::pair<std::string, std::string>> m = {
        {"0 1 image", {"1", "1"}},
        {"L 1 image", {"1", "1"}},
        {"Greyscale image", {"L", "L"}},
        {"Grayscale image", {"L", "L"}},
        {"RGB image", {"RGB", "RGB;L"}},
        {"RLB image", {"RGB", "RLB"}},
        {"RYB image", {"RGB", "RLB"}},
        {"B1 image", {"1", "1"}},
        {"B2 image", {"P", "P;2"}},
        {"B4 image", {"P", "P;4"}},
        {"X 24 image", {"RGB", "RGB"}},
        {"L 32 S image", {"I", "I;32"}},
        {"L 32 F image", {"F", "F;32"}},
        {"RGB3 image", {"RGB", "RGB;T"}},
        {"RYB3 image", {"RGB", "RYB;T"}},
        {"LA image", {"LA", "LA;L"}},
        {"PA image", {"LA", "PA;L"}},
        {"RGBA image", {"RGBA", "RGBA;L"}},
        {"RGBX image", {"RGB", "RGBX;L"}},
        {"CMYK image", {"CMYK", "CMYK;L"}},
        {"YCC image", {"YCbCr", "YCbCr;L"}},
    };
    for (const char* i : {"8", "8S", "16", "16S", "32", "32F"}) {
      m[std::string("L ") + i + " image"] = {"F", std::string("F;") + i};
      m[std::string("L*") + i + " image"] = {"F", std::string("F;") + i};
    }
    for (const char* i : {"16", "16L", "16B"}) {
      m[std::string("L ") + i + " image"] = {std::string("I;") + i, std::string("I;") + i};
      m[std::string("L*") + i + " image"] = {std::string("I;") + i, std::string("I;") + i};
    }
    m["L 32S image"] = m["L*32S image"] = {"I", "I;32S"};
    for (int j = 2; j <= 32; ++j) m["L*" + std::to_string(j) + " image"] = {"F", "F;" + std::to_string(j)};
    return m;
  }();
  return t;
}

// The bits a pixel of each raw mode read, 0 for the others. F;n other than
// F;8, F;16 and F;32 is PIL's bit decoder (im_bit_rows).
int im_raw_bits(const std::string& raw) {
  if (raw.size() > 2 && raw.size() <= 4 && raw.compare(0, 2, "F;") == 0 &&
      raw.find_first_not_of("0123456789", 2) == std::string::npos) {
    const int n = std::stoi(raw.substr(2));
    return n >= 2 && n <= 32 ? n : 0;
  }
  static const std::map<std::string, int> bits = {
      {"1", 1},        {"L", 8},        {"P", 8},        {"RGB;L", 24},   {"RGB", 24},
      {"RGBA;L", 32},  {"RGBX;L", 32},  {"LA;L", 16},    {"PA;L", 16},    {"CMYK;L", 32},
      {"F;8", 8},      {"F;8S", 8},     {"F;16", 16},    {"F;16S", 16},   {"F;32", 32},
      {"F;32F", 32},   {"I;16", 16},    {"I;16L", 16},   {"I;16B", 16},   {"I;32S", 32},
      {"I;32", 32},    {"YCbCr;L", 24}, {"P;2", 2},      {"P;4", 4},      {"RGB;T", 24},
      {"RYB;T", 24}};
  const auto it = bits.find(raw);
  return it == bits.end() ? 0 : it->second;
}

struct Im {
  int64_t w, h;
  std::string mode, raw;
  Palette pal;
  size_t data;
};

Im im_head(const Bytes& b) {
  if (std::memchr(b.p, '\n', std::min<size_t>(b.n, 100)) == nullptr) not_format("IM: not an IM file");
  std::string mode = "L", raw = "L";
  std::string size_text;  // the "Image size (x*y)" value, if any
  bool lut = false;
  int tags = 0;
  size_t pos = 0;
  int end = -1;  // the byte that ended the header: 0, 0x1a, or -1 at the file's end
  const auto numbers = [](const std::string& v, std::vector<std::pair<bool, int64_t>>* out) {
    std::string t = v;
    for (char& c : t) {
      if (c == '*') c = ',';
    }
    size_t a = 0;
    for (;;) {
      const size_t c = t.find(',', a);
      const std::string part = t.substr(a, c == std::string::npos ? std::string::npos : c - a);
      int64_t i;
      double f;
      if (py_int(part, &i)) out->push_back({true, i});
      else if (py_float(part, &f)) out->push_back({false, 0});
      else fail("IM: '" + v + "' is not a number");
      if (c == std::string::npos) break;
      a = c + 1;
    }
  };
  while (pos < b.n) {
    const uint8_t c = b.p[pos++];
    if (c == '\r') continue;
    if (c == 0 || c == 0x1a) {
      end = c;
      break;
    }
    const uint8_t* nl = static_cast<const uint8_t*>(std::memchr(b.p + pos, '\n', b.n - pos));
    const size_t stop = nl ? static_cast<size_t>(nl - b.p) + 1 : b.n;
    std::string line = str(b.p + pos - 1, stop - pos + 1);
    pos = stop;
    if (line.size() > 100) not_format("IM: header line of more than 100 bytes");
    if (line.size() >= 2 && line.compare(line.size() - 2, 2, "\r\n") == 0) line.resize(line.size() - 2);
    else if (!line.empty() && line.back() == '\n') line.pop_back();
    // ^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$
    const size_t colon = line.find(':');
    if (!std::isalpha(static_cast<unsigned char>(line[0])) || colon == std::string::npos) {
      not_format("IM: header syntax error");
    }
    const std::string k = line.substr(0, colon);
    size_t vs = colon + 1;
    while (vs < line.size() && (line[vs] == ' ' || line[vs] == '\t')) ++vs;
    std::string v = line.substr(vs);
    if (k == "File size (no of images)" || k == "Scale (x,y)" || k == "Image size (x*y)") {
      std::vector<std::pair<bool, int64_t>> nums;
      numbers(v, &nums);
      if (k == "Image size (x*y)") size_text = v;
    } else if (k == "Image type") {
      const auto it = im_types().find(v);
      if (it != im_types().end()) {
        mode = it->second.first;
        raw = it->second.second;
      } else {
        mode = v;  // PIL keeps the unknown string as the mode
      }
    }
    if (k == "Lut") lut = true;
    static const char* kTags[] = {"Comment", "Date", "Digitalization equipment",
                                  "File size (no of images)", "Lut", "Name", "Scale (x,y)",
                                  "Image size (x*y)", "Image type"};
    for (const char* t : kTags) tags += k == t;
  }
  if (!tags) not_format("IM: not an IM file");
  Im m{512, 512, mode, raw, Palette{}, 0};
  if (!size_text.empty()) {
    std::vector<std::pair<bool, int64_t>> nums;
    numbers(size_text, &nums);
    if (nums.size() == 1) not_format("IM: one number for the size");
    if (nums.size() != 2 || !nums[0].first || !nums[1].first) fail("IM: size '" + size_text + "' not read");
    m.w = nums[0].second;
    m.h = nums[1].second;
  }
  // Skip forward to the image data, after a 0x1a.
  if (end == -1) not_format("IM: file is truncated");
  while (end != 0x1a) {
    if (pos >= b.n) not_format("IM: file is truncated");
    end = b.p[pos++];
  }
  if (lut) {
    if (b.n - pos < 768) not_format("IM: palette is truncated");
    const uint8_t* p = b.p + pos;
    bool grey = true;
    for (int i = 0; i < 256; ++i) grey = grey && p[i] == p[i + 256] && p[i] == p[i + 512];
    if (!grey && (m.mode == "L" || m.mode == "P")) {
      m.mode = m.raw = "P";
    } else if (!grey && (m.mode == "LA" || m.mode == "PA")) {
      m.mode = "PA";
      m.raw = "PA;L";
    }
    for (int i = 0; i < 256; ++i) m.pal.set(i, p[i], p[i + 256], p[i + 512]);
    pos += 768;
  }
  if (m.mode.empty() || m.w <= 0 || m.h <= 0) not_format("IM: no mode or an empty image");
  const bool paletted = m.mode == "P" || m.mode == "PA";
  if (!im_raw_bits(m.raw) || (m.raw == "P" && !paletted) || (m.raw == "PA;L" && m.mode != "PA")) {
    fail("IM: image type '" + mode + "' (PIL mode " + m.mode + ", raw mode " + m.raw +
         ") not read");
  }
  check_size("IM", m.w, m.h);
  m.data = pos;
  return m;
}

Size im_header(const Bytes& b) {
  const Im m = im_head(b);
  return {m.w, m.h};
}


// PIL's "bit" decoder (BitDecode.c) as ImImagePlugin sets it up for the
// L*n types: n-bit unsigned samples taken from the low end of a bit
// buffer that each byte fills from above (64 bits, as an unsigned long
// there, so its refill after more than 32 bits is the same shift); at each
// row's end the bit count (not the buffer) is reset, so that a row starts
// at a fresh byte; bottom row first; mode F.
void im_bit_rows(const Bytes& b, const Im& m, int bits, uint8_t* out) {
  const uint64_t mask = (uint64_t(1) << bits) - 1;
  uint64_t buffer = 0;
  int count = 0;
  size_t pos = m.data;
  int64_t x = 0, y = m.h - 1;
  for (;;) {
    const uint8_t byte = b.u8(pos++);
    buffer |= uint64_t(byte) << count;
    count += 8;
    while (count >= bits) {
      const uint64_t data = buffer & mask;
      buffer >>= bits;
      count -= bits;
      put_grey(out + 4 * (y * m.w + x), f_to_u8(static_cast<float>(data)));
      if (++x >= m.w) {
        if (--y < 0) return;
        x = 0;
        count = 0;
      }
    }
  }
}

void im_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Im m = im_head(b);
  check_out("IM", m.w, m.h, out_w, out_h);
  const int bits = im_raw_bits(m.raw);
  if (m.raw[0] == 'F' && bits != 8 && bits != 16 && bits != 32) return im_bit_rows(b, m, bits, out);
  const int64_t w = m.w, h = m.h, row = (w * bits + 7) / 8;
  const std::string& r = m.raw;
  if (r == "RGB;T" || r == "RYB;T") {
    // Old LabEye/3PC files: three whole planes, green, red, blue, each
    // bottom row first (RYB;T read as RGB;T, as PIL reads it).
    const uint8_t* g = raw_rows(b, m.data, 3 * h, w, w);
    const uint8_t *red = g + w * h, *blue = red + w * h;
    for (int64_t y = 0; y < h; ++y) {
      const int64_t s = (h - 1 - y) * w;
      for (int64_t x = 0; x < w; ++x) put(out + 4 * (y * w + x), red[s + x], g[s + x], blue[s + x], 255);
    }
    return;
  }
  const uint8_t* rows = raw_rows(b, m.data, h, row, row);
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* s = rows + (h - 1 - y) * row;  // PIL reads IM bottom row first
    uint8_t* o = out + 4 * y * w;
    for (int64_t x = 0; x < w; ++x, o += 4) {
      if (r == "1") put_grey(o, bit_msb(s, x) ? 255 : 0);
      else if (r == "L") put_grey(o, s[x]);
      else if (r == "P") m.pal.put(o, s[x]);
      else if (r == "P;2" || r == "P;4") put(o, 0, 0, 0, 255);  // PIL's empty palette: black
      else if (r == "YCbCr;L") {
        uint8_t rgb[3];
        tracy_image::ycbcr_to_rgb(s[x], s[w + x], s[2 * w + x], rgb);
        put(o, rgb[0], rgb[1], rgb[2], 255);
      }
      else if (r == "RGB;L") put(o, s[x], s[w + x], s[2 * w + x], 255);
      else if (r == "RGB") put(o, s[3 * x], s[3 * x + 1], s[3 * x + 2], 255);
      else if (r == "RGBA;L") put(o, s[x], s[w + x], s[2 * w + x], s[3 * w + x]);
      else if (r == "RGBX;L") put(o, s[x], s[w + x], s[2 * w + x], 255);
      else if (r == "LA;L") put_grey(o, s[x], s[w + x]);
      else if (r == "PA;L") m.pal.put(o, s[x], s[w + x]);
      else if (r == "CMYK;L") {
        const int nk = 255 - s[3 * w + x];
        put(o, cmyk_channel(s[x], nk), cmyk_channel(s[w + x], nk), cmyk_channel(s[2 * w + x], nk), 255);
      } else if (r == "F;8") put_grey(o, f_to_u8(s[x]));
      else if (r == "F;8S") put_grey(o, f_to_u8(static_cast<int8_t>(s[x])));
      else if (r == "F;16") put_grey(o, f_to_u8(static_cast<float>(le16(s + 2 * x))));
      else if (r == "F;16S") put_grey(o, f_to_u8(static_cast<int16_t>(le16(s + 2 * x))));
      else if (r == "F;32") put_grey(o, f_to_u8(static_cast<float>(le32(s + 4 * x))));  // unsigned
      else if (r == "F;32F") put_grey(o, f_to_u8(f32(le32(s + 4 * x))));
      else if (r == "I;16" || r == "I;16L") put_grey(o, i_to_u8(le16(s + 2 * x)));
      else if (r == "I;16B") put_grey(o, i_to_u8(be16(s + 2 * x)));
      else put_grey(o, i_to_u8(static_cast<int32_t>(le32(s + 4 * x))));  // I;32S, I;32
    }
  }
}

// ---------------------------------------------------------------- XBM

struct Xbm {
  int64_t w, h;
  size_t data;
};

// [ \t]+[0-9]+[\r\n]+ at `i` of s: the number, and where the match ends;
// false where it does not match.
bool number_line(const std::string& s, size_t i, int64_t* v, size_t* end) {
  const size_t d = s.find_first_not_of(" \t", i);
  if (d == i || d == std::string::npos) return false;
  const size_t e = s.find_first_not_of("0123456789", d);
  if (e == d || e == std::string::npos || (s[e] != '\r' && s[e] != '\n')) return false;
  py_int(s.substr(d, e - d), v);
  *end = s.find_first_not_of("\r\n", e);
  if (*end == std::string::npos) *end = s.size();
  return true;
}

// Where "#define[ \t]+" at `i` of s ends, or npos.
size_t after_define(const std::string& s, size_t i) {
  if (s.compare(i, 7, "#define") != 0 || i + 7 >= s.size() || (s[i + 7] != ' ' && s[i + 7] != '\t')) {
    return std::string::npos;
  }
  return i + 8;
}

// XbmImagePlugin's header expression, matched at the start of the first
// 512 bytes as Python's re matches it:
//   \s*#define[ \t]+.*_width[ \t]+([0-9]+)[\r\n]+
//   #define[ \t]+.*_height[ \t]+([0-9]+)[\r\n]+
//   (#define[ \t]+[^_]*_x_hot[ \t]+[0-9]+[\r\n]+
//    #define[ \t]+[^_]*_y_hot[ \t]+[0-9]+[\r\n]+)?
//   [\000-\377]*_bits\[]
// "." is any byte but a newline, so the greedy ".*_width" tries the line's
// last "_width" first; the data starts after the last "_bits[]".
Xbm xbm_head(const Bytes& b) {
  const std::string head = str(b.p, std::min<size_t>(b.n, 512));
  const size_t lead = head.find_first_not_of(" \t\n\r\x0b\x0c");
  if (lead == std::string::npos || head.compare(lead, 7, "#define") != 0) not_format("XBM: not an XBM file");
  const size_t bits = head.rfind("_bits[]");
  // (value, end) of each match of "#define[ \t]+.*<key>[ \t]+([0-9]+)[\r\n]+"
  // at i, the last key on the line first.
  const auto dims = [&](size_t i, const char* key) {
    std::vector<std::pair<int64_t, size_t>> out;
    const size_t a = after_define(head, i);
    if (a == std::string::npos) return out;
    const size_t nl = std::min(head.find('\n', a), head.size());
    const size_t n = std::strlen(key);
    for (size_t k = head.rfind(key, nl); k != std::string::npos && k >= a; k = head.rfind(key, k - 1)) {
      int64_t v;
      size_t end;
      if (k + n <= nl && number_line(head, k + n, &v, &end)) out.push_back({v, end});
    }
    return out;
  };
  // "#define[ \t]+[^_]*<key>[ \t]+[0-9]+[\r\n]+" at i: its end, or npos.
  const auto hot = [&](size_t i, const char* key) {
    const size_t a = after_define(head, i);
    const size_t u = a == std::string::npos ? a : head.find('_', a);
    int64_t v;
    size_t end;
    if (u == std::string::npos || head.compare(u, std::strlen(key), key) != 0 ||
        !number_line(head, u + std::strlen(key), &v, &end)) {
      return std::string::npos;
    }
    return end;
  };
  for (const auto& wd : dims(lead, "_width")) {
    for (const auto& ht : dims(wd.second, "_height")) {
      size_t at = ht.second;
      const size_t x = hot(at, "_x_hot");
      const size_t y = x == std::string::npos ? x : hot(x, "_y_hot");
      if (y != std::string::npos) at = y;
      if (bits == std::string::npos || bits < at) continue;
      Xbm m{wd.first, ht.first, bits + 7};
      if (m.w <= 0 || m.h <= 0) not_format("XBM: empty image");
      check_size("XBM", m.w, m.h);
      return m;
    }
  }
  not_format("XBM: header does not match");
}

Size xbm_header(const Bytes& b) {
  const Xbm m = xbm_head(b);
  return {m.w, m.h};
}

inline int hex_digit(uint8_t v) {
  return v >= '0' && v <= '9' ? v - '0' : v >= 'a' && v <= 'f' ? v - 'a' + 10
       : v >= 'A' && v <= 'F' ? v - 'A' + 10 : 0;
}

void xbm_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Xbm m = xbm_head(b);
  check_out("XBM", m.w, m.h, out_w, out_h);
  // Each byte is the two characters after an 'x' (any other character 0);
  // least significant bit first, a set bit white (PIL's mode 1).
  const int64_t w = m.w, stride = (w + 7) / 8;
  size_t pos = m.data;
  for (int64_t y = 0; y < m.h; ++y) {
    for (int64_t i = 0; i < stride; ++i) {
      while (pos < b.n && b.p[pos] != 'x') ++pos;
      if (b.n - pos < 3) fail("XBM: file is truncated");
      const int v = hex_digit(b.p[pos + 1]) << 4 | hex_digit(b.p[pos + 2]);
      pos += 3;
      for (int k = 0; k < 8 && 8 * i + k < w; ++k) {
        put_grey(out + 4 * (y * w + 8 * i + k), (v >> k) & 1 ? 255 : 0);
      }
    }
  }
}

// ---------------------------------------------------------------- XPM

// A line as Python's readline() gives it (the newline kept).
std::string read_line(const Bytes& b, size_t* pos) {
  const size_t a = *pos;
  const uint8_t* nl = a < b.n ? static_cast<const uint8_t*>(std::memchr(b.p + a, '\n', b.n - a)) : nullptr;
  *pos = nl ? static_cast<size_t>(nl - b.p) + 1 : b.n;
  return str(b.p + a, *pos - a);
}

std::string rstrip(const std::string& s) {
  const size_t e = s.find_last_not_of(" \t\n\r\x0b\x0c");
  return e == std::string::npos ? "" : s.substr(0, e + 1);
}

std::vector<std::string> split_ws(const std::string& s) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < s.size()) {
    while (i < s.size() && std::isspace(static_cast<unsigned char>(s[i]))) ++i;
    const size_t a = i;
    while (i < s.size() && !std::isspace(static_cast<unsigned char>(s[i]))) ++i;
    if (i > a) out.push_back(s.substr(a, i - a));
  }
  return out;
}

struct Xpm {
  int64_t w, h;
  int bpp;
  bool rgb;  // more than 256 colours: PIL's mode RGB
  std::vector<std::string> keys;
  std::vector<std::array<uint8_t, 3>> colours;
  size_t data;
};

Xpm xpm_head(const Bytes& b) {
  if (b.n < 9 || std::memcmp(b.p, "/* XPM */", 9) != 0) not_format("XPM: not an XPM file");
  size_t pos = 9;
  // The first line that starts as "([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)
  std::string line, fields[4];
  for (bool found = false; !found;) {
    line = read_line(b, &pos);
    if (line.empty()) not_format("XPM: broken file");
    size_t i = 1;
    found = line[0] == '"';
    for (int k = 0; k < 4 && found; ++k) {
      const size_t e = std::min(line.find_first_not_of("0123456789", i), line.size());
      fields[k] = line.substr(i, e - i);
      found = k == 3 || (e < line.size() && line[e] == ' ');
      i = e + 1;
    }
  }
  int64_t v[4];
  for (int i = 0; i < 4; ++i) {
    if (!py_int(fields[i], &v[i])) fail("XPM: header '" + rstrip(line) + "' not read");
  }
  Xpm m{v[0], v[1], static_cast<int>(std::min<int64_t>(v[3], 1 << 20)), v[2] > 256, {}, {}, 0};
  if (m.bpp < 0) fail("XPM: negative characters a pixel");
  for (int64_t i = 0; i < v[2]; ++i) {
    const std::string l = rstrip(read_line(b, &pos));
    const std::string c = l.substr(std::min<size_t>(1, l.size()), m.bpp);
    const size_t a = std::min<size_t>(m.bpp + 1, l.size());
    const std::vector<std::string> s =
        split_ws(l.size() >= 2 && a < l.size() - 2 ? l.substr(a, l.size() - 2 - a) : "");
    bool keyed = false;
    for (size_t j = 0; j < s.size(); j += 2) {
      if (s[j] != "c") continue;
      if (j + 1 >= s.size()) not_format("XPM: colour key without a value");
      const std::string& rgb = s[j + 1];
      if (rgb == "None") {
        // Transparent in PIL's info, but absent from its palette: a pixel of
        // it raises when the image is read.
      } else if (rgb[0] == '#') {
        uint64_t n = 0;
        if (rgb.size() < 2) fail("XPM: colour '" + rgb + "' not read");
        for (size_t k = 1; k < rgb.size(); ++k) {
          const char d = rgb[k];
          if (!std::isxdigit(static_cast<unsigned char>(d))) fail("XPM: colour '" + rgb + "' not read");
          n = n << 4 | static_cast<uint64_t>(hex_digit(static_cast<uint8_t>(d)));
        }
        const std::array<uint8_t, 3> px = {static_cast<uint8_t>(n >> 16), static_cast<uint8_t>(n >> 8),
                                           static_cast<uint8_t>(n)};
        size_t k = 0;
        while (k < m.keys.size() && m.keys[k] != c) ++k;
        if (k == m.keys.size()) {
          m.keys.push_back(c);
          m.colours.push_back(px);
        } else {
          m.colours[k] = px;
        }
      } else {
        fail("XPM: colour '" + rgb + "' not read (PIL reads only #RRGGBB colours and None)");
      }
      keyed = true;
      break;
    }
    if (!keyed) fail("XPM: a colour without a 'c' key (PIL cannot read this XPM file)");
  }
  if (m.w <= 0 || m.h <= 0) not_format("XPM: empty image");
  check_size("XPM", m.w, m.h);
  m.data = pos;
  return m;
}

Size xpm_header(const Bytes& b) {
  const Xpm m = xpm_head(b);
  return {m.w, m.h};
}

void xpm_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Xpm m = xpm_head(b);
  check_out("XPM", m.w, m.h, out_w, out_h);
  const int64_t want = m.w * m.h;
  std::vector<int> idx;
  idx.reserve(static_cast<size_t>(want));
  size_t pos = m.data;
  bool pixel_header = false;
  std::map<std::string, int> lookup;
  for (size_t k = 0; k < m.keys.size(); ++k) lookup.emplace(m.keys[k], static_cast<int>(k));
  while (static_cast<int64_t>(idx.size()) < want) {
    std::string line = read_line(b, &pos);
    if (line.empty()) break;
    if (rstrip(line) == "/* pixels */" && !pixel_header) {
      pixel_header = true;
      continue;
    }
    // Between the first and the last quote.
    const size_t q0 = line.find('"'), q1 = line.rfind('"');
    if (q0 == std::string::npos || q1 == q0) continue;
    line = line.substr(q0 + 1, q1 - q0 - 1);
    for (size_t i = 0; i < line.size(); i += std::max(m.bpp, 1)) {
      const auto it = lookup.find(line.substr(i, m.bpp));
      if (it == lookup.end()) {
        fail("XPM: pixel '" + line.substr(i, m.bpp) + "' has no colour (PIL raises for it)");
      }
      idx.push_back(it->second);
    }
    if (m.bpp == 0) fail("XPM: 0 characters a pixel");
  }
  if (static_cast<int64_t>(idx.size()) < want) fail("XPM: not enough image data");
  for (int64_t i = 0; i < want; ++i) {
    const auto& c = m.colours[idx[i]];
    put(out + 4 * i, c[0], c[1], c[2], 255);
  }
}

// ---------------------------------------------------------------- PIXAR

Size pixar_header(const Bytes& b) {
  if (b.n < 4 || std::memcmp(b.p, "\x80\xe8\0\0", 4) != 0) not_format("PIXAR: not a PIXAR file");
  if (b.n < 428) not_format("PIXAR: header is truncated");
  const Size s{le16(b.p + 418), le16(b.p + 416)};
  const uint32_t a = le16(b.p + 424), c = le16(b.p + 426);
  if (a != 14 || c != 2) {
    not_format("PIXAR: channel layout (" + std::to_string(a) + ", " + std::to_string(c) +
               ") not read (PIL reads only (14, 2), RGB)");
  }
  if (s.w <= 0 || s.h <= 0) not_format("PIXAR: empty image");
  return s;
}

void pixar_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Size s = pixar_header(b);
  check_out("PIXAR", s.w, s.h, out_w, out_h);
  const uint8_t* p = raw_rows(b, 1024, s.h, 3 * s.w, 3 * s.w);
  for (int64_t i = 0; i < s.w * s.h; ++i) put(out + 4 * i, p[3 * i], p[3 * i + 1], p[3 * i + 2], 255);
}

// ---------------------------------------------------------------- SPIDER

struct Spider {
  int64_t w, h;
  bool big;
  size_t data;
};

// SpiderImagePlugin's isSpiderHeader over 27 floats (h[1..27]): the label
// length in bytes, or 0.
int64_t spider_label(const double* h) {
  const auto is_int = [](double f) { return std::isfinite(f) && f == std::trunc(f); };
  for (int i : {1, 2, 5, 12, 13, 22, 23}) {
    if (!is_int(h[i])) return 0;
  }
  const int64_t iform = static_cast<int64_t>(h[5]);
  if (!(iform == 1 || iform == 3 || iform == -11 || iform == -12 || iform == -21 || iform == -22)) return 0;
  const int64_t labrec = static_cast<int64_t>(h[13]), labbyt = static_cast<int64_t>(h[22]),
                lenbyt = static_cast<int64_t>(h[23]);
  return labbyt == labrec * lenbyt ? labbyt : 0;
}

Spider spider_head(const Bytes& b) {
  if (b.n < 108) not_format("SPIDER: header is truncated");
  double h[28];
  int64_t label = 0;
  bool big = true;
  for (int order = 0; order < 2 && label == 0; ++order) {
    big = order == 0;
    for (int i = 0; i < 27; ++i) h[i + 1] = f32(big ? be32(b.p + 4 * i) : le32(b.p + 4 * i));
    label = spider_label(h);
  }
  if (label == 0) not_format("SPIDER: not a SPIDER file");
  if (static_cast<int64_t>(h[5]) != 1) not_format("SPIDER: not a 2D image");
  for (int i : {24, 27}) {
    if (!std::isfinite(h[i])) fail("SPIDER: header value " + std::to_string(i) + " is not a number");
  }
  const int64_t stack = static_cast<int64_t>(h[24]), number = static_cast<int64_t>(h[27]);
  Spider m{static_cast<int64_t>(h[12]), static_cast<int64_t>(h[2]), big, 0};
  if (stack == 0 && number == 0) {
    m.data = static_cast<size_t>(label);
  } else if (stack > 0 && number == 0) {
    if (!std::isfinite(h[26])) fail("SPIDER: stack size is not a number");
    m.data = static_cast<size_t>(2 * label);  // the stack's first image
  } else if (stack == 0 && number > 0) {
    fail("SPIDER: an image inside a stack, without the stack (PIL cannot open it)");
  } else {
    not_format("SPIDER: inconsistent stack header");
  }
  if (label < 0) fail("SPIDER: negative label length");
  if (m.w <= 0 || m.h <= 0) not_format("SPIDER: empty image");
  check_size("SPIDER", m.w, m.h);
  return m;
}

Size spider_header(const Bytes& b) {
  const Spider m = spider_head(b);
  return {m.w, m.h};
}

void spider_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Spider m = spider_head(b);
  check_out("SPIDER", m.w, m.h, out_w, out_h);
  const uint8_t* p = raw_rows(b, m.data, m.h, 4 * m.w, 4 * m.w);
  for (int64_t i = 0; i < m.w * m.h; ++i) {
    put_grey(out + 4 * i, f_to_u8(f32(m.big ? be32(p + 4 * i) : le32(p + 4 * i))));
  }
}

// ---------------------------------------------------------------- FITS

struct Fits {
  int64_t w, h;
  int bits;
  bool gzip;
  size_t data;
  double scale, zero;
};

int64_t fits_int(const std::map<std::string, std::string>& hd, const std::string& key) {
  const auto it = hd.find(key);
  if (it == hd.end()) not_format("FITS: no " + key);
  int64_t v;
  if (!py_int(it->second, &v)) fail("FITS: " + key + " = " + it->second + " is not an integer");
  return v;
}

// FitsImageFile._open: 80-byte cards, headers merged across HDUs until one
// gives an image size (a GZIP_1 tile-compressed BINTABLE gives its ZNAXIS).
Fits fits_head(const Bytes& b) {
  if (b.n < 6 || std::memcmp(b.p, "SIMPLE", 6) != 0) not_format("FITS: not a FITS file");
  std::map<std::string, std::string> hd;
  bool in_progress = false, found = false;
  Fits m{0, 0, 0, false, 0, 1.0, 0.0};
  int64_t offset = 0;
  size_t pos = 0;
  for (;;) {
    if (pos >= b.n) fail("FITS: file is truncated");
    const size_t len = std::min<size_t>(80, b.n - pos);
    const std::string card = str(b.p + pos, len);
    pos += len;
    const std::string keyword = strip(card.substr(0, 8));
    if (keyword == "SIMPLE" || keyword == "XTENSION") {
      in_progress = true;
    } else if (!hd.empty() && !in_progress) {
      break;
    } else if (keyword == "END") {
      pos = (pos + 2879) / 2880 * 2880;
      if (!found) {
        std::string prefix;
        const auto get = [&](const char* k) {
          const auto it = hd.find(k);
          return it == hd.end() ? std::string("\x01") : it->second;
        };
        if (get("XTENSION") == "'BINTABLE'" && get("ZIMAGE") == "T") {
          if (!hd.count("ZCMPTYPE")) not_format("FITS: no ZCMPTYPE");
        }
        if (get("XTENSION") == "'BINTABLE'" && get("ZIMAGE") == "T" &&
            get("ZCMPTYPE") == "'GZIP_1  '") {
          int64_t tw = 0, th = 0;
          const int64_t naxis = fits_int(hd, "NAXIS");
          if (naxis == 1) {
            tw = 1;
            th = fits_int(hd, "NAXIS1");
          } else if (naxis != 0) {
            tw = fits_int(hd, "NAXIS1");
            th = fits_int(hd, "NAXIS2");
          }
          const int64_t tbits = fits_int(hd, "BITPIX");
          offset = tw * th * (tbits >= 0 ? tbits / 8 : -((-tbits + 7) / 8));
          prefix = "Z";
          m.gzip = true;
        }
        const int64_t naxis = fits_int(hd, prefix + "NAXIS");
        if (naxis != 0) {
          if (naxis == 1) {
            m.w = 1;
            m.h = fits_int(hd, prefix + "NAXIS1");
          } else {
            m.w = fits_int(hd, prefix + "NAXIS1");
            m.h = fits_int(hd, prefix + "NAXIS2");
          }
          m.bits = static_cast<int>(std::max<int64_t>(-1000, std::min<int64_t>(1000,
                                    fits_int(hd, prefix + "BITPIX"))));
          found = true;
        } else {
          m.gzip = false;
          offset = 0;
        }
      }
      in_progress = false;
      continue;
    }
    if (found) continue;
    std::string value = card.size() > 8 ? card.substr(8) : "";
    value = strip(value.substr(0, value.find('/')));
    if (!value.empty() && value[0] == '=') value = strip(value.substr(1));
    if (hd.empty() && (keyword.compare(0, 6, "SIMPLE") != 0 || value != "T")) {
      not_format("FITS: not a FITS file");
    }
    hd[keyword] = value;
  }
  if (!found) fail("FITS: no image data");
  if (!(m.bits == 8 || m.bits == 16 || m.bits == 32 || m.bits == -32 || m.bits == -64)) {
    not_format("FITS: BITPIX " + std::to_string(m.bits));
  }
  if (m.w <= 0 || m.h <= 0) not_format("FITS: empty image");
  check_size("FITS", m.w, m.h);
  const int64_t at = offset + static_cast<int64_t>(pos) - 80;
  if (at < 0) fail("FITS: data before the file's start");
  m.data = static_cast<size_t>(at);
  for (const char* k : {"BSCALE", "BZERO"}) {
    const auto it = hd.find(k);
    if (it == hd.end()) continue;
    double v;
    std::string t = it->second;
    for (char& c : t) {
      if (c == 'D' || c == 'd') c = 'E';
    }
    if (!py_float(t, &v)) fail(std::string("FITS: ") + k + " = " + it->second + " not read");
    (k[1] == 'S' ? m.scale : m.zero) = v;
  }
  return m;
}

Size fits_header(const Bytes& b) {
  const Fits m = fits_head(b);
  return {m.w, m.h};
}

// CRC-32 (zlib's) of p[0, n).
uint32_t crc32(const uint8_t* p, size_t n) {
  static const auto table = [] {
    std::array<uint32_t, 256> t{};
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = c & 1 ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
    return t;
  }();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// Python's gzip.decompress: gzip members one after another, zeros between
// and after them skipped, each member's CRC and length checked.
std::vector<uint8_t> gunzip(const uint8_t* p, size_t n) {
  std::vector<uint8_t> out;
  size_t pos = 0;
  while (pos < n) {
    const auto need = [&](size_t k) {
      if (n - pos < k) fail("FITS: gzip data ends early");
    };
    need(2);
    if (p[pos] != 0x1f || p[pos + 1] != 0x8b) fail("FITS: not gzip data");
    need(10);
    if (p[pos + 2] != 8) fail("FITS: unknown gzip compression method");
    const uint8_t flags = p[pos + 3];
    pos += 10;
    if (flags & 4) {
      need(2);
      const size_t x = p[pos] | p[pos + 1] << 8;
      pos += 2;
      need(x);
      pos += x;
    }
    for (uint8_t f : {uint8_t(8), uint8_t(16)}) {
      if (!(flags & f)) continue;
      while (true) {
        need(1);
        if (p[pos++] == 0) break;
      }
    }
    if (flags & 2) {
      need(2);
      pos += 2;
    }
    const size_t start = out.size();
    pos += tracy_image::inflate(p + pos, n - pos, out, SIZE_MAX, "FITS");
    need(8);
    if (le32(p + pos) != crc32(out.data() + start, out.size() - start)) fail("FITS: gzip CRC check failed");
    if (le32(p + pos + 4) != static_cast<uint32_t>(out.size() - start)) fail("FITS: gzip length check failed");
    pos += 8;
    while (pos < n && p[pos] == 0) ++pos;
  }
  return out;
}

void fits_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Fits m = fits_head(b);
  check_out("FITS", m.w, m.h, out_w, out_h);
  const int64_t w = m.w, h = m.h, bytes = std::abs(m.bits) / 8, count = w * h;
  std::vector<uint8_t> unpacked;
  const uint8_t* p;
  int64_t step = bytes;  // bytes from one sample to the next
  if (m.gzip) {
    // FitsGzipDecoder: each sample is the last |BITPIX| / 8 bytes of a
    // 4-byte word of the inflated heap.
    if (m.bits < 0) fail("FITS: GZIP_1 image of BITPIX " + std::to_string(m.bits) + " not read (PIL reads no data)");
    b.need(m.data, 0);
    unpacked = gunzip(b.p + m.data, b.n - m.data);
    if (static_cast<int64_t>(unpacked.size()) < 4 * count) fail("FITS: not enough image data");
    p = unpacked.data() + (4 - bytes);
    step = 4;
  } else {
    p = raw_rows(b, m.data, h, w * bytes, w * bytes);
  }
  const bool plain = m.bits > 0 && m.scale == 1.0 && m.zero == std::trunc(m.zero);
  for (int64_t y = 0; y < h; ++y) {
    uint8_t* o = out + 4 * (h - 1 - y) * w;  // bottom row first
    for (int64_t x = 0; x < w; ++x, o += 4) {
      const uint8_t* s = p + (y * w + x) * step;
      if (m.bits == 8) {  // as PIL reads it, whatever BSCALE and BZERO say
        put_grey(o, s[0]);
        continue;
      }
      double v;
      switch (m.bits) {
        case 16: v = static_cast<int16_t>(be16(s)); break;
        case 32: v = static_cast<int32_t>(be32(s)); break;
        case -32: v = f32(be32(s)); break;
        default: {
          const uint64_t u = uint64_t(be32(s)) << 32 | be32(s + 4);
          std::memcpy(&v, &u, 8);
        }
      }
      if (plain) put_grey(o, i_to_u8(static_cast<int64_t>(v) + static_cast<int64_t>(m.zero)));
      else put_grey(o, f_to_u8(static_cast<float>(m.zero + m.scale * v)));
    }
  }
}

// ---------------------------------------------------------------- GBR

struct Gbr {
  int64_t w, h;
  int depth;
  size_t data;
};

Gbr gbr_head(const Bytes& b) {
  if (b.n < 8 || be32(b.p) < 20 || !(be32(b.p + 4) == 1 || be32(b.p + 4) == 2)) {
    not_format("GBR: not a GIMP brush");
  }
  if (b.n < 20) not_format("GBR: header is truncated");
  const uint32_t header = be32(b.p), version = be32(b.p + 4);
  Gbr m{be32(b.p + 8), be32(b.p + 12), static_cast<int>(std::min<uint32_t>(be32(b.p + 16), 99)), 0};
  if (m.w == 0 || m.h == 0) not_format("GBR: empty brush");
  if (m.depth != 1 && m.depth != 4) not_format("GBR: colour depth " + std::to_string(m.depth));
  if (version == 2) {
    if (b.n < 28) not_format("GBR: header is truncated");
    if (std::memcmp(b.p + 20, "GIMP", 4) != 0) not_format("GBR: bad magic number");
    if (header < 28) fail("GBR: header size " + std::to_string(header) + " shorter than the header");
  }
  check_size("GBR", m.w, m.h);
  m.data = std::min<size_t>(header, b.n);
  return m;
}

Size gbr_header(const Bytes& b) {
  const Gbr m = gbr_head(b);
  return {m.w, m.h};
}

void gbr_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Gbr m = gbr_head(b);
  check_out("GBR", m.w, m.h, out_w, out_h);
  const int64_t n = m.w * m.h;
  if (static_cast<int64_t>(b.n - m.data) < n * m.depth) fail("GBR: not enough image data");
  const uint8_t* p = b.p + m.data;
  for (int64_t i = 0; i < n; ++i) {
    if (m.depth == 1) put_grey(out + 4 * i, p[i]);
    else std::memcpy(out + 4 * i, p + 4 * i, 4);
  }
}

// ---------------------------------------------------------------- McIdas

struct McIdas {
  int64_t w, h;
  int bytes;
  int64_t offset, stride;
};

McIdas mcidas_head(const Bytes& b) {
  static const uint8_t magic[8] = {0, 0, 0, 0, 0, 0, 0, 4};
  if (b.n < 8 || std::memcmp(b.p, magic, 8) != 0) not_format("McIdas: not a McIdas area file");
  if (b.n < 256) not_format("McIdas: area directory is truncated");
  const auto word = [&](int i) { return static_cast<int64_t>(static_cast<int32_t>(be32(b.p + 4 * (i - 1)))); };
  const int64_t bytes = word(11);
  if (bytes != 1 && bytes != 2 && bytes != 4) not_format("McIdas: " + std::to_string(bytes) + " bytes a sample");
  McIdas m{word(10), word(9), static_cast<int>(bytes), word(34) + word(15),
           word(15) + word(10) * word(11) * word(14)};
  if (m.w <= 0 || m.h <= 0) not_format("McIdas: empty image");
  check_size("McIdas", m.w, m.h);
  if (m.stride < m.w * m.bytes || m.offset < 0) fail("McIdas: rows overlap or start before the file");
  return m;
}

Size mcidas_header(const Bytes& b) {
  const McIdas m = mcidas_head(b);
  return {m.w, m.h};
}

void mcidas_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const McIdas m = mcidas_head(b);
  check_out("MCIDAS", m.w, m.h, out_w, out_h);
  const uint8_t* p = raw_rows(b, static_cast<size_t>(m.offset), m.h, m.w * m.bytes, m.stride);
  for (int64_t y = 0; y < m.h; ++y) {
    const uint8_t* r = p + y * m.stride;
    for (int64_t x = 0; x < m.w; ++x) {
      const int64_t v = m.bytes == 1   ? int64_t(r[x])
                        : m.bytes == 2 ? int64_t(be16(r + 2 * x))
                                       : int64_t(static_cast<int32_t>(be32(r + 4 * x)));
      put_grey(out + 4 * (y * m.w + x), i_to_u8(v));
    }
  }
}

// ---------------------------------------------------------------- XV thumbnail

struct XvThumb {
  int64_t w, h;
  size_t data;
};

XvThumb xvthumb_head(const Bytes& b) {
  if (b.n < 6 || std::memcmp(b.p, "P7 332", 6) != 0) not_format("XV thumbnail: not an XV thumbnail");
  size_t pos = 6;
  read_line(b, &pos);  // the rest of the first line
  std::string s;
  for (;;) {
    s = read_line(b, &pos);
    if (s.empty()) not_format("XV thumbnail: no header line");
    if (s[0] != '#') break;
  }
  const std::vector<std::string> f = split_ws(s);
  XvThumb m{};
  if (f.size() < 2 || !py_int(f[0], &m.w) || !py_int(f[1], &m.h)) {
    fail("XV thumbnail: header '" + rstrip(s) + "' not read");
  }
  if (m.w <= 0 || m.h <= 0) not_format("XV thumbnail: empty image");
  check_size("XV thumbnail", m.w, m.h);
  m.data = pos;
  return m;
}

Size xvthumb_header(const Bytes& b) {
  const XvThumb m = xvthumb_head(b);
  return {m.w, m.h};
}

void xvthumb_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const XvThumb m = xvthumb_head(b);
  check_out("XVTHUMB", m.w, m.h, out_w, out_h);
  const uint8_t* p = raw_rows(b, m.data, m.h, m.w, m.w);
  for (int64_t i = 0; i < m.w * m.h; ++i) {
    const int v = p[i], r = v >> 5, g = (v >> 2) & 7, bl = v & 3;  // 3-3-2
    put(out + 4 * i, r * 255 / 7, g * 255 / 7, bl * 255 / 3, 255);
  }
}

// ---------------------------------------------------------------- IMT

struct Imt {
  int64_t w, h;
  bool has_data;
  size_t data;
};

// ImtImageFile._open: "key value" lines (* a comment) up to a 0x0c; only
// "pixel n8" gives a mode (L).
Imt imt_head(const Bytes& b) {
  size_t fp = std::min<size_t>(b.n, 100);  // what has been read
  if (std::memchr(b.p, '\n', fp) == nullptr) not_format("IM Tools: not an IM Tools file");
  size_t pos = 0;  // the start of the unread buffer
  Imt m{0, 0, false, 0};
  bool grey = false;
  for (;;) {
    if (pos >= fp) {
      if (fp >= b.n) break;
      fp = pos + 1;
    }
    const uint8_t c = b.p[pos++];
    if (c == 0x0c) {
      m.has_data = true;
      m.data = pos;
      break;
    }
    if (std::memchr(b.p + pos, '\n', fp - pos) == nullptr) fp = std::min(b.n, fp + 100);
    const uint8_t* nl = static_cast<const uint8_t*>(std::memchr(b.p + pos, '\n', fp - pos));
    const size_t stop = nl ? static_cast<size_t>(nl - b.p) : fp;
    const std::string s = str(b.p + pos - 1, stop - pos + 1);
    pos = nl ? stop + 1 : fp;
    if (s.size() == 1 || s.size() > 100) break;
    if (s[0] == '*') continue;
    // ([a-z]*) ([^ \r\n]*)
    size_t k = 0;
    while (k < s.size() && s[k] >= 'a' && s[k] <= 'z') ++k;
    if (k >= s.size() || s[k] != ' ') break;
    size_t e = k + 1;
    while (e < s.size() && s[e] != ' ' && s[e] != '\r' && s[e] != '\n') ++e;
    const std::string key = s.substr(0, k), value = s.substr(k + 1, e - k - 1);
    int64_t v;
    if (key == "width" || key == "height") {
      if (!py_int(value, &v)) fail("IM Tools: " + key + " '" + value + "' not read");
      (key == "width" ? m.w : m.h) = v;
    } else if (key == "pixel" && value == "n8") {
      grey = true;
    }
  }
  if (!grey || m.w <= 0 || m.h <= 0) not_format("IM Tools: no mode or an empty image");
  check_size("IM Tools", m.w, m.h);
  return m;
}

Size imt_header(const Bytes& b) {
  const Imt m = imt_head(b);
  return {m.w, m.h};
}

void imt_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Imt m = imt_head(b);
  check_out("IMT", m.w, m.h, out_w, out_h);
  if (!m.has_data) {  // no 0x0c: PIL has no tile to read, and the image stays black
    for (int64_t i = 0; i < m.w * m.h; ++i) put_grey(out + 4 * i, 0);
    return;
  }
  const uint8_t* p = raw_rows(b, m.data, m.h, m.w, m.w);
  for (int64_t i = 0; i < m.w * m.h; ++i) put_grey(out + 4 * i, p[i]);
}

// ---------------------------------------------------------------- IPTC

struct IptcField {
  int rec, ds;     // 0, 0 at the end of the fields
  int64_t size;
  size_t body;     // where the data starts
};

// IptcImageFile.field; `opening`: inside _open, where errors of a short
// read make Image.open try its next plugin.
IptcField iptc_field(const Bytes& b, size_t pos, bool opening) {
  const size_t n = pos < b.n ? std::min<size_t>(5, b.n - pos) : 0;
  const uint8_t* s = b.p + pos;
  bool blank = true;
  for (size_t i = 0; i < n; ++i) blank = blank && s[i] == 0;
  if (blank) return {0, 0, 0, pos + n};
  const auto bad = [&](const std::string& msg) {
    if (opening) not_format(msg);
    fail(msg);
  };
  if (n < 3) bad("IPTC: field header is truncated");
  static const int kRecords[] = {1, 2, 3, 4, 5, 6, 7, 8, 9, 240};
  if (s[0] != 0x1C || std::find(std::begin(kRecords), std::end(kRecords), s[1]) == std::end(kRecords)) {
    bad("IPTC: invalid IPTC/NAA field");
  }
  if (n < 4) bad("IPTC: field header is truncated");
  int64_t size = s[3];
  size_t body = pos + 5;
  if (size > 132) fail("IPTC: illegal field length");
  if (size == 128) {
    size = 0;
  } else if (size > 128) {
    const size_t k = static_cast<size_t>(size - 128);
    const size_t have = body <= b.n ? std::min(k, b.n - body) : 0;
    uint64_t v = 0;
    for (size_t i = have > 4 ? have - 4 : 0; i < have; ++i) v = v << 8 | b.p[body + i];
    size = static_cast<int64_t>(v & 0xFFFFFFFFu);
    body += k;
  } else {
    if (n < 5) bad("IPTC: field header is truncated");
    size = be16(s + 3);
  }
  return {s[1], s[2], size, body};
}

struct Iptc {
  int64_t w, h;
  int bands;       // 1 (L), 3 (RGB) or 4 (CMYK)
  bool whole;      // the stream is the picture (L), not one band of it
  int band;        // PIL's band index, field (3, 65) - 1: -1 is the last band
  int compression; // 1 raw, 5 JPEG
  bool has_data;
  size_t data;     // the first (8, 10) field's header
};

Iptc iptc_head(const Bytes& b) {
  struct Value {
    int count = 0;
    bool none = false;
    size_t at = 0, len = 0;
  };
  std::map<int, Value> info;
  size_t pos = 0;
  IptcField f{};
  for (;;) {
    const size_t start = pos;
    f = iptc_field(b, pos, true);
    if (f.rec == 0 || (f.rec == 8 && f.ds == 10)) {
      pos = start;
      break;
    }
    Value& v = info[f.rec << 8 | f.ds];
    v.count++;
    v.none = f.size == 0;
    v.at = std::min(f.body, b.n);
    v.len = f.size ? std::min<size_t>(static_cast<size_t>(f.size), b.n - v.at) : 0;
    pos = f.size ? f.body + static_cast<size_t>(f.size) : f.body;
  }
  const auto get = [&](int rec, int ds, const char* what) -> const Value& {
    const auto it = info.find(rec << 8 | ds);
    if (it == info.end()) not_format(std::string("IPTC: no ") + what);
    if (it->second.count > 1 || it->second.none) not_format(std::string("IPTC: bad ") + what);
    return it->second;
  };
  const auto getint = [&](int rec, int ds, const char* what) {
    const Value& v = get(rec, ds, what);
    uint64_t r = 0;
    for (size_t i = v.len > 4 ? v.len - 4 : 0; i < v.len; ++i) r = r << 8 | b.p[v.at + i];
    return static_cast<int64_t>(r);
  };
  const Value& mode = get(3, 60, "image mode");
  if (mode.len < 2) not_format("IPTC: short image mode");
  const int layers = b.p[mode.at], component = b.p[mode.at + 1];
  Iptc m{};
  if (layers == 1 && !component) {
    m.bands = 1;
    m.whole = true;
  } else {
    m.bands = layers == 3 && component ? 3 : layers == 4 && component ? 4 : 0;
    const auto it = info.find(3 << 8 | 65);
    if (it != info.end()) {
      if (it->second.count > 1 || it->second.none || it->second.len == 0) not_format("IPTC: bad band");
      m.band = b.p[it->second.at] - 1;
    } else {
      m.band = 0;
    }
  }
  m.w = getint(3, 20, "width");
  m.h = getint(3, 30, "height");
  const auto c = info.find(3 << 8 | 120);
  if (c == info.end()) fail("IPTC: unknown image compression");
  if (c->second.count > 1 || c->second.none) not_format("IPTC: bad compression");
  m.compression = static_cast<int>(getint(3, 120, "compression"));
  if (m.compression != 1 && m.compression != 5) {
    fail("IPTC: image compression " + std::to_string(m.compression) + " not read (PIL: unknown)");
  }
  m.has_data = f.rec == 8;
  m.data = pos;
  if (!m.bands || m.w <= 0 || m.h <= 0) not_format("IPTC: no mode or an empty image");
  check_size("IPTC", m.w, m.h);
  return m;
}

Size iptc_header(const Bytes& b) {
  const Iptc m = iptc_head(b);
  return {m.w, m.h};
}

// Without (8, 10) fields PIL has no tile to read: the image stays black.
void iptc_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Iptc m = iptc_head(b);
  check_out("IPTC", m.w, m.h, out_w, out_h);
  if (m.has_data) fail("IPTC: the image is an embedded stream");
  for (int64_t i = 0; i < m.w * m.h; ++i) put_grey(out + 4 * i, 0);
}

// meta: compression, bands, whether the stream is the whole image, the
// band (PIL's index), whether there is data; spans: (start, length) of each
// (8, 10) field's data, `count` of them (at most `cap`).
void iptc_stream(const Bytes& b, int64_t* meta, int64_t* spans, int64_t cap, int64_t* count) {
  const Iptc m = iptc_head(b);
  meta[0] = m.compression;
  meta[1] = m.bands;
  meta[2] = m.whole;
  meta[3] = m.band;
  meta[4] = m.has_data;
  *count = 0;
  if (!m.has_data) return;
  size_t pos = m.data;
  for (;;) {
    const IptcField f = iptc_field(b, pos, false);
    if (!(f.rec == 8 && f.ds == 10)) break;
    const size_t at = std::min(f.body, b.n);
    const size_t len = std::min<size_t>(static_cast<size_t>(f.size), b.n - at);
    if (*count >= cap) fail("IPTC: too many data fields");
    spans[2 * *count] = static_cast<int64_t>(at);
    spans[2 * *count + 1] = static_cast<int64_t>(len);
    ++*count;
    pos = f.body + static_cast<size_t>(f.size);
    if (len < static_cast<size_t>(f.size)) break;  // the file ends inside the field
  }
}

// ---------------------------------------------------------------- PCD

// Pillow's PhotoYCC -> RGB tables (its YCC unpacker, per pixel r = L[Y] +
// CR[C2], g = L[Y] + GR[C2] + GB[C1], b = L[Y] + CB[C1], clipped), recovered
// from its output by tools/make_pcd_tables.py (fixed up to two constants
// that cancel in every sum).
const int16_t kYccL[256] = {
    0, 1, 3, 4, 5, 7, 8, 10, 11, 12, 14, 15, 16, 18, 19, 20,
    22, 23, 24, 26, 27, 29, 30, 31, 33, 34, 35, 37, 38, 39, 41, 42,
    43, 45, 46, 48, 49, 50, 52, 53, 54, 56, 57, 58, 60, 61, 62, 64,
    65, 67, 68, 69, 71, 72, 73, 75, 76, 77, 79, 80, 82, 83, 84, 86,
    87, 88, 90, 91, 92, 94, 95, 96, 98, 99, 101, 102, 103, 105, 106, 107,
    109, 110, 111, 113, 114, 115, 117, 118, 120, 121, 122, 124, 125, 126, 128, 129,
    130, 132, 133, 134, 136, 137, 139, 140, 141, 143, 144, 145, 147, 148, 149, 151,
    152, 153, 155, 156, 158, 159, 160, 162, 163, 164, 166, 167, 168, 170, 171, 173,
    174, 175, 177, 178, 179, 181, 182, 183, 185, 186, 187, 189, 190, 192, 193, 194,
    196, 197, 198, 200, 201, 202, 204, 205, 206, 208, 209, 211, 212, 213, 215, 216,
    217, 219, 220, 221, 223, 224, 225, 227, 228, 230, 231, 232, 234, 235, 236, 238,
    239, 240, 242, 243, 245, 246, 247, 249, 250, 251, 253, 254, 255, 257, 258, 259,
    261, 262, 264, 265, 266, 268, 269, 270, 272, 273, 274, 276, 277, 278, 280, 281,
    283, 284, 285, 287, 288, 289, 291, 292, 293, 295, 296, 297, 299, 300, 302, 303,
    304, 306, 307, 308, 310, 311, 312, 314, 315, 317, 318, 319, 321, 322, 323, 325,
    326, 327, 329, 330, 331, 333, 334, 336, 337, 338, 340, 341, 342, 344, 345, 346};
const int16_t kYccCB[256] = {
    -345, -343, -341, -338, -336, -334, -332, -329, -327, -325, -323, -321, -318, -316, -314, -312,
    -310, -307, -305, -303, -301, -298, -296, -294, -292, -290, -287, -285, -283, -281, -278, -276,
    -274, -272, -270, -267, -265, -263, -261, -258, -256, -254, -252, -250, -247, -245, -243, -241,
    -239, -236, -234, -232, -230, -227, -225, -223, -221, -219, -216, -214, -212, -210, -207, -205,
    -203, -201, -199, -196, -194, -192, -190, -188, -185, -183, -181, -179, -176, -174, -172, -170,
    -168, -165, -163, -161, -159, -156, -154, -152, -150, -148, -145, -143, -141, -139, -137, -134,
    -132, -130, -128, -125, -123, -121, -119, -117, -114, -112, -110, -108, -105, -103, -101, -99,
    -97, -94, -92, -90, -88, -85, -83, -81, -79, -77, -74, -72, -70, -68, -66, -63,
    -61, -59, -57, -54, -52, -50, -48, -46, -43, -41, -39, -37, -34, -32, -30, -28,
    -26, -23, -21, -19, -17, -15, -12, -10, -8, -6, -3, -1, 0, 2, 4, 7,
    9, 11, 13, 16, 18, 20, 22, 24, 27, 29, 31, 33, 35, 38, 40, 42,
    44, 47, 49, 51, 53, 55, 58, 60, 62, 64, 67, 69, 71, 73, 75, 78,
    80, 82, 84, 86, 89, 91, 93, 95, 98, 100, 102, 104, 106, 109, 111, 113,
    115, 118, 120, 122, 124, 126, 129, 131, 133, 135, 138, 140, 142, 144, 146, 149,
    151, 153, 155, 157, 160, 162, 164, 166, 169, 171, 173, 175, 177, 180, 182, 184,
    186, 189, 191, 193, 195, 197, 200, 202, 204, 206, 208, 211, 213, 215, 217, 220};
const int16_t kYccGB[256] = {
    67, 67, 66, 66, 65, 65, 65, 64, 64, 63, 63, 62, 62, 62, 61, 61,
    60, 60, 59, 59, 59, 58, 58, 57, 57, 56, 56, 56, 55, 55, 54, 54,
    53, 53, 52, 52, 52, 51, 51, 50, 50, 49, 49, 49, 48, 48, 47, 47,
    46, 46, 46, 45, 45, 44, 44, 43, 43, 43, 42, 42, 41, 41, 40, 40,
    40, 39, 39, 38, 38, 37, 37, 37, 36, 36, 35, 35, 34, 34, 34, 33,
    33, 32, 32, 31, 31, 31, 30, 30, 29, 29, 28, 28, 28, 27, 27, 26,
    26, 25, 25, 25, 24, 24, 23, 23, 22, 22, 22, 21, 21, 20, 20, 19,
    19, 19, 18, 18, 17, 17, 16, 16, 15, 15, 15, 14, 14, 13, 13, 12,
    12, 12, 11, 11, 10, 10, 9, 9, 9, 8, 8, 7, 7, 6, 6, 6,
    5, 5, 4, 4, 3, 3, 3, 2, 2, 1, 1, 0, 0, 0, 0, 0,
    -1, -1, -2, -2, -2, -3, -3, -4, -4, -5, -5, -5, -6, -6, -7, -7,
    -8, -8, -8, -9, -9, -10, -10, -11, -11, -11, -12, -12, -13, -13, -14, -14,
    -14, -15, -15, -16, -16, -17, -17, -18, -18, -18, -19, -19, -20, -20, -21, -21,
    -21, -22, -22, -23, -23, -24, -24, -24, -25, -25, -26, -26, -27, -27, -27, -28,
    -28, -29, -29, -30, -30, -30, -31, -31, -32, -32, -33, -33, -33, -34, -34, -35,
    -35, -36, -36, -36, -37, -37, -38, -38, -39, -39, -39, -40, -40, -41, -41, -42};
const int16_t kYccCR[256] = {
    -249, -247, -245, -243, -241, -239, -238, -236, -234, -232, -230, -229, -227, -225, -223, -221,
    -219, -218, -216, -214, -212, -210, -208, -207, -205, -203, -201, -199, -198, -196, -194, -192,
    -190, -188, -187, -185, -183, -181, -179, -178, -176, -174, -172, -170, -168, -167, -165, -163,
    -161, -159, -157, -156, -154, -152, -150, -148, -147, -145, -143, -141, -139, -137, -136, -134,
    -132, -130, -128, -127, -125, -123, -121, -119, -117, -116, -114, -112, -110, -108, -106, -105,
    -103, -101, -99, -97, -96, -94, -92, -90, -88, -86, -85, -83, -81, -79, -77, -76,
    -74, -72, -70, -68, -66, -65, -63, -61, -59, -57, -55, -54, -52, -50, -48, -46,
    -45, -43, -41, -39, -37, -35, -34, -32, -30, -28, -26, -25, -23, -21, -19, -17,
    -15, -14, -12, -10, -8, -6, -4, -3, -1, 0, 2, 4, 5, 7, 9, 11,
    13, 15, 16, 18, 20, 22, 24, 26, 27, 29, 31, 33, 35, 36, 38, 40,
    42, 44, 46, 47, 49, 51, 53, 55, 56, 58, 60, 62, 64, 66, 67, 69,
    71, 73, 75, 77, 78, 80, 82, 84, 86, 87, 89, 91, 93, 95, 97, 98,
    100, 102, 104, 106, 107, 109, 111, 113, 115, 117, 118, 120, 122, 124, 126, 128,
    129, 131, 133, 135, 137, 138, 140, 142, 144, 146, 148, 149, 151, 153, 155, 157,
    158, 160, 162, 164, 166, 168, 169, 171, 173, 175, 177, 179, 180, 182, 184, 186,
    188, 189, 191, 193, 195, 197, 199, 200, 202, 204, 206, 208, 209, 211, 213, 215};
const int16_t kYccGR[256] = {
    127, 126, 125, 124, 123, 122, 121, 121, 120, 119, 118, 117, 116, 115, 114, 113,
    112, 111, 110, 109, 108, 108, 107, 106, 105, 104, 103, 102, 101, 100, 99, 98,
    97, 96, 95, 95, 94, 93, 92, 91, 90, 89, 88, 87, 86, 85, 84, 83,
    83, 82, 81, 80, 79, 78, 77, 76, 75, 74, 73, 72, 71, 70, 70, 69,
    68, 67, 66, 65, 64, 63, 62, 61, 60, 59, 58, 57, 57, 56, 55, 54,
    53, 52, 51, 50, 49, 48, 47, 46, 45, 45, 44, 43, 42, 41, 40, 39,
    38, 37, 36, 35, 34, 33, 32, 32, 31, 30, 29, 28, 27, 26, 25, 24,
    23, 22, 21, 20, 19, 19, 18, 17, 16, 15, 14, 13, 12, 11, 10, 9,
    8, 7, 6, 6, 5, 4, 3, 2, 1, 0, 0, -1, -2, -3, -4, -5,
    -5, -6, -7, -8, -9, -10, -11, -12, -13, -14, -15, -16, -17, -18, -18, -19,
    -20, -21, -22, -23, -24, -25, -26, -27, -28, -29, -30, -31, -31, -32, -33, -34,
    -35, -36, -37, -38, -39, -40, -41, -42, -43, -44, -44, -45, -46, -47, -48, -49,
    -50, -51, -52, -53, -54, -55, -56, -56, -57, -58, -59, -60, -61, -62, -63, -64,
    -65, -66, -67, -68, -69, -69, -70, -71, -72, -73, -74, -75, -76, -77, -78, -79,
    -80, -81, -82, -82, -83, -84, -85, -86, -87, -88, -89, -90, -91, -92, -93, -94,
    -94, -95, -96, -97, -98, -99, -100, -101, -102, -103, -104, -105, -106, -107, -107, -108};

Size pcd_header(const Bytes& b) {
  if (b.n < 2048 + 4 || std::memcmp(b.p + 2048, "PCD_", 4) != 0) not_format("PCD: not a Photo CD file");
  if (b.n < 2048 + 1539) not_format("PCD: header is truncated");
  const int orientation = b.p[2048 + 1538] & 3;
  return orientation == 1 || orientation == 3 ? Size{512, 768} : Size{768, 512};
}

void pcd_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Size s = pcd_header(b);
  check_out("PCD", s.w, s.h, out_w, out_h);
  const int orientation = b.p[2048 + 1538] & 3;
  constexpr int W = 768, H = 512;
  // The base image: each pair of rows is Y, Y, then C1 and C2 at half
  // width, one chroma sample for each 2x2 pixels.
  b.need(96 * 2048, 3 * W * H / 2);
  const uint8_t* p = b.p + 96 * 2048;
  const auto clip = [](int v) { return v <= 0 ? 0 : v >= 255 ? 255 : v; };
  for (int y = 0; y < H; ++y) {
    const uint8_t* chunk = p + (y / 2) * 3 * W;
    for (int x = 0; x < W; ++x) {
      const int l = kYccL[chunk[(y & 1) * W + x]];
      const int c1 = chunk[(x + 4 * W) / 2], c2 = chunk[(x + 5 * W) / 2];
      // PIL rotates by 90 (orientation 1) or 270 (3) degrees anticlockwise.
      int64_t ox = x, oy = y;
      if (orientation == 1) {
        ox = y;
        oy = W - 1 - x;
      } else if (orientation == 3) {
        ox = H - 1 - y;
        oy = x;
      }
      put(out + 4 * (oy * s.w + ox), clip(l + kYccCR[c2]), clip(l + kYccGR[c2] + kYccGB[c1]),
          clip(l + kYccCB[c1]), 255);
    }
  }
}

// ---------------------------------------------------------------- FLI/FLC

struct Fli {
  int64_t w, h;
  Palette pal;
};

// FliImageFile._open: the 128-byte header, and the palette of the first
// frame's first colour chunk (COLOR_256, or COLOR_64 shifted by 2), else a
// grey ramp.
Fli fli_head(const Bytes& b) {
  const uint8_t* s = b.p;
  if (b.n < 16 || !(le16(s + 4) == 0xAF11 || le16(s + 4) == 0xAF12) ||
      !(le16(s + 14) == 0 || le16(s + 14) == 3)) {
    not_format("FLI: not an FLI/FLC file");
  }
  if (b.n < 128) not_format("FLI: header is truncated");
  const auto zeros = [&](size_t a, size_t e) {
    for (size_t i = a; i < e; ++i) {
      if (s[i]) return false;
    }
    return true;
  };
  if (!zeros(20, 22) || !zeros(42, 80) || !zeros(88, 128)) not_format("FLI: not an FLI/FLC file");
  Fli m{le16(s + 8), le16(s + 10), Palette::grey()};
  if (le16(s + 6) == 0) not_format("FLI: no frame");
  // The palette (struct and index errors make Image.open try its next
  // plugin).
  const auto need = [&](size_t at, size_t k) {
    if (at > b.n || b.n - at < k) not_format("FLI: frame header is truncated");
  };
  size_t pos = 128;
  need(pos, 16);
  if (le16(b.p + pos + 4) == 0xF100) {
    pos = 128 + le32(b.p + pos);
    need(pos, 16);
  }
  if (le16(b.p + pos + 4) == 0xF1FA) {
    const int chunks = static_cast<int>(le16(b.p + pos + 6));
    size_t at = pos + 16;
    for (int c = 0; c < chunks; ++c) {
      need(at, 6);
      const uint32_t size = le32(b.p + at), type = le16(b.p + at + 4);
      if (type == 4 || type == 11) {
        const int shift = type == 11 ? 2 : 0;
        size_t q = at + 6;
        need(q, 2);
        const int packets = static_cast<int>(le16(b.p + q));
        q += 2;
        int i = 0;
        for (int e = 0; e < packets; ++e) {
          need(q, 2);
          i += b.p[q];
          const int n = b.p[q + 1] ? b.p[q + 1] : 256;
          q += 2;
          const size_t have = std::min<size_t>(3 * n, b.n - q);
          if (have % 3) not_format("FLI: colour chunk is truncated");
          for (size_t k = 0; k < have; k += 3, ++i) {
            if (i > 255) not_format("FLI: palette index beyond 255");
            m.pal.set(i, (b.p[q + k] << shift) & 255, (b.p[q + k + 1] << shift) & 255,
                      (b.p[q + k + 2] << shift) & 255);
          }
          q += have;
        }
        break;
      }
      if (!size) break;
      at += size;
    }
  }
  // The first frame's size (the frame that is decoded starts at 128).
  need(128, 4);
  if (m.w <= 0 || m.h <= 0) not_format("FLI: empty image");
  check_size("FLI", m.w, m.h);
  return m;
}

Size fli_header(const Bytes& b) {
  const Fli m = fli_head(b);
  return {m.w, m.h};
}

// FliDecode on the first frame, over an image of zeros: BLACK, BRUN, COPY
// and the deltas LC and SS2; colour and stamp chunks are skipped.
void fli_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Fli m = fli_head(b);
  check_out("FLI", m.w, m.h, out_w, out_h);
  const int64_t W = m.w, H = m.h;
  std::vector<uint8_t> img(static_cast<size_t>(W * H), 0);
  const int64_t framesize = static_cast<int32_t>(le32(b.p + 128));
  // PIL hands the decoder min(framesize, what the file holds) bytes, and
  // asks for more (and finds the file truncated) while they fall short.
  int64_t bytes = std::min<int64_t>(framesize, static_cast<int64_t>(b.n) - 128);
  if (bytes < 4 || bytes + bytes % 2 < framesize) fail("FLI: frame is truncated");
  const uint8_t* ptr = b.p + 128;
  const auto overrun = [] { fail("FLI: chunk data overruns the frame"); };
  if (bytes < 8) overrun();
  if (le16(ptr + 4) != 0xF1FA) fail("FLI: the first frame is not a frame chunk");
  const int chunks = static_cast<int>(le16(ptr + 6));
  ptr += 16;
  bytes -= 16;
  for (int c = 0; c < chunks; ++c) {
    if (bytes < 10) overrun();
    const uint8_t* data = ptr + 6;
    const auto oob = [&](int64_t k) {
      if (data + k > ptr + bytes) overrun();
    };
    switch (le16(ptr + 4)) {
      case 4:
      case 11:
      case 18:
        break;
      case 7: {  // SS2: word deltas
        const int64_t lines = le16(data);
        data += 2;
        int64_t l = 0, y = 0;
        for (; l < lines && y < H; ++l, ++y) {
          uint8_t* row = img.data() + y * W;
          oob(2);
          int64_t packets = le16(data);
          data += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {
              y += 65536 - packets;  // skip lines
              if (y >= H) overrun();
              row = img.data() + y * W;
            } else {
              row[W - 1] = static_cast<uint8_t>(packets);  // the last byte of an odd width
            }
            oob(2);
            packets = le16(data);
            data += 2;
          }
          int64_t p = 0, x = 0;
          for (; p < packets; ++p) {
            oob(2);
            x += data[0];
            if (data[1] >= 128) {
              oob(4);
              const int64_t i = 256 - data[1];
              if (x + 2 * i > W) break;
              for (int64_t j = 0; j < i; ++j) {
                row[x++] = data[2];
                row[x++] = data[3];
              }
              data += 4;
            } else {
              const int64_t i = 2 * int64_t(data[1]);
              if (x + i > W) break;
              oob(2 + i);
              std::memcpy(row + x, data + 2, static_cast<size_t>(i));
              data += 2 + i;
              x += i;
            }
          }
          if (p < packets) break;
        }
        if (l < lines) overrun();
        break;
      }
      case 12: {  // LC: byte deltas
        int64_t y = le16(data);
        const int64_t ymax = y + le16(data + 2);
        data += 4;
        for (; y < ymax && y < H; ++y) {
          uint8_t* row = img.data() + y * W;
          oob(1);
          const int64_t packets = *data++;
          int64_t p = 0, x = 0, i = 0;
          for (; p < packets; ++p, x += i) {
            oob(2);
            x += data[0];
            if (data[1] & 0x80) {
              i = 256 - data[1];
              if (x + i > W) break;
              oob(3);
              std::memset(row + x, data[2], static_cast<size_t>(i));
              data += 3;
            } else {
              i = data[1];
              if (x + i > W) break;
              oob(2 + i);
              std::memcpy(row + x, data + 2, static_cast<size_t>(i));
              data += i + 2;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) overrun();
        break;
      }
      case 13:  // BLACK
        std::fill(img.begin(), img.end(), 0);
        break;
      case 15:  // BRUN: byte runs, every line whole
        for (int64_t y = 0; y < H; ++y) {
          uint8_t* row = img.data() + y * W;
          data += 1;  // the packet count is not used
          int64_t x = 0, i = 0;
          for (; x < W; x += i) {
            oob(2);
            if (data[0] & 0x80) {
              i = 256 - data[0];
              if (x + i > W) break;
              oob(i + 1);
              std::memcpy(row + x, data + 1, static_cast<size_t>(i));
              data += i + 1;
            } else {
              i = data[0];
              if (x + i > W) break;
              std::memset(row + x, data[1], static_cast<size_t>(i));
              data += 2;
            }
          }
          if (x != W) overrun();
        }
        break;
      case 16:  // COPY
        if (data + W * H > ptr + bytes) fail("FLI: frame is truncated");
        std::memcpy(img.data(), data, static_cast<size_t>(W * H));
        break;
      default:
        fail("FLI: chunk type " + std::to_string(le16(ptr + 4)) + " not read");
    }
    const int64_t advance = static_cast<int32_t>(le32(ptr));
    if (advance == 0) fail("FLI: a chunk of size 0");
    if (advance < 0 || advance > bytes) overrun();
    ptr += advance;
    bytes -= advance;
  }
  for (int64_t i = 0; i < W * H; ++i) m.pal.put(out + 4 * i, img[i]);
}

// PIL's mode of each format's image, Image.open(...).mode, from the header
// its plugin reads (utils/image_io.py::_pil_mode asks for it when such an
// image is an IPTC image's embedded stream); IPTC's own is its header's.
std::string legacy_mode(const std::string& fmt, const Bytes& b) {
  if (fmt == "pcx" || fmt == "dcx") {
    const Pcx m = fmt == "pcx" ? pcx_head(b, 0, "PCX") : pcx_head(b, dcx_page(b), "DCX");
    switch (m.kind) {
      case PcxKind::Bits1: return "1";
      case PcxKind::Grey: return "L";
      case PcxKind::Rgb: return "RGB";
      default: return "P";
    }
  }
  if (fmt == "sgi") return std::array<const char*, 5>{"", "L", "", "RGB", "RGBA"}[sgi_head(b).bands];
  if (fmt == "sun") {
    const Sun m = sun_head(b);
    return m.depth == 1 ? "1" : m.palette ? "P" : m.depth <= 8 ? "L" : "RGB";
  }
  if (fmt == "im") return im_head(b).mode;
  if (fmt == "xpm") return xpm_head(b).rgb ? "RGB" : "P";
  if (fmt == "fits") {
    const int bits = fits_head(b).bits;
    return bits == 8 ? "L" : bits == 16 ? "I;16" : bits == 32 ? "I" : "F";
  }
  if (fmt == "gbr") return gbr_head(b).depth == 1 ? "L" : "RGBA";
  if (fmt == "mcidas") {
    const int bytes = mcidas_head(b).bytes;
    return bytes == 1 ? "L" : bytes == 2 ? "I;16B" : "I";
  }
  if (fmt == "iptc") return std::array<const char*, 5>{"", "L", "", "RGB", "CMYK"}[iptc_head(b).bands];
  // One mode a format: the header only checked.
  static const std::map<std::string, std::pair<Size (*)(const Bytes&), const char*>> fixed = {
      {"msp", {msp_header, "1"}},      {"xbm", {xbm_header, "1"}},
      {"pixar", {pixar_header, "RGB"}}, {"pcd", {pcd_header, "RGB"}},
      {"spider", {spider_header, "F"}}, {"xvthumb", {xvthumb_header, "P"}},
      {"fli", {fli_header, "P"}},      {"imt", {imt_header, "L"}}};
  const auto it = fixed.find(fmt);
  if (it == fixed.end()) throw std::invalid_argument("no legacy format " + fmt);
  it->second.first(b);
  return it->second.second;
}

}  // namespace

extern "C" {

#define TRACY_LEGACY(fmt, NAME)                                                      \
  int tracy_##fmt##_info(const uint8_t* data, int64_t len, int* w, int* h) {         \
    return info(NAME, data, len, w, h, fmt##_header);                                \
  }                                                                                  \
  int tracy_##fmt##_decode(const uint8_t* data, int64_t len, uint8_t* out, int w, int h) { \
    return guarded(NAME, [&] { fmt##_decode({data, static_cast<size_t>(len), NAME}, out, w, h); }); \
  }

// Width and height of each format's image (3: not a file of the format, as
// PIL's plugin decides it), then its RGBA8.
TRACY_LEGACY(pcx, "PCX")
TRACY_LEGACY(dcx, "DCX")
TRACY_LEGACY(sgi, "SGI")
TRACY_LEGACY(sun, "SUN")
TRACY_LEGACY(msp, "MSP")
TRACY_LEGACY(im, "IM")
TRACY_LEGACY(xbm, "XBM")
TRACY_LEGACY(xpm, "XPM")
TRACY_LEGACY(pixar, "PIXAR")
TRACY_LEGACY(spider, "SPIDER")
TRACY_LEGACY(fits, "FITS")
TRACY_LEGACY(gbr, "GBR")
TRACY_LEGACY(mcidas, "MCIDAS")
TRACY_LEGACY(xvthumb, "XVTHUMB")
TRACY_LEGACY(imt, "IMT")
TRACY_LEGACY(iptc, "IPTC")
TRACY_LEGACY(pcd, "PCD")
TRACY_LEGACY(fli, "FLI")

// The IPTC image's embedded stream: meta[0..4] = (compression: 1 raw, 5
// JPEG; bands: 1, 3 or 4; 1 where the stream is the whole image; else the
// band it fills, as PIL indexes it (a field of 0 gives -1, the last band);
// whether there is image data), and spans[2k], spans[2k + 1] the
// start and length of the k-th (8, 10) field's data, *count of them.
int tracy_iptc_stream(const uint8_t* data, int64_t len, int64_t* meta, int64_t* spans,
                      int64_t cap, int64_t* count) {
  return guarded("IPTC", [&] { iptc_stream({data, static_cast<size_t>(len), "IPTC"}, meta, spans, cap, count); });
}

// PIL's mode of a file of one of the formats above (`fmt` its name in
// lower case, as utils/native.py::LEGACY_FORMATS has it), written into
// mode[0, cap).
int tracy_legacy_mode(const char* fmt, const uint8_t* data, int64_t len, char* mode, int cap) {
  std::string name(fmt);
  for (char& c : name) c = static_cast<char>(std::toupper(static_cast<unsigned char>(c)));
  return guarded(name.c_str(), [&] {
    const std::string m = legacy_mode(fmt, {data, static_cast<size_t>(len), name.c_str()});
    std::snprintf(mode, static_cast<size_t>(cap), "%s", m.c_str());
  });
}

}  // extern "C"
