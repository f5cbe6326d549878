// ICO, CUR, DIB, FTEX, BLP and ICNS decoding on the host: the icon and
// game-texture containers that PIL (tracy_tpu's loader) opens, over pixels
// the other sources already read. Built into the same library as
// image_decode.cpp (utils/native.py::get_image_lib), with its conventions:
// `tracy_<fmt>_info` (width and height) and `tracy_<fmt>_decode` (RGBA8
// [h, w, 4]) return 0, 1 for a fault of the file, or 2 for a failure inside
// the decoder, with the message in tracy_decode_error(). Where the entry a
// container opens is a PNG or JPEG stream, `tracy_<fmt>_stream` says where
// it lies, and utils/image_io.py hands it to the PNG or JPEG decoder. The
// output equals PIL's open(...).convert("RGBA") but where ROADMAP's hazards
// say otherwise:
//
// DIB: a BMP without its file header (image_formats.cpp's BMP reader, the
//   pixels right after the header, masks and palette).
// ICO: the entry IcoImageFile opens (the largest area; among those the
//   least colour depth; then file order). A PNG entry is a stream; a BMP
//   entry is a DIB of twice its height, its alpha the 32-bit pixels' fourth
//   byte (when the directory says 32 bits) or else the 1-bit AND mask that
//   ends the entry.
// CUR: the first entry, or a later one larger on both sides; a DIB of twice
//   its height, no AND mask; 32-bit pixels keep their alpha only when the
//   bitmap starts at byte 22 (PIL's rule).
// FTEX: one format, 0 (BC1, as DDS reads it) or 1 (raw RGB).
// BLP: BLP1's JPEG kind (a stream: the shared header and mip 0), BLP1
//   palette (encodings 4 and 5) and BLP2 palette, the palette's fourth byte
//   the alpha when the header has any; BLP2 DXT1, DXT3 and DXT5 as PIL's
//   own Python decoders compute them (565 endpoints by shifts, not bit
//   replication), read by the format where PIL's rows go astray (a width
//   that is not a multiple of 4, DXT3/DXT5 without alpha).
// ICNS: the best size's entries: PNG (a stream to the file's end) or JPEG
//   2000 (a stream of the entry's length, a raw codestream or a JP2 file,
//   for image_jpeg2000.cpp), either at a size PIL's IcnsImageFile takes for
//   the icon (one of its sizes, or a whole fraction of one); or the RLE (or
//   raw) RGB of is32, il32, ih32 and it32 with its s8mk, l8mk, h8mk or t8mk
//   alpha.
//
// Refused by name, as PIL refuses them: FTEX formats other than 0 and 1,
// FTEX with several formats, BLP1 encodings other than 4 and 5, BLP2
// encodings other than 1 and 2 (raw BGRA among them), unknown BLP
// compressions and DXT alpha encodings.

#include <cmath>
#include <tuple>

#include "image_common.h"

namespace {

struct Size {
  int64_t w, h;
};

// ---------------------------------------------------------------- DIB

Size dib_header(const Bytes& b) {
  const tracy_image::DibSize s = tracy_image::dib_size(b.p, b.n, 0);
  return {s.w, s.h};
}

void dib_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Size s = dib_header(b);
  check_out("DIB", s.w, s.h, out_w, out_h);
  tracy_image::dib_decode(b.p, b.n, 0, s.h, false, out);
}

// ---------------------------------------------------------------- ICO

struct IcoEntry {
  int64_t w, h;  // the directory's (0 is 256)
  int bpp;
  uint32_t size, offset;
  int depth;
};

// IcoFile's colour depth: bpp, else ceil(log2(colours)) when that is not 0,
// else 256 (Python's math.log(n, 2), the same doubles).
int ico_depth(int bpp, int colours) {
  if (bpp) return bpp;
  if (colours) {
    const int d = static_cast<int>(std::ceil(std::log(double(colours)) / std::log(2.0)));
    if (d) return d;
  }
  return 256;
}

// The entry IcoImageFile opens: IcoFile sorts by colour depth, then by area
// (largest first), both stable, and opens the first.
IcoEntry ico_entry(const Bytes& b) {
  b.need(0, 6);
  if (b.le32(0) != 0x10000) fail("ICO: not an ICO file");
  const int n = static_cast<int>(b.le16(4));
  if (n == 0) fail("ICO: no images");
  IcoEntry best{};
  for (int i = 0; i < n; ++i) {
    const size_t at = 6 + 16 * static_cast<size_t>(i);
    b.need(at, 16);
    IcoEntry e{};
    e.w = b.u8(at) ? b.u8(at) : 256;
    e.h = b.u8(at + 1) ? b.u8(at + 1) : 256;
    e.bpp = static_cast<int>(b.le16(at + 6));
    e.size = b.le32(at + 8);
    e.offset = b.le32(at + 12);
    e.depth = ico_depth(e.bpp, b.u8(at + 2));
    const int64_t area = e.w * e.h, best_area = best.w * best.h;
    if (i == 0 || area > best_area || (area == best_area && e.depth < best.depth)) best = e;
  }
  return best;
}

const uint8_t PNG_MAGIC[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

bool is_png(const Bytes& b, size_t at) {
  return at <= b.n && b.n - at >= 8 && std::memcmp(b.p + at, PNG_MAGIC, 8) == 0;
}

// A BMP entry: the DIB's width and half its height.
Size ico_bmp_size(const Bytes& b, const IcoEntry& e) {
  const tracy_image::DibSize s = tracy_image::dib_size(b.p, b.n, e.offset);
  if (s.h / 2 <= 0) fail("ICO: bitmap of " + std::to_string(s.h) + " rows");
  return {s.w, s.h / 2};
}

Size ico_header(const Bytes& b) {
  const IcoEntry e = ico_entry(b);
  if (is_png(b, e.offset)) fail("ICO: a PNG entry is read as a stream");
  return ico_bmp_size(b, e);
}

void ico_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const IcoEntry e = ico_entry(b);
  const Size s = ico_bmp_size(b, e);
  check_out("ICO", s.w, s.h, out_w, out_h);
  const size_t o = tracy_image::dib_decode(b.p, b.n, e.offset, s.h, false, out);
  const int64_t w = s.w, h = s.h;
  if (e.bpp == 32) {
    // Every fourth byte of the pixel data, rows bottom-up whatever the
    // header says (PIL's "L" mask with orientation -1).
    b.need(o, static_cast<size_t>(w * h * 4));
    for (int64_t y = 0; y < h; ++y) {
      const uint8_t* a = b.p + o + 4 * w * (h - 1 - y) + 3;
      for (int64_t x = 0; x < w; ++x) out[4 * (y * w + x) + 3] = a[4 * x];
    }
    return;
  }
  // The AND mask: 1 bit a pixel, rows padded to 32 bits, bottom-up, at the
  // entry's end by the directory's size; a set bit is transparent.
  const int64_t stride = (w + 31) / 32 * 4;
  const int64_t at = int64_t(e.offset) + e.size - stride * h;
  if (at < 0) fail("ICO: the AND mask starts before the file");
  b.need(static_cast<size_t>(at), static_cast<size_t>(stride * h));
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* m = b.p + at + stride * (h - 1 - y);
    for (int64_t x = 0; x < w; ++x) {
      out[4 * (y * w + x) + 3] = (m[x >> 3] >> (7 - (x & 7))) & 1 ? 0 : 255;
    }
  }
}

// ---------------------------------------------------------------- CUR

// CurImageFile: the first entry, replaced by each later one that is larger
// on both sides (the directory's bytes, 0 not read as 256); its bitmap at
// the entry's offset (0: right after the directory, where the file stands).
size_t cur_bitmap(const Bytes& b) {
  b.need(0, 6);
  if (b.le32(0) != 0x20000) fail("CUR: not a CUR file");
  const int n = static_cast<int>(b.le16(4));
  if (n == 0) fail("CUR: no cursors");
  size_t best = 6;
  for (int i = 0; i < n; ++i) {
    const size_t at = 6 + 16 * static_cast<size_t>(i);
    b.need(at, 16);
    if (i > 0 && b.u8(at) > b.u8(best) && b.u8(at + 1) > b.u8(best + 1)) best = at;
  }
  const uint32_t offset = b.le32(best + 12);
  return offset ? offset : 6 + 16 * static_cast<size_t>(n);
}

Size cur_header(const Bytes& b) {
  const tracy_image::DibSize s = tracy_image::dib_size(b.p, b.n, cur_bitmap(b));
  if (s.h / 2 <= 0) fail("CUR: bitmap of " + std::to_string(s.h) + " rows");
  return {s.w, s.h / 2};
}

void cur_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Size s = cur_header(b);
  check_out("CUR", s.w, s.h, out_w, out_h);
  const size_t at = cur_bitmap(b);
  tracy_image::dib_decode(b.p, b.n, at, s.h, at == 22, out);
}

// ---------------------------------------------------------------- FTEX

struct Ftex {
  int64_t w, h;
  int format;
  size_t data_at, data_len;
};

int32_t i32(const Bytes& b, size_t at) { return static_cast<int32_t>(b.le32(at)); }

Ftex ftex_header(const Bytes& b) {
  b.need(0, 32);
  if (std::memcmp(b.p, "FTEX", 4) != 0) fail("FTEX: not an FTEX file");
  Ftex f{};
  f.w = i32(b, 8);
  f.h = i32(b, 12);
  const int32_t formats = i32(b, 20);
  if (formats != 1) fail("FTEX: " + std::to_string(formats) + " formats are not read");
  f.format = i32(b, 24);
  const int32_t where = i32(b, 28);
  if (where < 0) fail("FTEX: bad mipmap offset");
  const int32_t size = i32(b, static_cast<size_t>(where));
  f.data_at = static_cast<size_t>(where) + 4;
  const size_t left = b.n - std::min(b.n, f.data_at);
  f.data_len = size < 0 ? left : std::min(left, static_cast<size_t>(size));  // read(n)
  check_size("FTEX", f.w, f.h);
  if (f.format != 0 && f.format != 1) {
    fail("FTEX: texture compression format " + std::to_string(f.format) + " is not read");
  }
  return f;
}

void ftex_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Ftex f = ftex_header(b);
  check_out("FTEX", f.w, f.h, out_w, out_h);
  const size_t need = f.format == 0 ? static_cast<size_t>((f.w + 3) / 4 * ((f.h + 3) / 4) * 8)
                                    : static_cast<size_t>(f.w * f.h * 3);
  if (f.data_len < need) fail("FTEX: file is truncated");
  const uint8_t* p = b.p + f.data_at;
  if (f.format == 0) {
    tracy_image::bc1_decode(p, f.w, f.h, out);
    return;
  }
  for (int64_t i = 0; i < f.w * f.h; ++i) {
    put(out + 4 * i, p[3 * i], p[3 * i + 1], p[3 * i + 2], 255);
  }
}

// ---------------------------------------------------------------- BLP

struct Blp {
  bool v2;
  int compression, encoding, alpha_encoding;
  bool alpha;
  int64_t w, h;
  uint32_t offset0, length0;
};

Blp blp_header(const Bytes& b) {
  b.need(0, 4);
  Blp m{};
  if (std::memcmp(b.p, "BLP1", 4) == 0) {
    m.v2 = false;
  } else if (std::memcmp(b.p, "BLP2", 4) == 0) {
    m.v2 = true;
  } else {
    fail("BLP: not a BLP file");
  }
  b.need(0, m.v2 ? 20 : 28);
  m.compression = i32(b, 4);
  if (m.v2) {
    m.encoding = static_cast<int8_t>(b.u8(8));
    m.alpha = b.u8(9) != 0;
    m.alpha_encoding = static_cast<int8_t>(b.u8(10));
  } else {
    m.alpha = b.le32(8) != 0;
    m.encoding = i32(b, 20);
  }
  m.w = b.le32(12);
  m.h = b.le32(16);
  check_size("BLP", m.w, m.h);
  const size_t table = m.v2 ? 20 : 28;  // 16 mip offsets, then 16 lengths
  m.offset0 = b.le32(table);
  m.length0 = b.le32(table + 64);
  const std::string kind = m.v2 ? "BLP2" : "BLP1";
  if (m.v2 ? m.compression != 1 : m.compression != 0 && m.compression != 1) {
    fail("BLP: " + kind + " compression " + std::to_string(m.compression) + " is not read");
  }
  if (m.v2 && m.encoding != 1 && m.encoding != 2) {
    fail("BLP: BLP2 encoding " + std::to_string(m.encoding) +
         (m.encoding == 3 ? " (raw BGRA)" : "") + " is not read");
  }
  if (!m.v2 && m.compression == 1 && m.encoding != 4 && m.encoding != 5) {
    fail("BLP: BLP1 encoding " + std::to_string(m.encoding) + " is not read");
  }
  if (m.v2 && m.encoding == 2 && m.alpha_encoding != 0 && m.alpha_encoding != 1 &&
      m.alpha_encoding != 7) {
    fail("BLP: DXT alpha encoding " + std::to_string(m.alpha_encoding) + " is not read");
  }
  return m;
}

bool blp_jpeg(const Blp& m) { return !m.v2 && m.compression == 0; }

// PIL's Python DXT decoders (BlpImagePlugin.decode_dxt1/3/5): endpoints
// widened by shifts, thirds and halves by floor division.
struct Rgb {
  int r, g, b;
};

Rgb unpack_565(uint32_t c) {
  return {int((c >> 11) & 0x1F) << 3, int((c >> 5) & 0x3F) << 2, int(c & 0x1F) << 3};
}

// The colour of code k (0-3) between c0 and c1; `four`: always the
// four-colour table (DXT3 and DXT5), else DXT1's choice by c0 > c1; a
// transparent black leaves *a at 0.
Rgb dxt_colour(uint32_t c0, uint32_t c1, int k, bool four, int* a) {
  const Rgb p = unpack_565(c0), q = unpack_565(c1);
  switch (k) {
    case 0: return p;
    case 1: return q;
    case 2:
      if (four || c0 > c1) return {(2 * p.r + q.r) / 3, (2 * p.g + q.g) / 3, (2 * p.b + q.b) / 3};
      return {(p.r + q.r) / 2, (p.g + q.g) / 2, (p.b + q.b) / 2};
    default:
      if (four || c0 > c1) return {(2 * q.r + p.r) / 3, (2 * q.g + p.g) / 3, (2 * q.b + p.b) / 3};
      *a = 0;
      return {0, 0, 0};
  }
}

int dxt5_alpha(int a0, int a1, int code) {
  if (code == 0) return a0;
  if (code == 1) return a1;
  if (a0 > a1) return ((8 - code) * a0 + (code - 1) * a1) / 7;
  if (code == 6) return 0;
  if (code == 7) return 255;
  return ((6 - code) * a0 + (code - 1) * a1) / 5;
}

void blp_dxt(const Bytes& b, const Blp& m, uint8_t* out) {
  const int bytes = m.alpha_encoding == 0 ? 8 : 16;
  const int64_t bw = (m.w + 3) / 4, bh = (m.h + 3) / 4;
  b.need(m.offset0, static_cast<size_t>(bw * bh * bytes));
  const uint8_t* p = b.p + m.offset0;
  for (int64_t by = 0; by < bh; ++by) {
    for (int64_t bx = 0; bx < bw; ++bx, p += bytes) {
      const uint8_t* c = m.alpha_encoding == 0 ? p : p + 8;
      const uint32_t c0 = c[0] | c[1] << 8, c1 = c[2] | c[3] << 8;
      const uint32_t code = c[4] | c[5] << 8 | c[6] << 16 | uint32_t(c[7]) << 24;
      uint64_t alpha_bits = 0;
      for (int k = 0; k < 6; ++k) alpha_bits |= uint64_t(p[2 + k]) << (8 * k);
      for (int j = 0; j < 4; ++j) {
        for (int i = 0; i < 4; ++i) {
          const int n = 4 * j + i;
          const int64_t x = 4 * bx + i, y = 4 * by + j;
          int a = 255;
          const Rgb rgb = dxt_colour(c0, c1, (code >> (2 * n)) & 3, m.alpha_encoding != 0, &a);
          if (m.alpha_encoding == 1) {
            a = ((p[n / 2] >> (4 * (n & 1))) & 15) * 17;
          } else if (m.alpha_encoding == 7) {
            a = dxt5_alpha(p[0], p[1], static_cast<int>((alpha_bits >> (3 * n)) & 7));
          }
          if (x >= m.w || y >= m.h) continue;
          // Without alpha the header's RGB mode drops it (DXT1's
          // transparent black stays black).
          put(out + 4 * (y * m.w + x), rgb.r, rgb.g, rgb.b, m.alpha ? a : 255);
        }
      }
    }
  }
}

void blp_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Blp m = blp_header(b);
  check_out("BLP", m.w, m.h, out_w, out_h);
  if (blp_jpeg(m)) fail("BLP: the JPEG kind is read as a stream");
  // The 256-entry BGRA palette after the mip tables (BLP2 reads it for
  // every encoding).
  const size_t pal = m.v2 ? 148 : 156;
  b.need(pal, 1024);
  if (m.v2 && m.encoding == 2) {
    blp_dxt(b, m, out);
    return;
  }
  // Indices: BLP1's right after the palette, BLP2's at mip 0's offset;
  // mip 0's length of them are read, the first w x h used.
  const size_t at = m.v2 ? m.offset0 : pal + 1024;
  b.need(at, m.length0);
  const int64_t n = m.w * m.h;
  if (m.length0 < n) fail("BLP: not enough image data");
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* e = b.p + pal + 4 * b.p[at + i];
    put(out + 4 * i, e[2], e[1], e[0], m.alpha ? e[3] : 255);
  }
}

// BLP1's JPEG kind: the shared header (its u32 size at 156, then the
// bytes), then mip 0, read where the header ends when its offset lies
// before that (PIL reads forward only).
void blp_stream(const Bytes& b, int64_t* parts) {
  const Blp m = blp_header(b);
  if (!blp_jpeg(m)) return;
  const size_t head = b.le32(156);
  b.need(160, head);
  const size_t mip = std::max<size_t>(m.offset0, 160 + head);
  b.need(mip, m.length0);
  parts[0] = 160;
  parts[1] = static_cast<int64_t>(head);
  parts[2] = static_cast<int64_t>(mip);
  parts[3] = m.length0;
}

// ---------------------------------------------------------------- ICNS

enum IcnsReader { kPng, kRgb, kRgbT, kMask };

struct IcnsCode {
  const char* sig;
  IcnsReader reader;
};

// IcnsFile.SIZES: (w, h, scale) and its entries, in PIL's order.
struct IcnsSize {
  int w, h, scale;
  IcnsCode codes[3];
  int n;
};

const IcnsSize kIcnsSizes[] = {
    {512, 512, 2, {{"ic10", kPng}}, 1},
    {512, 512, 1, {{"ic09", kPng}}, 1},
    {256, 256, 2, {{"ic14", kPng}}, 1},
    {256, 256, 1, {{"ic08", kPng}}, 1},
    {128, 128, 2, {{"ic13", kPng}}, 1},
    {128, 128, 1, {{"ic07", kPng}, {"it32", kRgbT}, {"t8mk", kMask}}, 3},
    {64, 64, 1, {{"icp6", kPng}}, 1},
    {32, 32, 2, {{"ic12", kPng}}, 1},
    {48, 48, 1, {{"ih32", kRgb}, {"h8mk", kMask}}, 2},
    {32, 32, 1, {{"icp5", kPng}, {"il32", kRgb}, {"l8mk", kMask}}, 3},
    {16, 16, 2, {{"ic11", kPng}}, 1},
    {16, 16, 1, {{"icp4", kPng}, {"is32", kRgb}, {"s8mk", kMask}}, 3},
};

struct IcnsBlock {
  bool found;
  size_t start, length;
};

struct Icns {
  const IcnsSize* size;
  IcnsBlock blocks[3];  // of size->codes
};

// IcnsFile: the blocks (the last of a signature wins), then bestsize, the
// largest (w, h, scale) any of whose entries is present; `present` lists
// every size with an entry (PIL's info["sizes"]).
Icns icns_scan(const Bytes& b, std::vector<const IcnsSize*>* present = nullptr) {
  b.need(0, 8);
  if (std::memcmp(b.p, "icns", 4) != 0) fail("ICNS: not an ICNS file");
  const uint64_t filesize = b.be32(4);
  struct Seen {
    char sig[4];
    size_t start, length;
  };
  std::vector<Seen> seen;
  for (uint64_t i = 8; i < filesize;) {
    b.need(i, 8);
    const uint32_t size = b.be32(i + 4);
    if (size == 0) fail("ICNS: invalid block header");
    Seen s;
    std::memcpy(s.sig, b.p + i, 4);
    s.start = static_cast<size_t>(i + 8);
    s.length = size >= 8 ? size - 8 : 0;
    seen.push_back(s);
    i += size;
  }
  Icns best{};
  for (const IcnsSize& z : kIcnsSizes) {
    Icns c{&z, {}};
    bool any = false;
    for (int k = 0; k < z.n; ++k) {
      for (const Seen& s : seen) {
        if (std::memcmp(s.sig, z.codes[k].sig, 4) == 0) c.blocks[k] = {true, s.start, s.length};
      }
      any = any || c.blocks[k].found;
    }
    if (!any) continue;
    if (present) present->push_back(&z);
    const IcnsSize* t = best.size;
    if (!t || std::make_tuple(z.w, z.h, z.scale) > std::make_tuple(t->w, t->h, t->scale)) best = c;
  }
  if (!best.size) fail("ICNS: no 32-bit icon resources found");
  return best;
}

// read_32: raw RGB when the block holds exactly w x h x 3 bytes, else three
// channels of PackBits-like runs read on from the block's start (a byte
// below 128: that many plus one literal bytes; else byte - 125 copies of
// the next), each of exactly w x h samples.
void icns_rgb(const Bytes& b, size_t start, size_t length, int64_t n, uint8_t* out) {
  if (length == static_cast<size_t>(n * 3)) {
    b.need(start, length);
    for (int64_t i = 0; i < n; ++i) {
      for (int c = 0; c < 3; ++c) out[4 * i + c] = b.p[start + 3 * i + c];
    }
    return;
  }
  size_t pos = start;
  for (int c = 0; c < 3; ++c) {
    int64_t got = 0;
    while (got < n) {
      const int head = b.u8(pos++);
      const int64_t count = head & 0x80 ? head - 125 : head + 1;
      if (got + count > n) fail("ICNS: a channel's runs overrun it");
      if (head & 0x80) {
        const uint8_t v = b.u8(pos++);
        for (int64_t k = 0; k < count; ++k) out[4 * (got + k) + c] = v;
      } else {
        b.need(pos, static_cast<size_t>(count));
        for (int64_t k = 0; k < count; ++k) out[4 * (got + k) + c] = b.p[pos + k];
        pos += count;
      }
      got += count;
    }
  }
}

// Whether PIL's IcnsImageFile takes an embedded image of w x h for the icon
// (its size setter, run when load() sets the entry's size): one of the
// present sizes is a whole multiple of it on both sides.
bool icns_size_ok(const std::vector<const IcnsSize*>& present, int64_t w, int64_t h) {
  if (w <= 0 || h <= 0) return false;
  for (const IcnsSize* z : present) {
    const int64_t sw = int64_t(z->w) * z->scale, sh = int64_t(z->h) * z->scale;
    if (sh == (sw / w) * h) return true;
  }
  return false;
}

struct IcnsStream {
  size_t start = 0, length = 0;  // 0, 0: the pixels are the container's own
};

bool is_jpeg2000(const uint8_t* s) {
  return std::memcmp(s, "\xff\x4f\xff\x51", 4) == 0 ||
         std::memcmp(s, "\x0d\x0a\x87\x0a", 4) == 0 ||
         std::memcmp(s, "\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a", 12) == 0;
}

// Every entry of the best size read in PIL's order (so that a bad one fails
// as in PIL). Returns the PNG or JPEG 2000 entry, which PIL returns in place
// of the rest, else none with the RGB (and the mask's alpha, else 255) in out.
IcnsStream icns_read(const Bytes& b, const Icns& m, const std::vector<const IcnsSize*>& present,
                     uint8_t* out) {
  const int64_t w = int64_t(m.size->w) * m.size->scale, h = int64_t(m.size->h) * m.size->scale;
  const int64_t n = w * h;
  IcnsStream stream;
  bool mask = false;
  for (int k = 0; k < m.size->n; ++k) {
    const IcnsBlock& blk = m.blocks[k];
    if (!blk.found) continue;
    const char* sig = m.size->codes[k].sig;
    switch (m.size->codes[k].reader) {
      case kPng: {
        b.need(blk.start, 12);
        const uint8_t* s = b.p + blk.start;
        int64_t ew, eh;
        if (is_png(b, blk.start)) {
          stream = {blk.start, b.n - blk.start};
          ew = b.be32(blk.start + 16);
          eh = b.be32(blk.start + 20);
        } else if (is_jpeg2000(s)) {
          b.need(blk.start, blk.length);
          stream = {blk.start, blk.length};
          tracy_image::jpeg2000_size(s, blk.length, &ew, &eh);
        } else {
          fail(std::string("ICNS: entry '") + sig + "' is neither PNG nor JPEG 2000");
        }
        if (!icns_size_ok(present, ew, eh)) {
          fail("ICNS: entry '" + std::string(sig) + "' of " + std::to_string(ew) + "x" +
               std::to_string(eh) + " is not one of the allowed sizes of this image");
        }
        break;
      }
      case kRgbT:
        if (b.be32(blk.start) != 0) fail("ICNS: it32 without its zero signature");
        icns_rgb(b, blk.start + 4, blk.length - std::min<size_t>(4, blk.length), n, out);
        break;
      case kRgb:
        icns_rgb(b, blk.start, blk.length, n, out);
        break;
      case kMask:
        b.need(blk.start, static_cast<size_t>(n));
        for (int64_t i = 0; i < n; ++i) out[4 * i + 3] = b.p[blk.start + i];
        mask = true;
        break;
    }
  }
  if (!stream.length && !mask) {
    for (int64_t i = 0; i < n; ++i) out[4 * i + 3] = 255;
  }
  return stream;
}

Size icns_header(const Bytes& b) {
  const Icns m = icns_scan(b);
  return {int64_t(m.size->w) * m.size->scale, int64_t(m.size->h) * m.size->scale};
}

void icns_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  std::vector<const IcnsSize*> present;
  const Icns m = icns_scan(b, &present);
  const Size s = icns_header(b);
  check_out("ICNS", s.w, s.h, out_w, out_h);
  if (icns_read(b, m, present, out).length) fail("ICNS: a PNG or JPEG 2000 entry is read as a stream");
}

void icns_stream(const Bytes& b, int64_t* parts) {
  std::vector<const IcnsSize*> present;
  const Icns m = icns_scan(b, &present);
  const Size s = icns_header(b);
  std::vector<uint8_t> scratch(static_cast<size_t>(4 * s.w * s.h));
  const IcnsStream stream = icns_read(b, m, present, scratch.data());
  if (stream.length) {
    parts[0] = static_cast<int64_t>(stream.start);
    parts[1] = static_cast<int64_t>(stream.length);
  }
}

void ico_stream(const Bytes& b, int64_t* parts) {
  const IcoEntry e = ico_entry(b);
  if (is_png(b, e.offset)) {
    parts[0] = e.offset;
    parts[1] = static_cast<int64_t>(b.n - e.offset);
  }
}

template <class F>
int stream(const char* fmt, const uint8_t* data, int64_t len, int64_t* parts, F&& f) {
  return guarded(fmt, [&] {
    for (int k = 0; k < 4; ++k) parts[k] = 0;
    f(Bytes{data, static_cast<size_t>(len), fmt}, parts);
  });
}

}  // namespace

extern "C" {

#define TRACY_CONTAINER(fmt, NAME)                                                   \
  int tracy_##fmt##_info(const uint8_t* data, int64_t len, int* w, int* h) {         \
    return info(NAME, data, len, w, h, fmt##_header);                                \
  }                                                                                  \
  int tracy_##fmt##_decode(const uint8_t* data, int64_t len, uint8_t* out, int w, int h) { \
    return guarded(NAME, [&] { fmt##_decode({data, static_cast<size_t>(len), NAME}, out, w, h); }); \
  }

// Width and height of the image each container opens, then its RGBA8.
TRACY_CONTAINER(dib, "DIB")
TRACY_CONTAINER(ico, "ICO")
TRACY_CONTAINER(cur, "CUR")
TRACY_CONTAINER(ftex, "FTEX")
TRACY_CONTAINER(icns, "ICNS")
TRACY_CONTAINER(blp, "BLP")

// Where the opened entry is a PNG, JPEG or JPEG 2000 stream: parts[0..3] =
// (start, length) of its first and second pieces (BLP1: the JPEG header,
// then mip 0; ICO and ICNS: a PNG to the file's end, an ICNS JPEG 2000 entry
// of its own length, no second piece); all 0 when the entry is pixels that
// tracy_<fmt>_decode reads.
int tracy_ico_stream(const uint8_t* data, int64_t len, int64_t* parts) {
  return stream("ICO", data, len, parts, ico_stream);
}
int tracy_icns_stream(const uint8_t* data, int64_t len, int64_t* parts) {
  return stream("ICNS", data, len, parts, icns_stream);
}
int tracy_blp_stream(const uint8_t* data, int64_t len, int64_t* parts) {
  return stream("BLP", data, len, parts, blp_stream);
}

}  // extern "C"
