// TGA, BMP, GIF, PNM, PSD and QOI decoding on the host, for the texture
// loader and read_image: the rest of the formats that stb_image (the C++
// reference's loader) and PIL (tracy_tpu's) both read, and QOI, which PIL
// reads.
//
// Built into the same library as image_decode.cpp (utils/native.py::
// get_image_lib) and with its conventions: an extern "C" pair for each
// format, `tracy_<fmt>_info` (width and height) and `tracy_<fmt>_decode`
// (RGBA8 [h, w, 4]), returning 0, 1 for a fault of the file, or 2 for a
// failure inside the decoder, with the message in tracy_decode_error().
// The output equals PIL's open(...).convert("RGBA") but where ROADMAP's
// hazards say otherwise:
//
// TGA: image types 1, 2, 3 and their RLE forms 9, 10, 11; 1-bit grey
//   (type 3: PIL's mode "1", rows of packed bits, 1 white); 8-bit indices
//   into 15-, 16-, 24- or 32-bit colour maps (a map's first index offsets
//   the indices; others are black); 8-bit grey, grey + alpha at 16 bits;
//   15-, 16-, 24- and 32-bit true colour; the image-ID field skipped; the
//   descriptor's bottom-up and right-to-left bits. 5-bit channels scale as
//   v * 255 / 31. At 16 bits the top bit is PIL's inverted alpha (set:
//   alpha 0). PIL refuses 15-bit pixels and 15- and 32-bit maps, and RLE
//   runs across rows; they are read as stb_image reads them. A colour map
//   on a grey or true-colour image is skipped, as the format says.
// BMP: 12-, 40-, 52-, 56-, 64-, 108- and 124-byte headers; 1, 4, 8, 16, 24
//   and 32 bits a pixel; BI_RGB, BI_RLE8, BI_RLE4 and the BI_BITFIELDS
//   layouts PIL reads (16-bit 5-6-5 and 5-5-5, 24-bit BGR, eight 32-bit
//   byte layouts, with or without alpha); top-down rows; palettes shorter
//   than 2^bits (the missing entries are black). 32-bit BI_RGB keeps PIL's
//   alpha 255. RLE deltas and odd RLE4 absolute runs follow the format
//   (PIL misreads both).
// GIF: the first frame, as PIL's open gives it: global or local colour
//   table (a table that is the grey ramp 0, 1, 2, ... reads as grey, as
//   PIL reads it), LZW with code-size growth and clear codes, interlaced
//   rows, the graphic control extension's transparency index (alpha 0 on
//   it), the screen grown to hold the frame, and the pixels outside the
//   frame's rectangle set to the transparency index, else index 0.
// PNM: P1-P6, ASCII and binary, # comments, any maxval: samples scale as
//   PIL scales them, round(v / maxval * 255) with Python's round, but grey
//   above maxval 255, which PIL clips to white: that keeps the high byte of
//   PIL's 16-bit sample (stb_image's high byte at maxval 65535). PFM's grey
//   Pf (mode F: little-endian where the scale is negative, rows bottom-up,
//   taken to 8 bits as PIL takes mode F), and Pillow's own binary kinds:
//   P0CMYK and PyCMYK (through cmyk2rgb), PyRGBA, and PyP (a P image
//   without a palette, which PIL's convert turns opaque black).
// PSD: version 1, 8-bit channels, bitmap (at 8 bits, and at 1 bit as
//   PIL's mode "1": a set bit white), grey, indexed, RGB, CMYK (PIL's
//   inverted "C;I" channels, then cmyk2rgb), Lab (through PIL's LittleCMS
//   transform, `tracy_image::lab_to_rgb`), multichannel and duotone
//   colour modes, raw or PackBits merged image data; RGB with exactly 4
//   channels keeps the fourth as alpha, as PIL does. PackBits counts are read for every channel of the file (PIL
//   reads those of the channels it uses only).
// QOI: RGB and RGBA, all six ops and the index hash, as PIL's QoiDecoder.
//
// Anything else is refused by name: run-length or colour 1-bit TGA, BMP
// JPEG/PNG/other compressions and bitfield layouts PIL refuses, PSB, 16-
// and 32-bit PSD. Only a GIF's first frame is ever read.

#include "image_common.h"
#include "lab_table.h"

namespace tracy_image {

// PIL's LAB -> RGB: LittleCMS's 8-bit evaluation (PrelinEval8) of its
// optimized Lab2 (D50) -> sRGB transform, a 33^3 CLUT (lab_table.h,
// tools/make_lab_table.py): each input x 257 into the fixed domain, the
// tetrahedron of its cell by the order of the fractions, then the 16-bit
// result to 8 bits as LittleCMS rounds it. `a` and `b` are offset by 128.
void lab_to_rgb(int L, int a, int b, uint8_t* rgb) {
  constexpr int kGrid = 33, kOz = 3, kOy = 3 * kGrid, kOx = 3 * kGrid * kGrid;
  auto fixed = [](int v) {
    const int x = v * 257 * (kGrid - 1);
    return x + (x + 0x7fff) / 0xffff;  // _cmsToFixedDomain
  };
  const int fx = fixed(L), fy = fixed(a), fz = fixed(b);
  const int rx = fx & 0xffff, ry = fy & 0xffff, rz = fz & 0xffff;
  const int x0 = kOx * (fx >> 16), y0 = kOy * (fy >> 16), z0 = kOz * (fz >> 16);
  const int x1 = x0 + (rx ? kOx : 0), y1 = y0 + (ry ? kOy : 0), z1 = z0 + (rz ? kOz : 0);
  for (int ch = 0; ch < 3; ++ch) {
    auto d = [&](int x, int y, int z) { return int64_t(kLabClut[x + y + z + ch]); };
    const int64_t c0 = d(x0, y0, z0);
    int64_t c1, c2, c3;
    if (rx >= ry && ry >= rz) {
      c1 = d(x1, y0, z0) - c0, c2 = d(x1, y1, z0) - d(x1, y0, z0), c3 = d(x1, y1, z1) - d(x1, y1, z0);
    } else if (rx >= rz && rz >= ry) {
      c1 = d(x1, y0, z0) - c0, c2 = d(x1, y1, z1) - d(x1, y0, z1), c3 = d(x1, y0, z1) - d(x1, y0, z0);
    } else if (rz >= rx && rx >= ry) {
      c1 = d(x1, y0, z1) - d(x0, y0, z1), c2 = d(x1, y1, z1) - d(x1, y0, z1), c3 = d(x0, y0, z1) - c0;
    } else if (ry >= rx && rx >= rz) {
      c1 = d(x1, y1, z0) - d(x0, y1, z0), c2 = d(x0, y1, z0) - c0, c3 = d(x1, y1, z1) - d(x1, y1, z0);
    } else if (ry >= rz && rz >= rx) {
      c1 = d(x1, y1, z1) - d(x0, y1, z1), c2 = d(x0, y1, z0) - c0, c3 = d(x0, y1, z1) - d(x0, y1, z0);
    } else {
      c1 = d(x1, y1, z1) - d(x0, y1, z1), c2 = d(x0, y1, z1) - d(x0, y0, z1), c3 = d(x0, y0, z1) - c0;
    }
    const int64_t rest = c1 * rx + c2 * ry + c3 * rz + 0x8001;
    const uint32_t v16 = uint32_t(c0 + ((rest + (rest >> 16)) >> 16)) & 0xffff;
    rgb[ch] = static_cast<uint8_t>((v16 * 65281u + 8388608u) >> 24);  // FROM_16_TO_8
  }
}

}  // namespace tracy_image

namespace {

inline int scale5(int v) { return v * 255 / 31; }

// ---------------------------------------------------------------- TGA

struct Tga {
  int type, cm_start, cm_len, cm_depth, w, h, depth, desc;
  bool has_map;
  size_t map_at, data_at;
};

Tga tga_header(const Bytes& b) {
  b.need(0, 18);
  Tga t{};
  const int id_len = b.u8(0);
  const int cm_type = b.u8(1);
  t.type = b.u8(2);
  t.cm_start = static_cast<int>(b.le16(3));
  t.cm_len = static_cast<int>(b.le16(5));
  t.cm_depth = b.u8(7);
  t.w = static_cast<int>(b.le16(12));
  t.h = static_cast<int>(b.le16(14));
  t.depth = b.u8(16);
  t.desc = b.u8(17);
  if (cm_type > 1 || t.w == 0 || t.h == 0) fail("TGA: not a TGA header");
  const int d = t.depth;
  if (d != 1 && d != 8 && d != 15 && d != 16 && d != 24 && d != 32) {
    fail("TGA: " + std::to_string(d) + " bits a pixel not read");
  }
  const int base = t.type & ~8;
  // PIL reads 1 bit as grey (mode "1") only; its run-length reader takes
  // 1 bit for 0 bytes a pixel and finds the file truncated.
  if (d == 1 && base != 3) fail("TGA: 1-bit image of type " + std::to_string(t.type) + " not read");
  if (d == 1 && (t.type & 8)) fail("TGA: run-length 1-bit images are not read");
  if (t.type > 11 || (base != 1 && base != 2 && base != 3)) {
    fail("TGA: image type " + std::to_string(t.type) + " not read");
  }
  t.has_map = cm_type == 1;
  if (base == 1) {
    if (!t.has_map) fail("TGA: colour-mapped image without a colour map");
    if (d != 8) fail("TGA: colour-mapped image at " + std::to_string(d) + " bits not read");
    const int m = t.cm_depth;
    if (m != 15 && m != 16 && m != 24 && m != 32) {
      fail("TGA: colour map entries of " + std::to_string(m) + " bits not read");
    }
  }
  if (base == 2 && d == 8) fail("TGA: true colour at 8 bits not read");
  if (base == 3 && d != 1 && d != 8 && d != 16) {
    fail("TGA: grey at " + std::to_string(d) + " bits not read");
  }
  t.map_at = 18 + static_cast<size_t>(id_len);
  const size_t entry = static_cast<size_t>(t.cm_depth + 7) / 8;
  t.data_at = t.map_at + (t.has_map ? entry * t.cm_len : 0);
  return t;
}

// One 15/16/24/32-bit BGR(A) value to RGBA (16 bits: PIL's inverted alpha).
inline void tga_colour(const uint8_t* s, int depth, uint8_t* o) {
  if (depth == 15 || depth == 16) {
    const int v = s[0] | s[1] << 8;
    put(o, scale5((v >> 10) & 31), scale5((v >> 5) & 31), scale5(v & 31),
        depth == 16 && (v & 0x8000) ? 0 : 255);
  } else {
    put(o, s[2], s[1], s[0], depth == 32 ? s[3] : 255);
  }
}

void tga_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Tga t = tga_header(b);
  check_out("TGA", t.w, t.h, out_w, out_h);
  const int base = t.type & 7;
  const bool rle = t.type & 8;
  const int bpp = (t.depth + 7) / 8;
  std::vector<uint8_t> map;
  if (base == 1) {
    const int entry = (t.cm_depth + 7) / 8;
    b.need(t.map_at, static_cast<size_t>(entry) * t.cm_len);
    map.resize(4 * static_cast<size_t>(t.cm_len));
    for (int i = 0; i < t.cm_len; ++i) {
      tga_colour(b.p + t.map_at + static_cast<size_t>(i) * entry, t.cm_depth, &map[4 * i]);
    }
  }
  auto pixel = [&](const uint8_t* s, uint8_t* o) {
    if (base == 1) {
      const int k = s[0] - t.cm_start;
      if (k >= 0 && k < t.cm_len) {
        std::memcpy(o, &map[4 * k], 4);
      } else {
        put(o, 0, 0, 0, 255);
      }
    } else if (base == 3) {
      put(o, s[0], s[0], s[0], t.depth == 16 ? s[1] : 255);
    } else {
      tga_colour(s, t.depth, o);
    }
  };
  const bool top = t.desc & 0x20, right = t.desc & 0x10;
  const int64_t total = int64_t(t.w) * t.h;
  if (t.depth == 1) {  // rows of (w + 7) / 8 bytes, the first pixel in the top bit, 1 white
    const int64_t stride = (t.w + 7) / 8;
    b.need(t.data_at, static_cast<size_t>(stride * t.h));
    for (int64_t r = 0; r < t.h; ++r) {
      const uint8_t* row = b.p + t.data_at + r * stride;
      const int64_t y = top ? r : t.h - 1 - r;
      for (int64_t c = 0; c < t.w; ++c) {
        const int v = (row[c >> 3] >> (7 - (c & 7)) & 1) ? 255 : 0;
        put(out + 4 * (y * t.w + (right ? t.w - 1 - c : c)), v, v, v, 255);
      }
    }
    return;
  }
  // Pixels come in file order: rows bottom-up unless `top`, each row
  // right-to-left if `right`.
  auto dest = [&](int64_t i) {
    const int64_t r = i / t.w, c = i % t.w;
    const int64_t y = top ? r : t.h - 1 - r;
    const int64_t x = right ? t.w - 1 - c : c;
    return out + 4 * (y * t.w + x);
  };
  size_t pos = t.data_at;
  if (!rle) {
    b.need(pos, static_cast<size_t>(total) * bpp);
    for (int64_t i = 0; i < total; ++i) pixel(b.p + pos + i * bpp, dest(i));
    return;
  }
  // RLE packets run on across rows (stb_image's reading; PIL refuses a run
  // that crosses a row and reads a literal packet that does).
  int64_t i = 0;
  while (i < total) {
    const int head = b.u8(pos++);
    const int64_t count = std::min<int64_t>((head & 0x7f) + 1, total - i);
    if (head & 0x80) {
      b.need(pos, bpp);
      uint8_t px[4];
      pixel(b.p + pos, px);
      pos += bpp;
      for (int64_t k = 0; k < count; ++k) std::memcpy(dest(i + k), px, 4);
    } else {
      b.need(pos, static_cast<size_t>((head & 0x7f) + 1) * bpp);
      for (int64_t k = 0; k < count; ++k) pixel(b.p + pos + k * bpp, dest(i + k));
      pos += static_cast<size_t>((head & 0x7f) + 1) * bpp;
    }
    i += count;
  }
}

// ---------------------------------------------------------------- BMP

enum BmpLayout { kIndexed, k555, k565, kBGR, k32 };

struct Bmp {
  int64_t w, h;
  bool top_down;
  int bits, comp;
  BmpLayout layout;
  int shift[4];  // 32-bit: byte of R, G, B, A in the pixel (A -1: 255)
  std::vector<uint8_t> palette;  // RGBA of the entries the file holds
  size_t data_at;
};

// The info header at `at` (14 in a BMP file, 0 in a DIB); `off` the pixel
// offset of a BMP's file header, 0 for a DIB, whose pixels follow the
// header, the bitfield masks and the palette (PIL's tile offset).
Bmp bmp_info(const Bytes& b, size_t at, uint32_t off) {
  Bmp m{};
  const uint32_t hsize = b.le32(at);
  int64_t colors = 0;
  int pad = 4;
  if (hsize == 12) {
    m.w = b.le16(at + 4);
    m.h = b.le16(at + 6);
    m.bits = static_cast<int>(b.le16(at + 10));
    pad = 3;
  } else if (hsize == 40 || hsize == 52 || hsize == 56 || hsize == 64 || hsize == 108 ||
             hsize == 124) {
    b.need(at, hsize);
    m.w = b.le32(at + 4);
    const uint32_t h = b.le32(at + 8);
    m.top_down = b.u8(at + 11) == 0xFF;  // a negative height, as PIL tests it
    m.h = m.top_down ? (int64_t(1) << 32) - h : h;
    m.bits = static_cast<int>(b.le16(at + 14));
    m.comp = static_cast<int>(b.le32(at + 16));
    colors = b.le32(at + 32);
  } else {
    fail("BMP: header of " + std::to_string(hsize) + " bytes not read");
  }
  check_size("BMP", m.w, m.h);
  if (m.bits != 1 && m.bits != 4 && m.bits != 8 && m.bits != 16 && m.bits != 24 &&
      m.bits != 32) {
    fail("BMP: " + std::to_string(m.bits) + " bits a pixel not read");
  }
  if (colors == 0) colors = int64_t(1) << m.bits;
  if (off == 14 + hsize && m.bits <= 8) off += static_cast<uint32_t>(4 * colors);
  m.layout = m.bits <= 8 ? kIndexed : m.bits == 16 ? k555 : m.bits == 24 ? kBGR : k32;
  m.shift[0] = 2, m.shift[1] = 1, m.shift[2] = 0, m.shift[3] = -1;  // BGRX
  size_t table_end = at + hsize;
  if (m.comp == 3) {  // BI_BITFIELDS: the layouts PIL reads
    const uint32_t r = b.le32(at + 40), g = b.le32(at + 44), bl = b.le32(at + 48);
    const uint32_t a = hsize >= 56 ? b.le32(at + 52) : 0;
    if (hsize == 40) table_end += 12;
    bool ok = false;
    if (m.bits == 32) {
      static const uint32_t kMasks[8][4] = {
          {0xFF0000, 0xFF00, 0xFF, 0}, {0xFF000000, 0xFF0000, 0xFF00, 0},
          {0xFF000000, 0xFF00, 0xFF, 0}, {0xFF000000, 0xFF0000, 0xFF00, 0xFF},
          {0xFF, 0xFF00, 0xFF0000, 0xFF000000}, {0xFF0000, 0xFF00, 0xFF, 0xFF000000},
          {0xFF000000, 0xFF00, 0xFF, 0xFF0000}, {0, 0, 0, 0}};
      for (const auto& k : kMasks) {
        if (r == k[0] && g == k[1] && bl == k[2] && a == k[3]) ok = true;
      }
      auto byte_of = [](uint32_t mask) {
        for (int i = 0; i < 4; ++i) {
          if (mask == 0xFFu << (8 * i)) return i;
        }
        return -1;
      };
      if (ok && r == 0) {  // no masks at all: PIL reads BGRA
        m.shift[3] = 3;
      } else if (ok) {
        m.shift[0] = byte_of(r), m.shift[1] = byte_of(g), m.shift[2] = byte_of(bl);
        m.shift[3] = byte_of(a);
      }
    } else if (m.bits == 24) {
      ok = r == 0xFF0000 && g == 0xFF00 && bl == 0xFF;
    } else if (m.bits == 16) {
      if (r == 0xF800 && g == 0x7E0 && bl == 0x1F) {
        ok = true;
        m.layout = k565;
      } else {
        ok = r == 0x7C00 && g == 0x3E0 && bl == 0x1F;
      }
    }
    if (!ok) fail("BMP: this bitfields layout is not read");
  } else if (m.comp == 1 || m.comp == 2) {
    if (m.bits > 8) fail("BMP: RLE at " + std::to_string(m.bits) + " bits not read");
  } else if (m.comp != 0) {
    fail("BMP: compression " + std::to_string(m.comp) + " not read");
  }
  if (m.layout == kIndexed) {
    if (colors <= 0 || colors > 65536) fail("BMP: palette size not read");
    // The entries the file holds (PIL reads what is there; the rest are
    // black).
    const size_t have = std::min<size_t>(static_cast<size_t>(colors) * pad,
                                         b.n > table_end ? b.n - table_end : 0) / pad;
    const size_t used = std::min<size_t>(have, 256);
    m.palette.resize(4 * used);
    for (size_t i = 0; i < used; ++i) {
      const uint8_t* e = b.p + table_end + i * pad;
      put(&m.palette[4 * i], e[2], e[1], e[0], 255);
    }
    table_end += static_cast<size_t>(colors) * pad;
  }
  m.data_at = off ? off : table_end;
  return m;
}

Bmp bmp_header(const Bytes& b) {
  if (b.n < 2 || b.p[0] != 'B' || b.p[1] != 'M') fail("BMP: not a BMP file");
  return bmp_info(b, 14, b.le32(10));
}

inline void bmp_index(const Bmp& m, int k, uint8_t* o) {
  if (4 * static_cast<size_t>(k) < m.palette.size()) {
    std::memcpy(o, &m.palette[4 * k], 4);
  } else {
    put(o, 0, 0, 0, 255);
  }
}

// BI_RLE8 / BI_RLE4 into a row-major index buffer in file row order, as
// PIL's BmpRleDecoder fills it: runs stop at the row's end, absolute runs
// run on into the next row, end-of-line pads the row with index 0. A delta
// (dx, dy) skips dx + dy * w pixels, left at index 0 (PIL reads two more
// bytes than the format has). An odd RLE4 absolute run keeps its last
// pixel (PIL drops it and loses step with the stream).
std::vector<uint8_t> bmp_rle(const Bytes& b, const Bmp& m) {
  const bool rle4 = m.comp == 2;
  const int64_t w = m.w, total = m.w * m.h;
  std::vector<uint8_t> idx(static_cast<size_t>(total), 0);
  int64_t len = 0, x = 0;
  size_t pos = m.data_at;
  auto push = [&](int v) {
    if (len < total) idx[static_cast<size_t>(len)] = static_cast<uint8_t>(v);
    ++len;
  };
  while (len < total) {
    if (pos + 2 > b.n) break;
    const int n = b.p[pos], c = b.p[pos + 1];
    pos += 2;
    if (n) {
      const int64_t k = x + n > w ? std::max<int64_t>(0, w - x) : n;
      for (int64_t i = 0; i < k; ++i) push(rle4 ? (i % 2 ? c & 15 : c >> 4) : c);
      x += k;
    } else if (c == 0) {  // end of line
      while (len % w) push(0);
      x = 0;
    } else if (c == 1) {  // end of bitmap
      break;
    } else if (c == 2) {  // delta
      if (pos + 2 > b.n) break;
      const int64_t skip = b.p[pos] + int64_t(b.p[pos + 1]) * w;
      pos += 2;
      for (int64_t i = 0; i < skip && len < total; ++i) push(0);
      x = len % w;
    } else {  // absolute run of c pixels
      const size_t bytes = rle4 ? (c + 1) / 2 : c;
      if (pos + bytes > b.n) break;
      for (int i = 0; i < c; ++i) {
        const int v = b.p[pos + (rle4 ? i / 2 : i)];
        push(rle4 ? (i % 2 ? v & 15 : v >> 4) : v);
      }
      pos += bytes;
      x += c;
      if (pos & 1) ++pos;  // word alignment in the file, as PIL aligns
    }
  }
  if (len < total) fail("BMP: RLE data ends before the last pixel");
  return idx;
}

// The pixels of a parsed BMP (m.h rows from m.data_at) to RGBA8 [h, w, 4].
void bmp_pixels(const Bytes& b, const Bmp& m, uint8_t* out) {
  const int64_t w = m.w, h = m.h;
  auto row_out = [&](int64_t r) {  // output row of file row r
    return out + 4 * w * (m.top_down ? r : h - 1 - r);
  };
  if (m.comp == 1 || m.comp == 2) {
    const std::vector<uint8_t> idx = bmp_rle(b, m);
    for (int64_t r = 0; r < h; ++r) {
      uint8_t* o = row_out(r);
      for (int64_t x = 0; x < w; ++x) bmp_index(m, idx[r * w + x], o + 4 * x);
    }
    return;
  }
  const size_t stride = ((static_cast<size_t>(w) * m.bits + 31) >> 3) & ~size_t(3);
  b.need(m.data_at, stride * static_cast<size_t>(h));
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t* s = b.p + m.data_at + stride * r;
    uint8_t* o = row_out(r);
    for (int64_t x = 0; x < w; ++x, o += 4) {
      switch (m.layout) {
        case kIndexed: {
          const int sh = 8 - m.bits - static_cast<int>((x * m.bits) % 8);
          bmp_index(m, (s[x * m.bits / 8] >> sh) & ((1 << m.bits) - 1), o);
          break;
        }
        case k555:
        case k565: {
          const int v = s[2 * x] | s[2 * x + 1] << 8;
          if (m.layout == k555) {
            put(o, scale5(v >> 10 & 31), scale5(v >> 5 & 31), scale5(v & 31), 255);
          } else {
            put(o, scale5(v >> 11 & 31), (v >> 5 & 63) * 255 / 63, scale5(v & 31), 255);
          }
          break;
        }
        case kBGR:
          put(o, s[3 * x + 2], s[3 * x + 1], s[3 * x], 255);
          break;
        case k32: {
          const uint8_t* p = s + 4 * x;
          put(o, p[m.shift[0]], p[m.shift[1]], p[m.shift[2]],
              m.shift[3] < 0 ? 255 : p[m.shift[3]]);
          break;
        }
      }
    }
  }
}

void bmp_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Bmp m = bmp_header(b);
  check_out("BMP", m.w, m.h, out_w, out_h);
  bmp_pixels(b, m, out);
}

}  // namespace

namespace tracy_image {

DibSize dib_size(const uint8_t* p, size_t n, size_t at) {
  const Bmp m = bmp_info({p, n, "BMP"}, at, 0);
  return {m.w, m.h};
}

size_t dib_decode(const uint8_t* p, size_t n, size_t at, int64_t rows, bool raw_alpha,
                  uint8_t* out) {
  const Bytes b{p, n, "BMP"};
  Bmp m = bmp_info(b, at, 0);
  if (rows <= 0 || rows > m.h) fail("BMP: " + std::to_string(rows) + " rows not read");
  m.h = rows;
  if (raw_alpha && m.comp == 0 && m.bits == 32) m.shift[3] = 3;
  bmp_pixels(b, m, out);
  return m.data_at;
}

}  // namespace tracy_image

namespace {

// ---------------------------------------------------------------- GIF

struct Gif {
  int64_t w, h;               // the screen, grown to hold the frame
  int x0, y0, fw, fh;         // the first frame's rectangle
  bool interlace;
  int transparency;           // -1: none
  const uint8_t* table;       // the frame's colour table (null: grey)
  int entries;                // its entries
  int lzw_bits;
  size_t data_at;
};

// Whether a colour table differs from the grey ramp 0, 1, 2, ... (PIL keeps
// a table only then, else it reads the indices as grey).
bool gif_table_needed(const uint8_t* p, size_t bytes) {
  for (size_t i = 0; i + 2 < bytes; i += 3) {
    const size_t k = i / 3;
    if (!(p[i] == k && p[i + 1] == k && p[i + 2] == k)) return true;
  }
  return false;
}

// The bytes of a table of 3 << bits bytes at `at`, as much as the file holds.
size_t gif_table_bytes(const Bytes& b, size_t at, int bits) {
  const size_t want = size_t(3) << bits;
  return at >= b.n ? 0 : std::min(want, b.n - at);
}

Gif gif_header(const Bytes& b) {
  if (b.n < 13 || (std::memcmp(b.p, "GIF87a", 6) != 0 && std::memcmp(b.p, "GIF89a", 6) != 0)) {
    fail("GIF: not a GIF file");
  }
  Gif g{};
  g.w = b.le16(6);
  g.h = b.le16(8);
  const int flags = b.u8(10);
  size_t pos = 13;
  const uint8_t* global = nullptr;
  int global_entries = 0;
  if (flags & 0x80) {
    const size_t bytes = gif_table_bytes(b, pos, (flags & 7) + 1);
    if (gif_table_needed(b.p + pos, bytes)) {
      global = b.p + pos;
      global_entries = static_cast<int>(bytes / 3);
    }
    pos += size_t(3) << ((flags & 7) + 1);
  }
  g.transparency = -1;
  // One sub-block, as PIL's GifImageFile.data reads it: its size (0 ends a
  // chain), pos past it.
  auto sub_block = [&]() {
    const int n = b.u8(pos);
    pos += 1 + n;
    return n;
  };
  // Blocks up to the first image descriptor; bytes that start no block are
  // skipped, as PIL skips them.
  while (true) {
    if (pos >= b.n) fail("GIF: no image in the file");
    const int c = b.p[pos++];
    if (c == ';') fail("GIF: no image in the file");
    if (c == '!') {
      const int label = b.u8(pos++);
      int n = sub_block();
      b.need(pos - n, n);
      const uint8_t* first = b.p + pos - n;
      if (label == 0xF9 && n > 0 && (first[0] & 1)) {
        if (n < 4) fail("GIF: graphic control extension is truncated");
        g.transparency = first[3];
      }
      if (label == 0xFE) {  // a comment: its chain ends at its terminator
        while (n) n = sub_block();
        continue;
      }
      if (label == 0xFF && n >= 11 && std::memcmp(first, "NETSCAPE2.0", 11) == 0) sub_block();
      // Then PIL skips sub-blocks up to a terminator (after an empty first
      // block, or an empty loop-count block, the chain that follows).
      while (sub_block()) {
      }
    } else if (c == ',') {
      b.need(pos, 9);
      g.x0 = static_cast<int>(b.le16(pos));
      g.y0 = static_cast<int>(b.le16(pos + 2));
      g.fw = static_cast<int>(b.le16(pos + 4));
      g.fh = static_cast<int>(b.le16(pos + 6));
      const int lflags = b.p[pos + 8];
      pos += 9;
      g.interlace = lflags & 0x40;
      g.table = global;
      g.entries = global_entries;
      if (lflags & 0x80) {
        const size_t bytes = gif_table_bytes(b, pos, (lflags & 7) + 1);
        const bool needed = gif_table_needed(b.p + pos, bytes);
        g.table = needed ? b.p + pos : nullptr;
        g.entries = needed ? static_cast<int>(bytes / 3) : 0;
        pos += size_t(3) << ((lflags & 7) + 1);
      }
      g.lzw_bits = b.u8(pos++);
      g.data_at = pos;
      break;
    }
  }
  if (g.fw == 0 || g.fh == 0) fail("GIF: the first frame is empty");
  g.w = std::max<int64_t>(g.w, g.x0 + g.fw);
  g.h = std::max<int64_t>(g.h, g.y0 + g.fh);
  check_size("GIF", g.w, g.h);
  if (g.lzw_bits < 1 || g.lzw_bits > 11) {
    fail("GIF: LZW code size " + std::to_string(g.lzw_bits) + " not read");
  }
  return g;
}

// LZW-decode the frame's indices into idx ([fh, fw], rows in display
// order), as PIL's GifDecode.c does; stops at the frame's last pixel.
void gif_lzw(const Bytes& b, const Gif& g, std::vector<uint8_t>& idx) {
  const int clear = 1 << g.lzw_bits, end = clear + 1;
  static thread_local uint16_t link[4096];
  static thread_local uint8_t suffix[4096];
  static thread_local uint8_t stack[4097];
  int codesize = 0, codemask = 0, next = 0, lastcode = 0, lastdata = 0;
  bool fresh = true;  // the next code is the first after a clear
  auto reset = [&]() {
    next = clear + 2;
    codesize = g.lzw_bits + 1;
    codemask = (1 << codesize) - 1;
    fresh = true;
  };
  reset();
  // Rows: 0, 8, ..., then 4, 12, ..., 2, 6, ..., 1, 3, ... when interlaced.
  int x = 0, y = 0, step = g.interlace ? 8 : 1, pass = g.interlace ? 1 : 0;
  bool done = false;
  auto emit = [&](int v) {
    idx[static_cast<size_t>(y) * g.fw + x] = static_cast<uint8_t>(v);
    if (++x < g.fw) return;
    x = 0;
    y += step;
    while (y >= g.fh) {
      if (pass == 1) {
        y = 4, pass = 2;
      } else if (pass == 2) {
        y = 2, step = 4, pass = 3;
      } else if (pass == 3) {
        y = 1, step = 2, pass = 0;
      } else {
        done = true;
        return;
      }
    }
  };
  size_t pos = g.data_at;
  int block = 0;
  uint32_t bitbuf = 0;
  int bitcount = 0;
  while (!done) {
    while (bitcount < codesize) {
      if (block > 0) {
        bitbuf |= uint32_t(b.p[pos++]) << bitcount;
        bitcount += 8;
        --block;
      } else {
        const int n = b.u8(pos);
        if (n == 0) fail("GIF: image data ends before the last pixel");
        b.need(pos + 1, n);
        block = n;
        ++pos;
      }
    }
    int c = static_cast<int>(bitbuf & codemask);
    bitbuf >>= codesize;
    bitcount -= codesize;
    if (c == clear) {
      reset();
      continue;
    }
    if (c == end) fail("GIF: image data ends before the last pixel");
    if (fresh) {
      if (c > clear) fail("GIF: corrupt LZW data");
      lastdata = lastcode = c;
      fresh = false;
      emit(c);
      continue;
    }
    const int thiscode = c;
    if (c > next) fail("GIF: corrupt LZW data");
    int top = 0;
    if (c == next) {
      stack[top++] = static_cast<uint8_t>(lastdata);
      c = lastcode;
    }
    while (c >= clear) {
      if (top >= 4096 || c >= 4096) fail("GIF: corrupt LZW data");
      stack[top++] = suffix[c];
      c = link[c];
    }
    lastdata = c;
    if (next < 4096) {
      suffix[next] = static_cast<uint8_t>(c);
      link[next] = static_cast<uint16_t>(lastcode);
      if (next == codemask && codesize < 12) {
        ++codesize;
        codemask = (1 << codesize) - 1;
      }
      ++next;
    }
    lastcode = thiscode;
    emit(c);
    while (top > 0 && !done) emit(stack[--top]);
  }
}

void gif_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Gif g = gif_header(b);
  check_out("GIF", g.w, g.h, out_w, out_h);
  std::vector<uint8_t> idx(static_cast<size_t>(g.fw) * g.fh);
  gif_lzw(b, g, idx);
  uint8_t lut[256][4];
  for (int v = 0; v < 256; ++v) {
    if (!g.table) {
      put(lut[v], v, v, v, 255);
    } else if (v < g.entries) {
      put(lut[v], g.table[3 * v], g.table[3 * v + 1], g.table[3 * v + 2], 255);
    } else {
      put(lut[v], 0, 0, 0, 255);
    }
  }
  if (g.transparency >= 0) lut[g.transparency][3] = 0;
  const uint8_t* bg = lut[g.transparency >= 0 ? g.transparency : 0];
  for (int64_t i = 0; i < g.w * g.h; ++i) std::memcpy(out + 4 * i, bg, 4);
  for (int r = 0; r < g.fh; ++r) {
    uint8_t* o = out + 4 * ((g.y0 + r) * g.w + g.x0);
    const uint8_t* s = &idx[static_cast<size_t>(r) * g.fw];
    for (int c = 0; c < g.fw; ++c) std::memcpy(o + 4 * c, lut[s[c]], 4);
  }
}

// ---------------------------------------------------------------- PNM

inline bool pnm_space(int c) { return c == ' ' || c == '\t' || (c >= '\n' && c <= '\r'); }

struct Pnm {
  int kind;  // 1..6; 0 Pf; 7 P0CMYK or PyCMYK; 8 PyRGBA; 9 PyP
  int64_t w, h;
  int maxval;
  bool little;  // Pf: a negative scale
  size_t data_at;
};

// One header token as PIL's PpmImageFile._read_token reads it: whitespace
// before it skipped, a # comment (to CR or LF) dropped wherever it starts,
// ended by one whitespace byte, at most 10 bytes.
std::string pnm_text(const Bytes& b, size_t& pos) {
  std::string tok;
  while (tok.size() <= 10) {
    if (pos >= b.n) break;
    const int c = b.p[pos++];
    if (pnm_space(c)) {
      if (tok.empty()) continue;
      break;
    }
    if (c == '#') {
      while (pos < b.n && b.p[pos] != '\r' && b.p[pos] != '\n') ++pos;
      ++pos;
      continue;
    }
    tok.push_back(static_cast<char>(c));
  }
  if (tok.empty()) fail("PNM: header ends early");
  if (tok.size() > 10) fail("PNM: header token too long");
  return tok;
}

int64_t pnm_token(const Bytes& b, size_t& pos) {
  const std::string tok = pnm_text(b, pos);
  size_t i = tok[0] == '+' ? 1 : 0;
  if (i == tok.size()) fail("PNM: bad header token");
  int64_t v = 0;
  for (; i < tok.size(); ++i) {
    if (tok[i] < '0' || tok[i] > '9') fail("PNM: bad header token '" + tok + "'");
    v = v * 10 + (tok[i] - '0');
  }
  return v;
}

Pnm pnm_header(const Bytes& b) {
  size_t pos = 0;
  std::string magic;
  while (magic.size() < 6 && pos < b.n) {
    const int c = b.p[pos++];
    if (pnm_space(c)) break;
    magic.push_back(static_cast<char>(c));
  }
  if (magic.size() == 2 && magic[0] == 'P' && magic[1] >= '1' && magic[1] <= '6') {
    Pnm m{};
    m.kind = magic[1] - '0';
    m.w = pnm_token(b, pos);
    m.h = pnm_token(b, pos);
    check_size("PNM", m.w, m.h);
    m.maxval = 1;
    if (m.kind != 1 && m.kind != 4) {
      const int64_t mv = pnm_token(b, pos);
      if (mv <= 0 || mv >= 65536) fail("PNM: maxval must be in 1..65535");
      m.maxval = static_cast<int>(mv);
    }
    m.data_at = pos;
    return m;
  }
  const int kind = magic == "Pf" ? 0 : magic == "P0CMYK" || magic == "PyCMYK" ? 7
                 : magic == "PyRGBA" ? 8 : magic == "PyP" ? 9 : -1;
  if (kind < 0) fail("PNM: not a PNM file");  // colour PFM (PF) too: PIL knows no such magic
  Pnm m{};
  m.kind = kind;
  m.w = pnm_token(b, pos);
  m.h = pnm_token(b, pos);
  check_size("PNM", m.w, m.h);
  if (kind == 0) {  // Python's float() of the scale token
    const std::string tok = pnm_text(b, pos);
    char* end = nullptr;
    const double scale = std::strtod(tok.c_str(), &end);
    if (end != tok.c_str() + tok.size()) fail("PNM: bad PFM scale '" + tok + "'");
    if (scale == 0.0 || !std::isfinite(scale)) fail("PNM: PFM scale must be finite and non-zero");
    m.little = scale < 0;
    m.maxval = 255;
  } else {
    const int64_t mv = pnm_token(b, pos);
    if (mv <= 0 || mv >= 65536) fail("PNM: maxval must be in 1..65535");
    m.maxval = static_cast<int>(mv);
  }
  m.data_at = pos;
  return m;
}

// A sample of maxval m to 8 bits: round(v / m * 255) with Python's round
// (half to even, the current rounding mode's nearbyint), at most 255; grey
// above maxval 255 keeps the high byte of round(v / m * 65535).
struct PnmScale {
  int maxval;
  bool grey16;
  int operator()(int64_t v) const {
    if (grey16) {
      const double s = std::min(65535.0, std::nearbyint(double(v) / maxval * 65535.0));
      return static_cast<int>(s) >> 8;
    }
    return static_cast<int>(std::min(255.0, std::nearbyint(double(v) / maxval * 255.0)));
  }
};

// Pillow's binary kinds and PFM.
void pnm_extension(const Bytes& b, const Pnm& m, uint8_t* out) {
  const int64_t total = m.w * m.h;
  if (m.kind == 0) {
    b.need(m.data_at, static_cast<size_t>(total) * 4);
    for (int64_t y = 0; y < m.h; ++y)
      for (int64_t x = 0; x < m.w; ++x) {
        const uint8_t* s = b.p + m.data_at + 4 * ((m.h - 1 - y) * m.w + x);
        const uint32_t u = m.little ? tracy_image::le32(s) : tracy_image::be32(s);
        const int v = tracy_image::f_to_u8(tracy_image::f32(u));
        put(out + 4 * (y * m.w + x), v, v, v, 255);
      }
    return;
  }
  const int bands = m.kind == 9 ? 1 : 4, in = m.maxval < 256 ? 1 : 2;
  b.need(m.data_at, static_cast<size_t>(total * bands) * in);
  const uint8_t* s = b.p + m.data_at;
  const PnmScale scale{m.maxval, false};
  auto at = [&](int64_t i) {
    const int x = in == 1 ? s[i] : s[2 * i] << 8 | s[2 * i + 1];
    return m.maxval == 255 ? x : scale(x);
  };
  for (int64_t p = 0; p < total; ++p) {
    uint8_t* o = out + 4 * p;
    if (m.kind == 9) {
      put(o, 0, 0, 0, 255);
    } else if (m.kind == 8) {
      put(o, at(4 * p), at(4 * p + 1), at(4 * p + 2), at(4 * p + 3));
    } else {
      const int nk = 255 - at(4 * p + 3);
      put(o, cmyk_channel(at(4 * p), nk), cmyk_channel(at(4 * p + 1), nk),
          cmyk_channel(at(4 * p + 2), nk), 255);
    }
  }
}

void pnm_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Pnm m = pnm_header(b);
  check_out("PNM", m.w, m.h, out_w, out_h);
  if (m.kind == 0 || m.kind > 6) return pnm_extension(b, m, out);
  const int64_t total = m.w * m.h;
  const bool colour = m.kind == 3 || m.kind == 6;
  const int bands = colour ? 3 : 1;
  const int64_t samples = total * bands;
  std::vector<int> v(static_cast<size_t>(samples));
  if (m.kind == 4) {  // packed bits, 1 = black
    const size_t stride = static_cast<size_t>((m.w + 7) / 8);
    b.need(m.data_at, stride * static_cast<size_t>(m.h));
    for (int64_t y = 0; y < m.h; ++y) {
      for (int64_t x = 0; x < m.w; ++x) {
        const int bit = b.p[m.data_at + stride * y + x / 8] >> (7 - x % 8) & 1;
        v[y * m.w + x] = bit ? 0 : 255;
      }
    }
  } else if (m.kind == 5 || m.kind == 6) {
    const int in = m.maxval < 256 ? 1 : 2;
    b.need(m.data_at, static_cast<size_t>(samples) * in);
    const uint8_t* s = b.p + m.data_at;
    const PnmScale scale{m.maxval, !colour && m.maxval > 255};
    for (int64_t i = 0; i < samples; ++i) {
      const int x = in == 1 ? s[i] : s[2 * i] << 8 | s[2 * i + 1];
      v[i] = m.maxval == 255 ? x : scale(x);
    }
  } else {
    // ASCII, as PIL's PpmPlainDecoder reads it: comments (# to CR or LF,
    // both dropped) come out first, then the rest splits at whitespace; P1
    // digits need none between them.
    std::string text;
    for (size_t pos = m.data_at; pos < b.n; ++pos) {
      if (b.p[pos] != '#') {
        text.push_back(static_cast<char>(b.p[pos]));
        continue;
      }
      while (pos < b.n && b.p[pos] != '\r' && b.p[pos] != '\n') ++pos;
    }
    const PnmScale scale{m.maxval, !colour && m.maxval > 255};
    size_t pos = 0;
    int64_t i = 0;
    while (i < samples && pos < text.size()) {
      const int c = static_cast<uint8_t>(text[pos]);
      if (pnm_space(c)) {
        ++pos;
        continue;
      }
      if (m.kind == 1) {
        if (c != '0' && c != '1') fail("PNM: bad P1 data");
        v[i++] = c == '1' ? 0 : 255;
        ++pos;
        continue;
      }
      std::string tok;
      while (pos < text.size() && !pnm_space(static_cast<uint8_t>(text[pos]))) {
        tok.push_back(text[pos++]);
      }
      if (tok.size() > 10) fail("PNM: data token too long");
      size_t k = tok[0] == '+' ? 1 : 0;
      if (k == tok.size()) fail("PNM: bad data token");
      int64_t x = 0;
      for (; k < tok.size(); ++k) {
        if (tok[k] < '0' || tok[k] > '9') fail("PNM: bad data token '" + tok + "'");
        x = x * 10 + (tok[k] - '0');
      }
      if (x > m.maxval) fail("PNM: sample above maxval");
      v[i++] = scale(x);
    }
    if (i < samples) fail("PNM: file is truncated");
  }
  for (int64_t p = 0; p < total; ++p) {
    if (colour) {
      put(out + 4 * p, v[3 * p], v[3 * p + 1], v[3 * p + 2], 255);
    } else {
      put(out + 4 * p, v[p], v[p], v[p], 255);
    }
  }
}

// ---------------------------------------------------------------- PSD

struct Psd {
  int64_t w, h;
  int channels, mode, used;  // used: channels read (1, 3 or 4)
  bool bits;                 // 1-bit bitmap
  const uint8_t* palette;    // indexed: 768 bytes, planar R, G, B
  int comp;
  size_t data_at;
};

Psd psd_header(const Bytes& b) {
  if (b.n < 4 || std::memcmp(b.p, "8BPS", 4) != 0) fail("PSD: not a PSD file");
  const uint32_t version = b.be16(4);
  if (version == 2) fail("PSD: PSB (large document) files are not read");
  if (version != 1) fail("PSD: not a PSD file");
  Psd m{};
  m.channels = static_cast<int>(b.be16(12));
  m.h = b.be32(14);
  m.w = b.be32(18);
  const int depth = static_cast<int>(b.be16(22));
  m.mode = static_cast<int>(b.be16(24));
  if (m.mode > 9 || m.mode == 5 || m.mode == 6) {
    fail("PSD: colour mode " + std::to_string(m.mode) + " not read");
  }
  m.bits = depth == 1 && m.mode == 0;
  if (depth != 8 && !m.bits) fail("PSD: " + std::to_string(depth) + "-bit channels are not read");
  m.used = m.mode == 3 ? (m.channels == 4 ? 4 : 3) : m.mode == 4 ? 4 : m.mode == 9 ? 3 : 1;
  if (m.channels < m.used) fail("PSD: not enough channels");
  check_size("PSD", m.w, m.h);
  size_t pos = 26;
  const uint32_t cm = b.be32(pos);
  b.need(pos + 4, cm);
  if (m.mode == 2) {
    if (cm != 768) fail("PSD: indexed image without a 768-byte colour table");
    m.palette = b.p + pos + 4;
  }
  pos += 4 + size_t(cm);
  pos += 4 + size_t(b.be32(pos));  // image resources
  pos += 4 + size_t(b.be32(pos));  // layers and masks
  m.comp = static_cast<int>(b.be16(pos));
  if (m.comp != 0 && m.comp != 1) {
    fail("PSD: compression " + std::to_string(m.comp) + " not read");
  }
  m.data_at = pos + 2;
  return m;
}

// One channel's PackBits rows from `pos`, as PIL's PackbitsDecode.c reads
// them: bytes of a packet beyond its row's end are dropped, -128 is a no-op.
void psd_packbits(const Bytes& b, size_t pos, int64_t w, int64_t h, uint8_t* plane) {
  for (int64_t y = 0; y < h; ++y) {
    uint8_t* row = plane + y * w;
    int64_t x = 0;
    while (x < w) {
      const int n = b.u8(pos);
      if (n == 128) {
        ++pos;
      } else if (n > 128) {
        const int v = b.u8(pos + 1);
        const int64_t k = std::min<int64_t>(257 - n, w - x);
        std::memset(row + x, v, static_cast<size_t>(k));
        x += k;
        pos += 2;
      } else {
        b.need(pos + 1, n + 1);
        const int64_t k = std::min<int64_t>(n + 1, w - x);
        std::memcpy(row + x, b.p + pos + 1, static_cast<size_t>(k));
        x += k;
        pos += 2 + n;
      }
    }
  }
}

void psd_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Psd m = psd_header(b);
  check_out("PSD", m.w, m.h, out_w, out_h);
  const int64_t rw = m.bits ? (m.w + 7) / 8 : m.w;  // bytes a row
  const size_t plane = static_cast<size_t>(rw * m.h);
  std::vector<uint8_t> planes(plane * m.used);
  if (m.comp == 0) {
    b.need(m.data_at, plane * m.used);
    std::memcpy(planes.data(), b.p + m.data_at, plane * m.used);
  } else {
    // Byte counts of every row of every channel, then the rows.
    const size_t rows = static_cast<size_t>(m.channels) * m.h;
    b.need(m.data_at, 2 * rows);
    size_t pos = m.data_at + 2 * rows;
    for (int c = 0; c < m.used; ++c) {
      psd_packbits(b, pos, rw, m.h, planes.data() + plane * c);
      for (int64_t y = 0; y < m.h; ++y) pos += b.be16(m.data_at + 2 * (c * m.h + y));
    }
  }
  const size_t total = static_cast<size_t>(m.w * m.h);
  for (size_t i = 0; i < total; ++i) {
    uint8_t* o = out + 4 * i;
    if (m.bits) {
      const int64_t y = int64_t(i) / m.w, x = int64_t(i) % m.w;
      const int v = (planes[y * rw + (x >> 3)] >> (7 - (x & 7)) & 1) ? 255 : 0;
      put(o, v, v, v, 255);
      continue;
    }
    const int v = planes[i];
    if (m.mode == 9) {
      // PIL's L, A, B bands as stored (a and b offset by 128); its LAB
      // image's fourth byte, 0, comes through the transform as alpha.
      uint8_t rgb[3];
      tracy_image::lab_to_rgb(v, planes[plane + i], planes[2 * plane + i], rgb);
      put(o, rgb[0], rgb[1], rgb[2], 0);
    } else if (m.mode == 4) {  // "C;I" etc.: each channel inverted, then cmyk2rgb
      const int nk = planes[3 * plane + i];
      put(o, cmyk_channel(255 - v, nk), cmyk_channel(255 - planes[plane + i], nk),
          cmyk_channel(255 - planes[2 * plane + i], nk), 255);
    } else if (m.mode == 3) {
      const int a = m.used == 4 ? planes[3 * plane + i] : 255;
      put(o, v, planes[plane + i], planes[2 * plane + i], a);
    } else if (m.mode == 2) {
      put(o, m.palette[v], m.palette[256 + v], m.palette[512 + v], 255);
    } else {
      put(o, v, v, v, 255);
    }
  }
}

// ---------------------------------------------------------------- QOI

struct Qoi {
  int64_t w, h;
  bool rgba;
};

Qoi qoi_header(const Bytes& b) {
  b.need(0, 14);
  if (std::memcmp(b.p, "qoif", 4) != 0) fail("QOI: not a QOI file");
  Qoi q{b.be32(4), b.be32(8), b.u8(12) != 3};
  check_size("QOI", q.w, q.h);
  return q;
}

// As PIL's QoiDecoder: the previous pixel starts (0, 0, 0, 255), the index
// (0, 0, 0, 0); a run repeats the previous pixel and may pass the last one.
// An RGB file keeps the alpha an RGBA op sets in its state, and drops it.
void qoi_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Qoi q = qoi_header(b);
  check_out("QOI", q.w, q.h, out_w, out_h);
  uint8_t index[64][4] = {};
  uint8_t px[4] = {0, 0, 0, 255};
  const size_t n = static_cast<size_t>(q.w * q.h);
  size_t pos = 14, i = 0;
  while (i < n) {
    const int op = b.u8(pos++);
    if (op == 0xfe) {
      b.need(pos, 3);
      std::memcpy(px, b.p + pos, 3);
      pos += 3;
    } else if (op == 0xff) {
      b.need(pos, 4);
      std::memcpy(px, b.p + pos, 4);
      pos += 4;
    } else if (op >> 6 == 0) {
      std::memcpy(px, index[op & 63], 4);
    } else if (op >> 6 == 1) {
      px[0] = static_cast<uint8_t>(px[0] + ((op >> 4) & 3) - 2);
      px[1] = static_cast<uint8_t>(px[1] + ((op >> 2) & 3) - 2);
      px[2] = static_cast<uint8_t>(px[2] + (op & 3) - 2);
    } else if (op >> 6 == 2) {
      const int second = b.u8(pos++);
      const int dg = (op & 63) - 32;
      px[0] = static_cast<uint8_t>(px[0] + dg + (second >> 4) - 8);
      px[1] = static_cast<uint8_t>(px[1] + dg);
      px[2] = static_cast<uint8_t>(px[2] + dg + (second & 15) - 8);
    } else {
      const size_t run = std::min<size_t>((op & 63) + 1, n - i);
      for (size_t k = 0; k < run; ++k, ++i) {
        put(out + 4 * i, px[0], px[1], px[2], q.rgba ? px[3] : 255);
      }
      continue;
    }
    std::memcpy(index[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64], px, 4);
    put(out + 4 * i++, px[0], px[1], px[2], q.rgba ? px[3] : 255);
  }
}

}  // namespace

extern "C" {

// Width and height of a file (0, or 1 with a message when the decoder
// refuses it); then tracy_<fmt>_decode writes RGBA8 [h, w, 4] to `out`.
int tracy_tga_info(const uint8_t* data, int64_t len, int* w, int* h) {
  return info("TGA", data, len, w, h, tga_header);
}
int tracy_tga_decode(const uint8_t* data, int64_t len, uint8_t* out, int w, int h) {
  return guarded("TGA", [&] { tga_decode({data, static_cast<size_t>(len), "TGA"}, out, w, h); });
}
int tracy_bmp_info(const uint8_t* data, int64_t len, int* w, int* h) {
  return info("BMP", data, len, w, h, bmp_header);
}
int tracy_bmp_decode(const uint8_t* data, int64_t len, uint8_t* out, int w, int h) {
  return guarded("BMP", [&] { bmp_decode({data, static_cast<size_t>(len), "BMP"}, out, w, h); });
}
int tracy_gif_info(const uint8_t* data, int64_t len, int* w, int* h) {
  return info("GIF", data, len, w, h, gif_header);
}
int tracy_gif_decode(const uint8_t* data, int64_t len, uint8_t* out, int w, int h) {
  return guarded("GIF", [&] { gif_decode({data, static_cast<size_t>(len), "GIF"}, out, w, h); });
}
int tracy_pnm_info(const uint8_t* data, int64_t len, int* w, int* h) {
  return info("PNM", data, len, w, h, pnm_header);
}
int tracy_pnm_decode(const uint8_t* data, int64_t len, uint8_t* out, int w, int h) {
  return guarded("PNM", [&] { pnm_decode({data, static_cast<size_t>(len), "PNM"}, out, w, h); });
}
int tracy_psd_info(const uint8_t* data, int64_t len, int* w, int* h) {
  return info("PSD", data, len, w, h, psd_header);
}
int tracy_psd_decode(const uint8_t* data, int64_t len, uint8_t* out, int w, int h) {
  return guarded("PSD", [&] { psd_decode({data, static_cast<size_t>(len), "PSD"}, out, w, h); });
}
int tracy_qoi_info(const uint8_t* data, int64_t len, int* w, int* h) {
  return info("QOI", data, len, w, h, qoi_header);
}
int tracy_qoi_decode(const uint8_t* data, int64_t len, uint8_t* out, int w, int h) {
  return guarded("QOI", [&] { qoi_decode({data, static_cast<size_t>(len), "QOI"}, out, w, h); });
}

}  // extern "C"
