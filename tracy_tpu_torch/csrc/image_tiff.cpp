// TIFF decoding on the host, for the texture loader and read_image: the
// first image (IFD) of a file, as PIL's open(...).convert("RGBA") gives it
// (tracy_tpu reads every 8-bit texture through PIL), but where ROADMAP's
// hazards say otherwise.
//
// Built into the decoder library beside image_decode.cpp and
// image_formats.cpp (utils/native.py::get_image_lib), with their
// conventions: tracy_tiff_info (width and height) and tracy_tiff_decode
// (RGBA8 [h, w, 4]) return 0, 1 for a fault of the file, or 2 for a failure
// inside the decoder, with the message in tracy_decode_error().
//
// Read: byte orders II and MM, classic TIFF and BigTIFF; strips and tiles
// (tiles cropped at the right and bottom edges); PlanarConfiguration 1 and
// 2; compression 1 (none), 5 (LZW, MSB-first codes with the early change),
// 8 and 32946 (deflate, inflated here: the card's host has no zlib
// headers) and 32773 (PackBits); Predictor 2 at 8 and 16 bits with LZW and
// deflate (libtiff ignores it with the other two, and so does PIL);
// FillOrder 2 (the stored bytes bit-reversed, as libtiff does before
// decompressing). Pixel kinds, as PIL's OPEN_INFO table maps them:
//
// - WhiteIsZero and BlackIsZero at 1, 2, 4 and 8 bits (v * 255 / (2^b -
//   1), inverted for WhiteIsZero), and 8-bit grey + unassociated alpha;
// - RGB at 8 and 16 bits with ExtraSamples 0 (ignored), 1 (associated
//   alpha, divided out as PIL's RGBa unpackers do: c * 255 / a, clipped,
//   all zero where a is 0), 2 or 999 (unassociated alpha), a fourth sample
//   without ExtraSamples read as unassociated alpha;
// - palette at 1, 2, 4 and 8 bits, the 16-bit ColorMap reduced to its high
//   byte, 8-bit with a second sample that is alpha (ExtraSamples 2) or not
//   (0);
// - CMYK at 8 bits (with up to two unused extra samples) and 16 bits,
//   converted as PIL's cmyk2rgb: nk - nk * c / 255, rounded its way.
//
// 16-bit samples keep their high byte. For grey that is a hazard: PIL opens
// 16-bit grey as I;16 and its convert("RGBA") clips every sample above 255
// to white (and has no mode for big-endian WhiteIsZero). Other hazards,
// where PIL loses the picture and this file follows the format: big-endian
// BigTIFF (PIL reads the version from the wrong byte and fails), FillOrder
// 2 in uncompressed 1-, 2- and 4-bit palette and WhiteIsZero 8-bit files
// (PIL has no raw mode for them), and PlanarConfiguration 2 where PIL's
// band unpacking breaks (16-bit uncompressed planes, ExtraSamples 0
// planes, the alpha planes of grey and palette images, and a fourth plane
// without ExtraSamples, read here as in a chunky file).
//
// Refused by name, so the texture falls back grey: JPEG in TIFF
// (compression 6 and 7), CCITT G3/G4, SGILog, LZMA, ZSTD, WebP,
// ThunderScan and any other compression; YCbCr, CIELab and any other
// photometric; signed and float samples; 12-, 32- and other bit depths;
// the floating-point predictor; old-style LZW; kinds PIL has no mode for.

#include "image_common.h"

#include <map>

namespace {

// ---------------------------------------------------------------- IFD

struct Ifd {
  bool le = true, big = false;
  std::map<int, std::vector<uint64_t>> tags;  // integer-valued tags

  bool has(int tag) const { return tags.count(tag) != 0; }
  uint64_t get(int tag, uint64_t dflt) const {
    const auto it = tags.find(tag);
    return it == tags.end() || it->second.empty() ? dflt : it->second[0];
  }
  const std::vector<uint64_t>& list(int tag) const {
    static const std::vector<uint64_t> none;
    const auto it = tags.find(tag);
    return it == tags.end() ? none : it->second;
  }
};

uint64_t read_uint(const Bytes& b, size_t at, int size, bool le) {
  b.need(at, static_cast<size_t>(size));
  uint64_t v = 0;
  for (int i = 0; i < size; ++i) {
    const uint64_t byte = b.p[at + i];
    v |= le ? byte << (8 * i) : byte << (8 * (size - 1 - i));
  }
  return v;
}

Ifd read_ifd(const Bytes& b) {
  Ifd f;
  b.need(0, 8);
  if (b.p[0] == 'I' && b.p[1] == 'I') {
    f.le = true;
  } else if (b.p[0] == 'M' && b.p[1] == 'M') {
    f.le = false;
  } else {
    fail("TIFF: not a TIFF file");
  }
  const uint64_t version = read_uint(b, 2, 2, f.le);
  uint64_t at;
  if (version == 42) {
    at = read_uint(b, 4, 4, f.le);
  } else if (version == 43) {
    f.big = true;
    if (read_uint(b, 4, 2, f.le) != 8) fail("TIFF: BigTIFF offsets that are not 8 bytes");
    at = read_uint(b, 8, 8, f.le);
  } else {
    fail("TIFF: version " + std::to_string(version) + " not read");
  }
  const int count_size = f.big ? 8 : 2, entry = f.big ? 20 : 12, inline_size = f.big ? 8 : 4;
  const uint64_t n = read_uint(b, at, count_size, f.le);
  if (n > 4096) fail("TIFF: " + std::to_string(n) + " tags in the first IFD");
  static const int kTypeSize[19] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8, 4, 0, 0, 8, 8, 8};
  for (uint64_t i = 0; i < n; ++i) {
    const size_t e = at + count_size + i * entry;
    const int tag = static_cast<int>(read_uint(b, e, 2, f.le));
    const int type = static_cast<int>(read_uint(b, e + 2, 2, f.le));
    const uint64_t count = read_uint(b, e + 4, f.big ? 8 : 4, f.le);
    // Integer types: BYTE, SHORT, LONG, SBYTE, UNDEFINED, SSHORT, SLONG,
    // IFD, LONG8, SLONG8, IFD8. Others (ASCII, rationals, floats) are not
    // needed and skipped.
    const bool integer = type == 1 || type == 3 || type == 4 || type == 6 || type == 7 ||
                         type == 8 || type == 9 || type == 13 || type >= 16;
    if (type < 1 || type > 18 || !integer || kTypeSize[type] == 0) continue;
    const int size = kTypeSize[type];
    if (count > (uint64_t(1) << 28)) fail("TIFF: tag " + std::to_string(tag) + " is too long");
    const uint64_t bytes = count * size;
    const size_t value_at = e + 4 + (f.big ? 8 : 4);
    const size_t data_at = bytes <= static_cast<uint64_t>(inline_size)
                               ? value_at
                               : static_cast<size_t>(read_uint(b, value_at, inline_size, f.le));
    b.need(data_at, static_cast<size_t>(bytes));
    std::vector<uint64_t> vals(static_cast<size_t>(count));
    for (uint64_t k = 0; k < count; ++k) vals[k] = read_uint(b, data_at + k * size, size, f.le);
    f.tags[tag] = std::move(vals);
  }
  return f;
}

// ---------------------------------------------------------------- layout

enum Tag {
  kWidth = 256, kLength = 257, kBits = 258, kCompression = 259, kPhotometric = 262,
  kFillOrder = 266, kStripOffsets = 273, kSamples = 277, kRowsPerStrip = 278,
  kStripBytes = 279, kPlanar = 284, kPredictor = 317, kColorMap = 320, kTileWidth = 322,
  kTileLength = 323, kTileOffsets = 324, kTileBytes = 325, kExtraSamples = 338,
  kSampleFormat = 339,
};

enum Kind { kGrey, kGreyAlpha, kRgb, kPalette, kCmyk };

struct Tiff {
  int64_t w = 0, h = 0;
  bool le = true;
  int compression = 1, photometric = 0, planar = 1, predictor = 1, fillorder = 1;
  int bits = 1, spp = 1;
  Kind kind = kGrey;
  bool invert = false;   // WhiteIsZero
  int alpha = -1;        // sample index of the alpha, -1 for none
  bool assoc = false;    // associated (premultiplied) alpha
  int64_t cw = 0, ch = 0;  // chunk (tile, or strip) width and rows
  bool tiled = false;
  std::vector<uint64_t> offsets, counts;
  uint8_t palette[3 * 256] = {};
};

std::string compression_name(uint64_t c) {
  switch (c) {
    case 2: return "CCITT modified Huffman (compression 2)";
    case 3: return "CCITT Group 3 (compression 3)";
    case 4: return "CCITT Group 4 (compression 4)";
    case 6: return "old-style JPEG in TIFF (compression 6)";
    case 7: return "JPEG in TIFF (compression 7)";
    case 32809: return "ThunderScan (compression 32809)";
    case 34676: return "SGILog (compression 34676)";
    case 34677: return "SGILog24 (compression 34677)";
    case 34925: return "LZMA (compression 34925)";
    case 50000: return "ZSTD (compression 50000)";
    case 50001: return "WebP in TIFF (compression 50001)";
    default: return "compression " + std::to_string(c);
  }
}

std::string list_str(const std::vector<int>& v) {
  std::string s = "(";
  for (size_t i = 0; i < v.size(); ++i) s += (i ? ", " : "") + std::to_string(v[i]);
  return s + ")";
}

// The pixel kind of photometric / bits / samples / extra samples, as PIL's
// OPEN_INFO table has it; refused by name where PIL has no mode.
void pick_kind(Tiff& t, const std::vector<int>& extra) {
  const int b = t.bits, n = t.spp, ph = t.photometric;
  const size_t ne = extra.size();
  auto refuse = [&] {
    fail("TIFF: photometric " + std::to_string(ph) + " with " + std::to_string(n) + " " +
         std::to_string(b) + "-bit samples and extra samples " + list_str(extra) + " not read");
  };
  auto all_zero_after = [&](size_t k) {
    for (size_t i = k; i < ne; ++i)
      if (extra[i] != 0) return false;
    return true;
  };
  if (ph == 0 || ph == 1) {
    t.invert = ph == 0;
    if (n == 1 && ne == 0 && (b <= 8 || b == 16)) {
      t.kind = kGrey;
    } else if (ph == 1 && n == 2 && b == 8 && ne == 1 && extra[0] == 2) {
      t.kind = kGreyAlpha;
      t.alpha = 1;
    } else {
      refuse();
    }
  } else if (ph == 2) {
    t.kind = kRgb;
    if (b != 8 && b != 16) refuse();
    if (ne == 0) {
      if (n == 4) t.alpha = 3;
      else if (n != 3) refuse();
    } else {
      const int e0 = extra[0];
      const bool ok = n == 3 + static_cast<int>(ne) && all_zero_after(1) &&
                      (b == 8 ? ne <= 3 && (e0 == 0 || e0 == 1 || e0 == 2 || (e0 == 999 && ne == 1))
                              : ne == 1 && (e0 == 0 || e0 == 1 || e0 == 2));
      if (!ok) refuse();
      if (e0 != 0) t.alpha = 3;
      t.assoc = e0 == 1;
    }
  } else if (ph == 3) {
    t.kind = kPalette;
    if (n == 1 && ne == 0 && b <= 8) {
    } else if (n == 2 && b == 8 && ne == 1 && (extra[0] == 0 || extra[0] == 2)) {
      if (extra[0] == 2) t.alpha = 1;
    } else {
      refuse();
    }
  } else if (ph == 5) {
    t.kind = kCmyk;
    const bool ok = b == 8 ? n == 4 + static_cast<int>(ne) && ne <= 2 && all_zero_after(0)
                           : b == 16 && n == 4 && ne == 0;
    if (!ok) refuse();
  } else if (ph == 6) {
    fail("TIFF: YCbCr photometric not read");
  } else if (ph == 8 || ph == 9 || ph == 10) {
    fail("TIFF: CIELab photometric (" + std::to_string(ph) + ") not read");
  } else {
    fail("TIFF: photometric " + std::to_string(ph) + " not read");
  }
  if (t.fillorder == 2) {
    const bool ok = (t.kind == kGrey) || (t.kind == kPalette && n == 1) ||
                    (t.kind == kRgb && b == 8 && n == 3);
    if (!ok) fail("TIFF: FillOrder 2 with photometric " + std::to_string(ph) + " and " +
                  std::to_string(n) + " samples not read");
  }
}

Tiff tiff_header(const Bytes& b) {
  const Ifd f = read_ifd(b);
  Tiff t;
  t.le = f.le;
  if (!f.has(kWidth) || !f.has(kLength)) fail("TIFF: no ImageWidth or ImageLength");
  t.w = static_cast<int64_t>(std::min<uint64_t>(f.get(kWidth, 0), uint64_t(1) << 40));
  t.h = static_cast<int64_t>(std::min<uint64_t>(f.get(kLength, 0), uint64_t(1) << 40));
  check_size("TIFF", t.w, t.h);

  const uint64_t comp = f.get(kCompression, 1);
  if (comp != 1 && comp != 5 && comp != 8 && comp != 32946 && comp != 32773) {
    fail("TIFF: " + compression_name(comp) + " not read");
  }
  t.compression = static_cast<int>(comp);
  t.photometric = static_cast<int>(std::min<uint64_t>(f.get(kPhotometric, 0), 1 << 20));
  const uint64_t fill = f.get(kFillOrder, 1);
  if (fill != 1 && fill != 2) fail("TIFF: FillOrder " + std::to_string(fill) + " not read");
  t.fillorder = static_cast<int>(fill);
  const uint64_t planar = f.get(kPlanar, 1);
  if (planar != 1 && planar != 2) fail("TIFF: PlanarConfiguration " + std::to_string(planar));
  t.planar = static_cast<int>(planar);

  for (const uint64_t sf : f.list(kSampleFormat)) {
    if (sf == 2) fail("TIFF: signed integer samples (SampleFormat 2) not read");
    if (sf == 3) fail("TIFF: floating-point samples (SampleFormat 3) not read");
    if (sf != 1) fail("TIFF: SampleFormat " + std::to_string(sf) + " not read");
  }
  // PIL's rules: one BitsPerSample value stands for every sample; more
  // values than samples are cut.
  std::vector<uint64_t> bits = f.list(kBits);
  if (bits.empty()) bits.push_back(1);
  const uint64_t spp = f.get(kSamples, 1);
  if (spp < 1 || spp > 6) fail("TIFF: " + std::to_string(spp) + " samples a pixel not read");
  t.spp = static_cast<int>(spp);
  if (bits.size() > spp) bits.resize(spp);
  if (bits.size() == 1 && spp > 1) bits.assign(spp, bits[0]);
  if (bits.size() != spp) fail("TIFF: BitsPerSample does not match SamplesPerPixel");
  for (const uint64_t v : bits) {
    if (v != bits[0]) fail("TIFF: samples of different bit depths not read");
  }
  if (bits[0] != 1 && bits[0] != 2 && bits[0] != 4 && bits[0] != 8 && bits[0] != 16) {
    fail("TIFF: " + std::to_string(bits[0]) + "-bit samples not read");
  }
  t.bits = static_cast<int>(bits[0]);
  std::vector<int> extra;
  for (const uint64_t e : f.list(kExtraSamples)) extra.push_back(static_cast<int>(std::min<uint64_t>(e, 1 << 20)));
  pick_kind(t, extra);

  const uint64_t pred = f.get(kPredictor, 1);
  if (t.compression == 5 || t.compression == 8 || t.compression == 32946) {
    if (pred == 3) fail("TIFF: floating-point predictor (Predictor 3) not read");
    if (pred != 1 && pred != 2) fail("TIFF: Predictor " + std::to_string(pred) + " not read");
    if (pred == 2 && t.bits != 8 && t.bits != 16) {
      fail("TIFF: Predictor 2 with " + std::to_string(t.bits) + "-bit samples not read");
    }
    t.predictor = static_cast<int>(pred);
  }

  if (t.kind == kPalette) {
    const std::vector<uint64_t>& map = f.list(kColorMap);
    const size_t entries = size_t(1) << t.bits;
    if (map.size() != 3 * entries) fail("TIFF: palette image without a full ColorMap");
    for (int c = 0; c < 3; ++c) {
      for (size_t i = 0; i < entries; ++i) {
        t.palette[256 * c + i] = static_cast<uint8_t>((map[c * entries + i] & 0xffff) >> 8);
      }
    }
  }

  t.tiled = f.has(kTileOffsets);
  if (t.tiled) {
    t.cw = static_cast<int64_t>(f.get(kTileWidth, 0));
    t.ch = static_cast<int64_t>(f.get(kTileLength, 0));
    if (t.cw <= 0 || t.ch <= 0 || t.cw > (1 << 20) || t.ch > (1 << 20) || t.cw * t.ch > kMaxPixels) {
      fail("TIFF: tiles of " + std::to_string(t.cw) + "x" + std::to_string(t.ch) + " not read");
    }
    t.offsets = f.list(kTileOffsets);
    t.counts = f.list(kTileBytes);
  } else {
    if (!f.has(kStripOffsets)) fail("TIFF: no StripOffsets or TileOffsets");
    t.cw = t.w;
    const uint64_t rps = f.get(kRowsPerStrip, static_cast<uint64_t>(t.h));
    t.ch = rps == 0 || rps > static_cast<uint64_t>(t.h) ? t.h : static_cast<int64_t>(rps);
    t.offsets = f.list(kStripOffsets);
    t.counts = f.list(kStripBytes);
  }
  const int64_t per_plane = ((t.w + t.cw - 1) / t.cw) * ((t.h + t.ch - 1) / t.ch);
  const int64_t chunks = per_plane * (t.planar == 2 ? t.spp : 1);
  if (static_cast<int64_t>(t.offsets.size()) < chunks) {
    fail("TIFF: " + std::to_string(t.offsets.size()) + " strip or tile offsets for " +
         std::to_string(chunks) + " chunks");
  }
  if (!t.counts.empty() && static_cast<int64_t>(t.counts.size()) < chunks) {
    fail("TIFF: fewer byte counts than strips or tiles");
  }
  return t;
}

// ---------------------------------------------------------------- codecs

// LZW as libtiff decodes it: 9- to 12-bit codes, MSB first, the width
// growing one code early; clear 256, end 257.
void lzw_decode(const uint8_t* p, size_t n, uint8_t* out, size_t want) {
  if (n >= 2 && p[0] == 0 && (p[1] & 1)) fail("TIFF: old-style LZW not read");
  static thread_local std::vector<uint16_t> prefix(4096);
  static thread_local std::vector<uint8_t> suffix(4096), first(4096);
  static thread_local std::vector<uint16_t> length(4096);
  for (int i = 0; i < 256; ++i) {
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  size_t pos = 0, o = 0;
  uint32_t acc = 0;
  int have = 0, nbits = 9, free = 258, old = -1;
  auto next = [&]() -> int {
    while (have < nbits) {
      if (pos >= n) fail("TIFF: LZW data ends early");
      acc = (acc << 8) | p[pos++];
      have += 8;
    }
    have -= nbits;
    return static_cast<int>((acc >> have) & ((1u << nbits) - 1));
  };
  auto emit = [&](int code) {
    const size_t len = length[code];
    if (o + len <= want) {
      for (size_t i = len; i-- > 0;) {
        out[o + i] = suffix[code];
        code = prefix[code];
      }
      o += len;
    } else {  // the chunk ends inside this string: keep its head
      std::vector<uint8_t> s(len);
      for (size_t i = len; i-- > 0;) {
        s[i] = suffix[code];
        code = prefix[code];
      }
      std::memcpy(out + o, s.data(), want - o);
      o = want;
    }
  };
  while (o < want) {
    int code = next();
    if (code == 256) {
      free = 258;
      nbits = 9;
      do code = next();
      while (code == 256);  // clear codes in a row, as libtiff reads them
      if (code == 257) break;
      if (code > 256) fail("TIFF: LZW code after a clear is not a byte");
      emit(code);
      old = code;
      continue;
    }
    if (code == 257) break;
    if (old < 0) fail("TIFF: LZW data does not start with a clear code");
    if (free >= 4096) fail("TIFF: LZW table overflows");
    if (code < free) {
      prefix[free] = static_cast<uint16_t>(old);
      suffix[free] = first[code];
    } else if (code == free) {
      prefix[free] = static_cast<uint16_t>(old);
      suffix[free] = first[old];
    } else {
      fail("TIFF: bad LZW code");
    }
    first[free] = first[old];
    length[free] = static_cast<uint16_t>(length[old] + 1);
    ++free;
    if (free > (1 << nbits) - 2 && nbits < 12) ++nbits;
    emit(code);
    old = code;
  }
  if (o < want) fail("TIFF: LZW data ends early");
}

void packbits_decode(const uint8_t* p, size_t n, uint8_t* out, size_t want) {
  size_t pos = 0, o = 0;
  while (o < want) {
    if (pos >= n) fail("TIFF: PackBits data ends early");
    const int c = static_cast<int8_t>(p[pos++]);
    if (c >= 0) {
      const size_t k = static_cast<size_t>(c) + 1;
      if (pos + k > n) fail("TIFF: PackBits data ends early");
      const size_t m = std::min(k, want - o);
      std::memcpy(out + o, p + pos, m);
      o += m;
      pos += k;
    } else if (c != -128) {
      if (pos >= n) fail("TIFF: PackBits data ends early");
      const size_t m = std::min(static_cast<size_t>(1 - c), want - o);
      std::memset(out + o, p[pos++], m);
      o += m;
    }
  }
}

// The bit reader of a raw deflate stream (RFC 1951); `fmt` names the format
// in errors.
struct Inflate {
  const uint8_t* p;
  size_t n;
  const char* fmt;
  size_t pos = 0;
  uint64_t acc = 0;
  int have = 0;

  [[noreturn]] void error(const char* what) const { fail(std::string(fmt) + ": " + what); }
  void fill(int k) {
    while (have < k) {
      if (pos >= n) error("deflate data ends early");
      acc |= uint64_t(p[pos++]) << have;
      have += 8;
    }
  }
  uint32_t bits(int k) {
    if (k == 0) return 0;
    fill(k);
    const uint32_t v = static_cast<uint32_t>(acc & ((uint64_t(1) << k) - 1));
    acc >>= k;
    have -= k;
    return v;
  }
  // Up to k bits without consuming them, zeros past the end of the data.
  uint32_t peek(int k) {
    while (have < k && pos < n) {
      acc |= uint64_t(p[pos++]) << have;
      have += 8;
    }
    return static_cast<uint32_t>(acc & ((uint64_t(1) << k) - 1));
  }
  void drop(int k) {
    if (k > have) error("deflate data ends early");
    acc >>= k;
    have -= k;
  }
};

constexpr int kFast = 10;

struct Huffman {
  uint16_t count[16] = {};
  uint16_t symbol[320] = {};
  uint16_t fast[1 << kFast] = {};  // symbol << 4 | length, 0 when longer

  void build(const uint8_t* lengths, int n, const Inflate& in) {
    std::memset(count, 0, sizeof(count));
    for (int i = 0; i < n; ++i) ++count[lengths[i]];
    count[0] = 0;
    int left = 1;
    for (int len = 1; len < 16; ++len) {
      left = 2 * left - count[len];
      if (left < 0) in.error("deflate code lengths are over-subscribed");
    }
    uint16_t offs[16] = {};
    for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + count[len];
    for (int i = 0; i < n; ++i)
      if (lengths[i]) symbol[offs[lengths[i]]++] = static_cast<uint16_t>(i);
    std::memset(fast, 0, sizeof(fast));
    int code = 0, index = 0;
    for (int len = 1; len <= kFast; ++len) {
      for (int k = 0; k < count[len]; ++k, ++code, ++index) {
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int fill = rev; fill < (1 << kFast); fill += 1 << len) {
          fast[fill] = static_cast<uint16_t>(symbol[index] << 4 | len);
        }
      }
      code <<= 1;
    }
  }

  int decode(Inflate& in) const {
    const uint16_t f = fast[in.peek(kFast)];
    if (f) {
      in.drop(f & 15);
      return f >> 4;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len < 16; ++len) {
      code |= static_cast<int>(in.bits(1));
      const int c = count[len];
      if (code - c < first) return symbol[index + (code - first)];
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    in.error("bad deflate code");
  }
};

}  // namespace

namespace tracy_image {

size_t inflate(const uint8_t* p, size_t n, std::vector<uint8_t>& out, size_t want,
               const char* fmt) {
  static const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,
                                        15, 17, 19, 23, 27, 31, 35, 43, 51,  59,
                                        67, 83, 99, 115, 131, 163, 195, 227, 258};
  static const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                        2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
  static const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,
                                         17,   25,   33,   49,   65,   97,    129,   193,
                                         257,  385,  513,  769,  1025, 1537,  2049,  3073,
                                         4097, 6145, 8193, 12289, 16385, 24577};
  static const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                         6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
  Inflate in{p, n, fmt};
  Huffman lit, dist;
  const size_t base = out.size();
  bool last = false;
  // Bytes of p consumed: to the byte that holds the last bit read.
  const auto used = [&in] { return in.pos - static_cast<size_t>(in.have / 8); };
  while (out.size() - base < want) {
    if (last) return used();
    last = in.bits(1) != 0;
    const uint32_t type = in.bits(2);
    if (type == 0) {
      in.acc >>= in.have & 7;  // to a byte boundary
      in.have -= in.have & 7;
      const uint32_t len = in.bits(16), nlen = in.bits(16);
      if ((len ^ 0xffff) != nlen) in.error("bad stored deflate block");
      for (uint32_t i = 0; i < len; ++i) {
        const uint8_t v = static_cast<uint8_t>(in.bits(8));
        if (out.size() - base < want) out.push_back(v);
      }
      continue;
    }
    if (type == 3) in.error("bad deflate block type");
    uint8_t lengths[320];
    if (type == 1) {
      int i = 0;
      for (; i < 144; ++i) lengths[i] = 8;
      for (; i < 256; ++i) lengths[i] = 9;
      for (; i < 280; ++i) lengths[i] = 7;
      for (; i < 288; ++i) lengths[i] = 8;
      lit.build(lengths, 288, in);
      for (i = 0; i < 30; ++i) lengths[i] = 5;
      dist.build(lengths, 30, in);
    } else {
      static const uint8_t kOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                         11, 4, 12, 3, 13, 2, 14, 1, 15};
      const int nlit = static_cast<int>(in.bits(5)) + 257;
      const int ndist = static_cast<int>(in.bits(5)) + 1;
      const int ncode = static_cast<int>(in.bits(4)) + 4;
      if (nlit > 286 || ndist > 30) in.error("bad deflate code counts");
      uint8_t cl[19] = {};
      for (int i = 0; i < ncode; ++i) cl[kOrder[i]] = static_cast<uint8_t>(in.bits(3));
      Huffman code;
      code.build(cl, 19, in);
      int i = 0;
      while (i < nlit + ndist) {
        const int sym = code.decode(in);
        if (sym < 16) {
          lengths[i++] = static_cast<uint8_t>(sym);
          continue;
        }
        int rep = 0;
        uint8_t v = 0;
        if (sym == 16) {
          if (i == 0) in.error("bad deflate code lengths");
          v = lengths[i - 1];
          rep = 3 + static_cast<int>(in.bits(2));
        } else if (sym == 17) {
          rep = 3 + static_cast<int>(in.bits(3));
        } else {
          rep = 11 + static_cast<int>(in.bits(7));
        }
        if (i + rep > nlit + ndist) in.error("bad deflate code lengths");
        while (rep--) lengths[i++] = v;
      }
      lit.build(lengths, nlit, in);
      dist.build(lengths + nlit, ndist, in);
    }
    for (;;) {
      const int sym = lit.decode(in);
      if (sym < 256) {
        out.push_back(static_cast<uint8_t>(sym));
        if (out.size() - base == want) return used();
        continue;
      }
      if (sym == 256) break;
      const int li = sym - 257;
      if (li >= 29) in.error("bad deflate length code");
      const size_t len = kLenBase[li] + in.bits(kLenExtra[li]);
      const int di = dist.decode(in);
      if (di >= 30) in.error("bad deflate distance code");
      const size_t d = kDistBase[di] + in.bits(kDistExtra[di]);
      if (d > out.size() - base) in.error("deflate distance before the start of the chunk");
      const size_t m = std::min(len, want - (out.size() - base));
      for (size_t k = 0; k < m; ++k) out.push_back(out[out.size() - d]);
      if (out.size() - base == want) return used();
    }
  }
  return used();
}

}  // namespace tracy_image

namespace {

// Inflate (RFC 1950/1951) of a zlib stream, until `want` bytes are out, as
// libtiff's ZIPDecode stops (the Adler-32 after them is not read).
void inflate_decode(const uint8_t* p, size_t n, uint8_t* out, size_t want) {
  if (n < 2 || (p[0] & 15) != 8 || ((p[0] << 8) | p[1]) % 31 != 0 || (p[1] & 0x20)) {
    fail("TIFF: deflate data without a zlib header");
  }
  std::vector<uint8_t> v;
  v.reserve(want);
  tracy_image::inflate(p + 2, n - 2, v, want, "TIFF");
  if (v.size() < want) fail("TIFF: deflate data ends early");
  std::memcpy(out, v.data(), want);
}

// ---------------------------------------------------------------- pixels

uint8_t reverse_bits(uint8_t v) {
  v = static_cast<uint8_t>((v & 0xf0) >> 4 | (v & 0x0f) << 4);
  v = static_cast<uint8_t>((v & 0xcc) >> 2 | (v & 0x33) << 2);
  return static_cast<uint8_t>((v & 0xaa) >> 1 | (v & 0x55) << 1);
}

// One strip or tile, decompressed and un-predicted: `rows` rows of
// `row_bytes` bytes.
std::vector<uint8_t> read_chunk(const Bytes& b, const Tiff& t, size_t k, int64_t cols,
                                int64_t rows, int samples, size_t row_bytes) {
  const size_t want = row_bytes * static_cast<size_t>(rows);
  const size_t at = static_cast<size_t>(std::min<uint64_t>(t.offsets[k], b.n + 1));
  size_t len;
  if (t.compression == 1) {
    len = want;  // PIL reads the rows from the offset, whatever the count
  } else {
    len = t.counts.empty() ? (at <= b.n ? b.n - at : 0)
                           : static_cast<size_t>(std::min<uint64_t>(t.counts[k], b.n + 1));
  }
  b.need(at, len);
  std::vector<uint8_t> src;
  const uint8_t* p = b.p + at;
  if (t.fillorder == 2) {
    src.assign(p, p + len);
    for (uint8_t& v : src) v = reverse_bits(v);
    p = src.data();
  }
  std::vector<uint8_t> out(want);
  switch (t.compression) {
    case 1: std::memcpy(out.data(), p, want); break;
    case 5: lzw_decode(p, len, out.data(), want); break;
    case 32773: packbits_decode(p, len, out.data(), want); break;
    default: inflate_decode(p, len, out.data(), want); break;
  }
  if (t.predictor == 2) {
    const int64_t stride = samples;
    for (int64_t y = 0; y < rows; ++y) {
      uint8_t* row = out.data() + y * row_bytes;
      if (t.bits == 8) {
        for (int64_t i = stride; i < cols * stride; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
      } else {
        const int lo = t.le ? 0 : 1, hi = 1 - lo;
        for (int64_t i = stride; i < cols * stride; ++i) {
          uint8_t* c = row + 2 * i;
          const uint8_t* q = row + 2 * (i - stride);
          const unsigned v = (c[lo] | c[hi] << 8) + (q[lo] | q[hi] << 8);
          c[lo] = static_cast<uint8_t>(v);
          c[hi] = static_cast<uint8_t>(v >> 8);
        }
      }
    }
  }
  return out;
}

Tiff tiff_decode_samples(const Bytes& b, std::vector<uint8_t>& samples) {
  const Tiff t = tiff_header(b);
  const int planes = t.planar == 2 ? t.spp : 1;
  const int per = t.planar == 2 ? 1 : t.spp;  // samples in a chunk's pixel
  const int64_t across = (t.w + t.cw - 1) / t.cw, down = (t.h + t.ch - 1) / t.ch;
  const size_t row_bytes = static_cast<size_t>((t.cw * per * t.bits + 7) / 8);
  // 8 bits a sample: the value (bits < 8), the byte (8) or the high byte (16).
  samples.assign(static_cast<size_t>(t.w * t.h * t.spp), 0);
  const int hi = t.le ? 1 : 0;
  const unsigned mask = (1u << std::min(t.bits, 8)) - 1;
  size_t k = 0;
  for (int plane = 0; plane < planes; ++plane) {
    for (int64_t ty = 0; ty < down; ++ty) {
      for (int64_t tx = 0; tx < across; ++tx, ++k) {
        const int64_t y0 = ty * t.ch, x0 = tx * t.cw;
        // A strip's last rows may be missing; a compressed tile is always
        // whole. PIL reads the visible rows of an uncompressed one only.
        const int64_t vis_rows = std::min(t.ch, t.h - y0);
        const int64_t rows = t.tiled && t.compression != 1 ? t.ch : vis_rows;
        const std::vector<uint8_t> chunk = read_chunk(b, t, k, t.cw, rows, per, row_bytes);
        const int64_t vis_w = std::min(t.cw, t.w - x0), vis_h = vis_rows;
        for (int64_t y = 0; y < vis_h; ++y) {
          const uint8_t* row = chunk.data() + y * row_bytes;
          uint8_t* dst = samples.data() + ((y0 + y) * t.w + x0) * t.spp + plane;
          for (int64_t x = 0; x < vis_w; ++x) {
            for (int s = 0; s < per; ++s) {
              const int64_t i = x * per + s;
              uint8_t v;
              if (t.bits == 8) {
                v = row[i];
              } else if (t.bits == 16) {
                v = row[2 * i + hi];
              } else {
                const int64_t bit = i * t.bits;
                v = static_cast<uint8_t>((row[bit >> 3] >> (8 - t.bits - (bit & 7))) & mask);
              }
              dst[x * t.spp + s] = v;
            }
          }
        }
      }
    }
  }
  return t;
}

inline int clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

void tiff_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  std::vector<uint8_t> s;
  const Tiff t = tiff_decode_samples(b, s);
  check_out("TIFF", t.w, t.h, out_w, out_h);
  const size_t n = static_cast<size_t>(t.w * t.h);
  const int scale = t.bits < 8 ? 255 / ((1 << t.bits) - 1) : 1;
  for (size_t i = 0; i < n; ++i) {
    const uint8_t* v = s.data() + i * t.spp;
    uint8_t* o = out + 4 * i;
    const int a = t.alpha >= 0 ? v[t.alpha] : 255;
    switch (t.kind) {
      case kGrey:
      case kGreyAlpha: {
        const int g = t.invert ? 255 - v[0] * scale : v[0] * scale;
        put(o, g, g, g, a);
        break;
      }
      case kPalette:
        put(o, t.palette[v[0]], t.palette[256 + v[0]], t.palette[512 + v[0]], a);
        break;
      case kRgb:
        if (!t.assoc || a == 255) {
          put(o, v[0], v[1], v[2], a);
        } else if (a == 0) {
          put(o, 0, 0, 0, 0);
        } else {
          put(o, clip8(v[0] * 255 / a), clip8(v[1] * 255 / a), clip8(v[2] * 255 / a), a);
        }
        break;
      case kCmyk: {
        const int nk = 255 - v[3];
        put(o, cmyk_channel(v[0], nk), cmyk_channel(v[1], nk), cmyk_channel(v[2], nk), 255);
        break;
      }
    }
  }
}

}  // namespace

extern "C" {

// Width and height of the first image (0, or 1 with a message when the
// decoder refuses it); then tracy_tiff_decode writes RGBA8 [h, w, 4].
int tracy_tiff_info(const uint8_t* data, int64_t len, int* w, int* h) {
  return info("TIFF", data, len, w, h, tiff_header);
}
int tracy_tiff_decode(const uint8_t* data, int64_t len, uint8_t* out, int w, int h) {
  return guarded([&] { tiff_decode({data, static_cast<size_t>(len), "TIFF"}, out, w, h); });
}

}  // extern "C"
