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
// headers), 32773 (PackBits), 2, 3 and 4 (CCITT modified Huffman, Group 3
// 1-D and 2-D with T4Options, Group 4), 7 (JPEG: the JPEGTables stream and
// each chunk's datastream through image_decode.cpp's libjpeg-exact
// decoder, YCbCr to RGB where libtiff asks libjpeg for it, other
// components as they are), 34925 (LZMA: an xz stream, image_xz.cpp), 50000
// (ZSTD, image_zstd.cpp) and 32809 (ThunderScan's 4-bit coding); Predictor 2 at
// 8, 16 and 32 bits and Predictor 3 (floating point) with LZW, deflate,
// LZMA and ZSTD (libtiff ignores predictors with the others, and so does
// PIL); FillOrder 2 (the stored bytes bit-reversed, as libtiff does before
// decompressing). Pixel kinds, as PIL's OPEN_INFO table maps them:
//
// - WhiteIsZero and BlackIsZero at 1, 2, 4 and 8 bits (v * 255 / (2^b -
//   1), inverted for WhiteIsZero), and 8-bit grey + unassociated alpha;
//   signed bytes read unsigned (PIL's L);
// - PIL's mode I (12-bit and little-endian 32-bit unsigned grey, signed 16-
//   and 32-bit grey) clipped to 0..255, and mode F (32-bit floats, of
//   either photometric) truncated and clipped, as PIL's convert takes them;
// - RGB at 8 and 16 bits with ExtraSamples 0 (ignored), 1 (associated
//   alpha, divided out as PIL's RGBa unpackers do: c * 255 / a, clipped,
//   all zero where a is 0), 2 or 999 (unassociated alpha), a fourth sample
//   without ExtraSamples read as unassociated alpha;
// - YCbCr of three 8-bit samples: JPEG's through libjpeg's YCbCr -> RGB,
//   the others through libtiff's RGBA interface (TIFFYCbCrtoRGB's integer
//   tables from YCbCrCoefficients and ReferenceBlackWhite, each
//   subsampling block's chroma for all its pixels);
// - palette at 1, 2, 4 and 8 bits, the 16-bit ColorMap reduced to its high
//   byte, 8-bit with a second sample that is alpha (ExtraSamples 2) or not
//   (0);
// - CMYK at 8 bits (with up to two unused extra samples) and 16 bits,
//   converted as PIL's cmyk2rgb: nk - nk * c / 255, rounded its way;
// - CIELab at 8 bits, through PIL's LittleCMS transform to sRGB (PIL's
//   planar reader skips the signed samples' offset: read here as chunky).
//
// 16-bit samples keep their high byte. For grey that is a hazard: PIL opens
// 16-bit grey as I;16 and its convert("RGBA") clips every sample above 255
// to white (and has no mode for big-endian WhiteIsZero). Other hazards,
// where PIL loses the picture and this file follows the format: big-endian
// BigTIFF (PIL reads the version from the wrong byte and fails), FillOrder
// 2 in uncompressed 1-, 2- and 4-bit palette and WhiteIsZero 8-bit files
// (PIL has no raw mode for them), PlanarConfiguration 2 where PIL's band
// unpacking breaks (16-bit uncompressed planes, ExtraSamples 0 planes, the
// alpha planes of grey and palette images, and a fourth plane without
// ExtraSamples, read here as in a chunky file), compressed big-endian
// signed and float samples (libtiff hands PIL native-order samples, which
// PIL unpacks as big-endian), and uncompressed YCbCr (PIL unpacks it as
// RGBX; here libtiff's RGBA interface reads it as it does compressed).
//
// Refused by name, so the texture falls back grey: SGILog (PIL has no mode
// for LogLuv), WebP (Pillow's libtiff has no WebP codec) and any other
// compression; ICCLab, ITULab and any other photometric; kinds PIL has no
// mode for; old-style LZW.

#include "image_common.h"

#include <cstdio>
#include <map>

namespace {

// ---------------------------------------------------------------- IFD

struct Ifd {
  bool le = true, big = false;
  std::map<int, std::vector<uint64_t>> tags;  // integer-valued tags
  std::map<int, std::vector<double>> reals;   // rational and floating-point tags

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
    const bool real = type == 5 || type == 10 || type == 11 || type == 12;
    if (type < 1 || type > 18 || !(integer || real) || kTypeSize[type] == 0) continue;
    const int size = kTypeSize[type];
    if (count > (uint64_t(1) << 28)) fail("TIFF: tag " + std::to_string(tag) + " is too long");
    const uint64_t bytes = count * size;
    const size_t value_at = e + 4 + (f.big ? 8 : 4);
    const size_t data_at = bytes <= static_cast<uint64_t>(inline_size)
                               ? value_at
                               : static_cast<size_t>(read_uint(b, value_at, inline_size, f.le));
    b.need(data_at, static_cast<size_t>(bytes));
    if (real) {
      std::vector<double> vals(static_cast<size_t>(count));
      for (uint64_t k = 0; k < count; ++k) {
        const size_t at = data_at + k * size;
        if (type == 11) {
          vals[k] = tracy_image::f32(static_cast<uint32_t>(read_uint(b, at, 4, f.le)));
        } else if (type == 12) {
          const uint64_t u = read_uint(b, at, 8, f.le);
          double d;
          std::memcpy(&d, &u, 8);
          vals[k] = d;
        } else {
          const uint32_t num = static_cast<uint32_t>(read_uint(b, at, 4, f.le));
          const uint32_t den = static_cast<uint32_t>(read_uint(b, at + 4, 4, f.le));
          const double n = type == 10 ? double(int32_t(num)) : double(num);
          const double d = type == 10 ? double(int32_t(den)) : double(den);
          vals[k] = d == 0 ? 0.0 : n / d;
        }
      }
      f.reals[tag] = std::move(vals);
      continue;
    }
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
  kStripBytes = 279, kPlanar = 284, kT4Options = 292, kT6Options = 293, kPredictor = 317,
  kColorMap = 320, kTileWidth = 322, kTileLength = 323, kTileOffsets = 324, kTileBytes = 325,
  kExtraSamples = 338, kSampleFormat = 339, kJpegTables = 347, kJpegInterchange = 513,
  kJpegInterchangeLength = 514, kYcbcrCoefficients = 529,
  kYcbcrSubsampling = 530, kReferenceBlackWhite = 532,
};

// kValue: one sample of PIL's mode I or F (or L of signed bytes), taken to
// 8 bits as PIL converts the mode.
enum Kind { kGrey, kGreyAlpha, kRgb, kPalette, kCmyk, kValue, kLab };

struct Tiff {
  int64_t w = 0, h = 0;
  bool le = true;
  int compression = 1, photometric = 0, planar = 1, predictor = 1, fillorder = 1;
  int bits = 1, spp = 1, format = 1;  // format: SampleFormat (1 unsigned, 2 signed, 3 float)
  Kind kind = kGrey;
  bool invert = false;   // WhiteIsZero
  int alpha = -1;        // sample index of the alpha, -1 for none
  bool assoc = false;    // associated (premultiplied) alpha
  int64_t cw = 0, ch = 0;  // chunk (tile, or strip) width and rows
  bool tiled = false;
  std::vector<uint64_t> offsets, counts;
  uint8_t palette[3 * 256] = {};
  // YCbCr through libtiff's RGBA interface (not JPEG): subsampling and the
  // conversion's constants, as TIFFYCbCrToRGBInit takes them.
  bool ycbcr = false;
  int sub_h = 2, sub_v = 2;
  float luma[3] = {0.299f, 0.587f, 0.114f};
  float refbw[6] = {0, 255, 128, 255, 128, 255};
  // JPEG: the JPEGTables stream; YCbCr to RGB in libjpeg (JPEGCOLORMODE_RGB).
  std::vector<uint8_t> jpeg_tables;
  bool jpeg_rgb = false;
  // Old-style JPEG: the JPEGInterchangeFormat stream, the whole image.
  uint64_t jif_at = 0, jif_len = 0;
  uint32_t t4 = 0, t6 = 0;  // T4Options, T6Options
};

std::string compression_name(uint64_t c) {
  switch (c) {
    case 34676: return "SGILog (compression 34676)";
    case 34677: return "SGILog24 (compression 34677)";
    case 50001: return "WebP in TIFF (compression 50001; Pillow's libtiff has no WebP codec)";
    default: return "compression " + std::to_string(c);
  }
}

std::string list_str(const std::vector<int>& v) {
  std::string s = "(";
  for (size_t i = 0; i < v.size(); ++i) s += (i ? ", " : "") + std::to_string(v[i]);
  return s + ")";
}

// The pixel kind of photometric / sample format / bits / samples / extra
// samples, as PIL's OPEN_INFO table has it; refused by name where PIL has no
// mode.
void pick_kind(Tiff& t, const std::vector<int>& extra) {
  const int b = t.bits, n = t.spp, ph = t.photometric, fm = t.format;
  const size_t ne = extra.size();
  auto refuse = [&] {
    fail("TIFF: photometric " + std::to_string(ph) + " with " + std::to_string(n) + " " +
         std::to_string(b) + "-bit samples" + (fm == 1 ? "" : " of SampleFormat " +
         std::to_string(fm)) + " and extra samples " + list_str(extra) + " not read");
  };
  auto all_zero_after = [&](size_t k) {
    for (size_t i = k; i < ne; ++i)
      if (extra[i] != 0) return false;
    return true;
  };
  if (fm != 1) {
    // Signed bytes read as L (PIL takes them unsigned); signed 16- and
    // 32-bit samples as I; floats as F, WhiteIsZero too.
    if (n != 1 || ne != 0) refuse();
    if (fm == 3 && b == 32 && (ph == 0 || ph == 1)) t.kind = kValue;
    else if (fm == 2 && ph == 1 && b == 8) t.kind = kGrey;
    else if (fm == 2 && ph == 1 && (b == 16 || b == 32)) t.kind = kValue;
    else refuse();
  } else if (ph == 0 || ph == 1) {
    t.invert = ph == 0;
    if (n == 1 && ne == 0 && (b <= 8 || b == 16)) {
      t.kind = kGrey;
    } else if (n == 1 && ne == 0 && ph == 1 && (b == 12 || b == 32) && t.le) {
      t.kind = kValue;  // PIL's I;12 and I;32N: little-endian files only
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
    // Three 8-bit samples, which PIL has libtiff turn into RGB: libjpeg for
    // JPEG, else libtiff's RGBA interface. (PIL's own raw reader takes an
    // uncompressed file for RGBX: read here as libtiff reads it.)
    if (n != 3 || b != 8 || ne != 0) refuse();
    if (t.planar != 1) fail("TIFF: YCbCr in separate planes not read");
    t.kind = kRgb;
    if (t.compression == 7) t.jpeg_rgb = true;
    else if (t.compression != 6) t.ycbcr = true;
  } else if (ph == 8) {
    // PIL's LAB: three 8-bit samples, a and b signed (its unpacker offsets
    // them by 128), converted through LittleCMS (`tracy_image::lab_to_rgb`).
    if (n != 3 || b != 8 || ne != 0) refuse();
    t.kind = kLab;
  } else if (ph == 9 || ph == 10) {
    fail("TIFF: photometric " + std::to_string(ph) + " not read (PIL has no mode for it)");
  } else {
    fail("TIFF: photometric " + std::to_string(ph) + " not read");
  }
  if (t.fillorder == 2) {
    const bool ok = (t.kind == kGrey) || (t.kind == kPalette && n == 1) ||
                    (t.kind == kRgb && b == 8 && n == 3 && !t.ycbcr && !t.jpeg_rgb);
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
  static const uint64_t kRead[] = {1, 2, 3, 4, 5, 6, 7, 8, 32773, 32809, 32946, 34925, 50000};
  if (std::find(std::begin(kRead), std::end(kRead), comp) == std::end(kRead)) {
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

  // PIL's rule: several SampleFormat values that agree stand for one.
  const std::vector<uint64_t>& formats = f.list(kSampleFormat);
  for (const uint64_t sf : formats) {
    if (sf != formats[0]) fail("TIFF: samples of different SampleFormats not read");
    if (sf < 1 || sf > 3) fail("TIFF: SampleFormat " + std::to_string(sf) + " not read");
  }
  t.format = formats.empty() ? 1 : static_cast<int>(formats[0]);
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
  if (bits[0] != 1 && bits[0] != 2 && bits[0] != 4 && bits[0] != 8 && bits[0] != 12 &&
      bits[0] != 16 && bits[0] != 32) {
    fail("TIFF: " + std::to_string(bits[0]) + "-bit samples not read");
  }
  t.bits = static_cast<int>(bits[0]);
  std::vector<int> extra;
  for (const uint64_t e : f.list(kExtraSamples)) extra.push_back(static_cast<int>(std::min<uint64_t>(e, 1 << 20)));
  pick_kind(t, extra);
  const int c = t.compression;
  if ((c >= 2 && c <= 4) && !(t.bits == 1 && t.spp == 1 && (t.kind == kGrey || t.kind == kPalette)))
    fail("TIFF: CCITT compression of " + std::to_string(t.spp) + " " + std::to_string(t.bits) +
         "-bit samples not read");
  if (c == 32809 && !(t.bits == 4 && t.spp == 1))
    fail("TIFF: ThunderScan compression of other than one 4-bit sample not read");
  if (c == 6) {
    // Old-style JPEG as libtiff's RGBA interface reads it for PIL: the
    // JPEGInterchangeFormat stream's YCbCr, chroma per block.
    if (!f.has(kJpegInterchange) || !f.has(kJpegInterchangeLength))
      fail("TIFF: old-style JPEG without JPEGInterchangeFormat not read");
    if (t.kind != kRgb || t.spp != 3 || t.bits != 8 || t.planar != 1 || t.alpha >= 0)
      fail("TIFF: old-style JPEG of other than three 8-bit samples not read");
    t.jif_at = f.get(kJpegInterchange, 0);
    t.jif_len = f.get(kJpegInterchangeLength, 0);
    t.ycbcr = false;
  }
  if (c == 7 && (t.bits != 8 || (t.planar != 1 && t.spp > 1)))
    fail("TIFF: JPEG compression of " + std::to_string(t.bits) + "-bit or planar samples not read");
  t.t4 = static_cast<uint32_t>(f.get(kT4Options, 0));
  t.t6 = static_cast<uint32_t>(f.get(kT6Options, 0));
  if (c == 3 && (t.t4 & 2)) fail("TIFF: CCITT Group 3 uncompressed mode not read");
  if (c == 4 && (t.t6 & 2)) fail("TIFF: CCITT Group 4 uncompressed mode not read");

  // libtiff's predictors: with LZW, deflate, LZMA and ZSTD; horizontal
  // differencing at 8, 16 and 32 bits, the floating-point one on floats.
  const uint64_t pred = f.get(kPredictor, 1);
  if (c == 5 || c == 8 || c == 32946 || c == 34925 || c == 50000) {
    if (pred == 3) {
      if (t.format != 3) fail("TIFF: floating-point predictor on integer samples not read");
    } else if (pred == 2) {
      if (t.bits != 8 && t.bits != 16 && t.bits != 32)
        fail("TIFF: Predictor 2 with " + std::to_string(t.bits) + "-bit samples not read");
    } else if (pred != 1) {
      fail("TIFF: Predictor " + std::to_string(pred) + " not read");
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
  if (t.ycbcr || c == 6) {
    const std::vector<uint64_t>& sub = f.list(kYcbcrSubsampling);
    if (sub.size() >= 2) t.sub_h = static_cast<int>(sub[0]), t.sub_v = static_cast<int>(sub[1]);
    // libtiff's RGBA interface has rows for 4x4, 4x2, 4x1, 2x2, 2x1, 1x2 and 1x1.
    const int hv = t.sub_h << 4 | t.sub_v;
    if (hv != 0x44 && hv != 0x42 && hv != 0x41 && hv != 0x22 && hv != 0x21 && hv != 0x12 && hv != 0x11)
      fail("TIFF: YCbCr subsampling " + std::to_string(t.sub_h) + "x" + std::to_string(t.sub_v) +
           " not read");
    const auto lit = f.reals.find(kYcbcrCoefficients);
    if (lit != f.reals.end() && lit->second.size() >= 3)
      for (int i = 0; i < 3; ++i) t.luma[i] = static_cast<float>(lit->second[i]);
    const auto rit = f.reals.find(kReferenceBlackWhite);
    if (rit != f.reals.end() && rit->second.size() >= 6)
      for (int i = 0; i < 6; ++i) t.refbw[i] = static_cast<float>(rit->second[i]);
    if (t.luma[1] == 0.0f) fail("TIFF: YCbCr coefficients with a zero green");
  }
  if (c == 7) {
    const std::vector<uint64_t>& tables = f.list(kJpegTables);
    for (const uint64_t v : tables) t.jpeg_tables.push_back(static_cast<uint8_t>(v));
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

// ---------------------------------------------------------------- CCITT

// T.4's run-length codes: (run, code, length) of white and black runs,
// terminating (0-63), makeup (64-1728) and the extended makeup codes both
// colours share (1792-2560).
struct FaxCode {
  uint16_t run, code;
  uint8_t len;
};
const FaxCode kWhite[] = {
    {0, 0x35, 8},    {1, 0x7, 6},     {2, 0x7, 4},     {3, 0x8, 4},     {4, 0xB, 4},
    {5, 0xC, 4},     {6, 0xE, 4},     {7, 0xF, 4},     {8, 0x13, 5},    {9, 0x14, 5},
    {10, 0x7, 5},    {11, 0x8, 5},    {12, 0x8, 6},    {13, 0x3, 6},    {14, 0x34, 6},
    {15, 0x35, 6},   {16, 0x2A, 6},   {17, 0x2B, 6},   {18, 0x27, 7},   {19, 0xC, 7},
    {20, 0x8, 7},    {21, 0x17, 7},   {22, 0x3, 7},    {23, 0x4, 7},    {24, 0x28, 7},
    {25, 0x2B, 7},   {26, 0x13, 7},   {27, 0x24, 7},   {28, 0x18, 7},   {29, 0x2, 8},
    {30, 0x3, 8},    {31, 0x1A, 8},   {32, 0x1B, 8},   {33, 0x12, 8},   {34, 0x13, 8},
    {35, 0x14, 8},   {36, 0x15, 8},   {37, 0x16, 8},   {38, 0x17, 8},   {39, 0x28, 8},
    {40, 0x29, 8},   {41, 0x2A, 8},   {42, 0x2B, 8},   {43, 0x2C, 8},   {44, 0x2D, 8},
    {45, 0x4, 8},    {46, 0x5, 8},    {47, 0xA, 8},    {48, 0xB, 8},    {49, 0x52, 8},
    {50, 0x53, 8},   {51, 0x54, 8},   {52, 0x55, 8},   {53, 0x24, 8},   {54, 0x25, 8},
    {55, 0x58, 8},   {56, 0x59, 8},   {57, 0x5A, 8},   {58, 0x5B, 8},   {59, 0x4A, 8},
    {60, 0x4B, 8},   {61, 0x32, 8},   {62, 0x33, 8},   {63, 0x34, 8},   {64, 0x1B, 5},
    {128, 0x12, 5},  {192, 0x17, 6},  {256, 0x37, 7},  {320, 0x36, 8},  {384, 0x37, 8},
    {448, 0x64, 8},  {512, 0x65, 8},  {576, 0x68, 8},  {640, 0x67, 8},  {704, 0xCC, 9},
    {768, 0xCD, 9},  {832, 0xD2, 9},  {896, 0xD3, 9},  {960, 0xD4, 9},  {1024, 0xD5, 9},
    {1088, 0xD6, 9}, {1152, 0xD7, 9}, {1216, 0xD8, 9}, {1280, 0xD9, 9}, {1344, 0xDA, 9},
    {1408, 0xDB, 9}, {1472, 0x98, 9}, {1536, 0x99, 9}, {1600, 0x9A, 9}, {1664, 0x18, 6},
    {1728, 0x9B, 9},
};
const FaxCode kBlack[] = {
    {0, 0x37, 10},    {1, 0x2, 3},      {2, 0x3, 2},      {3, 0x2, 2},      {4, 0x3, 3},
    {5, 0x3, 4},      {6, 0x2, 4},      {7, 0x3, 5},      {8, 0x5, 6},      {9, 0x4, 6},
    {10, 0x4, 7},     {11, 0x5, 7},     {12, 0x7, 7},     {13, 0x4, 8},     {14, 0x7, 8},
    {15, 0x18, 9},    {16, 0x17, 10},   {17, 0x18, 10},   {18, 0x8, 10},    {19, 0x67, 11},
    {20, 0x68, 11},   {21, 0x6C, 11},   {22, 0x37, 11},   {23, 0x28, 11},   {24, 0x17, 11},
    {25, 0x18, 11},   {26, 0xCA, 12},   {27, 0xCB, 12},   {28, 0xCC, 12},   {29, 0xCD, 12},
    {30, 0x68, 12},   {31, 0x69, 12},   {32, 0x6A, 12},   {33, 0x6B, 12},   {34, 0xD2, 12},
    {35, 0xD3, 12},   {36, 0xD4, 12},   {37, 0xD5, 12},   {38, 0xD6, 12},   {39, 0xD7, 12},
    {40, 0x6C, 12},   {41, 0x6D, 12},   {42, 0xDA, 12},   {43, 0xDB, 12},   {44, 0x54, 12},
    {45, 0x55, 12},   {46, 0x56, 12},   {47, 0x57, 12},   {48, 0x64, 12},   {49, 0x65, 12},
    {50, 0x52, 12},   {51, 0x53, 12},   {52, 0x24, 12},   {53, 0x37, 12},   {54, 0x38, 12},
    {55, 0x27, 12},   {56, 0x28, 12},   {57, 0x58, 12},   {58, 0x59, 12},   {59, 0x2B, 12},
    {60, 0x2C, 12},   {61, 0x5A, 12},   {62, 0x66, 12},   {63, 0x67, 12},   {64, 0xF, 10},
    {128, 0xC8, 12},  {192, 0xC9, 12},  {256, 0x5B, 12},  {320, 0x33, 12},  {384, 0x34, 12},
    {448, 0x35, 12},  {512, 0x6C, 13},  {576, 0x6D, 13},  {640, 0x4A, 13},  {704, 0x4B, 13},
    {768, 0x4C, 13},  {832, 0x4D, 13},  {896, 0x72, 13},  {960, 0x73, 13},  {1024, 0x74, 13},
    {1088, 0x75, 13}, {1152, 0x76, 13}, {1216, 0x77, 13}, {1280, 0x52, 13}, {1344, 0x53, 13},
    {1408, 0x54, 13}, {1472, 0x55, 13}, {1536, 0x5A, 13}, {1600, 0x5B, 13}, {1664, 0x64, 13},
    {1728, 0x65, 13},
};
const FaxCode kExtended[] = {
    {1792, 0x8, 11},  {1856, 0xC, 11},  {1920, 0xD, 11},  {1984, 0x12, 12}, {2048, 0x13, 12},
    {2112, 0x14, 12}, {2176, 0x15, 12}, {2240, 0x16, 12}, {2304, 0x17, 12}, {2368, 0x1C, 12},
    {2432, 0x1D, 12}, {2496, 0x1E, 12}, {2560, 0x1F, 12},
};

// A 13-bit lookup of one colour's codes: run << 4 | length, 0 where no code
// starts.
struct FaxTable {
  std::vector<uint32_t> t = std::vector<uint32_t>(1 << 13, 0);
  explicit FaxTable(bool white) {
    auto add = [&](const FaxCode& c) {
      const int shift = 13 - c.len;
      for (int j = 0; j < (1 << shift); ++j) t[(c.code << shift) + j] = uint32_t(c.run) << 4 | c.len;
    };
    if (white) for (const FaxCode& c : kWhite) add(c);
    else for (const FaxCode& c : kBlack) add(c);
    for (const FaxCode& c : kExtended) add(c);
  }
};

// MSB-first bits of a CCITT chunk (the fill order already undone).
struct FaxBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // bit position
  uint32_t peek(int k) const {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) {
      const size_t b = pos + i;
      v = v << 1 | ((b >> 3) < n ? (p[b >> 3] >> (7 - (b & 7))) & 1 : 0);
    }
    return v;
  }
  void skip(int k) { pos += k; }
  bool done() const { return pos >= 8 * n; }
  void align() { pos = (pos + 7) & ~size_t(7); }
};

// One run of a colour: makeup codes, then a terminating code.
int64_t fax_run(FaxBits& in, const FaxTable& t) {
  int64_t run = 0;
  for (;;) {
    if (in.done()) fail("TIFF: CCITT data ends early");
    const uint32_t e = t.t[in.peek(13)];
    if (!e) fail("TIFF: bad CCITT run code");
    in.skip(int(e & 15));
    const int64_t r = e >> 4;
    run += r;
    if (r < 64) return run;
  }
}

// libtiff's SYNC_EOL: eleven zeros at least (fill), then a 1.
void fax_eol(FaxBits& in) {
  int zeros = 0;
  for (;;) {
    if (in.done()) fail("TIFF: CCITT data ends before an EOL");
    const uint32_t b = in.peek(1);
    in.skip(1);
    if (b) {
      if (zeros >= 11) return;
      zeros = 0;
    } else {
      ++zeros;
    }
  }
}

// A CCITT chunk (compression 2, 3 or 4) to rows of packed bits, white 0 and
// black 1 (libtiff's fill; PIL then reads the bits by the photometric).
void ccitt_decode(const uint8_t* p, size_t n, const Tiff& t, int64_t cols, int64_t rows,
                  uint8_t* out, size_t row_bytes) {
  static const FaxTable white(true), black(false);
  FaxBits in{p, n};
  std::vector<int64_t> ref{cols, cols}, cur;  // changing elements; the first reference line white
  std::memset(out, 0, row_bytes * size_t(rows));
  const bool g4 = t.compression == 4, g3 = t.compression == 3, two_d = g4 || (g3 && (t.t4 & 1));
  for (int64_t y = 0; y < rows; ++y) {
    if (t.compression == 2) in.align();
    if (g3) fax_eol(in);
    bool one_d = !two_d;
    if (g3 && two_d) {
      one_d = in.peek(1);
      in.skip(1);
    }
    cur.clear();
    int64_t a0 = 0;
    int color = 0;  // 0 white, 1 black
    if (one_d) {
      while (a0 < cols) {
        a0 += fax_run(in, color ? black : white);
        cur.push_back(std::min(a0, cols));
        color ^= 1;
      }
    } else {
      a0 = -1;
      size_t i = 0;  // the first entry of ref past a0
      while (a0 < cols) {
        // b1: the first changing element of ref past a0 whose colour is the
        // opposite of a0's (even entries start black runs); b2 the next.
        while (i < ref.size() && ref[i] <= a0) ++i;
        const size_t j = i + ((i & 1) != size_t(color) ? 1 : 0);
        const int64_t b1 = j < ref.size() ? ref[j] : cols;
        const int64_t b2 = j + 1 < ref.size() ? ref[j + 1] : cols;
        if (in.done()) fail("TIFF: CCITT data ends early");
        const uint32_t c = in.peek(7);
        int delta;
        if (c >> 6 == 1) delta = 0, in.skip(1);
        else if (c >> 4 == 3) delta = 1, in.skip(3);
        else if (c >> 4 == 2) delta = -1, in.skip(3);
        else if (c >> 4 == 1) {  // horizontal
          in.skip(3);
          const int64_t start = a0 < 0 ? 0 : a0;
          const int64_t r1 = fax_run(in, color ? black : white);
          const int64_t r2 = fax_run(in, color ? white : black);
          cur.push_back(std::min(start + r1, cols));
          cur.push_back(std::min(start + r1 + r2, cols));
          a0 = start + r1 + r2;
          continue;
        } else if (c >> 3 == 1) {  // pass
          in.skip(4);
          a0 = b2;
          continue;
        } else if (c >> 1 == 3) delta = 2, in.skip(6);
        else if (c >> 1 == 2) delta = -2, in.skip(6);
        else if (c == 3) delta = 3, in.skip(7);
        else if (c == 2) delta = -3, in.skip(7);
        else fail("TIFF: bad CCITT 2-D code");
        const int64_t a1 = b1 + delta;
        if (a1 < 0 || a1 > cols || a1 < a0) fail("TIFF: CCITT 2-D code off the row");
        cur.push_back(a1);
        a0 = a1;
        color ^= 1;
      }
    }
    if (cur.empty() || cur.back() < cols) cur.push_back(cols);
    // The runs to bits: odd runs (from an even changing element) black.
    uint8_t* row = out + size_t(y) * row_bytes;
    int64_t x = 0;
    for (size_t k = 0; k < cur.size(); ++k) {
      const int64_t e = std::min(cur[k], cols);
      if (k & 1)
        for (int64_t j = x; j < e; ++j) row[j >> 3] |= uint8_t(0x80 >> (j & 7));
      x = std::max(x, e);
    }
    ref = cur;
    ref.push_back(cols), ref.push_back(cols);
  }
}

// ThunderScan's 4-bit coding (libtiff's tif_thunder.c): runs of the last
// value, and 2- and 3-bit deltas, nibbles packed high first.
void thunder_decode(const uint8_t* p, size_t n, int64_t cols, int64_t rows, uint8_t* out,
                    size_t row_bytes) {
  static const int kTwo[4] = {0, 1, 0, -1};
  static const int kThree[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  size_t pos = 0;
  std::memset(out, 0, row_bytes * size_t(rows));
  for (int64_t y = 0; y < rows; ++y) {
    uint8_t* row = out + size_t(y) * row_bytes;
    int64_t x = 0;
    int last = 0;
    auto put4 = [&](int v) {
      if (x < cols) row[x >> 1] |= uint8_t((v & 15) << ((x & 1) ? 0 : 4));
      ++x;
    };
    while (x < cols) {
      if (pos >= n) fail("TIFF: ThunderScan data ends early");
      const int c = p[pos++];
      switch (c & 0xC0) {
        case 0x00:  // a run of the last value
          if (x + (c & 0x3F) > cols) fail("TIFF: ThunderScan run past the row");
          for (int k = c & 0x3F; k > 0; --k) put4(last);
          break;
        case 0x40: {  // three 2-bit deltas; 2 skips
          const int d[3] = {(c >> 4) & 3, (c >> 2) & 3, c & 3};
          for (int k = 0; k < 3; ++k)
            if (d[k] != 2) last = (last + kTwo[d[k]]) & 15, put4(last);
          break;
        }
        case 0x80: {  // two 3-bit deltas; 4 skips
          const int d[2] = {(c >> 3) & 7, c & 7};
          for (int k = 0; k < 2; ++k)
            if (d[k] != 4) last = (last + kThree[d[k]]) & 15, put4(last);
          break;
        }
        default:  // a raw value
          last = c & 15;
          put4(last);
          break;
      }
    }
  }
}

// libtiff's TIFFYCbCrToRGBInit and TIFFYCbCrtoRGB (tif_color.c): integer
// tables from the luma coefficients and ReferenceBlackWhite, in float as
// libtiff computes them.
struct YcbcrTables {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], y[256];

  YcbcrTables(const float* luma, const float* rbw) {
    auto fix = [](float x) { return int32_t(double(x * float(1L << 16)) + 0.5); };
    auto clampf = [](float v, float lo, float hi) { return v < lo ? lo : v > hi ? hi : v; };
    auto code2v = [](int c, float rb, float rw, float cr) {
      return (float(c - int32_t(rb)) * cr) / ((rw - rb) != 0 ? (rw - rb) : 1.0f);
    };
    const float f1 = 2 - 2 * luma[0];
    const int32_t d1 = fix(clampf(f1, 0.0f, 2.0f));
    const float f2 = luma[0] * f1 / luma[1];
    const int32_t d2 = -fix(clampf(f2, 0.0f, 2.0f));
    const float f3 = 2 - 2 * luma[2];
    const int32_t d3 = fix(clampf(f3, 0.0f, 2.0f));
    const float f4 = luma[2] * f3 / luma[1];
    const int32_t d4 = -fix(clampf(f4, 0.0f, 2.0f));
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      const int32_t cr = int32_t(clampf(code2v(x, rbw[4] - 128.0f, rbw[5] - 128.0f, 127), -128.0f * 32, 128.0f * 32));
      const int32_t cb = int32_t(clampf(code2v(x, rbw[2] - 128.0f, rbw[3] - 128.0f, 127), -128.0f * 32, 128.0f * 32));
      cr_r[i] = (d1 * cr + (1 << 15)) >> 16;
      cb_b[i] = (d3 * cb + (1 << 15)) >> 16;
      cr_g[i] = d2 * cr;
      cb_g[i] = d4 * cb + (1 << 15);
      y[i] = int32_t(clampf(code2v(x + 128, rbw[0], rbw[1], 255), -128.0f * 32, 128.0f * 32));
    }
  }
  void rgb(int yy, int cb, int cr, uint8_t* o) const {
    auto c8 = [](int32_t v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
    o[0] = c8(y[yy] + cr_r[cr]);
    o[1] = c8(y[yy] + int32_t((cb_g[cb] + cr_g[cr]) >> 16));
    o[2] = c8(y[yy] + cb_b[cb]);
  }
};

// ---------------------------------------------------------------- pixels

uint8_t reverse_bits(uint8_t v) {
  v = static_cast<uint8_t>((v & 0xf0) >> 4 | (v & 0x0f) << 4);
  v = static_cast<uint8_t>((v & 0xcc) >> 2 | (v & 0x33) << 2);
  return static_cast<uint8_t>((v & 0xaa) >> 1 | (v & 0x55) << 1);
}

// libtiff's predictors, undone in place on `rows` rows: horizontal
// differencing of `stride` samples at 8, 16 or 32 bits (in the file's byte
// order), or the floating-point one (bytes of each row's samples stored by
// significance, most significant first, then differenced), which leaves
// the samples little-endian.
void unpredict(const Tiff& t, uint8_t* data, int64_t rows, int64_t cols, int stride,
               size_t row_bytes) {
  const int64_t count = cols * stride;
  std::vector<uint8_t> tmp;
  for (int64_t y = 0; y < rows; ++y) {
    uint8_t* row = data + y * row_bytes;
    if (t.predictor == 3) {
      const int64_t bytes = count * 4;
      for (int64_t i = stride; i < bytes; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
      tmp.assign(row, row + bytes);
      for (int64_t i = 0; i < count; ++i)
        for (int k = 0; k < 4; ++k) row[4 * i + k] = tmp[(3 - k) * count + i];
    } else if (t.bits == 8) {
      for (int64_t i = stride; i < count; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
    } else {
      const int size = t.bits / 8;
      for (int64_t i = stride; i < count; ++i) {
        uint8_t* c = row + size * i;
        const uint8_t* q = row + size * (i - stride);
        uint32_t carry = 0;
        for (int k = 0; k < size; ++k) {  // least significant byte first
          const int at = t.le ? k : size - 1 - k;
          const uint32_t v = uint32_t(c[at]) + q[at] + carry;
          c[at] = static_cast<uint8_t>(v);
          carry = v >> 8;
        }
      }
    }
  }
}

// One strip or tile, decompressed and un-predicted: `rows` rows of
// `row_bytes` bytes (YCbCr and JPEG chunks already RGB, three bytes a
// pixel).
std::vector<uint8_t> read_chunk(const Bytes& b, const Tiff& t, size_t k, int64_t cols,
                                int64_t rows, int samples, size_t row_bytes) {
  size_t want = row_bytes * static_cast<size_t>(rows);
  // libtiff's packing of subsampled YCbCr: blocks of sub_h x sub_v luma
  // samples, then Cb and Cr, across each band of sub_v rows.
  const int64_t bw = (cols + t.sub_h - 1) / t.sub_h, bh = (rows + t.sub_v - 1) / t.sub_v;
  const size_t block = size_t(t.sub_h * t.sub_v + 2);
  if (t.ycbcr) want = size_t(bw * bh) * block;
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
    case 2: case 3: case 4: ccitt_decode(p, len, t, cols, rows, out.data(), row_bytes); break;
    case 5: lzw_decode(p, len, out.data(), want); break;
    case 32773: packbits_decode(p, len, out.data(), want); break;
    case 32809: thunder_decode(p, len, cols, rows, out.data(), row_bytes); break;
    case 34925: case 50000: {
      std::vector<uint8_t> v;
      v.reserve(want);
      if (t.compression == 34925) tracy_image::xz_decode(p, len, v, want, "TIFF");
      else tracy_image::zstd_decode(p, len, v, want, "TIFF");
      std::memcpy(out.data(), v.data(), want);
      break;
    }
    case 7: {
      // The JPEGTables stream's tables, then the chunk's datastream.
      std::vector<uint8_t> stream;
      const std::vector<uint8_t>& tab = t.jpeg_tables;
      if (tab.size() >= 4 && tab[0] == 0xFF && tab[1] == 0xD8 && len >= 2 && p[0] == 0xFF &&
          p[1] == 0xD8) {
        const size_t keep = tab[tab.size() - 2] == 0xFF && tab.back() == 0xD9 ? tab.size() - 2 : tab.size();
        stream.assign(tab.begin(), tab.begin() + keep);
        stream.insert(stream.end(), p + 2, p + len);
      } else {
        stream.assign(p, p + len);
      }
      std::vector<uint8_t> pix;
      int jw = 0, jh = 0, jc = 0;
      const std::string err =
          tracy_image::jpeg_components(stream.data(), stream.size(), t.jpeg_rgb, pix, &jw, &jh, &jc);
      if (!err.empty()) fail("TIFF: " + err);
      if (jw != cols || jh != rows || jc != samples)
        fail("TIFF: a JPEG chunk of " + std::to_string(jw) + "x" + std::to_string(jh) + "x" +
             std::to_string(jc) + " where the TIFF has " + std::to_string(cols) + "x" +
             std::to_string(rows) + "x" + std::to_string(samples));
      std::memcpy(out.data(), pix.data(), want);
      break;
    }
    default: inflate_decode(p, len, out.data(), want); break;
  }
  if (t.predictor != 1) unpredict(t, out.data(), rows, cols, samples, row_bytes);
  if (t.ycbcr) {  // libtiff's RGBA interface: each block's Cb and Cr for all its pixels
    static thread_local std::vector<uint8_t> rgb;
    rgb.assign(row_bytes * size_t(rows), 0);
    const YcbcrTables tab(t.luma, t.refbw);
    for (int64_t by = 0; by < bh; ++by)
      for (int64_t bx = 0; bx < bw; ++bx) {
        const uint8_t* blk = out.data() + size_t(by * bw + bx) * block;
        const int cb = blk[block - 2], cr = blk[block - 1];
        for (int j = 0; j < t.sub_v; ++j)
          for (int i = 0; i < t.sub_h; ++i) {
            const int64_t y = by * t.sub_v + j, x = bx * t.sub_h + i;
            if (y < rows && x < cols) tab.rgb(blk[j * t.sub_h + i], cb, cr, &rgb[y * row_bytes + 3 * x]);
          }
      }
    out.swap(rgb);
  }
  return out;
}

// Old-style JPEG: the interchange stream's planes after the IDCT, each
// subsampling block's chroma for all its pixels, through TIFFYCbCrtoRGB.
void ojpeg_samples(const Bytes& b, const Tiff& t, std::vector<uint8_t>& samples) {
  b.need(static_cast<size_t>(std::min<uint64_t>(t.jif_at, b.n + 1)),
         static_cast<size_t>(std::min<uint64_t>(t.jif_len, b.n + 1)));
  std::vector<std::vector<uint8_t>> planes;
  std::vector<int> layout;
  int jw = 0, jh = 0;
  const std::string err = tracy_image::jpeg_planes(b.p + t.jif_at, size_t(t.jif_len), planes,
                                                   layout, &jw, &jh);
  if (!err.empty()) fail("TIFF: " + err);
  if (planes.size() != 3) fail("TIFF: old-style JPEG of other than three components not read");
  if (jw < t.w || jh < t.h) fail("TIFF: old-style JPEG smaller than the image");
  if (layout[0] != 1 || layout[1] != 1 || layout[3] != layout[6] || layout[4] != layout[7])
    fail("TIFF: old-style JPEG with subsampled luma or unequal chroma not read");
  const int sh = layout[3], sv = layout[4];
  const YcbcrTables tab(t.luma, t.refbw);
  samples.assign(size_t(t.w * t.h * 3), 0);
  for (int64_t y = 0; y < t.h; ++y)
    for (int64_t x = 0; x < t.w; ++x) {
      const size_t ci = size_t(y / sv) * layout[5] + size_t(x / sh);
      tab.rgb(planes[0][size_t(y) * layout[2] + x], planes[1][ci], planes[2][ci],
              &samples[3 * size_t(y * t.w + x)]);
    }
}

Tiff tiff_decode_samples(const Bytes& b, std::vector<uint8_t>& samples) {
  const Tiff t = tiff_header(b);
  if (t.compression == 6) {
    ojpeg_samples(b, t, samples);
    return t;
  }
  const int planes = t.planar == 2 ? t.spp : 1;
  const int per = t.planar == 2 ? 1 : t.spp;  // samples in a chunk's pixel
  const int64_t across = (t.w + t.cw - 1) / t.cw, down = (t.h + t.ch - 1) / t.ch;
  const size_t row_bytes = static_cast<size_t>((t.cw * per * t.bits + 7) / 8);
  // 8 bits a sample: the value (bits < 8), the byte (8) or the high byte
  // (16); for PIL's modes I and F, the value taken to 8 bits as PIL does.
  samples.assign(static_cast<size_t>(t.w * t.h * t.spp), 0);
  const bool le = t.le || t.predictor == 3;  // the floating-point predictor leaves little-endian
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
              if (t.kind == kValue) {
                const uint8_t* q = row + (i * t.bits >> 3);
                if (t.bits == 12) {
                  v = tracy_image::i_to_u8((i & 1) ? (q[0] & 15) << 8 | q[1] : q[0] << 4 | q[1] >> 4);
                } else if (t.bits == 16) {
                  v = tracy_image::i_to_u8(int16_t(le ? q[0] | q[1] << 8 : q[0] << 8 | q[1]));
                } else {
                  const uint32_t u = le ? tracy_image::le32(q) : tracy_image::be32(q);
                  v = t.format == 3 ? tracy_image::f_to_u8(tracy_image::f32(u))
                                    : tracy_image::i_to_u8(int32_t(u));
                }
              } else if (t.bits == 8) {
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
      case kValue:
        put(o, v[0], v[0], v[0], 255);
        break;
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
      case kLab: {
        uint8_t rgb[3];
        tracy_image::lab_to_rgb(v[0], v[1] ^ 128, v[2] ^ 128, rgb);
        put(o, rgb[0], rgb[1], rgb[2], 255);
        break;
      }
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
  return guarded("TIFF", [&] { tiff_decode({data, static_cast<size_t>(len), "TIFF"}, out, w, h); });
}
// The mode PIL opens the first image in ("L", "I;16", "F", "RGB", ...; at
// most cap - 1 characters), for IPTC's embedded streams, whose band and
// conversion follow it (utils/image_io.py::_pil_mode).
int tracy_tiff_mode(const uint8_t* data, int64_t len, char* mode, int cap) {
  return guarded("TIFF", [&] {
    const Tiff t = tiff_header({data, static_cast<size_t>(len), "TIFF"});
    std::string m;
    switch (t.kind) {
      case kGrey: m = t.bits == 1 ? "1" : t.bits == 16 ? (t.le ? "I;16" : "I;16B") : "L"; break;
      case kGreyAlpha: m = "LA"; break;
      case kValue: m = t.format == 3 ? "F" : t.bits == 12 ? "I;16" : "I"; break;
      case kRgb: m = t.alpha >= 0 ? "RGBA" : "RGB"; break;
      case kPalette: m = t.alpha >= 0 ? "PA" : "P"; break;
      case kCmyk: m = "CMYK"; break;
      case kLab: m = "LAB"; break;
    }
    std::snprintf(mode, static_cast<size_t>(cap), "%s", m.c_str());
  });
}

}  // extern "C"
