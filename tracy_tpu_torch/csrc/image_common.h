// What the host image decoders share (image_formats.cpp, image_tiff.cpp,
// image_blocks.cpp, image_webp.cpp, image_containers.cpp,
// image_legacy.cpp, image_jpeg2000.cpp): bounds-checked reads of the file,
// the size limit, the fault types, and the guard that turns a fault into
// the return codes of the extern "C" entry points (0; 1, a fault of the
// file; 2, a failure inside the decoder; 3, not a file of the format asked
// for), the message going to tracy_decode_error().

#pragma once


#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace tracy_image {
void set_error(const std::string& msg);

// A fault of the file (return code 1): one type across the sources, so that
// a fault raised in one (a DIB inside an ICO) is caught in another.
struct DecodeError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// Not a file of the format asked for (return code 3): where PIL's plugin
// raises an error that Image.open takes for "not this format", so that it
// tries its next plugin (image_legacy.cpp's header readers).
struct NotFormat : DecodeError {
  using DecodeError::DecodeError;
};

// Mode I to 8 bits, as PIL converts it: clipped.
inline uint8_t i_to_u8(int64_t v) {
  return static_cast<uint8_t>(v <= 0 ? 0 : v >= 255 ? 255 : v);
}
// Mode F to 8 bits, as PIL converts it: truncated toward zero and clipped,
// NaN 0.
inline uint8_t f_to_u8(float v) {
  return v > 0 ? (v >= 255 ? 255 : static_cast<uint8_t>(v)) : 0;
}

inline uint32_t le16(const uint8_t* p) { return p[0] | p[1] << 8; }
inline uint32_t le32(const uint8_t* p) {
  return p[0] | p[1] << 8 | p[2] << 16 | uint32_t(p[3]) << 24;
}
inline uint32_t be16(const uint8_t* p) { return p[0] << 8 | p[1]; }
inline uint32_t be32(const uint8_t* p) {
  return uint32_t(p[0]) << 24 | p[1] << 16 | p[2] << 8 | p[3];
}
inline float f32(uint32_t u) {
  float v;
  std::memcpy(&v, &u, 4);
  return v;
}

// What one source lends another (image_containers.cpp reads the bitmaps of
// ICO, CUR and DIB files, FTEX's BC1 blocks and the size of ICNS's JPEG 2000
// entries with these).
//
// The DIB whose info header starts at `at` of p[0, n) (a BMP without its
// 14-byte file header): its width and height as the header gives them.
struct DibSize {
  int64_t w, h;
};
DibSize dib_size(const uint8_t* p, size_t n, size_t at);
// Its first `rows` rows in file order (PIL's tile cut to that height), as
// PIL's DibImageFile reads them: the pixels follow the header, the
// bitfield masks and the palette. `raw_alpha`: a 32-bit BI_RGB pixel's
// fourth byte is its alpha (PIL's BGRA rawmode), else alpha is 255. Writes
// RGBA8 [rows, w, 4] and returns where the pixel data starts.
size_t dib_decode(const uint8_t* p, size_t n, size_t at, int64_t rows, bool raw_alpha,
                  uint8_t* out);
// BC1 blocks (ceil(w / 4) x ceil(h / 4), 8 bytes each, already bounds-
// checked) to RGBA8 [h, w, 4], as DDS reads them (image_blocks.cpp).
void bc1_decode(const uint8_t* p, int64_t w, int64_t h, uint8_t* out);
// Raw deflate (RFC 1951) of p[0, n), appended to `out` until `want` bytes
// are out or the final block ends (image_tiff.cpp). Returns the bytes of p
// consumed, to the byte that holds the last bit read; `fmt` names the
// format in errors.
size_t inflate(const uint8_t* p, size_t n, std::vector<uint8_t>& out, size_t want,
               const char* fmt);
// An xz stream of LZMA2 (and delta) data at p[0, n), appended to `out`
// until `want` bytes are out (image_xz.cpp); a run of zstd frames the same
// way (image_zstd.cpp). `fmt` names the format in errors.
void xz_decode(const uint8_t* p, size_t n, std::vector<uint8_t>& out, size_t want,
               const char* fmt);
void zstd_decode(const uint8_t* p, size_t n, std::vector<uint8_t>& out, size_t want,
                 const char* fmt);
// A JPEG datastream at p[0, n) (image_decode.cpp) as libjpeg gives it to
// libtiff: `ycc_to_rgb` forces YCbCr -> RGB (libtiff's JPEGCOLORMODE_RGB),
// else the components come out as they are (JCS_UNKNOWN). Writes w * h *
// comps bytes to `out`; returns "" or the decoder's message.
std::string jpeg_components(const uint8_t* p, size_t n, bool ycc_to_rgb,
                            std::vector<uint8_t>& out, int* w, int* h, int* comps);
// The same datastream's components after the IDCT, each at its own
// sampling (libjpeg's raw data): `layout` holds each one's horizontal and
// vertical subsampling and its row stride.
std::string jpeg_planes(const uint8_t* p, size_t n, std::vector<std::vector<uint8_t>>& planes,
                        std::vector<int>& layout, int* w, int* h);
// PIL's LAB -> RGB of one pixel, `a` and `b` offset by 128 as PIL holds
// them: LittleCMS's transform to sRGB (image_formats.cpp, lab_table.h).
void lab_to_rgb(int L, int a, int b, uint8_t* rgb);
// PIL's YCbCr -> RGB of one pixel (ConvertYCbCr.c's integer tables, which
// image_jpeg2000.cpp holds for sYCC; IM's YCC kind reads through them too).
void ycbcr_to_rgb(int y, int cb, int cr, uint8_t* rgb);
// The size PIL gives a JPEG 2000 file (a raw codestream or JP2) of p[0, n)
// (image_jpeg2000.cpp; throws DecodeError where the decoder refuses it).
bool jpeg2000_size(const uint8_t* p, size_t n, int64_t* w, int64_t* h);
}  // namespace tracy_image

namespace {

using tracy_image::DecodeError;

[[noreturn]] void fail(const std::string& msg) { throw DecodeError(msg); }
[[noreturn]] inline void not_format(const std::string& msg) { throw tracy_image::NotFormat(msg); }

// PIL's decompression-bomb error starts at twice its 89.5 M-pixel warning
// (utils/image_io.py::MAX_PIXELS, which PNG and JPEG are held to).
constexpr int64_t kMaxPixels = 2 * int64_t(89478485);

// Bounds-checked reads of the file; `fmt` names the format in errors.
struct Bytes {
  const uint8_t* p;
  size_t n;
  const char* fmt;

  void need(size_t at, size_t k) const {
    if (at > n || k > n - at) fail(std::string(fmt) + ": file is truncated");
  }
  uint8_t u8(size_t at) const {
    need(at, 1);
    return p[at];
  }
  uint32_t le16(size_t at) const {
    need(at, 2);
    return p[at] | p[at + 1] << 8;
  }
  uint32_t le32(size_t at) const {
    need(at, 4);
    return p[at] | p[at + 1] << 8 | p[at + 2] << 16 | uint32_t(p[at + 3]) << 24;
  }
  uint32_t be16(size_t at) const {
    need(at, 2);
    return p[at] << 8 | p[at + 1];
  }
  uint32_t be32(size_t at) const {
    need(at, 4);
    return uint32_t(p[at]) << 24 | p[at + 1] << 16 | p[at + 2] << 8 | p[at + 3];
  }
};

inline void check_size(const char* fmt, int64_t w, int64_t h) {
  if (w <= 0 || h <= 0 || w * h > kMaxPixels) {
    fail(std::string(fmt) + ": " + std::to_string(w) + "x" + std::to_string(h) +
         " pixels not read");
  }
}

inline void check_out(const char* fmt, int64_t w, int64_t h, int out_w, int out_h) {
  if (w != out_w || h != out_h) fail(std::string(fmt) + ": size changed between calls");
}

// Pillow's cmyk2rgb (Convert.c): one of R, G, B from its CMYK channel v and
// nk = 255 - K, with MULDIV255's rounding.
inline uint8_t cmyk_channel(int v, int nk) {
  const int t = v * nk + 128;
  const int c = nk - (((t >> 8) + t) >> 8);
  return static_cast<uint8_t>(c < 0 ? 0 : c > 255 ? 255 : c);
}

inline void put(uint8_t* o, int r, int g, int b, int a) {
  o[0] = static_cast<uint8_t>(r);
  o[1] = static_cast<uint8_t>(g);
  o[2] = static_cast<uint8_t>(b);
  o[3] = static_cast<uint8_t>(a);
}


// `fmt` names the format in a failure inside the decoder; a fault's message
// names it already.
template <class F>
int guarded(const char* fmt, F&& f) {
  try {
    f();
    return 0;
  } catch (const tracy_image::NotFormat& e) {
    tracy_image::set_error(e.what());
    return 3;
  } catch (const DecodeError& e) {
    tracy_image::set_error(e.what());
    return 1;
  } catch (const std::exception& e) {
    tracy_image::set_error(std::string(fmt) + ": decoder failure: " + e.what());
    return 2;
  }
}

template <class H>
int info(const char* fmt, const uint8_t* data, int64_t len, int* w, int* h, H&& header) {
  return guarded(fmt, [&] {
    const Bytes b{data, static_cast<size_t>(len), fmt};
    const auto m = header(b);
    *w = static_cast<int>(m.w);
    *h = static_cast<int>(m.h);
  });
}

}  // namespace
