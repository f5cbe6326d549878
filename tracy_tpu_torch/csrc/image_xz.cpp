// The xz container and its LZMA2 and delta filters, as liblzma decodes them
// for libtiff's LZMA codec (TIFF compression 34925: each strip or tile one
// xz stream, liblzma's lzma_stream_decoder). The stream header, the block
// headers with their filter chains (delta, then LZMA2), LZMA2's chunks
// (uncompressed, LZMA with state and property resets, dictionary resets)
// and the LZMA range decoder with its literal, match and repeat coding.
// Checks (CRC32, CRC64, SHA-256) are skipped, not verified: a stream that
// ends early or codes past its dictionary fails as liblzma fails it.

#include "image_common.h"

namespace {

// ---------------------------------------------------------------- range decoder

struct Range {
  const uint8_t* p;
  size_t n, pos = 0;
  uint32_t range = 0xFFFFFFFF, code = 0;
  const char* fmt;

  [[noreturn]] void error(const char* what) const { fail(std::string(fmt) + ": " + what); }
  void init(const uint8_t* data, size_t len) {
    p = data, n = len, pos = 0, range = 0xFFFFFFFF, code = 0;
    if (n < 5 || p[0] != 0) error("bad LZMA chunk start");
    for (int i = 1; i < 5; ++i) code = code << 8 | p[i];
    pos = 5;
    if (code == range) error("bad LZMA chunk start");
  }
  void normalize() {
    if (range < (1u << 24)) {
      if (pos >= n) error("LZMA data ends early");
      range <<= 8;
      code = code << 8 | p[pos++];
    }
  }
  int bit(uint16_t& prob) {
    normalize();
    const uint32_t bound = (range >> 11) * prob;
    if (code < bound) {
      range = bound;
      prob = static_cast<uint16_t>(prob + ((2048 - prob) >> 5));
      return 0;
    }
    range -= bound;
    code -= bound;
    prob = static_cast<uint16_t>(prob - (prob >> 5));
    return 1;
  }
  uint32_t direct(int count) {
    uint32_t v = 0;
    while (count--) {
      normalize();
      range >>= 1;
      const uint32_t t = (code - range) >> 31;  // 1 where code < range
      code -= range & (t - 1);
      v = v << 1 | (1 - t);
    }
    return v;
  }
  template <int N>
  uint32_t tree(uint16_t* probs) {  // N bits, most significant first
    uint32_t m = 1;
    for (int i = 0; i < N; ++i) m = m << 1 | bit(probs[m]);
    return m - (1u << N);
  }
  template <int N>
  uint32_t reverse(uint16_t* probs) {
    uint32_t m = 1, v = 0;
    for (int i = 0; i < N; ++i) {
      const int b = bit(probs[m]);
      m = m << 1 | b;
      v |= uint32_t(b) << i;
    }
    return v;
  }
};

// ---------------------------------------------------------------- LZMA

struct LenCoder {
  uint16_t choice, choice2, low[16][8], mid[16][8], high[256];
  void reset() {
    choice = choice2 = 1024;
    for (auto& a : low) for (uint16_t& v : a) v = 1024;
    for (auto& a : mid) for (uint16_t& v : a) v = 1024;
    for (uint16_t& v : high) v = 1024;
  }
  uint32_t decode(Range& rc, int pos_state) {
    if (!rc.bit(choice)) return rc.tree<3>(low[pos_state]);
    if (!rc.bit(choice2)) return 8 + rc.tree<3>(mid[pos_state]);
    return 16 + rc.tree<8>(high);
  }
};

struct Lzma {
  int lc = 0, lp = 0, pb = 0;
  std::vector<uint16_t> literal;
  uint16_t is_match[12][16], is_rep[12], is_rep0[12], is_rep1[12], is_rep2[12], is_rep0_long[12][16];
  uint16_t slot[4][64], special[115], align[16];
  LenCoder len, rep_len;
  int state = 0;
  uint32_t rep[4] = {0, 0, 0, 0};

  void props(int v, const char* fmt) {
    if (v > 224) fail(std::string(fmt) + ": bad LZMA properties");
    lc = v % 9, v /= 9, lp = v % 5, pb = v / 5;
    if (lc + lp > 4) fail(std::string(fmt) + ": LZMA2 lc + lp above 4");
  }
  void reset() {
    literal.assign(size_t(0x300) << (lc + lp), 1024);
    for (auto& a : is_match) for (uint16_t& v : a) v = 1024;
    for (auto& a : is_rep0_long) for (uint16_t& v : a) v = 1024;
    for (int i = 0; i < 12; ++i) is_rep[i] = is_rep0[i] = is_rep1[i] = is_rep2[i] = 1024;
    for (auto& a : slot) for (uint16_t& v : a) v = 1024;
    for (uint16_t& v : special) v = 1024;
    for (uint16_t& v : align) v = 1024;
    len.reset();
    rep_len.reset();
    state = 0;
    rep[0] = rep[1] = rep[2] = rep[3] = 0;
  }

  // Decodes until `out` holds `end` bytes (the dictionary is `out` from
  // `dict` on: LZMA2 resets it at chunk boundaries).
  void run(Range& rc, std::vector<uint8_t>& out, size_t dict, size_t end, const char* fmt) {
    const uint32_t pb_mask = (1u << pb) - 1, lp_mask = (1u << lp) - 1;
    while (out.size() < end) {
      const size_t pos = out.size();
      const int ps = int(pos & pb_mask);
      if (!rc.bit(is_match[state][ps])) {
        const int prev = pos > dict ? out[pos - 1] : 0;
        uint16_t* probs = &literal[size_t(0x300) * (((pos & lp_mask) << lc) + (prev >> (8 - lc)))];
        uint32_t sym = 1;
        if (state >= 7) {
          if (rep[0] + 1 > pos - dict) fail(std::string(fmt) + ": LZMA distance before the start");
          uint32_t match = out[pos - rep[0] - 1];
          while (sym < 0x100) {
            const uint32_t mbit = (match >> 7) & 1;
            match <<= 1;
            const int b = rc.bit(probs[0x100 + (mbit << 8) + sym]);
            sym = sym << 1 | b;
            if (uint32_t(b) != mbit) break;
          }
        }
        while (sym < 0x100) sym = sym << 1 | rc.bit(probs[sym]);
        out.push_back(static_cast<uint8_t>(sym));
        state = state < 4 ? 0 : state < 10 ? state - 3 : state - 6;
        continue;
      }
      uint32_t length;
      if (rc.bit(is_rep[state])) {
        if (pos == dict) fail(std::string(fmt) + ": LZMA repeat before any data");
        if (!rc.bit(is_rep0[state])) {
          if (!rc.bit(is_rep0_long[state][ps])) {  // one byte at rep0
            state = state < 7 ? 9 : 11;
            if (rep[0] + 1 > pos - dict) fail(std::string(fmt) + ": LZMA distance before the start");
            out.push_back(out[pos - rep[0] - 1]);
            continue;
          }
        } else {
          uint32_t d;
          if (!rc.bit(is_rep1[state])) {
            d = rep[1];
          } else {
            if (!rc.bit(is_rep2[state])) {
              d = rep[2];
            } else {
              d = rep[3];
              rep[3] = rep[2];
            }
            rep[2] = rep[1];
          }
          rep[1] = rep[0];
          rep[0] = d;
        }
        length = rep_len.decode(rc, ps);
        state = state < 7 ? 8 : 11;
      } else {
        rep[3] = rep[2], rep[2] = rep[1], rep[1] = rep[0];
        length = len.decode(rc, ps);
        state = state < 7 ? 7 : 10;
        const uint32_t s = rc.tree<6>(slot[std::min<uint32_t>(length, 3)]);
        uint32_t d;
        if (s < 4) {
          d = s;
        } else {
          const int bits = int(s >> 1) - 1;
          d = (2 | (s & 1)) << bits;
          if (s < 14) {
            uint32_t m = 1;
            const uint32_t base = d - s;
            for (int i = 0; i < bits; ++i) {
              const int b = rc.bit(special[base + m]);
              m = m << 1 | b;
              d += uint32_t(b) << i;
            }
          } else {
            d += rc.direct(bits - 4) << 4;
            d += rc.reverse<4>(align);
            if (d == 0xFFFFFFFF) fail(std::string(fmt) + ": LZMA end marker in an LZMA2 chunk");
          }
        }
        rep[0] = d;
      }
      length += 2;
      if (rep[0] + 1 > out.size() - dict) fail(std::string(fmt) + ": LZMA distance before the start");
      if (out.size() + length > end) fail(std::string(fmt) + ": LZMA match past the chunk");
      for (uint32_t i = 0; i < length; ++i) out.push_back(out[out.size() - rep[0] - 1]);
    }
  }
};

uint64_t vli(const uint8_t* p, size_t n, size_t& pos, const char* fmt) {
  uint64_t v = 0;
  for (int i = 0; i < 9; ++i) {
    if (pos >= n) fail(std::string(fmt) + ": xz block header ends early");
    const uint8_t b = p[pos++];
    v |= uint64_t(b & 0x7F) << (7 * i);
    if (!(b & 0x80)) return v;
  }
  fail(std::string(fmt) + ": bad xz integer");
}

}  // namespace

namespace tracy_image {

void xz_decode(const uint8_t* p, size_t n, std::vector<uint8_t>& out, size_t want,
               const char* fmt) {
  const std::string f(fmt);
  static const uint8_t kMagic[6] = {0xFD, '7', 'z', 'X', 'Z', 0};
  if (n < 12 || std::memcmp(p, kMagic, 6) != 0) fail(f + ": not an xz stream");
  if (p[6] != 0 || (p[7] & 0xF0)) fail(f + ": bad xz stream flags");
  static const int kCheck[16] = {0, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64};
  const int check = kCheck[p[7] & 15];
  size_t pos = 12;
  const size_t base = out.size();
  while (out.size() - base < want) {
    if (pos >= n) fail(f + ": xz stream ends early");
    if (p[pos] == 0) fail(f + ": xz stream ends early");  // the index: no more blocks
    const size_t hsize = (size_t(p[pos]) + 1) * 4;
    if (pos + hsize > n) fail(f + ": xz block header ends early");
    const uint8_t* h = p + pos;
    const int flags = h[1];
    if (flags & 0x3C) fail(f + ": bad xz block flags");
    const int nfilters = (flags & 3) + 1;
    size_t hp = 2;
    if (flags & 0x40) vli(h, hsize, hp, fmt);  // compressed size
    if (flags & 0x80) vli(h, hsize, hp, fmt);  // uncompressed size
    int delta = 0, dict_props = -1;
    for (int i = 0; i < nfilters; ++i) {
      const uint64_t id = vli(h, hsize, hp, fmt), psize = vli(h, hsize, hp, fmt);
      if (hp + psize > hsize) fail(f + ": xz filter properties end early");
      if (id == 3 && psize == 1 && i + 1 < nfilters) {
        delta = h[hp] + 1;
      } else if (id == 0x21 && psize == 1 && i + 1 == nfilters) {
        dict_props = h[hp];
      } else {
        fail(f + ": xz filter " + std::to_string(id) + " not read");
      }
      hp += size_t(psize);
    }
    if (dict_props < 0 || dict_props > 40) fail(f + ": xz block without an LZMA2 filter");
    pos += hsize;
    // LZMA2 chunks.
    const size_t start = out.size();
    Lzma lz;
    Range rc{nullptr, 0};
    rc.fmt = fmt;
    bool need_dict = true, need_props = true;
    size_t dict = start;
    for (;;) {
      if (pos >= n) fail(f + ": LZMA2 data ends early");
      const int c = p[pos++];
      if (c == 0) break;
      if (c == 1 || c == 2) {
        if (pos + 2 > n) fail(f + ": LZMA2 data ends early");
        const size_t size = (size_t(p[pos]) << 8 | p[pos + 1]) + 1;
        pos += 2;
        if (c == 1) dict = out.size(), need_dict = false;
        else if (need_dict) fail(f + ": LZMA2 chunk without a dictionary reset");
        if (pos + size > n) fail(f + ": LZMA2 data ends early");
        out.insert(out.end(), p + pos, p + pos + size);
        pos += size;
        continue;
      }
      if (c < 0x80) fail(f + ": bad LZMA2 control byte");
      if (pos + 4 > n) fail(f + ": LZMA2 data ends early");
      const size_t unpacked = (size_t(c & 0x1F) << 16 | size_t(p[pos]) << 8 | p[pos + 1]) + 1;
      const size_t packed = (size_t(p[pos + 2]) << 8 | p[pos + 3]) + 1;
      pos += 4;
      const int reset = (c >> 5) & 3;
      if (reset == 3) dict = out.size(), need_dict = false;
      else if (need_dict) fail(f + ": LZMA2 chunk without a dictionary reset");
      if (reset >= 2) {
        if (pos >= n) fail(f + ": LZMA2 data ends early");
        lz.props(p[pos++], fmt);
        need_props = false;
      } else if (need_props) {
        fail(f + ": LZMA2 chunk without properties");
      }
      if (reset >= 1) lz.reset();
      if (pos + packed > n) fail(f + ": LZMA2 data ends early");
      rc.init(p + pos, packed);
      lz.run(rc, out, dict, out.size() + unpacked, fmt);
      pos += packed;
    }
    if (delta) {  // byte-wise delta over the block, distance `delta`
      for (size_t i = start + delta; i < out.size(); ++i)
        out[i] = static_cast<uint8_t>(out[i] + out[i - delta]);
    }
    // Block padding to 4 bytes (the stream header is 12), then the check.
    while (pos & 3) ++pos;
    pos += size_t(check);
  }
  out.resize(base + want);
}

}  // namespace tracy_image
