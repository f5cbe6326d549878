// Zstandard frames (RFC 8878), as libzstd decodes them for libtiff's ZSTD
// codec (TIFF compression 50000: each strip or tile a zstd frame): frame
// headers, raw, RLE and compressed blocks; literals raw, RLE, or Huffman
// coded in one or four streams with their tree (FSE-coded or direct
// weights, or the previous block's); sequences with the predefined, RLE,
// FSE-coded or repeated tables of literal lengths, offsets and match
// lengths, and the three repeat offsets. Skippable frames are skipped;
// dictionaries are refused by name; the content checksum is not verified.

#include "image_common.h"

namespace {

[[noreturn]] void bad(const char* fmt, const char* what) {
  fail(std::string(fmt) + ": zstd " + what);
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// Bits read from the end of a stream toward its start: the last byte's
// highest set bit marks the end; positions below 0 read as zeros (a stream
// that has been read past its start is "overflowed").
struct BackBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t pos = 0;  // bits left
  const char* fmt = "";

  void init(const uint8_t* data, size_t len, const char* f) {
    fmt = f;
    if (len == 0 || data[len - 1] == 0) bad(fmt, "bitstream without its end mark");
    p = data, n = len;
    pos = int64_t(len - 1) * 8 + highbit(data[len - 1]);
  }
  uint32_t peek(int k) const {  // k <= 32
    const int64_t start = pos - k;
    uint64_t word = 0;
    if (start >= 0) {
      const size_t lo = size_t(start >> 3);
      for (size_t i = 0; i < 8 && lo + i < n; ++i) word |= uint64_t(p[lo + i]) << (8 * i);
      return uint32_t((word >> (start & 7)) & ((uint64_t(1) << k) - 1));
    }
    uint32_t v = 0;
    for (int j = k - 1; j >= 0; --j) {
      const int64_t b = start + j;
      v = v << 1 | (b >= 0 ? (p[b >> 3] >> (b & 7)) & 1 : 0);
    }
    return v;
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    pos -= k;
    return v;
  }
  bool overflowed() const { return pos < 0; }
};

// ---------------------------------------------------------------- FSE

struct Fse {
  int log = 0;
  std::vector<uint8_t> sym, bits;
  std::vector<uint16_t> base;

  void build(const int16_t* norm, int nsym, int al, const char* fmt) {
    const int size = 1 << al;
    log = al;
    sym.assign(size, 0), bits.assign(size, 0), base.assign(size, 0);
    std::vector<uint32_t> next(nsym);
    int high = size - 1;
    for (int s = 0; s < nsym; ++s)
      if (norm[s] == -1) sym[high--] = uint8_t(s), next[s] = 1;
    const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    int pos = 0;
    for (int s = 0; s < nsym; ++s) {
      if (norm[s] <= 0) continue;
      next[s] = uint32_t(norm[s]);
      for (int i = 0; i < norm[s]; ++i) {
        sym[pos] = uint8_t(s);
        do pos = (pos + step) & mask;
        while (pos > high);
      }
    }
    if (pos != 0) bad(fmt, "FSE table is malformed");
    for (int u = 0; u < size; ++u) {
      const uint32_t ns = next[sym[u]]++;
      bits[u] = uint8_t(al - highbit(ns));
      base[u] = uint16_t((ns << bits[u]) - size);
    }
  }
  void rle(int s) {
    log = 0;
    sym.assign(1, uint8_t(s)), bits.assign(1, 0), base.assign(1, 0);
  }
};

struct FseState {
  const Fse* t;
  uint32_t state;
  void init(const Fse& table, BackBits& in) { t = &table, state = in.read(table.log); }
  int symbol() const { return t->sym[state]; }
  void update(BackBits& in) { state = t->base[state] + in.read(t->bits[state]); }
};

// An FSE table description at p[0, n): the normalized counts of up to
// `max_sym` + 1 symbols, accuracy log at most `max_log`. Returns its bytes.
size_t read_fse(const uint8_t* p, size_t n, int max_sym, int max_log, Fse& out, const char* fmt) {
  size_t bitpos = 0;
  auto peek = [&](int k) {
    uint32_t v = 0;
    for (int j = 0; j < k; ++j) {
      const size_t b = bitpos + j;
      if ((b >> 3) < n) v |= uint32_t((p[b >> 3] >> (b & 7)) & 1) << j;
    }
    return v;
  };
  auto take = [&](int k) {
    const uint32_t v = peek(k);
    bitpos += k;
    return v;
  };
  const int al = int(take(4)) + 5;
  if (al > max_log) bad(fmt, "FSE accuracy log too large");
  int16_t norm[256] = {};
  int remaining = (1 << al) + 1, threshold = 1 << al, nbits = al + 1, s = 0;
  bool previous0 = false;
  while (remaining > 1 && s <= max_sym) {
    if (previous0) {
      int n0 = s;
      for (;;) {
        const int r = int(take(2));
        n0 += r;
        if (r != 3) break;
      }
      if (n0 > max_sym + 1) bad(fmt, "FSE table has too many symbols");
      while (s < n0) norm[s++] = 0;
      if (s > max_sym) break;
    }
    const int maxv = (2 * threshold - 1) - remaining;
    int count;
    const uint32_t v = peek(nbits);
    if (int(v & (threshold - 1)) < maxv) {
      count = int(v & (threshold - 1));
      bitpos += nbits - 1;
    } else {
      count = int(v & (2 * threshold - 1));
      if (count >= threshold) count -= maxv;
      bitpos += nbits;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[s++] = int16_t(count);
    previous0 = count == 0;
    while (remaining < threshold) nbits--, threshold >>= 1;
  }
  if (remaining != 1 || s > max_sym + 1) bad(fmt, "FSE table counts are malformed");
  const size_t used = (bitpos + 7) >> 3;
  if (used > n) bad(fmt, "FSE table description ends early");
  out.build(norm, s, al, fmt);
  return used;
}

// ---------------------------------------------------------------- Huffman

struct Huff {
  int log = 0;
  std::vector<uint8_t> sym, bits;
  bool ready = false;

  void build(const uint8_t* w, int nsym, const char* fmt) {
    uint32_t sum = 0;
    for (int s = 0; s < nsym; ++s) {
      if (w[s] > 11) bad(fmt, "Huffman weight above 11");
      if (w[s]) sum += 1u << (w[s] - 1);
    }
    if (sum == 0) bad(fmt, "Huffman weights are all zero");
    log = highbit(sum) + 1;
    const uint32_t rest = (1u << log) - sum;
    if (rest & (rest - 1)) bad(fmt, "Huffman weights do not complete a tree");
    std::vector<uint8_t> weights(w, w + nsym);
    weights.push_back(uint8_t(highbit(rest) + 1));
    if (log > 11) bad(fmt, "Huffman codes longer than 11 bits");
    int rank[13] = {};
    for (uint8_t x : weights) rank[x]++;
    int start[13] = {}, next = 0;
    for (int k = 1; k <= log; ++k) start[k] = next, next += rank[k] << (k - 1);
    sym.assign(size_t(1) << log, 0), bits.assign(size_t(1) << log, 0);
    for (size_t s = 0; s < weights.size(); ++s) {
      const int wt = weights[s];
      if (!wt) continue;
      const int len = 1 << (wt - 1);
      for (int i = 0; i < len; ++i)
        sym[start[wt] + i] = uint8_t(s), bits[start[wt] + i] = uint8_t(log + 1 - wt);
      start[wt] += len;
    }
    ready = true;
  }
  void decode(const uint8_t* p, size_t n, uint8_t* out, size_t count, const char* fmt) const {
    BackBits in;
    in.init(p, n, fmt);
    for (size_t i = 0; i < count; ++i) {
      const uint32_t k = in.peek(log);
      out[i] = sym[k];
      in.pos -= bits[k];
    }
    if (in.pos != 0) bad(fmt, "Huffman stream not used up exactly");
  }
};

// The tree description at p[0, n); returns its bytes.
size_t read_huff(const uint8_t* p, size_t n, Huff& h, const char* fmt) {
  if (n < 1) bad(fmt, "Huffman tree description ends early");
  const int head = p[0];
  uint8_t w[256] = {};
  int nw = 0;
  size_t used;
  if (head >= 128) {
    nw = head - 127;
    used = 1 + size_t(nw + 1) / 2;
    if (used > n) bad(fmt, "Huffman weights end early");
    for (int i = 0; i < nw; ++i) w[i] = uint8_t(i & 1 ? p[1 + i / 2] & 15 : p[1 + i / 2] >> 4);
  } else {
    used = 1 + size_t(head);
    if (used > n) bad(fmt, "Huffman weights end early");
    Fse t;
    const size_t d = read_fse(p + 1, head, 255, 6, t, fmt);
    if (d >= size_t(head)) bad(fmt, "Huffman weights end early");
    BackBits in;
    in.init(p + 1 + d, head - d, fmt);
    FseState s1, s2;
    s1.init(t, in), s2.init(t, in);
    for (;;) {
      if (nw > 254) bad(fmt, "too many Huffman weights");
      w[nw++] = uint8_t(s1.symbol());
      s1.update(in);
      if (in.overflowed()) {
        w[nw++] = uint8_t(s2.symbol());
        break;
      }
      if (nw > 254) bad(fmt, "too many Huffman weights");
      w[nw++] = uint8_t(s2.symbol());
      s2.update(in);
      if (in.overflowed()) {
        if (nw > 254) bad(fmt, "too many Huffman weights");
        w[nw++] = uint8_t(s1.symbol());
        break;
      }
    }
  }
  h.build(w, nw, fmt);
  return used;
}

// ---------------------------------------------------------------- sequences

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Frame {
  Huff huff;
  Fse ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint32_t rep[3] = {1, 4, 8};
  const char* fmt;
  std::vector<uint8_t> lit;

  // One table of a sequences section at p[0, n) by its mode; returns bytes.
  size_t table(int mode, const uint8_t* p, size_t n, Fse& t, bool& have, const int16_t* dflt,
               int dsym, int dlog, int max_sym, int max_log) {
    switch (mode) {
      case 0: t.build(dflt, dsym, dlog, fmt); have = true; return 0;
      case 1:
        if (n < 1) bad(fmt, "sequences section ends early");
        if (p[0] > max_sym) bad(fmt, "RLE symbol out of range");
        t.rle(p[0]);
        have = true;
        return 1;
      case 2: have = true; return read_fse(p, n, max_sym, max_log, t, fmt);
      default:
        if (!have) bad(fmt, "repeated table without a previous one");
        return 0;
    }
  }

  void block(const uint8_t* p, size_t n, std::vector<uint8_t>& out, size_t base) {
    // Literals section.
    if (n < 1) bad(fmt, "block ends early");
    const int type = p[0] & 3, sf = (p[0] >> 2) & 3;
    size_t regen, comp = 0, head;
    auto le = [&](int k) {
      if (size_t(k) > n) bad(fmt, "literals header ends early");
      uint64_t v = 0;
      for (int i = 0; i < k; ++i) v |= uint64_t(p[i]) << (8 * i);
      return v;
    };
    if (type < 2) {
      if ((sf & 1) == 0) head = 1, regen = p[0] >> 3;
      else if (sf == 1) head = 2, regen = size_t(le(2) >> 4);
      else head = 3, regen = size_t(le(3) >> 4);
    } else {
      const int hb = sf < 2 ? 3 : sf == 2 ? 4 : 5, sb = sf < 2 ? 10 : sf == 2 ? 14 : 18;
      const uint64_t h = le(hb);
      head = size_t(hb);
      regen = size_t((h >> 4) & ((1u << sb) - 1));
      comp = size_t((h >> (4 + sb)) & ((1u << sb) - 1));
    }
    if (regen > (size_t(128) << 10)) bad(fmt, "literals above the block maximum");
    lit.resize(regen);
    size_t at = head;
    if (type == 0) {
      if (at + regen > n) bad(fmt, "raw literals end early");
      std::memcpy(lit.data(), p + at, regen);
      at += regen;
    } else if (type == 1) {
      if (at + 1 > n) bad(fmt, "RLE literals end early");
      std::memset(lit.data(), p[at], regen);
      at += 1;
    } else {
      if (at + comp > n) bad(fmt, "compressed literals end early");
      const uint8_t* q = p + at;
      size_t qn = comp;
      if (type == 2) {
        const size_t d = read_huff(q, qn, huff, fmt);
        q += d, qn -= d;
      } else if (!huff.ready) {
        bad(fmt, "treeless literals without a previous tree");
      }
      if (sf == 0) {
        huff.decode(q, qn, lit.data(), regen, fmt);
      } else {
        if (qn < 6) bad(fmt, "literal streams end early");
        const size_t s1 = q[0] | q[1] << 8, s2 = q[2] | q[3] << 8, s3 = q[4] | q[5] << 8;
        if (6 + s1 + s2 + s3 > qn) bad(fmt, "literal streams end early");
        const size_t s4 = qn - 6 - s1 - s2 - s3, seg = (regen + 3) / 4;
        if (3 * seg > regen) bad(fmt, "too few literals for four streams");
        const uint8_t* s = q + 6;
        huff.decode(s, s1, lit.data(), seg, fmt);
        huff.decode(s + s1, s2, lit.data() + seg, seg, fmt);
        huff.decode(s + s1 + s2, s3, lit.data() + 2 * seg, seg, fmt);
        huff.decode(s + s1 + s2 + s3, s4, lit.data() + 3 * seg, regen - 3 * seg, fmt);
      }
      at += comp;
    }
    // Sequences section.
    if (at >= n) bad(fmt, "sequences section ends early");
    size_t nseq = p[at];
    if (nseq < 128) {
      at += 1;
    } else if (nseq < 255) {
      if (at + 2 > n) bad(fmt, "sequences section ends early");
      nseq = ((nseq - 128) << 8) + p[at + 1];
      at += 2;
    } else {
      if (at + 3 > n) bad(fmt, "sequences section ends early");
      nseq = p[at + 1] + (size_t(p[at + 2]) << 8) + 0x7F00;
      at += 3;
    }
    size_t li = 0;
    if (nseq) {
      if (at >= n) bad(fmt, "sequences section ends early");
      const int modes = p[at++];
      if (modes & 3) bad(fmt, "reserved sequence mode bits set");
      at += table(modes >> 6, p + at, n - at, ll, have_ll, kLLDefault, 36, 6, 35, 9);
      at += table((modes >> 4) & 3, p + at, n - at, of, have_of, kOFDefault, 29, 5, 31, 8);
      at += table((modes >> 2) & 3, p + at, n - at, ml, have_ml, kMLDefault, 53, 6, 52, 9);
      if (at >= n) bad(fmt, "sequences bitstream missing");
      BackBits in;
      in.init(p + at, n - at, fmt);
      FseState sll, sof, sml;
      sll.init(ll, in), sof.init(of, in), sml.init(ml, in);
      for (size_t i = 0; i < nseq; ++i) {
        const int oc = sof.symbol(), mc = sml.symbol(), lc = sll.symbol();
        if (oc > 31 || mc > 52 || lc > 35) bad(fmt, "sequence code out of range");
        const uint32_t ov = (1u << oc) + in.read(oc);
        const uint32_t mlen = kMLBase[mc] + in.read(kMLBits[mc]);
        const uint32_t llen = kLLBase[lc] + in.read(kLLBits[lc]);
        if (i + 1 < nseq) sll.update(in), sml.update(in), sof.update(in);
        uint32_t off;
        if (ov > 3) {
          off = ov - 3;
          rep[2] = rep[1], rep[1] = rep[0], rep[0] = off;
        } else {
          const uint32_t idx = ov - 1 + (llen == 0 ? 1 : 0);
          if (idx == 0) {
            off = rep[0];
          } else {
            off = idx == 3 ? rep[0] - 1 : rep[idx];
            if (idx >= 2) rep[2] = rep[1];
            rep[1] = rep[0];
            rep[0] = off;
          }
        }
        if (li + llen > lit.size()) bad(fmt, "sequence past its literals");
        out.insert(out.end(), lit.begin() + li, lit.begin() + li + llen);
        li += llen;
        if (off == 0 || off > out.size() - base) bad(fmt, "offset before the start of the frame");
        for (uint32_t k = 0; k < mlen; ++k) out.push_back(out[out.size() - off]);
      }
      if (in.pos != 0) bad(fmt, "sequences bitstream not used up exactly");
    }
    out.insert(out.end(), lit.begin() + li, lit.end());
  }
};

}  // namespace

namespace tracy_image {

void zstd_decode(const uint8_t* p, size_t n, std::vector<uint8_t>& out, size_t want,
                 const char* fmt) {
  const size_t start = out.size();
  size_t pos = 0;
  while (out.size() - start < want) {
    if (pos + 4 > n) bad(fmt, "data ends early");
    const uint32_t magic = p[pos] | p[pos + 1] << 8 | p[pos + 2] << 16 | uint32_t(p[pos + 3]) << 24;
    pos += 4;
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
      if (pos + 4 > n) bad(fmt, "data ends early");
      pos += 4 + size_t(p[pos] | p[pos + 1] << 8 | p[pos + 2] << 16 | uint32_t(p[pos + 3]) << 24);
      continue;
    }
    if (magic != 0xFD2FB528u) bad(fmt, "frame magic number missing");
    if (pos >= n) bad(fmt, "frame header ends early");
    const int d = p[pos++];
    const int fcs = d >> 6, single = (d >> 5) & 1, checksum = (d >> 2) & 1, dict = d & 3;
    if (d & 8) bad(fmt, "reserved frame header bit set");
    if (!single) pos += 1;  // window descriptor
    static const int kDictBytes[4] = {0, 1, 2, 4};
    static const int kFcsBytes[4] = {0, 2, 4, 8};
    uint32_t dict_id = 0;
    for (int i = 0; i < kDictBytes[dict]; ++i) {
      if (pos >= n) bad(fmt, "frame header ends early");
      dict_id |= uint32_t(p[pos++]) << (8 * i);
    }
    if (dict_id) bad(fmt, "dictionaries not read");
    pos += size_t(fcs == 0 ? single : kFcsBytes[fcs]);
    Frame f;
    f.fmt = fmt;
    const size_t base = out.size();
    for (;;) {
      if (pos + 3 > n) bad(fmt, "block header ends early");
      const uint32_t h = p[pos] | p[pos + 1] << 8 | p[pos + 2] << 16;
      pos += 3;
      const int last = h & 1, type = (h >> 1) & 3;
      const size_t size = h >> 3;
      if (type == 3) bad(fmt, "reserved block type");
      if (type == 1) {
        if (pos + 1 > n) bad(fmt, "RLE block ends early");
        out.insert(out.end(), size, p[pos]);
        pos += 1;
      } else {
        if (pos + size > n) bad(fmt, "block ends early");
        if (type == 0) out.insert(out.end(), p + pos, p + pos + size);
        else f.block(p + pos, size, out, base);
        pos += size;
      }
      if (last) break;
    }
    if (checksum) pos += 4;
  }
  out.resize(start + want);
}

}  // namespace tracy_image
