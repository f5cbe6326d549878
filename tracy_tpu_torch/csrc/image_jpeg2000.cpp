// JPEG 2000 decoding on the host, for the texture loader and read_image:
// JP2 files and raw codestreams (ITU-T T.800, Part 1), as PIL's
// open(...).convert("RGBA") gives them. PIL decodes through OpenJPEG, tile
// by tile (opj_read_tile_header, opj_decode_tile_data), at reduce 0 with
// every layer, and unpacks each tile's components itself
// (Jpeg2KDecode.c); this source computes what OpenJPEG 2.5 computes and
// then what PIL's unpackers and convert("RGBA") make of it.
//
// Built into the same library as image_decode.cpp (utils/native.py::
// get_image_lib), with its conventions: `tracy_jpeg2000_info` (width and
// height) and `tracy_jpeg2000_decode` (RGBA8 [h, w, 4]) return 0, 1 for a
// fault of the file, or 2 for a failure inside the decoder, with the
// message in tracy_decode_error().
//
// Containers: a raw codestream (size and mode from SIZ, as PIL's
//   _parse_codestream: one component L, or I;16 above 8 bits; two LA,
//   three RGB, four RGBA), or a JP2 file (the signature and ftyp boxes
//   first, as OpenJPEG requires; jp2h with ihdr, colr, pclr and cmap
//   checked as OpenJPEG checks them and read as PIL's _parse_jp2_header:
//   colr enumerated space 12 with four components is CMYK, pclr on L/LA is
//   P/PA; then jp2c, of the size the header says). OpenJPEG's colour space
//   is the first colr box's (16 sRGB, 17 grey, 18 sYCC, 24 eYCC, 12 CMYK);
//   else, and in a raw codestream, PIL takes it from the component count,
//   but sYCC where the first component is whole and the second or third
//   subsampled. cmap, cdef and res are not applied (PIL's tile path
//   applies none of them).
// Codestream: SIZ (image and tile offsets, subsampling, up to 31 bits),
//   COD/COC and QCD/QCC in the main and first tile-part headers in marker
//   order (a COD or QCD resets every component, as OpenJPEG copies it), RGN,
//   POC (main and tile, appended), PPM and PPT (merged in index order;
//   Nppm fields dropped, each whole within a marker), TLM/PLM/PLT/CRG/COM
//   skipped, tiles in several tile-parts (their data joined), EOC
//   required. Tier 2: the five progression orders
//   with OpenJPEG's packet iterator (one inclusion array across the POC
//   progressions), tag trees, inclusion, zero bit-planes, pass counts,
//   Lblock, SOP/EPH (skipped where present), bit stuffing; a segment
//   longer than the data left is refused (OpenJPEG's strict mode).
//   Tier 1: the MQ decoder and its 47 states, the significance,
//   refinement and cleanup passes with the contexts of Annex D and
//   OpenJPEG's orientation table, run-length mode, and every code-block
//   style (bypass, reset, termall, vertically causal, predictable
//   termination, segmentation symbols); OpenJPEG's ROI max-shift on the
//   doubled coefficients.
// Reconstruction: dequantisation (none, scalar derived, scalar expounded;
//   Delta_b with OpenJPEG's gain of 0 for the 9/7), the inverse 5/3 in
//   integers and the inverse 9/7 in float32 in OpenJPEG's order of lifting
//   steps and scalings (K and 2/K), the inverse RCT or ICT on the first
//   three components, the DC level shift with lrintf rounding and the clamp
//   to each component's precision; only the resolutions decoded
//   (resno_decoded) are transformed, as OpenJPEG does.
// To 8 bits: OpenJPEG's tile buffer (1, 2 or 4 bytes a sample), then PIL's
//   unpackers (the precision shift with its rounding, the signed offset,
//   subsampled components indexed as PIL indexes them, results truncated
//   to 8 bits as PIL stores them), sYCC through PIL's YCbCr tables, CMYK
//   through PIL's cmyk2rgb, a palette's indices (black past its entries).
//   A grey file above
//   8 bits (PIL's I;16, which convert clips to 255) keeps the high byte
//   (ROADMAP, hazards); a pclr palette with a repeated entry, which PIL
//   folds and so maps later indices to other colours, is read as the file
//   says, and so is one of one or two columns (grey, grey + alpha), which
//   PIL maps to black.
//
// Refused by name: HTJ2K (Part 15: the CAP or CPF marker, Rsiz bit 14,
// code-block style bit 6), Part 2 extensions (the MCT, MCC, MCO, CBD, DFS,
// ADS, ATK and NLT markers), a pclr of more than 4 columns, and what PIL
// or OpenJPEG refuse: more than four components,
// a mode and colour space without PIL's unpacker, precision above 31 bits,
// truncated data, a JP2 header whose size is not the codestream's, sizes
// beyond kMaxPixels.

#include <array>
#include <cstdio>

#include "image_common.h"

namespace {

const char* const kFmt = "JPEG 2000";

constexpr int kMaxRes = 33;
constexpr int kMaxBands = 3 * kMaxRes - 2;

inline int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t ceildivpow2(int64_t a, int s) { return (a + (int64_t(1) << s) - 1) >> s; }
inline int floorlog2(uint32_t v) {
  int l = 0;
  while (v > 1) {
    v >>= 1;
    ++l;
  }
  return l;
}

// ---------------------------------------------------------------- markers

struct CompSiz {
  int prec;
  bool sgnd;
  int dx, dy;
};

// Coding style and quantisation of one component (OpenJPEG's opj_tccp_t).
struct Tccp {
  int numres = 6;
  int cbw = 6, cbh = 6;
  int cblksty = 0;
  int qmfbid = 0;
  int prcw[kMaxRes], prch[kMaxRes];
  int qntsty = 0, guard = 0;
  int expn[kMaxBands] = {}, mant[kMaxBands] = {};
  int roishift = 0;
  Tccp() {
    for (int r = 0; r < kMaxRes; ++r) prcw[r] = prch[r] = 15;
  }
};

struct Poc {
  int res0, comp0, lay1, res1, comp1, prg;
};

// One tile's parameters (OpenJPEG's opj_tcp_t).
struct Tcp {
  int csty = 0;  // bit 1: SOP, bit 2: EPH
  int prg = 0;
  int layers = 1;
  int mct = 0;
  std::vector<Tccp> tccps;
  std::vector<Poc> pocs;
  std::vector<std::vector<uint8_t>> ppt;  // by Zppt
};

struct TilePart {
  size_t header, header_end;  // markers between SOT and SOD
  size_t data, data_end;
};

struct Codestream {
  const uint8_t* p = nullptr;
  size_t n = 0;
  uint32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0, tdx = 0, tdy = 0, tx0 = 0, ty0 = 0;
  int ntx = 0, nty = 0;
  std::vector<CompSiz> comps;
  Tcp deflt;
  std::vector<std::vector<uint8_t>> ppm;  // by Zppm
  bool has_ppm = false;
  std::vector<std::vector<TilePart>> parts;  // by tile index
  std::vector<int> order;                    // tiles by first appearance
};

struct Reader {
  const uint8_t* p;
  size_t at, end;
  void need(size_t k) const {
    if (k > end - at) fail("JPEG 2000: marker segment is truncated");
  }
  uint32_t u8() {
    need(1);
    return p[at++];
  }
  uint32_t u16() {
    need(2);
    const uint32_t v = uint32_t(p[at]) << 8 | p[at + 1];
    at += 2;
    return v;
  }
  uint32_t u32() {
    const uint32_t hi = u16();
    return hi << 16 | u16();
  }
  uint32_t comp_index(size_t ncomp) { return ncomp <= 256 ? u8() : u16(); }
};

[[noreturn]] void refuse_marker(uint32_t m) {
  char buf[8];
  std::snprintf(buf, sizeof buf, "%04X", m);
  if (m == 0xFF50 || m == 0xFF59) {
    fail(std::string("JPEG 2000: HTJ2K (Part 15) is not read (marker ") + buf + ")");
  }
  fail(std::string("JPEG 2000: Part 2 extension marker ") + buf + " is not read");
}

bool is_part2_marker(uint32_t m) {
  return m == 0xFF74 || m == 0xFF75 || m == 0xFF77 || m == 0xFF78 || m == 0xFF72 ||
         m == 0xFF73 || m == 0xFF79 || m == 0xFF76;
}

void read_spcod(Reader& r, Tccp& t, bool precincts) {
  const int levels = static_cast<int>(r.u8());
  if (levels + 1 > kMaxRes) fail(std::string("JPEG 2000: ") + std::to_string(levels) + " decomposition levels");
  t.numres = levels + 1;
  t.cbw = static_cast<int>(r.u8()) + 2;
  t.cbh = static_cast<int>(r.u8()) + 2;
  if (t.cbw > 10 || t.cbh > 10 || t.cbw + t.cbh > 12) fail("JPEG 2000: code-block size out of range");
  t.cblksty = static_cast<int>(r.u8());
  if (t.cblksty & 0x40) fail("JPEG 2000: HTJ2K (Part 15) code-blocks are not read");
  if (t.cblksty & 0x80) fail("JPEG 2000: code-block style bit 7 is not read");
  t.qmfbid = static_cast<int>(r.u8());
  if (t.qmfbid > 1) fail("JPEG 2000: wavelet " + std::to_string(t.qmfbid) + " (Part 2) is not read");
  for (int k = 0; k < kMaxRes; ++k) t.prcw[k] = t.prch[k] = 15;
  if (precincts) {
    for (int k = 0; k < t.numres; ++k) {
      const uint32_t v = r.u8();
      t.prcw[k] = v & 0xF;
      t.prch[k] = v >> 4;
      if (k > 0 && (t.prcw[k] == 0 || t.prch[k] == 0)) fail("JPEG 2000: invalid precinct size");
    }
  }
}

void copy_coding(Tccp& to, const Tccp& from) {
  to.numres = from.numres;
  to.cbw = from.cbw;
  to.cbh = from.cbh;
  to.cblksty = from.cblksty;
  to.qmfbid = from.qmfbid;
  std::memcpy(to.prcw, from.prcw, sizeof to.prcw);
  std::memcpy(to.prch, from.prch, sizeof to.prch);
}

void read_sqcd(Reader& r, Tccp& t) {
  const uint32_t s = r.u8();
  t.qntsty = s & 0x1F;
  t.guard = static_cast<int>(s >> 5);
  if (t.qntsty > 2) fail("JPEG 2000: quantisation style " + std::to_string(t.qntsty));
  const size_t left = r.end - r.at;
  const size_t nb = t.qntsty == 0 ? left : t.qntsty == 1 ? 1 : left / 2;
  for (size_t k = 0; k < nb; ++k) {
    if (t.qntsty == 0) {
      const uint32_t v = r.u8();
      if (k < size_t(kMaxBands)) {
        t.expn[k] = static_cast<int>(v >> 3);
        t.mant[k] = 0;
      }
    } else {
      const uint32_t v = r.u16();
      if (k < size_t(kMaxBands)) {
        t.expn[k] = static_cast<int>(v >> 11);
        t.mant[k] = static_cast<int>(v & 0x7FF);
      }
    }
  }
  if (t.qntsty == 1) {
    for (int k = 1; k < kMaxBands; ++k) {
      t.expn[k] = std::max(0, t.expn[0] - (k - 1) / 3);
      t.mant[k] = t.mant[0];
    }
  }
}

void copy_quant(Tccp& to, const Tccp& from) {
  to.qntsty = from.qntsty;
  to.guard = from.guard;
  std::memcpy(to.expn, from.expn, sizeof to.expn);
  std::memcpy(to.mant, from.mant, sizeof to.mant);
}

// One marker segment of the main header or of a tile-part header.
void read_segment(Codestream& cs, Tcp& tcp, bool main, uint32_t m, Reader r) {
  const size_t nc = cs.comps.size();
  switch (m) {
    case 0xFF52: {  // COD
      const uint32_t scod = r.u8();
      tcp.csty = static_cast<int>(scod);
      tcp.prg = static_cast<int>(r.u8());
      if (tcp.prg > 4) fail("JPEG 2000: progression order " + std::to_string(tcp.prg));
      tcp.layers = static_cast<int>(r.u16());
      if (tcp.layers == 0) fail("JPEG 2000: no quality layers");
      tcp.mct = static_cast<int>(r.u8());
      if (tcp.mct > 1) fail("JPEG 2000: multiple component transform " + std::to_string(tcp.mct));
      read_spcod(r, tcp.tccps[0], scod & 1);
      for (size_t c = 1; c < nc; ++c) copy_coding(tcp.tccps[c], tcp.tccps[0]);
      break;
    }
    case 0xFF53: {  // COC
      const uint32_t c = r.comp_index(nc);
      if (c >= nc) fail("JPEG 2000: COC of component " + std::to_string(c));
      const uint32_t scoc = r.u8();
      read_spcod(r, tcp.tccps[c], scoc & 1);
      break;
    }
    case 0xFF5C:  // QCD
      read_sqcd(r, tcp.tccps[0]);
      for (size_t c = 1; c < nc; ++c) copy_quant(tcp.tccps[c], tcp.tccps[0]);
      break;
    case 0xFF5D: {  // QCC
      const uint32_t c = r.comp_index(nc);
      if (c >= nc) fail("JPEG 2000: QCC of component " + std::to_string(c));
      read_sqcd(r, tcp.tccps[c]);
      break;
    }
    case 0xFF5E: {  // RGN
      const uint32_t c = r.comp_index(nc);
      if (c >= nc) fail("JPEG 2000: RGN of component " + std::to_string(c));
      if (r.u8() != 0) fail("JPEG 2000: RGN style other than max-shift");
      tcp.tccps[c].roishift = static_cast<int>(r.u8());
      break;
    }
    case 0xFF5F: {  // POC
      const size_t entry = nc <= 256 ? 7 : 9;
      const size_t count = (r.end - r.at) / entry;
      if (count == 0) fail("JPEG 2000: empty POC marker");
      for (size_t k = 0; k < count; ++k) {
        Poc p;
        p.res0 = static_cast<int>(r.u8());
        p.comp0 = static_cast<int>(r.comp_index(nc));
        p.lay1 = static_cast<int>(r.u16());
        p.res1 = static_cast<int>(r.u8());
        p.comp1 = static_cast<int>(std::min<uint32_t>(r.comp_index(nc), uint32_t(nc)));
        p.prg = static_cast<int>(r.u8());
        if (p.prg > 4) fail("JPEG 2000: POC progression order " + std::to_string(p.prg));
        tcp.pocs.push_back(p);
      }
      break;
    }
    case 0xFF60: {  // PPM
      if (!main) fail("JPEG 2000: PPM in a tile-part header");
      const uint32_t z = r.u8();
      if (cs.ppm.size() <= z) cs.ppm.resize(z + 1);
      if (!cs.ppm[z].empty()) fail("JPEG 2000: PPM marker " + std::to_string(z) + " read twice");
      cs.ppm[z].assign(r.p + r.at, r.p + r.end);
      cs.has_ppm = true;
      break;
    }
    case 0xFF61: {  // PPT
      if (main) fail("JPEG 2000: PPT in the main header");
      const uint32_t z = r.u8();
      if (tcp.ppt.size() <= z) tcp.ppt.resize(z + 1);
      if (!tcp.ppt[z].empty()) fail("JPEG 2000: PPT marker " + std::to_string(z) + " read twice");
      tcp.ppt[z].assign(r.p + r.at, r.p + r.end);
      break;
    }
    case 0xFF50:
    case 0xFF59:
      refuse_marker(m);
    default:
      if (is_part2_marker(m)) refuse_marker(m);
      break;  // TLM, PLM, PLT, CRG, COM and unknown markers: skipped
  }
}

// Walks marker segments from `at` to the next SOT, SOD or EOC (returned,
// with `at` on it). Each segment goes to read_segment.
uint32_t read_markers(Codestream& cs, Tcp& tcp, bool main, size_t& at, size_t end) {
  for (;;) {
    if (at + 2 > end) fail("JPEG 2000: codestream is truncated");
    const uint32_t m = uint32_t(cs.p[at]) << 8 | cs.p[at + 1];
    if (m == 0xFF90 || m == 0xFF93 || m == 0xFFD9) return m;
    if (m < 0xFF00) fail("JPEG 2000: expected a marker in the header");
    if (at + 4 > end) fail("JPEG 2000: codestream is truncated");
    const uint32_t len = uint32_t(cs.p[at + 2]) << 8 | cs.p[at + 3];
    if (len < 2 || at + 2 + len > end) fail("JPEG 2000: marker segment is truncated");
    read_segment(cs, tcp, main, m, Reader{cs.p, at + 4, at + 2 + len});
    at += 2 + len;
  }
}

void read_siz(Codestream& cs, size_t& at) {
  if (cs.n < 4 || cs.p[0] != 0xFF || cs.p[1] != 0x4F || cs.p[2] != 0xFF || cs.p[3] != 0x51) {
    fail("JPEG 2000: codestream does not start with SOC and SIZ");
  }
  if (cs.n < 6) fail("JPEG 2000: codestream is truncated");
  const uint32_t len = uint32_t(cs.p[4]) << 8 | cs.p[5];
  if (len < 41 || 4 + len > cs.n) fail("JPEG 2000: SIZ is truncated");
  Reader r{cs.p, 6, 4 + len};
  if (r.u16() & 0x4000) fail("JPEG 2000: HTJ2K (Part 15) is not read (Rsiz bit 14)");
  cs.x1 = r.u32();
  cs.y1 = r.u32();
  cs.x0 = r.u32();
  cs.y0 = r.u32();
  cs.tdx = r.u32();
  cs.tdy = r.u32();
  cs.tx0 = r.u32();
  cs.ty0 = r.u32();
  const uint32_t ncomp = r.u16();
  if (ncomp == 0 || ncomp > 16384) fail("JPEG 2000: SIZ with " + std::to_string(ncomp) + " components");
  if (len != 38 + 3 * ncomp) fail("JPEG 2000: SIZ length does not match its components");
  if (cs.x0 >= cs.x1 || cs.y0 >= cs.y1 || cs.tdx == 0 || cs.tdy == 0 || cs.tx0 > cs.x0 ||
      cs.ty0 > cs.y0 || uint64_t(cs.tx0) + cs.tdx <= cs.x0 || uint64_t(cs.ty0) + cs.tdy <= cs.y0) {
    fail("JPEG 2000: SIZ with an invalid image or tile grid");
  }
  for (uint32_t c = 0; c < ncomp; ++c) {
    const uint32_t s = r.u8();
    CompSiz k;
    k.prec = static_cast<int>(s & 0x7F) + 1;
    k.sgnd = s & 0x80;
    k.dx = static_cast<int>(r.u8());
    k.dy = static_cast<int>(r.u8());
    if (k.dx == 0 || k.dy == 0) fail("JPEG 2000: component subsampling of 0");
    if (k.prec > 31) fail(std::string("JPEG 2000: ") + std::to_string(k.prec) + "-bit components (OpenJPEG reads up to 31)");
    cs.comps.push_back(k);
  }
  const int64_t ntx = ceildiv(int64_t(cs.x1) - cs.tx0, cs.tdx);
  const int64_t nty = ceildiv(int64_t(cs.y1) - cs.ty0, cs.tdy);
  if (ntx * nty > 65535) fail(std::string("JPEG 2000: ") + std::to_string(ntx * nty) + " tiles");
  cs.ntx = static_cast<int>(ntx);
  cs.nty = static_cast<int>(nty);
  cs.deflt.tccps.assign(ncomp, Tccp());
  at = 4 + len;
}

// The main header and every tile-part's place.
void read_codestream(Codestream& cs) {
  size_t at = 0;
  read_siz(cs, at);
  uint32_t m = read_markers(cs, cs.deflt, true, at, cs.n);
  cs.parts.assign(size_t(cs.ntx) * cs.nty, {});
  while (m == 0xFF90) {
    const size_t sot = at;
    Reader r{cs.p, at + 2, cs.n};
    const uint32_t lsot = r.u16();
    if (lsot != 10) fail("JPEG 2000: SOT of length " + std::to_string(lsot));
    const uint32_t isot = r.u16();
    const uint32_t psot = r.u32();
    r.u8();  // TPsot
    r.u8();  // TNsot
    if (isot >= cs.parts.size()) fail("JPEG 2000: tile " + std::to_string(isot) + " beyond the grid");
    // Psot 0: the last tile-part, up to the EOC marker (OpenJPEG).
    const size_t end = psot == 0 ? std::max(cs.n, size_t(2)) - 2 : sot + psot;
    if (psot != 0 && psot < 14) fail("JPEG 2000: tile-part of " + std::to_string(psot) + " bytes");
    if (end > cs.n || end < sot + 14) fail("JPEG 2000: codestream is truncated");
    TilePart tp;
    tp.header = sot + 12;
    size_t hat = tp.header;
    Tcp scratch;  // only the marker walk: each tile's markers are read again in decode
    scratch.tccps.assign(cs.comps.size(), Tccp());
    if (read_markers(cs, scratch, false, hat, end) != 0xFF93) fail("JPEG 2000: tile-part without SOD");
    tp.header_end = hat;
    tp.data = hat + 2;
    tp.data_end = end;
    if (cs.parts[isot].empty()) cs.order.push_back(static_cast<int>(isot));
    cs.parts[isot].push_back(tp);
    at = end;
    if (at + 2 > cs.n) fail("JPEG 2000: codestream does not end with EOC");
    m = uint32_t(cs.p[at]) << 8 | cs.p[at + 1];
  }
  if (m != 0xFFD9) fail("JPEG 2000: expected SOT or EOC");
}

// ---------------------------------------------------------------- tier 2

struct BitIn {  // OpenJPEG's opj_bio: bit stuffing after 0xFF
  const uint8_t* p;
  size_t at, end;
  uint32_t buf = 0;
  int ct = 0;
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (at < end) buf |= p[at++];
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t bits(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) v |= bit() << i;
    return v;
  }
  // opj_bio_inalign: false when the byte after a 0xFF is missing.
  bool align() {
    ct = 0;
    if ((buf & 0xFF) == 0xFF) {
      if (at >= end) return false;
      bytein();
    }
    ct = 0;
    return true;
  }
};

struct TagTree {
  struct Node {
    int parent, value, low;
  };
  std::vector<Node> nodes;
  void init(int w, int h) {
    nodes.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<std::pair<int, int>> levels;
    int lw = w, lh = h;
    for (;;) {
      levels.push_back({lw, lh});
      if (lw * lh <= 1) break;
      lw = (lw + 1) / 2;
      lh = (lh + 1) / 2;
    }
    size_t total = 0;
    for (auto& l : levels) total += size_t(l.first) * l.second;
    nodes.assign(total, {-1, 999, 0});
    size_t base = 0;
    for (size_t k = 0; k + 1 < levels.size(); ++k) {
      const int cw = levels[k].first, ch = levels[k].second, pw = levels[k + 1].first;
      const size_t next = base + size_t(cw) * ch;
      for (int j = 0; j < ch; ++j) {
        for (int i = 0; i < cw; ++i) {
          nodes[base + size_t(j) * cw + i].parent = static_cast<int>(next + size_t(j / 2) * pw + i / 2);
        }
      }
      base = next;
    }
  }
  // opj_tgt_decode: whether the leaf's value is below `threshold`.
  bool decode(BitIn& bio, int leaf, int threshold) {
    int stk[64];
    int sp = 0;
    int node = leaf;
    while (nodes[node].parent >= 0) {
      stk[sp++] = node;
      node = nodes[node].parent;
    }
    int low = 0;
    for (;;) {
      Node& nd = nodes[node];
      if (low > nd.low) {
        nd.low = low;
      } else {
        low = nd.low;
      }
      while (low < threshold && low < nd.value) {
        if (bio.bit()) {
          nd.value = low;
        } else {
          ++low;
        }
      }
      nd.low = low;
      if (sp == 0) break;
      node = stk[--sp];
    }
    return nodes[node].value < threshold;
  }
};

struct Seg {
  uint32_t len = 0;
  int numpasses = 0, maxpasses = 0, newpasses = 0;
  uint32_t newlen = 0;
};

struct Cblk {
  int x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0;
  int numsegs = 0;
  int numnewpasses = 0;
  std::vector<Seg> segs;
  std::vector<uint8_t> data;
};

struct Precinct {
  int cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int bandno;  // 0 LL, 1 HL (x high), 2 LH (y high), 3 HH
  int64_t x0, y0, x1, y1;
  float stepsize;
  int numbps;
  std::vector<Precinct> precincts;
  bool empty() const { return x0 >= x1 || y0 >= y1; }
};

struct Resolution {
  int64_t x0, y0, x1, y1;
  int pdx, pdy, pw, ph;
  std::vector<Band> bands;
};

union Px {
  int32_t i;
  float f;
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  int numres;
  int resno_decoded = 0;
  std::vector<Resolution> res;
  std::vector<Px> data;
};

void init_seg(Cblk& cb, int index, int cblksty, bool first) {
  if (int(cb.segs.size()) <= index) cb.segs.resize(index + 1);
  Seg& s = cb.segs[index];
  s = Seg();
  if (cblksty & 4) {  // termall
    s.maxpasses = 1;
  } else if (cblksty & 1) {  // bypass
    if (first) {
      s.maxpasses = 10;
    } else {
      const int prev = cb.segs[index - 1].maxpasses;
      s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
    }
  } else {
    s.maxpasses = 109;
  }
}

int getnumpasses(BitIn& b) {
  if (!b.bit()) return 1;
  if (!b.bit()) return 2;
  uint32_t n = b.bits(2);
  if (n != 3) return 3 + static_cast<int>(n);
  n = b.bits(5);
  if (n != 31) return 6 + static_cast<int>(n);
  return 37 + static_cast<int>(b.bits(7));
}

// A packet header source: the tile data, or a PPM/PPT stream.
struct HeaderSrc {
  const uint8_t* p;
  size_t at, end;
};

struct TileDecoder {
  const Codestream& cs;
  const Tcp& tcp;
  int64_t tx0, ty0, tx1, ty1;
  std::vector<TileComp> comps;

  TileDecoder(const Codestream& c, const Tcp& t, int tileno) : cs(c), tcp(t) {
    const int p = tileno % cs.ntx, q = tileno / cs.ntx;
    tx0 = std::max<int64_t>(int64_t(cs.tx0) + int64_t(p) * cs.tdx, cs.x0);
    ty0 = std::max<int64_t>(int64_t(cs.ty0) + int64_t(q) * cs.tdy, cs.y0);
    tx1 = std::min<int64_t>(int64_t(cs.tx0) + int64_t(p + 1) * cs.tdx, cs.x1);
    ty1 = std::min<int64_t>(int64_t(cs.ty0) + int64_t(q + 1) * cs.tdy, cs.y1);
    comps.resize(cs.comps.size());
    for (size_t c = 0; c < comps.size(); ++c) init_comp(c);
  }

  void init_comp(size_t c) {
    const CompSiz& k = cs.comps[c];
    const Tccp& tc = tcp.tccps[c];
    TileComp& t = comps[c];
    t.x0 = ceildiv(tx0, k.dx);
    t.y0 = ceildiv(ty0, k.dy);
    t.x1 = ceildiv(tx1, k.dx);
    t.y1 = ceildiv(ty1, k.dy);
    t.numres = tc.numres;
    t.data.assign(size_t(t.x1 - t.x0) * size_t(t.y1 - t.y0), Px{0});
    t.res.resize(t.numres);
    for (int r = 0; r < t.numres; ++r) {
      Resolution& R = t.res[r];
      const int level = t.numres - 1 - r;
      R.x0 = ceildivpow2(t.x0, level);
      R.y0 = ceildivpow2(t.y0, level);
      R.x1 = ceildivpow2(t.x1, level);
      R.y1 = ceildivpow2(t.y1, level);
      R.pdx = tc.prcw[r];
      R.pdy = tc.prch[r];
      const int64_t px0 = (R.x0 >> R.pdx) << R.pdx, py0 = (R.y0 >> R.pdy) << R.pdy;
      const int64_t px1 = ceildivpow2(R.x1, R.pdx) << R.pdx;
      const int64_t py1 = ceildivpow2(R.y1, R.pdy) << R.pdy;
      R.pw = R.x0 == R.x1 ? 0 : static_cast<int>((px1 - px0) >> R.pdx);
      R.ph = R.y0 == R.y1 ? 0 : static_cast<int>((py1 - py0) >> R.pdy);
      if (int64_t(R.pw) * R.ph > (int64_t(1) << 26)) fail("JPEG 2000: too many precincts");
      int64_t cbgx0, cbgy0;
      int cbgw, cbgh;
      if (r == 0) {
        cbgx0 = px0;
        cbgy0 = py0;
        cbgw = R.pdx;
        cbgh = R.pdy;
      } else {
        cbgx0 = ceildivpow2(px0, 1);
        cbgy0 = ceildivpow2(py0, 1);
        cbgw = R.pdx - 1;
        cbgh = R.pdy - 1;
      }
      const int cblkw = std::min(tc.cbw, cbgw), cblkh = std::min(tc.cbh, cbgh);
      const int nbands = r == 0 ? 1 : 3;
      R.bands.resize(nbands);
      for (int b = 0; b < nbands; ++b) {
        Band& B = R.bands[b];
        B.bandno = r == 0 ? 0 : b + 1;
        if (r == 0) {
          B.x0 = ceildivpow2(t.x0, level);
          B.y0 = ceildivpow2(t.y0, level);
          B.x1 = ceildivpow2(t.x1, level);
          B.y1 = ceildivpow2(t.y1, level);
        } else {
          const int xob = B.bandno & 1, yob = B.bandno >> 1;
          B.x0 = ceildivpow2(t.x0 - (int64_t(xob) << level), level + 1);
          B.y0 = ceildivpow2(t.y0 - (int64_t(yob) << level), level + 1);
          B.x1 = ceildivpow2(t.x1 - (int64_t(xob) << level), level + 1);
          B.y1 = ceildivpow2(t.y1 - (int64_t(yob) << level), level + 1);
        }
        const int idx = r == 0 ? 0 : 3 * (r - 1) + B.bandno;
        const int gain = tc.qmfbid == 0 ? 0 : B.bandno == 0 ? 0 : B.bandno == 3 ? 2 : 1;
        const int rb = k.prec + gain;
        B.stepsize = static_cast<float>((1.0 + tc.mant[idx] / 2048.0) *
                                        std::pow(2.0, double(rb - tc.expn[idx])));
        B.numbps = tc.expn[idx] + tc.guard - 1;
        B.precincts.resize(size_t(R.pw) * R.ph);
        for (int pno = 0; pno < R.pw * R.ph; ++pno) {
          Precinct& P = B.precincts[pno];
          const int64_t gx0 = cbgx0 + int64_t(pno % R.pw) * (int64_t(1) << cbgw);
          const int64_t gy0 = cbgy0 + int64_t(pno / R.pw) * (int64_t(1) << cbgh);
          const int64_t x0 = std::max(gx0, B.x0), y0 = std::max(gy0, B.y0);
          const int64_t x1 = std::min(gx0 + (int64_t(1) << cbgw), B.x1);
          const int64_t y1 = std::min(gy0 + (int64_t(1) << cbgh), B.y1);
          if (x0 >= x1 || y0 >= y1) continue;
          const int64_t bx0 = (x0 >> cblkw) << cblkw, by0 = (y0 >> cblkh) << cblkh;
          const int64_t bx1 = ceildivpow2(x1, cblkw) << cblkw;
          const int64_t by1 = ceildivpow2(y1, cblkh) << cblkh;
          P.cw = static_cast<int>((bx1 - bx0) >> cblkw);
          P.ch = static_cast<int>((by1 - by0) >> cblkh);
          P.cblks.resize(size_t(P.cw) * P.ch);
          for (int cno = 0; cno < P.cw * P.ch; ++cno) {
            Cblk& cb = P.cblks[cno];
            const int64_t cx0 = bx0 + (int64_t(cno % P.cw) << cblkw);
            const int64_t cy0 = by0 + (int64_t(cno / P.cw) << cblkh);
            cb.x0 = static_cast<int>(std::max(cx0, x0));
            cb.y0 = static_cast<int>(std::max(cy0, y0));
            cb.x1 = static_cast<int>(std::min(cx0 + (int64_t(1) << cblkw), x1));
            cb.y1 = static_cast<int>(std::min(cy0 + (int64_t(1) << cblkh), y1));
          }
          P.incl.init(P.cw, P.ch);
          P.imsb.init(P.cw, P.ch);
        }
      }
    }
  }

  // ---------------------------------------------------- packet iterator

  int maxres = 0, maxprec = 0;
  std::vector<uint8_t> include;

  size_t include_index(int lay, int res, int comp, int prec) const {
    return ((size_t(lay) * maxres + res) * comps.size() + comp) * maxprec + prec;
  }

  template <class F>
  void iterate(F&& packet) {
    const int nc = static_cast<int>(comps.size());
    for (const TileComp& t : comps) {
      maxres = std::max(maxres, t.numres);
      for (const Resolution& R : t.res) maxprec = std::max(maxprec, R.pw * R.ph);
    }
    include.assign(size_t(tcp.layers) * maxres * nc * std::max(maxprec, 1), 0);
    std::vector<Poc> pocs = tcp.pocs;
    if (pocs.empty()) pocs.push_back({0, 0, tcp.layers, maxres, nc, tcp.prg});
    for (const Poc& poc : pocs) {
      const int lay1 = std::min(poc.lay1, tcp.layers);
      const int comp1 = std::min(poc.comp1, nc);
      auto visit = [&](int lay, int res, int comp, int prec) {
        const size_t i = include_index(lay, res, comp, prec);
        if (i >= include.size()) fail("JPEG 2000: packet iterator out of range");
        if (include[i]) return;
        include[i] = 1;
        packet(lay, res, comp, prec);
      };
      switch (poc.prg) {
        case 0:  // LRCP
          for (int l = 0; l < lay1; ++l) {
            for (int r = poc.res0; r < poc.res1; ++r) {
              for (int c = poc.comp0; c < comp1; ++c) {
                if (r >= comps[c].numres) continue;
                const Resolution& R = comps[c].res[r];
                for (int p = 0; p < R.pw * R.ph; ++p) visit(l, r, c, p);
              }
            }
          }
          break;
        case 1:  // RLCP
          for (int r = poc.res0; r < poc.res1; ++r) {
            for (int l = 0; l < lay1; ++l) {
              for (int c = poc.comp0; c < comp1; ++c) {
                if (r >= comps[c].numres) continue;
                const Resolution& R = comps[c].res[r];
                for (int p = 0; p < R.pw * R.ph; ++p) visit(l, r, c, p);
              }
            }
          }
          break;
        default:
          positional(poc, lay1, comp1, visit);
      }
    }
  }

  // The step over the reference grid: the least precinct extent of the
  // components given (OpenJPEG's pi->dx, pi->dy).
  bool steps(int c0, int c1, uint32_t& dx, uint32_t& dy) const {
    dx = dy = 0;
    for (int c = c0; c < c1; ++c) {
      const CompSiz& k = cs.comps[c];
      for (int r = 0; r < comps[c].numres; ++r) {
        const Resolution& R = comps[c].res[r];
        const int level = comps[c].numres - 1 - r;
        if (R.pdx + level < 32 && uint64_t(k.dx) << (R.pdx + level) <= 0xFFFFFFFFu) {
          const uint32_t v = uint32_t(k.dx) << (R.pdx + level);
          dx = dx ? std::min(dx, v) : v;
        }
        if (R.pdy + level < 32 && uint64_t(k.dy) << (R.pdy + level) <= 0xFFFFFFFFu) {
          const uint32_t v = uint32_t(k.dy) << (R.pdy + level);
          dy = dy ? std::min(dy, v) : v;
        }
      }
    }
    return dx != 0 && dy != 0;
  }

  // Whether (x, y) starts a precinct of component c at resolution r; its
  // index in `prec`.
  bool precinct_at(int c, int r, uint64_t x, uint64_t y, int& prec) const {
    const CompSiz& k = cs.comps[c];
    const Resolution& R = comps[c].res[r];
    const int level = comps[c].numres - 1 - r;
    const uint64_t cdx = uint64_t(k.dx) << level, cdy = uint64_t(k.dy) << level;
    if (cdx > 0xFFFFFFFFu || cdy > 0xFFFFFFFFu) return false;  // OpenJPEG's 32-bit guard
    const uint64_t trx0 = ceildiv(tx0, cdx), try0 = ceildiv(ty0, cdy);
    const uint64_t trx1 = ceildiv(tx1, cdx), try1 = ceildiv(ty1, cdy);
    const int rpx = R.pdx + level, rpy = R.pdy + level;
    if (rpx >= 32 || rpy >= 32 || uint64_t(k.dx) << rpx > 0xFFFFFFFFu ||
        uint64_t(k.dy) << rpy > 0xFFFFFFFFu) {
      return false;
    }
    if (!((y % (uint64_t(k.dy) << rpy)) == 0 ||
          (int64_t(y) == ty0 && ((try0 << level) % (uint64_t(1) << rpy)) != 0))) {
      return false;
    }
    if (!((x % (uint64_t(k.dx) << rpx)) == 0 ||
          (int64_t(x) == tx0 && ((trx0 << level) % (uint64_t(1) << rpx)) != 0))) {
      return false;
    }
    if (R.pw == 0 || R.ph == 0) return false;
    if (trx0 == trx1 || try0 == try1) return false;
    const uint64_t prci = (ceildiv(x, cdx) >> R.pdx) - (trx0 >> R.pdx);
    const uint64_t prcj = (ceildiv(y, cdy) >> R.pdy) - (try0 >> R.pdy);
    prec = static_cast<int>(prci + prcj * R.pw);
    return true;
  }

  template <class V>
  void positional(const Poc& poc, int lay1, int comp1, V&& visit) {
    auto run_xy = [&](uint32_t dx, uint32_t dy, auto&& at_xy) {
      for (uint64_t y = ty0; int64_t(y) < ty1; y += dy - (y % dy)) {
        for (uint64_t x = tx0; int64_t(x) < tx1; x += dx - (x % dx)) at_xy(x, y);
      }
    };
    uint32_t dx, dy;
    if (poc.prg == 2) {  // RPCL
      if (!steps(0, static_cast<int>(comps.size()), dx, dy)) return;
      for (int r = poc.res0; r < poc.res1; ++r) {
        run_xy(dx, dy, [&](uint64_t x, uint64_t y) {
          for (int c = poc.comp0; c < comp1; ++c) {
            if (r >= comps[c].numres) continue;
            int p;
            if (!precinct_at(c, r, x, y, p)) continue;
            for (int l = 0; l < lay1; ++l) visit(l, r, c, p);
          }
        });
      }
    } else if (poc.prg == 3) {  // PCRL
      if (!steps(0, static_cast<int>(comps.size()), dx, dy)) return;
      run_xy(dx, dy, [&](uint64_t x, uint64_t y) {
        for (int c = poc.comp0; c < comp1; ++c) {
          for (int r = poc.res0; r < std::min(poc.res1, comps[c].numres); ++r) {
            int p;
            if (!precinct_at(c, r, x, y, p)) continue;
            for (int l = 0; l < lay1; ++l) visit(l, r, c, p);
          }
        }
      });
    } else {  // CPRL
      for (int c = poc.comp0; c < comp1; ++c) {
        if (!steps(c, c + 1, dx, dy)) return;
        run_xy(dx, dy, [&](uint64_t x, uint64_t y) {
          for (int r = poc.res0; r < std::min(poc.res1, comps[c].numres); ++r) {
            int p;
            if (!precinct_at(c, r, x, y, p)) continue;
            for (int l = 0; l < lay1; ++l) visit(l, r, c, p);
          }
        });
      }
    }
  }

  // ---------------------------------------------------- packets

  // One packet: its header from `hdr` (the body stream itself without PPM
  // or PPT), its code-block data from the body at `at`.
  void read_packet(int lay, int r, int c, int prec, HeaderSrc& hdr, const uint8_t* body,
                   size_t& at, size_t end, bool separate) {
    TileComp& t = comps[c];
    Resolution& R = t.res[r];
    const int cblksty = tcp.tccps[c].cblksty;
    if (tcp.csty & 2) {  // SOP
      if (end - at >= 6 && body[at] == 0xFF && body[at + 1] == 0x91) at += 6;
    }
    if (!separate) hdr = {body, at, end};
    BitIn bio{hdr.p, hdr.at, hdr.end};
    const bool present = bio.bit();
    std::vector<Cblk*> included;
    if (present) {
      for (Band& B : R.bands) {
        if (B.empty()) continue;
        Precinct& P = B.precincts[prec];
        for (int cno = 0; cno < P.cw * P.ch; ++cno) {
          Cblk& cb = P.cblks[cno];
          const bool inc = cb.numsegs == 0 ? P.incl.decode(bio, cno, lay + 1) : bio.bit();
          if (!inc) {
            cb.numnewpasses = 0;
            continue;
          }
          if (cb.numsegs == 0) {
            int i = 0;
            while (!P.imsb.decode(bio, cno, i)) {
              if (++i > 31) fail("JPEG 2000: too many zero bit-planes");
            }
            cb.numbps = B.numbps + 1 - i;
            cb.numlenbits = 3;
          }
          cb.numnewpasses = getnumpasses(bio);
          int inc_len = 0;
          while (bio.bit()) ++inc_len;
          cb.numlenbits += inc_len;
          int segno = 0;
          if (cb.numsegs == 0) {
            init_seg(cb, 0, cblksty, true);
          } else {
            segno = cb.numsegs - 1;
            if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
              ++segno;
              init_seg(cb, segno, cblksty, false);
            }
          }
          int n = cb.numnewpasses;
          do {
            Seg& s = cb.segs[segno];
            s.newpasses = std::min(s.maxpasses - s.numpasses, n);
            const int nbits = cb.numlenbits + floorlog2(static_cast<uint32_t>(s.newpasses));
            if (nbits > 32) fail("JPEG 2000: code-block length of more than 32 bits");
            s.newlen = bio.bits(nbits);
            n -= s.newpasses;
            if (n > 0) {
              ++segno;
              init_seg(cb, segno, cblksty, false);
            }
          } while (n > 0);
          included.push_back(&cb);
        }
      }
    }
    if (!bio.align() && present) fail("JPEG 2000: packet header is truncated");
    size_t hat = bio.at;
    if (tcp.csty & 4) {  // EPH
      if (hdr.end - hat >= 2 && hdr.p[hat] == 0xFF && hdr.p[hat + 1] == 0x92) hat += 2;
    }
    if (separate) {
      hdr.at = hat;
    } else {
      at = hat;
    }
    t.resno_decoded = std::max(t.resno_decoded, r);
    for (Cblk* cb : included) {
      int s;
      if (cb->numsegs == 0) {
        s = 0;
        cb->numsegs = 1;
      } else {
        s = cb->numsegs - 1;
        if (cb->segs[s].numpasses == cb->segs[s].maxpasses) {
          ++s;
          ++cb->numsegs;
        }
      }
      for (;;) {
        Seg& sg = cb->segs[s];
        if (sg.newlen > end - at) fail("JPEG 2000: code-block data is truncated");
        cb->data.insert(cb->data.end(), body + at, body + at + sg.newlen);
        at += sg.newlen;
        sg.len += sg.newlen;
        sg.numpasses += sg.newpasses;
        cb->numnewpasses -= sg.newpasses;
        if (cb->numnewpasses <= 0) break;
        ++s;
        ++cb->numsegs;
      }
    }
  }

  // ---------------------------------------------------- tier 1

  void decode_blocks();
  void inverse_dwt();
  void mct_and_shift();
};

// ---------------------------------------------------------------- MQ decoder

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

constexpr MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

// Contexts: 0-8 zero coding, 9-13 sign, 14-16 refinement, 17 run length,
// 18 uniform.
constexpr int kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17, kCtxUni = 18;

struct Mq {
  const uint8_t* p = nullptr;
  size_t n = 0, pos = 0;
  uint32_t c = 0, a = 0;
  int ct = 0;
  uint8_t state[19], mps[19];

  uint8_t byte(size_t i) const { return i < n ? p[i] : 0xFF; }
  void reset_states() {
    for (int k = 0; k < 19; ++k) state[k] = mps[k] = 0;
    state[kCtxUni] = 46;
    state[kCtxAgg] = 3;
    state[0] = 4;
  }
  void bytein() {
    if (byte(pos) == 0xFF) {
      if (byte(pos + 1) > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++pos;
        c += uint32_t(byte(pos)) << 9;
        ct = 7;
      }
    } else {
      ++pos;
      c += uint32_t(byte(pos)) << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* data, size_t len) {
    p = data;
    n = len;
    pos = 0;
    c = uint32_t(byte(0)) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    const MqState& s = kMq[state[cx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      if (a < s.qe) {
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        d = !mps[cx];
        if (s.sw) mps[cx] = !mps[cx];
        state[cx] = s.nlps;
      }
      a = s.qe;
      renorm();
    } else {
      c -= uint32_t(s.qe) << 16;
      if ((a & 0x8000) == 0) {
        if (a < s.qe) {
          d = !mps[cx];
          if (s.sw) mps[cx] = !mps[cx];
          state[cx] = s.nlps;
        } else {
          d = mps[cx];
          state[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  // The raw (bypass) decoder, opj_mqc_raw_decode.
  void raw_init(const uint8_t* data, size_t len) {
    p = data;
    n = len;
    pos = 0;
    c = 0;
    ct = 0;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (byte(pos) > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = byte(pos++);
          ct = 7;
        }
      } else {
        c = byte(pos++);
        ct = 8;
      }
    }
    --ct;
    return (c >> ct) & 1;
  }
};

// Zero-coding contexts (Table D.1) by band (1, HL: the horizontal and
// vertical counts swapped) and neighbourhood code h | v << 2 | d << 4.
struct ZcTable {
  uint8_t t[4][256];
  ZcTable() {
    for (int o = 0; o < 4; ++o) {
      for (int code = 0; code < 256; ++code) {
        int h = code & 3, v = (code >> 2) & 3;
        const int d = code >> 4;
        int n = 0;
        if (o == 3) {
          const int hv = h + v;
          if (d == 0) {
            n = hv == 0 ? 0 : hv == 1 ? 1 : 2;
          } else if (d == 1) {
            n = hv == 0 ? 3 : hv == 1 ? 4 : 5;
          } else if (d == 2) {
            n = hv == 0 ? 6 : 7;
          } else {
            n = 8;
          }
        } else {
          if (o == 1) std::swap(h, v);
          if (h == 0) {
            if (v == 0) {
              n = d == 0 ? 0 : d == 1 ? 1 : 2;
            } else {
              n = v == 1 ? 3 : 4;
            }
          } else if (h == 1) {
            n = v == 0 ? (d == 0 ? 5 : 6) : 7;
          } else {
            n = 8;
          }
        }
        t[o][code] = static_cast<uint8_t>(n);
      }
    }
  }
};
const ZcTable kZc;

// One code-block's tier-1 decoder. Each sample has a state (significant,
// visited in this bit-plane, refined, negative) and a neighbourhood code:
// the significant horizontal (bits 0-1), vertical (2-3) and diagonal (4-6)
// neighbours, kept as samples become significant. Under the vertically
// causal style a stripe's last row does not count the next stripe's samples.
struct T1 {
  enum : uint8_t { kSig = 1, kVisit = 2, kRefined = 4, kNeg = 8 };
  int w = 0, h = 0, stride = 0;
  std::vector<uint8_t> st, nb;
  std::vector<int32_t> data;
  Mq mq;
  const uint8_t* zc = nullptr;
  bool vsc = false;

  void setup(int cw, int ch, int orient, bool causal) {
    w = cw;
    h = ch;
    stride = w + 2;
    st.assign(size_t(stride) * (h + 2), 0);
    nb.assign(size_t(stride) * (h + 2), 0);
    data.assign(size_t(w) * h, 0);
    zc = kZc.t[orient];
    vsc = causal;
  }
  size_t at(int x, int y) const { return size_t(y + 1) * stride + (x + 1); }

  void make_significant(int x, int y, int neg) {
    const size_t i = at(x, y);
    st[i] |= kSig | (neg ? kNeg : 0);
    nb[i - 1] += 1;  // west neighbour sees an east one
    nb[i + 1] += 1;
    const bool up = !(vsc && (y & 3) == 0);  // the row above is in another stripe
    if (up) {
      nb[i - stride] += 4;
      nb[i - stride - 1] += 16;
      nb[i - stride + 1] += 16;
    }
    nb[i + stride] += 4;
    nb[i + stride - 1] += 16;
    nb[i + stride + 1] += 16;
  }

  // Sign context (9-13) and XOR bit from the horizontal and vertical
  // neighbours' signs.
  int sign(int x, int y) {
    const size_t i = at(x, y);
    auto contrib = [&](size_t j) {
      const uint8_t s = st[j];
      return (s & kSig) ? ((s & kNeg) ? -1 : 1) : 0;
    };
    int hc = contrib(i - 1) + contrib(i + 1);
    int vc = contrib(i - stride);
    if (!(vsc && (y & 3) == 3)) vc += contrib(i + stride);
    hc = std::max(-1, std::min(1, hc));
    vc = std::max(-1, std::min(1, vc));
    int ctx, xorbit;
    if (hc == 1) {
      ctx = vc == 1 ? 13 : vc == 0 ? 12 : 11;
      xorbit = 0;
    } else if (hc == 0) {
      ctx = vc == 0 ? 9 : 10;
      xorbit = vc == -1 ? 1 : 0;
    } else {
      ctx = vc == 1 ? 11 : vc == 0 ? 12 : 13;
      xorbit = 1;
    }
    return mq.decode(ctx) ^ xorbit;
  }

  void sig_step(int x, int y, int32_t oneplushalf, bool raw) {
    const size_t i = at(x, y);
    if ((st[i] & (kSig | kVisit)) || nb[i] == 0) return;
    int v = raw ? mq.raw() : mq.decode(zc[nb[i]]);
    if (v) {
      const int neg = raw ? mq.raw() : sign(x, y);
      data[size_t(y) * w + x] = neg ? -oneplushalf : oneplushalf;
      make_significant(x, y, neg);
    }
    st[i] |= kVisit;
  }

  void sigpass(int bpno, bool raw) {
    const int32_t oneplushalf = (int32_t(1) << bpno) | (int32_t(1) << bpno >> 1);
    for (int k = 0; k < h; k += 4) {
      for (int x = 0; x < w; ++x) {
        for (int y = k; y < std::min(k + 4, h); ++y) sig_step(x, y, oneplushalf, raw);
      }
    }
  }

  void refpass(int bpno, bool raw) {
    const int32_t poshalf = (int32_t(1) << bpno) >> 1;
    for (int k = 0; k < h; k += 4) {
      for (int x = 0; x < w; ++x) {
        for (int y = k; y < std::min(k + 4, h); ++y) {
          const size_t i = at(x, y);
          if ((st[i] & (kSig | kVisit)) != kSig) continue;
          int v;
          if (raw) {
            v = mq.raw();
          } else {
            const int ctx = (st[i] & kRefined) ? kCtxMag + 2 : nb[i] ? kCtxMag + 1 : kCtxMag;
            v = mq.decode(ctx);
          }
          int32_t& d = data[size_t(y) * w + x];
          d += (v ^ (d < 0)) ? poshalf : -poshalf;
          st[i] |= kRefined;
        }
      }
    }
  }

  void cln_step(int x, int y, int32_t oneplushalf, bool partial) {
    const size_t i = at(x, y);
    if (!partial) {
      if (st[i] & (kSig | kVisit)) return;
      if (!mq.decode(zc[nb[i]])) return;
    }
    const int neg = sign(x, y);
    data[size_t(y) * w + x] = neg ? -oneplushalf : oneplushalf;
    make_significant(x, y, neg);
  }

  void clnpass(int bpno, bool segsym) {
    const int32_t oneplushalf = (int32_t(1) << bpno) | (int32_t(1) << bpno >> 1);
    const int full = h & ~3;
    for (int k = 0; k < full; k += 4) {
      for (int x = 0; x < w; ++x) {
        bool zero = true;
        for (int y = k; y < k + 4 && zero; ++y) {
          const size_t i = at(x, y);
          zero = (st[i] & (kSig | kVisit)) == 0 && nb[i] == 0;
        }
        int start = k;
        if (zero) {
          if (!mq.decode(kCtxAgg)) {
            clear_visits(x, k, k + 4);
            continue;
          }
          int runlen = mq.decode(kCtxUni);
          runlen = (runlen << 1) | mq.decode(kCtxUni);
          cln_step(x, k + runlen, oneplushalf, true);
          start = k + runlen + 1;
        }
        for (int y = start; y < k + 4; ++y) cln_step(x, y, oneplushalf, false);
        clear_visits(x, k, k + 4);
      }
    }
    if (full < h) {
      for (int x = 0; x < w; ++x) {
        for (int y = full; y < h; ++y) cln_step(x, y, oneplushalf, false);
        clear_visits(x, full, h);
      }
    }
    if (segsym) {
      for (int k = 0; k < 4; ++k) mq.decode(kCtxUni);
    }
  }

  void clear_visits(int x, int y0, int y1) {
    for (int y = y0; y < y1; ++y) st[at(x, y)] &= ~kVisit;
  }

  // opj_t1_decode_cblk.
  void decode(const Cblk& cb, int roishift, int cblksty) {
    int bpno_plus_one = roishift + cb.numbps;
    if (bpno_plus_one >= 31) fail("JPEG 2000: code-block of " + std::to_string(bpno_plus_one) + " bit-planes");
    int passtype = 2;
    mq.reset_states();
    size_t off = 0;
    for (int s = 0; s < cb.numsegs; ++s) {
      const Seg& seg = cb.segs[s];
      const bool raw = bpno_plus_one <= cb.numbps - 4 && passtype < 2 && (cblksty & 1);
      if (raw) {
        mq.raw_init(cb.data.data() + off, seg.len);
      } else {
        mq.init(cb.data.data() + off, seg.len);
      }
      off += seg.len;
      for (int pass = 0; pass < seg.numpasses && bpno_plus_one >= 1; ++pass) {
        if (passtype == 0) {
          sigpass(bpno_plus_one, raw);
        } else if (passtype == 1) {
          refpass(bpno_plus_one, raw);
        } else {
          clnpass(bpno_plus_one, cblksty & 32);
        }
        if ((cblksty & 2) && !raw) mq.reset_states();
        if (++passtype == 3) {
          passtype = 0;
          --bpno_plus_one;
        }
      }
    }
  }
};

void TileDecoder::decode_blocks() {
  T1 t1;
  for (size_t c = 0; c < comps.size(); ++c) {
    TileComp& t = comps[c];
    const Tccp& tc = tcp.tccps[c];
    const int64_t tw = t.x1 - t.x0;
    for (int r = 0; r < t.numres; ++r) {
      Resolution& R = t.res[r];
      for (Band& B : R.bands) {
        if (B.empty()) continue;
        for (Precinct& P : B.precincts) {
          for (Cblk& cb : P.cblks) {
            const int cw = cb.x1 - cb.x0, ch = cb.y1 - cb.y0;
            if (cw <= 0 || ch <= 0) continue;
            int64_t x = cb.x0 - B.x0, y = cb.y0 - B.y0;
            if (B.bandno & 1) x += t.res[r - 1].x1 - t.res[r - 1].x0;
            if (B.bandno & 2) y += t.res[r - 1].y1 - t.res[r - 1].y0;
            Px* out = t.data.data() + y * tw + x;
            if (cb.numsegs == 0) continue;  // zeros, as the buffer holds
            t1.setup(cw, ch, B.bandno, tc.cblksty & 8);
            t1.decode(cb, tc.roishift, tc.cblksty);
            int32_t* d = t1.data.data();
            const size_t count = size_t(cw) * ch;
            if (tc.roishift) {
              if (tc.roishift >= 31) {
                std::fill(d, d + count, 0);
              } else {
                const int32_t thresh = int32_t(1) << tc.roishift;
                for (size_t k = 0; k < count; ++k) {
                  const int32_t v = d[k];
                  int32_t mag = v < 0 ? -v : v;
                  if (mag >= thresh) {
                    mag >>= tc.roishift;
                    d[k] = v < 0 ? -mag : mag;
                  }
                }
              }
            }
            if (tc.qmfbid == 1) {
              for (int j = 0; j < ch; ++j) {
                for (int i = 0; i < cw; ++i) out[j * tw + i].i = d[size_t(j) * cw + i] / 2;
              }
            } else {
              const float step = 0.5f * B.stepsize;
              for (int j = 0; j < ch; ++j) {
                for (int i = 0; i < cw; ++i) {
                  out[j * tw + i].f = static_cast<float>(d[size_t(j) * cw + i]) * step;
                }
              }
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- wavelets

// One line of the inverse 5/3: `x` the sn low-pass then dn high-pass
// coefficients, interleaved in place from parity `cas` (opj_idwt53_h/v).
void idwt53(int32_t* x, int sn, int dn, int cas, std::vector<int32_t>& tmp) {
  const int n = sn + dn;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
  } else {
    if (sn == 0 && dn == 1) {
      x[0] /= 2;
      return;
    }
    if (n == 0) return;
  }
  tmp.resize(n);
  for (int i = 0; i < sn; ++i) tmp[2 * i + cas] = x[i];
  for (int i = 0; i < dn; ++i) tmp[2 * i + 1 - cas] = x[sn + i];
  auto at = [&](int i) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * (n - 1) - i;
    return tmp[i];
  };
  for (int i = cas; i < n; i += 2) tmp[i] -= (at(i - 1) + at(i + 1) + 2) >> 2;
  for (int i = 1 - cas; i < n; i += 2) tmp[i] += (at(i - 1) + at(i + 1)) >> 1;
  std::memcpy(x, tmp.data(), sizeof(int32_t) * n);
}

const float kK = 1.230174105f;
const float kTwoInvK = 1.625732422f;
// OpenJPEG's lifting constants: the inverse adds (left + right) * c.
const float kAlpha = 1.586134342f, kBeta = 0.052980118f, kGamma = -0.882911075f,
            kDelta = -0.443506852f;

// One line of the inverse 9/7, as opj_v8dwt_decode: scale the low-pass
// samples by K and the high-pass by 2/K, then the four lifting steps, each
// x += (left + right) * c with a missing neighbour taken from the other side.
void idwt97(float* x, int sn, int dn, int cas, std::vector<float>& tmp) {
  const int n = sn + dn;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
  } else {
    if (!(sn > 0 || dn > 1)) return;
  }
  tmp.resize(n);
  for (int i = 0; i < sn; ++i) tmp[2 * i + cas] = x[i];
  for (int i = 0; i < dn; ++i) tmp[2 * i + 1 - cas] = x[sn + i];
  float* w = tmp.data();
  for (int i = cas; i < n; i += 2) w[i] *= kK;
  for (int i = 1 - cas; i < n; i += 2) w[i] *= kTwoInvK;
  auto lift = [&](int first, float c) {
    for (int i = first; i < n; i += 2) {
      const bool l = i - 1 >= 0, r = i + 1 < n;
      float sum;
      if (l && r) {
        sum = w[i - 1] + w[i + 1];
      } else if (l) {
        sum = w[i - 1] + w[i - 1];
      } else if (r) {
        sum = w[i + 1] + w[i + 1];
      } else {
        continue;
      }
      w[i] = w[i] + sum * c;
    }
  };
  lift(cas, kDelta);
  lift(1 - cas, kGamma);
  lift(cas, kBeta);
  lift(1 - cas, kAlpha);
  std::memcpy(x, w, sizeof(float) * n);
}

void TileDecoder::inverse_dwt() {
  std::vector<int32_t> ti;
  std::vector<float> tf;
  std::vector<Px> block;
  for (size_t c = 0; c < comps.size(); ++c) {
    TileComp& t = comps[c];
    const int numres = t.resno_decoded + 1;
    if (numres <= 1) continue;
    const bool rev = tcp.tccps[c].qmfbid == 1;
    const int64_t w = t.x1 - t.x0;
    for (int r = 1; r < numres; ++r) {
      const Resolution& prev = t.res[r - 1];
      const Resolution& R = t.res[r];
      const int rw = static_cast<int>(R.x1 - R.x0), rh = static_cast<int>(R.y1 - R.y0);
      const int hsn = static_cast<int>(prev.x1 - prev.x0), vsn = static_cast<int>(prev.y1 - prev.y0);
      const int hcas = static_cast<int>(R.x0 % 2), vcas = static_cast<int>(R.y0 % 2);
      for (int j = 0; j < rh; ++j) {
        Px* row = t.data.data() + j * w;
        if (rev) {
          idwt53(&row[0].i, hsn, rw - hsn, hcas, ti);
        } else {
          idwt97(&row[0].f, hsn, rw - hsn, hcas, tf);
        }
      }
      // Columns 16 at a time, each copied out whole (rows of the block
      // stay in cache), then lifted alone.
      constexpr int kBlock = 16;
      block.resize(size_t(kBlock) * rh);
      for (int i0 = 0; i0 < rw; i0 += kBlock) {
        const int nb = std::min(kBlock, rw - i0);
        Px* base = t.data.data() + i0;
        for (int j = 0; j < rh; ++j) {
          for (int b = 0; b < nb; ++b) block[size_t(b) * rh + j] = base[j * w + b];
        }
        for (int b = 0; b < nb; ++b) {
          Px* col = block.data() + size_t(b) * rh;
          if (rev) {
            idwt53(&col[0].i, vsn, rh - vsn, vcas, ti);
          } else {
            idwt97(&col[0].f, vsn, rh - vsn, vcas, tf);
          }
        }
        for (int j = 0; j < rh; ++j) {
          for (int b = 0; b < nb; ++b) base[j * w + b] = block[size_t(b) * rh + j];
        }
      }
    }
  }
}

void TileDecoder::mct_and_shift() {
  if (tcp.mct && comps.size() >= 3) {
    const TileComp& a = comps[0];
    const size_t n = size_t(a.x1 - a.x0) * size_t(a.y1 - a.y0);
    for (int k = 1; k < 3; ++k) {
      const TileComp& b = comps[k];
      if (b.numres != a.numres || b.resno_decoded != a.resno_decoded ||
          size_t(b.x1 - b.x0) * size_t(b.y1 - b.y0) != n) {
        fail("JPEG 2000: a colour transform over components of different sizes");
      }
    }
    Px *c0 = comps[0].data.data(), *c1 = comps[1].data.data(), *c2 = comps[2].data.data();
    if (tcp.tccps[0].qmfbid == 1) {
      for (size_t i = 0; i < n; ++i) {
        const int32_t y = c0[i].i, u = c1[i].i, v = c2[i].i;
        const int32_t g = y - ((u + v) >> 2);
        c0[i].i = v + g;
        c1[i].i = g;
        c2[i].i = u + g;
      }
    } else {
      for (size_t i = 0; i < n; ++i) {
        const float y = c0[i].f, u = c1[i].f, v = c2[i].f;
        const float r = y + (v * 1.402f);
        const float g = y - (u * 0.34413f) - (v * 0.71414f);
        const float b = y + (u * 1.772f);
        c0[i].f = r;
        c1[i].f = g;
        c2[i].f = b;
      }
    }
  }
  for (size_t c = 0; c < comps.size(); ++c) {
    TileComp& t = comps[c];
    const CompSiz& k = cs.comps[c];
    const int64_t lo = k.sgnd ? -(int64_t(1) << (k.prec - 1)) : 0;
    const int64_t hi = k.sgnd ? (int64_t(1) << (k.prec - 1)) - 1 : (int64_t(1) << k.prec) - 1;
    const int64_t shift = k.sgnd ? 0 : int64_t(1) << (k.prec - 1);
    const Resolution& R = t.res[t.resno_decoded];
    const int64_t rw = R.x1 - R.x0, rh = R.y1 - R.y0, w = t.x1 - t.x0;
    const bool rev = tcp.tccps[c].qmfbid == 1;
    for (int64_t j = 0; j < rh; ++j) {
      for (int64_t i = 0; i < rw; ++i) {
        Px& p = t.data[size_t(j * w + i)];
        int64_t v;
        if (rev) {
          v = int64_t(p.i) + shift;
        } else {
          const float f = p.f;
          if (f > float(INT32_MAX)) {
            p.i = static_cast<int32_t>(hi);
            continue;
          }
          if (f < float(INT32_MIN)) {
            p.i = static_cast<int32_t>(lo);
            continue;
          }
          v = static_cast<int64_t>(std::lrintf(f)) + shift;
        }
        p.i = static_cast<int32_t>(std::min(hi, std::max(lo, v)));
      }
    }
  }
}

// ---------------------------------------------------------------- tiles

// A tile's parameters: the main header's, then its tile-part headers' in
// order (COD, COC, QCD, QCC and RGN only in the first tile-part).
Tcp tile_params(Codestream& cs, int tileno) {
  Tcp tcp = cs.deflt;
  tcp.ppt.clear();
  bool first = true;
  for (const TilePart& tp : cs.parts[tileno]) {
    size_t at = tp.header;
    Tcp part = tcp;
    read_markers(cs, part, false, at, tp.header_end + 2);
    if (first) {
      tcp = part;
    } else {
      tcp.pocs = part.pocs;
      tcp.ppt = part.ppt;
    }
    first = false;
  }
  return tcp;
}

std::vector<uint8_t> joined(const std::vector<std::vector<uint8_t>>& pieces) {
  std::vector<uint8_t> out;
  for (const auto& p : pieces) out.insert(out.end(), p.begin(), p.end());
  return out;
}

// The PPM stream without its Nppm fields (opj_j2k_merge_ppm): the markers
// in index order, each Nppm whole within one marker.
std::vector<uint8_t> merged_ppm(const Codestream& cs) {
  std::vector<uint8_t> out;
  size_t remaining = 0;  // of the current tile-part's headers, in later markers
  for (const std::vector<uint8_t>& m : cs.ppm) {
    size_t at = std::min(remaining, m.size());
    out.insert(out.end(), m.begin(), m.begin() + at);
    remaining -= at;
    while (at < m.size()) {
      if (m.size() - at < 4) fail("JPEG 2000: PPM marker without room for Nppm");
      const uint32_t n = uint32_t(m[at]) << 24 | m[at + 1] << 16 | m[at + 2] << 8 | m[at + 3];
      at += 4;
      const size_t take = std::min<size_t>(n, m.size() - at);
      out.insert(out.end(), m.begin() + at, m.begin() + at + take);
      at += take;
      remaining = n - take;
    }
  }
  return out;
}

// A decoded tile: each component's samples at its own resolution
// (OpenJPEG's tile buffer before it packs them to 1, 2 or 4 bytes).
struct TileOut {
  int64_t x0, y0, x1, y1;
  std::vector<int64_t> cw, ch;
  std::vector<std::vector<int32_t>> comps;
};

TileOut decode_tile(Codestream& cs, int tileno, std::vector<uint8_t>& ppm, size_t& ppm_at) {
  const Tcp tcp = tile_params(cs, tileno);
  TileDecoder td(cs, tcp, tileno);
  std::vector<uint8_t> body;
  for (const TilePart& tp : cs.parts[tileno]) {
    body.insert(body.end(), cs.p + tp.data, cs.p + tp.data_end);
  }
  std::vector<uint8_t> ppt = joined(tcp.ppt);
  HeaderSrc hdr{nullptr, 0, 0};
  bool separate = false;
  if (cs.has_ppm) {
    hdr = {ppm.data(), ppm_at, ppm.size()};
    separate = true;
  } else if (!tcp.ppt.empty()) {
    hdr = {ppt.data(), 0, ppt.size()};
    separate = true;
  }
  size_t at = 0;
  td.iterate([&](int l, int r, int c, int p) {
    td.read_packet(l, r, c, p, hdr, body.data(), at, body.size(), separate);
  });
  if (cs.has_ppm) ppm_at = hdr.at;
  td.decode_blocks();
  td.inverse_dwt();
  td.mct_and_shift();
  TileOut out;
  out.x0 = td.tx0;
  out.y0 = td.ty0;
  out.x1 = td.tx1;
  out.y1 = td.ty1;
  for (TileComp& t : td.comps) {
    const Resolution& R = t.res[t.resno_decoded];
    const int64_t rw = R.x1 - R.x0, rh = R.y1 - R.y0, w = t.x1 - t.x0;
    std::vector<int32_t> v(size_t(rw * rh));
    for (int64_t j = 0; j < rh; ++j) {
      for (int64_t i = 0; i < rw; ++i) v[size_t(j * rw + i)] = t.data[size_t(j * w + i)].i;
    }
    out.cw.push_back(rw);
    out.ch.push_back(rh);
    out.comps.push_back(std::move(v));
  }
  return out;
}

// ---------------------------------------------------------------- JP2 and PIL

enum Space { kUnspecified = 0, kSrgb = 1, kGray = 2, kSycc = 3, kEycc = 4, kCmyk = 5 };

struct Jp2 {
  int64_t w = 0, h = 0;  // PIL's size
  std::string mode;
  int space = kUnspecified;
  std::vector<std::array<uint8_t, 4>> palette;  // P and PA: PIL's palette
  size_t cs_at = 0, cs_len = 0;  // the codestream
};

struct Box {
  uint32_t type;
  size_t body, end;
};

// The box at `at` within [.., end): PIL's BoxReader and OpenJPEG agree on
// lengths 0 (to the end, OpenJPEG) and 1 (64-bit).
bool next_box(const Bytes& b, size_t at, size_t end, Box& box) {
  if (end - at < 8) return false;
  const uint64_t len = b.be32(at);
  box.type = b.be32(at + 4);
  size_t hlen = 8;
  uint64_t full = len;
  if (len == 1) {
    b.need(at, 16);
    full = uint64_t(b.be32(at + 8)) << 32 | b.be32(at + 12);
    hlen = 16;
  } else if (len == 0) {
    full = end - at;
  }
  if (full < hlen || full > end - at) fail("JPEG 2000: invalid box length");
  box.body = at + hlen;
  box.end = at + size_t(full);
  return true;
}

constexpr uint32_t fourcc(const char* s) {
  return uint32_t(uint8_t(s[0])) << 24 | uint32_t(uint8_t(s[1])) << 16 | uint32_t(uint8_t(s[2])) << 8 |
         uint8_t(s[3]);
}

const uint8_t kJp2Signature[12] = {0, 0, 0, 0x0C, 'j', 'P', ' ', ' ', 0x0D, 0x0A, 0x87, 0x0A};

bool is_codestream(const Bytes& b) {
  return b.n >= 4 && b.p[0] == 0xFF && b.p[1] == 0x4F && b.p[2] == 0xFF && b.p[3] == 0x51;
}

// _parse_codestream's size and mode from SIZ.
void codestream_mode(const Bytes& b, size_t at, Jp2& j) {
  Bytes s{b.p + at, b.n - at, kFmt};
  s.need(0, 4 + 38 + 1);
  const uint32_t x1 = s.be32(8), y1 = s.be32(12), x0 = s.be32(16), y0 = s.be32(20);
  const uint32_t nc = s.be16(40);
  j.w = int64_t(x1) - x0;
  j.h = int64_t(y1) - y0;
  if (nc == 1) {
    j.mode = (s.u8(42) & 0x7F) + 1 > 8 ? "I;16" : "L";
  } else if (nc == 2) {
    j.mode = "LA";
  } else if (nc == 3) {
    j.mode = "RGB";
  } else if (nc == 4) {
    j.mode = "RGBA";
  } else {
    fail("JPEG 2000: unable to determine J2K image mode (" + std::to_string(nc) + " components)");
  }
}

// OpenJPEG's checks of the header boxes it reads (opj_jp2_read_ihdr,
// _colr, _pclr, _cmap): a fault there fails the decode, and PIL with it.
struct Jp2Checks {
  bool ihdr = false, pclr = false, cmap = false;
  size_t pclr_columns = 0;
  void box(const Bytes& b, const Box& sub) {
    const size_t len = sub.end - sub.body;
    if (sub.type == fourcc("ihdr")) {
      if (ihdr) return;  // later ihdr boxes are ignored
      if (len != 14) fail("JPEG 2000: bad ihdr box size");
      if (b.be32(sub.body) == 0 || b.be32(sub.body + 4) == 0 || b.be16(sub.body + 8) == 0) {
        fail("JPEG 2000: ihdr with a zero size or no components");
      }
      ihdr = true;
    } else if (sub.type == fourcc("colr")) {
      if (len < 3 || (b.u8(sub.body) == 1 && len < 7)) fail("JPEG 2000: bad colr box size");
    } else if (sub.type == fourcc("pclr")) {
      if (pclr || len < 3) fail("JPEG 2000: bad pclr box");
      const uint32_t ne = b.be16(sub.body), npc = b.u8(sub.body + 2);
      if (ne == 0 || ne > 1024 || npc == 0) fail("JPEG 2000: pclr box with " + std::to_string(ne) +
                                                   " entries of " + std::to_string(npc) + " columns");
      if (len < 3 + npc) fail("JPEG 2000: bad pclr box");
      size_t need = 3 + npc;
      for (uint32_t k = 0; k < npc; ++k) {
        need += size_t(ne) * std::min<size_t>(4, ((b.u8(sub.body + 3 + k) & 0x7F) + 8) >> 3);
      }
      if (len < need) fail("JPEG 2000: pclr box is truncated");
      pclr = true;
      pclr_columns = npc;
    } else if (sub.type == fourcc("cmap")) {
      if (!pclr) fail("JPEG 2000: cmap box before its pclr box");
      if (cmap || len != 4 * pclr_columns) fail("JPEG 2000: bad cmap box");
      cmap = true;
    }
  }
};

Jp2 read_container(const Bytes& b) {
  Jp2 j;
  if (is_codestream(b)) {
    codestream_mode(b, 0, j);
    j.cs_at = 0;
    j.cs_len = b.n;
    return j;
  }
  if (b.n < 12 || std::memcmp(b.p, kJp2Signature, 12) != 0) fail("JPEG 2000: not a JPEG 2000 file");
  // PIL: the boxes up to jp2h, whose ihdr, colr and pclr give the mode.
  size_t at = 12;
  Box box;
  bool have_header = false, ftyp_second = false;
  int nbox = 0;
  int nc = 0, enumcs = 0;
  bool colr_seen = false;
  Jp2Checks checks;
  while (next_box(b, at, b.n, box)) {
    ++nbox;
    if (nbox == 1) ftyp_second = box.type == fourcc("ftyp");
    if (box.type == fourcc("jp2h")) {
      have_header = true;
      size_t hat = box.body;
      Box sub;
      bool size_seen = false;
      while (next_box(b, hat, box.end, sub)) {
        checks.box(b, sub);
        if (sub.type == fourcc("ihdr")) {
          if (sub.end - sub.body < 11) fail("JPEG 2000: Not enough data in header");
          j.h = b.be32(sub.body);
          j.w = b.be32(sub.body + 4);
          nc = static_cast<int>(b.be16(sub.body + 8));
          const int bpc = b.u8(sub.body + 10);
          size_seen = true;
          if (nc == 1 && (bpc & 0x7F) > 8) {
            j.mode = "I;16";
          } else if (nc == 1) {
            j.mode = "L";
          } else if (nc == 2) {
            j.mode = "LA";
          } else if (nc == 3) {
            j.mode = "RGB";
          } else if (nc == 4) {
            j.mode = "RGBA";
          }
        } else if (sub.type == fourcc("colr")) {
          const int meth = b.u8(sub.body);
          const uint32_t cs = meth == 1 ? b.be32(sub.body + 3) : 0;
          if (nc == 4 && meth == 1 && cs == 12) j.mode = "CMYK";
          if (!colr_seen && meth <= 2) {  // OpenJPEG takes the first, and ignores meth > 2
            enumcs = static_cast<int>(cs);
            colr_seen = true;
          }
        } else if (sub.type == fourcc("pclr") && (j.mode == "L" || j.mode == "LA")) {
          const uint32_t ne = b.be16(sub.body);
          const uint32_t npc = b.u8(sub.body + 2);
          const size_t pat = sub.body + 3 + npc;
          int maxbits = 0;
          for (uint32_t k = 0; k < npc; ++k) maxbits = std::max(maxbits, int(b.p[sub.body + 3 + k]));
          if (maxbits <= 8) {
            // PIL reads each entry's npc bytes into a palette of getcolor
            // calls; the port reads the entries as the file gives them. One
            // or two columns, which PIL maps to black (ROADMAP, hazards),
            // are grey and grey + alpha, as the file's one or two
            // components would be.
            if (npc > 4) fail("JPEG 2000: palette of " + std::to_string(npc) + " columns");
            if (sub.end - pat < size_t(ne) * npc) fail("JPEG 2000: Not enough data in header");
            for (uint32_t e = 0; e < ne; ++e) {
              const uint8_t* c = b.p + pat + size_t(e) * npc;
              std::array<uint8_t, 4> col{c[0], c[0], c[0], 255};
              if (npc == 2) col[3] = c[1];
              for (uint32_t k = 0; k < npc && npc >= 3; ++k) col[k] = c[k];
              j.palette.push_back(col);
            }
            std::vector<std::array<uint8_t, 4>> distinct;
            for (const auto& col : j.palette) {
              if (std::find(distinct.begin(), distinct.end(), col) == distinct.end()) {
                distinct.push_back(col);
              }
            }
            if (npc >= 3 && distinct.size() > 256) fail("JPEG 2000: cannot allocate more than 256 colors");
            j.mode = j.mode == "L" ? "P" : "PA";
          }
        }
        hat = sub.end;
      }
      if (!size_seen || j.mode.empty()) fail("JPEG 2000: Malformed JP2 header");
      break;
    }
    at = box.end;
  }
  if (!have_header) fail("JPEG 2000: no jp2h box");
  if (!checks.ihdr) fail("JPEG 2000: no ihdr box");
  // OpenJPEG: ftyp second, then the codestream box after jp2h.
  if (!ftyp_second) fail("JPEG 2000: the ftyp box must be the second box in the file");
  at = box.end;
  bool found = false;
  while (next_box(b, at, b.n, box)) {
    if (box.type == fourcc("jp2c")) {
      j.cs_at = box.body;
      j.cs_len = box.end - box.body;
      found = true;
      break;
    }
    at = box.end;
  }
  if (!found) fail("JPEG 2000: no jp2c box");
  // OpenJPEG's colour space from the first colr box; any other value
  // leaves it unspecified.
  switch (enumcs) {
    case 16: j.space = kSrgb; break;
    case 17: j.space = kGray; break;
    case 18: j.space = kSycc; break;
    case 24: j.space = kEycc; break;
    case 12: j.space = kCmyk; break;
    default: j.space = kUnspecified;
  }
  return j;
}

// PIL's YCbCr -> RGB tables (ConvertYCbCr.c, SCALE 6): each entry
// (int)(d * coefficient * 64 + 0.5), truncated toward zero, which every
// one of PIL's 256 R and B and 65536 G offsets bears out.
struct YccTables {
  int16_t r_cr[256], g_cb[256], g_cr[256], b_cb[256];
  YccTables() {
    for (int i = 0; i < 256; ++i) {
      const double d = i - 128;
      r_cr[i] = static_cast<int16_t>(d * 1.402 * 64 + 0.5);
      g_cb[i] = static_cast<int16_t>(d * -0.34414 * 64 + 0.5);
      g_cr[i] = static_cast<int16_t>(d * -0.71414 * 64 + 0.5);
      b_cb[i] = static_cast<int16_t>(d * 1.772 * 64 + 0.5);
    }
  }
};
const YccTables kYcc;

inline uint8_t clip8(int v) { return static_cast<uint8_t>(v <= 0 ? 0 : v >= 255 ? 255 : v); }

// PIL's image in its mode, 4 bytes a pixel (1 for L and P, 2 for I;16, in
// the low bytes), filled tile by tile by Jpeg2KDecode.c's unpackers.
struct PilImage {
  int64_t w, h;
  std::string mode;
  std::vector<uint32_t> px;
};

struct Unpacker {
  const char* mode;
  int space, comps;
  bool subsampling;
  int kind;  // 0 gray_l, 1 gray_i, 2 gray_rgb, 3 graya_la, 4 srgb_rgb, 5 sycc_rgb, 6 srgba_rgba, 7 sycca_rgba
};

const Unpacker kUnpackers[] = {
    {"L", kGray, 1, false, 0},      {"P", kSrgb, 1, false, 0},      {"PA", kSrgb, 2, false, 3},
    {"I;16", kGray, 1, false, 1},   {"I;16B", kGray, 1, false, 1},  {"LA", kGray, 2, false, 3},
    {"RGB", kGray, 1, false, 2},    {"RGB", kGray, 2, false, 2},    {"RGB", kSrgb, 3, true, 4},
    {"RGB", kSycc, 3, true, 5},     {"RGB", kSrgb, 4, true, 4},     {"RGB", kSycc, 4, true, 5},
    {"RGBA", kGray, 1, false, 2},   {"RGBA", kGray, 2, false, 3},   {"RGBA", kSrgb, 3, true, 4},
    {"RGBA", kSycc, 3, true, 5},    {"RGBA", kSrgb, 4, true, 6},    {"RGBA", kSycc, 4, true, 7},
    {"CMYK", kCmyk, 4, true, 6},
};

// OpenJPEG's packed tile buffer: each component's samples in turn at
// 1, 2 or 4 little-endian bytes (3 taken as 4), masked to that width.
struct TileBytes {
  std::vector<uint8_t> buf;
  std::vector<size_t> csiz;
  uint32_t word(size_t off, size_t size) const {
    if (off + size > buf.size()) return 0;
    if (size == 1) return buf[off];
    uint32_t v = 0;
    for (size_t k = 0; k < size; ++k) v |= uint32_t(buf[off + k]) << (8 * k);
    return v;
  }
};

TileBytes pack_tile(const Codestream& cs, const TileOut& t) {
  TileBytes tb;
  size_t total = 0;
  for (size_t c = 0; c < t.comps.size(); ++c) {
    size_t size = size_t(cs.comps[c].prec + 7) >> 3;
    tb.csiz.push_back(size == 3 ? 4 : size);
    total += tb.csiz.back() * t.comps[c].size();
  }
  tb.buf.resize(total);
  uint8_t* o = tb.buf.data();
  for (size_t c = 0; c < t.comps.size(); ++c) {
    const size_t size = tb.csiz[c];
    for (int32_t v : t.comps[c]) {
      for (size_t k = 0; k < size; ++k) *o++ = static_cast<uint8_t>(uint32_t(v) >> (8 * k));
    }
  }
  return tb;
}

inline uint32_t pil_shift(uint32_t x, int n) { return n < 0 ? x >> -n : x << n; }

struct Chan {
  int shift;
  uint32_t offset;
};

Chan chan(const CompSiz& k, int bits) {
  Chan c;
  c.shift = bits - k.prec;
  c.offset = k.sgnd ? uint32_t(1) << (k.prec - 1) : 0;
  if (c.shift < 0) c.offset += uint32_t(1) << (-c.shift - 1);
  return c;
}

void unpack(const Codestream& cs, const Unpacker& u, const TileOut& t, int64_t img_x0,
            int64_t img_y0, PilImage& im) {
  const TileBytes tb = pack_tile(cs, t);
  const int64_t x0 = t.x0 - img_x0, y0 = t.y0 - img_y0;
  const int64_t w = t.x1 - t.x0, h = t.y1 - t.y0;
  if (t.x0 >= t.x1 || t.y0 >= t.y1 || x0 < 0 || y0 < 0 || t.x1 - img_x0 > im.w ||
      t.y1 - img_y0 > im.h) {
    fail("JPEG 2000: a tile lies outside the image");
  }
  uint32_t* out = im.px.data();
  auto pix = [&](int64_t x, int64_t y) -> uint32_t& { return out[size_t((y0 + y) * im.w + x0 + x)]; };
  const size_t cs0 = tb.csiz[0];
  switch (u.kind) {
    case 0:
    case 1:
    case 2: {
      const Chan ch = chan(cs.comps[0], u.kind == 1 ? 16 : 8);
      for (int64_t y = 0; y < h; ++y) {
        for (int64_t x = 0; x < w; ++x) {
          const uint32_t v = pil_shift(ch.offset + tb.word(size_t(y * w + x) * cs0, cs0), ch.shift);
          if (u.kind == 0) {
            pix(x, y) = v & 0xFF;
          } else if (u.kind == 1) {
            pix(x, y) = v & 0xFFFF;
          } else {
            const uint32_t g = v & 0xFF;
            pix(x, y) = g | g << 8 | g << 16 | 0xFF000000u;
          }
        }
      }
      break;
    }
    case 3: {
      const Chan ch = chan(cs.comps[0], 8), ach = chan(cs.comps[1], 8);
      const size_t acs = tb.csiz[1];
      const size_t abase = cs0 * size_t(w * h);
      for (int64_t y = 0; y < h; ++y) {
        for (int64_t x = 0; x < w; ++x) {
          const uint32_t g = pil_shift(ch.offset + tb.word(size_t(y * w + x) * cs0, cs0), ch.shift) & 0xFF;
          const uint32_t a =
              pil_shift(ach.offset + tb.word(abase + size_t(y * w + x) * acs, acs), ach.shift) & 0xFF;
          pix(x, y) = g | g << 8 | g << 16 | a << 24;
        }
      }
      break;
    }
    default: {
      const int n = u.kind == 4 || u.kind == 5 ? 3 : 4;
      Chan chs[4];
      size_t base[4];
      int64_t dx[4], dy[4];
      size_t off = 0;
      for (int k = 0; k < n; ++k) {
        chs[k] = chan(cs.comps[k], 8);
        dx[k] = cs.comps[k].dx;
        dy[k] = cs.comps[k].dy;
        base[k] = off;
        off += tb.csiz[k] * size_t(w / dx[k]) * size_t(h / dy[k]);
      }
      bool whole = true;  // no subsampling: PIL's index is y * w + x
      for (int k = 0; k < n; ++k) whole = whole && dx[k] == 1 && dy[k] == 1;
      for (int64_t y = 0; y < h; ++y) {
        for (int64_t x = 0; x < w; ++x) {
          uint32_t v[4] = {0, 0, 0, 0xFF};
          for (int k = 0; k < n; ++k) {
            const size_t i = whole ? size_t(y * w + x)
                                   : size_t((y / dy[k]) * (w / dx[k]) + x / dx[k]);
            v[k] = pil_shift(chs[k].offset + tb.word(base[k] + i * tb.csiz[k], tb.csiz[k]),
                             chs[k].shift) & 0xFF;
          }
          if (u.kind == 5 || u.kind == 7) {
            uint8_t rgb[3];
            tracy_image::ycbcr_to_rgb(int(v[0]), int(v[1]), int(v[2]), rgb);
            v[0] = rgb[0];
            v[1] = rgb[1];
            v[2] = rgb[2];
          }
          pix(x, y) = v[0] | v[1] << 8 | v[2] << 16 | v[3] << 24;
        }
      }
    }
  }
}

// PIL's convert("RGBA") of its image, but I;16 keeps its high byte
// (ROADMAP, hazards) where PIL clips it to 255.
void to_rgba(const PilImage& im, const Jp2& j, uint8_t* out) {
  enum { kL, kI16, kP, kPA, kLA, kRGB, kRGBA, kCMYK } mode = kCMYK;
  const char* const names[] = {"L", "I;16", "P", "PA", "LA", "RGB", "RGBA"};
  for (int k = 0; k < 7; ++k) {
    if (im.mode == names[k]) mode = static_cast<decltype(mode)>(k);
  }
  const size_t n = size_t(im.w) * size_t(im.h);
  for (size_t i = 0; i < n; ++i) {
    const uint32_t v = im.px[i];
    uint8_t* o = out + 4 * i;
    switch (mode) {
      case kL:
        put(o, v, v, v, 255);
        break;
      case kI16:
        put(o, v >> 8, v >> 8, v >> 8, 255);
        break;
      case kP:
      case kPA: {
        const uint32_t idx = v & 0xFF;
        std::array<uint8_t, 4> col{0, 0, 0, 255};  // PIL's palette past its entries
        if (idx < j.palette.size()) col = j.palette[idx];
        put(o, col[0], col[1], col[2], mode == kPA ? int(v >> 24) : col[3]);
        break;
      }
      case kLA:
        put(o, v & 0xFF, v & 0xFF, v & 0xFF, v >> 24);
        break;
      case kRGB:
        put(o, v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF, 255);
        break;
      case kRGBA:
        put(o, v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF, v >> 24);
        break;
      case kCMYK: {
        const int nk = 255 - int(v >> 24);
        put(o, cmyk_channel(v & 0xFF, nk), cmyk_channel((v >> 8) & 0xFF, nk),
            cmyk_channel((v >> 16) & 0xFF, nk), 255);
      }
    }
  }
}

struct Size {
  int64_t w, h;
};

Size jpeg2000_header(const Bytes& b) {
  const Jp2 j = read_container(b);
  check_size(kFmt, j.w, j.h);
  return {j.w, j.h};
}

void jpeg2000_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const Jp2 j = read_container(b);
  check_size(kFmt, j.w, j.h);
  check_out(kFmt, j.w, j.h, out_w, out_h);
  Codestream cs;
  cs.p = b.p + j.cs_at;
  cs.n = j.cs_len;
  read_codestream(cs);
  const int nc = static_cast<int>(cs.comps.size());
  int space = j.space;
  if (is_codestream(b) || space == kUnspecified) {
    // A raw codestream: sYCC where the first component is whole and the
    // second or third subsampled (as PIL's decode shows), else by count.
    auto sub = [&](int c) { return cs.comps[c].dx != 1 || cs.comps[c].dy != 1; };
    space = nc <= 2 ? kGray : (!sub(0) && (sub(1) || sub(2))) ? kSycc : kSrgb;
  }
  if (nc > 4) fail(std::string("JPEG 2000: ") + std::to_string(nc) + " components");
  if (int64_t(cs.x1) - cs.x0 != j.w || int64_t(cs.y1) - cs.y0 != j.h) {
    fail("JPEG 2000: the JP2 header's size differs from the codestream's");
  }
  bool subsampled = false;
  for (const CompSiz& k : cs.comps) subsampled = subsampled || k.dx != 1 || k.dy != 1;
  const Unpacker* u = nullptr;
  for (const Unpacker& cand : kUnpackers) {
    if (cand.space == space && cand.comps == nc && (cand.subsampling || !subsampled) &&
        j.mode == cand.mode) {
      u = &cand;
      break;
    }
  }
  if (!u) fail("JPEG 2000: no unpacker for mode " + j.mode + " with " + std::to_string(nc) + " components");
  PilImage im{j.w, j.h, j.mode, std::vector<uint32_t>(size_t(j.w) * size_t(j.h), 0)};
  std::vector<uint8_t> ppm = cs.has_ppm ? merged_ppm(cs) : std::vector<uint8_t>();
  size_t ppm_at = 0;
  for (int tileno : cs.order) {
    const TileOut t = decode_tile(cs, tileno, ppm, ppm_at);
    unpack(cs, *u, t, cs.x0, cs.y0, im);
  }
  to_rgba(im, j, out);
}

}  // namespace

namespace tracy_image {
void ycbcr_to_rgb(int y, int cb, int cr, uint8_t* rgb) {
  rgb[0] = clip8(y + (kYcc.r_cr[cr] >> 6));
  rgb[1] = clip8(y + ((kYcc.g_cb[cb] + kYcc.g_cr[cr]) >> 6));
  rgb[2] = clip8(y + (kYcc.b_cb[cb] >> 6));
}

bool jpeg2000_size(const uint8_t* p, size_t n, int64_t* w, int64_t* h) {
  const Size s = jpeg2000_header(Bytes{p, n, kFmt});
  *w = s.w;
  *h = s.h;
  return true;
}
}  // namespace tracy_image

extern "C" {

// PIL's width and height of the file (0, or 1 with a message when the
// decoder refuses it); then tracy_jpeg2000_decode writes RGBA8 [h, w, 4].
int tracy_jpeg2000_info(const uint8_t* data, int64_t len, int* w, int* h) {
  return info(kFmt, data, len, w, h, jpeg2000_header);
}
int tracy_jpeg2000_decode(const uint8_t* data, int64_t len, uint8_t* out, int w, int h) {
  return guarded(kFmt, [&] { jpeg2000_decode({data, static_cast<size_t>(len), kFmt}, out, w, h); });
}

}  // extern "C"
