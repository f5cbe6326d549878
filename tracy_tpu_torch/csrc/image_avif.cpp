// AVIF images as PIL reads them through libavif 1.3 (and dav1d): the HEIF
// container (ftyp, meta with hdlr, pitm, iloc, iinf, iref and iprp), the
// primary AV1 item and its alpha auxiliary item, each decoded by
// av1_decode.cpp and av1_recon.cpp, then the colour conversion to RGBA8 as
// avifImageYUVToRGB computes it for PIL (libyuv's fixed-point matrices and
// bilinear chroma upsampling, or libavif's own float code;
// tools/check_avif_colour.py holds them to that function on every input).
//
// Where libavif's parser fails in a way that PIL's _open reports as
// SyntaxError (a file type without the avif or avis brand, a malformed or
// truncated box, no AV1 primary item), tracy_avif_info answers 3, "not this
// format", so that image_format tries the formats after it, as PIL does.
// A grid item's cells are decoded one by one and laid out; an image
// sequence (avis) is read as its first frame, from the first sample of its
// tracks. Refused by name: superres.

#include <array>

#include "av1_decode.h"
#include "image_common.h"

namespace {

constexpr const char* kFmt = "AVIF";

uint32_t fourcc(const char* s) {
  return uint32_t(uint8_t(s[0])) << 24 | uint8_t(s[1]) << 16 | uint8_t(s[2]) << 8 | uint8_t(s[3]);
}

struct Box {
  uint32_t type;
  size_t body, end;  // body start and end offsets in the file
};

// The boxes in [at, end) of the file.
std::vector<Box> boxes(const Bytes& b, size_t at, size_t end) {
  std::vector<Box> out;
  while (at < end) {
    if (end - at < 8) not_format("AVIF: box header is truncated");
    uint64_t size = b.be32(at);
    const uint32_t type = b.be32(at + 4);
    size_t body = at + 8;
    if (size == 1) {
      if (end - at < 16) not_format("AVIF: box header is truncated");
      size = uint64_t(b.be32(at + 8)) << 32 | b.be32(at + 12);
      body = at + 16;
    } else if (size == 0) {
      size = end - at;
    }
    if (size < body - at || size > end - at) not_format("AVIF: box size is out of range");
    out.push_back({type, body, at + size_t(size)});
    at += size_t(size);
  }
  return out;
}

const Box* find(const std::vector<Box>& v, const char* t) {
  for (const Box& x : v)
    if (x.type == fourcc(t)) return &x;
  return nullptr;
}

struct Item {
  uint32_t id = 0, type = 0;
  int method = 0;
  std::vector<std::pair<uint64_t, uint64_t>> extents;  // offset, length
  uint64_t base = 0;
  std::vector<uint32_t> props;  // property indices (1-based)
};

struct Properties {
  bool ispe = false, av1c = false, nclx = false, alpha = false;
  uint32_t w = 0, h = 0;
  int cp = 2, tc = 2, mc = 2, full = 0;
};

// The first sample of a track of an image sequence (moov).
struct Track {
  uint32_t id = 0, auxl_to = 0;
  bool pict = false, av01 = false;
  uint64_t offset = 0, size = 0;
  uint32_t w = 0, h = 0;  // tkhd's, 16.16 fixed point dropped
  bool nclx = false;
  int cp = 2, tc = 2, mc = 2, full = 0;
};

struct Container {
  Bytes b;
  uint32_t major = 0;
  std::vector<Track> tracks;
  std::vector<Item> items;
  std::vector<Box> props;
  size_t idat = 0, idat_end = 0;
  uint32_t primary = 0;
  std::vector<std::array<uint32_t, 3>> refs;  // type, from, to

  Item* item(uint32_t id) {
    for (Item& it : items)
      if (it.id == id) return &it;
    return nullptr;
  }
  Properties properties(const Item& it) {
    Properties p;
    for (uint32_t idx : it.props) {
      if (idx == 0 || idx > props.size()) not_format("AVIF: property index out of range");
      const Box& x = props[idx - 1];
      if (x.type == fourcc("ispe")) {
        b.need(x.body, 12);
        p.ispe = true;
        p.w = b.be32(x.body + 4);
        p.h = b.be32(x.body + 8);
      } else if (x.type == fourcc("av1C")) {
        p.av1c = true;
      } else if (x.type == fourcc("colr")) {
        b.need(x.body, 4);
        if (b.be32(x.body) == fourcc("nclx") && !p.nclx) {
          b.need(x.body, 11);
          p.nclx = true;
          p.cp = int(b.be16(x.body + 4));
          p.tc = int(b.be16(x.body + 6));
          p.mc = int(b.be16(x.body + 8));
          p.full = b.u8(x.body + 10) >> 7;
        }
      } else if (x.type == fourcc("auxC")) {
        std::string urn;
        for (size_t i = x.body + 4; i < x.end && b.p[i]; i++) urn += char(b.p[i]);
        p.alpha = urn == "urn:mpeg:mpegB:cicp:systems:auxiliary:alpha" ||
                  urn == "urn:mpeg:hevc:2015:auxid:1";
      }
    }
    return p;
  }
  std::vector<uint8_t> data(const Item& it) {
    std::vector<uint8_t> out;
    for (auto [off, len] : it.extents) {
      uint64_t start = it.base + off;
      if (it.method == 1) {
        if (start > idat_end - idat || len > idat_end - idat - start)
          not_format("AVIF: item data outside its idat box");
        start += idat;
      } else if (start > b.n || len > b.n - start) {
        not_format("AVIF: item data is truncated");
      }
      out.insert(out.end(), b.p + start, b.p + start + len);
    }
    return out;
  }
};

uint64_t uint_n(const Bytes& b, size_t& at, int bytes) {
  uint64_t v = 0;
  for (int i = 0; i < bytes; i++) v = v << 8 | b.u8(at + i);
  at += bytes;
  return v;
}

// The tracks of moov: each one's handler, auxl reference, sample entry
// (av01, with its colr) and the place of its first sample (stsz, stco or
// co64; the first chunk starts with the first sample).
void parse_tracks(Container& c, const Box& moov) {
  const Bytes& b = c.b;
  for (const Box& trak : boxes(b, moov.body, moov.end)) {
    if (trak.type != fourcc("trak")) continue;
    Track t;
    const std::vector<Box> tk = boxes(b, trak.body, trak.end);
    if (const Box* tkhd = find(tk, "tkhd")) {
      const bool v1 = b.u8(tkhd->body) == 1;
      t.id = b.be32(tkhd->body + (v1 ? 20 : 12));
      const size_t dims = tkhd->body + (v1 ? 88 : 76);
      t.w = b.be32(dims) >> 16, t.h = b.be32(dims + 4) >> 16;
    }
    if (const Box* tref = find(tk, "tref"))
      for (const Box& r : boxes(b, tref->body, tref->end))
        if (r.type == fourcc("auxl") && r.end >= r.body + 4) t.auxl_to = b.be32(r.body);
    const Box* mdia = find(tk, "mdia");
    if (!mdia) not_format("AVIF: track without mdia box");
    const std::vector<Box> md = boxes(b, mdia->body, mdia->end);
    const Box* hdlr = find(md, "hdlr");
    t.pict = hdlr && (b.be32(hdlr->body + 8) == fourcc("pict") || b.be32(hdlr->body + 8) == fourcc("auxv"));
    const Box* minf = find(md, "minf");
    const Box* stbl = minf ? find(boxes(b, minf->body, minf->end), "stbl") : nullptr;
    if (!stbl) not_format("AVIF: track without sample table");
    const std::vector<Box> st = boxes(b, stbl->body, stbl->end);
    const Box* stsd = find(st, "stsd");
    const Box* stsz = find(st, "stsz");
    const Box* stco = find(st, "stco");
    const Box* co64 = find(st, "co64");
    if (!stsd || !stsz || !(stco || co64)) not_format("AVIF: track sample table is incomplete");
    const std::vector<Box> entries = boxes(b, stsd->body + 8, stsd->end);
    if (!entries.empty() && entries[0].type == fourcc("av01")) {
      t.av01 = true;
      for (const Box& x : boxes(b, entries[0].body + 78, entries[0].end))
        if (x.type == fourcc("colr") && b.be32(x.body) == fourcc("nclx") && !t.nclx) {
          t.nclx = true;
          t.cp = int(b.be16(x.body + 4)), t.tc = int(b.be16(x.body + 6));
          t.mc = int(b.be16(x.body + 8)), t.full = b.u8(x.body + 10) >> 7;
        }
    }
    const uint32_t fixed = b.be32(stsz->body + 4), count = b.be32(stsz->body + 8);
    if (count == 0) not_format("AVIF: track without samples");
    t.size = fixed ? fixed : b.be32(stsz->body + 12);
    if (b.be32((stco ? stco : co64)->body + 4) == 0) not_format("AVIF: track without chunks");
    t.offset = stco ? b.be32(stco->body + 8)
                    : uint64_t(b.be32(co64->body + 8)) << 32 | b.be32(co64->body + 12);
    c.tracks.push_back(t);
  }
}

Container parse(const Bytes& b) {
  Container c{b};
  const std::vector<Box> top = boxes(b, 0, b.n);
  const Box* ftyp = top.empty() || top[0].type != fourcc("ftyp") ? nullptr : &top[0];
  if (!ftyp) not_format("AVIF: no ftyp box");
  bool brand = false;
  c.major = b.be32(ftyp->body);
  for (size_t at = ftyp->body; at + 4 <= ftyp->end; at += at == ftyp->body ? 8 : 4) {
    const uint32_t t = b.be32(at);
    if (t == fourcc("avif") || t == fourcc("avis")) brand = true;
  }
  if (!brand) not_format("AVIF: the file type has neither the avif nor the avis brand");
  if (const Box* moov = find(top, "moov")) parse_tracks(c, *moov);
  const Box* meta = find(top, "meta");
  if (!meta) return c;
  const std::vector<Box> m = boxes(b, meta->body + 4, meta->end);
  const Box* hdlr = find(m, "hdlr");
  if (!hdlr || b.be32(hdlr->body + 8) != fourcc("pict")) not_format("AVIF: no pict handler");
  const Box* pitm = find(m, "pitm");
  if (!pitm) not_format("AVIF: no primary item");
  c.primary = b.u8(pitm->body) == 0 ? b.be16(pitm->body + 4) : b.be32(pitm->body + 4);
  if (const Box* idat = find(m, "idat")) c.idat = idat->body, c.idat_end = idat->end;
  const Box* iloc = find(m, "iloc");
  const Box* iinf = find(m, "iinf");
  if (!iloc || !iinf) not_format("AVIF: no iloc or iinf box");
  {
    const int version = b.u8(iloc->body);
    size_t at = iloc->body + 4;
    const int sizes = int(b.be16(at));
    at += 2;
    const int off_size = sizes >> 12, len_size = (sizes >> 8) & 15, base_size = (sizes >> 4) & 15;
    const int idx_size = version >= 1 ? sizes & 15 : 0;
    const uint32_t count = version < 2 ? uint32_t(uint_n(b, at, 2)) : uint32_t(uint_n(b, at, 4));
    for (uint32_t i = 0; i < count; i++) {
      Item it;
      it.id = uint32_t(uint_n(b, at, version < 2 ? 2 : 4));
      if (version >= 1) it.method = int(uint_n(b, at, 2) & 15);
      uint_n(b, at, 2);  // data_reference_index
      it.base = uint_n(b, at, base_size);
      const int extents = int(uint_n(b, at, 2));
      for (int e = 0; e < extents; e++) {
        if (idx_size) uint_n(b, at, idx_size);
        const uint64_t off = uint_n(b, at, off_size), len = uint_n(b, at, len_size);
        it.extents.push_back({off, len});
      }
      if (it.method > 1) throw DecodeError("AVIF: item construction method " + std::to_string(it.method) + " not read");
      if (at > iloc->end) not_format("AVIF: iloc box is truncated");
      c.items.push_back(it);
    }
  }
  {
    const int version = b.u8(iinf->body);
    const size_t first = iinf->body + 4 + (version == 0 ? 2 : 4);
    for (const Box& infe : boxes(b, first, iinf->end)) {
      if (infe.type != fourcc("infe")) continue;
      const int v = b.u8(infe.body);
      if (v < 2) continue;
      size_t at = infe.body + 4;
      const uint32_t id = uint32_t(uint_n(b, at, v == 2 ? 2 : 4));
      at += 2;
      const uint32_t type = b.be32(at);
      Item* it = c.item(id);
      if (!it) {
        c.items.push_back(Item{});
        it = &c.items.back();
        it->id = id;
      }
      it->type = type;
    }
  }
  if (const Box* iref = find(m, "iref")) {
    const int version = b.u8(iref->body);
    const int n = version == 0 ? 2 : 4;
    for (const Box& r : boxes(b, iref->body + 4, iref->end)) {
      size_t at = r.body;
      const uint32_t from = uint32_t(uint_n(b, at, n));
      const int count = int(uint_n(b, at, 2));
      for (int i = 0; i < count; i++) c.refs.push_back({r.type, from, uint32_t(uint_n(b, at, n))});
      if (at > r.end) not_format("AVIF: iref box is truncated");
    }
  }
  if (const Box* iprp = find(m, "iprp")) {
    const std::vector<Box> pp = boxes(b, iprp->body, iprp->end);
    if (const Box* ipco = find(pp, "ipco")) c.props = boxes(b, ipco->body, ipco->end);
    for (const Box& ipma : pp) {
      if (ipma.type != fourcc("ipma")) continue;
      const int version = b.u8(ipma.body), flags = int(b.be32(ipma.body) & 0xffffff);
      size_t at = ipma.body + 4;
      const uint32_t count = uint32_t(uint_n(b, at, 4));
      for (uint32_t i = 0; i < count; i++) {
        const uint32_t id = uint32_t(uint_n(b, at, version < 1 ? 2 : 4));
        const int assoc = b.u8(at++);
        Item* it = c.item(id);
        for (int k = 0; k < assoc; k++) {
          const uint32_t v = uint32_t(uint_n(b, at, (flags & 1) ? 2 : 1));
          if (it) it->props.push_back(v & ((flags & 1) ? 0x7fff : 0x7f));
        }
      }
    }
  }
  return c;
}

av1::Picture decode_item(Container& c, const Item& it, const Properties& p);

// av1::decode, its refusals named as the AVIF file's.
av1::Picture decode_av1(const uint8_t* data, size_t n) {
  av1::Picture pic;
  try {
    av1::decode(data, n, pic);
  } catch (const DecodeError& e) {
    throw DecodeError(std::string("AVIF: ") + e.what());
  }
  return pic;
}

// A grid item (ISO/IEC 23008-12 ImageGrid): its cells, each an AV1 item of
// one size and kind, laid out row by row and cropped to the output size.
av1::Picture decode_grid(Container& c, const Item& grid, const Properties& p) {
  const std::vector<uint8_t> data = c.data(grid);
  const Bytes g{data.data(), data.size(), kFmt};
  if (g.u8(0) != 0) throw DecodeError("AVIF: grid version " + std::to_string(g.u8(0)) + " not read");
  const int rows = g.u8(2) + 1, cols = g.u8(3) + 1;
  const bool wide = g.u8(1) & 1;
  const uint32_t ow = wide ? g.be32(4) : g.be16(4), oh = wide ? g.be32(8) : g.be16(6);
  std::vector<uint32_t> cells;
  for (const auto& r : c.refs)
    if (r[0] == fourcc("dimg") && r[1] == grid.id) cells.push_back(r[2]);
  if (int(cells.size()) != rows * cols) throw DecodeError("AVIF: grid cell count differs from its layout");
  if (ow != p.w || oh != p.h) throw DecodeError("AVIF: grid size differs from its ispe property");
  av1::Picture out;
  int cell_w = 0, cell_h = 0;
  for (int k = 0; k < rows * cols; k++) {
    const Item* cell = c.item(cells[k]);
    if (!cell || cell->type != fourcc("av01")) throw DecodeError("AVIF: a grid cell is not an AV1 item");
    const av1::Picture pic = decode_item(c, *cell, c.properties(*cell));
    if (k == 0) {
      if (int64_t(cols - 1) * pic.width >= ow || int64_t(cols) * pic.width < ow ||
          int64_t(rows - 1) * pic.height >= oh || int64_t(rows) * pic.height < oh)
        throw DecodeError("AVIF: grid cells do not cover its output size");
      out = pic;
      cell_w = pic.width, cell_h = pic.height;
      out.width = int(ow), out.height = int(oh);
      for (int q = 0; q < pic.planes; q++) {
        const int sx = q ? pic.sub_x : 0, sy = q ? pic.sub_y : 0;
        out.pw[q] = (int(ow) + sx) >> sx, out.ph[q] = (int(oh) + sy) >> sy;
        out.plane[q].assign(size_t(out.pw[q]) * out.ph[q], 0);
      }
    } else if (pic.pw[0] != cell_w || pic.ph[0] != cell_h || pic.bit_depth != out.bit_depth ||
               pic.sub_x != out.sub_x ||
               pic.sub_y != out.sub_y || pic.planes != out.planes) {
      throw DecodeError("AVIF: grid cells of different kinds");
    }
    const int cr = k / cols, cc = k % cols;
    for (int q = 0; q < pic.planes; q++) {
      const int sx = q ? pic.sub_x : 0, sy = q ? pic.sub_y : 0;
      const int x0 = (cc * cell_w) >> sx, y0 = (cr * cell_h) >> sy;
      for (int y = 0; y < pic.ph[q] && y0 + y < out.ph[q]; y++)
        for (int x = 0; x < pic.pw[q] && x0 + x < out.pw[q]; x++)
          out.plane[q][size_t(y0 + y) * out.pw[q] + x0 + x] = pic.plane[q][size_t(y) * pic.pw[q] + x];
    }
  }
  return out;
}

// The planes of one AV1 (or grid) item, with its ispe size checked.
av1::Picture decode_item(Container& c, const Item& it, const Properties& p) {
  if (it.type == fourcc("grid")) return decode_grid(c, it, p);
  if (!p.av1c) not_format("AVIF: the AV1 item has no av1C property");
  const std::vector<uint8_t> data = c.data(it);
  const av1::Picture pic = decode_av1(data.data(), data.size());
  if (uint32_t(pic.width) != p.w || uint32_t(pic.height) != p.h)
    throw DecodeError("AVIF: the AV1 frame's size differs from its ispe property");
  return pic;
}

struct Image {
  av1::Picture color, alpha;
  bool has_alpha = false, premultiplied = false;
  int cp = 2, tc = 2, mc = 2, full = 0;  // as libavif takes them (nclx over the AV1 header)
};

// The first sample of a track, decoded.
av1::Picture decode_sample(Container& c, const Track& t) {
  if (!t.av01) throw DecodeError("AVIF: a track whose samples are not AV1 not read");
  if (t.offset > c.b.n || t.size > c.b.n - t.offset) not_format("AVIF: track sample is truncated");
  return decode_av1(c.b.p + t.offset, size_t(t.size));
}

// An image sequence as libavif reads it for PIL: the first frame of the
// colour track (a picture track without an auxl reference) and of the alpha
// track that references it.
Image load_tracks(Container& c, bool pixels) {
  const Track* color = nullptr;
  for (const Track& t : c.tracks)
    if (t.pict && !t.auxl_to) {
      color = &t;
      break;
    }
  if (!color) not_format("AVIF: no colour track");
  const Track* alpha = nullptr;
  for (const Track& t : c.tracks)
    if (t.auxl_to && t.auxl_to == color->id) alpha = &t;
  check_size(kFmt, color->w, color->h);
  Image img;
  img.color.width = int(color->w), img.color.height = int(color->h);
  img.has_alpha = alpha != nullptr;
  if (!pixels) return img;
  img.color = decode_sample(c, *color);
  if (color->nclx) img.cp = color->cp, img.tc = color->tc, img.mc = color->mc, img.full = color->full;
  else img.cp = img.color.color_primaries, img.tc = img.color.transfer,
       img.mc = img.color.matrix, img.full = img.color.full_range;
  if (alpha) {
    img.alpha = decode_sample(c, *alpha);
    if (img.alpha.width != img.color.width || img.alpha.height != img.color.height)
      throw DecodeError("AVIF: the alpha track's size differs from the image's");
  }
  return img;
}

Image load(const Bytes& b, bool pixels) {
  Container c = parse(b);
  // libavif's source for PIL: the tracks where the major brand is avis, or
  // where it is neither avif nor avis and the file has tracks; else the
  // primary item.
  const bool tracks = c.major == fourcc("avis") || (c.major != fourcc("avif") && !c.tracks.empty());
  if (tracks) {
    if (c.tracks.empty()) not_format("AVIF: an avis file without tracks");
    return load_tracks(c, pixels);
  }
  if (!c.primary) not_format("AVIF: no meta box");
  Item* primary = c.item(c.primary);
  if (!primary) not_format("AVIF: the primary item is not in the file");
  if (primary->type != fourcc("av01") && primary->type != fourcc("grid"))
    not_format("AVIF: the primary item is not an AV1 image");
  const Properties p = c.properties(*primary);
  if (primary->type == fourcc("av01") && !p.av1c) not_format("AVIF: the AV1 item has no av1C property");
  if (!p.ispe) not_format("AVIF: the AV1 item has no ispe property");
  check_size(kFmt, p.w, p.h);
  Image img;
  img.color.width = int(p.w), img.color.height = int(p.h);
  const Item* alpha = nullptr;
  Properties ap;
  for (const auto& r : c.refs)
    if (r[0] == fourcc("auxl") && r[2] == c.primary) {
      const Item* it = c.item(r[1]);
      if (!it || (it->type != fourcc("av01") && it->type != fourcc("grid"))) continue;
      const Properties q = c.properties(*it);
      if (!q.alpha) continue;
      if (!q.ispe) not_format("AVIF: the alpha item has no ispe property");
      if (it->type == fourcc("av01") && !q.av1c) not_format("AVIF: the alpha item has no av1C property");
      alpha = it, ap = q;
      break;
    }
  for (const auto& r : c.refs)
    if (alpha && r[0] == fourcc("prem") && r[1] == c.primary && r[2] == alpha->id)
      img.premultiplied = true;
  img.has_alpha = alpha != nullptr;
  if (!pixels) return img;
  img.color = decode_item(c, *primary, p);
  if (p.nclx) img.cp = p.cp, img.tc = p.tc, img.mc = p.mc, img.full = p.full;
  else img.cp = img.color.color_primaries, img.tc = img.color.transfer,
       img.mc = img.color.matrix, img.full = img.color.full_range;
  if (alpha) {
    img.alpha = decode_item(c, *alpha, ap);
    if (img.alpha.width != img.color.width || img.alpha.height != img.color.height)
      throw DecodeError("AVIF: the alpha item's size differs from the image's");
  }
  return img;
}

// libyuv's YUV -> RGB in fixed point (row_common.cc, YuvPixel), for the
// matrices libavif hands to libyuv: y1 = (y16 * yg >> 16) + yb with luma's
// bits repeated to 16 (y * 0x0101 at 8 bits), then each channel (y1 +-
// chroma terms) >> 6, clamped. The constants are
// libyuv's kYuv{JPEG,F709,V2020,I601,H709,2020}Constants, fitted to
// avifImageYUVToRGB's output for every 8-bit (y, u, v) and checked there by
// tools/check_avif_colour.py.
struct Yuv {
  int yg, yb, vr, ub, ug, vg;
};

// libyuv's constants of a matrix and range, or false where libavif
// converts by itself (float_rgb).
bool libyuv_constants(int mc, int full, Yuv& c) {
  const bool bt601 = mc == 2 || mc == 5 || mc == 6;
  if (full && bt601) c = {16320, 32, 90, 113, 22, 46};
  else if (full && mc == 1) c = {16320, 32, 101, 119, 12, 30};
  else if (full && mc == 9) c = {16320, 32, 94, 120, 11, 37};
  else if (!full && bt601) c = {18997, -1160, 102, 128, 25, 52};
  else if (!full && mc == 1) c = {18997, -1160, 115, 128, 14, 34};
  else if (!full && mc == 9) c = {19003, -1160, 107, 128, 12, 42};
  else return false;
  return true;
}

// kr and kb of the matrices libavif converts in float (reformat.c's table);
// false for YCgCo (8), which it converts by its own rule.
bool float_matrix(int mc, float& kr, float& kb) {
  switch (mc) {
    case 1: kr = 0.2126f, kb = 0.0722f; return true;
    case 4: kr = 0.30f, kb = 0.11f; return true;
    case 2: case 5: case 6: kr = 0.299f, kb = 0.114f; return true;
    case 7: kr = 0.212f, kb = 0.087f; return true;
    case 9: kr = 0.2627f, kb = 0.0593f; return true;
    case 8: return false;
    default: throw DecodeError("AVIF: matrix coefficients " + std::to_string(mc) + " not read");
  }
}

// The RGB of libavif's own conversion, as floats before they are stored:
// samples to floats ((v - bias) / range at the image's depth), chroma
// upsampled bilinearly in float (9/16, 3/16, 3/16, 1/16 of the nearest, the
// adjacent column, the adjacent row and the diagonal sample; 4:2:2 by rows
// alone), the identity matrix as G, B, R over the largest sample. The
// library builds with -ffp-contract=off, as this source does.
std::vector<std::array<float, 3>> float_rgb(const Image& img) {
  const av1::Picture& pc = img.color;
  const int w = pc.width, h = pc.height, s = pc.bit_depth - 8;
  const float top = float((1 << pc.bit_depth) - 1);
  const float bias_y = img.full ? 0.0f : float(16 << s), range_y = img.full ? top : float(219 << s);
  const float range_uv = img.full ? top : float(224 << s), bias_uv = float(128 << s);
  const bool identity = img.mc == 0 && pc.planes == 3;
  float kr = 0, kb = 0;
  const bool ycgco = pc.planes == 3 && !identity && !float_matrix(img.mc, kr, kb);
  const float kg = 1.0f - kr - kb;
  auto uv = [&](int v) { return (float(v) - bias_uv) / range_uv; };
  std::vector<std::array<float, 3>> rgb(size_t(w) * h);
  for (int j = 0; j < h; j++)
    for (int i = 0; i < w; i++) {
      const int yv = pc.plane[0][size_t(j) * w + i];
      const float y = (float(yv) - bias_y) / range_y;
      const int sx = pc.sub_x, sy = pc.sub_y, cw = pc.pw[1];
      if (identity) {
        const size_t ci = size_t(j >> sy) * cw + (i >> sx);
        rgb[size_t(j) * w + i] = {pc.plane[2][ci] / top, yv / top, pc.plane[1][ci] / top};
        continue;
      }
      float cb = 0.0f, cr = 0.0f;
      if (pc.planes == 3) {
        const int ui = i >> sx, uj = j >> sy;
        auto at = [&](int p, int jj, int ii) { return uv(pc.plane[p][size_t(jj) * cw + ii]); };
        if (!sx && !sy) {
          cb = at(1, uj, ui), cr = at(2, uj, ui);
        } else {
          const int adj_col = (i == 0 || (i == w - 1 && (i & 1))) ? 0 : (i & 1) ? 1 : -1;
          const int adj_row = (!sy || j == 0 || (j == h - 1 && (j & 1))) ? 0 : (j & 1) ? 1 : -1;
          for (int p = 1; p < 3; p++) {
            const float v = at(p, uj, ui) * (9.0f / 16.0f) + at(p, uj, ui + adj_col) * (3.0f / 16.0f) +
                            at(p, uj + adj_row, ui) * (3.0f / 16.0f) +
                            at(p, uj + adj_row, ui + adj_col) * (1.0f / 16.0f);
            (p == 1 ? cb : cr) = v;
          }
        }
      }
      float r, g, b;
      if (pc.planes == 1) {
        r = g = b = y;
      } else if (ycgco) {
        const float t = y - cb;
        g = y + cb, b = t - cr, r = t + cr;
      } else {
        r = y + (2 * (1 - kr)) * cr;
        b = y + (2 * (1 - kb)) * cb;
        g = y - ((2 * ((kr * (1 - kr) * cr) + (kb * (1 - kb) * cb))) / kg);
      }
      rgb[size_t(j) * w + i] = {r, g, b};
    }
  return rgb;
}

int unorm8(float c) { return int(0.5f + std::clamp(c, 0.0f, 1.0f) * 255.0f); }

// Chroma upsampled to the luma grid as libyuv's bilinear filters do it
// (ScaleRowUp2_Linear and _Bilinear, and their _16 rows: 3:1 and 9:3:3:1
// toward the nearer sample, edges repeated), of the samples >> shift; by
// repetition where `nearest`.
std::vector<int> upsample(const av1::Picture& pc, int p, int shift, bool nearest) {
  const int w = pc.width, h = pc.height, sx = pc.sub_x, sy = pc.sub_y, cw = pc.pw[p], ch = pc.ph[p];
  std::vector<int> out(size_t(w) * h);
  auto c = [&](int y, int x) {
    return int(pc.plane[p][size_t(std::clamp(y, 0, ch - 1)) * cw + std::clamp(x, 0, cw - 1)]) >>
           shift;
  };
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      int v;
      // An odd width's last column takes its chroma sample unfiltered.
      const bool last = sx && (w & 1) && x == w - 1;
      const int cx = !sx ? x : last ? x >> 1 : (x - 1) >> 1, cy = sy ? (y - 1) >> 1 : y;
      const int wx1 = sx && !last ? ((x & 1) ? 1 : 3) : 0, wy1 = sy ? ((y & 1) ? 1 : 3) : 0;
      if (nearest)
        v = c(y >> sy, x >> sx);
      else if (sx && sy)
        v = (c(cy, cx) * (4 - wx1) * (4 - wy1) + c(cy, cx + 1) * wx1 * (4 - wy1) +
             c(cy + 1, cx) * (4 - wx1) * wy1 + c(cy + 1, cx + 1) * wx1 * wy1 + 8) >> 4;
      else if (sx)
        v = (c(cy, cx) * (4 - wx1) + c(cy, cx + 1) * wx1 + 2) >> 2;
      else
        v = c(cy, cx);
      out[size_t(y) * w + x] = v;
    }
  return out;
}

// libyuv's ARGBUnattenuate (its x86 rows), as libavif unpremultiplies
// 8-bit RGBA: c * 257 * (65536 / a) >> 16 in 16 bits, packed with signed
// saturation (a = 1 gives 65535).
int unattenuate(int v, int a) {
  if (a == 255) return v;
  const uint32_t ia = a == 0 ? 0 : a == 1 ? 0xffff : 0x10000 / a;
  const uint32_t x = (uint32_t(v) * 257u * ia) >> 16;
  return x > 32767 ? 0 : int(std::min<uint32_t>(x, 255));
}

// avifImageYUVToRGB into 8-bit RGB (an image without alpha) or RGBA, as PIL
// asks for it; tools/check_avif_colour.py holds each route to it:
// - libyuv takes the matrices it has constants for, into RGB from colour
//   images and into RGBA from grey ones too (I400ToARGB, chroma 128).
//   Samples above 8 bits go down to 8 (Convert16To8Plane: v >> (depth - 8)),
//   but for RGBA from 10-bit colour (I010/I210/I410AlphaToARGB) and from
//   12-bit 4:2:0 (I012ToARGB, chroma repeated): chroma filtered at the
//   depth, then >> (depth - 8); luma's bits repeated to 16. The alpha of a
//   grey or I012 image is libavif's, not libyuv's.
// - libavif's float code takes the rest: its fast rows (grey and 4:4:4 of
//   a YUV matrix, and 8-bit full-range identity) store each channel, then
//   unpremultiply through libyuv; its slow rows unpremultiply in float,
//   min(c / a, 1).
// - libavif's own alpha: (uint8)(0.5 + a / max * 255).
void to_rgba(const Image& img, uint8_t* out) {
  const av1::Picture& pc = img.color;
  const int w = pc.width, h = pc.height, bd = pc.bit_depth, s = bd - 8;
  const size_t n = size_t(w) * h;
  const bool identity = img.mc == 0 && pc.planes == 3;
  if (identity && !img.full) throw DecodeError("AVIF: limited-range identity matrix not read");
  if (img.mc == 12) throw DecodeError("AVIF: chroma-derived matrix coefficients (12) not read");
  const bool alpha = img.has_alpha;
  if (alpha && img.alpha.bit_depth != bd)
    throw DecodeError("AVIF: an alpha item of another bit depth than the image not read");
  const float top = float((1 << bd) - 1);
  Yuv c{};
  const bool fixed = !identity && (pc.planes == 3 || alpha) && libyuv_constants(img.mc, img.full, c);
  const bool deep = fixed && alpha && pc.planes == 3 && (bd == 10 || (bd == 12 && pc.sub_x && pc.sub_y));
  const bool libyuv_alpha = fixed && pc.planes == 3 && !(bd == 12 && deep);
  std::vector<int> u, v;
  std::vector<std::array<float, 3>> frgb;
  bool slow = false;
  if (fixed && pc.planes == 3) {
    const int shift = deep ? 0 : s;
    const bool nearest = deep && bd == 12;
    u = upsample(pc, 1, shift, nearest), v = upsample(pc, 2, shift, nearest);
  } else if (!fixed) {
    frgb = float_rgb(img);
    slow = identity ? bd != 8 : img.mc == 8 || (pc.planes == 3 && (pc.sub_x || pc.sub_y));
  }
  for (size_t i = 0; i < n; i++) {
    const int yy = pc.plane[0][i];
    int a = 255;
    if (alpha) {
      const int av = img.alpha.plane[0][i];
      a = libyuv_alpha ? std::min(av >> s, 255) : unorm8(av / top);
    }
    int r, g, b;
    if (fixed) {
      const int uu = pc.planes == 3 ? std::min(u[i] >> (deep ? s : 0), 255) : 128;
      const int vv = pc.planes == 3 ? std::min(v[i] >> (deep ? s : 0), 255) : 128;
      const uint32_t y16 = deep ? uint32_t(yy << (16 - bd) | yy >> (2 * bd - 16)) : uint32_t((yy >> s) * 0x0101);
      const int y1 = int((y16 * uint32_t(c.yg)) >> 16) + c.yb;
      b = std::clamp((y1 + (uu - 128) * c.ub) >> 6, 0, 255);
      g = std::clamp((y1 - ((uu - 128) * c.ug + (vv - 128) * c.vg)) >> 6, 0, 255);
      r = std::clamp((y1 + (vv - 128) * c.vr) >> 6, 0, 255);
    } else if (slow && alpha && img.premultiplied) {
      const float fa = img.alpha.plane[0][i] / top;
      std::array<float, 3> px = frgb[i];
      for (float& x : px) {
        x = std::clamp(x, 0.0f, 1.0f);
        x = fa >= 1.0f ? x : fa > 0.0f ? std::min(x / fa, 1.0f) : 0.0f;
      }
      r = unorm8(px[0]), g = unorm8(px[1]), b = unorm8(px[2]);
    } else {
      r = unorm8(frgb[i][0]), g = unorm8(frgb[i][1]), b = unorm8(frgb[i][2]);
    }
    if (alpha && img.premultiplied && !slow) r = unattenuate(r, a), g = unattenuate(g, a), b = unattenuate(b, a);
    put(out + 4 * i, r, g, b, a);
  }
}

}  // namespace

extern "C" {

// PIL's size of the AVIF file (0; 1 with a message where the decoder refuses
// it; 3 where PIL's plugin gives the file up to the next one); then
// tracy_avif_decode writes RGBA8 [h, w, 4].
int tracy_avif_info(const uint8_t* data, int64_t len, int* w, int* h) {
  return guarded(kFmt, [&] {
    const Image img = load({data, size_t(len), kFmt}, false);
    *w = img.color.width;
    *h = img.color.height;
  });
}

int tracy_avif_decode(const uint8_t* data, int64_t len, uint8_t* out, int w, int h) {
  return guarded(kFmt, [&] {
    const Image img = load({data, size_t(len), kFmt}, true);
    check_out(kFmt, img.color.width, img.color.height, w, h);
    to_rgba(img, out);
  });
}

// The decoded planes, for the tests: meta[0..9] = width, height, bit depth,
// sub_x, sub_y, planes, has alpha, premultiplied, alpha bit depth and the
// coding tools used (av1::kTool bits of the image and its alpha); with
// non-null buffers, Y, U, V and alpha samples as uint16 (U and V at the
// chroma size).
int tracy_avif_planes(const uint8_t* data, int64_t len, int* meta, uint16_t* y, uint16_t* u,
                      uint16_t* v, uint16_t* a) {
  return guarded(kFmt, [&] {
    const Image img = load({data, size_t(len), kFmt}, true);
    const av1::Picture& p = img.color;
    const int m[10] = {p.width, p.height, p.bit_depth, p.sub_x, p.sub_y, p.planes,
                       int(img.has_alpha), int(img.premultiplied), img.alpha.bit_depth,
                       int(p.tools | img.alpha.tools)};
    std::memcpy(meta, m, sizeof(m));
    uint16_t* dst[3] = {y, u, v};
    for (int k = 0; k < p.planes; k++)
      if (dst[k]) std::memcpy(dst[k], p.plane[k].data(), p.plane[k].size() * 2);
    if (a && img.has_alpha) std::memcpy(a, img.alpha.plane[0].data(), img.alpha.plane[0].size() * 2);
  });
}

}  // extern "C"
