// AV1's syntax for the port's AVIF reader: OBUs, the sequence and frame
// headers, the symbol decoder with its CDF adaptation, and every syntax
// element of a key or intra-only frame (partitions, modes, palette, intra
// block copy vectors, transform sizes and types, coefficients), as the AV1
// Bitstream & Decoding Process Specification defines them. Reconstruction
// and the loop filters are av1_recon.cpp's; the tables, av1_tables.h's.
//
// Samples of 8, 10 and 12 bits. What is refused, by name: inter frames,
// superres, show_existing_frame, large scale tile and more than one frame.

#include "av1_decode.h"

#include "av1_tables.h"
#include "image_common.h"

namespace av1 {

const uint8_t kBlockW[22] = {4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32,
                             64, 64, 64, 128, 128, 4, 16, 8, 32, 16, 64};
const uint8_t kBlockH[22] = {4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 64,
                             32, 64, 128, 64, 128, 16, 4, 32, 8, 64, 16};
const uint8_t kTxW[19] = {4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64};
const uint8_t kTxH[19] = {4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16};

int block_size(int w, int h) {
  for (int b = 0; b < 22; b++)
    if (kBlockW[b] == w && kBlockH[b] == h) return b;
  return BLOCK_INVALID;
}
int tx_size(int w, int h) {
  for (int t = 0; t < 19; t++)
    if (kTxW[t] == w && kTxH[t] == h) return t;
  return -1;
}

int Frame::qidx(int segment, int current_q, bool ignore_delta) const {
  if (seg_enabled && feature_enabled[segment][0]) {
    const int q = (!ignore_delta && delta_q_present ? current_q : base_q) +
                  feature_data[segment][0];
    return std::clamp(q, 0, 255);
  }
  return !ignore_delta && delta_q_present ? current_q : base_q;
}

namespace {

using tracy_image::DecodeError;
[[noreturn]] void refuse(const std::string& what) { throw DecodeError(what); }

// MSB-first bit reader over the headers.
struct Bits {
  const uint8_t* p;
  size_t n, pos = 0;  // pos in bits
  uint32_t f(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; i++) {
      if (pos >= n * 8) refuse("AV1 header is truncated");
      v = v << 1 | ((p[pos >> 3] >> (7 - (pos & 7))) & 1);
      pos++;
    }
    return v;
  }
  int su(int k) {
    int v = int(f(k));
    if (v & (1 << (k - 1))) v -= 1 << k;
    return v;
  }
  uint32_t uvlc() {
    int zeros = 0;
    while (!f(1)) {
      if (++zeros >= 32) refuse("AV1 uvlc too long");
    }
    return zeros ? (f(zeros) + ((1u << zeros) - 1)) : 0;
  }
  int ns(int m) {
    const int w = log2i(m) + 1, mm = (1 << w) - m;
    const int v = int(f(w - 1));
    return v < mm ? v : (v << 1) - mm + int(f(1));
  }
  void byte_align() { pos = (pos + 7) & ~size_t(7); }
};

uint64_t leb128(const uint8_t* p, size_t n, size_t& at) {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) {
    if (at >= n) refuse("AV1 OBU size is truncated");
    const uint8_t b = p[at++];
    v |= uint64_t(b & 0x7f) << (7 * i);
    if (!(b & 0x80)) return v;
  }
  refuse("AV1 OBU size too long");
}

// The CDFs a tile adapts (libaom's layout: 32768 - cdf, then the counter).
struct Cdfs {
  uint16_t kf_y[5][5][14], angle[8][8], uv[2][13][15], partition[20][11];
  uint16_t intra_tx[3][4][13][17], inter_tx[4][4][17];
  uint16_t cfl_alpha[6][17], cfl_sign[9], filter_intra[22][3], filter_intra_mode[6];
  uint16_t pal_y_size[7][8], pal_uv_size[7][8], pal_y_mode[7][3][3], pal_uv_mode[2][3];
  uint16_t pal_y_color[7][5][9], pal_uv_color[7][5][9];
  uint16_t txfm_split[21][3], tx_size[4][3][4], skip[3][3], intrabc[3], delta_q[5];
  uint16_t delta_lf[5], delta_lf_multi[4][5], segment[3][9];
  uint16_t restore_sw[4], restore_wiener[3], restore_sgr[3];
  uint16_t mv_joint[5], mv_sign[2][3], mv_class[2][12], mv_class0[2][3], mv_bits[2][10][3];
  uint16_t txb_skip[5][13][3], eob_extra[5][2][9][3], dc_sign[2][3][3];
  uint16_t eob16[2][2][6], eob32[2][2][7], eob64[2][2][8], eob128[2][2][9];
  uint16_t eob256[2][2][10], eob512[2][2][11], eob1024[2][2][12];
  uint16_t base_eob[5][2][4][4], base[5][2][42][5], br[5][2][21][5];

  void init(int base_q) {
#define CP(dst, src) std::memcpy(dst, src, sizeof(dst))
    CP(kf_y, kKfYModeCdf);
    CP(angle, kAngleDeltaCdf);
    CP(uv, kUvModeCdf);
    CP(partition, kPartitionCdf);
    CP(intra_tx, kIntraTxTypeCdf);
    CP(inter_tx, kInterTxTypeCdf);
    CP(cfl_alpha, kCflAlphaCdf);
    CP(cfl_sign, kCflSignCdf);
    CP(filter_intra, kFilterIntraCdf);
    CP(filter_intra_mode, kFilterIntraModeCdf);
    CP(pal_y_size, kPaletteYSizeCdf);
    CP(pal_uv_size, kPaletteUvSizeCdf);
    CP(pal_y_mode, kPaletteYModeCdf);
    CP(pal_uv_mode, kPaletteUvModeCdf);
    CP(pal_y_color, kPaletteYColorCdf);
    CP(pal_uv_color, kPaletteUvColorCdf);
    CP(txfm_split, kTxfmSplitCdf);
    CP(tx_size, kTxSizeCdf);
    CP(skip, kSkipCdf);
    CP(intrabc, kIntrabcCdf);
    CP(delta_q, kDeltaQCdf);
    CP(delta_lf, kDeltaQCdf);
    for (auto& d : delta_lf_multi) CP(d, kDeltaQCdf);
    CP(segment, kSegmentIdCdf);
    CP(restore_sw, kRestoreSwitchableCdf);
    CP(restore_wiener, kRestoreWienerCdf);
    CP(restore_sgr, kRestoreSgrprojCdf);
    CP(mv_joint, kMvJointCdf);
    for (int c = 0; c < 2; c++) {
      mv_sign[c][0] = 16384, mv_sign[c][1] = mv_sign[c][2] = 0;
      CP(mv_class[c], kMvClassCdf);
      CP(mv_class0[c], kMvClass0Cdf);
      CP(mv_bits[c], kMvBitsCdf);
    }
    const int q = base_q <= 20 ? 0 : base_q <= 60 ? 1 : base_q <= 120 ? 2 : 3;
    CP(txb_skip, kTxbSkipCdf[q]);
    CP(eob_extra, kEobExtraCdf[q]);
    CP(dc_sign, kDcSignCdf[q]);
    CP(eob16, kEobPt16Cdf[q]);
    CP(eob32, kEobPt32Cdf[q]);
    CP(eob64, kEobPt64Cdf[q]);
    CP(eob128, kEobPt128Cdf[q]);
    CP(eob256, kEobPt256Cdf[q]);
    CP(eob512, kEobPt512Cdf[q]);
    CP(eob1024, kEobPt1024Cdf[q]);
    CP(base_eob, kCoeffBaseEobCdf[q]);
    CP(base, kCoeffBaseCdf[q]);
    CP(br, kCoeffBrCdf[q]);
#undef CP
  }
};

// The multi-symbol arithmetic decoder (spec 8.2): a 15-bit window, CDFs
// adapted after each symbol unless the frame disables it.
struct Symbols {
  const uint8_t* p = nullptr;
  size_t n = 0, pos = 0;  // pos in bits
  int64_t max_bits = 0;
  uint32_t value = 0, range = 0;
  bool adapt = true;

  uint32_t bits(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; i++) {
      const uint32_t b = pos < n * 8 ? (p[pos >> 3] >> (7 - (pos & 7))) & 1 : 0;
      v = v << 1 | b;
      pos++;
    }
    return v;
  }
  void init(const uint8_t* data, size_t size, bool disable_update) {
    p = data, n = size, pos = 0;
    const int nb = int(std::min<size_t>(size * 8, 15));
    const uint32_t buf = bits(nb) << (15 - nb);
    value = ((1u << 15) - 1) ^ buf;
    range = 1u << 15;
    max_bits = int64_t(size) * 8 - 15;
    adapt = !disable_update;
  }
  int decode(const uint16_t* icdf, int n_sym) {
    uint32_t cur = range, prev;
    int s = -1;
    do {
      s++;
      prev = cur;
      cur = ((range >> 8) * (uint32_t(icdf[s]) >> 6) >> 1) + 4 * uint32_t(n_sym - s - 1);
    } while (value < cur);
    range = prev - cur;
    value -= cur;
    const int b = 15 - log2i(int(range));
    range <<= b;
    const int nb = int(std::min<int64_t>(b, std::max<int64_t>(0, max_bits)));
    const uint32_t data = bits(nb) << (b - nb);
    value = data ^ (((value + 1) << b) - 1);
    max_bits -= b;
    return s;
  }
  int read(uint16_t* cdf, int n_sym) {
    const int s = decode(cdf, n_sym);
    if (adapt) {
      const int rate = 3 + (cdf[n_sym] > 15) + (cdf[n_sym] > 31) + std::min(log2i(n_sym), 2);
      int tmp = 32768;
      for (int i = 0; i < n_sym - 1; i++) {
        if (i == s) tmp = 0;
        if (tmp < cdf[i]) cdf[i] -= uint16_t((cdf[i] - tmp) >> rate);
        else cdf[i] += uint16_t((tmp - cdf[i]) >> rate);
      }
      cdf[n_sym] += cdf[n_sym] < 32;
    }
    return s;
  }
  int bit() {
    static const uint16_t half[2] = {16384, 0};
    return decode(half, 2);
  }
  int literal(int k) {
    int v = 0;
    for (int i = 0; i < k; i++) v = v << 1 | bit();
    return v;
  }
  int ns(int m) {
    const int w = log2i(m) + 1, mm = (1 << w) - m;
    const int v = literal(w - 1);
    return v < mm ? v : (v << 1) - mm + literal(1);
  }
};

constexpr int kSegBits[8] = {8, 6, 6, 6, 6, 3, 0, 0};
constexpr int kSegSigned[8] = {1, 1, 1, 1, 1, 0, 0, 0};
constexpr int kSegMax[8] = {255, 63, 63, 63, 63, 7, 0, 0};
constexpr int kIntraModeContext[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
constexpr int kModeToTxType[14] = {DCT_DCT,  ADST_DCT, DCT_ADST, DCT_DCT,  ADST_ADST,
                                   ADST_DCT, DCT_ADST, DCT_ADST, ADST_DCT, ADST_ADST,
                                   ADST_DCT, DCT_ADST, ADST_ADST, DCT_DCT};
constexpr int kFilterIntraDir[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED};
constexpr int kIntraInv1[7] = {IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
constexpr int kIntraInv2[5] = {IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
constexpr int kInterInv1[16] = {IDTX,     V_DCT,    H_DCT,     V_ADST,       H_ADST,
                                V_FLIPADST, H_FLIPADST, DCT_DCT, ADST_DCT,   DCT_ADST,
                                FLIPADST_DCT, DCT_FLIPADST, ADST_ADST, FLIPADST_FLIPADST,
                                ADST_FLIPADST, FLIPADST_ADST};
constexpr int kInterInv2[12] = {IDTX,         V_DCT,        H_DCT,     DCT_DCT,
                                ADST_DCT,     DCT_ADST,     FLIPADST_DCT, DCT_FLIPADST,
                                ADST_ADST,    FLIPADST_FLIPADST, ADST_FLIPADST,
                                FLIPADST_ADST};
constexpr int kInterInv3[2] = {IDTX, DCT_DCT};
enum { SET_DCT, SET_INTRA1, SET_INTRA2, SET_INTER1, SET_INTER2, SET_INTER3 };
constexpr int kWienerMin[3] = {-5, -23, -17}, kWienerMax[3] = {10, 8, 46}, kWienerK[3] = {1, 2, 3};
constexpr int kSgrMin[2] = {-96, -32}, kSgrMax[2] = {31, 95};
constexpr int kPaletteColorContext[9] = {-1, -1, 0, -1, -1, 4, 3, 2, 1};

int sqr_up(int t) { return tx_size(std::max(kTxW[t], kTxH[t]), std::max(kTxW[t], kTxH[t])); }
int sqr(int t) { return tx_size(std::min(kTxW[t], kTxH[t]), std::min(kTxW[t], kTxH[t])); }
int split_tx(int t) {
  const int w = kTxW[t], h = kTxH[t];
  if (w == h) return t == TX_4X4 ? TX_4X4 : tx_size(w / 2, h / 2);
  if (w == 2 * h || h == 2 * w) return tx_size(std::min(w, h), std::min(w, h));
  return w > h ? tx_size(w / 2, h) : tx_size(w, h / 2);  // 4:1
}
int max_tx_rect(int b) { return tx_size(std::min(64, int(kBlockW[b])), std::min(64, int(kBlockH[b]))); }
int is_directional(int mode) { return mode >= V_PRED && mode <= D67_PRED; }

bool tx_in_set(int set, int type) {
  switch (set) {
    case SET_DCT: return type == DCT_DCT;
    case SET_INTRA1: return type <= ADST_ADST || type == IDTX || type == V_DCT || type == H_DCT;
    case SET_INTRA2: return type <= ADST_ADST || type == IDTX;
    case SET_INTER1: return true;
    case SET_INTER2: return type <= H_DCT;
    default: return type == IDTX || type == DCT_DCT;
  }
}

struct TileDecoder {
  Frame& f;
  Cdfs c;
  Symbols s;
  int row_start, row_end, col_start, col_end;
  int current_q, delta_lf[4] = {0, 0, 0, 0};
  int ref_sgr[3][2], ref_wiener[3][2][3];
  std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];
  std::vector<uint8_t> block_decoded[3];
  int bd_stride = 0, bd_off = 0;
  bool read_deltas = false;

  // The block being decoded.
  int mi_row = 0, mi_col = 0, mi_size = 0, has_chroma = 0, avail_u = 0, avail_l = 0,
      avail_u_chroma = 0, avail_l_chroma = 0;
  int skip = 0, segment = 0, lossless = 0, is_inter = 0, use_intrabc = 0, y_mode = 0,
      uv_mode = 0, angle_y = 0, angle_uv = 0, use_filter_intra = 0, filter_intra_mode = 0,
      cfl_u = 0, cfl_v = 0, pal_y = 0, pal_uv = 0, tx = 0, max_luma_w = 0, max_luma_h = 0;
  uint16_t pal_colors[3][8];
  int16_t mv[2];
  std::vector<uint8_t> color_map[2];  // [y * 64+? ]
  int cm_stride = 128;
  int32_t coef[32 * 32];
  int32_t quant[1024];

  explicit TileDecoder(Frame& fr) : f(fr) {}

  bool inside(int r, int col) const {
    return col >= col_start && col < col_end && r >= row_start && r < row_end;
  }
  int sb4() const { return f.sb128 ? 32 : 16; }

  uint8_t& decoded_flag(int plane, int y, int x) {
    return block_decoded[plane][size_t(y + bd_off) * bd_stride + x + bd_off];
  }

  void clear_block_decoded(int r, int col) {
    const int n = sb4();
    for (int plane = 0; plane < f.planes; plane++) {
      const int sx = plane ? f.sub_x : 0, sy = plane ? f.sub_y : 0;
      const int sbw4 = (col_end - col) >> sx, sbh4 = (row_end - r) >> sy;
      for (int y = -1; y <= (n >> sy); y++)
        for (int x = -1; x <= (n >> sx); x++) {
          uint8_t v = 0;
          if (y < 0 && x < sbw4) v = 1;
          else if (x < 0 && y < sbh4) v = 1;
          decoded_flag(plane, y, x) = v;
        }
      decoded_flag(plane, n >> sy, -1) = 0;
    }
  }

  // Per-superblock loop restoration coefficients (spec 5.11.57-58).
  int subexp(int num, int k) {
    int i = 0, mk = 0;
    for (;;) {
      const int b2 = i ? k + i - 1 : k, a = 1 << b2;
      if (num <= mk + 3 * a) return s.ns(num - mk) + mk;
      if (!s.literal(1)) return s.literal(b2) + mk;
      i++;
      mk += a;
    }
  }
  static int recenter(int r, int v) {
    if (v > 2 * r) return v;
    return (v & 1) ? r - ((v + 1) >> 1) : r + (v >> 1);
  }
  int signed_subexp(int low, int high, int k, int r) {
    const int mx = high - low;
    r -= low;
    const int v = subexp(mx, k);
    const int x = (r << 1) <= mx ? recenter(r, v) : mx - 1 - recenter(mx - 1 - r, v);
    return x + low;
  }
  void read_lr_unit(int plane, int unit) {
    int type;
    if (f.lr_type[plane] == RESTORE_WIENER) type = s.read(c.restore_wiener, 2) ? RESTORE_WIENER : 0;
    else if (f.lr_type[plane] == RESTORE_SGRPROJ) type = s.read(c.restore_sgr, 2) ? RESTORE_SGRPROJ : 0;
    else type = s.read(c.restore_sw, 3);
    f.lr_unit_type[plane][unit] = uint8_t(type);
    int16_t* coefs = &f.lr_coef[plane][size_t(unit) * 6];
    if (type == RESTORE_WIENER) {
      for (int pass = 0; pass < 2; pass++) {
        const int first = plane ? 1 : 0;
        if (plane) coefs[pass * 3] = 0;
        for (int j = first; j < 3; j++) {
          const int v = signed_subexp(kWienerMin[j], kWienerMax[j] + 1, kWienerK[j],
                                      ref_wiener[plane][pass][j]);
          coefs[pass * 3 + j] = int16_t(v);
          ref_wiener[plane][pass][j] = v;
        }
      }
    } else if (type == RESTORE_SGRPROJ) {
      const int set = s.literal(4);
      f.lr_sgr_set[plane][unit] = uint8_t(set);
      for (int i = 0; i < 2; i++) {
        const int radius = kSgrParams[set][i * 2];
        int v;
        if (radius) {
          v = signed_subexp(kSgrMin[i], kSgrMax[i] + 1, 4, ref_sgr[plane][i]);
        } else {
          v = 0;
          if (i == 1) v = std::clamp((1 << 7) - ref_sgr[plane][0], kSgrMin[i], kSgrMax[i]);
        }
        coefs[i] = int16_t(v);
        ref_sgr[plane][i] = v;
      }
    }
  }
  void read_lr(int r, int col, int bsize) {
    if (f.allow_intrabc) return;
    const int w = kBlockW[bsize] / 4, h = kBlockH[bsize] / 4;
    for (int plane = 0; plane < f.planes; plane++) {
      if (f.lr_type[plane] == RESTORE_NONE) continue;
      const int sx = plane ? f.sub_x : 0, sy = plane ? f.sub_y : 0;
      const int unit = f.lr_size[plane];
      const int rows = f.lr_unit_rows[plane], cols = f.lr_unit_cols[plane];
      const int rs = (r * (4 >> sy) + unit - 1) / unit;
      const int re = std::min(rows, ((r + h) * (4 >> sy) + unit - 1) / unit);
      const int cs = (col * (4 >> sx) + unit - 1) / unit;
      const int ce = std::min(cols, ((col + w) * (4 >> sx) + unit - 1) / unit);
      for (int ur = rs; ur < re; ur++)
        for (int uc = cs; uc < ce; uc++) read_lr_unit(plane, ur * cols + uc);
    }
  }

  void decode_tile() {
    for (int p = 0; p < 3; p++) {
      above_level[p].assign(f.mi_cols + 32, 0);
      above_dc[p].assign(f.mi_cols + 32, 0);
      left_level[p].assign(f.mi_rows + 32, 0);
      left_dc[p].assign(f.mi_rows + 32, 0);
      ref_sgr[p][0] = -32, ref_sgr[p][1] = 31;
      for (int pass = 0; pass < 2; pass++)
        ref_wiener[p][pass][0] = 3, ref_wiener[p][pass][1] = -7, ref_wiener[p][pass][2] = 15;
    }
    for (int& d : delta_lf) d = 0;
    bd_stride = 32 + 3, bd_off = 1;
    for (auto& b : block_decoded) b.assign(size_t(bd_stride) * bd_stride, 0);
    const int n = sb4(), sb = f.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    for (int r = row_start; r < row_end; r += n) {
      for (int p = 0; p < 3; p++) {
        std::fill(left_level[p].begin(), left_level[p].end(), 0);
        std::fill(left_dc[p].begin(), left_dc[p].end(), 0);
      }
      for (int col = col_start; col < col_end; col += n) {
        read_deltas = f.delta_q_present;
        const int cr = r >> 4, cc = col >> 4, cs = (f.mi_cols + 15) >> 4;
        f.cdef_idx[cr * cs + cc] = -1;
        if (f.sb128) {
          if (cc + 1 < cs) f.cdef_idx[cr * cs + cc + 1] = -1;
          if ((r + 16) < f.mi_rows) {
            f.cdef_idx[(cr + 1) * cs + cc] = -1;
            if (cc + 1 < cs) f.cdef_idx[(cr + 1) * cs + cc + 1] = -1;
          }
        }
        clear_block_decoded(r, col);
        read_lr(r, col, sb);
        decode_partition(r, col, sb);
      }
    }
  }

  void decode_partition(int r, int col, int bsize) {
    if (r >= f.mi_rows || col >= f.mi_cols) return;
    const int au = inside(r - 1, col), al = inside(r, col - 1);
    const int n4 = kBlockW[bsize] / 4, half = n4 >> 1, quarter = half >> 1;
    const bool has_rows = (r + half) < f.mi_rows, has_cols = (col + half) < f.mi_cols;
    int part;
    if (bsize < BLOCK_8X8) {
      part = 0;
    } else {
      const int bsl = log2i(n4);
      const int above = au && log2i(kBlockW[f.at(r - 1, col).size] / 4) < bsl;
      const int left = al && log2i(kBlockH[f.at(r, col - 1).size] / 4) < bsl;
      uint16_t* cdf = c.partition[(bsl - 1) * 4 + left * 2 + above];
      const int nsym = bsl == 1 ? 4 : bsl == 5 ? 8 : 10;
      if (has_rows && has_cols) {
        part = s.read(cdf, nsym);
      } else if (has_cols || has_rows) {
        auto prob = [&](int e) { return (e > 0 ? cdf[e - 1] : 32768) - cdf[e]; };
        int psum;
        if (has_cols) {  // at the bottom edge: split or horizontal
          psum = prob(2) + prob(3) + prob(4) + prob(6) + prob(7);
          if (bsize != BLOCK_128X128) psum += prob(9);
        } else {  // at the right edge: split or vertical
          psum = prob(1) + prob(3) + prob(4) + prob(5) + prob(6);
          if (bsize != BLOCK_128X128) psum += prob(8);
        }
        const uint16_t icdf[2] = {uint16_t(psum), 0};
        part = s.decode(icdf, 2) ? 3 : (has_cols ? 1 : 2);
      } else {
        part = 3;
      }
    }
    const int w = kBlockW[bsize], h = kBlockH[bsize];
    const int sub_h = block_size(w, h / 2), sub_v = block_size(w / 2, h),
              split = block_size(w / 2, h / 2);
    switch (part) {
      case 0: decode_block(r, col, bsize); break;
      case 1:
        decode_block(r, col, sub_h);
        if (has_rows) decode_block(r + half, col, sub_h);
        break;
      case 2:
        decode_block(r, col, sub_v);
        if (has_cols) decode_block(r, col + half, sub_v);
        break;
      case 3:
        decode_partition(r, col, split);
        decode_partition(r, col + half, split);
        decode_partition(r + half, col, split);
        decode_partition(r + half, col + half, split);
        break;
      case 4:  // HORZ_A
        decode_block(r, col, split);
        decode_block(r, col + half, split);
        decode_block(r + half, col, sub_h);
        break;
      case 5:  // HORZ_B
        decode_block(r, col, sub_h);
        decode_block(r + half, col, split);
        decode_block(r + half, col + half, split);
        break;
      case 6:  // VERT_A
        decode_block(r, col, split);
        decode_block(r + half, col, split);
        decode_block(r, col + half, sub_v);
        break;
      case 7:  // VERT_B
        decode_block(r, col, sub_v);
        decode_block(r, col + half, split);
        decode_block(r + half, col + half, split);
        break;
      case 8: {  // HORZ_4
        const int b = block_size(w, h / 4);
        for (int i = 0; i < 4; i++)
          if (i == 0 || r + quarter * i < f.mi_rows) decode_block(r + quarter * i, col, b);
        break;
      }
      default: {  // VERT_4
        const int b = block_size(w / 4, h);
        for (int i = 0; i < 4; i++)
          if (i == 0 || col + quarter * i < f.mi_cols) decode_block(r, col + quarter * i, b);
        break;
      }
    }
  }

  int plane_size(int bsize, int plane) const {
    if (!plane) return bsize;
    const int w = std::max(4, kBlockW[bsize] >> f.sub_x), h = std::max(4, kBlockH[bsize] >> f.sub_y);
    const int b = block_size(w, h);
    if (b == BLOCK_INVALID) refuse("AV1 block size invalid for the chroma subsampling");
    return b;
  }

  void decode_block(int r, int col, int bsize) {
    mi_row = r, mi_col = col, mi_size = bsize;
    const int bw4 = kBlockW[bsize] / 4, bh4 = kBlockH[bsize] / 4;
    if (bh4 == 1 && f.sub_y && (r & 1) == 0) has_chroma = 0;
    else if (bw4 == 1 && f.sub_x && (col & 1) == 0) has_chroma = 0;
    else has_chroma = f.planes > 1;
    avail_u = inside(r - 1, col);
    avail_l = inside(r, col - 1);
    avail_u_chroma = avail_u, avail_l_chroma = avail_l;
    if (has_chroma) {
      if (f.sub_y && bh4 == 1) avail_u_chroma = inside(r - 2, col);
      if (f.sub_x && bw4 == 1) avail_l_chroma = inside(r, col - 2);
    } else {
      avail_u_chroma = avail_l_chroma = 0;
    }
    intra_frame_mode_info();
    palette_tokens();
    read_block_tx_size();
    if (skip) reset_block_context(bw4, bh4);
    // Store the block for its neighbours.
    BlockInfo b{};
    b.size = uint8_t(bsize);
    b.y_mode = uint8_t(y_mode);
    b.uv_mode = uint8_t(uv_mode);
    b.is_inter = uint8_t(is_inter);
    b.skip = uint8_t(skip);
    b.segment = uint8_t(segment);
    b.palette[0] = uint8_t(pal_y);
    b.palette[1] = uint8_t(pal_uv);
    std::memcpy(b.colors[0], pal_colors[0], sizeof(b.colors[0]));
    std::memcpy(b.colors[1], pal_colors[1], sizeof(b.colors[1]));
    b.mv[0] = mv[0], b.mv[1] = mv[1];
    for (int i = 0; i < 4; i++) b.delta_lf[i] = int8_t(delta_lf[i]);
    f.blocks.push_back(b);
    const int idx = int(f.blocks.size()) - 1;
    for (int y = 0; y < bh4 && r + y < f.mi_rows; y++)
      for (int x = 0; x < bw4 && col + x < f.mi_cols; x++)
        f.mi_block[size_t(r + y) * f.mi_cols + col + x] = idx;
    if (is_inter) compute_intrabc_prediction();
    residual();
  }

  void reset_block_context(int bw4, int bh4) {
    for (int plane = 0; plane < 1 + 2 * has_chroma; plane++) {
      const int sx = plane ? f.sub_x : 0, sy = plane ? f.sub_y : 0;
      for (int i = mi_col >> sx; i < ((mi_col + bw4 - 1) >> sx) + 1; i++)
        above_level[plane][i] = above_dc[plane][i] = 0;
      for (int i = (mi_row - row_start) >> sy; i < ((mi_row - row_start + bh4 - 1) >> sy) + 1; i++)
        left_level[plane][i] = left_dc[plane][i] = 0;
    }
  }

  // Mode info (spec 5.11.7).
  void intra_frame_mode_info() {
    skip = 0;
    if (f.seg_id_pre_skip) intra_segment_id();
    read_skip();
    if (!f.seg_id_pre_skip) intra_segment_id();
    read_cdef();
    read_delta_qindex();
    read_delta_lf();
    read_deltas = false;
    use_intrabc = f.allow_intrabc ? s.read(c.intrabc, 2) : 0;
    pal_y = pal_uv = 0;
    use_filter_intra = 0;
    angle_y = angle_uv = 0;
    mv[0] = mv[1] = 0;
    if (use_intrabc) {
      is_inter = 1;
      f.tools |= kToolIntrabc;
      y_mode = DC_PRED, uv_mode = DC_PRED;
      read_intrabc_mv();
      return;
    }
    is_inter = 0;
    const int above = avail_u ? int(f.at(mi_row - 1, mi_col).y_mode) : int(DC_PRED);
    const int left = avail_l ? int(f.at(mi_row, mi_col - 1).y_mode) : int(DC_PRED);
    y_mode = s.read(c.kf_y[kIntraModeContext[above]][kIntraModeContext[left]], 13);
    if (mi_size >= BLOCK_8X8 && is_directional(y_mode))
      angle_y = s.read(c.angle[y_mode - V_PRED], 7) - 3;
    if (has_chroma) {
      int cfl_allowed;
      if (lossless && plane_size(mi_size, 1) == BLOCK_4X4) cfl_allowed = 1;
      else if (!lossless && std::max(kBlockW[mi_size], kBlockH[mi_size]) <= 32) cfl_allowed = 1;
      else cfl_allowed = 0;
      uv_mode = s.read(c.uv[cfl_allowed][y_mode], 13 + cfl_allowed);
      if (uv_mode == UV_CFL_PRED) read_cfl_alphas(), f.tools |= kToolCfl;
      if (mi_size >= BLOCK_8X8 && is_directional(uv_mode))
        angle_uv = s.read(c.angle[uv_mode - V_PRED], 7) - 3;
    } else {
      uv_mode = DC_PRED;
    }
    if (mi_size >= BLOCK_8X8 && kBlockW[mi_size] <= 64 && kBlockH[mi_size] <= 64 &&
        f.screen_content)
      palette_mode_info();
    if (f.enable_filter_intra && y_mode == DC_PRED && pal_y == 0 &&
        std::max(kBlockW[mi_size], kBlockH[mi_size]) <= 32) {
      use_filter_intra = s.read(c.filter_intra[mi_size], 2);
      if (use_filter_intra) filter_intra_mode = s.read(c.filter_intra_mode, 5), f.tools |= kToolFilterIntra;
    }
  }

  void intra_segment_id() {
    if (f.seg_enabled) {
      const int ul = avail_u && avail_l ? f.at(mi_row - 1, mi_col - 1).segment : -1;
      const int u = avail_u ? f.at(mi_row - 1, mi_col).segment : -1;
      const int l = avail_l ? f.at(mi_row, mi_col - 1).segment : -1;
      int pred;
      if (u == -1) pred = l == -1 ? 0 : l;
      else if (l == -1) pred = u;
      else pred = ul == u ? u : l;
      if (skip) {
        segment = pred;
      } else {
        int ctx;
        if (ul < 0) ctx = 0;
        else if (ul == u && ul == l) ctx = 2;
        else if (ul == u || ul == l || u == l) ctx = 1;
        else ctx = 0;
        // neg_deinterleave(diff, pred, LastActiveSegId + 1)
        const int diff = s.read(c.segment[ctx], 8), mx = f.last_active_seg + 1;
        const int near = (diff & 1) ? pred + ((diff + 1) >> 1) : pred - (diff >> 1);
        int v;
        if (!pred) v = diff;
        else if (pred >= mx - 1) v = mx - diff - 1;
        else if (2 * pred < mx) v = diff <= 2 * pred ? near : diff;
        else v = diff <= 2 * (mx - pred - 1) ? near : mx - (diff + 1);
        segment = std::clamp(v, 0, f.last_active_seg);
      }
    } else {
      segment = 0;
    }
    lossless = f.lossless[segment];
  }

  void read_skip() {
    if (f.seg_id_pre_skip && f.seg_enabled && f.feature_enabled[segment][6]) {
      skip = 1;
    } else {
      const int ctx = (avail_u ? f.at(mi_row - 1, mi_col).skip : 0) +
                      (avail_l ? f.at(mi_row, mi_col - 1).skip : 0);
      skip = s.read(c.skip[ctx], 2);
    }
  }

  void read_cdef() {
    if (skip || f.coded_lossless || !f.enable_cdef || f.allow_intrabc) return;
    const int cs = (f.mi_cols + 15) >> 4;
    const int r = mi_row >> 4, col = mi_col >> 4;
    int8_t& idx = f.cdef_idx[r * cs + col];
    if (idx == -1) {
      idx = int8_t(s.literal(f.cdef_bits));
      const int w4 = kBlockW[mi_size] / 4, h4 = kBlockH[mi_size] / 4;
      for (int y = mi_row & ~15; y < (mi_row & ~15) + h4; y += 16)
        for (int x = mi_col & ~15; x < (mi_col & ~15) + w4; x += 16)
          if (y < f.mi_rows && x < f.mi_cols) f.cdef_idx[(y >> 4) * cs + (x >> 4)] = idx;
    }
  }

  void read_delta_qindex() {
    const int sb = f.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    if (mi_size == sb && skip) return;
    if (read_deltas) {
      int a = s.read(c.delta_q, 4);
      if (a == 3) {
        const int rem = s.literal(3) + 1;
        a = s.literal(rem) + (1 << rem) + 1;
      }
      if (a) {
        const int sign = s.literal(1);
        const int reduced = sign ? -a : a;
        current_q = std::clamp(current_q + (reduced << f.delta_q_res), 1, 255);
        f.tools |= kToolDeltaQ;
      }
    }
  }

  void read_delta_lf() {
    const int sb = f.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    if (mi_size == sb && skip) return;
    if (read_deltas && f.delta_lf_present) {
      const int count = f.delta_lf_multi ? (f.planes > 1 ? 4 : 2) : 1;
      for (int i = 0; i < count; i++) {
        int a = s.read(f.delta_lf_multi ? c.delta_lf_multi[i] : c.delta_lf, 4);
        if (a == 3) {
          const int n = s.literal(3) + 1;
          a = s.literal(n) + (1 << n) + 1;
        }
        if (a) {
          const int sign = s.literal(1);
          const int reduced = sign ? -a : a;
          delta_lf[i] = std::clamp(delta_lf[i] + (reduced << f.delta_lf_res), -63, 63);
          f.tools |= kToolDeltaLf;
        }
      }
    }
  }

  void read_cfl_alphas() {
    const int signs = s.read(c.cfl_sign, 8);
    const int su = (signs + 1) / 3, sv = (signs + 1) % 3;
    cfl_u = cfl_v = 0;
    if (su) {
      cfl_u = 1 + s.read(c.cfl_alpha[(su - 1) * 3 + sv], 16);
      if (su == 1) cfl_u = -cfl_u;
    }
    if (sv) {
      cfl_v = 1 + s.read(c.cfl_alpha[(sv - 1) * 3 + su], 16);
      if (sv == 1) cfl_v = -cfl_v;
    }
  }

  int palette_cache(int plane, uint16_t* cache) {
    int above_n = 0, left_n = 0;
    const BlockInfo* a = nullptr;
    const BlockInfo* l = nullptr;
    if ((mi_row * 4) % 64 && avail_u) {
      a = &f.at(mi_row - 1, mi_col);
      above_n = a->palette[plane];
    }
    if (avail_l) {
      l = &f.at(mi_row, mi_col - 1);
      left_n = l->palette[plane];
    }
    int ai = 0, li = 0, n = 0;
    while (ai < above_n && li < left_n) {
      const int ac = a->colors[plane][ai], lc = l->colors[plane][li];
      if (lc < ac) {
        if (n == 0 || lc != cache[n - 1]) cache[n++] = uint16_t(lc);
        li++;
      } else {
        if (n == 0 || ac != cache[n - 1]) cache[n++] = uint16_t(ac);
        ai++;
        if (lc == ac) li++;
      }
    }
    for (; ai < above_n; ai++) {
      const int v = a->colors[plane][ai];
      if (n == 0 || v != cache[n - 1]) cache[n++] = uint16_t(v);
    }
    for (; li < left_n; li++) {
      const int v = l->colors[plane][li];
      if (n == 0 || v != cache[n - 1]) cache[n++] = uint16_t(v);
    }
    return n;
  }

  static int ceil_log2(int x) {
    if (x < 2) return 0;
    int i = 1, p = 2;
    while (p < x) i++, p <<= 1;
    return i;
  }

  void read_palette_colors(int plane, int n) {
    uint16_t cache[16];
    const int cn = palette_cache(plane, cache);
    const int bdmax = (1 << f.bit_depth) - 1;
    uint16_t* colors = pal_colors[plane];
    int idx = 0;
    for (int i = 0; i < cn && idx < n; i++)
      if (s.literal(1)) colors[idx++] = cache[i];
    if (idx < n) {
      colors[idx++] = uint16_t(s.literal(f.bit_depth));
      if (idx < n) {
        int bits = f.bit_depth - 3 + s.literal(2);
        for (; idx < n; idx++) {
          int delta = s.literal(bits);
          if (plane == 0) delta++;
          colors[idx] = uint16_t(std::clamp(colors[idx - 1] + delta, 0, bdmax));
          const int range = (1 << f.bit_depth) - colors[idx] - (plane == 0 ? 1 : 0);
          bits = std::min(bits, ceil_log2(range));
        }
      }
      std::sort(colors, colors + n);
    }
  }

  void palette_mode_info() {
    const int bctx = log2i(kBlockW[mi_size] / 4) + log2i(kBlockH[mi_size] / 4) - 2;
    if (y_mode == DC_PRED) {
      const int ctx = (avail_u && f.at(mi_row - 1, mi_col).palette[0] > 0) +
                      (avail_l && f.at(mi_row, mi_col - 1).palette[0] > 0);
      if (s.read(c.pal_y_mode[bctx][ctx], 2)) {
        pal_y = s.read(c.pal_y_size[bctx], 7) + 2;
        f.tools |= kToolPalette;
        read_palette_colors(0, pal_y);
      }
    }
    if (has_chroma && uv_mode == DC_PRED) {
      if (s.read(c.pal_uv_mode[pal_y > 0], 2)) {
        pal_uv = s.read(c.pal_uv_size[bctx], 7) + 2;
        f.tools |= kToolPalette;
        read_palette_colors(1, pal_uv);
        uint16_t* v = pal_colors[2];
        if (s.literal(1)) {
          const int maxv = 1 << f.bit_depth;
          const int bits = f.bit_depth - 4 + s.literal(2);
          v[0] = uint16_t(s.literal(f.bit_depth));
          for (int idx = 1; idx < pal_uv; idx++) {
            int delta = s.literal(bits);
            if (delta && s.literal(1)) delta = -delta;
            int val = v[idx - 1] + delta;
            if (val < 0) val += maxv;
            if (val >= maxv) val -= maxv;
            v[idx] = uint16_t(std::clamp(val, 0, maxv - 1));
          }
        } else {
          for (int idx = 0; idx < pal_uv; idx++) v[idx] = uint16_t(s.literal(f.bit_depth));
        }
      }
    }
  }

  void palette_tokens() {
    int bh = kBlockH[mi_size], bw = kBlockW[mi_size];
    int oh = std::min(bh, (f.mi_rows - mi_row) * 4), ow = std::min(bw, (f.mi_cols - mi_col) * 4);
    for (int plane = 0; plane < 2; plane++) {
      const int n = plane ? pal_uv : pal_y;
      if (!n) continue;
      if (plane) {
        bh >>= f.sub_y, bw >>= f.sub_x, oh >>= f.sub_y, ow >>= f.sub_x;
        if (bw < 4) bw += 2, ow += 2;
        if (bh < 4) bh += 2, oh += 2;
      }
      std::vector<uint8_t>& m = color_map[plane];
      m.assign(size_t(cm_stride) * cm_stride, 0);
      m[0] = uint8_t(s.ns(n));
      for (int i = 1; i < oh + ow - 1; i++) {
        for (int j = std::min(i, ow - 1); j >= std::max(0, i - oh + 1); j--) {
          const int rr = i - j, cc = j;
          int scores[8] = {0, 0, 0, 0, 0, 0, 0, 0}, order[8] = {0, 1, 2, 3, 4, 5, 6, 7};
          if (cc > 0) scores[m[rr * cm_stride + cc - 1]] += 2;
          if (rr > 0 && cc > 0) scores[m[(rr - 1) * cm_stride + cc - 1]] += 1;
          if (rr > 0) scores[m[(rr - 1) * cm_stride + cc]] += 2;
          for (int k = 0; k < 3; k++) {
            int best = scores[k], bi = k;
            for (int q = k + 1; q < n; q++)
              if (scores[q] > best) best = scores[q], bi = q;
            if (bi != k) {
              const int bs = scores[bi], bo = order[bi];
              for (int q = bi; q > k; q--) scores[q] = scores[q - 1], order[q] = order[q - 1];
              scores[k] = bs, order[k] = bo;
            }
          }
          const int ctx = kPaletteColorContext[scores[0] + 2 * scores[1] + 2 * scores[2]];
          uint16_t* cdf = plane ? c.pal_uv_color[n - 2][ctx] : c.pal_y_color[n - 2][ctx];
          m[rr * cm_stride + cc] = uint8_t(order[s.read(cdf, n)]);
        }
      }
      for (int i = 0; i < oh; i++)
        for (int j = ow; j < bw; j++) m[i * cm_stride + j] = m[i * cm_stride + ow - 1];
      for (int i = oh; i < bh; i++)
        for (int j = 0; j < bw; j++) m[i * cm_stride + j] = m[(oh - 1) * cm_stride + j];
    }
  }

  // Transform sizes (spec 5.11.15-17).
  int above_tx_width(int r, int col) {
    if (r == mi_row) {
      if (!avail_u) return 64;
      const BlockInfo& b = f.at(r - 1, col);
      if (b.skip && b.is_inter) return kBlockW[b.size];
    }
    return kTxW[f.inter_tx[size_t(r - 1) * f.mi_cols + col]];
  }
  int left_tx_height(int r, int col) {
    if (col == mi_col) {
      if (!avail_l) return 64;
      const BlockInfo& b = f.at(r, col - 1);
      if (b.skip && b.is_inter) return kBlockH[b.size];
    }
    return kTxH[f.inter_tx[size_t(r) * f.mi_cols + col - 1]];
  }
  void set_inter_tx(int r, int col, int w4, int h4, int t) {
    for (int y = 0; y < h4 && r + y < f.mi_rows; y++)
      for (int x = 0; x < w4 && col + x < f.mi_cols; x++)
        f.inter_tx[size_t(r + y) * f.mi_cols + col + x] = uint8_t(t);
  }
  void read_var_tx_size(int r, int col, int t, int depth) {
    if (r >= f.mi_rows || col >= f.mi_cols) return;
    int split = 0;
    if (t != TX_4X4 && depth != 2) {
      const int above = above_tx_width(r, col) < kTxW[t];
      const int left = left_tx_height(r, col) < kTxH[t];
      const int size = std::min(64, std::max<int>(kBlockW[mi_size], kBlockH[mi_size]));
      const int max_sz = tx_size(size, size);
      const int ctx = (sqr_up(t) != max_sz) * 3 + (TX_64X64 - max_sz) * 6 + above + left;
      split = s.read(c.txfm_split[ctx], 2);
      if (split) f.tools |= kToolVarTx;
    }
    const int w4 = kTxW[t] / 4, h4 = kTxH[t] / 4;
    if (split) {
      const int sub = split_tx(t), sw = kTxW[sub] / 4, sh = kTxH[sub] / 4;
      for (int i = 0; i < h4; i += sh)
        for (int j = 0; j < w4; j += sw) read_var_tx_size(r + i, col + j, sub, depth + 1);
    } else {
      set_inter_tx(r, col, w4, h4, t);
      tx = t;
    }
  }
  void read_block_tx_size() {
    const int bw4 = kBlockW[mi_size] / 4, bh4 = kBlockH[mi_size] / 4;
    if (f.tx_mode_select && mi_size > BLOCK_4X4 && is_inter && !skip && !lossless) {
      const int mt = max_tx_rect(mi_size), w4 = kTxW[mt] / 4, h4 = kTxH[mt] / 4;
      for (int r = mi_row; r < mi_row + bh4; r += h4)
        for (int col = mi_col; col < mi_col + bw4; col += w4) read_var_tx_size(r, col, mt, 0);
    } else {
      read_tx_size(!skip || !is_inter);
      set_inter_tx(mi_row, mi_col, bw4, bh4, tx);
    }
  }
  void read_tx_size(bool allow_select) {
    if (lossless) {
      tx = TX_4X4;
      return;
    }
    const int mt = max_tx_rect(mi_size);
    tx = mt;
    if (mi_size > BLOCK_4X4 && allow_select && f.tx_mode_select) {
      int depth_max = 0;
      for (int t = mt; t != TX_4X4; t = split_tx(t)) depth_max++;
      const int cat = depth_max - 1, max_depth = std::min(depth_max, 2);
      const int mw = kTxW[mt], mh = kTxH[mt];
      int above_w = 0, left_h = 0;
      if (avail_u) {
        const BlockInfo& b = f.at(mi_row - 1, mi_col);
        above_w = b.is_inter ? kBlockW[b.size] : above_tx_width(mi_row, mi_col);
      }
      if (avail_l) {
        const BlockInfo& b = f.at(mi_row, mi_col - 1);
        left_h = b.is_inter ? kBlockH[b.size] : left_tx_height(mi_row, mi_col);
      }
      const int ctx = (above_w >= mw) + (left_h >= mh);
      const int depth = s.read(c.tx_size[cat][ctx], max_depth + 1);
      for (int i = 0; i < depth; i++) tx = split_tx(tx);
    }
  }

  // Intra block copy's vector (spec 5.11.26, 7.10.2).
  void read_intrabc_mv() {
    const int bw4 = kBlockW[mi_size] / 4, bh4 = kBlockH[mi_size] / 4;
    int stack[8][2], weight[8], found = 0;
    auto add = [&](int r, int col, int w) {
      const BlockInfo& b = f.at(r, col);
      if (!b.is_inter) return;
      int cand[2] = {b.mv[0], b.mv[1]};
      for (int i = 0; i < 2; i++) {  // lower_mv_precision with integer vectors
        const int a = std::abs(cand[i]), ai = (a + 3) >> 3;
        if (cand[i] > 0) cand[i] = ai << 3;
        else if (cand[i] < 0) cand[i] = -(ai << 3);
      }
      int k = 0;
      for (; k < found; k++)
        if (stack[k][0] == cand[0] && stack[k][1] == cand[1]) break;
      if (k < found) weight[k] += w;
      else if (found < 8) stack[found][0] = cand[0], stack[found][1] = cand[1], weight[found++] = w;
    };
    auto scan_row = [&](int delta_row) {
      const int end4 = std::min(std::min(bw4, f.mi_cols - mi_col), 16);
      int delta_col = 0;
      const bool step16 = bw4 >= 16;
      if (std::abs(delta_row) > 1) delta_row += mi_row & 1, delta_col = 1 - (mi_col & 1);
      for (int i = 0; i < end4;) {
        const int r = mi_row + delta_row, col = mi_col + delta_col + i;
        if (!inside(r, col)) break;
        int len = std::min(bw4, kBlockW[f.at(r, col).size] / 4);
        if (std::abs(delta_row) > 1) len = std::max(2, len);
        if (step16) len = std::max(4, len);
        add(r, col, len * 2);
        i += len;
      }
    };
    auto scan_col = [&](int delta_col) {
      const int end4 = std::min(std::min(bh4, f.mi_rows - mi_row), 16);
      int delta_row = 0;
      const bool step16 = bh4 >= 16;
      if (std::abs(delta_col) > 1) delta_row = 1 - (mi_row & 1), delta_col += mi_col & 1;
      for (int i = 0; i < end4;) {
        const int r = mi_row + delta_row + i, col = mi_col + delta_col;
        if (!inside(r, col)) break;
        int len = std::min(bh4, kBlockH[f.at(r, col).size] / 4);
        if (std::abs(delta_col) > 1) len = std::max(2, len);
        if (step16) len = std::max(4, len);
        add(r, col, len * 2);
        i += len;
      }
    };
    auto scan_point = [&](int dr, int dc) {
      const int r = mi_row + dr, col = mi_col + dc;
      if (inside(r, col) && f.decoded(r, col)) add(r, col, 4);
    };
    scan_row(-1);
    scan_col(-1);
    if (std::max(bw4, bh4) <= 16) scan_point(-1, bw4);
    const int nearest = found;
    for (int i = 0; i < nearest; i++) weight[i] += 640;
    scan_point(-1, -1);
    scan_row(-3);
    scan_col(-3);
    if (bh4 > 1) scan_row(-5);
    if (bw4 > 1) scan_col(-5);
    auto sort_stack = [&](int start, int end) {
      while (end > start) {
        int new_end = start;
        for (int i = start + 1; i < end; i++)
          if (weight[i - 1] < weight[i]) {
            std::swap(weight[i - 1], weight[i]);
            std::swap(stack[i - 1][0], stack[i][0]);
            std::swap(stack[i - 1][1], stack[i][1]);
            new_end = i;
          }
        end = new_end;
      }
    };
    sort_stack(0, nearest);
    sort_stack(nearest, found);
    for (int i = 0; i < found; i++) {  // clamp to the frame plus a border
      const int top = -(mi_row * 4 * 8), bottom = (f.mi_rows - bh4 - mi_row) * 4 * 8;
      const int left = -(mi_col * 4 * 8), right = (f.mi_cols - bw4 - mi_col) * 4 * 8;
      stack[i][0] = std::clamp(stack[i][0], top - (128 + bh4 * 32), bottom + 128 + bh4 * 32);
      stack[i][1] = std::clamp(stack[i][1], left - (128 + bw4 * 32), right + 128 + bw4 * 32);
    }
    for (int i = found; i < 2; i++) stack[i][0] = stack[i][1] = 0;
    int pred[2] = {stack[0][0], stack[0][1]};
    if (!pred[0] && !pred[1]) pred[0] = stack[1][0], pred[1] = stack[1][1];
    if (!pred[0] && !pred[1]) {
      const int n = sb4();
      if (mi_row - n < row_start) pred[0] = 0, pred[1] = -(n * 4 + 256) * 8;
      else pred[0] = -(n * 4 * 8), pred[1] = 0;
    }
    const int joint = s.read(c.mv_joint, 4);
    int diff[2] = {0, 0};
    if (joint == 2 || joint == 3) diff[0] = read_mv_component(0);
    if (joint == 1 || joint == 3) diff[1] = read_mv_component(1);
    mv[0] = int16_t(pred[0] + diff[0]);
    mv[1] = int16_t(pred[1] + diff[1]);
  }
  int read_mv_component(int comp) {
    const int sign = s.read(c.mv_sign[comp], 2);
    const int cls = s.read(c.mv_class[comp], 11);
    int mag;
    if (cls == 0) {
      const int bit = s.read(c.mv_class0[comp], 2);
      mag = ((bit << 3) | (3 << 1) | 1) + 1;
    } else {
      int d = 0;
      for (int i = 0; i < cls; i++) d |= s.read(c.mv_bits[comp][i], 2) << i;
      mag = (2 << (cls + 2)) + ((d << 3) | (3 << 1) | 1) + 1;
    }
    return sign ? -mag : mag;
  }

  void compute_intrabc_prediction() {
    for (int plane = 0; plane < 1 + 2 * has_chroma; plane++) {
      const int sx = plane ? f.sub_x : 0, sy = plane ? f.sub_y : 0;
      const int ps = plane_size(mi_size, plane);
      const int x = (mi_col >> sx) * 4, y = (mi_row >> sy) * 4;
      predict_intrabc(f, plane, x, y, kBlockW[ps], kBlockH[ps], mv);
    }
  }

  // Residual (spec 5.11.34-39).
  int uv_tx(int plane) const {
    if (lossless) return TX_4X4;
    if (!plane) return tx;
    const int t = max_tx_rect(plane_size(mi_size, plane));
    if (kTxW[t] == 64 || kTxH[t] == 64) {
      if (kTxW[t] == 16) return TX_16X32;
      if (kTxH[t] == 16) return TX_32X16;
      return TX_32X32;
    }
    return t;
  }
  void residual() {
    const int wc = std::max(1, kBlockW[mi_size] >> 6), hc = std::max(1, kBlockH[mi_size] >> 6);
    for (int cy = 0; cy < hc; cy++)
      for (int cx = 0; cx < wc; cx++) {
        const int rc = mi_row + (cy << 4), ccol = mi_col + (cx << 4);
        for (int plane = 0; plane < 1 + 2 * has_chroma; plane++) {
          const int t = lossless ? TX_4X4 : (plane ? uv_tx(plane) : tx);
          const int step_x = kTxW[t] >> 2, step_y = kTxH[t] >> 2;
          const int ps = plane_size(mi_size, plane);
          const int n4w = kBlockW[ps] >> 2, n4h = kBlockH[ps] >> 2;
          const int sx = plane ? f.sub_x : 0, sy = plane ? f.sub_y : 0;
          if (is_inter && !lossless && !plane) {
            transform_tree((ccol >> sx) * 4, (rc >> sy) * 4, n4w * 4, n4h * 4);
          } else {
            const int bx = (mi_col >> sx) * 4, by = (mi_row >> sy) * 4;
            for (int y = 0; y < std::min(n4h, 16 >> sy); y += step_y)
              for (int x = 0; x < std::min(n4w, 16 >> sx); x += step_x)
                transform_block(plane, bx, by, t, x + ((cx << 4) >> sx), y + ((cy << 4) >> sy));
          }
        }
      }
  }
  void transform_tree(int x, int y, int w, int h) {
    if (x >= f.mi_cols * 4 || y >= f.mi_rows * 4) return;
    const int t = f.inter_tx[size_t(y >> 2) * f.mi_cols + (x >> 2)];
    if (w <= kTxW[t] && h <= kTxH[t]) {
      transform_block(0, x, y, t, 0, 0);
    } else if (w > h) {
      transform_tree(x, y, w / 2, h);
      transform_tree(x + w / 2, y, w / 2, h);
    } else if (w < h) {
      transform_tree(x, y, w, h / 2);
      transform_tree(x, y + h / 2, w, h / 2);
    } else {
      transform_tree(x, y, w / 2, h / 2);
      transform_tree(x + w / 2, y, w / 2, h / 2);
      transform_tree(x, y + h / 2, w / 2, h / 2);
      transform_tree(x + w / 2, y + h / 2, w / 2, h / 2);
    }
  }

  int filter_type(int plane) {
    auto smooth = [&](int r, int col) {
      const BlockInfo& b = f.at(r, col);
      int mode;
      if (!plane) mode = b.y_mode;
      else {
        if (b.is_inter) return false;
        mode = b.uv_mode;
      }
      return mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED;
    };
    bool a = false, l = false;
    if (plane ? avail_u_chroma : avail_u) {
      int r = mi_row - 1, col = mi_col;
      if (plane) {
        if (f.sub_x && !(mi_col & 1)) col++;
        if (f.sub_y && (mi_row & 1)) r--;
      }
      a = smooth(r, col);
    }
    if (plane ? avail_l_chroma : avail_l) {
      int r = mi_row, col = mi_col - 1;
      if (plane) {
        if (f.sub_x && (mi_col & 1)) col--;
        if (f.sub_y && !(mi_row & 1)) r++;
      }
      l = smooth(r, col);
    }
    return a || l;
  }

  void transform_block(int plane, int bx, int by, int t, int x, int y) {
    const int start_x = bx + 4 * x, start_y = by + 4 * y;
    const int sx = plane ? f.sub_x : 0, sy = plane ? f.sub_y : 0;
    const int row = (start_y << sy) >> 2, col = (start_x << sx) >> 2;
    const int mask = f.sb128 ? 31 : 15;
    const int sbr = row & mask, sbc = col & mask;
    const int step_x = kTxW[t] >> 2, step_y = kTxH[t] >> 2;
    const int max_x = ((f.mi_cols * 4) >> sx) - 1, max_y = ((f.mi_rows * 4) >> sy) - 1;
    if (start_x >= max_x || start_y >= max_y) return;
    if (!is_inter) {
      const int npal = plane ? pal_uv : pal_y;
      if (npal) {
        const uint16_t* pal = pal_colors[plane];
        const std::vector<uint8_t>& m = color_map[plane ? 1 : 0];
        for (int i = 0; i < kTxH[t]; i++)
          for (int j = 0; j < kTxW[t]; j++)
            f.px(plane, start_y + i, start_x + j) = pal[m[(y * 4 + i) * cm_stride + x * 4 + j]];
      } else {
        const bool cfl = plane > 0 && uv_mode == UV_CFL_PRED;
        const int mode = plane == 0 ? y_mode : (cfl ? DC_PRED : uv_mode);
        const bool have_left = (plane ? avail_l_chroma : avail_l) || x > 0;
        const bool have_above = (plane ? avail_u_chroma : avail_u) || y > 0;
        const bool above_rt = decoded_flag(plane, (sbr >> sy) - 1, (sbc >> sx) + step_x);
        const bool below_lft = decoded_flag(plane, (sbr >> sy) + step_y, (sbc >> sx) - 1);
        const int ftype = f.enable_edge_filter && is_directional(mode) ? filter_type(plane) : 0;
        predict_intra(f, plane, start_x, start_y, have_left, have_above, above_rt, below_lft,
                      mode, plane ? angle_uv : angle_y,
                      plane == 0 && use_filter_intra ? filter_intra_mode : -1,
                      log2i(kTxW[t]), log2i(kTxH[t]), ftype);
        if (cfl)
          predict_cfl(f, plane, start_x, start_y, t, plane == 1 ? cfl_u : cfl_v, max_luma_w,
                      max_luma_h);
      }
      if (plane == 0) {
        max_luma_w = start_x + step_x * 4;
        max_luma_h = start_y + step_y * 4;
      }
    }
    if (!skip) {
      int type = DCT_DCT;
      const int eob = coeffs(plane, start_x, start_y, t, type);
      if (eob > 0) reconstruct(f, plane, start_x, start_y, t, type, lossless, coef);
      if (eob > 0 && lossless) f.tools |= kToolLossless;
      if (eob > 0 && (kTxW[t] == 64 || kTxH[t] == 64)) f.tools |= kToolTx64;
    }
    for (int i = 0; i < step_y; i++)
      for (int j = 0; j < step_x; j++) {
        const int pr = (row >> sy) + i, pc = (col >> sx) + j;
        const int pcols = (f.mi_cols + sx) >> sx, prows = (f.mi_rows + sy) >> sy;
        if (pr < prows && pc < pcols) f.lf_tx[plane][size_t(pr) * pcols + pc] = uint8_t(t);
        decoded_flag(plane, (sbr >> sy) + i, (sbc >> sx) + j) = 1;
      }
  }

  int tx_set(int t) const {
    const int up = sqr_up(t), sq = sqr(t);
    if (up > TX_32X32) return SET_DCT;
    if (is_inter) {
      if (f.reduced_tx_set || up == TX_32X32) return SET_INTER3;
      if (sq == TX_16X16) return SET_INTER2;
      return SET_INTER1;
    }
    if (up == TX_32X32) return SET_DCT;
    if (f.reduced_tx_set) return SET_INTRA2;
    if (sq == TX_16X16) return SET_INTRA2;
    return SET_INTRA1;
  }

  int compute_tx_type(int plane, int t, int bx4, int by4) {
    if (lossless || sqr_up(t) > TX_32X32) return DCT_DCT;
    const int set = tx_set(t);
    if (plane == 0) return f.tx_types[size_t(by4) * f.mi_cols + bx4];
    int type;
    if (is_inter) {
      const int x4 = std::max(mi_col, bx4 << f.sub_x), y4 = std::max(mi_row, by4 << f.sub_y);
      type = f.tx_types[size_t(y4) * f.mi_cols + x4];
    } else {
      type = kModeToTxType[uv_mode];
    }
    return tx_in_set(set, type) ? type : DCT_DCT;
  }

  void set_tx_types(int x4, int y4, int t, int type) {
    for (int i = 0; i < kTxH[t] / 4; i++)
      for (int j = 0; j < kTxW[t] / 4; j++)
        if (y4 + i < f.mi_rows && x4 + j < f.mi_cols)
          f.tx_types[size_t(y4 + i) * f.mi_cols + x4 + j] = uint8_t(type);
  }

  void read_tx_type(int x4, int y4, int t) {
    const int set = tx_set(t);
    int type = DCT_DCT;
    if (set > 0 && f.qidx(segment, current_q, true) > 0) {
      const int sq = sqr(t);
      if (is_inter) {
        if (set == SET_INTER1) type = kInterInv1[s.read(c.inter_tx[1][sq], 16)];
        else if (set == SET_INTER2) type = kInterInv2[s.read(c.inter_tx[2][sq], 12)];
        else type = kInterInv3[s.read(c.inter_tx[3][sq], 2)];
      } else {
        const int dir = use_filter_intra ? kFilterIntraDir[filter_intra_mode] : y_mode;
        if (set == SET_INTRA1) type = kIntraInv1[s.read(c.intra_tx[1][sq][dir], 7)];
        else type = kIntraInv2[s.read(c.intra_tx[2][sq][dir], 5)];
      }
    }
    if (type >= IDTX) f.tools |= kToolIdtx1d;
    if ((type >= FLIPADST_DCT && type <= FLIPADST_ADST) || type == V_FLIPADST || type == H_FLIPADST)
      f.tools |= kToolFlipAdst;
    set_tx_types(x4, y4, t, type);
  }

  // The scans, by the specification's rule: 0 default (anti-diagonals,
  // zig-zag on squares), 1 row by row, 2 column by column.
  static const std::vector<uint16_t>& scan(int w, int h, int kind) {
    static std::vector<uint16_t> tables[6][6][3];
    std::vector<uint16_t>& s = tables[log2i(w) - 2][log2i(h) - 2][kind];
    if (s.empty()) {
      if (kind == 1) {
        for (int i = 0; i < w * h; i++) s.push_back(uint16_t(i));
      } else if (kind == 2) {
        for (int cc = 0; cc < w; cc++)
          for (int r = 0; r < h; r++) s.push_back(uint16_t(r * w + cc));
      } else {
        for (int d = 0; d < w + h - 1; d++) {
          std::vector<uint16_t> cells;
          for (int r = 0; r < h; r++)
            if (d - r >= 0 && d - r < w) cells.push_back(uint16_t(r * w + d - r));
          if ((w == h && d % 2 == 0) || w > h) std::reverse(cells.begin(), cells.end());
          s.insert(s.end(), cells.begin(), cells.end());
        }
      }
    }
    return s;
  }

  int coeffs(int plane, int start_x, int start_y, int t, int& type_out) {
    const int x4 = start_x >> 2, y4 = start_y >> 2, w4 = kTxW[t] >> 2, h4 = kTxH[t] >> 2;
    const int sx = plane ? f.sub_x : 0, sy = plane ? f.sub_y : 0;
    const int max_x4 = (f.mi_cols + sx) >> sx, max_y4 = (f.mi_rows + sy) >> sy;
    const int ctx_sz = (sqr(t) + sqr_up(t) + 1) >> 1;
    const int ptype = plane > 0;
    // Adjusted (64 -> 32) size for the coefficient layout.
    const int aw = std::min(32, int(kTxW[t])), ah = std::min(32, int(kTxH[t]));
    const int bwl = log2i(aw);
    const int seg_eob = aw * ah;
    std::fill(quant, quant + seg_eob, 0);
    int eob = 0, cul = 0, dc_cat = 0;
    // all_zero context.
    int ctx;
    if (plane == 0) {
      int top = 0, left = 0;
      for (int k = 0; k < w4; k++)
        if (x4 + k < max_x4) top = std::max(top, int(above_level[plane][x4 + k]));
      for (int k = 0; k < h4; k++)
        if (y4 + k < max_y4) left = std::max(left, int(left_level[plane][y4 - (row_start >> sy) + k]));
      if (kBlockW[mi_size] == kTxW[t] && kBlockH[mi_size] == kTxH[t]) ctx = 0;
      else if (top == 0 && left == 0) ctx = 1;
      else if (top == 0 || left == 0) ctx = 2 + (std::max(top, left) > 3);
      else if (std::max(top, left) <= 3) ctx = 4;
      else if (std::min(top, left) <= 3) ctx = 5;
      else ctx = 6;
    } else {
      int above = 0, left = 0;
      for (int k = 0; k < w4; k++)
        if (x4 + k < max_x4) above |= above_level[plane][x4 + k] | above_dc[plane][x4 + k];
      for (int k = 0; k < h4; k++)
        if (y4 + k < max_y4) {
          const int li = y4 - (row_start >> sy) + k;
          left |= left_level[plane][li] | left_dc[plane][li];
        }
      ctx = (above != 0) + (left != 0) + 7;
      const int ps = plane_size(mi_size, plane);
      if (kBlockW[ps] * kBlockH[ps] > kTxW[t] * kTxH[t]) ctx += 3;
    }
    const int all_zero = s.read(c.txb_skip[ctx_sz][ctx], 2);
    int type = DCT_DCT;
    if (all_zero) {
      if (plane == 0) set_tx_types(x4, y4, t, DCT_DCT);
    } else {
      if (plane == 0) read_tx_type(x4, y4, t);
      type = compute_tx_type(plane, t, x4, y4);
      const int tclass = (type == V_DCT || type == V_ADST || type == V_FLIPADST) ? 2
                         : (type == H_DCT || type == H_ADST || type == H_FLIPADST) ? 1 : 0;
      // Scan: 64-sample sides use the 32 scans; IDTX the default.
      int kind = 0;
      if (sqr_up(t) != TX_64X64 && type != IDTX) kind = tclass == 2 ? 1 : tclass == 1 ? 2 : 0;
      const std::vector<uint16_t>& sc = scan(aw, ah, kind);
      const int multisize = std::min(log2i(kTxW[t]), 5) + std::min(log2i(kTxH[t]), 5) - 4;
      const int ectx = tclass == 0 ? 0 : 1;
      int eob_pt;
      switch (multisize) {
        case 0: eob_pt = s.read(c.eob16[ptype][ectx], 5); break;
        case 1: eob_pt = s.read(c.eob32[ptype][ectx], 6); break;
        case 2: eob_pt = s.read(c.eob64[ptype][ectx], 7); break;
        case 3: eob_pt = s.read(c.eob128[ptype][ectx], 8); break;
        case 4: eob_pt = s.read(c.eob256[ptype][ectx], 9); break;
        case 5: eob_pt = s.read(c.eob512[ptype][0], 10); break;
        default: eob_pt = s.read(c.eob1024[ptype][0], 11); break;
      }
      eob_pt += 1;
      eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
      int shift = eob_pt - 3;
      if (shift >= 0) {
        if (s.read(c.eob_extra[ctx_sz][ptype][eob_pt - 3], 2)) eob += 1 << shift;
        for (int i = 1; i < std::max(0, eob_pt - 2); i++) {
          shift = std::max(0, eob_pt - 2) - 1 - i;
          if (s.literal(1)) eob += 1 << shift;
        }
      }
      // Context offsets.
      static const int8_t kSig2d[5][2] = {{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}};
      static const int8_t kSigVert[5][2] = {{1, 0}, {2, 0}, {3, 0}, {4, 0}, {0, 1}};
      static const int8_t kSigHorz[5][2] = {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}};
      static const int8_t kMag2d[3][2] = {{0, 1}, {1, 0}, {1, 1}};
      static const int8_t kMagVert[3][2] = {{0, 1}, {1, 0}, {2, 0}};
      static const int8_t kMagHorz[3][2] = {{0, 1}, {1, 0}, {0, 2}};
      static const uint8_t kCtxSquare[5][5] = {{0, 1, 6, 6, 21}, {1, 6, 6, 21, 21},
                                               {6, 6, 21, 21, 21}, {6, 21, 21, 21, 21},
                                               {21, 21, 21, 21, 21}};
      static const uint8_t kCtxWide[5][5] = {{0, 16, 6, 6, 21}, {16, 16, 6, 21, 21},
                                             {16, 16, 21, 21, 21}, {16, 16, 21, 21, 21},
                                             {16, 16, 21, 21, 21}};
      static const uint8_t kCtxTall[5][5] = {{0, 11, 11, 11, 11}, {11, 11, 11, 11, 11},
                                             {6, 6, 21, 21, 21}, {6, 21, 21, 21, 21},
                                             {21, 21, 21, 21, 21}};
      const auto& sig = tclass == 0 ? kSig2d : tclass == 2 ? kSigVert : kSigHorz;
      const auto& magref = tclass == 0 ? kMag2d : tclass == 2 ? kMagVert : kMagHorz;
      // By the transform's own shape (32x64 is tall though its coefficients are 32x32).
      const auto& offs = kTxW[t] == kTxH[t] ? kCtxSquare : kTxW[t] > kTxH[t] ? kCtxWide : kCtxTall;
      // 4x4 has its own last column of offsets.
      static const uint8_t kCtx4x4[5][5] = {{0, 1, 6, 6, 0}, {1, 6, 6, 21, 0}, {6, 6, 21, 21, 0},
                                            {6, 21, 21, 21, 0}, {0, 0, 0, 0, 0}};
      const auto& offsets = t == TX_4X4 ? kCtx4x4 : offs;
      for (int ci = eob - 1; ci >= 0; ci--) {
        const int pos = sc[ci], row = pos >> bwl, colp = pos - (row << bwl);
        int level;
        if (ci == eob - 1) {
          const int n = ah << bwl;
          const int bctx = ci == 0 ? 0 : ci <= n / 8 ? 1 : ci <= n / 4 ? 2 : 3;
          level = s.read(c.base_eob[ctx_sz][ptype][bctx], 3) + 1;
        } else {
          int mag = 0;
          for (int k = 0; k < 5; k++) {
            const int rr = row + sig[k][0], cc = colp + sig[k][1];
            if (rr < ah && cc < aw) mag += std::min(std::abs(quant[(rr << bwl) + cc]), 3);
          }
          int bctx = std::min((mag + 1) >> 1, 4);
          if (tclass == 0) {
            bctx = (row == 0 && colp == 0) ? 0 : bctx + offsets[std::min(row, 4)][std::min(colp, 4)];
          } else {
            const int idx = tclass == 2 ? row : colp;
            bctx += 26 + 5 * std::min(idx, 2);
          }
          level = s.read(c.base[ctx_sz][ptype][bctx], 4);
        }
        if (level > 2) {
          int mag = 0;
          for (int k = 0; k < 3; k++) {
            const int rr = row + magref[k][0], cc = colp + magref[k][1];
            if (rr < ah && cc < aw) mag += std::min(quant[(rr << bwl) + cc], 15);
          }
          mag = std::min((mag + 1) >> 1, 6);
          int bctx;
          if (pos == 0) bctx = mag;
          else if (tclass == 0) bctx = (row < 2 && colp < 2) ? mag + 7 : mag + 14;
          else if (tclass == 1) bctx = colp == 0 ? mag + 7 : mag + 14;
          else bctx = row == 0 ? mag + 7 : mag + 14;
          for (int k = 0; k < 4; k++) {
            const int br = s.read(c.br[std::min(ctx_sz, 3)][ptype][bctx], 4);
            level += br;
            if (br < 3) break;
          }
        }
        quant[pos] = level;
      }
      for (int ci = 0; ci < eob; ci++) {
        const int pos = sc[ci];
        int sign = 0;
        if (quant[pos] != 0) {
          if (ci == 0) {
            int dsum = 0;
            for (int k = 0; k < w4; k++)
              if (x4 + k < max_x4) {
                const int v = above_dc[plane][x4 + k];
                dsum += v == 1 ? -1 : v == 2 ? 1 : 0;
              }
            for (int k = 0; k < h4; k++)
              if (y4 + k < max_y4) {
                const int v = left_dc[plane][y4 - (row_start >> sy) + k];
                dsum += v == 1 ? -1 : v == 2 ? 1 : 0;
              }
            const int dctx = dsum < 0 ? 1 : dsum > 0 ? 2 : 0;
            sign = s.read(c.dc_sign[ptype][dctx], 2);
          } else {
            sign = s.literal(1);
          }
        }
        if (quant[pos] > 14) {
          int length = 0, b;
          do {
            length++;
            b = s.literal(1);
            if (length > 32) refuse("AV1 coefficient Golomb code too long");
          } while (!b);
          int x = 1;
          for (int i = length - 2; i >= 0; i--) x = (x << 1) | s.literal(1);
          quant[pos] = x + 14;
        }
        if (pos == 0 && quant[pos] > 0) dc_cat = sign ? 1 : 2;
        quant[pos] &= 0xFFFFF;
        cul += quant[pos];
        if (sign) quant[pos] = -quant[pos];
      }
      cul = std::min(63, cul);
      dequant(plane, t, type, eob, sc);
    }
    for (int k = 0; k < w4; k++)
      above_level[plane][x4 + k] = uint8_t(cul), above_dc[plane][x4 + k] = uint8_t(dc_cat);
    for (int k = 0; k < h4; k++) {
      const int li = y4 - (row_start >> sy) + k;
      left_level[plane][li] = uint8_t(cul), left_dc[plane][li] = uint8_t(dc_cat);
    }
    type_out = type;
    return eob;
  }

  void dequant(int plane, int t, int type, int eob, const std::vector<uint16_t>& sc) {
    const int aw = std::min(32, int(kTxW[t])), ah = std::min(32, int(kTxH[t]));
    const int q = f.qidx(segment, current_q, false);
    const int bdi = (f.bit_depth - 8) >> 1;
    const int dq_dc = plane == 0 ? f.dq_y_dc : plane == 1 ? f.dq_u_dc : f.dq_v_dc;
    const int dq_ac = plane == 0 ? 0 : plane == 1 ? f.dq_u_ac : f.dq_v_ac;
    const int dcq = kDcQLookup[bdi][std::clamp(q + dq_dc, 0, 255)];
    const int acq = kAcQLookup[bdi][std::clamp(q + dq_ac, 0, 255)];
    const int area = kTxW[t] * kTxH[t];
    const int shift = (area > 256) + (area > 1024);
    const int level = f.seg_qm_level[plane][segment];
    const uint8_t* qm = nullptr;
    if (f.using_qm && !lossless && level < 15 && type < IDTX) {
      static const int kQmOffset[19] = {0, 16, 80, 336, 336, 1360, 1392, 1424, 1552, 1680,
                                        2192, 336, 336, 2704, 2768, 2832, 3088, 1680, 2192};
      qm = &kQuantizerMatrix[level][plane > 0][kQmOffset[t]];
    }
    std::fill(coef, coef + aw * ah, 0);
    const int64_t lo = -(int64_t(1) << (7 + f.bit_depth)), hi = (int64_t(1) << (7 + f.bit_depth)) - 1;
    for (int ci = 0; ci < eob; ci++) {
      const int pos = sc[ci];
      const int v = quant[pos];
      if (!v) continue;
      int qv = pos == 0 ? dcq : acq;
      // aom's matrices (av1_tables.h) run down the columns of this
      // coefficient layout: a rectangular transform's weight is transposed.
      if (qm) qv = (qm[(pos % aw) * ah + pos / aw] * qv + 16) >> 5;
      int64_t d = int64_t(std::abs(v)) * qv;
      d &= 0xFFFFFF;
      d >>= shift;
      if (v < 0) d = -d;
      coef[pos] = int32_t(std::clamp(d, lo, hi));
    }
  }
};

void sequence_header(Frame& f, Bits& b) {
  f.profile = int(b.f(3));
  if (f.profile > 2) refuse("AV1 profile " + std::to_string(f.profile) + " not read");
  b.f(1);  // still_picture
  f.reduced = int(b.f(1));
  if (f.reduced) {
    f.op_count = 1;
    f.op_idc.assign(1, 0);
    f.op_decoder_model.assign(1, 0);
    b.f(5);  // seq_level_idx
  } else {
    int delay_len = 0;
    if (b.f(1)) {  // timing_info_present_flag
      b.f(32), b.f(32);
      f.equal_picture_interval = int(b.f(1));
      if (f.equal_picture_interval) b.uvlc();
      f.decoder_model = int(b.f(1));
      if (f.decoder_model) {
        delay_len = int(b.f(5)) + 1;
        b.f(32);
        f.buffer_removal_len = int(b.f(5)) + 1;
        f.frame_presentation_len = int(b.f(5)) + 1;
      }
    }
    const int initial_delay = int(b.f(1));
    f.op_count = int(b.f(5)) + 1;
    f.op_idc.assign(f.op_count, 0);
    f.op_decoder_model.assign(f.op_count, 0);
    for (int i = 0; i < f.op_count; i++) {
      f.op_idc[i] = int(b.f(12));
      const int level = int(b.f(5));
      if (level > 7) b.f(1);
      if (f.decoder_model) {
        f.op_decoder_model[i] = int(b.f(1));
        if (f.op_decoder_model[i]) b.f(delay_len), b.f(delay_len), b.f(1);
      }
      if (initial_delay && b.f(1)) b.f(4);
    }
  }
  f.width_bits = int(b.f(4)) + 1;
  f.height_bits = int(b.f(4)) + 1;
  f.max_w = int(b.f(f.width_bits)) + 1;
  f.max_h = int(b.f(f.height_bits)) + 1;
  if (!f.reduced) {
    f.frame_id_present = int(b.f(1));
    if (f.frame_id_present) {
      const int delta_len = int(b.f(4)) + 2;
      f.id_len = int(b.f(3)) + delta_len + 1;
    }
  }
  f.sb128 = int(b.f(1));
  f.enable_filter_intra = int(b.f(1));
  f.enable_edge_filter = int(b.f(1));
  if (f.reduced) {
    f.force_screen_content = 2;
    f.force_integer_mv_seq = 2;
    f.order_hint_bits = 0;
  } else {
    b.f(4);  // interintra, masked, warped, dual filter
    const int order_hint = int(b.f(1));
    if (order_hint) b.f(2);  // jnt_comp, ref_frame_mvs
    f.force_screen_content = b.f(1) ? 2 : int(b.f(1));
    if (f.force_screen_content > 0) f.force_integer_mv_seq = b.f(1) ? 2 : int(b.f(1));
    else f.force_integer_mv_seq = 2;
    if (order_hint) f.order_hint_bits = int(b.f(3)) + 1;
  }
  f.enable_superres = int(b.f(1));
  f.enable_cdef = int(b.f(1));
  f.enable_restoration = int(b.f(1));
  // color_config
  const int high = int(b.f(1));
  if (f.profile == 2 && high) f.bit_depth = b.f(1) ? 12 : 10;
  else f.bit_depth = high ? 10 : 8;
  f.mono = f.profile == 1 ? 0 : int(b.f(1));
  if (b.f(1)) {
    f.color_primaries = int(b.f(8));
    f.transfer = int(b.f(8));
    f.matrix = int(b.f(8));
  } else {
    f.color_primaries = f.transfer = f.matrix = 2;
  }
  if (f.mono) {
    f.full_range = int(b.f(1));
    f.sub_x = f.sub_y = 1;
    f.separate_uv_delta_q = 0;
    f.planes = 1;
  } else {
    f.planes = 3;
    if (f.color_primaries == 1 && f.transfer == 13 && f.matrix == 0) {
      f.full_range = 1;
      f.sub_x = f.sub_y = 0;
    } else {
      f.full_range = int(b.f(1));
      if (f.profile == 0) f.sub_x = f.sub_y = 1;
      else if (f.profile == 1) f.sub_x = f.sub_y = 0;
      else if (f.bit_depth == 12) {
        f.sub_x = int(b.f(1));
        f.sub_y = f.sub_x ? int(b.f(1)) : 0;
      } else {
        f.sub_x = 1, f.sub_y = 0;
      }
      if (f.sub_x && f.sub_y) b.f(2);  // chroma_sample_position
    }
    f.separate_uv_delta_q = int(b.f(1));
  }
  f.film_grain_present = int(b.f(1));
}

int read_delta_q(Bits& b) { return b.f(1) ? b.su(7) : 0; }

int tile_log2(int blk, int target) {
  int k = 0;
  while ((blk << k) < target) k++;
  return k;
}

// film_grain_params (spec 5.9.30), into f.grain.
void film_grain_params(Frame& f, Bits& b) {
  FilmGrain& g = f.grain;
  g.seed = int(b.f(16));
  if (f.frame_type == 1) refuse("AV1 film grain of inter frames not read");
  g.num_y = int(b.f(4));
  for (int i = 0; i < g.num_y; i++) g.y_value[i] = int(b.f(8)), g.y_scaling[i] = int(b.f(8));
  g.chroma_from_luma = f.mono ? 0 : int(b.f(1));
  g.num_cb = g.num_cr = 0;
  if (!(f.mono || g.chroma_from_luma || (f.sub_x && f.sub_y && g.num_y == 0))) {
    g.num_cb = int(b.f(4));
    for (int i = 0; i < g.num_cb; i++) g.cb_value[i] = int(b.f(8)), g.cb_scaling[i] = int(b.f(8));
    g.num_cr = int(b.f(4));
    for (int i = 0; i < g.num_cr; i++) g.cr_value[i] = int(b.f(8)), g.cr_scaling[i] = int(b.f(8));
  }
  g.scaling_shift = int(b.f(2)) + 8;
  g.ar_lag = int(b.f(2));
  const int pos_luma = 2 * g.ar_lag * (g.ar_lag + 1);
  const int pos_chroma = g.num_y ? pos_luma + 1 : pos_luma;
  if (g.num_y)
    for (int i = 0; i < pos_luma; i++) g.ar_y[i] = int(b.f(8)) - 128;
  if (g.chroma_from_luma || g.num_cb)
    for (int i = 0; i < pos_chroma; i++) g.ar_cb[i] = int(b.f(8)) - 128;
  if (g.chroma_from_luma || g.num_cr)
    for (int i = 0; i < pos_chroma; i++) g.ar_cr[i] = int(b.f(8)) - 128;
  g.ar_shift = int(b.f(2)) + 6;
  g.grain_scale_shift = int(b.f(2));
  if (g.num_cb) g.cb_mult = int(b.f(8)), g.cb_luma_mult = int(b.f(8)), g.cb_offset = int(b.f(9));
  if (g.num_cr) g.cr_mult = int(b.f(8)), g.cr_luma_mult = int(b.f(8)), g.cr_offset = int(b.f(9));
  g.overlap = int(b.f(1));
  g.clip_restricted = int(b.f(1));
}

void frame_header(Frame& f, Bits& b, int temporal_id, int spatial_id) {
  if (f.reduced) {
    f.frame_type = 0;
    f.show_frame = 1;
  } else {
    if (b.f(1)) refuse("AV1 show_existing_frame not read");
    f.frame_type = int(b.f(2));
    f.show_frame = int(b.f(1));
    if (f.show_frame && f.decoder_model && !f.equal_picture_interval)
      b.f(f.frame_presentation_len);
    if (!f.show_frame) b.f(1);  // showable_frame
    if (f.frame_type == 3 || (f.frame_type == 0 && f.show_frame)) f.error_resilient = 1;
    else f.error_resilient = int(b.f(1));
  }
  if (f.frame_type == 1 || f.frame_type == 3)
    refuse("AV1 inter frames not read (the still image's frame must be intra)");
  f.disable_cdf_update = int(b.f(1));
  f.screen_content = f.force_screen_content == 2 ? int(b.f(1)) : f.force_screen_content;
  if (f.screen_content && f.force_integer_mv_seq == 2) b.f(1);  // force_integer_mv
  if (f.frame_id_present) b.f(f.id_len);
  int size_override = 0;
  if (!f.reduced) size_override = int(b.f(1));
  b.f(f.order_hint_bits);
  // primary_ref_frame is none for intra frames.
  if (f.decoder_model) {
    if (b.f(1)) {  // buffer_removal_time_present_flag
      for (int i = 0; i < f.op_count; i++)
        if (f.op_decoder_model[i]) {
          const int idc = f.op_idc[i];
          const int in_t = (idc >> temporal_id) & 1, in_s = (idc >> (spatial_id + 8)) & 1;
          if (idc == 0 || (in_t && in_s)) b.f(f.buffer_removal_len);
        }
    }
  }
  int refresh = 0xff;
  if (!(f.frame_type == 0 && f.show_frame)) refresh = int(b.f(8));
  if (refresh != 0xff && f.error_resilient && f.order_hint_bits)
    for (int i = 0; i < 8; i++) b.f(f.order_hint_bits);
  // frame_size
  if (size_override) {
    f.width = int(b.f(f.width_bits)) + 1;
    f.height = int(b.f(f.height_bits)) + 1;
  } else {
    f.width = f.max_w;
    f.height = f.max_h;
  }
  // No encoder here writes superres: aom answers "superres-mode" with
  // AVIF_RESULT_INVALID_CODEC_SPECIFIC_OPTION, in Pillow's libavif and in
  // OpenCV's alike, so no decode of it could be checked.
  if (f.enable_superres && b.f(1)) refuse("AV1 superres not read");
  if (b.f(1)) b.f(16), b.f(16);  // render size
  f.mi_cols = 2 * ((f.width + 7) >> 3);
  f.mi_rows = 2 * ((f.height + 7) >> 3);
  f.allow_intrabc = f.screen_content ? int(b.f(1)) : 0;
  if (!(f.reduced || f.disable_cdf_update)) b.f(1);  // disable_frame_end_update_cdf
  // tile_info
  const int sb_cols = f.sb128 ? (f.mi_cols + 31) >> 5 : (f.mi_cols + 15) >> 4;
  const int sb_rows = f.sb128 ? (f.mi_rows + 31) >> 5 : (f.mi_rows + 15) >> 4;
  const int sb_shift = f.sb128 ? 5 : 4, sb_size = sb_shift + 2;
  const int max_tile_w_sb = 4096 >> sb_size;
  int max_tile_area_sb = (4096 * 2304) >> (2 * sb_size);
  const int min_log2_cols = tile_log2(max_tile_w_sb, sb_cols);
  const int max_log2_cols = tile_log2(1, std::min(sb_cols, 64));
  const int max_log2_rows = tile_log2(1, std::min(sb_rows, 64));
  const int min_log2_tiles = std::max(min_log2_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols));
  f.col_starts.clear();
  f.row_starts.clear();
  if (b.f(1)) {  // uniform
    f.tile_cols_log2 = min_log2_cols;
    while (f.tile_cols_log2 < max_log2_cols && b.f(1)) f.tile_cols_log2++;
    const int tw = (sb_cols + (1 << f.tile_cols_log2) - 1) >> f.tile_cols_log2;
    for (int sb = 0; sb < sb_cols; sb += tw) f.col_starts.push_back(sb << sb_shift);
    const int min_log2_rows = std::max(min_log2_tiles - f.tile_cols_log2, 0);
    f.tile_rows_log2 = min_log2_rows;
    while (f.tile_rows_log2 < max_log2_rows && b.f(1)) f.tile_rows_log2++;
    const int th = (sb_rows + (1 << f.tile_rows_log2) - 1) >> f.tile_rows_log2;
    for (int sb = 0; sb < sb_rows; sb += th) f.row_starts.push_back(sb << sb_shift);
  } else {
    int widest = 0;
    for (int sb = 0; sb < sb_cols;) {
      f.col_starts.push_back(sb << sb_shift);
      const int size = b.ns(std::min(sb_cols - sb, max_tile_w_sb)) + 1;
      widest = std::max(widest, size);
      sb += size;
    }
    max_tile_area_sb = min_log2_tiles > 0 ? (sb_rows * sb_cols) >> (min_log2_tiles + 1)
                                          : sb_rows * sb_cols;
    const int max_h_sb = std::max(max_tile_area_sb / widest, 1);
    for (int sb = 0; sb < sb_rows;) {
      f.row_starts.push_back(sb << sb_shift);
      sb += b.ns(std::min(sb_rows - sb, max_h_sb)) + 1;
    }
    f.tile_cols_log2 = tile_log2(1, int(f.col_starts.size()));
    f.tile_rows_log2 = tile_log2(1, int(f.row_starts.size()));
  }
  f.tile_cols = int(f.col_starts.size());
  f.tile_rows = int(f.row_starts.size());
  f.col_starts.push_back(f.mi_cols);
  f.row_starts.push_back(f.mi_rows);
  if (f.tile_cols_log2 > 0 || f.tile_rows_log2 > 0) {
    b.f(f.tile_cols_log2 + f.tile_rows_log2);  // context_update_tile_id
    f.tile_size_bytes = int(b.f(2)) + 1;
  }
  // quantization_params
  f.base_q = int(b.f(8));
  f.dq_y_dc = read_delta_q(b);
  if (f.planes > 1) {
    const int diff = f.separate_uv_delta_q ? int(b.f(1)) : 0;
    f.dq_u_dc = read_delta_q(b);
    f.dq_u_ac = read_delta_q(b);
    if (diff) {
      f.dq_v_dc = read_delta_q(b);
      f.dq_v_ac = read_delta_q(b);
    } else {
      f.dq_v_dc = f.dq_u_dc, f.dq_v_ac = f.dq_u_ac;
    }
  }
  f.using_qm = int(b.f(1));
  if (f.using_qm) {
    f.qm_y = int(b.f(4));
    f.qm_u = int(b.f(4));
    f.qm_v = f.separate_uv_delta_q ? int(b.f(4)) : f.qm_u;
  }
  // segmentation_params
  std::memset(f.feature_enabled, 0, sizeof(f.feature_enabled));
  std::memset(f.feature_data, 0, sizeof(f.feature_data));
  f.seg_enabled = int(b.f(1));
  if (f.seg_enabled) {
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++) {
        if (!b.f(1)) continue;
        f.feature_enabled[i][j] = 1;
        if (kSegSigned[j]) f.feature_data[i][j] = std::clamp(b.su(1 + kSegBits[j]), -kSegMax[j], kSegMax[j]);
        else f.feature_data[i][j] = std::clamp(int(b.f(kSegBits[j])), 0, kSegMax[j]);
      }
  }
  f.seg_id_pre_skip = 0;
  f.last_active_seg = 0;
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++)
      if (f.feature_enabled[i][j]) {
        f.last_active_seg = i;
        if (j >= 5) f.seg_id_pre_skip = 1;
      }
  // delta_q_params, delta_lf_params
  f.delta_q_res = f.delta_q_present = f.delta_lf_present = f.delta_lf_res = f.delta_lf_multi = 0;
  if (f.base_q > 0) f.delta_q_present = int(b.f(1));
  if (f.delta_q_present) {
    f.delta_q_res = int(b.f(2));
    if (!f.allow_intrabc) f.delta_lf_present = int(b.f(1));
    if (f.delta_lf_present) {
      f.delta_lf_res = int(b.f(2));
      f.delta_lf_multi = int(b.f(1));
    }
  }
  f.coded_lossless = 1;
  for (int s = 0; s < 8; s++) {
    const int q = f.qidx(s, f.base_q, true);
    f.lossless[s] = q == 0 && !f.dq_y_dc && !f.dq_u_ac && !f.dq_u_dc && !f.dq_v_ac && !f.dq_v_dc;
    if (!f.lossless[s]) f.coded_lossless = 0;
    const int lv[3] = {f.qm_y, f.qm_u, f.qm_v};
    for (int p = 0; p < 3; p++) f.seg_qm_level[p][s] = f.using_qm && !f.lossless[s] ? lv[p] : 15;
  }
  f.all_lossless = f.coded_lossless;
  // loop_filter_params
  if (f.coded_lossless || f.allow_intrabc) {
    f.lf_level[0] = f.lf_level[1] = 0;
  } else {
    f.lf_level[0] = int(b.f(6));
    f.lf_level[1] = int(b.f(6));
    if (f.planes > 1 && (f.lf_level[0] || f.lf_level[1])) {
      f.lf_level[2] = int(b.f(6));
      f.lf_level[3] = int(b.f(6));
    }
    f.lf_sharpness = int(b.f(3));
    f.lf_delta_enabled = int(b.f(1));
    if (f.lf_delta_enabled && b.f(1)) {
      for (int i = 0; i < 8; i++)
        if (b.f(1)) f.lf_ref_delta[i] = b.su(7);
      for (int i = 0; i < 2; i++)
        if (b.f(1)) f.lf_mode_delta[i] = b.su(7);
    }
  }
  // cdef_params
  f.cdef_bits = 0;
  f.cdef_y_pri[0] = f.cdef_y_sec[0] = f.cdef_uv_pri[0] = f.cdef_uv_sec[0] = 0;
  f.cdef_damping = 3;
  if (!(f.coded_lossless || f.allow_intrabc || !f.enable_cdef)) {
    f.cdef_damping = int(b.f(2)) + 3;
    f.cdef_bits = int(b.f(2));
    for (int i = 0; i < (1 << f.cdef_bits); i++) {
      f.cdef_y_pri[i] = int(b.f(4));
      f.cdef_y_sec[i] = int(b.f(2));
      if (f.cdef_y_sec[i] == 3) f.cdef_y_sec[i]++;
      if (f.planes > 1) {
        f.cdef_uv_pri[i] = int(b.f(4));
        f.cdef_uv_sec[i] = int(b.f(2));
        if (f.cdef_uv_sec[i] == 3) f.cdef_uv_sec[i]++;
      }
    }
  } else if (f.enable_cdef) {
    f.enable_cdef = 0;  // coded lossless or intra block copy: no CDEF
  }
  // lr_params
  f.uses_lr = 0;
  for (int& t : f.lr_type) t = RESTORE_NONE;
  if (!(f.all_lossless || f.allow_intrabc || !f.enable_restoration)) {
    static const int kRemap[4] = {RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ};
    int chroma = 0;
    for (int i = 0; i < f.planes; i++) {
      f.lr_type[i] = kRemap[b.f(2)];
      if (f.lr_type[i] != RESTORE_NONE) {
        f.uses_lr = 1;
        if (i > 0) chroma = 1;
      }
    }
    if (f.uses_lr) {
      int shift;
      if (f.sb128) shift = int(b.f(1)) + 1;
      else {
        shift = int(b.f(1));
        if (shift) shift += int(b.f(1));
      }
      f.lr_size[0] = 256 >> (2 - shift);
      const int uv_shift = f.sub_x && f.sub_y && chroma ? int(b.f(1)) : 0;
      f.lr_size[1] = f.lr_size[2] = f.lr_size[0] >> uv_shift;
    }
  }
  // read_tx_mode
  f.tx_mode_select = f.coded_lossless ? 0 : int(b.f(1));
  // frame_reference_mode, skip_mode, warped motion: none for intra frames.
  f.reduced_tx_set = int(b.f(1));
  // film_grain_params
  f.apply_grain = 0;
  if (f.film_grain_present && f.show_frame) {
    f.apply_grain = int(b.f(1));
    if (f.apply_grain) film_grain_params(f, b);
  }
}

void decode_tiles(Frame& f, const uint8_t* p, size_t n, Bits& b) {
  const int num_tiles = f.tile_cols * f.tile_rows;
  int start = 0, end = num_tiles - 1;
  if (num_tiles > 1 && b.f(1)) {
    const int bits = f.tile_cols_log2 + f.tile_rows_log2;
    start = int(b.f(bits));
    end = int(b.f(bits));
  }
  b.byte_align();
  size_t at = b.pos >> 3;
  if (start != 0 || end != num_tiles - 1) refuse("AV1 frames in several tile groups not read");
  for (int t = start; t <= end; t++) {
    size_t size;
    if (t == end) {
      if (at > n) refuse("AV1 tile data is truncated");
      size = n - at;
    } else {
      if (at + f.tile_size_bytes > n) refuse("AV1 tile size is truncated");
      size = 0;
      for (int i = 0; i < f.tile_size_bytes; i++) size |= size_t(p[at + i]) << (8 * i);
      size += 1;
      at += f.tile_size_bytes;
      if (size > n - at) refuse("AV1 tile data is truncated");
    }
    TileDecoder td(f);
    const int tr = t / f.tile_cols, tc = t % f.tile_cols;
    td.row_start = f.row_starts[tr], td.row_end = f.row_starts[tr + 1];
    td.col_start = f.col_starts[tc], td.col_end = f.col_starts[tc + 1];
    td.current_q = f.base_q;
    td.c.init(f.base_q);
    td.s.init(p + at, size, f.disable_cdf_update);
    td.decode_tile();
    at += size;
  }
}

void allocate(Frame& f) {
  const int sb = f.sb128 ? 128 : 64;
  const int w = (f.mi_cols * 4 + sb - 1) / sb * sb + 64, h = (f.mi_rows * 4 + sb - 1) / sb * sb + 64;
  for (int p = 0; p < f.planes; p++) {
    const int sx = p ? f.sub_x : 0, sy = p ? f.sub_y : 0;
    f.stride[p] = (w >> sx) + 16;
    f.cur[p].assign(size_t(f.stride[p]) * ((h >> sy) + 16), 0);
    const int pcols = (f.mi_cols + sx) >> sx, prows = (f.mi_rows + sy) >> sy;
    f.lf_tx[p].assign(size_t(pcols) * prows, 0);
  }
  const size_t mis = size_t(f.mi_cols) * f.mi_rows;
  f.mi_block.assign(mis, -1);
  f.inter_tx.assign(mis, 0);
  f.tx_types.assign(mis, 0);
  f.cdef_idx.assign(size_t((f.mi_cols + 15) >> 4) * ((f.mi_rows + 15) >> 4) + 2, -1);
  f.blocks.clear();
  f.blocks.reserve(mis / 4 + 16);
  for (int p = 0; p < f.planes; p++) {
    if (f.lr_type[p] == RESTORE_NONE) continue;
    const int sx = p ? f.sub_x : 0, sy = p ? f.sub_y : 0;
    const int unit = f.lr_size[p];
    auto units = [&](int size) { return std::max((size + (unit >> 1)) / unit, 1); };
    f.lr_unit_rows[p] = units((f.height + sy) >> sy);
    f.lr_unit_cols[p] = units((f.width + sx) >> sx);
    const size_t nu = size_t(f.lr_unit_rows[p]) * f.lr_unit_cols[p];
    f.lr_unit_type[p].assign(nu, 0);
    f.lr_sgr_set[p].assign(nu, 0);
    f.lr_coef[p].assign(nu * 6, 0);
  }
}

}  // namespace

void decode(const uint8_t* p, size_t n, Picture& out) {
  Frame f;
  bool have_seq = false, have_frame = false;
  size_t at = 0;
  bool header_seen = false;
  while (at < n) {
    const uint8_t h = p[at++];
    if (h & 0x80) refuse("AV1 OBU forbidden bit set");
    const int type = (h >> 3) & 15, ext = (h >> 2) & 1, has_size = (h >> 1) & 1;
    int temporal_id = 0, spatial_id = 0;
    if (ext) {
      if (at >= n) refuse("AV1 OBU header is truncated");
      temporal_id = p[at] >> 5, spatial_id = (p[at] >> 3) & 3;
      at++;
    }
    const uint64_t size = has_size ? leb128(p, n, at) : n - at;
    if (size > n - at) refuse("AV1 OBU is truncated");
    const uint8_t* obu = p + at;
    at += size;
    if (type == 1) {  // sequence header
      Bits b{obu, size_t(size)};
      sequence_header(f, b);
      have_seq = true;
    } else if (type == 3 || type == 6 || type == 4) {
      if (!have_seq) refuse("AV1 frame before its sequence header");
      if (type == 3 || type == 6) {
        if (have_frame) refuse("AV1 streams of more than one frame not read");
        Bits b{obu, size_t(size)};
        frame_header(f, b, temporal_id, spatial_id);
        header_seen = true;
        allocate(f);
        if (type == 6) {
          b.byte_align();
          Bits tb{obu + (b.pos >> 3), size_t(size) - (b.pos >> 3)};
          decode_tiles(f, tb.p, tb.n, tb);
          have_frame = true;
        }
      } else {
        if (!header_seen) refuse("AV1 tile group before its frame header");
        Bits tb{obu, size_t(size)};
        decode_tiles(f, obu, size_t(size), tb);
        have_frame = true;
      }
    } else if (type == 8) {
      refuse("AV1 large scale tile not read");
    }
  }
  if (!have_frame) refuse("AV1 item holds no frame");
  if (f.sb128) f.tools |= kToolSb128;
  if (f.tile_cols * f.tile_rows > 1) f.tools |= kToolTiles;
  if (f.seg_enabled) f.tools |= kToolSegments;
  if (f.using_qm) f.tools |= kToolQm;
  if (f.lf_level[0] || f.lf_level[1]) f.tools |= kToolDeblock;
  if (f.enable_cdef && !f.coded_lossless && !f.allow_intrabc) f.tools |= kToolCdef;
  for (int p2 = 0; p2 < f.planes; p2++)
    for (uint8_t t : f.lr_unit_type[p2])
      f.tools |= t == RESTORE_WIENER    ? uint32_t(kToolWiener)
                 : t == RESTORE_SGRPROJ ? uint32_t(kToolSgrproj)
                                        : 0u;
  // Loop filters in the specification's order.
  if (f.lf_level[0] || f.lf_level[1]) loop_filter(f);
  const bool do_cdef = f.enable_cdef && !f.coded_lossless && !f.allow_intrabc;
  std::vector<uint16_t> deblocked[3];
  if (f.uses_lr && do_cdef)
    for (int p2 = 0; p2 < f.planes; p2++) deblocked[p2] = f.cur[p2];
  if (do_cdef) cdef(f);
  if (f.uses_lr) loop_restoration(f, do_cdef ? deblocked : nullptr);
  if (f.apply_grain) film_grain(f);
  out.width = f.width;
  out.height = f.height;
  out.bit_depth = f.bit_depth;
  out.sub_x = f.sub_x;
  out.sub_y = f.sub_y;
  out.planes = f.planes;
  out.color_primaries = f.color_primaries;
  out.transfer = f.transfer;
  out.matrix = f.matrix;
  out.full_range = f.full_range;
  out.tools = f.tools;
  for (int p2 = 0; p2 < f.planes; p2++) {
    const int sx = p2 ? f.sub_x : 0, sy = p2 ? f.sub_y : 0;
    const int w = (f.width + sx) >> sx, h = (f.height + sy) >> sy;
    out.pw[p2] = w, out.ph[p2] = h;
    out.plane[p2].resize(size_t(w) * h);
    for (int y = 0; y < h; y++)
      std::memcpy(&out.plane[p2][size_t(y) * w], &f.cur[p2][size_t(y) * f.stride[p2]],
                  size_t(w) * 2);
  }
}

}  // namespace av1
