// The AV1 decoder of the port's AVIF reader (image_avif.cpp), split in two
// sources that compile apart: av1_decode.cpp (OBUs, headers, the symbol
// decoder and every syntax element of a key or intra-only frame) and
// av1_recon.cpp (dequantisation, inverse transforms, intra and intra block
// copy prediction, deblocking, CDEF and loop restoration), as the AV1
// Bitstream & Decoding Process Specification defines them. This header is
// what the two share: the frame's headers and state.

#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace av1 {

// A decoded picture: the planes as the frame's bit depth gives them (one
// sample per uint16_t), cropped to the frame size.
struct Picture {
  int width = 0, height = 0, bit_depth = 8;
  int sub_x = 1, sub_y = 1, planes = 3;  // planes: 1 for monochrome
  int color_primaries = 2, transfer = 2, matrix = 2, full_range = 0;
  uint32_t tools = 0;  // the kTool bits of what the frame used
  std::vector<uint16_t> plane[3];
  int pw[3] = {0, 0, 0}, ph[3] = {0, 0, 0};
};

// Decodes the one frame of the OBUs in p[0, n) (an AVIF item: a sequence
// header, then a frame). Throws tracy_image::DecodeError naming what is
// refused.
void decode(const uint8_t* p, size_t n, Picture& out);

enum { BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8, BLOCK_16X16,
       BLOCK_16X32, BLOCK_32X16, BLOCK_32X32, BLOCK_32X64, BLOCK_64X32, BLOCK_64X64,
       BLOCK_64X128, BLOCK_128X64, BLOCK_128X128, BLOCK_4X16, BLOCK_16X4, BLOCK_8X32,
       BLOCK_32X8, BLOCK_16X64, BLOCK_64X16, BLOCK_INVALID };
enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, TX_8X16, TX_16X8,
       TX_16X32, TX_32X16, TX_32X64, TX_64X32, TX_4X16, TX_16X4, TX_8X32, TX_32X8, TX_16X64,
       TX_64X16 };
enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED,
       D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED };
enum { DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST, FLIPADST_FLIPADST,
       ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST,
       H_FLIPADST };
enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };
// Coding tools a decode went through (Picture::tools), for the tests that
// show a corpus covers them.
enum : uint32_t {
  kToolPalette = 1, kToolIntrabc = 2, kToolFilterIntra = 4, kToolCfl = 8, kToolCdef = 16,
  kToolWiener = 32, kToolSgrproj = 64, kToolQm = 128, kToolDeltaQ = 256, kToolDeltaLf = 512,
  kToolLossless = 1024, kToolTx64 = 2048, kToolSb128 = 4096, kToolTiles = 8192,
  kToolSegments = 16384, kToolVarTx = 32768, kToolIdtx1d = 65536, kToolFlipAdst = 131072,
  kToolDeblock = 262144
};

extern const uint8_t kBlockW[22], kBlockH[22];  // in samples
extern const uint8_t kTxW[19], kTxH[19];        // in samples
int block_size(int w, int h);                   // BLOCK_INVALID if none
int tx_size(int w, int h);
inline int log2i(int v) { return v > 0 ? 31 - __builtin_clz(unsigned(v)) : 0; }

// What a decoded block leaves for its neighbours and the loop filters.
struct BlockInfo {
  uint8_t size, y_mode, uv_mode, is_inter, skip, segment, palette[2];
  uint16_t colors[2][8];  // the Y and U palettes
  int16_t mv[2];          // intra block copy's vector (row, col), 1/8 sample
  int8_t delta_lf[4];
};

// Film grain parameters (spec 5.9.30).
struct FilmGrain {
  int seed = 0, num_y = 0, num_cb = 0, num_cr = 0, chroma_from_luma = 0, scaling_shift = 8,
      ar_lag = 0, ar_shift = 6, grain_scale_shift = 0, cb_mult = 0, cb_luma_mult = 0,
      cb_offset = 0, cr_mult = 0, cr_luma_mult = 0, cr_offset = 0, overlap = 0,
      clip_restricted = 0;
  int y_value[16], y_scaling[16], cb_value[16], cb_scaling[16], cr_value[16], cr_scaling[16];
  int ar_y[24], ar_cb[25], ar_cr[25];
};

// The parameters of one frame and its decoding state.
struct Frame {
  // Sequence header.
  int profile = 0, reduced = 0, sb128 = 0, enable_filter_intra = 0,
      enable_edge_filter = 0, enable_superres = 0, enable_cdef = 0, enable_restoration = 0,
      film_grain_present = 0, bit_depth = 8, mono = 0, sub_x = 1, sub_y = 1, full_range = 0,
      color_primaries = 2, transfer = 2, matrix = 2, separate_uv_delta_q = 0,
      force_screen_content = 2, force_integer_mv_seq = 2, order_hint_bits = 0,
      frame_id_present = 0, id_len = 0, width_bits = 0, height_bits = 0, max_w = 0,
      max_h = 0, decoder_model = 0, equal_picture_interval = 0, buffer_removal_len = 0,
      frame_presentation_len = 0, op_count = 0;
  std::vector<int> op_idc, op_decoder_model;
  // Frame header.
  int frame_type = 0, show_frame = 1, error_resilient = 1, disable_cdf_update = 0,
      screen_content = 0, allow_intrabc = 0, width = 0, height = 0, mi_cols = 0, mi_rows = 0,
      base_q = 0, dq_y_dc = 0, dq_u_dc = 0, dq_u_ac = 0, dq_v_dc = 0, dq_v_ac = 0,
      using_qm = 0, qm_y = 15, qm_u = 15, qm_v = 15, seg_enabled = 0, delta_q_present = 0,
      delta_q_res = 0, delta_lf_present = 0, delta_lf_res = 0, delta_lf_multi = 0,
      coded_lossless = 0, all_lossless = 0, lf_level[4] = {0, 0, 0, 0}, lf_sharpness = 0,
      lf_delta_enabled = 0, cdef_damping = 3, cdef_bits = 0, tx_mode_select = 0,
      reduced_tx_set = 0, uses_lr = 0, planes = 3;
  int lf_ref_delta[8] = {1, 0, 0, 0, -1, 0, -1, -1}, lf_mode_delta[2] = {0, 0};
  int cdef_y_pri[8], cdef_y_sec[8], cdef_uv_pri[8], cdef_uv_sec[8];
  int lr_type[3] = {0, 0, 0}, lr_size[3] = {64, 64, 64};
  int feature_enabled[8][8], feature_data[8][8], last_active_seg = 0, seg_id_pre_skip = 0;
  int lossless[8], seg_qm_level[3][8];
  int tile_cols = 1, tile_rows = 1, tile_cols_log2 = 0, tile_rows_log2 = 0,
      tile_size_bytes = 4;
  std::vector<int> col_starts, row_starts;
  // Film grain, where the header asks for it.
  int apply_grain = 0;
  FilmGrain grain;
  uint32_t tools = 0;

  // Planes, allocated past the frame to whole superblocks plus a margin.
  std::vector<uint16_t> cur[3];
  int stride[3] = {0, 0, 0};
  uint16_t& px(int p, int y, int x) { return cur[p][size_t(y) * stride[p] + x]; }

  // Per 4x4 (mi) unit of the frame.
  std::vector<BlockInfo> blocks;
  std::vector<int32_t> mi_block;  // index into blocks, -1 before decoding
  std::vector<uint8_t> inter_tx;  // InterTxSizes
  std::vector<uint8_t> lf_tx[3];  // LoopfilterTxSizes, per plane unit
  std::vector<uint8_t> tx_types;  // TxTypes of luma 4x4 units
  std::vector<int8_t> cdef_idx;   // per 64x64
  // Loop restoration unit parameters.
  int lr_unit_rows[3] = {0, 0, 0}, lr_unit_cols[3] = {0, 0, 0};
  std::vector<uint8_t> lr_unit_type[3], lr_sgr_set[3];
  std::vector<int16_t> lr_coef[3];  // per unit: wiener [2][3] or sgr xqd [2]

  BlockInfo& at(int r, int c) { return blocks[mi_block[size_t(r) * mi_cols + c]]; }
  bool decoded(int r, int c) const { return mi_block[size_t(r) * mi_cols + c] >= 0; }
  int qidx(int segment, int current_q, bool ignore_delta) const;
};

// av1_recon.cpp.
void predict_intra(Frame& f, int plane, int x, int y, bool have_left, bool have_above,
                   bool have_above_rt, bool have_below_lft, int mode, int angle_delta,
                   int filter_mode, int log2w, int log2h, int filter_type);
void predict_cfl(Frame& f, int plane, int x, int y, int tx, int alpha, int max_luma_w,
                 int max_luma_h);
void predict_intrabc(Frame& f, int plane, int x, int y, int w, int h, const int16_t mv[2]);
// Dequantised coefficients coef[h][w] (row-major, up to 32x32 nonzero) of a
// transform block of type `type`, added to the prediction at (x, y).
void reconstruct(Frame& f, int plane, int x, int y, int tx, int type, bool lossless,
                 int32_t* coef);
void loop_filter(Frame& f);
void film_grain(Frame& f);
void cdef(Frame& f);
// `deblocked`: the planes before CDEF (the stripe boundaries' source), or
// null when CDEF is off.
void loop_restoration(Frame& f, const std::vector<uint16_t>* deblocked);

}  // namespace av1
