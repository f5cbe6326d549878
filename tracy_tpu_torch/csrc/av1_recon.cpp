// AV1's reconstruction for the port's AVIF reader: dequantised
// coefficients through the inverse transforms (DCT 4-64, ADST 4-16,
// flipped ADST, identity and the lossless Walsh-Hadamard), intra prediction
// (DC, directional with edge filtering and upsampling, the smooth modes,
// Paeth, recursive filter intra, chroma from luma), intra block copy, and
// the loop filters in the specification's order: deblocking, CDEF and loop
// restoration (Wiener and self-guided, with the stripe boundaries taken
// from the deblocked frame), as the AV1 Bitstream & Decoding Process
// Specification defines them, with libaom's butterfly order.

#include "av1_decode.h"

#include <algorithm>
#include <array>
#include <cstdlib>
#include <cstring>

#include "av1_tables.h"

namespace av1 {
namespace {

inline int32_t btf(int w0, int32_t a, int w1, int32_t b) {
  return int32_t((int64_t(w0) * a + int64_t(w1) * b + 2048) >> 12);
}
inline int cosk(int k) { return k >= 64 ? 0 : kCos128[k]; }
inline int32_t round2(int64_t v, int n) {
  return n ? int32_t((v + (int64_t(1) << (n - 1))) >> n) : int32_t(v);
}

int brev_slow(int n, int x) {
  int r = 0;
  for (int i = 0; i < n; i++) r |= ((x >> i) & 1) << (n - 1 - i);
  return r;
}

// brev(n, x), the n-bit reversal of x, for n = 1..6.
int brev(int n, int x) {
  static const auto table = [] {
    std::array<std::array<uint8_t, 64>, 7> r{};
    for (int k = 1; k <= 6; k++)
      for (int i = 0; i < (1 << k); i++) r[k][i] = uint8_t(brev_slow(k, i));
    return r;
  }();
  return table[n][x];
}

// The odd half t[M, 2M) of an N = 2M point inverse DCT whose input is in
// bit-reversed order (libaom's stages: the first rotations, then per level
// a butterfly stage and rotations, the last by pi / 4).
void idct_odd(int32_t* t, int n) {
  const int N = 1 << n, M = N / 2;
  for (int i = 0; i < M / 2; i++) {
    const int a = M + i, b = N - 1 - i, k = 64 - brev(n, a) * 64 / N;
    const int32_t xa = t[a], xb = t[b];
    t[a] = btf(cosk(k), xa, -cosk(64 - k), xb);
    t[b] = btf(cosk(64 - k), xa, cosk(k), xb);
  }
  const int levels = log2i(M);
  for (int l = 1; l < levels; l++) {
    const int G = 1 << l;
    for (int q = 0; q < M / G; q++) {
      const int start = M + q * G;
      for (int j = 0; j < G / 2; j++) {
        const int lo = start + j, hi = start + G - 1 - j;
        const int32_t x = t[lo], y = t[hi];
        if (!(q & 1)) t[lo] = x + y, t[hi] = x - y;
        else t[lo] = y - x, t[hi] = y + x;
      }
    }
    if (l < levels - 1) {
      const int g = G, np = N >> (l + 1);
      for (int q = 0; q < M / (4 * g); q++) {
        const int start = M + q * 2 * g;
        const int k = 64 - brev(log2i(np), np / 2 + q) * 64 / np;
        const int c = cosk(k), s = cosk(64 - k);
        for (int lo = start + g / 2; lo < start + g; lo++) {
          const int hi = 3 * M - 1 - lo;
          const int32_t x = t[lo], y = t[hi];
          t[lo] = btf(-s, x, c, y);
          t[hi] = btf(c, x, s, y);
        }
        for (int lo = start + g; lo < start + g + g / 2; lo++) {
          const int hi = 3 * M - 1 - lo;
          const int32_t x = t[lo], y = t[hi];
          t[lo] = btf(-c, x, -s, y);
          t[hi] = btf(-s, x, c, y);
        }
      }
    } else {
      const int c32 = cosk(32);
      for (int lo = M + M / 4; lo < M + M / 2; lo++) {
        const int hi = 3 * M - 1 - lo;
        const int32_t x = t[lo], y = t[hi];
        t[lo] = btf(-c32, x, c32, y);
        t[hi] = btf(c32, x, c32, y);
      }
    }
  }
}

void idct_rev(int32_t* t, int n) {
  const int N = 1 << n;
  if (n == 2) {
    const int32_t a = t[0], b = t[1];
    t[0] = btf(cosk(32), a, cosk(32), b);
    t[1] = btf(cosk(32), a, -cosk(32), b);
  } else {
    idct_rev(t, n - 1);
  }
  idct_odd(t, n);
  for (int i = 0; i < N / 2; i++) {
    const int32_t e = t[i], o = t[N - 1 - i];
    t[i] = e + o;
    t[N - 1 - i] = e - o;
  }
}

void idct(int32_t* x, int n) {
  int32_t t[64];
  const int N = 1 << n;
  for (int i = 0; i < N; i++) t[i] = x[brev(n, i)];
  idct_rev(t, n);
  std::memcpy(x, t, N * sizeof(int32_t));
}

void iadst4(int32_t* x) {
  const int64_t s1 = kSinPi[1], s2 = kSinPi[2], s3 = kSinPi[3], s4 = kSinPi[4];
  const int64_t x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
  if (!(x0 | x1 | x2 | x3)) return;
  int64_t a0 = s1 * x0, a1 = s2 * x0, a2 = s3 * x1, a3 = s4 * x2, a4 = s1 * x2, a5 = s2 * x3,
          a6 = s4 * x3;
  const int64_t a7 = int32_t(x0 - x2 + x3);
  a0 = a0 + a3;
  a1 = a1 - a4;
  a3 = a2;
  a2 = s3 * a7;
  a0 = a0 + a5;
  a1 = a1 - a6;
  const int64_t o0 = a0 + a3, o1 = a1 + a3, o2 = a2, o3 = a0 + a1 - a3;
  x[0] = round2(o0, 12), x[1] = round2(o1, 12), x[2] = round2(o2, 12), x[3] = round2(o3, 12);
}

void iadst8(int32_t* x) {
  int32_t b[8] = {x[7], x[0], x[5], x[2], x[3], x[4], x[1], x[6]}, t[8];
  for (int i = 0; i < 4; i++) {
    const int k = 4 + 16 * i;
    t[2 * i] = btf(cosk(k), b[2 * i], cosk(64 - k), b[2 * i + 1]);
    t[2 * i + 1] = btf(cosk(64 - k), b[2 * i], -cosk(k), b[2 * i + 1]);
  }
  for (int i = 0; i < 4; i++) b[i] = t[i] + t[i + 4], b[i + 4] = t[i] - t[i + 4];
  t[0] = b[0], t[1] = b[1], t[2] = b[2], t[3] = b[3];
  t[4] = btf(cosk(16), b[4], cosk(48), b[5]);
  t[5] = btf(cosk(48), b[4], -cosk(16), b[5]);
  t[6] = btf(-cosk(48), b[6], cosk(16), b[7]);
  t[7] = btf(cosk(16), b[6], cosk(48), b[7]);
  b[0] = t[0] + t[2], b[1] = t[1] + t[3], b[2] = t[0] - t[2], b[3] = t[1] - t[3];
  b[4] = t[4] + t[6], b[5] = t[5] + t[7], b[6] = t[4] - t[6], b[7] = t[5] - t[7];
  const int c = cosk(32);
  t[0] = b[0], t[1] = b[1], t[4] = b[4], t[5] = b[5];
  t[2] = btf(c, b[2], c, b[3]);
  t[3] = btf(c, b[2], -c, b[3]);
  t[6] = btf(c, b[6], c, b[7]);
  t[7] = btf(c, b[6], -c, b[7]);
  x[0] = t[0], x[1] = -t[4], x[2] = t[6], x[3] = -t[2];
  x[4] = t[3], x[5] = -t[7], x[6] = t[5], x[7] = -t[1];
}

void iadst16(int32_t* x) {
  int32_t b[16] = {x[15], x[0], x[13], x[2], x[11], x[4], x[9], x[6],
                   x[7],  x[8], x[5],  x[10], x[3], x[12], x[1], x[14]};
  int32_t t[16];
  for (int i = 0; i < 8; i++) {
    const int k = 2 + 8 * i;
    t[2 * i] = btf(cosk(k), b[2 * i], cosk(64 - k), b[2 * i + 1]);
    t[2 * i + 1] = btf(cosk(64 - k), b[2 * i], -cosk(k), b[2 * i + 1]);
  }
  for (int i = 0; i < 8; i++) b[i] = t[i] + t[i + 8], b[i + 8] = t[i] - t[i + 8];
  for (int i = 0; i < 8; i++) t[i] = b[i];
  t[8] = btf(cosk(8), b[8], cosk(56), b[9]);
  t[9] = btf(cosk(56), b[8], -cosk(8), b[9]);
  t[10] = btf(cosk(40), b[10], cosk(24), b[11]);
  t[11] = btf(cosk(24), b[10], -cosk(40), b[11]);
  t[12] = btf(-cosk(56), b[12], cosk(8), b[13]);
  t[13] = btf(cosk(8), b[12], cosk(56), b[13]);
  t[14] = btf(-cosk(24), b[14], cosk(40), b[15]);
  t[15] = btf(cosk(40), b[14], cosk(24), b[15]);
  for (int base : {0, 8})
    for (int i = base; i < base + 4; i++) b[i] = t[i] + t[i + 4], b[i + 4] = t[i] - t[i + 4];
  for (int base : {0, 8}) {
    t[base] = b[base], t[base + 1] = b[base + 1], t[base + 2] = b[base + 2], t[base + 3] = b[base + 3];
    t[base + 4] = btf(cosk(16), b[base + 4], cosk(48), b[base + 5]);
    t[base + 5] = btf(cosk(48), b[base + 4], -cosk(16), b[base + 5]);
    t[base + 6] = btf(-cosk(48), b[base + 6], cosk(16), b[base + 7]);
    t[base + 7] = btf(cosk(16), b[base + 6], cosk(48), b[base + 7]);
  }
  for (int base : {0, 4, 8, 12})
    b[base] = t[base] + t[base + 2], b[base + 1] = t[base + 1] + t[base + 3],
    b[base + 2] = t[base] - t[base + 2], b[base + 3] = t[base + 1] - t[base + 3];
  const int c = cosk(32);
  for (int base : {0, 4, 8, 12}) {
    t[base] = b[base], t[base + 1] = b[base + 1];
    t[base + 2] = btf(c, b[base + 2], c, b[base + 3]);
    t[base + 3] = btf(c, b[base + 2], -c, b[base + 3]);
  }
  static const int kOut[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1};
  for (int i = 0; i < 16; i++) x[i] = (i & 1) ? -t[kOut[i]] : t[kOut[i]];
}

enum { T_DCT, T_ADST, T_FLIPADST, T_IDTX };
void tx_kinds(int type, int& vt, int& ht) {
  static const int8_t kV[16] = {T_DCT, T_ADST, T_DCT, T_ADST, T_FLIPADST, T_DCT, T_FLIPADST,
                                T_ADST, T_FLIPADST, T_IDTX, T_DCT, T_IDTX, T_ADST, T_IDTX,
                                T_FLIPADST, T_IDTX};
  static const int8_t kH[16] = {T_DCT, T_DCT, T_ADST, T_ADST, T_DCT, T_FLIPADST, T_FLIPADST,
                                T_FLIPADST, T_ADST, T_IDTX, T_IDTX, T_DCT, T_IDTX, T_ADST,
                                T_IDTX, T_FLIPADST};
  vt = kV[type], ht = kH[type];
}

void tx1d(int32_t* x, int n, int kind) {
  const int N = 1 << n;
  if (kind == T_DCT) {
    idct(x, n);
  } else if (kind == T_IDTX) {
    for (int i = 0; i < N; i++) {
      if (N == 4) x[i] = round2(int64_t(x[i]) * 5793, 12);
      else if (N == 8) x[i] = x[i] * 2;
      else if (N == 16) x[i] = round2(int64_t(x[i]) * 11586, 12);
      else x[i] = x[i] * 4;
    }
  } else if (N == 4) {
    iadst4(x);
  } else if (N == 8) {
    iadst8(x);
  } else {
    iadst16(x);
  }
}

constexpr int kRowShift[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2};

void wht(int32_t* t, int shift) {
  int32_t a = t[0] >> shift, c = t[1] >> shift, d = t[2] >> shift, b = t[3] >> shift;
  a += c;
  d -= b;
  const int32_t e = (a - d) >> 1;
  b = e - b;
  c = e - c;
  a -= b;
  d += c;
  t[0] = a, t[1] = b, t[2] = c, t[3] = d;
}

}  // namespace

void reconstruct(Frame& f, int plane, int x, int y, int t, int type, bool lossless, int32_t* coef) {
  const int w = kTxW[t], h = kTxH[t], lw = log2i(w), lh = log2i(h);
  const int aw = std::min(32, w), ah = std::min(32, h);
  const int bd = f.bit_depth, maxv = (1 << bd) - 1;
  static thread_local int32_t res[64 * 64];
  int32_t tmp[64];
  int vt = T_DCT, ht = T_DCT;
  if (lossless) {
    for (int i = 0; i < 4; i++) {
      for (int j = 0; j < 4; j++) tmp[j] = coef[i * 4 + j];
      wht(tmp, 2);
      for (int j = 0; j < 4; j++) res[i * 4 + j] = tmp[j];
    }
    for (int j = 0; j < 4; j++) {
      for (int i = 0; i < 4; i++) tmp[i] = res[i * 4 + j];
      wht(tmp, 0);
      for (int i = 0; i < 4; i++) res[i * 4 + j] = tmp[i];
    }
  } else {
    tx_kinds(type, vt, ht);
    const bool rect = std::abs(lw - lh) == 1;
    const int rlo = -(1 << (bd + 7)), rhi = (1 << (bd + 7)) - 1;
    const int cr = std::max(bd + 6, 16);
    const int clo = -(1 << (cr - 1)), chi = (1 << (cr - 1)) - 1;
    for (int i = 0; i < h; i++) {
      // A row of zeros stays zero through every 1-D transform.
      if (i >= ah || std::all_of(coef + i * aw, coef + i * aw + aw, [](int32_t v) { return !v; })) {
        std::fill(res + i * w, res + i * w + w, 0);
        continue;
      }
      for (int j = 0; j < w; j++) {
        int32_t v = j < aw ? coef[i * aw + j] : 0;
        if (rect) v = round2(int64_t(v) * 2896, 12);
        tmp[j] = std::clamp(v, rlo, rhi);
      }
      tx1d(tmp, lw, ht);
      for (int j = 0; j < w; j++) res[i * w + j] = std::clamp(round2(tmp[j], kRowShift[t]), clo, chi);
    }
    for (int j = 0; j < w; j++) {
      for (int i = 0; i < h; i++) tmp[i] = res[i * w + j];
      tx1d(tmp, lh, vt);
      for (int i = 0; i < h; i++) res[i * w + j] = round2(tmp[i], 4);
    }
  }
  const bool flip_ud = vt == T_FLIPADST, flip_lr = ht == T_FLIPADST;
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++) {
      const int yy = flip_ud ? h - 1 - i : i, xx = flip_lr ? w - 1 - j : j;
      uint16_t& p = f.px(plane, y + yy, x + xx);
      p = uint16_t(std::clamp(int(p) + res[i * w + j], 0, maxv));
    }
}

// Intra prediction (spec 7.11.2).
void predict_intra(Frame& f, int plane, int x, int y, bool have_left, bool have_above,
                   bool have_above_rt, bool have_below_lft, int mode, int angle_delta,
                   int filter_mode, int log2w, int log2h, int filter_type) {
  const int w = 1 << log2w, h = 1 << log2h, bd = f.bit_depth, maxv = (1 << bd) - 1;
  const int sx = plane ? f.sub_x : 0, sy = plane ? f.sub_y : 0;
  const int max_x = ((f.mi_cols * 4) >> sx) - 1, max_y = ((f.mi_rows * 4) >> sy) - 1;
  int above_buf[2 * 128 + 32], left_buf[2 * 128 + 32];
  int* above = above_buf + 16;
  int* left = left_buf + 16;
  const int n = w + h;
  if (!have_above && have_left) {
    for (int i = -1; i < n; i++) above[i] = f.px(plane, y, x - 1);
  } else if (!have_above && !have_left) {
    for (int i = -1; i < n; i++) above[i] = (1 << (bd - 1)) - 1;
  } else {
    const int limit = std::min(max_x, x + (have_above_rt ? 2 * w : w) - 1);
    for (int i = 0; i < n; i++) above[i] = f.px(plane, y - 1, std::min(limit, x + i));
  }
  if (!have_left && have_above) {
    for (int i = -1; i < n; i++) left[i] = f.px(plane, y - 1, x);
  } else if (!have_left && !have_above) {
    for (int i = -1; i < n; i++) left[i] = (1 << (bd - 1)) + 1;
  } else {
    const int limit = std::min(max_y, y + (have_below_lft ? 2 * h : h) - 1);
    for (int i = 0; i < n; i++) left[i] = f.px(plane, std::min(limit, y + i), x - 1);
  }
  int corner;
  if (have_above && have_left) corner = f.px(plane, y - 1, x - 1);
  else if (have_above) corner = f.px(plane, y - 1, x);
  else if (have_left) corner = f.px(plane, y, x - 1);
  else corner = 1 << (bd - 1);
  above[-1] = left[-1] = corner;

  auto put = [&](int i, int j, int v) { f.px(plane, y + i, x + j) = uint16_t(v); };
  if (filter_mode >= 0) {  // recursive filter intra (7.11.2.3)
    static thread_local int pred[64][64];
    for (int i2 = 0; i2 < h / 2; i2++)
      for (int j4 = 0; j4 < w / 4; j4++) {
        int p[7];
        for (int i = 0; i < 7; i++) {
          if (i < 5) {
            if (i2 == 0) p[i] = above[(j4 << 2) + i - 1];
            else if (j4 == 0 && i == 0) p[i] = left[(i2 << 1) - 1];
            else p[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
          } else {
            if (j4 == 0) p[i] = left[(i2 << 1) + i - 5];
            else p[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
          }
        }
        for (int i = 0; i < 8; i++) {
          int pr = 0;
          for (int j = 0; j < 7; j++) pr += kFilterIntraTaps[filter_mode][i][j] * p[j];
          const int v = pr >= 0 ? (pr + 8) >> 4 : -((-pr + 8) >> 4);
          pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] = std::clamp(v, 0, maxv);
        }
      }
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) put(i, j, pred[i][j]);
    return;
  }
  if (mode >= V_PRED && mode <= D67_PRED) {
    static const int kAngle[9] = {0, 90, 180, 45, 135, 113, 157, 203, 67};
    const int angle = kAngle[mode] + angle_delta * 3;
    int up_above = 0, up_left = 0;
    if (f.enable_edge_filter) {
      if (angle != 90 && angle != 180) {
        if (angle > 90 && angle < 180 && w + h >= 24) {
          const int s = left[0] * 5 + above[-1] * 6 + above[0] * 5;
          above[-1] = left[-1] = (s + 8) >> 4;
        }
        auto strength = [&](int delta) {
          const int d = std::abs(delta), wh = w + h;
          int st = 0;
          if (filter_type == 0) {
            if (wh <= 8) { if (d >= 56) st = 1; }
            else if (wh <= 12) { if (d >= 40) st = 1; }
            else if (wh <= 16) { if (d >= 40) st = 1; }
            else if (wh <= 24) { if (d >= 8) st = 1; if (d >= 16) st = 2; if (d >= 32) st = 3; }
            else if (wh <= 32) { if (d >= 1) st = 1; if (d >= 4) st = 2; if (d >= 32) st = 3; }
            else { if (d >= 1) st = 3; }
          } else {
            if (wh <= 8) { if (d >= 40) st = 1; if (d >= 64) st = 2; }
            else if (wh <= 16) { if (d >= 20) st = 1; if (d >= 48) st = 2; }
            else if (wh <= 24) { if (d >= 4) st = 3; }
            else { if (d >= 1) st = 3; }
          }
          return st;
        };
        auto edge_filter = [&](int* buf, int sz, int st) {
          if (!st) return;
          static const int kKernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};
          int edge[2 * 128 + 32];
          for (int i = 0; i < sz; i++) edge[i] = buf[i - 1];
          for (int i = 1; i < sz; i++) {
            int s = 0;
            for (int j = 0; j < 5; j++) s += kKernel[st - 1][j] * edge[std::clamp(i - 2 + j, 0, sz - 1)];
            buf[i - 1] = (s + 8) >> 4;
          }
        };
        if (have_above) {
          const int npx = std::min(w, max_x - x + 1) + (angle < 90 ? h : 0) + 1;
          edge_filter(above, npx, strength(angle - 90));
        }
        if (have_left) {
          const int npx = std::min(h, max_y - y + 1) + (angle > 180 ? w : 0) + 1;
          edge_filter(left, npx, strength(angle - 180));
        }
      }
      auto use_up = [&](int delta) {
        const int d = std::abs(delta), wh = w + h;
        if (d <= 0 || d >= 40) return 0;
        return filter_type == 0 ? int(wh <= 16) : int(wh <= 8);
      };
      auto upsample = [&](int* buf, int npx) {
        int dup[2 * 128 + 32];
        dup[0] = buf[-1];
        for (int i = -1; i < npx; i++) dup[i + 2] = buf[i];
        dup[npx + 2] = buf[npx - 1];
        buf[-2] = dup[0];
        for (int i = 0; i < npx; i++) {
          int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
          s = std::clamp((s + 8) >> 4, 0, maxv);
          buf[2 * i - 1] = s;
          buf[2 * i] = dup[i + 2];
        }
      };
      up_above = use_up(angle - 90);
      if (up_above && angle < 180) upsample(above, w + (angle < 90 ? h : 0));
      up_left = use_up(angle - 180);
      if (up_left && angle > 90) upsample(left, h + (angle > 180 ? w : 0));
    }
    int dx = 0, dy = 0;
    if (angle < 90) dx = kDrIntraDerivative[angle];
    else if (angle > 90 && angle < 180) dx = kDrIntraDerivative[180 - angle];
    if (angle > 90 && angle < 180) dy = kDrIntraDerivative[angle - 90];
    else if (angle > 180) dy = kDrIntraDerivative[270 - angle];
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int v;
        if (angle < 90) {
          const int idx = (i + 1) * dx;
          const int base = (idx >> (6 - up_above)) + (j << up_above);
          const int shift = ((idx << up_above) >> 1) & 0x1f;
          const int max_base = (w + h - 1) << up_above;
          v = base < max_base ? round2(above[base] * (32 - shift) + above[base + 1] * shift, 5)
                              : above[max_base];
        } else if (angle > 90 && angle < 180) {
          const int idx = (j << 6) - (i + 1) * dx;
          const int base = idx >> (6 - up_above);
          if (base >= -(1 << up_above)) {
            const int shift = ((idx * (1 << up_above)) >> 1) & 0x1f;
            v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
          } else {
            const int idy = (i << 6) - (j + 1) * dy;
            const int b2 = idy >> (6 - up_left);
            const int shift = ((idy * (1 << up_left)) >> 1) & 0x1f;
            v = round2(left[b2] * (32 - shift) + left[b2 + 1] * shift, 5);
          }
        } else if (angle > 180) {
          const int idx = (j + 1) * dy;
          const int base = (idx >> (6 - up_left)) + (i << up_left);
          const int shift = ((idx << up_left) >> 1) & 0x1f;
          const int max_base = (w + h - 1) << up_left;
          v = base < max_base ? round2(left[base] * (32 - shift) + left[base + 1] * shift, 5)
                              : left[max_base];
        } else if (angle == 90) {
          v = above[j];
        } else {
          v = left[i];
        }
        put(i, j, v);
      }
    return;
  }
  if (mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED) {
    static const int kOff[7] = {0, 0, 0, 4, 12, 28, 60};  // by log2 size
    const uint8_t* wx = kSmWeights + kOff[log2w];
    const uint8_t* wy = kSmWeights + kOff[log2h];
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int v;
        if (mode == SMOOTH_PRED)
          v = round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1] + wx[j] * left[i] +
                         (256 - wx[j]) * above[w - 1], 9);
        else if (mode == SMOOTH_V_PRED)
          v = round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1], 8);
        else
          v = round2(wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 8);
        put(i, j, v);
      }
    return;
  }
  if (mode == DC_PRED) {
    int avg;
    if (have_left && have_above) {
      int sum = 0;
      for (int k = 0; k < w; k++) sum += above[k];
      for (int k = 0; k < h; k++) sum += left[k];
      avg = (sum + ((w + h) >> 1)) / (w + h);
    } else if (have_left) {
      int sum = 0;
      for (int k = 0; k < h; k++) sum += left[k];
      avg = (sum + (h >> 1)) >> log2h;
    } else if (have_above) {
      int sum = 0;
      for (int k = 0; k < w; k++) sum += above[k];
      avg = (sum + (w >> 1)) >> log2w;
    } else {
      avg = 1 << (bd - 1);
    }
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) put(i, j, avg);
    return;
  }
  // Paeth.
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++) {
      const int base = above[j] + left[i] - above[-1];
      const int pl = std::abs(base - left[i]), pt = std::abs(base - above[j]),
                ptl = std::abs(base - above[-1]);
      put(i, j, pl <= pt && pl <= ptl ? left[i] : pt <= ptl ? above[j] : above[-1]);
    }
}

void predict_cfl(Frame& f, int plane, int x, int y, int t, int alpha, int max_luma_w,
                 int max_luma_h) {
  const int w = kTxW[t], h = kTxH[t], sx = f.sub_x, sy = f.sub_y, maxv = (1 << f.bit_depth) - 1;
  static thread_local int L[32][32];
  int64_t avg = 0;
  for (int i = 0; i < h; i++) {
    const int ly = std::min(i, ((max_luma_h - (y << sy)) >> sy) - 1);
    for (int j = 0; j < w; j++) {
      const int lx = std::min(j, ((max_luma_w - (x << sx)) >> sx) - 1);
      int tsum = 0;
      for (int dy = 0; dy <= sy; dy++)
        for (int dx = 0; dx <= sx; dx++)
          tsum += f.px(0, (y << sy) + (ly << sy) + dy, (x << sx) + (lx << sx) + dx);
      L[i][j] = tsum << (3 - sx - sy);
      avg += L[i][j];
    }
  }
  const int a = round2(avg, log2i(w) + log2i(h));
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++) {
      const int d = alpha * (L[i][j] - a);
      const int sc = d >= 0 ? (d + 32) >> 6 : -((-d + 32) >> 6);
      uint16_t& p = f.px(plane, y + i, x + j);
      p = uint16_t(std::clamp(int(p) + sc, 0, maxv));
    }
}

// Intra block copy: the bilinear block inter prediction of spec 7.11.3 from
// the frame being decoded (its filters are off).
void predict_intrabc(Frame& f, int plane, int x, int y, int w, int h, const int16_t mv[2]) {
  const int sx = plane ? f.sub_x : 0, sy = plane ? f.sub_y : 0;
  const int bd = f.bit_depth, maxv = (1 << bd) - 1;
  const int r0 = bd == 12 ? 5 : 3, r1 = bd == 12 ? 9 : 11;
  const int start_x = ((x << 4) + ((2 * mv[1]) >> sx)) * 64 + 32;
  const int start_y = ((y << 4) + ((2 * mv[0]) >> sy)) * 64 + 32;
  const int last_x = ((f.width + sx) >> sx) - 1, last_y = ((f.height + sy) >> sy) - 1;
  const int ih = (((h - 1) * 1024 + 1023) >> 10) + 8;
  std::vector<int32_t> inter(size_t(ih) * w);
  std::vector<uint16_t> out(size_t(h) * w);
  for (int r = 0; r < ih; r++)
    for (int c = 0; c < w; c++) {
      const int p = start_x + 1024 * c, pos = (p & 1023) >> 6;
      const int ry = std::clamp((start_y >> 10) + r - 3, 0, last_y);
      const int s = (128 - 8 * pos) * f.px(plane, ry, std::clamp((p >> 10), 0, last_x)) +
                    8 * pos * f.px(plane, ry, std::clamp((p >> 10) + 1, 0, last_x));
      inter[size_t(r) * w + c] = round2(s, r0);
    }
  for (int r = 0; r < h; r++)
    for (int c = 0; c < w; c++) {
      const int p = (start_y & 1023) + 1024 * r, pos = (p & 1023) >> 6;
      const int base = (p >> 10) + 3;
      const int s = (128 - 8 * pos) * inter[size_t(base) * w + c] + 8 * pos * inter[size_t(base + 1) * w + c];
      out[size_t(r) * w + c] = uint16_t(std::clamp(round2(s, r1), 0, maxv));
    }
  for (int r = 0; r < h; r++)
    for (int c = 0; c < w; c++) f.px(plane, y + r, x + c) = out[size_t(r) * w + c];
}

// Deblocking (spec 7.14), with libaom's 4-, 6-, 8- and 14-tap filters.
namespace {

int plane_block(const Frame& f, int b, int plane) {
  if (!plane) return b;
  return block_size(std::max(4, kBlockW[b] >> f.sub_x), std::max(4, kBlockH[b] >> f.sub_y));
}

int filter_level(Frame& f, const BlockInfo& b, int plane, int pass) {
  const int i = plane == 0 ? pass : plane + 1;
  const int dlf = f.delta_lf_multi ? b.delta_lf[i] : b.delta_lf[0];
  int lvl = std::clamp(dlf + f.lf_level[i], 0, 63);
  if (f.seg_enabled && f.feature_enabled[b.segment][1 + i])
    lvl = std::clamp(lvl + f.feature_data[b.segment][1 + i], 0, 63);
  if (f.lf_delta_enabled) {
    const int shift = lvl >> 5;
    lvl = std::clamp(lvl + (f.lf_ref_delta[0] * (1 << shift)), 0, 63);
  }
  return lvl;
}

void filter_edge(uint16_t* p, int step, int size, int plane, int lvl, int sharp, int bd) {
  const int shift = sharp > 4 ? 2 : sharp > 0 ? 1 : 0;
  int limit = sharp > 0 ? std::clamp(lvl >> shift, 1, 9 - sharp) : std::max(1, lvl >> shift);
  int blimit = 2 * (lvl + 2) + limit;
  int thresh = lvl >> 4;
  const int s8 = bd - 8;
  limit <<= s8, blimit <<= s8, thresh <<= s8;
  const int flat_t = 1 << s8;
  auto P = [&](int k) -> int { return p[-(k + 1) * step]; };
  auto Q = [&](int k) -> int { return p[k * step]; };
  auto set = [&](int k, int v) { p[k * step] = uint16_t(v); };  // k < 0: p side
  const int p0 = P(0), p1 = P(1), q0 = Q(0), q1 = Q(1);
  const bool hev = std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
  auto filter4 = [&]() {
    const int off = 0x80 << s8, lo = -(128 << s8), hi = (128 << s8) - 1;
    auto c = [&](int v) { return std::clamp(v, lo, hi); };
    const int ps1 = p1 - off, ps0 = p0 - off, qs0 = q0 - off, qs1 = q1 - off;
    int filt = hev ? c(ps1 - qs1) : 0;
    filt = c(filt + 3 * (qs0 - ps0));
    const int f1 = c(filt + 4) >> 3, f2 = c(filt + 3) >> 3;
    set(0, c(qs0 - f1) + off);
    set(-1, c(ps0 + f2) + off);
    const int fo = hev ? 0 : (f1 + 1) >> 1;
    set(1, c(qs1 - fo) + off);
    set(-2, c(ps1 + fo) + off);
  };
  const int edge_ok_base = std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 <= blimit &&
                           std::abs(p1 - p0) <= limit && std::abs(q1 - q0) <= limit;
  if (size == 4) {
    if (edge_ok_base) filter4();
    return;
  }
  if (plane > 0) {  // 6-tap chroma
    const int p2 = P(2), q2 = Q(2);
    if (!(edge_ok_base && std::abs(p2 - p1) <= limit && std::abs(q2 - q1) <= limit)) return;
    const bool flat = std::abs(p1 - p0) <= flat_t && std::abs(q1 - q0) <= flat_t &&
                      std::abs(p2 - p0) <= flat_t && std::abs(q2 - q0) <= flat_t;
    if (flat) {
      set(-2, round2(p2 * 3 + p1 * 2 + p0 * 2 + q0, 3));
      set(-1, round2(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1, 3));
      set(0, round2(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2, 3));
      set(1, round2(p0 + q0 * 2 + q1 * 2 + q2 * 3, 3));
    } else {
      filter4();
    }
    return;
  }
  const int p2 = P(2), q2 = Q(2), p3 = P(3), q3 = Q(3);
  if (!(edge_ok_base && std::abs(p3 - p2) <= limit && std::abs(p2 - p1) <= limit &&
        std::abs(q2 - q1) <= limit && std::abs(q3 - q2) <= limit))
    return;
  const bool flat = std::abs(p1 - p0) <= flat_t && std::abs(q1 - q0) <= flat_t &&
                    std::abs(p2 - p0) <= flat_t && std::abs(q2 - q0) <= flat_t &&
                    std::abs(p3 - p0) <= flat_t && std::abs(q3 - q0) <= flat_t;
  if (size == 16 && flat) {
    const int p4 = P(4), p5 = P(5), p6 = P(6), q4 = Q(4), q5 = Q(5), q6 = Q(6);
    const bool flat2 = std::abs(p4 - p0) <= flat_t && std::abs(q4 - q0) <= flat_t &&
                       std::abs(p5 - p0) <= flat_t && std::abs(q5 - q0) <= flat_t &&
                       std::abs(p6 - p0) <= flat_t && std::abs(q6 - q0) <= flat_t;
    if (flat2) {
      set(-6, round2(p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0, 4));
      set(-5, round2(p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1, 4));
      set(-4, round2(p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 + q2, 4));
      set(-3, round2(p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 + q2 + q3, 4));
      set(-2, round2(p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 + q2 + q3 + q4, 4));
      set(-1, round2(p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 + q3 + q4 + q5, 4));
      set(0, round2(p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 + q4 + q5 + q6, 4));
      set(1, round2(p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 + q5 + q6 * 2, 4));
      set(2, round2(p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 + q6 * 3, 4));
      set(3, round2(p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 + q6 * 4, 4));
      set(4, round2(p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5, 4));
      set(5, round2(p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7, 4));
      return;
    }
  }
  if (flat) {
    set(-3, round2(p3 * 3 + p2 * 2 + p1 + p0 + q0, 3));
    set(-2, round2(p3 * 2 + p2 + p1 * 2 + p0 + q0 + q1, 3));
    set(-1, round2(p3 + p2 + p1 + p0 * 2 + q0 + q1 + q2, 3));
    set(0, round2(p2 + p1 + p0 + q0 * 2 + q1 + q2 + q3, 3));
    set(1, round2(p1 + p0 + q0 + q1 * 2 + q2 + q3 * 2, 3));
    set(2, round2(p0 + q0 + q1 + q2 * 2 + q3 * 3, 3));
  } else {
    filter4();
  }
}

}  // namespace

void loop_filter(Frame& f) {
  for (int plane = 0; plane < f.planes; plane++) {
    if (plane == 1 && !f.lf_level[2]) continue;
    if (plane == 2 && !f.lf_level[3]) continue;
    const int sx = plane ? f.sub_x : 0, sy = plane ? f.sub_y : 0;
    const int pcols = (f.mi_cols + sx) >> sx;
    for (int pass = 0; pass < 2; pass++) {
      const int dx = pass == 0, dy = pass == 1;
      for (int row0 = 0; row0 < f.mi_rows; row0 += 1 << sy)
        for (int col0 = 0; col0 < f.mi_cols; col0 += 1 << sx) {
          const int x = col0 * 4, y = row0 * 4;
          if (x >= f.width || y >= f.height) continue;
          if ((pass == 0 && x == 0) || (pass == 1 && y == 0)) continue;
          const int row = row0 | sy, col = col0 | sx;
          const int xp = x >> sx, yp = y >> sy;
          const int prow = row - (dy << sy), pcol = col - (dx << sx);
          const BlockInfo& b = f.at(row, col);
          const int t = f.lf_tx[plane][size_t(row >> sy) * pcols + (col >> sx)];
          const int pt = f.lf_tx[plane][size_t(prow >> sy) * pcols + (pcol >> sx)];
          const int ps = plane_block(f, b.size, plane);
          const bool block_edge = pass == 0 ? xp % kBlockW[ps] == 0 : yp % kBlockH[ps] == 0;
          const bool tx_edge = pass == 0 ? xp % kTxW[t] == 0 : yp % kTxH[t] == 0;
          if (!tx_edge) continue;
          if (!(block_edge || !b.skip || !b.is_inter)) continue;
          const int base = pass == 0 ? std::min(kTxW[pt], kTxW[t]) : std::min(kTxH[pt], kTxH[t]);
          const int size = plane == 0 ? std::min(16, base) : std::min(8, base);
          int lvl = filter_level(f, b, plane, pass);
          if (lvl == 0) lvl = filter_level(f, f.at(prow, pcol), plane, pass);
          if (lvl == 0) continue;
          for (int i = 0; i < 4; i++) {
            uint16_t* p = &f.px(plane, yp + dx * i, xp + dy * i);
            filter_edge(p, pass == 0 ? 1 : f.stride[plane], size, plane, lvl, f.lf_sharpness,
                        f.bit_depth);
          }
        }
    }
  }
}

// CDEF (spec 7.15).
void cdef(Frame& f) {
  std::vector<uint16_t> src[3];
  for (int p = 0; p < f.planes; p++) src[p] = f.cur[p];
  const int bd = f.bit_depth, cshift = bd - 8;
  auto at = [&](int p, int y, int x) { return int(src[p][size_t(y) * f.stride[p] + x]); };
  static const int kDirs[8][2][2] = {{{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}},
                                     {{0, 1}, {1, 2}},   {{1, 1}, {2, 2}},  {{1, 0}, {2, 1}},
                                     {{1, 0}, {2, 0}},   {{1, 0}, {2, -1}}};
  static const int kUvDir[2][2][8] = {{{0, 1, 2, 3, 4, 5, 6, 7}, {1, 2, 2, 2, 3, 4, 6, 0}},
                                      {{7, 0, 2, 4, 5, 6, 6, 6}, {0, 1, 2, 3, 4, 5, 6, 7}}};
  static const int kDiv[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
  auto constrain = [](int diff, int threshold, int damping) {
    if (!threshold) return 0;
    const int adj = std::max(0, damping - log2i(threshold));
    const int v = std::min(std::abs(diff), std::max(0, threshold - (std::abs(diff) >> adj)));
    return diff < 0 ? -v : v;
  };
  auto filter = [&](int plane, int r, int c, int pri, int sec, int damping, int dir) {
    const int sx = plane ? f.sub_x : 0, sy = plane ? f.sub_y : 0;
    const int x0 = (c * 4) >> sx, y0 = (r * 4) >> sy, w = 8 >> sx, h = 8 >> sy;
    const int tap_set = (pri >> cshift) & 1;
    static const int kPri[2][2] = {{4, 2}, {3, 3}}, kSec[2][2] = {{2, 1}, {2, 1}};
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        const int x = at(plane, y0 + i, x0 + j);
        int sum = 0, mx = x, mn = x;
        auto sample = [&](int dy, int dx, int& v) {
          const int yy = y0 + i + dy, xx = x0 + j + dx;
          const int cr = (yy << sy) >> 2, cc = (xx << sx) >> 2;
          if (yy < 0 || xx < 0 || cr >= f.mi_rows || cc >= f.mi_cols) return false;
          v = at(plane, yy, xx);
          return true;
        };
        for (int k = 0; k < 2; k++)
          for (int sign = -1; sign <= 1; sign += 2) {
            int p;
            if (sample(sign * kDirs[dir][k][0], sign * kDirs[dir][k][1], p)) {
              sum += kPri[tap_set][k] * constrain(p - x, pri, damping);
              mx = std::max(p, mx), mn = std::min(p, mn);
            }
            for (int off = -2; off <= 2; off += 4) {
              const int d2 = (dir + off) & 7;
              int s2;
              if (sample(sign * kDirs[d2][k][0], sign * kDirs[d2][k][1], s2)) {
                sum += kSec[tap_set][k] * constrain(s2 - x, sec, damping);
                mx = std::max(s2, mx), mn = std::min(s2, mn);
              }
            }
          }
        f.px(plane, y0 + i, x0 + j) = uint16_t(std::clamp(x + ((8 + sum - (sum < 0)) >> 4), mn, mx));
      }
  };
  const int cs = (f.mi_cols + 15) >> 4;
  for (int r = 0; r < f.mi_rows; r += 2)
    for (int c = 0; c < f.mi_cols; c += 2) {
      const int idx = f.cdef_idx[(r >> 4) * cs + (c >> 4)];
      if (idx == -1) continue;
      if (f.at(r, c).skip && f.at(r + 1, c).skip && f.at(r, c + 1).skip && f.at(r + 1, c + 1).skip)
        continue;
      // Direction of the 8x8 luma block.
      int cost[8] = {0, 0, 0, 0, 0, 0, 0, 0}, partial[8][15];
      std::memset(partial, 0, sizeof(partial));
      for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
          const int v = (at(0, r * 4 + i, c * 4 + j) >> cshift) - 128;
          partial[0][i + j] += v;
          partial[1][i + j / 2] += v;
          partial[2][i] += v;
          partial[3][3 + i - j / 2] += v;
          partial[4][7 + i - j] += v;
          partial[5][3 - i / 2 + j] += v;
          partial[6][j] += v;
          partial[7][i / 2 + j] += v;
        }
      for (int i = 0; i < 8; i++) {
        cost[2] += partial[2][i] * partial[2][i];
        cost[6] += partial[6][i] * partial[6][i];
      }
      cost[2] *= kDiv[8];
      cost[6] *= kDiv[8];
      for (int i = 0; i < 7; i++) {
        cost[0] += (partial[0][i] * partial[0][i] + partial[0][14 - i] * partial[0][14 - i]) * kDiv[i + 1];
        cost[4] += (partial[4][i] * partial[4][i] + partial[4][14 - i] * partial[4][14 - i]) * kDiv[i + 1];
      }
      cost[0] += partial[0][7] * partial[0][7] * kDiv[8];
      cost[4] += partial[4][7] * partial[4][7] * kDiv[8];
      for (int i = 1; i < 8; i += 2) {
        for (int j = 0; j < 5; j++) cost[i] += partial[i][3 + j] * partial[i][3 + j];
        cost[i] *= kDiv[8];
        for (int j = 0; j < 3; j++)
          cost[i] += (partial[i][j] * partial[i][j] + partial[i][10 - j] * partial[i][10 - j]) *
                     kDiv[2 * j + 2];
      }
      int best = 0, dir = 0;
      for (int i = 0; i < 8; i++)
        if (cost[i] > best) best = cost[i], dir = i;
      const int var = (best - cost[(dir + 4) & 7]) >> 10;
      int pri = f.cdef_y_pri[idx] << cshift, sec = f.cdef_y_sec[idx] << cshift;
      const int vstr = (var >> 6) ? std::min(log2i(var >> 6), 12) : 0;
      pri = var ? (pri * (4 + vstr) + 8) >> 4 : 0;
      filter(0, r, c, pri, sec, f.cdef_damping + cshift, pri == 0 ? 0 : dir);
      if (f.planes == 1) continue;
      pri = f.cdef_uv_pri[idx] << cshift;
      sec = f.cdef_uv_sec[idx] << cshift;
      const int uvdir = pri == 0 ? 0 : kUvDir[f.sub_x][f.sub_y][dir];
      filter(1, r, c, pri, sec, f.cdef_damping + cshift - 1, uvdir);
      filter(2, r, c, pri, sec, f.cdef_damping + cshift - 1, uvdir);
    }
}

// Loop restoration (spec 7.17), from the CDEF output, with the deblocked
// frame above and below each 64-row stripe.
void loop_restoration(Frame& f, const std::vector<uint16_t>* deblocked) {
  std::vector<uint16_t> cdefed[3];
  for (int p = 0; p < f.planes; p++) cdefed[p] = f.cur[p];
  const int bd = f.bit_depth, maxv = (1 << bd) - 1;
  for (int plane = 0; plane < f.planes; plane++) {
    if (f.lr_type[plane] == RESTORE_NONE) continue;
    const int sx = plane ? f.sub_x : 0, sy = plane ? f.sub_y : 0, stride = f.stride[plane];
    const int unit = f.lr_size[plane];
    const int end_x = ((f.width + sx) >> sx) - 1, end_y = ((f.height + sy) >> sy) - 1;
    const uint16_t* cd = cdefed[plane].data();
    const uint16_t* db = deblocked ? deblocked[plane].data() : cd;
    for (int row = 0; row < f.mi_rows; row++) {
      if ((row * 4) >= f.height) break;
      const int luma_y = row * 4;
      const int stripe = (luma_y + 8) / 64;
      const int stripe_start = (-8 + stripe * 64) >> sy;
      const int stripe_end = stripe_start + (64 >> sy) - 1;
      auto sample = [&](int xx, int yy) -> int {
        xx = std::clamp(xx, 0, end_x);
        yy = std::clamp(yy, 0, end_y);
        if (yy < stripe_start) return db[size_t(std::max(stripe_start - 2, yy)) * stride + xx];
        if (yy > stripe_end) return db[size_t(std::min(stripe_end + 2, yy)) * stride + xx];
        return cd[size_t(yy) * stride + xx];
      };
      const int unit_row = std::min(f.lr_unit_rows[plane] - 1, ((row * 4 + 8) >> sy) / unit);
      const int y = (row * 4) >> sy;
      const int h = std::min(4 >> sy, end_y - y + 1);
      for (int col = 0; col < f.mi_cols; col++) {
        if (col * 4 >= f.width) break;
        const int x = (col * 4) >> sx;
        const int w = std::min(4 >> sx, end_x - x + 1);
        const int unit_col = std::min(f.lr_unit_cols[plane] - 1, x / unit);
        const int u = unit_row * f.lr_unit_cols[plane] + unit_col;
        const int type = f.lr_unit_type[plane][u];
        const int16_t* co = &f.lr_coef[plane][size_t(u) * 6];
        if (type == RESTORE_WIENER) {
          const int r0 = bd == 12 ? 5 : 3, r1 = bd == 12 ? 9 : 11;
          int vf[7], hf[7];
          for (int pass = 0; pass < 2; pass++) {
            int* fl = pass == 0 ? vf : hf;
            fl[3] = 128;
            for (int i = 0; i < 3; i++) {
              fl[i] = fl[6 - i] = co[pass * 3 + i];
              fl[3] -= 2 * co[pass * 3 + i];
            }
          }
          const int offset = 1 << (bd + 7 - r0 - 1), limit = (1 << (bd + 1 + 7 - r0)) - 1;
          int inter[10][4];
          for (int r = 0; r < h + 6; r++)
            for (int c = 0; c < w; c++) {
              int s = 0;
              for (int t = 0; t < 7; t++) s += hf[t] * sample(x + c + t - 3, y + r - 3);
              inter[r][c] = std::clamp(round2(s, r0), -offset, limit - offset);
            }
          for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++) {
              int s = 0;
              for (int t = 0; t < 7; t++) s += vf[t] * inter[r + t][c];
              f.px(plane, y + r, x + c) = uint16_t(std::clamp(round2(s, r1), 0, maxv));
            }
        } else if (type == RESTORE_SGRPROJ) {
          const int set = f.lr_sgr_set[plane][u];
          int flt[2][4][4];
          for (int pass = 0; pass < 2; pass++) {
            const int r = kSgrParams[set][pass * 2];
            if (!r) continue;
            const int s = kSgrParams[set][pass * 2 + 1];
            const int n = (2 * r + 1) * (2 * r + 1);
            int A[6][6], B[6][6];
            for (int i = -1; i < h + 1; i++)
              for (int j = -1; j < w + 1; j++) {
                int64_t a = 0, b = 0;
                for (int dy = -r; dy <= r; dy++)
                  for (int dx = -r; dx <= r; dx++) {
                    const int c = sample(x + j + dx, y + i + dy);
                    a += c * c;
                    b += c;
                  }
                a = round2(a, 2 * (bd - 8));
                const int64_t d = round2(b, bd - 8);
                const int64_t p = std::max<int64_t>(0, a * n - d * d);
                const uint32_t z = uint32_t((uint64_t(p) * uint32_t(s) + (1u << 19)) >> 20);
                const int a2 = kXByXPlus1[std::min<uint32_t>(z, 255)];
                const int one_over_n = kOneByX[n - 1];
                const uint32_t b2 = uint32_t(256 - a2) * uint32_t(b) * uint32_t(one_over_n);
                A[i + 1][j + 1] = a2;
                B[i + 1][j + 1] = int(round2(b2, 12));
              }
            for (int i = 0; i < h; i++) {
              const int shift = pass == 0 && (i & 1) ? 4 : 5;
              for (int j = 0; j < w; j++) {
                int a = 0, b = 0;
                for (int dy = -1; dy <= 1; dy++)
                  for (int dx = -1; dx <= 1; dx++) {
                    int wgt;
                    if (pass == 0) wgt = ((i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
                    else wgt = (dx == 0 || dy == 0) ? 4 : 3;
                    a += wgt * A[i + 1 + dy][j + 1 + dx];
                    b += wgt * B[i + 1 + dy][j + 1 + dx];
                  }
                const int64_t v = int64_t(a) * cd[size_t(y + i) * stride + x + j] + b;
                flt[pass][i][j] = round2(v, 8 + shift - 4);
              }
            }
          }
          const int w0 = co[0], w1 = co[1], w2 = (1 << 7) - w0 - w1;
          const int rr0 = kSgrParams[set][0], rr1 = kSgrParams[set][2];
          for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
              const int64_t uu = int64_t(cd[size_t(y + i) * stride + x + j]) << 4;
              int64_t v = w1 * uu;
              v += rr0 ? int64_t(w0) * flt[0][i][j] : w0 * uu;
              v += rr1 ? int64_t(w2) * flt[1][i][j] : w2 * uu;
              f.px(plane, y + i, x + j) = uint16_t(std::clamp(round2(v, 4 + 7), 0, maxv));
            }
        }
      }
    }
  }
}

}  // namespace av1

namespace av1 {

// Film grain synthesis (spec 7.18.3), applied to the output planes.
void film_grain(Frame& f) {
  const FilmGrain& g = f.grain;
  const int bd = f.bit_depth, sx = f.sub_x, sy = f.sub_y;
  const int center = 128 << (bd - 8), gmin = -center, gmax = (256 << (bd - 8)) - 1 - center;
  uint32_t reg = 0;
  auto rnd = [&](int bits) {
    const uint32_t r = reg;
    const uint32_t bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
    reg = (r >> 1) | (bit << 15);
    return int((reg >> (16 - bits)) & ((1u << bits) - 1));
  };
  static thread_local int luma[73][82], cb[38 + 35][82], cr[38 + 35][82];
  int shift = 12 - bd + g.grain_scale_shift;
  reg = uint32_t(g.seed);
  for (int y = 0; y < 73; y++)
    for (int x = 0; x < 82; x++)
      luma[y][x] = round2(g.num_y > 0 ? kGaussianSequence[rnd(11)] : 0, shift);
  const int ar_shift = g.ar_shift, lag = g.ar_lag;
  for (int y = 3; y < 73; y++)
    for (int x = 3; x < 82 - 3; x++) {
      int sum = 0, pos = 0;
      for (int dr = -lag; dr <= 0; dr++)
        for (int dc = -lag; dc <= lag; dc++) {
          if (dr == 0 && dc == 0) break;
          sum += luma[y + dr][x + dc] * g.ar_y[pos++];
        }
      luma[y][x] = std::clamp(luma[y][x] + round2(sum, ar_shift), gmin, gmax);
    }
  const int cw = sx ? 44 : 82, ch = sy ? 38 : 73;
  const bool use_cb = g.num_cb || g.chroma_from_luma, use_cr = g.num_cr || g.chroma_from_luma;
  reg = uint32_t(g.seed ^ 0xb524);
  for (int y = 0; y < ch; y++)
    for (int x = 0; x < cw; x++) cb[y][x] = round2(use_cb ? kGaussianSequence[rnd(11)] : 0, shift);
  reg = uint32_t(g.seed ^ 0x49d8);
  for (int y = 0; y < ch; y++)
    for (int x = 0; x < cw; x++) cr[y][x] = round2(use_cr ? kGaussianSequence[rnd(11)] : 0, shift);
  for (int y = 3; y < ch; y++)
    for (int x = 3; x < cw - 3; x++) {
      int s0 = 0, s1 = 0, pos = 0;
      for (int dr = -lag; dr <= 0; dr++)
        for (int dc = -lag; dc <= lag; dc++) {
          const int c0 = g.ar_cb[pos], c1 = g.ar_cr[pos];
          if (dr == 0 && dc == 0) {
            if (g.num_y > 0) {
              int l = 0;
              const int lx = ((x - 3) << sx) + 3, ly = ((y - 3) << sy) + 3;
              for (int i = 0; i <= sy; i++)
                for (int j = 0; j <= sx; j++) l += luma[ly + i][lx + j];
              l = round2(l, sx + sy);
              s0 += l * c0, s1 += l * c1;
            }
            break;
          }
          s0 += c0 * cb[y + dr][x + dc];
          s1 += c1 * cr[y + dr][x + dc];
          pos++;
        }
      if (use_cb) cb[y][x] = std::clamp(cb[y][x] + round2(s0, ar_shift), gmin, gmax);
      if (use_cr) cr[y][x] = std::clamp(cr[y][x] + round2(s1, ar_shift), gmin, gmax);
    }
  // Scaling lookups.
  int lut[3][256];
  auto init_lut = [&](int* l, int n, const int* value, const int* scaling) {
    if (n == 0) {
      std::fill(l, l + 256, 0);
      return;
    }
    for (int i = 0; i < value[0]; i++) l[i] = scaling[0];
    for (int i = 0; i < n - 1; i++) {
      const int dy = scaling[i + 1] - scaling[i], dx = value[i + 1] - value[i];
      const int delta = dy * ((65536 + (dx >> 1)) / dx);
      for (int x = 0; x < dx; x++) l[value[i] + x] = scaling[i] + ((x * delta + 32768) >> 16);
    }
    for (int i = value[n - 1]; i < 256; i++) l[i] = scaling[n - 1];
  };
  init_lut(lut[0], g.num_y, g.y_value, g.y_scaling);
  if (g.chroma_from_luma) {
    init_lut(lut[1], g.num_y, g.y_value, g.y_scaling);
    init_lut(lut[2], g.num_y, g.y_value, g.y_scaling);
  } else {
    init_lut(lut[1], g.num_cb, g.cb_value, g.cb_scaling);
    init_lut(lut[2], g.num_cr, g.cr_value, g.cr_scaling);
  }
  auto scale = [&](int p, int index) {
    const int s = bd - 8, x = index >> s, rem = index - (x << s);
    if (bd == 8 || x == 255) return lut[p][x];
    return lut[p][x] + round2((lut[p][x + 1] - lut[p][x]) * rem, s);
  };
  // Noise stripes of 32 luma rows, blocks of 32 luma columns from random
  // offsets into the grain templates, overlapped where asked.
  const int W = f.width, H = f.height;
  const int stripes = (H + 31) / 32 + 1;
  const int sw = W + 64;
  std::vector<int> stripe[3];
  for (int p = 0; p < f.planes; p++) stripe[p].assign(size_t(stripes) * 34 * sw, 0);
  auto st = [&](int p, int n, int i, int x) -> int& { return stripe[p][(size_t(n) * 34 + i) * sw + x]; };
  int n = 0;
  for (int y = 0; y < (H + 1) / 2; y += 16, n++) {
    reg = uint32_t(g.seed);
    reg ^= uint32_t(((n * 37 + 178) & 255) << 8);
    reg ^= uint32_t((n * 173 + 105) & 255);
    for (int x = 0; x < (W + 1) / 2; x += 16) {
      const int r = rnd(8), ox = r >> 4, oy = r & 15;
      for (int p = 0; p < f.planes; p++) {
        const int psx = p ? sx : 0, psy = p ? sy : 0;
        const int px = psx ? 6 + ox : 9 + ox * 2, py = psy ? 6 + oy : 9 + oy * 2;
        for (int i = 0; i < (34 >> psy); i++)
          for (int j = 0; j < (34 >> psx); j++) {
            int v = p == 0 ? luma[py + i][px + j] : p == 1 ? cb[py + i][px + j] : cr[py + i][px + j];
            if (!psx) {
              if (j < 2 && g.overlap && x > 0) {
                const int old = st(p, n, i, x * 2 + j);
                v = j == 0 ? old * 27 + v * 17 : old * 17 + v * 27;
                v = std::clamp(round2(v, 5), gmin, gmax);
              }
              st(p, n, i, x * 2 + j) = v;
            } else {
              if (j == 0 && g.overlap && x > 0) {
                const int old = st(p, n, i, x + j);
                v = std::clamp(round2(old * 23 + v * 22, 5), gmin, gmax);
              }
              st(p, n, i, x + j) = v;
            }
          }
      }
    }
  }
  std::vector<int> noise[3];
  for (int p = 0; p < f.planes; p++) {
    const int psx = p ? sx : 0, psy = p ? sy : 0;
    const int pw = (W + psx) >> psx, ph = (H + psy) >> psy;
    noise[p].assign(size_t(pw) * ph, 0);
    for (int y = 0; y < ph; y++)
      for (int x = 0; x < pw; x++) {
        const int ln = y >> (5 - psy), i = y - (ln << (5 - psy));
        int v = st(p, ln, i, x);
        if (!psy) {
          if (i < 2 && ln > 0 && g.overlap) {
            const int old = st(p, ln - 1, i + 32, x);
            v = i == 0 ? old * 27 + v * 17 : old * 17 + v * 27;
            v = std::clamp(round2(v, 5), gmin, gmax);
          }
        } else if (i < 1 && ln > 0 && g.overlap) {
          const int old = st(p, ln - 1, i + 16, x);
          v = std::clamp(round2(old * 23 + v * 22, 5), gmin, gmax);
        }
        noise[p][size_t(y) * pw + x] = v;
      }
  }
  int min_v, max_luma, max_chroma;
  if (g.clip_restricted) {
    min_v = 16 << (bd - 8);
    max_luma = 235 << (bd - 8);
    max_chroma = f.matrix == 0 ? max_luma : 240 << (bd - 8);
  } else {
    min_v = 0;
    max_luma = max_chroma = (256 << (bd - 8)) - 1;
  }
  const int sshift = g.scaling_shift, maxv = (1 << bd) - 1;
  if (f.planes > 1) {
    const int pw = (W + sx) >> sx, ph = (H + sy) >> sy;
    for (int y = 0; y < ph; y++)
      for (int x = 0; x < pw; x++) {
        const int lx = x << sx, ly = y << sy, lnx = std::min(lx + 1, W - 1);
        const int avg = sx ? round2(f.px(0, ly, lx) + f.px(0, ly, lnx), 1) : f.px(0, ly, lx);
        for (int p = 1; p < 3; p++) {
          const bool on = (p == 1 ? g.num_cb : g.num_cr) > 0 || g.chroma_from_luma;
          if (!on) continue;
          const int orig = f.px(p, y, x);
          int merged;
          if (g.chroma_from_luma) {
            merged = avg;
          } else {
            const int lm = p == 1 ? g.cb_luma_mult : g.cr_luma_mult, m = p == 1 ? g.cb_mult : g.cr_mult;
            const int off = p == 1 ? g.cb_offset : g.cr_offset;
            const int combined = avg * (lm - 128) + orig * (m - 128);
            merged = std::clamp((combined >> 6) + ((off - 256) << (bd - 8)), 0, maxv);
          }
          const int nz = round2(scale(p, merged) * noise[p][size_t(y) * pw + x], sshift);
          f.px(p, y, x) = uint16_t(std::clamp(orig + nz, min_v, max_chroma));
        }
      }
  }
  if (g.num_y > 0)
    for (int y = 0; y < H; y++)
      for (int x = 0; x < W; x++) {
        const int orig = f.px(0, y, x);
        const int nz = round2(scale(0, orig) * noise[0][size_t(y) * W + x], sshift);
        f.px(0, y, x) = uint16_t(std::clamp(orig + nz, min_v, max_luma));
      }
}

}  // namespace av1
