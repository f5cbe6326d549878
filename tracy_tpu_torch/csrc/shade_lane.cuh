// One lane's shading bounce, shared by K2 and K4 (shade.cu) and K5
// (bounce.cu), so that the RNG bits and the bounce math cannot drift apart.
//
// The lane's state and hit record come in registers. shade_miss is a live
// lane that hit nothing: it gathers the sky (material slot 0's emissive, or
// on a textured scene its equirect texel, which K4 fetched). shade_hit is a
// live lane that hit: the material row lookup, Material::Scatter (reference
// material.h:210-268: diffuse, specular and refraction lobes, Schlick, the
// specular-chance lerps, the TIR clamp), radiance += emission * throughput,
// throughput *= attenuation, and Russian roulette with p = EPS +
// max(throughput) and a true-division 1/p reweight. The RNG is one of
// tracy_tpu/core/rng.py's kinds, chosen per launch, bit for bit: a counter
// hash of (seed, pixel, sample_key, bounce, draw) in uint32_t, 'fast' (PCG),
// 'xorshift' (xorshift32 twice) or 'lcg' (two LCG steps with xor-folds); or
// 'threefry', jax.random's Threefry-2x32 of the lane's position in the wave
// under the draw's key (the host folds (seed, sample_key, bounce, draw) into
// the four keys of a launch: core/rng.py::threefry_keys), plus the 'fast'
// draw of seed ^ 0x5BD1E995, modulo 1.
//
// TEXTURED adds, per the slot flags of the material table (columns 10-14,
// build_material_table_tex): texture overrides of basecolor, roughness,
// metalness and emissive from the lane's 12-float texel row (in registers;
// texfetch_lane.cuh), and tangent-space normal mapping with the raw
// interpolated tangent in the TBN (pallas_shade.py:189-210, reference
// material.h:189-203). The tangent is read only where the material has a
// normal map.
//
// The material table comes as a pointer: K2 and K4 pass the block's staged
// copy in shared memory, or on their global route the table in global
// memory with LDG true (read through __ldg); K5 passes it in global memory
// and reads it with plain loads.
//
// Operation order is that of the plain PyTorch versions (ops/shade.py),
// with FMA contraction off at build time, so they agree to rounding.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "texfetch_lane.cuh"

namespace tracy {

constexpr float SHADE_EPS = 1.0e-8f;
constexpr float RAY_OFFSET = 1.0e-3f;
constexpr float TWO_PI = 6.283185307179586f;  // float32(2 * pi)
constexpr int MTAB_COLS = 10;  // albedo3, rough, metal, ior, emissive3, transl
constexpr int MTAB_TEX_COLS = 16;  // + has basecolor/normal/rough/metal/emissive, pad
constexpr int HAS_BC = 10, HAS_N = 11, HAS_R = 12, HAS_M = 13, HAS_E = 14;
constexpr int TX_BC = 0, TX_NM = 3, TX_ROUGH = 6, TX_METAL = 7, TX_EM = 8;
constexpr uint32_t K_PIXEL = 0x9E3779B9u, K_FRAME = 0x85EBCA6Bu;
constexpr uint32_t K_BOUNCE = 0xC2B2AE35u, K_DRAW = 0x27D4EB2Fu;
// RNG kinds (core/rng.py KINDS order).
constexpr int RNG_FAST = 0, RNG_XORSHIFT = 1, RNG_LCG = 2, RNG_THREEFRY = 3;
constexpr uint32_t THREEFRY_MIX_SEED = 0x5BD1E995u;
constexpr int NUM_DRAWS = 4;  // sphere z, sphere phi, specular, roulette

// A launch's RNG: its kind, seed, sample key and bounce, and under
// threefry the keys of draws 0-3, (k1, k2) each, which depend on host
// integers only (core/rng.py::threefry_keys).
struct Rng {
  int kind;
  uint32_t seed, skey, bounce;
  uint32_t keys[2 * NUM_DRAWS];
};

// keys: 2 * NUM_DRAWS words, read only under threefry (may be null else).
inline Rng make_rng(int kind, uint32_t seed, uint32_t skey, uint32_t bounce,
                    const uint32_t* keys) {
  Rng r{kind, seed, skey, bounce, {}};
  if (kind == RNG_THREEFRY && keys != nullptr) {
    for (int k = 0; k < 2 * NUM_DRAWS; ++k) r.keys[k] = keys[k];
  }
  return r;
}

__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  x = x * 747796405u + 2891336453u;
  x = ((x >> ((x >> 28u) + 4u)) ^ x) * 277803737u;
  return (x >> 22u) ^ x;
}

__device__ __forceinline__ uint32_t xorshift32(uint32_t x) {
  x ^= x << 13u;
  x ^= x >> 17u;
  return x ^ (x << 5u);
}

// One LCG step (Numerical Recipes' constants), then a 16-bit xor-fold.
__device__ __forceinline__ uint32_t lcg_fold(uint32_t x) {
  x = x * 1664525u + 1013904223u;
  return x ^ (x >> 16u);
}

// core/rng.py HASHES[kind]; the kind is uniform across a launch.
__device__ __forceinline__ uint32_t counter_hash(uint32_t x, int kind) {
  if (kind == RNG_XORSHIFT) return xorshift32(xorshift32(x));
  if (kind == RNG_LCG) return lcg_fold(lcg_fold(x));
  return pcg_hash(x);
}

// Uniform [0, 1) from the top 24 hashed bits (core/rng.py::uniform_fast).
__device__ __forceinline__ float hash01(uint32_t seed, uint32_t pix,
                                        uint32_t skey, uint32_t bounce,
                                        uint32_t draw, int kind) {
  uint32_t h = seed + pix * K_PIXEL;
  h = counter_hash(h + skey * K_FRAME, kind);
  h = counter_hash(h + bounce * K_BOUNCE + draw * K_DRAW, kind);
  return static_cast<float>(counter_hash(h, kind) >> 8u) * (1.0f / 16777216.0f);
}

// Threefry-2x32 with 20 rounds (jax/_src/prng.py::_threefry2x32_lowering),
// in place on the counter words (x1, x2).
__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2,
                                             uint32_t& x1, uint32_t& x2) {
  constexpr int ROT[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = __funnelshift_l(x2, x2, ROT[i & 1][j]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// Draw `draw` of a lane with pixel id pix at position pos of the wave
// (core/rng.py::RngSpec.uniform): uniform [0, 1).
__device__ __forceinline__ float rand01(const Rng& rng, uint32_t pix,
                                        uint32_t pos, uint32_t draw) {
  if (rng.kind != RNG_THREEFRY) {
    return hash01(rng.seed, pix, rng.skey, rng.bounce, draw, rng.kind);
  }
  // jax.random.uniform over the wave: the counter is (pos >> 32, pos),
  // bits = x1 ^ x2, a float in [1, 2) from the top 23 bits, minus one.
  uint32_t x1 = 0u, x2 = pos;
  threefry2x32(rng.keys[2 * draw], rng.keys[2 * draw + 1], x1, x2);
  const float base = __uint_as_float(((x1 ^ x2) >> 9u) | 0x3F800000u) - 1.0f;
  const float s = base + hash01(rng.seed ^ THREEFRY_MIX_SEED, pix, rng.skey,
                                rng.bounce, draw, RNG_FAST);
  return s >= 1.0f ? s - 1.0f : s;
}

__device__ __forceinline__ float schlick(float cosine, float ref_idx) {
  const float r = (1.0f - ref_idx) / (1.0f + ref_idx);
  const float r0 = r * r;
  const float c = 1.0f - cosine;
  const float c2 = c * c;
  return r0 + (1.0f - r0) * (c * (c2 * c2));
}

// A live lane that hit nothing: rad += sky * thr. sky_texel is the sky's
// equirect texel in this lane's direction (TEXTURED only; used when the
// sky is textured).
template <bool TEXTURED, bool LDG = false>
__device__ __forceinline__ void shade_miss(float* rad, const float* thr,
                                           const float* mtab,
                                           float4 sky_texel) {
  float sky[3] = {ld<LDG>(mtab + 6), ld<LDG>(mtab + 7), ld<LDG>(mtab + 8)};
  if (TEXTURED && ld<LDG>(mtab + HAS_E) > 0.0f) {
    sky[0] = sky_texel.x;
    sky[1] = sky_texel.y;
    sky[2] = sky_texel.z;
  }
  for (int c = 0; c < 3; ++c) rad[c] = rad[c] + sky[c] * thr[c];
}

// A live lane that hit at distance t, with the winner's unnormalised
// interpolated normal nrm and material m: updates o, d, thr, rad in place
// to the next state and returns whether the path lives on. pix and pos are
// the lane's pixel id and its position in the wave (threefry's counter).
// tex and tan_lane are the lane's 12-float texel row (registers) and
// tangent (TEXTURED only; tan_lane may be null, read as zero).
template <bool TEXTURED, bool LDG = false>
__device__ __forceinline__ bool shade_hit(
    float* o, float* d, float* thr, float* rad, float t, const float* nrm,
    int m, uint32_t pix, uint32_t pos, const float* mtab, int num_materials,
    const Rng& rng, int russian_roulette, const float* tex,
    const float* __restrict__ tan_lane) {
  constexpr int COLS = TEXTURED ? MTAB_TEX_COLS : MTAB_COLS;
  const float r_z = rand01(rng, pix, pos, 0u);
  const float r_phi = rand01(rng, pix, pos, 1u);
  const float r_spec = rand01(rng, pix, pos, 2u);

  m = (m < 0 || m >= num_materials) ? 0 : m;
  const float* row = mtab + m * COLS;
  float bc[3] = {ld<LDG>(row), ld<LDG>(row + 1), ld<LDG>(row + 2)};
  float rough = ld<LDG>(row + 3), metal = ld<LDG>(row + 4);
  const float ior = ld<LDG>(row + 5);
  float emis[3] = {ld<LDG>(row + 6), ld<LDG>(row + 7), ld<LDG>(row + 8)};
  const float transl = ld<LDG>(row + 9);
  float nv[3] = {nrm[0], nrm[1], nrm[2]};

  if (TEXTURED) {
    // Texture overrides and normal mapping (render/material.py::
    // apply_textures, in its operation order).
    if (ld<LDG>(row + HAS_BC) > 0.0f) {
      for (int c = 0; c < 3; ++c) bc[c] = tex[TX_BC + c];
    }
    if (ld<LDG>(row + HAS_R) > 0.0f) rough = tex[TX_ROUGH];
    if (ld<LDG>(row + HAS_M) > 0.0f) metal = tex[TX_METAL];
    if (ld<LDG>(row + HAS_E) > 0.0f) {
      for (int c = 0; c < 3; ++c) emis[c] = tex[TX_EM + c];
    }
    if (ld<LDG>(row + HAS_N) > 0.0f) {
      float tg[3] = {0.0f, 0.0f, 0.0f};
      if (tan_lane != nullptr) {
        for (int c = 0; c < 3; ++c) tg[c] = tan_lane[c];
      }
      const float tdn = tg[0] * nv[0] + tg[1] * nv[1] + tg[2] * nv[2];
      float to[3];
      for (int c = 0; c < 3; ++c) to[c] = tg[c] - tdn * nv[c];
      const float tl = sqrtf(fmaxf(to[0] * to[0] + to[1] * to[1] + to[2] * to[2], 1.0e-20f));
      for (int c = 0; c < 3; ++c) to[c] = to[c] / tl;
      const float bt[3] = {nv[1] * to[2] - nv[2] * to[1],
                           nv[2] * to[0] - nv[0] * to[2],
                           nv[0] * to[1] - nv[1] * to[0]};
      float nt[3], mp[3];
      for (int c = 0; c < 3; ++c) nt[c] = tex[TX_NM + c] * 2.0f - 1.0f;
      for (int c = 0; c < 3; ++c) mp[c] = bt[c] * nt[0] + tg[c] * nt[1] + nv[c] * nt[2];
      const float ml = sqrtf(fmaxf(mp[0] * mp[0] + mp[1] * mp[1] + mp[2] * mp[2], 1.0e-20f));
      for (int c = 0; c < 3; ++c) nv[c] = mp[c] / ml;
    }
  }

  const float vdn = d[0] * nv[0] + d[1] * nv[1] + d[2] * nv[2];

  // random_on_unit_sphere (material.h:144-157)
  const float sz = 2.0f * r_z - 1.0f;
  const float phi = TWO_PI * r_phi;
  const float sr = sqrtf(fmaxf(1.0f - sz * sz, 0.0f));
  const float sph[3] = {sr * cosf(phi), sr * sinf(phi), sz};

  // BTDF (material.h:236-249; Snell cosine clamped to 0 on TIR)
  const bool inside = vdn > SHADE_EPS;
  const float cos_in = sqrtf(fmaxf(1.0f - ior * ior * (1.0f - vdn * vdn), 0.0f));
  const float cosine = inside ? cos_in : -vdn;
  const float eta = inside ? ior : 1.0f / fmaxf(ior, 1.0e-8f);
  const float ndi = nv[0] * d[0] + nv[1] * d[1] + nv[2] * d[2];
  const float k_r = 1.0f - eta * eta * (1.0f - ndi * ndi);
  const float coef = eta * ndi + sqrtf(fmaxf(k_r, 0.0f));
  const bool btdf_spec = r_spec < schlick(cosine, eta);

  // BRDF (material.h:250-261)
  const float mat_spec_chance = 0.1f + 0.9f * metal;
  const float fresnel = (1.0f - rough) * schlick(-vdn, 1.0f);
  const float spec_chance = mat_spec_chance + (1.0f - mat_spec_chance) * fresnel;
  const bool brdf_spec = r_spec < spec_chance;
  const bool is_btdf = transl > SHADE_EPS;

  float nd[3], att[3];
  const float two_dn = 2.0f * ndi;
  for (int c = 0; c < 3; ++c) {
    const float scat = nv[c] + sph[c];
    const float refl = d[c] - two_dn * nv[c];
    const float spec = refl + (scat - refl) * rough;
    const float refr = k_r < 0.0f ? 0.0f : eta * d[c] - coef * nv[c];
    const float trans = refr + (scat - refr) * rough;
    const float speccol = 0.85f + (bc[c] - 0.85f) * metal;
    nd[c] = is_btdf ? (btdf_spec ? spec : trans) : (brdf_spec ? spec : scat);
    att[c] = is_btdf ? bc[c] : (brdf_spec ? speccol : bc[c]);
  }
  const float len = sqrtf(fmaxf(nd[0] * nd[0] + nd[1] * nd[1] + nd[2] * nd[2], 1.0e-20f));
  for (int c = 0; c < 3; ++c) nd[c] = nd[c] / len;

  for (int c = 0; c < 3; ++c) {
    const float p = o[c] + t * d[c];
    o[c] = p + RAY_OFFSET * nd[c];
    d[c] = nd[c];
    rad[c] = rad[c] + emis[c] * thr[c];
    thr[c] = thr[c] * att[c];
  }
  bool alive = true;
  if (russian_roulette) {
    const float p = SHADE_EPS + fmaxf(thr[0], fmaxf(thr[1], thr[2]));
    alive = rand01(rng, pix, pos, 3u) <= p;
    if (alive) {
      const float den = fmaxf(p, SHADE_EPS);
      for (int c = 0; c < 3; ++c) thr[c] = thr[c] / den;
    }
  }
  return alive;
}

}  // namespace tracy
