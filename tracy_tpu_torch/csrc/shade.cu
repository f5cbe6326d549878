// K2 and K4: one shading bounce of the wavefront, one thread per lane.
//
// K2 (untextured) replaces tracy_tpu/ops/pallas_shade.py::_kernel/
// shade_planes (entered through shade_packets); K4 (textured) replaces
// pallas_shade.py::_kernel_tex (entered through shade_packets_textured).
// As shade_planes serves both TPU kernels, one device function serves both
// here: shade_bounce<TEXTURED>, launched as shade_kernel (K2) and
// shade_textured_kernel (K4). The bounce is the material row lookup,
// Material::Scatter
// (reference material.h:210-268: diffuse, specular and refraction lobes,
// Schlick, the specular-chance lerps, the TIR clamp), constant-sky emission
// on misses, radiance += emission * throughput, throughput *= attenuation,
// and Russian roulette with p = EPS + max(throughput) and a true-division
// 1/p reweight. The counter RNG is tracy_tpu/core/rng.py's 'fast' PCG hash
// of (seed, pixel, sample_key, bounce, draw) in uint32_t, bit for bit.
//
// K4 adds, per the slot flags of its material table (columns 10-14,
// build_material_table_tex): texture overrides of basecolor, roughness,
// metalness and emissive from the lane's texel row (ops/texfetch.py, K3),
// tangent-space normal mapping with the raw interpolated tangent in the TBN
// (pallas_shade.py:189-210, reference material.h:189-203), and the sky from
// the texel row's emissive texels on miss lanes when the sky is textured
// (pallas_shade.py:274-281). RNG bits and operation order are K2's.
//
// What bounds it on an H100: it is a fused elementwise pass. Per lane K2
// reads 74 bytes of state and hit record and writes 49; K4 also reads a
// 48-byte texel row and a 12-byte tangent. Against a few hundred flops that
// is bound by DRAM bandwidth; the material table is a few rows and stays
// in L1. The design keeps every intermediate in registers and makes one
// read and one write of each value (the texel row as three 16-byte loads).
// It takes the operation order of the plain PyTorch versions (ops/shade.py),
// with FMA contraction off at build time, so the two agree to rounding;
// speed work (packed state, fusing K3's gather in) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float EPS = 1.0e-8f;
constexpr float RAY_OFFSET = 1.0e-3f;
constexpr float TWO_PI = 6.283185307179586f;  // float32(2 * pi)
constexpr int MTAB_COLS = 10;  // albedo3, rough, metal, ior, emissive3, transl
constexpr int MTAB_TEX_COLS = 16;  // + has basecolor/normal/rough/metal/emissive, pad
constexpr int HAS_BC = 10, HAS_N = 11, HAS_R = 12, HAS_M = 13, HAS_E = 14;
constexpr int TX_BC = 0, TX_NM = 3, TX_ROUGH = 6, TX_METAL = 7, TX_EM = 8;
constexpr int BLOCK = 256;
constexpr uint32_t K_PIXEL = 0x9E3779B9u, K_FRAME = 0x85EBCA6Bu;
constexpr uint32_t K_BOUNCE = 0xC2B2AE35u, K_DRAW = 0x27D4EB2Fu;

__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  x = x * 747796405u + 2891336453u;
  x = ((x >> ((x >> 28u) + 4u)) ^ x) * 277803737u;
  return (x >> 22u) ^ x;
}

// Uniform [0, 1) from the top 24 hashed bits (core/rng.py::uniform_fast).
__device__ __forceinline__ float rand01(uint32_t seed, uint32_t pix,
                                        uint32_t skey, uint32_t bounce,
                                        uint32_t draw) {
  uint32_t h = seed + pix * K_PIXEL;
  h = pcg_hash(h + skey * K_FRAME);
  h = pcg_hash(h + bounce * K_BOUNCE + draw * K_DRAW);
  return static_cast<float>(pcg_hash(h) >> 8u) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float schlick(float cosine, float ref_idx) {
  const float r = (1.0f - ref_idx) / (1.0f + ref_idx);
  const float r0 = r * r;
  const float c = 1.0f - cosine;
  const float c2 = c * c;
  return r0 + (1.0f - r0) * (c * (c2 * c2));
}

// The lane's 12-float texel row (render/texture.py layout), three float4s.
__device__ __forceinline__ void load_texels(const float4* __restrict__ texels,
                                            int i, float* tex) {
  for (int k = 0; k < 3; ++k) {
    const float4 q = texels[3 * i + k];
    tex[4 * k] = q.x;
    tex[4 * k + 1] = q.y;
    tex[4 * k + 2] = q.z;
    tex[4 * k + 3] = q.w;
  }
}

template <bool TEXTURED>
__device__ __forceinline__ void shade_bounce(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ thr_in, const float* __restrict__ rad_in,
    const bool* __restrict__ alive_in, const int* __restrict__ pix_in,
    const bool* __restrict__ hit_in, const float* __restrict__ t_in,
    const float* __restrict__ nrm_in, const int* __restrict__ mat_in,
    const float* __restrict__ tan_in, const float4* __restrict__ texels,
    int n, const float* __restrict__ mtab, int num_materials, uint32_t skey,
    uint32_t bounce, uint32_t seed, int russian_roulette,
    float* __restrict__ o_out, float* __restrict__ d_out,
    float* __restrict__ thr_out, float* __restrict__ rad_out,
    bool* __restrict__ alive_out) {
  constexpr int COLS = TEXTURED ? MTAB_TEX_COLS : MTAB_COLS;
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  float o[3], d[3], thr[3], rad[3];
  for (int c = 0; c < 3; ++c) {
    o[c] = orig[3 * i + c];
    d[c] = dir[3 * i + c];
    thr[c] = thr_in[3 * i + c];
    rad[c] = rad_in[3 * i + c];
  }
  bool alive = false;
  if (alive_in[i]) {
    if (!hit_in[i]) {
      // Miss: the sky (material slot 0's emissive, or its equirect texels
      // that K3 fetched for this lane) and the path ends.
      float sky[3] = {mtab[6], mtab[7], mtab[8]};
      if (TEXTURED && mtab[HAS_E] > 0.0f) {
        float tex[12];
        load_texels(texels, i, tex);
        for (int c = 0; c < 3; ++c) sky[c] = tex[TX_EM + c];
      }
      for (int c = 0; c < 3; ++c) rad[c] = rad[c] + sky[c] * thr[c];
    } else {
      const uint32_t pix = static_cast<uint32_t>(pix_in[i]);
      const float r_z = rand01(seed, pix, skey, bounce, 0u);
      const float r_phi = rand01(seed, pix, skey, bounce, 1u);
      const float r_spec = rand01(seed, pix, skey, bounce, 2u);

      int m = mat_in[i];
      m = (m < 0 || m >= num_materials) ? 0 : m;
      const float* row = mtab + m * COLS;
      float bc[3] = {row[0], row[1], row[2]};
      float rough = row[3], metal = row[4];
      const float ior = row[5];
      float emis[3] = {row[6], row[7], row[8]};
      const float transl = row[9];
      float nv[3] = {nrm_in[3 * i], nrm_in[3 * i + 1], nrm_in[3 * i + 2]};

      if (TEXTURED) {
        // Texture overrides and normal mapping (render/material.py::
        // apply_textures, in its operation order).
        float tex[12];
        load_texels(texels, i, tex);
        if (row[HAS_BC] > 0.0f) {
          for (int c = 0; c < 3; ++c) bc[c] = tex[TX_BC + c];
        }
        if (row[HAS_R] > 0.0f) rough = tex[TX_ROUGH];
        if (row[HAS_M] > 0.0f) metal = tex[TX_METAL];
        if (row[HAS_E] > 0.0f) {
          for (int c = 0; c < 3; ++c) emis[c] = tex[TX_EM + c];
        }
        if (row[HAS_N] > 0.0f) {
          float tg[3] = {0.0f, 0.0f, 0.0f};
          if (tan_in != nullptr) {
            for (int c = 0; c < 3; ++c) tg[c] = tan_in[3 * i + c];
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
      const bool inside = vdn > EPS;
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
      const bool is_btdf = transl > EPS;

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

      const float t = t_in[i];
      for (int c = 0; c < 3; ++c) {
        const float p = o[c] + t * d[c];
        o[c] = p + RAY_OFFSET * nd[c];
        d[c] = nd[c];
        rad[c] = rad[c] + emis[c] * thr[c];
        thr[c] = thr[c] * att[c];
      }
      alive = true;
      if (russian_roulette) {
        const float p = EPS + fmaxf(thr[0], fmaxf(thr[1], thr[2]));
        alive = rand01(seed, pix, skey, bounce, 3u) <= p;
        if (alive) {
          const float den = fmaxf(p, EPS);
          for (int c = 0; c < 3; ++c) thr[c] = thr[c] / den;
        }
      }
    }
  }
  for (int c = 0; c < 3; ++c) {
    o_out[3 * i + c] = o[c];
    d_out[3 * i + c] = d[c];
    thr_out[3 * i + c] = thr[c];
    rad_out[3 * i + c] = rad[c];
  }
  alive_out[i] = alive;
}

// K2 and K4 are two kernels of their own names, so that a profile tells
// them apart; both are shade_bounce.
#define SHADE_PARAMS                                                        \
  const float *__restrict__ orig, const float *__restrict__ dir,            \
      const float *__restrict__ thr_in, const float *__restrict__ rad_in,   \
      const bool *__restrict__ alive_in, const int *__restrict__ pix_in,    \
      const bool *__restrict__ hit_in, const float *__restrict__ t_in,      \
      const float *__restrict__ nrm_in, const int *__restrict__ mat_in,     \
      const float *__restrict__ tan_in, const float4 *__restrict__ texels,  \
      int n, const float *__restrict__ mtab, int num_materials,             \
      uint32_t skey, uint32_t bounce, uint32_t seed, int russian_roulette,  \
      float *__restrict__ o_out, float *__restrict__ d_out,                 \
      float *__restrict__ thr_out, float *__restrict__ rad_out,             \
      bool *__restrict__ alive_out
#define SHADE_ARGS                                                          \
  orig, dir, thr_in, rad_in, alive_in, pix_in, hit_in, t_in, nrm_in,        \
      mat_in, tan_in, texels, n, mtab, num_materials, skey, bounce, seed,   \
      russian_roulette, o_out, d_out, thr_out, rad_out, alive_out

__global__ void __launch_bounds__(BLOCK) shade_kernel(SHADE_PARAMS) {
  shade_bounce<false>(SHADE_ARGS);
}

__global__ void __launch_bounds__(BLOCK) shade_textured_kernel(SHADE_PARAMS) {
  shade_bounce<true>(SHADE_ARGS);
}

}  // namespace

extern "C" int tracy_shade(const float* orig, const float* dir,
                           const float* thr, const float* rad,
                           const bool* alive, const int* pix,
                           const bool* hit, const float* t,
                           const float* normal, const int* mat, int n,
                           const float* mtab, int num_materials,
                           uint32_t sample_key, uint32_t bounce, uint32_t seed,
                           int russian_roulette, float* o_out, float* d_out,
                           float* thr_out, float* rad_out, bool* alive_out,
                           void* stream) {
  if (n > 0) {
    shade_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        orig, dir, thr, rad, alive, pix, hit, t, normal, mat, nullptr,
        nullptr, n, mtab, num_materials, sample_key, bounce, seed,
        russian_roulette, o_out, d_out, thr_out, rad_out, alive_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4. tangent may be null (no normal maps in the scene: read as zero);
// texels is [n, 12] float32, 16-byte aligned; mtab is [M, 16].
extern "C" int tracy_shade_textured(
    const float* orig, const float* dir, const float* thr, const float* rad,
    const bool* alive, const int* pix, const bool* hit, const float* t,
    const float* normal, const int* mat, const float* tangent,
    const float* texels, int n, const float* mtab, int num_materials,
    uint32_t sample_key, uint32_t bounce, uint32_t seed, int russian_roulette,
    float* o_out, float* d_out, float* thr_out, float* rad_out,
    bool* alive_out, void* stream) {
  if (n > 0) {
    shade_textured_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        orig, dir, thr, rad, alive, pix, hit, t, normal, mat, tangent,
        reinterpret_cast<const float4*>(texels), n, mtab, num_materials,
        sample_key, bounce, seed, russian_roulette, o_out, d_out, thr_out,
        rad_out, alive_out);
  }
  return static_cast<int>(cudaGetLastError());
}
