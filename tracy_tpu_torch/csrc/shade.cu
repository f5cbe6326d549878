// K2: one untextured shading bounce of the wavefront, one thread per lane.
//
// Replaces tracy_tpu/ops/pallas_shade.py::_kernel/shade_planes (entered
// through shade_packets): the material row lookup, Material::Scatter
// (reference material.h:210-268: diffuse, specular and refraction lobes,
// Schlick, the specular-chance lerps, the TIR clamp), constant-sky emission
// on misses, radiance += emission * throughput, throughput *= attenuation,
// and Russian roulette with p = EPS + max(throughput) and a true-division
// 1/p reweight. The counter RNG is tracy_tpu/core/rng.py's 'fast' PCG hash
// of (seed, pixel, sample_key, bounce, draw) in uint32_t, bit for bit.
//
// What bounds it on an H100: it is a fused elementwise pass. Per lane it
// reads 78 bytes of state and hit record and writes 49, against a few
// hundred flops, so it is bound by DRAM bandwidth; the material table is a
// few rows and stays in L1. The design keeps every intermediate in
// registers and makes one read and one write of each value. It takes the
// operation order of the plain PyTorch version (ops/shade.py), with FMA
// contraction off at build time, so the two agree to rounding; speed work
// (packed state, fewer planes) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float EPS = 1.0e-8f;
constexpr float RAY_OFFSET = 1.0e-3f;
constexpr float TWO_PI = 6.283185307179586f;  // float32(2 * pi)
constexpr int MTAB_COLS = 10;  // albedo3, rough, metal, ior, emissive3, transl
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

__global__ void __launch_bounds__(BLOCK) shade_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ thr_in, const float* __restrict__ rad_in,
    const bool* __restrict__ alive_in, const int* __restrict__ pix_in,
    const bool* __restrict__ hit_in, const float* __restrict__ t_in,
    const float* __restrict__ nrm_in, const int* __restrict__ mat_in, int n,
    const float* __restrict__ mtab, int num_materials, uint32_t skey,
    uint32_t bounce, uint32_t seed, int russian_roulette,
    float* __restrict__ o_out, float* __restrict__ d_out,
    float* __restrict__ thr_out, float* __restrict__ rad_out,
    bool* __restrict__ alive_out) {
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
      // Miss: the sky (material slot 0's emissive) and the path ends.
      for (int c = 0; c < 3; ++c) rad[c] = rad[c] + mtab[6 + c] * thr[c];
    } else {
      const uint32_t pix = static_cast<uint32_t>(pix_in[i]);
      const float r_z = rand01(seed, pix, skey, bounce, 0u);
      const float r_phi = rand01(seed, pix, skey, bounce, 1u);
      const float r_spec = rand01(seed, pix, skey, bounce, 2u);

      int m = mat_in[i];
      m = (m < 0 || m >= num_materials) ? 0 : m;
      const float* row = mtab + m * MTAB_COLS;
      const float bc[3] = {row[0], row[1], row[2]};
      const float rough = row[3], metal = row[4], ior = row[5];
      const float emis[3] = {row[6], row[7], row[8]};
      const float transl = row[9];
      const float nv[3] = {nrm_in[3 * i], nrm_in[3 * i + 1], nrm_in[3 * i + 2]};

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
        orig, dir, thr, rad, alive, pix, hit, t, normal, mat, n, mtab,
        num_materials, sample_key, bounce, seed, russian_roulette, o_out,
        d_out, thr_out, rad_out, alive_out);
  }
  return static_cast<int>(cudaGetLastError());
}
