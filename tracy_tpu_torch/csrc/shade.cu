// K2 and K4: one shading bounce of the wavefront, one thread per lane.
//
// K2 (untextured) replaces tracy_tpu/ops/pallas_shade.py::_kernel/
// shade_planes (entered through shade_packets); K4 (textured) replaces
// pallas_shade.py::_kernel_tex (entered through shade_packets_textured).
// As shade_planes serves both TPU kernels, one device function serves both
// here: shade_bounce<TEXTURED>, launched as shade_kernel (K2) and
// shade_textured_kernel (K4). Its per-lane math is tracy::shade_miss and
// tracy::shade_hit (shade_lane.cuh), which K5 (bounce.cu) shares. The
// bounce is the material row lookup,
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

#include "shade_lane.cuh"

namespace {

constexpr int BLOCK = 256;

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
  const float4* tex_row = TEXTURED ? texels + 3 * i : nullptr;
  if (alive_in[i]) {
    if (!hit_in[i]) {
      tracy::shade_miss<TEXTURED>(rad, thr, mtab, tex_row);
    } else {
      const float nv[3] = {nrm_in[3 * i], nrm_in[3 * i + 1], nrm_in[3 * i + 2]};
      alive = tracy::shade_hit<TEXTURED>(
          o, d, thr, rad, t_in[i], nv, mat_in[i],
          static_cast<uint32_t>(pix_in[i]), mtab, num_materials, skey, bounce,
          seed, russian_roulette, tex_row,
          (TEXTURED && tan_in != nullptr) ? tan_in + 3 * i : nullptr);
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
