// K2 and K4: one shading bounce of the wavefront, one thread per lane.
//
// K2 (shade_kernel, untextured) replaces tracy_tpu/ops/pallas_shade.py::
// _kernel/shade_planes (entered through shade_packets). K4
// (shade_textured_kernel) replaces the whole of shade_packets_textured
// (pallas_shade.py:389): the texel fetch of pallas_texfetch.py::
// fetch_texels (_fetch_kernel) and the textured bounce of _kernel_tex, in
// one launch, as that entry point is one jitted graph. Their per-lane math
// is tracy::shade_miss and tracy::shade_hit (shade_lane.cuh), which K5
// (bounce.cu) shares: the material row lookup, Material::Scatter (reference
// material.h:210-268), the sky on misses, radiance += emission *
// throughput, throughput *= attenuation, Russian roulette with p = EPS +
// max(throughput) and a true-division 1/p reweight. The RNG is one of
// tracy_tpu/core/rng.py's four kinds, chosen per launch; under threefry a
// lane's counter is its index in the wave, which is its position in the
// reference's flat pixel array (the wave is shaded whole). K4's texel
// addresses are K3's (texfetch_lane.cuh), and it adds the texture overrides
// and tangent-space normal mapping of apply_textures.
//
// What bounds them on an H100: memory; a few hundred flops a lane.
//
// Both update the state in place, so each lane moves only what its class
// needs (the traffic ops/compare.py's bound counts): a dead lane reads its
// alive flag and nothing else; a miss lane reads hit, throughput and
// radiance (and, in K4, its direction when the sky is textured) and writes
// radiance and alive; a hit lane reads its hit record and state and writes
// the state. Each block stages the material table in shared memory
// (tracy::stage_words), so the per-lane material gather never leaves the
// SM, where the tables fit the 48 KB a block gets by default. Larger
// tables are read where they lie, through the read-only cache: the
// STAGED = false instance of each kernel, which does the same arithmetic
// (ops/launch.py::table_route picks; staging them in opted-in shared
// memory ran 2.5-4.2 x slower on an H100, PERF.md).
//
// K2 (M x 10 floats of material table in shared memory) moves 1 byte for a
// dead lane, 39 for a miss lane and 123 for a hit lane. Once a live lane
// knows its class it issues every load that class needs before any math:
// throughput and radiance, which both classes read, outside the class
// branch, and a hit lane's hit record and the rest of its state right
// after, so they are all in flight together; radiance and alive are
// written outside the branch too. On an H100 80GB HBM3 at 700 W this
// order took 0.097 ms on the 1080p canned wave where loading inside each
// class's branch took 0.113 (PERF.md).
//
// K4 fetches its texels itself: the 48-byte texel row of the old K3 -> K4
// pair never reaches device memory, as a lane gathers its own texels into
// registers. The block stages the material table (M x 16 floats),
// tex_table (K x 4) and tex_index (M x 5) in shared memory, so a lane's
// chain material -> slot
// flags -> texture row -> texel has one dependent global gather, and it
// issues every gather its material needs (up to five 16-byte __ldg loads)
// before it reads its state, so the gathers are in flight while the state
// arrives. A variant that brought the block's float3 state slices into
// shared memory by 1-D bulk asynchronous copies (cp.async.bulk on an
// mbarrier) while the gathers were in flight took the same time on the
// 1080p wave (PERF.md), so plain coalesced loads it is.
//
// Operation order is that of the plain PyTorch versions (ops/shade.py), with
// FMA contraction off at build time, so the two agree to rounding.

#include "shade_lane.cuh"
#include "texfetch_lane.cuh"

namespace {

constexpr int BLOCK = 256;

template <bool STAGED>
__global__ void __launch_bounds__(BLOCK) shade_kernel(
    float* __restrict__ orig, float* __restrict__ dir, float* __restrict__ thr_io,
    float* __restrict__ rad_io, bool* __restrict__ alive_io,
    const int* __restrict__ pix_in, const bool* __restrict__ hit_in,
    const float* __restrict__ t_in, const float* __restrict__ nrm_in,
    const int* __restrict__ mat_in, int n, const float* __restrict__ mtab,
    int num_materials, const tracy::Rng rng, int russian_roulette) {
  // STAGED: mtab [M, 10] f32 in shared memory; else read where it lies.
  extern __shared__ float4 smem[];
  const float* s_mtab = mtab;
  if (STAGED) {
    float* staged = reinterpret_cast<float*>(smem);
    tracy::stage_words(reinterpret_cast<uint32_t*>(staged),
                       reinterpret_cast<const uint32_t*>(mtab),
                       tracy::MTAB_COLS * num_materials);
    __syncthreads();
    s_mtab = staged;
  }
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n || !alive_io[i]) return;
  // Every load the lane's class needs, before any math: both classes read
  // throughput and radiance, a hit lane also its hit record and the rest
  // of its state.
  const bool hit = hit_in[i];
  float thr[3], rad[3], o[3], d[3], nv[3];
  float t = 0.0f;
  int m = 0;
  uint32_t pix = 0u;
  for (int c = 0; c < 3; ++c) {
    thr[c] = thr_io[3 * i + c];
    rad[c] = rad_io[3 * i + c];
  }
  if (hit) {
    for (int c = 0; c < 3; ++c) {
      o[c] = orig[3 * i + c];
      d[c] = dir[3 * i + c];
      nv[c] = nrm_in[3 * i + c];
    }
    t = t_in[i];
    m = mat_in[i];
    pix = static_cast<uint32_t>(pix_in[i]);
  }
  bool alive = false;
  if (hit) {
    alive = tracy::shade_hit<false, !STAGED>(o, d, thr, rad, t, nv, m, pix,
                                    static_cast<uint32_t>(i), s_mtab,
                                    num_materials, rng, russian_roulette,
                                    nullptr, nullptr);
    for (int c = 0; c < 3; ++c) {
      orig[3 * i + c] = o[c];
      dir[3 * i + c] = d[c];
      thr_io[3 * i + c] = thr[c];
    }
  } else {
    tracy::shade_miss<false, !STAGED>(rad, thr, s_mtab, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
  }
  for (int c = 0; c < 3; ++c) rad_io[3 * i + c] = rad[c];
  alive_io[i] = alive;
}

template <bool STAGED>
__global__ void __launch_bounds__(BLOCK) shade_textured_kernel(
    float* __restrict__ orig, float* __restrict__ dir, float* __restrict__ thr_io,
    float* __restrict__ rad_io, bool* __restrict__ alive_io,
    const int* __restrict__ pix_in, const bool* __restrict__ hit_in,
    const float* __restrict__ t_in, const float* __restrict__ nrm_in,
    const float* __restrict__ tan_in, const float* __restrict__ uv_in,
    const int* __restrict__ mat_in, int n, const float* __restrict__ mtab,
    int num_materials, const float4* __restrict__ tex_data,
    const int4* __restrict__ tex_table, int num_textures,
    const int* __restrict__ tex_index, const tracy::Rng rng,
    int russian_roulette) {
  // STAGED: mtab [M, 16] f32, tex_table [K] int4 and tex_index [M, 5] i32
  // in shared memory; else read where they lie.
  extern __shared__ float4 smem[];
  constexpr bool LDG = !STAGED;
  const float* s_mtab = mtab;
  tracy::TexTables tt{tex_table, tex_index, num_textures};
  if (STAGED) {
    float* m_s = reinterpret_cast<float*>(smem);
    int4* t_s = reinterpret_cast<int4*>(smem + (tracy::MTAB_TEX_COLS / 4) * num_materials);
    int* x_s = reinterpret_cast<int*>(t_s + num_textures);
    tracy::stage_words(reinterpret_cast<uint32_t*>(m_s),
                       reinterpret_cast<const uint32_t*>(mtab),
                       tracy::MTAB_TEX_COLS * num_materials);
    tracy::stage_words(reinterpret_cast<uint32_t*>(t_s),
                       reinterpret_cast<const uint32_t*>(tex_table), 4 * num_textures);
    tracy::stage_words(reinterpret_cast<uint32_t*>(x_s),
                       reinterpret_cast<const uint32_t*>(tex_index),
                       tracy::NUM_TEX_SLOTS * num_materials);
    __syncthreads();
    s_mtab = m_s;
    tt = tracy::TexTables{t_s, x_s, num_textures};
  }
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n || !alive_io[i]) return;
  const bool hit = hit_in[i];

  // The gathers first: material, flags and uv, or the sky direction.
  long long addr[tracy::NUM_TEX_SLOTS];
#pragma unroll
  for (int s = 0; s < tracy::NUM_TEX_SLOTS; ++s) addr[s] = -1;
  int m = 0;
  if (hit) {
    m = mat_in[i];
    m = (m < 0 || m >= num_materials) ? 0 : m;
    const float* row = s_mtab + m * tracy::MTAB_TEX_COLS;
    bool textured = false;
#pragma unroll
    for (int s = 0; s < tracy::NUM_TEX_SLOTS; ++s) {
      textured |= tracy::ld<LDG>(row + tracy::HAS_BC + s) > 0.0f;
    }
    if (textured) {
      const float u = uv_in != nullptr ? uv_in[2 * i] : 0.0f;
      const float v = uv_in != nullptr ? uv_in[2 * i + 1] : 0.0f;
      tracy::hit_addresses<LDG>(tt, m, u, v, addr);
    }
  } else if (tracy::ld<LDG>(s_mtab + tracy::HAS_E) > 0.0f) {
    addr[tracy::SLOT_EMISSIVE] =
        tracy::sky_address<LDG>(tt, dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]);
  }
  float4 q[tracy::NUM_TEX_SLOTS];
  tracy::gather_texels<tracy::NUM_TEX_SLOTS>(tex_data, addr, q);

  // Then the state, while the gathers are in flight.
  float thr[3], rad[3];
  for (int c = 0; c < 3; ++c) {
    thr[c] = thr_io[3 * i + c];
    rad[c] = rad_io[3 * i + c];
  }
  bool alive = false;
  if (!hit) {
    tracy::shade_miss<true, LDG>(rad, thr, s_mtab, q[tracy::SLOT_EMISSIVE]);
  } else {
    float o[3], d[3], nv[3];
    for (int c = 0; c < 3; ++c) {
      o[c] = orig[3 * i + c];
      d[c] = dir[3 * i + c];
      nv[c] = nrm_in[3 * i + c];
    }
    const float* tan_lane = tan_in == nullptr ? nullptr : tan_in + 3 * i;
    float tex[12];
    tracy::texel_row(q, tex);
    alive = tracy::shade_hit<true, LDG>(o, d, thr, rad, t_in[i], nv, m,
                                   static_cast<uint32_t>(pix_in[i]),
                                   static_cast<uint32_t>(i), s_mtab,
                                   num_materials, rng, russian_roulette, tex,
                                   tan_lane);
    for (int c = 0; c < 3; ++c) {
      orig[3 * i + c] = o[c];
      dir[3 * i + c] = d[c];
      thr_io[3 * i + c] = thr[c];
    }
  }
  for (int c = 0; c < 3; ++c) rad_io[3 * i + c] = rad[c];
  alive_io[i] = alive;
}

}  // namespace

// K2, in place: orig, dir, thr, rad and alive are read and written. mtab is
// [M, 10]. smem: its bytes, to stage it in shared memory (at most 48 KB;
// the wrapper checks), or 0 to read it from global memory. rng: tracy::RNG_*; keys: the launch's threefry keys (host
// memory, 2 * NUM_DRAWS words), null for the counter hashes.
extern "C" int tracy_shade(float* orig, float* dir, float* thr, float* rad,
                           bool* alive, const int* pix, const bool* hit,
                           const float* t, const float* normal, const int* mat,
                           int n, const float* mtab, int num_materials,
                           uint32_t sample_key, uint32_t bounce, uint32_t seed,
                           int russian_roulette, int rng, const uint32_t* keys,
                           int smem, void* stream) {
  if (n > 0) {
    const int blocks = (n + BLOCK - 1) / BLOCK;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const tracy::Rng r = tracy::make_rng(rng, seed, sample_key, bounce, keys);
    if (smem > 0) {
      shade_kernel<true><<<blocks, BLOCK, smem, st>>>(
          orig, dir, thr, rad, alive, pix, hit, t, normal, mat, n, mtab, num_materials, r,
          russian_roulette);
    } else {
      shade_kernel<false><<<blocks, BLOCK, 0, st>>>(
          orig, dir, thr, rad, alive, pix, hit, t, normal, mat, n, mtab, num_materials, r,
          russian_roulette);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// K4, in place: orig, dir, thr, rad and alive are read and written.
// tangent may be null (no normal maps: read as zero), uv too (no material
// textured, the sky may be: read as zero); mtab is [M, 16]; tex_data
// [P, 4] f32 is 16-byte aligned. smem: the three tables' bytes, to stage
// them in shared memory (at most 48 KB; the wrapper checks), or 0 to read
// them from global memory. rng and keys: as
// tracy_shade's.
extern "C" int tracy_shade_textured(
    float* orig, float* dir, float* thr, float* rad, bool* alive,
    const int* pix, const bool* hit, const float* t, const float* normal,
    const float* tangent, const float* uv, const int* mat, int n,
    const float* mtab, int num_materials, const float* tex_data,
    const int* tex_table, int num_textures, const int* tex_index,
    uint32_t sample_key, uint32_t bounce, uint32_t seed, int russian_roulette,
    int rng, const uint32_t* keys, int smem, void* stream) {
  if (n > 0) {
    const int blocks = (n + BLOCK - 1) / BLOCK;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const tracy::Rng r = tracy::make_rng(rng, seed, sample_key, bounce, keys);
    const auto* data = reinterpret_cast<const float4*>(tex_data);
    const auto* table = reinterpret_cast<const int4*>(tex_table);
    if (smem > 0) {
      shade_textured_kernel<true><<<blocks, BLOCK, smem, st>>>(
          orig, dir, thr, rad, alive, pix, hit, t, normal, tangent, uv, mat, n, mtab,
          num_materials, data, table, num_textures, tex_index, r, russian_roulette);
    } else {
      shade_textured_kernel<false><<<blocks, BLOCK, 0, st>>>(
          orig, dir, thr, rad, alive, pix, hit, t, normal, tangent, uv, mat, n, mtab,
          num_materials, data, table, num_textures, tex_index, r, russian_roulette);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
