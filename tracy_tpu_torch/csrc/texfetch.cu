// K3: per-lane texel fetch from the flat texture atlas, one thread per lane.
//
// Replaces tracy_tpu/ops/pallas_texfetch.py::_fetch_kernel (entered through
// fetch_texels, addressed by lane_page_indices and _texel_ij). The TPU
// kernel relays the atlas out into 16x8-texel pages, DMAs each distinct
// page of a packet into VMEM and drains a loop over them, because XLA
// gathers serialise and VMEM cannot hold the atlas. None of that binds a
// GPU thread, which gathers freely: this kernel reads the flat atlas
// directly through the texture tables (texfetch_lane.cuh). Unlike the TPU
// pages, the five slots of a material need not share one size: each slot
// reads its own texture, which is what the JAX package's XLA path
// (sample_nearest) computes.
//
// Per lane (mat_id, the interpolated texture uv, direction, hit, alive) it
// writes one 12-float row (render/texture.py: basecolor rgb, normal rgb,
// roughness, metalness, emissive rgb, pad): a live hit lane every slot its
// material has, a live miss lane the textured sky's emissive texel, and
// zeros elsewhere (the TPU kernel's page = -1).
//
// On the render paths K4 (shade.cu::shade_textured_kernel) fetches the same
// texels itself through the same header, and this kernel is not launched;
// it is the port's counterpart of fetch_texels for callers that want the
// rows.
//
// What bounds it on an H100: memory. Per lane it reads 2-26 bytes of lane
// state and up to five 16-byte texels scattered over a 100-500 MB atlas,
// and writes 48 bytes; the arithmetic is a few dozen flops. The design:
// the block stages tex_table and tex_index in shared memory, so a lane's
// chain material -> texture -> texel has one dependent global load (tables
// too large to stage are read where they lie, through the read-only cache:
// the STAGED = false instance, ops/texfetch.py picks the route); a lane
// issues all of its texel gathers back to back through the read-only path;
// the row leaves as three 16-byte streaming stores (__stcs: written once,
// not read again by this kernel, so kept out of the way of the texels in
// L2).

#include "texfetch_lane.cuh"

namespace {

constexpr int BLOCK = 256;

template <bool STAGED>
__global__ void __launch_bounds__(BLOCK) texfetch_kernel(
    const int* __restrict__ mat_in, const float* __restrict__ uv_in,
    const float* __restrict__ dir, const bool* __restrict__ hit_in,
    const bool* __restrict__ alive_in, int n,
    const float4* __restrict__ tex_data, const int4* __restrict__ tex_table,
    int num_textures, const int* __restrict__ tex_index, int num_materials,
    float4* __restrict__ out) {
  extern __shared__ int4 smem[];  // STAGED: tex_table [K], then tex_index [M, 5]
  constexpr bool LDG = !STAGED;
  tracy::TexTables tt{tex_table, tex_index, num_textures};
  if (STAGED) {
    int* s_index = reinterpret_cast<int*>(smem + num_textures);
    tracy::stage_words(reinterpret_cast<uint32_t*>(smem),
                       reinterpret_cast<const uint32_t*>(tex_table), 4 * num_textures);
    tracy::stage_words(reinterpret_cast<uint32_t*>(s_index),
                       reinterpret_cast<const uint32_t*>(tex_index),
                       tracy::NUM_TEX_SLOTS * num_materials);
    __syncthreads();
    tt = tracy::TexTables{smem, s_index, num_textures};
  }
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;

  long long addr[tracy::NUM_TEX_SLOTS];
#pragma unroll
  for (int s = 0; s < tracy::NUM_TEX_SLOTS; ++s) addr[s] = -1;
  if (alive_in[i]) {
    if (hit_in[i]) {
      int m = mat_in[i];
      m = (m < 0 || m >= num_materials) ? 0 : m;
      const float u = uv_in != nullptr ? uv_in[2 * i] : 0.0f;
      const float v = uv_in != nullptr ? uv_in[2 * i + 1] : 0.0f;
      tracy::hit_addresses<LDG>(tt, m, u, v, addr);
    } else {
      addr[tracy::SLOT_EMISSIVE] =
          tracy::sky_address<LDG>(tt, dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]);
    }
  }
  float4 q[tracy::NUM_TEX_SLOTS];
  tracy::gather_texels<tracy::NUM_TEX_SLOTS>(tex_data, addr, q);
  float row[12];
  tracy::texel_row(q, row);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    __stcs(out + 3 * i + k,
           make_float4(row[4 * k], row[4 * k + 1], row[4 * k + 2], row[4 * k + 3]));
  }
}

}  // namespace

// uv may be null (no material but the sky is textured: uv reads as zero).
// tex_data [P, 4] f32 and out [n, 12] f32 must be 16-byte aligned. smem:
// the tables' bytes (16 K + 20 M) to stage them in shared memory, at most
// the 48 KB a block gets by default (the wrapper checks); 0 reads them
// from global memory.
extern "C" int tracy_texfetch(const int* mat, const float* uv,
                              const float* dir, const bool* hit,
                              const bool* alive, int n, const float* tex_data,
                              const int* tex_table, int num_textures,
                              const int* tex_index, int num_materials,
                              float* out, int smem, void* stream) {
  if (n > 0) {
    const int blocks = (n + BLOCK - 1) / BLOCK;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* data = reinterpret_cast<const float4*>(tex_data);
    const auto* table = reinterpret_cast<const int4*>(tex_table);
    auto* rows = reinterpret_cast<float4*>(out);
    if (smem > 0) {
      texfetch_kernel<true><<<blocks, BLOCK, smem, st>>>(
          mat, uv, dir, hit, alive, n, data, table, num_textures, tex_index, num_materials,
          rows);
    } else {
      texfetch_kernel<false><<<blocks, BLOCK, 0, st>>>(
          mat, uv, dir, hit, alive, n, data, table, num_textures, tex_index, num_materials,
          rows);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
