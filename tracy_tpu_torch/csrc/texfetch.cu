// K3: per-lane texel fetch from the flat texture atlas, one thread per lane.
//
// Replaces tracy_tpu/ops/pallas_texfetch.py::_fetch_kernel (entered through
// fetch_texels, addressed by lane_page_indices and _texel_ij). The TPU
// kernel relays the atlas out into 16x8-texel pages, DMAs each distinct
// page of a packet into VMEM and drains a loop over them, because XLA
// gathers serialise and VMEM cannot hold the atlas. None of that binds a
// GPU thread, which gathers freely: this kernel reads the flat atlas
// tex_data [P, 4] directly, through tex_table [K, 4] (offset, width,
// height, 0) and tex_index [M, 5]. Unlike the TPU pages, the five slots of
// a material need not share one size: each slot reads its own texture,
// which is what the JAX package's XLA path (sample_nearest) computes.
//
// Per lane (mat_id, the interpolated texture uv, direction, hit, alive) it
// writes one 12-float row (render/texture.py: basecolor rgb, normal rgb,
// roughness, metalness, emissive rgb, pad) as three float4 stores:
//   * a live hit lane: every slot its material has, at the nearest texel
//     of its uv (sample_nearest's f32 math: repeat via frac, v flipped,
//     clipped to the texture, truncated), others zero;
//   * a live miss lane: the sky's (material 0's) emissive equirect texel at
//     uv = (atan2(z, x) / f32(2 pi) + .5, asin(clip(y)) / f32(pi) + .5),
//     if the sky is textured;
//   * anything else: zeros (the TPU kernel's page = -1).
//
// What bounds it on an H100: memory. Per lane it reads 26 bytes of lane
// state, up to five 16-byte texels scattered over a 100-500 MB atlas, and
// writes 48 bytes; the arithmetic is a few dozen flops. The texel reads
// are the cost: neighbouring lanes of a 32x32 screen tile hit neighbouring
// texels, so sectors are shared across a warp and L2 catches repeats. The
// design reads each texel as one 16-byte vector through the read-only path
// and writes the row with three 16-byte stores. Texture objects (hardware
// addressing) and fusing this gather into K4 are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int NUM_SLOTS = 5;
constexpr int TEX_EMISSIVE = 4;
// First column and channel count of each slot (render/texture.py). The
// slot loops are unrolled, so these fold to constants and the row stays in
// registers.
__device__ __forceinline__ int slot_col(int s) {
  return s == 0 ? 0 : s == 1 ? 3 : s == 2 ? 6 : s == 3 ? 7 : 8;
}
__device__ __forceinline__ int slot_nch(int s) { return (s == 2 || s == 3) ? 1 : 3; }
constexpr float TWO_PI_F32 = 6.2831854820251465f;  // float32(2 * pi)
constexpr float PI_F32 = 3.1415927410125732f;      // float32(pi)

// Nearest texel of texture tid at (u, v): render/texture.py::texel_index.
__device__ __forceinline__ float4 sample_nearest(
    const float4* __restrict__ tex_data, const int4* __restrict__ tex_table,
    int tid, float u, float v) {
  const int4 e = tex_table[tid];
  const float wf = static_cast<float>(e.y);
  const float hf = static_cast<float>(e.z);
  const float fu = u - floorf(u);
  const float fv = (1.0f - v) - floorf(1.0f - v);
  const int ii = static_cast<int>(fminf(fmaxf(fu * wf, 0.0f), wf - 1.0f));
  const int jj = static_cast<int>(fminf(fmaxf(fv * hf, 0.0f), hf - 1.0f));
  return __ldg(tex_data + (static_cast<long long>(e.x) +
                           static_cast<long long>(jj) * e.y + ii));
}

__device__ __forceinline__ void put(float* row, int slot, float4 t) {
  const float c[3] = {t.x, t.y, t.z};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k < slot_nch(slot)) row[slot_col(slot) + k] = c[k];
  }
}

__global__ void __launch_bounds__(BLOCK) texfetch_kernel(
    const int* __restrict__ mat_in, const float* __restrict__ uv_in,
    const float* __restrict__ dir, const bool* __restrict__ hit_in,
    const bool* __restrict__ alive_in, int n,
    const float4* __restrict__ tex_data, const int4* __restrict__ tex_table,
    int num_textures, const int* __restrict__ tex_index, int num_materials,
    float4* __restrict__ out) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  float row[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) row[k] = 0.0f;
  if (alive_in[i]) {
    if (hit_in[i]) {
      int m = mat_in[i];
      m = (m < 0 || m >= num_materials) ? 0 : m;
      const float u = uv_in != nullptr ? uv_in[2 * i] : 0.0f;
      const float v = uv_in != nullptr ? uv_in[2 * i + 1] : 0.0f;
#pragma unroll
      for (int s = 0; s < NUM_SLOTS; ++s) {
        const int tid = tex_index[NUM_SLOTS * m + s];
        if (tid >= 0 && tid < num_textures) {
          put(row, s, sample_nearest(tex_data, tex_table, tid, u, v));
        }
      }
    } else {
      const int tid = tex_index[TEX_EMISSIVE];  // the sky: material 0
      if (tid >= 0 && tid < num_textures) {
        const float dx = dir[3 * i], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
        const float su = atan2f(dz, dx) / TWO_PI_F32 + 0.5f;
        const float sv = asinf(fminf(fmaxf(dy, -1.0f), 1.0f)) / PI_F32 + 0.5f;
        put(row, TEX_EMISSIVE, sample_nearest(tex_data, tex_table, tid, su, sv));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out[3 * i + k] = make_float4(row[4 * k], row[4 * k + 1], row[4 * k + 2],
                                 row[4 * k + 3]);
  }
}

}  // namespace

// uv may be null (no material but the sky is textured: uv reads as zero).
// tex_data [P, 4] f32 and out [n, 12] f32 must be 16-byte aligned.
extern "C" int tracy_texfetch(const int* mat, const float* uv,
                              const float* dir, const bool* hit,
                              const bool* alive, int n, const float* tex_data,
                              const int* tex_table, int num_textures,
                              const int* tex_index, int num_materials,
                              float* out, void* stream) {
  if (n > 0) {
    texfetch_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        mat, uv, dir, hit, alive, n, reinterpret_cast<const float4*>(tex_data),
        reinterpret_cast<const int4*>(tex_table), num_textures, tex_index,
        num_materials, reinterpret_cast<float4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
