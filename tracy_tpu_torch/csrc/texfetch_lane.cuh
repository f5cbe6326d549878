// One lane's texel fetch from the flat texture atlas, shared by K3
// (texfetch.cu) and K4 (shade.cu::shade_textured_kernel), so that the
// addresses K4 gathers are the ones K3's exact check against its plain
// version covers.
//
// The atlas is tex_data [P, 4] float32 (one 16-byte texel a row), addressed
// through tex_table [K, 4] int32 (offset, width, height, 0) and tex_index
// [M, 5] int32 (the texture of each material slot, -1 for none). Where the
// tables fit, a block stages both in shared memory (stage_words) so that a
// lane's chain material -> slot -> texture row -> texel has one dependent
// global gather; beyond that the kernels read them where they lie, through
// the read-only cache (the LDG template argument, ld below).
//
// Addresses (render/texture.py::texel_index): nearest texel, repeat via
// frac, v flipped, clipped to the texture, truncated, in float32 in the
// JAX package's operation order. A live hit lane fetches every slot of its
// material whose texture id is in range; a live miss lane the sky's
// (material 0's) emissive texture at the equirect uv of its direction,
// (atan2(z, x) / f32(2 pi) + .5, asin(clip(y)) / f32(pi) + .5). A lane
// issues all of its gathers (at most five 16-byte __ldg loads) back to back
// before it uses the first.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tracy {

constexpr int NUM_TEX_SLOTS = 5;
constexpr int SLOT_EMISSIVE = 4;
constexpr float TWO_PI_F32 = 6.2831854820251465f;  // float32(2 * pi)
constexpr float PI_F32 = 3.1415927410125732f;      // float32(pi)

// First column and channel count of each slot in the 12-float texel row
// (render/texture.py). The slot loops are unrolled, so these fold to
// constants and the row stays in registers.
__device__ __forceinline__ int slot_col(int s) {
  return s == 0 ? 0 : s == 1 ? 3 : s == 2 ? 6 : s == 3 ? 7 : 8;
}
__device__ __forceinline__ int slot_nch(int s) { return (s == 2 || s == 3) ? 1 : 3; }

// One read of a material or texture table: a plain load from the block's
// staged copy in shared memory, or with LDG an __ldg from global memory
// (the tables' global route).
template <bool LDG, class T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (LDG) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// Copy `words` 32-bit words from global memory to shared memory, strided
// over the block's threads. The caller synchronises the block afterwards.
__device__ __forceinline__ void stage_words(uint32_t* dst,
                                            const uint32_t* __restrict__ src,
                                            int words) {
  for (int k = threadIdx.x; k < words; k += blockDim.x) dst[k] = src[k];
}

// The two texture tables: the block's staged copy, or (read with LDG) the
// global arrays.
struct TexTables {
  const int4* table;  // [K]: offset, width, height, 0
  const int* index;   // [M, 5]
  int num_textures;
};

// Flat atlas row of the nearest texel of texture entry e at (u, v).
__device__ __forceinline__ long long texel_address(int4 e, float u, float v) {
  const float wf = static_cast<float>(e.y);
  const float hf = static_cast<float>(e.z);
  const float fu = u - floorf(u);
  const float fv = (1.0f - v) - floorf(1.0f - v);
  const int ii = static_cast<int>(fminf(fmaxf(fu * wf, 0.0f), wf - 1.0f));
  const int jj = static_cast<int>(fminf(fmaxf(fv * hf, 0.0f), hf - 1.0f));
  return static_cast<long long>(e.x) + static_cast<long long>(jj) * e.y + ii;
}

// The atlas row of texture tid at (u, v), -1 when tid is out of range.
template <bool LDG>
__device__ __forceinline__ long long slot_address(const TexTables& tt, int tid,
                                                  float u, float v) {
  return (tid >= 0 && tid < tt.num_textures) ? texel_address(ld<LDG>(tt.table + tid), u, v)
                                             : -1ll;
}

// A live hit lane of material m (in range) at texture uv (u, v): the atlas
// row of each slot, -1 where the material has none.
template <bool LDG>
__device__ __forceinline__ void hit_addresses(const TexTables& tt, int m, float u,
                                              float v, long long addr[NUM_TEX_SLOTS]) {
#pragma unroll
  for (int s = 0; s < NUM_TEX_SLOTS; ++s) {
    addr[s] = slot_address<LDG>(tt, ld<LDG>(tt.index + NUM_TEX_SLOTS * m + s), u, v);
  }
}

// A live miss lane going in direction (dx, dy, dz): the atlas row of the
// sky's emissive texel, -1 when the sky is not textured.
template <bool LDG>
__device__ __forceinline__ long long sky_address(const TexTables& tt, float dx,
                                                 float dy, float dz) {
  const int tid = ld<LDG>(tt.index + SLOT_EMISSIVE);  // material 0
  if (tid < 0 || tid >= tt.num_textures) return -1ll;
  const float su = atan2f(dz, dx) / TWO_PI_F32 + 0.5f;
  const float sv = asinf(fminf(fmaxf(dy, -1.0f), 1.0f)) / PI_F32 + 0.5f;
  return texel_address(ld<LDG>(tt.table + tid), su, sv);
}

// The texel at each address (zero where it is -1), every load issued
// before any is used.
template <int S>
__device__ __forceinline__ void gather_texels(const float4* __restrict__ tex_data,
                                              const long long addr[S], float4 q[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    q[s] = addr[s] >= 0 ? __ldg(tex_data + addr[s]) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// The 12-float texel row (render/texture.py layout) of a hit lane's slots.
__device__ __forceinline__ void texel_row(const float4 q[NUM_TEX_SLOTS], float row[12]) {
#pragma unroll
  for (int k = 0; k < 12; ++k) row[k] = 0.0f;
#pragma unroll
  for (int s = 0; s < NUM_TEX_SLOTS; ++s) {
    const float c[3] = {q[s].x, q[s].y, q[s].z};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k < slot_nch(s)) row[slot_col(s) + k] = c[k];
    }
  }
}

}  // namespace tracy
