// K6: a microbenchmark of K1's leaf visit, timed in isolation.
//
// The Hopper counterpart of tools/tpu_micro.py (its Pallas kernel, main()
// :213), which times the building blocks of the TPU intersect kernel's
// inner loop with a fixed trip count, no BVH and no ray dependencies. Here
// one thread per ray does `iters` visits of leaf (iteration % num_leaves),
// drawn from a few leaves of `leaf_size` triangles in K1's tri / tri_meta
// layout (accel/tables.py), and each variant adds one building block:
//
//   V0   the empty loop: acc += 1e-7 (the loop skeleton);
//   VD   the leaf's three float4 loads per triangle, minimally consumed
//        (acc = min(acc, p0.x + e1.y + e2.z + ox));
//   VMT  + K1's Möller–Trumbore (tracy::test_triangle), keeping best t;
//   VACC + keeping the winner's (t, slot, u, v);
//   VRED + a warp vote (__any_sync) on improvement feeding a per-warp
//        counter: the GPU analogue of the TPU kernel's list append, whose
//        vector-to-scalar reduction and scalar write sync the core;
//   VRES VACC + resolving the winner's tri_meta and interpolated vertex
//        normal at each improving visit (the TPU tool's 'fused' leaf visit,
//        which also builds on vacc).
//
// Every variant writes its per-ray outputs, so the compiler cannot drop or
// hoist the loop: tools/tpu_micro.py:12-14 records that trap on the TPU
// (an MT that did not depend on the loop was hoisted out of it). The table
// of a few leaves is tiny and stays in L1: the numbers are the cost of the
// arithmetic and of the L1 loads, not of the memory system.
//
// What bounds it: operations. Each visit tests leaf_size triangles, each
// test at least 15 float32 operations before its first early exit.

#include "traverse.cuh"

namespace {

constexpr int BLOCK = 128;
enum Variant { V0 = 0, VD = 1, VMT = 2, VACC = 3, VRED = 4, VRES = 5 };

template <int VARIANT>
__global__ void __launch_bounds__(BLOCK) micro_kernel(
    const float* __restrict__ rays, int n, const float4* __restrict__ tri,
    const int4* __restrict__ tmeta, const float* __restrict__ vnormal,
    int num_leaves, int leaf_size, int iters, float* __restrict__ out,
    int* __restrict__ warp_count) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;  // the wrapper makes n a multiple of 32: whole warps
  const float ox = rays[6 * i], oy = rays[6 * i + 1], oz = rays[6 * i + 2];
  const float dx = rays[6 * i + 3], dy = rays[6 * i + 4], dz = rays[6 * i + 5];
  float acc = ox;
  float best_t = FLT_MAX, bu = 0.0f, bv = 0.0f;
  int best = -1;
  float nv[3] = {0.0f, 0.0f, 0.0f};
  int mat = 0;
  int count = 0;
  for (int it = 0; it < iters; ++it) {
    if (VARIANT == V0) {
      acc = acc + 1.0e-7f;
      continue;
    }
    const int first = (it % num_leaves) * leaf_size;
    if (VARIANT == VD) {
      for (int s = first; s < first + leaf_size; ++s) {
        const float4 p0 = tri[3 * s], e1 = tri[3 * s + 1], e2 = tri[3 * s + 2];
        acc = fminf(acc, p0.x + e1.y + e2.z + ox);
      }
      continue;
    }
    bool improved = false;
    for (int s = first; s < first + leaf_size; ++s) {
      improved |= tracy::test_triangle(tri, s, ox, oy, oz, dx, dy, dz, &best_t,
                                       &best, &bu, &bv);
    }
    if (VARIANT == VRED && __any_sync(0xffffffffu, improved)) ++count;
    if (VARIANT == VRES && improved) {
      const int4 tm = tmeta[best];
      tracy::interp<3>(vnormal, tm, 1.0f - bu - bv, bu, bv, nv);
      mat = tm.w;
    }
  }
  float* o = out + 8 * i;
  const bool acc_only = VARIANT == V0 || VARIANT == VD;
  o[0] = acc_only ? acc : best_t;
  const bool winner = VARIANT >= VACC;
  o[1] = winner ? static_cast<float>(best) : 0.0f;
  o[2] = winner ? bu : 0.0f;
  o[3] = winner ? bv : 0.0f;
  for (int c = 0; c < 3; ++c) o[4 + c] = nv[c];
  o[7] = static_cast<float>(mat);
  if (VARIANT == VRED && (threadIdx.x & 31) == 0) warp_count[i / 32] = count;
}

template <int VARIANT>
void launch(const float* rays, int n, const float* tri, const int* tmeta,
            const float* vnormal, int num_leaves, int leaf_size, int iters,
            float* out, int* warp_count, cudaStream_t stream) {
  micro_kernel<VARIANT><<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
      rays, n, reinterpret_cast<const float4*>(tri),
      reinterpret_cast<const int4*>(tmeta), vnormal, num_leaves, leaf_size,
      iters, out, warp_count);
}

}  // namespace

// rays [n, 6] (origin, direction), n a multiple of 32; tri [L*leaf_size, 12],
// tmeta [L*leaf_size, 4], vnormal [V, 3]; out [n, 8]: (t or acc, slot, u,
// v, normal xyz, material); warp_count [n / 32] (VRED only).
extern "C" int tracy_micro(int variant, const float* rays, int n,
                           const float* tri, const int* tmeta,
                           const float* vnormal, int num_leaves, int leaf_size,
                           int iters, float* out, int* warp_count,
                           void* stream) {
  if (n % 32 != 0 || num_leaves <= 0 || leaf_size <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TRACY_MICRO_CASE(V)                                                 \
  case V:                                                                   \
    launch<V>(rays, n, tri, tmeta, vnormal, num_leaves, leaf_size, iters,   \
              out, warp_count, st);                                         \
    break;
  switch (variant) {
    TRACY_MICRO_CASE(V0)
    TRACY_MICRO_CASE(VD)
    TRACY_MICRO_CASE(VMT)
    TRACY_MICRO_CASE(VACC)
    TRACY_MICRO_CASE(VRED)
    TRACY_MICRO_CASE(VRES)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TRACY_MICRO_CASE
  return static_cast<int>(cudaGetLastError());
}
