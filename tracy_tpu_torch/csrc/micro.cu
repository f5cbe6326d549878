// K6: a microbenchmark of K1's leaf visit, timed in isolation.
//
// The Hopper counterpart of tools/tpu_micro.py (its Pallas kernel, main()
// :213), which times the building blocks of the TPU intersect kernel's
// inner loop with a fixed trip count, no BVH and no ray dependencies. Here
// each ray does `iters` visits of leaf (iteration % num_leaves), drawn from
// a few leaves of LEAF triangles in K1's tri / tri_meta layout
// (accel/tables.py), and each variant adds one building block:
//
//   V0   the empty loop: acc += 1e-7 (the loop skeleton);
//   VD   the leaf's three float4 loads per triangle, minimally consumed
//        (acc = min(acc, p0.x + e1.y + e2.z + ox));
//   VMT  + K1's Möller–Trumbore, keeping best t;
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
// (an MT that did not depend on the loop was hoisted out of it).
//
// What bounds it: operations. Each visit tests LEAF triangles, each test at
// least 15 float32 operations (ops/compare.py's OPS_TRI_TEST), and the
// table is tiny. The design spends as few issue slots as it can on
// anything but the test:
//
// - LEAF is a template constant and the leaf loop is unrolled; the leaf
//   comes from a wrapping counter, not `it % num_leaves`.
// - The leaf table (31 x 8 triangles, 11.9 KB) is staged in shared memory
//   once a block and read as warp-uniform 16-byte broadcasts.
// - Each thread carries RAYS rays (ray r of lane l of hardware warp w is
//   32 * (RAYS * w + r) + l, so each of its rays' warps of 32 is one
//   "warp" of the outputs), sharing each triangle's loads and overlapping
//   the rays' dependent chains.
// - The test (`front`, then `back`) contracts each product-sum into
//   __fmaf_rn, which --fmad=false leaves alone, takes the reciprocal with
//   __frcp_rn (correctly rounded, as 1.0f / det is), and branches once
//   after the u and v tests (which imply K1's det and u <= det tests), so a
//   warp leaves a triangle whole unless one of its lanes lies inside it;
//   each thread's rays run their branch-free halves together, before
//   either branch.
//   tools/micro.py::micro_plain rounds each fmaf exactly as the card does
//   (core/math.py::fma), so the plain version still equals the kernel bit
//   for bit. K1's own test (traverse.cuh) is not changed: this is the
//   leaf visit that a later K1 may take, measured alone.
// - A ray improved in a visit iff its best t fell (each hit it takes is
//   strictly nearer): no flag a test.

#include "traverse.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr int LEAF = 8;  // tools/micro.py LEAF_SIZE
constexpr int RAYS = 2;  // rays a thread
enum Variant { V0 = 0, VD = 1, VMT = 2, VACC = 3, VRED = 4, VRES = 5 };

// K1's Möller–Trumbore (traverse.cuh::test_triangle) of one ray against
// the triangle (p0, e1, e2), each dot and cross product's sums contracted
// into fmaf in this order, in two halves: `front`, branch-free, up to
// whether the ray lies inside the triangle, and `back`, which a lane
// inside takes. A thread runs the fronts of all its rays before either
// back, so that their dependent chains share one basic block.
struct Front {
  float det, u, v, qx, qy, qz;
  bool inside;
};

__device__ __forceinline__ Front front(const float4& p0, const float4& e1, const float4& e2,
                                       float ox, float oy, float oz, float dx, float dy,
                                       float dz) {
  const float eps = tracy::TRAVERSE_EPS;
  Front f;
  const float px = __fmaf_rn(dy, e2.z, -(dz * e2.y));
  const float py = __fmaf_rn(dz, e2.x, -(dx * e2.z));
  const float pz = __fmaf_rn(dx, e2.y, -(dy * e2.x));
  f.det = __fmaf_rn(e1.x, px, __fmaf_rn(e1.y, py, e1.z * pz));
  const float tx = ox - p0.x, ty = oy - p0.y, tz = oz - p0.z;
  f.u = __fmaf_rn(tx, px, __fmaf_rn(ty, py, tz * pz));
  f.qx = __fmaf_rn(ty, e1.z, -(tz * e1.y));
  f.qy = __fmaf_rn(tz, e1.x, -(tx * e1.z));
  f.qz = __fmaf_rn(tx, e1.y, -(ty * e1.x));
  f.v = __fmaf_rn(dx, f.qx, __fmaf_rn(dy, f.qy, dz * f.qz));
  // K1's det > eps, u >= eps, u <= det, v >= eps, u + v <= det in three
  // compares: rounding is monotonic, so fl(u + v) <= det with v >= eps > 0
  // gives u <= fl(u + v) <= det, and with u >= eps too det >= fl(2 eps) >
  // eps (NaN and infinity fail or pass both forms alike).
  f.inside = (f.u >= eps) & (f.v >= eps) & (f.u + f.v <= f.det);
  return f;
}

// The rest of the test for a lane inside triangle slot s: a nearer hit
// becomes the winner.
__device__ __forceinline__ void back(const Front& f, const float4& e2, int s, float& best_t,
                                     int& best, float& bu, float& bv) {
  const float eps = tracy::TRAVERSE_EPS;
  const float tn = __fmaf_rn(e2.x, f.qx, __fmaf_rn(e2.y, f.qy, e2.z * f.qz));
  const float inv_det = __frcp_rn(f.det);
  const float t = tn * inv_det;
  if ((t > eps) & (t < best_t)) {
    best_t = t;
    best = s;
    bu = f.u * inv_det;
    bv = f.v * inv_det;
  }
}

// Enough blocks resident for 270,336 rays (an H100's 132 SMs x 2048
// threads at one ray a thread) in one wave: the register cap that gives.
template <int VARIANT>
__global__ void __launch_bounds__(BLOCK, 16 / RAYS) micro_kernel(
    const float* __restrict__ rays, int n, const float4* __restrict__ tri,
    const int4* __restrict__ tmeta, const float* __restrict__ vnormal, int num_leaves,
    int iters, float* __restrict__ out, int* __restrict__ warp_count) {
  extern __shared__ float4 table[];
  for (int k = threadIdx.x; k < num_leaves * LEAF * 3; k += BLOCK) table[k] = tri[k];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int base = ((blockIdx.x * BLOCK + threadIdx.x) >> 5) * 32 * RAYS;
  if (base >= n) return;  // whole warps: the wrapper makes n a multiple of 32
  float ox[RAYS], oy[RAYS], oz[RAYS], dx[RAYS], dy[RAYS], dz[RAYS];
  float acc[RAYS], best_t[RAYS], bu[RAYS], bv[RAYS], nv[RAYS][3];
  int best[RAYS], mat[RAYS], count[RAYS];
#pragma unroll
  for (int r = 0; r < RAYS; ++r) {
    // A ray past n (in the grid's last warp, where n / 32 is not a multiple
    // of RAYS) runs ray 0's lane: the warp stays whole for the vote, and
    // nothing of it is written.
    const int i = base + 32 * r < n ? base + 32 * r + lane : base + lane;
    ox[r] = rays[6 * i];
    oy[r] = rays[6 * i + 1];
    oz[r] = rays[6 * i + 2];
    dx[r] = rays[6 * i + 3];
    dy[r] = rays[6 * i + 4];
    dz[r] = rays[6 * i + 5];
    acc[r] = ox[r];
    best_t[r] = FLT_MAX;
    bu[r] = bv[r] = 0.0f;
    best[r] = -1;
    nv[r][0] = nv[r][1] = nv[r][2] = 0.0f;
    mat[r] = 0;
    count[r] = 0;
  }
  int leaf = 0;
  for (int it = 0; it < iters; ++it) {
    if (VARIANT == V0) {
#pragma unroll
      for (int r = 0; r < RAYS; ++r) acc[r] = acc[r] + 1.0e-7f;
      continue;
    }
    const int first = leaf * LEAF;
    leaf = leaf + 1 == num_leaves ? 0 : leaf + 1;
    // A ray improved in this visit iff its best t fell: each hit it takes
    // is strictly nearer than the one before.
    float start_t[RAYS];
#pragma unroll
    for (int r = 0; r < RAYS; ++r) start_t[r] = best_t[r];
#pragma unroll
    for (int s = 0; s < LEAF; ++s) {
      const int k = 3 * (first + s);
      const float4 p0 = table[k], e1 = table[k + 1], e2 = table[k + 2];
      if (VARIANT == VD) {
#pragma unroll
        for (int r = 0; r < RAYS; ++r) acc[r] = fminf(acc[r], p0.x + e1.y + e2.z + ox[r]);
        continue;
      }
      Front f[RAYS];
#pragma unroll
      for (int r = 0; r < RAYS; ++r) {
        f[r] = front(p0, e1, e2, ox[r], oy[r], oz[r], dx[r], dy[r], dz[r]);
      }
#pragma unroll
      for (int r = 0; r < RAYS; ++r) {
        if (f[r].inside) back(f[r], e2, first + s, best_t[r], best[r], bu[r], bv[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RAYS; ++r) {
      const bool improved = best_t[r] < start_t[r];
      if (VARIANT == VRED && __any_sync(0xffffffffu, improved)) ++count[r];
      if (VARIANT == VRES && improved) {
        const int4 tm = tmeta[best[r]];
        tracy::interp<3>(vnormal, tm, 1.0f - bu[r] - bv[r], bu[r], bv[r], nv[r]);
        mat[r] = tm.w;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RAYS; ++r) {
    const int w0 = base + 32 * r;
    if (w0 >= n) break;
    float* o = out + 8 * (w0 + lane);
    const bool acc_only = VARIANT == V0 || VARIANT == VD;
    o[0] = acc_only ? acc[r] : best_t[r];
    const bool winner = VARIANT >= VACC;
    o[1] = winner ? static_cast<float>(best[r]) : 0.0f;
    o[2] = winner ? bu[r] : 0.0f;
    o[3] = winner ? bv[r] : 0.0f;
    for (int c = 0; c < 3; ++c) o[4 + c] = nv[r][c];
    o[7] = static_cast<float>(mat[r]);
    if (VARIANT == VRED && lane == 0) warp_count[w0 / 32] = count[r];
  }
}

template <int VARIANT>
int launch(const float* rays, int n, const float* tri, const int* tmeta, const float* vnormal,
           int num_leaves, int iters, float* out, int* warp_count, cudaStream_t stream) {
  const size_t table_bytes = static_cast<size_t>(num_leaves) * LEAF * 3 * sizeof(float4);
  if (table_bytes > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = (n / 32 + RAYS - 1) / RAYS;
  const int blocks = (warps * 32 + BLOCK - 1) / BLOCK;
  micro_kernel<VARIANT><<<blocks, BLOCK, table_bytes, stream>>>(
      rays, n, reinterpret_cast<const float4*>(tri), reinterpret_cast<const int4*>(tmeta),
      vnormal, num_leaves, iters, out, warp_count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rays [n, 6] (origin, direction), n a multiple of 32; tri [L*8, 12],
// tmeta [L*8, 4], vnormal [V, 3]; out [n, 8]: (t or acc, slot, u, v, normal
// xyz, material); warp_count [n / 32] (VRED only). leaf_size must be 8 and
// the table at most 48 KB (341 triangles).
extern "C" int tracy_micro(int variant, const float* rays, int n, const float* tri,
                           const int* tmeta, const float* vnormal, int num_leaves,
                           int leaf_size, int iters, float* out, int* warp_count, void* stream) {
  if (n % 32 != 0 || num_leaves <= 0 || leaf_size != LEAF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TRACY_MICRO(V) \
  launch<V>(rays, n, tri, tmeta, vnormal, num_leaves, iters, out, warp_count, st)
  switch (variant) {
    case V0: return TRACY_MICRO(V0);
    case VD: return TRACY_MICRO(VD);
    case VMT: return TRACY_MICRO(VMT);
    case VACC: return TRACY_MICRO(VACC);
    case VRED: return TRACY_MICRO(VRED);
    case VRES: return TRACY_MICRO(VRES);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TRACY_MICRO
}
