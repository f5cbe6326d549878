// K1's closest-hit traversal of one ray, shared by K1 (intersect.cu), K5
// (bounce.cu) and K6 (micro.cu), so that all of them find the same winner
// bit for bit.
//
// Each thread walks a BVH of accel/tables.py for its own ray with a stack
// in local memory, nearest child first, and runs the exact backface-culled
// Möller–Trumbore test of tracy_tpu/render/intersect.py:61-72 on every
// triangle of a leaf. `traverse` walks the binary tree (width 2),
// `traverse_wide<W>` the 4-wide one (W = 4, tracy_tpu's default
// pallas_bvh_width) or the 8-wide one (W = 8), and `traverse_bvh<W>`
// picks between them at compile time. Every attribute of the winner is w*a0 + u*a1 + v*a2
// with w = 1-u-v, in tracy_tpu/render/integrator.py's order: one ulp of uv
// can move a texel index at a cell edge.

#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace tracy {

constexpr int STACK_MAX = 64;    // accel/tables.py KERNEL_STACK_MAX
constexpr int STACK4_MAX = 97;   // accel/tables.py KERNEL_STACK4_MAX
constexpr int STACK8_MAX = 148;  // accel/tables.py KERNEL_STACK8_MAX
constexpr float TRAVERSE_EPS = 1.0e-8f;

// Sign-preserving clamp of tiny direction components before the reciprocal:
// |1/d| <= 1e12, so no infinities reach the slab test.
__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (fabsf(d) < 1.0e-12f ? copysignf(1.0e-12f, d) : d);
}

// Reference RayAABB (collision.h:119-131) on the box (lo, hi).
__device__ __forceinline__ bool slab_box(float lox, float loy, float loz,
                                         float hix, float hiy, float hiz,
                                         float ox, float oy, float oz,
                                         float ix, float iy, float iz,
                                         float best_t, float* t_enter) {
  const float x0 = (lox - ox) * ix, x1 = (hix - ox) * ix;
  const float y0 = (loy - oy) * iy, y1 = (hiy - oy) * iy;
  const float z0 = (loz - oz) * iz, z1 = (hiz - oz) * iz;
  const float tmin = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1));
  const float tmax = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
  *t_enter = tmin;
  return tmax >= fmaxf(TRAVERSE_EPS, tmin) && tmin < best_t;
}

// The binary tree's node box: two float4s of node_bounds.
__device__ __forceinline__ bool slab(const float4* __restrict__ nb, int node,
                                     float ox, float oy, float oz, float ix,
                                     float iy, float iz, float best_t,
                                     float* t_enter) {
  const float4 lo = nb[2 * node];
  const float4 hi = nb[2 * node + 1];
  return slab_box(lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, ox, oy, oz, ix, iy, iz,
                  best_t, t_enter);
}

// Möller–Trumbore of the ray against triangle slot s (three float4s:
// p0, e1, e2); on a nearer front-facing hit, takes it as the winner.
// Returns whether it did.
__device__ __forceinline__ bool test_triangle(
    const float4* __restrict__ tri, int s, float ox, float oy, float oz,
    float dx, float dy, float dz, float* best_t, int* best, float* bu,
    float* bv) {
  const float4 p0 = tri[3 * s], e1 = tri[3 * s + 1], e2 = tri[3 * s + 2];
  const float px = dy * e2.z - dz * e2.y;
  const float py = dz * e2.x - dx * e2.z;
  const float pz = dx * e2.y - dy * e2.x;
  const float det = e1.x * px + e1.y * py + e1.z * pz;
  if (!(det > TRAVERSE_EPS)) return false;
  const float tx = ox - p0.x, ty = oy - p0.y, tz = oz - p0.z;
  const float u = tx * px + ty * py + tz * pz;
  if (!(u >= TRAVERSE_EPS && u <= det)) return false;
  const float qx = ty * e1.z - tz * e1.y;
  const float qy = tz * e1.x - tx * e1.z;
  const float qz = tx * e1.y - ty * e1.x;
  const float v = dx * qx + dy * qy + dz * qz;
  if (!(v >= TRAVERSE_EPS && u + v <= det)) return false;
  const float inv_det = 1.0f / det;
  const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
  if (!(t > TRAVERSE_EPS && t < *best_t)) return false;
  *best_t = t;
  *best = s;
  *bu = u * inv_det;
  *bv = v * inv_det;
  return true;
}

// The closest front-facing hit of the ray (o, d) in the BVH: leaves
// best_t (FLT_MAX on a miss), the winner slot best (-1 on a miss) and its
// barycentrics bu, bv (0 on a miss).
__device__ __forceinline__ void traverse(
    const float4* __restrict__ nb, const int4* __restrict__ nm,
    const float4* __restrict__ tri, float ox, float oy, float oz, float dx,
    float dy, float dz, float* best_t, int* best, float* bu, float* bv) {
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  int stack[STACK_MAX];
  int sp = 0;
  int node = 0;
  while (true) {
    const int4 m = nm[node];
    if (m.y > 0) {  // leaf: slots [m.x, m.x + m.y)
      for (int s = m.x; s < m.x + m.y; ++s) {
        test_triangle(tri, s, ox, oy, oz, dx, dy, dz, best_t, best, bu, bv);
      }
    } else {  // inner: children m.x (left) and m.z (right)
      float tl, tr;
      const bool hl = slab(nb, m.x, ox, oy, oz, ix, iy, iz, *best_t, &tl);
      const bool hr = slab(nb, m.z, ox, oy, oz, ix, iy, iz, *best_t, &tr);
      if (hl && hr) {
        // The stack holds at most one far child per tree level, and the
        // wrapper refuses trees deeper than STACK_MAX - 1.
        const bool left_first = tl <= tr;
        stack[sp++] = left_first ? m.z : m.x;
        node = left_first ? m.x : m.z;
        continue;
      }
      if (hl || hr) {
        node = hl ? m.x : m.z;
        continue;
      }
    }
    if (sp == 0) break;
    node = stack[--sp];
  }
}

// One child of a wide node, as the traversal carries it: its reference
// (wide row, or ~first slot of a leaf), its triangle count (> 0 leaf, 0
// inner) and its entry distance.
struct Child {
  int ref;
  int count;
  float t;
};

// Orders children a, b (slots ka, kb) so that a comes first: by entry
// distance, ties by child slot. A missed child carries t = +inf.
__device__ __forceinline__ void order(Child& a, int& ka, Child& b, int& kb) {
  if (b.t < a.t || (b.t == a.t && kb < ka)) {
    const Child c = a;
    a = b;
    b = c;
    const int k = ka;
    ka = kb;
    kb = k;
  }
}

// Sorts a wide node's W children by (entry distance, slot) with a sorting
// network (ops/intersect.py NETWORKS holds the same comparators). The keys
// are distinct, so any sorting network gives this order.
template <int W>
__device__ __forceinline__ void sort_children(Child* c, int* k);

template <>
__device__ __forceinline__ void sort_children<4>(Child* c, int* k) {
  order(c[0], k[0], c[1], k[1]);
  order(c[2], k[2], c[3], k[3]);
  order(c[0], k[0], c[2], k[2]);
  order(c[1], k[1], c[3], k[3]);
  order(c[1], k[1], c[2], k[2]);
}

// The optimal 19-comparator network for 8 keys (depth 6).
template <>
__device__ __forceinline__ void sort_children<8>(Child* c, int* k) {
  order(c[0], k[0], c[2], k[2]);
  order(c[1], k[1], c[3], k[3]);
  order(c[4], k[4], c[6], k[6]);
  order(c[5], k[5], c[7], k[7]);
  order(c[0], k[0], c[4], k[4]);
  order(c[1], k[1], c[5], k[5]);
  order(c[2], k[2], c[6], k[6]);
  order(c[3], k[3], c[7], k[7]);
  order(c[0], k[0], c[1], k[1]);
  order(c[2], k[2], c[3], k[3]);
  order(c[4], k[4], c[5], k[5]);
  order(c[6], k[6], c[7], k[7]);
  order(c[2], k[2], c[4], k[4]);
  order(c[3], k[3], c[5], k[5]);
  order(c[1], k[1], c[4], k[4]);
  order(c[3], k[3], c[6], k[6]);
  order(c[1], k[1], c[2], k[2]);
  order(c[3], k[3], c[4], k[4]);
  order(c[5], k[5], c[6], k[6]);
}

// The W-wide tree of accel/tables.py (`wide`, one row of 2W float4s a
// node: one 128-byte line at W = 4, two at W = 8). Each level is one
// dependent step: the node's 2W float4s load at once (lo.x hi.x lo.y hi.y
// lo.z hi.z of its W children, references, counts), then W slab tests
// (slab_box's operations, so box decisions are the binary kernel's), a
// sorting network by entry distance (ties by child slot), a descent into
// the nearest hit child, and a push of the others far-to-near as
// (reference, count, t_enter). A leaf child is tested when it is reached,
// with the binary kernel's triangle loop. A popped entry whose t_enter is
// no nearer than the best hit found since it was pushed is skipped
// (culling on pop). The wrapper refuses trees whose stack bound
// ((W - 1) * depthW + 1) exceeds the stack. Results as traverse's.
template <int W>
__device__ __forceinline__ void traverse_wide(
    const float4* __restrict__ wide, const float4* __restrict__ tri, float ox,
    float oy, float oz, float dx, float dy, float dz, float* best_t, int* best,
    float* bu, float* bv) {
  static_assert(W == 4 || W == 8, "wide nodes have 4 or 8 children");
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  Child stack[W == 4 ? STACK4_MAX : STACK8_MAX];
  int sp = 0;
  int ref = 0, count = 0;  // the root, a wide inner node
  while (true) {
    if (count > 0) {  // leaf: slots [~ref, ~ref + count)
      const int first = ~ref;
      for (int s = first; s < first + count; ++s) {
        test_triangle(tri, s, ox, oy, oz, dx, dy, dz, best_t, best, bu, bv);
      }
    } else {  // inner: one row of 2W float4s
      const float4* line = wide + 2 * W * ref;
      float f[8 * W];
#pragma unroll
      for (int q = 0; q < 2 * W; ++q) {
        const float4 v = __ldg(line + q);
        f[4 * q] = v.x;
        f[4 * q + 1] = v.y;
        f[4 * q + 2] = v.z;
        f[4 * q + 3] = v.w;
      }
      const float bt = *best_t;
      Child c[W];
      int k[W];
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int cnt = __float_as_int(f[7 * W + j]);
        c[j] = Child{__float_as_int(f[6 * W + j]), cnt, 0.0f};
        k[j] = j;
        // An empty slot (count -1) has an inverted box, which the min/max
        // slab test would hit: its count masks it.
        if (!(slab_box(f[j], f[2 * W + j], f[4 * W + j], f[W + j],
                       f[3 * W + j], f[5 * W + j], ox, oy, oz, ix, iy, iz, bt,
                       &c[j].t) &&
              cnt >= 0)) {
          c[j].t = CUDART_INF_F;
        }
      }
      sort_children<W>(c, k);
      // A hit child's entry distance is finite (|1/d| <= 1e12), so the hit
      // children come first.
      if (c[0].t != CUDART_INF_F) {
#pragma unroll
        for (int j = W - 1; j >= 1; --j) {
          if (c[j].t != CUDART_INF_F) stack[sp++] = c[j];
        }
        ref = c[0].ref;
        count = c[0].count;
        continue;
      }
    }
    bool found = false;
    while (sp > 0) {
      const Child e = stack[--sp];
      if (e.t < *best_t) {
        ref = e.ref;
        count = e.count;
        found = true;
        break;
      }
    }
    if (!found) break;
  }
}

// The tree of width W (2, 4 or 8): K1's and K5's traversal.
template <int W>
__device__ __forceinline__ void traverse_bvh(
    const float4* __restrict__ nb, const int4* __restrict__ nm,
    const float4* __restrict__ wide, const float4* __restrict__ tri, float ox,
    float oy, float oz, float dx, float dy, float dz, float* best_t, int* best,
    float* bu, float* bv) {
  if constexpr (W == 2) {
    traverse(nb, nm, tri, ox, oy, oz, dx, dy, dz, best_t, best, bu, bv);
  } else {
    traverse_wide<W>(wide, tri, ox, oy, oz, dx, dy, dz, best_t, best, bu, bv);
  }
}

// Barycentric interpolation of a per-vertex attribute of width W.
template <int W>
__device__ __forceinline__ void interp(const float* __restrict__ attr, int4 tm,
                                       float w, float u, float v,
                                       float* __restrict__ out) {
  for (int c = 0; c < W; ++c) {
    out[c] = w * attr[W * tm.x + c] + u * attr[W * tm.y + c] +
             v * attr[W * tm.z + c];
  }
}

}  // namespace tracy
