// K1's closest-hit traversal of one ray, shared by K1 (intersect.cu), K5
// (bounce.cu) and K6 (micro.cu), so that all of them find the same winner
// bit for bit.
//
// Each thread walks the binary BVH of accel/tables.py for its own ray with
// a stack in local memory, visits the nearer child first, and runs the
// exact backface-culled Möller–Trumbore test of
// tracy_tpu/render/intersect.py:61-72 on every triangle of a leaf. Every
// attribute of the winner is w*a0 + u*a1 + v*a2 with w = 1-u-v, in
// tracy_tpu/render/integrator.py's order: one ulp of uv can move a texel
// index at a cell edge.

#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace tracy {

constexpr int STACK_MAX = 64;  // accel/tables.py KERNEL_STACK_MAX
constexpr float TRAVERSE_EPS = 1.0e-8f;

// Sign-preserving clamp of tiny direction components before the reciprocal:
// |1/d| <= 1e12, so no infinities reach the slab test.
__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (fabsf(d) < 1.0e-12f ? copysignf(1.0e-12f, d) : d);
}

// Reference RayAABB (collision.h:119-131).
__device__ __forceinline__ bool slab(const float4* __restrict__ nb, int node,
                                     float ox, float oy, float oz, float ix,
                                     float iy, float iz, float best_t,
                                     float* t_enter) {
  const float4 lo = nb[2 * node];
  const float4 hi = nb[2 * node + 1];
  const float x0 = (lo.x - ox) * ix, x1 = (hi.x - ox) * ix;
  const float y0 = (lo.y - oy) * iy, y1 = (hi.y - oy) * iy;
  const float z0 = (lo.z - oz) * iz, z1 = (hi.z - oz) * iz;
  const float tmin = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1));
  const float tmax = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
  *t_enter = tmin;
  return tmax >= fmaxf(TRAVERSE_EPS, tmin) && tmin < best_t;
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
