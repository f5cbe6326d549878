// K1: closest-hit BVH intersection, one thread per ray.
//
// Replaces tracy_tpu/ops/pallas_packet.py::_kernel/_packet_body (entered
// through pallas_intersect). That kernel shares one traversal stack among a
// packet of 4096 rays and DMAs 128-triangle leaf chunks into VMEM, because
// the TPU serialises gathers. A GPU thread gathers freely, so this kernel
// ports the function, not those mechanics: each thread walks a BVH of
// accel/tables.py for its own ray with a stack in local memory, nearest
// child first, and runs the exact backface-culled Möller–Trumbore test of
// tracy_tpu/render/intersect.py:61-72 on every triangle of a leaf. As in
// tracy_tpu (pallas_bvh_width), the tree is binary (width 2,
// tracy::traverse), 4-wide (width 4, the default) or 8-wide (width 8), the
// wide ones walked by tracy::traverse_wide<W>.
//
// What bounds it on an H100: the traversal is a chain of dependent loads
// whose addresses diverge across a warp on secondary rays, so it is bound
// by load latency and divergence, not by arithmetic or DRAM bandwidth. The
// node and triangle tables of a scene of about 100K triangles take a few
// MB and stay in the 50 MB L2. The binary walk pays two dependent steps a
// level (the node's meta, then its children's boxes). The wide walks pay
// one: a 4-wide node is one 128-byte line holding its 4 children's boxes,
// references and counts, loaded as 8 float4s at once, over about half as
// many levels; an 8-wide node is two lines (16 float4s, still one
// dependent step) over about a third as many levels, at the cost of 8 slab
// tests and a 19-comparator sort a node. Both visit the nearest child
// first and skip a popped entry that the best hit since its push has left
// behind. Node compression and ray reordering are later work.
//
// Dead rays (active == false) do no work and return a miss. Outputs per
// ray: t (FLT_MAX on a miss), barycentric u/v, the hit mask, the winner's
// unnormalised interpolated vertex normal, its material id and triangle id;
// on textured scenes also the interpolated texture uv and (with normal maps)
// the unnormalised tangent, as the TPU kernel's has_uv / with_tangent rows
// (pallas_packet.py:448-466). Those two and the width are template
// parameters, so the untextured launch does no extra loads or stores.
// Every attribute is w*a0 + u*a1 + v*a2 with w = 1-u-v, in
// tracy_tpu/render/integrator.py's order: one ulp of uv can move a texel
// index at a cell edge.

#include "traverse.cuh"

namespace {

using tracy::interp;
constexpr int BLOCK = 128;

template <bool UV, bool TANGENT, int W>
__global__ void __launch_bounds__(BLOCK) intersect_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const bool* __restrict__ active, int n, const float4* __restrict__ nb,
    const int4* __restrict__ nm, const float4* __restrict__ wide,
    const float4* __restrict__ tri,
    const int4* __restrict__ tmeta, const int* __restrict__ tri_id,
    const float* __restrict__ vnormal, const float* __restrict__ vuv,
    const float* __restrict__ vtan, float* __restrict__ t_out,
    float* __restrict__ uv_out, bool* __restrict__ mask_out,
    float* __restrict__ n_out, int* __restrict__ mat_out,
    int* __restrict__ tri_out, float* __restrict__ texuv_out,
    float* __restrict__ tan_out) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  float best_t = FLT_MAX, bu = 0.0f, bv = 0.0f;
  int best = -1;
  if (active[i]) {
    tracy::traverse_bvh<W>(nb, nm, wide, tri, orig[3 * i], orig[3 * i + 1],
                           orig[3 * i + 2], dir[3 * i], dir[3 * i + 1],
                           dir[3 * i + 2], &best_t, &best, &bu, &bv);
  }
  t_out[i] = best_t;
  mask_out[i] = best >= 0;
  if (best >= 0) {
    const int4 tm = tmeta[best];
    const float w = 1.0f - bu - bv;
    interp<3>(vnormal, tm, w, bu, bv, n_out + 3 * i);
    if (UV) interp<2>(vuv, tm, w, bu, bv, texuv_out + 2 * i);
    if (TANGENT) interp<3>(vtan, tm, w, bu, bv, tan_out + 3 * i);
    mat_out[i] = tm.w;
    tri_out[i] = tri_id[best];
  } else {
    n_out[3 * i] = n_out[3 * i + 1] = n_out[3 * i + 2] = 0.0f;
    if (UV) texuv_out[2 * i] = texuv_out[2 * i + 1] = 0.0f;
    if (TANGENT) tan_out[3 * i] = tan_out[3 * i + 1] = tan_out[3 * i + 2] = 0.0f;
    mat_out[i] = 0;
    tri_out[i] = 0;
  }
  uv_out[2 * i] = bu;
  uv_out[2 * i + 1] = bv;
}

template <bool UV, bool TANGENT, int W>
void launch(const float* orig, const float* dir, const bool* active, int n,
            const float* nb, const int* nm, const float* wide, const float* tri,
            const int* tmeta, const int* tri_id, const float* vnormal,
            const float* vuv, const float* vtan, float* t_out, float* uv_out,
            bool* mask_out, float* n_out, int* mat_out, int* tri_out,
            float* texuv_out, float* tan_out, cudaStream_t stream) {
  intersect_kernel<UV, TANGENT, W>
      <<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
          orig, dir, active, n, reinterpret_cast<const float4*>(nb),
          reinterpret_cast<const int4*>(nm),
          reinterpret_cast<const float4*>(wide),
          reinterpret_cast<const float4*>(tri),
          reinterpret_cast<const int4*>(tmeta), tri_id, vnormal, vuv, vtan,
          t_out, uv_out, mask_out, n_out, mat_out, tri_out, texuv_out,
          tan_out);
}

template <int W>
void launch_width(const float* orig, const float* dir, const bool* active,
                  int n, const float* nb, const int* nm, const float* wide,
                  const float* tri, const int* tmeta, const int* tri_id,
                  const float* vnormal, const float* vuv, const float* vtan,
                  float* t_out, float* uv_out, bool* mask_out, float* n_out,
                  int* mat_out, int* tri_out, float* texuv_out, float* tan_out,
                  cudaStream_t st) {
  if (vtan != nullptr) {
    launch<true, true, W>(orig, dir, active, n, nb, nm, wide, tri, tmeta,
                             tri_id, vnormal, vuv, vtan, t_out, uv_out,
                             mask_out, n_out, mat_out, tri_out, texuv_out,
                             tan_out, st);
  } else if (vuv != nullptr) {
    launch<true, false, W>(orig, dir, active, n, nb, nm, wide, tri, tmeta,
                              tri_id, vnormal, vuv, vtan, t_out, uv_out,
                              mask_out, n_out, mat_out, tri_out, texuv_out,
                              tan_out, st);
  } else {
    launch<false, false, W>(orig, dir, active, n, nb, nm, wide, tri, tmeta,
                               tri_id, vnormal, vuv, vtan, t_out, uv_out,
                               mask_out, n_out, mat_out, tri_out, texuv_out,
                               tan_out, st);
  }
}

}  // namespace

// width 2 walks nb/nm (the binary tree), width 4 or 8 walks `wide` (the
// wide rows), which must then not be null. vuv/texuv_out and vtan/tan_out
// are null when the scene needs no texture uv or tangent; a tangent without
// uv is refused.
extern "C" int tracy_intersect(const float* orig, const float* dir,
                               const bool* active, int n, const float* nb,
                               const int* nm, const float* wide, int width,
                               const float* tri, const int* tmeta,
                               const int* tri_id, const float* vnormal,
                               const float* vuv, const float* vtan,
                               float* t_out, float* uv_out, bool* mask_out,
                               float* n_out, int* mat_out, int* tri_out,
                               float* texuv_out, float* tan_out,
                               void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((vtan != nullptr && vuv == nullptr) ||
      (width != 2 && width != 4 && width != 8) ||
      (width != 2 && wide == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (width == 8) {
    launch_width<8>(orig, dir, active, n, nb, nm, wide, tri, tmeta, tri_id,
                    vnormal, vuv, vtan, t_out, uv_out, mask_out, n_out,
                    mat_out, tri_out, texuv_out, tan_out, st);
  } else if (width == 4) {
    launch_width<4>(orig, dir, active, n, nb, nm, wide, tri, tmeta, tri_id,
                    vnormal, vuv, vtan, t_out, uv_out, mask_out, n_out,
                    mat_out, tri_out, texuv_out, tan_out, st);
  } else {
    launch_width<2>(orig, dir, active, n, nb, nm, wide, tri, tmeta, tri_id,
                    vnormal, vuv, vtan, t_out, uv_out, mask_out, n_out,
                    mat_out, tri_out, texuv_out, tan_out, st);
  }
  return static_cast<int>(cudaGetLastError());
}
