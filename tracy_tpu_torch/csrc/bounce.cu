// K5: one whole untextured bounce in one kernel, one thread per lane.
//
// Replaces tracy_tpu/ops/pallas_packet.py::pallas_trace_bounce (its
// `_kernel` run with `shade=`): the TPU's fused bounce megakernel, K1 and K2
// in one kernel so that the hit record never goes to memory. Here a live
// lane runs K1's traversal (tracy::traverse_bvh<W>: the 4-wide tree, the
// default, the 8-wide or the binary one; traverse.cuh), interpolates
// the winner's normal and reads its material, and runs K2's bounce
// (tracy::shade_miss / tracy::shade_hit, shade_lane.cuh), all in registers.
// It writes only the next state (origin, direction, throughput, radiance,
// alive). Dead lanes pass through unchanged. Under rng 'threefry' a lane
// draws at its position in the wave: its own index, or, under compaction
// (accel/reorder.py::compact_bounce), the wave position of the lane its
// slot holds, read from `pos` (an int32 plane read only by hit lanes, and
// only under threefry). Since the three kernels share
// their device functions and the build turns FMA contraction off, K5's next
// state equals K1 followed by K2 on the same lanes bit for bit.
//
// Untextured scenes only: tracy_tpu refuses tables with uv or tangent
// (pallas_packet.py:2311), and so does tracy_bounce.
//
// What bounds it on an H100: the traversal, as for K1 (a chain of dependent
// loads that diverge across a warp; the tables stay in the 50 MB L2). Fusing
// saves the hit record's round trip through device memory (t, uv, mask,
// normal, material and triangle id: about 33 bytes a lane written by K1 and
// read back by K2) and one launch per bounce, and costs registers: the
// shading math now lives beside the traversal stack.

#include "shade_lane.cuh"
#include "traverse.cuh"

namespace {

constexpr int BLOCK = 128;

template <int W>
__global__ void __launch_bounds__(BLOCK) bounce_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ thr_in, const float* __restrict__ rad_in,
    const bool* __restrict__ alive_in, const int* __restrict__ pix_in,
    const int* __restrict__ pos_in, int n,
    const float4* __restrict__ nb, const int4* __restrict__ nm,
    const float4* __restrict__ wide, const float4* __restrict__ tri,
    const int4* __restrict__ tmeta,
    const float* __restrict__ vnormal, const float* __restrict__ mtab,
    int num_materials, const tracy::Rng rng, int russian_roulette,
    float* __restrict__ o_out,
    float* __restrict__ d_out, float* __restrict__ thr_out,
    float* __restrict__ rad_out, bool* __restrict__ alive_out) {
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
  if (alive_in[i]) {
    float best_t = FLT_MAX, bu = 0.0f, bv = 0.0f;
    int best = -1;
    tracy::traverse_bvh<W>(nb, nm, wide, tri, o[0], o[1], o[2], d[0], d[1],
                           d[2], &best_t, &best, &bu, &bv);
    if (best < 0) {
      tracy::shade_miss<false>(rad, thr, mtab, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    } else {
      const int4 tm = tmeta[best];
      float nv[3];
      tracy::interp<3>(vnormal, tm, 1.0f - bu - bv, bu, bv, nv);
      const uint32_t pos = static_cast<uint32_t>(pos_in != nullptr ? pos_in[i] : i);
      alive = tracy::shade_hit<false>(
          o, d, thr, rad, best_t, nv, tm.w, static_cast<uint32_t>(pix_in[i]),
          pos, mtab, num_materials, rng, russian_roulette, nullptr, nullptr);
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

template <int W>
void launch(const float* orig, const float* dir, const float* thr,
            const float* rad, const bool* alive, const int* pix, const int* pos,
            int n, const float* nb, const int* nm, const float* wide,
            const float* tri, const int* tmeta, const float* vnormal,
            const float* mtab, int num_materials, const tracy::Rng& rng,
            int russian_roulette, float* o_out, float* d_out, float* thr_out,
            float* rad_out, bool* alive_out, cudaStream_t stream) {
  bounce_kernel<W><<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
      orig, dir, thr, rad, alive, pix, pos, n, reinterpret_cast<const float4*>(nb),
      reinterpret_cast<const int4*>(nm), reinterpret_cast<const float4*>(wide),
      reinterpret_cast<const float4*>(tri),
      reinterpret_cast<const int4*>(tmeta), vnormal, mtab, num_materials, rng,
      russian_roulette, o_out, d_out, thr_out, rad_out, alive_out);
}

}  // namespace

// width 2 walks nb/nm (the binary tree), width 4 or 8 walks `wide` (the
// wide rows), which must then not be null: as tracy_intersect. vuv and
// vtan are the tables' texture uv and tangent: K5 is untextured and refuses
// them when they are not null. rng: tracy::RNG_*; keys: the launch's
// threefry keys (host memory, 2 * NUM_DRAWS words), null for the counter
// hashes; pos: each slot's position in the wave for threefry, null for the
// slots' own indices.
extern "C" int tracy_bounce(const float* orig, const float* dir,
                            const float* thr, const float* rad,
                            const bool* alive, const int* pix, const int* pos, int n,
                            const float* nb, const int* nm, const float* wide,
                            int width, const float* tri, const int* tmeta,
                            const float* vnormal, const float* vuv,
                            const float* vtan, const float* mtab,
                            int num_materials, uint32_t sample_key,
                            uint32_t bounce, uint32_t seed,
                            int russian_roulette, int rng, const uint32_t* keys,
                            float* o_out, float* d_out,
                            float* thr_out, float* rad_out, bool* alive_out,
                            void* stream) {
  if (vuv != nullptr || vtan != nullptr ||
      (width != 2 && width != 4 && width != 8) ||
      (width != 2 && wide == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const tracy::Rng r = tracy::make_rng(rng, seed, sample_key, bounce, keys);
    if (width == 8) {
      launch<8>(orig, dir, thr, rad, alive, pix, pos, n, nb, nm, wide, tri,
                tmeta, vnormal, mtab, num_materials, r, russian_roulette,
                o_out, d_out, thr_out, rad_out, alive_out, st);
    } else if (width == 4) {
      launch<4>(orig, dir, thr, rad, alive, pix, pos, n, nb, nm, wide, tri,
                tmeta, vnormal, mtab, num_materials, r, russian_roulette,
                o_out, d_out, thr_out, rad_out, alive_out, st);
    } else {
      launch<2>(orig, dir, thr, rad, alive, pix, pos, n, nb, nm, wide, tri,
                tmeta, vnormal, mtab, num_materials, r, russian_roulette,
                o_out, d_out, thr_out, rad_out, alive_out, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
