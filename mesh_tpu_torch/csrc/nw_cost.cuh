// The normal-weighted cost functor shared by normal_weighted_faces.cu (the
// registration path's chunk cull over closest_cull.cuh) and
// normal_weighted_faces_every.cu (every face, over argmin.cuh), so that both
// round alike: the Hopper counterpart of _nw_cost_tile in
// mesh_tpu/query/pallas_normal_weighted.py.  The plain PyTorch version
// (mesh_tpu_torch/query/normal_weighted.py _nw_cost_tile) makes the same
// operations in the same order; build with --fmad=false.
//
// A pair costs the fast tile's 88 operations without the degenerate tail
// and 119 with it (csrc/face_cost.cuh fast_pair; the running argmin's
// compare and select included) plus 8: the normal dot product (5), the
// square root, 1 - dot and the product by eps.  The query normal rides in
// the scaffolds' per-query vector and eps in their scalar parameter, so one
// build serves every eps.

#pragma once

#include "face_cost.cuh"

namespace mt {

// The penalty floor's rounding up of the norms it multiplies
// (normal_weighted_faces.cu, item 7): the factor 1 + 2^-18, then absolute
// terms above the underflow of a norm's squares and of the dot product's
// products.  All three are float32 values.
constexpr float kNormUp = 1.0f + 0x1p-18f;
constexpr float kNormTiny = 0x1p-64f;
constexpr float kDotTiny = 0x1p-100f;

// Planes: the 19 fast-tile planes, then the unit face normal, staged as 6
// float4 (two pads).
template <bool kTail>
struct NormalWeightedCost {
  static constexpr int kRows = 22;
  static constexpr int kVec = 6;
  static constexpr bool kQueryVec = true;

  __device__ static void stage(const float* c, int n, int j, float* dst) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) dst[r] = c[static_cast<size_t>(r) * n + j];
    dst[22] = dst[23] = 0.0f;
  }

  __device__ static float cost(float px, float py, float pz, float nx,
                               float ny, float nz, float eps,
                               const float4* t) {
    const float4 r0 = t[0], r1 = t[1], r2 = t[2], r3 = t[3], r4 = t[4],
                 r5 = t[5];
    const float d2 = fast_pair<kTail>(px, py, pz, r0.x, r0.y, r0.z, r0.w,
                                      r1.x, r1.y, r1.z, r1.w, r2.x, r2.y,
                                      r2.z, r2.w, r3.x, r3.y, r3.z, r3.w,
                                      r4.x, r4.y, r4.z);
    const float ndot = nx * r4.w + ny * r5.x + nz * r5.y;
    return sqrtf(d2) + eps * (1.0f - ndot);
  }

  // P_lo, a lane's floor under every face's computed penalty
  // eps (1 - n . n_tri) (normal_weighted_faces.cu, items 6 and 7): hi
  // bounds the computed |n . n_tri| from |n| rounded up and the mesh's
  // bound on |n_tri|; eps >= 0 takes 1 - hi, eps < 0 takes 1 + hi.  NaN
  // propagates.
  __device__ static float lane_floor(float nx, float ny, float nz, float eps,
                                     float bound) {
    const float norm = sqrtf(nx * nx + ny * ny + nz * nz);
    const float up = norm * kNormUp + kNormTiny;
    const float hi = (up * bound) * kNormUp + kDotTiny;
    return eps * (1.0f - (eps >= 0.0f ? hi : -hi));
  }

  // A lane's lower bound on the computed costs of a chunk from its
  // squared bound lb2 (closest_cull.cuh cull_lb2): sqrt(max(lb2, 0)) +
  // P_lo, and -inf (always needed) where lb2 is -inf or NaN.
  __device__ static float lower(float lb2, float lane) {
    return lb2 > -CUDART_INF_F ? sqrtf(max0(lb2)) + lane : -CUDART_INF_F;
  }
};

// The cull's staging (closest_cull.cuh): the 22 planes, in order.
template <bool kTail>
struct Staging<NormalWeightedCost<kTail>> {
  static constexpr int kCopy = 22;
  __device__ static int row(int i) { return i; }
  __device__ static int slot(int i) { return i; }
  static constexpr bool kDerive = false;
  __device__ static void derive(float*) {}
};

}  // namespace mt
