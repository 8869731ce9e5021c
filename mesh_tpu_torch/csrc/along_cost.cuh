// The along-normal cost shared by alongnormal_faces.cu (the chunk cull) and
// alongnormal_faces_every.cu (every face): the Hopper counterpart of
// _alongnormal_cost_tile in mesh_tpu/query/pallas_ray.py.
//
// Per pair, |t| = |tn| / |det| where the line p + t n (t of either sign)
// meets the face (ray_cost.cuh line_hit with its default tolerances), else
// kBig.  About 67 operations: line_hit's 60, |tn|, the ad == 0 guard
// (compare and select), one IEEE division (counted as one operation; it
// issues as a reciprocal with refinement), the miss select, and the fold's
// compare and select.  The plain PyTorch version (ray_kernel.py
// _alongnormal_cost_tile) makes the same operations in the same order.

#pragma once

#include "ray_cost.cuh"

namespace mt {

constexpr float kBig = 1e30f;  // the reference's _BIG: a miss's cost

struct AlongNormalCost : RayFace {
  static constexpr bool kQueryVec = true;

  __device__ static float cost(float px, float py, float pz, float nx,
                               float ny, float nz, float /*param*/,
                               const float4* t) {
    float ad, tn;
    const bool hit = RayFace::hit(px, py, pz, nx, ny, nz, t, ad, tn);
    const float t_abs = fabsf(tn) / (ad == 0.0f ? 1.0f : ad);
    return hit ? t_abs : kBig;
  }
};

}  // namespace mt
