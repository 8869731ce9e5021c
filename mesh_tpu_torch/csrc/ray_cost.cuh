// The division-free, sign-carried Moller-Trumbore line/triangle predicate
// shared by the ray kernels of mesh_tpu_torch (ray_any_hit.cu,
// alongnormal_faces.cu): the Hopper counterpart of _mt_terms and
// _mt_line_hit in mesh_tpu/query/pallas_ray.py.
//
// With det = e1.(d x e2), every bound of the divided form
//   u >= -beps, v >= -beps, u + v <= 1 + beps
// is multiplied through by |det| (positive), so no pair divides:
//   un >= -beps |det|, vn >= -beps |det|, un + vn <= |det| + beps |det|
// with un = s.(d x e2) sign(det), vn = d.(s x e1) sign(det),
// tn = e2.(s x e1) sign(det) and s = o - a; t = tn / |det|.
//
// The plain PyTorch version (mesh_tpu_torch/query/ray_kernel.py
// mt_line_hit) makes the same operations in the same order; build with
// --fmad=false so that no product and sum fuse.

#pragma once

#include "common.cuh"

namespace mt {

constexpr float kRayEps = 1e-9f;   // |det| below this: the line is parallel
constexpr float kBaryEps = 1e-6f;  // barycentric inclusion tolerance

// jnp.sign: -1, 0 or +1 (sign(0) = 0 zeroes un, vn and tn, where copysignf
// would give +-1)
__device__ __forceinline__ float sign3(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// Whether the line o + t d (t of either sign) meets the triangle with
// corner a and edges e1, e2; also returns ad = |det| and the sign-carried
// numerator tn of t.  eps guards |det|, beps is the barycentric tolerance
// (the ray kernels take the defaults; the segment tests of
// tri_tri_cost.cuh pass 1e-9 for both).
__device__ __forceinline__ bool line_hit(
    float ox, float oy, float oz, float dx, float dy, float dz, float ax,
    float ay, float az, float e1x, float e1y, float e1z, float e2x, float e2y,
    float e2z, float& ad, float& tn, float eps = kRayEps,
    float beps = kBaryEps) {
  // pvec = d x e2
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float sd = sign3(det);
  ad = fabsf(det);
  const float sx = ox - ax, sy = oy - ay, sz = oz - az;
  const float un = (sx * px + sy * py + sz * pz) * sd;
  // qvec = s x e1
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float vn = (dx * qx + dy * qy + dz * qz) * sd;
  tn = (e2x * qx + e2y * qy + e2z * qz) * sd;
  const float tol = beps * ad;
  return (ad >= eps) & (un >= -tol) & (vn >= -tol) & (un + vn <= ad + tol);
}

// Face planes of the ray kernels: a(3) e1(3) e2(3), staged as 3 float4
// (three pads).
struct RayFace {
  static constexpr int kRows = 9;
  static constexpr int kVec = 3;

  __device__ static void stage(const float* c, int n, int j, float* dst) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) dst[r] = c[static_cast<size_t>(r) * n + j];
    dst[9] = dst[10] = dst[11] = 0.0f;
  }

  __device__ static bool hit(float ox, float oy, float oz, float dx, float dy,
                             float dz, const float4* t, float& ad,
                             float& tn) {
    const float4 r0 = t[0], r1 = t[1], r2 = t[2];
    return line_hit(ox, oy, oz, dx, dy, dz, r0.x, r0.y, r0.z, r0.w, r1.x,
                    r1.y, r1.z, r1.w, r2.x, ad, tn);
  }
};

}  // namespace mt
