// Normal-weighted nearest face on Hopper (sm_90a): per query point and
// normal, the face with the least |p - q| + eps (1 - n_q . n_tri), where q
// is the face's closest point and n_tri its unit normal.
//
// Replaces: mesh_tpu/query/pallas_normal_weighted.py
// nearest_normal_weighted_pallas (make_argmin_kernel over _nw_cost_tile).
//
// Bound on the H100: float32 issue.  A pair costs the fast tile's 88
// operations without the degenerate tail and 119 with it (counted in
// csrc/closest_faces.cu; the running argmin's compare and select included)
// plus 8: the normal dot product (5), the square root, 1 - dot and the
// product by eps.  88 bytes of face planes are read once per block of 128
// queries.
//
// What the design does about it: the 19 fast-tile planes of
// csrc/face_cost.cuh (the closest-face kernels' rounding, shared) plus the
// three unit-normal planes are staged in shared memory as 6 float4 per
// face; the query normal rides in the argmin scaffold's per-query vector
// and eps in its scalar parameter, so one build serves every eps.  The
// winner's point is recomputed exactly in PyTorch.

#include "argmin.cuh"
#include "face_cost.cuh"

namespace mt {

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
};

}  // namespace mt

// pts, normals [B, Q, 3] and planes [B, 22, F] float32 (the 19 fast-tile
// planes, then the unit face normal); out [B, Q] int32.  tail: 1 with the
// degenerate-face tail.  Returns the launch's CUDA error code.
extern "C" int mt_normal_weighted_faces(const float* pts,
                                        const float* normals,
                                        const float* planes, int* out,
                                        int n_b, int n_q, int n_faces,
                                        int tail, float eps,
                                        cudaStream_t stream) {
  using namespace mt;
  return tail ? launch_argmin<NormalWeightedCost<true>>(
                    pts, planes, out, n_b, n_q, n_faces, stream, normals, eps)
              : launch_argmin<NormalWeightedCost<false>>(
                    pts, planes, out, n_b, n_q, n_faces, stream, normals,
                    eps);
}
