// Nearest face along the query normal on Hopper (sm_90a): per query, the
// face whose hit on the line p + t n (t of either sign) has the least |t|.
//
// Replaces: mesh_tpu/query/pallas_ray.py nearest_alongnormal_pallas
// (make_argmin_kernel over _alongnormal_cost_tile).
//
// Bound on the H100: float32 issue.  A pair costs about 67 operations:
// line_hit's 60 (csrc/ray_cost.cuh), |tn|, the ad == 0 guard (compare and
// select), one IEEE division (counted as one operation; it issues as a
// reciprocal with refinement), the miss select and the running argmin's
// compare and select.  36 bytes of face planes are read once per block of
// 128 queries.
//
// What the design does about it: the shared argmin scaffold
// (csrc/argmin.cuh) stages face tiles in shared memory and keeps the
// running (|t|, face) pair in registers; the query's normal rides in the
// scaffold's per-query vector.  The division stays: the ray parameter
// itself orders the hits.  The exact winner recompute (distance |t| |n|,
// the hit point, +inf for a miss) runs in PyTorch on the winners only.

#include "argmin.cuh"
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

// pts, normals [B, Q, 3] and planes [B, 9, F] float32; out [B, Q] int32.
// Returns the launch's CUDA error code.
extern "C" int mt_alongnormal_faces(const float* pts, const float* normals,
                                    const float* planes, int* out, int n_b,
                                    int n_q, int n_faces,
                                    cudaStream_t stream) {
  return mt::launch_argmin<mt::AlongNormalCost>(pts, planes, out, n_b, n_q,
                                                n_faces, stream, normals);
}
