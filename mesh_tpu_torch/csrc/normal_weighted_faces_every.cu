// Normal-weighted nearest face on Hopper (sm_90a), every face of the mesh:
// the oracle that chip_smoke.py holds normal_weighted_faces.cu's chunk cull
// to, bit for bit; no path launches it.  Per query point and normal, the
// face with the least |p - q| + eps (1 - n_q . n_tri), where q is the
// face's closest point and n_tri its unit normal.
//
// Replaces: mesh_tpu/query/pallas_normal_weighted.py
// nearest_normal_weighted_pallas (make_argmin_kernel over _nw_cost_tile).
//
// Bound on the H100: float32 issue.  A pair costs 96 operations without
// the degenerate tail and 127 with it (csrc/nw_cost.cuh); 88 bytes of face
// planes are read once per block of 128 queries.
//
// What the design does about it: the 19 fast-tile planes of
// csrc/face_cost.cuh (the closest-face kernels' rounding, shared) plus the
// three unit-normal planes are staged in shared memory as 6 float4 per
// face by argmin.cuh's scaffold, the query normal in its per-query vector
// and eps in its scalar parameter.  The winner's point is recomputed
// exactly in PyTorch.

#include "argmin.cuh"
#include "nw_cost.cuh"

// pts, normals [B, Q, 3] and planes [B, 22, F] float32 (the 19 fast-tile
// planes, then the unit face normal); out [B, Q] int32.  tail: 1 with the
// degenerate-face tail.  Returns the launch's CUDA error code.
extern "C" int mt_normal_weighted_faces_every(const float* pts,
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
