// Brute-force nearest mesh vertex per query on Hopper (sm_90a).
//
// Replaces: mesh_tpu/query/pallas_closest.py nearest_vertices_pallas
// (make_argmin_kernel over _vertex_sqdist_tile).
//
// Bound on the H100: float32 issue, barely.  A pair costs 10 operations
// (3 subtractions, 3 multiplies, 2 adds, the argmin's compare and select)
// against 12 bytes of vertex read once per block of 128 queries, so the
// work is again far above the card's bytes-per-operation balance; but at
// the sizes callers use (one mesh, a few thousand queries) the grid has
// fewer blocks than the card has SMs and the launch itself dominates.
//
// What the design does about it: the shared argmin scaffold stages each
// vertex tile once per block as one float4 per vertex, read by broadcast,
// so the inner loop is the ten operations on registers.

#include "argmin.cuh"

namespace mt {

struct VertexCost {
  static constexpr int kRows = 3;
  static constexpr int kVec = 1;

  __device__ static void stage(const float* c, int n, int j, float* dst) {
    dst[0] = c[j];
    dst[1] = c[static_cast<size_t>(n) + j];
    dst[2] = c[2 * static_cast<size_t>(n) + j];
    dst[3] = 0.0f;
  }

  __device__ static float cost(float px, float py, float pz,
                               const float4* t) {
    const float4 v = t[0];
    const float dx = px - v.x, dy = py - v.y, dz = pz - v.z;
    return dx * dx + dy * dy + dz * dz;
  }
};

}  // namespace mt

// Returns the launch's CUDA error code.
extern "C" int mt_nearest_vertices(const float* pts, const float* vplanes,
                                   int* out, int n_b, int n_q, int n_verts,
                                   cudaStream_t stream) {
  return mt::launch_argmin<mt::VertexCost>(pts, vplanes, out, n_b, n_q,
                                           n_verts, stream);
}
