// Triangle-triangle any-hit on Hopper (sm_90a), every pair: per query
// triangle, the index of the first mesh triangle it intersects (the mesh's
// face count when none), in either pair test of tri_tri_cost.cuh (the
// segment tile, or the Moller tile, valid only when both meshes are
// nondegenerate).  The oracle that chip_smoke.py holds tri_tri_any_hit.cu
// to, flags and first hits; no path launches it.  Its loop, design and
// bound: tri_tri_every.cuh.
//
// Replaces: mesh_tpu/query/pallas_ray.py tri_tri_any_hit_pallas (kernels
// _tri_tri_kernel over _tri_tri_hit_tile, and _moller_tri_tri_kernel over
// _moller_hit): the mesh-vs-mesh predicate behind
// AabbTree.intersections_indices.

#include "tri_tri_every.cuh"

// qplanes [Kq, Q] and fplanes [Kf, F] float32, plane-major (algorithm 0:
// the segment tile, Kq = Kf = 9, query corners and face (a, e1, e2);
// algorithm 1: the Moller tile, Kq = Kf = 13); first [Q] int32, filled with
// F by the caller, receives each query's first intersecting face.  t_lo /
// t_hi bound the segment tile's t (unused by the Moller tile).  Returns the
// launch's CUDA error code.
extern "C" int mt_tri_tri_any_hit_every(const float* qplanes,
                                        const float* fplanes, int* first,
                                        int n_q, int n_f, int algorithm,
                                        float t_lo, float t_hi,
                                        cudaStream_t stream) {
  using namespace mt;
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (n_q <= 0 || n_f <= 0) return 0;
  if (algorithm != 0 && algorithm != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return algorithm == 0
             ? launch_tri_every<SegmentTile>(qplanes, fplanes, first, n_q,
                                             n_f, t_lo, t_hi, stream)
             : launch_tri_every<MollerTile>(qplanes, fplanes, first, n_q,
                                            n_f, t_lo, t_hi, stream);
}
