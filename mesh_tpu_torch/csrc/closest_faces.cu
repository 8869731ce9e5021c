// Brute-force closest face per query on Hopper (sm_90a).
//
// Replaces: mesh_tpu/query/pallas_closest.py closest_point_pallas (kernel
// _closest_kernel over make_argmin_kernel, costs _sqdist_tile_fast ->
// _ericson_tail -> _region_select and _sqdist_tile_safe), exact reduction.
//
// Bound on the H100: float32 issue.  A pair costs, counted from the code
// below (each add, multiply, compare, logical and select one operation,
// the argmin's compare and select included): fast tile 88 without the
// degenerate tail and 119 with it; sliver-safe tile 147 and 151.  The
// main path (256 meshes x 1024 queries x 13776 faces = 3.6e9 pairs) thus
// needs 3.2e11 operations in its default variant, against about 0.27 GB of
// face planes read once: three orders of magnitude above the card's
// bytes-per-operation balance.
//
// What the design does about it: all per-face work that does not depend on
// the query (edges, normal, dot products, reciprocals) is hoisted into the
// 19 planes the PyTorch prologue computes once per face (the sliver-safe
// functor also derives its edges once per face while staging), so the
// inner loop holds only per-pair arithmetic on registers; a face tile is
// read from device memory once per block of 128 queries and from shared
// memory by broadcast loads, so memory stays far from the limit; the
// region chain is straight-line selects, so warps do not diverge.

#include "argmin.cuh"
#include "face_cost.cuh"

// variant: 0 fast tile, 1 sliver-safe tile; tail: 1 with the degenerate-face
// tail.  Returns the launch's CUDA error code.
extern "C" int mt_closest_faces(const float* pts, const float* planes,
                                int* out, int n_b, int n_q, int n_faces,
                                int variant, int tail, cudaStream_t stream) {
  using namespace mt;
  if (variant == 0) {
    return tail ? launch_argmin<FastCost<true>>(pts, planes, out, n_b, n_q,
                                                n_faces, stream)
                : launch_argmin<FastCost<false>>(pts, planes, out, n_b, n_q,
                                                 n_faces, stream);
  }
  if (variant == 1) {
    return tail ? launch_argmin<SafeCost<true>>(pts, planes, out, n_b, n_q,
                                                n_faces, stream)
                : launch_argmin<SafeCost<false>>(pts, planes, out, n_b, n_q,
                                                 n_faces, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
