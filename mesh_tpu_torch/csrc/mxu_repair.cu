// f32 exact repair of the MXU rung behind the bf16 bound pass, on Hopper
// (sm_90a), by an exact per-warp chunk cull (csrc/mxu_cull.cuh) inside the
// face tiles the screen lets each query tile run.
//
// Replaces: mesh_tpu/query/pallas_closest.py _make_mxu_repair_kernel
// (kernels _kernel_mxu_repair / _kernel_mxu_repair_nodegen, pallas_call in
// _mxu_repair_staged; entry closest_point_pallas_mxu_repair).
//
// A query tile of tile_q queries (in the caller's order) runs face tile t
// of tile_f faces when surv[tile, t] is set: the reference's screen, some
// query of the tile having cert[q, t] <= sqrt(max(ub[q], 0)) with ub and
// cert from mxu_bound.cu (mxu_kernel.survivors, made on the card before
// the launch; the wrapper's rep is its row sum).  Each query's face is the
// lowest-index least MXU-form cost over the faces of the tiles its query
// tile runs: the every-face repair's (mxu_repair_every.cu) bit for bit,
// and so the dense scan's.
//
// Bound on the H100: float32 issue on the pairs the cull lets through, of
// the surviving tiles only: 93 or 124 operations a pair (mxu_faces.cu),
// with a chunk bound (44) per chunk a lane scans in the tiles its warp
// runs, and the seed's scan over the chunks of the tiles its query tile
// runs (11 a chunk, and one pair).

#include "mxu_cull.cuh"

// As mt_mxu_faces (mxu_faces.cu), with surv [n_q / tile_q, ceil(n_faces /
// tile_f)] uint8 and tile_f a multiple of 32.  Returns the launch's CUDA
// error code.
extern "C" int mt_mxu_repair(const float* pts, const int* qorder,
                             const float* rec, const float* chunks,
                             const unsigned char* surv, float* seeds,
                             float* part_d, int* part_i, int* out,
                             int* warp_chunks,
                             int* lane_faces, int* warp_stages, int n_q,
                             int n_faces, int tile_q, int tile_f, int split,
                             int tail, cudaStream_t stream) {
  return mt::launch_mxu_cull<true>(pts, qorder, rec, chunks, surv, seeds,
                                   part_d, part_i, out, warp_chunks,
                                   lane_faces,
                                   warp_stages, n_q, n_faces, tile_q,
                                   tile_f, split, tail, stream);
}
