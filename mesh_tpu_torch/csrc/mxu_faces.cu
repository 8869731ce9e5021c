// Dense closest face per query, the MXU rung's exact scan, on Hopper
// (sm_90a), by an exact per-warp chunk cull (csrc/mxu_cull.cuh).
//
// Replaces: mesh_tpu/query/pallas_closest.py closest_point_pallas_mxu
// (kernels _kernel_mxu / _kernel_mxu_nodegen over _sqdist_tile_mxu ->
// _ericson_tail, pallas_call in _mxu_dense_staged).  The reference folds
// every face of every tile; this kernel gives the same faces, bit for bit,
// as the every-face kernel (mxu_faces_every.cu) from the chunks of 32
// faces a warp of queries needs.
//
// For each query, the index of the face with the least MXU-form Ericson
// squared distance (mxu_cost.cuh mxu_pair), lowest index on exact ties;
// with or without the degenerate-face tail.
//
// Bound on the H100: float32 issue on the pairs the cull lets through.  A
// pair costs, counted from mxu_cost.cuh and face_cost.cuh (each add,
// multiply, compare, logical and select one operation, the argmin's
// compare and select included): the four dot products 20, their corner
// terms and ap2 8, the Ericson tail and region select 63 -> 93 without the
// degenerate tail and 124 with it.  Around the pairs, a lane computes a
// bound per chunk it scans (44 operations: closest_cull.cuh's 41, the
// reach's two adds and the screen's and) and a seed (one distance per
// chunk, 11, and one pair).  The every-face kernel issues every pair at
// close to the SM's instruction rate: the cull is what the design does
// about the bound.

#include "mxu_cull.cuh"

// pts [n_q, 3] (n_q a multiple of tile_q), qorder [n_q] int32 (a
// permutation), rec [n_faces, 24] and chunks [ceil(n_faces / 32), 16]
// float32; seeds [n_q] float32 (scratch); part_d [split, n_q] float32 and
// part_i [split, n_q] int32 for split > 1 (null otherwise); out [n_q]
// int32; warp_chunks [split, n_q /
// 32], lane_faces [split, n_q] and warp_stages [split, n_q / 32] int32 all
// null or all set.  tail: 1 with the degenerate-face tail.  Returns the
// launch's CUDA error code.
extern "C" int mt_mxu_faces(const float* pts, const int* qorder,
                            const float* rec, const float* chunks,
                            float* seeds, float* part_d, int* part_i,
                            int* out,
                            int* warp_chunks, int* lane_faces,
                            int* warp_stages, int n_q, int n_faces,
                            int tile_q, int split, int tail,
                            cudaStream_t stream) {
  return mt::launch_mxu_cull<false>(pts, qorder, rec, chunks, nullptr,
                                    seeds, part_d, part_i, out, warp_chunks,
                                    lane_faces, warp_stages, n_q, n_faces,
                                    tile_q, n_faces, split, tail, stream);
}
