// Dense closest face per query, the MXU rung's exact scan over every face,
// on Hopper (sm_90a): the oracle that chip_smoke.py holds mxu_faces.cu's
// chunk cull to, bit for bit; no path launches it.
//
// Replaces: mesh_tpu/query/pallas_closest.py closest_point_pallas_mxu
// (kernels _kernel_mxu / _kernel_mxu_nodegen over _sqdist_tile_mxu ->
// _ericson_tail, pallas_call in _mxu_dense_staged).
//
// For each query, the index of the face with the least MXU-form Ericson
// squared distance (mxu_cost.cuh mxu_pair), lowest index on exact ties;
// with or without the degenerate-face tail.
//
// Bound on the H100: float32 issue.  A pair costs, counted from
// mxu_cost.cuh and face_cost.cuh (each add, multiply, compare, logical and
// select one operation, the argmin's compare and select included): the
// four dot products 20, their corner terms and ap2 8, the Ericson tail and
// region select 63 -> 93 without the degenerate tail and 124 with it.  At
// 65,536 queries x 32,512 faces (2.13e9 pairs) that is about 2e11
// operations against 3 MB of face records read once: far above the card's
// bytes-per-operation balance.
//
// What the design does: the reference forms the dot products on the MXU;
// here they are CUDA-core float32 (a tensor-core form would need 3xTF32
// and keeps only the tie contract).  Everything per face that does not
// depend on the query is hoisted into the record the PyTorch prologue
// builds once per mesh; a block stages the records in 12 KB chunks of 128
// faces in shared memory and reads them by broadcast float4 loads, so the
// inner loop is per-pair register arithmetic.  One thread per query keeps
// the argmin in registers, so blocks need no merge.  A block is tile_q
// queries, so 4,096 queries at tile_q 256 fill 16 of the card's 132 SMs.

#include "mxu_cost.cuh"

// pts [n_q, 3] (n_q a multiple of tile_q), rec [n_faces, 24] float32; out
// [n_q] int32.  tail: 1 with the degenerate-face tail.  Returns the launch's
// CUDA error code.
extern "C" int mt_mxu_faces_every(const float* pts, const float* rec,
                                  int* out, int n_q, int n_faces, int tile_q,
                                  int tile_f, int tail, cudaStream_t stream) {
  return mt::launch_mxu_scan<false>(pts, rec, nullptr, nullptr, out, nullptr,
                                    n_q, n_faces, tile_q, tile_f, tail,
                                    stream);
}
