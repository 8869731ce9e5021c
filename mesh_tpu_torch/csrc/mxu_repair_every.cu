// f32 exact repair of the MXU rung behind the bf16 bound pass, every face
// of each face tile it runs, on Hopper (sm_90a): the oracle that
// chip_smoke.py holds mxu_repair.cu's chunk cull to, bit for bit; no path
// launches it.
//
// Replaces: mesh_tpu/query/pallas_closest.py _make_mxu_repair_kernel
// (kernels _kernel_mxu_repair / _kernel_mxu_repair_nodegen, pallas_call in
// _mxu_repair_staged; entry closest_point_pallas_mxu_repair).
//
// The dense scan of mxu_faces_every.cu (mxu_cost.cuh mxu_scan_kernel, the
// same cost, order and strict <), except that a block of tile_q queries
// runs a face tile of tile_f only when some query of the block has
// cert[q, t] <= sqrt(max(ub[q], 0)), with ub and cert from mxu_bound.cu.
// Every face of a skipped tile is certified farther than some face of the
// mesh, so the result is the dense kernel's bit for bit.  rep[block] is the
// number of tiles the block ran; the decision is per (tile_q, tile_f) block
// with the reference's defaults 256 and 2048, so the repaired/screened
// ratio means what the reference's does.
//
// Bound on the H100: float32 issue on the surviving tiles only: 93 or 124
// operations a pair (mxu_faces_every.cu) times tile_q * tile_f pairs per
// repaired tile; the screen is one compare per query per tile and one
// block vote.  The certificates (n_q x n_tiles floats) are read once.
//
// What the design does: the vote is __syncthreads_or over the block's
// queries, so a skipped tile costs one coalesced read of the certificates
// and a barrier; a repaired one is the dense kernel's chunked shared-memory
// scan.

#include "mxu_cost.cuh"

// pts [n_q, 3] (n_q a multiple of tile_q), rec [n_faces, 24], ub [n_q],
// cert [n_q, ceil(n_faces / tile_f)] float32; out [n_q] int32, rep
// [n_q / tile_q] int32.  Returns the launch's CUDA error code.
extern "C" int mt_mxu_repair_every(const float* pts, const float* rec,
                                   const float* ub, const float* cert,
                                   int* out, int* rep, int n_q, int n_faces,
                                   int tile_q, int tile_f, int tail,
                                   cudaStream_t stream) {
  return mt::launch_mxu_scan<true>(pts, rec, ub, cert, out, rep, n_q,
                                   n_faces, tile_q, tile_f, tail, stream);
}
