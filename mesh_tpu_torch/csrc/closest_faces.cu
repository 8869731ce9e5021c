// Brute-force closest face per query on Hopper (sm_90a), by an exact
// per-warp chunk cull (csrc/closest_cull.cuh): the main path's kernel.
//
// Replaces: mesh_tpu/query/pallas_closest.py closest_point_pallas (kernel
// _closest_kernel over make_argmin_kernel, reduction="exact", or over
// make_fused_argmin_kernel, reduction="fused"; costs _sqdist_tile_fast ->
// _ericson_tail -> _region_select and _sqdist_tile_safe).  The reference
// folds every face of every tile; this kernel gives the same faces, bit for
// bit, from the chunks of 32 faces a warp of queries needs.
//
// Bound on the H100: float32 issue on the pairs the cull lets through.  A
// pair costs, counted from csrc/face_cost.cuh (each add, multiply, compare,
// logical and select one operation, the fold's compare and select
// included): fast tile 88 without the degenerate tail and 119 with it;
// sliver-safe tile 147 and 151; the fused reduction adds 4.  Around the
// pairs, a lane computes a bound per chunk it scans and a seed (one
// distance per chunk and one pair).  The every-face kernel
// (closest_faces_every.cu) issues every pair at about the SM's instruction
// rate: the cull is what the design does about the bound.

#include "closest_cull.cuh"

namespace {

// The exact fold (fused_tile_f == 0) or the fused packed-key one over the
// tile functor Cost<kTail, kKeepNan>.
template <template <bool, bool> class Cost, bool kTail>
int launch_faces(const float* pts, const int* qorder, const float* planes,
                 const float* recs, int* out, int* warp_chunks,
                 int* lane_faces, int* warp_stages, int n_b, int n_q,
                 int n_faces, int fused_tile_f, cudaStream_t stream) {
  using namespace mt;
  if (fused_tile_f == 0) {
    return launch_cull<Cost<kTail, false>, ExactFold>(
        pts, qorder, planes, recs, out, warp_chunks, lane_faces,
        warp_stages, n_b, n_q, n_faces, 0, stream);
  }
  return launch_cull<Cost<kTail, true>, FusedFold>(
      pts, qorder, planes, recs, out, warp_chunks, lane_faces, warp_stages,
      n_b, n_q, n_faces, fused_tile_f, stream);
}

}  // namespace

// pts [B, Q, 3], qorder [B, Q] int32 (a permutation per mesh), planes
// [B, 19, F] and records [B, ceil(F / 32), 12] float32, out [B, Q] int32;
// warp_chunks [B, ceil(Q / 32)], lane_faces [B, Q] and warp_stages
// [B, ceil(Q / 32)] int32 all null or all set.  variant: 0 fast tile, 1
// sliver-safe tile; tail: 1 with the degenerate-face tail; fused_tile_f: 0
// for the exact reduction, else the fused reduction's power-of-two face
// tile.  Returns the launch's CUDA error code.
extern "C" int mt_closest_faces(const float* pts, const int* qorder,
                                const float* planes, const float* recs,
                                int* out, int* warp_chunks, int* lane_faces,
                                int* warp_stages, int n_b, int n_q,
                                int n_faces, int variant, int tail,
                                int fused_tile_f, cudaStream_t stream) {
  using namespace mt;
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (fused_tile_f < 0 || (fused_tile_f & (fused_tile_f - 1)) != 0 ||
      (warp_chunks == nullptr) != (lane_faces == nullptr) ||
      (warp_chunks == nullptr) != (warp_stages == nullptr) ||
      (variant != 0 && variant != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_b <= 0 || n_q <= 0) return 0;
  if (n_b > 65535 || n_faces <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto launch =
      variant == 0
          ? (tail ? launch_faces<FastCost, true> : launch_faces<FastCost, false>)
          : (tail ? launch_faces<SafeCost, true> : launch_faces<SafeCost, false>);
  return launch(pts, qorder, planes, recs, out, warp_chunks, lane_faces,
                warp_stages, n_b, n_q, n_faces, fused_tile_f, stream);
}
