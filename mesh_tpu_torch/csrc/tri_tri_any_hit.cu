// Triangle-triangle any-hit on Hopper (sm_90a): per query triangle, the
// index of the first mesh triangle it intersects (the mesh's face count
// when none), in either pair test of tri_tri_cost.cuh (the segment tile, or
// the Moller tile, valid only when both meshes are nondegenerate).
//
// Replaces: mesh_tpu/query/pallas_ray.py tri_tri_any_hit_pallas (kernels
// _tri_tri_kernel over _tri_tri_hit_tile, and _moller_tri_tri_kernel over
// _moller_hit): the mesh-vs-mesh predicate behind
// AabbTree.intersections_indices.
//
// Bound on the H100: the float32 instruction rate.  A pair costs 428
// operations in the segment tile and 232 in the Moller tile (counted in
// tri_tri_cost.cuh), plus the loop's exit test; 36 or 52 bytes of face
// planes are read once per block of 128 queries, so memory is far from the
// limit.
//
// What the design does about it: one thread owns one query triangle, held
// in registers (9 or 13 floats), and a block walks a range of the faces in
// tiles staged in shared memory and read by broadcast.  A query set of a
// hand (1,552 triangles) is only 13 blocks of 128, so the faces are split
// across blockIdx.y until the launch has a few blocks per SM; each block
// stops a thread at its query's first hit in its range, stops staging once
// every query of the block has hit (__syncthreads_or, the same decision for
// every thread), and folds the hit's face index into the query's result
// with atomicMin.  The minimum over the ranges is the first hit overall,
// whatever order the blocks run in, and the plain version reproduces it.

#include "tri_tri_cost.cuh"

namespace mt {

constexpr int kTriThreads = 128;  // query triangles per block
constexpr int kTriTile = 128;     // faces staged per shared-memory tile

template <class Tile>
__global__ void __launch_bounds__(kTriThreads)
tri_any_hit_kernel(const float* __restrict__ qplanes,
                   const float* __restrict__ fplanes, int* __restrict__ first,
                   int n_q, int n_f, int per_split, float t_lo, float t_hi) {
  __shared__ float tile[kTriTile * Tile::kFace];
  const int i = blockIdx.x * kTriThreads + threadIdx.x;
  const bool live = i < n_q;
  const int f_begin = blockIdx.y * per_split;
  const int f_end = min(n_f, f_begin + per_split);

  float q[Tile::kQuery];
#pragma unroll
  for (int r = 0; r < Tile::kQuery; ++r) {
    q[r] = live ? qplanes[static_cast<size_t>(r) * n_q + i] : 0.0f;
  }
  // a padding thread starts hit, so it never keeps its block staging
  bool hit = !live;
  int at = -1;
  for (int f0 = f_begin; f0 < f_end; f0 += kTriTile) {
    // also the barrier after every thread's reads of the previous tile
    if (!__syncthreads_or(!hit)) break;
    const int nf = min(kTriTile, f_end - f0);
    for (int k = threadIdx.x; k < nf; k += kTriThreads) {
#pragma unroll
      for (int r = 0; r < Tile::kFace; ++r) {
        tile[k * Tile::kFace + r] =
            fplanes[static_cast<size_t>(r) * n_f + f0 + k];
      }
    }
    __syncthreads();
    for (int k = 0; k < nf && !hit; ++k) {
      if (Tile::hit(q, tile + k * Tile::kFace, t_lo, t_hi)) {
        hit = true;
        at = f0 + k;
      }
    }
  }
  if (live && at >= 0) atomicMin(first + i, at);
}

}  // namespace mt

// qplanes [Kq, Q] and fplanes [Kf, F] float32, plane-major (algorithm 0:
// the segment tile, Kq = Kf = 9, query corners and face (a, e1, e2);
// algorithm 1: the Moller tile, Kq = Kf = 13); first [Q] int32, filled with
// F by the caller, receives each query's first intersecting face.  t_lo /
// t_hi bound the segment tile's t (unused by the Moller tile).  Returns the
// launch's CUDA error code.
extern "C" int mt_tri_tri_any_hit(const float* qplanes, const float* fplanes,
                                  int* first, int n_q, int n_f,
                                  int algorithm, float t_lo, float t_hi,
                                  cudaStream_t stream) {
  using namespace mt;
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (n_q <= 0 || n_f <= 0) return 0;
  if (algorithm != 0 && algorithm != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int q_blocks = (n_q + kTriThreads - 1) / kTriThreads;
  int n_split, per_split;
  face_splits(q_blocks, n_f, kTriTile, &n_split, &per_split);
  const dim3 grid(q_blocks, n_split);
  if (algorithm == 0) {
    tri_any_hit_kernel<SegmentTile><<<grid, kTriThreads, 0, stream>>>(
        qplanes, fplanes, first, n_q, n_f, per_split, t_lo, t_hi);
  } else {
    tri_any_hit_kernel<MollerTile><<<grid, kTriThreads, 0, stream>>>(
        qplanes, fplanes, first, n_q, n_f, per_split, t_lo, t_hi);
  }
  return static_cast<int>(cudaGetLastError());
}
