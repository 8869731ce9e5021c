// Self-intersection counts on Hopper (sm_90a): for each query face i of a
// mesh, the number of faces j != i that share none of i's vertex indices
// and intersect it, in either pair test of tri_tri_cost.cuh.
//
// Replaces: mesh_tpu/query/pallas_ray.py self_intersection_count_pallas
// (kernel _make_self_intersect_kernel over _tri_tri_hit_tile or
// _moller_hit), the interpenetration check of posed bodies; the count of
// faces with a partner is taken from these counts in PyTorch.
//
// Bound on the H100: the float32 instruction rate.  A pair costs the tile's
// 428 (segment) or 232 (Moller) operations, counted in tri_tri_cost.cuh,
// plus 21 of its own: 9 vertex-index compares and 8 ors, the self test, the
// and with the hit, and the count's add.  Every pair is tested: the count,
// not a flag, is the kernel's result.  36 or 52 bytes of planes and 12 bytes
// of vertex ids per face are read once per block of 128 queries.
//
// What the design does about it: one thread owns one query face (its
// planes and vertex ids in registers), and a block walks a range of the
// mesh's faces in tiles staged in shared memory beside their vertex ids.
// The faces are split across blockIdx.y until the launch has a few blocks
// per SM (an SMPL-sized body is only 108 blocks of 128 queries), and each
// block adds its partial counts with atomicAdd: integer sums, the same in
// any order.  The vertex-sharing and self tests come first, so the pair
// test runs only on the pairs that can count.  A launch takes a range
// [q0, q0 + n_q) of query faces against all faces, so a large mesh can be
// checked a slice at a time.

#include "tri_tri_cost.cuh"

namespace mt {

constexpr int kSelfThreads = 128;  // query faces per block
constexpr int kSelfTile = 128;     // faces staged per shared-memory tile

template <class Tile>
__global__ void __launch_bounds__(kSelfThreads)
self_intersect_kernel(const float* __restrict__ qplanes,
                      const float* __restrict__ fplanes,
                      const int* __restrict__ ids, int* __restrict__ counts,
                      int n_f, int q0, int n_q, int per_split, float t_lo,
                      float t_hi) {
  __shared__ float tile[kSelfTile * Tile::kFace];
  __shared__ int tile_ids[kSelfTile * 3];
  const int local = blockIdx.x * kSelfThreads + threadIdx.x;
  const bool live = local < n_q;
  const int i = q0 + local;
  const int f_begin = blockIdx.y * per_split;
  const int f_end = min(n_f, f_begin + per_split);

  float q[Tile::kQuery];
  int qi0 = -1, qi1 = -1, qi2 = -1;
#pragma unroll
  for (int r = 0; r < Tile::kQuery; ++r) {
    q[r] = live ? qplanes[static_cast<size_t>(r) * n_f + i] : 0.0f;
  }
  if (live) {
    qi0 = ids[static_cast<size_t>(i) * 3];
    qi1 = ids[static_cast<size_t>(i) * 3 + 1];
    qi2 = ids[static_cast<size_t>(i) * 3 + 2];
  }
  int count = 0;
  for (int f0 = f_begin; f0 < f_end; f0 += kSelfTile) {
    const int nf = min(kSelfTile, f_end - f0);
    __syncthreads();  // every thread is done with the previous tile
    for (int k = threadIdx.x; k < nf; k += kSelfThreads) {
#pragma unroll
      for (int r = 0; r < Tile::kFace; ++r) {
        tile[k * Tile::kFace + r] =
            fplanes[static_cast<size_t>(r) * n_f + f0 + k];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        tile_ids[k * 3 + c] = ids[static_cast<size_t>(f0 + k) * 3 + c];
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < nf; ++k) {
      const int m0 = tile_ids[k * 3], m1 = tile_ids[k * 3 + 1],
                m2 = tile_ids[k * 3 + 2];
      const bool shares = (qi0 == m0) | (qi0 == m1) | (qi0 == m2) |
                          (qi1 == m0) | (qi1 == m1) | (qi1 == m2) |
                          (qi2 == m0) | (qi2 == m1) | (qi2 == m2);
      if (!shares && f0 + k != i &&
          Tile::hit(q, tile + k * Tile::kFace, t_lo, t_hi)) {
        ++count;
      }
    }
  }
  if (live && count) atomicAdd(counts + local, count);
}

}  // namespace mt

// qplanes [Kq, F] and fplanes [Kf, F] float32, plane-major, both over the
// mesh's F faces (algorithm 0: the segment tile, the corners and (a, e1,
// e2); algorithm 1: the Moller tile, the same 13 planes on both sides);
// ids [F, 3] int32 vertex indices; counts [n_q] int32, zeroed by the
// caller, receives the counts of the query faces q0 .. q0 + n_q - 1.
// Returns the launch's CUDA error code.
extern "C" int mt_self_intersect(const float* qplanes, const float* fplanes,
                                 const int* ids, int* counts, int n_f, int q0,
                                 int n_q, int algorithm, float t_lo,
                                 float t_hi, cudaStream_t stream) {
  using namespace mt;
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (n_q <= 0 || n_f <= 0) return 0;
  if ((algorithm != 0 && algorithm != 1) || q0 < 0 || q0 + n_q > n_f) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int q_blocks = (n_q + kSelfThreads - 1) / kSelfThreads;
  int n_split, per_split;
  face_splits(q_blocks, n_f, kSelfTile, &n_split, &per_split);
  const dim3 grid(q_blocks, n_split);
  if (algorithm == 0) {
    self_intersect_kernel<SegmentTile><<<grid, kSelfThreads, 0, stream>>>(
        qplanes, fplanes, ids, counts, n_f, q0, n_q, per_split, t_lo, t_hi);
  } else {
    self_intersect_kernel<MollerTile><<<grid, kSelfThreads, 0, stream>>>(
        qplanes, fplanes, ids, counts, n_f, q0, n_q, per_split, t_lo, t_hi);
  }
  return static_cast<int>(cudaGetLastError());
}
