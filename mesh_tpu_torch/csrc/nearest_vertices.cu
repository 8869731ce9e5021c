// Brute-force nearest mesh vertex per query on Hopper (sm_90a): the vertex
// axis split over a thread-block cluster, several queries a thread, and an
// exact merge of the splits through distributed shared memory.
//
// Replaces: mesh_tpu/query/pallas_closest.py nearest_vertices_pallas
// (make_argmin_kernel over _vertex_sqdist_tile).
//
// For each query of each mesh, the index of the vertex with the least
// squared distance, the lowest index on exact ties.  pts [B, Q, 3] and
// vplanes [B, 3, V] float32, contiguous and centered; out [B, Q] int32.
//
// Bound on the H100: float32 issue.  A pair costs 10 operations (3
// subtractions, 3 multiplies, 2 adds, the fold's compare and select)
// against 12 bytes of vertex read once a block.  Built without FMA, each
// is one instruction, so the SM's 3.345e13 instructions a second need up
// to twice the 67e12 bound.  At the facade's shape (1 x 4096 x 6,890) one
// thread a query over every vertex fills 32 blocks of the 132 SMs.
//
// What the design does about it (nearest_vertices_every.cu, the oracle, is
// the shared argmin scaffold: one query a thread over every vertex):
// - Splits.  The grid is (n_split x the query blocks, B); the n_split
//   blocks of one query block form a thread-block cluster, and its block s
//   folds the contiguous vertex range [s * chunk, (s + 1) * chunk), chunk =
//   ceil(V / n_split).  The wrapper picks n_split and kPer from the shape
//   (closest_kernel.vertex_plan, the fastest of tools/vertex_plan_sweep.py
//   on the card): 12 splits at 1 x 4096, 7 from 8 to 48 x 1024, and 2
//   where the query blocks fill the card already (64 to 256 x 1024; 2
//   measured 1.4% faster than 1 at 256 x 1024).  Clusters above 8 blocks
//   are a size the H100 allows but does not promise to other cards
//   (cudaFuncAttributeNonPortableClusterSizeAllowed).
// - Several queries a thread.  kPer queries a thread, 4 where the query
//   blocks fill the card, else 2 (the same plan), so one 16-byte
//   shared-memory read of a vertex serves kPer pairs.
// - Staging.  Tiles of kTile vertices go to shared memory as one float4 a
//   vertex (x, y, z; w unused) through a cp.async double buffer, tile t + 1
//   copied while tile t is folded.  The copies are of 4 bytes: a row of the
//   [B, 3, V] planes is 16-byte aligned only when V % 4 == 0.
// - The fold.  Each query keeps (best_d, best_i) from (+inf, 0) and takes a
//   vertex only when its cost is strictly below best_d, in increasing index
//   order: the lowest index wins an exact tie and a NaN cost is never taken,
//   as in the oracle.
// - The merge.  Each block packs its queries' results into 64-bit keys
//   (uint64(bits(best_d)) << 32) | best_i in its own shared memory; after a
//   cluster barrier block 0 reads the n_split keys of each of its queries
//   through distributed shared memory, keeps the least and writes its index;
//   a second barrier keeps every block's shared memory alive until then.
//   With n_split = 1 the block writes its indices directly.  The least key
//   is the every-vertex fold's result, for four reasons:
//   1. best_d = dx*dx + dy*dy + dz*dz is never negative and never -0.0 (a
//      product of equal factors is +0.0 or more, and so is a sum of them);
//   2. as unsigned integers, the bits of finite values, of +inf and of NaN
//      order in that order, and the finite ones as their values; a split's
//      best_d is never NaN (the strict < never takes one), so a split with
//      no finite cost keeps its start, key (bits(+inf) << 32) | 0;
//   3. so a query whose costs are all +inf or NaN gets index 0, and at an
//      equal distance the lower index is the lower key (the ranges are
//      contiguous and in index order, so it is also the lower split's);
//   4. that is what the strict-< fold over every vertex from +inf gives
//      (the oracle, argmin.cuh), what the reference's untouched accumulator
//      gives, and what torch.argmin gives in the plain version, where a NaN
//      query makes every cost NaN and the first NaN is index 0.
// - Rounding.  The cost is dx*dx + dy*dy + dz*dz in that order, each
//   operation rounded (--fmad=false), as the plain version computes it, so
//   the indices equal argmin_vertices_plain's bit for bit, ties included.
//   No tensor cores: their form |p|^2 - 2 p.v + |v|^2 rounds differently
//   (in TF32 or bf16 far more), which would move exact ties and near-ties
//   away from the plain version's and the reference's indices.
//
// closest_kernel.argmin_vertices_split_plain is the split and the merge in
// plain PyTorch.

#include <cooperative_groups.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace mt {

constexpr int kThreads = 128;  // threads a block
constexpr int kTile = 256;     // vertices a shared-memory tile
constexpr int kPortableSplit = 8;  // blocks a cluster, the portable most
constexpr int kMaxSplit = 16;      // the H100's most

// Copies vertices [c0, c0 + n) of the [3, n_v] planes `c` into `dst`, one
// float4 a vertex, with every thread's 4-byte cp.async copies.
__device__ __forceinline__ void stage_vertices(const float* c, int n_v,
                                               int c0, int n, float4* dst) {
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const float* src = c + c0 + k;
    float* d = reinterpret_cast<float*>(dst + k);
    cp_async4(d, src);
    cp_async4(d + 1, src + n_v);
    cp_async4(d + 2, src + 2 * static_cast<size_t>(n_v));
  }
}

template <int kPer>
__global__ void __launch_bounds__(kThreads)
nearest_vertices_kernel(const float* __restrict__ pts,
                        const float* __restrict__ vplanes,
                        int* __restrict__ out, int n_q, int n_v,
                        int n_split) {
  __shared__ float4 tile[2][kTile];
  __shared__ unsigned long long keys[kPer * kThreads];
  const int split = blockIdx.x % n_split;
  const int q0 = blockIdx.x / n_split * (kPer * kThreads);
  const int b = blockIdx.y;
  const float* c = vplanes + static_cast<size_t>(b) * 3 * n_v;
  const int chunk = (n_v + n_split - 1) / n_split;
  const int v0 = min(n_v, split * chunk);
  const int v1 = min(n_v, v0 + chunk);

  float px[kPer], py[kPer], pz[kPer], best_d[kPer];
  int best_i[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int q = q0 + j * kThreads + threadIdx.x;
    px[j] = py[j] = pz[j] = 0.0f;
    if (q < n_q) {
      const size_t at = (static_cast<size_t>(b) * n_q + q) * 3;
      px[j] = pts[at];
      py[j] = pts[at + 1];
      pz[j] = pts[at + 2];
    }
    best_d[j] = CUDART_INF_F;
    best_i[j] = 0;
  }

  const int n_tiles = (v1 - v0 + kTile - 1) / kTile;
  if (n_tiles > 0) stage_vertices(c, n_v, v0, min(kTile, v1 - v0), tile[0]);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = v0 + t * kTile;
    if (t + 1 < n_tiles) {
      stage_vertices(c, n_v, c0 + kTile, min(kTile, v1 - c0 - kTile),
                     tile[(t + 1) & 1]);
    }
    cp_async_commit();  // an empty group after the last tile
    cp_async_wait<1>();  // this thread's copies of tile t have landed
    __syncthreads();     // and every other thread's
    const float4* tv = tile[t & 1];
    const int nc = min(kTile, v1 - c0);
#pragma unroll 4
    for (int k = 0; k < nc; ++k) {
      const float4 v = tv[k];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float dx = px[j] - v.x, dy = py[j] - v.y, dz = pz[j] - v.z;
        const float d = dx * dx + dy * dy + dz * dz;
        if (d < best_d[j]) {
          best_d[j] = d;
          best_i[j] = c0 + k;
        }
      }
    }
    __syncthreads();  // every thread is done with the buffer tile t + 2 fills
  }

  if (n_split == 1) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int q = q0 + j * kThreads + threadIdx.x;
      if (q < n_q) out[static_cast<size_t>(b) * n_q + q] = best_i[j];
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    keys[j * kThreads + threadIdx.x] =
        (static_cast<unsigned long long>(__float_as_uint(best_d[j])) << 32) |
        static_cast<unsigned>(best_i[j]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's keys are in its shared memory
  if (cluster.block_rank() == 0) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int slot = j * kThreads + threadIdx.x;
      unsigned long long key = keys[slot];
      for (int s = 1; s < n_split; ++s) {
        const unsigned long long other =
            cluster.map_shared_rank(keys, s)[slot];
        key = other < key ? other : key;
      }
      const int q = q0 + slot;
      if (q < n_q) {
        out[static_cast<size_t>(b) * n_q + q] =
            static_cast<int>(key & 0xffffffffu);
      }
    }
  }
  cluster.sync();  // block 0 has read every block's keys
}

template <int kPer>
cudaError_t launch_nearest(const float* pts, const float* vplanes, int* out,
                           int n_b, int n_q, int n_verts, int n_split,
                           cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kPer) * kThreads;
  const long long blocks = (n_q + per_block - 1) / per_block * n_split;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  if (n_split > kPortableSplit) {
    const cudaError_t err = cudaFuncSetAttribute(
        nearest_vertices_kernel<kPer>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks),
                        static_cast<unsigned>(n_b));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(n_split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, nearest_vertices_kernel<kPer>, pts,
                            vplanes, out, n_q, n_verts, n_split);
}

}  // namespace mt

// per_thread: queries a thread, 2 or 4; n_split: blocks of a cluster
// that share a query block's vertices, 1 to 16 (above 8 a non-portable
// cluster size, which the H100 allows).  Returns the launch's CUDA error
// code.
extern "C" int mt_nearest_vertices(const float* pts, const float* vplanes,
                                   int* out, int n_b, int n_q, int n_verts,
                                   int per_thread, int n_split,
                                   cudaStream_t stream) {
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (n_split < 1 || n_split > mt::kMaxSplit || n_b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_b <= 0 || n_q <= 0) return 0;
  cudaError_t err;
  switch (per_thread) {
    case 2:
      err = mt::launch_nearest<2>(pts, vplanes, out, n_b, n_q, n_verts,
                                  n_split, stream);
      break;
    case 4:
      err = mt::launch_nearest<4>(pts, vplanes, out, n_b, n_q, n_verts,
                                  n_split, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
