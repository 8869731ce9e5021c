// The MXU rung of the closest-point ladder on Hopper: the per-pair costs and
// the query-block scan shared by mxu_faces.cu, mxu_bound.cu and
// mxu_repair.cu, counterparts of _sqdist_tile_mxu, _mxu_ap2_env and the
// argmin scaffolds over them in mesh_tpu/query/pallas_closest.py.
//
// On the TPU the four query-dependent dot products of the fast tile (ab.p,
// ac.p, n.p and a.p) come from one matrix product per tile.  Here they are
// CUDA-core float32 dot products, each written px*gx + py*gy + pz*gz, so
// that the plain PyTorch versions in mesh_tpu_torch/query/mxu_kernel.py can
// repeat them op for op; build with --fmad=false.  The Ericson tail is
// face_cost.cuh's, shared with the fast tile.
//
// Face operand: one contiguous record of kMxuRecord floats per face (the
// port's layout of the reference's G operand and its 11 planes, plus the
// reach), read as kMxuVec float4:
//   0-2 ab   3-5 ac   6-8 n   9-11 a   12 a.ab  13 a.ac  14 a.n  15 a2
//   16 ab2   17 ac2   18 abac 19 inv_ab2  20 inv_ac2  21 inv_bc2  22 inv_n2
//   23 reach = sqrt(max(ab2, ac2))

#pragma once

#include <cuda_bf16.h>

#include "face_cost.cuh"

namespace mt {

constexpr int kMxuRecord = 24;  // floats per face record
constexpr int kMxuVec = kMxuRecord / 4;
constexpr int kMxuChunk = 128;  // faces staged in shared memory at a time
constexpr int kMxuMaxTileQ = 256;
// MXU_BF16_EPS of the reference: the certified envelope of the bf16 screen
constexpr float kMxuBf16Eps = 0.015625f;  // 2^-6

// x rounded to bfloat16 to nearest even (as torch.bfloat16 rounds), back in
// float32
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// min that propagates NaN, as torch.amin and jnp.min do (fminf drops it)
__device__ __forceinline__ float min_nan(float x, float acc) {
  return (x < acc || x != x) ? x : acc;
}

// The MXU tile's squared distance (_sqdist_tile_mxu) of query p (p2 = |p|^2)
// to the face whose record is r.  The corner-a terms come from p's dot
// products and the record's a.ab, a.ac, a.n and a2: ap2 = p2 - 2 p.a + a2,
// clamped at 0, cancels at the scale of |p|^2, so the cost differs from
// the fast tile's only by rounding (argmin tie flips).
template <bool kTail>
__device__ __forceinline__ float mxu_pair(float px, float py, float pz,
                                          float p2, const float4* r) {
  const float4 r0 = r[0], r1 = r[1], r2 = r[2], r3 = r[3], r4 = r[4],
               r5 = r[5];
  const float abx = r0.x, aby = r0.y, abz = r0.z, acx = r0.w;
  const float acy = r1.x, acz = r1.y, nx = r1.z, ny = r1.w;
  const float nz = r2.x, ax = r2.y, ay = r2.z, az = r2.w;
  const float d1 = (px * abx + py * aby + pz * abz) - r3.x;
  const float d2 = (px * acx + py * acy + pz * acz) - r3.y;
  const float n_ap = (px * nx + py * ny + pz * nz) - r3.z;
  const float pa = px * ax + py * ay + pz * az;
  const float ap2 = max0(p2 - (pa + pa) + r3.w);
  return ericson_tail<kTail>(d1, d2, ap2, n_ap, r4.x, r4.y, r4.z, r4.w, r5.x,
                             r5.y, r5.z);
}

// The exact scan of rows 3 and 5.  One block of blockDim.x (tile_q) threads
// owns tile_q consecutive queries, one each; the query count is a multiple
// of tile_q (the wrapper pads with queries at the origin, as the reference
// pads).  The block walks the face tiles [t*tile_f, (t+1)*tile_f) in
// increasing order, staging each in chunks of kMxuChunk records in shared
// memory, and every thread folds the chunk into its (best_d, best_i) with a
// strict <: the lowest index wins an exact tie, with no merge across
// blocks.
//
// kScreen (row 5): before a tile, the block asks whether any of its queries
// has cert[q, t] <= sqrt(max(ub[q], 0)) (__syncthreads_or: the reference's
// jnp.any over the query tile) and skips the tile when none has; it counts
// the tiles it ran into rep[block].  A skipped tile holds no face that can
// win (the bound pass's certificate), so row 5 names exactly row 3's faces:
// same cost, same order, same comparison.
template <bool kTail, bool kScreen>
__global__ void __launch_bounds__(kMxuMaxTileQ)
mxu_scan_kernel(const float* __restrict__ pts, const float* __restrict__ rec,
                const float* __restrict__ ub, const float* __restrict__ cert,
                int* __restrict__ out, int* __restrict__ rep, int n_faces,
                int tile_f, int n_tiles) {
  __shared__ float4 tile[kMxuChunk * kMxuVec];
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const float px = pts[3 * static_cast<size_t>(q)];
  const float py = pts[3 * static_cast<size_t>(q) + 1];
  const float pz = pts[3 * static_cast<size_t>(q) + 2];
  const float p2 = px * px + py * py + pz * pz;
  float su = 0.0f;
  if (kScreen) su = sqrtf(max0(ub[q]));
  const float4* rec4 = reinterpret_cast<const float4*>(rec);

  float best_d = CUDART_INF_F;
  int best_i = 0;
  int repaired = 0;
  for (int t = 0; t < n_tiles; ++t) {
    if (kScreen) {
      const bool keep = cert[static_cast<size_t>(q) * n_tiles + t] <= su;
      if (!__syncthreads_or(keep)) continue;  // block-uniform
      ++repaired;
    }
    const int f1 = min(n_faces, (t + 1) * tile_f);
    for (int c0 = t * tile_f; c0 < f1; c0 += kMxuChunk) {
      const int nc = min(kMxuChunk, f1 - c0);
      __syncthreads();  // every thread is done with the previous chunk
      const float4* src = rec4 + static_cast<size_t>(c0) * kMxuVec;
      for (int k = threadIdx.x; k < nc * kMxuVec; k += blockDim.x) {
        tile[k] = src[k];
      }
      __syncthreads();
      for (int k = 0; k < nc; ++k) {
        const float d = mxu_pair<kTail>(px, py, pz, p2, tile + k * kMxuVec);
        if (d < best_d) {
          best_d = d;
          best_i = c0 + k;
        }
      }
    }
  }
  out[q] = best_i;
  if (kScreen && threadIdx.x == 0) rep[blockIdx.x] = repaired;
}

// Launches the scan on `stream` over n_q queries (a multiple of tile_q)
// and the faces' n_tiles tiles of tile_f; returns cudaGetLastError().
template <bool kScreen>
int launch_mxu_scan(const float* pts, const float* rec, const float* ub,
                    const float* cert, int* out, int* rep, int n_q,
                    int n_faces, int tile_q, int tile_f, int tail,
                    cudaStream_t stream) {
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (tile_q <= 0 || tile_q > kMxuMaxTileQ || tile_q % 32 != 0 ||
      n_q % tile_q != 0 || tile_f <= 0 || n_faces <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_q == 0) return 0;
  const int n_tiles = (n_faces + tile_f - 1) / tile_f;
  const int grid = n_q / tile_q;
  if (tail) {
    mxu_scan_kernel<true, kScreen><<<grid, tile_q, 0, stream>>>(
        pts, rec, ub, cert, out, rep, n_faces, tile_f, n_tiles);
  } else {
    mxu_scan_kernel<false, kScreen><<<grid, tile_q, 0, stream>>>(
        pts, rec, ub, cert, out, rep, n_faces, tile_f, n_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mt
