// Running min/argmin scaffold shared by the brute-force query kernels of
// mesh_tpu_torch: the Hopper counterpart of make_argmin_kernel in
// mesh_tpu/query/pallas_closest.py.
//
// One thread owns one query; blockIdx.x picks a block of kThreads queries
// and blockIdx.y the mesh of the batch.  The block walks the mesh's
// columns (faces or vertices) in tiles of kTileCols: its threads copy each
// tile's per-column planes from device memory into shared memory, laid out
// as kVec float4 per column so the cost functor reads a column with kVec
// broadcast 16-byte loads, and after __syncthreads every thread folds the
// tile into its registers in increasing column order.  The exact fold
// keeps (best_d, best_i) with a strict <, which keeps the lowest index on
// exact ties, the reference's tie rule, with no merge across blocks; the
// fused fold (closest_faces' reduction="fused") keeps a packed key.  The
// ragged last tile is masked by its column count, so no padding columns
// exist.
//
// A cost functor provides
//   kRows                      planes per column in device memory
//   kVec                       float4 per column in shared memory
//   stage(cols, n, j, dst)     copy column j of the [kRows, n] planes into
//                              dst[0 .. 4*kVec), deriving what it likes
//   cost(px, py, pz, src)      the pair's cost from the staged column
// and, when it also reads a per-query vector (a ray direction, a query
// normal) and the launch's scalar parameter, kQueryVec = true and
//   cost(px, py, pz, nx, ny, nz, param, src)
// instead of the four-argument cost.
//
// Operands: pts [B, Q, 3] (and vecs [B, Q, 3] for a kQueryVec functor) and
// cols [B, kRows, N], float32, contiguous; out [B, Q] int32.  Build with
// --fmad=false: the plain PyTorch versions round every product and sum
// separately, and so must the kernels for the two to pick the same columns.
//
// The running minimum starts at +inf where the reference's starts at its
// _BIG (1e30): a column whose cost is exactly _BIG (the along-normal
// functor's miss) then wins only while nothing is below it, so a query with
// no finite cost gets column 0, as the reference's untouched accumulator
// gives it, and as torch.argmin gives the plain versions.

#pragma once

#include <climits>
#include <type_traits>

#include "common.cuh"

namespace mt {

constexpr int kThreads = 128;   // queries per block
constexpr int kTileCols = 128;  // columns staged per shared-memory tile

template <class Cost, class = void>
struct QueryVec : std::false_type {};
template <class Cost>
struct QueryVec<Cost, std::void_t<decltype(Cost::kQueryVec)>>
    : std::bool_constant<Cost::kQueryVec> {};

// The exact reduction: a running (best_d, best_i) pair, taken on a strict <.
// A fold starts in the kernel from the launch's tile_f (unused here).
struct ExactFold {
  float best_d;
  int best_i;

  __device__ void start(int) {
    best_d = CUDART_INF_F;
    best_i = 0;
  }
  __device__ void add(float d, int col) {
    if (d < best_d) {
      best_d = d;
      best_i = col;
    }
  }
  __device__ int result() const { return best_i; }
};

// The fused packed-key reduction: the Hopper counterpart of
// make_fused_argmin_kernel in mesh_tpu/query/pallas_closest.py.  Per pair
// the cost's float32 bits lose their low log2(tile_f) bits to the column
// within its face tile of tile_f (a power of two):
//   key = (bits(d) & ~(tile_f - 1)) | (col & (tile_f - 1))
// and one int32 comparison orders both the quantized distance and the
// column.  A thread folds the keys in increasing column order with a
// strict <, keeping (best_key, best_tile = col / tile_f), and writes
// best_tile * tile_f + (best_key & (tile_f - 1)) from an INT_MAX init, as
// the reference does.  The strict < keeps the earlier tile on an equal
// key, so this fold is exactly the reference's per-tile min followed by
// its cross-tile merge: the tie group is "lowest column within its tile,
// then earliest tile", not "lowest face", and its radius is
// 2^-(23 - log2(tile_f)) relative.  tile_f only quantizes the key: the
// staging tiles are kTileCols as for the exact fold.  The reference pads
// the face axis with +inf-cost columns, which lose to every real face;
// here there are no padding columns.  Every +inf key 0x7f800000 | col is
// below INT_MAX, so a query whose costs are all +inf gets face 0, as in
// the reference.  The cost functor keeps NaN (kKeepNan), so a NaN key is
// the plain version's on the same card (0x7fffffff there: it loses).
struct FusedFold {
  int mask, shift, best_key, best_tile;

  __device__ void start(int tile_f) {
    mask = tile_f - 1;
    shift = __ffs(tile_f) - 1;
    best_key = INT_MAX;
    best_tile = 0;
  }
  __device__ void add(float d, int col) {
    const int key = (__float_as_int(d) & ~mask) | (col & mask);
    if (key < best_key) {
      best_key = key;
      best_tile = col >> shift;
    }
  }
  __device__ int result() const {
    return (best_tile << shift) + (best_key & mask);
  }
};

template <class Cost, class Fold>
__global__ void __launch_bounds__(kThreads)
argmin_kernel(const float* __restrict__ pts, const float* __restrict__ vecs,
              const float* __restrict__ cols, int* __restrict__ out, int n_q,
              int n_cols, float param, int tile_f) {
  __shared__ float4 tile[kTileCols * Cost::kVec];
  Fold fold;
  fold.start(tile_f);
  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const float* c = cols + static_cast<size_t>(b) * Cost::kRows * n_cols;

  float px = 0.0f, py = 0.0f, pz = 0.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  if (q < n_q) {
    const size_t at = (static_cast<size_t>(b) * n_q + q) * 3;
    px = pts[at];
    py = pts[at + 1];
    pz = pts[at + 2];
    if constexpr (QueryVec<Cost>::value) {
      nx = vecs[at];
      ny = vecs[at + 1];
      nz = vecs[at + 2];
    }
  }
  for (int c0 = 0; c0 < n_cols; c0 += kTileCols) {
    const int nc = min(kTileCols, n_cols - c0);
    __syncthreads();  // every thread is done with the previous tile
    for (int k = threadIdx.x; k < nc; k += kThreads) {
      Cost::stage(c, n_cols, c0 + k,
                  reinterpret_cast<float*>(tile + k * Cost::kVec));
    }
    __syncthreads();
    for (int k = 0; k < nc; ++k) {
      float d;
      if constexpr (QueryVec<Cost>::value) {
        d = Cost::cost(px, py, pz, nx, ny, nz, param, tile + k * Cost::kVec);
      } else {
        d = Cost::cost(px, py, pz, tile + k * Cost::kVec);
      }
      fold.add(d, c0 + k);
    }
  }
  if (q < n_q) out[static_cast<size_t>(b) * n_q + q] = fold.result();
}

// Launches one argmin over the batch on `stream`; returns the launch's
// cudaGetLastError() (0 when it was accepted).  `vecs` and `param` are read
// only by a kQueryVec functor.
template <class Cost>
int launch_argmin(const float* pts, const float* cols, int* out, int n_b,
                  int n_q, int n_cols, cudaStream_t stream,
                  const float* vecs = nullptr, float param = 0.0f) {
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (n_b <= 0 || n_q <= 0) return 0;
  const dim3 grid((n_q + kThreads - 1) / kThreads, n_b);
  argmin_kernel<Cost, ExactFold><<<grid, kThreads, 0, stream>>>(
      pts, vecs, cols, out, n_q, n_cols, param, 0);
  return static_cast<int>(cudaGetLastError());
}

// Launches one fused argmin over the batch on `stream` (tile_f a power of
// two); returns the launch's cudaGetLastError().
template <class Cost>
int launch_fused_argmin(const float* pts, const float* cols, int* out,
                        int n_b, int n_q, int n_cols, int tile_f,
                        cudaStream_t stream) {
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (tile_f <= 0 || (tile_f & (tile_f - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_b <= 0 || n_q <= 0) return 0;
  const dim3 grid((n_q + kThreads - 1) / kThreads, n_b);
  argmin_kernel<Cost, FusedFold><<<grid, kThreads, 0, stream>>>(
      pts, nullptr, cols, out, n_q, n_cols, 0.0f, tile_f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mt
