// Per-leaf AABBs of the animated-mesh BVH refit on Hopper (sm_90a), one
// warp a leaf: the oracle that chip_smoke.py holds leaf_boxes.cu to, box
// for box; no path launches it.
//
// Replaces: mesh_tpu/accel/pallas_refit.py leaf_boxes_pallas (the
// row-reduction kernel _make_leaf_box_kernel, pallas_call in
// _leaf_boxes_run).
//
// For each leaf b of the frozen Morton order: the min and the max of each
// coordinate over the leaf's leaf_size * 3 triangle corners.  tri_s is the
// centered, Morton-ordered [Fp, 3, 3] float32 triangle array with
// Fp = n_leaves * leaf_size, so leaf b owns the contiguous floats
// [b * leaf_size * 9, (b + 1) * leaf_size * 9); lo and hi are [n_leaves, 3].
//
// Bound on the H100: bytes.  Each corner float is read once and costs two
// compares and two selects (min and max), about one operation per byte, far
// below the card's balance: Fp * 36 bytes in, n_leaves * 24 out.  At a
// refit's sizes (a few MB) the launch itself is most of the time.
//
// What the design does: one warp per leaf, eight leaves a block.  The lanes
// walk the leaf's corners with a stride of 32 (12 bytes a lane, so a warp
// reads 384 contiguous bytes an iteration), keep three running minima and
// maxima in registers and fold them with shuffles.  min and max round
// nothing, so the result is the same in any fold order and equals numpy's
// blocks.min / blocks.max.  A NaN corner makes its leaf's box NaN, as
// np.min and jnp.min do: fminf / fmaxf would drop it, so the compares are
// written out.

#include "common.cuh"

namespace mt {

// A NaN operand is the result; otherwise the smaller (larger) value.  a != a
// holds exactly for NaN (the build has no fast math).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

constexpr int kLeavesPerBlock = 8;

__global__ void __launch_bounds__(32 * kLeavesPerBlock)
leaf_boxes_kernel(const float* __restrict__ tri_s, float* __restrict__ lo,
                  float* __restrict__ hi, int n_leaves, int leaf_size) {
  const int lane = threadIdx.x & 31;
  const int leaf = blockIdx.x * kLeavesPerBlock + (threadIdx.x >> 5);
  if (leaf >= n_leaves) return;  // the whole warp leaves together
  const int n_corners = leaf_size * 3;
  const float* corners = tri_s + static_cast<size_t>(leaf) * n_corners * 3;
  float mn[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float mx[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  for (int c = lane; c < n_corners; c += 32) {
    const float* p = corners + 3 * static_cast<size_t>(c);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float x = __ldg(p + k);
      mn[k] = nan_min(mn[k], x);
      mx[k] = nan_max(mx[k], x);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      mn[k] = nan_min(mn[k], __shfl_xor_sync(0xffffffffu, mn[k], off));
      mx[k] = nan_max(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], off));
    }
  }
  if (lane < 3) {
    // lane k writes coordinate k (the registers are indexed statically)
    const float l = lane == 0 ? mn[0] : (lane == 1 ? mn[1] : mn[2]);
    const float h = lane == 0 ? mx[0] : (lane == 1 ? mx[1] : mx[2]);
    lo[3 * static_cast<size_t>(leaf) + lane] = l;
    hi[3 * static_cast<size_t>(leaf) + lane] = h;
  }
}

}  // namespace mt

// Returns the launch's CUDA error code.
extern "C" int mt_leaf_boxes_warp(const float* tri_s, float* lo, float* hi,
                                  int n_leaves, int leaf_size,
                                  cudaStream_t stream) {
  if (n_leaves <= 0) return 0;
  const int blocks =
      (n_leaves + mt::kLeavesPerBlock - 1) / mt::kLeavesPerBlock;
  mt::leaf_boxes_kernel<<<blocks, 32 * mt::kLeavesPerBlock, 0, stream>>>(
      tri_s, lo, hi, n_leaves, leaf_size);
  return static_cast<int>(cudaGetLastError());
}
