// Per-leaf AABBs of the animated-mesh BVH refit on Hopper (sm_90a): a
// one-pass segmented reduction shaped for HBM bandwidth.
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
// compares and two selects, about one operation per byte, far below the
// card's balance: Fp * 36 bytes in, n_leaves * 24 out (4.7 MB at the
// 98,304-face keyframe, 1.4 us at 3.35 TB/s).  At that size the time is
// HBM latency unless most of the bytes are in flight at once.
//
// What the design does about it (leaf_boxes_warp.cu, the oracle, gives a
// warp to a leaf and has each lane issue one 4-byte load at a time, each
// consumed before the next: 64 blocks at leaf 256, lanes 24-31 idle at
// leaf 8):
// - Items.  Where leaf_size % 4 == 0 and tri_s is 16-byte aligned, an item
//   is a unit of 48 bytes, four corners, read as three float4.  A unit
//   starts at a multiple of 12 floats, so its float j is coordinate j % 3
//   and a thread keeps its three minima and maxima with no exchange of
//   lanes.  Every other layout (any leaf size >= 1, any 4-byte alignment)
//   runs the same kernel with an item of one corner, three 4-byte loads.
// - Bytes in flight.  A group of `group` threads (a power of two, at most
//   the block's 256) folds one leaf; its thread r takes items r, r + group,
//   r + 2 group, ..., kItems of them a round, and issues every load of a
//   round before it folds any.  The wrapper picks the least group with
//   group * kItems >= the leaf's items (refit_kernel.leaf_plan), so one
//   round covers a leaf of up to 768 items: at leaf 256 (192 units) 64
//   threads, at leaf 8 (6 units) 2.  Both anim shapes launch 128 blocks of
//   256 threads with 144 bytes in flight a thread, about 36 KB an SM.
// - Reduction.  Within a warp, a segmented xor-shuffle over the group's
//   lanes (offsets below the group's size stay inside its aligned lanes);
//   a group of several warps then folds its warps' partials through shared
//   memory.  One thread writes each of a leaf's six floats, once.
// - Exactness.  min and max round nothing, so the fold order is free and
//   the boxes equal numpy's blocks.min / blocks.max.  A NaN corner makes
//   its leaf's box NaN, as np.min and jnp.min do (fminf / fmaxf would drop
//   it, so the compares are written out), and -0.0 and 0.0 compare equal,
//   so either may stand for a zero bound, as in the plain version.
//
// refit_kernel.leaf_boxes_schedule is this schedule in plain PyTorch.

#include <cstdint>

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

constexpr int kThreads = 256;  // threads a block
constexpr int kItems = 3;      // items a thread loads in one round

// The running box of one thread: three minima and three maxima.
struct Box {
  float mn[3], mx[3];

  __device__ __forceinline__ void start() {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      mn[k] = CUDART_INF_F;
      mx[k] = -CUDART_INF_F;
    }
  }
  __device__ __forceinline__ void add(int k, float x) {
    mn[k] = nan_min(mn[k], x);
    mx[k] = nan_max(mx[k], x);
  }
};

template <bool kUnits>
__global__ void __launch_bounds__(kThreads)
leaf_boxes_kernel(const float* __restrict__ tri_s, float* __restrict__ lo,
                  float* __restrict__ hi, int n_leaves, int n_items,
                  int group) {
  __shared__ float part[kThreads / 32][6];
  const int r = threadIdx.x & (group - 1);
  const int leaf = blockIdx.x * (kThreads / group) + threadIdx.x / group;
  const bool live = leaf < n_leaves;  // the same for a whole group
  Box box;
  box.start();
  if (live) {
    const size_t first = static_cast<size_t>(leaf) * n_items;
    for (int i0 = r; i0 < n_items; i0 += group * kItems) {
      if constexpr (kUnits) {
        const float4* units = reinterpret_cast<const float4*>(tri_s);
        float4 u[kItems][3];
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          const int item = i0 + k * group;
          if (item < n_items) {
            const float4* p = units + 3 * (first + item);
            u[k][0] = __ldg(p);
            u[k][1] = __ldg(p + 1);
            u[k][2] = __ldg(p + 2);
          }
        }
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          if (i0 + k * group < n_items) {
            const float f[12] = {u[k][0].x, u[k][0].y, u[k][0].z, u[k][0].w,
                                 u[k][1].x, u[k][1].y, u[k][1].z, u[k][1].w,
                                 u[k][2].x, u[k][2].y, u[k][2].z, u[k][2].w};
#pragma unroll
            for (int j = 0; j < 12; ++j) box.add(j % 3, f[j]);
          }
        }
      } else {
        float c[kItems][3];
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          const int item = i0 + k * group;
          if (item < n_items) {
            const float* p = tri_s + 3 * (first + item);
#pragma unroll
            for (int m = 0; m < 3; ++m) c[k][m] = __ldg(p + m);
          }
        }
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          if (i0 + k * group < n_items) {
#pragma unroll
            for (int m = 0; m < 3; ++m) box.add(m, c[k][m]);
          }
        }
      }
    }
  }
  // the group's lanes within a warp (every lane takes part: a dead group
  // folds its +-inf starts among themselves)
  for (int off = (group < 32 ? group : 32) >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      box.mn[k] = nan_min(box.mn[k],
                          __shfl_xor_sync(0xffffffffu, box.mn[k], off));
      box.mx[k] = nan_max(box.mx[k],
                          __shfl_xor_sync(0xffffffffu, box.mx[k], off));
    }
  }
  if (group > 32) {  // the same for the whole block
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        part[warp][k] = box.mn[k];
        part[warp][3 + k] = box.mx[k];
      }
    }
    __syncthreads();
    const int warps = group >> 5;
    if (live && lane < 6 && (warp & (warps - 1)) == 0) {
      // lane c folds value c of the group's warps: c < 3 a minimum
      float v = part[warp][lane];
      for (int w = 1; w < warps; ++w) {
        const float x = part[warp + w][lane];
        v = lane < 3 ? nan_min(v, x) : nan_max(v, x);
      }
      (lane < 3 ? lo : hi)[3 * static_cast<size_t>(leaf) + lane % 3] = v;
    }
  } else if (live && r == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[3 * static_cast<size_t>(leaf) + k] = box.mn[k];
      hi[3 * static_cast<size_t>(leaf) + k] = box.mx[k];
    }
  }
}

}  // namespace mt

// units: 1 for the 48-byte units (leaf_size % 4 == 0 and tri_s 16-byte
// aligned), 0 for corners; group: threads a leaf, a power of two up to 256.
// Returns the launch's CUDA error code.
extern "C" int mt_leaf_boxes(const float* tri_s, float* lo, float* hi,
                             int n_leaves, int leaf_size, int units,
                             int group, cudaStream_t stream) {
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (leaf_size < 1 || group < 1 || group > mt::kThreads ||
      (group & (group - 1)) != 0 ||
      (units && (leaf_size % 4 != 0 ||
                 reinterpret_cast<std::uintptr_t>(tri_s) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_leaves <= 0) return 0;
  const int per_block = mt::kThreads / group;
  const int blocks = (n_leaves + per_block - 1) / per_block;
  if (units) {
    mt::leaf_boxes_kernel<true><<<blocks, mt::kThreads, 0, stream>>>(
        tri_s, lo, hi, n_leaves, leaf_size / 4 * 3, group);
  } else {
    mt::leaf_boxes_kernel<false><<<blocks, mt::kThreads, 0, stream>>>(
        tri_s, lo, hi, n_leaves, leaf_size * 3, group);
  }
  return static_cast<int>(cudaGetLastError());
}
