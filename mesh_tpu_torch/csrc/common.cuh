// Pieces every query kernel of mesh_tpu_torch shares: clamping, block-wide
// min/max reductions, and the C entry point that names a CUDA error.
//
// The reductions are exact (min and max round nothing), so every thread of
// a block gets the same value whatever order the warps combine in; the
// kernels rely on that to take block-uniform branches.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace mt {

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// max(x, 0) that keeps NaN, as torch.clamp_min and jnp.maximum do
__device__ __forceinline__ float max0(float x) { return x < 0.0f ? 0.0f : x; }

struct MinOp {
  __device__ static float apply(float a, float b) { return fminf(a, b); }
};
struct MaxOp {
  __device__ static float apply(float a, float b) { return fmaxf(a, b); }
};

// Asynchronous copies from global to shared memory (cp.async): a copy of
// 16 bytes (both addresses 16-byte aligned) or of 4, each thread's copies
// since its last commit forming one group; cp_async_wait<N> returns when at
// most N of the thread's groups are still in flight.  A __syncthreads after
// the wait makes every thread's landed copies visible to the block.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The block-wide reduction of v, returned to every thread.  `scratch`
// holds one float per warp (32 suffice for any block).  The leading
// __syncthreads also orders this call after every thread's earlier reads
// of shared memory, which the kernels use to recycle their staging tiles.
template <class Op>
__device__ __forceinline__ float block_reduce(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = Op::apply(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  const int n_warps = (blockDim.x + 31) >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < n_warps; ++w) r = Op::apply(r, scratch[w]);
  return r;
}

}  // namespace mt

extern "C" const char* mt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
