// The stackless BVH rope walk per query tile, shared by rope_faces.cu (the
// fast tile's leaf visit) and rope_mxu_faces.cu (the MXU tile's, with its
// optional bf16 screen): the Hopper counterpart of the walk in
// mesh_tpu/accel/pallas_bvh.py and mesh_tpu/accel/pallas_stream.py.
//
// Operands (built by mesh_tpu_torch/accel/rope_kernel.py): queries
// Morton-sorted and edge-padded to whole tiles of tile_q, each with a seed
// (an upper bound on its closest squared distance); the coarse BVH built
// with leaf_size == tile_f, as node boxes [N, 6] (lo, hi) and topology
// [N, 2] (skip pointer, first sorted face of a leaf or -1); the leaves'
// faces in the visit policy's layout, in Morton face order.  Outputs: per
// query its best squared distance and the sorted position of its face, per
// query tile the leaves it took and the leaves whose full visit ran.
//
// In rope_walk_kernel one block of tile_q threads owns one query tile, one
// thread one query.  The block walks the rope together: each thread
// computes its squared distance to the node's box, a block min-reduction
// gives the tile's lower bound, and the node is pruned when that bound,
// shrunk by the reference's margin, exceeds the tile's worst running best
// (a block max).  A taken leaf is copied into shared memory and every
// thread folds it into its (best_d, best_i) through the visit policy, with
// a strict <, so exact ties keep the lowest sorted position.
//
// Resident walk (n_buffers == 0): a leaf that survives the fresh bound is
// copied and visited at once.  rope_lanes_kernel is the resident walk with
// S threads per query, for policies that can fold part of a leaf (see the
// note above it).  Streamed walk (n_buffers >= 2): refill walks the rope
// ahead and, for each leaf that survives the bound frozen when
// refill was called, starts a cp.async copy into the next slot of a ring
// of n_buffers, until the ring is full; the main loop waits for the oldest
// slot, visits it, and calls refill again with the tightened bound.  A
// popped leaf is not re-checked.  The frozen bound is looser, so the
// streamed walk takes a superset of the resident walk's leaves in the
// same order; the leaves it adds cannot beat the running best under the
// strict <, so faces and distances are bit-identical between the two
// walks and only the leaf count may grow
// (mesh_tpu/accel/pallas_stream.py:34-50).
//
// A visit policy V provides
//   V::Query                                 per-thread query state
//   query(q, px, py, pz)                     the state of query q
//   slot_floats()                            floats of one staged leaf
//   stage(slot, leaf_start)                  copy a leaf, then __syncthreads
//   prefetch(slot, leaf_start)               the copy as one cp.async group
//                                            (16-byte pieces)
//   visit(slot, leaf_start, query, best_d, best_i)
//                                            fold the staged leaf; called by
//                                            every thread of the block; false
//                                            when it skipped the full visit
// A policy of rope_lanes_kernel provides V::Query, query(), stage() and
//   leaf_faces()                             tile_f
//   fold(slot, k0, k1, base, query, d, i)    fold faces [k0, k1) of the
//                                            staged leaf into (d, i) with a
//                                            strict <, i = base + position

#pragma once

#include "common.cuh"

namespace mt {

constexpr int kMaxBuffers = 16;
// threads a block of rope_lanes_kernel may have (tile_q x lanes); the
// kernel is built for it, so ptxas keeps a thread within 64 registers
constexpr int kMaxLaneThreads = 1024;
// the face position of a sub-lane whose run beat nothing (all +inf)
constexpr int kNoFace = 0x7fffffff;
// dynamic shared memory a walk may ask for: the H100's 227 KB a block can
// use, less room for the walk's static scratch
constexpr size_t kMaxRingBytes = 226 * 1024;

// (1 - _MARGIN) in float32, the reference's lower-bound shrink
constexpr float kShrink = static_cast<float>(1.0 - 1e-3);

// Wait until at most n of this thread's copy groups are pending (at most
// 7 for n >= 7, which waits for more than is needed, never less).
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

struct Rope {
  const float* boxes;
  const int* topo;
  int n_nodes;
  float* scratch;

  // The tile's lower bound on the squared distance to node's box.
  __device__ float lower_bound(int node, float px, float py, float pz) const {
    const float* bx = boxes + static_cast<size_t>(node) * 6;
    const float dx = fmaxf(fmaxf(bx[0] - px, px - bx[3]), 0.0f);
    const float dy = fmaxf(fmaxf(bx[1] - py, py - bx[4]), 0.0f);
    const float dz = fmaxf(fmaxf(bx[2] - pz, pz - bx[5]), 0.0f);
    return block_reduce<MinOp>(dx * dx + dy * dy + dz * dz, scratch);
  }
};

template <class V, bool kStream>
__global__ void rope_walk_kernel(const float* __restrict__ pts,
                                 const float* __restrict__ seed, Rope rope,
                                 V policy, float* __restrict__ out_d,
                                 int* __restrict__ out_i,
                                 int* __restrict__ out_lv,
                                 int* __restrict__ out_rep, int n_buffers) {
  extern __shared__ float4 smem4[];
  __shared__ float scratch[32];
  float* slots = reinterpret_cast<float*>(smem4);
  rope.scratch = scratch;
  const int slot_floats = policy.slot_floats();
  const size_t q = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float px = pts[q * 3], py = pts[q * 3 + 1], pz = pts[q * 3 + 2];
  const typename V::Query query = policy.query(q, px, py, pz);
  float best_d = seed[q];
  int best_i = 0;
  int leaves = 0, full = 0;
  int node = 0;

  if (!kStream) {
    float worst = block_reduce<MaxOp>(best_d, scratch);
    while (node < rope.n_nodes) {
      const bool prune =
          rope.lower_bound(node, px, py, pz) * kShrink > worst;
      const int skip = rope.topo[2 * node];
      const int leaf_start = rope.topo[2 * node + 1];
      const bool is_leaf = leaf_start >= 0;
      if (is_leaf && !prune) {
        policy.stage(slots, leaf_start);
        full += policy.visit(slots, leaf_start, query, best_d, best_i);
        ++leaves;
        worst = block_reduce<MaxOp>(best_d, scratch);
      }
      node = (prune || is_leaf) ? skip : node + 1;
    }
  } else {
    int ring[kMaxBuffers];
    int head = 0, count = 0;
    float bound = block_reduce<MaxOp>(best_d, scratch);
    for (;;) {
      // refill: enqueue every leaf that survives the frozen bound until
      // the ring is full or the walk reaches the exit sentinel
      while (node < rope.n_nodes && count < n_buffers) {
        const bool prune =
            rope.lower_bound(node, px, py, pz) * kShrink > bound;
        const int skip = rope.topo[2 * node];
        const int leaf_start = rope.topo[2 * node + 1];
        const bool is_leaf = leaf_start >= 0;
        if (is_leaf && !prune) {
          const int slot = (head + count) % n_buffers;
          ring[slot] = leaf_start;
          policy.prefetch(slots + slot * slot_floats, leaf_start);
          ++count;
        }
        node = (prune || is_leaf) ? skip : node + 1;
      }
      if (count == 0) break;
      cp_async_wait_at_most(count - 1);  // the oldest slot has landed
      __syncthreads();
      full += policy.visit(slots + head * slot_floats, ring[head], query,
                           best_d, best_i);
      ++leaves;
      head = (head + 1) % n_buffers;
      --count;
      // every thread is done with the slot before refill reuses it
      bound = block_reduce<MaxOp>(best_d, scratch);
    }
  }
  out_d[q] = best_d;
  out_i[q] = best_i;
  if (threadIdx.x == 0) {
    out_lv[blockIdx.x] = leaves;
    if (out_rep != nullptr) out_rep[blockIdx.x] = full;
  }
}

// Resident walk with kLanes sub-lanes per query.  A block of tile_q x
// kLanes threads owns one query tile; thread t is sub-lane s = t / tile_q
// of query t % tile_q.  This layout puts 32 queries of ONE sub-lane in a
// warp (tile_q is a multiple of 32), so the warp reads the same face of the
// staged leaf at every step of its fold: a broadcast from shared memory,
// free of bank conflicts (interleaving the sub-lanes of a query in a warp
// would read faces tile_f / S apart, all in one bank).  Every thread of
// the block copies the leaf, 16 bytes at a time where the policy can.
//
// Sub-lane s folds faces [s R, (s + 1) R), R = tile_f / kLanes, from
// (+inf, kNoFace) with a strict <: the run's minimum at its lowest
// position.  The kLanes partials of a query meet in shared memory and
// every sub-lane merges them alike, by (smaller distance, then lower
// position), and applies the result to the running (best_d, best_i) with
// one strict <: the reference's tile_min, first argmin and
// `better = tile_min < acc_d` (mesh_tpu/accel/pallas_bvh.py:166-178).
// The fold never sees NaN (the exact cost clamps with fmaxf), so leaves,
// faces and distances are those of one thread folding the whole leaf.
// All sub-lanes of a query hold the same point and the same best, so the
// block reductions of the walk give the values they give with one lane.
// kLanes == 1 folds straight into the running best.
template <class V, int kLanes>
__global__ void __launch_bounds__(kMaxLaneThreads)
rope_lanes_kernel(const float* __restrict__ pts,
                  const float* __restrict__ seed, Rope rope, V policy,
                  float* __restrict__ out_d, int* __restrict__ out_i,
                  int* __restrict__ out_lv) {
  extern __shared__ float4 smem4[];
  __shared__ float scratch[32];
  // the partials [kLanes][tile_q] (distances, then positions), then the
  // staged leaf, 16-byte aligned (blockDim.x is a multiple of 32)
  float* part_d = reinterpret_cast<float*>(smem4);
  int* part_i = reinterpret_cast<int*>(part_d + blockDim.x);
  float* slot = part_d + (kLanes > 1 ? 2 * blockDim.x : 0);
  rope.scratch = scratch;
  const int tile_q = blockDim.x / kLanes;
  const int lane = threadIdx.x / tile_q;
  const int ql = threadIdx.x - lane * tile_q;
  const size_t q = static_cast<size_t>(blockIdx.x) * tile_q + ql;
  const float px = pts[q * 3], py = pts[q * 3 + 1], pz = pts[q * 3 + 2];
  const typename V::Query query = policy.query(q, px, py, pz);
  const int run = policy.leaf_faces() / kLanes;
  const int k0 = lane * run;
  float best_d = seed[q];
  int best_i = 0;
  int leaves = 0;
  int node = 0;
  float worst = block_reduce<MaxOp>(best_d, scratch);
  while (node < rope.n_nodes) {
    const bool prune = rope.lower_bound(node, px, py, pz) * kShrink > worst;
    const int skip = rope.topo[2 * node];
    const int leaf_start = rope.topo[2 * node + 1];
    const bool is_leaf = leaf_start >= 0;
    if (is_leaf && !prune) {
      policy.stage(slot, leaf_start);
      if constexpr (kLanes == 1) {
        policy.fold(slot, 0, run, leaf_start, query, best_d, best_i);
      } else {
        float d = CUDART_INF_F;
        int i = kNoFace;
        policy.fold(slot, k0, k0 + run, 0, query, d, i);
        part_d[threadIdx.x] = d;
        part_i[threadIdx.x] = i;
        __syncthreads();
        float md = part_d[ql];
        int mi = part_i[ql];
#pragma unroll
        for (int r = 1; r < kLanes; ++r) {
          const float dr = part_d[r * tile_q + ql];
          const int ir = part_i[r * tile_q + ql];
          if (dr < md || (dr == md && ir < mi)) {
            md = dr;
            mi = ir;
          }
        }
        if (md < best_d) {
          best_d = md;
          best_i = leaf_start + mi;
        }
      }
      ++leaves;
      // its leading __syncthreads also ends every read of the slot and of
      // the partials before the next leaf overwrites them
      worst = block_reduce<MaxOp>(best_d, scratch);
    }
    node = (prune || is_leaf) ? skip : node + 1;
  }
  if (lane == 0) {
    out_d[q] = best_d;
    out_i[q] = best_i;
  }
  if (threadIdx.x == 0) out_lv[blockIdx.x] = leaves;
}

// Launches rope_lanes_kernel<V, lanes> on `stream`, one staged leaf taking
// slot_bytes of shared memory (after the partials when lanes > 1).  lanes
// must be 1, 2, 4 or 8 and divide tile_f (the caller checks the latter);
// tile_q a multiple of 32 dividing q_pad, with tile_q x lanes up to
// kMaxLaneThreads.  Returns the launch's CUDA error code.
template <class V>
int launch_rope_lanes(const float* pts, const float* seed, Rope rope,
                      V policy, float* out_d, int* out_i, int* out_lv,
                      int q_pad, int tile_q, int lanes, size_t slot_bytes,
                      cudaStream_t stream) {
  if (q_pad <= 0) return 0;
  const int threads = tile_q * lanes;
  if (tile_q <= 0 || tile_q % 32 || q_pad % tile_q || lanes <= 0 ||
      threads > kMaxLaneThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  decltype(&rope_lanes_kernel<V, 1>) kernel = nullptr;
  switch (lanes) {
    case 1: kernel = rope_lanes_kernel<V, 1>; break;
    case 2: kernel = rope_lanes_kernel<V, 2>; break;
    case 4: kernel = rope_lanes_kernel<V, 4>; break;
    case 8: kernel = rope_lanes_kernel<V, 8>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      slot_bytes + (lanes > 1 ? threads * (sizeof(float) + sizeof(int)) : 0);
  if (smem > kMaxRingBytes) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<q_pad / tile_q, threads, smem, stream>>>(pts, seed, rope, policy,
                                                     out_d, out_i, out_lv);
  return static_cast<int>(cudaGetLastError());
}

// Launches the walk of `policy` on `stream`: the resident walk for
// n_buffers == 0, the streamed one for 2..kMaxBuffers, each staged leaf
// taking slot_bytes of shared memory.  tile_q must be a multiple of 32 up
// to 1024 dividing q_pad.  out_rep may be null.  Returns the launch's CUDA
// error code (cudaErrorInvalidValue for shapes the walk does not take).
template <class V>
int launch_rope_walk(const float* pts, const float* seed, Rope rope, V policy,
                     float* out_d, int* out_i, int* out_lv, int* out_rep,
                     int q_pad, int tile_q, int n_buffers, size_t slot_bytes,
                     cudaStream_t stream) {
  if (q_pad <= 0) return 0;
  const bool stream_entry = n_buffers != 0;
  if (tile_q <= 0 || tile_q > 1024 || tile_q % 32 || q_pad % tile_q ||
      (stream_entry && (n_buffers < 2 || n_buffers > kMaxBuffers))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (stream_entry ? n_buffers : 1) * slot_bytes;
  if (smem > kMaxRingBytes) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = stream_entry ? rope_walk_kernel<V, true>
                                   : rope_walk_kernel<V, false>;
  // opt in on every launch: the kernel's static scratch counts against the
  // 48 KB a block gets without it, so even exactly 48 KB of leaves needs it
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<q_pad / tile_q, tile_q, smem, stream>>>(
      pts, seed, rope, policy, out_d, out_i, out_lv, out_rep, n_buffers);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mt
