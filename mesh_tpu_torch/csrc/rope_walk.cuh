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
// One block owns one query tile and walks the rope: each thread computes
// its squared distance to the node's box, a block min-reduction gives the
// tile's lower bound, and the node is pruned when that bound, shrunk by
// the reference's margin, exceeds the tile's worst running best (a block
// max).  A taken leaf is copied into shared memory and folded into each
// query's (best_d, best_i) through the visit policy, with a strict <, so
// exact ties keep the lowest sorted position.  Two kernels, each with S
// threads per query:
//
//   rope_lanes_kernel   resident walk (both resident entries): a leaf that
//                       survives the fresh bound is copied and visited at
//                       once.
//   rope_stream_kernel  streamed walk (both streamed entries): refill walks
//                       the rope ahead and, for each leaf that survives the
//                       bound frozen when refill was called, starts a
//                       cp.async copy into the next slot of a ring of
//                       n_buffers, until the ring is full; the main loop
//                       waits for the oldest slot, visits it, and calls
//                       refill again with the tightened bound.  A popped
//                       leaf is not re-checked.  The frozen bound is
//                       looser, so the streamed walk takes a superset of the
//                       resident walk's leaves in the same order; the leaves
//                       it adds cannot beat the running best under the
//                       strict <, so faces and distances are bit-identical
//                       between the two walks and only the leaf count may
//                       grow (mesh_tpu/accel/pallas_stream.py:34-50).
//
// rope_stream_kernel is a kernel of its own beside rope_lanes_kernel, not a
// streamed branch of it: the ring's state (slots, head, count, n_buffers)
// would be dead parameters and registers in the resident walk.  The two
// write the same screen, leaf fold and merge, each in its own body:
// factored into one inlined function, the merge changed the resident
// kernel's SASS at S > 1, and the fast tile's resident instantiation keeps
// its measured code.  For the same reason the resident kernel's screen and
// its count of full visits are compile-time members of the policy
// (kScreen, kCountVisits): without them it compiles to the code it had
// before it took them.
//
// Sub-lanes.  A block of tile_q x S threads owns a query tile; thread t is
// sub-lane s = t / tile_q of query t % tile_q, so a warp holds 32 queries
// of ONE sub-lane and reads the same face of the staged leaf at every step
// of its fold: a broadcast from shared memory, free of bank conflicts
// (interleaving the sub-lanes of a query in a warp would read faces
// tile_f / S apart, all in one bank).
// Every thread of the block copies its share of a leaf, 16 bytes at a
// time.  Sub-lane s folds faces [s R, (s + 1) R), R = tile_f / S, from
// (+inf, kNoFace) with a strict <: its run's minimum at its lowest
// position.  The S partials of a query meet in shared memory (a region of
// their own, never a staged leaf's) and every sub-lane merges them alike,
// by (smaller distance, then lower position), then applies the result to
// the running (best_d, best_i) with one strict <: the reference's
// tile_min, first argmin and `better = tile_min < acc_d`
// (mesh_tpu/accel/pallas_bvh.py:166-178).  Why nothing changes against one
// thread folding the whole leaf:
//   - the fold never sees NaN (the exact cost clamps with fmaxf), so the
//     runs' (minimum, lowest position) merged by (distance, position) are
//     the whole leaf's (minimum, first position) bit for bit, and one
//     strict < of that against the running best decides as the whole-leaf
//     fold's chain of strict <s does;
//   - all sub-lanes of a query hold the same point and the same best, so
//     the walk's block reductions (the node bound, the refill's frozen
//     bound, a block max over values every sub-lane of a query shares)
//     give the values they give with one lane;
//   - so the leaves taken, their order, the faces, the distances and the
//     full visits are those of the one-lane walk.
// S == 1 folds straight into the running best.
//
// The MXU policy's bf16 screen splits the same way: each sub-lane tests its
// own run up to its first survivor, and the block runs the full visit when
// any (query, run) survives (one __syncthreads_or).  Every sub-lane of a
// query tests against the same running best ub, so the OR over (query,
// run) is the OR over (query, leaf) of the one-lane screen, and the same
// visits are skipped.  A sub-lane may test more pairs than the one-lane
// screen did (it stops at its own run's first survivor, not the leaf's),
// never fewer in total.  With S == 1 a thread screens the whole leaf.
//
// A visit policy V provides
//   V::Query                                 per-thread query state
//   query(q, px, py, pz)                     the state of query q
//   leaf_faces()                             tile_f
//   fold(slot, k0, k1, base, query, d, i)    fold faces [k0, k1) of the
//                                            staged leaf into (d, i) with a
//                                            strict <, i = base + position
//   stage(slot, leaf_start)                  (resident) copy a leaf with
//                                            every thread, then
//                                            __syncthreads
//   slot_floats(), prefetch(slot, leaf_start)
//                                            (streamed) floats of one ring
//                                            slot; start the copy of a leaf
//                                            as one cp.async group of this
//                                            thread (16-byte pieces)
//   kScreen, survives(slot, query, ub, k0, k1)
//                                            whether faces [k0, k1) may
//                                            still beat ub (survives only
//                                            under kScreen)
//   kCountVisits                             (resident) whether the walk
//                                            counts full visits into out_rep
//                                            (the streamed walk always does)

#pragma once

#include "common.cuh"

namespace mt {

constexpr int kMaxBuffers = 16;
// threads a block of the sub-lane kernels may have (tile_q x lanes); they
// are built for it, so ptxas keeps a thread within 64 registers
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

// Resident walk with kLanes sub-lanes per query (the note at the top).
// Under V::kCountVisits it writes the full visits per query tile into
// out_rep, which may be null; otherwise it never reads out_rep.
template <class V, int kLanes>
__global__ void __launch_bounds__(kMaxLaneThreads)
rope_lanes_kernel(const float* __restrict__ pts,
                  const float* __restrict__ seed, Rope rope, V policy,
                  float* __restrict__ out_d, int* __restrict__ out_i,
                  int* __restrict__ out_lv, int* __restrict__ out_rep) {
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
  int leaves = 0, full = 0;
  int node = 0;
  float worst = block_reduce<MaxOp>(best_d, scratch);
  while (node < rope.n_nodes) {
    const bool prune = rope.lower_bound(node, px, py, pz) * kShrink > worst;
    const int skip = rope.topo[2 * node];
    const int leaf_start = rope.topo[2 * node + 1];
    const bool is_leaf = leaf_start >= 0;
    if (is_leaf && !prune) {
      policy.stage(slot, leaf_start);
      bool visit = true;
      if constexpr (V::kScreen) {
        visit = __syncthreads_or(
            policy.survives(slot, query, best_d, k0, k0 + run));
      }
      if (visit) {
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
        if constexpr (V::kCountVisits) ++full;
      }
      ++leaves;
      // its leading __syncthreads also ends every read of the slot (by the
      // screen or the fold) and of the partials before the next leaf
      // overwrites them
      worst = block_reduce<MaxOp>(best_d, scratch);
    }
    node = (prune || is_leaf) ? skip : node + 1;
  }
  if (lane == 0) {
    out_d[q] = best_d;
    out_i[q] = best_i;
  }
  if (threadIdx.x == 0) {
    out_lv[blockIdx.x] = leaves;
    if constexpr (V::kCountVisits) {
      if (out_rep != nullptr) out_rep[blockIdx.x] = full;
    }
  }
}

// Streamed walk with kLanes sub-lanes per query (the note at the top):
// rope_lanes_kernel's block layout, fold and merge over a ring of
// n_buffers slots.  out_rep may be null.
template <class V, int kLanes>
__global__ void __launch_bounds__(kMaxLaneThreads)
rope_stream_kernel(const float* __restrict__ pts,
                   const float* __restrict__ seed, Rope rope, V policy,
                   float* __restrict__ out_d, int* __restrict__ out_i,
                   int* __restrict__ out_lv, int* __restrict__ out_rep,
                   int n_buffers) {
  extern __shared__ float4 smem4[];
  __shared__ float scratch[32];
  // the partials [kLanes][tile_q] (distances, then positions), then the
  // ring of n_buffers slots, 16-byte aligned (blockDim.x is a multiple of
  // 32); a slot in flight never overlaps the partials
  float* part_d = reinterpret_cast<float*>(smem4);
  int* part_i = reinterpret_cast<int*>(part_d + blockDim.x);
  float* slots = part_d + (kLanes > 1 ? 2 * blockDim.x : 0);
  rope.scratch = scratch;
  const int slot_floats = policy.slot_floats();
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
  int leaves = 0, full = 0;
  int node = 0;
  int ring[kMaxBuffers];
  int head = 0, count = 0;
  float bound = block_reduce<MaxOp>(best_d, scratch);
  for (;;) {
    // refill: enqueue every leaf that survives the frozen bound until the
    // ring is full or the walk reaches the exit sentinel
    while (node < rope.n_nodes && count < n_buffers) {
      const bool prune = rope.lower_bound(node, px, py, pz) * kShrink > bound;
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
    const float* slot = slots + head * slot_floats;
    const int leaf_start = ring[head];
    bool visit = true;
    if constexpr (V::kScreen) {
      visit = __syncthreads_or(
          policy.survives(slot, query, best_d, k0, k0 + run));
    }
    if (visit) {
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
      ++full;
    }
    ++leaves;
    head = (head + 1) % n_buffers;
    --count;
    // its leading __syncthreads ends every read of the slot and of the
    // partials before refill reuses the slot and the next visit the
    // partials
    bound = block_reduce<MaxOp>(best_d, scratch);
  }
  if (lane == 0) {
    out_d[q] = best_d;
    out_i[q] = best_i;
  }
  if (threadIdx.x == 0) {
    out_lv[blockIdx.x] = leaves;
    if (out_rep != nullptr) out_rep[blockIdx.x] = full;
  }
}

// Launches rope_lanes_kernel<V, lanes> on `stream`, one staged leaf taking
// slot_bytes of shared memory (after the partials when lanes > 1).  lanes
// must be 1, 2, 4 or 8 and divide tile_f (the caller checks the latter);
// tile_q a multiple of 32 dividing q_pad, with tile_q x lanes up to
// kMaxLaneThreads.  out_rep may be null.  Returns the launch's CUDA error
// code.
template <class V>
int launch_rope_lanes(const float* pts, const float* seed, Rope rope,
                      V policy, float* out_d, int* out_i, int* out_lv,
                      int* out_rep, int q_pad, int tile_q, int lanes,
                      size_t slot_bytes, cudaStream_t stream) {
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
  kernel<<<q_pad / tile_q, threads, smem, stream>>>(
      pts, seed, rope, policy, out_d, out_i, out_lv, out_rep);
  return static_cast<int>(cudaGetLastError());
}

// Launches rope_stream_kernel<V, lanes> on `stream` with a ring of
// n_buffers (2..kMaxBuffers) slots of slot_bytes each, after the partials
// when lanes > 1.  lanes, tile_q and q_pad as for launch_rope_lanes.
// out_rep may be null.  Returns the launch's CUDA error code.
template <class V>
int launch_rope_stream(const float* pts, const float* seed, Rope rope,
                       V policy, float* out_d, int* out_i, int* out_lv,
                       int* out_rep, int q_pad, int tile_q, int lanes,
                       int n_buffers, size_t slot_bytes,
                       cudaStream_t stream) {
  if (q_pad <= 0) return 0;
  const int threads = tile_q * lanes;
  if (tile_q <= 0 || tile_q % 32 || q_pad % tile_q || lanes <= 0 ||
      threads > kMaxLaneThreads || n_buffers < 2 ||
      n_buffers > kMaxBuffers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  decltype(&rope_stream_kernel<V, 1>) kernel = nullptr;
  switch (lanes) {
    case 1: kernel = rope_stream_kernel<V, 1>; break;
    case 2: kernel = rope_stream_kernel<V, 2>; break;
    case 4: kernel = rope_stream_kernel<V, 4>; break;
    case 8: kernel = rope_stream_kernel<V, 8>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      n_buffers * slot_bytes +
      (lanes > 1 ? threads * (sizeof(float) + sizeof(int)) : 0);
  if (smem > kMaxRingBytes) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<q_pad / tile_q, threads, smem, stream>>>(
      pts, seed, rope, policy, out_d, out_i, out_lv, out_rep, n_buffers);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mt
