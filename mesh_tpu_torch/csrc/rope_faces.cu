// BVH rope walk per query tile on Hopper (sm_90a): the resident and the
// streamed entry of one kernel.
//
// Replaces: mesh_tpu/accel/pallas_bvh.py closest_point_pallas_bvh (kernel
// _make_rope_kernel) and mesh_tpu/accel/pallas_stream.py
// closest_point_pallas_bvh_stream (kernel _make_stream_kernel).
//
// Operands (built by mesh_tpu_torch/accel/rope_kernel.py): queries
// Morton-sorted and edge-padded to whole tiles of tile_q, each with a seed
// (an upper bound on its closest squared distance); the coarse BVH built
// with leaf_size == tile_f, as node boxes [N, 6] (lo, hi) and topology
// [N, 2] (skip pointer, first sorted face of a leaf or -1); and the fast
// tile's 19 face planes [19, Fp] in Morton face order.  Outputs: per query
// its best squared distance and the sorted position of its face, per query
// tile the leaves it tested.
//
// One block of tile_q threads owns one query tile, one thread one query.
// The block walks the stackless rope together: each thread computes its
// squared distance to the node's box, a block min-reduction gives the
// tile's lower bound, and the node is pruned when that bound, shrunk by
// the reference's margin, exceeds the tile's worst running best (a block
// max).  A visited leaf's 19 x tile_f planes sit in shared memory, rows
// as in device memory, and every thread folds them into its (best_d,
// best_i) with the fast tile and its degenerate tail (fast_pair<true>,
// csrc/face_cost.cuh) and a strict <, so exact ties keep the lowest
// sorted position.
//
// Resident entry (n_buffers == 0): a leaf that survives the fresh bound is
// copied into shared memory and scanned at once.  Streamed entry
// (n_buffers >= 2): refill walks the rope ahead and, for each leaf that
// survives the bound frozen when refill was called, starts a cp.async copy
// of its planes into the next slot of a ring of n_buffers, until the ring
// is full; the main loop waits for the oldest slot, scans it, and calls
// refill again with the tightened bound.  A popped leaf is not re-checked.
// The frozen bound is looser, so the streamed walk tests a superset of the
// resident walk's leaves in the same order; the leaves it adds cannot beat
// the running best under the strict <, so faces and distances are
// bit-identical between the two entries and only the leaf count may grow
// (mesh_tpu/accel/pallas_stream.py:34-50).
//
// Bound on the H100: float32 issue on the pairs of the tested leaves (119
// operations a pair, the fast tile with its tail), against the planes of
// each tested leaf read once per query tile.  The walk's control costs two
// block reductions per node; the streamed ring hides the copy of the next
// leaves behind the scan of the current one.

#include "face_cost.cuh"

namespace mt {

constexpr int kPlanes = 19;
constexpr int kMaxBuffers = 16;

// (1 - _MARGIN) in float32, the reference's lower-bound shrink
constexpr float kShrink = static_cast<float>(1.0 - 1e-3);

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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
  const float* rows;
  int n_nodes, f_pad, tile_f;
  float* scratch;

  // The tile's lower bound on the squared distance to node's box.
  __device__ float lower_bound(int node, float px, float py, float pz) const {
    const float* bx = boxes + static_cast<size_t>(node) * 6;
    const float dx = fmaxf(fmaxf(bx[0] - px, px - bx[3]), 0.0f);
    const float dy = fmaxf(fmaxf(bx[1] - py, py - bx[4]), 0.0f);
    const float dz = fmaxf(fmaxf(bx[2] - pz, pz - bx[5]), 0.0f);
    return block_reduce<MinOp>(dx * dx + dy * dy + dz * dz, scratch);
  }

  // Copy a leaf's planes into `slot` ([19][tile_f]) and wait for them.
  __device__ void stage(float* slot, int leaf_start) const {
    for (int i = threadIdx.x; i < kPlanes * tile_f; i += blockDim.x) {
      const int r = i / tile_f, k = i - r * tile_f;
      slot[i] = rows[static_cast<size_t>(r) * f_pad + leaf_start + k];
    }
    __syncthreads();
  }

  // Start the copy of a leaf's planes into `slot`, 16 bytes at a time, as
  // one cp.async group of this thread (tile_f % 4 == 0).
  __device__ void prefetch(float* slot, int leaf_start) const {
    const int vec = tile_f >> 2;
    for (int i = threadIdx.x; i < kPlanes * vec; i += blockDim.x) {
      const int r = i / vec, k = (i - r * vec) << 2;
      cp_async16(slot + r * tile_f + k,
                 rows + static_cast<size_t>(r) * f_pad + leaf_start + k);
    }
    cp_async_commit();
  }

  // Fold a staged leaf into (best_d, best_i) in increasing face order.
  __device__ void scan(const float* slot, int leaf_start, float px, float py,
                       float pz, float& best_d, int& best_i) const {
    const int t = tile_f;
    for (int k = 0; k < t; ++k) {
      const float* c = slot + k;
      const float d = fast_pair<true>(
          px, py, pz, c[0], c[t], c[2 * t], c[3 * t], c[4 * t], c[5 * t],
          c[6 * t], c[7 * t], c[8 * t], c[9 * t], c[10 * t], c[11 * t],
          c[12 * t], c[13 * t], c[14 * t], c[15 * t], c[16 * t], c[17 * t],
          c[18 * t]);
      if (d < best_d) {
        best_d = d;
        best_i = leaf_start + k;
      }
    }
  }
};

template <bool kStream>
__global__ void rope_kernel(const float* __restrict__ pts,
                            const float* __restrict__ seed, Rope rope,
                            float* __restrict__ out_d, int* __restrict__ out_i,
                            int* __restrict__ out_lv, int n_buffers) {
  extern __shared__ float4 smem4[];
  __shared__ float scratch[32];
  float* slots = reinterpret_cast<float*>(smem4);
  rope.scratch = scratch;
  const int slot_floats = kPlanes * rope.tile_f;
  const size_t q = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float px = pts[q * 3], py = pts[q * 3 + 1], pz = pts[q * 3 + 2];
  float best_d = seed[q];
  int best_i = 0;
  int leaves = 0;
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
        rope.stage(slots, leaf_start);
        rope.scan(slots, leaf_start, px, py, pz, best_d, best_i);
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
          rope.prefetch(slots + slot * slot_floats, leaf_start);
          ++count;
        }
        node = (prune || is_leaf) ? skip : node + 1;
      }
      if (count == 0) break;
      cp_async_wait_at_most(count - 1);  // the oldest slot has landed
      __syncthreads();
      rope.scan(slots + head * slot_floats, ring[head], px, py, pz, best_d,
                best_i);
      ++leaves;
      head = (head + 1) % n_buffers;
      --count;
      // every thread is done with the slot before refill reuses it
      bound = block_reduce<MaxOp>(best_d, scratch);
    }
  }
  out_d[q] = best_d;
  out_i[q] = best_i;
  if (threadIdx.x == 0) out_lv[blockIdx.x] = leaves;
}

}  // namespace mt

// n_buffers: 0 for the resident entry, 2..16 for the streamed one (whose
// tile_f must be a multiple of 4 and whose rows must be 16-byte aligned).
// tile_q must be a multiple of 32 up to 1024 dividing q_pad; tile_f must
// divide f_pad.  Returns the launch's CUDA error code.
extern "C" int mt_rope_faces(const float* pts, const float* seed,
                             const float* boxes, const int* topo,
                             const float* rows, float* out_d, int* out_i,
                             int* out_lv, int q_pad, int n_nodes, int f_pad,
                             int tile_q, int tile_f, int n_buffers,
                             cudaStream_t stream) {
  using namespace mt;
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (q_pad <= 0) return 0;
  const bool stream_entry = n_buffers != 0;
  if (tile_q <= 0 || tile_q > 1024 || tile_q % 32 || q_pad % tile_q ||
      tile_f <= 0 || f_pad % tile_f ||
      (stream_entry && (n_buffers < 2 || n_buffers > kMaxBuffers ||
                        tile_f % 4 ||
                        reinterpret_cast<size_t>(rows) % 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(stream_entry ? n_buffers : 1) *
                      kPlanes * tile_f * sizeof(float);
  if (smem > 226 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  Rope rope{boxes, topo, rows, n_nodes, f_pad, tile_f, nullptr};
  const auto kernel = stream_entry ? rope_kernel<true> : rope_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<q_pad / tile_q, tile_q, smem, stream>>>(pts, seed, rope, out_d,
                                                   out_i, out_lv, n_buffers);
  return static_cast<int>(cudaGetLastError());
}
