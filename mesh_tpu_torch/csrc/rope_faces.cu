// BVH rope walk per query tile on Hopper (sm_90a), fast-tile leaf visit:
// the resident and the streamed entry of one kernel.
//
// Replaces: mesh_tpu/accel/pallas_bvh.py closest_point_pallas_bvh (kernel
// _make_rope_kernel) and mesh_tpu/accel/pallas_stream.py
// closest_point_pallas_bvh_stream (kernel _make_stream_kernel).
//
// The walk, its operands and both entries are rope_walk.cuh's.  Leaf
// layout: the fast tile's 19 face planes [19, Fp] in Morton face order; a
// staged leaf is folded into (best_d, best_i) with the fast tile and its
// degenerate tail (fast_pair<true>, csrc/face_cost.cuh) and a strict <.
//
// Bound on the H100: float32 issue on the pairs of the tested leaves (119
// operations a pair, the fast tile with its tail), against the planes of
// each tested leaf read once per query tile.  One thread folding a whole
// leaf is one dependent chain of tile_f pairs, and a grid of few query
// tiles (an avatar frame: 4096 queries, 32 tiles) puts one warp on each
// scheduler of a quarter of the SMs; and a pair read from 19 planes costs
// 19 shared loads.  So the resident entry runs rope_lanes_kernel: `lanes`
// threads per query, each folding tile_f / lanes faces, which multiplies
// the warps in flight by `lanes` at the same work; every thread of the
// block stages a leaf, reading 16 bytes at a time, into one 20-float
// record per face, which the fold reads as 5 float4.  The walk's control
// costs two block reductions per node; the streamed entry (one thread per
// query) hides the copy of the next leaves behind the scan of the current
// one with its ring.

#include "face_cost.cuh"
#include "rope_walk.cuh"

namespace mt {

constexpr int kPlanes = 19;

// The streamed entry's policy (rope_walk_kernel): a leaf staged as its 19
// planes, rows as in device memory.
struct FastVisit {
  const float* rows;
  int f_pad, tile_f;

  struct Query {
    float px, py, pz;
  };

  __device__ Query query(size_t, float px, float py, float pz) const {
    return {px, py, pz};
  }

  __device__ int slot_floats() const { return kPlanes * tile_f; }

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
  __device__ bool visit(const float* slot, int leaf_start, const Query& q,
                        float& best_d, int& best_i) const {
    const int t = tile_f;
    for (int k = 0; k < t; ++k) {
      const float* c = slot + k;
      const float d = fast_pair<true>(
          q.px, q.py, q.pz, c[0], c[t], c[2 * t], c[3 * t], c[4 * t],
          c[5 * t], c[6 * t], c[7 * t], c[8 * t], c[9 * t], c[10 * t],
          c[11 * t], c[12 * t], c[13 * t], c[14 * t], c[15 * t], c[16 * t],
          c[17 * t], c[18 * t]);
      if (d < best_d) {
        best_d = d;
        best_i = leaf_start + k;
      }
    }
    return true;
  }
};

// The resident entry's policy (rope_lanes_kernel): a leaf staged as one
// record per face, FastCost's 19 planes and a pad, which the fold reads as
// 5 float4, so a pair costs 5 shared loads of 16 bytes instead of 19 of 4.
struct FastLanes {
  const float* rows;
  int f_pad, tile_f;
  bool vec;  // tile_f % 4 == 0 and rows 16-byte aligned: 16-byte copies

  using Query = FastVisit::Query;
  static constexpr int kRecord = 4 * FastCost<true>::kVec;

  __device__ Query query(size_t, float px, float py, float pz) const {
    return {px, py, pz};
  }

  __device__ int leaf_faces() const { return tile_f; }

  // Copy a leaf into `slot` as records ([tile_f][kRecord]) with every
  // thread of the block, and wait for it.  A thread reads 16 bytes, four
  // faces of one plane, and writes them into four records; consecutive
  // threads take consecutive planes, so their writes fall in distinct
  // banks.  The records' pads stay unwritten: the fold never reads them.
  __device__ void stage(float* slot, int leaf_start) const {
    if (vec) {
      const int n4 = tile_f >> 2;
#pragma unroll 4
      for (int i = threadIdx.x; i < kPlanes * n4; i += blockDim.x) {
        const int j = i / kPlanes, r = i - j * kPlanes;
        const float4 x = *reinterpret_cast<const float4*>(
            rows + static_cast<size_t>(r) * f_pad + leaf_start + 4 * j);
        float* dst = slot + 4 * j * kRecord + r;
        dst[0] = x.x;
        dst[kRecord] = x.y;
        dst[2 * kRecord] = x.z;
        dst[3 * kRecord] = x.w;
      }
    } else {
      for (int j = threadIdx.x; j < tile_f; j += blockDim.x) {
        FastCost<true>::stage(rows + leaf_start, f_pad, j,
                              slot + j * kRecord);
      }
    }
    __syncthreads();
  }

  // Fold records [k0, k1) of a staged leaf into (d, i) in increasing face
  // order with a strict <; i = base + the face's position in the leaf.
  __device__ void fold(const float* slot, int k0, int k1, int base,
                       const Query& q, float& d, int& i) const {
    const float4* s4 = reinterpret_cast<const float4*>(slot);
    for (int k = k0; k < k1; ++k) {
      const float dk = FastCost<true>::cost(
          q.px, q.py, q.pz, s4 + k * FastCost<true>::kVec);
      if (dk < d) {
        d = dk;
        i = base + k;
      }
    }
  }
};

}  // namespace mt

// n_buffers: 0 for the resident entry (rope_lanes_kernel with `lanes` of
// 1, 2, 4 or 8 threads per query, lanes dividing tile_f and tile_q x
// lanes up to 1024), 2..16 for the streamed one (lanes must be 1; tile_f a
// multiple of 4 and rows 16-byte aligned).  tile_q must be a multiple of
// 32 dividing q_pad; tile_f must divide f_pad.  Returns the launch's CUDA
// error code.
extern "C" int mt_rope_faces(const float* pts, const float* seed,
                             const float* boxes, const int* topo,
                             const float* rows, float* out_d, int* out_i,
                             int* out_lv, int q_pad, int n_nodes, int f_pad,
                             int tile_q, int tile_f, int n_buffers, int lanes,
                             cudaStream_t stream) {
  using namespace mt;
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (q_pad <= 0) return 0;
  const bool vec =
      tile_f % 4 == 0 && reinterpret_cast<size_t>(rows) % 16 == 0;
  if (tile_f <= 0 || f_pad % tile_f || lanes <= 0 || tile_f % lanes ||
      (n_buffers != 0 && (!vec || lanes != 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Rope rope{boxes, topo, n_nodes, nullptr};
  if (n_buffers == 0) {
    return launch_rope_lanes(
        pts, seed, rope, FastLanes{rows, f_pad, tile_f, vec}, out_d, out_i,
        out_lv, q_pad, tile_q, lanes,
        static_cast<size_t>(FastLanes::kRecord) * tile_f * sizeof(float),
        stream);
  }
  return launch_rope_walk(
      pts, seed, rope, FastVisit{rows, f_pad, tile_f}, out_d, out_i, out_lv,
      nullptr, q_pad, tile_q, n_buffers,
      static_cast<size_t>(kPlanes) * tile_f * sizeof(float), stream);
}
