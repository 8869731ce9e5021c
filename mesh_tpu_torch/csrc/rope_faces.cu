// BVH rope walk per query tile on Hopper (sm_90a), fast-tile leaf visit:
// the resident and the streamed entry of one kernel.
//
// Replaces: mesh_tpu/accel/pallas_bvh.py closest_point_pallas_bvh (kernel
// _make_rope_kernel) and mesh_tpu/accel/pallas_stream.py
// closest_point_pallas_bvh_stream (kernel _make_stream_kernel).
//
// The walk, its operands and both entries are rope_walk.cuh's.  Leaf
// layout: the resident entry reads the fast tile's 19 face planes [19, Fp]
// in Morton face order; the streamed entry reads them as one record per
// face ([Fp, 20]: the 19 planes and a pad, built by the prologue), because
// cp.async copies only contiguous 16-byte pieces.  A staged leaf is one
// record per face either way, folded into (best_d, best_i) with the fast
// tile and its degenerate tail (FastCost<true>, csrc/face_cost.cuh) and a
// strict <.
//
// Bound on the H100: float32 issue on the pairs of the tested leaves (119
// operations a pair, the fast tile with its tail), against the planes of
// each tested leaf read once per query tile.  One thread folding a whole
// leaf is one dependent chain of tile_f pairs, and a grid of few query
// tiles (an avatar frame: 4096 queries, 32 tiles) puts one warp on each
// scheduler of a quarter of the SMs; and a pair read from 19 planes costs
// 19 shared loads.  So both entries run `lanes` threads per query
// (rope_walk.cuh's rope_lanes_kernel and rope_stream_kernel), each folding
// tile_f / lanes faces, which multiplies the warps in flight by `lanes` at
// the same work, and the fold reads a record as 5 float4.  The resident
// entry stages a leaf with every thread, reading 16 bytes of planes at a
// time; the streamed one copies records with every thread's cp.async into
// a ring, which hides the copy of the next leaves behind the fold of the
// current one.  The walk's control costs two block reductions per node.

#include "face_cost.cuh"
#include "rope_walk.cuh"

namespace mt {

constexpr int kPlanes = 19;

// The policy of both entries: a leaf staged as one record per face,
// FastCost's 19 planes and a pad, which the fold reads as 5 float4, so a
// pair costs 5 shared loads of 16 bytes instead of 19 of 4.  `rows` holds
// the planes [19, f_pad] for the resident entry (stage) and the records
// [f_pad, kRecord] for the streamed one (prefetch).
struct FastLanes {
  const float* rows;
  int f_pad, tile_f;
  bool vec;  // tile_f % 4 == 0 and rows 16-byte aligned: 16-byte copies

  struct Query {
    float px, py, pz;
  };
  static constexpr int kRecord = 4 * FastCost<true>::kVec;
  static constexpr bool kScreen = false;
  static constexpr bool kCountVisits = false;

  __device__ Query query(size_t, float px, float py, float pz) const {
    return {px, py, pz};
  }

  __device__ int leaf_faces() const { return tile_f; }

  __device__ int slot_floats() const { return kRecord * tile_f; }

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

  // Start the copy of a leaf's records into `slot` ([tile_f][kRecord]),
  // 16 bytes at a time, as one cp.async group of this thread (rows 16-byte
  // aligned).
  __device__ void prefetch(float* slot, int leaf_start) const {
    const float* src = rows + static_cast<size_t>(leaf_start) * kRecord;
    for (int i = threadIdx.x; i < (kRecord / 4) * tile_f; i += blockDim.x) {
      cp_async16(slot + 4 * i, src + 4 * i);
    }
    cp_async_commit();
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

// n_buffers: 0 for the resident entry (rope_lanes_kernel; rows the planes
// [19, f_pad]), 2..16 for the streamed one (rope_stream_kernel; rows the
// records [f_pad, 20], 16-byte aligned).  lanes: 1, 2, 4 or 8 threads per
// query, dividing tile_f, with tile_q x lanes up to 1024.  tile_q must be a
// multiple of 32 dividing q_pad; tile_f must divide f_pad; the staged
// leaves (one, or n_buffers) and the partials must fit 226 KB.  Returns the
// launch's CUDA error code.
extern "C" int mt_rope_faces(const float* pts, const float* seed,
                             const float* boxes, const int* topo,
                             const float* rows, float* out_d, int* out_i,
                             int* out_lv, int q_pad, int n_nodes, int f_pad,
                             int tile_q, int tile_f, int n_buffers, int lanes,
                             cudaStream_t stream) {
  using namespace mt;
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (q_pad <= 0) return 0;
  const bool aligned = reinterpret_cast<size_t>(rows) % 16 == 0;
  const bool vec = tile_f % 4 == 0 && aligned;
  if (tile_f <= 0 || f_pad % tile_f || lanes <= 0 || tile_f % lanes ||
      (n_buffers != 0 && !aligned)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Rope rope{boxes, topo, n_nodes, nullptr};
  const FastLanes policy{rows, f_pad, tile_f, vec};
  const size_t slot_bytes =
      static_cast<size_t>(FastLanes::kRecord) * tile_f * sizeof(float);
  if (n_buffers == 0) {
    return launch_rope_lanes(pts, seed, rope, policy, out_d, out_i, out_lv,
                             nullptr, q_pad, tile_q, lanes, slot_bytes,
                             stream);
  }
  return launch_rope_stream(pts, seed, rope, policy, out_d, out_i, out_lv,
                            nullptr, q_pad, tile_q, lanes, n_buffers,
                            slot_bytes, stream);
}
