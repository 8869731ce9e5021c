// BVH rope walk per query tile on Hopper (sm_90a), fast-tile leaf visit:
// the resident and the streamed entry of one kernel.
//
// Replaces: mesh_tpu/accel/pallas_bvh.py closest_point_pallas_bvh (kernel
// _make_rope_kernel) and mesh_tpu/accel/pallas_stream.py
// closest_point_pallas_bvh_stream (kernel _make_stream_kernel).
//
// The walk, its operands and both entries are rope_walk.cuh's.  Leaf
// layout: the fast tile's 19 face planes [19, Fp] in Morton face order; a
// staged leaf is its 19 x tile_f planes, rows as in device memory, and
// every thread folds them into its (best_d, best_i) with the fast tile and
// its degenerate tail (fast_pair<true>, csrc/face_cost.cuh) and a strict <.
//
// Bound on the H100: float32 issue on the pairs of the tested leaves (119
// operations a pair, the fast tile with its tail), against the planes of
// each tested leaf read once per query tile.  The walk's control costs two
// block reductions per node; the streamed ring hides the copy of the next
// leaves behind the scan of the current one.

#include "face_cost.cuh"
#include "rope_walk.cuh"

namespace mt {

constexpr int kPlanes = 19;

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
  if (tile_f <= 0 || f_pad % tile_f ||
      (n_buffers != 0 &&
       (tile_f % 4 || reinterpret_cast<size_t>(rows) % 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_rope_walk(pts, seed, Rope{boxes, topo, n_nodes, nullptr},
                          FastVisit{rows, f_pad, tile_f}, out_d, out_i,
                          out_lv, nullptr, q_pad, tile_q, n_buffers,
                          static_cast<size_t>(kPlanes) * tile_f *
                              sizeof(float),
                          stream);
}
