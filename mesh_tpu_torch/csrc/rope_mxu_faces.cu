// BVH rope walk per query tile on Hopper (sm_90a), MXU-tile leaf visit
// with an optional bf16 screen: the resident and the streamed entry of one
// kernel.
//
// Replaces: mesh_tpu/accel/pallas_bvh.py closest_point_pallas_bvh_mxu
// (kernel _make_rope_kernel_mxu) and mesh_tpu/accel/pallas_stream.py
// closest_point_pallas_bvh_stream_mxu (kernel _make_stream_kernel_mxu).
//
// The walk, its operands, pruning, refill and frozen bound are
// rope_walk.cuh's, as for the fast tile's walk (rope_faces.cu).  Leaf
// layout: the MXU face record of csrc/mxu_cost.cuh (24 float32 per face:
// ab ac n a, the 11 planes, the reach), contiguous in Morton face order,
// so one leaf of tile_f faces is one block of 96 * tile_f bytes, copied
// in 16-byte pieces.  A staged leaf is folded with mxu_pair<true> (the
// reference visits with _sqdist_tile_mxu, tail on) and a strict <; each
// query also carries p2 = |p|^2, an operand.
//
// bf16 screen (use_bf16): before the full visit every thread tests its
// query against the faces of its run of the staged leaf,
//   max0(p2 - 2 (bf16(p) . bf16(a)) + a2) - 2^-6 (p2 + a2)
//       <= ub + 2 sqrt(max0(ub)) r + r^2,
// with ub the thread's running best (mesh_tpu/query/pallas_closest.py
// _mxu_screen_tile; bf16 rounding by __float2bfloat16_rn, as mxu_bound.cu).
// The block runs the full visit when any thread survives
// (__syncthreads_or: the reference's jnp.any over the query tile).  A leaf
// with no survivor holds no face that beats any running best, and a
// running best only tightens, so the screen skips only visits whose every
// pair would lose the strict <: faces and distances are bit-identical
// with and without the screen, and between the resident and the streamed
// entry.  Both entries run `lanes` threads per query (the resident one on
// rope_lanes_kernel, the streamed one on rope_stream_kernel), and each
// sub-lane screens its own run of the leaf, which decides every visit as
// one thread screening the whole leaf does (rope_walk.cuh's note).  Per
// query tile the kernel counts the leaves it took and the full visits it
// ran, the reference's screened and repaired.
//
// Bound on the H100: float32 issue on the pairs of the visited leaves (124
// operations a pair: the MXU tile with its tail) plus, under the screen,
// the screened pairs as the sub-lanes test them, each run up to its own
// first survivor (25 operations: three bf16 round trips counted as two
// each, the dot product 5, ap2~ 5, the envelope 2, the bound's 4, the
// subtract, the compare and the loop's exit test).  The walk's control is
// rope_walk.cuh's.  The staged leaves (one resident, a ring of n_buffers
// streamed) of 96 * tile_f bytes each and the sub-lanes' partials (8 bytes
// a thread) must fit the walk's 226 KB: 9 slots at tile_f 256.

#include "mxu_cost.cuh"
#include "rope_walk.cuh"

namespace mt {

template <bool kBf16>
struct MxuVisit {
  const float* rec;
  const float* p2;
  int tile_f;

  struct Query {
    float px, py, pz, p2, bx, by, bz;
  };
  static constexpr bool kScreen = kBf16;
  static constexpr bool kCountVisits = true;

  __device__ Query query(size_t q, float px, float py, float pz) const {
    return {px, py, pz, p2[q], bf16_round(px), bf16_round(py),
            bf16_round(pz)};
  }

  __device__ int leaf_faces() const { return tile_f; }

  __device__ int slot_floats() const { return kMxuRecord * tile_f; }

  // Copy a leaf's records into `slot` ([tile_f][24]) and wait for them.
  __device__ void stage(float* slot, int leaf_start) const {
    const float4* src = reinterpret_cast<const float4*>(rec) +
                        static_cast<size_t>(leaf_start) * kMxuVec;
    float4* dst = reinterpret_cast<float4*>(slot);
    for (int i = threadIdx.x; i < kMxuVec * tile_f; i += blockDim.x) {
      dst[i] = src[i];
    }
    __syncthreads();
  }

  // Start the copy of a leaf's records into `slot`, 16 bytes at a time, as
  // one cp.async group of this thread.
  __device__ void prefetch(float* slot, int leaf_start) const {
    const float* src = rec + static_cast<size_t>(leaf_start) * kMxuRecord;
    for (int i = threadIdx.x; i < kMxuVec * tile_f; i += blockDim.x) {
      cp_async16(slot + 4 * i, src + 4 * i);
    }
    cp_async_commit();
  }

  // Whether this thread's query may still beat ub on a face of [k0, k1)
  // of the staged leaf (the bf16 screen), testing up to the first survivor.
  __device__ bool survives(const float* slot, const Query& q, float ub,
                           int k0, int k1) const {
    const float su = sqrtf(max0(ub));
    const float su2 = su + su;
    for (int k = k0; k < k1; ++k) {
      const float* r = slot + k * kMxuRecord;
      const float pa = q.bx * bf16_round(r[9]) + q.by * bf16_round(r[10]) +
                       q.bz * bf16_round(r[11]);
      const float ap2t = max0(q.p2 - (pa + pa) + r[15]);
      const float env = kMxuBf16Eps * (q.p2 + r[15]);
      const float reach = r[23];
      if (ap2t - env <= ub + su2 * reach + reach * reach) return true;
    }
    return false;
  }

  // Fold faces [k0, k1) of a staged leaf into (d, i) in increasing face
  // order with a strict <; i = base + the face's position in the leaf.
  __device__ void fold(const float* slot, int k0, int k1, int base,
                       const Query& q, float& d, int& i) const {
    const float4* s4 = reinterpret_cast<const float4*>(slot);
    for (int k = k0; k < k1; ++k) {
      const float dk =
          mxu_pair<true>(q.px, q.py, q.pz, q.p2, s4 + k * kMxuVec);
      if (dk < d) {
        d = dk;
        i = base + k;
      }
    }
  }
};

}  // namespace mt

// pts [q_pad, 3], p2 [q_pad], seed [q_pad], boxes [n_nodes, 6], topo
// [n_nodes, 2] int32, rec [f_pad, 24] (16-byte aligned) float32; out_d,
// out_i [q_pad]; out_lv and out_rep [q_pad / tile_q] int32.  n_buffers: 0
// for the resident entry (rope_lanes_kernel), 2..16 for the streamed one
// (rope_stream_kernel).  lanes: 1, 2, 4 or 8 threads per query, dividing
// tile_f, with tile_q x lanes up to 1024.  tile_q must be a multiple of 32
// dividing q_pad; tile_f must divide f_pad; the staged leaves (one, or
// n_buffers) and the partials must fit 226 KB.  Returns the launch's CUDA
// error code.
extern "C" int mt_rope_mxu_faces(const float* pts, const float* p2,
                                 const float* seed, const float* boxes,
                                 const int* topo, const float* rec,
                                 float* out_d, int* out_i, int* out_lv,
                                 int* out_rep, int q_pad, int n_nodes,
                                 int f_pad, int tile_q, int tile_f,
                                 int n_buffers, int use_bf16, int lanes,
                                 cudaStream_t stream) {
  using namespace mt;
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (q_pad <= 0) return 0;
  if (tile_f <= 0 || f_pad % tile_f || lanes <= 0 || tile_f % lanes ||
      reinterpret_cast<size_t>(rec) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Rope rope{boxes, topo, n_nodes, nullptr};
  const size_t slot_bytes =
      static_cast<size_t>(kMxuRecord) * tile_f * sizeof(float);
  if (use_bf16) {
    const MxuVisit<true> policy{rec, p2, tile_f};
    if (n_buffers == 0) {
      return launch_rope_lanes(pts, seed, rope, policy, out_d, out_i, out_lv,
                               out_rep, q_pad, tile_q, lanes, slot_bytes,
                               stream);
    }
    return launch_rope_stream(pts, seed, rope, policy, out_d, out_i, out_lv,
                              out_rep, q_pad, tile_q, lanes, n_buffers,
                              slot_bytes, stream);
  }
  const MxuVisit<false> policy{rec, p2, tile_f};
  if (n_buffers == 0) {
    return launch_rope_lanes(pts, seed, rope, policy, out_d, out_i, out_lv,
                             out_rep, q_pad, tile_q, lanes, slot_bytes,
                             stream);
  }
  return launch_rope_stream(pts, seed, rope, policy, out_d, out_i, out_lv,
                            out_rep, q_pad, tile_q, lanes, n_buffers,
                            slot_bytes, stream);
}
