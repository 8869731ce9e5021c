// Exact per-warp chunk cull of the brute-force closest-face argmin on
// Hopper (sm_90a): the loop of closest_faces.cu, for both folds of
// csrc/argmin.cuh (ExactFold, and FusedFold's packed keys) over both cost
// functors of csrc/face_cost.cuh.  Its answers are the every-face kernel's
// (closest_faces_every.cu, argmin_kernel) bit for bit, on every input.
//
// Bound on the H100: float32 issue.  The every-face kernel issues an add,
// multiply, compare or select for each of the 88 to 151 operations of
// every pair and 5 to 7 shared loads a pair, about 90-95% of the SM's
// instruction rate on the main path (256 meshes x 1024 queries x 13,776
// faces): no staging or tensor-core scheme helps, and fused multiply-adds
// would break the op-for-op equality with the plain versions.  The one
// lever is to evaluate fewer pairs.
//
// Operands (mesh_tpu_torch/query/closest_kernel.py cull_operands): the
// kernel's pts [B, Q, 3] and planes [B, 19, F] as before, qorder [B, Q]
// int32 (each mesh's queries in Morton order, a permutation) and records
// [B, C, 12] float32, C = ceil(F / 32), three float4 per chunk of 32
// consecutive faces in index order: the center of the box around the
// chunk's corners and its half diagonal h; the half extents and e1;
// corner a of the chunk's first face and e2 (cull_records).  Outputs: the
// face per query at out[b, qorder[b, q]], and on request the chunks each
// warp folded, the real faces of the chunks each query's own lane needed
// (at its sorted position q) and the chunks each warp staged.
//
// Design.  Lane q of block q / 128 of mesh b owns query qorder[b, q], so a
// warp holds 32 queries that are close in space.  Before the walk the lane
// takes the chunk whose representative (corner a of its first face) is
// nearest and evaluates that face's cost with the tile's own functor: the
// seed.  The fold still starts from +inf (ExactFold::start,
// FusedFold::start); the seed only gates.  The walk takes the chunks in
// index order.  A lane needs chunk k unless lb2 > thr, with lb2 its bound
// to the chunk (cull_lb2 below) and thr = min(best_d, seed) for the exact
// fold or, for the fused fold, the float whose bits are min(best_key,
// seed_key) with the tile's low bits set.  Written !(lb2 > thr), a NaN
// bound or threshold is always needed.  A warp folds a chunk when one of
// its lanes needs it (__any_sync), and then every lane of it folds every
// face of the chunk: no divergence, and a lower best for the lanes that
// did not need it.  Each warp stages its own chunks, one chunk ahead, into
// its own cp.async double buffer in shared memory: the vote for the next
// chunk is taken before the current one is folded, against a best that
// can only fall, so it keeps a superset of what the lanes need when the
// chunk comes.  No barrier couples the block's warps: a warp waits only
// for its own copies, and the other warps of the SM fill the issue slots
// meanwhile.  (A block-wide vote and staging, as culled_faces.cu has,
// staged 40% of the chunks for the warps' 21% and took 4.12 ms on the
// main path against 3.32 for this loop, in one A/B on the H100; PERF.md
// section 6.)  A chunk's planes come from L2: a mesh's 1 MB is read by
// its 32 warps, launched together.
//
// Why the answers do not change.
// (1) A fold in increasing face order with a strict < over any superset of
//     {the winner} and {every face costing no more than the final best}
//     gives the every-face answer: the least cost over the superset is the
//     least over all faces, and the first face reaching it is the first
//     over all faces, since every face reaching it is in the superset.
//     For the fused fold read keys for costs: the answer is the first
//     column of the least key.
// (2) The seed is a cost (or key) that the kernel itself computes for a
//     real face of the mesh, so the final best m* is at most the seed,
//     and at most the running best; hence m* <= thr at every chunk.
// (3) A lane skips chunk k only when lb2 > thr >= m*.  If every face f of
//     the chunk has a computed cost c_f >= lb2 (below), then c_f > m*: no
//     such face is the winner or reaches the final best.  The warp skips a
//     chunk only when all its lanes do.  With (1), the answer stands.
//     Fused: a key is at least the bucket of its cost, bits(c) & ~mask,
//     and bits order non-negative floats; c_f >= lb2 > float(K | mask)
//     makes bucket(c_f) > bucket(K) >= bucket(K*), so every key of the
//     chunk exceeds K* (the best key) strictly, and no skipped column can
//     win even in an earlier tile.
// (4) c_f >= lb2.  Let T be the triangle the functor measures, in exact
//     arithmetic: corners a, a + ab, a + ac from the fast tile's planes (the
//     box is widened for the float32 rounding of those sums), the three
//     corners of the sliver-safe tile.  Every corner lies in the chunk's
//     box, so dist(p, T)^2 >= D^2, D the distance from p to the box; the
//     computed D^2 is within a factor 1 + 6u and 8u R^2 of its value (u =
//     2^-24, R = |p - center| + 3h, which bounds |p - a| + the longest
//     edge L); the shrink (1 - 1e-3)^2 and E's first term cover that.
//     What remains is c_f >= dist(p, T)^2 - E_f, E_f <= E = R^2 e1 + (R^2
//     e2)^2 with the chunk's e1 = u (64 + 40 S + 96 G), e2 = 128 u Lambda
//     (maxima over its faces; cull_records).  From the tile's operation
//     chain, with |d_i| <= L R and each d_i, computed, within 8u L R, and
//     va, vb, vc within 36u L^2 R^2 (two products of d's and a difference):
//     - the vertex forms ap2, bp2, cp2 are squared distances to corners of
//       T, each within 10u R^2 of its value (bp2 = ap2 - 2 d1 + ab2 and
//       cp2 cancel to no more than that);
//     - an edge form is taken only with its foot tests (d1 >= 0, d3 <= 0
//       for ab, and their twins), so the true foot lies within 8u R of the
//       segment and the form is at least the squared distance to the
//       segment, hence to T, less 21u R^2.  The fast tile's bc form
//       subtracts d_bc^2 inv_bc2, whose inv_bc2 is the reciprocal of the
//       corners' own fl(c - b) squared, not of |ac - ab|^2: for a short bc
//       that term's relative error reaches 6u L / |bc| plus 32u R^2 L / |bc|
//       from d_bc's rounding, so G = L / |bc| enters with a factor 40 (96
//       with the doubling below).  The sliver-safe tile's clamped residual
//       forms |ap - t ab|^2 are distances to points of T for any t, within
//       10u R^2; so are the degenerate tail's segment forms (21u R^2).
//       These are the rounding the 1e-3 shrink covers in culled_faces.cu;
//       here they are absolute terms, since the main path's reference has
//       no cull to inherit a margin from, and the fast tile's edge forms
//       ap2 - d1^2 inv_ab2 cancel when |p - a| is far above the bound.
//     - the interior form n_ap^2 inv_n2 is the squared distance to the
//       plane through a normal to the computed n, within 15u |ap|^2 of its
//       value; n is within 16u |ab||ac| of ab x ac, which tilts the plane
//       by up to 16u S (S = |ab||ac| / |n|) and lowers the distance by
//       less than 17u S R^2.  The form is taken when no vertex or edge test
//       holds.  If p's projection lies outside T, it lies in one exterior
//       region of Ericson's partition, whose tests all hold exactly; for
//       the computed ones to fail, some d_i or v lies within its error of
//       0, and each case (an edge region with v within 36u L^2 R^2 of 0,
//       or a foot test failing near a vertex, where the vertex test's
//       second d then bounds the height, and the vertex regions likewise)
//       puts the projection within delta <= 52u R^2 Lambda of T, Lambda =
//       L^2 / (|n| e_min) over the shortest edge e_min.  Then dist(p, T)^2
//       <= plane^2 + delta^2, and (128u R^2 Lambda)^2 covers delta^2.
//     Every bound above is doubled in e1 and e2 for the first-order
//     accounting.  A face that fails the premises makes its chunk always
//     needed (e1 = +inf): a non-finite plane, S or G above 1e4 (so the
//     squared terms stay below the linear ones), or, without the tail,
//     inv_n2 <= 0, whose interior cost is 0 wherever p lies.  With the
//     tail, a face with !(inv_n2 > 0) takes the tail's forms and adds no
//     conditioning term.
// (5) Overflow: a chunk with R > 1e9 is always needed.  Below it every d_i
//     and product of two is finite (L <= R, |d_i| <= R^2 = 1e18), so a
//     finite face's cost is finite or +inf (n_ap^2 overflowing times a
//     positive inv_n2), never a NaN that the exact fold's fmaxf would turn
//     into 0.  A NaN query makes every bound NaN: always needed.
//
// On the CPU tensors get closest_kernel.argmin_faces_plain; the plain
// version of this design, argmin_faces_culled_plain, makes the same
// decisions and counts (each warp's vote one chunk ahead included), so
// chip_smoke holds the kernel to it on faces and counts, and to the
// every-face kernel on faces.
//
// A functor with a per-query vector (argmin.cuh's kQueryVec: the
// normal-weighted cost of normal_weighted_faces.cu) runs the same loop
// with what CullExtra carries: each lane reads its vector at its own qi
// and the launch's scalar parameter; its seed comes from a pass of its
// own (seeds, one per sorted lane); the functor turns the chunk's
// squared bound into a bound on its cost (Cost::lower, with the lane's
// term Cost::lane_floor); gridDim.z warps may share a warp's chunks,
// split s taking [s C / split, (s + 1) C / split) and writing its
// (best_d, best_i) for cull_merge_kernel, and its counts at split s.
// Every such branch is an if constexpr on QueryVec<Cost>, so the
// closest-face functors compile to the code above (their registers,
// spills and times unchanged on the H100; PERF.md, row 7).
// normal_weighted_faces.cu's note proves that functor's bound.

#pragma once

#include "argmin.cuh"
#include "face_cost.cuh"

namespace mt {

constexpr int kCullChunk = 32;     // faces per chunk
constexpr int kCullThreads = 128;  // queries per block, four warps

// (1 - 1e-3)^2: the box bound's shrink of a squared distance
constexpr float kCullShrink2 = 0.998f;

// past this R (distance to the box center plus three half diagonals) a
// chunk is always needed: below it no product of the tile overflows
constexpr float kCullFar = 1e9f;

// What a lane holds its chunk bounds against: the seed, and the threshold
// of item (2) of the note from the fold's running best.
template <class Fold>
struct CullGate;

template <>
struct CullGate<ExactFold> {
  float seed;
  __device__ void set(const ExactFold&, float d, int) { seed = d; }
  __device__ float threshold(const ExactFold& f) const {
    return fminf(f.best_d, seed);
  }
};

template <>
struct CullGate<FusedFold> {
  int seed;
  __device__ void set(const FusedFold& f, float d, int col) {
    seed = (__float_as_int(d) & ~f.mask) | (col & f.mask);
  }
  __device__ float threshold(const FusedFold& f) const {
    return __int_as_float(min(f.best_key, seed) | f.mask);
  }
};

// What a lane of a query-vector functor reads and writes beyond the
// closest-face operands (empty for the closest-face functors, whose
// kernels keep their parameters): the vectors [B, Q, 3], a per-mesh
// bound [B] that Cost::lane_floor reads, the seeds [B, Q] of the sorted
// lanes, each split's (best_d, best_i) [split, B, Q] (null at split 1: the
// kernel writes out), and the launch's scalar parameter.
template <class Cost, bool = QueryVec<Cost>::value>
struct CullExtra {};

template <class Cost>
struct CullExtra<Cost, true> {
  const float* vecs;
  const float* bounds;
  const float* seeds;
  float* part_d;
  int* part_i;
  float param;
};

// The first face of the chunk whose representative (record float4 2) is
// nearest to p: the seed's face (a NaN distance is never taken).
__device__ __forceinline__ int cull_seed_face(const float4* rec,
                                              int n_chunks, float px,
                                              float py, float pz) {
  float near = CUDART_INF_F;
  int ks = 0;
  for (int k = 0; k < n_chunks; ++k) {
    const float4 r = __ldg(rec + 3 * k + 2);
    const float dx = px - r.x, dy = py - r.y, dz = pz - r.z;
    const float d = dx * dx + dy * dy + dz * dz;
    if (d < near) {
      near = d;
      ks = k;
    }
  }
  return ks * kCullChunk;
}

template <class Cost, class Fold>
__global__ void __launch_bounds__(kCullThreads)
closest_cull_kernel(const float* __restrict__ pts,
                    const int* __restrict__ qorder,
                    const float* __restrict__ planes,
                    const float4* __restrict__ recs, int* __restrict__ out,
                    int* __restrict__ warp_chunks,
                    int* __restrict__ lane_faces,
                    int* __restrict__ warp_stages, int n_q, int n_f,
                    int tile_f, CullExtra<Cost> ex) {
  using S = Staging<Cost>;
  constexpr bool kQuery = QueryVec<Cost>::value;
  constexpr int kWords = 4 * Cost::kVec;  // one face's record
  constexpr int kWarps = kCullThreads / 32;
  __shared__ float4 ring[kWarps][2][kCullChunk * Cost::kVec];
  const int b = blockIdx.y;
  const int q = blockIdx.x * kCullThreads + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_chunks = (n_f + kCullChunk - 1) / kCullChunk;
  const float* c = planes + static_cast<size_t>(b) * Cost::kRows * n_f;
  const float4* rec = recs + static_cast<size_t>(b) * n_chunks * 3;
  // this split's chunks [k_lo, k_hi) and the offset of its outputs
  const int s = kQuery ? static_cast<int>(blockIdx.z) : 0;
  const long long n_ll = n_chunks;
  const int k_lo = kQuery ? static_cast<int>(n_ll * s / gridDim.z) : 0;
  const int k_hi =
      kQuery ? static_cast<int>(n_ll * (s + 1) / gridDim.z) : n_chunks;
  const size_t n_split = static_cast<size_t>(s) * gridDim.y;

  bool valid = q < n_q;
  if (!__any_sync(0xffffffffu, valid)) return;  // a warp past the queries
  int qi = 0;
  if (valid) {
    qi = qorder[static_cast<size_t>(b) * n_q + q];
    valid = qi >= 0 && qi < n_q;
  }
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  if (valid) {
    const size_t at = (static_cast<size_t>(b) * n_q + qi) * 3;
    px = pts[at];
    py = pts[at + 1];
    pz = pts[at + 2];
    if constexpr (kQuery) {
      nx = ex.vecs[at];
      ny = ex.vecs[at + 1];
      nz = ex.vecs[at + 2];
    }
  }
  // the pair's cost from a staged face record
  auto pair = [&](const float4* t) {
    if constexpr (kQuery) {
      return Cost::cost(px, py, pz, nx, ny, nz, ex.param, t);
    } else {
      return Cost::cost(px, py, pz, t);
    }
  };

  Fold fold;
  fold.start(tile_f);
  CullGate<Fold> gate;
  float lane_floor = 0.0f;  // the lane's term of Cost::lower
  if constexpr (kQuery) {
    lane_floor = Cost::lane_floor(nx, ny, nz, ex.param, ex.bounds[b]);
    gate.set(fold,
             valid ? ex.seeds[static_cast<size_t>(b) * n_q + q]
                   : CUDART_INF_F,
             0);
  } else {
    // the seed: the cost of the first face of the chunk whose
    // representative is nearest
    const int fs = cull_seed_face(rec, n_chunks, px, py, pz);
    float4 face[Cost::kVec];
    Cost::stage(c, n_f, fs, reinterpret_cast<float*>(face));
    gate.set(fold, pair(face), fs);
  }

  // this lane's squared lower bound to chunk k's computed costs (note,
  // items 4 and 5)
  auto cull_lb2 = [&](int k) {
    const float4 s0 = __ldg(rec + 3 * k);      // box center, half diagonal
    const float4 s1 = __ldg(rec + 3 * k + 1);  // half extents, e1
    const float e2 = __ldg(rec + 3 * k + 2).w;
    const float dx = px - s0.x, dy = py - s0.y, dz = pz - s0.z;
    const float big = sqrtf(dx * dx + dy * dy + dz * dz) + 3.0f * s0.w;
    const float ox = max0(fabsf(dx) - s1.x);
    const float oy = max0(fabsf(dy) - s1.y);
    const float oz = max0(fabsf(dz) - s1.z);
    const float big2 = big * big;
    const float t = big2 * e2;
    const float lb2 = (ox * ox + oy * oy + oz * oz) * kCullShrink2 -
                      (big2 * s1.w + t * t);
    return big <= kCullFar ? lb2 : -CUDART_INF_F;
  };
  auto needs = [&](float lb2) {
    if constexpr (kQuery) {
      return valid &&
             !(Cost::lower(lb2, lane_floor) > gate.threshold(fold));
    } else {
      return valid && !(lb2 > gate.threshold(fold));
    }
  };
  // the first chunk in [k, k_hi) that a lane of the warp needs against its
  // best so far (k_hi: none), by one warp vote a chunk; *lb2 receives this
  // lane's bound to it
  auto next_chunk = [&](int k, float* lb2) {
    for (; k < k_hi; ++k) {
      *lb2 = cull_lb2(k);
      if (__any_sync(0xffffffffu, needs(*lb2))) return k;
    }
    return k_hi;
  };
  // chunk k's planes into this warp's ring[slot], as one cp.async group of
  // this lane: copy j of the lane takes face (j / groups) * 8 + lane % 8
  // and plane (j % groups) * 4 + lane / 8, so a copy instruction reads four
  // 32-byte rows and writes 32 distinct banks (face records of 4 * kVec
  // words: 20 or 28; the normal-weighted record's 24 take two ways)
  auto stage = [&](int k, int slot) {
    const int c0 = k * kCullChunk;
    const int nf = min(kCullChunk, n_f - c0);
    float* dst = reinterpret_cast<float*>(ring[warp][slot]);
    constexpr int kGroups = (S::kCopy + 3) / 4;
#pragma unroll
    for (int j = 0; j < (kCullChunk / 8) * kGroups; ++j) {
      const int f = (j / kGroups) * 8 + (lane & 7);
      const int p = (j % kGroups) * 4 + (lane >> 3);
      if (p < S::kCopy && f < nf) {
        cp_async4(dst + f * kWords + S::slot(p),
                  c + static_cast<size_t>(S::row(p)) * n_f + c0 + f);
      }
    }
    cp_async_commit();
  };

  float lb2 = 0.0f;
  int n_fold = 0, n_lane = 0, n_stage = 0;
  int k = next_chunk(k_lo, &lb2);
  if (k < k_hi) stage(k, 0);
  for (int slot = 0; k < k_hi; slot ^= 1) {
    ++n_stage;
    const bool need = needs(lb2);  // against the best after chunks < k
    const int nxt = next_chunk(k + 1, &lb2);
    if (nxt < k_hi) {
      stage(nxt, slot ^ 1);
      cp_async_wait<1>();  // chunk k's group has landed
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int c0 = k * kCullChunk;
    const int nf = min(kCullChunk, n_f - c0);
    float4* t = ring[warp][slot];
    if (S::kDerive) {
      if (lane < nf) S::derive(reinterpret_cast<float*>(t) + lane * kWords);
      __syncwarp();
    }
    if (__any_sync(0xffffffffu, need)) {
      ++n_fold;
#pragma unroll 4
      for (int i = 0; i < nf; ++i) {
        fold.add(pair(t + i * Cost::kVec), c0 + i);
      }
    }
    if (need) n_lane += nf;
    __syncwarp();  // every lane is done with ring[warp][slot]
    k = nxt;
  }

  if (valid) {
    const size_t at = static_cast<size_t>(b) * n_q + qi;
    if constexpr (kQuery) {
      if (ex.part_d != nullptr) {
        ex.part_d[n_split * n_q + at] = fold.best_d;
        ex.part_i[n_split * n_q + at] = fold.best_i;
      } else {
        out[at] = fold.result();
      }
    } else {
      out[at] = fold.result();
    }
  }
  if (warp_chunks == nullptr) return;
  if (q < n_q) {
    lane_faces[(n_split + b) * n_q + q] = n_lane;
  }
  if (lane == 0) {
    const size_t at = (n_split + b) * ((n_q + 31) / 32) + (q >> 5);
    warp_chunks[at] = n_fold;
    warp_stages[at] = n_stage;
  }
}

// The splits' (best_d, best_i) [split, n] folded in split order with a
// strict <: the face of each of the n queries (the merge of the split
// culls of mxu_cull.cuh and normal_weighted_faces.cu).
__global__ void cull_merge_kernel(const float* __restrict__ part_d,
                                  const int* __restrict__ part_i,
                                  int* __restrict__ out, long long n,
                                  int split) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (q >= n) return;
  float best_d = part_d[q];
  int best_i = part_i[q];
  for (int s = 1; s < split; ++s) {
    const float d = part_d[s * n + q];
    if (d < best_d) {
      best_d = d;
      best_i = part_i[s * n + q];
    }
  }
  out[q] = best_i;
}

// Launches one culled argmin over the batch on `stream` (tile_f: the fused
// fold's power-of-two face tile, unused by the exact one); returns the
// launch's cudaGetLastError().
template <class Cost, class Fold>
int launch_cull(const float* pts, const int* qorder, const float* planes,
                const float* recs, int* out, int* warp_chunks,
                int* lane_faces, int* warp_stages, int n_b, int n_q,
                int n_f, int tile_f, cudaStream_t stream) {
  const dim3 grid((n_q + kCullThreads - 1) / kCullThreads, n_b);
  closest_cull_kernel<Cost, Fold><<<grid, kCullThreads, 0, stream>>>(
      pts, qorder, planes, reinterpret_cast<const float4*>(recs), out,
      warp_chunks, lane_faces, warp_stages, n_q, n_f, tile_f,
      CullExtra<Cost>{});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mt
