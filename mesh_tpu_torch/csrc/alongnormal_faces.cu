// Nearest face along the query normal on Hopper (sm_90a), by an exact
// per-warp chunk cull: the registration path's kernel.  Per query, the face
// whose hit on the line p + t n (t of either sign) has the least |t|
// (csrc/along_cost.cuh; a miss costs kBig), the lowest face index on exact
// ties, face 0 when nothing is hit.
//
// Replaces: mesh_tpu/query/pallas_ray.py nearest_alongnormal_pallas
// (make_argmin_kernel over _alongnormal_cost_tile).  The reference folds
// every face of every tile; this kernel gives the same faces, bit for bit,
// on every input, as the every-face kernel (alongnormal_faces_every.cu)
// that chip_smoke.py holds it to.
//
// Bound on the H100: float32 issue on what the cull lets through.  A pair
// costs about 67 operations (along_cost.cuh).  Around the pairs a lane runs
// the chunk test of csrc/ray_cull.cuh on each chunk of its range (69
// operations, and 226 more where the normal cone fails the guard), the
// bound of item 3 on the chunks its line meets, and, in a pass of its own,
// a seed (two distances per chunk and the pairs of four chunks).  The
// every-face kernel issues every pair at about a third of the card's
// float32 rate (a division a pair): the cull is what the design does about
// the bound.  What is left is mostly the chunk tests, not the folds: every
// lane tests every chunk of its range, and on phase 8's scan three in five
// of the tests fall back to the faces' normals (PERF.md, row 9, gives the
// kernel's time without its folds and without its fallback).
//
// Operands (mesh_tpu_torch/query/ray_kernel.py alongnormal_cull_operands,
// the face side made once per mesh): pts, normals [B, Q, 3]; qorder [B, Q]
// int32, each mesh's queries in Morton order (a permutation); faces [B, Fp,
// 12] and chunks [B, C, 20] float32, row 8's operands (any_hit_sorted_faces
// and any_hit_records: the faces in the Morton order of their centroids,
// edge-padded to C chunks of 32, Fp = 32 C; a face record a, e1, e2 and
// its unit normal over rho_f; a chunk record of 5 float4, ray_cull.cuh);
// ids [B, Fp] int32, the original index of each sorted position (padding
// repeats the last); min_ids [B, C] int32, the least original index of
// each chunk's real faces.  Scratch: seeds [B, Q] and, for split > 1,
// part_d and part_i [split, B, Q].  Outputs: the face per query at out[b,
// qorder[b, q]], and on request, per split, the chunks each warp folded,
// the real faces of the chunks each lane needed (at its sorted position),
// the chunks each warp staged and the chunks each lane folded as one miss
// candidate (item 2), [split, B, ceil(Q / 32)] and [split, B, Q].
//
// Design: three launches.  along_seed_kernel, one thread a sorted lane,
// folds the faces of the kSeedChunks chunks nearest to p: the seed (item 6;
// on phase 8's scan points a seed over four chunks is the lane's best cost
// for 93% of the lanes, over one for 46%, and the warps then fold 13.0% of
// the chunks at split 16 against 18.9%: tools/cull_counts.py --along
// --seed-chunks 1).  along_cull_kernel: lane q of block q / 128 owns query
// qorder[b, q], so a warp holds 32 points close in space (Morton codes in
// the mesh's box: ray_kernel.py along_query_order).  The lane walks the
// chunks of its split's range in order, runs chunk_needed on each (the whole
// line: no t_lo) and turns it into one of three outcomes: the line misses
// the chunk's grown box (item 2: the lane folds one candidate for the
// chunk), its bound exceeds its threshold (item 4: nothing to fold), or it
// needs the chunk's faces.  A warp folds a chunk when one of its lanes needs
// it (__any_sync), and then every lane folds every real face of it: no
// divergence, and a lower best for the lanes that did not need it. Each warp
// stages its own chunks (face records and ids), one chunk ahead, into its
// own cp.async double buffer, the vote for the next chunk taken before the
// current one is folded: row 1's loop (closest_cull.cuh), kept as a loop of
// its own because its fold is lexicographic and its chunk test is row 8's.
// No barrier couples a block's warps.  gridDim.z = split warps share a
// warp's chunks; for split > 1 along_merge_kernel folds the splits' (best_d,
// best_i) lexicographically.  Sorted faces and not index order: row 8's
// records are made for the sorted order (Morton chunks are compact, which
// the box and the cone need); the lexicographic fold makes the order of the
// walk irrelevant.
//
// Why the answers do not change.  u = 2^-24; every operation rounds to
// nearest, none fuses (--fmad=false).
// (1) The fold.  LexFold keeps (best_d, best_i), from (+inf, 0), and takes
//     (d, i) when d < best_d, or d == best_d and i < best_i, with i a
//     face's original index; it never takes a NaN cost.  Whatever the
//     order, it ends on the least pair, (cost, index) ordered
//     lexicographically, of the candidates with a non-NaN cost and (+inf,
//     0).  The every-face fold (argmin.cuh ExactFold: faces in index order,
//     a strict <, from (+inf, 0)) ends on the least non-NaN cost and the
//     lowest index reaching it, face 0 when no cost is below +inf: the
//     least pair L of every face and (+inf, 0), since (+inf, i) >= (+inf,
//     0).  So a lane that folds genuine pairs only (padding is never
//     folded) among which L is (or is stood for by an equal pair) returns
//     L's face.  The items below show that L is never skipped.
// (2) Misses.  When chunk_needed finds that the line misses the chunk's
//     box grown by mt, no face of the chunk is accepted by line_hit (the
//     note of ray_cull.cuh, with has_lo = 0: the whole line), so each real
//     face costs exactly kBig, and the least of the chunk's pairs is (kBig,
//     min_ids[k]): folding that one candidate is folding the chunk.  The
//     lane folds it only while best_d >= kBig; below, it cannot win.
// (3) The bound.  Where the guard holds with the pair (rho, c), every face
//     f of the chunk has k_f = rho_f / c_f <= K = rho / c, and K >= 1
//     (rho_f >= 1 since |e1 x e2| <= E^2; c <= 1).  For a face that
//     line_hit accepts, ray_cull.cuh's bounds give |ad - |D|| <= 7u |d|
//     E^2 = 7u k_f |D| and |tn| >= |TN| - 8u |S| E^2 = |TN| - 8u k_f |S|
//     |D| / |d| (E^2 = rho_f N, |D| = |d| N c_f).  With t* = TN / |D|, the
//     exact parameter where the line meets the face's plane, the computed
//     cost is
//       fl(|tn| / ad) >= (1 - u) (|t*| - 8u K |S| / |d|) / (1 + 7u K)
//                     >= |t*| - 8u K (|t*| + |S| / |d|)
//     (7u K < 2^-3 under the guard), less an absolute 2^-110 for the
//     products of tn that may underflow (at most 2^-145 over ad >= 1e-9).
//     The note of ray_cull.cuh puts o + t* d in the box grown by m, and
//     the 2^-20 pad of mt, which covers the slab test's rounding, makes
//     each axis's computed entry at most, and its exit at least, the exact
//     entry and exit of that box (an axis with d = 0 gives -inf and +inf;
//     fmaxf and fminf drop a NaN axis, which only widens the interval).
//     So t* lies in [t_near, t_far], up to 2^-149 where a product (l - o)
//     i underflows, and where an endpoint overflowed to inf, |t*| exceeds
//     FLT_MAX (1 - 4u).  The lane takes tau = min(the least |t| on
//     [t_near, t_far], FLT_MAX), so |t*| >= tau (1 - 5u) - 2^-149, and
//       LB = fl(fl(tau - fl(kr fl(fl(s inv_dn) + tau))) - 2^-100),
//       kr = fl(2^-19 fl(rho / c)),
//     with s = W + |p - cen|_1 >= |S| (as m has it) and inv_dn = 1 / |n|.
//     kr x is at least 31u K (tau + |S| / |d|): four times the 8u K of the
//     bound, which covers the roundings of kr, x, s, 1 / |n| and tau's (1 -
//     5u); the last subtraction's own rounding (u tau) is below the 20u K
//     tau left over, and 2^-100 covers the absolute terms.  So LB <= the
//     cost of every face of the chunk that the line hits.
// (4) The skip.  thr = min(best_d, seed, kBig).  A lane needs chunk k
//     unless item 2 holds or lb > thr, lb = min(LB, kBig) (written lb >
//     kBig ? kBig : LB, so that a NaN LB stays NaN) and written !(lb >
//     thr), so a NaN bound is always needed.  L's cost m* is at most the
//     seed (item 6) and at most best_d, a genuine pair's cost.  When thr <
//     kBig, lb > thr >= m*: each hit face of the chunk costs at least LB >
//     m* and each missed one kBig > m*, so no face of it is L.  When thr =
//     kBig (nothing hit below kBig yet), lb <= kBig is never above it:
//     needed.  The vote for chunk k is taken one chunk early, against a
//     best that can only fall since, so a warp stages a superset of what
//     its lanes need when the chunk comes.  A miss candidate lowers best_d
//     only from >= kBig to kBig, which leaves thr unchanged: the outcome of
//     every test is the same whenever the candidates are folded, so the
//     plain version folds them in any order.
// (5) Lanes that keep every chunk: a NaN or inf point or normal
//     (CullRay::wild), a normal with |n|^2 outside [2^-100, 2^100] (the
//     cone's cosine needs n / |n| within a few units of rounding of the
//     exact direction, and no overflow), a chunk with rho = +inf, and a
//     failed guard (chunk_needed keeps the chunk before its slab test).
// (6) Seeds and splits.  The seed pass computes AlongNormalCost on the same
//     face records, each operation rounded alone: a seed is a cost the
//     fold computes for a real face (or +inf), so m* <= seed.  A split
//     folds the chunks of its range [C s / split, C (s + 1) / split) by
//     items 1-4 with its own best, which is at least m*; the split whose
//     range holds L's face, or the chunk whose miss candidate equals L,
//     returns L, and every split returns a genuine pair or (+inf, 0), so
//     the lexicographic merge returns L.
//
// On the CPU tensors get ray_kernel.argmin_alongnormal_plain (every face);
// the plain version of this design, argmin_alongnormal_culled_plain, makes
// the same decisions and counts (each warp's vote one chunk ahead, the miss
// candidates and the splits included), so chip_smoke holds the kernel to it
// on faces and counts, and to alongnormal_faces_every on faces.

#include <climits>

#include "along_cost.cuh"
#include "common.cuh"
#include "ray_cull.cuh"

namespace {

using mt::kBig;
using mt::kChunk;
using mt::kChunkVec;
using mt::RayFace;

constexpr int kAlongThreads = 128;  // queries per block, four warps
constexpr int kFaceVec = kChunk * RayFace::kVec;  // float4 of a chunk's faces
constexpr int kIdVec = kChunk / 4;                // int4 of a chunk's ids
// the most warps that share one warp's chunks (gridDim.z)
constexpr int kAlongMaxSplit = 64;
// chunks whose faces a lane's seed folds (ray_kernel.py SEED_CHUNKS)
constexpr int kSeedChunks = 4;

constexpr float kBoundRel = 0x1p-19f;    // item 3's relative term
constexpr float kBoundTiny = 0x1p-100f;  // item 3's absolute term
constexpr float kLooseLo = 0x1p-100f;    // item 5: |n|^2 below: every chunk
constexpr float kLooseHi = 0x1p100f;     // item 5: |n|^2 above: every chunk

// The lexicographic (cost, original index) fold of item 1.
struct LexFold {
  float best_d;
  int best_i;

  __device__ void start() {
    best_d = CUDART_INF_F;
    best_i = 0;
  }
  __device__ void add(float d, int i) {
    if (d < best_d || (d == best_d && i < best_i)) {
      best_d = d;
      best_i = i;
    }
  }
};

// The seed of each sorted lane q of mesh b, one thread a lane, written to
// seeds[b, q]: the least cost over the real faces of the kSeedChunks
// chunks nearest to p, nearest by the distance squared to the chunk's box
// (0 inside), then to its centre, then the lower chunk, a NaN distance
// read as +inf; a NaN cost is never taken (+inf for a lane past a
// permutation's range).
__global__ void __launch_bounds__(kAlongThreads)
along_seed_kernel(const float* __restrict__ pts,
                  const float* __restrict__ normals,
                  const int* __restrict__ qorder,
                  const float4* __restrict__ faces,
                  const float4* __restrict__ chunks,
                  float* __restrict__ seeds, int n_q, int n_f, int n_c) {
  const int b = blockIdx.y;
  const int q = blockIdx.x * kAlongThreads + threadIdx.x;
  if (q >= n_q) return;
  const int qi = qorder[static_cast<size_t>(b) * n_q + q];
  float seed = CUDART_INF_F;
  if (qi >= 0 && qi < n_q) {
    const size_t at = (static_cast<size_t>(b) * n_q + qi) * 3;
    const float px = pts[at], py = pts[at + 1], pz = pts[at + 2];
    const float nx = normals[at], ny = normals[at + 1], nz = normals[at + 2];
    const float4* cb = chunks + static_cast<size_t>(b) * n_c * kChunkVec;
    // the nearest chunks so far, in order: (box, centre, chunk) keys
    float sb[kSeedChunks], sc[kSeedChunks];
    int sk[kSeedChunks];
#pragma unroll
    for (int j = 0; j < kSeedChunks; ++j) {
      sb[j] = sc[j] = CUDART_INF_F;
      sk[j] = INT_MAX;
    }
    for (int k = 0; k < n_c; ++k) {
      const float4 lo = __ldg(cb + k * kChunkVec);
      const float4 hi = __ldg(cb + k * kChunkVec + 1);
      const float4 cen = __ldg(cb + k * kChunkVec + 3);
      const float ex = fmaxf(fmaxf(lo.x - px, px - hi.x), 0.0f);
      const float ey = fmaxf(fmaxf(lo.y - py, py - hi.y), 0.0f);
      const float ez = fmaxf(fmaxf(lo.z - pz, pz - hi.z), 0.0f);
      const float cx = px - cen.x, cy = py - cen.y, cz = pz - cen.z;
      float kb = ex * ex + ey * ey + ez * ez;
      float kc = cx * cx + cy * cy + cz * cz;
      int kk = k;
      if (isnan(kb)) kb = CUDART_INF_F;
      if (isnan(kc)) kc = CUDART_INF_F;
      // insert (kb, kc, kk): each slot keeps the lesser key, passing the
      // greater one on
#pragma unroll
      for (int j = 0; j < kSeedChunks; ++j) {
        const bool less =
            kb < sb[j] ||
            (kb == sb[j] && (kc < sc[j] || (kc == sc[j] && kk < sk[j])));
        if (less) {
          const float tb = sb[j], tc = sc[j];
          const int tk = sk[j];
          sb[j] = kb;
          sc[j] = kc;
          sk[j] = kk;
          kb = tb;
          kc = tc;
          kk = tk;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kSeedChunks; ++j) {
      if (sk[j] >= n_c) continue;
      const float4* fb =
          faces + (static_cast<size_t>(b) * n_c + sk[j]) * kFaceVec;
      const int nf = min(kChunk, n_f - sk[j] * kChunk);
      for (int i = 0; i < nf; ++i) {
        const float d = mt::AlongNormalCost::cost(
            px, py, pz, nx, ny, nz, 0.0f, fb + i * RayFace::kVec);
        if (d < seed) seed = d;
      }
    }
  }
  seeds[static_cast<size_t>(b) * n_q + q] = seed;
}

__global__ void __launch_bounds__(kAlongThreads)
along_cull_kernel(const float* __restrict__ pts,
                  const float* __restrict__ normals,
                  const int* __restrict__ qorder,
                  const float4* __restrict__ faces,
                  const float4* __restrict__ chunks,
                  const int* __restrict__ ids,
                  const int* __restrict__ min_ids,
                  const float* __restrict__ seeds,
                  float* __restrict__ part_d, int* __restrict__ part_i,
                  int* __restrict__ out, int* __restrict__ warp_chunks,
                  int* __restrict__ lane_faces,
                  int* __restrict__ warp_stages,
                  int* __restrict__ lane_misses, int n_q, int n_f,
                  int n_c) {
  constexpr int kWarps = kAlongThreads / 32;
  __shared__ __align__(16) float4 ring[kWarps][2][kFaceVec];
  __shared__ __align__(16) int4 ring_ids[kWarps][2][kIdVec];
  const int b = blockIdx.y;
  const int q = blockIdx.x * kAlongThreads + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float4* fb = faces + static_cast<size_t>(b) * n_c * kFaceVec;
  const float4* cb = chunks + static_cast<size_t>(b) * n_c * kChunkVec;
  const int* ib = ids + static_cast<size_t>(b) * n_c * kChunk;
  const int* mb = min_ids + static_cast<size_t>(b) * n_c;
  // this split's chunks [k_lo, k_hi) and the offset of its outputs
  const int s = static_cast<int>(blockIdx.z);
  const long long n_ll = n_c;
  const int k_lo = static_cast<int>(n_ll * s / gridDim.z);
  const int k_hi = static_cast<int>(n_ll * (s + 1) / gridDim.z);
  const size_t n_split = static_cast<size_t>(s) * gridDim.y;

  bool valid = q < n_q;
  if (!__any_sync(0xffffffffu, valid)) return;  // a warp past the queries
  int qi = 0;
  if (valid) {
    qi = qorder[static_cast<size_t>(b) * n_q + q];
    valid = qi >= 0 && qi < n_q;
  }
  mt::CullRay ray;
  float inv_dn = 1.0f, seed = CUDART_INF_F;
  bool loose = false;
  if (valid) {
    const size_t at = (static_cast<size_t>(b) * n_q + qi) * 3;
    const float nx = normals[at], ny = normals[at + 1], nz = normals[at + 2];
    ray.init(pts[at], pts[at + 1], pts[at + 2], nx, ny, nz, 0, 0.0f);
    const float dn2 = nx * nx + ny * ny + nz * nz;
    inv_dn = 1.0f / sqrtf(dn2);
    loose = ray.wild || !(dn2 >= kLooseLo && dn2 <= kLooseHi);
    seed = seeds[static_cast<size_t>(b) * n_q + q];
  } else {
    ray.init(0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0, 0.0f);
  }

  LexFold fold;
  fold.start();
  int n_fold = 0, n_lane = 0, n_stage = 0, n_miss = 0;

  // this lane's bound on chunk k's costs (items 2-5): +inf where it needs
  // nothing of the chunk (after folding a miss candidate), -inf where it
  // needs every face
  auto lane_bound = [&](int k) {
    if (!valid) return CUDART_INF_F;
    if (loose) return -CUDART_INF_F;
    mt::ChunkSpan sp;
    const bool keep = mt::chunk_needed<true>(
        ray, cb + k * kChunkVec, fb + k * kFaceVec + 2, 0, 0.0f, &sp);
    if (!sp.decided) return -CUDART_INF_F;
    if (!keep) {
      ++n_miss;
      if (!(fold.best_d < kBig)) fold.add(kBig, __ldg(mb + k));
      return CUDART_INF_F;
    }
    const float tau0 = sp.t_near > 0.0f
                           ? sp.t_near
                           : (sp.t_far < 0.0f ? -sp.t_far : 0.0f);
    const float tau = fminf(tau0, FLT_MAX);
    const float kr = kBoundRel * (sp.rho / sp.c);
    const float lb = (tau - kr * (sp.s * inv_dn + tau)) - kBoundTiny;
    return lb > kBig ? kBig : lb;
  };
  auto needs = [&](float lb) {
    const float thr = fminf(fminf(fold.best_d, seed), kBig);
    return valid && !(lb > thr);
  };
  // the first chunk in [k, k_hi) that a lane of the warp needs against its
  // best so far (k_hi: none), by one warp vote a chunk; *lb receives this
  // lane's bound on it
  auto next_chunk = [&](int k, float* lb) {
    for (; k < k_hi; ++k) {
      *lb = lane_bound(k);
      if (__any_sync(0xffffffffu, needs(*lb))) return k;
    }
    return k_hi;
  };
  // chunk k's face records and ids into this warp's ring slot, as one
  // cp.async group of this lane
  auto stage = [&](int k, int slot) {
    const float4* src = fb + static_cast<size_t>(k) * kFaceVec;
#pragma unroll
    for (int i = lane; i < kFaceVec; i += 32) {
      mt::cp_async16(&ring[warp][slot][i], src + i);
    }
    if (lane < kIdVec) {
      mt::cp_async16(&ring_ids[warp][slot][lane],
                     ib + static_cast<size_t>(k) * kChunk + 4 * lane);
    }
    mt::cp_async_commit();
  };

  float lb = 0.0f;
  int k = next_chunk(k_lo, &lb);
  if (k < k_hi) stage(k, 0);
  for (int slot = 0; k < k_hi; slot ^= 1) {
    ++n_stage;
    const bool need = needs(lb);  // against the best after chunks < k
    const int nxt = next_chunk(k + 1, &lb);
    if (nxt < k_hi) {
      stage(nxt, slot ^ 1);
      mt::cp_async_wait<1>();  // chunk k's group has landed
    } else {
      mt::cp_async_wait<0>();
    }
    __syncwarp();
    const int nf = min(kChunk, n_f - k * kChunk);
    if (__any_sync(0xffffffffu, need)) {
      ++n_fold;
      const float4* t = ring[warp][slot];
      const int* fid = reinterpret_cast<const int*>(ring_ids[warp][slot]);
#pragma unroll 4
      for (int i = 0; i < nf; ++i) {
        fold.add(mt::AlongNormalCost::cost(ray.ox, ray.oy, ray.oz, ray.dx,
                                           ray.dy, ray.dz, 0.0f,
                                           t + i * RayFace::kVec),
                 fid[i]);
      }
    }
    if (need) n_lane += nf;
    __syncwarp();  // every lane is done with this warp's ring slot
    k = nxt;
  }

  if (valid) {
    const size_t at = static_cast<size_t>(b) * n_q + qi;
    if (part_d != nullptr) {
      part_d[n_split * n_q + at] = fold.best_d;
      part_i[n_split * n_q + at] = fold.best_i;
    } else {
      out[at] = fold.best_i;
    }
  }
  if (warp_chunks == nullptr) return;
  if (q < n_q) {
    lane_faces[(n_split + b) * n_q + q] = n_lane;
    lane_misses[(n_split + b) * n_q + q] = n_miss;
  }
  if (lane == 0) {
    const size_t at = (n_split + b) * ((n_q + 31) / 32) + (q >> 5);
    warp_chunks[at] = n_fold;
    warp_stages[at] = n_stage;
  }
}

// The splits' (best_d, best_i) [split, n] folded lexicographically (item
// 6): the face of each of the n queries.
__global__ void along_merge_kernel(const float* __restrict__ part_d,
                                   const int* __restrict__ part_i,
                                   int* __restrict__ out, long long n,
                                   int split) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (q >= n) return;
  LexFold fold;
  fold.start();
  for (int s = 0; s < split; ++s) {
    fold.add(part_d[s * n + q], part_i[s * n + q]);
  }
  out[q] = fold.best_i;
}

}  // namespace

// pts, normals [B, Q, 3] float32; qorder [B, Q] int32; faces [B, 32 n_c,
// 12] and chunks [B, n_c, 20] float32; ids [B, 32 n_c] and min_ids [B, n_c]
// int32 (16-byte aligned); seeds [B, Q] float32 scratch; part_d [split, B,
// Q] float32 and part_i int32 scratch for split > 1, null otherwise; out
// [B, Q] int32; warp_chunks and warp_stages [split, B, ceil(Q / 32)],
// lane_faces and lane_misses [split, B, Q] int32, all null or all set (a
// warp with no query writes none of its counts).  n_faces: the real faces
// (32 (n_c - 1) < n_faces <= 32 n_c); split: warps sharing one warp's
// chunks, 1 to 64.  Returns the launches' CUDA error code.
extern "C" int mt_alongnormal_faces(
    const float* pts, const float* normals, const int* qorder,
    const float* faces, const float* chunks, const int* ids,
    const int* min_ids, float* seeds, float* part_d, int* part_i, int* out,
    int* warp_chunks, int* lane_faces, int* warp_stages, int* lane_misses,
    int n_b, int n_q, int n_faces, int n_c, int split,
    cudaStream_t stream) {
  (void)cudaGetLastError();  // clear an error left by an earlier call
  const bool stats = warp_chunks != nullptr;
  if (split < 1 || split > kAlongMaxSplit || seeds == nullptr ||
      (split > 1) != (part_d != nullptr) ||
      (part_d == nullptr) != (part_i == nullptr) ||
      stats != (lane_faces != nullptr) || stats != (warp_stages != nullptr) ||
      stats != (lane_misses != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_b <= 0 || n_q <= 0) return 0;
  if (n_b > 65535 || n_faces <= 0 || n_faces > n_c * kChunk ||
      n_faces <= (n_c - 1) * kChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float4* f4 = reinterpret_cast<const float4*>(faces);
  const float4* c4 = reinterpret_cast<const float4*>(chunks);
  const int blocks = (n_q + kAlongThreads - 1) / kAlongThreads;
  along_seed_kernel<<<dim3(blocks, n_b), kAlongThreads, 0, stream>>>(
      pts, normals, qorder, f4, c4, seeds, n_q, n_faces, n_c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  along_cull_kernel<<<dim3(blocks, n_b, split), kAlongThreads, 0, stream>>>(
      pts, normals, qorder, f4, c4, ids, min_ids, seeds, part_d, part_i, out,
      warp_chunks, lane_faces, warp_stages, lane_misses, n_q, n_faces, n_c);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(n_b) * n_q;
  along_merge_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                       stream>>>(part_d, part_i, out, n, split);
  return static_cast<int>(cudaGetLastError());
}
