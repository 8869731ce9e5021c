// Exact per-warp chunk cull of the MXU rung's scans on Hopper (sm_90a): the
// loop of mxu_faces.cu (dense) and mxu_repair.cu (behind the bf16 screen),
// with and without the degenerate tail.  Their answers are the every-face
// kernels' (mxu_faces_every.cu, mxu_repair_every.cu over mxu_cost.cuh's
// mxu_scan_kernel) bit for bit, on every input.
//
// Bound on the H100: float32 issue.  The every-face kernels issue the 93 or
// 124 operations of every pair (mxu_cost.cuh mxu_pair) and six broadcast
// 16-byte shared loads a pair, close to the SM's instruction rate; built
// without fused multiply-adds so that the plain versions repeat them op for
// op.  A tensor-core form would take over only the four dot products (20
// of the 93 operations) and break that equality.  The lever is to evaluate
// fewer pairs.
//
// Operands (mesh_tpu_torch/query/mxu_kernel.py mxu_cull_operands): pts
// [n_q, 3] and the face record rec [F, 24] as before; qorder [n_q] int32
// (the queries in Morton order, a permutation, the origin padding rows
// included); chunks [C, 16] float32, C = ceil(F / 32), four float4 per
// chunk of 32 consecutive faces in index order: the center of the box
// around the chunk's corners and its half diagonal h; the half extents and
// e1; corner a of the chunk's first face (the seed's representative) and
// e2; |center| + h (mxu_chunk_records: closest_cull.cuh's records of the
// same triangles, plus that reach from the origin).  The repair also takes
// surv [n_q / tile_q, ceil(F / tile_f)] uint8, the reference's screen
// (mxu_kernel.survivors, made on the card before the launch; tile_f a
// multiple of 32, so no chunk straddles two face tiles).  Outputs: the face
// per query at out[qorder[q]], and on request per split the chunks each warp
// folded, the real faces of the chunks each lane needed (at its sorted
// position q) and the chunks each warp staged.
//
// Design.  closest_cull.cuh's loop, over the MXU record: lane q of block
// q / 128 owns query qorder[q]; a seed from the cost of one real face; the
// chunks in index order; a warp folds a chunk when one of its lanes needs
// it, every lane then every face of it; each warp stages its own chunks,
// one chunk ahead, into its own cp.async double buffer (a chunk is 3 KB of
// contiguous records: six 16-byte copies a lane).  Two additions:
// - The screen (kScreen).  A lane folds only the faces of the face tiles
//   its own query tile (qi / tile_q, in the caller's order) runs, by a
//   per-lane predicate on the fold; it needs a chunk only if its tile runs
//   the chunk's tile; a warp skips, with one vote, a face tile that none of
//   its lanes' query tiles runs.  The seed is the cost of the first face of
//   the nearest representative among the chunks of the tiles the lane's
//   query tile runs (+inf when it runs none): a seed from a screened-out
//   tile could lie below every face the lane folds and cull its winner.
// - Splits.  gridDim.y = split warps share a warp's chunk range, split s
//   taking chunks [s C / split, (s + 1) C / split) with the one seed, which
//   a pass of its own computes first (mxu_seed_kernel, one thread a lane);
//   each writes its (best_d, best_i) and cull_merge_kernel folds them in
//   split order with the same strict <.  A launch ends with its heaviest
//   warp, and a small query set fills few of the card's 528 schedulers;
//   the wrapper picks the split (mxu_kernel.py mxu_split).
//
// Why the answers do not change.  Items (1)-(3) of closest_cull.cuh's note
// carry over with "every face" read as S_q, the faces a lane folds (all of
// them without the screen, those of the face tiles its query tile runs
// with it): the every-face kernels fold exactly S_q in increasing order
// with a strict <, and the seed is the cost of a face of S_q, so m* (the
// least cost over S_q) is at most every threshold.  A split folds a
// superset of the faces of its range with cost at most m*; the first face
// f* reaching m* lies in one split's range, which returns (m*, f*); earlier
// splits return a cost above m* (a face of theirs at m* would precede f*)
// and later ones at least m*, so the in-order strict-< merge returns f*.
// When every cost is +inf each split returns (+inf, 0), as the every-face
// fold does.
// (4') c_f >= lb2, with the bound of closest_cull.cuh item (4) and R there
//     replaced by R_m = R + |p| + |center| + h (R = |p - center| + 3h).
//     The MXU tile forms its four scalars from the origin, not from p - a:
//     d1 = fl(fl(p.ab) - a.ab) with p.ab three rounded products and two
//     sums and a.ab the prologue's (each within 3.0001u times |p| L or
//     |a| L, L >= |ab|), so d1 is within 4.01u R_o L of (p - a).ab, R_o =
//     |p| + |a|, where the fast tile's d1 = ab.fl(p - a) is within 4.01u
//     |p - a| L; d2 and n_ap likewise (|n| for L); ap2 = max(fl(fl(p2 - 2
//     p.a) + a2), 0) is within 5.01u R_o^2 (p2, 2 p.a and a2 each within
//     3.0001u of their magnitudes' products, two rounded sums), where the
//     fast tile's is within 5.01u |p - a|^2.  From the four scalars on, the
//     MXU tile is the fast tile's chain op for op (face_cost.cuh
//     ericson_tail).  Item (4) bounds every magnitude (|p - a|, L) and every
//     error (|p - a|) by R; R_m bounds both and R_o too (a corner lies
//     within h of the box's center), and every bound of item (4) is a
//     polynomial in R with non-negative coefficients, so each holds with R_m
//     for R: c_f >= dist(p, T)^2 - E_m, E_m = R_m^2 e1 + (R_m^2 e2)^2 with
//     the chunk's e1 and e2 (the record's ab, ac, n and Ericson constants
//     are the fast tile's planes, so S, G and Lambda are too).  For queries
//     near a mesh far larger than a chunk R_m^2 is about 4 |p|^2, against R^2
//     about (3h)^2: the MXU form pays for its cancellation at the scale of
//     the mesh, not of the chunk.  A face whose premises fail makes its
//     chunk always needed (e1 = +inf): item (4)'s, and a non-finite a.ab,
//     a.ac, a.n or a2 (the hoisted corner terms the fast tile lacks).
// (5') Overflow: a chunk with R_m > 1e9 is always needed.  Below it |p|,
//     |a| and L are below 1e9, so p2, a2 and every dot product with p or a
//     are finite, and item (5) of closest_cull.cuh holds as written.  A NaN
//     query makes every bound NaN: always needed.
//
// On the CPU tensors get the plain versions of this design,
// mxu_faces_culled_plain and mxu_repair_culled_plain (query/mxu_kernel.py),
// which make the same decisions and counts (each warp's vote one chunk
// ahead and the splits included), so chip_smoke holds the kernels to them
// on faces and counts, and to the every-face kernels and plain versions on
// faces.

#pragma once

#include "closest_cull.cuh"
#include "mxu_cost.cuh"

namespace mt {

constexpr int kMxuChunkVec = 4;  // float4 per chunk record
constexpr int kMxuMaxSplit = 64;  // warps sharing one warp's chunk range

// The query of sorted lane q (qorder[q], a valid index or the lane idles)
// and the faces it folds: with the screen, those of the face tiles its
// query tile runs (surv's row qi / tile_q).
template <bool kScreen>
struct MxuLane {
  bool valid;
  int qi;
  float px, py, pz, p2;
  const unsigned char* run;

  __device__ MxuLane(const float* pts, const int* qorder,
                     const unsigned char* surv, int q, int n_q, int tile_q,
                     int n_tiles) {
    valid = q < n_q;
    qi = valid ? qorder[q] : 0;
    valid = valid && qi >= 0 && qi < n_q;
    px = py = pz = 0.0f;
    if (valid) {
      px = pts[3 * static_cast<size_t>(qi)];
      py = pts[3 * static_cast<size_t>(qi) + 1];
      pz = pts[3 * static_cast<size_t>(qi) + 2];
    }
    p2 = px * px + py * py + pz * pz;
    run = kScreen && valid
              ? surv + static_cast<size_t>(qi / tile_q) * n_tiles
              : nullptr;
  }
  // whether this lane folds the faces of face tile t
  __device__ bool runs(int t) const {
    return valid && (!kScreen || run[t] != 0);
  }
};

// The seed of each sorted lane q, one thread a lane, written to seeds[q]:
// the cost of the first face of the chunk whose representative is
// nearest among the chunks of the tiles the lane folds (a NaN distance is
// never taken; none: +inf).  A pass of its own, so that the splits of a
// warp's chunks share one scan.
template <bool kTail, bool kScreen>
__global__ void __launch_bounds__(kCullThreads)
mxu_seed_kernel(const float* __restrict__ pts, const int* __restrict__ qorder,
                const float4* __restrict__ rec,
                const float4* __restrict__ chunks,
                const unsigned char* __restrict__ surv,
                float* __restrict__ seeds, int n_q, int n_f, int tile_q,
                int tile_f, int n_tiles) {
  const int q = blockIdx.x * kCullThreads + threadIdx.x;
  if (q >= n_q) return;
  const MxuLane<kScreen> l(pts, qorder, surv, q, n_q, tile_q, n_tiles);
  const int n_chunks = (n_f + kCullChunk - 1) / kCullChunk;
  const int cpt = kScreen ? tile_f / kCullChunk : n_chunks;
  float near = CUDART_INF_F;
  int ks = -1;
  for (int t = 0; t < (kScreen ? n_tiles : 1); ++t) {
    if (!l.runs(t)) continue;
    const int k1 = min(n_chunks, (t + 1) * cpt);
    for (int k = t * cpt; k < k1; ++k) {
      const float4 r = __ldg(chunks + kMxuChunkVec * k + 2);
      const float dx = l.px - r.x, dy = l.py - r.y, dz = l.pz - r.z;
      const float d = dx * dx + dy * dy + dz * dz;
      if (d < near) {
        near = d;
        ks = k;
      }
    }
  }
  float seed = CUDART_INF_F;
  if (ks >= 0) {
    float4 face[kMxuVec];
    const float4* src = rec + static_cast<size_t>(ks) * kCullChunk * kMxuVec;
#pragma unroll
    for (int j = 0; j < kMxuVec; ++j) face[j] = __ldg(src + j);
    seed = mxu_pair<kTail>(l.px, l.py, l.pz, l.p2, face);
  }
  seeds[q] = seed;
}

template <bool kTail, bool kScreen>
__global__ void __launch_bounds__(kCullThreads)
mxu_cull_kernel(const float* __restrict__ pts, const int* __restrict__ qorder,
                const float4* __restrict__ rec,
                const float4* __restrict__ chunks,
                const unsigned char* __restrict__ surv,
                const float* __restrict__ seeds, float* __restrict__ part_d,
                int* __restrict__ part_i, int* __restrict__ out,
                int* __restrict__ warp_chunks, int* __restrict__ lane_faces,
                int* __restrict__ warp_stages, int n_q, int n_f, int tile_q,
                int tile_f, int n_tiles) {
  constexpr int kWarps = kCullThreads / 32;
  __shared__ float4 ring[kWarps][2][kCullChunk * kMxuVec];
  const int split = gridDim.y, s = blockIdx.y;
  const int q = blockIdx.x * kCullThreads + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_chunks = (n_f + kCullChunk - 1) / kCullChunk;
  const int k_lo = static_cast<int>(static_cast<long long>(n_chunks) * s /
                                    split);
  const int k_hi = static_cast<int>(static_cast<long long>(n_chunks) *
                                    (s + 1) / split);
  // chunks per face tile of the screen (one group of every chunk without)
  const int cpt = kScreen ? tile_f / kCullChunk : n_chunks;

  if (!__any_sync(0xffffffffu, q < n_q)) return;  // a warp past the queries
  const MxuLane<kScreen> l(pts, qorder, surv, q, n_q, tile_q, n_tiles);
  const bool valid = l.valid;
  const float px = l.px, py = l.py, pz = l.pz, p2 = l.p2;
  const float plen = sqrtf(p2);
  const float seed = valid ? seeds[q] : CUDART_INF_F;

  float best_d = CUDART_INF_F;
  int best_i = 0;
  // this lane's squared lower bound to chunk k's computed costs (note,
  // items 4' and 5')
  auto cull_lb2 = [&](int k) {
    const float4 s0 = __ldg(chunks + kMxuChunkVec * k);  // center, h
    const float4 s1 = __ldg(chunks + kMxuChunkVec * k + 1);  // extents, e1
    const float e2 = __ldg(chunks + kMxuChunkVec * k + 2).w;
    const float reach = __ldg(chunks + kMxuChunkVec * k + 3).x;
    const float dx = px - s0.x, dy = py - s0.y, dz = pz - s0.z;
    const float big =
        sqrtf(dx * dx + dy * dy + dz * dz) + 3.0f * s0.w + (plen + reach);
    const float ox = max0(fabsf(dx) - s1.x);
    const float oy = max0(fabsf(dy) - s1.y);
    const float oz = max0(fabsf(dz) - s1.z);
    const float big2 = big * big;
    const float t = big2 * e2;
    const float lb2 = (ox * ox + oy * oy + oz * oz) * kCullShrink2 -
                      (big2 * s1.w + t * t);
    return big <= kCullFar ? lb2 : -CUDART_INF_F;
  };
  auto needs = [&](bool r, float lb2) {
    return r && !(lb2 > fminf(best_d, seed));
  };
  // the first chunk in [k, k_hi) that a lane of the warp needs against its
  // best so far (k_hi: none), by one warp vote a chunk and, with the
  // screen, one a face tile; *lb2 and *r receive this lane's bound to it
  // and whether it folds its tile
  auto next_chunk = [&](int k, float* lb2, bool* r) {
    while (k < k_hi) {
      const int t = k / cpt;
      const int end = min(k_hi, (t + 1) * cpt);
      *r = l.runs(t);
      if (kScreen && !__any_sync(0xffffffffu, *r)) {
        k = end;  // no lane of the warp folds this face tile
        continue;
      }
      for (; k < end; ++k) {
        *lb2 = cull_lb2(k);
        if (__any_sync(0xffffffffu, needs(*r, *lb2))) return k;
      }
    }
    return k_hi;
  };
  // chunk k's records into this warp's ring[slot], as one cp.async group
  // of this lane: 32 x 6 contiguous float4, copy j of the lane taking
  // float4 32 j + lane
  auto stage = [&](int k, int slot) {
    const int c0 = k * kCullChunk;
    const int nv = min(kCullChunk, n_f - c0) * kMxuVec;
    const float4* src = rec + static_cast<size_t>(c0) * kMxuVec;
    float4* dst = ring[warp][slot];
#pragma unroll
    for (int j = 0; j < kMxuVec; ++j) {
      const int v = j * 32 + lane;
      if (v < nv) cp_async16(dst + v, src + v);
    }
    cp_async_commit();
  };

  float lb2 = 0.0f;
  bool r = false;
  int n_fold = 0, n_lane = 0, n_stage = 0;
  int k = next_chunk(k_lo, &lb2, &r);
  if (k < k_hi) stage(k, 0);
  for (int slot = 0; k < k_hi; slot ^= 1) {
    ++n_stage;
    const bool need = needs(r, lb2);  // against the best after chunks < k
    const bool folds = r;             // this lane folds chunk k's tile
    const int nxt = next_chunk(k + 1, &lb2, &r);
    if (nxt < k_hi) {
      stage(nxt, slot ^ 1);
      cp_async_wait<1>();  // chunk k's group has landed
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int c0 = k * kCullChunk;
    const int nf = min(kCullChunk, n_f - c0);
    const float4* t = ring[warp][slot];
    if (__any_sync(0xffffffffu, need)) {
      ++n_fold;
#pragma unroll 4
      for (int i = 0; i < nf; ++i) {
        const float d = mxu_pair<kTail>(px, py, pz, p2, t + i * kMxuVec);
        if (folds && d < best_d) {
          best_d = d;
          best_i = c0 + i;
        }
      }
    }
    if (need) n_lane += nf;
    __syncwarp();  // every lane is done with ring[warp][slot]
    k = nxt;
  }

  if (valid) {
    if (part_d == nullptr) {
      out[l.qi] = best_i;
    } else {
      part_d[static_cast<size_t>(s) * n_q + l.qi] = best_d;
      part_i[static_cast<size_t>(s) * n_q + l.qi] = best_i;
    }
  }
  if (warp_chunks == nullptr) return;
  if (q < n_q) lane_faces[static_cast<size_t>(s) * n_q + q] = n_lane;
  if (lane == 0) {
    const size_t at = static_cast<size_t>(s) * ((n_q + 31) / 32) + (q >> 5);
    warp_chunks[at] = n_fold;
    warp_stages[at] = n_stage;
  }
}

// Launches the seeds' pass, the culled scan and, for split > 1, the merge
// on `stream` (the wrapper gives the scratch: seeds [n_q]; part_d and
// part_i [split, n_q] for split > 1, null otherwise) over n_q queries (a
// multiple of tile_q) and n_f faces; returns cudaGetLastError().
template <bool kTail, bool kScreen>
int launch_mxu_pass(const float* pts, const int* qorder, const float4* rec,
                    const float4* chunks, const unsigned char* surv,
                    float* seeds, float* part_d, int* part_i, int* out,
                    int* warp_chunks, int* lane_faces, int* warp_stages,
                    int n_q, int n_f, int tile_q, int tile_f, int n_tiles,
                    int split, cudaStream_t stream) {
  const int blocks = (n_q + kCullThreads - 1) / kCullThreads;
  mxu_seed_kernel<kTail, kScreen><<<blocks, kCullThreads, 0, stream>>>(
      pts, qorder, rec, chunks, surv, seeds, n_q, n_f, tile_q, tile_f,
      n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mxu_cull_kernel<kTail, kScreen>
      <<<dim3(blocks, split), kCullThreads, 0, stream>>>(
          pts, qorder, rec, chunks, surv, seeds, part_d, part_i, out,
          warp_chunks, lane_faces, warp_stages, n_q, n_f, tile_q, tile_f,
          n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  cull_merge_kernel<<<(n_q + 255) / 256, 256, 0, stream>>>(part_d, part_i,
                                                           out, n_q, split);
  return static_cast<int>(cudaGetLastError());
}

template <bool kScreen>
int launch_mxu_cull(const float* pts, const int* qorder, const float* rec,
                    const float* chunks, const unsigned char* surv,
                    float* seeds, float* part_d, int* part_i, int* out,
                    int* warp_chunks, int* lane_faces, int* warp_stages,
                    int n_q, int n_f, int tile_q, int tile_f, int split,
                    int tail, cudaStream_t stream) {
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (n_f <= 0 || tile_q <= 0 || n_q % tile_q != 0 || tile_f <= 0 ||
      seeds == nullptr ||
      (kScreen && tile_f % kCullChunk != 0) || split < 1 ||
      split > kMxuMaxSplit || (split > 1) != (part_d != nullptr) ||
      (part_d == nullptr) != (part_i == nullptr) ||
      (warp_chunks == nullptr) != (lane_faces == nullptr) ||
      (warp_chunks == nullptr) != (warp_stages == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_q == 0) return 0;
  const int n_tiles = (n_f + tile_f - 1) / tile_f;
  const auto pass = tail ? launch_mxu_pass<true, kScreen>
                         : launch_mxu_pass<false, kScreen>;
  return pass(pts, qorder, reinterpret_cast<const float4*>(rec),
              reinterpret_cast<const float4*>(chunks), surv, seeds, part_d,
              part_i, out, warp_chunks, lane_faces, warp_stages, n_q, n_f,
              tile_q, tile_f, n_tiles, split, stream);
}

}  // namespace mt
