// Triangle-triangle any-hit on Hopper (sm_90a): per query triangle, the
// index of the first mesh triangle it intersects (the mesh's face count
// when none), in either pair test of tri_tri_cost.cuh; in the Moller tile
// by an exact cull that tests only the pairs that can hit.  The contact
// path's kernel (AabbTree.intersections_indices).
//
// Replaces: mesh_tpu/query/pallas_ray.py tri_tri_any_hit_pallas (kernels
// _tri_tri_kernel over _tri_tri_hit_tile, and _moller_tri_tri_kernel over
// _moller_hit).  The reference tests every pair; so does
// tri_tri_any_hit_every.cu (tri_tri_every.cuh's loop), which stays as the
// oracle that chip_smoke.py holds this kernel to: the same flags and the
// same first hits, on every input.
//
// Bound on the H100: float32 issue on what the cull lets through.  A pair
// costs the Moller tile's 64 operations of plane sides and, when neither
// triangle lies on one side of the other's plane, its 168 of interval part
// (tri_tri_cost.cuh); a lane's test of a chunk box costs 38
// (plane_needs_box).  On contact's hand against an SMPL-sized body almost
// every pair fails the plane sides, so the every-pair kernel spends its
// time on pairs that cannot hit; what bounds this design is the pairs each
// lane still needs.
//
// Operands (query/tri_tri_kernel.py tri_any_hit_operands): qplanes [13, Q], the
// Moller query operand; faces [32 C, 16] float32, a record per face (its 13
// rows of the face operand, zero-padded; the last face repeated to a whole
// chunk) and chunks [C, 8] float32, per chunk of 32 consecutive faces in index
// order, the box (lo, hi, P, the largest corner magnitude) of the corners of
// its candidate faces and, in word 7, the bits of its 32-bit candidate mask
// (tri_records.cu).  Outputs: first [Q] int32, filled with F by the caller,
// receives each query's first hit by atomicMin; on request, per warp of 32
// lanes the chunks it took and their candidate slots, and per lane the pairs it
// ran through the plane sides and those that reached the interval part, each
// summed over the splits ([ceil(Q / 32), 2] and [Q, 2], zeroed by the caller).
//
// Design.  The records kernel marks a face a candidate unless its own plane
// clears, by the margin, the box of every query corner: the face side of the
// cull, one test a face for all queries (on contact 11.9% of the body's faces
// are candidates).  Lane q of block q / 128 owns query q: a warp holds 32
// consecutive triangles of the query mesh, in its own index order, which keeps
// neighbours on one side of a surface together (the Morton order of their
// centroids puts the two sides of a finger in one warp: on contact its warps
// issue 5.0% of the pairs against 3.1% in index order, tools/cull_counts.py
// --tri).  The lane walks the chunks of its split's range in index order.  The
// warp reads their records 32 chunks at a time, one chunk a lane, and steps
// through those with a candidate by the ballot of their masks (uniform across
// the warp), each chunk's box broadcast by shuffles: with a dependent load a
// chunk, the walk was latency-bound (PERF.md, row 11).  On a chunk with a
// candidate the lane needs the chunk unless its own plane clears the chunk's
// box by the margin, or it has hit.  A warp takes a chunk when one of its lanes
// needs it (__any_sync) and stages it into its own cp.async double buffer, one
// chunk ahead, without a block barrier (row 1's loop, closest_cull.cuh: the
// vote for the next chunk is taken before the current one is tested, against a
// hit state that only grows, so it keeps a superset of what the lanes need when
// the chunk comes; a ring of four chunks took as long, PERF.md, row 11).  In a
// chunk, the lanes that need it step through its candidate slots by the mask
// (uniform across the warp), in increasing index, each running
// MollerTile::sides and the interval part only when neither side rejects (as
// self_intersect.cu does), and stopping at its first hit.  A warp stops when
// every lane has hit.  A hand of 1,552 triangles makes 49 warps, so gridDim.y
// warps share one warp's chunks (split s takes [s C / split, (s + 1) C /
// split)), and each folds its lanes' first hits into first with atomicMin. The
// plain version (tri_tri_kernel.py tri_tri_any_hit_culled_plain) makes the same
// decisions and counts.
//
// Why the flags and first hits are the every-pair kernel's.  MollerTile's
// hit is intervals & !reject, and reject = reject_q | reject_m: reject_q
// when the query's three corners lie strictly on one side of the mesh
// face's plane (each plane_dist to it at least kTriEps, of one sign), and
// reject_m when the face's corners lie so against the query's plane.
// (i)   The face side.  plane_dist(n, d, p) is the same expression whoever
//       owns the plane (n, d), so self_intersect.cu's lemma holds with the
//       roles swapped: where a face's plane clears the box [qlo, qhi] of
//       every query corner by more than M = 2^-28 + 2^-20 X, X = |n|_1 P +
//       |d| < 2^100 (P the box's largest magnitude, which bounds every
//       query corner), every query corner's computed plane_dist to it is
//       at least kTriEps of one sign, none is zeroed and both products are
//       positive: reject_q holds for every query triangle, and no query
//       can hit the face.  It is not a candidate.
// (ii)  The chunk test.  The lemma again, on the box of the candidates'
//       corners: where a query's plane clears it by more than M, each
//       candidate face of the chunk has its three corners strictly on one
//       side of that plane (reject_m), and a face that is not a candidate
//       cannot hit by (i).  So no face of a chunk a lane skips hits that
//       lane's query, and no candidate slot it passes over does either.
// (iii) The first hit.  In each split a lane visits the faces it tests in
//       increasing index and stops at its first hit; every face it passes
//       over cannot hit, so that hit is the least hitting index of the
//       split's range.  atomicMin over the splits gives the least overall,
//       whatever order the warps run in: the every-pair kernel's first, and
//       hit = first < F.  The interval part skipped on a rejected pair
//       cannot change hit, which is false there.
// (iv)  NaN and degenerate cases.  A NaN corner makes the query box NaN
//       (torch.amin / amax keep NaN), or its chunk's box (the records
//       kernel's minima keep NaN), and a NaN normal or offset makes s_min,
//       s_max, X and M NaN: every comparison is false, so nothing is
//       skipped.  A zero normal (a degenerate triangle, whose prologue sets
//       d = 0) gives s_min = s_max = 0 < M: not skipped either.  Padding
//       faces are never candidates, padding lanes never need a chunk.
//
// The segment tile (algorithm 0) keeps tri_tri_every.cuh's every-pair
// loop: its six seg_hit tests have no plane sides, and no bound that a
// skipped pair cannot pass a near-parallel edge's |det| guard has been
// written down for them (row 8's margin argument in both directions would
// be that bound), so no cull is taken.

#include "tri_tri_every.cuh"

namespace mt {

constexpr int kTriChunk = 32;         // faces per chunk
constexpr int kTriCullThreads = 128;  // query lanes per block, four warps
constexpr int kTriFaceVec = 4;        // float4 of a face record
constexpr int kTriMaxSplit = 64;      // warps sharing one warp's chunks
constexpr int kTriBatch = 4;          // candidates whose sides run at once

// a staged face record, its 13 rows first
struct FaceRecord {
  float w[4 * kTriFaceVec];
};

__device__ __forceinline__ FaceRecord face_record(const float4* chunk,
                                                  int j) {
  FaceRecord f;
  float4* v = reinterpret_cast<float4*>(f.w);
#pragma unroll
  for (int r = 0; r < kTriFaceVec; ++r) v[r] = chunk[j * kTriFaceVec + r];
  return f;
}

__global__ void __launch_bounds__(kTriCullThreads)
tri_cull_kernel(const float* __restrict__ qplanes,
                const float4* __restrict__ faces,
                const float4* __restrict__ chunks, int* __restrict__ first,
                int* __restrict__ warp_stats, int* __restrict__ lane_stats,
                int n_q, int n_c) {
  constexpr int kWarps = kTriCullThreads / 32;
  __shared__ float4 ring[kWarps][2][kTriChunk * kTriFaceVec];
  const int q = blockIdx.x * kTriCullThreads + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this split's chunks [k_lo, k_hi)
  const long long n_ll = n_c;
  const int s = static_cast<int>(blockIdx.y);
  const int k_lo = static_cast<int>(n_ll * s / gridDim.y);
  const int k_hi = static_cast<int>(n_ll * (s + 1) / gridDim.y);

  const bool valid = q < n_q;
  if (!__any_sync(0xffffffffu, valid)) return;  // a warp past the queries
  float qv[MollerTile::kQuery];
#pragma unroll
  for (int r = 0; r < MollerTile::kQuery; ++r) {
    qv[r] = valid ? qplanes[static_cast<size_t>(r) * n_q + q] : 0.0f;
  }
  // a padding lane starts hit, so it never needs a chunk
  bool hit = !valid;
  int at = -1;

  // The chunk records of the warp's current group of 32 chunks from k_lo
  // on, lane j holding chunk g0 + j's (a chunk past the range: no
  // candidate), and the group's chunks with a candidate, one bit each:
  // read in one load a lane, so walking them costs no load of its own.
  int g0 = k_lo - 32;
  float4 gb0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), gb1 = gb0;
  unsigned group = 0u;
  // the next chunk from k on with a candidate that a lane of the warp
  // needs (k_hi: none), by one warp vote a chunk; *need receives this
  // lane's need of it and *mask its candidate mask.  k only grows from
  // call to call, so the group only moves forward.
  auto next_chunk = [&](int k, bool* need, unsigned* mask) {
    for (; k < k_hi; k = g0 + 32) {
      if (k >= g0 + 32) {
        g0 = k_lo + (k - k_lo) / 32 * 32;
        const int own = g0 + lane;
        gb0 = own < k_hi ? __ldg(chunks + 2 * own) : gb0;
        gb1 = own < k_hi ? __ldg(chunks + 2 * own + 1)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        group = __ballot_sync(0xffffffffu, __float_as_uint(gb1.w) != 0u);
      }
      // the group's chunks from k on with a candidate (uniform)
      for (unsigned left = group & (0xffffffffu << (k - g0)); left != 0u;
           left &= left - 1u) {
        const int j = __ffs(left) - 1;
        const float4 b0 = make_float4(
            __shfl_sync(0xffffffffu, gb0.x, j),
            __shfl_sync(0xffffffffu, gb0.y, j),
            __shfl_sync(0xffffffffu, gb0.z, j),
            __shfl_sync(0xffffffffu, gb0.w, j));
        const float4 b1 = make_float4(
            __shfl_sync(0xffffffffu, gb1.x, j),
            __shfl_sync(0xffffffffu, gb1.y, j),
            __shfl_sync(0xffffffffu, gb1.z, j), 0.0f);
        const bool nd = !hit && plane_needs_box(qv[9], qv[10], qv[11],
                                                qv[12], b0, b1);
        if (__any_sync(0xffffffffu, nd)) {
          *need = nd;
          *mask = __float_as_uint(__shfl_sync(0xffffffffu, gb1.w, j));
          return g0 + j;
        }
      }
    }
    return k_hi;
  };
  // chunk k's face records into this warp's ring[slot], as one cp.async
  // group of this lane
  auto stage = [&](int k, int slot) {
    const float4* src = faces + static_cast<size_t>(k) * kTriChunk *
                                    kTriFaceVec;
    for (int i = lane; i < kTriChunk * kTriFaceVec; i += 32) {
      cp_async16(&ring[warp][slot][i], src + i);
    }
    cp_async_commit();
  };

  int n_chunk = 0, n_slot = 0, n_pair = 0, n_deep = 0;
  bool need = false;
  unsigned mask = 0u;
  int k = next_chunk(k_lo, &need, &mask);
  if (k < k_hi) stage(k, 0);
  for (int slot = 0; k < k_hi; slot ^= 1) {
    // the vote was taken before the chunks since then were tested: a lane
    // that hit meanwhile no longer needs chunk k
    const bool need_cur = need && !hit;
    const unsigned mask_cur = mask;
    const int nxt = next_chunk(k + 1, &need, &mask);
    if (nxt < k_hi) {
      stage(nxt, slot ^ 1);
      cp_async_wait<1>();  // chunk k's group has landed
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    if (__any_sync(0xffffffffu, need_cur)) {
      ++n_chunk;
      n_slot += __popc(mask_cur);
      if (need_cur) {
        const float4* t = ring[warp][slot];
        // the candidates in increasing index, kTriBatch at a time: their
        // plane sides are independent, so their latencies overlap; then in
        // order, each pair is counted, and one on neither side runs its
        // sides again (the same operations) and the interval part
        for (unsigned m = mask_cur; m != 0u && !hit;) {
          int js[kTriBatch];
          bool reject[kTriBatch];
#pragma unroll
          for (int b = 0; b < kTriBatch; ++b) {
            js[b] = m != 0u ? __ffs(m) - 1 : -1;
            m &= m - 1u;
            // past the last candidate: slot 0's record, never counted
            const int j = js[b] >= 0 ? js[b] : 0;
            reject[b] = MollerTile::sides(qv, face_record(t, j).w).reject;
          }
#pragma unroll
          for (int b = 0; b < kTriBatch; ++b) {
            if (js[b] < 0 || hit) break;
            ++n_pair;
            if (reject[b]) continue;
            ++n_deep;
            const FaceRecord f = face_record(t, js[b]);
            if (MollerTile::intervals(qv, f.w, MollerTile::sides(qv, f.w))) {
              hit = true;
              at = k * kTriChunk + js[b];
            }
          }
        }
      }
    }
    __syncwarp();  // every lane is done with ring[warp][slot]
    if (!__any_sync(0xffffffffu, !hit)) break;
    k = nxt;
  }
  cp_async_wait<0>();  // a prefetch left in flight by the early exit

  if (at >= 0) atomicMin(first + q, at);
  if (warp_stats == nullptr) return;
  if (q < n_q && n_pair) {
    atomicAdd(lane_stats + 2 * q, n_pair);
    atomicAdd(lane_stats + 2 * q + 1, n_deep);
  }
  if (lane == 0 && n_chunk) {
    atomicAdd(warp_stats + 2 * (q >> 5), n_chunk);
    atomicAdd(warp_stats + 2 * (q >> 5) + 1, n_slot);
  }
}

}  // namespace mt

// algorithm 1 (the Moller tile): qplanes [13, Q], faces [32 C, 16] and
// chunks [C, 8] float32 as the note above says, first [Q]
// int32 (filled with F by the caller), warp_stats [ceil(Q / 32), 2] and
// lane_stats [Q, 2] int32 (both zeroed, or both null: no statistics),
// n_split warps to a warp's chunks (1 .. 64), n_c = ceil(F / 32).
// algorithm 0 (the segment tile, every pair): qplanes [9, Q] and faces
// [9, F] float32, plane-major (query corners; face a, e1, e2), first as
// above; chunks and the statistics null, n_c and n_split unread;
// t_lo / t_hi bound its t.  Returns the launch's CUDA error code.
extern "C" int mt_tri_tri_any_hit(const float* qplanes, const float* faces,
                                  const float* chunks,
                                  int* first, int* warp_stats,
                                  int* lane_stats, int n_q, int n_f, int n_c,
                                  int n_split, int algorithm, float t_lo,
                                  float t_hi, cudaStream_t stream) {
  using namespace mt;
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (n_q <= 0 || n_f <= 0) return 0;
  if (algorithm == 0) {
    return launch_tri_every<SegmentTile>(qplanes, faces, first, n_q, n_f,
                                         t_lo, t_hi, stream);
  }
  if (algorithm != 1 || chunks == nullptr ||
      n_c != (n_f + kTriChunk - 1) / kTriChunk || n_split < 1 ||
      n_split > kTriMaxSplit ||
      ((warp_stats == nullptr) != (lane_stats == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n_q + kTriCullThreads - 1) / kTriCullThreads, n_split);
  tri_cull_kernel<<<grid, kTriCullThreads, 0, stream>>>(
      qplanes, reinterpret_cast<const float4*>(faces),
      reinterpret_cast<const float4*>(chunks), first, warp_stats,
      lane_stats, n_q, n_c);
  return static_cast<int>(cudaGetLastError());
}
