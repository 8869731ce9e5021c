// Self-intersection counts on Hopper (sm_90a): for each query face i of a
// mesh, the number of faces j != i that share none of i's vertex indices
// and intersect it, in either pair test of tri_tri_cost.cuh.
//
// Replaces: mesh_tpu/query/pallas_ray.py self_intersection_count_pallas
// (kernel _make_self_intersect_kernel over _tri_tri_hit_tile or
// _moller_hit), the interpenetration check of posed bodies; the count of
// faces with a partner is taken from these counts in PyTorch.
//
// Bound on the H100: the float32 instruction rate.  A pair costs the tile's
// 428 (segment) or 232 (Moller) operations, counted in tri_tri_cost.cuh,
// plus 21 of its own: 9 vertex-index compares and 8 ors, the self test, the
// and with the hit, and the count's add.  The TPU kernel tests every pair,
// as a Pallas grid step runs all its lanes; yet on a posed body a few
// hundred of 10^5 faces have a partner.  What bounds a kernel that tests
// every pair is that work; the design below lets a warp skip the work that
// provably cannot change a count, and its own bound is the work each query
// lane still needs (chip_smoke.py compare_self): the box test of each tile,
// the vertex-id test of each pair of the tiles it takes, the plane sides of
// each pair past that test and the interval part of each pair on neither
// side.
//
// Design.  One thread owns one query face (its operand rows and vertex ids
// in registers), a block of 128 query faces walks the mesh's faces in tiles
// of 128, and each face's record (its operand rows and the bits of its
// three vertex ids, kRec words) is staged by cp.async into a double buffer
// in shared memory, so that the next tile the block needs loads while the
// current one is tested.  The faces are split across blockIdx.y into short
// ranges, for about 256 blocks per SM: the cull leaves the blocks uneven
// work, which many small blocks balance.  Each block adds its partial
// counts with atomicAdd: integer sums, the same in any order.  The caller
// (query/tri_tri_kernel.py self_intersection_counts_kernel) sorts the faces
// by the Morton code of their centroid, so a warp holds neighbouring query
// faces and a tile is a compact patch of the surface.  A launch takes a
// range [q0, q0 + n_q) of query faces against all faces.
//
// The Moller tile's cull (segment tile: none, see below).  MollerTile::hit
// is false whenever reject_m holds: all three corners of the mesh face lie
// strictly on one side of the query's plane, each plane distance at least
// kTriEps after plane_dist.  Each thread tests its query plane (n, d) against
// each tile's box [lo, hi] of corners (built by the prologue with
// torch.amin / amax, so a NaN corner makes the box NaN), at the two box
// corners that minimise and maximise n.p (per axis lo or hi by the sign of
// n: the centre distance n.c + d minus and plus |n|.half-extent, without
// rounding the centre).  It skips the tile when s_min > M or s_max < -M, with
//
//   X = (|nx| + |ny| + |nz|) P + |d|,  M = 2^-28 + 2^-20 X,
//
// P the largest corner magnitude of the box, and only when X < 2^100
// (plane_needs_box and its constants, in tri_tri_cost.cuh).
// Why no pair it skips can count, in float32 with u = 2^-24 and no FMA:
// plane_dist evaluates ((nx px + ny py) + nz pz) + d, whose error is at most
// g4 (|n|_1 P + |d|) = g4 X with g4 = 4u / (1 - 4u) (three products and
// three sums; X < 2^100 keeps every partial sum finite, and underflow adds
// at most 8 x 2^-150).  The box test evaluates the same expression at a box
// corner p*, so the exact n.p* + d exceeds s_min - g4 X; every corner p of
// the tile lies in the box, so n.p + d >= n.p* + d (p* minimises the linear
// form over the box), and p's computed plane distance exceeds
// s_min - 2 g4 X > M - 2 g4 X.  The computed M is at least
// 2^-28 (1 - u) + 2^-20 (1 - 4u) X (X and M add non-negative terms and
// scale by a power of two, each operation off by at most a factor 1 - u),
// and 2^-20 (1 - 4u) > 2 g4 = 2^-21 / (1 - 4u): the distance exceeds
// 2^-28 (1 - u) = 3.7e-9 > kTriEps, the rounding of the box test and of M
// both covered.  So each of the three distances is at least kTriEps, none
// is zeroed, both products are positive (at least 1e-18, no underflow),
// reject_m holds and hit is false.  The mirror case s_max < -M
// gives three distances at most -kTriEps.  A NaN in the query's plane or in
// the box makes s, X and M NaN, and every comparison false: no skip.  A
// zero normal (a degenerate query, whose prologue sets d = 0) gives
// s_min = s_max = 0 < M: no skip.  A box-overlap cull would not be exact:
// two far-apart near-coplanar faces with corner noise above kTriEps have a
// noise-dominated line direction, and the float test may report overlap.
//
// A warp skips a tile when none of its lanes needs it (__any_sync) and the
// block stages a tile when any thread needs it (__syncthreads_or); a lane
// whose box test skips the tile idles through it.  Inside a tile the pair
// test computes the vertex-sharing and self tests first, then the plane
// sides (MollerTile::sides, the same operations in the same order as hit),
// and skips the interval part (168 of the 232 operations) when either
// triangle lies on one side of the other's plane: hit would be false.  The
// counts are therefore those of the every-pair kernel, bit for bit.  On
// request the kernel also returns the work it did: per query warp the face
// tiles it tested, and per query face the pairs of the tiles its own lane
// took (each through the vertex-id test), the pairs past the id and self
// exclusion (each through the Moller plane sides or the whole segment
// test), and the Moller pairs that reached the interval part; the plain
// version (tri_tri_kernel.py self_intersect_culled_plain) makes the same
// decisions and counts.

// The segment tile (algorithm 0) keeps its every-pair loop, with the same
// order and staging: its six seg_hit tests run on the raw, unscaled corners,
// and no float32 bound that a skipped pair cannot pass a near-parallel
// edge's |det| guard has been written down, so no cull is taken.

#include <type_traits>

#include "tri_tri_cost.cuh"

namespace mt {

constexpr int kSelfThreads = 128;  // query faces per block
constexpr int kSelfTile = 128;     // faces per staged tile
// Blocks a launch aims for: about 256 per SM of the H100's 132, so many
// short face ranges that the uneven work the cull leaves (one block's
// queries need most tiles, another's few) spreads over the SMs instead of
// waiting on the busiest block of a single wave.
constexpr int kSelfTargetBlocks = 256 * 132;

// words of a face record: the operand rows and three vertex ids, rounded
// up to whole float4
template <class Tile>
constexpr int kRecWords = (Tile::kFace + 3 + 3) / 4 * 4;

template <class Tile>
__global__ void __launch_bounds__(kSelfThreads)
self_intersect_kernel(const float* __restrict__ qplanes,
                      const float* __restrict__ frec,
                      const float* __restrict__ boxes,
                      int* __restrict__ counts, int* __restrict__ warp_tiles,
                      int* __restrict__ work, int n_f, int q0, int n_q,
                      int per_split, float t_lo, float t_hi) {
  constexpr bool kCull = std::is_same<Tile, MollerTile>::value;
  constexpr int kRec = kRecWords<Tile>;
  __shared__ __align__(16) float ring[2][kSelfTile * kRec];
  const int local = blockIdx.x * kSelfThreads + threadIdx.x;
  const bool live = local < n_q;
  const int i = q0 + local;
  const int split = static_cast<int>(blockIdx.y);
  const int t_begin = split * (per_split / kSelfTile);
  const int f_end = min(n_f, (split + 1) * per_split);
  const int t_end = (f_end + kSelfTile - 1) / kSelfTile;

  float q[Tile::kQuery];
  int qi0 = -1, qi1 = -1, qi2 = -1;
#pragma unroll
  for (int r = 0; r < Tile::kQuery; ++r) {
    q[r] = live ? qplanes[static_cast<size_t>(r) * n_f + i] : 0.0f;
  }
  if (live) {
    const float* own = frec + static_cast<size_t>(i) * kRec + Tile::kFace;
    qi0 = __float_as_int(own[0]);
    qi1 = __float_as_int(own[1]);
    qi2 = __float_as_int(own[2]);
  }

  // this lane's need of tile t
  auto lane_needs = [&](int t) -> bool {
    if (!live) return false;
    if constexpr (kCull) {
      const float4* b =
          reinterpret_cast<const float4*>(boxes + static_cast<size_t>(t) *
                                                      kBoxWords);
      return plane_needs_box(q[9], q[10], q[11], q[12], __ldg(b),
                             __ldg(b + 1));
    }
    return true;
  };
  // the first tile from t on that some thread of the block needs (t_end:
  // none), by one block vote per tile; *need receives this lane's vote
  auto next_tile = [&](int t, bool* need) {
    for (; t < t_end; ++t) {
      *need = lane_needs(t);
      if (__syncthreads_or(*need)) return t;
    }
    return t_end;
  };
  // tile t's records into ring[slot], as one cp.async group of this thread
  auto stage = [&](int t, int slot) {
    const int f0 = t * kSelfTile;
    const int words = min(kSelfTile, n_f - f0) * kRec;
    const float* src = frec + static_cast<size_t>(f0) * kRec;
    for (int k = 4 * threadIdx.x; k < words; k += 4 * kSelfThreads) {
      cp_async16(ring[slot] + k, src + k);
    }
    cp_async_commit();
  };

  int count = 0, tested = 0, taken = 0, reached = 0, deep = 0;
  bool need = false;
  int cur = next_tile(t_begin, &need);
  if (cur < t_end) stage(cur, 0);
  for (int slot = 0; cur < t_end; slot ^= 1) {
    const bool need_cur = need;
    const int nxt = next_tile(cur + 1, &need);
    if (nxt < t_end) {
      stage(nxt, slot ^ 1);
      cp_async_wait<1>();  // this tile's group has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (__any_sync(0xffffffffu, need_cur)) {
      ++tested;
      if (need_cur) {
        const int f0 = cur * kSelfTile;
        const int nf = min(kSelfTile, n_f - f0);
        const float4* tile = reinterpret_cast<const float4*>(ring[slot]);
        taken += nf;
        for (int k = 0; k < nf; ++k) {
          float4 mv[kRec / 4];
#pragma unroll
          for (int r = 0; r < kRec / 4; ++r) mv[r] = tile[k * (kRec / 4) + r];
          const float* m = reinterpret_cast<const float*>(mv);
          const int m0 = __float_as_int(m[Tile::kFace]);
          const int m1 = __float_as_int(m[Tile::kFace + 1]);
          const int m2 = __float_as_int(m[Tile::kFace + 2]);
          const bool shares = (qi0 == m0) | (qi0 == m1) | (qi0 == m2) |
                              (qi1 == m0) | (qi1 == m1) | (qi1 == m2) |
                              (qi2 == m0) | (qi2 == m1) | (qi2 == m2);
          if (shares | (f0 + k == i)) continue;
          ++reached;
          if constexpr (kCull) {
            const MollerSides s = MollerTile::sides(q, m);
            if (s.reject) continue;
            ++deep;
            count += MollerTile::intervals(q, m, s) ? 1 : 0;
          } else {
            count += Tile::hit(q, m, t_lo, t_hi) ? 1 : 0;
          }
        }
      }
    }
    __syncthreads();  // every thread is done with ring[slot]
    cur = nxt;
  }
  if (live && count) atomicAdd(counts + local, count);
  if (work == nullptr) return;
  if (live && taken) {
    atomicAdd(work + 3 * local, taken);
    atomicAdd(work + 3 * local + 1, reached);
    atomicAdd(work + 3 * local + 2, deep);
  }
  if ((threadIdx.x & 31) == 0 && tested) {
    atomicAdd(warp_tiles + (local >> 5), tested);
  }
}

}  // namespace mt

// qplanes [Kq, F] float32, plane-major, and frec [F, W] float32, one record
// per face: the face operand's rows then the bits of its three int32 vertex
// ids, zero-padded to W words (algorithm 0: the segment tile, query rows the
// corners and face rows (a, e1, e2), W 12; algorithm 1: the Moller tile, the
// same 13 rows on both sides, W 16); boxes [ceil(F / 128), 8] (Moller only:
// per tile of 128 faces its corners' lo and hi, the largest magnitude P and
// a pad; the segment tile takes null).  counts [n_q] int32, zeroed by the
// caller, receives the counts of the query faces q0 .. q0 + n_q - 1; with
// warp_tiles [ceil(n_q / 32)] and work [n_q, 3] int32 (zeroed; both null:
// no statistics) the face tiles each warp of 32 tested, and per query face
// the pairs its lane took, those past the exclusion and those that reached
// the Moller interval part (segment: 0).  Returns the launch's CUDA error
// code.
extern "C" int mt_self_intersect(const float* qplanes, const float* frec,
                                 const float* boxes, int* counts,
                                 int* warp_tiles, int* work, int n_f, int q0,
                                 int n_q, int algorithm, float t_lo,
                                 float t_hi, cudaStream_t stream) {
  using namespace mt;
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (n_q <= 0 || n_f <= 0) return 0;
  if ((algorithm != 0 && algorithm != 1) || q0 < 0 || q0 + n_q > n_f ||
      (algorithm == 1 && boxes == nullptr) ||
      ((warp_tiles == nullptr) != (work == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int q_blocks = (n_q + kSelfThreads - 1) / kSelfThreads;
  int n_split, per_split;
  face_splits(q_blocks, n_f, kSelfTile, &n_split, &per_split,
              kSelfTargetBlocks);
  const dim3 grid(q_blocks, n_split);
  if (algorithm == 0) {
    self_intersect_kernel<SegmentTile><<<grid, kSelfThreads, 0, stream>>>(
        qplanes, frec, boxes, counts, warp_tiles, work, n_f, q0, n_q,
        per_split, t_lo, t_hi);
  } else {
    self_intersect_kernel<MollerTile><<<grid, kSelfThreads, 0, stream>>>(
        qplanes, frec, boxes, counts, warp_tiles, work, n_f, q0, n_q,
        per_split, t_lo, t_hi);
  }
  return static_cast<int>(cudaGetLastError());
}
