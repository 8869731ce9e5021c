// bf16 bound pass of the MXU rung on Hopper (sm_90a), by an exact per-warp
// chunk cull: the same ub as the every-face kernel (mxu_bound.cu), bit for
// bit, and the same repair decisions, from the chunks of 32 faces a warp of
// queries needs.
//
// Replaces: mesh_tpu/query/pallas_closest.py _mxu_bound_kernel (over
// _mxu_ap2_env; pallas_call in _mxu_repair_staged), which the every-face
// kernel mxu_bound.cu ported; that kernel stays as this one's oracle, and
// no path launches it.
//
// Per pair, as mxu_bound.cu computes it (p and corner a rounded to bf16,
// their exact products summed in float32; p2 and a2 unrounded):
//   ap2~ = max(p2 - 2 pa + a2, 0),   E = 2^-6 (p2 + a2)
//   U    = ap2~ + E                          (ub[q] = min over all faces)
//   C    = sqrt(max(ap2~ - E, 0)) - r        (cert[q, t] = min over tile t)
// both minima keeping NaN (min_nan).  The repair reads them only through
// mxu_kernel.survivors: cert[q, t] <= sqrt(max(ub[q], 0)).
//
// Contract (the pass is not the every-face kernel's on every cert value):
// for the same p (the origin padding rows included) and face record,
// - ub equals the every-face kernel's bit for bit (NaN where it is NaN);
// - cert[q, t] equals the every-face value wherever that value is <=
//   sqrt(max(ub[q], 0)), and in every tile of a query whose ub is NaN;
//   elsewhere both values are > sqrt(max(ub[q], 0)), or both are NaN;
// - hence survivors(ub, cert) and every answer and tile count of the
//   repair are the every-face pass's.
// NaN: a NaN a or a2 in one face makes ub NaN for every query and that
// face's tile NaN in cert; a NaN reach makes its tile NaN; a NaN query
// makes its row NaN.  Each is kept (item B6).
//
// Bound on the H100: float32 issue.  A pair costs 26 operations
// (mxu_bound.cu), a lane's test of a chunk 32 (the box distance 17, the
// two lower bounds 10, the compares and their logic 5), the seed 11 a chunk
// and one pair.  The every-face kernel issues every pair (2.13e9 on the
// 32,512-face sphere x 65,536 queries); the lever is to issue fewer.
//
// Operands (mesh_tpu_torch/query/mxu_kernel.py): pts [n_q, 3], n_q a
// multiple of 32; qorder [n_q] int32, the queries in Morton order
// (mxu_cull_operands, shared with mxu_repair); bnd [F, 8] float32, the
// face's bound record (mxu_bound_records: bf16(a) as float32, a2, the
// reach, three zeros); chunks [n_c, 16], n_c = ceil(F / 32), the chunk records
// of mxu_cull.cuh (mxu_chunk_records), of which this pass reads the box
// (center, half diagonal h, half extents) and columns 13-15: A2 (the
// chunk's largest a2; +inf when the chunk must always be folded), Rm (its
// largest reach times 1 + 2^-21) and H (h^2 2^-21 + 2^-120).  tile_f is a
// multiple of 32, so no chunk straddles two cert tiles.
//
// Design: mxu_cull.cuh's loop over the bound's values.  Lane q of block
// q / 128 owns query qorder[q] (MxuLane); warps are 32 Morton-adjacent
// queries; chunks of 32 faces in index order.  A pass of its own seeds
// each lane's running ub with U of the first face of the chunk whose
// representative corner is nearest (a member of the min).  A lane needs
// chunk k when either test holds against its running ub:
//   ub-need    !(Lu > ub),               Lu = (S D2 + K1 p2) - H
//   cert-need  !(Lc > sqrt(max(ub, 0))), Lc = sqrt(max(S D2 - ((p2 + A2)
//                                             K3 + H), 0)) - Rm
// with D2 the squared distance to the chunk's box as closest_cull.cuh
// computes it, S = 0.998, K1 = 0.99 2^-7 and K3 = 3.01 2^-7; a lane with
// !(p2 <= 1e18) needs every chunk.  A warp folds a chunk when one of its
// lanes needs it, every lane then every face; each warp stages its chunks'
// bound records (1 KB a chunk) one chunk ahead into its own cp.async
// double buffer, voting for the next chunk against the state before the
// current one's fold.  A lane writes, per tile, the min of C over the faces
// it folded there (+inf where it folded none), and its ub.
// Splits: gridDim.y = split warps share a warp's chunk range, split s
// taking chunks [s n_c / split, (s + 1) n_c / split) from the one seed, each
// writing its ub and the cert of the tiles its range touches (at most
// `slots`) at sorted positions; mxu_bound_merge_kernel folds them in split
// order with min_nan.  A merge pass, not an atomicMin on ordered integer
// keys: min is exact either way, and the pass keeps the fold's order and
// its NaN without a key for it, which the plain version repeats; the
// partials cost 4 (1 + slots) bytes a lane and split.
//
// Why the answers do not change.  u = 2^-24 below; P = |p|, A = |a|.
// (B1) Each skip is against a running ub that only falls towards the final
//     ub (the seed is one of the values of the min), so a face with U_f >
//     Lu > ub_running exceeds the final ub, and one with C_f > Lc >
//     sqrt(max(ub_running, 0)) exceeds sqrt(max(ub, 0)) (sqrt and max are
//     monotone, and so is their rounding).  ub: the face reaching the
//     final ub lies in a chunk that its lane needs at every vote, so it is
//     folded, and a min over a subset holding it is the min.  cert: if the
//     every-face value of tile t is <= sqrt(max(ub, 0)), the face reaching
//     it is folded likewise, and the min over the folded faces of t (a
//     subset) equals it; otherwise the folded faces' min (or +inf) is at
//     least the every-face value.  Voting one chunk ahead keeps a superset
//     (the state can only fall).  A split folds a superset of what it
//     needs against its own running ub, which is never below the final
//     one, and the merge takes the min over the splits.
// (B2) The box.  Corner a of every face of the chunk lies in the box
//     (closest_cull.cuh item (4): a is one of the corners the box is made
//     around), and within h of its center c.  Per axis, fl(px - cx) is
//     within u |px - cx| of its value and fl(|dx| - hx) within u of its
//     own, so the computed ox exceeds the distance to the slab by at most
//     (1 + u) u |px - cx|; with three products and two sums, D2 <= (1 +
//     5.01u) (D^2 + 2.0001u |p - c|^2), D the distance to the box, and
//     |p - c|^2 <= 2 |p - a|^2 + 2 h^2, D <= |p - a|.  Hence
//     |p - a|^2 >= (1 - 9.02u) D2 - 4.001u h^2   for every face's a.
// (B3) The bf16 screen's rounding (the reference's certificate,
//     pallas_closest.py:828-837): |pa - p.a| <= ((1 + 2^-8)^2 (1 + u)^2 -
//     1) P A <= 1.0021 2^-7 P A; p2 and a2 are within 3.0001u of P^2, A^2;
//     the two rounded sums of ap2~ add 5.05u (P^2 + A^2).  So ap2~ is
//     within k (P^2 + A^2) of |p - a|^2, k = 1.0022 2^-7 (half the
//     envelope), and E lies within 4.1u of 2^-6 (P^2 + A^2).  Then
//     U_f = fl(ap2~ + E) >= (1 - u) (|p - a|^2 + 0.997 2^-7 (P^2 + A^2)),
//     and fl(ap2~ - E) >= |p - a|^2 - 3.0025 2^-7 (P^2 + A^2), a rounding
//     of 2.03u (P^2 + A^2) included.  With the correctly rounded sqrt and
//     fl(s - r) >= s (1 - u) - r (1 + u) for s, r >= 0:
//     C_f >= sqrt(max(|p - a|^2 - 3.0025 2^-7 (P^2 + A^2), 0)) (1 - 2u)
//            - r_f (1 + u),   and C_f >= -r_f (1 + u) always.
// (B4) Lu <= U_f.  From (B2) and (B3), U_f >= (1 - 10.1u) D2 - 4.001u h^2
//     + 0.9968 2^-7 p2 + 0.99 2^-7 A^2 (P^2 >= p2 / (1 + 3.0001u)).  Lu's
//     own roundings give Lu <= S (1 + u)^3 D2 + K1 (1 + u)^3 p2 - H when
//     Lu >= 0 (and a negative Lu is below U_f >= 0): S (1 + u)^3 <= 1 -
//     10.1u, K1 (1 + u)^3 <= 0.9968 2^-7, H (1 - u) >= 4.001u h^2.  The
//     unused 0.0068 2^-7 P^2 + 0.99 2^-7 A^2 covers what underflow adds
//     (a product's 2^-150, a subnormal bf16's 2^-134 times P or A: at most
//     2^-132 (P + A) + 2^-145) once P + A >= 2^-63; below that S D2 is
//     under 2^-123 + 4.01u h^2, and H >= 2^-120 + 7.99u h^2 makes Lu
//     negative.
// (B5) Lc <= C_f.  With A2 >= a2 >= A^2 / (1 + 3.0001u), (B2) and (B3),
//     fl(ap2~ - E) >= V = (1 - 9.02u) D2 - 3.004 2^-7 (p2 + A2) -
//     4.001u h^2 (the 0.0015 2^-7 (P^2 + A^2) to spare covers underflow as
//     in B4).  The computed v = fl(S D2 - ((p2 + A2) K3 + H)) is at most V
//     - 0.0019 D2 when it is >= 0 (K3 (1 - u)^3 >= 3.004 2^-7), so v <= V
//     (1 - 0.0019), and fl(sqrt(v)) (1 + u) <= sqrt(V) (1 - 2u); with Rm >=
//     r_f (1 + 6.9u), both signs of fl(s - Rm) give Lc <= sqrt(max(V, 0))
//     (1 - 2u) - r_f (1 + u) <= C_f.  Where v <= 0, Lc = -Rm <= C_f by the
//     last line of (B3).  In the underflow range v < 0 as in (B4).
// (B6) NaN and overflow.  A lane with p2 > 1e18 or NaN needs every chunk.
//     A2 = +inf in every chunk of a mesh with a face whose a or a2 is not
//     finite or whose a2 exceeds 1e18, and in a chunk whose box is not
//     finite: then Lc is -Rm or NaN, and both are needed (sqrt(max(ub, 0))
//     >= 0 or NaN).  A NaN or infinite reach gives Rm NaN or +inf: Lc NaN
//     or -inf, needed.  Otherwise P, A <= 1e9: every pair value is finite
//     and (B2)-(B5) hold; D2 overflows only with H (|p - c| <= |p - a| +
//     h), and an infinite H makes Lu -inf or NaN and Lc -Rm or NaN: needed.
//     So a lane whose ub is NaN (a NaN query, or a face that
//     can make one, which flags the whole mesh) folds every chunk and its
//     cert row is the every-face row, and a NaN cert of a finite-ub lane
//     comes from a NaN reach, whose chunk is always folded.
//
// On the CPU tensors get mxu_bound_culled_plain (query/mxu_kernel.py), the
// plain version of this design: the same decisions and counts (the votes
// one chunk ahead and the splits included), and the same values (a chunk's
// minimum by torch.amin, equal to the fold's up to a zero's sign); so
// chip_smoke holds the kernel to it bit for bit, and to the every-face
// kernel and mxu_bound_plain by the contract above.

#include "mxu_cull.cuh"

namespace mt {

constexpr int kBoundVec = 2;          // float4 per face bound record
// the bounds' constants (note, items B4 and B5)
constexpr float kUbSlack = 0.99f * 0.0078125f;   // K1 = 0.99 2^-7
constexpr float kCertEnv = 3.01f * 0.0078125f;   // K3 = 3.01 2^-7
constexpr float kBoundFar2 = 1e18f;              // p2 past it: every chunk

// U = ap2~ + E and C = sqrt(max(ap2~ - E, 0)) - r of the query (bf16
// coordinates b, p2) and the face whose bound record is (a, r): the
// operations of mxu_bound.cu in its order
struct BoundPair {
  float u, c;
  __device__ BoundPair(float bx, float by, float bz, float p2, float4 a,
                       float r) {
    const float pa = bx * a.x + by * a.y + bz * a.z;
    const float ap2t = max0(p2 - (pa + pa) + a.w);
    const float env = kMxuBf16Eps * (p2 + a.w);
    u = ap2t + env;
    c = sqrtf(max0(ap2t - env)) - r;
  }
};

// The seed of each sorted lane q, one thread a lane: U of the first face of
// the chunk whose representative (corner a of its first face) is nearest
// (a NaN distance is never taken; none: +inf).
__global__ void __launch_bounds__(kCullThreads)
mxu_bound_seed_kernel(const float* __restrict__ pts,
                      const int* __restrict__ qorder,
                      const float4* __restrict__ bnd,
                      const float4* __restrict__ chunks,
                      float* __restrict__ seeds, int n_q, int n_f) {
  const int q = blockIdx.x * kCullThreads + threadIdx.x;
  if (q >= n_q) return;
  const MxuLane<false> l(pts, qorder, nullptr, q, n_q, 0, 0);
  const int n_chunks = (n_f + kCullChunk - 1) / kCullChunk;
  float near = CUDART_INF_F;
  int ks = -1;
  for (int k = 0; k < n_chunks; ++k) {
    const float4 r = __ldg(chunks + kMxuChunkVec * k + 2);
    const float dx = l.px - r.x, dy = l.py - r.y, dz = l.pz - r.z;
    const float d = dx * dx + dy * dy + dz * dz;
    if (d < near) {
      near = d;
      ks = k;
    }
  }
  float seed = CUDART_INF_F;
  if (ks >= 0) {
    const float4* src = bnd + static_cast<size_t>(ks) * kCullChunk * kBoundVec;
    seed = BoundPair(bf16_round(l.px), bf16_round(l.py), bf16_round(l.pz),
                     l.p2, __ldg(src), __ldg(src + 1).x).u;
  }
  seeds[q] = seed;
}

// The tiles [t_lo, t_hi] that split s's chunk range [k_lo, k_hi) touches
// (t_hi = t_lo - 1 when the range is empty).
__device__ __host__ inline void split_tiles(int n_chunks, int split, int s,
                                            int cpt, int* k_lo, int* k_hi,
                                            int* t_lo, int* t_hi) {
  *k_lo = static_cast<int>(static_cast<long long>(n_chunks) * s / split);
  *k_hi = static_cast<int>(static_cast<long long>(n_chunks) * (s + 1) /
                           split);
  *t_lo = *k_lo / cpt;
  *t_hi = *k_hi > *k_lo ? (*k_hi - 1) / cpt : *t_lo - 1;
}

__global__ void __launch_bounds__(kCullThreads)
mxu_bound_cull_kernel(const float* __restrict__ pts,
                      const int* __restrict__ qorder,
                      const float4* __restrict__ bnd,
                      const float4* __restrict__ chunks,
                      const float* __restrict__ seeds, float* __restrict__ ub,
                      float* __restrict__ cert, float* __restrict__ part_ub,
                      float* __restrict__ part_cert,
                      int* __restrict__ warp_chunks,
                      int* __restrict__ lane_faces,
                      int* __restrict__ warp_stages, int n_q, int n_f,
                      int tile_f, int n_tiles, int slots) {
  constexpr int kWarps = kCullThreads / 32;
  __shared__ float4 ring[kWarps][2][kCullChunk * kBoundVec];
  const int split = gridDim.y, s = blockIdx.y;
  const int q = blockIdx.x * kCullThreads + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_chunks = (n_f + kCullChunk - 1) / kCullChunk;
  const int cpt = tile_f / kCullChunk;
  int k_lo, k_hi, t_lo, t_hi;
  split_tiles(n_chunks, split, s, cpt, &k_lo, &k_hi, &t_lo, &t_hi);

  if (!__any_sync(0xffffffffu, q < n_q)) return;  // a warp past the queries
  const MxuLane<false> l(pts, qorder, nullptr, q, n_q, 0, 0);
  const bool valid = l.valid;
  const float px = l.px, py = l.py, pz = l.pz, p2 = l.p2;
  const float bx = bf16_round(px), by = bf16_round(py), bz = bf16_round(pz);
  const bool near = p2 <= kBoundFar2;
  const float k1p2 = kUbSlack * p2;

  float ub_run = valid ? seeds[q] : CUDART_INF_F;
  float su = sqrtf(max0(ub_run));
  // this lane's lower bounds (Lu, Lc) to chunk k's values (note, B4-B5)
  auto bounds = [&](int k, float* lu, float* lc) {
    const float4 s0 = __ldg(chunks + kMxuChunkVec * k);      // center, h
    const float4 s1 = __ldg(chunks + kMxuChunkVec * k + 1);  // extents
    const float4 s3 = __ldg(chunks + kMxuChunkVec * k + 3);  // A2, Rm, H
    const float dx = px - s0.x, dy = py - s0.y, dz = pz - s0.z;
    const float ox = max0(fabsf(dx) - s1.x);
    const float oy = max0(fabsf(dy) - s1.y);
    const float oz = max0(fabsf(dz) - s1.z);
    const float sd2 = (ox * ox + oy * oy + oz * oz) * kCullShrink2;
    *lu = (sd2 + k1p2) - s3.w;
    *lc = sqrtf(max0(sd2 - ((p2 + s3.y) * kCertEnv + s3.w))) - s3.z;
  };
  auto needs = [&](float lu, float lc) {
    return valid && (!near || !(lu > ub_run) || !(lc > su));
  };
  // the first chunk in [k, k_hi) that a lane of the warp needs against its
  // running ub (k_hi: none), by one warp vote a chunk; *lu and *lc receive
  // this lane's bounds to it
  auto next_chunk = [&](int k, float* lu, float* lc) {
    for (; k < k_hi; ++k) {
      bounds(k, lu, lc);
      if (__any_sync(0xffffffffu, needs(*lu, *lc))) return k;
    }
    return k_hi;
  };
  // chunk k's bound records into this warp's ring[slot], as one cp.async
  // group of this lane: 32 x 2 contiguous float4, copy j of the lane taking
  // float4 32 j + lane
  auto stage = [&](int k, int slot) {
    const int c0 = k * kCullChunk;
    const int nv = min(kCullChunk, n_f - c0) * kBoundVec;
    const float4* src = bnd + static_cast<size_t>(c0) * kBoundVec;
    float4* dst = ring[warp][slot];
#pragma unroll
    for (int j = 0; j < kBoundVec; ++j) {
      const int v = j * 32 + lane;
      if (v < nv) cp_async16(dst + v, src + v);
    }
    cp_async_commit();
  };
  // the cert of tile t, this split's slot of it or the row's column
  auto put_cert = [&](int t, float m) {
    if (!valid) return;
    if (part_ub == nullptr) {
      cert[static_cast<size_t>(l.qi) * n_tiles + t] = m;
    } else {
      part_cert[(static_cast<size_t>(s) * slots + (t - t_lo)) * n_q + q] = m;
    }
  };

  float lu = 0.0f, lc = 0.0f;
  float m_t = CUDART_INF_F;  // the cert of tile t_cur so far
  int t_cur = t_lo;
  int n_fold = 0, n_lane = 0, n_stage = 0;
  int k = next_chunk(k_lo, &lu, &lc);
  if (k < k_hi) stage(k, 0);
  for (int slot = 0; k < k_hi; slot ^= 1) {
    ++n_stage;
    const bool need = needs(lu, lc);  // against the ub after chunks < k
    const int nxt = next_chunk(k + 1, &lu, &lc);
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
      for (const int tk = k / cpt; t_cur < tk; ++t_cur) {
        put_cert(t_cur, m_t);
        m_t = CUDART_INF_F;
      }
#pragma unroll 4
      for (int i = 0; i < nf; ++i) {
        const BoundPair v(bx, by, bz, p2, t[i * kBoundVec],
                          t[i * kBoundVec + 1].x);
        ub_run = min_nan(v.u, ub_run);
        m_t = min_nan(v.c, m_t);
      }
      su = sqrtf(max0(ub_run));
    }
    if (need) n_lane += nf;
    __syncwarp();  // every lane is done with ring[warp][slot]
    k = nxt;
  }
  for (; t_cur <= t_hi; ++t_cur) {
    put_cert(t_cur, m_t);
    m_t = CUDART_INF_F;
  }

  if (valid) {
    if (part_ub == nullptr) {
      ub[l.qi] = ub_run;
    } else {
      part_ub[static_cast<size_t>(s) * n_q + q] = ub_run;
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

// The splits' partials folded in split order with min_nan, one thread a
// sorted lane: ub[qorder[q]] over every split, cert[qorder[q], t] over the
// splits whose range touches tile t (+inf: none).
__global__ void mxu_bound_merge_kernel(const int* __restrict__ qorder,
                                       const float* __restrict__ part_ub,
                                       const float* __restrict__ part_cert,
                                       float* __restrict__ ub,
                                       float* __restrict__ cert, int n_q,
                                       int n_f, int tile_f, int n_tiles,
                                       int split, int slots) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_q) return;
  const int qi = qorder[q];
  if (qi < 0 || qi >= n_q) return;
  const int n_chunks = (n_f + kCullChunk - 1) / kCullChunk;
  const int cpt = tile_f / kCullChunk;
  float* row = cert + static_cast<size_t>(qi) * n_tiles;
  float u = part_ub[q];
  float m = CUDART_INF_F;
  int t_cur = 0;
  for (int s = 0; s < split; ++s) {
    if (s > 0) u = min_nan(part_ub[static_cast<size_t>(s) * n_q + q], u);
    int k_lo, k_hi, t_lo, t_hi;
    split_tiles(n_chunks, split, s, cpt, &k_lo, &k_hi, &t_lo, &t_hi);
    for (int t = t_lo; t <= t_hi; ++t) {
      for (; t_cur < t; ++t_cur) {
        row[t_cur] = m;
        m = CUDART_INF_F;
      }
      m = min_nan(
          part_cert[(static_cast<size_t>(s) * slots + (t - t_lo)) * n_q + q],
          m);
    }
  }
  for (; t_cur < n_tiles; ++t_cur) {
    row[t_cur] = m;
    m = CUDART_INF_F;
  }
  ub[qi] = u;
}

// The most tiles one split's chunk range touches.
inline int split_slots(int n_chunks, int split, int cpt) {
  int slots = 0;
  for (int s = 0; s < split; ++s) {
    int k_lo, k_hi, t_lo, t_hi;
    split_tiles(n_chunks, split, s, cpt, &k_lo, &k_hi, &t_lo, &t_hi);
    if (t_hi - t_lo + 1 > slots) slots = t_hi - t_lo + 1;
  }
  return slots;
}

}  // namespace mt

// pts [n_q, 3] (n_q a multiple of 32), qorder [n_q] int32 (a permutation),
// bnd [n_faces, 8] and chunks [ceil(n_faces / 32), 16] float32 (16-byte
// aligned); seeds [n_q] scratch; ub [n_q] and cert [n_q, ceil(n_faces /
// tile_f)] float32, tile_f a multiple of 32.  For split > 1 part_ub [split,
// n_q] and part_cert [split, slots, n_q] scratch (slots: the most tiles a
// split's chunk range touches, which the call checks), null otherwise.
// warp_chunks, lane_faces and warp_stages: null, or [split, n_q / 32],
// [split, n_q] and [split, n_q / 32] int32.  Returns the launches' CUDA
// error code.
extern "C" int mt_mxu_bound_culled(const float* pts, const int* qorder,
                                   const float* bnd, const float* chunks,
                                   float* seeds, float* part_ub,
                                   float* part_cert, float* ub, float* cert,
                                   int* warp_chunks, int* lane_faces,
                                   int* warp_stages, int n_q, int n_faces,
                                   int tile_f, int split, int slots,
                                   cudaStream_t stream) {
  using namespace mt;
  (void)cudaGetLastError();  // clear an error left by an earlier call
  const int n_chunks = (n_faces + kCullChunk - 1) / kCullChunk;
  if (n_faces <= 0 || n_q < 0 || n_q % 32 != 0 || tile_f <= 0 ||
      tile_f % kCullChunk != 0 || seeds == nullptr || split < 1 ||
      split > kMxuMaxSplit || (split > 1) != (part_ub != nullptr) ||
      (part_ub == nullptr) != (part_cert == nullptr) ||
      (split > 1 && slots != split_slots(n_chunks, split,
                                         tile_f / kCullChunk)) ||
      (warp_chunks == nullptr) != (lane_faces == nullptr) ||
      (warp_chunks == nullptr) != (warp_stages == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_q == 0) return 0;
  const int n_tiles = (n_faces + tile_f - 1) / tile_f;
  const int blocks = (n_q + kCullThreads - 1) / kCullThreads;
  const float4* bnd4 = reinterpret_cast<const float4*>(bnd);
  const float4* chunks4 = reinterpret_cast<const float4*>(chunks);
  mxu_bound_seed_kernel<<<blocks, kCullThreads, 0, stream>>>(
      pts, qorder, bnd4, chunks4, seeds, n_q, n_faces);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mxu_bound_cull_kernel<<<dim3(blocks, split), kCullThreads, 0, stream>>>(
      pts, qorder, bnd4, chunks4, seeds, ub, cert, part_ub, part_cert,
      warp_chunks, lane_faces, warp_stages, n_q, n_faces, tile_f, n_tiles,
      slots);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  mxu_bound_merge_kernel<<<(n_q + 255) / 256, 256, 0, stream>>>(
      qorder, part_ub, part_cert, ub, cert, n_q, n_faces, tile_f, n_tiles,
      split, slots);
  return static_cast<int>(cudaGetLastError());
}
