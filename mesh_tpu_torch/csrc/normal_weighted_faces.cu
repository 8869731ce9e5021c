// Normal-weighted nearest face on Hopper (sm_90a), by an exact per-warp
// chunk cull (csrc/closest_cull.cuh): the registration path's kernel.  Per
// query point p and normal n_p, the face with the least
// |p - q| + eps (1 - n_p . n_tri), q the face's closest point and n_tri its
// unit normal; the lowest index on exact ties.
//
// Replaces: mesh_tpu/query/pallas_normal_weighted.py
// nearest_normal_weighted_pallas (make_argmin_kernel over _nw_cost_tile).
// The reference folds every face of every tile; this kernel gives the same
// faces, bit for bit, on every input, as the every-face kernel
// (normal_weighted_faces_every.cu) that chip_smoke.py holds it to.
//
// Bound on the H100: float32 issue on the pairs the cull lets through.  A
// pair costs 96 operations without the degenerate tail and 127 with it
// (csrc/nw_cost.cuh).  Around the pairs a lane computes a bound per chunk
// it scans (row 1's 41 operations and 5 more: the -inf test, the max, the
// square root and the add of NormalWeightedCost::lower) and, in a pass of
// its own, a seed (one distance per chunk and one pair).  The every-face
// kernel issues every pair near the SM's instruction rate: the cull is
// what the design does about the bound.
//
// Operands (mesh_tpu_torch/query/normal_weighted.py
// normal_weighted_cull_operands): pts, normals [B, Q, 3] and planes
// [B, 22, F] as the every-face kernel takes them; qorder [B, Q] int32 (each
// mesh's queries in Morton order, a permutation); records [B, C, 12],
// C = ceil(F / 32): closest_cull.cuh's chunk records of the first 19
// planes (cull_records.cu reads them in place), the same fast tile's;
// bounds [B] float32, per mesh an upper bound on every face normal's norm
// (normal_bounds).  Scratch: seeds [B, Q] and, for split > 1, part_d and
// part_i [split, B, Q].  Outputs: the face per query at out[b, qorder[b,
// q]], and on request, per split, the chunks each warp folded, the real
// faces of the chunks each lane needed (at its sorted position) and the
// chunks each warp staged, [split, B, ceil(Q / 32)] and [split, B, Q].
//
// Design: three launches.  nw_seed_kernel, one thread a sorted lane, costs
// the first face of the chunk whose representative is nearest, with the
// lane's normal and eps: closest_cull.cuh's seed, in a pass of its own so
// that the splits of a warp's chunks share it.  closest_cull_kernel over
// NormalWeightedCost: row 1's loop (Morton lanes, chunks of 32 faces in
// index order, each warp voting one chunk ahead, staging its own cp.async
// double buffer and folding every face of a chunk one of its lanes needs),
// with each lane's normal, eps and its own P_lo (item 6); gridDim.z =
// split warps share a warp's chunks.  For split > 1 closest_cull.cuh's
// cull_merge_kernel folds the splits' (best_d, best_i) in split order with
// a strict <.  The
// planted miss of the registration drive, 50 body radii out, needs about
// half of the chunks (tools/cull_counts.py --nw): at split 1 its warp
// alone would set the launch's pace.
//
// Why the answers do not change.  Items (1)-(5) of closest_cull.cuh's note
// carry over with "cost" for "squared distance" (the exact fold; the fused
// one is not used): a superset fold in increasing face order with a strict
// <, a seed that is a cost the kernel computes for a real face, and a skip
// only when LB > thr >= m*, written !(LB > thr) so that a NaN bound is
// always needed and ties are kept.  What remains is LB <= c_f for every
// face f of a skipped chunk, c_f its computed cost.
// (6) The bound.  c_f = fl(fl(sqrtf(d2)) + P), P = fl(eps fl(1 - ndot)),
//     with d2 the fast tile's computed squared distance (clamped by fmaxf:
//     d2 >= 0, a NaN mapped to 0) and ndot = fl(fl(fl(nx tnx) + fl(ny
//     tny)) + fl(nz tnz)).  LB = fl(sqrtf(max(lb2, 0)) + P_lo) when lb2 >
//     -inf, and -inf otherwise (a chunk past kCullFar, an always-needed
//     chunk, a NaN bound: always needed), with P_lo = fl(eps fl(1 - x)),
//     x = hi for eps >= 0 and -hi for eps < 0, hi >= |ndot| (item 7).
//     (a) Correctly rounded sqrtf (the build has no fast math), +, - and
//         the product by a fixed factor are monotone: x <= y gives
//         fl(x) <= fl(y), and the product by eps < 0 reverses the order.
//     (b) Item (4) of closest_cull.cuh gives d2 >= lb2 for every face of
//         the chunk; with d2 >= 0, sqrtf(d2) >= sqrtf(max(lb2, 0)).
//     (c) eps >= 0: ndot <= hi, so 1 - ndot >= 1 - hi, fl(1 - ndot) >=
//         fl(1 - hi) and P >= P_lo.  eps < 0: ndot >= -hi, so fl(1 -
//         ndot) <= fl(1 + hi) and the product by eps reverses it: P >=
//         P_lo.  eps = 0: both are zeros (a zero's sign is no order), or
//         P_lo is NaN when 1 - hi is not finite (always needed).  Unit
//         query normals are not assumed: with |n_p| = 3 the penalty
//         reaches -2 eps, and hi = 3 (1 + O(u)) follows it; n_p = 0 gives
//         hi = 2^-100 and P_lo = eps, the exact penalty.
//     (d) By (a) on the sum, c_f = fl(sqrtf(d2) + P) >= fl(sqrtf(max(lb2,
//         0)) + P_lo) = LB.  Infinities keep the order; a NaN c_f (inf -
//         inf) is never taken by the kernel's fold, so skipping it changes
//         nothing.
// (7) hi.  Let u = 2^-24 and eta = 2^-150 (a product's underflow; sums of
//     floats round relatively).  The computed |ndot| <= (1 + u)^3
//     sum |n_i t_i| + 3 eta <= (1 + u)^3 |n_p| |n_tri| + 3 eta
//     (Cauchy-Schwarz).  The lane's norm = fl(sqrtf(fl(fl(nx nx + ny ny) +
//     nz nz))) is at least (1 - 3u) |n_p| - 5e-23 (each square within u and
//     eta, sqrt(3 eta) < 5e-23), so up = fl(fl(norm (1 + 2^-18)) + 2^-64)
//     >= |n_p|: 2^-18 = 64u covers the relative terms and 2^-64 = 5.4e-20
//     the absolute one.  The mesh's bound is the same rounding up of each
//     face's fl(|n_tri|), its largest over the mesh (normal_bounds, in
//     PyTorch, the same IEEE operations in the same order): at least every
//     |n_tri|.  That is measured and not assumed: normalize_rows leaves
//     |n_tri| at 1 + O(u) for a normal of ordinary size, but its squares
//     underflow for a cross product near 1e-22, and then |n_tri| reaches
//     about 1.58.  So hi = fl(fl(fl(up bound) (1 + 2^-18)) + 2^-100) >=
//     |ndot|: the factor covers (1 + u)^3 and the three roundings, and
//     2^-100 covers 3 eta.  An overflow makes hi +inf (LB -inf or NaN:
//     always needed).
// (8) NaN.  A NaN normal, face normal or eps makes P_lo NaN, so the lane
//     needs every chunk (the mesh's bound keeps a NaN: amax).  The
//     kernel's fold never takes a NaN cost, and a lane whose every cost is
//     NaN keeps face 0, as the every-face fold does.  The plain versions'
//     torch.argmin takes the first NaN instead; they agree with each other
//     because a cost can be NaN only where the lane needs every chunk of
//     the mesh: a NaN penalty (above), an infinite one (an infinite normal:
//     hi = inf), or a NaN squared distance in PyTorch, which needs a
//     non-finite plane (an always-needed chunk), a NaN query or one past
//     kCullFar (lb2 NaN or -inf; item 5 of closest_cull.cuh).
// (9) Seeds and splits.  The seed pass computes the functor the fold does,
//     on the same plane values, each operation rounded alone (no FMA): a
//     seed is the cost the fold computes for that face, so m* <= seed.  A
//     split folds a superset of the faces of its range with cost at most
//     m* (items 1-3 with its own best, which is at least m*).  The first
//     face f* reaching m* lies in one split's range, which returns (m*,
//     f*); earlier splits return a cost above m* and later ones at least
//     m*, so the in-order strict-< merge returns f*; when no cost is below
//     +inf every split returns (+inf, 0), as the every-face fold does.
//
// On the CPU tensors get normal_weighted.argmin_normal_weighted_plain; the
// plain version of this design, argmin_normal_weighted_culled_plain, makes
// the same decisions and counts (each warp's vote one chunk ahead and the
// splits included), so chip_smoke holds the kernel to it on faces and
// counts, and to the every-face kernel on faces.

#include "closest_cull.cuh"
#include "nw_cost.cuh"

namespace {

using mt::kCullChunk;
using mt::kCullThreads;

// the most warps that share one warp's chunks (gridDim.z)
constexpr int kNwMaxSplit = 64;

// The seed of each sorted lane q of mesh b, one thread a lane, written to
// seeds[b, q]: the cost of the first face of the chunk whose representative
// is nearest (+inf for a lane past a permutation's range).
template <bool kTail>
__global__ void __launch_bounds__(kCullThreads)
nw_seed_kernel(const float* __restrict__ pts,
               const float* __restrict__ normals,
               const int* __restrict__ qorder,
               const float* __restrict__ planes,
               const float4* __restrict__ recs, float* __restrict__ seeds,
               int n_q, int n_f, float eps) {
  using Cost = mt::NormalWeightedCost<kTail>;
  const int b = blockIdx.y;
  const int q = blockIdx.x * kCullThreads + threadIdx.x;
  if (q >= n_q) return;
  const int qi = qorder[static_cast<size_t>(b) * n_q + q];
  float seed = CUDART_INF_F;
  if (qi >= 0 && qi < n_q) {
    const size_t at = (static_cast<size_t>(b) * n_q + qi) * 3;
    const float px = pts[at], py = pts[at + 1], pz = pts[at + 2];
    const int n_chunks = (n_f + kCullChunk - 1) / kCullChunk;
    const int fs = mt::cull_seed_face(
        recs + static_cast<size_t>(b) * n_chunks * 3, n_chunks, px, py, pz);
    float4 face[Cost::kVec];
    Cost::stage(planes + static_cast<size_t>(b) * Cost::kRows * n_f, n_f,
                fs, reinterpret_cast<float*>(face));
    seed = Cost::cost(px, py, pz, normals[at], normals[at + 1],
                      normals[at + 2], eps, face);
  }
  seeds[static_cast<size_t>(b) * n_q + q] = seed;
}

template <bool kTail>
int launch_nw(const float* pts, const float* normals, const int* qorder,
              const float* planes, const float* recs, const float* bounds,
              float* seeds, float* part_d, int* part_i, int* out,
              int* warp_chunks, int* lane_faces, int* warp_stages, int n_b,
              int n_q, int n_f, int split, float eps, cudaStream_t stream) {
  using Cost = mt::NormalWeightedCost<kTail>;
  const float4* rec = reinterpret_cast<const float4*>(recs);
  const int blocks = (n_q + kCullThreads - 1) / kCullThreads;
  nw_seed_kernel<kTail><<<dim3(blocks, n_b), kCullThreads, 0, stream>>>(
      pts, normals, qorder, planes, rec, seeds, n_q, n_f, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const mt::CullExtra<Cost> ex{normals, bounds, seeds, part_d, part_i, eps};
  mt::closest_cull_kernel<Cost, mt::ExactFold>
      <<<dim3(blocks, n_b, split), kCullThreads, 0, stream>>>(
          pts, qorder, planes, rec, out, warp_chunks, lane_faces,
          warp_stages, n_q, n_f, 0, ex);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(n_b) * n_q;
  mt::cull_merge_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                           stream>>>(part_d, part_i, out, n, split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pts, normals [B, Q, 3], qorder [B, Q] int32, planes [B, 22, F], records
// [B, ceil(F / 32), 12] and bounds [B] float32; seeds [B, Q] float32
// scratch; part_d [split, B, Q] float32 and part_i int32 scratch for
// split > 1, null otherwise; out [B, Q] int32; warp_chunks
// [split, B, ceil(Q / 32)], lane_faces [split, B, Q] and warp_stages
// [split, B, ceil(Q / 32)] int32 all null or all set.  tail: 1 with the
// degenerate-face tail; split: warps sharing one warp's chunks, 1 to 64.
// Returns the launches' CUDA error code.
extern "C" int mt_normal_weighted_faces(
    const float* pts, const float* normals, const int* qorder,
    const float* planes, const float* recs, const float* bounds,
    float* seeds, float* part_d, int* part_i, int* out, int* warp_chunks,
    int* lane_faces, int* warp_stages, int n_b, int n_q, int n_faces,
    int tail, int split, float eps, cudaStream_t stream) {
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (split < 1 || split > kNwMaxSplit || seeds == nullptr ||
      (split > 1) != (part_d != nullptr) ||
      (part_d == nullptr) != (part_i == nullptr) ||
      (warp_chunks == nullptr) != (lane_faces == nullptr) ||
      (warp_chunks == nullptr) != (warp_stages == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_b <= 0 || n_q <= 0) return 0;
  if (n_b > 65535 || n_faces <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto launch = tail ? launch_nw<true> : launch_nw<false>;
  return launch(pts, normals, qorder, planes, recs, bounds, seeds, part_d,
                part_i, out, warp_chunks, lane_faces, warp_stages, n_b, n_q,
                n_faces, split, eps, stream);
}
