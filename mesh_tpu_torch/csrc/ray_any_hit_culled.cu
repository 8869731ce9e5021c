// Culled any-hit ray test on Hopper (sm_90a): per ray, whether it meets any
// face of its own mesh within [t_lo, t_hi], testing only the chunks of
// faces that some ray of its warp may hit.
//
// Replaces: mesh_tpu/query/pallas_ray.py ray_any_hit_pallas (kernel
// _any_hit_kernel over _mt_hit), the visibility hot loop, as a redesign of
// ray_any_hit.cu, which stays as the every-face kernel and flag oracle.
//
// Operands (mesh_tpu_torch/query/ray_kernel.py any_hit_operands, per mesh
// of a batch): the faces in the Morton order of their centroids,
// edge-padded to whole chunks of kChunk faces, as records of 3 float4: a,
// e1, e2 in RayFace's shared layout, then, in the three words RayFace
// leaves free, the face's unit normal over its shape factor rho_f = E^2 /
// |e1 x e2| (E = max(|e1|, |e2|)), from float64 terms, rounded; and per
// chunk a record of 5 float4 (chunk_needed below): its float32 box [lo,
// hi], its centre, a normal cone (unit axis, cosine ct and sine st of its
// half-angle), its largest rho_f (rho), its largest edge E, W = E + R (R:
// the largest distance of a corner from the centre) and Bm, the largest
// |coordinate| of its box.  A chunk holding a NaN or inf corner, or a face
// without area, has rho = +inf and is always kept.  Rays come in any
// order; visibility sorts each mesh's vertices by Morton code first, so
// that a warp holds 32 neighbouring rays.
//
// Bound on the H100: float32 issue over the pairs each lane evaluates (64
// operations a pair, as ray_any_hit.cu) and each lane's chunk tests
// (chunk_needed, counted in chip_smoke.py), against 48 bytes a face and 80
// a chunk read once per staged chunk.  The dense kernel tests every face
// for every ray that no face blocks, about 71% of all pairs on the
// visibility drive, at the card's float32 rate.
//
// Design.  One block of kThreads threads owns a run of rays of one mesh,
// one thread one ray.  The block walks the chunks in increasing order.
// For each chunk every unblocked lane runs chunk_needed on its own ray; the
// block stages the chunk when some thread needs it (__syncthreads_or, the
// vote made chunk by chunk, as csrc/culled_faces.cu does, because a lane
// that is blocked meanwhile stops voting: a precomputed per-warp bitmask
// would keep the chunks its blocked lanes once needed), a warp tests it
// when one of its lanes needs it (__any_sync), and only those lanes run the
// unchanged RayFace::hit and t tests (ray_any_hit.cu) on its real faces in
// increasing order, each stopping at its first hit.  Staging is a cp.async
// double buffer of 16-byte copies: while chunk k is tested the next chunk
// some lane needs, by a vote made before k was tested (which can only keep
// more: a lane's need falls once it is blocked), is already loading.  The
// block stops once every ray is blocked.  Outputs per ray: blocked, and the
// pairs its own lane evaluated; on request, per warp the chunks it tested,
// and per ray the sorted position of the face that blocked it (-1: none),
// the first hit in the sorted order, as the dense kernel would find it on
// the sorted faces.  The plain version (ray_any_hit_culled_plain) makes the
// same decisions and counts.
//
// Why no pair that could hit is skipped.  u = 2^-24 (float32, round to
// nearest, no FMA: --fmad=false).  Take a face with float32 corner a and
// edges e1, e2 (exact values; T the triangle a + x e1 + y e2, x, y >= 0,
// x + y <= 1), N = |e1 x e2|, E and rho_f as above, and a ray o, d with S
// = o - a, D = e1.(d x e2) = |d| N c_f, c_f = |cos phi| the cosine between
// d and the face normal.  Standard bounds on line_hit's float32 steps
// (ray_cost.cuh; each cross component within 2u, each 3-term dot within
// 3u, s = o - a within u) give
//   |det - D| <= 7u |d| E^2,  |un - U|, |vn - V| <= 8u |S| |d| E,
//   |tn - TN| <= 8u |S| E^2,
// U, V, TN the exact sign-carried numerators.  When c_f > 2^-18 rho_f, 7u
// |d| E^2 < D / 2, so sign(det) = sign(D), and an accepted pair (un, vn >=
// -tol, un + vn <= |det| + tol, tol = 1e-6 |det|) has exact barycentrics
// x = U / |D|, y = V / |D| with x, y >= -delta and x + y <= 1 + delta,
//   delta = 1.01 (7u E^2 + 16u |S| E) / (N c_f) + 1.7e-6.
// The exact line meets the plane at P = a + x e1 + y e2 (= o + t d, t =
// TN / |D|), and clamping and rescaling (x, y) onto T moves P by at most
// 5 delta E.  The t test (tn >= t_lo |det|) gives t >= t_lo - tau with
// tau |d| <= 8u |S| k + u |t_lo| |d| (7 k + 1.5), k = rho_f / c_f, so the
// point of the half-line at max(t, t_lo) lies within
//   m1 <= u k (35.4 E + 88.8 |S| + 7 |t_lo| |d|) + 8.5e-6 E
//         + 1.5u |t_lo| |d| + u E
// of T, and T lies within u E of the box of the float32 corners (e1 =
// fl(b - a)).  With a pair (rho, c) such that rho / c >= rho_f / c_f for
// every face of the chunk (below), the kernel takes
//   m  = 2^-17 rho (W + |o - cen|_1 + |t_lo| |d|) / c + 2^-16 E  (>= m1,
//        since |S| <= |o - cen|_1 + R, 2^-17 = 128u, 2^-16 > 1.5e-5),
//   mt = m + 2^-20 (Bm + |o|_inf + m),
// and slab-tests the half-line t >= t_lo (the whole line without t_lo;
// t_hi is not used, which only keeps more) against [lo - mt, hi + mt]: the
// 2^-20 term covers the slab test's own rounding (lo - mt, minus o, times
// 1 / d: 5u (|lo| + |o| + mt) on each side), so a ray whose exact
// half-line meets the box grown by m is kept, and with it every face the
// float32 predicate could accept.  The constants' slack (over 40%) covers
// the rounding of m's own evaluation.  The pair (rho, c) comes from the
// cone: rho is the chunk's largest rho_f and, with ca = |d/|d| . axis|
// (within 10u of the exact cosine), the cosine of the angle of d to every
// face normal is at least
//   c = (ca - 2^-19) ct - sqrt((1 - ca^2) + 2^-17) st
// (cos(alpha + theta), each factor bounded the safe way, the 2^-19 and
// 2^-17 pads covering ca's error and c's rounding; ct is rounded down, st
// up, and the prologue subtracts 1e-6 from ct for its float64 normals).  A
// cone of 90 degrees or more, or one without a finite axis, has ct = 0, st
// = 1, so c < 0.  When the cone fails the guard c > 2^-18 rho, rho = 1 and
// c = min_f |d/|d| . n_f / rho_f| - 2^-19, from the records' scaled
// normals (within 2u of the exact direction, the dot within 12u / rho_f):
// on posed synthetic bodies a chunk's cone is about 30 degrees wide, and
// this bound fails the guard on about 0.1% of (ray, chunk) pairs where the
// cone's fails on half.  Both pairs give c / rho <= c_f / rho_f, so the
// guard c > 2^-18 rho implies each face's.  Whenever the guard fails (c <=
// 0 near parallel, NaN, a sliver) the chunk is kept.  Origin terms grow
// with |S|, so a ray whose origin lies on the surface (min_dist 1e-3) keeps
// its own neighbourhood's chunks by the box itself.  A ray with a NaN or
// inf origin or direction keeps every chunk.

#include <cfloat>

#include "ray_cost.cuh"

namespace mt {

constexpr int kThreads = 128;   // rays per block
constexpr int kChunk = 32;      // faces per chunk (one warp)
constexpr int kChunkVec = 5;    // float4 of a chunk record
// blocks an SM keeps resident: 8 caps the kernel at 64 registers (80
// bytes spill), 7-10% faster than uncapped (72-80 registers) on the
// visibility drive's rays (H100 80GB HBM3)
constexpr int kBlocksPerSM = 8;

constexpr float kConePad = 0x1p-19f;    // off |cos alpha|
constexpr float kSinePad = 0x1p-17f;    // under the sine's root
constexpr float kGuard = 0x1p-18f;      // c > kGuard * rho, else keep
constexpr float kMarginRel = 0x1p-17f;  // m's origin and edge term
constexpr float kMarginEdge = 0x1p-16f; // m's tolerance term
constexpr float kSlabPad = 0x1p-20f;    // the slab test's rounding

// A lane's ray and what its chunk tests reuse.
struct CullRay {
  float ox, oy, oz, dx, dy, dz;
  float hx, hy, hz;  // d / |d|
  float ix, iy, iz;  // 1 / d
  float onorm;       // |o|_inf
  float tlod;        // |t_lo| |d| (0 without t_lo)
  bool wild;         // a NaN or inf component: every chunk is kept

  __device__ void init(float ox_, float oy_, float oz_, float dx_, float dy_,
                       float dz_, int has_lo, float t_lo) {
    ox = ox_; oy = oy_; oz = oz_; dx = dx_; dy = dy_; dz = dz_;
    const float dn = sqrtf(dx * dx + dy * dy + dz * dz);
    const float inv = 1.0f / dn;
    hx = dx * inv; hy = dy * inv; hz = dz * inv;
    ix = 1.0f / dx; iy = 1.0f / dy; iz = 1.0f / dz;
    onorm = fmaxf(fmaxf(fabsf(ox), fabsf(oy)), fabsf(oz));
    tlod = has_lo ? fabsf(t_lo) * dn : 0.0f;
    wild = !(isfinite(ox) && isfinite(oy) && isfinite(oz) && isfinite(dx) &&
             isfinite(dy) && isfinite(dz));
  }
};

// One axis of the slab test: (entry, exit) parameters of [l, h].
__device__ __forceinline__ void slab(float l, float h, float o, float i,
                                     float& t_in, float& t_out) {
  const float t0 = (l - o) * i;
  const float t1 = (h - o) * i;
  t_in = fminf(t0, t1);
  t_out = fmaxf(t0, t1);
}

// Whether this ray may hit a face of the chunk: the guard, the margin and
// the slab test of the source note, operation for operation as
// ray_kernel.py chunk_needs.
__device__ __forceinline__ bool chunk_needed(
    const CullRay& r, const float4* __restrict__ rec,
    const float4* __restrict__ normals, int has_lo, float t_lo) {
  const float4 q0 = __ldg(rec);
  // a chunk with a non-finite corner or a face without area: rho = +inf
  if (r.wild || !(q0.w <= FLT_MAX)) return true;
  const float4 q1 = __ldg(rec + 1), q2 = __ldg(rec + 2), q3 = __ldg(rec + 3),
               q4 = __ldg(rec + 4);
  // q0 lo, rho; q1 hi, E; q2 axis, ct; q3 centre, st; q4 W, Bm
  const float ca = fabsf(r.hx * q2.x + r.hy * q2.y + r.hz * q2.z);
  const float sa = sqrtf((1.0f - ca * ca) + kSinePad);
  float c = (ca - kConePad) * q2.w - sa * q3.w;
  float rho = q0.w;
  if (!(c > kGuard * rho)) {
    // the cone is too wide for this ray: the least |cos| / rho over the
    // faces, from the normals scaled by 1 / rho in their records
    float least = CUDART_INF_F;
    for (int j = 0; j < kChunk; ++j) {
      const float4 n = __ldg(normals + j * RayFace::kVec);
      least = fminf(least, fabsf(r.hx * n.y + r.hy * n.z + r.hz * n.w));
    }
    c = least - kConePad;
    rho = 1.0f;
    if (!(c > kGuard)) return true;
  }
  const float sb = fabsf(r.ox - q3.x) + fabsf(r.oy - q3.y) +
                   fabsf(r.oz - q3.z);
  const float m =
      (kMarginRel * rho) * ((q4.x + sb) + r.tlod) / c + kMarginEdge * q1.w;
  const float mt = m + kSlabPad * ((q4.y + r.onorm) + m);
  float ax, bx, ay, by, az, bz;
  slab(q0.x - mt, q1.x + mt, r.ox, r.ix, ax, bx);
  slab(q0.y - mt, q1.y + mt, r.oy, r.iy, ay, by);
  slab(q0.z - mt, q1.z + mt, r.oz, r.iz, az, bz);
  const float t_near = fmaxf(fmaxf(ax, ay), az);
  const float t_far = fminf(fminf(bx, by), bz);
  const bool miss = (t_near > t_far) | (has_lo && t_far < t_lo);
  return !miss;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
any_hit_culled_kernel(const float* __restrict__ orig,
                      const float* __restrict__ dirs,
                      const float4* __restrict__ faces,
                      const float4* __restrict__ chunks,
                      int* __restrict__ blocked, int* __restrict__ pairs,
                      int* __restrict__ warp_chunks,
                      int* __restrict__ hit_face, int n_r, int n_f, int n_c,
                      int has_lo, float t_lo, int has_hi, float t_hi) {
  __shared__ __align__(16) float4 ring[2][kChunk * RayFace::kVec];
  const int b = blockIdx.y;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool live = r < n_r;
  const size_t at = static_cast<size_t>(b) * n_r + r;
  const float4* fb =
      faces + static_cast<size_t>(b) * n_c * kChunk * RayFace::kVec;
  const float4* cb = chunks + static_cast<size_t>(b) * n_c * kChunkVec;

  CullRay ray;
  if (live) {
    ray.init(orig[at * 3], orig[at * 3 + 1], orig[at * 3 + 2], dirs[at * 3],
             dirs[at * 3 + 1], dirs[at * 3 + 2], has_lo, t_lo);
  } else {
    ray.init(0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0, 0.0f);
  }
  // a padding thread starts blocked, so it never votes
  bool hit = !live;
  int n_pair = 0, n_warp = 0, first = -1;

  // the first chunk in [k, n_c) that some thread needs (n_c: none), by one
  // block vote per chunk; *need receives this thread's own need of it
  auto next_chunk = [&](int k, bool* need) {
    for (; k < n_c; ++k) {
      *need = !hit &&
              chunk_needed(
                  ray, cb + k * kChunkVec,
                  fb + static_cast<size_t>(k) * kChunk * RayFace::kVec + 2,
                  has_lo, t_lo);
      if (__syncthreads_or(*need)) return k;
    }
    return n_c;
  };
  // chunk k's records into ring[slot], as one cp.async group of this thread
  auto stage = [&](int k, int slot) {
    const float4* src = fb + static_cast<size_t>(k) * kChunk * RayFace::kVec;
    for (int i = threadIdx.x; i < kChunk * RayFace::kVec; i += kThreads) {
      cp_async16(&ring[slot][i], src + i);
    }
    cp_async_commit();
  };

  bool voted = false;
  int k = next_chunk(0, &voted);
  if (k < n_c) stage(k, 0);
  for (int slot = 0; k < n_c; slot ^= 1) {
    // the vote was made before the chunks since then were tested: a lane
    // blocked meanwhile no longer needs chunk k
    const bool need = voted && !hit;
    const int nxt = next_chunk(k + 1, &voted);
    if (nxt < n_c) {
      stage(nxt, slot ^ 1);
      cp_async_wait<1>();  // chunk k's group has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (__any_sync(0xffffffffu, need)) {
      ++n_warp;
      if (need) {
        const int c0 = k * kChunk;
        const int n_real = min(kChunk, n_f - c0);
        for (int j = 0; j < n_real; ++j) {
          float ad, tn;
          bool h = RayFace::hit(ray.ox, ray.oy, ray.oz, ray.dx, ray.dy,
                                ray.dz, ring[slot] + j * RayFace::kVec, ad,
                                tn);
          if (has_lo) h = h & (tn >= t_lo * ad);
          if (has_hi) h = h & (tn <= t_hi * ad);
          ++n_pair;
          if (h) {
            hit = true;
            first = c0 + j;
            break;
          }
        }
      }
    }
    // also the barrier after every thread's reads of ring[slot]
    if (!__syncthreads_or(!hit)) break;
    k = nxt;
  }
  cp_async_wait<0>();  // a prefetch left in flight by the early exit
  if (live) {
    blocked[at] = hit ? 1 : 0;
    pairs[at] = n_pair;
  }
  if (hit_face == nullptr) return;
  if (live) hit_face[at] = first;
  if ((threadIdx.x & 31) == 0 && live) {
    warp_chunks[static_cast<size_t>(b) * ((n_r + 31) >> 5) + (r >> 5)] =
        n_warp;
  }
}

}  // namespace mt

// origins, dirs [B, R, 3] float32; faces [B, n_c * 32, 12] and chunks
// [B, n_c, 20] float32 from any_hit_operands (n_f of the faces real,
// n_c * 32 - n_f padding); blocked and pairs [B, R] int32; warp_chunks
// [B, ceil(R / 32)] and hit_face [B, R] int32 both null, or both receive
// the statistics.  has_lo / has_hi: 1 when t_lo / t_hi bound t.  Returns
// the launch's CUDA error code.
extern "C" int mt_ray_any_hit_culled(const float* orig, const float* dirs,
                                     const float* faces, const float* chunks,
                                     int* blocked, int* pairs,
                                     int* warp_chunks, int* hit_face, int n_b,
                                     int n_r, int n_f, int n_c, int has_lo,
                                     float t_lo, int has_hi, float t_hi,
                                     cudaStream_t stream) {
  using namespace mt;
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (n_b <= 0 || n_r <= 0) return 0;
  if (n_b > 65535 || n_c < 0 || n_f < 0 || n_f > n_c * kChunk ||
      n_f <= (n_c - 1) * kChunk ||
      ((warp_chunks == nullptr) != (hit_face == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n_r + kThreads - 1) / kThreads, n_b);
  any_hit_culled_kernel<<<grid, kThreads, 0, stream>>>(
      orig, dirs, reinterpret_cast<const float4*>(faces),
      reinterpret_cast<const float4*>(chunks), blocked, pairs, warp_chunks,
      hit_face, n_r, n_f, n_c, has_lo, t_lo, has_hi, t_hi);
  return static_cast<int>(cudaGetLastError());
}
