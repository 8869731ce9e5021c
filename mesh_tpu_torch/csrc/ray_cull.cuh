// The chunk test of the culled ray kernels of mesh_tpu_torch: whether a
// line or half-line o + t d may hit a face of a chunk of 32 faces, from the
// chunk's box, normal cone and margin terms (ray_kernel.py
// any_hit_records).  ray_any_hit_culled.cu culls the visibility rays with
// it; alongnormal_faces.cu reads the slab interval it computes too.
//
// A chunk record (5 float4): the float32 box [lo, hi] of the chunk's
// corners and its centre, a normal cone (unit axis, cosine ct and sine st
// of its half-angle), the largest shape factor rho_f = E^2 / |e1 x e2| of
// its faces (E = max(|e1|, |e2|)), the largest E, W = E + R (R: the
// largest distance of a corner from the centre) and Bm, the largest
// |coordinate| of the box; each face record carries its unit normal over
// rho_f in the three words RayFace leaves free.
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

#pragma once

#include <cfloat>

#include "ray_cost.cuh"

namespace mt {

constexpr int kChunk = 32;      // faces per chunk (one warp)
constexpr int kChunkVec = 5;    // float4 of a chunk record

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

// What a chunk test leaves for a caller that bounds the ray parameter of
// the chunk's hits (alongnormal_faces.cu): when the guard held (decided),
// the slab interval [t_near, t_far] of the line against the box grown by
// mt, the guard's pair (rho, c) and W + |o - cen|_1 (s).
struct ChunkSpan {
  float t_near, t_far, rho, c, s;
  bool decided;
};

// Whether this ray may hit a face of the chunk: the guard, the margin and
// the slab test of the note above, operation for operation as
// ray_kernel.py _chunk_keep.  With kSpan it also fills *span (decided
// false where the chunk is kept before the slab test); without it the code
// is the one row 8's kernel was measured with.
template <bool kSpan = false>
__device__ __forceinline__ bool chunk_needed(
    const CullRay& r, const float4* __restrict__ rec,
    const float4* __restrict__ normals, int has_lo, float t_lo,
    ChunkSpan* span = nullptr) {
  if constexpr (kSpan) span->decided = false;
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
  if constexpr (kSpan) {
    *span = ChunkSpan{t_near, t_far, rho, c, q4.x + sb, true};
  }
  return !miss;
}

}  // namespace mt
