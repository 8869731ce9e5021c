// The two triangle-triangle pair tests shared by tri_tri_any_hit.cu,
// tri_tri_any_hit_every.cu and self_intersect.cu (the Hopper counterparts
// of _tri_tri_hit_tile and _moller_hit in mesh_tpu/query/pallas_ray.py),
// and the plane cull that tri_tri_any_hit.cu and self_intersect.cu take
// in the Moller tile (plane_needs_box).
//
// SegmentTile: the 3 edges of the query triangle against the mesh face and
// the 3 edges of the mesh face against the query triangle, each the
// division-free line test of ray_cost.cuh with eps = beps = 1e-9 and the
// segment bounds t in [t_lo, t_hi] (float32 values of -1e-9 and 1 + 1e-9,
// the latter 1.0f).  Query operand: the raw corners a, b, c (9 floats);
// face operand: a, e1, e2 (9 floats).  The face corners b = a + e1 and
// c = a + e2 are rebuilt from the planes and the query edges taken from the
// raw corners, so the two directions round differently, as in the reference.
//
// MollerTile: Moller's interval test without division, on 13 floats per
// triangle: the corners, the unit normal n and the plane offset
// d = -n.corner0, computed by the PyTorch prologue from triangles jointly
// prescaled into the unit box (query/tri_tri_kernel.py moller_planes).  The
// five-way case chain of each interval is a chain of selects; the
// interval-overlap test is written !(hi1 < lo2 || hi2 < lo1), so a NaN
// endpoint reports overlap as the reference's does, and min / max
// propagate NaN as jnp.minimum / jnp.maximum do.
//
// The plain PyTorch versions (query/tri_tri_kernel.py segment_hit_tile and
// moller_hit_tile) make the same operations in the same order; build with
// --fmad=false so that no product and sum fuse.
//
// Operations per pair, counting each add, multiply, compare, logical and
// select as one: a segment test is line_hit's 60, the two t bounds (2
// multiplies, 2 compares, 2 ands) and its direction (3 subtracts): 69; the
// segment tile is six of them, the rebuilt corners (6 adds), the second
// query edge (3 subtracts; the first is the first segment's direction) and
// five ors: 428.  The Moller tile: six plane distances of 9 (54), the four
// sign products (4), the two one-side rejects (6), the line direction (9)
// and its magnitudes (3), the axis choice (3), six projections (12), two
// interval set-ups of 54 (108: 8 case tests, 17 select masks, 18 formula
// operations, 10 picks, and the coplanar flag), the interval ends (17),
// their min and max (4), the overlap (4) and the final mask (8): 232, of
// which the plane sides (the distances, products and rejects) are 64.

#pragma once

#include "ray_cost.cuh"

namespace mt {

constexpr float kTriEps = 1e-9f;  // segment and plane tolerance (_EPS)

// Blocks a launch aims for: a few per SM of the H100's 132, so that a
// query set of a few thousand triangles still fills the card.
constexpr int kTargetBlocks = 4 * 132;

// How a launch of q_blocks query blocks splits the n_f faces across
// blockIdx.y: into *n_split ranges of *per_split faces (a whole number of
// staging tiles each; the last range may be short), for about `target`
// blocks in all.
inline void face_splits(int q_blocks, int n_f, int tile, int* n_split,
                        int* per_split, int target = kTargetBlocks) {
  const int tiles = (n_f + tile - 1) / tile;
  int s = (target + q_blocks - 1) / q_blocks;
  s = s < 1 ? 1 : s;
  s = s > tiles ? tiles : s;
  s = s > 65535 ? 65535 : s;
  *per_split = ((tiles + s - 1) / s) * tile;
  *n_split = (n_f + *per_split - 1) / *per_split;
}

// jnp.minimum / jnp.maximum: NaN in either argument gives NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// The segment o -> o + d against the triangle (a, e1, e2): line_hit with
// the tight tolerances, then t_lo <= t <= t_hi multiplied through by |det|.
__device__ __forceinline__ bool seg_hit(float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        const float* a, const float* e1,
                                        const float* e2, float t_lo,
                                        float t_hi) {
  float ad, tn;
  const bool h = line_hit(ox, oy, oz, dx, dy, dz, a[0], a[1], a[2], e1[0],
                          e1[1], e1[2], e2[0], e2[1], e2[2], ad, tn, kTriEps,
                          kTriEps);
  return h & (tn >= t_lo * ad) & (tn <= t_hi * ad);
}

struct SegmentTile {
  static constexpr int kQuery = 9;  // corners a, b, c
  static constexpr int kFace = 9;   // corner a, edges e1, e2

  __device__ static bool hit(const float* q, const float* m, float t_lo,
                             float t_hi) {
    const float* qa = q;
    const float* qb = q + 3;
    const float* qc = q + 6;
    const float* ma = m;
    const float* me1 = m + 3;
    const float* me2 = m + 6;
    const float mb[3] = {ma[0] + me1[0], ma[1] + me1[1], ma[2] + me1[2]};
    const float mc[3] = {ma[0] + me2[0], ma[1] + me2[1], ma[2] + me2[2]};
    // the query's edges against the mesh face
    bool hit = seg_hit(qa[0], qa[1], qa[2], qb[0] - qa[0], qb[1] - qa[1],
                       qb[2] - qa[2], ma, me1, me2, t_lo, t_hi);
    hit = hit | seg_hit(qb[0], qb[1], qb[2], qc[0] - qb[0], qc[1] - qb[1],
                        qc[2] - qb[2], ma, me1, me2, t_lo, t_hi);
    hit = hit | seg_hit(qc[0], qc[1], qc[2], qa[0] - qc[0], qa[1] - qc[1],
                        qa[2] - qc[2], ma, me1, me2, t_lo, t_hi);
    // the mesh face's edges against the query
    const float qe1[3] = {qb[0] - qa[0], qb[1] - qa[1], qb[2] - qa[2]};
    const float qe2[3] = {qc[0] - qa[0], qc[1] - qa[1], qc[2] - qa[2]};
    hit = hit | seg_hit(ma[0], ma[1], ma[2], mb[0] - ma[0], mb[1] - ma[1],
                        mb[2] - ma[2], qa, qe1, qe2, t_lo, t_hi);
    hit = hit | seg_hit(mb[0], mb[1], mb[2], mc[0] - mb[0], mc[1] - mb[1],
                        mc[2] - mb[2], qa, qe1, qe2, t_lo, t_hi);
    hit = hit | seg_hit(mc[0], mc[1], mc[2], ma[0] - mc[0], ma[1] - mc[1],
                        ma[2] - mc[2], qa, qe1, qe2, t_lo, t_hi);
    return hit;
  }
};

// jnp.where(|val| < eps, 0, val) of the plane distance n.p + d
__device__ __forceinline__ float plane_dist(const float* n, float d,
                                            const float* p) {
  const float val = n[0] * p[0] + n[1] * p[1] + n[2] * p[2] + d;
  return fabsf(val) < kTriEps ? 0.0f : val;
}

// The plane cull of the Moller tile (self_intersect.cu's query plane
// against a tile box, tri_tri_any_hit.cu's face planes against the query
// box and its query planes against chunk boxes): whether the plane (n, d)
// may pass within the margin M = kPlaneMarginFloor + kPlaneMarginRel * X,
// X = |n|_1 P + |d|, of a box of corners b0 = (lo.x, lo.y, lo.z, hi.x),
// b1 = (hi.y, hi.z, P, -), P the largest corner magnitude; the margin is
// taken only where X < kPlaneMarginCap.  Where it returns false, every
// corner in the box has a plane_dist at least kTriEps of one sign, so a
// triangle with its three corners there lies strictly on one side of the
// plane (the lemma of self_intersect.cu's note).  A NaN plane or box
// returns true.
constexpr float kPlaneMarginFloor = 0x1p-28f;
constexpr float kPlaneMarginRel = 0x1p-20f;
constexpr float kPlaneMarginCap = 0x1p100f;
constexpr int kBoxWords = 8;  // a box record: lo (3), hi (3), P, one word

__device__ __forceinline__ bool plane_needs_box(float nx, float ny, float nz,
                                                float d, float4 b0,
                                                float4 b1) {
  const float lox = b0.x, loy = b0.y, loz = b0.z;
  const float hix = b0.w, hiy = b1.x, hiz = b1.y, p = b1.z;
  const bool px = nx >= 0.0f, py = ny >= 0.0f, pz = nz >= 0.0f;
  const float s_min = nx * (px ? lox : hix) + ny * (py ? loy : hiy) +
                      nz * (pz ? loz : hiz) + d;
  const float s_max = nx * (px ? hix : lox) + ny * (py ? hiy : loy) +
                      nz * (pz ? hiz : loz) + d;
  const float x = (fabsf(nx) + fabsf(ny) + fabsf(nz)) * p + fabsf(d);
  const float margin = kPlaneMarginFloor + kPlaneMarginRel * x;
  const bool skip =
      (x < kPlaneMarginCap) & ((s_min > margin) | (s_max < -margin));
  return !skip;
}

// One triangle's interval on the intersection line (_moller_intervals):
// the projections vp*, plane distances dv* and their products.
struct Interval {
  float a, b, c, x0, x1;
  bool coplanar;
};

__device__ __forceinline__ Interval moller_interval(float vp0, float vp1,
                                                    float vp2, float dv0,
                                                    float dv1, float dv2,
                                                    float dv0dv1,
                                                    float dv0dv2) {
  const bool case1 = dv0dv1 > 0.0f;                        // dv2 alone
  const bool case2 = dv0dv2 > 0.0f;                        // dv1 alone
  const bool case3 = (dv1 * dv2 > 0.0f) | (dv0 != 0.0f);   // dv0 alone
  const bool case4 = dv1 != 0.0f;
  const bool case5 = dv2 != 0.0f;
  const bool sel_d1 = (!case1 & case2) | (!case1 & !case2 & !case3 & case4);
  const bool sel_d2 = case1 | (!case1 & !case2 & !case3 & !case4 & case5);
  Interval out;
  out.coplanar = !case1 & !case2 & !case3 & !case4 & !case5;
  // base vertex 2 (case1 / case5), 1 (case2 / case4), 0 (case3)
  const float b2 = (vp0 - vp2) * dv2, c2 = (vp1 - vp2) * dv2;
  const float x0_2 = dv2 - dv0, x1_2 = dv2 - dv1;
  const float b1 = (vp0 - vp1) * dv1, c1 = (vp2 - vp1) * dv1;
  const float x0_1 = dv1 - dv0, x1_1 = dv1 - dv2;
  const float b0 = (vp1 - vp0) * dv0, c0 = (vp2 - vp0) * dv0;
  const float x0_0 = dv0 - dv1, x1_0 = dv0 - dv2;
  out.a = sel_d2 ? vp2 : (sel_d1 ? vp1 : vp0);
  out.b = sel_d2 ? b2 : (sel_d1 ? b1 : b0);
  out.c = sel_d2 ? c2 : (sel_d1 ? c1 : c0);
  out.x0 = sel_d2 ? x0_2 : (sel_d1 ? x0_1 : x0_0);
  out.x1 = sel_d2 ? x1_2 : (sel_d1 ? x1_1 : x1_0);
  return out;
}

// The Moller tile's plane sides of one pair: each triangle's corners
// against the other's plane, and whether either lies strictly on one side
// (reject_q: the query against the mesh face's plane; reject_m: the mesh
// face against the query's).
struct MollerSides {
  float dv0, dv1, dv2, dv0dv1, dv0dv2;
  float du0, du1, du2, du0du1, du0du2;
  bool reject;  // reject_q | reject_m: the pair cannot hit
};

struct MollerTile {
  static constexpr int kQuery = 13;  // corners (9), unit normal (3), offset
  static constexpr int kFace = 13;

  // The plane distances and the two one-side rejects: 64 of the tile's 232
  // operations, the first ones hit makes.
  __device__ static MollerSides sides(const float* q, const float* m) {
    const float* n1 = q + 9;
    const float d1 = q[12];
    const float* n2 = m + 9;
    const float d2 = m[12];
    MollerSides s;
    s.dv0 = plane_dist(n2, d2, q);
    s.dv1 = plane_dist(n2, d2, q + 3);
    s.dv2 = plane_dist(n2, d2, q + 6);
    s.dv0dv1 = s.dv0 * s.dv1;
    s.dv0dv2 = s.dv0 * s.dv2;
    const bool reject_q = (s.dv0dv1 > 0.0f) & (s.dv0dv2 > 0.0f);

    s.du0 = plane_dist(n1, d1, m);
    s.du1 = plane_dist(n1, d1, m + 3);
    s.du2 = plane_dist(n1, d1, m + 6);
    s.du0du1 = s.du0 * s.du1;
    s.du0du2 = s.du0 * s.du2;
    const bool reject_m = (s.du0du1 > 0.0f) & (s.du0du2 > 0.0f);
    s.reject = reject_q | reject_m;
    return s;
  }

  // The interval part (the other 168 operations): whether the two
  // triangles' intervals on the intersection line overlap, neither being
  // coplanar.  hit is this and not s.reject.
  __device__ static bool intervals(const float* q, const float* m,
                                   const MollerSides& s) {
    const float* q0 = q;
    const float* q1 = q + 3;
    const float* q2 = q + 6;
    const float* n1 = q + 9;
    const float* m0 = m;
    const float* m1 = m + 3;
    const float* m2 = m + 6;
    const float* n2 = m + 9;

    // the intersection line's direction and its dominant axis
    const float dx = n1[1] * n2[2] - n1[2] * n2[1];
    const float dy = n1[2] * n2[0] - n1[0] * n2[2];
    const float dz = n1[0] * n2[1] - n1[1] * n2[0];
    const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
    const bool use_y = ay > ax;
    const bool use_z = az > nan_max(ax, ay);
    // projections on the dominant axis, as selects (no dynamic index)
    auto proj = [use_y, use_z](const float* p) {
      return use_z ? p[2] : (use_y ? p[1] : p[0]);
    };

    const Interval i1 = moller_interval(proj(q0), proj(q1), proj(q2), s.dv0,
                                        s.dv1, s.dv2, s.dv0dv1, s.dv0dv2);
    const Interval i2 = moller_interval(proj(m0), proj(m1), proj(m2), s.du0,
                                        s.du1, s.du2, s.du0du1, s.du0du2);

    const float xx = i1.x0 * i1.x1;
    const float yy = i2.x0 * i2.x1;
    const float xxyy = xx * yy;
    const float t1 = i1.a * xxyy;
    const float i1a = t1 + i1.b * i1.x1 * yy;
    const float i1b = t1 + i1.c * i1.x0 * yy;
    const float t2 = i2.a * xxyy;
    const float i2a = t2 + i2.b * xx * i2.x1;
    const float i2b = t2 + i2.c * xx * i2.x0;
    const float lo1 = nan_min(i1a, i1b), hi1 = nan_max(i1a, i1b);
    const float lo2 = nan_min(i2a, i2b), hi2 = nan_max(i2a, i2b);
    const bool overlap = !((hi1 < lo2) | (hi2 < lo1));
    return overlap & !i1.coplanar & !i2.coplanar;
  }

  __device__ static bool hit(const float* q, const float* m, float /*t_lo*/,
                             float /*t_hi*/) {
    const MollerSides s = sides(q, m);
    return intervals(q, m, s) & !s.reject;
  }
};

}  // namespace mt
