// Per-pair squared-distance functors shared by every closest-face kernel of
// mesh_tpu_torch (closest_faces.cu, culled_faces.cu, rope_faces.cu, and
// through ericson_tail the MXU kernels of mxu_cost.cuh), so
// that all of them round alike: the Hopper counterparts of
// _sqdist_tile_fast (-> _ericson_tail -> _region_select) and
// _sqdist_tile_safe in mesh_tpu/query/pallas_closest.py.  The plain
// PyTorch versions in mesh_tpu_torch/query/closest_kernel.py make the same
// operations in the same order; build with --fmad=false so that no product
// and sum fuse.
//
// A functor provides what csrc/argmin.cuh asks of one (kRows, kVec, stage,
// cost); fast_pair is the fast tile's arithmetic on the 19 values of one
// face, for kernels that keep the planes in another layout.  Staging<Cost>
// says how the chunk kernels (culled_faces.cu, closest_cull.cuh) copy a
// chunk of plane-major planes into the functor's shared-memory records.

#pragma once

#include "common.cuh"

namespace mt {

// The cost's final clamp at 0.  The exact kernels take fmaxf, which maps a
// NaN cost to 0; the fused reduction (kKeepNan) keeps NaN, as
// torch.clamp_min does, because its packed key reads the cost's bits.
template <bool kKeepNan>
__device__ __forceinline__ float clamp_cost(float d) {
  return kKeepNan ? max0(d) : fmaxf(d, 0.0f);
}

template <bool kTail, bool kKeepNan = false>
__device__ __forceinline__ float region_select(
    float d1, float d2, float d3, float d4, float d5, float d6, float ap2,
    float bp2, float cp2, float n_ap, float ab2, float ac2, float abac,
    float inv_ab2, float inv_ac2, float inv_bc2, float inv_n2) {
  const float va = d3 * d6 - d5 * d4;
  const float vb = d5 * d2 - d1 * d6;
  const float vc = d1 * d4 - d3 * d2;
  const float d_bc = d4 - d3;  // (c-b).(p-b), since ac - ab = bc

  float d = n_ap * n_ap * inv_n2;
  const float e_bc_edge = bp2 - d_bc * d_bc * inv_bc2;
  if ((va <= 0.0f) & (d_bc >= 0.0f) & (d5 - d6 >= 0.0f)) d = e_bc_edge;
  const float e_ca_edge = ap2 - d2 * d2 * inv_ac2;
  if ((vb <= 0.0f) & (d2 >= 0.0f) & (d6 <= 0.0f)) d = e_ca_edge;
  const float e_ab_edge = ap2 - d1 * d1 * inv_ab2;
  if ((vc <= 0.0f) & (d1 >= 0.0f) & (d3 <= 0.0f)) d = e_ab_edge;
  if ((d6 >= 0.0f) & (d5 <= d6)) d = cp2;
  if ((d3 >= 0.0f) & (d4 <= d3)) d = bp2;
  if ((d1 <= 0.0f) & (d2 <= 0.0f)) d = ap2;

  if (kTail) {
    // degenerate faces (inv_n2 zeroed by the relative area cut) are their
    // edge segments: take the best clamped segment projection
    const float t_ab = clamp01(d1 * inv_ab2);
    const float e_ab = ap2 - t_ab * (d1 + d1 - t_ab * ab2);
    const float t_ca = clamp01(d2 * inv_ac2);
    const float e_ca = ap2 - t_ca * (d2 + d2 - t_ca * ac2);
    const float bc2 = ab2 + ac2 - (abac + abac);
    const float t_bc = clamp01(d_bc * inv_bc2);
    const float e_bc = bp2 - t_bc * (d_bc + d_bc - t_bc * bc2);
    if (!(inv_n2 > 0.0f)) d = fminf(e_ab, fminf(e_ca, e_bc));
  }
  // the edge forms subtract two nearly-equal squares; clamp the rounding
  return clamp_cost<kKeepNan>(d);
}

// _ericson_tail: the squared distance from the four query-dependent scalars
// d1 = ab.ap, d2 = ac.ap, ap2 = |ap|^2 and n_ap = n.ap, deriving the b/c-corner
// terms from the corner-a ones and the hoisted per-face constants.  The fast
// tile and the MXU tile (mxu_cost.cuh) differ only in how they form the four.
template <bool kTail, bool kKeepNan = false>
__device__ __forceinline__ float ericson_tail(
    float d1, float d2, float ap2, float n_ap, float ab2, float ac2,
    float abac, float inv_ab2, float inv_ac2, float inv_bc2, float inv_n2) {
  const float d3 = d1 - ab2;
  const float d4 = d2 - abac;
  const float d5 = d1 - abac;
  const float d6 = d2 - ac2;
  const float bp2 = ap2 - (d1 + d1) + ab2;
  const float cp2 = ap2 - (d2 + d2) + ac2;
  return region_select<kTail, kKeepNan>(d1, d2, d3, d4, d5, d6, ap2, bp2,
                                        cp2, n_ap, ab2, ac2, abac, inv_ab2,
                                        inv_ac2, inv_bc2, inv_n2);
}

// The fast tile's squared distance from the 19 plane values of one face, in
// fast_tile_rows order: corner a, edges ab and ac, the unnormalized normal,
// ab2 ac2 abac and the reciprocals inv_ab2 inv_ac2 inv_bc2 inv_n2.
template <bool kTail, bool kKeepNan = false>
__device__ __forceinline__ float fast_pair(
    float px, float py, float pz, float ax, float ay, float az, float abx,
    float aby, float abz, float acx, float acy, float acz, float nx, float ny,
    float nz, float ab2, float ac2, float abac, float inv_ab2, float inv_ac2,
    float inv_bc2, float inv_n2) {
  const float apx = px - ax, apy = py - ay, apz = pz - az;
  const float d1 = abx * apx + aby * apy + abz * apz;
  const float d2 = acx * apx + acy * apy + acz * apz;
  const float ap2 = apx * apx + apy * apy + apz * apz;
  const float n_ap = nx * apx + ny * apy + nz * apz;
  return ericson_tail<kTail, kKeepNan>(d1, d2, ap2, n_ap, ab2, ac2, abac,
                                       inv_ab2, inv_ac2, inv_bc2, inv_n2);
}

// Fast tile: planes a(3) ab(3) ac(3) n(3) ab2 ac2 abac inv_ab2 inv_ac2
// inv_bc2 inv_n2, staged as 5 float4 (one pad).
template <bool kTail, bool kKeepNan = false>
struct FastCost {
  static constexpr int kRows = 19;
  static constexpr int kVec = 5;

  __device__ static void stage(const float* c, int n, int j, float* dst) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) dst[r] = c[static_cast<size_t>(r) * n + j];
    dst[19] = 0.0f;
  }

  __device__ static float cost(float px, float py, float pz,
                               const float4* t) {
    const float4 r0 = t[0], r1 = t[1], r2 = t[2], r3 = t[3], r4 = t[4];
    return fast_pair<kTail, kKeepNan>(px, py, pz, r0.x, r0.y, r0.z, r0.w,
                                      r1.x, r1.y, r1.z, r1.w, r2.x, r2.y,
                                      r2.z, r2.w, r3.x, r3.y, r3.z, r3.w,
                                      r4.x, r4.y, r4.z);
  }
};

__device__ __forceinline__ float seg_sqdist(float t, float ox, float oy,
                                            float oz, float ex, float ey,
                                            float ez) {
  const float rx = ox - t * ex;
  const float ry = oy - t * ey;
  const float rz = oz - t * ez;
  return rx * rx + ry * ry + rz * rz;
}

// Sliver-safe tile: device planes a(3) b(3) c(3) n(3) ab2 ac2 abac inv_ab2
// inv_ac2 inv_bc2 inv_n2; staged as a b c n, the edges ab ac bc (derived
// here once per face, the same float32 subtractions the plain version
// makes) and the four reciprocals: 25 floats in 7 float4.
template <bool kTail, bool kKeepNan = false>
struct SafeCost {
  static constexpr int kRows = 19;
  static constexpr int kVec = 7;

  __device__ static void stage(const float* c, int n, int j, float* dst) {
    float r[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) r[k] = c[static_cast<size_t>(k) * n + j];
#pragma unroll
    for (int k = 0; k < 12; ++k) dst[k] = r[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dst[12 + k] = r[3 + k] - r[k];      // ab = b - a
      dst[15 + k] = r[6 + k] - r[k];      // ac = c - a
      dst[18 + k] = r[6 + k] - r[3 + k];  // bc = c - b
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[21 + k] = c[static_cast<size_t>(15 + k) * n + j];
    dst[25] = dst[26] = dst[27] = 0.0f;
  }

  __device__ static float cost(float px, float py, float pz,
                               const float4* t) {
    const float4 r0 = t[0], r1 = t[1], r2 = t[2], r3 = t[3], r4 = t[4],
                 r5 = t[5], r6 = t[6];
    const float ax = r0.x, ay = r0.y, az = r0.z, bx = r0.w;
    const float by = r1.x, bz = r1.y, cx = r1.z, cy = r1.w;
    const float cz = r2.x, nx = r2.y, ny = r2.z, nz = r2.w;
    const float abx = r3.x, aby = r3.y, abz = r3.z, acx = r3.w;
    const float acy = r4.x, acz = r4.y, bcx = r4.z, bcy = r4.w;
    const float bcz = r5.x, inv_ab2 = r5.y, inv_ac2 = r5.z, inv_bc2 = r5.w;
    const float inv_n2 = r6.x;

    const float apx = px - ax, apy = py - ay, apz = pz - az;
    const float bpx = px - bx, bpy = py - by, bpz = pz - bz;
    const float cpx = px - cx, cpy = py - cy, cpz = pz - cz;
    const float d1 = abx * apx + aby * apy + abz * apz;
    const float d2 = acx * apx + acy * apy + acz * apz;
    const float d3 = abx * bpx + aby * bpy + abz * bpz;
    const float d4 = acx * bpx + acy * bpy + acz * bpz;
    const float d5 = abx * cpx + aby * cpy + abz * cpz;
    const float d6 = acx * cpx + acy * cpy + acz * cpz;
    const float ap2 = apx * apx + apy * apy + apz * apz;
    const float bp2 = bpx * bpx + bpy * bpy + bpz * bpz;
    const float cp2 = cpx * cpx + cpy * cpy + cpz * cpz;
    const float n_ap = nx * apx + ny * apy + nz * apz;

    // clamped-foot residual-vector edge distances: the edge regions' value
    // and the degenerate tail's
    const float e_ab = seg_sqdist(clamp01(d1 * inv_ab2), apx, apy, apz,
                                  abx, aby, abz);
    const float e_ca = seg_sqdist(clamp01(d2 * inv_ac2), apx, apy, apz,
                                  acx, acy, acz);
    const float d_bc = d4 - d3;
    const float e_bc = seg_sqdist(clamp01(d_bc * inv_bc2), bpx, bpy, bpz,
                                  bcx, bcy, bcz);

    const float va = d3 * d6 - d5 * d4;
    const float vb = d5 * d2 - d1 * d6;
    const float vc = d1 * d4 - d3 * d2;
    float d = n_ap * n_ap * inv_n2;
    if ((va <= 0.0f) & (d_bc >= 0.0f) & (d5 - d6 >= 0.0f)) d = e_bc;
    if ((vb <= 0.0f) & (d2 >= 0.0f) & (d6 <= 0.0f)) d = e_ca;
    if ((vc <= 0.0f) & (d1 >= 0.0f) & (d3 <= 0.0f)) d = e_ab;
    if ((d6 >= 0.0f) & (d5 <= d6)) d = cp2;
    if ((d3 >= 0.0f) & (d4 <= d3)) d = bp2;
    if ((d1 <= 0.0f) & (d2 <= 0.0f)) d = ap2;
    if (kTail && !(inv_n2 > 0.0f)) d = fminf(e_ab, fminf(e_ca, e_bc));
    return clamp_cost<kKeepNan>(d);
  }
};

// How a chunk of a cost functor's plane-major planes lands in shared
// memory: kCopy planes, plane `row(i)` of the chunk's faces copied to word
// `slot(i)` of each face's record of 4 * Cost::kVec words, then `derive` on
// each staged record.
template <class Cost>
struct Staging;

template <bool kTail, bool kKeepNan>
struct Staging<FastCost<kTail, kKeepNan>> {
  static constexpr int kCopy = 19;  // the 19 planes, in order
  __device__ static int row(int i) { return i; }
  __device__ static int slot(int i) { return i; }
  static constexpr bool kDerive = false;
  __device__ static void derive(float*) {}
};

template <bool kTail, bool kKeepNan>
struct Staging<SafeCost<kTail, kKeepNan>> {
  // corners a b c and n (planes 0-11) to words 0-11, the reciprocals
  // (planes 15-18) to words 21-24; ab2 ac2 abac are not read
  static constexpr int kCopy = 16;
  __device__ static int row(int i) { return i < 12 ? i : i + 3; }
  __device__ static int slot(int i) { return i < 12 ? i : i + 9; }
  static constexpr bool kDerive = true;
  // the edges ab, ac, bc, as SafeCost::stage derives them
  __device__ static void derive(float* f) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      f[12 + k] = f[3 + k] - f[k];
      f[15 + k] = f[6 + k] - f[k];
      f[18 + k] = f[6 + k] - f[3 + k];
    }
  }
};

}  // namespace mt
