// The chunk records of closest_faces' cull on Hopper (sm_90a): per chunk
// of 32 consecutive faces, the box around its corners, the rounding terms
// e1 and e2 of its costs and its representative (csrc/closest_cull.cuh
// reads them; mesh_tpu_torch/query/closest_kernel.py cull_records_plain
// is the plain version and says what each field means).
//
// Replaces: mesh_tpu/query/pallas_closest.py closest_point_pallas, the
// prologue of its redesign for the H100 (the reference folds every face
// and needs no records).
//
// Bound on the H100: bytes.  It reads the 19 planes of every face once
// (0.27 GB on the main path) and writes 48 bytes a chunk; its ~120
// operations a face are two orders of magnitude below the card's float32
// rate.  The plain version takes about 275 small kernels (2.3 ms on the
// main path's shapes, each a pass over device memory).
//
// Design: one warp per chunk, one lane per face (the last face repeated
// past the end, as the plain version pads), so a warp reads each plane's
// 32 faces as one coalesced 128-byte row; min, max and any over the chunk
// by shuffles; lane 0 writes the record.  The operations are the plain
// version's in its order, and the minima and maxima keep NaN as
// torch.minimum, torch.maximum, amin and amax do, so both give the same
// bits (a zero's sign aside, which no reader sees).

#include "common.cuh"

namespace {

constexpr float kU = 5.9604644775390625e-08f;  // 2^-24
constexpr float kMaxCond = 1e4f;                // CULL_MAX_COND
constexpr int kWarps = 4;                       // chunks per block

// min and max that keep NaN, as torch.minimum and torch.maximum do
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

template <bool kFast, bool kTail>
__global__ void __launch_bounds__(32 * kWarps)
cull_records_kernel(const float* __restrict__ planes,
                    float* __restrict__ recs, int n_f, int n_rows, int n_c) {
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= n_c) return;  // a whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int j = min(k * 32 + lane, n_f - 1);
  const float* c = planes + static_cast<size_t>(b) * n_rows * n_f + j;
  float r[19];
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 19; ++i) {
    r[i] = c[static_cast<size_t>(i) * n_f];
    finite &= isfinite(r[i]);
  }
  const float ax = r[0], ay = r[1], az = r[2];
  float bx, by, bz, cx, cy, cz, abx, aby, abz, acx, acy, acz;
  if (kFast) {
    abx = r[3], aby = r[4], abz = r[5], acx = r[6], acy = r[7], acz = r[8];
    bx = ax + abx, by = ay + aby, bz = az + abz;
    cx = ax + acx, cy = ay + acy, cz = az + acz;
  } else {
    bx = r[3], by = r[4], bz = r[5], cx = r[6], cy = r[7], cz = r[8];
    abx = bx - ax, aby = by - ay, abz = bz - az;
    acx = cx - ax, acy = cy - ay, acz = cz - az;
  }
  // the box, one axis at a time
  const float pa[3] = {ax, ay, az}, pb[3] = {bx, by, bz},
              pc[3] = {cx, cy, cz};
  float cen[3], half[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float lo = warp_min(nan_min(nan_min(pa[d], pb[d]), pc[d]));
    const float hi = warp_max(nan_max(nan_max(pa[d], pb[d]), pc[d]));
    cen[d] = (lo + hi) * 0.5f;
    half[d] = nan_max(hi - cen[d], cen[d] - lo) * (1.0f + 8 * kU) +
              nan_max(fabsf(lo), fabsf(hi)) * (4 * kU);
  }
  const float diag =
      sqrtf(half[0] * half[0] + half[1] * half[1] + half[2] * half[2]) *
      (1.0f + 8 * kU);

  // the face's conditioning numbers
  const float ab2 = abx * abx + aby * aby + abz * abz;
  const float ac2 = acx * acx + acy * acy + acz * acz;
  const float bcx = acx - abx, bcy = acy - aby, bcz = acz - abz;
  const float bc2 = bcx * bcx + bcy * bcy + bcz * bcz;
  const float long2 = nan_max(nan_max(ab2, ac2), bc2);
  const float shortest = sqrtf(nan_min(nan_min(ab2, ac2), bc2));
  const float span = sqrtf(ab2 * ac2);
  const float n_low =
      sqrtf(r[9] * r[9] + r[10] * r[10] + r[11] * r[11]) - span * (16 * kU);
  const bool pos = n_low > 0.0f;
  float cond_s = pos ? span / n_low : CUDART_INF_F;
  float cond_l = (pos & (shortest > 0.0f)) ? long2 / (n_low * shortest)
                                            : CUDART_INF_F;
  float cond_g = kFast ? sqrtf(long2 * r[17]) : 0.0f;
  const bool chain = r[18] > 0.0f;
  bool always = !finite;
  if (kTail) {
    cond_s = chain ? cond_s : 0.0f;
    cond_l = chain ? cond_l : 0.0f;
    cond_g = chain ? cond_g : 0.0f;
  } else {
    always |= !chain;
  }
  always |= !(cond_s <= kMaxCond) | !(cond_g <= kMaxCond);
  const bool any_always = __any_sync(0xffffffffu, always);
  const float s_max = warp_max(cond_s);
  const float g_max = warp_max(cond_g);
  const float l_max = warp_max(cond_l);
  if (lane != 0) return;
  const float e1 = any_always ? CUDART_INF_F
                              : (s_max * 40.0f + 64.0f + g_max * 96.0f) * kU;
  const float e2 = l_max * (128 * kU);
  float4* out = reinterpret_cast<float4*>(recs) +
                (static_cast<size_t>(b) * n_c + k) * 3;
  out[0] = make_float4(cen[0], cen[1], cen[2], diag);
  out[1] = make_float4(half[0], half[1], half[2], e1);
  out[2] = make_float4(ax, ay, az, e2);
}

template <bool kFast, bool kTail>
int launch_records(const float* planes, float* recs, int n_b, int n_f,
                   int n_rows, int n_c, cudaStream_t stream) {
  const dim3 grid((n_c + kWarps - 1) / kWarps, n_b);
  cull_records_kernel<kFast, kTail><<<grid, 32 * kWarps, 0, stream>>>(
      planes, recs, n_f, n_rows, n_c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// planes [B, R, F] float32 (R >= 19: the 19 tile planes first, as the
// normal-weighted kernel's 22 rows have them; the rest are not read) ->
// recs [B, ceil(F / 32), 12] float32.  variant: 0 fast tile, 1
// sliver-safe tile; tail: 1 with the degenerate-face tail.  Returns the
// launch's CUDA error code.
extern "C" int mt_cull_records(const float* planes, float* recs, int n_b,
                               int n_f, int n_rows, int variant, int tail,
                               cudaStream_t stream) {
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (n_b <= 0) return 0;
  if (n_b > 65535 || n_f <= 0 || n_rows < 19 ||
      (variant != 0 && variant != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_c = (n_f + 31) / 32;
  const auto launch =
      variant == 0
          ? (tail ? launch_records<true, true> : launch_records<true, false>)
          : (tail ? launch_records<false, true>
                  : launch_records<false, false>);
  return launch(planes, recs, n_b, n_f, n_rows, n_c, stream);
}
