// The operands of tri_tri_any_hit.cu's cull on Hopper (sm_90a): per face,
// its record, and per chunk of 32 consecutive faces, which of them can meet
// a query triangle at all and the box around those (query/tri_tri_kernel.py
// tri_records_plain is the plain version and says what each field means).
//
// Replaces: mesh_tpu/query/pallas_ray.py tri_tri_any_hit_pallas, the
// prologue of its redesign for the H100 (the reference tests every pair
// and needs no records).
//
// Bound on the H100: bytes.  It reads the 13 rows of every face once
// (0.72 MB at contact's 13,776 faces) and writes 64 bytes a face and 32 a
// chunk; its ~80 operations a face are far below the card's float32 rate.
//
// Design: one warp per chunk, one lane per face (the last face repeated
// past the end), so a warp reads each row's 32 faces as one coalesced
// 128-byte row.  A lane tests its face's plane against the box of every
// query corner (qlo, qhi from torch.amin / amax, which keep NaN; P, their
// largest magnitude, computed here) with plane_needs_box, the face side of
// the cull (tri_tri_any_hit.cu's note, item (i)); the warp's ballot is the
// chunk's candidate mask, and its minima and maxima over the candidates'
// corners, by shuffles that keep NaN, the chunk's box.  Lane 0 writes the
// chunk record.  The operations are the plain version's, so both give the
// same bits (a zero's sign aside, which no reader sees).

#include "tri_tri_cost.cuh"

namespace {

constexpr int kWarps = 4;  // chunks per block

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = mt::nan_min(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = mt::nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// the largest magnitude of a box [lo, hi], as torch.maximum(lo.abs(),
// hi.abs()).amax() (NaN kept)
__device__ __forceinline__ float box_magnitude(const float* lo,
                                               const float* hi) {
  float p = mt::nan_max(fabsf(lo[0]), fabsf(hi[0]));
  p = mt::nan_max(p, mt::nan_max(fabsf(lo[1]), fabsf(hi[1])));
  return mt::nan_max(p, mt::nan_max(fabsf(lo[2]), fabsf(hi[2])));
}

__global__ void __launch_bounds__(32 * kWarps)
tri_records_kernel(const float* __restrict__ qlo,
                   const float* __restrict__ qhi,
                   const float* __restrict__ fplanes,
                   float4* __restrict__ faces, float4* __restrict__ chunks,
                   int n_f, int n_c) {
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= n_c) return;  // a whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int at = k * 32 + lane;
  const int j = min(at, n_f - 1);
  float r[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) r[i] = fplanes[static_cast<size_t>(i) * n_f + j];
  float4* rec = faces + static_cast<size_t>(at) * 4;
  rec[0] = make_float4(r[0], r[1], r[2], r[3]);
  rec[1] = make_float4(r[4], r[5], r[6], r[7]);
  rec[2] = make_float4(r[8], r[9], r[10], r[11]);
  rec[3] = make_float4(r[12], 0.0f, 0.0f, 0.0f);

  // the face side: this face's plane against the query corners' box
  const float ql[3] = {qlo[0], qlo[1], qlo[2]};
  const float qh[3] = {qhi[0], qhi[1], qhi[2]};
  const float qp = box_magnitude(ql, qh);
  const bool cand =
      at < n_f && mt::plane_needs_box(
                      r[9], r[10], r[11], r[12],
                      make_float4(ql[0], ql[1], ql[2], qh[0]),
                      make_float4(qh[1], qh[2], qp, 0.0f));
  const unsigned mask = __ballot_sync(0xffffffffu, cand);

  // the box of the candidates' corners, one axis at a time
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float l = mt::nan_min(mt::nan_min(r[a], r[3 + a]), r[6 + a]);
    const float h = mt::nan_max(mt::nan_max(r[a], r[3 + a]), r[6 + a]);
    lo[a] = warp_min(cand ? l : CUDART_INF_F);
    hi[a] = warp_max(cand ? h : -CUDART_INF_F);
  }
  if (lane != 0) return;
  chunks[2 * k] = make_float4(lo[0], lo[1], lo[2], hi[0]);
  chunks[2 * k + 1] =
      make_float4(hi[1], hi[2], box_magnitude(lo, hi), __uint_as_float(mask));
}

}  // namespace

// qlo, qhi [3] float32 (the least and the largest coordinate of every query
// corner, per axis), fplanes [13, F] float32 (the Moller face operand) ->
// faces [32 C, 16] and chunks [C, 8] float32, C = ceil(F / 32) = n_c.
// Returns the launch's CUDA error code.
extern "C" int mt_tri_records(const float* qlo, const float* qhi,
                              const float* fplanes, float* faces,
                              float* chunks, int n_f, int n_c,
                              cudaStream_t stream) {
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (n_f <= 0) return 0;
  if (n_c != (n_f + 31) / 32) return static_cast<int>(cudaErrorInvalidValue);
  tri_records_kernel<<<(n_c + kWarps - 1) / kWarps, 32 * kWarps, 0,
                       stream>>>(qlo, qhi, fplanes,
                                 reinterpret_cast<float4*>(faces),
                                 reinterpret_cast<float4*>(chunks), n_f, n_c);
  return static_cast<int>(cudaGetLastError());
}
