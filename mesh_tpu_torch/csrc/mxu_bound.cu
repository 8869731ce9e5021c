// bf16 bound pass of the MXU rung on Hopper (sm_90a).
//
// Replaces: mesh_tpu/query/pallas_closest.py _mxu_bound_kernel (over
// _mxu_ap2_env; pallas_call in _mxu_repair_staged).
//
// For each query p and face f with corner a and reach r (record columns
// 9-11, 15, 23; mxu_cost.cuh): p and a rounded to bf16 to nearest even
// (__float2bfloat16_rn, as torch.bfloat16 rounds), pa the sum in float32 of
// the exact bf16 products (a product of two bf16 fits a float32),
//   ap2~ = max(p2 - 2 pa + a2, 0),   E = 2^-6 (p2 + a2)
// with p2 and a2 unrounded float32.  Outputs:
//   ub[q]      = min over all faces of ap2~ + E, an upper bound on the
//                closest squared distance;
//   cert[q, t] = min over the faces of tile t (tile_f faces) of
//                sqrt(max(ap2~ - E, 0)) - r, a lower bound on their
//                distance to p.
// The minima propagate NaN, as torch.amin and jnp.min do.
//
// The reference carries ub across its sequential face-tile grid axis.  On
// the card blocks run in no order, so neither a second pass nor an
// atomicMin is used: each thread owns one query and walks every face in
// order, carrying ub and the current tile's cert in registers; the loop
// takes the place of the sequential grid axis and the result does not
// depend on the block shape.
//
// Bound on the H100: float32 issue.  A pair costs 26 operations counted as
// in mxu_faces.cu (the bf16 dot product 5, ap2~ 5, E 2, ub's add and NaN
// min 5, the certificate's subtract, clamp, sqrt, subtract and NaN min 9,
// sqrt counted as one): 2.13e9 pairs at 65,536 queries x 32,512 faces,
// 5.5e10 operations, against 3 MB of records read once.
//
// What the design does: a block of 128 queries stages 128 faces at a time
// in shared memory as (bf16(a) as float32, a2) and r, rounding a once per
// face and block; the inner loop is register arithmetic on broadcast
// loads.

#include "mxu_cost.cuh"

namespace mt {

constexpr int kBoundThreads = 128;

__global__ void __launch_bounds__(kBoundThreads)
mxu_bound_kernel(const float* __restrict__ pts, const float* __restrict__ rec,
                 float* __restrict__ ub, float* __restrict__ cert, int n_q,
                 int n_faces, int tile_f, int n_tiles) {
  __shared__ float4 corner[kMxuChunk];  // bf16(a) as float32, a2
  __shared__ float reach[kMxuChunk];
  const int q = blockIdx.x * kBoundThreads + threadIdx.x;
  const bool live = q < n_q;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (live) {
    px = pts[3 * static_cast<size_t>(q)];
    py = pts[3 * static_cast<size_t>(q) + 1];
    pz = pts[3 * static_cast<size_t>(q) + 2];
  }
  const float p2 = px * px + py * py + pz * pz;
  const float bx = bf16_round(px), by = bf16_round(py), bz = bf16_round(pz);

  float ub_q = CUDART_INF_F;
  for (int t = 0; t < n_tiles; ++t) {
    float m_t = CUDART_INF_F;
    const int f1 = min(n_faces, (t + 1) * tile_f);
    for (int c0 = t * tile_f; c0 < f1; c0 += kMxuChunk) {
      const int nc = min(kMxuChunk, f1 - c0);
      __syncthreads();  // every thread is done with the previous chunk
      for (int k = threadIdx.x; k < nc; k += kBoundThreads) {
        const float* r = rec + static_cast<size_t>(c0 + k) * kMxuRecord;
        corner[k] = make_float4(bf16_round(r[9]), bf16_round(r[10]),
                                bf16_round(r[11]), r[15]);
        reach[k] = r[23];
      }
      __syncthreads();
      for (int k = 0; k < nc; ++k) {
        const float4 a = corner[k];
        const float pa = bx * a.x + by * a.y + bz * a.z;
        const float ap2t = max0(p2 - (pa + pa) + a.w);
        const float env = kMxuBf16Eps * (p2 + a.w);
        ub_q = min_nan(ap2t + env, ub_q);
        m_t = min_nan(sqrtf(max0(ap2t - env)) - reach[k], m_t);
      }
    }
    if (live) cert[static_cast<size_t>(q) * n_tiles + t] = m_t;
  }
  if (live) ub[q] = ub_q;
}

}  // namespace mt

// pts [n_q, 3], rec [n_faces, 24] float32; ub [n_q] and cert [n_q,
// ceil(n_faces / tile_f)] float32.  Returns the launch's CUDA error code.
extern "C" int mt_mxu_bound(const float* pts, const float* rec, float* ub,
                            float* cert, int n_q, int n_faces, int tile_f,
                            cudaStream_t stream) {
  using namespace mt;
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (tile_f <= 0 || n_faces <= 0 || n_q < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_q == 0) return 0;
  const int n_tiles = (n_faces + tile_f - 1) / tile_f;
  const int grid = (n_q + kBoundThreads - 1) / kBoundThreads;
  mxu_bound_kernel<<<grid, kBoundThreads, 0, stream>>>(pts, rec, ub, cert,
                                                       n_q, n_faces, tile_f,
                                                       n_tiles);
  return static_cast<int>(cudaGetLastError());
}
