// Any-hit ray test on Hopper (sm_90a): per ray, whether it meets any face of
// its own mesh within [t_lo, t_hi].
//
// Replaces: mesh_tpu/query/pallas_ray.py ray_any_hit_pallas (kernel
// _any_hit_kernel over _mt_hit), the visibility hot loop.
//
// Bound on the H100: float32 issue.  A pair costs about 64 operations,
// counted from csrc/ray_cost.cuh line_hit (60: the two cross products, the
// three sign-carried dot products, sign and |det|, the four tolerance
// tests) plus the t_lo test (3) and the exit test; 36 bytes of face planes
// are read once per block of 128 rays, so memory is far from the limit.
//
// What the design does about it: one thread owns one ray, and a block walks
// its mesh's faces in tiles staged in shared memory (3 float4 per face, read
// by broadcast).  The OR over faces is order-free, so a thread stops testing
// at its ray's first hit, and the block stops staging tiles once every ray
// of the block is blocked: the decision is __syncthreads_or, the same for
// every thread.  Faces are tested in increasing order, so the pairs a ray
// tests are the index of its first hit plus one (all faces when it is
// free), whatever the block; the kernel writes that count per ray, and the
// plain version reproduces it.

#include "ray_cost.cuh"

namespace mt {

constexpr int kRayThreads = 128;  // rays per block
constexpr int kRayTile = 128;     // faces staged per shared-memory tile

__global__ void __launch_bounds__(kRayThreads)
any_hit_kernel(const float* __restrict__ orig, const float* __restrict__ dirs,
               const float* __restrict__ planes, int* __restrict__ blocked,
               int* __restrict__ tested, int n_r, int n_f, int has_lo,
               float t_lo, int has_hi, float t_hi) {
  __shared__ float4 tile[kRayTile * RayFace::kVec];
  const int b = blockIdx.y;
  const int r = blockIdx.x * kRayThreads + threadIdx.x;
  const float* c = planes + static_cast<size_t>(b) * RayFace::kRows * n_f;
  const bool live = r < n_r;
  const size_t at = static_cast<size_t>(b) * n_r + r;

  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (live) {
    ox = orig[at * 3];
    oy = orig[at * 3 + 1];
    oz = orig[at * 3 + 2];
    dx = dirs[at * 3];
    dy = dirs[at * 3 + 1];
    dz = dirs[at * 3 + 2];
  }
  // a padding thread starts blocked, so it never keeps its block staging
  bool hit = !live;
  int n_tested = 0;
  for (int f0 = 0; f0 < n_f; f0 += kRayTile) {
    // also the barrier after every thread's reads of the previous tile
    if (!__syncthreads_or(!hit)) break;
    const int nf = min(kRayTile, n_f - f0);
    for (int k = threadIdx.x; k < nf; k += kRayThreads) {
      RayFace::stage(c, n_f, f0 + k,
                     reinterpret_cast<float*>(tile + k * RayFace::kVec));
    }
    __syncthreads();
    for (int k = 0; k < nf && !hit; ++k) {
      float ad, tn;
      bool h = RayFace::hit(ox, oy, oz, dx, dy, dz, tile + k * RayFace::kVec,
                            ad, tn);
      if (has_lo) h = h & (tn >= t_lo * ad);
      if (has_hi) h = h & (tn <= t_hi * ad);
      ++n_tested;
      hit = h;
    }
  }
  if (live) {
    blocked[at] = hit ? 1 : 0;
    tested[at] = n_tested;
  }
}

}  // namespace mt

// origins, dirs [B, R, 3] and planes [B, 9, F] float32; blocked and tested
// [B, R] int32.  has_lo / has_hi: 1 when t_lo / t_hi bound t (0: unbounded).
// Returns the launch's CUDA error code.
extern "C" int mt_ray_any_hit(const float* orig, const float* dirs,
                              const float* planes, int* blocked, int* tested,
                              int n_b, int n_r, int n_f, int has_lo,
                              float t_lo, int has_hi, float t_hi,
                              cudaStream_t stream) {
  using namespace mt;
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (n_b <= 0 || n_r <= 0) return 0;
  const dim3 grid((n_r + kRayThreads - 1) / kRayThreads, n_b);
  any_hit_kernel<<<grid, kRayThreads, 0, stream>>>(
      orig, dirs, planes, blocked, tested, n_r, n_f, has_lo, t_lo, has_hi,
      t_hi);
  return static_cast<int>(cudaGetLastError());
}
