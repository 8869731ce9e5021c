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
// Why no pair that could hit is skipped: the note of csrc/ray_cull.cuh,
// whose chunk_needed this kernel runs.

#include "ray_cull.cuh"

namespace mt {

constexpr int kThreads = 128;   // rays per block
// blocks an SM keeps resident: 8 caps the kernel at 64 registers (80
// bytes spill), 7-10% faster than uncapped (72-80 registers) on the
// visibility drive's rays (H100 80GB HBM3)
constexpr int kBlocksPerSM = 8;

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
