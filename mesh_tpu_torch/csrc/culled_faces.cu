// Sphere-culled closest face per query on Hopper (sm_90a).
//
// Replaces: mesh_tpu/query/pallas_culled.py closest_point_pallas_culled
// (kernel _make_culled_kernel over _sqdist_tile_fast / _sqdist_tile_safe).
//
// Operands (built by mesh_tpu_torch/query/culled_kernel.py, per mesh of a
// batch): queries Morton-sorted and edge-padded to a multiple of tile_q,
// faces Morton-sorted and edge-padded to a multiple of tile_f, a bounding
// sphere per query tile and per face tile, and a per-query seed, an upper
// bound on its closest squared distance.  Output: per query, the position
// of its closest face in the sorted face order, and per query tile the
// number of face tiles it tested.
//
// One block of tile_q threads owns one query tile of one mesh, one thread
// one query.  The block walks the mesh's face tiles in increasing order.
// A face tile is skipped, by the whole block, when the sphere-to-sphere
// lower bound, shrunk by the reference's margin and squared, exceeds the
// tile's worst running best (`worst`, the block's max, which starts at the
// max of the seeds and is recomputed after each tested tile); the test
// reads the two spheres and `worst` only, so it is block-uniform.  A
// tested tile is staged through shared memory in chunks of kChunk faces by
// the argmin functors (csrc/face_cost.cuh) and folded into each thread's
// (best_d, best_i) with a strict < in increasing face order, starting from
// the seed: the reference's tile min / first argmin / strict-< merge,
// which keeps the lowest sorted position on exact ties.
//
// Bound on the H100: float32 issue on the pairs the cull lets through
// (88 to 151 operations a pair, csrc/closest_faces.cu), against the face
// planes read once per tested (query tile, face tile).  The design keeps
// the per-pair loop of closest_faces.cu and spends one sqrt and one block
// reduction per face tile on the cull.

#include "face_cost.cuh"

namespace mt {

constexpr int kChunk = 128;  // faces staged per shared-memory chunk

// (1 - _MARGIN) in float32, the reference's lower-bound shrink
constexpr float kShrink = static_cast<float>(1.0 - 1e-3);

template <class Cost>
__global__ void culled_kernel(const float* __restrict__ pts,
                              const float* __restrict__ seed,
                              const float* __restrict__ qsph,
                              const float* __restrict__ fsph,
                              const float* __restrict__ planes,
                              int* __restrict__ out, int* __restrict__ visits,
                              int q_pad, int f_pad, int tile_f) {
  __shared__ float4 tile[kChunk * Cost::kVec];
  __shared__ float scratch[32];
  const int b = blockIdx.y;
  const int qt = blockIdx.x;
  const int n_qt = gridDim.x;
  const int n_ft = f_pad / tile_f;
  const size_t row = static_cast<size_t>(b) * q_pad + qt * blockDim.x +
                     threadIdx.x;  // q_pad is a multiple of tile_q
  const float px = pts[row * 3], py = pts[row * 3 + 1], pz = pts[row * 3 + 2];
  const float* c = planes + static_cast<size_t>(b) * Cost::kRows * f_pad;
  const float* qs = qsph + (static_cast<size_t>(b) * n_qt + qt) * 4;
  const float qx = qs[0], qy = qs[1], qz = qs[2], qr = qs[3];

  float best_d = seed[row];
  int best_i = 0;
  float worst = block_reduce<MaxOp>(best_d, scratch);
  int n_visit = 0;
  for (int j = 0; j < n_ft; ++j) {
    const float* fs = fsph + (static_cast<size_t>(b) * n_ft + j) * 4;
    const float dx = qx - fs[0], dy = qy - fs[1], dz = qz - fs[2];
    const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
    const float lb = fmaxf(dist - qr - fs[3], 0.0f) * kShrink;
    if (!(lb * lb <= worst)) continue;
    ++n_visit;
    for (int c0 = j * tile_f; c0 < (j + 1) * tile_f; c0 += kChunk) {
      const int nc = min(kChunk, (j + 1) * tile_f - c0);
      __syncthreads();  // every thread is done with the previous chunk
      for (int k = threadIdx.x; k < nc; k += blockDim.x) {
        Cost::stage(c, f_pad, c0 + k,
                    reinterpret_cast<float*>(tile + k * Cost::kVec));
      }
      __syncthreads();
      for (int k = 0; k < nc; ++k) {
        const float d = Cost::cost(px, py, pz, tile + k * Cost::kVec);
        if (d < best_d) {
          best_d = d;
          best_i = c0 + k;
        }
      }
    }
    worst = block_reduce<MaxOp>(best_d, scratch);
  }
  out[row] = best_i;
  if (threadIdx.x == 0) visits[static_cast<size_t>(b) * n_qt + qt] = n_visit;
}

template <class Cost>
int launch_culled(const float* pts, const float* seed, const float* qsph,
                  const float* fsph, const float* planes, int* out,
                  int* visits, int n_b, int q_pad, int f_pad, int tile_q,
                  int tile_f, cudaStream_t stream) {
  const dim3 grid(q_pad / tile_q, n_b);
  culled_kernel<Cost><<<grid, tile_q, 0, stream>>>(
      pts, seed, qsph, fsph, planes, out, visits, q_pad, f_pad, tile_f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mt

// variant: 0 fast tile, 1 sliver-safe tile; tail: 1 with the degenerate-face
// tail.  tile_q must be a multiple of 32 up to 1024 dividing q_pad, and
// tile_f must divide f_pad.  Returns the launch's CUDA error code.
extern "C" int mt_culled_faces(const float* pts, const float* seed,
                               const float* qsph, const float* fsph,
                               const float* planes, int* out, int* visits,
                               int n_b, int q_pad, int f_pad, int tile_q,
                               int tile_f, int variant, int tail,
                               cudaStream_t stream) {
  using namespace mt;
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (n_b <= 0 || q_pad <= 0) return 0;
  if (tile_q <= 0 || tile_q > 1024 || tile_q % 32 || q_pad % tile_q ||
      tile_f <= 0 || f_pad % tile_f || n_b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant == 0) {
    return tail ? launch_culled<FastCost<true>>(pts, seed, qsph, fsph, planes,
                                                out, visits, n_b, q_pad,
                                                f_pad, tile_q, tile_f, stream)
                : launch_culled<FastCost<false>>(pts, seed, qsph, fsph,
                                                 planes, out, visits, n_b,
                                                 q_pad, f_pad, tile_q, tile_f,
                                                 stream);
  }
  if (variant == 1) {
    return tail ? launch_culled<SafeCost<true>>(pts, seed, qsph, fsph, planes,
                                                out, visits, n_b, q_pad,
                                                f_pad, tile_q, tile_f, stream)
                : launch_culled<SafeCost<false>>(pts, seed, qsph, fsph,
                                                 planes, out, visits, n_b,
                                                 q_pad, f_pad, tile_q, tile_f,
                                                 stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
