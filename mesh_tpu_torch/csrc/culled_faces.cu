// Sphere-culled closest face per query on Hopper (sm_90a).
//
// Replaces: mesh_tpu/query/pallas_culled.py closest_point_pallas_culled
// (kernel _make_culled_kernel over _sqdist_tile_fast / _sqdist_tile_safe).
//
// Operands (built by mesh_tpu_torch/query/culled_kernel.py, per mesh of a
// batch): queries Morton-sorted and edge-padded to a multiple of tile_q,
// faces Morton-sorted and edge-padded to a multiple of tile_f, a bounding
// sphere per query tile, per face tile and per chunk of `chunk` faces (128,
// or tile_f when tile_f is not a multiple of 128), and a per-query seed, an
// upper bound on its closest squared distance.  Output: per query, the
// position of its closest face in the sorted face order; per query tile
// the number of face tiles it tested; on request, per warp of a query tile
// the number of chunks it tested, and per query the real (unpadded) faces
// its own lane folded in.
//
// Bound on the H100: float32 issue on the pairs the cull lets through (88
// to 151 operations a pair, csrc/closest_faces.cu), against the face
// planes read once per staged chunk; counted per query lane (chip_smoke.py
// compare_culled), the real faces each query folds in and its chunk
// bounds, whatever else its warp runs.  The TPU kernel culls at one
// granularity, a tile of queries against a tile of faces, by a sphere
// bound against the tile's worst running best: with surface-proximal
// queries most face tiles pass (one loose query keeps the whole tile's
// worst high), and every pair of a passing tile is tested.
//
// Design.  One block of tile_q threads owns one query tile of one mesh, one
// thread one query.  The block walks the mesh's face tiles in increasing
// order and keeps the reference's block test: a face tile is skipped, by
// the whole block, when the sphere-to-sphere lower bound, shrunk by the
// reference's margin and squared, exceeds the tile's worst running best
// (`worst`, the block's max, which starts at the max of the seeds and is
// recomputed after each tested tile); this feeds `visits`.  Inside a tested
// tile each lane culls per chunk against its own running best: its lower
// bound to the chunk's sphere, the reference's bound with a query radius
// of 0, lb = max(|p - c| - r, 0) * (1 - 1e-3), and it needs the chunk when
// lb^2 <= best_d.  A warp tests a chunk when one of its lanes needs it
// (__any_sync), only those lanes fold it in, and the block stages a chunk
// when a thread votes for it (__syncthreads_or).  Staging is a cp.async
// double buffer: while chunk c is tested, the next chunk of the tile that
// some lane needs against its best so far is already loading (a vote made
// before c is folded in can only keep more chunks than the one made after:
// the best only falls).  The face planes are plane-major in global memory
// and face-major in shared memory, as the cost functors of
// csrc/face_cost.cuh read them; each thread copies 4-byte words, a warp 8
// faces x 4 planes at a time (coalesced 32-byte rows, distinct banks), and
// the sliver-safe tile derives its edges in shared memory after the copy,
// with the same subtractions SafeCost::stage makes.  Each lane folds its
// chunk's faces into (best_d, best_i) with a strict < in increasing face
// order, starting from the seed: the reference's tile min / first argmin /
// strict-< merge, which keeps the lowest sorted position on exact ties.
//
// Why the chunk cull keeps every answer.  The bound is the one the block
// test already trusts, per query instead of per tile: every face of the
// chunk lies in its sphere, so no face of it is closer to p than |p - c| -
// r, and the 1e-3 shrink covers the float32 rounding of the bound and of
// the cost (the reference's margin argument).  A skipped chunk's faces
// therefore cost more than lb^2 > best_d: none could beat the lane's best
// nor, the merge being strict, tie it at a lower sorted position (chunks
// come in increasing order, so each of its faces follows the best's).  The
// lane's best, and hence each tile's `worst` and `visits`, are the every-
// face kernel's.  The plain version (culled_kernel.py argmin_culled_plain)
// makes the same decisions and counts.

#include "face_cost.cuh"

namespace mt {

constexpr int kChunk = 128;  // most faces a staged chunk holds

// (1 - _MARGIN) in float32, the reference's lower-bound shrink
constexpr float kShrink = static_cast<float>(1.0 - 1e-3);

template <class Cost>
__global__ void culled_kernel(const float* __restrict__ pts,
                              const float* __restrict__ seed,
                              const float* __restrict__ qsph,
                              const float* __restrict__ fsph,
                              const float* __restrict__ csph,
                              const float* __restrict__ planes,
                              int* __restrict__ out, int* __restrict__ visits,
                              int* __restrict__ chunks, int* __restrict__ pairs,
                              int n_f, int q_pad, int f_pad, int tile_f,
                              int chunk) {
  using S = Staging<Cost>;
  constexpr int kWords = 4 * Cost::kVec;  // one face's record
  __shared__ float4 ring[2][kChunk * Cost::kVec];
  __shared__ float scratch[32];
  const int b = blockIdx.y;
  const int qt = blockIdx.x;
  const int n_qt = gridDim.x;
  const int n_ft = f_pad / tile_f;
  const int per_tile = tile_f / chunk;
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(b) * q_pad + qt * blockDim.x +
                     threadIdx.x;  // q_pad is a multiple of tile_q
  const float px = pts[row * 3], py = pts[row * 3 + 1], pz = pts[row * 3 + 2];
  const float* c = planes + static_cast<size_t>(b) * Cost::kRows * f_pad;
  const float* qs = qsph + (static_cast<size_t>(b) * n_qt + qt) * 4;
  const float qx = qs[0], qy = qs[1], qz = qs[2], qr = qs[3];
  const float4* cs =
      reinterpret_cast<const float4*>(csph) +
      static_cast<size_t>(b) * (f_pad / chunk);

  // this lane's squared lower bound to chunk k's faces
  auto chunk_lb2 = [&](int k) {
    const float4 s = __ldg(cs + k);
    const float dx = px - s.x, dy = py - s.y, dz = pz - s.z;
    const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
    const float lb = fmaxf(dist - s.w, 0.0f) * kShrink;
    return lb * lb;
  };
  // the first chunk in [k, end) that some lane needs against its best so
  // far (end: none), by one block vote per chunk; *lb2 receives this lane's
  // bound to it
  float best_d = seed[row];
  int best_i = 0;
  auto next_chunk = [&](int k, int end, float* lb2) {
    for (; k < end; ++k) {
      *lb2 = chunk_lb2(k);
      if (__syncthreads_or(*lb2 <= best_d)) return k;
    }
    return end;
  };
  // chunk k's planes into ring[slot], as one cp.async group of this thread:
  // flat index i -> (8-face group, 4-plane group, lane), lane -> (face
  // lane & 7, plane lane >> 3)
  auto stage = [&](int k, int slot) {
    const int c0 = k * chunk;
    float* dst = reinterpret_cast<float*>(ring[slot]);
    constexpr int kGroups = (S::kCopy + 3) / 4;
    const int n = ((chunk + 7) / 8) * kGroups * 32;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int g = (i >> 5) % kGroups;
      const int f = ((i >> 5) / kGroups) * 8 + (i & 7);
      const int p = g * 4 + ((i & 31) >> 3);
      if (p < S::kCopy && f < chunk) {
        cp_async4(dst + f * kWords + S::slot(p),
                  c + static_cast<size_t>(S::row(p)) * f_pad + c0 + f);
      }
    }
    cp_async_commit();
  };

  float worst = block_reduce<MaxOp>(best_d, scratch);
  int n_visit = 0, n_chunk = 0, n_pair = 0;
  for (int j = 0; j < n_ft; ++j) {
    const float* fs = fsph + (static_cast<size_t>(b) * n_ft + j) * 4;
    const float dx = qx - fs[0], dy = qy - fs[1], dz = qz - fs[2];
    const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
    const float lb = fmaxf(dist - qr - fs[3], 0.0f) * kShrink;
    if (!(lb * lb <= worst)) continue;
    ++n_visit;
    const int end = (j + 1) * per_tile;
    float lb2 = 0.0f;
    int k = next_chunk(j * per_tile, end, &lb2);
    if (k < end) stage(k, 0);
    for (int slot = 0; k < end; slot ^= 1) {
      const bool need = lb2 <= best_d;  // against the best so far
      const int nxt = next_chunk(k + 1, end, &lb2);
      if (nxt < end) {
        stage(nxt, slot ^ 1);
        cp_async_wait<1>();  // chunk k's group has landed
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (S::kDerive) {
        float* rec = reinterpret_cast<float*>(ring[slot]);
        for (int f = threadIdx.x; f < chunk; f += blockDim.x) {
          S::derive(rec + f * kWords);
        }
        __syncthreads();
      }
      if (__any_sync(0xffffffffu, need)) {
        ++n_chunk;
        if (need) {
          const int c0 = k * chunk;
          n_pair += max(0, min(chunk, n_f - c0));
          for (int f = 0; f < chunk; ++f) {
            const float d = Cost::cost(px, py, pz,
                                       ring[slot] + f * Cost::kVec);
            if (d < best_d) {
              best_d = d;
              best_i = c0 + f;
            }
          }
        }
      }
      __syncthreads();  // every thread is done with ring[slot]
      k = nxt;
    }
    worst = block_reduce<MaxOp>(best_d, scratch);
  }
  out[row] = best_i;
  if (threadIdx.x == 0) visits[static_cast<size_t>(b) * n_qt + qt] = n_visit;
  if (chunks == nullptr) return;
  pairs[row] = n_pair;
  if (lane == 0) {
    chunks[(static_cast<size_t>(b) * n_qt + qt) * (blockDim.x >> 5) +
           (threadIdx.x >> 5)] = n_chunk;
  }
}

template <class Cost>
int launch_culled(const float* pts, const float* seed, const float* qsph,
                  const float* fsph, const float* csph, const float* planes,
                  int* out, int* visits, int* chunks, int* pairs, int n_b,
                  int n_f, int q_pad, int f_pad, int tile_q, int tile_f,
                  int chunk, cudaStream_t stream) {
  const dim3 grid(q_pad / tile_q, n_b);
  culled_kernel<Cost><<<grid, tile_q, 0, stream>>>(
      pts, seed, qsph, fsph, csph, planes, out, visits, chunks, pairs, n_f,
      q_pad, f_pad, tile_f, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mt

// variant: 0 fast tile, 1 sliver-safe tile; tail: 1 with the degenerate-face
// tail.  tile_q must be a multiple of 32 up to 1024 dividing q_pad, tile_f
// must divide f_pad, and chunk (at most 128) must divide tile_f; csph holds
// f_pad / chunk spheres per mesh; n_f of the f_pad faces are real.  chunks
// (tile_q / 32 counts per query tile) and pairs (one count per query) are
// both null, or both receive the statistics.  Returns the launch's CUDA
// error code.
extern "C" int mt_culled_faces(const float* pts, const float* seed,
                               const float* qsph, const float* fsph,
                               const float* csph, const float* planes,
                               int* out, int* visits, int* chunks, int* pairs,
                               int n_b, int n_f, int q_pad, int f_pad,
                               int tile_q, int tile_f, int chunk, int variant,
                               int tail, cudaStream_t stream) {
  using namespace mt;
  (void)cudaGetLastError();  // clear an error left by an earlier call
  if (n_b <= 0 || q_pad <= 0) return 0;
  if (tile_q <= 0 || tile_q > 1024 || tile_q % 32 || q_pad % tile_q ||
      tile_f <= 0 || f_pad % tile_f || n_b > 65535 || chunk <= 0 ||
      chunk > kChunk || tile_f % chunk || n_f <= 0 || n_f > f_pad ||
      ((chunks == nullptr) != (pairs == nullptr)) ||
      (variant != 0 && variant != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto launch = variant == 0
                          ? (tail ? launch_culled<FastCost<true>>
                                  : launch_culled<FastCost<false>>)
                          : (tail ? launch_culled<SafeCost<true>>
                                  : launch_culled<SafeCost<false>>);
  return launch(pts, seed, qsph, fsph, csph, planes, out, visits, chunks,
                pairs, n_b, n_f, q_pad, f_pad, tile_q, tile_f, chunk, stream);
}
