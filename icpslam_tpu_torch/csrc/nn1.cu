// K1: exact 1-nearest-neighbour search on Hopper (sm_90a).
//
// Replaces icpslam_tpu/ops/pallas/nn_kernel.py:309 nearest_neighbors_pallas3
// (kernel _nn3_kernel). For each query, the nearest live target and its
// squared distance, in the subtraction form sum_c (t_c - q_c)^2 in float32
// on coordinates centred on the query centroid, with __fsub_rn/__fmul_rn/
// __fadd_rn so that no FMA contraction happens: the d2 kept for the winner
// is bit for bit the value recomputed from it, ((e0*e0 + e1*e1) + e2*e2).
// Ties go to the lowest index; masked targets never win; no live target
// gives index 0 and d2 = +inf; valid_len is read from device memory.
//
// What bounds it on this card: the FP32 instruction rate. Each evaluated
// (query, target) pair is 3 subtractions, 3 multiplies and 2 adds that may
// not fuse, plus a compare, on operands read from shared memory; device
// memory holds only the 16 bytes of each target per tile fetch.
//
// Design (nn_tiles.cuh has the details shared with K2):
//  - the prologue stages the targets as centred float4 tiles of 256 and
//    writes each tile's AABB; the search kernel runs 8 lanes per query
//    and 4 queries per warp (2,048 warps at N = 8192, against 256 warps
//    for one thread per query), so the FP32 pipes of every SM have work;
//  - a tile is swept only where some query of the warp has an AABB
//    distance no larger than its current best (exact: '<=' and the same
//    rounding as d2), starting at the tile nearest the warp's first query;
//  - each lane keeps the tile-local best of its strided targets with a
//    strict '<' (ascending within the lane), folds it into a 64-bit key
//    (d2 bits << 32 | index), and the 8 lanes' keys are min-reduced with
//    shuffles at the end, so ties go to the lowest index in any order;
//  - kept tiles come in through cp.async into a per-warp double buffer.
// prune_beyond is not passed: the search is exact for every query.
// One call of icpslam_nn1 launches the prologue and the search kernel; the
// wrapper's launch count (nn1_cuda.launches) counts calls.

#include "nn_tiles.cuh"

namespace {

struct Nearest {
  float qx, qy, qz;
  unsigned long long best;  // (d2 bits << 32) | index

  __device__ float group_bound() const { return group_min(key_d2(best)); }

  __device__ void sweep(const float4* tile, unsigned base, int sub, float) {
    float tb = CUDART_INF_F;
    int tk = 0;
#pragma unroll
    for (int k = sub; k < kTile; k += kG) {
      const float4 v = tile[k];
      const float d = sqdist(v.x, v.y, v.z, qx, qy, qz);
      if (d < tb) {
        tb = d;
        tk = k;
      }
    }
    if (tb < CUDART_INF_F) {
      const unsigned long long key = pack(tb, base + tk);
      best = key < best ? key : best;
    }
  }
};

__global__ void __launch_bounds__(kThreads)
nn1_kernel(const float* __restrict__ q, const float4* __restrict__ staged,
           const float4* __restrict__ lo, const float4* __restrict__ hi,
           const int* __restrict__ valid_len, const float* __restrict__ center,
           int n, int m, unsigned long long* __restrict__ pairs,
           int* __restrict__ idx_out, float* __restrict__ d2_out) {
  __shared__ float4 buf[kWarps][2][kTile];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = (blockIdx.x * kWarps + warp) * kQ;
  if (q0 >= n) return;
  const int i = q0 + lane / kG;
  const bool qvalid = i < n;
  Nearest acc{0.f, 0.f, 0.f, pack(CUDART_INF_F, 0u)};
  if (qvalid) {
    acc.qx = __fsub_rn(q[3 * i + 0], center[0]);
    acc.qy = __fsub_rn(q[3 * i + 1], center[1]);
    acc.qz = __fsub_rn(q[3 * i + 2], center[2]);
  }
  search(acc, buf[warp], staged, lo, hi, live_len(valid_len, m), q0, n,
         qvalid, pairs);
  const unsigned long long best = group_min(acc.best);
  if (qvalid && lane % kG == 0) {
    idx_out[i] = static_cast<int>(best & 0xffffffffu);
    d2_out[i] = key_d2(best);
  }
}

}  // namespace

// q (n,3), t (m,3) float32; mask (m,) bool; valid_len: device int32 scalar
// or null; center (3,) float32 on the device; scratch: at least
// icpslam_nn_scratch_floats(m) floats on the device; pairs: a device
// uint64 counter or null. Outputs idx (n,) int32, d2 (n,) float32.
// Returns cudaGetLastError() after the launches.
extern "C" int icpslam_nn1(const float* q, const float* t,
                           const unsigned char* mask, const int* valid_len,
                           const float* center, int n, int m, float* scratch,
                           long long scratch_len, unsigned long long* pairs,
                           int* idx, float* d2, void* stream) {
  if (n <= 0) return 0;
  if (scratch_len < scratch_floats(m)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (m + kTile - 1) / kTile;
  float4* staged = reinterpret_cast<float4*>(scratch);
  float4* lo = staged + static_cast<long long>(tiles) * kTile;
  float4* hi = lo + tiles;
  if (tiles > 0) {
    stage_tiles<<<tiles, kTile, 0, s>>>(t, mask, valid_len, center, m, staged, lo, hi);
  }
  const int warps = (n + kQ - 1) / kQ;
  const int blocks = (warps + kWarps - 1) / kWarps;
  nn1_kernel<<<blocks, kThreads, 0, s>>>(q, staged, lo, hi, valid_len, center,
                                         n, m, pairs, idx, d2);
  return static_cast<int>(cudaGetLastError());
}

// Floats of scratch icpslam_nn1 and icpslam_knn need for m targets.
extern "C" long long icpslam_nn_scratch_floats(int m) { return scratch_floats(m); }
