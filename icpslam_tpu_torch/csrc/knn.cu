// K2: exact k-nearest-neighbours (k <= 16) on Hopper (sm_90a).
//
// Replaces icpslam_tpu/ops/pallas/nn_kernel.py:450 knn_pallas (kernel
// _nn_excl_kernel), which runs k exclusion passes of a matmul-form 1-NN.
// Here it is one pass in the subtraction form of K1 (nn1.cu), without FMA
// contraction. In the port this is the covariance k-NN of the main path
// (self k-NN, k = 10, once per scan). Output (n, k) ascending in (d2,
// index); missing neighbours (fewer than k live targets) are d2 = +inf
// with index 0, as knn_pallas leaves them; a live self-query finds itself
// at d2 = 0 (first, unless an exact duplicate has a lower index).
//
// What bounds it on this card: the FP32 instruction rate, as K1; the
// insertion into a k-list runs only for a target no farther than the
// current k-th best, which after the first tiles is rare.
//
// Design (the tiles, the AABB skip and the staging are nn_tiles.cuh's):
//  - 8 lanes per query, 4 queries per warp; each lane keeps a sorted list
//    of its k best targets among every 8th target of a tile, as 64-bit keys
//    (d2 bits << 32 | index) in registers, so exact ties keep index order
//    in any visiting order;
//  - a tile is swept only where some query's AABB distance is no larger
//    than a bound on its k-th best: the 8 lanes together hold at least k
//    targets no farther than the largest of their ceil(k/8)-th bests
//    (Knn::group_bound), and a target beyond that bound is not inserted;
//    the search starts at the query's own tile (self k-NN: the query's
//    rank is its index);
//  - at the end the 8 lanes' lists are merged by a shuffle butterfly, k
//    insertions per step and 3 steps, so every lane holds the query's k-NN.
// One call of icpslam_knn launches the prologue and the search kernel; the
// wrapper's launch count (knn_cuda.launches) counts calls.

#include "nn_tiles.cuh"

namespace {

template <int K>
struct Knn {
  float qx, qy, qz;
  unsigned long long key[K];  // ascending; empty slots are (+inf, ~0)

  __device__ float kth() const { return key_d2(key[K - 1]); }

  // Each lane holds at least J = ceil(K / kG) of its targets no farther
  // than its J-th best, so the query's kG lanes hold at least K no farther
  // than the largest of those: the query's K-th best so far is no larger
  // than that, nor than any lane's own K-th best.
  __device__ float group_bound() const {
    constexpr int J = (K + kG - 1) / kG;
    return fminf(group_max(key_d2(key[J - 1])), group_min(kth()));
  }

  __device__ __forceinline__ void insert(unsigned long long c) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const unsigned long long cur = key[s];
      const bool sw = c < cur;
      key[s] = sw ? c : cur;
      c = sw ? cur : c;
    }
  }

  // A target farther than the query's bound cannot reach its K-NN, and
  // one farther than the lane's own K-th best cannot reach the lane's list.
  __device__ void sweep(const float4* tile, unsigned base, int sub, float bound) {
    float gate = fminf(kth(), bound);
#pragma unroll 4
    for (int k = sub; k < kTile; k += kG) {
      const float4 v = tile[k];
      const float d = sqdist(v.x, v.y, v.z, qx, qy, qz);
      if (d <= gate) {
        insert(pack(d, base + k));
        gate = fminf(kth(), bound);
      }
    }
  }
};

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ q, const float4* __restrict__ staged,
           const float4* __restrict__ lo, const float4* __restrict__ hi,
           const float* __restrict__ center, int n, int m,
           unsigned long long* __restrict__ pairs, int* __restrict__ idx_out,
           float* __restrict__ d2_out) {
  __shared__ float4 buf[kWarps][2][kTile];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = (blockIdx.x * kWarps + warp) * kQ;
  if (q0 >= n) return;
  const int i = q0 + lane / kG;
  const bool qvalid = i < n;
  Knn<K> acc;
  acc.qx = acc.qy = acc.qz = 0.f;
#pragma unroll
  for (int s = 0; s < K; ++s) acc.key[s] = pack(CUDART_INF_F, 0xffffffffu);
  if (qvalid) {
    acc.qx = __fsub_rn(q[3 * i + 0], center[0]);
    acc.qy = __fsub_rn(q[3 * i + 1], center[1]);
    acc.qz = __fsub_rn(q[3 * i + 2], center[2]);
  }
  search(acc, buf[warp], staged, lo, hi, m, q0, n, qvalid, pairs);
  // butterfly merge of the kG lanes' lists (disjoint target sets)
#pragma unroll
  for (int off = kG / 2; off > 0; off >>= 1) {
    unsigned long long other[K];
#pragma unroll
    for (int s = 0; s < K; ++s) other[s] = __shfl_xor_sync(kFull, acc.key[s], off);
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (other[s] < acc.key[K - 1]) acc.insert(other[s]);
    }
  }
  if (qvalid && lane % kG == 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const float d = key_d2(acc.key[s]);
      idx_out[i * K + s] =
          d < CUDART_INF_F ? static_cast<int>(acc.key[s] & 0xffffffffu) : 0;
      d2_out[i * K + s] = d;
    }
  }
}

template <int K>
void launch(const float* q, const float4* staged, const float4* lo,
            const float4* hi, const float* center, int n, int m,
            unsigned long long* pairs, int* idx, float* d2,
            cudaStream_t stream) {
  const int warps = (n + kQ - 1) / kQ;
  const int blocks = (warps + kWarps - 1) / kWarps;
  knn_kernel<K><<<blocks, kThreads, 0, stream>>>(q, staged, lo, hi, center, n,
                                                  m, pairs, idx, d2);
}

}  // namespace

// q (n,3), t (m,3) float32; mask (m,) bool; center (3,) float32 on the
// device; 1 <= k <= 16; scratch: at least icpslam_nn_scratch_floats(m)
// floats on the device; pairs: a device uint64 counter or null. Outputs
// idx (n,k) int32 and d2 (n,k) float32. Returns cudaGetLastError() after
// the launches (cudaErrorInvalidValue for an unsupported k or a short
// scratch buffer).
extern "C" int icpslam_knn(const float* q, const float* t,
                           const unsigned char* mask, const float* center,
                           int n, int m, int k, float* scratch,
                           long long scratch_len, unsigned long long* pairs,
                           int* idx, float* d2, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > 16 || scratch_len < scratch_floats(m))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (m + kTile - 1) / kTile;
  float4* staged = reinterpret_cast<float4*>(scratch);
  float4* lo = staged + static_cast<long long>(tiles) * kTile;
  float4* hi = lo + tiles;
  if (tiles > 0) {
    stage_tiles<<<tiles, kTile, 0, s>>>(t, mask, nullptr, center, m, staged, lo, hi);
  }
  switch (k) {
#define ICPSLAM_KNN_CASE(K)                                                \
  case K:                                                                  \
    launch<K>(q, staged, lo, hi, center, n, m, pairs, idx, d2, s);         \
    break;
    ICPSLAM_KNN_CASE(1) ICPSLAM_KNN_CASE(2) ICPSLAM_KNN_CASE(3)
    ICPSLAM_KNN_CASE(4) ICPSLAM_KNN_CASE(5) ICPSLAM_KNN_CASE(6)
    ICPSLAM_KNN_CASE(7) ICPSLAM_KNN_CASE(8) ICPSLAM_KNN_CASE(9)
    ICPSLAM_KNN_CASE(10) ICPSLAM_KNN_CASE(11) ICPSLAM_KNN_CASE(12)
    ICPSLAM_KNN_CASE(13) ICPSLAM_KNN_CASE(14) ICPSLAM_KNN_CASE(15)
    ICPSLAM_KNN_CASE(16)
#undef ICPSLAM_KNN_CASE
  }
  return static_cast<int>(cudaGetLastError());
}
