// K3: fixed-radius neighbourhood moments on Hopper (sm_90a).
//
// Replaces icpslam_tpu/ops/pallas/radius_stats_kernel.py:69 radius_moments
// (kernel _stats_kernel). For each query q: over the live targets t with
// d2 = |t - q|^2 < r^2, the weight w = 1 (hard cutoff) or exp(-d2 / 2 sigma^2)
// (taper), and from the sums
//   sw = sum w,  s = sum w e,  S = sum w e e^T,  e = t - q,
// the outputs count = sw, mean = q + s / sw, cov = S / sw - m m^T with
// m = s / sw; all zero where sw = 0.
//
// The TPU kernel reduces with a one-hot feature matmul (F @ w) so the MXU
// does the sums, on coordinates centred on the cloud centroid. Here each
// query keeps its 10 sums in registers, on e = t - q: e is exact for
// neighbours (Sterbenz), so the cancellation in E[e e^T] - m m^T happens at
// neighbourhood scale (r), not at the ~80 m scale of a scan, and a cloud
// 1 km from the origin loses nothing.
//
// What bounds it on this card: FP32 instruction issue. Each (query,
// target) pair that is swept costs 3 subtractions, 3 multiplies, 2 adds and
// a compare; the accumulation (one expf and ten multiply-adds) runs only
// for the few pairs in radius (~6 of 8192 per query on a kitti_config()
// scan at r = 1 m). Device memory holds 16 bytes per target, read once per
// swept tile.
//
// Design: the tiled search of nn_tiles.cuh (K1's), against the fixed
// bound r^2.
//  - The prologue (stage_tiles) stages the targets as float4 tiles with
//    their AABBs, on a zero centre: __fsub_rn(x, 0) is x, so e = t - q and
//    d2 = ((ex*ex + ey*ey) + ez*ez) round exactly as the plain version
//    (ops/radius_stats.py::radius_moments_plain) rounds them, and
//    membership d2 < r^2 is decided bit for bit alike. (Centring on the
//    query centroid would round (t - c) - (q - c) otherwise.) Masked
//    targets are NaN, and NaN < r^2 is false: the sweep has no mask test.
//  - 8 lanes per query, 4 queries per warp (2,048 warps at N = 8192); a
//    tile is swept only where some query of the warp has its AABB distance
//    lb2 <= r^2. lb2 <= d2 in the same rounded operations, so a tile that
//    holds a neighbour is never skipped; on voxel-sorted scans, whose tiles
//    are thin x-slabs, a warp sweeps the few slabs within r of its queries.
//  - Each lane sums its targets with d2 < r^2 (every 8th of a tile), in a
//    visiting order fixed by the inputs; the 8 lanes' sums are merged by a
//    shuffle butterfly, in which every lane adds the same pairs (addition
//    commutes), so a run gives the same bits every time. The epilogue is
//    the first version's.
//  - Tiles of kTile = 256 targets, as K1's. Tiles of 128 swept fewer pairs
//    on a kitti_config() scan but took longer on the H100 (PERF.md, PR 4).
// One call of icpslam_radius_moments launches the prologue and the search
// kernel; the wrapper's launch count (radius_moments_cuda.launches) counts
// calls. The optional pairs counter adds, per swept tile, the warp's
// queries times the tile's live targets.

#include "nn_tiles.cuh"

namespace {

struct Moments {
  float qx, qy, qz;
  float r2, inv2s2;
  // sw, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz
  float s[10];

  __device__ float group_bound() const { return r2; }

  __device__ void sweep(const float4* tile, unsigned, int sub, float) {
#pragma unroll 4
    for (int k = sub; k < kTile; k += kG) {
      const float4 v = tile[k];
      const float ex = __fsub_rn(v.x, qx);
      const float ey = __fsub_rn(v.y, qy);
      const float ez = __fsub_rn(v.z, qz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                                 __fmul_rn(ez, ez));
      if (d2 < r2) {
        const float w = inv2s2 > 0.f ? expf(-d2 * inv2s2) : 1.f;
        const float wx = w * ex, wy = w * ey, wz = w * ez;
        s[0] += w;
        s[1] += wx;
        s[2] += wy;
        s[3] += wz;
        s[4] += wx * ex;
        s[5] += wx * ey;
        s[6] += wx * ez;
        s[7] += wy * ey;
        s[8] += wy * ez;
        s[9] += wz * ez;
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads)
radius_moments_kernel(const float* __restrict__ q, const float4* __restrict__ staged,
                      const float4* __restrict__ lo, const float4* __restrict__ hi,
                      int n, int m, float r2, float inv2s2,
                      unsigned long long* __restrict__ pairs,
                      float* __restrict__ count_out, float* __restrict__ mean_out,
                      float* __restrict__ cov_out) {
  __shared__ float4 buf[kWarps][2][kTile];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = (blockIdx.x * kWarps + warp) * kQ;
  if (q0 >= n) return;
  const int i = q0 + lane / kG;
  const bool qvalid = i < n;
  Moments acc;
  acc.qx = acc.qy = acc.qz = 0.f;
  acc.r2 = r2;
  acc.inv2s2 = inv2s2;
#pragma unroll
  for (int c = 0; c < 10; ++c) acc.s[c] = 0.f;
  if (qvalid) {
    acc.qx = q[3 * i + 0];
    acc.qy = q[3 * i + 1];
    acc.qz = q[3 * i + 2];
  }
  search(acc, buf[warp], staged, lo, hi, m, q0, n, qvalid, pairs);
#pragma unroll
  for (int off = kG / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < 10; ++c) acc.s[c] += __shfl_xor_sync(kFull, acc.s[c], off);
  }
  if (!qvalid || lane % kG != 0) return;
  const float* s = acc.s;
  const float sw = s[0];
  float mean[3] = {0.f, 0.f, 0.f};
  float cov[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (sw > 0.f) {
    const float mx = s[1] / sw, my = s[2] / sw, mz = s[3] / sw;
    mean[0] = acc.qx + mx;
    mean[1] = acc.qy + my;
    mean[2] = acc.qz + mz;
    const float cxx = s[4] / sw - mx * mx, cxy = s[5] / sw - mx * my;
    const float cxz = s[6] / sw - mx * mz, cyy = s[7] / sw - my * my;
    const float cyz = s[8] / sw - my * mz, czz = s[9] / sw - mz * mz;
    cov[0] = cxx; cov[1] = cxy; cov[2] = cxz;
    cov[3] = cxy; cov[4] = cyy; cov[5] = cyz;
    cov[6] = cxz; cov[7] = cyz; cov[8] = czz;
  }
  count_out[i] = sw;
#pragma unroll
  for (int c = 0; c < 3; ++c) mean_out[3 * i + c] = mean[c];
#pragma unroll
  for (int c = 0; c < 9; ++c) cov_out[9 * i + c] = cov[c];
}

}  // namespace

// q (n,3), t (m,3) float32; mask (m,) bool; zero: a (3,) float32 zero on
// the device (the prologue's centre); r2 = radius^2 and inv2s2 = 1 / (2
// sigma^2) (0 for the hard cutoff) as float32; scratch: at least
// icpslam_nn_scratch_floats(m) floats on the device (nn1.cu: the same tile
// layout); pairs: a device uint64 counter or null. Outputs count (n,), mean
// (n,3), cov (n,3,3) float32. Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a short scratch buffer).
extern "C" int icpslam_radius_moments(const float* q, const float* t,
                                      const unsigned char* mask, const float* zero,
                                      int n, int m, float r2, float inv2s2,
                                      float* scratch, long long scratch_len,
                                      unsigned long long* pairs, float* count,
                                      float* mean, float* cov, void* stream) {
  if (n <= 0) return 0;
  if (scratch_len < scratch_floats(m)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (m + kTile - 1) / kTile;
  float4* staged = reinterpret_cast<float4*>(scratch);
  float4* lo = staged + static_cast<long long>(tiles) * kTile;
  float4* hi = lo + tiles;
  if (tiles > 0) {
    stage_tiles<<<tiles, kTile, 0, s>>>(t, mask, nullptr, zero, m, staged, lo, hi);
  }
  const int warps = (n + kQ - 1) / kQ;
  const int blocks = (warps + kWarps - 1) / kWarps;
  radius_moments_kernel<<<blocks, kThreads, 0, s>>>(q, staged, lo, hi, n, m, r2, inv2s2,
                                                    pairs, count, mean, cov);
  return static_cast<int>(cudaGetLastError());
}
