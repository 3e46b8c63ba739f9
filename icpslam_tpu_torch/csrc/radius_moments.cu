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
// thread keeps its query's 10 sums in registers, centred on the query
// itself: e = t - q is exact for neighbours (Sterbenz), so the
// cancellation in E[e e^T] - m m^T happens at neighbourhood scale (r), not
// at the ~80 m scale of a scan, and a cloud 1 km from the origin loses
// nothing.
//
// What bounds it on this card: FP32 instruction throughput. Every
// (query, target) pair costs 3 subtractions, 3 multiplies, 2 adds and a
// compare; the accumulation (one expf and ten multiply-adds) runs only for
// the few pairs in radius (~6 of 8192 per query on a kitti_config scan at
// r = 1 m), so the sweep costs about what K1's does. Device memory is not
// the limit: a 256-target tile (4 KB) is read once per block.
//
// Design (first, simple version):
//  - one thread per query (64-thread blocks: 128 blocks at 8192 queries,
//    about one per SM), its coordinates and the 10 sums in registers;
//  - the targets are swept in tiles staged through shared memory as float4
//    (x, y, z, live); masked targets carry live = 0 and are skipped;
//  - d2 uses __fsub_rn/__fmul_rn/__fadd_rn, ((ex*ex + ey*ey) + ez*ez), so
//    membership d2 < r^2 is decided bit for bit as the plain version
//    (ops/radius_stats.py::radius_moments_plain) decides it; the sums may
//    contract to FMA and are taken in target order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 256;

__global__ void __launch_bounds__(kThreads)
radius_moments_kernel(const float* __restrict__ q, const float* __restrict__ t,
                      const unsigned char* __restrict__ mask, int n, int m,
                      float r2, float inv2s2, float* __restrict__ count_out,
                      float* __restrict__ mean_out, float* __restrict__ cov_out) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (i < n) {
    qx = q[3 * i + 0];
    qy = q[3 * i + 1];
    qz = q[3 * i + 2];
  }
  float sw = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
  float sxx = 0.f, sxy = 0.f, sxz = 0.f, syy = 0.f, syz = 0.f, szz = 0.f;

  for (int base = 0; base < m; base += kTile) {
    for (int k = threadIdx.x; k < kTile; k += kThreads) {
      const int j = base + k;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < m && mask[j]) {
        v.x = t[3 * j + 0];
        v.y = t[3 * j + 1];
        v.z = t[3 * j + 2];
        v.w = 1.f;
      }
      tile[k] = v;
    }
    __syncthreads();
    const int cnt = min(kTile, m - base);
    for (int k = 0; k < cnt; ++k) {
      const float4 v = tile[k];
      const float ex = __fsub_rn(v.x, qx);
      const float ey = __fsub_rn(v.y, qy);
      const float ez = __fsub_rn(v.z, qz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                                 __fmul_rn(ez, ez));
      if (v.w != 0.f && d2 < r2) {
        const float w = inv2s2 > 0.f ? expf(-d2 * inv2s2) : 1.f;
        const float wx = w * ex, wy = w * ey, wz = w * ez;
        sw += w;
        sx += wx;
        sy += wy;
        sz += wz;
        sxx += wx * ex;
        sxy += wx * ey;
        sxz += wx * ez;
        syy += wy * ey;
        syz += wy * ez;
        szz += wz * ez;
      }
    }
    __syncthreads();
  }
  if (i >= n) return;
  float mean[3] = {0.f, 0.f, 0.f};
  float cov[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (sw > 0.f) {
    const float mx = sx / sw, my = sy / sw, mz = sz / sw;
    mean[0] = qx + mx;
    mean[1] = qy + my;
    mean[2] = qz + mz;
    const float cxx = sxx / sw - mx * mx, cxy = sxy / sw - mx * my;
    const float cxz = sxz / sw - mx * mz, cyy = syy / sw - my * my;
    const float cyz = syz / sw - my * mz, czz = szz / sw - mz * mz;
    cov[0] = cxx; cov[1] = cxy; cov[2] = cxz;
    cov[3] = cxy; cov[4] = cyy; cov[5] = cyz;
    cov[6] = cxz; cov[7] = cyz; cov[8] = czz;
  }
  count_out[i] = sw;
  for (int c = 0; c < 3; ++c) mean_out[3 * i + c] = mean[c];
  for (int c = 0; c < 9; ++c) cov_out[9 * i + c] = cov[c];
}

}  // namespace

// q (n,3), t (m,3) float32; mask (m,) bool; r2 = radius^2 and
// inv2s2 = 1 / (2 sigma^2) (0 for the hard cutoff) as float32. Outputs
// count (n,), mean (n,3), cov (n,3,3) float32. Returns cudaGetLastError()
// after the launch.
extern "C" int icpslam_radius_moments(const float* q, const float* t,
                                      const unsigned char* mask, int n, int m,
                                      float r2, float inv2s2, float* count,
                                      float* mean, float* cov, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  radius_moments_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, t, mask, n, m, r2, inv2s2, count, mean, cov);
  return static_cast<int>(cudaGetLastError());
}
