// K4: exact 1-nearest-neighbour search in matmul form on Hopper (sm_90a).
//
// Replaces icpslam_tpu/ops/pallas/nn_kernel.py:123 nearest_neighbors_pallas
// (v1, kernel _nn_kernel). For each query, the nearest live target by
//   d2 = |t|^2 - 2 (t . q) + |q|^2
// in float32 on coordinates centred on the query centroid, with masked
// targets at |t|^2 = +inf and the sweep stopping at valid_len. The JAX
// package keeps this form only as the reference formulation and the A/B
// baseline of the subtraction-form kernel K1 (csrc/nn1.cu); no path of
// slam_step calls it, in JAX or in the port.
//
// Numerics: the form cancels |t|^2 + |q|^2 against 2 t.q, so its rounding
// error scales with the operands (|t|^2 up to ~6,400 m^2 on an 80 m scan),
// not with d2. The TPU ran the cross term at HIGHEST (full float32); here
// it is plain FP32 on the CUDA cores (no TF32, no tensor cores), and FMA
// contraction is allowed: the plain version (ops/nn.py::
// nearest_neighbors_matmul_plain) agrees to ~4e-7 (|q|^2 + |t|^2), not
// bit for bit. The result is clamped at 0 where finite, as on the TPU.
//
// What bounds it on this card: FP32 instruction throughput, as for K1
// (per pair 3 multiply-adds, 2 adds and a compare; the target tile is read
// from shared memory by every thread).
//
// Design (first, simple version):
//  - one thread per query, centred query and |q|^2 in registers;
//  - targets in shared-memory tiles of float4 (x, y, z, |t|^2 or +inf);
//  - running (best d2, index) in registers; a strict '<' on an ascending
//    sweep keeps the lowest index on ties;
//  - valid_len is read from device memory, as in K1;
//  - no live target: index 0, d2 = +inf.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 256;

__global__ void __launch_bounds__(kThreads)
nn1_matmul_kernel(const float* __restrict__ q, const float* __restrict__ t,
                  const unsigned char* __restrict__ mask,
                  const int* __restrict__ valid_len,
                  const float* __restrict__ center, int n, int m,
                  int* __restrict__ idx_out, float* __restrict__ d2_out) {
  __shared__ float4 tile[kTile];
  const float cx = center[0], cy = center[1], cz = center[2];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (i < n) {
    qx = q[3 * i + 0] - cx;
    qy = q[3 * i + 1] - cy;
    qz = q[3 * i + 2] - cz;
  }
  const float qn2 = qx * qx + qy * qy + qz * qz;
  int live = m;
  if (valid_len != nullptr) live = min(max(*valid_len, 0), m);

  float best = CUDART_INF_F;
  int best_j = 0;
  for (int base = 0; base < live; base += kTile) {
    for (int k = threadIdx.x; k < kTile; k += kThreads) {
      const int j = base + k;
      float4 v = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
      if (j < live && mask[j]) {
        v.x = t[3 * j + 0] - cx;
        v.y = t[3 * j + 1] - cy;
        v.z = t[3 * j + 2] - cz;
        v.w = v.x * v.x + v.y * v.y + v.z * v.z;
      }
      tile[k] = v;
    }
    __syncthreads();
    const int cnt = min(kTile, live - base);
    for (int k = 0; k < cnt; ++k) {
      const float4 v = tile[k];
      const float cross = v.x * qx + v.y * qy + v.z * qz;
      const float d = v.w - 2.f * cross + qn2;
      if (d < best) {
        best = d;
        best_j = base + k;
      }
    }
    __syncthreads();
  }
  if (i < n) {
    idx_out[i] = best_j;
    d2_out[i] = best < CUDART_INF_F ? fmaxf(best, 0.f) : best;
  }
}

}  // namespace

// q (n,3), t (m,3) float32; mask (m,) bool; valid_len: device int32 scalar
// or null; center (3,) float32 on the device. Outputs idx (n,) int32,
// d2 (n,) float32. Returns cudaGetLastError() after the launch.
extern "C" int icpslam_nn1_matmul(const float* q, const float* t,
                                  const unsigned char* mask,
                                  const int* valid_len, const float* center,
                                  int n, int m, int* idx, float* d2,
                                  void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  nn1_matmul_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, t, mask, valid_len, center, n, m, idx, d2);
  return static_cast<int>(cudaGetLastError());
}
