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
// it is FP32 on the CUDA cores, with the per-pair expression pinned:
//   p = fma(tz, -2 qz, fma(ty, -2 qy, fma(tx, -2 qx, |t|^2)))
// (__fmaf_rn in this order; -2 q is exact), so the result does not depend
// on the compiler's contraction. |t|^2 and |q|^2 are ((x*x + y*y) + z*z)
// without FMA, as the plain version (ops/nn.py::
// nearest_neighbors_matmul_plain) takes them; its cross term is a matmul
// reduced in another order, so the two agree to ~4e-7 (|q|^2 + |t|^2), not
// bit for bit. The argmin is taken over p; the output is d2 = p + |q|^2,
// clamped at 0 where finite, as on the TPU.
//
// What bounds it on this card: FP32 instruction issue. The form has no
// lower bound that a tile could be skipped on (the rounded p is not
// bounded below by the subtraction-form AABB distance), so every live pair
// is evaluated, as the JAX v1 kernel does: 3 FMAs, a compare and two
// selects. Why not tensor cores: at depth 3 the cross term is 3 FMAs a pair,
// and the epilogue (compare, select) costs as much again, which a tensor
// core product would leave on the CUDA cores while adding the round trip of
// its accumulators through registers; and its only FP32-input mode, TF32,
// keeps 10 mantissa bits, which picks wrong neighbours (the port keeps full
// float32, ROADMAP ground rules).
//
// Design:
//  - a prologue writes each live-range target once as float4 (x, y, z,
//    |t|^2) centred on the query centroid, masked ones and the ragged end
//    of the last tile as (0, 0, 0, +inf), into the wrapper's scratch; it
//    reads valid_len from device memory, as the search does;
//  - the search kernel gives each warp kR = 4 queries, which all its 32
//    lanes hold in registers (register blocking: one shared-memory read of
//    a target serves 4 pairs), each lane every 32nd target; 8 warps per
//    block stage each 512-target tile once with cp.async, double buffered,
//    for the block's 32 queries; a lane stops at valid_len, so the last
//    tile's ragged end is not swept;
//  - each lane visits its targets in ascending index and keeps its best
//    with a strict '<'; the 32 lanes' bests meet as 64-bit keys
//    (order-preserving bits of p << 32 | index) in a min over the warp, so
//    an exact tie of p goes to the lowest index, as the one-thread
//    ascending sweep of the first version gave;
//  - at N = 8192, kR = 4 gives 2,048 warps, against the 8,448 (64 on each
//    of 132 SMs) that the card holds at once; 1 and 2 queries per warp
//    (8,192 and 4,096 warps) took longer on the H100 (PERF.md, PR 4): more
//    shared-memory reads per pair cost more than the extra warps hid;
//  - no live target: index 0, d2 = +inf.

#include "nn_tiles.cuh"

namespace {

// float -> uint32 with the same order (negative values included; p may be
// below 0 by the form's rounding)
__device__ __forceinline__ unsigned ordered_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned u) {
  return __uint_as_float(u ^ ((u >> 31) ? 0x80000000u : 0xffffffffu));
}

constexpr int kMTile = 512;              // targets per staged tile
constexpr int kMWarps = 8;               // warps per block
constexpr int kMThreads = 32 * kMWarps;
constexpr int kR = 4;                    // queries per warp

// The prologue: one thread per target slot of every tile that starts below
// valid_len.
__global__ void __launch_bounds__(kMThreads)
stage_matmul(const float* __restrict__ t, const unsigned char* __restrict__ mask,
             const int* __restrict__ valid_len, const float* __restrict__ center,
             int m, float4* __restrict__ staged) {
  const int live = live_len(valid_len, m);
  const int j = blockIdx.x * kMThreads + threadIdx.x;
  if (j / kMTile * kMTile >= live) return;
  float4 v = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
  if (j < live && mask[j]) {
    v.x = __fsub_rn(t[3 * j + 0], center[0]);
    v.y = __fsub_rn(t[3 * j + 1], center[1]);
    v.z = __fsub_rn(t[3 * j + 2], center[2]);
    v.w = __fadd_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)), __fmul_rn(v.z, v.z));
  }
  staged[j] = v;
}

__global__ void __launch_bounds__(kMThreads)
nn1_matmul_kernel(const float* __restrict__ q, const float4* __restrict__ staged,
                  const int* __restrict__ valid_len, const float* __restrict__ center,
                  int n, int m, int* __restrict__ idx_out, float* __restrict__ d2_out) {
  __shared__ float4 buf[2][kMTile];
  const int lane = threadIdx.x % 32;
  const int i0 = (blockIdx.x * kMWarps + threadIdx.x / 32) * kR;
  const float cx = center[0], cy = center[1], cz = center[2];
  float mx[kR], my[kR], mz[kR], best[kR];
  unsigned bj[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = i0 + r;
    float x = 0.f, y = 0.f, z = 0.f;
    if (i < n) {
      x = __fsub_rn(q[3 * i + 0], cx);
      y = __fsub_rn(q[3 * i + 1], cy);
      z = __fsub_rn(q[3 * i + 2], cz);
    }
    mx[r] = -2.f * x;
    my[r] = -2.f * y;
    mz[r] = -2.f * z;
    best[r] = CUDART_INF_F;
    bj[r] = 0u;
  }
  const int live = live_len(valid_len, m);
  const int mt = (live + kMTile - 1) / kMTile;
  auto stage = [&](int b, int t) {
    const float4* src = staged + static_cast<long long>(t) * kMTile;
#pragma unroll
    for (int k = threadIdx.x; k < kMTile; k += kMThreads) cp_async16(&buf[b][k], src + k);
  };
  if (mt > 0) stage(0, 0);
  cp_async_commit();
  for (int t = 0; t < mt; ++t) {
    if (t + 1 < mt) stage((t + 1) & 1, t + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const float4* tile = buf[t & 1];
    const int cnt = min(kMTile, live - t * kMTile);
    const unsigned base = static_cast<unsigned>(t) * kMTile;
#pragma unroll 8
    for (int k = lane; k < cnt; k += 32) {
      const float4 v = tile[k];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float p = __fmaf_rn(v.z, mz[r], __fmaf_rn(v.y, my[r], __fmaf_rn(v.x, mx[r], v.w)));
        if (p < best[r]) {
          best[r] = p;
          bj[r] = base + k;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const unsigned long long key =
        group_min<32>((static_cast<unsigned long long>(ordered_bits(best[r])) << 32) | bj[r]);
    const int i = i0 + r;
    if (lane == r && i < n) {
      const float p = from_ordered(static_cast<unsigned>(key >> 32));
      const float x = -0.5f * mx[r], y = -0.5f * my[r], z = -0.5f * mz[r];
      const float qn2 = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
      const bool found = p < CUDART_INF_F;
      idx_out[i] = found ? static_cast<int>(key & 0xffffffffu) : 0;
      d2_out[i] = found ? fmaxf(__fadd_rn(p, qn2), 0.f) : CUDART_INF_F;
    }
  }
}

inline long long staged_floats(int m) {
  return 4LL * ((m + kMTile - 1) / kMTile) * kMTile;
}

}  // namespace

// q (n,3), t (m,3) float32; mask (m,) bool; valid_len: device int32 scalar
// or null; center (3,) float32 on the device; scratch: at least
// icpslam_nn1_matmul_scratch_floats(m) floats on the device. Outputs idx
// (n,) int32, d2 (n,) float32. Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for a short scratch buffer).
extern "C" int icpslam_nn1_matmul(const float* q, const float* t,
                                  const unsigned char* mask,
                                  const int* valid_len, const float* center,
                                  int n, int m, float* scratch,
                                  long long scratch_len, int* idx, float* d2,
                                  void* stream) {
  if (n <= 0) return 0;
  if (scratch_len < staged_floats(m)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* staged = reinterpret_cast<float4*>(scratch);
  const int slots = static_cast<int>(staged_floats(m) / 4);
  if (slots > 0)
    stage_matmul<<<slots / kMThreads, kMThreads, 0, s>>>(t, mask, valid_len, center, m, staged);
  constexpr int per_block = kMWarps * kR;
  nn1_matmul_kernel<<<(n + per_block - 1) / per_block, kMThreads, 0, s>>>(
      q, staged, valid_len, center, n, m, idx, d2);
  return static_cast<int>(cudaGetLastError());
}

// Floats of scratch icpslam_nn1_matmul needs for m targets.
extern "C" long long icpslam_nn1_matmul_scratch_floats(int m) { return staged_floats(m); }
