// Tiled neighbour search on Hopper, shared by K1 (nn1.cu), K2 (knn.cu) and
// K3 (radius_moments.cu).
//
// The kernels search, for each query, the live targets in tiles of kTile
// consecutive targets. Scan clouds leave the voxel filter sorted by an
// x-major key, so a tile is a thin x-slab, and the map is built by
// appending such scans: most tiles lie far from most queries. One C call
// runs two kernels on the caller's stream:
//
//  1. stage_tiles (the prologue): one block per tile. It writes the tile's
//     targets centred on the given centre (K1/K2: the query centroid; K3: a
//     zero centre, so the raw coordinates) as float4 (x, y, z, live) into
//     the scratch buffer the wrapper allocated, with masked targets and the
//     ragged end of the last tile at NaN (a NaN distance loses every
//     compare, so the sweep needs no mask test), and the tile's axis-aligned
//     bounding box (AABB) of its live targets with their count (lo.w).
//     Tiles past valid_len (read from device memory) are not written and
//     never read.
//  2. the search kernel: G = kG lanes per query, kQ = 32 / kG queries per
//     warp, each warp on its own. For each query and tile the lanes compute
//     the squared AABB distance lb2 in the same rounded operations as d2
//     (no FMA), so lb2 <= d2 of every target in the tile, exactly. A tile
//     is swept only if some query of the warp has lb2 <= its current bound
//     (best d2 for K1, k-th best for K2, the fixed r^2 for K3): '<=' keeps
//     a target exactly at the bound, which may win a tie on its lower
//     index (K3 counts only d2 < r^2, so there '<=' only sweeps a tile
//     that lies exactly at the radius, which is exact too). Kept tiles are
//     staged into a per-warp double buffer in shared memory with cp.async
//     while the previous one is swept. Each lane of a query sweeps every
//     kG-th target of the tile.
//
// Order: results are kept as 64-bit keys (float bits of d2 << 32 | index).
// d2 >= 0, so the unsigned order of the keys is the (d2, index) order, and
// a min over keys gives the lowest index on an exact tie in any visiting
// order. Tiles are visited in a rotation that starts at the tile with the
// smallest lb2 for the warp's first query (ties: the first from the tile
// whose rank matches the query's own rank, as the JAX kernel's matched
// start, nn_kernel.py:245); for K1 and K2 the order changes the speed,
// never the result. K3's sums are rounded in this order, which is fixed by
// the inputs, so a run gives the same bits every time.
//
// An optional device counter (pairs, null on the main path) adds, per
// swept tile, the warp's queries times the tile's live targets.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

// Everything here has internal linkage (the unnamed namespace, which the
// including source reopens for its own kernels), so each source that
// includes it gets its own copy of stage_tiles.
namespace {

constexpr int kTile = 256;           // targets per tile
constexpr int kG = 8;                // lanes per query
constexpr int kQ = 32 / kG;          // queries per warp
constexpr int kWarps = 4;            // warps per block of the search kernel
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float e0 = __fsub_rn(ax, bx);
  const float e1 = __fsub_rn(ay, by);
  const float e2 = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(e0, e0), __fmul_rn(e1, e1)),
                   __fmul_rn(e2, e2));
}

__device__ __forceinline__ unsigned long long pack(float d2, unsigned j) {
  return (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) | j;
}

__device__ __forceinline__ float key_d2(unsigned long long key) {
  return __uint_as_float(static_cast<unsigned>(key >> 32));
}

__device__ __forceinline__ int live_len(const int* valid_len, int m) {
  return valid_len != nullptr ? min(max(*valid_len, 0), m) : m;
}

// Squared distance from q to the box [lo, hi], rounded as sqdist rounds:
// every coordinate gap is <= |t_c - q_c| of every target in the box, so
// the result is <= sqdist(t, q). An empty tile (lo = +inf) gives +inf.
__device__ __forceinline__ float aabb_lb2(float4 lo, float4 hi, float qx,
                                          float qy, float qz) {
  const float g0 = fmaxf(fmaxf(__fsub_rn(lo.x, qx), __fsub_rn(qx, hi.x)), 0.f);
  const float g1 = fmaxf(fmaxf(__fsub_rn(lo.y, qy), __fsub_rn(qy, hi.y)), 0.f);
  const float g2 = fmaxf(fmaxf(__fsub_rn(lo.z, qz), __fsub_rn(qz, hi.z)), 0.f);
  return __fadd_rn(__fadd_rn(__fmul_rn(g0, g0), __fmul_rn(g1, g1)),
                   __fmul_rn(g2, g2));
}

// The prologue: stage one tile and write its AABB.
__global__ void __launch_bounds__(kTile)
stage_tiles(const float* __restrict__ t, const unsigned char* __restrict__ mask,
            const int* __restrict__ valid_len, const float* __restrict__ center,
            int m, float4* __restrict__ staged, float4* __restrict__ lo,
            float4* __restrict__ hi) {
  const int live = live_len(valid_len, m);
  const int base = blockIdx.x * kTile;
  if (base >= live) return;
  const int j = base + threadIdx.x;
  const bool on = j < live && mask[j];
  float4 v = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, 0.f);
  if (on) {
    v.x = __fsub_rn(t[3 * j + 0], center[0]);
    v.y = __fsub_rn(t[3 * j + 1], center[1]);
    v.z = __fsub_rn(t[3 * j + 2], center[2]);
    v.w = 1.f;
  }
  staged[j] = v;
  float r[7] = {on ? v.x : CUDART_INF_F, on ? v.y : CUDART_INF_F,
                on ? v.z : CUDART_INF_F, on ? v.x : -CUDART_INF_F,
                on ? v.y : -CUDART_INF_F, on ? v.z : -CUDART_INF_F, v.w};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      r[c] = fminf(r[c], __shfl_xor_sync(kFull, r[c], off));
      r[c + 3] = fmaxf(r[c + 3], __shfl_xor_sync(kFull, r[c + 3], off));
    }
    r[6] += __shfl_xor_sync(kFull, r[6], off);
  }
  __shared__ float part[kTile / 32][7];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int c = 0; c < 7; ++c) part[warp][c] = r[c];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kTile / 32; ++w) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        r[c] = fminf(r[c], part[w][c]);
        r[c + 3] = fmaxf(r[c + 3], part[w][c + 3]);
      }
      r[6] += part[w][6];
    }
    lo[blockIdx.x] = make_float4(r[0], r[1], r[2], r[6]);
    hi[blockIdx.x] = make_float4(r[3], r[4], r[5], 0.f);
  }
}

// Floats of scratch the wrapper allocates for m targets: the staged tiles,
// then lo, then hi.
inline long long scratch_floats(int m) {
  const long long tiles = (m + kTile - 1) / kTile;
  return tiles * (kTile + 2) * 4;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// min over the kG lanes of one query (aligned groups of kG lanes)
__device__ __forceinline__ float group_min(float x) {
#pragma unroll
  for (int off = kG / 2; off > 0; off >>= 1)
    x = fminf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = kG / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// min of 64-bit keys over aligned groups of W lanes (W = kG: one query's
// lanes; W = 32: the warp)
template <int W = kG>
__device__ __forceinline__ unsigned long long group_min(unsigned long long x) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    const unsigned long long y = __shfl_xor_sync(kFull, x, off);
    x = y < x ? y : x;
  }
  return x;
}

// The search loop. Acc is the per-lane accumulator of K1, K2 or K3:
//   float group_bound() const
//       -- the d2 a target must not exceed to matter to the lane's query,
//          agreed by the query's kG lanes (shuffles: all lanes call it)
//   void sweep(const float4* tile, unsigned base, int sub, float bound)
//       -- targets sub, sub + kG, ... of the tile
// q0 is the warp's first query; the lane's query is valid when qvalid.
template <class Acc>
__device__ __forceinline__ void search(
    Acc& acc, float4 (*buf)[kTile], const float4* __restrict__ staged,
    const float4* __restrict__ lo, const float4* __restrict__ hi, int live,
    int q0, int n, bool qvalid, unsigned long long* pairs) {
  const int lane = threadIdx.x % 32;
  const int sub = lane % kG;
  const int mt = (live + kTile - 1) / kTile;
  if (mt == 0) return;
  // matched start (tie-break order): the tile whose rank matches q0's
  const int start = static_cast<int>((static_cast<long long>(q0) * mt) / n);
  // the seed: the first tile, in rotation from start, of least lb2 for
  // the lane's query; the warp starts at its first query's seed
  unsigned long long seed = ~0ull;
  for (int p0 = 0; p0 < mt; p0 += kG) {
    const int p = p0 + sub;
    if (qvalid && p < mt) {
      int t = start + p;
      t = t >= mt ? t - mt : t;
      const float lb2 = aabb_lb2(lo[t], hi[t], acc.qx, acc.qy, acc.qz);
      const unsigned long long key = pack(lb2, static_cast<unsigned>(t));
      seed = key < seed ? key : seed;
    }
  }
  seed = group_min(seed);
  // lane 0's query (q0) is always valid; with every tile empty the seed
  // is still a tile index (lb2 = +inf sorts below ~0)
  const int first = static_cast<int>(__shfl_sync(kFull, seed, 0) & 0xffffffffu);
  auto tile_at = [&](int p) {
    const int t = first + p;
    return t >= mt ? t - mt : t;
  };
  float bound = acc.group_bound();
  // next visiting position >= p that some query of the warp needs, under
  // the current bound; kG positions are tested per step (lane sub tests
  // position p + sub for its query)
  auto next_needed = [&](int p) {
    for (; p < mt; p += kG) {
      const int v = p + sub;
      bool need = false;
      if (qvalid && v < mt) {
        const int t = tile_at(v);
        const float lb2 = aabb_lb2(lo[t], hi[t], acc.qx, acc.qy, acc.qz);
        need = lb2 <= bound && lb2 < CUDART_INF_F;
      }
      unsigned ballot = __ballot_sync(kFull, need);
      unsigned fold = 0;
#pragma unroll
      for (int g = 0; g < kQ; ++g) fold |= ballot >> (g * kG);
      fold &= (1u << kG) - 1u;
      if (fold) return p + __ffs(fold) - 1;
    }
    return mt;
  };
  auto stage = [&](float4* dst, int t) {
    const float4* src = staged + static_cast<long long>(t) * kTile;
#pragma unroll
    for (int i = lane; i < kTile; i += 32) cp_async16(dst + i, src + i);
  };
  const int nq = min(kQ, n - q0);
  int cur = next_needed(0);
  int b = 0;
  if (cur < mt) stage(buf[0], tile_at(cur));
  cp_async_commit();
  while (cur < mt) {
    const int nxt = next_needed(cur + 1);
    if (nxt < mt) stage(buf[b ^ 1], tile_at(nxt));
    cp_async_commit();
    cp_async_wait1();
    __syncwarp();
    const int t = tile_at(cur);
    // cur was chosen under an older bound: test it again
    const float4 l = lo[t];
    const bool need = qvalid && aabb_lb2(l, hi[t], acc.qx, acc.qy, acc.qz) <= bound;
    if (__any_sync(kFull, need)) {
      acc.sweep(buf[b], static_cast<unsigned>(t) * kTile, sub, bound);
      bound = acc.group_bound();
      if (pairs != nullptr && lane == 0)
        atomicAdd(pairs, static_cast<unsigned long long>(nq) *
                             static_cast<unsigned long long>(l.w));
    }
    __syncwarp();
    b ^= 1;
    cur = nxt;
  }
}

}  // namespace
