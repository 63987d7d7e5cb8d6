// Device code shared by the two semiring kernels (semiring_spmm.cu and
// semiring_superstep.cu): the two semirings and the walk over one output
// block's run of tiles.
//
// Layout (the blocked graph's, see repro_torch/core/blocked.py):
//   tiles (P, T, B, B) float32   tile[t, i, j] = weight of edge
//                                (rows[t]*B + i) -> (cols[t]*B + j)
//   rows, cols (P, T) int32      -1 = padding; valid columns are sorted
//                                ascending and padding sorts last
//
// So every output block c owns one contiguous run [lo, hi) of a
// partition's tile list.  One CTA computes one (partition, output block):
// it finds its run by binary search, then its threads fold the run in a
// fixed order.  Runs are independent, so there are no atomics on state and
// results do not depend on scheduling.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace semiring_kernels {

// (min, +).  ``add`` is a NaN-propagating min, matching jnp.minimum and
// torch.minimum; fminf would drop a NaN operand.
struct MinPlus {
  static __device__ __forceinline__ float zero() {
    return __int_as_float(0x7f800000);  // +inf
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return (a != a || a < b) ? a : b;
  }
  static __device__ __forceinline__ float mac(float acc, float x, float w) {
    return add(acc, x + w);
  }
};

// (+, x), accumulated in float32 on the CUDA cores (no TF32).
struct PlusMul {
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float add(float a, float b) {
    return a + b;
  }
  static __device__ __forceinline__ float mac(float acc, float x, float w) {
    return __fmaf_rn(x, w, acc);
  }
};

template <class SR>
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(SR::add(a.x, b.x), SR::add(a.y, b.y),
                     SR::add(a.z, b.z), SR::add(a.w, b.w));
}

// Threads per CTA: (B/4 column quads) x G row groups.  Each thread reads
// 16 bytes (four columns) of a tile row per load; G splits the rows so a
// CTA keeps about kThreads threads' worth of loads in flight.
constexpr int kThreads = 512;

inline int row_groups(int B) {
  int g = kThreads / (B / 4);
  if (g > B) g = B;
  return g < 1 ? 1 : g;
}

// [lo, hi) of the tiles with column c among the first n entries of cols.
// The valid prefix ends at the first padding entry (cols < 0 is monotone
// over t because padding sorts last).
__device__ __forceinline__ int2 find_run(const int* __restrict__ cols, int n,
                                         int c) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int m = (lo + hi) >> 1;
    if (cols[m] < 0) hi = m; else lo = m + 1;
  }
  const int len = lo;
  lo = 0;
  hi = len;
  while (lo < hi) {  // lower bound of c
    int m = (lo + hi) >> 1;
    if (cols[m] < c) lo = m + 1; else hi = m;
  }
  const int first = lo;
  hi = len;
  while (lo < hi) {  // upper bound of c
    int m = (lo + hi) >> 1;
    if (cols[m] <= c) lo = m + 1; else hi = m;
  }
  return make_int2(first, lo);
}

// Fold of the run [lo, hi) for output columns 4q..4q+3.  The run's
// (tile, row) pairs are walked in order; thread (q, g) takes pairs
// g, g+G, ... — one float4 of the tile row (coalesced over q) and one
// broadcast x value each — so consecutive loads of a thread are
// independent and several are in flight.  The G partials are then
// combined in order 0..G-1 through shared memory (``red``: G*B floats).
// Every thread of the CTA must call this (it synchronises).  The result
// is valid on the threads with g == 0.
template <class SR>
__device__ __forceinline__ float4 fold_run(
    const float* __restrict__ tiles, const int* __restrict__ rows,
    const float* __restrict__ x, int lo, int hi, int B, int G, int q, int g,
    float4* red) {
  const float z = SR::zero();
  float4 acc = make_float4(z, z, z, z);
  const int n = (hi - lo) * B;
  const float* base = tiles + (size_t)lo * B * B + 4 * q;
#pragma unroll 4
  for (int k = g; k < n; k += G) {
    const int dt = k / B;
    const int i = k - dt * B;
    const float4 w =
        __ldg(reinterpret_cast<const float4*>(base + (size_t)k * B));
    const float xi = __ldg(x + (size_t)max(rows[lo + dt], 0) * B + i);
    acc.x = SR::mac(acc.x, xi, w.x);
    acc.y = SR::mac(acc.y, xi, w.y);
    acc.z = SR::mac(acc.z, xi, w.z);
    acc.w = SR::mac(acc.w, xi, w.w);
  }
  const int nq = B / 4;
  red[g * nq + q] = acc;
  __syncthreads();
  float4 y = red[q];
  if (g == 0) {
    for (int k = 1; k < G; ++k) y = add4<SR>(y, red[k * nq + q]);
  }
  return y;
}

}  // namespace semiring_kernels
