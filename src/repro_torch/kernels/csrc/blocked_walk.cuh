// Device code shared by the two semiring kernels (semiring_spmm.cu and
// semiring_superstep.cu): the two semirings, the walk of one chunk of a
// run of tiles, and the fixed-order combine of a run's chunks.
//
// Layout (the blocked graph's, see repro_torch/core/blocked.py):
//   tiles (P, T, B, B) float32   tile[t, i, j] = weight of edge
//                                (rows[t]*B + i) -> (cols[t]*B + j)
//   rows (P, T) int32            row block of each tile
//
// Every output block c of a partition owns one contiguous run of its
// column-sorted tile list.  The walk plan (repro_torch/kernels/
// walk_plan.py) cuts each run into chunks of at most ``chunk`` tiles and
// lists them as rows (p, c, t0, t1); one CTA folds one chunk:
//
// 1. Thread 0 initialises one mbarrier per stage of a ring in shared
//    memory and issues the chunk's first kStages stages as TMA bulk
//    copies (cp.async.bulk ... mbarrier::complete_tx::bytes).  The tiles
//    t0..t1 are contiguous in memory, so the chunk is one stream of
//    (t1 - t0) * B rows of B floats; a stage is kStageBytes of it, whole
//    rows, whatever B is (several tiles at small B, part of one at
//    large B).  The copies mark the tiles evict-first in L2: they are
//    read once.
// 2. Meanwhile the threads gather the chunk's x values, x[rows[t]*B + i]
//    for each of its tile rows, into shared memory, once.
// 3. Thread (q, g) — q a column quad, g one of G row groups — waits on
//    each stage's mbarrier in turn and folds the stage's rows g, g+G, ...
//    into four columns held in registers.  After the stage is consumed,
//    thread 0 refills it with the stage kStages ahead.
// 4. The G partials are combined in order 0..G-1 through shared memory.
//
// A run of one chunk is then written by its CTA.  A run of several:
// each CTA stores its partial (B floats) to scratch, fences, and takes a
// ticket from the run's counter; the CTA with the last ticket folds the
// run's partials in chunk order and finishes the block, and resets the
// counter to zero for the next launch.  So every order of summation is
// fixed by the plan and B alone: plus-mul is the same from run to run and
// between the two kernels, min-plus is exact.
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

// Threads per CTA (at most; B/4 * G of them run), ring stages and stage
// size.  Four 16 KB stages keep 64 KB of tile bytes in flight per CTA,
// and three such CTAs fit one SM's shared memory.
constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kStageBytes = 16384;

// The walk plan's device arrays (see walk_plan.py) and the scratch of the
// multi-chunk combine.
struct Plan {
  const int4* chunks;    // (W) rows (p, c, t0, t1); c < 0 = padding
  const int* first;      // (P * n_out) first chunk of each run
  const int* count;      // (P * n_out) chunks of each run
  int* counters;         // (P * n_out) tickets, zero between launches
  float4* partials;      // (W, B/4) partial of each chunk
};

// Geometry of a launch, the same on host and device.
struct Walk {
  int B, nq, G, chunk;
  __host__ __device__ static Walk make(int B, int chunk) {
    Walk w;
    w.B = B;
    w.nq = B / 4;
    w.G = kThreads / w.nq;
    w.chunk = chunk;
    return w;
  }
  __host__ __device__ int threads() const { return nq * G; }
  __host__ __device__ int stage_rows() const { return kStageBytes / (4 * B); }
  // ring | x values of a chunk | G partials | one mbarrier per stage
  __host__ __device__ size_t x_offset() const {
    return (size_t)kStages * kStageBytes;
  }
  __host__ __device__ size_t red_offset() const {
    return x_offset() + (((size_t)chunk * B * 4 + 15) & ~(size_t)15);
  }
  __host__ __device__ size_t bar_offset() const {
    return red_offset() + (size_t)G * nq * sizeof(float4);
  }
  __host__ __device__ size_t smem_bytes() const {
    return bar_offset() + kStages * sizeof(uint64_t);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Bulk copy of ``bytes`` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory; completion is counted on ``bar``,
// which expects it.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  // tiles are read once per launch: evict them from L2 first, so that
  // x, the partials and the states stay
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar)),
      "l"(policy)
      : "memory");
}

// Fold of one chunk: tiles [t0, t1) of partition p against x (this
// partition's x, or the shared one).  Every thread of the CTA must call
// this (it synchronises).  The result is valid on the threads with
// g == 0: thread (q, 0) holds output columns 4q..4q+3.
template <class SR>
__device__ __forceinline__ float4 fold_chunk(
    const Walk& wk, const float* __restrict__ tiles,
    const int* __restrict__ rows, const float* __restrict__ x, int p,
    int t0, int t1, int T, unsigned char* smem) {
  const int B = wk.B, nq = wk.nq, G = wk.G;
  const int tid = threadIdx.x, q = tid % nq, g = tid / nq;
  float* ring = reinterpret_cast<float*>(smem);
  float* xs = reinterpret_cast<float*>(smem + wk.x_offset());
  float4* red = reinterpret_cast<float4*>(smem + wk.red_offset());
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + wk.bar_offset());
  const int n_rows = (t1 - t0) * B;
  const int srows = wk.stage_rows();
  const int n_stages = (n_rows + srows - 1) / srows;
  const float* src = tiles + ((size_t)p * T + t0) * B * B;
  constexpr int kStageFloats = kStageBytes / 4;

  auto issue = [&](int s) {  // stage s into slot s % kStages
    const int r0 = s * srows;
    const int nr = min(srows, n_rows - r0);
    bulk_load(ring + (s % kStages) * kStageFloats, src + (size_t)r0 * B,
              (uint32_t)nr * B * 4, &bar[s % kStages]);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int s = 0; s < min(kStages, n_stages); ++s) issue(s);
  }
  // x values of every tile row of the chunk, once
  const int* rw = rows + (size_t)p * T + t0;
  for (int e = tid; e < n_rows; e += blockDim.x) {
    const int j = e / B;
    xs[e] = __ldg(x + (size_t)max(__ldg(rw + j), 0) * B + (e - j * B));
  }
  __syncthreads();  // xs and the barriers are ready

  const float z = SR::zero();
  float4 acc = make_float4(z, z, z, z);
  for (int s = 0; s < n_stages; ++s) {
    const int slot = s % kStages;
    while (!mbar_try_wait(&bar[slot], (s / kStages) & 1)) {
    }
    const int r0 = s * srows;
    const int nr = min(srows, n_rows - r0);
    const float* st = ring + slot * kStageFloats + 4 * q;
    const float* xr = xs + r0;
#pragma unroll 4
    for (int k = g; k < nr; k += G) {
      const float4 w = *reinterpret_cast<const float4*>(st + k * B);
      const float xi = xr[k];
      acc.x = SR::mac(acc.x, xi, w.x);
      acc.y = SR::mac(acc.y, xi, w.y);
      acc.z = SR::mac(acc.z, xi, w.z);
      acc.w = SR::mac(acc.w, xi, w.w);
    }
    __syncthreads();  // every thread is done with this slot
    if (tid == 0 && s + kStages < n_stages) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(s + kStages);
    }
  }
  red[g * nq + q] = acc;
  __syncthreads();
  float4 y = red[q];
  if (g == 0) {
    for (int k = 1; k < G; ++k) y = add4<SR>(y, red[k * nq + q]);
  }
  return y;
}

// After fold_chunk on chunk w of run pc: returns true on the one CTA
// that finishes the run, with the run's fold in ``y`` (threads g == 0);
// false on the others, which must then return.  Every thread of the CTA
// must call this.
template <class SR>
__device__ __forceinline__ bool finish_run(const Walk& wk, const Plan& plan,
                                           int w, int pc, float4& y) {
  const int n = plan.count[pc];
  if (n == 1) return true;
  __shared__ int last;
  const int tid = threadIdx.x, q = tid % wk.nq, g = tid / wk.nq;
  if (g == 0) plan.partials[(size_t)w * wk.nq + q] = y;
  __threadfence();  // the partial is visible before the ticket is taken
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(plan.counters + pc, 1) == n - 1;
    if (last) plan.counters[pc] = 0;  // every other ticket is taken
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  if (g == 0) {
    const float4* part = plan.partials + (size_t)plan.first[pc] * wk.nq + q;
    y = __ldcg(part);
    for (int k = 1; k < n; ++k) y = add4<SR>(y, __ldcg(part + (size_t)k * wk.nq));
  }
  return true;
}

// Allows ``kernel`` the dynamic shared memory ``bytes`` (above 48 KB it
// must be asked for).  ``allowed`` is the caller's record of what this
// kernel was allowed so far, so the attribute is set only when a launch
// needs more (never, in particular, inside a CUDA graph capture that
// follows a first eager call).  Returns a CUDA error code.
template <class K>
inline int allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == 0) allowed = bytes;
  return err;
}

}  // namespace semiring_kernels
