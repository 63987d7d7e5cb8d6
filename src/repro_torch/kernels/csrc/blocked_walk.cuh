// Device code shared by the two semiring kernels (semiring_spmm.cu and
// semiring_superstep.cu): the two semirings, the walk of one chunk of a
// run of tiles for every lane of the query axis, and the fixed-order
// combine of a run's chunks.
//
// Layout (the blocked graph's, see repro_torch/core/blocked.py):
//   tiles (P, T, B, B) float32   tile[t, i, j] = weight of edge
//                                (rows[t]*B + i) -> (cols[t]*B + j)
//   rows (P, T) int32            row block of each tile
//   x     Q lanes of (P or 1, nvb*B) float32, the lane stride and the
//         partition stride given apart (0 = one x shared by partitions)
//
// Every output block c of a partition owns one contiguous run of its
// column-sorted tile list.  The walk plan (repro_torch/kernels/
// walk_plan.py) cuts each run into chunks of at most ``chunk`` tiles and
// lists them as rows (p, c, t0, t1); one CTA folds one chunk for all Q
// lanes, L lanes at a time (a lane group; L = 1, 4 or 8, see lane_group):
//
// 1. Thread 0 initialises one mbarrier per stage of a ring in shared
//    memory and issues the first kStages stages as TMA bulk copies
//    (cp.async.bulk ... mbarrier::complete_tx::bytes).  The tiles t0..t1
//    are contiguous in memory, so the chunk is one stream of (t1 - t0) * B
//    rows of B floats; a stage is kStageBytes of it, whole rows, whatever
//    B is.  The walk is the chunk's stream once per lane group, one
//    sequence of stages: the ring runs on from one group's last stage
//    into the next group's first, so a group's tiles are in flight while
//    the previous group folds.  A chunk walked once marks its tiles
//    evict-first in L2 (they are read once); walked by several groups,
//    evict-normal, so that the later groups find them in L2.
// 2. Before each group, the threads gather the chunk's x values for the
//    group's L lanes, x[lane][rows[t]*B + i] for each tile row, into
//    shared memory, lanes innermost.
// 3. Thread (q, g) — q a column quad, g one of G row groups — waits on
//    each stage's mbarrier in turn and folds the stage's rows g, g+G, ...
//    into four columns of each of the L lanes, held in registers (4 L
//    floats).  Each weight read from shared memory serves L lanes.
//    After a stage is consumed, thread 0 refills its slot kStages ahead.
// 4. The G partials of each lane are combined in order 0..G-1 through
//    shared memory.
//
// A run of one chunk is then finished by its CTA, group by group.  A run
// of several: each CTA stores its partials (Q x B floats) to scratch,
// fences, and takes a ticket from the run's counter; the CTA with the
// last ticket folds the run's partials in chunk order for every lane and
// finishes the block, and resets the counter to zero for the next launch.
// The tickets count CTAs, one per chunk whatever Q is, so they keep the
// plan's (P, n_out) shape.  Every order of summation is fixed by the plan
// and B alone, the same for every lane and every Q: plus-mul is the same
// from run to run, between the two kernels, and between a lane of a
// batch and the same state run alone; min-plus is exact.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace semiring_kernels {

using namespace hopper;  // mbarriers, allow_smem

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
// size.  Four 16 KB stages keep 64 KB of tile bytes in flight per CTA.
constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kStageBytes = 16384;

// Lanes folded together (the lane group) for Q lanes: one for a single
// state, four up to four lanes, else eight.  Eight lanes hold 32 float
// accumulators a thread, and at B = 64 (chunks of 8 tiles) a CTA takes
// 112 KB of shared memory (64 KB ring, 16 KB of x values, 32 KB of lane
// partials): two CTAs an SM.  Sixteen would hold 64 accumulators and take
// 160 KB, one CTA an SM.  walk_plan.lane_group is the same rule.
__host__ __device__ inline int lane_group(int Q) {
  return Q <= 1 ? 1 : (Q <= 4 ? 4 : 8);
}

// The walk plan's device arrays (see walk_plan.py) and the scratch of the
// multi-chunk combine.
struct Plan {
  const int4* chunks;  // (W) rows (p, c, t0, t1); c < 0 = padding
  const int* first;    // (P * n_out) first chunk of each run
  const int* count;    // (P * n_out) chunks of each run
  int* counters;       // (P * n_out) tickets, zero between launches
  float4* partials;    // (W, Q, B/4) partial of each chunk and lane
};

// The query axis of a launch: Q lanes, and where each lane's x starts.
struct Lanes {
  int Q;
  long long x_lstride;  // floats between two lanes of x
  long long x_pstride;  // floats between two partitions of x; 0 = shared
};

// Geometry of a launch, the same on host and device.
struct Walk {
  int B, nq, G, chunk, L;
  __host__ __device__ static Walk make(int B, int chunk, int L) {
    Walk w;
    w.B = B;
    w.nq = B / 4;
    w.G = kThreads / w.nq;
    w.chunk = chunk;
    w.L = L;
    return w;
  }
  __host__ __device__ int threads() const { return nq * G; }
  __host__ __device__ int stage_rows() const { return kStageBytes / (4 * B); }
  // ring | x values of a chunk, L lanes | L x G partials | L vote flags |
  // one mbarrier per stage
  __host__ __device__ size_t x_offset() const {
    return (size_t)kStages * kStageBytes;
  }
  __host__ __device__ size_t red_offset() const {
    return x_offset() + (((size_t)chunk * B * L * 4 + 15) & ~(size_t)15);
  }
  __host__ __device__ size_t flag_offset() const {
    return red_offset() + (size_t)L * G * nq * sizeof(float4);
  }
  __host__ __device__ size_t bar_offset() const {
    return flag_offset() + (((size_t)L * 4 + 7) & ~(size_t)7);
  }
  __host__ __device__ size_t smem_bytes() const {
    return bar_offset() + kStages * sizeof(uint64_t);
  }
};

// One chunk of the walk plan, for every lane: fold, then finish the run
// (directly, or through the partials and the run's ticket).  ``epi`` is
// called for every (lane, column quad) of the finished block as
// ``epi(lane0, l, q, y, valid, flags)``, lane ``lane0 + l`` of the group
// that starts at ``lane0``, by every thread of the CTA the same number of
// times (so it may synchronise); ``valid`` is false on threads that hold
// no lane.  ``flags`` is an L-int shared array, zero on entry and on
// return, that an epilogue may use for a per-lane vote (see
// semiring_superstep.cu).
template <class SR, int L, class Epi>
__device__ __forceinline__ void walk_chunk(
    const Walk& wk, const Plan& plan, const float* __restrict__ tiles,
    const int* __restrict__ rows, const float* __restrict__ x, Lanes ln,
    int T, int n_out, unsigned char* smem, Epi& epi) {
  const int w = blockIdx.x;
  const int4 ch = plan.chunks[w];  // (p, c, t0, t1)
  if (ch.y < 0) return;            // padding row of the work list
  const int p = ch.x, pc = p * n_out + ch.y, t0 = ch.z, t1 = ch.w;
  const int B = wk.B, nq = wk.nq, G = wk.G, Q = ln.Q;
  const int tid = threadIdx.x, q = tid % nq, g = tid / nq;
  float* ring = reinterpret_cast<float*>(smem);
  float* xs = reinterpret_cast<float*>(smem + wk.x_offset());
  float4* red = reinterpret_cast<float4*>(smem + wk.red_offset());
  int* flags = reinterpret_cast<int*>(smem + wk.flag_offset());
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + wk.bar_offset());
  const int n_rows = (t1 - t0) * B;
  const int srows = wk.stage_rows();
  const int n_stages = (n_rows + srows - 1) / srows;
  const int n_groups = (Q + L - 1) / L;
  const int total = n_stages * n_groups;  // stages of the whole walk
  const float* src = tiles + ((size_t)p * T + t0) * B * B;
  constexpr int kStageFloats = kStageBytes / 4;

  uint64_t policy;
  if (n_groups == 1) {
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
  } else {
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n"
                 : "=l"(policy));
  }
  auto issue = [&](int s) {  // walk stage s into slot s % kStages
    const int r0 = (s % n_stages) * srows;
    const int nr = min(srows, n_rows - r0);
    bulk_load(ring + (s % kStages) * kStageFloats, src + (size_t)r0 * B,
              (uint32_t)nr * B * 4, &bar[s % kStages], policy);
  };
  if (tid < L) flags[tid] = 0;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s], 1);
    mbar_init_fence();
    for (int s = 0; s < min(kStages, total); ++s) issue(s);
  }
  const int* rw = rows + (size_t)p * T + t0;
  const float* xp = x + p * ln.x_pstride;
  const int n_done = plan.count[pc];
  float4* part = plan.partials + (size_t)w * Q * nq;

  for (int grp = 0; grp < n_groups; ++grp) {
    const int lane0 = grp * L;
    // x values of every tile row of the chunk for the group's lanes,
    // read lane by lane (coalesced), stored lanes innermost; the
    // previous group's last stage ended in a barrier, so xs is free
    for (int e = tid; e < n_rows * L; e += blockDim.x) {
      const int l = e / n_rows, r = e - l * n_rows, j = r / B;
      const int lane = lane0 + l;
      xs[r * L + l] = lane < Q
          ? __ldg(xp + lane * ln.x_lstride
                  + (size_t)max(__ldg(rw + j), 0) * B + (r - j * B))
          : SR::zero();
    }
    __syncthreads();  // xs (and, first time, the barriers) are ready

    const float z = SR::zero();
    float4 acc[L];
#pragma unroll
    for (int l = 0; l < L; ++l) acc[l] = make_float4(z, z, z, z);
    for (int s = 0; s < n_stages; ++s) {
      const int sw = grp * n_stages + s;  // stage of the walk
      const int slot = sw % kStages;
      while (!mbar_try_wait(&bar[slot], (sw / kStages) & 1)) {
      }
      const int r0 = s * srows;
      const int nr = min(srows, n_rows - r0);
      const float* st = ring + slot * kStageFloats + 4 * q;
      const float* xr = xs + (size_t)r0 * L;
      constexpr int kUnroll = L == 1 ? 4 : 2;
#pragma unroll kUnroll
      for (int k = g; k < nr; k += G) {
        const float4 wt = *reinterpret_cast<const float4*>(st + k * B);
        float xv[L];
        if constexpr (L % 4 == 0) {
#pragma unroll
          for (int l = 0; l < L; l += 4) {
            const float4 v =
                *reinterpret_cast<const float4*>(xr + k * L + l);
            xv[l] = v.x;
            xv[l + 1] = v.y;
            xv[l + 2] = v.z;
            xv[l + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int l = 0; l < L; ++l) xv[l] = xr[k * L + l];
        }
#pragma unroll
        for (int l = 0; l < L; ++l) {
          acc[l].x = SR::mac(acc[l].x, xv[l], wt.x);
          acc[l].y = SR::mac(acc[l].y, xv[l], wt.y);
          acc[l].z = SR::mac(acc[l].z, xv[l], wt.z);
          acc[l].w = SR::mac(acc[l].w, xv[l], wt.w);
        }
      }
      __syncthreads();  // every thread is done with this slot
      if (tid == 0 && sw + kStages < total) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(sw + kStages);
      }
    }
#pragma unroll
    for (int l = 0; l < L; ++l) red[(l * G + g) * nq + q] = acc[l];
    __syncthreads();
    // lane l of the group is combined (G partials, in order) and then
    // held by the threads with g == l % G
    for (int l0 = 0; l0 < L; l0 += G) {
      const int l = l0 + g;
      const bool valid = l < L && lane0 + l < Q;
      float4 y = make_float4(z, z, z, z);
      if (valid) {
        y = red[(l * G) * nq + q];
        for (int k = 1; k < G; ++k) y = add4<SR>(y, red[(l * G + k) * nq + q]);
      }
      if (n_done == 1) {
        epi(lane0, l, q, y, valid, flags);
      } else if (valid) {
        part[(size_t)(lane0 + l) * nq + q] = y;
      }
    }
    __syncthreads();  // red is free for the next group
  }
  if (n_done == 1) return;

  // a run of several chunks: the last CTA to finish folds them in order
  __shared__ int last;
  __threadfence();  // the partials are visible before the ticket is taken
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(plan.counters + pc, 1) == n_done - 1;
    if (last) plan.counters[pc] = 0;  // every other ticket is taken
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float4* run = plan.partials + (size_t)plan.first[pc] * Q * nq;
  for (int grp = 0; grp < n_groups; ++grp) {
    for (int l0 = 0; l0 < L; l0 += G) {
      const int l = l0 + g, lane = grp * L + l;
      const bool valid = l < L && lane < Q;
      const float z = SR::zero();
      float4 y = make_float4(z, z, z, z);
      if (valid) {
        const float4* pl = run + (size_t)lane * nq + q;
        y = __ldcg(pl);
        for (int k = 1; k < n_done; ++k)
          y = add4<SR>(y, __ldcg(pl + (size_t)k * Q * nq));
      }
      epi(grp * L, l, q, y, valid, flags);
    }
  }
}

}  // namespace semiring_kernels
