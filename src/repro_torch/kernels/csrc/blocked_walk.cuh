// Device code shared by the two semiring kernels (semiring_spmm.cu and
// semiring_superstep.cu): the two semirings, the walks of one chunk of a
// run of tiles for every lane of the query axis (the group walk below;
// for min-plus calls of kLaneWalkMin lanes or more, the lane walk further
// down), and the fixed-order combine of a run's chunks.
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

// (min, +).  ``add`` is one instruction, min.NaN.f32 (sm_80+): NaN if
// either operand is NaN, as jnp.minimum (fminf would drop a NaN operand),
// and -0 below +0 whatever the order, as jnp.minimum and jnp.min, so that
// no fold order changes a bit of the result.
struct MinPlus {
  static __device__ __forceinline__ float zero() {
    return __int_as_float(0x7f800000);  // +inf
  }
  static __device__ __forceinline__ float add(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
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

// ---------------------------------------------------------------------------
// The min-plus lane walk: one walk of each chunk for every lane.
//
// For min-plus calls with Q >= kLaneWalkMin lanes (walk_plan.walk_form
// decides, the C entry points check).  The group walk above re-walks a
// chunk once per group of 8 lanes (the later walks from L2) and folds its
// rows in G row groups whose partials meet in a 32 KB array.  Here a CTA
// folds its chunk for a pass of up to kMaxPassLanes lanes from one walk
// of the tiles:
//
// 1. The threads copy the chunk's x values of the pass's Lp lanes into
//    shared memory, lane-major (lane l's rows at xs[l * NR ...], NR the
//    chunk's rows padded to an odd number of float4s, so that the lanes
//    of one warp fall in different banks): thread (cq, lq, g) copies
//    column quad cq of lanes 4 lq .. 4 lq + 3 of tiles g, g + G, ..., a
//    float4 load each where x is 16-byte aligned in every lane and
//    partition; no integer division.
// 2. The tiles stream once through a ring of kLaneStages TMA stages
//    (evict-first when one pass walks the chunk).  A stage is whole rows,
//    a multiple of four.
// 3. Thread (cq, lq, g) owns 16 outputs in registers: columns 4 cq ..
//    4 cq + 3 of lanes 4 lq .. 4 lq + 3.  For each quad of rows of the
//    stage (quads g, g + G, ...: G row groups fill the CTA when the lanes
//    are few) it reads four float4 of x (four rows of one lane each) and
//    four float4 of weights (one row each), and folds 64 pairs, an add
//    and a min.NaN each.
// 4. When G > 1, the row groups' partials meet through shared memory (the
//    x array, free once the pass is folded); group 0 finishes them.
// The multi-chunk combine and the run tickets are the group walk's: the
// last CTA of a run folds the run's partials (W, Q, B) in chunk order.
// Min is exact and min.NaN orders -0 below +0, so no order of the fold
// changes a bit: every lane equals its one-lane walk.

constexpr int kLaneWalkMin = 5;  // walk_plan.LANE_WALK_MIN
// threads of a lane-walk CTA at most (walk_plan.LANE_THREADS)
constexpr int kLaneThreads = 256;
constexpr int kLaneStages = 3;
constexpr int kMaxPassLanes = 32;
// x values of one pass (floats): 32 lanes of a 512-row chunk (B = 64, 8
// tiles) padded to 516 rows.  With three 16 KB stages a CTA takes 113 KB
// of shared memory: two CTAs an SM.  walk_plan.LANE_X_FLOATS.
constexpr int kLaneXFloats = 16512;

// Geometry of a lane walk, the same on host and device
// (walk_plan.lane_walk mirrors make).  valid() is false when not even
// four lanes of a chunk fit kLaneXFloats.  x_vec: x is 16-byte aligned in
// every lane and partition (the caller sets it).
struct LaneWalk {
  int B, nq, chunk, NR, Lq, Lp, G, passes;
  bool x_vec;
  __host__ __device__ static LaneWalk make(int B, int chunk, int Q) {
    LaneWalk w;
    w.B = B;
    w.nq = B / 4;
    w.chunk = chunk;
    w.NR = ((chunk * B / 4) | 1) * 4;
    int lq = kLaneThreads / w.nq;
    lq = lq < kMaxPassLanes / 4 ? lq : kMaxPassLanes / 4;
    const int fit = kLaneXFloats / (4 * w.NR);
    lq = lq < fit ? lq : fit;
    const int quads = (Q + 3) / 4;
    w.passes = lq > 0 ? (quads + lq - 1) / lq : 0;
    w.Lq = w.passes > 0 ? (quads + w.passes - 1) / w.passes : 0;
    w.Lp = 4 * w.Lq;
    w.G = w.Lq > 0 ? kLaneThreads / (w.nq * w.Lq) : 0;
    w.x_vec = false;
    return w;
  }
  __host__ __device__ bool valid() const { return passes > 0 && G > 0; }
  __host__ __device__ int threads() const { return nq * Lq * G; }
  // rows of a stage: whole rows of one 16 KB stage, a multiple of four
  __host__ __device__ int stage_rows() const {
    return (kStageBytes / (4 * B)) & ~3;
  }
  // floats of the x array: the pass's x values, or the row groups'
  // partials when those are more
  __host__ __device__ int x_floats() const {
    const int red = (G - 1) * nq * Lq * 16;
    return Lp * NR > red ? Lp * NR : red;
  }
  // ring | x values of the pass | Lp vote flags | one mbarrier per stage
  __host__ __device__ size_t x_offset() const {
    return (size_t)kLaneStages * kStageBytes;
  }
  __host__ __device__ size_t flag_offset() const {
    return x_offset() + (size_t)x_floats() * 4;
  }
  __host__ __device__ size_t bar_offset() const {
    return flag_offset() + (((size_t)Lp * 4 + 7) & ~(size_t)7);
  }
  __host__ __device__ size_t smem_bytes() const {
    return bar_offset() + kLaneStages * sizeof(uint64_t);
  }
};

// Allows a lane-walk kernel its dynamic shared memory and asks for the
// largest shared-memory carveout, so that two CTAs of 113 KB fit an SM;
// ``allowed`` as for allow_smem.
template <class K>
inline int allow_lane_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return 0;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err == 0)
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == 0) allowed = bytes;
  return err;
}

// The walk a launch takes (the ``walk`` argument of the C entry points):
// 0, the group walk (walk_chunk, lane_group(Q) lanes a group); 1, the
// min-plus lane walk.  The caller names it (walk_plan.walk_form); the
// entry points refuse a launch that names another walk than this rule.
__host__ __device__ inline int walk_of(int Q, bool min_plus) {
  return min_plus && Q >= kLaneWalkMin ? 1 : 0;
}

__device__ __forceinline__ float min_plus_mac(float acc, float x, float w) {
  return MinPlus::add(acc, x + w);
}

// One chunk of the walk plan for every lane, min-plus, Q >= kLaneWalkMin:
// fold, then finish the run as walk_chunk does.  ``epi`` as for
// walk_chunk, with the lanes of a pass in place of a group's: it is
// called four times per pass by every thread, ``flags`` holds Lp ints.
template <class Epi>
__device__ __forceinline__ void walk_chunk_lanes(
    const LaneWalk& wk, const Plan& plan, const float* __restrict__ tiles,
    const int* __restrict__ rows, const float* __restrict__ x, Lanes ln,
    int T, int n_out, unsigned char* smem, Epi& epi) {
  const int w = blockIdx.x;
  const int4 ch = plan.chunks[w];  // (p, c, t0, t1)
  if (ch.y < 0) return;            // padding row of the work list
  const int p = ch.x, pc = p * n_out + ch.y, t0 = ch.z, t1 = ch.w;
  const int B = wk.B, nq = wk.nq, Lq = wk.Lq, Lp = wk.Lp, G = wk.G;
  const int NR = wk.NR, Q = ln.Q;
  const int tid = threadIdx.x;
  const int cq = tid % nq, lq = (tid / nq) % Lq, g = tid / (nq * Lq);
  float* ring = reinterpret_cast<float*>(smem);
  float* xs = reinterpret_cast<float*>(smem + wk.x_offset());
  int* flags = reinterpret_cast<int*>(smem + wk.flag_offset());
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + wk.bar_offset());
  const int nt = t1 - t0, n_rows = nt * B;
  const int srows = wk.stage_rows();
  const int n_stages = (n_rows + srows - 1) / srows;
  const int total = n_stages * wk.passes;  // stages of the whole walk
  const float* src = tiles + ((size_t)p * T + t0) * B * B;
  constexpr int kStageFloats = kStageBytes / 4;

  uint64_t policy;
  if (wk.passes == 1) {
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
  } else {
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n"
                 : "=l"(policy));
  }
  auto issue = [&](int s) {  // walk stage s into slot s % kLaneStages
    const int r0 = (s % n_stages) * srows;
    const int nr = min(srows, n_rows - r0);
    bulk_load(ring + (s % kLaneStages) * kStageFloats, src + (size_t)r0 * B,
              (uint32_t)nr * B * 4, &bar[s % kLaneStages], policy);
  };
  if (tid < Lp) flags[tid] = 0;
  if (tid == 0) {
    for (int s = 0; s < kLaneStages; ++s) mbar_init(&bar[s], 1);
    mbar_init_fence();
    for (int s = 0; s < min(kLaneStages, total); ++s) issue(s);
  }
  const int* rw = rows + (size_t)p * T + t0;
  const float* xp = x + p * ln.x_pstride;
  const int n_done = plan.count[pc];
  float4* part = plan.partials + (size_t)w * Q * nq;
  const float z = MinPlus::zero();

  for (int pass = 0; pass < wk.passes; ++pass) {
    const int lane0 = pass * Lp;
    // 1. x values of the pass's lanes, coalesced along the columns; the
    // previous pass ended in a barrier, so xs is free
    for (int j = g; j < nt; j += G) {
      const size_t off = (size_t)max(__ldg(rw + j), 0) * B + 4 * cq;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = 4 * lq + i, lane = lane0 + l;
        float4 v = make_float4(z, z, z, z);
        if (lane < Q) {
          const float* xl = xp + lane * ln.x_lstride + off;
          v = wk.x_vec ? __ldg(reinterpret_cast<const float4*>(xl))
                       : make_float4(__ldg(xl), __ldg(xl + 1),
                                     __ldg(xl + 2), __ldg(xl + 3));
        }
        *reinterpret_cast<float4*>(xs + l * NR + j * B + 4 * cq) = v;
      }
    }
    __syncthreads();  // xs (and, first time, the barriers) are ready

    // 2-3. fold every stage of the chunk into 4 lanes x 4 columns
    float4 acc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = make_float4(z, z, z, z);
    const float* xl = xs + (4 * lq) * NR;
    for (int s = 0; s < n_stages; ++s) {
      const int sw = pass * n_stages + s;  // stage of the walk
      const int slot = sw % kLaneStages;
      mbar_wait(&bar[slot], (sw / kLaneStages) & 1);
      const int r0 = s * srows;
      const int nr = min(srows, n_rows - r0);
      const float* st = ring + slot * kStageFloats + 4 * cq;
      const float* xr = xl + r0;
#pragma unroll 2
      for (int k = 4 * g; k < nr; k += 4 * G) {
        float4 xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          xv[i] = *reinterpret_cast<const float4*>(xr + i * NR + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 wt = *reinterpret_cast<const float4*>(st + (k + j) * B);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float xj = j == 0 ? xv[i].x : j == 1 ? xv[i].y
                           : j == 2 ? xv[i].z : xv[i].w;
            acc[i].x = min_plus_mac(acc[i].x, xj, wt.x);
            acc[i].y = min_plus_mac(acc[i].y, xj, wt.y);
            acc[i].z = min_plus_mac(acc[i].z, xj, wt.z);
            acc[i].w = min_plus_mac(acc[i].w, xj, wt.w);
          }
        }
      }
      __syncthreads();  // every thread is done with this slot
      if (tid == 0 && sw + kLaneStages < total) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(sw + kLaneStages);
      }
    }

    // 4. the row groups' partials meet in xs (free: every stage of the
    // pass is folded), group 0 finishes them
    if (G > 1) {
      float4* red = reinterpret_cast<float4*>(xs);
      const int o = lq * nq + cq, n = Lq * nq;
      if (g > 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) red[((g - 1) * 4 + i) * n + o] = acc[i];
      }
      __syncthreads();
      if (g == 0) {
        for (int k = 0; k < G - 1; ++k) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i] = add4<MinPlus>(acc[i], red[(k * 4 + i) * n + o]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = 4 * lq + i;
      const bool valid = g == 0 && lane0 + l < Q;
      if (n_done == 1) {
        epi(lane0, l, cq, acc[i], valid, flags);
      } else if (valid) {
        part[(size_t)(lane0 + l) * nq + cq] = acc[i];
      }
    }
    __syncthreads();  // xs is free for the next pass
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
  for (int pass = 0; pass < wk.passes; ++pass) {
    const int lane0 = pass * Lp;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = 4 * lq + i, lane = lane0 + l;
      const bool valid = g == 0 && lane < Q;
      float4 y = make_float4(z, z, z, z);
      if (valid) {
        const float4* pl = run + (size_t)lane * nq + cq;
        y = __ldcg(pl);
        for (int k = 1; k < n_done; ++k)
          y = add4<MinPlus>(y, __ldcg(pl + (size_t)k * Q * nq));
      }
      epi(lane0, l, cq, y, valid, flags);
    }
  }
}

}  // namespace semiring_kernels
