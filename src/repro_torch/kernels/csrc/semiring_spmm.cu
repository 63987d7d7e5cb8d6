// Blocked semiring SpMV for all partitions and all lanes of the query
// axis in one launch (sm_90a).
//
//   y[l, p, c*B + j] = add over the tiles t of the run of (p, c), over i,
//                      of mul(x[l, p', rows[p,t]*B + i], tiles[p,t,i,j])
//
// Replaces the TPU kernel spmv_blocked_pallas
// (src/repro/kernels/semiring_spmm/kernel.py:80), which the reference
// vmaps over partitions and, under the query axis, over Q lanes.  p' = p,
// or 0 when x is shared by every partition (x_pstride == 0, the boundary
// consume); the lane stride of x is separate (the consume's shared
// boundary is shared by partitions, not by lanes).  The runs, and
// ``nnz``'s cap on a packed list, come from the walk plan (walk_plan.py):
// one CTA per chunk of a run, grid (W), every lane folded by that CTA.
// Blocks with an empty run get the semiring zero.
//
// What bounds it on an H100: for one lane, bytes.  Each valid tile is
// read once and does B multiply-adds (or add-mins) per 4-byte weight, 0.5
// operation a byte against about 20 float32 operations per byte of HBM
// bandwidth; at TR_SMALL (8 partitions, B = 64) the local sweep moves
// about 82 MB and the boundary consume about 185 MB: 0.0245 and 0.0553 ms
// at 3.35 TB/s.  Q lanes do Q times the operations on the same tile
// bytes, so at Q = 32 the operations bound it (about 0.04 ms of the
// card's float32 rate for the local sweep).  What the design does about
// it (blocked_walk.cuh): the work list spreads the tile bytes evenly over
// all SMs whatever the skew of the runs, TMA bulk copies keep 48-64 KB of
// tiles in flight per CTA with no registers spent on them, and the run's
// chunks are combined in a fixed order in the same launch.  Plus-mul
// calls and min-plus calls of fewer than kLaneWalkMin lanes take the
// group walk: each weight read from shared memory serves a lane group of
// up to 8 lanes, a chunk walked once per group (later groups find it in
// L2).  Min-plus calls of more lanes take the lane walk: the chunk
// streams from HBM once for the up to 32 lanes of a pass, each thread
// folding 16 (lane, column) outputs with an add and one min.NaN a pair.
// B must be a multiple of 4 and at most 1,024; tiles and y 16-byte
// aligned.
#include "blocked_walk.cuh"

namespace semiring_kernels {

// Writes lane l's block of y, (Q, P, n_out*B) contiguous.
struct SpmvOut {
  float* y;
  long long y_lstride;  // P * n_out * B
  int B, pc;
  __device__ __forceinline__ void operator()(int lane0, int l, int q,
                                             float4 v, bool valid, int*) {
    if (valid) {
      reinterpret_cast<float4*>(y + (lane0 + l) * y_lstride +
                                (size_t)pc * B)[q] = v;
    }
  }
};

template <class SR, int L>
__global__ void __launch_bounds__(kThreads) spmv_blocked_kernel(
    const float* __restrict__ tiles, const int* __restrict__ rows,
    const float* __restrict__ x, Plan plan, float* __restrict__ y, int T,
    Walk wk, Lanes ln, long long y_lstride, int n_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int4 ch = plan.chunks[blockIdx.x];
  SpmvOut out{y, y_lstride, wk.B, ch.x * n_out + ch.y};
  walk_chunk<SR, L>(wk, plan, tiles, rows, x, ln, T, n_out, smem, out);
}

template <class SR, int L>
int launch_spmv(const float* t, const int* r, const float* x, Plan plan,
                float* y, int T, Walk wk, Lanes ln, long long y_lstride,
                int n_out, int W, cudaStream_t s) {
  const size_t smem = wk.smem_bytes();
  static size_t allowed = 0;
  const int err = allow_smem(spmv_blocked_kernel<SR, L>, smem, allowed);
  if (err) return err;
  spmv_blocked_kernel<SR, L><<<W, wk.threads(), smem, s>>>(
      t, r, x, plan, y, T, wk, ln, y_lstride, n_out);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kLaneThreads, 2) spmv_lane_walk_kernel(
    const float* __restrict__ tiles, const int* __restrict__ rows,
    const float* __restrict__ x, Plan plan, float* __restrict__ y, int T,
    LaneWalk wk, Lanes ln, long long y_lstride, int n_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int4 ch = plan.chunks[blockIdx.x];
  SpmvOut out{y, y_lstride, wk.B, ch.x * n_out + ch.y};
  walk_chunk_lanes(wk, plan, tiles, rows, x, ln, T, n_out, smem, out);
}

int launch_spmv_lane_walk(const float* t, const int* r, const float* x,
                          Plan plan, float* y, int T, LaneWalk wk, Lanes ln,
                          long long y_lstride, int n_out, int W,
                          cudaStream_t s) {
  const size_t smem = wk.smem_bytes();
  static size_t allowed = 0;
  const int err = allow_lane_smem(spmv_lane_walk_kernel, smem, allowed);
  if (err) return err;
  spmv_lane_walk_kernel<<<W, wk.threads(), smem, s>>>(
      t, r, x, plan, y, T, wk, ln, y_lstride, n_out);
  return (int)cudaGetLastError();
}

template <class SR>
int launch_spmv_lanes(const float* t, const int* r, const float* x,
                      Plan plan, float* y, int T, Walk wk, Lanes ln,
                      long long y_lstride, int n_out, int W,
                      cudaStream_t s) {
  switch (wk.L) {
    case 1:
      return launch_spmv<SR, 1>(t, r, x, plan, y, T, wk, ln, y_lstride,
                                n_out, W, s);
    case 4:
      return launch_spmv<SR, 4>(t, r, x, plan, y, T, wk, ln, y_lstride,
                                n_out, W, s);
    case 8:
      return launch_spmv<SR, 8>(t, r, x, plan, y, T, wk, ln, y_lstride,
                                n_out, W, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace semiring_kernels

// C entry point (bound with ctypes).  Q lanes: x lane l, partition p at
// x + l * x_lstride + p * x_pstride (x_pstride 0 = shared by partitions);
// y (Q, P, n_out * B) contiguous.  The plan: ``chunks`` (W, 4),
// ``first``/``count``/``counters`` (P * n_out), ``partials`` scratch of
// W * Q * B floats.  semiring: 0 = min_plus, 1 = plus_mul.  walk: the
// walk the caller expects, walk_of(Q, semiring == 0) (0 = group walk, 1
// = lane walk); another is refused.  Returns cudaGetLastError() after
// the launch.
extern "C" int spmv_blocked_f32(const void* tiles, const void* rows,
                                const void* x, const void* chunks,
                                const void* first, const void* count,
                                void* counters, void* partials, void* y,
                                int T, int B, int W, int chunk, int P,
                                int Q, long long x_lstride,
                                long long x_pstride, int n_out,
                                int semiring, int walk, void* stream) {
  using namespace semiring_kernels;
  if (B <= 0 || B % 4 != 0 || B > 4 * kThreads || chunk <= 0 || Q <= 0 ||
      (semiring != 0 && semiring != 1) || walk != walk_of(Q, semiring == 0))
    return (int)cudaErrorInvalidValue;
  if (W == 0) return 0;
  const Plan plan{(const int4*)chunks, (const int*)first, (const int*)count,
                  (int*)counters, (float4*)partials};
  const Lanes ln{Q, x_lstride, x_pstride};
  const long long y_lstride = (long long)P * n_out * B;
  const auto* t = (const float*)tiles;
  const auto* r = (const int*)rows;
  const auto* xx = (const float*)x;
  auto* yy = (float*)y;
  cudaStream_t s = (cudaStream_t)stream;
  if (walk == 1) {
    LaneWalk lw = LaneWalk::make(B, chunk, Q);
    lw.x_vec = (uintptr_t)x % 16 == 0 && x_lstride % 4 == 0 &&
               x_pstride % 4 == 0;
    if (!lw.valid()) return (int)cudaErrorInvalidValue;
    return launch_spmv_lane_walk(t, r, xx, plan, yy, T, lw, ln, y_lstride,
                                 n_out, W, s);
  }
  const Walk wk = Walk::make(B, chunk, lane_group(Q));
  if (semiring == 0)
    return launch_spmv_lanes<MinPlus>(t, r, xx, plan, yy, T, wk, ln,
                                      y_lstride, n_out, W, s);
  return launch_spmv_lanes<PlusMul>(t, r, xx, plan, yy, T, wk, ln,
                                    y_lstride, n_out, W, s);
}

// Message for a code returned by the entry points above.
extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
