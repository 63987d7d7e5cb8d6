// Blocked semiring SpMV for all partitions in one launch (sm_90a).
//
//   y[p, c*B + j] = add over the tiles t of the run of (p, c), over i, of
//                   mul(x[p', rows[p,t]*B + i], tiles[p,t,i,j])
//
// Replaces the TPU kernel spmv_blocked_pallas
// (src/repro/kernels/semiring_spmm/kernel.py:80).  p' = p, or 0 when x is
// shared by every partition (x_pstride == 0, the boundary consume).  The
// runs, and ``nnz``'s cap on a packed list, come from the walk plan
// (walk_plan.py): one CTA per chunk of a run, grid (W).  Blocks with an
// empty run get the semiring zero.
//
// What bounds it on an H100: bytes.  Each valid tile is read once and
// does B multiply-adds (or add-mins) per 4-byte weight, 0.5 operation a
// byte against about 20 float32 operations per byte of HBM bandwidth.
// At TR_SMALL (8 partitions, B = 64) the local sweep moves about 82 MB
// and the boundary consume about 185 MB: 0.0245 and 0.0553 ms at
// 3.35 TB/s.  What the design does about it (blocked_walk.cuh): the work
// list spreads the tile bytes evenly over all SMs whatever the skew of
// the runs, TMA bulk copies keep 64 KB of tiles in flight per CTA with
// no registers spent on them, and the run's chunks are combined in a
// fixed order in the same launch.
// B must be a multiple of 4 and at most 1,024; tiles and y 16-byte
// aligned.
#include "blocked_walk.cuh"

namespace semiring_kernels {

template <class SR>
__global__ void __launch_bounds__(kThreads) spmv_blocked_kernel(
    const float* __restrict__ tiles, const int* __restrict__ rows,
    const float* __restrict__ x, Plan plan, float* __restrict__ y, int T,
    Walk wk, long long x_pstride, int n_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int w = blockIdx.x;
  const int4 ch = plan.chunks[w];  // (p, c, t0, t1)
  if (ch.y < 0) return;            // padding row of the work list
  const int p = ch.x, pc = p * n_out + ch.y;
  float4 v = fold_chunk<SR>(wk, tiles, rows, x + p * x_pstride, p, ch.z,
                            ch.w, T, smem);
  if (!finish_run<SR>(wk, plan, w, pc, v)) return;
  const int q = threadIdx.x % wk.nq;
  if (threadIdx.x < wk.nq) {
    reinterpret_cast<float4*>(y + (size_t)pc * wk.B)[q] = v;
  }
}

template <class SR>
int launch_spmv(const float* t, const int* r, const float* x, Plan plan,
                float* y, int T, Walk wk, long long x_pstride, int n_out,
                int W, cudaStream_t s) {
  const size_t smem = wk.smem_bytes();
  static size_t allowed = 0;
  const int err = allow_smem(spmv_blocked_kernel<SR>, smem, allowed);
  if (err) return err;
  spmv_blocked_kernel<SR><<<W, wk.threads(), smem, s>>>(
      t, r, x, plan, y, T, wk, x_pstride, n_out);
  return (int)cudaGetLastError();
}

}  // namespace semiring_kernels

// C entry point (bound with ctypes).  The plan: ``chunks`` (W, 4),
// ``first``/``count``/``counters`` (P * n_out), ``partials`` scratch of
// W * B floats.  semiring: 0 = min_plus, 1 = plus_mul.  Returns
// cudaGetLastError() after the launch.
extern "C" int spmv_blocked_f32(const void* tiles, const void* rows,
                                const void* x, const void* chunks,
                                const void* first, const void* count,
                                void* counters, void* partials, void* y,
                                int T, int B, int W, int chunk,
                                long long x_pstride, int n_out,
                                int semiring, void* stream) {
  using namespace semiring_kernels;
  if (B <= 0 || B % 4 != 0 || B > 4 * kThreads || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  if (W == 0) return 0;
  const Walk wk = Walk::make(B, chunk);
  const Plan plan{(const int4*)chunks, (const int*)first, (const int*)count,
                  (int*)counters, (float4*)partials};
  const auto* t = (const float*)tiles;
  const auto* r = (const int*)rows;
  const auto* xx = (const float*)x;
  auto* yy = (float*)y;
  cudaStream_t s = (cudaStream_t)stream;
  if (semiring == 0)
    return launch_spmv<MinPlus>(t, r, xx, plan, yy, T, wk, x_pstride, n_out,
                                W, s);
  if (semiring == 1)
    return launch_spmv<PlusMul>(t, r, xx, plan, yy, T, wk, x_pstride, n_out,
                                W, s);
  return (int)cudaErrorInvalidValue;
}

// Message for a code returned by the entry points above.
extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
