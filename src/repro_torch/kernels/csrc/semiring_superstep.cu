// Fused superstep stage for all partitions in one launch (sm_90a).
//
// Per partition p and output block c (every c in 0..NVB-1):
//   y          = fold of A_p^T x_in over the run of tiles with cols == c
//   x_out[p,c] = add(x_comb[p,c], y)   if the run is non-empty
//              = x_comb[p,c]           otherwise
//   changed[p] |= any_j(vmask[p,c,j] && x_out[p,c,j] != x_ref[p,c,j])
//
// Replaces the TPU kernel fused_step_pallas
// (src/repro/kernels/semiring_superstep/kernel.py:142).  x_in is
// (P, NVBin, B), or (1, NVBin, B) shared by every partition
// (xin_pstride == 0, the boundary consume).  The vote covers every block,
// touched or not: in the consume shape x_comb differs from x_ref there.
// It is a block-wide OR (__syncthreads_or) and one atomicOr per voting
// CTA into ``changed``, which the caller zeroes before the launch.
//
// Two pointers may be null.  x_comb == nullptr combines with the semiring
// zero: x_out = y, and blocks with an empty run get the zero (the plain
// SpMV of PageRank's step).  changed == nullptr skips the vote, and x_ref
// and vmask are not read.
//
// What bounds it on an H100: bytes, as for the SpMV (semiring_spmm.cu):
// the valid tiles once plus the states, about 82 MB for the TR_SMALL
// local sweep and 185 MB for its boundary consume, 0.0245 and 0.0553 ms
// at 3.35 TB/s.  The design is the SpMV's walk (blocked_walk.cuh): one
// CTA per chunk of the walk plan, TMA bulk copies into a ring of stages,
// and a fixed-order combine of a run's chunks by the CTA that finishes
// the run; that CTA applies x_comb, writes x_out and votes.  Every block
// has at least one chunk (an empty run one empty chunk), so every block
// is written and votes.
// Grid (W), block (B/4, G) flattened; B must be a multiple of 4 and at
// most 1,024, the float tensors 16-byte aligned and vmask 4-byte aligned.
#include "blocked_walk.cuh"

namespace semiring_kernels {

template <class SR>
__global__ void __launch_bounds__(kThreads) fused_step_kernel(
    const float* __restrict__ tiles, const int* __restrict__ rows,
    const float* __restrict__ x_in, const float* __restrict__ x_comb,
    const float* __restrict__ x_ref, const uint8_t* __restrict__ vmask,
    float* __restrict__ x_out, int* __restrict__ changed, Plan plan, int T,
    Walk wk, long long xin_pstride, int nvb) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int w = blockIdx.x;
  const int4 ch = plan.chunks[w];  // (p, c, t0, t1)
  if (ch.y < 0) return;            // padding row of the work list
  const int p = ch.x, pc = p * nvb + ch.y;
  float4 v = fold_chunk<SR>(wk, tiles, rows, x_in + p * xin_pstride, p,
                            ch.z, ch.w, T, smem);
  if (!finish_run<SR>(wk, plan, w, pc, v)) return;
  // this CTA finishes block (p, c); a run of one chunk is empty iff its
  // chunk is
  const bool empty = ch.z == ch.w && plan.count[pc] == 1;
  const int tid = threadIdx.x;
  int vote = 0;
  if (tid < wk.nq) {
    const size_t o = (size_t)pc * wk.B + 4 * tid;
    float4 out = v;  // an empty run folds to the semiring zero
    if (x_comb != nullptr) {
      const float4 base = *reinterpret_cast<const float4*>(x_comb + o);
      out = empty ? base : add4<SR>(base, v);
    }
    *reinterpret_cast<float4*>(x_out + o) = out;
    if (changed != nullptr) {
      const float4 ref = *reinterpret_cast<const float4*>(x_ref + o);
      const uchar4 m = *reinterpret_cast<const uchar4*>(vmask + o);
      vote = (m.x && out.x != ref.x) || (m.y && out.y != ref.y) ||
             (m.z && out.z != ref.z) || (m.w && out.w != ref.w);
    }
  }
  if (changed == nullptr) return;  // the same for the whole grid
  if (__syncthreads_or(vote) && tid == 0) atomicOr(changed + p, 1);
}

template <class SR>
int launch_fused(const float* t, const int* r, const float* xi,
                 const float* xc, const float* xr, const uint8_t* vm,
                 float* xo, int* ch, Plan plan, int T, Walk wk,
                 long long xin_pstride, int nvb, int W, cudaStream_t s) {
  const size_t smem = wk.smem_bytes();
  static size_t allowed = 0;
  const int err = allow_smem(fused_step_kernel<SR>, smem, allowed);
  if (err) return err;
  fused_step_kernel<SR><<<W, wk.threads(), smem, s>>>(
      t, r, xi, xc, xr, vm, xo, ch, plan, T, wk, xin_pstride, nvb);
  return (int)cudaGetLastError();
}

}  // namespace semiring_kernels

// C entry point (bound with ctypes).  The plan as for spmv_blocked_f32.
// semiring: 0 = min_plus, 1 = plus_mul.  Returns cudaGetLastError() after
// the launch.
extern "C" int fused_step_f32(const void* tiles, const void* rows,
                              const void* x_in, const void* x_comb,
                              const void* x_ref, const void* vmask,
                              void* x_out, void* changed, const void* chunks,
                              const void* first, const void* count,
                              void* counters, void* partials, int T, int B,
                              int W, int chunk, long long xin_pstride,
                              int nvb, int semiring, void* stream) {
  using namespace semiring_kernels;
  if (B <= 0 || B % 4 != 0 || B > 4 * kThreads || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  if (W == 0) return 0;
  const Walk wk = Walk::make(B, chunk);
  const Plan plan{(const int4*)chunks, (const int*)first, (const int*)count,
                  (int*)counters, (float4*)partials};
  const auto* t = (const float*)tiles;
  const auto* r = (const int*)rows;
  const auto* xi = (const float*)x_in;
  const auto* xc = (const float*)x_comb;
  const auto* xr = (const float*)x_ref;
  const auto* vm = (const uint8_t*)vmask;
  auto* xo = (float*)x_out;
  auto* ch = (int*)changed;
  cudaStream_t s = (cudaStream_t)stream;
  if (semiring == 0)
    return launch_fused<MinPlus>(t, r, xi, xc, xr, vm, xo, ch, plan, T, wk,
                                 xin_pstride, nvb, W, s);
  if (semiring == 1)
    return launch_fused<PlusMul>(t, r, xi, xc, xr, vm, xo, ch, plan, T, wk,
                                 xin_pstride, nvb, W, s);
  return (int)cudaErrorInvalidValue;
}
