// Fused superstep stage for all partitions and all lanes of the query
// axis in one launch (sm_90a).
//
// Per lane l, partition p and output block c (every c in 0..NVB-1):
//   y            = fold of A_p^T x_in[l] over the run of tiles with
//                  cols == c
//   x_out[l,p,c] = add(x_comb[l,p,c], y)   if the run is non-empty
//                = x_comb[l,p,c]           otherwise
//   changed[l,p] |= any_j(vmask[p,c,j] && x_out[l,p,c,j] != x_ref[l,p,c,j])
//
// Replaces the TPU kernel fused_step_pallas
// (src/repro/kernels/semiring_superstep/kernel.py:142), which the
// reference vmaps over Q lanes under the query axis (a grid axis over Q).
// x_in is Q lanes of (P, NVBin, B), or of (1, NVBin, B) shared by every
// partition (xin_pstride == 0, the boundary consume), the lane stride
// given apart: the consume's boundary is shared by partitions, not by
// lanes.  x_comb, x_ref and x_out are (Q, P, NVB, B) contiguous; vmask
// (P, NVB, B) has no lane axis.  The vote covers every block, touched or
// not: in the consume shape x_comb differs from x_ref there.  Each lane's
// vote is a flag in shared memory, then one atomicOr per (lane, CTA) that
// voted into ``changed`` (Q, P), which the caller zeroes before the
// launch.
//
// Two pointers may be null.  x_comb == nullptr combines with the semiring
// zero: x_out = y, and blocks with an empty run get the zero (the plain
// SpMV of PageRank's step).  changed == nullptr skips the vote, and x_ref
// and vmask are not read.
//
// What bounds it on an H100: for one lane, bytes, as for the SpMV
// (semiring_spmm.cu): the valid tiles once plus the states, about 82 MB
// for the TR_SMALL local sweep and 185 MB for its boundary consume,
// 0.0245 and 0.0553 ms at 3.35 TB/s; at Q = 32 the operations on the same
// tiles.  The design is the SpMV's walk (blocked_walk.cuh): one CTA per
// chunk of the walk plan for every lane, TMA bulk copies into a ring of
// stages, lane groups of up to 8 lanes folded from one weight read, and
// a fixed-order combine of a run's chunks by the CTA that finishes the
// run; that CTA applies x_comb, writes x_out and votes, lane by lane.
// Every block has at least one chunk (an empty run one empty chunk), so
// every block of every lane is written and votes.
// Grid (W), block (B/4, G) flattened; B must be a multiple of 4 and at
// most 1,024, the float tensors 16-byte aligned and vmask 4-byte aligned.
#include "blocked_walk.cuh"

namespace semiring_kernels {

// Combine, write and vote for lane l's block (p, c).
template <class SR>
struct FusedOut {
  const float* x_comb;
  const float* x_ref;
  const uint8_t* vmask;
  float* x_out;
  int* changed;
  long long s_lstride;  // P * NVB * B, the states' lane stride
  int B, P, p, pc;
  bool empty;  // the run of (p, c) has no tile
  int L;       // lanes of a group: the flags a vote may set
  __device__ __forceinline__ void operator()(int lane0, int l, int q,
                                             float4 v, bool valid,
                                             int* flags) {
    int vote = 0;
    if (valid) {
      const size_t o = (size_t)pc * B + 4 * q;
      const long long lo = (lane0 + l) * s_lstride;
      float4 out = v;  // an empty run folds to the semiring zero
      if (x_comb != nullptr) {
        const float4 base =
            *reinterpret_cast<const float4*>(x_comb + lo + o);
        out = empty ? base : add4<SR>(base, v);
      }
      *reinterpret_cast<float4*>(x_out + lo + o) = out;
      if (changed != nullptr) {
        const float4 ref = *reinterpret_cast<const float4*>(x_ref + lo + o);
        const uchar4 m = *reinterpret_cast<const uchar4*>(vmask + o);
        vote = (m.x && out.x != ref.x) || (m.y && out.y != ref.y) ||
               (m.z && out.z != ref.z) || (m.w && out.w != ref.w);
      }
    }
    if (changed == nullptr) return;  // the same for the whole grid
    if (vote) flags[l] = 1;  // every writer stores the same value
    __syncthreads();
    const int t = threadIdx.x;
    if (t < L && flags[t]) {
      atomicOr(changed + (size_t)(lane0 + t) * P + p, 1);
      flags[t] = 0;
    }
    __syncthreads();  // flags are zero again before the next call
  }
};

template <class SR, int L>
__global__ void __launch_bounds__(kThreads) fused_step_kernel(
    const float* __restrict__ tiles, const int* __restrict__ rows,
    const float* __restrict__ x_in, const float* __restrict__ x_comb,
    const float* __restrict__ x_ref, const uint8_t* __restrict__ vmask,
    float* __restrict__ x_out, int* __restrict__ changed, Plan plan, int T,
    Walk wk, Lanes ln, int P, int nvb) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int4 ch = plan.chunks[blockIdx.x];  // (p, c, t0, t1)
  const int pc = ch.x * nvb + ch.y;
  // this CTA may finish block (p, c); a run of one chunk is empty iff its
  // chunk is
  const bool empty = ch.y >= 0 && ch.z == ch.w && plan.count[pc] == 1;
  FusedOut<SR> out{x_comb, x_ref, vmask, x_out, changed,
                   (long long)P * nvb * wk.B, wk.B, P, ch.x, pc, empty, L};
  walk_chunk<SR, L>(wk, plan, tiles, rows, x_in, ln, T, nvb, smem, out);
}

template <class SR, int L>
int launch_fused(const float* t, const int* r, const float* xi,
                 const float* xc, const float* xr, const uint8_t* vm,
                 float* xo, int* ch, Plan plan, int T, Walk wk, Lanes ln,
                 int P, int nvb, int W, cudaStream_t s) {
  const size_t smem = wk.smem_bytes();
  static size_t allowed = 0;
  const int err = allow_smem(fused_step_kernel<SR, L>, smem, allowed);
  if (err) return err;
  fused_step_kernel<SR, L><<<W, wk.threads(), smem, s>>>(
      t, r, xi, xc, xr, vm, xo, ch, plan, T, wk, ln, P, nvb);
  return (int)cudaGetLastError();
}

template <class SR>
int launch_fused_lanes(const float* t, const int* r, const float* xi,
                       const float* xc, const float* xr, const uint8_t* vm,
                       float* xo, int* ch, Plan plan, int T, Walk wk,
                       Lanes ln, int P, int nvb, int W, cudaStream_t s) {
  switch (wk.L) {
    case 1:
      return launch_fused<SR, 1>(t, r, xi, xc, xr, vm, xo, ch, plan, T, wk,
                                 ln, P, nvb, W, s);
    case 4:
      return launch_fused<SR, 4>(t, r, xi, xc, xr, vm, xo, ch, plan, T, wk,
                                 ln, P, nvb, W, s);
    case 8:
      return launch_fused<SR, 8>(t, r, xi, xc, xr, vm, xo, ch, plan, T, wk,
                                 ln, P, nvb, W, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace semiring_kernels

// C entry point (bound with ctypes).  Q lanes: x_in lane l, partition p
// at x_in + l * xin_lstride + p * xin_pstride (xin_pstride 0 = shared by
// partitions); x_comb, x_ref, x_out (Q, P, nvb, B) and changed (Q, P)
// contiguous.  The plan as for spmv_blocked_f32.  semiring: 0 =
// min_plus, 1 = plus_mul.  Returns cudaGetLastError() after the launch.
extern "C" int fused_step_f32(const void* tiles, const void* rows,
                              const void* x_in, const void* x_comb,
                              const void* x_ref, const void* vmask,
                              void* x_out, void* changed, const void* chunks,
                              const void* first, const void* count,
                              void* counters, void* partials, int T, int B,
                              int W, int chunk, int P, int Q,
                              long long xin_lstride, long long xin_pstride,
                              int nvb, int semiring, void* stream) {
  using namespace semiring_kernels;
  if (B <= 0 || B % 4 != 0 || B > 4 * kThreads || chunk <= 0 || Q <= 0)
    return (int)cudaErrorInvalidValue;
  if (W == 0) return 0;
  const Walk wk = Walk::make(B, chunk, lane_group(Q));
  const Plan plan{(const int4*)chunks, (const int*)first, (const int*)count,
                  (int*)counters, (float4*)partials};
  const Lanes ln{Q, xin_lstride, xin_pstride};
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
    return launch_fused_lanes<MinPlus>(t, r, xi, xc, xr, vm, xo, ch, plan,
                                       T, wk, ln, P, nvb, W, s);
  if (semiring == 1)
    return launch_fused_lanes<PlusMul>(t, r, xi, xc, xr, vm, xo, ch, plan,
                                       T, wk, ln, P, nvb, W, s);
  return (int)cudaErrorInvalidValue;
}
