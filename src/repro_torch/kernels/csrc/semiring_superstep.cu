// Fused superstep stage for all partitions in one launch (sm_90a).
//
// Per partition p and output block c (every c in 0..NVB-1):
//   y          = run fold of A_p^T x_in over the tiles with cols == c
//   x_out[p,c] = add(x_comb[p,c], y)   if the run is non-empty
//              = x_comb[p,c]           otherwise
//   changed[p] |= any_j(vmask[p,c,j] && x_out[p,c,j] != x_ref[p,c,j])
//
// x_in is (P, NVBin, B), or (1, NVBin, B) shared by every partition
// (xin_pstride == 0, the boundary consume).  The vote covers every block,
// touched or not: in the consume shape x_comb differs from x_ref there.
// It is a block-wide OR (__syncthreads_or) and one atomicOr per voting
// CTA into ``changed``, which the caller zeroes before the launch.
//
// Two pointers may be null.  x_comb == nullptr combines with the semiring
// zero: x_out = y, and blocks with an empty run get the zero (the plain
// SpMV of PageRank's step).  changed == nullptr skips the vote, and x_ref
// and vmask are not read.
// Grid (NVB, P), block (B/4, G); B must be a multiple of 4, the float
// tensors 16-byte aligned and vmask 4-byte aligned.
#include "blocked_walk.cuh"

namespace semiring_kernels {

template <class SR>
__global__ void fused_step_kernel(
    const float* __restrict__ tiles, const int* __restrict__ rows,
    const int* __restrict__ cols, const float* __restrict__ x_in,
    const float* __restrict__ x_comb, const float* __restrict__ x_ref,
    const uint8_t* __restrict__ vmask, float* __restrict__ x_out,
    int* __restrict__ changed, int T, int B, int G, long long xin_pstride,
    int nvb) {
  extern __shared__ float4 red[];
  __shared__ int2 run;
  const int c = blockIdx.x, p = blockIdx.y;
  const int q = threadIdx.x, g = threadIdx.y;
  const size_t pt = (size_t)p * T;
  if (q == 0 && g == 0) run = find_run(cols + pt, T, c);
  __syncthreads();
  const float4 v = fold_run<SR>(tiles + pt * B * B, rows + pt,
                                x_in + p * xin_pstride, run.x, run.y, B, G,
                                q, g, red);
  int vote = 0;
  if (g == 0) {
    const size_t o = ((size_t)p * nvb + c) * B + 4 * q;
    float4 out = v;  // an empty run folds to the semiring zero
    if (x_comb != nullptr) {
      const float4 base = *reinterpret_cast<const float4*>(x_comb + o);
      out = run.y > run.x ? add4<SR>(base, v) : base;
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
  if (__syncthreads_or(vote) && q == 0 && g == 0) atomicOr(changed + p, 1);
}

}  // namespace semiring_kernels

// C entry point (bound with ctypes).  semiring: 0 = min_plus, 1 = plus_mul.
// Returns cudaGetLastError() after the launch.
extern "C" int fused_step_f32(const void* tiles, const void* rows,
                              const void* cols, const void* x_in,
                              const void* x_comb, const void* x_ref,
                              const void* vmask, void* x_out, void* changed,
                              int P, int T, int B, long long xin_pstride,
                              int nvb, int semiring, void* stream) {
  using namespace semiring_kernels;
  if (B <= 0 || B % 4 != 0) return (int)cudaErrorInvalidValue;
  const int G = row_groups(B);
  const dim3 grid(nvb, P), block(B / 4, G);
  const size_t smem = (size_t)G * B * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  const auto* t = (const float*)tiles;
  const auto* r = (const int*)rows;
  const auto* c = (const int*)cols;
  const auto* xi = (const float*)x_in;
  const auto* xc = (const float*)x_comb;
  const auto* xr = (const float*)x_ref;
  const auto* vm = (const uint8_t*)vmask;
  auto* xo = (float*)x_out;
  auto* ch = (int*)changed;
  if (semiring == 0) {
    fused_step_kernel<MinPlus><<<grid, block, smem, s>>>(
        t, r, c, xi, xc, xr, vm, xo, ch, T, B, G, xin_pstride, nvb);
  } else if (semiring == 1) {
    fused_step_kernel<PlusMul><<<grid, block, smem, s>>>(
        t, r, c, xi, xc, xr, vm, xo, ch, T, B, G, xin_pstride, nvb);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
