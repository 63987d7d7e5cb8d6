// Blocked semiring SpMV for all partitions in one launch (sm_90a).
//
//   y[p, c*B + j] = add over tiles t of partition p with cols[p,t] == c,
//                   over i, of mul(x[p', rows[p,t]*B + i], tiles[p,t,i,j])
//
// p' = p, or 0 when x is shared by every partition (x_pstride == 0, the
// boundary consume).  Blocks with no valid tile get the semiring zero.
// ``nnz`` (optional, (P,) int32) caps the walked prefix of each tile list
// (a packed list's valid-tile count).  Grid (n_out, P), block (B/4, G);
// B must be a multiple of 4 and tiles/y 16-byte aligned.
#include "blocked_walk.cuh"

namespace semiring_kernels {

template <class SR>
__global__ void spmv_blocked_kernel(
    const float* __restrict__ tiles, const int* __restrict__ rows,
    const int* __restrict__ cols, const float* __restrict__ x,
    const int* __restrict__ nnz, float* __restrict__ y, int T, int B, int G,
    long long x_pstride, int n_out) {
  extern __shared__ float4 red[];
  __shared__ int2 run;
  const int c = blockIdx.x, p = blockIdx.y;
  const int q = threadIdx.x, g = threadIdx.y;
  const size_t pt = (size_t)p * T;
  if (q == 0 && g == 0) {
    int n = T;
    if (nnz != nullptr) n = min(n, max(nnz[p], 0));
    run = find_run(cols + pt, n, c);
  }
  __syncthreads();
  const float4 v = fold_run<SR>(tiles + pt * B * B, rows + pt,
                                x + p * x_pstride, run.x, run.y, B, G, q, g,
                                red);
  if (g == 0) {
    reinterpret_cast<float4*>(y + ((size_t)p * n_out + c) * B)[q] = v;
  }
}

}  // namespace semiring_kernels

// C entry point (bound with ctypes).  semiring: 0 = min_plus, 1 = plus_mul.
// Returns cudaGetLastError() after the launch.
extern "C" int spmv_blocked_f32(const void* tiles, const void* rows,
                                const void* cols, const void* x,
                                const void* nnz, void* y, int P, int T, int B,
                                long long x_pstride, int n_out, int semiring,
                                void* stream) {
  using namespace semiring_kernels;
  if (B <= 0 || B % 4 != 0) return (int)cudaErrorInvalidValue;
  const int G = row_groups(B);
  const dim3 grid(n_out, P), block(B / 4, G);
  const size_t smem = (size_t)G * B * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  const auto* t = (const float*)tiles;
  const auto* r = (const int*)rows;
  const auto* c = (const int*)cols;
  const auto* xx = (const float*)x;
  const auto* nz = (const int*)nnz;
  auto* yy = (float*)y;
  if (semiring == 0) {
    spmv_blocked_kernel<MinPlus><<<grid, block, smem, s>>>(
        t, r, c, xx, nz, yy, T, B, G, x_pstride, n_out);
  } else if (semiring == 1) {
    spmv_blocked_kernel<PlusMul><<<grid, block, smem, s>>>(
        t, r, c, xx, nz, yy, T, B, G, x_pstride, n_out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Message for a code returned by the entry points above.
extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
