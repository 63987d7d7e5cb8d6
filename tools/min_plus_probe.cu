// What one min-plus pair costs on the card, and how its min treats signed
// zeros and NaN: the facts the graph kernels' lane walk is designed on.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o min_plus_probe \
//       tools/min_plus_probe.cu && ./min_plus_probe
//
// 1. min.NaN.f32 (the kernels' MinPlus::add), min.f32, fminf and an add
//    on pairs of +0, -0, NaN, 1 and +inf, in both orders, as bit patterns:
//    whether -0 is ordered below +0 whatever the order, and which NaN
//    comes out.
// 2. Issue rates per SM and clock of FADD, FMNMX.NAN (min.NaN.f32), FMNMX
//    (min.f32), FFMA, and the pair acc = min.NaN(acc, x + w) of the
//    kernels' fold, from 16 independent chains a thread; the pair with 8,
//    3, 4 and 2 CTAs of 8 warps an SM.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>
#include <cstring>

__global__ void signed_zero_probe(const float* a, const float* b, float* out,
                                  int n) {
  const int i = threadIdx.x;
  if (i >= n) return;
  float r, r2;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a[i]), "f"(b[i]));
  asm("min.f32 %0, %1, %2;" : "=f"(r2) : "f"(a[i]), "f"(b[i]));
  out[4 * i] = r;
  out[4 * i + 1] = r2;
  out[4 * i + 2] = fminf(a[i], b[i]);
  out[4 * i + 3] = a[i] + b[i];
}

constexpr int kChains = 16;
constexpr int kIters = 4096;

template <int OP>
__global__ void rate(float* out, float x, float w) {
  float acc[kChains], xv[kChains], ww = w;
#pragma unroll
  for (int i = 0; i < kChains; ++i) {
    acc[i] = threadIdx.x + i;
    xv[i] = x + threadIdx.x + i;
  }
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int i = 0; i < kChains; ++i) {
      if (OP == 0) acc[i] = acc[i] + ww;
      if (OP == 1)
        asm volatile("min.NaN.f32 %0, %0, %1;" : "+f"(acc[i]) : "f"(ww));
      if (OP == 2) asm volatile("min.f32 %0, %0, %1;" : "+f"(acc[i]) : "f"(ww));
      if (OP == 3) acc[i] = __fmaf_rn(acc[i], 1.0001f, ww);
      if (OP == 4) {
        const float s = xv[i] + ww;
        asm volatile("min.NaN.f32 %0, %0, %1;" : "+f"(acc[i]) : "f"(s));
      }
    }
    ww += 1e-7f;
  }
  float s = 0;
#pragma unroll
  for (int i = 0; i < kChains; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int OP>
void time_rate(const char* name, float* out, int sms, int clk_khz,
               int per_sm) {
  const dim3 grid(sms * per_sm), block(256);
  rate<OP><<<grid, block>>>(out, 1.f, 2.f);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int r = 0; r < 5; ++r) rate<OP><<<grid, block>>>(out, 1.f, 2.f);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0;
  cudaEventElapsedTime(&ms, a, b);
  ms /= 5;
  const double ops = (double)grid.x * block.x * kIters * kChains;
  const double per_s = ops / (ms * 1e-3);
  printf("%-40s %.4f ms  %.4e /s  %.1f /clk/SM (at %d MHz)\n", name, ms,
         per_s, per_s / sms / (clk_khz * 1e3), clk_khz / 1000);
}

static float from_bits(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

static uint32_t bits(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    fprintf(stderr, "min_plus_probe: no CUDA device\n");
    return 2;
  }
  int clk = 0;
  cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0);
  printf("%s, %d SMs, clock %d MHz\n", prop.name, prop.multiProcessorCount,
         clk / 1000);

  // 1. signed zeros and NaN
  const uint32_t P0 = 0, N0 = 0x80000000u, QN = 0x7fc00000u,
                 NN = 0xffc00000u, ONE = 0x3f800000u, INF = 0x7f800000u;
  const uint32_t A[] = {P0, N0, P0, N0, QN, ONE, NN, QN, P0, INF, N0};
  const uint32_t B[] = {N0, P0, P0, N0, ONE, QN, P0, N0, INF, N0, QN};
  const int n = sizeof(A) / sizeof(A[0]);
  float ha[16], hb[16], ho[64];
  for (int i = 0; i < n; ++i) {
    ha[i] = from_bits(A[i]);
    hb[i] = from_bits(B[i]);
  }
  float *da, *db, *dout;
  cudaMalloc(&da, sizeof(ha));
  cudaMalloc(&db, sizeof(hb));
  cudaMalloc(&dout, sizeof(ho));
  cudaMemcpy(da, ha, 4 * n, cudaMemcpyHostToDevice);
  cudaMemcpy(db, hb, 4 * n, cudaMemcpyHostToDevice);
  signed_zero_probe<<<1, 32>>>(da, db, dout, n);
  cudaMemcpy(ho, dout, 16 * n, cudaMemcpyDeviceToHost);
  for (int i = 0; i < n; ++i)
    printf("a=%08x b=%08x  min.NaN=%08x  min=%08x  fminf=%08x  add=%08x\n",
           A[i], B[i], bits(ho[4 * i]), bits(ho[4 * i + 1]),
           bits(ho[4 * i + 2]), bits(ho[4 * i + 3]));

  // 2. issue rates
  float* out;
  cudaMalloc(&out, (size_t)prop.multiProcessorCount * 8 * 256 * 4);
  const int sms = prop.multiProcessorCount;
  time_rate<0>("FADD", out, sms, clk, 8);
  time_rate<1>("min.NaN.f32 (FMNMX.NAN)", out, sms, clk, 8);
  time_rate<2>("min.f32 (FMNMX)", out, sms, clk, 8);
  time_rate<3>("FFMA", out, sms, clk, 8);
  time_rate<4>("pair min.NaN(acc, x + w), pairs", out, sms, clk, 8);
  time_rate<4>("pair, 4 CTAs of 8 warps an SM", out, sms, clk, 4);
  time_rate<4>("pair, 3 CTAs of 8 warps an SM", out, sms, clk, 3);
  time_rate<4>("pair, 2 CTAs of 8 warps an SM", out, sms, clk, 2);
  const cudaError_t err = cudaDeviceSynchronize();
  printf("status: %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
