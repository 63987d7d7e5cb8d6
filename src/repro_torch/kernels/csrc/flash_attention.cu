// Flash attention, prefill (sm_90a).
//
//   o[b, i, h, :] = softmax_j(q[b,i,h,:] . k[b,j,h/G,:] / sqrt(d)) v[b,j,h/G,:]
//
// over the keys j that the mask allows: all j < Skv, and with ``causal``
// j <= i + q_offset and, with a window w > 0, j > i + q_offset - w.
// q (B, Sq, H, d), k/v (B, Skv, K, d) with G = H / K; k/v are read in place
// through their batch and row strides (the KV cache's slots [0, Skv)), and
// query head h reads KV head h / G: no repeated or transposed copy.
//
// Grid (query block, head, batch).  Key blocks wholly outside the mask of
// the query block are never visited.  Online softmax with float32 (acc, m,
// l); the output is acc / max(l, 1e-30), in q's type.
//
// bfloat16: 64 query rows per CTA, 16 per warp; both products on tensor
// cores (mma.sync m16n8k16, float32 accumulators), p rounded to bf16
// before p.v as the reference does; K/V blocks of 64 keys double-buffered
// in shared memory by cp.async.
// float32: 32 query rows per CTA, four threads per row, CUDA-core FMAs in
// full float32 (no TF32).
#include "attn_common.cuh"

namespace attn_kernels {

constexpr int FA_THREADS = 128;  // 4 warps

// ---------------------------------------------------------------------------
// bfloat16, tensor cores
// ---------------------------------------------------------------------------
constexpr int BM = 64;  // query rows per CTA
constexpr int BN = 64;  // keys per block

template <int D>
constexpr size_t flash_bf16_smem() {
  return 2 /*stages*/ * 2 /*K, V*/ * BN * (D + 8) * sizeof(uint16_t);
}

template <int D>
__device__ __forceinline__ void load_kv_block(uint16_t* sK, uint16_t* sV,
                                              const uint16_t* k,
                                              const uint16_t* v,
                                              long long k_rs, long long v_rs,
                                              int n0, int Skv, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  constexpr int LD = D + 8;   // padded row: conflict-free fragment reads
  for (int c = tid; c < BN * CPR; c += FA_THREADS) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    const int n = n0 + r;
    const bool ok = n < Skv;
    const long long nn = ok ? n : 0;
    cp_async16(sK + r * LD + cc, k + nn * k_rs + cc, ok);
    cp_async16(sV + r * LD + cc, v + nn * v_rs + cc, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS) flash_fwd_bf16(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, uint16_t* __restrict__ o, int Sq, int Skv,
    int G, long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, long long o_bs, long long o_rs,
    int causal, int window, int q_offset, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* smem = reinterpret_cast<uint16_t*>(smem_raw);
  constexpr int LD = D + 8;
  constexpr int TILE = BN * LD;
  constexpr int KD = D / 16;  // k-steps of Q K^T
  constexpr int ND = D / 8;   // n-tiles of the output
  constexpr int NB = BN / 8;  // n-tiles of the logits

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int r0 = m0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const uint16_t* qp = q + b * q_bs + (long long)h * D;
  const uint16_t* kp = k + b * k_bs + (long long)(h / G) * D;
  const uint16_t* vp = v + b * v_bs + (long long)(h / G) * D;

  // keys the query block can see
  int kv_lo = 0, kv_hi = Skv;
  if (causal) {
    kv_hi = min(Skv, min(m0 + BM, Sq) + q_offset);
    if (window > 0) kv_lo = max(0, m0 + q_offset - window + 1);
  }
  const int jb0 = kv_lo / BN, jb1 = (kv_hi + BN - 1) / BN;

  // Q fragments (rows r0, r0 + 8), straight from device memory
  uint32_t qa[KD][4];
  {
    const bool ok0 = r0 < Sq, ok1 = r0 + 8 < Sq;
    const uint16_t* q0 = qp + (long long)(ok0 ? r0 : 0) * q_rs;
    const uint16_t* q1 = qp + (long long)(ok1 ? r0 + 8 : 0) * q_rs;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int c = kk * 16 + t * 2;
      qa[kk][0] = ok0 ? ld32(q0 + c) : 0u;
      qa[kk][1] = ok1 ? ld32(q1 + c) : 0u;
      qa[kk][2] = ok0 ? ld32(q0 + c + 8) : 0u;
      qa[kk][3] = ok1 ? ld32(q1 + c + 8) : 0u;
    }
  }
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};  // this thread's share of l; summed at the end
  const int qpos[2] = {r0 + q_offset, r0 + 8 + q_offset};

  if (jb0 < jb1)
    load_kv_block<D>(smem, smem + TILE, kp, vp, k_rs, v_rs, jb0 * BN, Skv,
                     tid);
  cp_async_commit();
  for (int jb = jb0; jb < jb1; ++jb) {
    const int st = (jb - jb0) & 1;
    if (jb + 1 < jb1) {
      uint16_t* nk = smem + 2 * (st ^ 1) * TILE;
      load_kv_block<D>(nk, nk + TILE, kp, vp, k_rs, v_rs, (jb + 1) * BN, Skv,
                       tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint16_t* sK = smem + 2 * st * TILE;
    const uint16_t* sV = sK + TILE;

    // logits: 16 rows x BN keys per warp
    float s[NB][4];
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NB; ++nt) {
        const uint16_t* kr = sK + (nt * 8 + g) * LD + kk * 16 + t * 2;
        const uint32_t bfr[2] = {ld32(kr), ld32(kr + 8)};
        mma_bf16_16816(s[nt], qa[kk], bfr);
      }
    }
    // scale, mask, row max (rows spread over the 4 threads of a quad)
    const int n0 = jb * BN;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        const int kpos = n0 + nt * 8 + t * 2 + (e & 1);
        bool ok = kpos < Skv;
        if (causal) {
          ok = ok && kpos <= qpos[rr];
          if (window > 0) ok = ok && kpos > qpos[rr] - window;
        }
        const float val = ok ? s[nt][e] * scale : NEG_INF;
        s[nt][e] = val;
        mx[rr] = fmaxf(mx[rr], val);
      }
    }
    float corr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      corr[rr] = expf(m_r[rr] - mx[rr]);
      m_r[rr] = mx[rr];
      l_r[rr] *= corr[rr];
    }
    // p = exp(s - m): l takes it in float32, p.v in bf16 (A fragments)
    uint32_t pa[NB / 2][4];
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) {
      const float p0 = expf(s[nt][0] - mx[0]), p1 = expf(s[nt][1] - mx[0]);
      const float p2 = expf(s[nt][2] - mx[1]), p3 = expf(s[nt][3] - mx[1]);
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16x2(p0, p1);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16x2(p2, p3);
    }
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt) {
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
        // B[key][dim] = V: keys kt*16 + 2t + {0, 1} (and + 8), dim dt*8 + g
        const uint16_t* vr = sV + (kt * 16 + t * 2) * LD + dt * 8 + g;
        const uint32_t bfr[2] = {
            (uint32_t)vr[0] | ((uint32_t)vr[LD] << 16),
            (uint32_t)vr[8 * LD] | ((uint32_t)vr[9 * LD] << 16)};
        mma_bf16_16816(acc[dt], pa[kt], bfr);
      }
    }
    __syncthreads();  // this stage is refilled two blocks on
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l_r[rr] += __shfl_xor_sync(0xffffffffu, l_r[rr], 1);
    l_r[rr] += __shfl_xor_sync(0xffffffffu, l_r[rr], 2);
    l_r[rr] = fmaxf(l_r[rr], 1e-30f);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + rr * 8;
    if (r >= Sq) continue;
    uint16_t* orow = o + b * o_bs + (long long)r * o_rs + (long long)h * D;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + t * 2) = pack_bf16x2(
          acc[dt][2 * rr] / l_r[rr], acc[dt][2 * rr + 1] / l_r[rr]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32, CUDA cores
// ---------------------------------------------------------------------------
constexpr int FBM = 32;  // query rows per CTA (4 threads each)
constexpr int FBN = 32;  // keys per block

template <int D>
__global__ void __launch_bounds__(FA_THREADS) flash_fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv,
    int G, long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, long long o_bs, long long o_rs,
    int causal, int window, int q_offset, float scale) {
  constexpr int C4 = D / 4;   // float4 per row
  constexpr int NC = D / 16;  // float4 per thread: chunks c*4 + part
  __shared__ float4 sK[FBN][C4];
  __shared__ float4 sV[FBN][C4];
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, part = tid & 3;
  const int m0 = blockIdx.x * FBM;
  const int r = m0 + (tid >> 2);
  const int qp = r + q_offset;
  const float* kp = k + b * k_bs + (long long)(h / G) * D;
  const float* vp = v + b * v_bs + (long long)(h / G) * D;

  int kv_lo = 0, kv_hi = Skv;
  if (causal) {
    kv_hi = min(Skv, min(m0 + FBM, Sq) + q_offset);
    if (window > 0) kv_lo = max(0, m0 + q_offset - window + 1);
  }
  const int jb0 = kv_lo / FBN, jb1 = (kv_hi + FBN - 1) / FBN;

  float4 qf[NC], acc[NC];
  {
    const float4* q4 = reinterpret_cast<const float4*>(
        q + b * q_bs + (long long)(r < Sq ? r : 0) * q_rs + (long long)h * D);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      qf[c] = r < Sq ? q4[c * 4 + part] : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  float m = NEG_INF, l = 0.f;
  for (int jb = jb0; jb < jb1; ++jb) {
    const int n0 = jb * FBN;
    __syncthreads();
    for (int i = tid; i < FBN * C4; i += FA_THREADS) {
      const int rr = i / C4, cc = i % C4;
      const int n = n0 + rr;
      const bool ok = n < Skv;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      sK[rr][cc] = ok ? reinterpret_cast<const float4*>(kp + n * k_rs)[cc] : z;
      sV[rr][cc] = ok ? reinterpret_cast<const float4*>(vp + n * v_rs)[cc] : z;
    }
    __syncthreads();
    float s[FBN];
    float mx = m;
#pragma unroll
    for (int n = 0; n < FBN; ++n) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk = sK[n][c * 4 + part];
        dot += qf[c].x * kk.x + qf[c].y * kk.y + qf[c].z * kk.z +
               qf[c].w * kk.w;
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kpos = n0 + n;
      bool ok = kpos < Skv;
      if (causal) {
        ok = ok && kpos <= qp;
        if (window > 0) ok = ok && kpos > qp - window;
      }
      s[n] = ok ? dot * scale : NEG_INF;
      mx = fmaxf(mx, s[n]);
    }
    const float corr = expf(m - mx);
    m = mx;
    l *= corr;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[c].x *= corr; acc[c].y *= corr; acc[c].z *= corr; acc[c].w *= corr;
    }
#pragma unroll
    for (int n = 0; n < FBN; ++n) {
      const float p = expf(s[n] - mx);
      l += p;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = sV[n][c * 4 + part];
        acc[c].x += p * vv.x; acc[c].y += p * vv.y;
        acc[c].z += p * vv.z; acc[c].w += p * vv.w;
      }
    }
  }
  if (r < Sq) {
    l = fmaxf(l, 1e-30f);
    float4* o4 = reinterpret_cast<float4*>(o + b * o_bs + (long long)r * o_rs +
                                           (long long)h * D);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      o4[c * 4 + part] = make_float4(acc[c].x / l, acc[c].y / l,
                                     acc[c].z / l, acc[c].w / l);
  }
}

template <int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         int B, int Sq, int Skv, int H, int G,
                         const long long* st, int causal, int window,
                         int q_offset, float scale, int dtype,
                         cudaStream_t s) {
  if (dtype == 1) {
    constexpr size_t smem = flash_bf16_smem<D>();
    static bool attr_set = false;  // per instantiation, set once
    if (!attr_set) {
      cudaError_t e = cudaFuncSetAttribute(
          flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return e;
      attr_set = true;
    }
    const dim3 grid((Sq + BM - 1) / BM, H, B);
    flash_fwd_bf16<D><<<grid, FA_THREADS, smem, s>>>(
        (const uint16_t*)q, (const uint16_t*)k, (const uint16_t*)v,
        (uint16_t*)o, Sq, Skv, G, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], causal, window, q_offset, scale);
  } else {
    const dim3 grid((Sq + FBM - 1) / FBM, H, B);
    flash_fwd_f32<D><<<grid, FA_THREADS, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, Sq, Skv,
        G, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], causal,
        window, q_offset, scale);
  }
  return cudaGetLastError();
}

}  // namespace attn_kernels

// C entry point (bound with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// Strides are in elements: batch and row (sequence) strides of q, k, v, o;
// the head dim is contiguous and heads are packed (stride d).
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Skv, int H, int K, int D, long long q_bs, long long q_rs,
    long long k_bs, long long k_rs, long long v_bs, long long v_rs,
    long long o_bs, long long o_rs, int causal, int window, int q_offset,
    float scale, int dtype, void* stream) {
  using namespace attn_kernels;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || K <= 0 || H % K != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long st[8] = {q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs};
  const int G = H / K;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  switch (D) {
    case 16: e = launch_flash<16>(q, k, v, o, B, Sq, Skv, H, G, st, causal, window, q_offset, scale, dtype, s); break;
    case 32: e = launch_flash<32>(q, k, v, o, B, Sq, Skv, H, G, st, causal, window, q_offset, scale, dtype, s); break;
    case 64: e = launch_flash<64>(q, k, v, o, B, Sq, Skv, H, G, st, causal, window, q_offset, scale, dtype, s); break;
    case 128: e = launch_flash<128>(q, k, v, o, B, Sq, Skv, H, G, st, causal, window, q_offset, scale, dtype, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}
