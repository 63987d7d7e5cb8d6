// Decode attention: one new query token per sequence against a KV cache
// (sm_90a), split-S flash decoding.
//
//   o[b, h, :] = softmax_j(q[b,h,:] . k[b,j,h/G,:] / sqrt(d)) v[b,j,h/G,:]
//
// over the cache slots j in [lo, len) with len = min(lengths[b], S) and
// lo = max(0, len - window) for a window > 0, else 0.  q (B, H, d); k/v
// (B, S, K, d) read in place through batch and row strides (the cache),
// with the G = H / K queries of one KV head folded together: every K/V
// byte is read once for all G of them.  A sequence with len <= 0 gets 0.
//
// Pass 1, grid (B*K, nsplit): a CTA takes one (batch, KV head) and one of
// nsplit even shares of [lo, len); its 4 warps take turns at blocks of 32
// keys, each with its own online softmax in float32 (p rounded to v's
// type before p.v, as the reference does).
// * bfloat16: the G query rows sit in one 16-row tensor-core tile: q.k and
//   p.v are mma.sync m16n8k16 products with float32 accumulators, and each
//   warp copies its K/V block into shared memory with 16-byte cp.async.
// * float32: CUDA cores in full float32 (no TF32).  For q.k each lane
//   holds one key and reads its row with 16-byte loads against the G
//   queries kept in shared memory; for p.v each lane holds four dims of
//   the G accumulators and the p of the 32 keys come by shuffle.
// The warps' partial (acc, m, l) are merged in warp order; with nsplit = 1
// the CTA writes the output, else its partial goes to a workspace and
// pass 2, grid (B*K, G), combines the splits in split order, so the
// result does not depend on scheduling.
#include "attn_common.cuh"

namespace attn_kernels {

constexpr int DW = 4;      // warps per CTA
constexpr int DKEYS = 32;  // keys per warp step
constexpr int DROWS = 16;  // query rows per (batch, KV head): G <= 16

// Merge the DW warps' partials -- s_m/s_l [DW][DROWS], s_acc
// [DW][DROWS][D] -- in warp order, then write the output (one split) or
// this split's partial to the workspace.
template <class T>
__device__ void merge_warps(const float* s_acc, const float* s_m,
                            const float* s_l, int D, int G, T* o,
                            float* ws_acc, float* ws_ml, int bk, int split,
                            int nsplit) {
  for (int i = threadIdx.x; i < G * D; i += DW * 32) {
    const int g = i / D, dd = i % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < DW; ++w) M = fmaxf(M, s_m[w * DROWS + g]);
    float A = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < DW; ++w) {
      const float c = expf(s_m[w * DROWS + g] - M);
      A += s_acc[(w * DROWS + g) * D + dd] * c;
      L += s_l[w * DROWS + g] * c;
    }
    if (nsplit == 1) {
      o[(long long)g * D + dd] = from_f<T>(A / fmaxf(L, 1e-30f));
    } else {
      const long long slot = ((long long)bk * nsplit + split) * G + g;
      ws_acc[slot * D + dd] = A;
      if (dd == 0) {
        ws_ml[slot * 2] = M;
        ws_ml[slot * 2 + 1] = L;
      }
    }
  }
}

// the share [c0, c1) of pass-1 CTA ``split`` for sequence length ``len``
__device__ __forceinline__ int2 split_range(int len, int S, int window,
                                            int split, int nsplit) {
  len = min(len, S);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int n = max(len - lo, 0);
  const int chunk = (n + nsplit - 1) / nsplit;
  const int c0 = lo + split * chunk;
  return make_int2(c0, min(len, c0 + chunk));
}

// ---------------------------------------------------------------------------
// bfloat16, tensor cores
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t decode_bf16_smem() {
  // each warp's K and V blocks; after the loop the same memory holds the
  // warps' partials for the merge
  constexpr size_t tiles = (size_t)DW * 2 * DKEYS * (D + 8) * 2;
  constexpr size_t merge = (size_t)DW * DROWS * (D + 2) * 4;
  return tiles > merge ? tiles : merge;
}

template <int D>
__global__ void __launch_bounds__(DW * 32) decode_split_bf16(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, const int* __restrict__ lengths,
    uint16_t* __restrict__ o, float* __restrict__ ws_acc,
    float* __restrict__ ws_ml, int S, int K, int G, long long q_bs,
    long long k_bs, long long k_rs, long long v_bs, long long v_rs,
    long long o_bs, int window, int nsplit, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 8;  // padded row: conflict-free fragment reads
  constexpr int KD = D / 16, ND = D / 8, NB = DKEYS / 8, CPR = D / 8;
  const int bk = blockIdx.x, split = blockIdx.y;
  const int b = bk / K, kvh = bk % K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint16_t* sK = reinterpret_cast<uint16_t*>(smem_raw) + warp * 2 * DKEYS * LD;
  uint16_t* sV = sK + DKEYS * LD;
  const int2 r = split_range(lengths[b], S, window, split, nsplit);
  const uint16_t* kp = k + b * k_bs + (long long)kvh * D;
  const uint16_t* vp = v + b * v_bs + (long long)kvh * D;
  const uint16_t* qh = q + b * q_bs + (long long)kvh * G * D;

  // A fragments of the 16 query rows (rows past G are zero)
  uint32_t qa[KD][4];
  {
    const bool ok0 = g < G, ok1 = g + 8 < G;
    const uint16_t* q0 = qh + (ok0 ? g : 0) * D;
    const uint16_t* q1 = qh + (ok1 ? g + 8 : 0) * D;
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

  for (int base = r.x + warp * DKEYS; base < r.y; base += DW * DKEYS) {
    // this warp's K/V rows [base, base + DKEYS), zeros past the share
    for (int c = lane; c < DKEYS * CPR; c += 32) {
      const int row = c / CPR, cc = (c % CPR) * 8;
      const bool ok = base + row < r.y;
      const long long key = ok ? base + row : base;
      cp_async16(sK + row * LD + cc, kp + key * k_rs + cc, ok);
      cp_async16(sV + row * LD + cc, vp + key * v_rs + cc, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();

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
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = base + nt * 8 + t * 2 + (e & 1) < r.y;
        s[nt][e] = ok ? s[nt][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
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
    for (int kt = 0; kt < NB / 2; ++kt) {
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
        const uint16_t* vr = sV + (kt * 16 + t * 2) * LD + dt * 8 + g;
        const uint32_t bfr[2] = {
            (uint32_t)vr[0] | ((uint32_t)vr[LD] << 16),
            (uint32_t)vr[8 * LD] | ((uint32_t)vr[9 * LD] << 16)};
        mma_bf16_16816(acc[dt], pa[kt], bfr);
      }
    }
    __syncwarp();  // the block is refilled next step
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l_r[rr] += __shfl_xor_sync(0xffffffffu, l_r[rr], 1);
    l_r[rr] += __shfl_xor_sync(0xffffffffu, l_r[rr], 2);
  }
  __syncthreads();  // every warp is done with its blocks: reuse the memory
  float* s_acc = reinterpret_cast<float*>(smem_raw);
  float* s_m = s_acc + DW * DROWS * D;
  float* s_l = s_m + DW * DROWS;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = warp * DROWS + g + rr * 8;
    if (t == 0) {
      s_m[row] = m_r[rr];
      s_l[row] = l_r[rr];
    }
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      s_acc[row * D + dt * 8 + t * 2] = acc[dt][2 * rr];
      s_acc[row * D + dt * 8 + t * 2 + 1] = acc[dt][2 * rr + 1];
    }
  }
  __syncthreads();
  merge_warps(s_acc, s_m, s_l, D, G,
              reinterpret_cast<__nv_bfloat16*>(o + b * o_bs +
                                               (long long)kvh * G * D),
              ws_acc, ws_ml, bk, split, nsplit);
}

// ---------------------------------------------------------------------------
// float32, CUDA cores
// ---------------------------------------------------------------------------
template <int D, int GMAX>
__global__ void __launch_bounds__(DW * 32) decode_split_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ lengths,
    float* __restrict__ o, float* __restrict__ ws_acc,
    float* __restrict__ ws_ml, int S, int K, int G, long long q_bs,
    long long k_bs, long long k_rs, long long v_bs, long long v_rs,
    long long o_bs, int window, int nsplit, float scale) {
  constexpr int VPRE = 8;  // V rows whose loads a lane keeps in flight
  __shared__ float sq[GMAX][D];
  __shared__ float s_acc[DW * DROWS * D];
  __shared__ float s_m[DW * DROWS], s_l[DW * DROWS];
  const int bk = blockIdx.x, split = blockIdx.y;
  const int b = bk / K, kvh = bk % K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const float* qp = q + b * q_bs + (long long)kvh * G * D;
  for (int i = tid; i < G * D; i += DW * 32) sq[i / D][i % D] = qp[i];
  __syncthreads();

  const int2 r = split_range(lengths[b], S, window, split, nsplit);
  const float* kp = k + b * k_bs + (long long)kvh * D;
  const float* vp = v + b * v_bs + (long long)kvh * D;
  const bool dim_lane = lane * 4 < D;  // this lane's 4 dims of p.v

  float m[GMAX], l[GMAX], acc[GMAX][4];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;  // this lane's share; summed over the warp at the end
    acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  }
  for (int base = r.x + warp * DKEYS; base < r.y; base += DW * DKEYS) {
    const int key = base + lane;
    const bool valid = key < r.y;
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
    if (valid) {
      const float* kr = kp + key * k_rs;
#pragma unroll 4
      for (int c = 0; c < D; c += 4) {
        const float4 kf = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < G)
            s[g] += sq[g][c] * kf.x + sq[g][c + 1] * kf.y +
                    sq[g][c + 2] * kf.z + sq[g][c + 3] * kf.w;
        }
      }
    }
    float p[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        const float val = valid ? s[g] * scale : NEG_INF;
        const float mn = fmaxf(m[g], warp_max(val));
        const float corr = expf(m[g] - mn);
        m[g] = mn;
        p[g] = valid ? expf(val - mn) : 0.f;
        l[g] = l[g] * corr + p[g];
        acc[g][0] *= corr; acc[g][1] *= corr;
        acc[g][2] *= corr; acc[g][3] *= corr;
      }
    }
    const int nvalid = min(DKEYS, r.y - base);
    for (int j0 = 0; j0 < nvalid; j0 += VPRE) {
      float4 vf[VPRE];
#pragma unroll
      for (int u = 0; u < VPRE; ++u) {
        vf[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (dim_lane && j0 + u < nvalid)
          vf[u] = *reinterpret_cast<const float4*>(
              vp + (long long)(base + j0 + u) * v_rs + lane * 4);
      }
#pragma unroll
      for (int u = 0; u < VPRE; ++u) {
        if (j0 + u < nvalid) {
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            if (g < G) {
              const float pj = __shfl_sync(0xffffffffu, p[g], j0 + u);
              acc[g][0] += pj * vf[u].x; acc[g][1] += pj * vf[u].y;
              acc[g][2] += pj * vf[u].z; acc[g][3] += pj * vf[u].w;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      const float lt = warp_sum(l[g]);
      if (lane == 0) {
        s_m[warp * DROWS + g] = m[g];
        s_l[warp * DROWS + g] = lt;
      }
      if (dim_lane) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s_acc[(warp * DROWS + g) * D + lane * 4 + e] = acc[g][e];
      }
    }
  }
  __syncthreads();
  merge_warps(s_acc, s_m, s_l, D, G, o + b * o_bs + (long long)kvh * G * D,
              ws_acc, ws_ml, bk, split, nsplit);
}

// ---------------------------------------------------------------------------
// pass 2: the splits, combined in split order
// ---------------------------------------------------------------------------
template <class T>
__global__ void decode_combine_kernel(const float* __restrict__ ws_acc,
                                      const float* __restrict__ ws_ml,
                                      T* __restrict__ o, int K, int G, int D,
                                      int nsplit, long long o_bs) {
  const int bk = blockIdx.x, g = blockIdx.y, dd = threadIdx.x;
  const int b = bk / K, kvh = bk % K;
  const long long first = (long long)bk * nsplit * G + g;  // split 0's slot
  float M = NEG_INF;
  for (int s = 0; s < nsplit; ++s)
    M = fmaxf(M, ws_ml[(first + (long long)s * G) * 2]);
  float A = 0.f, L = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const long long slot = first + (long long)s * G;
    const float c = expf(ws_ml[slot * 2] - M);
    A += ws_acc[slot * D + dd] * c;
    L += ws_ml[slot * 2 + 1] * c;
  }
  o[b * o_bs + ((long long)kvh * G + g) * D + dd] =
      from_f<T>(A / fmaxf(L, 1e-30f));
}

template <int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* lengths, void* o, float* ws_acc,
                          float* ws_ml, int B, int S, int K, int G,
                          const long long* st, int window, int nsplit,
                          float scale, int dtype, cudaStream_t s) {
  const dim3 grid(B * K, nsplit);
  if (dtype == 1) {
    constexpr size_t smem = decode_bf16_smem<D>();
    static bool attr_set = false;  // per instantiation, set once
    if (!attr_set) {
      cudaError_t e = cudaFuncSetAttribute(
          decode_split_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return e;
      attr_set = true;
    }
    decode_split_bf16<D><<<grid, DW * 32, smem, s>>>(
        (const uint16_t*)q, (const uint16_t*)k, (const uint16_t*)v, lengths,
        (uint16_t*)o, ws_acc, ws_ml, S, K, G, st[0], st[1], st[2], st[3],
        st[4], st[5], window, nsplit, scale);
  } else if (G <= 8) {
    decode_split_f32<D, 8><<<grid, DW * 32, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v, lengths,
        (float*)o, ws_acc, ws_ml, S, K, G, st[0], st[1], st[2], st[3], st[4],
        st[5], window, nsplit, scale);
  } else {
    decode_split_f32<D, 16><<<grid, DW * 32, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v, lengths,
        (float*)o, ws_acc, ws_ml, S, K, G, st[0], st[1], st[2], st[3], st[4],
        st[5], window, nsplit, scale);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  if (dtype == 1)
    decode_combine_kernel<__nv_bfloat16><<<dim3(B * K, G), D, 0, s>>>(
        ws_acc, ws_ml, (__nv_bfloat16*)o, K, G, D, nsplit, st[5]);
  else
    decode_combine_kernel<float><<<dim3(B * K, G), D, 0, s>>>(
        ws_acc, ws_ml, (float*)o, K, G, D, nsplit, st[5]);
  return cudaGetLastError();
}

}  // namespace attn_kernels

// C entry point (bound with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// q (B, H, D) with batch stride q_bs; k/v batch and row strides in
// elements (head dim contiguous, heads packed); o (B, H, D) with batch
// stride o_bs.  ws_acc (B*K*nsplit*G*D) and ws_ml (B*K*nsplit*G*2) float32
// are read only when nsplit > 1.  G = H / K must be at most 16.
// Returns cudaGetLastError() after the launches.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    void* ws_acc, void* ws_ml, int B, int S, int H, int K, int D,
    long long q_bs, long long k_bs, long long k_rs, long long v_bs,
    long long v_rs, long long o_bs, int window, int nsplit, float scale,
    int dtype, void* stream) {
  using namespace attn_kernels;
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || H % K != 0 ||
      H / K > DROWS || nsplit <= 0 || nsplit > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long st[6] = {q_bs, k_bs, k_rs, v_bs, v_rs, o_bs};
  const int G = H / K;
  cudaStream_t s = (cudaStream_t)stream;
  const int* len = (const int*)lengths;
  auto* wa = (float*)ws_acc;
  auto* wm = (float*)ws_ml;
  cudaError_t e;
  switch (D) {
    case 16: e = launch_decode<16>(q, k, v, len, o, wa, wm, B, S, K, G, st, window, nsplit, scale, dtype, s); break;
    case 32: e = launch_decode<32>(q, k, v, len, o, wa, wm, B, S, K, G, st, window, nsplit, scale, dtype, s); break;
    case 64: e = launch_decode<64>(q, k, v, len, o, wa, wm, B, S, K, G, st, window, nsplit, scale, dtype, s); break;
    case 128: e = launch_decode<128>(q, k, v, len, o, wa, wm, B, S, K, G, st, window, nsplit, scale, dtype, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}
