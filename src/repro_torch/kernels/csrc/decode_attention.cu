// Decode attention: one new query token per sequence against a KV cache
// (sm_90a), split-S flash decoding.
//
//   o[b, h, :] = softmax_j(q[b,h,:] . k[b,j,h/G,:] / sqrt(d)) v[b,j,h/G,:]
//
// over the cache slots j in [lo, hi): hi = min(len, S) and, with a window
// w > 0, lo = max(0, len - w), else 0, where len = lengths[b] (the
// reference's mask: j < len, j < S and j > len - 1 - w).  A sequence whose
// range is empty (len <= 0) gets 0.  q (B, H, d); k/v (B, S, K, d) read in
// place through batch and row strides (the cache), with the G = H / K
// queries of one KV head folded together: every K/V byte is read once for
// all G of them.  Logits in float32, masked keys at -1e30; p rounded to
// v's type before p.v, l summed from the unrounded p.  Replaces the TPU
// kernel decode_attention_pallas
// (src/repro/kernels/decode_attention/kernel.py:83).
//
// Grid (B*K, nsplit): a CTA takes one (batch, KV head) and split s of its
// range.  The range is cut into blocks of KB = 64 keys from lo; split s
// takes blocks [s nb, (s+1) nb) with nb = ceil(ceil((hi - lo) / KB) /
// nsplit), so every split but the last non-empty one has whole blocks
// (kernels/decode_attention/schedule.py holds the same formulas and the
// split count).  A split's warps keep their own online softmax (float32
// m, l, acc) and are merged in warp order.
//
// Three routes, picked by (dtype, d) alone (decode_route below):
//
// * bfloat16, d in {64, 128}: decode_ring_bf16, the serving path's kernel.
//   What bounds it: bytes.  One token reads every valid K/V row once and
//   does 4 G d operations per 4 d bytes of it, G = 9 operations per byte
//   at starcoder2-7b against the H100's ~295: at the serving batch (4
//   sequences, window 4,096, 4 KV heads, d = 128) a layer reads 33.6 MB,
//   10 us at 3.35 TB/s.  So the kernel must keep HBM busy from its first
//   microseconds with few, short CTAs (16 (batch, KV head) pairs):
//   - the split count fills one wave of CTAs in whole blocks (8 splits of
//     8 blocks at the serving shape);
//   - one producer thread fills a ring of two K/V stages, one 64-key
//     block a stage, ahead of the consumers: TMA loads of 64-key x 64-dim
//     boxes (128-byte swizzle) from 4-D tensor maps over the cache as it
//     lies (tensor_map.cuh), rows past the cache read as zero.  A stage's
//     full mbarrier expects its boxes' bytes, its empty mbarrier one
//     arrival per consumer warp.  More stages were no faster with K/V out
//     of L2, as a decode step reads them (PERF.md).  Copies of single rows
//     were tried first: one 1-D bulk copy (TMA) per 256-byte K or V row
//     costs the SM tens of cycles each, and 16-byte cp.async from one
//     producer warp is held by the SM's outstanding loads; both ran slower
//     than the boxes (PERF.md, tools/decode_variants.py);
//   - four consumer warps take 16 keys of each stage: q.k and p.v are
//     mma.sync m16n8k16 (the G <= 16 query rows in one 16-row A tile; K
//     fragments by ldmatrix, V by ldmatrix.trans, both through the
//     swizzle: conflict-free), p = 0 for the keys past the split's end,
//     whose V rows are zeroed first (0 x NaN is NaN, and a cache holds
//     anything past its lengths).  wgmma's 64-row tile would be 7/8 empty
//     at G = 9, and the tensor cores are not the bound;
// * bfloat16, d in {16, 32}: decode_split_bf16, each warp copying 32-key
//   blocks with 16-byte cp.async and running the same mma.sync products.
// * float32: decode_split_f32, CUDA cores in full float32 (no TF32).  For
//   q.k each lane holds one key and reads its row with 16-byte loads
//   against the G queries kept in shared memory; for p.v each lane holds
//   four dims of the G accumulators and the p of the 32 keys come by
//   shuffle.
// Every route writes o with one split; with more, each split writes its
// partial (acc, m, l) to a workspace and a second launch
// (decode_combine_kernel) combines the splits in split order.
#include "attn_common.cuh"
#include "bulk_copy.cuh"
#include "tensor_map.cuh"

namespace attn_kernels {

using namespace hopper;  // mbarriers, allow_smem

constexpr int DW = 4;      // (consumer) warps per CTA
constexpr int DKEYS = 32;  // keys per warp step (float32, small bf16)
constexpr int DROWS = 16;  // query rows per (batch, KV head): G <= 16
constexpr int KB = 64;     // keys per block of the split schedule

// Merge the DW warps' partials -- s_m/s_l [DW][DROWS], s_acc
// [DW][DROWS][D] -- in warp order, then write the output (one split) or
// this split's partial to the workspace.  Each (warp, row) scale is
// computed once, into s_m (so s_m is consumed).  Every thread of the CTA
// must call this (it synchronises).
template <class T>
__device__ void merge_warps(const float* s_acc, float* s_m, const float* s_l,
                            int D, int G, T* o, float* ws_acc, float* ws_ml,
                            int bk, int split, int nsplit) {
  __shared__ float row_l[DROWS];
  __syncthreads();  // the warps' partials are in place
  if ((int)threadIdx.x < G) {
    const int g = threadIdx.x;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < DW; ++w) M = fmaxf(M, s_m[w * DROWS + g]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < DW; ++w) {
      const float c = expf(s_m[w * DROWS + g] - M);
      s_m[w * DROWS + g] = c;
      L += s_l[w * DROWS + g] * c;
    }
    row_l[g] = L;
    if (nsplit > 1) {
      const long long slot = ((long long)bk * nsplit + split) * G + g;
      ws_ml[slot * 2] = M;
      ws_ml[slot * 2 + 1] = L;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < DW; ++w)
      A += s_acc[(w * DROWS + g) * D + i % D] * s_m[w * DROWS + g];
    if (nsplit == 1)
      o[i] = from_f<T>(A / fmaxf(row_l[g], 1e-30f));
    else
      ws_acc[(((long long)bk * nsplit + split) * G) * D + i] = A;
  }
}

// The keys [c0, c1) of split ``split`` of ``nsplit`` for sequence length
// ``len`` (schedule.py split_ranges); c1 == c0 for an empty split.
__device__ __forceinline__ int2 split_range(int len, int S, int window,
                                            int split, int nsplit) {
  const int hi = min(len, S);
  const int lo = window > 0 ? (int)max(0LL, (long long)len - window) : 0;
  const int n = max(hi - lo, 0);
  const int nb = ((n + KB - 1) / KB + nsplit - 1) / nsplit;
  const int c0 = lo + split * nb * KB;
  return make_int2(c0, max(c0, min(hi, c0 + nb * KB)));
}

// Output (g, dd) of one (batch, KV head) from its nsplit partials, split s
// in workspace slot first + s * G: combined in split order.
__device__ __forceinline__ float combine_one(const float* ws_acc,
                                             const float* ws_ml,
                                             long long first, int G, int D,
                                             int dd, int nsplit) {
  float M = NEG_INF;
  for (int s = 0; s < nsplit; ++s)
    M = fmaxf(M, __ldcg(ws_ml + (first + (long long)s * G) * 2));
  float A = 0.f, L = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const long long slot = first + (long long)s * G;
    const float c = expf(__ldcg(ws_ml + slot * 2) - M);
    A += __ldcg(ws_acc + slot * D + dd) * c;
    L += __ldcg(ws_ml + slot * 2 + 1) * c;
  }
  return A / fmaxf(L, 1e-30f);
}

// ---------------------------------------------------------------------------
// bfloat16, d 16 or 32: cp.async per warp
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
  merge_warps(s_acc, s_m, s_l, D, G, o + b * o_bs + (long long)kvh * G * D,
              ws_acc, ws_ml, bk, split, nsplit);
}

// ---------------------------------------------------------------------------
// bfloat16, d 64 or 128: the TMA-fed ring
// ---------------------------------------------------------------------------
// four 8x8 b16 matrices from shared memory (lanes 8i..8i+7 give the row
// addresses of matrix i), plain and transposed
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// A block of K (or V) in a stage: D / 64 TMA boxes of 64 keys x 64 dims,
// 8 KB each, rows of 128 bytes under the 128-byte swizzle (16-byte chunk c
// of row r at chunk c ^ (r % 8)).  The element offset of chunk ``c`` (0 ..
// D/8 - 1) of key ``r``:
__device__ __forceinline__ int kv_chunk(int r, int c) {
  return (c >> 3) * (KB * 64) + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

template <int D>
struct Ring {
  static constexpr int kTile = KB * D * 2;  // one block of K (or V), bytes
  static constexpr int kStage = 2 * kTile;  // K, then V
  static constexpr int kAlign = 1024;       // the swizzle's atom
  static constexpr int kStages = 2;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kBytes = kAlign + kRing + 2 * kStages * 8;
  // once drained, the ring holds the warps' partials for the merge
  static_assert(DW * DROWS * (D + 2) * 4 <= kRing, "merge buffer");
};

template <int D>
__global__ void __launch_bounds__((DW + 1) * 32, 1) decode_ring_bf16(
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const uint16_t* __restrict__ q, const int* __restrict__ lengths,
    uint16_t* __restrict__ o, float* __restrict__ ws_acc,
    float* __restrict__ ws_ml, int S, int K, int G, long long q_bs,
    long long o_bs, int window, int nsplit, float scale) {
  using R = Ring<D>;
  constexpr int KD = D / 16, ND = D / 8;
  extern __shared__ __align__(1024) unsigned char dyn_smem[];
  unsigned char* base_smem =
      dyn_smem + ((R::kAlign - (smem_addr(dyn_smem) & (R::kAlign - 1))) &
                  (R::kAlign - 1));
  uint16_t* ring = reinterpret_cast<uint16_t*>(base_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(base_smem + R::kRing);
  uint64_t* empty = full + R::kStages;
  const int bk = blockIdx.x, split = blockIdx.y;
  const int b = bk / K, kvh = bk % K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int2 r = split_range(__ldg(lengths + b), S, window, split, nsplit);
  const int nkeys = r.y - r.x, nblk = (nkeys + KB - 1) / KB;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], DW);
    }
    mbar_init_fence();
  }
  __syncthreads();

  float acc[ND][4];
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};  // this thread's share of l; summed at the end
  if (warp == DW) {
    // producer: block i into stage i % kStages once the consumers freed
    // it, K and V by TMA, D / 64 boxes each; rows past the cache read as
    // zero, rows past the split's end (at most 63) are read and masked
    if (lane == 0) {
      for (int i = 0; i < nblk; ++i) {
        const int s = i % R::kStages;
        mbar_wait(&empty[s], ((i / R::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], R::kStage);
        const uint32_t sk = smem_addr(ring + s * (R::kStage / 2));
        const uint32_t bar = smem_addr(&full[s]);
#pragma unroll
        for (int h = 0; h < D / 64; ++h) {
          tma_load_4d(sk + h * KB * 128, &tm_k, bar, h * 64, kvh,
                      r.x + i * KB, b);
          tma_load_4d(sk + R::kTile + h * KB * 128, &tm_v, bar, h * 64, kvh,
                      r.x + i * KB, b);
        }
      }
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
    const int key0 = warp * 16;  // this warp's 16 keys of every block
    // A fragments of the 16 query rows (rows past G are zero)
    uint32_t qa[KD][4];
    {
      const uint16_t* qh = q + b * q_bs + (long long)kvh * G * D;
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
#pragma unroll
    for (int i = 0; i < ND; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    // ldmatrix rows: K as [key][dim] -> matrices (keys 0-7 | 8-15) x
    // (dims 0-7 | 8-15) of a 16-dim step; V transposed -> (keys 0-7 |
    // 8-15) x (dims 0-7 | 8-15) of two 8-dim output tiles
    const int k_row = key0 + (lane & 7) + ((lane >> 4) << 3);
    const int k_hi = (lane >> 3) & 1;
    const int v_row = key0 + (lane & 7) + (((lane >> 3) & 1) << 3);
    const int v_hi = lane >> 4;
    for (int i = 0; i < nblk; ++i) {
      const int s = i % R::kStages;
      const uint16_t* sK = ring + s * (R::kStage / 2);
      uint16_t* sV = ring + s * (R::kStage / 2) + R::kTile / 2;
      const int valid = min(KB, nkeys - i * KB) - key0;  // this warp's keys
      mbar_wait(&full[s], (i / R::kStages) & 1);
      if (valid > 0) {
        if (valid < 16) {
          // rows past the split's end: p = 0 below, and V zeroed, since
          // 0 x NaN is NaN (a cache holds anything past its lengths)
          for (int c = lane; c < (16 - valid) * (D / 8); c += 32)
            *reinterpret_cast<uint4*>(
                sV + kv_chunk(key0 + valid + c / (D / 8), c % (D / 8))) =
                make_uint4(0u, 0u, 0u, 0u);
          __syncwarp();
        }
        float sc[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t kb[4];
          ldsm_x4(kb, sK + kv_chunk(k_row, 2 * kk + k_hi));
          const uint32_t b0[2] = {kb[0], kb[1]}, b1[2] = {kb[2], kb[3]};
          mma_bf16_16816(sc[0], qa[kk], b0);
          mma_bf16_16816(sc[1], qa[kk], b1);
        }
        float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = nt * 8 + t * 2 + (e & 1) < valid;
            sc[nt][e] = ok ? sc[nt][e] * scale : NEG_INF;
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
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
        float p[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = nt * 8 + t * 2 + (e & 1) < valid;
            p[nt][e] = ok ? expf(sc[nt][e] - mx[e >> 1]) : 0.f;
            l_r[e >> 1] += p[nt][e];
          }
        }
        const uint32_t pa[4] = {
            pack_bf16x2(p[0][0], p[0][1]), pack_bf16x2(p[0][2], p[0][3]),
            pack_bf16x2(p[1][0], p[1][1]), pack_bf16x2(p[1][2], p[1][3])};
#pragma unroll
        for (int dt = 0; dt < ND; ++dt) {
          acc[dt][0] *= corr[0];
          acc[dt][1] *= corr[0];
          acc[dt][2] *= corr[1];
          acc[dt][3] *= corr[1];
        }
#pragma unroll
        for (int dt = 0; dt < ND; dt += 2) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, sV + kv_chunk(v_row, dt + v_hi));
          const uint32_t b0[2] = {vb[0], vb[1]}, b1[2] = {vb[2], vb[3]};
          mma_bf16_16816(acc[dt], pa, b0);
          mma_bf16_16816(acc[dt + 1], pa, b1);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // the stage may be refilled
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l_r[rr] += __shfl_xor_sync(0xffffffffu, l_r[rr], 1);
      l_r[rr] += __shfl_xor_sync(0xffffffffu, l_r[rr], 2);
    }
  }
  __syncthreads();  // every copy landed and was read: reuse the ring
  float* s_acc = reinterpret_cast<float*>(base_smem);
  float* s_m = s_acc + DW * DROWS * D;
  float* s_l = s_m + DW * DROWS;
  if (warp < DW) {
    const int g = lane >> 2, t = lane & 3;
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
  }
  merge_warps(s_acc, s_m, s_l, D, G,
              reinterpret_cast<__nv_bfloat16*>(o + b * o_bs +
                                               (long long)kvh * G * D),
              ws_acc, ws_ml, bk, split, nsplit);
}

// ---------------------------------------------------------------------------
// second pass of every route with several splits: the splits combined in
// split order
// ---------------------------------------------------------------------------
template <class T>
__global__ void decode_combine_kernel(const float* __restrict__ ws_acc,
                                      const float* __restrict__ ws_ml,
                                      T* __restrict__ o, int K, int G, int D,
                                      int nsplit, long long o_bs) {
  const int bk = blockIdx.x, g = blockIdx.y, dd = threadIdx.x;
  const int b = bk / K, kvh = bk % K;
  o[b * o_bs + ((long long)kvh * G + g) * D + dd] = from_f<T>(combine_one(
      ws_acc, ws_ml, (long long)bk * nsplit * G + g, G, D, dd, nsplit));
}

template <class T>
cudaError_t launch_combine(const float* ws_acc, const float* ws_ml, void* o,
                           int B, int K, int G, int D, int nsplit,
                           long long o_bs, cudaStream_t s) {
  cudaError_t e = cudaGetLastError();  // the split kernel's launch
  if (e != cudaSuccess || nsplit == 1) return e;
  decode_combine_kernel<T><<<dim3(B * K, G), D, 0, s>>>(
      ws_acc, ws_ml, (T*)o, K, G, D, nsplit, o_bs);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_ring(const void* q, const void* k, const void* v,
                        const int* lengths, void* o, float* ws_acc,
                        float* ws_ml, int B, int S, int K, int G,
                        const long long* st, int window, int nsplit,
                        float scale, cudaStream_t s) {
  using R = Ring<D>;
  const EncodeTiledFn enc = tensor_map_encoder();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap mk, mv;
  if (!encode_heads_map(enc, &mk, k, D, K, S, B, st[2], st[1], KB) ||
      !encode_heads_map(enc, &mv, v, D, K, S, B, st[4], st[3], KB))
    return cudaErrorInvalidValue;
  static size_t allowed = 0;  // per instantiation
  const int err = allow_smem(decode_ring_bf16<D>, R::kBytes, allowed);
  if (err) return (cudaError_t)err;
  decode_ring_bf16<D><<<dim3(B * K, nsplit), (DW + 1) * 32, R::kBytes, s>>>(
      mk, mv, (const uint16_t*)q, lengths, (uint16_t*)o, ws_acc, ws_ml, S,
      K, G, st[0], st[5], window, nsplit, scale);
  return launch_combine<__nv_bfloat16>(ws_acc, ws_ml, o, B, K, G, D, nsplit,
                                       st[5], s);
}

template <int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* lengths, void* o, float* ws_acc,
                          float* ws_ml, int B, int S, int K, int G,
                          const long long* st, int window, int nsplit,
                          float scale, int dtype, cudaStream_t s) {
  const dim3 grid(B * K, nsplit);
  if (dtype == 1) {
    if constexpr (D <= 32) {  // under 48 KB of shared memory
      decode_split_bf16<D><<<grid, DW * 32, decode_bf16_smem<D>(), s>>>(
          (const uint16_t*)q, (const uint16_t*)k, (const uint16_t*)v,
          lengths, (uint16_t*)o, ws_acc, ws_ml, S, K, G, st[0], st[1], st[2],
          st[3], st[4], st[5], window, nsplit, scale);
    } else {
      return cudaErrorInvalidValue;  // the ring route
    }
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
  if (dtype == 1)
    return launch_combine<__nv_bfloat16>(ws_acc, ws_ml, o, B, K, G, D,
                                         nsplit, st[5], s);
  return launch_combine<float>(ws_acc, ws_ml, o, B, K, G, D, nsplit, st[5],
                               s);
}

enum DecodeRoute {
  DECODE_F32 = 0,
  DECODE_BF16_SMALL = 1,
  DECODE_BF16_RING = 2
};

inline int decode_route(int dtype, int D) {
  if (dtype == 0) return DECODE_F32;
  return (D == 64 || D == 128) ? DECODE_BF16_RING : DECODE_BF16_SMALL;
}

}  // namespace attn_kernels

// C entry point (bound with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// q (B, H, D) with batch stride q_bs; k/v batch and row strides in
// elements (head dim contiguous, heads packed); o (B, H, D) with batch
// stride o_bs.  With nsplit > 1: ws_acc (B*K*nsplit*G*D) and ws_ml
// (B*K*nsplit*G*2) float32 scratch.  G = H / K must be at most 16.  ``route``
// receives the route taken (0 float32, 1 bf16 cp.async, 2 bf16 ring)
// before the launch.  Returns cudaGetLastError() after the launches.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    void* ws_acc, void* ws_ml, int B, int S, int H, int K,
    int D, long long q_bs, long long k_bs, long long k_rs, long long v_bs,
    long long v_rs, long long o_bs, int window, int nsplit, float scale,
    int dtype, int* route, void* stream) {
  using namespace attn_kernels;
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || H % K != 0 ||
      H / K > DROWS || nsplit <= 0 || nsplit > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int r = decode_route(dtype, D);
  if (nsplit > 1 && (ws_acc == nullptr || ws_ml == nullptr))
    return (int)cudaErrorInvalidValue;
  *route = r;
  const long long st[6] = {q_bs, k_bs, k_rs, v_bs, v_rs, o_bs};
  const int G = H / K;
  cudaStream_t s = (cudaStream_t)stream;
  const int* len = (const int*)lengths;
  auto* wa = (float*)ws_acc;
  auto* wm = (float*)ws_ml;
  cudaError_t e;
  if (r == DECODE_BF16_RING) {
    if (D == 128)
      e = launch_ring<128>(q, k, v, len, o, wa, wm, B, S, K, G, st, window, nsplit, scale, s);
    else
      e = launch_ring<64>(q, k, v, len, o, wa, wm, B, S, K, G, st, window, nsplit, scale, s);
    return (int)e;
  }
  switch (D) {
    case 16: e = launch_decode<16>(q, k, v, len, o, wa, wm, B, S, K, G, st, window, nsplit, scale, dtype, s); break;
    case 32: e = launch_decode<32>(q, k, v, len, o, wa, wm, B, S, K, G, st, window, nsplit, scale, dtype, s); break;
    case 64: e = launch_decode<64>(q, k, v, len, o, wa, wm, B, S, K, G, st, window, nsplit, scale, dtype, s); break;
    case 128: e = launch_decode<128>(q, k, v, len, o, wa, wm, B, S, K, G, st, window, nsplit, scale, dtype, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}
