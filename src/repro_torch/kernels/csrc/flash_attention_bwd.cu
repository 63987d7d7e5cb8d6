// Flash attention, backward (sm_90a).
//
// Given q (B, Sq, H, d), k/v (B, Skv, K, d) with G = H / K (query head h
// reads KV head h / G), the forward's output o and its log-sum-exp
// lse (B, H, Sq) (flash_attention.cu with a non-null ``lse``), and the
// output's gradient dO, this computes
//
//   P  = exp(q k^T / sqrt(d) - lse)        on the pairs the mask allows
//   D  = rowsum(dO o)                       (float32, one value a row)
//   dV = P^T dO      dS = P (dO v^T - D)
//   dQ = dS k / sqrt(d)      dK = dS^T q / sqrt(d)
//
// with the forward's mask: key j < Skv and, with ``causal``, j <= i +
// q_offset and, with a window w > 0, j > i + q_offset - w.  That is the
// gradient the reference takes with jax.value_and_grad through
// chunked_attention (src/repro/models/attention.py:41), whose online
// softmax equals this P.  It replaces no TPU kernel: neither Pallas
// attention kernel of the reference has a backward, and the reference
// trains through XLA's autodiff of the jnp path.  The port runs kernel 3
// (flash_attention.cu) for the training forward, so its gradient is a
// kernel too.
//
// What bounds it: operations.  A visible (query, key) pair costs five
// products of 2 d operations (S, dP, dV, dK, dQ; S is recomputed in both
// passes below, so the kernels issue six): 10 d operations on inputs read
// about once, far above the H100's ~295 bf16 operations a byte.  At the
// training layer shape of starcoder2-7b (B 4, S 4,096, window 4,096, 36
// heads, d 128) that is 1.55 TFLOP, 1.56 ms at 989 TFLOP/s.
//
// What the design does (FA2's shape, simple and right first): three
// kernels and no floating-point atomics, so two launches give the same
// bits.
//   (a) bwd_row_dot: D = rowsum(dO o) in float32, one warp a row;
//   (b) bwd_dkdv_*: one CTA per (batch, KV head, block of keys) keeps its
//       dK and dV in registers and walks the G query heads of its group
//       and only the query blocks that the causal and window masks let see
//       its keys, recomputing S^T = K Q^T and P^T from lse;
//   (c) bwd_dq_*: one CTA per (batch, head, block of queries) keeps dQ in
//       registers and walks the key blocks its rows see (the forward's key
//       range), recomputing S, P and dP.
// bfloat16 takes mma.sync m16n8k16 with float32 accumulators (every d the
// forward takes: 16, 32, 64, 128); P and dS are rounded to bf16 as the
// A operand of their products, as p is in the forward.  float32 takes
// CUDA-core FMAs in full float32.  wgmma and TMA are later work.
#include "attn_common.cuh"

namespace attn_bwd {

using attn_kernels::NEG_INF;
using attn_kernels::cp_async16;
using attn_kernels::cp_async_commit;
using attn_kernels::cp_async_wait;
using attn_kernels::ld32;
using attn_kernels::mma_bf16_16816;
using attn_kernels::pack_bf16x2;
using attn_kernels::warp_sum;

constexpr int THREADS = 128;  // 4 warps (kernels b and c)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(uint16_t x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}

// the forward's mask for query row i and key j
__device__ __forceinline__ bool visible(int i, int j, int Sq, int Skv,
                                        int causal, int window,
                                        int q_offset) {
  bool ok = i < Sq && j < Skv;
  if (causal) {
    const int qp = i + q_offset;
    ok = ok && j <= qp;
    if (window > 0) ok = ok && j > qp - window;
  }
  return ok;
}

// (a) Dd[b, h, i] = sum_c dO[b, i, h, c] o[b, i, h, c], one warp a row of
// the (B, Sq, H) rows of dO and o
template <class T>
__global__ void bwd_row_dot(const T* __restrict__ dout,
                            const T* __restrict__ o, float* __restrict__ Dd,
                            int Sq, int H, int D, long long rows) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* a = dout + row * D;
  const T* c = o + row * D;
  float s = 0.f;
  for (int j = lane; j < D; j += 32) s += to_f(a[j]) * to_f(c[j]);
  s = warp_sum(s);
  if (lane == 0) {
    const long long h = row % H, bi = row / H;
    Dd[((bi / Sq) * H + h) * Sq + bi % Sq] = s;
  }
}

// query rows [i_lo, i_hi) that see some key of [n0, n1)
__device__ __forceinline__ void query_range(int n0, int n1, int Sq,
                                            int causal, int window,
                                            int q_offset, int& i_lo,
                                            int& i_hi) {
  i_lo = 0;
  i_hi = Sq;
  if (causal) {
    i_lo = max(0, n0 - q_offset);
    if (window > 0) i_hi = min(Sq, n1 - 1 - q_offset + window);
  }
}

// key columns [kv_lo, kv_hi) that rows [m0, m1) see (the forward's range)
__device__ __forceinline__ void key_range(int m0, int m1, int Skv, int causal,
                                          int window, int q_offset,
                                          int& kv_lo, int& kv_hi) {
  kv_lo = 0;
  kv_hi = Skv;
  if (causal) {
    kv_hi = min(Skv, m1 + q_offset);
    if (window > 0) kv_lo = max(0, m0 + q_offset - window + 1);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16
// ---------------------------------------------------------------------------
constexpr int KB = 64;  // keys per CTA of the dK/dV kernel (16 a warp)
constexpr int QB = 64;  // query rows per CTA of the dQ kernel (16 a warp)
// queries per step of the dK/dV kernel and keys per step of the dQ kernel:
// smaller at d = 128, where the dK/dV (dQ) accumulators take 128 (64)
// registers a thread
template <int D>
struct Tile {
  static constexpr int M = D >= 128 ? 32 : 64;
  static constexpr int LD = D + 8;  // padded smem row: conflict-free reads
};

template <int D>
constexpr size_t dkdv_smem() {
  return (size_t)(2 * KB + 2 * Tile<D>::M) * Tile<D>::LD * 2 +
         2 * Tile<D>::M * sizeof(float);
}
template <int D>
constexpr size_t dq_smem() {
  return (size_t)2 * 2 * Tile<D>::M * Tile<D>::LD * 2;
}

// rows [r0, r0 + n) of a (B, S, heads, D) bf16 tensor, head ``hd``, into
// smem rows of LD; rows past S are zero-filled
template <int D>
__device__ __forceinline__ void load_rows(uint16_t* s, const uint16_t* src,
                                          int b, int r0, int n, int S,
                                          int heads, int hd, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  constexpr int LD = Tile<D>::LD;
  for (int c = tid; c < n * CPR; c += THREADS) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    const int i = r0 + r;
    const bool ok = i < S;
    const long long off =
        (((long long)b * S + (ok ? i : 0)) * heads + hd) * D + cc;
    cp_async16(s + r * LD + cc, src + off, ok);
  }
}

// A fragment (16 x 16, row-major) of rows row0.. of a smem tile, k-step kk
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const uint16_t* s,
                                       int LD, int row, int kk, int t) {
  const uint16_t* p = s + row * LD + kk * 16 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}
// B fragment (16 x 8, col-major) B[k][n] = s[n][k] (rows n of the tile are
// the product's columns; k runs along a row): two 32-bit loads
__device__ __forceinline__ void frag_b_rows(uint32_t (&bf)[2],
                                            const uint16_t* s, int LD,
                                            int n, int kk, int t) {
  const uint16_t* p = s + n * LD + kk * 16 + 2 * t;
  bf[0] = ld32(p);
  bf[1] = ld32(p + 8);
}
// B fragment B[k][n] = s[k][n] (k runs down the tile's rows): four 16-bit
// loads, k = 16 kt + 2t + {0, 1, 8, 9}, n = 8 dt + g
__device__ __forceinline__ void frag_b_cols(uint32_t (&bf)[2],
                                            const uint16_t* s, int LD,
                                            int kt, int dt, int t, int g) {
  const uint16_t* p = s + (kt * 16 + 2 * t) * LD + dt * 8 + g;
  bf[0] = (uint32_t)p[0] | ((uint32_t)p[LD] << 16);
  bf[1] = (uint32_t)p[8 * LD] | ((uint32_t)p[9 * LD] << 16);
}

// (b) dK, dV of KB keys of one KV head.  Warp w owns keys n0 + 16 w + g
// and + 8 (the rows of its S^T tiles); query steps of M rows.
template <int D>
__global__ void __launch_bounds__(THREADS) bwd_dkdv_bf16(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ Dd,
    uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int Sq, int Skv,
    int H, int Kh, int causal, int window, int q_offset, float scale) {
  constexpr int M = Tile<D>::M, LD = Tile<D>::LD;
  constexpr int KD = D / 16;  // k-steps over the head dim
  constexpr int ND = D / 8;   // n-tiles over the head dim
  constexpr int NQ = M / 8;   // n-tiles over the queries
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sK = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sV = sK + KB * LD;
  uint16_t* sQ = sV + KB * LD;
  uint16_t* sO = sQ + M * LD;  // dO
  float* sL = reinterpret_cast<float*>(sO + M * LD);
  float* sD = sL + M;

  const int G = H / Kh;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int n0 = blockIdx.x * KB, n1 = min(n0 + KB, Skv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int krow = warp * 16 + g;  // tile rows krow and krow + 8

  load_rows<D>(sK, k, b, n0, KB, Skv, Kh, kvh, tid);
  load_rows<D>(sV, v, b, n0, KB, Skv, Kh, kvh, tid);
  cp_async_commit();

  int i_lo, i_hi;
  query_range(n0, n1, Sq, causal, window, q_offset, i_lo, i_hi);
  const int qb_lo = i_lo / M;
  const int qb_hi = i_hi > i_lo ? (i_hi + M - 1) / M : qb_lo;

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int gg = 0; gg < G; ++gg) {
    const int h = kvh * G + gg;
    const float* lrow = lse + ((long long)b * H + h) * Sq;
    const float* drow = Dd + ((long long)b * H + h) * Sq;
    for (int qb = qb_lo; qb < qb_hi; ++qb) {
      const int m0 = qb * M;
      __syncthreads();  // the previous step's reads of sQ, sO are done
      load_rows<D>(sQ, q, b, m0, M, Sq, H, h, tid);
      load_rows<D>(sO, dout, b, m0, M, Sq, H, h, tid);
      cp_async_commit();
      for (int r = tid; r < M; r += THREADS) {
        const bool ok = m0 + r < Sq;
        sL[r] = ok ? lrow[m0 + r] : 0.f;
        sD[r] = ok ? drow[m0 + r] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x M queries a warp
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int i = 0; i < NQ; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ak[4], av[4];
        frag_a(ak, sK, LD, krow, kk, t);
        frag_a(av, sV, LD, krow, kk, t);
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt) {
          uint32_t bq[2], bo[2];
          frag_b_rows(bq, sQ, LD, nt * 8 + g, kk, t);
          frag_b_rows(bo, sO, LD, nt * 8 + g, kk, t);
          mma_bf16_16816(st[nt], ak, bq);
          mma_bf16_16816(dpt[nt], av, bo);
        }
      }
      // P^T and dS^T, rounded to bf16 A fragments (k = the queries)
      uint32_t pa[NQ / 2][4], da[NQ / 2][4];
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = n0 + krow + 8 * (e >> 1);
          const int qi = nt * 8 + 2 * t + (e & 1);
          const bool ok =
              visible(m0 + qi, j, Sq, Skv, causal, window, q_offset);
          const float p = ok ? expf(st[nt][e] * scale - sL[qi]) : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - sD[qi]);
        }
        pa[nt >> 1][(nt & 1) * 2] = pack_bf16x2(st[nt][0], st[nt][1]);
        pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16x2(st[nt][2], st[nt][3]);
        da[nt >> 1][(nt & 1) * 2] = pack_bf16x2(dpt[nt][0], dpt[nt][1]);
        da[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16x2(dpt[nt][2], dpt[nt][3]);
      }
      // dV += P^T dO and dK += dS^T Q (k-steps over the queries)
#pragma unroll
      for (int kt = 0; kt < M / 16; ++kt) {
#pragma unroll
        for (int dt = 0; dt < ND; ++dt) {
          uint32_t bo[2], bq[2];
          frag_b_cols(bo, sO, LD, kt, dt, t, g);
          frag_b_cols(bq, sQ, LD, kt, dt, t, g);
          mma_bf16_16816(dva[dt], pa[kt], bo);
          mma_bf16_16816(dka[dt], da[kt], bq);
        }
      }
    }
  }
  // rows krow, krow + 8; dims 8 dt + 2t, + 1
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int j = n0 + krow + 8 * rr;
    if (j >= Skv) continue;
    const long long base = (((long long)b * Skv + j) * Kh + kvh) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + base + dt * 8) = pack_bf16x2(
          dka[dt][2 * rr] * scale, dka[dt][2 * rr + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + dt * 8) =
          pack_bf16x2(dva[dt][2 * rr], dva[dt][2 * rr + 1]);
    }
  }
}

// (c) dQ of QB query rows of one head.  Warp w owns rows m0 + 16 w + g and
// + 8; key steps of M keys through a two-stage cp.async ring.
template <int D>
__global__ void __launch_bounds__(THREADS) bwd_dq_bf16(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ Dd,
    uint16_t* __restrict__ dq, int Sq, int Skv, int H, int Kh, int causal,
    int window, int q_offset, float scale) {
  constexpr int M = Tile<D>::M, LD = Tile<D>::LD;
  constexpr int KD = D / 16, ND = D / 8, NB = M / 8;
  constexpr int TILE = M * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* smem = reinterpret_cast<uint16_t*>(smem_raw);

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kh);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * QB, m1 = min(m0 + QB, Sq);
  const int r0 = m0 + warp * 16 + g;  // rows r0 and r0 + 8

  // Q and dO fragments of rows r0, r0 + 8, straight from device memory
  uint32_t qa[KD][4], oa[KD][4];
  float lr[2], dr[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 8 * rr;
    const bool ok = r < Sq;
    const long long off = (((long long)b * Sq + (ok ? r : 0)) * H + h) * D;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][rr] = ok ? ld32(q + off + c) : 0u;
      qa[kk][rr + 2] = ok ? ld32(q + off + c + 8) : 0u;
      oa[kk][rr] = ok ? ld32(dout + off + c) : 0u;
      oa[kk][rr + 2] = ok ? ld32(dout + off + c + 8) : 0u;
    }
    const long long li = ((long long)b * H + h) * Sq + (ok ? r : 0);
    lr[rr] = ok ? lse[li] : 0.f;
    dr[rr] = ok ? Dd[li] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int kv_lo, kv_hi;
  key_range(m0, m1, Skv, causal, window, q_offset, kv_lo, kv_hi);
  const int jb0 = kv_lo / M;
  const int jb1 = kv_hi > kv_lo ? (kv_hi + M - 1) / M : jb0;
  if (jb0 < jb1) {
    load_rows<D>(smem, k, b, jb0 * M, M, Skv, Kh, kvh, tid);
    load_rows<D>(smem + TILE, v, b, jb0 * M, M, Skv, Kh, kvh, tid);
  }
  cp_async_commit();
  for (int jb = jb0; jb < jb1; ++jb) {
    const int st = (jb - jb0) & 1;
    if (jb + 1 < jb1) {
      uint16_t* nk = smem + 2 * (st ^ 1) * TILE;
      load_rows<D>(nk, k, b, (jb + 1) * M, M, Skv, Kh, kvh, tid);
      load_rows<D>(nk + TILE, v, b, (jb + 1) * M, M, Skv, Kh, kvh, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint16_t* sK = smem + 2 * st * TILE;
    const uint16_t* sV = sK + TILE;

    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NB; ++nt) {
        uint32_t bk[2], bv[2];
        frag_b_rows(bk, sK, LD, nt * 8 + g, kk, t);
        frag_b_rows(bv, sV, LD, nt * 8 + g, kk, t);
        mma_bf16_16816(s[nt], qa[kk], bk);
        mma_bf16_16816(dp[nt], oa[kk], bv);
      }
    }
    const int n0 = jb * M;
    uint32_t da[NB / 2][4];
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        const int j = n0 + nt * 8 + 2 * t + (e & 1);
        const bool ok =
            visible(r0 + 8 * rr, j, Sq, Skv, causal, window, q_offset);
        const float p = ok ? expf(s[nt][e] * scale - lr[rr]) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - dr[rr]);
      }
      da[nt >> 1][(nt & 1) * 2] = pack_bf16x2(dp[nt][0], dp[nt][1]);
      da[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16x2(dp[nt][2], dp[nt][3]);
    }
    // dQ += dS K (k-steps over the keys)
#pragma unroll
    for (int kt = 0; kt < M / 16; ++kt) {
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
        uint32_t bk[2];
        frag_b_cols(bk, sK, LD, kt, dt, t, g);
        mma_bf16_16816(acc[dt], da[kt], bk);
      }
    }
    __syncthreads();  // this stage is refilled two blocks on
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 8 * rr;
    if (r >= Sq) continue;
    const long long base = (((long long)b * Sq + r) * H + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt)
      *reinterpret_cast<uint32_t*>(dq + base + dt * 8) = pack_bf16x2(
          acc[dt][2 * rr] * scale, acc[dt][2 * rr + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, four threads a row (d / 4 values each)
// ---------------------------------------------------------------------------
constexpr int FB = 32;  // keys (dK/dV) or query rows (dQ) per CTA and step

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ void fma4(float4& acc, float s, float4 x) {
  acc.x += s * x.x;
  acc.y += s * x.y;
  acc.z += s * x.z;
  acc.w += s * x.w;
}
// the four threads of a row hold its chunks c * 4 + part
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__device__ __forceinline__ void load_rows_f32(float4 (*s)[D / 4],
                                              const float* src, int b,
                                              int r0, int S, int heads,
                                              int hd, int tid) {
  constexpr int C4 = D / 4;
  for (int i = tid; i < FB * C4; i += THREADS) {
    const int r = i / C4, cc = i % C4;
    const int n = r0 + r;
    s[r][cc] = n < S ? reinterpret_cast<const float4*>(
                           src + (((long long)b * S + n) * heads + hd) * D)[cc]
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) bwd_dkdv_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ Dd,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int H,
    int Kh, int causal, int window, int q_offset, float scale) {
  constexpr int C4 = D / 4, NC = D / 16;
  __shared__ float4 sQ[FB][C4];
  __shared__ float4 sO[FB][C4];
  __shared__ float sL[FB], sD[FB];
  const int G = H / Kh;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, part = tid & 3;
  const int n0 = blockIdx.x * FB, n1 = min(n0 + FB, Skv);
  const int j = n0 + (tid >> 2);  // this thread's key

  float4 kf[NC], vf[NC], dkf[NC], dvf[NC];
  {
    const long long off =
        (((long long)b * Skv + (j < Skv ? j : 0)) * Kh + kvh) * D;
    const float4* k4 = reinterpret_cast<const float4*>(k + off);
    const float4* v4 = reinterpret_cast<const float4*>(v + off);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      kf[c] = j < Skv ? k4[c * 4 + part] : z;
      vf[c] = j < Skv ? v4[c * 4 + part] : z;
      dkf[c] = dvf[c] = z;
    }
  }
  int i_lo, i_hi;
  query_range(n0, n1, Sq, causal, window, q_offset, i_lo, i_hi);
  for (int gg = 0; gg < G; ++gg) {
    const int h = kvh * G + gg;
    for (int m0 = (i_lo / FB) * FB; m0 < i_hi; m0 += FB) {
      __syncthreads();
      load_rows_f32<D>(sQ, q, b, m0, Sq, H, h, tid);
      load_rows_f32<D>(sO, dout, b, m0, Sq, H, h, tid);
      if (tid < FB) {
        const bool ok = m0 + tid < Sq;
        const long long li = ((long long)b * H + h) * Sq + m0 + tid;
        sL[tid] = ok ? lse[li] : 0.f;
        sD[tid] = ok ? Dd[li] : 0.f;
      }
      __syncthreads();
      for (int n = 0; n < FB; ++n) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          s += dot4(kf[c], sQ[n][c * 4 + part]);
          dp += dot4(vf[c], sO[n][c * 4 + part]);
        }
        s = quad_sum(s);
        dp = quad_sum(dp);
        const bool ok = visible(m0 + n, j, Sq, Skv, causal, window, q_offset);
        const float p = ok ? expf(s * scale - sL[n]) : 0.f;
        const float ds = p * (dp - sD[n]);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          fma4(dvf[c], p, sO[n][c * 4 + part]);
          fma4(dkf[c], ds, sQ[n][c * 4 + part]);
        }
      }
    }
  }
  if (j < Skv) {
    const long long off = (((long long)b * Skv + j) * Kh + kvh) * D;
    float4* dk4 = reinterpret_cast<float4*>(dk + off);
    float4* dv4 = reinterpret_cast<float4*>(dv + off);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 a = dkf[c];
      dk4[c * 4 + part] =
          make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
      dv4[c * 4 + part] = dvf[c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) bwd_dq_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ Dd,
    float* __restrict__ dq, int Sq, int Skv, int H, int Kh, int causal,
    int window, int q_offset, float scale) {
  constexpr int C4 = D / 4, NC = D / 16;
  __shared__ float4 sK[FB][C4];
  __shared__ float4 sV[FB][C4];
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kh);
  const int tid = threadIdx.x, part = tid & 3;
  const int m0 = blockIdx.x * FB, m1 = min(m0 + FB, Sq);
  const int r = m0 + (tid >> 2);  // this thread's row
  const bool live = r < Sq;

  float4 qf[NC], of[NC], dqf[NC];
  {
    const long long off = (((long long)b * Sq + (live ? r : 0)) * H + h) * D;
    const float4* q4 = reinterpret_cast<const float4*>(q + off);
    const float4* o4 = reinterpret_cast<const float4*>(dout + off);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      qf[c] = live ? q4[c * 4 + part] : z;
      of[c] = live ? o4[c * 4 + part] : z;
      dqf[c] = z;
    }
  }
  const long long li = ((long long)b * H + h) * Sq + (live ? r : 0);
  const float lr = live ? lse[li] : 0.f, dr = live ? Dd[li] : 0.f;
  int kv_lo, kv_hi;
  key_range(m0, m1, Skv, causal, window, q_offset, kv_lo, kv_hi);
  for (int n0 = (kv_lo / FB) * FB; n0 < kv_hi; n0 += FB) {
    __syncthreads();
    load_rows_f32<D>(sK, k, b, n0, Skv, Kh, kvh, tid);
    load_rows_f32<D>(sV, v, b, n0, Skv, Kh, kvh, tid);
    __syncthreads();
    for (int n = 0; n < FB; ++n) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        s += dot4(qf[c], sK[n][c * 4 + part]);
        dp += dot4(of[c], sV[n][c * 4 + part]);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      const bool ok = visible(r, n0 + n, Sq, Skv, causal, window, q_offset);
      const float p = ok ? expf(s * scale - lr) : 0.f;
      const float ds = p * (dp - dr);
#pragma unroll
      for (int c = 0; c < NC; ++c) fma4(dqf[c], ds, sK[n][c * 4 + part]);
    }
  }
  if (live) {
    float4* dq4 = reinterpret_cast<float4*>(
        dq + (((long long)b * Sq + r) * H + h) * D);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 a = dqf[c];
      dq4[c * 4 + part] =
          make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
enum BwdRoute { BWD_F32 = 0, BWD_BF16_MMA_SYNC = 1 };

template <class K>
cudaError_t max_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* Dd,
                       void* dq, void* dk, void* dv, int B, int Sq, int Skv,
                       int H, int Kh, int causal, int window, int q_offset,
                       float scale, int dtype, cudaStream_t s) {
  cudaError_t e;
  if (dtype == 1) {
    static bool attr_set = false;  // per instantiation, set once
    if (!attr_set) {
      if ((e = max_smem(bwd_dkdv_bf16<D>, dkdv_smem<D>())) != cudaSuccess)
        return e;
      if ((e = max_smem(bwd_dq_bf16<D>, dq_smem<D>())) != cudaSuccess)
        return e;
      attr_set = true;
    }
    const auto* q16 = (const uint16_t*)q;
    const auto* k16 = (const uint16_t*)k;
    const auto* v16 = (const uint16_t*)v;
    const auto* o16 = (const uint16_t*)dout;
    bwd_dkdv_bf16<D><<<dim3((Skv + KB - 1) / KB, Kh, B), THREADS,
                       dkdv_smem<D>(), s>>>(
        q16, k16, v16, o16, lse, Dd, (uint16_t*)dk, (uint16_t*)dv, Sq, Skv,
        H, Kh, causal, window, q_offset, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    bwd_dq_bf16<D><<<dim3((Sq + QB - 1) / QB, H, B), THREADS, dq_smem<D>(),
                     s>>>(q16, k16, v16, o16, lse, Dd, (uint16_t*)dq, Sq,
                          Skv, H, Kh, causal, window, q_offset, scale);
  } else {
    const auto* qf = (const float*)q;
    const auto* kf = (const float*)k;
    const auto* vf = (const float*)v;
    const auto* of = (const float*)dout;
    bwd_dkdv_f32<D><<<dim3((Skv + FB - 1) / FB, Kh, B), THREADS, 0, s>>>(
        qf, kf, vf, of, lse, Dd, (float*)dk, (float*)dv, Sq, Skv, H, Kh,
        causal, window, q_offset, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    bwd_dq_f32<D><<<dim3((Sq + FB - 1) / FB, H, B), THREADS, 0, s>>>(
        qf, kf, vf, of, lse, Dd, (float*)dq, Sq, Skv, H, Kh, causal, window,
        q_offset, scale);
  }
  return cudaGetLastError();
}

}  // namespace attn_bwd

// C entry point (bound with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// q, o, dout, dq (B, Sq, H, d) and k, v, dk, dv (B, Skv, K, d) contiguous
// in that layout; lse and Dd (scratch for D) float32 (B, H, Sq).
// ``route`` receives the route (0 float32, 1 bf16 mma.sync) before the
// launches.  Returns the first CUDA error of the three launches, else 0.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* Dd, void* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int H, int K, int D, int causal,
    int window, int q_offset, float scale, int dtype, int* route,
    void* stream) {
  using namespace attn_bwd;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || K <= 0 || H % K != 0 ||
      (dtype != 0 && dtype != 1) ||
      (D != 16 && D != 32 && D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  *route = dtype == 1 ? BWD_BF16_MMA_SYNC : BWD_F32;
  cudaStream_t s = (cudaStream_t)stream;
  const long long rows = (long long)B * Sq * H;
  const long long blocks = (rows + 7) / 8;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (dtype == 1)
    bwd_row_dot<uint16_t><<<(unsigned)blocks, 256, 0, s>>>(
        (const uint16_t*)dout, (const uint16_t*)o, (float*)Dd, Sq, H, D,
        rows);
  else
    bwd_row_dot<float><<<(unsigned)blocks, 256, 0, s>>>(
        (const float*)dout, (const float*)o, (float*)Dd, Sq, H, D, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float* l = (const float*)lse;
  const float* dd = (const float*)Dd;
  switch (D) {
    case 16: e = launch_bwd<16>(q, k, v, dout, l, dd, dq, dk, dv, B, Sq, Skv, H, K, causal, window, q_offset, scale, dtype, s); break;
    case 32: e = launch_bwd<32>(q, k, v, dout, l, dd, dq, dk, dv, B, Sq, Skv, H, K, causal, window, q_offset, scale, dtype, s); break;
    case 64: e = launch_bwd<64>(q, k, v, dout, l, dd, dq, dk, dv, B, Sq, Skv, H, K, causal, window, q_offset, scale, dtype, s); break;
    default: e = launch_bwd<128>(q, k, v, dout, l, dd, dq, dk, dv, B, Sq, Skv, H, K, causal, window, q_offset, scale, dtype, s); break;
  }
  return (int)e;
}
