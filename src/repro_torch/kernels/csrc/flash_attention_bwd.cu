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
// products of 2 d operations (S, dP, dV, dK, dQ): 10 d operations on
// inputs read about once, far above the H100's ~295 bf16 operations a
// byte.  At the training layer shape of starcoder2-7b (B 4, S 4,096,
// window 4,096, 36 heads over 4, d 128) that is 1.55 TFLOP, 1.56 ms at
// 989 TFLOP/s.  The kernels issue seven products a pair (S and dP once
// more in the dQ pass): 14 d, 2.19 ms at that rate.
//
// Three launches and no floating-point atomics, so two launches give the
// same bits:
//   (a) bwd_row_dot: D = rowsum(dO o) in float32, one warp a row;
//   (b) bwd_dkdv_*: one CTA per (batch, KV head, block of keys) keeps its
//       dK and dV in registers and walks the G query heads of its group
//       and only the query blocks that the causal and window masks let see
//       its keys, recomputing S^T = K Q^T and P^T from lse; the sum over
//       heads and query blocks is in that fixed order;
//   (c) bwd_dq_*: one CTA per (batch, head, block of queries) keeps dQ in
//       registers and walks the key blocks its rows see (the forward's key
//       range), recomputing S, P and dP.
// P and dS are rounded to bf16 as the A operand of their products, as p
// is in the forward.  Three routes, picked by (dtype, d) alone
// (bwd_route below; the wrapper counts each in launches_by_route):
//
// * bfloat16, d in {64, 128}: bwd_dkdv_bf16_wgmma and bwd_dq_bf16_wgmma,
//   the training path's kernels, FA3's shape.  The tensor cores bound
//   them, and only wgmma reaches their full rate, with operands that
//   arrive without the consumers' issue slots.  Each CTA is two consumer
//   warpgroups and one producer warp's thread (384 threads; the producer
//   drops to 24 registers with setmaxnreg, the consumers rise to 240):
//   - dK/dV: a CTA owns 128 keys (64 a consumer warpgroup) and loads K and
//     V once; the producer keeps TMA loads of each step's Q and dO (64
//     query rows of head h; 4-D tensor maps over the tensors as they lie,
//     128-byte swizzle, rows past Sq zero-filled) and bulk copies of its
//     lse and D rows in flight through a ring of three stages with
//     full/empty mbarriers.  S^T = K Q^T and dP^T = V dO^T are wgmma
//     m64n64k16 with both operands in shared memory; P^T and dS^T stay in
//     registers and feed dV += P^T dO and dK += dS^T Q as the A operand of
//     wgmma m64n{d}k16, B (dO, Q) read MN-major through the transposed-B
//     bit, as the forward reads V;
//   - dQ: shaped like flash_fwd_bf16_wgmma: a CTA owns 128 query rows of
//     one head and loads Q and dO once; a TMA ring of K/V blocks of 64
//     keys feeds S = Q K^T and dP = dO V^T (SS) and dQ += dS K (RS, K read
//     MN-major);
//   - the D pre-pass writes D and lse log2(e) in rows padded to 128 (zero
//     past Sq), so that a step's rows are one aligned bulk copy and
//     P = exp2(S scale log2(e) - lse log2(e)) is one FMA and ex2;
//   - only edge blocks evaluate the mask: the mask-free sub-ranges need
//     whole blocks of rows and keys (rows past Sq and keys past Skv always
//     take the mask), and a masked P is a select (lse is -inf on a row
//     that sees no key, where exp would give inf and inf 0 NaN);
//   - launch order, the longest CTAs first: dK/dV key blocks from the
//     first (under the causal mask key block n of 128 sees 64 - 2n query
//     blocks of 64 a head at the training shape), dQ query blocks from
//     the last, as the forward orders them.  schedule.py:bwd_schedule
//     computes the same ranges and order, and tiled_bwd_ref follows them.
//   A single pass that adds dQ into a float32 workspace in a fixed order
//   would issue 10 d; it is later work (ROADMAP.md).
// * bfloat16, d in {16, 32}: bwd_dkdv_bf16 and bwd_dq_bf16, mma.sync
//   m16n8k16 with float32 accumulators, cp.async loads (FA2's shape):
//   wgmma's 128-byte swizzle wants rows of at least 64 bf16.
// * float32: bwd_dkdv_f32 and bwd_dq_f32, CUDA-core FMAs in full float32.
#include "attn_common.cuh"
#include "tensor_map.cuh"
#include "wgmma.cuh"

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
// the (B, ld, H) rows, rows i >= Sq giving 0.  Dd and Lp have rows of
// ``ld`` >= Sq floats; with a non-null Lp, Lp[b, h, i] = lse[b, h, i]
// log2(e) (0 past Sq).  The wgmma route pads ld to a multiple of 128 so
// that a block of rows starts 16-byte aligned (bulk copies) and rows past
// Sq read zeros; the other routes take ld = Sq and no Lp.
template <class T>
__global__ void bwd_row_dot(const T* __restrict__ dout,
                            const T* __restrict__ o,
                            const float* __restrict__ lse,
                            float* __restrict__ Dd, float* __restrict__ Lp,
                            int Sq, int H, int D, int ld, long long rows) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long h = row % H, bi = row / H;
  const long long b = bi / ld, i = bi % ld;
  float s = 0.f;
  if (i < Sq) {
    const long long off = ((b * Sq + i) * H + h) * D;
    for (int j = lane; j < D; j += 32)
      s += to_f(dout[off + j]) * to_f(o[off + j]);
    s = warp_sum(s);
  }
  if (lane == 0) {
    const long long out = (b * H + h) * ld + i;
    Dd[out] = s;
    if (Lp != nullptr)
      Lp[out] = i < Sq ? lse[(b * H + h) * Sq + i] * 1.4426950408889634f
                       : 0.f;
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
// bfloat16, d in {16, 32}: mma.sync m16n8k16
// ---------------------------------------------------------------------------
constexpr int KB = 64;  // keys per CTA of the dK/dV kernel (16 a warp)
constexpr int QB = 64;  // query rows per CTA of the dQ kernel (16 a warp)
template <int D>
struct Tile {
  // queries per step of the dK/dV kernel and keys per step of the dQ one
  static constexpr int M = 64;
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
// bfloat16, d in {64, 128}: wgmma, TMA rings, warp-specialised producers
// ---------------------------------------------------------------------------
namespace wgb {

using attn_kernels::tma_load_4d;
using namespace attn_kernels::wg;

constexpr int kThreads = 384;  // 2 consumer warpgroups + 1 producer
constexpr int KVB = 128;  // keys per dK/dV CTA: 64 per consumer warpgroup
constexpr int QS = 64;    // query rows per step of the dK/dV kernel
constexpr int QR = 128;   // query rows per dQ CTA: 64 per consumer warpgroup
constexpr int KS = 64;    // keys per step of the dQ kernel
constexpr int kRing = 3;  // stages of either kernel's ring
constexpr int kRowPad = 128;  // lse and D rows padded to a multiple of this

template <int D>
struct DkdvLayout {  // byte offsets from a 1024-byte aligned base
  static constexpr int kTileK = KVB * D * 2;  // K or V: 128 keys
  static constexpr int kHalfK = KVB * 128;    // a 64-dim half of that tile
  static constexpr int kTileQ = QS * D * 2;   // Q or dO: 64 rows
  static constexpr int kHalfQ = QS * 128;
  static constexpr int kK = 0;
  static constexpr int kV = kTileK;
  static constexpr int kQ = 2 * kTileK;  // stage s at kQ + s * kTileQ
  static constexpr int kO = kQ + kRing * kTileQ;
  static constexpr int kL = kO + kRing * kTileQ;   // lse log2(e): QS floats
  static constexpr int kDd = kL + kRing * QS * 4;  // D: QS floats a stage
  static constexpr int kBars = kDd + kRing * QS * 4;
  // bar_kv, full[kRing], empty[kRing]
  static constexpr int kBytes = kBars + (1 + 2 * kRing) * 8;
  static constexpr size_t kSmem = kBytes + 1024;  // + alignment slack
};

template <int D>
struct DqLayout {
  static constexpr int kTileQ = QR * D * 2;  // Q or dO: 128 rows
  static constexpr int kHalfQ = QR * 128;
  static constexpr int kTileK = KS * D * 2;  // K or V: 64 keys
  static constexpr int kHalfK = KS * 128;
  static constexpr int kQ = 0;
  static constexpr int kO = kTileQ;
  static constexpr int kK = 2 * kTileQ;  // stage s at kK + s * kTileK
  static constexpr int kV = kK + kRing * kTileK;
  static constexpr int kBars = kV + kRing * kTileK;
  // bar_q, full[kRing], empty[kRing]
  static constexpr int kBytes = kBars + (1 + 2 * kRing) * 8;
  static constexpr size_t kSmem = kBytes + 1024;
};

// ``bytes`` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory, counted on ``bar`` (whose expect_tx announced them)
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// a 64 x 64 f32 accumulator as the bf16 A operand of four m64nNk16
// products (k-step kk: its columns 16 kk .. 16 kk + 15)
__device__ __forceinline__ void pack_a(const float (&s)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    a[c >> 1][(c & 1) * 2] = pack_bf16x2(s[c * 4], s[c * 4 + 1]);
    a[c >> 1][(c & 1) * 2 + 1] = pack_bf16x2(s[c * 4 + 2], s[c * 4 + 3]);
  }
}
__device__ __forceinline__ void fence_a(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
}

// acc (64 x 64) = A B^T over the head dim: A the 64 rows of a K-major
// tile at ``a`` whose 64-dim halves lie ``half_a`` bytes apart, B the
// same at ``b``
template <int D>
__device__ __forceinline__ void ss_64x64(float (&acc)[32], uint32_t a,
                                         uint32_t half_a, uint32_t b,
                                         uint32_t half_b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(acc,
                 desc_sw128(a + (kk >> 2) * half_a + (kk & 3) * 32, 16, 1024),
                 desc_sw128(b + (kk >> 2) * half_b + (kk & 3) * 32, 16, 1024),
                 kk > 0 ? 1 : 0);
}
// acc (64 x D) += A (64 x 64, registers) B (64 x D: the 64 rows of a tile
// at ``b`` read MN-major, its 64-dim halves ``half_b`` bytes apart)
template <int D>
__device__ __forceinline__ void rs_64xd(float (&acc)[D / 2],
                                        const uint32_t (&a)[4][4], uint32_t b,
                                        uint32_t half_b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_sw128(b + kk * 16 * 128, half_b, 1024);
    if constexpr (D == 128)
      wgmma_rs_n128(acc, a[kk], db);
    else
      wgmma_rs_n64(acc, a[kk], db);
  }
}

}  // namespace wgb

// (b) dK, dV of 128 keys of one KV head.  Grid: one CTA per (key block,
// batch, KV head), key blocks slowest and from the first: under the
// causal mask the first key block sees the most query rows, so the
// longest CTAs start first.  Consumer warpgroup w owns keys n0 + 64 w ..;
// the producer walks the G heads of the group and, in each, the query
// blocks of 64 rows [qb_lo, qb_hi) that see a key of the block;
// [qf_lo, qf_hi) need no mask (schedule.py:bwd_schedule computes the
// same).
template <int D>
__global__ void __launch_bounds__(wgb::kThreads, 1) bwd_dkdv_bf16_wgmma(
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_o, const float* __restrict__ Lp,
    const float* __restrict__ Dd, int ld, uint16_t* __restrict__ dk,
    uint16_t* __restrict__ dv, int B, int Sq, int Skv, int Kh, int G,
    int causal, int window, int q_offset, float sl2, float scale) {
  using namespace wgb;
  using L = DkdvLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_kv = base + L::kBars;
  auto full = [&](int s) { return bar_kv + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_kv + 8u * (1 + kRing + s); };

  int rest = blockIdx.x;
  const int kvh = rest % Kh;
  rest /= Kh;
  const int b = rest % B, kb = rest / B;
  const int n0 = kb * KVB, n1 = min(n0 + KVB, Skv);
  const int H = Kh * G;

  int i_lo, i_hi;
  query_range(n0, n1, Sq, causal, window, q_offset, i_lo, i_hi);
  const int qb_lo = i_lo / QS;
  const int qb_hi = i_hi > i_lo ? (i_hi + QS - 1) / QS : qb_lo;
  // mask-free query blocks: whole blocks of rows and keys, every row at
  // or after the last key's causal limit and before the first key's
  // window end
  int qf_lo = causal ? (max(0, n0 + KVB - 1 - q_offset) + QS - 1) / QS : 0;
  int qf_hi = (causal && window > 0)
                  ? max(0, min(Sq, n0 - q_offset + window)) / QS
                  : Sq / QS;
  if (n0 + KVB > Skv) qf_hi = qf_lo;
  qf_lo = min(max(qf_lo, qb_lo), qb_hi);
  qf_hi = max(min(qf_hi, qb_hi), qf_lo);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tm_q))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tm_o))
                   : "memory");
      mbar_expect_tx(bar_kv, 2 * L::kTileK);
#pragma unroll
      for (int hh = 0; hh < D / 64; ++hh) {
        tma_load_4d(sK + hh * L::kHalfK, &tm_k, bar_kv, hh * 64, kvh, n0, b);
        tma_load_4d(sV + hh * L::kHalfK, &tm_v, bar_kv, hh * 64, kvh, n0, b);
      }
      int i = 0;
      for (int gg = 0; gg < G; ++gg) {
        const int h = kvh * G + gg;
        const long long row0 = ((long long)b * H + h) * ld;
        for (int qb = qb_lo; qb < qb_hi; ++qb, ++i) {
          const int s = i % kRing;
          mbar_wait(empty(s), ((i / kRing) & 1) ^ 1);  // round 0 passes
          mbar_expect_tx(full(s), 2 * L::kTileQ + 2 * QS * 4);
#pragma unroll
          for (int hh = 0; hh < D / 64; ++hh) {
            tma_load_4d(base + L::kQ + s * L::kTileQ + hh * L::kHalfQ, &tm_q,
                        full(s), hh * 64, h, qb * QS, b);
            tma_load_4d(base + L::kO + s * L::kTileQ + hh * L::kHalfQ, &tm_o,
                        full(s), hh * 64, h, qb * QS, b);
          }
          bulk_g2s(base + L::kL + s * QS * 4, Lp + row0 + qb * QS, QS * 4,
                   full(s));
          bulk_g2s(base + L::kDd + s * QS * 4, Dd + row0 + qb * QS, QS * 4,
                   full(s));
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wgi = threadIdx.x >> 7;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, t = lane & 3;
    const int j0 = n0 + wgi * 64 + warp * 16 + gq;  // keys j0 and j0 + 8
    const uint32_t sKw = sK + wgi * 64 * 128, sVw = sV + wgi * 64 * 128;

    float dka[D / 2], dva[D / 2], st[32], dpt[32];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dka[x] = dva[x] = 0.f;
#pragma unroll
    for (int x = 0; x < 32; ++x) st[x] = dpt[x] = 0.f;
    uint32_t pa[4][4], da[4][4];

    mbar_wait(bar_kv, 0);
    int i = 0;
    for (int gg = 0; gg < G; ++gg) {
      for (int qb = qb_lo; qb < qb_hi; ++qb, ++i) {
        const int s = i % kRing;
        const uint32_t sQs = base + L::kQ + s * L::kTileQ;
        const uint32_t sOs = base + L::kO + s * L::kTileQ;
        const float* sL =
            reinterpret_cast<const float*>(gbase + L::kL + s * QS * 4);
        const float* sD =
            reinterpret_cast<const float*>(gbase + L::kDd + s * QS * 4);
        const bool edge = qb < qf_lo || qb >= qf_hi;
        const int m0 = qb * QS;
        mbar_wait(full(s), (i / kRing) & 1);
        // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries)
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
        ss_64x64<D>(st, sKw, L::kHalfK, sQs, L::kHalfQ);
        wgmma_commit();
        ss_64x64<D>(dpt, sVw, L::kHalfK, sOs, L::kHalfQ);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(st);
        // P^T = exp(S^T scale - lse), on the edge blocks 0 where masked
        // (a select: lse is -inf on a row that sees no key)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(sL + 8 * c + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2(fmaf(st[c * 4 + e], sl2, (e & 1) ? -l2.y : -l2.x));
            if (edge && !visible(m0 + 8 * c + 2 * t + (e & 1),
                                 j0 + 8 * (e >> 1), Sq, Skv, causal, window,
                                 q_offset))
              p = 0.f;
            st[c * 4 + e] = p;
          }
        }
        wgmma_wait<0>();
        fence_regs(dpt);
        // dS^T = P^T (dP^T - D)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(sD + 8 * c + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[c * 4 + e] =
                st[c * 4 + e] * (dpt[c * 4 + e] - ((e & 1) ? d2.y : d2.x));
        }
        pack_a(st, pa);
        pack_a(dpt, da);
        // dV += P^T dO, dK += dS^T Q (dO and Q read MN-major)
        fence_a(pa);
        fence_a(da);
        fence_regs(dva);
        fence_regs(dka);
        wgmma_fence();
        rs_64xd<D>(dva, pa, sOs, L::kHalfQ);
        rs_64xd<D>(dka, da, sQs, L::kHalfQ);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dva);
        fence_regs(dka);
        fence_a(pa);
        fence_a(da);
        if (lane == 0) mbar_arrive(empty(s));
      }
    }
    // dka[4c + e]: key j0 + 8 (e >> 1), dim 8c + 2t + (e & 1)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int j = j0 + 8 * rr;
      if (j >= Skv) continue;
      const long long off =
          (((long long)b * Skv + j) * Kh + kvh) * D + 2 * t;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        *reinterpret_cast<uint32_t*>(dk + off + c * 8) = pack_bf16x2(
            dka[c * 4 + 2 * rr] * scale, dka[c * 4 + 2 * rr + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + c * 8) =
            pack_bf16x2(dva[c * 4 + 2 * rr], dva[c * 4 + 2 * rr + 1]);
      }
    }
  }
}

// (c) dQ of 128 query rows of one head.  Grid: one CTA per (batch, KV
// head, query block, head of the group), in that order from the slowest
// to the fastest index, query blocks from the last one down (the
// forward's order: the longest first, the heads of a group side by side
// on their K/V).  Consumer warpgroup w owns rows m0 + 64 w ..; the
// producer loads Q and dO once, then the key blocks of 64 [jb_lo, jb_hi)
// that the rows see; [jf_lo, jf_hi) need no mask.
template <int D>
__global__ void __launch_bounds__(wgb::kThreads, 1) bwd_dq_bf16_wgmma(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_o,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ Lp,
    const float* __restrict__ Dd, int ld, uint16_t* __restrict__ dq, int Sq,
    int Skv, int Kh, int G, int nqb, int causal, int window, int q_offset,
    float sl2, float scale) {
  using namespace wgb;
  using L = DqLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sO = base + L::kO;
  const uint32_t bar_q = base + L::kBars;
  auto full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + kRing + s); };

  int rest = blockIdx.x;
  const int g = rest % G;
  rest /= G;
  const int qb = nqb - 1 - rest % nqb;
  rest /= nqb;
  const int kvh = rest % Kh, b = rest / Kh;
  const int h = kvh * G + g, H = Kh * G;
  const int m0 = qb * QR, m1 = min(m0 + QR, Sq);

  int kv_lo, kv_hi;
  key_range(m0, m1, Skv, causal, window, q_offset, kv_lo, kv_hi);
  const int jb_lo = kv_lo / KS;
  const int jb_hi = kv_hi > kv_lo ? (kv_hi + KS - 1) / KS : jb_lo;
  // mask-free key blocks: the forward's sub-range, none in a ragged last
  // query block
  int jf_lo = (causal && window > 0)
                  ? (max(0, m1 + q_offset - window) + KS - 1) / KS
                  : 0;
  int jf_hi = (causal ? min(Skv, m0 + q_offset + 1) : Skv) / KS;
  if (m0 + QR > Sq) jf_hi = jf_lo;
  jf_lo = min(max(jf_lo, jb_lo), jb_hi);
  jf_hi = max(min(jf_hi, jb_hi), jf_lo);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tm_k))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tm_v))
                   : "memory");
      mbar_expect_tx(bar_q, 2 * L::kTileQ);
#pragma unroll
      for (int hh = 0; hh < D / 64; ++hh) {
        tma_load_4d(sQ + hh * L::kHalfQ, &tm_q, bar_q, hh * 64, h, m0, b);
        tma_load_4d(sO + hh * L::kHalfQ, &tm_o, bar_q, hh * 64, h, m0, b);
      }
      for (int j = jb_lo, i = 0; j < jb_hi; ++j, ++i) {
        const int s = i % kRing;
        mbar_wait(empty(s), ((i / kRing) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kTileK);
#pragma unroll
        for (int hh = 0; hh < D / 64; ++hh) {
          tma_load_4d(base + L::kK + s * L::kTileK + hh * L::kHalfK, &tm_k,
                      full(s), hh * 64, kvh, j * KS, b);
          tma_load_4d(base + L::kV + s * L::kTileK + hh * L::kHalfK, &tm_v,
                      full(s), hh * 64, kvh, j * KS, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wgi = threadIdx.x >> 7;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, t = lane & 3;
    const int r0 = m0 + wgi * 64 + warp * 16 + gq;  // rows r0 and r0 + 8
    const uint32_t sQw = sQ + wgi * 64 * 128, sOw = sO + wgi * 64 * 128;
    // rows past Sq read the padding (0), within ld
    const long long li = ((long long)b * H + h) * ld + r0;
    const float nl0 = -Lp[li], nl1 = -Lp[li + 8];
    const float dd0 = Dd[li], dd1 = Dd[li + 8];

    float acc[D / 2], sc[32], dp[32];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = dp[x] = 0.f;
    uint32_t da[4][4];

    mbar_wait(bar_q, 0);
    for (int j = jb_lo, i = 0; j < jb_hi; ++j, ++i) {
      const int s = i % kRing;
      const uint32_t sKs = base + L::kK + s * L::kTileK;
      const uint32_t sVs = base + L::kV + s * L::kTileK;
      const bool edge = j < jf_lo || j >= jf_hi;
      mbar_wait(full(s), (i / kRing) & 1);
      // S = Q K^T and dP = dO V^T (64 rows x 64 keys)
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      ss_64x64<D>(sc, sQw, L::kHalfQ, sKs, L::kHalfK);
      wgmma_commit();
      ss_64x64<D>(dp, sOw, L::kHalfQ, sVs, L::kHalfK);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      // P = exp(S scale - lse), on the edge blocks 0 where masked
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(sc[c * 4 + e], sl2, (e & 2) ? nl1 : nl0));
          if (edge && !visible(r0 + 4 * (e & 2),
                               j * KS + 8 * c + 2 * t + (e & 1), Sq, Skv,
                               causal, window, q_offset))
            p = 0.f;
          sc[c * 4 + e] = p;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS = P (dP - D)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[c * 4 + e] =
              sc[c * 4 + e] * (dp[c * 4 + e] - ((e & 2) ? dd1 : dd0));
      }
      pack_a(dp, da);
      // dQ += dS K (K read MN-major)
      fence_a(da);
      fence_regs(acc);
      wgmma_fence();
      rs_64xd<D>(acc, da, sKs, L::kHalfK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_a(da);
      if (lane == 0) mbar_arrive(empty(s));
    }
    // acc[4c + e]: row r0 + 8 (e >> 1), dim 8c + 2t + (e & 1)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r0 + 8 * rr;
      if (r >= Sq) continue;
      const long long off = (((long long)b * Sq + r) * H + h) * D + 2 * t;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(dq + off + c * 8) = pack_bf16x2(
            acc[c * 4 + 2 * rr] * scale, acc[c * 4 + 2 * rr + 1] * scale);
    }
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
enum BwdRoute { BWD_F32 = 0, BWD_BF16_MMA_SYNC = 1, BWD_BF16_WGMMA = 2 };

inline int bwd_route(int dtype, int D) {
  if (dtype == 0) return BWD_F32;
  return (D == 64 || D == 128) ? BWD_BF16_WGMMA : BWD_BF16_MMA_SYNC;
}

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
    if constexpr (D > 32) {
      return cudaErrorInvalidValue;  // the wgmma route
    } else {
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
    }
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

// the wgmma route's two kernels, after the D pre-pass filled Lp and Dd
// (rows of ld floats)
template <int D>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const float* Lp,
                             const float* Dd, int ld, void* dq, void* dk,
                             void* dv, int B, int Sq, int Skv, int H, int Kh,
                             int causal, int window, int q_offset,
                             float scale, cudaStream_t s) {
  using namespace wgb;
  using attn_kernels::EncodeTiledFn;
  using attn_kernels::encode_heads_map;
  const EncodeTiledFn enc = attn_kernels::tensor_map_encoder();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  const long long q_rs = (long long)H * D, k_rs = (long long)Kh * D;
  const long long q_bs = q_rs * Sq, k_bs = k_rs * Skv;
  // dK/dV: K, V in boxes of 128 keys, Q, dO of 64 rows; dQ: Q, dO of 128
  // rows, K, V of 64 keys
  CUtensorMap k128, v128, q64, o64, q128, o128, k64, v64;
  if (!encode_heads_map(enc, &k128, k, D, Kh, Skv, B, k_rs, k_bs, KVB) ||
      !encode_heads_map(enc, &v128, v, D, Kh, Skv, B, k_rs, k_bs, KVB) ||
      !encode_heads_map(enc, &q64, q, D, H, Sq, B, q_rs, q_bs, QS) ||
      !encode_heads_map(enc, &o64, dout, D, H, Sq, B, q_rs, q_bs, QS) ||
      !encode_heads_map(enc, &q128, q, D, H, Sq, B, q_rs, q_bs, QR) ||
      !encode_heads_map(enc, &o128, dout, D, H, Sq, B, q_rs, q_bs, QR) ||
      !encode_heads_map(enc, &k64, k, D, Kh, Skv, B, k_rs, k_bs, KS) ||
      !encode_heads_map(enc, &v64, v, D, Kh, Skv, B, k_rs, k_bs, KS))
    return cudaErrorInvalidValue;
  static bool attr_set = false;  // per instantiation, set once
  cudaError_t e;
  if (!attr_set) {
    if ((e = max_smem(bwd_dkdv_bf16_wgmma<D>, DkdvLayout<D>::kSmem)) !=
        cudaSuccess)
      return e;
    if ((e = max_smem(bwd_dq_bf16_wgmma<D>, DqLayout<D>::kSmem)) !=
        cudaSuccess)
      return e;
    attr_set = true;
  }
  const int G = H / Kh;
  const long long nkb = (Skv + KVB - 1) / KVB, nqb = (Sq + QR - 1) / QR;
  const long long ctas_kv = nkb * B * Kh, ctas_q = (long long)B * Kh * nqb * G;
  if (ctas_kv > 0x7fffffffLL || ctas_q > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  constexpr float kLog2e = 1.4426950408889634f;
  bwd_dkdv_bf16_wgmma<D><<<(unsigned)ctas_kv, kThreads,
                           DkdvLayout<D>::kSmem, s>>>(
      k128, v128, q64, o64, Lp, Dd, ld, (uint16_t*)dk, (uint16_t*)dv, B, Sq,
      Skv, Kh, G, causal, window, q_offset, scale * kLog2e, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bwd_dq_bf16_wgmma<D><<<(unsigned)ctas_q, kThreads, DqLayout<D>::kSmem,
                         s>>>(q128, o128, k64, v64, Lp, Dd, ld,
                              (uint16_t*)dq, Sq, Skv, Kh, G, (int)nqb,
                              causal, window, q_offset, scale * kLog2e,
                              scale);
  return cudaGetLastError();
}

}  // namespace attn_bwd

// C entry point (bound with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// q, o, dout, dq (B, Sq, H, d) and k, v, dk, dv (B, Skv, K, d) contiguous
// in that layout; lse float32 (B, H, Sq).  ``scratch`` is float32
// scratch of flash_attention_bwd_scratch(B, H, Sq) floats.  ``route``
// receives the route (0 float32, 1 bf16 mma.sync, 2 bf16 wgmma) before
// the launches.  Returns the first CUDA error of the three launches,
// else 0.
extern "C" long long flash_attention_bwd_scratch(int B, int H, int Sq) {
  const long long ld =
      (Sq + attn_bwd::wgb::kRowPad - 1) / attn_bwd::wgb::kRowPad *
      attn_bwd::wgb::kRowPad;
  return 2LL * B * H * ld;  // D and lse log2(e), rows of ld
}

extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int H, int K, int D, int causal,
    int window, int q_offset, float scale, int dtype, int* route,
    void* stream) {
  using namespace attn_bwd;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || K <= 0 || H % K != 0 ||
      (dtype != 0 && dtype != 1) ||
      (D != 16 && D != 32 && D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  const int r = bwd_route(dtype, D);
  *route = r;
  cudaStream_t s = (cudaStream_t)stream;
  // the wgmma route reads D and lse in rows padded to kRowPad; the others
  // read D in rows of Sq
  const int ld = r == BWD_BF16_WGMMA
                     ? (Sq + wgb::kRowPad - 1) / wgb::kRowPad * wgb::kRowPad
                     : Sq;
  float* Dd = (float*)scratch;
  float* Lp = r == BWD_BF16_WGMMA ? Dd + (long long)B * H * ld : nullptr;
  const long long rows = (long long)B * ld * H;
  const long long blocks = (rows + 7) / 8;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const float* l = (const float*)lse;
  if (dtype == 1)
    bwd_row_dot<uint16_t><<<(unsigned)blocks, 256, 0, s>>>(
        (const uint16_t*)dout, (const uint16_t*)o, l, Dd, Lp, Sq, H, D, ld,
        rows);
  else
    bwd_row_dot<float><<<(unsigned)blocks, 256, 0, s>>>(
        (const float*)dout, (const float*)o, l, Dd, Lp, Sq, H, D, ld, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (r == BWD_BF16_WGMMA) {
    e = D == 128 ? launch_bwd_wgmma<128>(q, k, v, dout, Lp, Dd, ld, dq, dk, dv, B, Sq, Skv, H, K, causal, window, q_offset, scale, s)
                 : launch_bwd_wgmma<64>(q, k, v, dout, Lp, Dd, ld, dq, dk, dv, B, Sq, Skv, H, K, causal, window, q_offset, scale, s);
    return (int)e;
  }
  switch (D) {
    case 16: e = launch_bwd<16>(q, k, v, dout, l, Dd, dq, dk, dv, B, Sq, Skv, H, K, causal, window, q_offset, scale, dtype, s); break;
    case 32: e = launch_bwd<32>(q, k, v, dout, l, Dd, dq, dk, dv, B, Sq, Skv, H, K, causal, window, q_offset, scale, dtype, s); break;
    case 64: e = launch_bwd<64>(q, k, v, dout, l, Dd, dq, dk, dv, B, Sq, Skv, H, K, causal, window, q_offset, scale, dtype, s); break;
    default: e = launch_bwd<128>(q, k, v, dout, l, Dd, dq, dk, dv, B, Sq, Skv, H, K, causal, window, q_offset, scale, dtype, s); break;
  }
  return (int)e;
}
