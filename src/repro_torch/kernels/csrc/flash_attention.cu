// Flash attention, prefill (sm_90a).
//
//   o[b, i, h, :] = softmax_j(q[b,i,h,:] . k[b,j,h/G,:] / sqrt(d)) v[b,j,h/G,:]
//
// over the keys j that the mask allows: all j < Skv, and with ``causal``
// j <= i + q_offset and, with a window w > 0, j > i + q_offset - w.
// q (B, Sq, H, d), k/v (B, Skv, K, d) with G = H / K; k/v are read in place
// through their batch and row strides (the KV cache's slots [0, Skv)), and
// query head h reads KV head h / G: no repeated or transposed copy.
// Online softmax with float32 (acc, m, l); p is rounded to bf16 before p.v
// and l sums the unrounded p; the output is acc / max(l, 1e-30), in q's
// type.  Given a non-null ``lse`` (float32 (B, H, Sq)), every route also
// writes m + log l of each query row in the natural-log scale of the
// scaled logits, -inf for a row that sees no key: the statistic the
// backward kernel (flash_attention_bwd.cu) recomputes p from.  With a null
// pointer (serving) nothing else changes.  Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py:86).
//
// Three routes, picked by (dtype, d) alone (flash_route below):
//
// * bfloat16, d in {64, 128}: flash_fwd_bf16_wgmma, the serving path's
//   kernel.  What bounds it: operations.  A visible (query, key) pair costs
//   4 d FLOP on K/V bytes that every query block of a window re-reads, so
//   at the serving shape the work is ~1.86 TFLOP a layer against ~0.3 GB
//   of inputs: the tensor cores, not HBM, set the floor.  Only wgmma runs
//   them at full rate, and only if the operands arrive without spending
//   the consumers' issue slots on loads.  So:
//   - a CTA owns 128 query rows of one head: two consumer warpgroups of 64
//     rows, plus one producer warpgroup (384 threads, one CTA per SM);
//   - the producer's one thread loads Q once and then K/V blocks of 128
//     keys with TMA (4-D tensor maps over the tensors as they lie,
//     128-byte swizzle, rows past Sq/Skv zero-filled) into a ring of
//     three stages guarded by full/empty mbarriers; it drops to 24
//     registers (setmaxnreg) and the consumers rise to 240;
//   - S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//     (K is K-major as the cache holds it); O += P V is wgmma m64n{d}k16
//     with P from registers (the S accumulator repacked as bf16 pairs) and
//     V from shared memory through the transposed-B bit: no copy of V;
//   - the key-block range of a query block and its mask-free sub-range
//     come from (q block, q_offset, window, Skv) (block_schedule in
//     kernels/flash_attention/schedule.py computes the same): only the
//     edge blocks, at most two of about 33 at the serving shape, evaluate
//     the per-element mask; exp2 with scale * log2(e) folded into one FMA;
//   - launch order: the G query heads of one KV head next to each other,
//     then neighbouring query blocks, longest (last) query block first, so
//     that CTAs resident together share their K/V blocks in L2.
//   - inside a warpgroup, Q K^T of block j and P V of block j - 1 are
//     issued together, and the softmax of block j runs while P V is in
//     flight; so the consumers hold two stages at once, and the third
//     stage lets the producer load block j + 1 meanwhile.
//   The two consumer warpgroups are not ordered against each other: the
//   warp schedulers interleave one's softmax with the other's products.
// * bfloat16, d in {16, 32}: flash_fwd_bf16_small, 64 query rows per CTA,
//   16 per warp, mma.sync m16n8k16, K/V blocks of 64 keys double-buffered
//   by cp.async.  wgmma's 128-byte swizzle wants rows of at least 64 bf16.
// * float32: flash_fwd_f32, 32 query rows per CTA, four threads per row,
//   CUDA-core FMAs in full float32 (no TF32).
#include "attn_common.cuh"
#include "tensor_map.cuh"
#include "wgmma.cuh"

namespace attn_kernels {

constexpr int FA_THREADS = 128;  // 4 warps (small bf16 and float32 routes)

// ---------------------------------------------------------------------------
// bfloat16, d in {64, 128}: wgmma, TMA ring, warp-specialised producer
// ---------------------------------------------------------------------------
namespace wg {

constexpr int BM = 128;  // query rows per CTA: two consumer warpgroups of 64
constexpr int BN = 128;  // keys per block
constexpr int kStages = 3;
constexpr int kThreads = 384;  // 2 consumer warpgroups + 1 producer
constexpr int kHalfQ = BM * 128;   // bytes of a 64-column half of the Q tile
constexpr int kHalfKV = BN * 128;  // the same of a K or V tile
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Layout {  // byte offsets from a 1024-byte aligned base
  static constexpr int kTileQ = BM * D * 2;
  static constexpr int kTileKV = BN * D * 2;
  static constexpr int kK = kTileQ;
  static constexpr int kV = kK + kStages * kTileKV;
  static constexpr int kBars = kV + kStages * kTileKV;
  // bar_q, full_k[kStages], full_v[kStages], empty[kStages]
  static constexpr int kBytes = kBars + (1 + 3 * kStages) * 8;
  static constexpr size_t kSmem = kBytes + 1024;  // + alignment slack
};

// Online softmax of one thread's share of a 64 x 128 logit block: rows
// qp0 - q_offset and that + 8 (the accumulator layout of wgmma m64n128:
// s[4c + e] is row + 8 * (e >> 1), key 8c + 2t + (e & 1)), float32 (m, l).
struct Softmax {
  float m0, m1, l0, l1, corr0, corr1, sl2;
  int qp0, t2, Skv, causal, window;

  __device__ __forceinline__ void init(int qpos, int t, int skv, int cz,
                                       int win, float scale_log2) {
    m0 = m1 = NEG_INF;
    l0 = l1 = 0.f;  // this thread's share; summed over the quad at the end
    qp0 = qpos;
    t2 = 2 * t;
    Skv = skv;
    causal = cz;
    window = win;
    sl2 = scale_log2;
  }
  // mask (edge blocks only), new maxima, correction factors, and p in
  // place of the logits; l takes the unrounded p
  __device__ __forceinline__ void step(float (&s)[64], int n0, bool edge) {
    if (edge) {
#pragma unroll
      for (int c = 0; c < 16; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = n0 + t2 + c * 8 + (e & 1);
          const int qp = qp0 + 4 * (e & 2);
          bool ok = kpos < Skv;
          if (causal) {
            ok = ok && kpos <= qp;
            if (window > 0) ok = ok && kpos > qp - window;
          }
          if (!ok) s[c * 4 + e] = NEG_INF;
        }
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      mx0 = fmaxf(mx0, fmaxf(s[c * 4], s[c * 4 + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[c * 4 + 2], s[c * 4 + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // logits and maxima stay unscaled: p = 2^(s sl2 - m sl2), one FMA.  A
    // row that has seen only masked keys (max -1e30) gets p = 1 on them,
    // as exp(-1e30 - -1e30) in the reference, and the next block with a
    // visible key wipes it (corr = 0).
    corr0 = ex2((m0 - mx0) * sl2);
    corr1 = ex2((m1 - mx1) * sl2);
    m0 = mx0;
    m1 = mx1;
    const float a0 = mx0 <= NEG_INF ? 0.f : sl2;
    const float a1 = mx1 <= NEG_INF ? 0.f : sl2;
    const float b0 = mx0 <= NEG_INF ? 0.f : -mx0 * sl2;
    const float b1 = mx1 <= NEG_INF ? 0.f : -mx1 * sl2;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      s[c * 4] = ex2(fmaf(s[c * 4], a0, b0));
      s[c * 4 + 1] = ex2(fmaf(s[c * 4 + 1], a0, b0));
      s[c * 4 + 2] = ex2(fmaf(s[c * 4 + 2], a1, b1));
      s[c * 4 + 3] = ex2(fmaf(s[c * 4 + 3], a1, b1));
      ls0 += s[c * 4] + s[c * 4 + 1];
      ls1 += s[c * 4 + 2] + s[c * 4 + 3];
    }
    l0 = l0 * corr0 + ls0;
    l1 = l1 * corr1 + ls1;
  }
  // O *= corr, row by row (the accumulator layout of wgmma m64n{D})
  template <int D>
  __device__ __forceinline__ void rescale(float (&acc)[D / 2]) const {
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      acc[c * 4] *= corr0;
      acc[c * 4 + 1] *= corr0;
      acc[c * 4 + 2] *= corr1;
      acc[c * 4 + 3] *= corr1;
    }
  }
  // p rounded to bf16 pairs as the A operand of P V: k-step kk takes keys
  // 16kk..16kk+15, i.e. the S accumulator's column chunks 2kk and 2kk + 1
  __device__ __forceinline__ static void pack(const float (&s)[64],
                                              uint32_t (&pa)[8][4]) {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      pa[c >> 1][(c & 1) * 2] = pack_bf16x2(s[c * 4], s[c * 4 + 1]);
      pa[c >> 1][(c & 1) * 2 + 1] = pack_bf16x2(s[c * 4 + 2], s[c * 4 + 3]);
    }
  }
};

}  // namespace wg

// Grid: one CTA per (batch, KV head, query block, head of the group), in
// that order from the slowest to the fastest index, query blocks from the
// last one down.
template <int D>
__global__ void __launch_bounds__(wg::kThreads, 1) flash_fwd_bf16_wgmma(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, uint16_t* __restrict__ o,
    float* __restrict__ lse, int Sq, int Skv, int Kh, int G, int nqb,
    long long o_bs, long long o_rs, int causal, int window, int q_offset,
    float sl2) {
  using namespace wg;
  using L = Layout<D>;
  constexpr int HALVES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_q = base + L::kBars;
  auto full_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + 2 * kStages + s); };

  int rest = blockIdx.x;
  const int g = rest % G;
  rest /= G;
  const int qb = nqb - 1 - rest % nqb;
  rest /= nqb;
  const int kvh = rest % Kh, b = rest / Kh;
  const int h = kvh * G + g;
  const int m0 = qb * BM, m1 = min(m0 + BM, Sq);

  // Key blocks [jb_lo, jb_hi) that hold a visible key for some row of the
  // query block, and the sub-range [jf_lo, jf_hi) where every (row, key)
  // pair is visible, so no mask is evaluated (schedule.py:block_schedule).
  int kv_lo = 0, kv_hi = Skv;
  if (causal) {
    kv_hi = min(Skv, m1 + q_offset);
    if (window > 0) kv_lo = max(0, m0 + q_offset - window + 1);
  }
  const int jb_lo = kv_lo / BN;
  const int jb_hi = kv_hi > kv_lo ? (kv_hi + BN - 1) / BN : jb_lo;
  int jf_lo = (causal && window > 0)
                  ? (max(0, m1 + q_offset - window) + BN - 1) / BN
                  : 0;
  int jf_hi = (causal ? min(Skv, m0 + q_offset + 1) : Skv) / BN;
  jf_lo = min(max(jf_lo, jb_lo), jb_hi);
  jf_hi = max(min(jf_hi, jb_hi), jf_lo);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
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
                       reinterpret_cast<uint64_t>(&tm_k))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tm_v))
                   : "memory");
      mbar_expect_tx(bar_q, L::kTileQ);
#pragma unroll
      for (int hh = 0; hh < HALVES; ++hh)
        tma_load_4d(sQ + hh * kHalfQ, &tm_q, bar_q, hh * 64, h, m0, b);
      for (int j = jb_lo, i = 0; j < jb_hi; ++j, ++i) {
        const int s = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        mbar_wait(empty(s), ph ^ 1);  // the first round passes at once
        mbar_expect_tx(full_k(s), L::kTileKV);
#pragma unroll
        for (int hh = 0; hh < HALVES; ++hh)
          tma_load_4d(sK + s * L::kTileKV + hh * kHalfKV, &tm_k, full_k(s),
                      hh * 64, kvh, j * BN, b);
        mbar_expect_tx(full_v(s), L::kTileKV);
#pragma unroll
        for (int hh = 0; hh < HALVES; ++hh)
          tma_load_4d(sV + s * L::kTileKV + hh * kHalfKV, &tm_v, full_v(s),
                      hh * 64, kvh, j * BN, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wgi = threadIdx.x >> 7;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, t = lane & 3;
    const int r0 = m0 + wgi * 64 + warp * 16 + gq;  // rows r0 and r0 + 8
    const uint32_t sQw = sQ + wgi * 64 * 128;  // this warpgroup's rows
    Softmax sm;
    sm.init(r0 + q_offset, t, Skv, causal, window, sl2);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    uint32_t pa[8][4];

    // S = Q K^T of the block in stage s
    auto issue_qk = [&](int s) {
      const uint32_t sKs = sK + s * L::kTileKV;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n128(sc,
                      desc_sw128(sQw + (kk >> 2) * kHalfQ + (kk & 3) * 32, 16,
                                 1024),
                      desc_sw128(sKs + (kk >> 2) * kHalfKV + (kk & 3) * 32,
                                 16, 1024),
                      kk > 0 ? 1 : 0);
      wgmma_commit();
    };
    // O += P V of the block in stage s
    auto issue_pv = [&](int s) {
      const uint32_t sVs = sV + s * L::kTileKV;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t dv = desc_sw128(sVs + kk * 16 * 128, kHalfKV, 1024);
        if constexpr (D == 128)
          wgmma_rs_n128(acc, pa[kk], dv);
        else
          wgmma_rs_n64(acc, pa[kk], dv);
      }
      wgmma_commit();
    };
    auto fence_all = [&]() {
      fence_regs(acc);
      fence_regs(sc);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) fence_regs(pa[kk]);
    };

    mbar_wait(bar_q, 0);
    const int n = jb_hi - jb_lo;
    if (n > 0) {
      // block 0: Q K^T alone
      mbar_wait(full_k(0), 0);
      fence_all();
      wgmma_fence();
      issue_qk(0);
      wgmma_wait<0>();
      fence_regs(sc);
      sm.step(sc, jb_lo * BN, jb_lo < jf_lo || jb_lo >= jf_hi);
      sm.pack(sc, pa);
      // block i: Q K^T of block i and P V of block i - 1 issued together;
      // the softmax of block i runs while P V is in flight
      for (int i = 1; i < n; ++i) {
        const int j = jb_lo + i;
        const int s = i % kStages, sp = (i - 1) % kStages;
        mbar_wait(full_k(s), (i / kStages) & 1);
        mbar_wait(full_v(sp), ((i - 1) / kStages) & 1);
        fence_all();
        wgmma_fence();
        issue_qk(s);
        issue_pv(sp);
        wgmma_wait<1>();  // Q K^T done
        fence_regs(sc);
        sm.step(sc, j * BN, j < jf_lo || j >= jf_hi);
        wgmma_wait<0>();  // P V done: stage sp is free, O may be rescaled
        fence_all();
        if (lane == 0) mbar_arrive(empty(sp));
        sm.rescale<D>(acc);
        sm.pack(sc, pa);
      }
      // the last block's P V
      const int sp = (n - 1) % kStages;
      mbar_wait(full_v(sp), ((n - 1) / kStages) & 1);
      fence_all();
      wgmma_fence();
      issue_pv(sp);
      wgmma_wait<0>();
      fence_all();
      if (lane == 0) mbar_arrive(empty(sp));
    }
    float l_r0 = sm.l0, l_r1 = sm.l1;
    l_r0 += __shfl_xor_sync(0xffffffffu, l_r0, 1);
    l_r0 += __shfl_xor_sync(0xffffffffu, l_r0, 2);
    l_r1 += __shfl_xor_sync(0xffffffffu, l_r1, 1);
    l_r1 += __shfl_xor_sync(0xffffffffu, l_r1, 2);
    if (lse != nullptr && t == 0) {
      // m is kept unscaled: m scale + log l = (m sl2 + log2 l) ln 2
      float* lrow = lse + ((long long)b * Kh * G + h) * Sq;
      if (r0 < Sq)
        lrow[r0] = sm.m0 <= NEG_INF ? neg_inf()
                                    : (sm.m0 * sl2 + log2f(l_r0)) * kLn2;
      if (r0 + 8 < Sq)
        lrow[r0 + 8] = sm.m1 <= NEG_INF ? neg_inf()
                                        : (sm.m1 * sl2 + log2f(l_r1)) * kLn2;
    }
    l_r0 = fmaxf(l_r0, 1e-30f);
    l_r1 = fmaxf(l_r1, 1e-30f);
    // acc[4c + e]: row r0 + 8 * (e >> 1), dim 8c + 2t + (e & 1)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r0 + rr * 8;
      if (r >= Sq) continue;
      const float l = rr ? l_r1 : l_r0;
      uint16_t* orow = o + b * o_bs + (long long)r * o_rs + (long long)h * D;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(orow + c * 8 + 2 * t) = pack_bf16x2(
            acc[c * 4 + 2 * rr] / l, acc[c * 4 + 2 * rr + 1] / l);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16, d in {16, 32}: mma.sync tensor cores
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
__global__ void __launch_bounds__(FA_THREADS) flash_fwd_bf16_small(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
    float* __restrict__ lse, int Sq, int Skv, int G, long long q_bs,
    long long q_rs, long long k_bs, long long k_rs, long long v_bs,
    long long v_rs, long long o_bs, long long o_rs, int causal, int window,
    int q_offset, float scale) {
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
    const int r = r0 + rr * 8;
    if (lse != nullptr && t == 0 && r < Sq)
      lse[((long long)b * gridDim.y + h) * Sq + r] =
          m_r[rr] <= NEG_INF ? neg_inf() : m_r[rr] + logf(l_r[rr]);
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
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int Sq, int Skv, int G, long long q_bs,
    long long q_rs, long long k_bs, long long k_rs, long long v_bs,
    long long v_rs, long long o_bs, long long o_rs, int causal, int window,
    int q_offset, float scale) {
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
    if (lse != nullptr && part == 0)
      lse[((long long)b * gridDim.y + h) * Sq + r] =
          m <= NEG_INF ? neg_inf() : m + logf(l);
    l = fmaxf(l, 1e-30f);
    float4* o4 = reinterpret_cast<float4*>(o + b * o_bs + (long long)r * o_rs +
                                           (long long)h * D);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      o4[c * 4 + part] = make_float4(acc[c].x / l, acc[c].y / l,
                                     acc[c].z / l, acc[c].w / l);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
enum FlashRoute { ROUTE_F32 = 0, ROUTE_BF16_SMALL = 1, ROUTE_BF16_WGMMA = 2 };

inline int flash_route(int dtype, int D) {
  if (dtype == 0) return ROUTE_F32;
  return (D == 64 || D == 128) ? ROUTE_BF16_WGMMA : ROUTE_BF16_SMALL;
}

template <int D>
cudaError_t launch_flash_wgmma(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int Sq, int Skv,
                               int H, int Kh,
                               const long long* st, int causal, int window,
                               int q_offset, float scale, cudaStream_t s) {
  using L = wg::Layout<D>;
  const EncodeTiledFn enc = tensor_map_encoder();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap mq, mk, mv;
  if (!encode_heads_map(enc, &mq, q, D, H, Sq, B, st[1], st[0], wg::BM) ||
      !encode_heads_map(enc, &mk, k, D, Kh, Skv, B, st[3], st[2], wg::BN) ||
      !encode_heads_map(enc, &mv, v, D, Kh, Skv, B, st[5], st[4], wg::BN))
    return cudaErrorInvalidValue;
  static bool attr_set = false;  // per instantiation, set once
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L::kSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int G = H / Kh;
  const int nqb = (Sq + wg::BM - 1) / wg::BM;
  const long long ctas = (long long)B * Kh * nqb * G;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  constexpr float kLog2e = 1.4426950408889634f;
  flash_fwd_bf16_wgmma<D><<<(unsigned)ctas, wg::kThreads, L::kSmem, s>>>(
      mq, mk, mv, (uint16_t*)o, lse, Sq, Skv, Kh, G, nqb, st[6], st[7], causal,
      window, q_offset, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int Sq, int Skv, int H, int G,
                         const long long* st, int causal, int window,
                         int q_offset, float scale, int dtype,
                         cudaStream_t s) {
  if (dtype == 1) {
    if constexpr (D > 32) return cudaErrorInvalidValue;  // the wgmma route
    constexpr size_t smem = flash_bf16_smem<D>();
    static bool attr_set = false;  // per instantiation, set once
    if (!attr_set) {
      cudaError_t e = cudaFuncSetAttribute(
          flash_fwd_bf16_small<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return e;
      attr_set = true;
    }
    const dim3 grid((Sq + BM - 1) / BM, H, B);
    flash_fwd_bf16_small<D><<<grid, FA_THREADS, smem, s>>>(
        (const uint16_t*)q, (const uint16_t*)k, (const uint16_t*)v,
        (uint16_t*)o, lse, Sq, Skv, G, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], causal, window, q_offset, scale);
  } else {
    const dim3 grid((Sq + FBM - 1) / FBM, H, B);
    flash_fwd_f32<D><<<grid, FA_THREADS, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, Sq,
        Skv, G, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], causal,
        window, q_offset, scale);
  }
  return cudaGetLastError();
}

}  // namespace attn_kernels

// C entry point (bound with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// Strides are in elements: batch and row (sequence) strides of q, k, v, o;
// the head dim is contiguous and heads are packed (stride d).  ``route``
// receives the route taken (0 float32, 1 bf16 mma.sync, 2 bf16 wgmma)
// before the launch.  ``lse`` is null or a float32 (B, H, Sq) buffer that
// receives each row's log-sum-exp.  Returns cudaGetLastError() after the
// launch.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Sq,
    int Skv, int H, int K, int D, long long q_bs, long long q_rs,
    long long k_bs, long long k_rs, long long v_bs, long long v_rs,
    long long o_bs, long long o_rs, int causal, int window, int q_offset,
    float scale, int dtype, int* route, void* stream) {
  using namespace attn_kernels;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || K <= 0 || H % K != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long st[8] = {q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs};
  const int G = H / K;
  cudaStream_t s = (cudaStream_t)stream;
  const int r = flash_route(dtype, D);
  *route = r;
  float* l = (float*)lse;
  cudaError_t e;
  if (r == ROUTE_BF16_WGMMA) {
    if (D == 128)
      e = launch_flash_wgmma<128>(q, k, v, o, l, B, Sq, Skv, H, K, st, causal, window, q_offset, scale, s);
    else
      e = launch_flash_wgmma<64>(q, k, v, o, l, B, Sq, Skv, H, K, st, causal, window, q_offset, scale, s);
    return (int)e;
  }
  switch (D) {
    case 16: e = launch_flash<16>(q, k, v, o, l, B, Sq, Skv, H, G, st, causal, window, q_offset, scale, dtype, s); break;
    case 32: e = launch_flash<32>(q, k, v, o, l, B, Sq, Skv, H, G, st, causal, window, q_offset, scale, dtype, s); break;
    case 64: e = launch_flash<64>(q, k, v, o, l, B, Sq, Skv, H, G, st, causal, window, q_offset, scale, dtype, s); break;
    case 128: e = launch_flash<128>(q, k, v, o, l, B, Sq, Skv, H, G, st, causal, window, q_offset, scale, dtype, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}
