// mbarrier and 1-D bulk-copy (TMA) helpers shared by the kernels that feed
// a shared-memory ring through mbarriers: the graph kernels' tile walk
// (blocked_walk.cuh, 1-D bulk copies) and the decode-attention kernel
// (decode_attention.cu, TMA tensor boxes: tensor_map.cuh).
//
// A copy counts its bytes on an mbarrier (complete_tx); the barrier's
// phase completes once its expected arrivals have arrived and the bytes
// announced by expect_tx have landed.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// After one thread initialised the barriers: make them visible to the
// other threads and to the bulk-copy (async) proxy.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival on ``bar`` that also announces ``bytes`` of copies to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Bulk copy of ``bytes`` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory; completion is counted on ``bar``,
// which expects it (this is the copy's one arrival).  ``policy`` is an L2
// cache policy (createpolicy): evict-first for bytes read once per launch,
// so that what is reused (vectors, partials, states) stays.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar)),
      "l"(policy)
      : "memory");
}

// Allows ``kernel`` the dynamic shared memory ``bytes`` (above 48 KB it
// must be asked for).  ``allowed`` is the caller's record of what this
// kernel was allowed so far, so the attribute is set only when a launch
// needs more (never, in particular, inside a CUDA graph capture that
// follows a first eager call).  Returns a CUDA error code.
template <class K>
inline int allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == 0) allowed = bytes;
  return err;
}

}  // namespace hopper
