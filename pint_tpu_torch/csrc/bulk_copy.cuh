// bulk_copy.cuh: the copy ring of the two joint-Gram kernels
// (fused_gram_joint.cu, fused_gram_wide.cu): one lane copies a chunk's
// whole-row spans of global memory into a shared stage with
// cp.async.bulk, completing on the stage's mbarrier.
//
// Every mbarrier wait gives up with __trap() after ~1 s, so a phase error
// comes back as a launch failure, not a hung card.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initializes each mbarrier with its arrival count, then
// fences the inits before any other thread or the copy engine uses them.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Waits for the completion of the mbarrier phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 31)) __trap();  // ~1 s: a phase error
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t tx) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(tx)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :
      : "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The part of `bytes` of global `src` past its 16-byte body (< 16 bytes,
// only in a ragged last chunk) into shared `dst` by plain loads.  Returns
// the body's size, which the caller brings by one bulk copy; the plain
// stores come before the caller's arrive, which releases them.
template <typename E>
__device__ __forceinline__ uint32_t bulk_tail(unsigned char* dst,
                                              const E* src, int bytes) {
  const int body = bytes & ~15;
  for (int b = body; b < bytes; b += (int)sizeof(E))
    *reinterpret_cast<E*>(dst + b) = src[b / (int)sizeof(E)];
  return (uint32_t)body;
}
