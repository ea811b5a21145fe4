// Asynchronous copies from device memory into shared memory (cp.async,
// sm_80 and later), shared by the kernels that stream a plan through a ring
// of shared memory: K8/K9 (well_spmv.cu), K10 and K11 (bell_spmv.cu) and the
// pipelined sweep solves of K22/K23 (tri_walk.cuh).  Each
// thread copies 16 or 4 bytes; a thread commits its copies into groups and
// waits until at most N groups are still in flight, and a block barrier then
// publishes them to the block.  A plan that streams through L2 once can copy
// with an evict-first policy (K8/K9), so that x, gathered many times, keeps
// its place in L2.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ unsigned gk_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned long long gk_evict_first() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// -- cp.async -------------------------------------------------------------------

__device__ __forceinline__ void gk_cp16(void* dst, const void* src, unsigned long long policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
                   gk_smem_addr(dst)),
               "l"(src), "l"(policy)
               : "memory");
}

// 16 bytes with the default policy (a vector gathered again).
__device__ __forceinline__ void gk_cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(gk_smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void gk_cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(gk_smem_addr(dst)), "l"(src)
               : "memory");
}

// The first `bytes` (0 to 4) of 4 bytes at src, the rest zero (src is not
// read when bytes is 0).
__device__ __forceinline__ void gk_cp4_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(gk_smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// The first `bytes` (0 to 16) of 16 bytes at src, the rest zero, past L1.
__device__ __forceinline__ void gk_cp16_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(gk_smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void gk_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void gk_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- mbarriers (K11: a producer warp's copies signal the consumer warps) -----------

__device__ __forceinline__ void gk_mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(gk_smem_addr(bar)), "r"(count)
               : "memory");
}

// One arrival of the executing thread.
__device__ __forceinline__ void gk_mbar_arrive(unsigned long long* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(gk_smem_addr(bar))
      : "memory");
}

// One arrival once every cp.async the executing thread issued before has
// landed (the barrier's count includes it).
__device__ __forceinline__ void gk_cp_mbar_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(gk_smem_addr(bar))
               : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void gk_mbar_wait(unsigned long long* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "GK_MBAR_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra GK_MBAR_WAIT;\n"
      "}\n" ::"r"(gk_smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void gk_cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

