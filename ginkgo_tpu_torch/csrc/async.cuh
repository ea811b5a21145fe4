// Asynchronous copies from device memory into shared memory (cp.async,
// sm_80 and later), shared by the kernels that stream a plan through a ring
// of shared memory: K8/K9 (well_spmv.cu) and K10 (bell_spmv.cu).  Each
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

// 4 bytes from src, or 4 zero bytes when !in (src is then not read).
__device__ __forceinline__ void gk_cp4_or_zero(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(gk_smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void gk_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void gk_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
