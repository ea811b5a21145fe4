// Shared helpers of the hand-written Hopper kernels (ginkgo_tpu_torch/csrc).
//
// Every translation unit that includes this header is built on its own into
// a shared library with a plain C interface (see ginkgo_tpu_torch/_build.py),
// so the extern "C" helpers below exist once per library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes shared with the Python wrappers (ginkgo_tpu_torch/ops/dia.py
// DTYPE_CODE, ops/pell.py INDEX_CODE)
enum GkDtype : int { GK_F32 = 0, GK_F64 = 1, GK_BF16 = 2, GK_I8 = 3, GK_I32 = 4 };

// Lanes of a plan tile or a panel: 128 consecutive rows or columns (the
// PELL, WELL and BELL layouts of the JAX package).
#define GK_LANES 128

// The DIA kernels take at most this many diagonals: the offsets travel by
// value in the kernel's parameter block (matrix/dia.py suitable_for_dia caps
// a DIA operator at 64 diagonals as well).
#define GK_MAX_DIAGS 64

struct GkOffsets {
  int nd;
  long long off[GK_MAX_DIAGS];
};

// Value loads widened to the accumulation type.
__device__ __forceinline__ float gk_to_float(float v) { return v; }
__device__ __forceinline__ float gk_to_float(double v) { return (float)v; }
__device__ __forceinline__ float gk_to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ double gk_to_double(double v) { return v; }
__device__ __forceinline__ double gk_to_double(float v) { return v; }
__device__ __forceinline__ double gk_to_double(__nv_bfloat16 v) {
  return (double)__bfloat162float(v);
}

template <typename T>
struct GkAcc;
template <>
struct GkAcc<float> {
  template <typename S>
  static __device__ __forceinline__ float load(S v) { return gk_to_float(v); }
};
template <>
struct GkAcc<double> {
  template <typename S>
  static __device__ __forceinline__ double load(S v) { return gk_to_double(v); }
};

extern "C" const char* gk_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
