// Blocked-ELL (BELL) SpMV and SpMM for Hopper: kernels K10 and K11 of the
// PyTorch port.
//
// Replaces the Pallas TPU kernels of ginkgo_tpu/ops/pallas_bell.py:
//   K10 bell_spmv <- bell_spmv_pallas: _bell_kernel (x streamed panel by
//                    panel) and _bell_vmem_kernel (x resident in VMEM); the
//                    two compute the same function and differ only in how x
//                    reaches the TPU's VMEM, so one kernel serves both
//   K11 bell_spmm <- bell_spmm_pallas / _bell_spmm_kernel (an MXU dot per
//                    panel on the TPU)
//
// Layout (ginkgo_tpu_torch/matrix/bell.py): values (NRB, K, BR, 128) dense
// panels, float32 or bfloat16; panel_ids (NRB, K) int32, padding panels with
// id 0 and zero values.  Row r of row block rb = r / BR reads, from each of
// its K panels, the 128 lanes of x's panel pid:
//
//   y[r] = sum_k sum_l values[rb, k, r % BR, l] * x[128 * pid[rb, k] + l]
//
// with x's last panel cut at n_cols (columns past it read 0).  Padding
// panels are multiplied like any other, as on the TPU, so a NaN in
// x[0:128] reaches every row with a padding panel.  Vectors are float32 and
// the sums run in float32.
//
// Order: for each panel k in order, a lane sum from 0 over l = 0..127 in
// order, then the panel sum adds into the row's total (the TPU kernels add
// one lane-reduced panel after another; their lane reduction order is the
// hardware's, so the plain version fixes this one instead).  K11 keeps the
// same order for each of its columns.
//
// What bounds it on the H100: bytes, the panels read once (512 bytes a
// panel row in float32, 256 in bfloat16) against 2 flops a cell; x is read
// a panel at a time and stays in L1/L2.
//
// What the design does about it: one thread per row walks its K panels with
// 16-byte loads of its panel row (four float32 or eight bfloat16 values);
// the BR threads of a row block read the same x panel.  A warp's loads
// touch 32 panel rows at once, so each 128-byte line is used over eight
// loads from L1.  K11 reads each panel once for up to GK_BELL_COLS
// right-hand sides.  No tensor cores yet.

#include <stdint.h>

#include "common.cuh"

#define GK_BELL_THREADS 256
#define GK_BELL_COLS 8

// Eight consecutive panel values, widened to float (16-byte aligned).
__device__ __forceinline__ void gk_bell_load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void gk_bell_load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
}

// x[col .. col + 8), 0 past n_cols; a 16-byte load where x allows it.
__device__ __forceinline__ void gk_bell_x8(const float* __restrict__ x,
                                           long long col, long long n_cols,
                                           bool x_aligned, float* xv) {
  if (x_aligned && col + 8 <= n_cols) {
    gk_bell_load8(x + col, xv);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) xv[j] = col + j < n_cols ? x[col + j] : 0.0f;
}

template <typename TV>
__global__ void __launch_bounds__(GK_BELL_THREADS)
    bell_spmv_kernel(const TV* __restrict__ values, const int* __restrict__ pids,
                     int K, int BR, const float* __restrict__ x,
                     float* __restrict__ y, long long n_rows,
                     long long n_cols) {
  const long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const long long rb = row / BR;
  const int r = (int)(row % BR);
  const bool x_aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  float total = 0.0f;
  for (int k = 0; k < K; ++k) {
    const long long c0 = (long long)pids[rb * K + k] * GK_LANES;
    const TV* v = values + ((rb * K + k) * BR + r) * GK_LANES;
    float lane_sum = 0.0f;
    for (int l0 = 0; l0 < GK_LANES; l0 += 8) {
      float vv[8], xv[8];
      gk_bell_load8(v + l0, vv);
      gk_bell_x8(x, c0 + l0, n_cols, x_aligned, xv);
#pragma unroll
      for (int j = 0; j < 8; ++j) lane_sum += vv[j] * xv[j];
    }
    total += lane_sum;
  }
  y[row] = total;
}

template <typename TV>
__global__ void __launch_bounds__(GK_BELL_THREADS)
    bell_spmm_kernel(const TV* __restrict__ values, const int* __restrict__ pids,
                     int K, int BR, const float* __restrict__ X,
                     float* __restrict__ Y, long long n_rows, long long n_cols,
                     int k) {
  const long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const long long rb = row / BR;
  const int r = (int)(row % BR);
  const int cb = blockIdx.y * GK_BELL_COLS;
  const int kc = min(GK_BELL_COLS, k - cb);
  float total[GK_BELL_COLS];
#pragma unroll
  for (int c = 0; c < GK_BELL_COLS; ++c) total[c] = 0.0f;
  for (int p = 0; p < K; ++p) {
    const long long c0 = (long long)pids[rb * K + p] * GK_LANES;
    const TV* v = values + ((rb * K + p) * BR + r) * GK_LANES;
    float lane_sum[GK_BELL_COLS];
#pragma unroll
    for (int c = 0; c < GK_BELL_COLS; ++c) lane_sum[c] = 0.0f;
    for (int l0 = 0; l0 < GK_LANES; l0 += 8) {
      float vv[8];
      gk_bell_load8(v + l0, vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long col = c0 + l0 + j;
        const bool in = col < n_cols;
        const float* xr = X + (in ? col : 0) * k + cb;
#pragma unroll
        for (int c = 0; c < GK_BELL_COLS; ++c) {
          if (c < kc) lane_sum[c] += vv[j] * (in ? xr[c] : 0.0f);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < GK_BELL_COLS; ++c) total[c] += lane_sum[c];
  }
  float* yr = Y + row * k + cb;
#pragma unroll
  for (int c = 0; c < GK_BELL_COLS; ++c) {
    if (c < kc) yr[c] = total[c];
  }
}

template <typename TV>
static int launch_spmv(const void* values, const int* pids, int K, int BR,
                       const float* x, float* y, long long n_rows,
                       long long n_cols, cudaStream_t stream) {
  const long long blocks = (n_rows + GK_BELL_THREADS - 1) / GK_BELL_THREADS;
  bell_spmv_kernel<TV><<<(unsigned)blocks, GK_BELL_THREADS, 0, stream>>>(
      (const TV*)values, pids, K, BR, x, y, n_rows, n_cols);
  return (int)cudaGetLastError();
}

template <typename TV>
static int launch_spmm(const void* values, const int* pids, int K, int BR,
                       const float* X, float* Y, long long n_rows,
                       long long n_cols, int k, cudaStream_t stream) {
  const long long bx = (n_rows + GK_BELL_THREADS - 1) / GK_BELL_THREADS;
  const int by = (k + GK_BELL_COLS - 1) / GK_BELL_COLS;
  bell_spmm_kernel<TV><<<dim3((unsigned)bx, (unsigned)by), GK_BELL_THREADS, 0,
                         stream>>>((const TV*)values, pids, K, BR, X, Y,
                                   n_rows, n_cols, k);
  return (int)cudaGetLastError();
}

// values: float32 or bfloat16, 16-byte aligned; vectors float32.
extern "C" int bell_spmv(const void* values, int v_dtype, const int* pids,
                         int K, int BR, const float* x, float* y,
                         long long n_rows, long long n_cols, void* stream) {
  if (K < 1 || BR < 1) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  if (v_dtype == GK_F32)
    return launch_spmv<float>(values, pids, K, BR, x, y, n_rows, n_cols,
                              (cudaStream_t)stream);
  if (v_dtype == GK_BF16)
    return launch_spmv<__nv_bfloat16>(values, pids, K, BR, x, y, n_rows,
                                      n_cols, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int bell_spmm(const void* values, int v_dtype, const int* pids,
                         int K, int BR, const float* X, float* Y,
                         long long n_rows, long long n_cols, int k,
                         void* stream) {
  if (K < 1 || BR < 1) return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || k == 0) return 0;
  if (v_dtype == GK_F32)
    return launch_spmm<float>(values, pids, K, BR, X, Y, n_rows, n_cols, k,
                              (cudaStream_t)stream);
  if (v_dtype == GK_BF16)
    return launch_spmm<__nv_bfloat16>(values, pids, K, BR, X, Y, n_rows,
                                      n_cols, k, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
