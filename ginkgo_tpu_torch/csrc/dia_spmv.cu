// DIA (banded) SpMV family for Hopper: kernels K1-K3 of the PyTorch port.
//
// Replaces the Pallas TPU kernels of ginkgo_tpu/ops/pallas_dia.py:
//   K1 dia_spmv           <- dia_spmv_pallas / _dia_kernel          (y = A x)
//   K2 dia_spmv_advanced  <- dia_advanced_spmv_pallas
//                            / _dia_advanced_kernel                  (y = a A x + b y)
//   K3 dia_spmm           <- dia_spmm_pallas / _dia_spmm_kernel      (Y = A X, k RHS)
//
// Layout: diags is (nd, n_rows) row-major with diags[d, i] = A[i, i + off_d];
// x is (n_cols,), X and Y are (n, k) row-major (the public layout).
//
//   y[i] = sum_d diags[d, i] * x[i + off_d],   0 <= i + off_d < n_cols
//
// What bounds it on the H100: bytes.  Each row costs nd diagonal values plus
// one x read and one y write, i.e. (nd * sizeof(TD) + 2 * sizeof(TX)) bytes
// against 2 * nd flops, far below the card's flop/byte balance.
//
// What the design does about it: one thread per row, so a warp reads
// diags[d, i..i+31] and x[i+off..i+off+31] as contiguous 128-byte lines and
// the neighbouring diagonals of a stencil hit the same x lines in L1/L2.
// That does the job of the TPU kernel's halo'd x slab DMA and its lane
// roll+select, which are not carried over.  bf16 diagonals halve the
// dominant term; they are widened with __bfloat162float and summed in f32.
// K3 applies each diagonal value, read once, to a chunk of up to
// GK_SPMM_COLS right-hand sides, reaching the (nd + 2k) * n traffic of the
// TPU kernel for k <= GK_SPMM_COLS.  The diagonals are summed in offset
// order, as the XLA reference path does.

#include "common.cuh"

#define GK_SPMV_THREADS 256
#define GK_SPMM_COLS 8

template <typename TD, typename TX, bool ADVANCED>
__global__ void __launch_bounds__(GK_SPMV_THREADS)
    dia_spmv_kernel(const TD* __restrict__ diags, const GkOffsets offs,
                    const TX* __restrict__ x, TX* __restrict__ y,
                    const TX* __restrict__ yin, const TX* __restrict__ alpha,
                    const TX* __restrict__ beta, long long n_rows,
                    long long n_cols) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  TX acc = 0;
  for (int d = 0; d < offs.nd; ++d) {
    const long long j = i + offs.off[d];
    if (j >= 0 && j < n_cols) {
      acc += GkAcc<TX>::load(diags[d * n_rows + i]) * x[j];
    }
  }
  if (ADVANCED) acc = alpha[0] * acc + beta[0] * yin[i];
  y[i] = acc;
}

template <typename TD, typename TX>
__global__ void __launch_bounds__(GK_SPMV_THREADS)
    dia_spmm_kernel(const TD* __restrict__ diags, const GkOffsets offs,
                    const TX* __restrict__ X, TX* __restrict__ Y,
                    long long n_rows, long long n_cols, int k) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  const int c0 = blockIdx.y * GK_SPMM_COLS;
  const int kc = min(GK_SPMM_COLS, k - c0);
  TX acc[GK_SPMM_COLS];
#pragma unroll
  for (int c = 0; c < GK_SPMM_COLS; ++c) acc[c] = 0;
  for (int d = 0; d < offs.nd; ++d) {
    const long long j = i + offs.off[d];
    if (j >= 0 && j < n_cols) {
      const TX v = GkAcc<TX>::load(diags[d * n_rows + i]);
      const TX* xr = X + j * k + c0;
#pragma unroll
      for (int c = 0; c < GK_SPMM_COLS; ++c) {
        if (c < kc) acc[c] += v * xr[c];
      }
    }
  }
  TX* yr = Y + i * k + c0;
#pragma unroll
  for (int c = 0; c < GK_SPMM_COLS; ++c) {
    if (c < kc) yr[c] = acc[c];
  }
}

static bool gk_fill_offsets(GkOffsets* o, const long long* offsets, int nd) {
  if (nd < 0 || nd > GK_MAX_DIAGS) return false;
  o->nd = nd;
  for (int d = 0; d < nd; ++d) o->off[d] = offsets[d];
  return true;
}

template <typename TD, typename TX, bool ADVANCED>
static int launch_spmv(const void* diags, const GkOffsets& offs, const void* x,
                       void* y, const void* yin, const void* alpha,
                       const void* beta, long long n_rows, long long n_cols,
                       cudaStream_t stream) {
  const long long blocks = (n_rows + GK_SPMV_THREADS - 1) / GK_SPMV_THREADS;
  dia_spmv_kernel<TD, TX, ADVANCED>
      <<<(unsigned)blocks, GK_SPMV_THREADS, 0, stream>>>(
          (const TD*)diags, offs, (const TX*)x, (TX*)y, (const TX*)yin,
          (const TX*)alpha, (const TX*)beta, n_rows, n_cols);
  return (int)cudaGetLastError();
}

template <typename TD, typename TX>
static int launch_spmm(const void* diags, const GkOffsets& offs, const void* X,
                       void* Y, long long n_rows, long long n_cols, int k,
                       cudaStream_t stream) {
  const long long bx = (n_rows + GK_SPMV_THREADS - 1) / GK_SPMV_THREADS;
  const int by = (k + GK_SPMM_COLS - 1) / GK_SPMM_COLS;
  dim3 grid((unsigned)bx, (unsigned)by);
  dia_spmm_kernel<TD, TX><<<grid, GK_SPMV_THREADS, 0, stream>>>(
      (const TD*)diags, offs, (const TX*)X, (TX*)Y, n_rows, n_cols, k);
  return (int)cudaGetLastError();
}

// Supported (value, diagonal) dtype pairs: the diagonal type is never wider
// than the vector type, and arithmetic runs in the vector type.
#define GK_DISPATCH(x_dtype, d_dtype, CALL)                          \
  do {                                                               \
    if (x_dtype == GK_F32 && d_dtype == GK_F32) {                    \
      using TX = float;                                              \
      using TD = float;                                              \
      return CALL;                                                   \
    }                                                                \
    if (x_dtype == GK_F32 && d_dtype == GK_BF16) {                   \
      using TX = float;                                              \
      using TD = __nv_bfloat16;                                      \
      return CALL;                                                   \
    }                                                                \
    if (x_dtype == GK_F64 && d_dtype == GK_F64) {                    \
      using TX = double;                                             \
      using TD = double;                                             \
      return CALL;                                                   \
    }                                                                \
    if (x_dtype == GK_F64 && d_dtype == GK_F32) {                    \
      using TX = double;                                             \
      using TD = float;                                              \
      return CALL;                                                   \
    }                                                                \
    if (x_dtype == GK_F64 && d_dtype == GK_BF16) {                   \
      using TX = double;                                             \
      using TD = __nv_bfloat16;                                      \
      return CALL;                                                   \
    }                                                                \
    return (int)cudaErrorInvalidValue;                               \
  } while (0)

extern "C" int dia_spmv(const void* diags, int d_dtype,
                        const long long* offsets, int nd, const void* x,
                        int x_dtype, void* y, long long n_rows,
                        long long n_cols, void* stream) {
  GkOffsets offs;
  if (!gk_fill_offsets(&offs, offsets, nd)) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  GK_DISPATCH(x_dtype, d_dtype,
              (launch_spmv<TD, TX, false>(diags, offs, x, y, nullptr, nullptr,
                                          nullptr, n_rows, n_cols,
                                          (cudaStream_t)stream)));
}

extern "C" int dia_spmv_advanced(const void* diags, int d_dtype,
                                 const long long* offsets, int nd,
                                 const void* x, int x_dtype,
                                 const void* alpha, const void* beta,
                                 const void* yin, void* y, long long n_rows,
                                 long long n_cols, void* stream) {
  GkOffsets offs;
  if (!gk_fill_offsets(&offs, offsets, nd)) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  GK_DISPATCH(x_dtype, d_dtype,
              (launch_spmv<TD, TX, true>(diags, offs, x, y, yin, alpha, beta,
                                         n_rows, n_cols,
                                         (cudaStream_t)stream)));
}

extern "C" int dia_spmm(const void* diags, int d_dtype,
                        const long long* offsets, int nd, const void* X,
                        int x_dtype, void* Y, long long n_rows,
                        long long n_cols, int k, void* stream) {
  GkOffsets offs;
  if (!gk_fill_offsets(&offs, offsets, nd)) return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || k == 0) return 0;
  GK_DISPATCH(x_dtype, d_dtype,
              (launch_spmm<TD, TX>(diags, offs, X, Y, n_rows, n_cols, k,
                                   (cudaStream_t)stream)));
}
