// PELL SpMV and SpMM for Hopper: kernels K5 and K6 of the PyTorch port.
//
// Replaces the Pallas TPU kernels of ginkgo_tpu/ops/spmv_pallas.py:
//   K5 pell_spmv  <- pell_spmv / _pell_call / _pell_kernel         (y = A x)
//   K6 pell_spmm  <- pell_spmm / _pell_spmm_call / _pell_spmm_kernel (Y = A X)
//
// The plan layout and the row sum are described in pell.cuh.  Values are
// float32, bfloat16 or float64; lane indices int8 or int32, widened in
// registers; vectors float32 or float64, and the sums run in the vector
// type (promote(out, f32) of the TPU kernel, spmv_pallas.py:282).
//
// What bounds it on the H100: bytes.  Every slot cell is read once:
// sizeof(value) + sizeof(q) bytes (5 with f32 values and int8 indices, 3
// with bf16) against 2 flops, plus one x read per cell that mostly hits
// L1/L2 (a cell's column lies in one 128-entry panel next to its row's).
//
// What the design does about it: one thread per output row, so a warp
// reads 32 consecutive lanes of a slot's values and q rows (128 B of f32,
// 32 B of int8) and gathers x from one panel; every row has one writer, no
// atomics, and the sum runs in a fixed order.  Persistent blocks that stream
// each tile's slots into a ring of shared memory by bulk asynchronous copies
// were slower on an NVIDIA H100 80GB HBM3 at 700 W on poisson_3d(160)'s
// plan, 145-210 us against this kernel's 147-151 in float32 and 145-200
// against 128 in bfloat16 (well_bench.py; PERF.md): the x gathers, not the
// plan stream, set K5's pace, and a ring that fills shared memory leaves
// them less L1 and fewer warps.  The TPU kernel's scalar
// prefetch of bases and step->tile maps becomes a per-block load of
// tile_ptr and bases (the same address for a whole warp).  K6 reads each
// cell once for up to GK_PELL_COLS right-hand sides, as the TPU kernel
// streams the plan once for all k columns; its sum runs slot by slot, in
// the TPU SpMM kernel's order (spmv_pallas.py:470-493).

#include "pell.cuh"

#define GK_PELL_THREADS 256
#define GK_PELL_COLS 8

struct PellPlanArgs {
  const void* values;
  const void* qidx;
  const int* bases;
  const int* tile_ptr;
  int S;
  int G;
};

template <typename TV, typename TQ, typename TX>
__global__ void __launch_bounds__(GK_PELL_THREADS)
    pell_spmv_kernel(const PellPlanArgs P, const TX* __restrict__ x,
                     TX* __restrict__ y, long long n_rows, long long n_cols) {
  const long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  y[row] = gk_pell_row<TX, false>(static_cast<const TV*>(P.values),
                                  static_cast<const TQ*>(P.qidx), P.bases,
                                  P.tile_ptr, P.S, P.G, x, row, n_cols);
}

template <typename TV, typename TQ, typename TX>
__global__ void __launch_bounds__(GK_PELL_THREADS)
    pell_spmm_kernel(const PellPlanArgs P, const TX* __restrict__ X,
                     TX* __restrict__ Y, long long n_rows, long long n_cols,
                     int k) {
  const long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const TV* __restrict__ values = static_cast<const TV*>(P.values);
  const TQ* __restrict__ qidx = static_cast<const TQ*>(P.qidx);
  const int S = P.S;
  const long long t = row / ((long long)S * GK_LANES);
  const int s = (int)((row / GK_LANES) % S);
  const int l = (int)(row % GK_LANES);
  const int c0 = blockIdx.y * GK_PELL_COLS;
  const int kc = min(GK_PELL_COLS, k - c0);
  TX acc[GK_PELL_COLS];
#pragma unroll
  for (int c = 0; c < GK_PELL_COLS; ++c) acc[c] = 0;
  const int end = P.tile_ptr[t + 1];
  for (long long slot = P.tile_ptr[t]; slot < end; ++slot) {
    const long long cell = (slot * S + s) * GK_LANES + l;
    const long long col =
        ((long long)P.bases[slot] - (S - 1) + s) * GK_LANES + (int)qidx[cell];
    const bool in = col >= 0 && col < n_cols;
    const TX v = GkAcc<TX>::load(values[cell]);
    const TX* xr = X + (in ? col : 0) * k + c0;
#pragma unroll
    for (int c = 0; c < GK_PELL_COLS; ++c) {
      if (c < kc) acc[c] += v * (in ? xr[c] : TX(0));
    }
  }
  TX* yr = Y + row * k + c0;
#pragma unroll
  for (int c = 0; c < GK_PELL_COLS; ++c) {
    if (c < kc) yr[c] = acc[c];
  }
}

template <typename TV, typename TQ, typename TX>
static int launch_spmv(const PellPlanArgs& P, const void* x, void* y,
                       long long n_rows, long long n_cols, cudaStream_t stream) {
  const long long blocks = (n_rows + GK_PELL_THREADS - 1) / GK_PELL_THREADS;
  pell_spmv_kernel<TV, TQ, TX><<<(unsigned)blocks, GK_PELL_THREADS, 0, stream>>>(
      P, (const TX*)x, (TX*)y, n_rows, n_cols);
  return (int)cudaGetLastError();
}

// K5's launch on this device for n_rows rows: out = {blocks, threads a block,
// dynamic shared bytes a block (none), blocks an SM, registers a thread}.
template <typename TV, typename TQ, typename TX>
static int config_spmv(long long n_rows, int* out) {
  cudaFuncAttributes attr;
  int per_sm = 0;
  cudaError_t e = cudaFuncGetAttributes(&attr, pell_spmv_kernel<TV, TQ, TX>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pell_spmv_kernel<TV, TQ, TX>,
                                                      GK_PELL_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  const int v[5] = {(int)((n_rows + GK_PELL_THREADS - 1) / GK_PELL_THREADS), GK_PELL_THREADS, 0,
                    per_sm, attr.numRegs};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

template <typename TV, typename TQ, typename TX>
static int launch_spmm(const PellPlanArgs& P, const void* X, void* Y,
                       long long n_rows, long long n_cols, int k,
                       cudaStream_t stream) {
  const long long bx = (n_rows + GK_PELL_THREADS - 1) / GK_PELL_THREADS;
  const int by = (k + GK_PELL_COLS - 1) / GK_PELL_COLS;
  pell_spmm_kernel<TV, TQ, TX><<<dim3((unsigned)bx, (unsigned)by),
                                 GK_PELL_THREADS, 0, stream>>>(
      P, (const TX*)X, (TX*)Y, n_rows, n_cols, k);
  return (int)cudaGetLastError();
}

// (vector, value, index) dtype triples: vectors f32/f64, values
// f32/f64/bf16, indices int8/int32.
#define GK_PELL_DISPATCH_Q(TV_, TX_, q_dtype, CALL) \
  do {                                              \
    using TV = TV_;                                 \
    using TX = TX_;                                 \
    if (q_dtype == GK_I8) {                         \
      using TQ = signed char;                       \
      return CALL;                                  \
    }                                               \
    if (q_dtype == GK_I32) {                        \
      using TQ = int;                               \
      return CALL;                                  \
    }                                               \
    return (int)cudaErrorInvalidValue;              \
  } while (0)

#define GK_PELL_DISPATCH_V(TX_, v_dtype, q_dtype, CALL)                          \
  do {                                                                          \
    if (v_dtype == GK_F32) GK_PELL_DISPATCH_Q(float, TX_, q_dtype, CALL);        \
    if (v_dtype == GK_F64) GK_PELL_DISPATCH_Q(double, TX_, q_dtype, CALL);       \
    if (v_dtype == GK_BF16) GK_PELL_DISPATCH_Q(__nv_bfloat16, TX_, q_dtype, CALL); \
    return (int)cudaErrorInvalidValue;                                          \
  } while (0)

#define GK_PELL_DISPATCH(x_dtype, v_dtype, q_dtype, CALL)                   \
  do {                                                                     \
    if (x_dtype == GK_F32) GK_PELL_DISPATCH_V(float, v_dtype, q_dtype, CALL);  \
    if (x_dtype == GK_F64) GK_PELL_DISPATCH_V(double, v_dtype, q_dtype, CALL); \
    return (int)cudaErrorInvalidValue;                                     \
  } while (0)

static bool gk_plan_args(PellPlanArgs* P, const void* values,
                         const void* qidx, const int* bases,
                         const int* tile_ptr, int S, int G) {
  if (S < 1 || G < 1) return false;
  P->values = values;
  P->qidx = qidx;
  P->bases = bases;
  P->tile_ptr = tile_ptr;
  P->S = S;
  P->G = G;
  return true;
}

extern "C" int pell_spmv(const void* values, int v_dtype, const void* qidx,
                         int q_dtype, const int* bases, const int* tile_ptr,
                         int S, int G, const void* x, int x_dtype, void* y,
                         long long n_rows, long long n_cols, void* stream) {
  PellPlanArgs P;
  if (!gk_plan_args(&P, values, qidx, bases, tile_ptr, S, G))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  GK_PELL_DISPATCH(x_dtype, v_dtype, q_dtype,
                   (launch_spmv<TV, TQ, TX>(P, x, y, n_rows, n_cols,
                                            (cudaStream_t)stream)));
}

extern "C" int pell_spmm(const void* values, int v_dtype, const void* qidx,
                         int q_dtype, const int* bases, const int* tile_ptr,
                         int S, int G, const void* X, int x_dtype, void* Y,
                         long long n_rows, long long n_cols, int k,
                         void* stream) {
  PellPlanArgs P;
  if (!gk_plan_args(&P, values, qidx, bases, tile_ptr, S, G))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || k == 0) return 0;
  GK_PELL_DISPATCH(x_dtype, v_dtype, q_dtype,
                   (launch_spmm<TV, TQ, TX>(P, X, Y, n_rows, n_cols, k,
                                            (cudaStream_t)stream)));
}

extern "C" int pell_spmv_config(int v_dtype, int q_dtype, int x_dtype, long long n_rows,
                                int* out) {
  GK_PELL_DISPATCH(x_dtype, v_dtype, q_dtype, (config_spmv<TV, TQ, TX>(n_rows, out)));
}
