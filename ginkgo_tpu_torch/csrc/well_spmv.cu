// WELL SpMV and SpMM for Hopper: kernels K8 and K9 of the PyTorch port.
//
// Replaces the Pallas TPU kernels of ginkgo_tpu/ops/spmv_well.py:
//   K8 well_spmv <- well_spmv / _well_call / _well_kernel (T = 1) and
//                   _well_xl_kernel (T > 1)                      (y = A x)
//   K9 well_spmm <- well_spmm / _well_spmm_call / _well_spmm_kernel and
//                   _well_xl_spmm_kernel                         (Y = A X)
//
// Plan layout (ginkgo_tpu_torch/ops/well.py WellPlan): values, qidx, rt and,
// for T > 1, tsb are (slots, 8, 128); bases (slots,) is each slot's window
// base panel; tile_ptr (NST + 1) delimits the slots of supertile st, a
// whole number of G-slot steps.  Cell c = (slot, s, l) adds
//
//   values[c] * x[128 * (bases[slot] + rt[slot, s, q]) + q],  q = qidx[c],
//
// into row 1024 * (T * st + tsb[c]) + 128 * s + l.  The routing tile is read
// at lane q of the cell's own sublane: the TPU's chained sublane-then-lane
// gather, which here is one byte load from the slot's 128-byte rt row.
//
// Order, as on the TPU.  K8: the G cells of a step add into T step sums (the
// cell into sum tsb), then each step sum adds into its row's output, step
// after step.  K9: each cell's products add straight into the outputs, slot
// after slot (the TPU SpMM kernel keeps no step sum).  The TPU adds
// where(tsb == b, contrib, 0) into all T sums; adding +0.0 to a sum that
// started at +0.0 leaves it unchanged bit for bit, so the kernels add into
// sum tsb only.  A column at or past n_cols reads 0 (the TPU reads zero pad
// panels); every other cell, padding included, is multiplied, so a NaN in x
// reaches the same rows as on the TPU.
//
// What bounds it on the H100: bytes.  Every cell is read once,
// sizeof(value) + 2 bytes (+ 1 for tsb when T > 1) against 2 flops, plus the
// routed rt byte (from the slot's rt row, in L1 for the whole block) and
// one x gather (x stays in L2).
//
// What the design does about it: one block per (supertile, sublane) and one
// thread per lane, so a warp reads 32 consecutive cells of a slot row.  A
// thread owns the T rows (st, b, s, l) for b < T, keeps their step sums and
// outputs in local memory indexed by tsb, and writes each row once: no
// atomics.  A row's sum is serial in slot order, and a supertile holds at
// least as many slots as its longest row has entries: on a power-law
// matrix the hub row's supertile (48k slots at 2^20 rows) outlasts all
// others, and its walk is bound by the latency of the dependent loads (q,
// then rt, then x).  So the loads of GK_WELL_UNROLL slots (K9:
// GK_WELL_SPMM_UNROLL) are issued together before their sums, which still
// run in slot order.

#include "common.cuh"

#define GK_WELL_SUB 8
#define GK_WELL_TILE (GK_WELL_SUB * GK_LANES)
// slots whose loads are issued together, before their sums (K8, K9)
#define GK_WELL_UNROLL 16
#define GK_WELL_SPMM_UNROLL 8
#define GK_WELL_COLS 4
#define GK_WELL_MAX_T 64

struct WellPlanArgs {
  const void* values;
  const signed char* qidx;
  const signed char* rt;
  const signed char* tsb;  // null when T == 1
  const int* bases;
  const int* tile_ptr;
  int T;
  int G;
};

// Cells (slot0 + u, s, l) for u < n <= U: values in the accumulation type,
// columns and sub-tiles.  The loads run in two rounds, the residues,
// values, sub-tiles and bases of all n slots, then their routed rt bytes,
// so that the loads of the n slots are in flight together (the caller's x
// gathers make the third round).
template <int U, typename TX, typename TV>
__device__ __forceinline__ void gk_well_cells(const WellPlanArgs& P, long long slot0,
                                              int n, int s, int l, bool has_sub,
                                              TX* v, long long* col, int* sub) {
  int q[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u < n) {
      const long long c = ((slot0 + u) * GK_WELL_SUB + s) * GK_LANES + l;
      q[u] = P.qidx[c];
      v[u] = GkAcc<TX>::load(static_cast<const TV*>(P.values)[c]);
      sub[u] = has_sub ? (int)P.tsb[c] : 0;
      col[u] = (long long)P.bases[slot0 + u] * GK_LANES;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u < n) {
      const long long row0 = ((slot0 + u) * GK_WELL_SUB + s) * GK_LANES;
      col[u] += (long long)P.rt[row0 + q[u]] * GK_LANES + q[u];
    }
  }
}

template <typename TV, typename TX, int TMAX>
__global__ void __launch_bounds__(GK_LANES)
    well_spmv_kernel(const WellPlanArgs P, const TX* __restrict__ x,
                     TX* __restrict__ y, long long n_rows, long long n_cols) {
  constexpr int U = GK_WELL_UNROLL;
  const long long st = blockIdx.x / GK_WELL_SUB;
  const int s = blockIdx.x % GK_WELL_SUB;
  const int l = threadIdx.x;
  const int T = TMAX == 1 ? 1 : P.T;
  const int G = P.G;
  TX out[TMAX];
  TX acc[TMAX];
  for (int b = 0; b < T; ++b) out[b] = 0;
  const int end = P.tile_ptr[st + 1];
  for (int step = P.tile_ptr[st]; step < end; step += G) {
    for (int b = 0; b < T; ++b) acc[b] = 0;
    for (int g0 = 0; g0 < G; g0 += U) {
      const int n = min(U, G - g0);
      TX v[U], prod[U];
      long long col[U];
      int sub[U];
      gk_well_cells<U, TX, TV>(P, step + g0, n, s, l, TMAX > 1, v, col, sub);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < n) prod[u] = v[u] * (col[u] < n_cols ? __ldg(x + col[u]) : TX(0));
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < n) acc[sub[u]] += prod[u];
      }
    }
    for (int b = 0; b < T; ++b) out[b] += acc[b];
  }
  for (int b = 0; b < T; ++b) {
    const long long row = (st * T + b) * GK_WELL_TILE + s * GK_LANES + l;
    if (row < n_rows) y[row] = out[b];
  }
}

template <typename TV, typename TX, int TMAX>
__global__ void __launch_bounds__(GK_LANES)
    well_spmm_kernel(const WellPlanArgs P, const TX* __restrict__ X,
                     TX* __restrict__ Y, long long n_rows, long long n_cols,
                     int k) {
  constexpr int U = GK_WELL_SPMM_UNROLL;
  const long long st = blockIdx.x / GK_WELL_SUB;
  const int s = blockIdx.x % GK_WELL_SUB;
  const int l = threadIdx.x;
  const int T = TMAX == 1 ? 1 : P.T;
  const int c0 = blockIdx.y * GK_WELL_COLS;
  const int kc = min(GK_WELL_COLS, k - c0);
  TX out[TMAX * GK_WELL_COLS];
  for (int i = 0; i < T * GK_WELL_COLS; ++i) out[i] = 0;
  const int end = P.tile_ptr[st + 1];
  for (int slot0 = P.tile_ptr[st]; slot0 < end; slot0 += U) {
    const int n = min(U, end - slot0);
    TX v[U];
    long long col[U];
    int sub[U];
    gk_well_cells<U, TX, TV>(P, slot0, n, s, l, TMAX > 1, v, col, sub);
    TX xv[U][GK_WELL_COLS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = u < n && col[u] < n_cols;
      const TX* xr = X + (in ? col[u] : 0) * k + c0;
#pragma unroll
      for (int c = 0; c < GK_WELL_COLS; ++c) xv[u][c] = in && c < kc ? __ldg(xr + c) : TX(0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u >= n) break;
      TX* o = out + sub[u] * GK_WELL_COLS;
#pragma unroll
      for (int c = 0; c < GK_WELL_COLS; ++c) {
        if (c < kc) o[c] += v[u] * xv[u][c];
      }
    }
  }
  for (int b = 0; b < T; ++b) {
    const long long row = (st * T + b) * GK_WELL_TILE + s * GK_LANES + l;
    if (row >= n_rows) continue;
    TX* yr = Y + row * k + c0;
#pragma unroll
    for (int c = 0; c < GK_WELL_COLS; ++c) {
      if (c < kc) yr[c] = out[b * GK_WELL_COLS + c];
    }
  }
}

template <typename TV, typename TX, int TMAX>
static int launch_spmv(const WellPlanArgs& P, int NST, const void* x, void* y,
                       long long n_rows, long long n_cols, cudaStream_t stream) {
  well_spmv_kernel<TV, TX, TMAX><<<(unsigned)NST * GK_WELL_SUB, GK_LANES, 0, stream>>>(
      P, (const TX*)x, (TX*)y, n_rows, n_cols);
  return (int)cudaGetLastError();
}

template <typename TV, typename TX, int TMAX>
static int launch_spmm(const WellPlanArgs& P, int NST, const void* X, void* Y,
                       long long n_rows, long long n_cols, int k,
                       cudaStream_t stream) {
  const int by = (k + GK_WELL_COLS - 1) / GK_WELL_COLS;
  well_spmm_kernel<TV, TX, TMAX>
      <<<dim3((unsigned)NST * GK_WELL_SUB, (unsigned)by), GK_LANES, 0, stream>>>(
          P, (const TX*)X, (TX*)Y, n_rows, n_cols, k);
  return (int)cudaGetLastError();
}

// (vector, value) dtypes and the accumulator count: T = 1 keeps its sums in
// registers, 1 < T <= 64 in 64-entry local arrays.
#define GK_WELL_DISPATCH_T(TV_, TX_, T_, CALL) \
  do {                                         \
    using TV = TV_;                            \
    using TX = TX_;                            \
    if (T_ == 1) {                             \
      constexpr int TMAX = 1;                  \
      return CALL;                             \
    }                                          \
    constexpr int TMAX = GK_WELL_MAX_T;        \
    return CALL;                               \
  } while (0)

#define GK_WELL_DISPATCH_V(TX_, v_dtype, T_, CALL)                              \
  do {                                                                         \
    if (v_dtype == GK_F32) GK_WELL_DISPATCH_T(float, TX_, T_, CALL);           \
    if (v_dtype == GK_F64) GK_WELL_DISPATCH_T(double, TX_, T_, CALL);          \
    if (v_dtype == GK_BF16) GK_WELL_DISPATCH_T(__nv_bfloat16, TX_, T_, CALL);  \
    return (int)cudaErrorInvalidValue;                                         \
  } while (0)

#define GK_WELL_DISPATCH(x_dtype, v_dtype, T_, CALL)                     \
  do {                                                                  \
    if (x_dtype == GK_F32) GK_WELL_DISPATCH_V(float, v_dtype, T_, CALL);  \
    if (x_dtype == GK_F64) GK_WELL_DISPATCH_V(double, v_dtype, T_, CALL); \
    return (int)cudaErrorInvalidValue;                                  \
  } while (0)

static bool gk_well_args(WellPlanArgs* P, const void* values, const void* qidx,
                         const void* rt, const void* tsb, const int* bases,
                         const int* tile_ptr, int T, int G) {
  if (T < 1 || T > GK_WELL_MAX_T || G < 1 || (T > 1 && tsb == nullptr))
    return false;
  P->values = values;
  P->qidx = static_cast<const signed char*>(qidx);
  P->rt = static_cast<const signed char*>(rt);
  P->tsb = static_cast<const signed char*>(tsb);
  P->bases = bases;
  P->tile_ptr = tile_ptr;
  P->T = T;
  P->G = G;
  return true;
}

extern "C" int well_spmv(const void* values, int v_dtype, const void* qidx,
                         const void* rt, const void* tsb, const int* bases,
                         const int* tile_ptr, int NST, int T, int G,
                         const void* x, int x_dtype, void* y, long long n_rows,
                         long long n_cols, void* stream) {
  WellPlanArgs P;
  if (!gk_well_args(&P, values, qidx, rt, tsb, bases, tile_ptr, T, G))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || NST == 0) return 0;
  GK_WELL_DISPATCH(x_dtype, v_dtype, T,
                   (launch_spmv<TV, TX, TMAX>(P, NST, x, y, n_rows, n_cols,
                                              (cudaStream_t)stream)));
}

extern "C" int well_spmm(const void* values, int v_dtype, const void* qidx,
                         const void* rt, const void* tsb, const int* bases,
                         const int* tile_ptr, int NST, int T, int G,
                         const void* X, int x_dtype, void* Y, long long n_rows,
                         long long n_cols, int k, void* stream) {
  WellPlanArgs P;
  if (!gk_well_args(&P, values, qidx, rt, tsb, bases, tile_ptr, T, G))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || NST == 0 || k == 0) return 0;
  GK_WELL_DISPATCH(x_dtype, v_dtype, T,
                   (launch_spmm<TV, TX, TMAX>(P, NST, X, Y, n_rows, n_cols, k,
                                              (cudaStream_t)stream)));
}
