// The PELL slot sum of one output row, shared by K5 (pell_spmv.cu), K7
// (pell_cg_fused.cu) and the Pell forms of K12, K13, K15 and K17 (K18-K21).
//
// Plan layout (ginkgo_tpu_torch/ops/pell.py PellPlan): values and qidx are
// (slots, S, 128); bases is (slots,); tile_ptr (NT + 1) delimits the slots
// of output tile t, which are [tile_ptr[t], tile_ptr[t + 1]), a multiple of
// G.  Output row = t * S * 128 + s * 128 + l reads, from each slot of its
// tile, the cell (slot, s, l):
//
//   y[row] += values[slot, s, l] * x[(bases[slot] - (S - 1) + s) * 128
//                                    + q[slot, s, l]]
//
// A column outside [0, n_cols) reads 0: the TPU kernel reads zero pad
// panels there.  Zero-valued cells inside the range are multiplied like any
// other, so a NaN or Inf in x comes through as it does on the TPU.  The sum
// runs in the TPU kernel's order (_pell_kernel, ops/spmv_pallas.py:269-295):
// G slots into a step sum, then the step sums in slot order.
#pragma once

#include "common.cuh"

// The slot sum of `row` with the gathered value of column c given by
// load(c) (called only for c in [0, n_cols)).
template <typename TA, typename TV, typename TQ, typename Load>
__device__ __forceinline__ TA gk_pell_row_with(const TV* __restrict__ values,
                                               const TQ* __restrict__ qidx,
                                               const int* __restrict__ bases,
                                               const int* __restrict__ tile_ptr,
                                               int S, int G, long long row,
                                               long long n_cols, Load load) {
  const long long t = row / ((long long)S * GK_LANES);
  const int s = (int)((row / GK_LANES) % S);
  const int l = (int)(row % GK_LANES);
  const int end = tile_ptr[t + 1];
  TA total = 0;
  for (int slot0 = tile_ptr[t]; slot0 < end; slot0 += G) {
    TA acc = 0;
    for (int g = 0; g < G; ++g) {
      const long long slot = slot0 + g;
      const long long cell = (slot * S + s) * GK_LANES + l;
      const long long col =
          ((long long)bases[slot] - (S - 1) + s) * GK_LANES + (int)qidx[cell];
      TA xv = 0;
      if (col >= 0 && col < n_cols) xv = load(col);
      acc += GkAcc<TA>::load(values[cell]) * xv;
    }
    total += acc;
  }
  return total;
}

template <typename TA, bool LDCG, typename TV, typename TQ>
__device__ __forceinline__ TA gk_pell_row(const TV* __restrict__ values,
                                          const TQ* __restrict__ qidx,
                                          const int* __restrict__ bases,
                                          const int* __restrict__ tile_ptr,
                                          int S, int G, const TA* x,
                                          long long row, long long n_cols) {
  return gk_pell_row_with<TA>(values, qidx, bases, tile_ptr, S, G, row, n_cols,
                              [&](long long c) -> TA { return LDCG ? __ldcg(x + c) : x[c]; });
}

// A square Pell as the operator of a templated whole-solve kernel (see
// coop.cuh GkDiaOp): row(i, src) gathers src with __ldcg (LDCG; else plain
// loads, as coop.cuh gk_dia_row), widened to float32 (a bfloat16 GMRES
// basis).  With `cminv` the gathered value is cminv[c] * src[c], one
// float32 product, so the row is that of A M with M = diag(cminv) applied
// explicitly: the same rounding as the TPU kernels' staged w = M p
// (pallas_pell_cg.py, _pell_bicgstab_kernel and _pell_cgs_kernel), and no
// pass or barrier of its own.  PELL values have no column fold, so
// BiCGSTAB and CGS on a Pell take M this way.
template <typename TV, typename TQ, bool LDCG = true>
struct GkPellOp {
  const TV* values;
  const TQ* qidx;
  const int* bases;
  const int* tile_ptr;
  int S;
  int G;
  long long n_cols;
  const float* cminv;  // nullptr: no column scaling

  template <typename TS>
  __device__ __forceinline__ float row(long long i, const TS* src) const {
    const float* m = cminv;
    return gk_pell_row_with<float>(values, qidx, bases, tile_ptr, S, G, i, n_cols,
                                   [&](long long c) -> float {
                                     const float v = gk_to_float(LDCG ? __ldcg(src + c) : src[c]);
                                     return m ? m[c] * v : v;
                                   });
  }
};

// Dispatch CALL with TV (float / __nv_bfloat16) and TQ (signed char / int)
// bound to a Pell's value and lane-index dtype codes; any other pair
// returns cudaErrorInvalidValue.
#define GK_PELL_VQ_DISPATCH(v_dtype, q_dtype, CALL)                         \
  do {                                                                      \
    if (v_dtype == GK_F32 && q_dtype == GK_I8) {                            \
      using TV = float;                                                     \
      using TQ = signed char;                                               \
      return CALL;                                                          \
    }                                                                       \
    if (v_dtype == GK_F32 && q_dtype == GK_I32) {                           \
      using TV = float;                                                     \
      using TQ = int;                                                       \
      return CALL;                                                          \
    }                                                                       \
    if (v_dtype == GK_BF16 && q_dtype == GK_I8) {                           \
      using TV = __nv_bfloat16;                                             \
      using TQ = signed char;                                               \
      return CALL;                                                          \
    }                                                                       \
    if (v_dtype == GK_BF16 && q_dtype == GK_I32) {                          \
      using TV = __nv_bfloat16;                                             \
      using TQ = int;                                                       \
      return CALL;                                                          \
    }                                                                       \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

// The Pell operator of the C entry points' plan arguments.
template <typename TV, typename TQ, bool LDCG = true>
static GkPellOp<TV, TQ, LDCG> gk_pell_op(const void* values, const void* qidx,
                                         const int* bases, const int* tile_ptr, int S, int G,
                                         long long n, const float* cminv) {
  GkPellOp<TV, TQ, LDCG> op;
  op.values = static_cast<const TV*>(values);
  op.qidx = static_cast<const TQ*>(qidx);
  op.bases = bases;
  op.tile_ptr = tile_ptr;
  op.S = S;
  op.G = G;
  op.n_cols = n;
  op.cminv = cminv;
  return op;
}
