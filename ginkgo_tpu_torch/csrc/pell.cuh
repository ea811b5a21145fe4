// The PELL slot sum of one output row, shared by K5 (pell_spmv.cu) and K7
// (pell_cg_fused.cu).
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

template <typename TA, bool LDCG, typename TV, typename TQ>
__device__ __forceinline__ TA gk_pell_row(const TV* __restrict__ values,
                                          const TQ* __restrict__ qidx,
                                          const int* __restrict__ bases,
                                          const int* __restrict__ tile_ptr,
                                          int S, int G, const TA* x,
                                          long long row, long long n_cols) {
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
      if (col >= 0 && col < n_cols) xv = LDCG ? __ldcg(x + col) : x[col];
      acc += GkAcc<TA>::load(values[cell]) * xv;
    }
    total += acc;
  }
  return total;
}
