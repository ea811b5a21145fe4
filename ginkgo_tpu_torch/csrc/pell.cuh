// The PELL slot sum of one output row, shared by K5 (pell_spmv.cu), K7
// (pell_cg_fused.cu), K19 (bicgstab_fused.cu), K20 (cgs_fused.cu), K21
// (ir_fused.cu) and K15's Pell form K18 (gmres_fused.cu); and the chunked
// row schedule of K7 and K19-K21.
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

// A square Pell as the operator of K15's whole-solve kernel on a Pell, K18
// (gmres_fused.cu; see coop.cuh GkDiaOp): row(i, src) gathers src with
// __ldcg (LDCG; else plain loads, as coop.cuh gk_dia_row), widened to
// float32 (a bfloat16 GMRES basis).  With `cminv` the gathered value is
// cminv[c] * src[c], one float32 product, so the row is that of A M with
// M = diag(cminv) applied explicitly.  K18 passes none; without the field
// its kernels took other spills on the H100 (PERF.md section 6), so it
// stays and K18 keeps its code.
template <typename TV, typename TQ, bool LDCG>
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

// Rows a thread takes of a chunk in K7 and K19-K21, who walk the same chunks; a
// chunk is 256 * GK_PELL_CHUNK_ROWS rows, eight 128-row panels, so it lies
// in one tile when S is a multiple of 8.  On the H100 (PERF.md section 6)
// 4 rows a thread at 64 registers and 4 blocks an SM beat one row a thread
// grid-stride at 6 to 8 blocks an SM in K7, and beat 4 rows held to 40
// registers and 6 blocks an SM.
#define GK_PELL_CHUNK_ROWS 4

// Blocks an SM that K19's and K20's registers must leave room for (at most
// 64 registers a thread, K7's and K21's occupancy).  Held to 1, nvcc took
// 71 registers for K19 (3 blocks an SM), 17% slower an iteration on the
// H100 (PERF.md section 6).
#define GK_PELL_KRYLOV_MIN_BLOCKS 4

// The row schedule of K7 and K19-K21 (GkPellChunks<THREADS>): the rows go in
// chunks of THREADS * R rows (R = GK_PELL_CHUNK_ROWS), dealt to the blocks
// in turn; a thread takes R rows of a chunk, THREADS apart (row), the same
// rows in every pass, so a vector written at a row is only read back there
// by the thread that wrote it.  Where a chunk lies in one PELL tile (S a
// multiple of 8: a chunk is at most eight 128-row panels, aligned to its
// size), spmv reads the tile's slot range and each slot's base once for
// the thread's rows, does the row index math in 32 bits, and issues the
// rows' value, lane index and gather loads of a slot before their sums;
// other S take the rows one at a time (gk_pell_row_with).  The gathers are
// plain loads: the kernels call spmv only on a source that every block
// wrote before the last grid barrier, and grid.sync() invalidates L1.
// Rows are 32-bit: the callers take n <= 2^31 - 1 - THREADS * R.
template <int THREADS>
struct GkPellChunks {
  static constexpr int R = GK_PELL_CHUNK_ROWS;
  static constexpr int kChunk = THREADS * R;
  static_assert((8 * GK_LANES) % kChunk == 0 && kChunk % THREADS == 0 && THREADS % GK_LANES == 0,
                "a chunk lies in one tile of any S that is a multiple of 8");

  // Row q of this thread in chunk c.
  static __device__ __forceinline__ int row(int c, int q) {
    return (c * R + q) * THREADS + threadIdx.x;
  }

  // f(i) for each of this thread's rows i < n, in the same order every pass.
  template <typename F>
  static __device__ __forceinline__ void own_rows(int n, F f) {
    const int chunks = (n + kChunk - 1) / kChunk;
    for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = row(c, q);
        if (i < n) f(i);
      }
    }
  }

  // out = (A src) on the thread's rows of chunk c (rows past n: computed
  // and not used where the plan's tiles cover them, else 0).
  template <typename TV, typename TQ>
  static __device__ __forceinline__ void spmv(const TV* __restrict__ values,
                                              const TQ* __restrict__ qidx, const int* bases,
                                              const int* tile_ptr, int S, int G, int n,
                                              const float* src, int c, float (&out)[R]) {
    if (S % 8 == 0) {
      // one tile: sublanes s0, s0 + T/128, ... of lane l
      constexpr int kStep = THREADS / GK_LANES;
      const int l = threadIdx.x & (GK_LANES - 1);
      const int panel0 = c * (kChunk / GK_LANES);
      const int t = panel0 / S;
      const int s0 = panel0 - t * S + threadIdx.x / GK_LANES;
      const int end = tile_ptr[t + 1];
      float total[R];
#pragma unroll
      for (int q = 0; q < R; ++q) total[q] = 0.f;
      for (int slot0 = tile_ptr[t]; slot0 < end; slot0 += G) {
        float acc[R];
#pragma unroll
        for (int q = 0; q < R; ++q) acc[q] = 0.f;
        for (int g = 0; g < G; ++g) {
          const int slot = slot0 + g;
          const int panel = bases[slot] - (S - 1) + s0;
          const long long cell0 = ((long long)slot * S + s0) * GK_LANES + l;
          float v[R], xv[R];
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const long long cell = cell0 + kStep * q * GK_LANES;
            const int col = (panel + kStep * q) * GK_LANES + (int)qidx[cell];
            v[q] = GkAcc<float>::load(values[cell]);
            xv[q] = (col >= 0 && col < n) ? src[col] : 0.f;
          }
#pragma unroll
          for (int q = 0; q < R; ++q) acc[q] += v[q] * xv[q];
        }
#pragma unroll
        for (int q = 0; q < R; ++q) total[q] += acc[q];
      }
#pragma unroll
      for (int q = 0; q < R; ++q) out[q] = total[q];
    } else {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = row(c, q);
        out[q] = i < n ? gk_pell_row_with<float>(values, qidx, bases, tile_ptr, S, G, i, n,
                                                 [&](long long col) -> float {
                                                   return src[(int)col];
                                                 })
                       : 0.f;
      }
    }
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
template <typename TV, typename TQ, bool LDCG>
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
