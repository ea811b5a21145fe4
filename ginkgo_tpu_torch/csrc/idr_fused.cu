// Whole-solve biorthogonal IDR(s) in one persistent cooperative kernel:
// kernel K16 of the PyTorch port.
//
// Replaces ginkgo_tpu/ops/pallas_idr.py idr_vmem_solve (_idr_kernel,
// :60-303): IDR(s) with the kappa-safeguarded omega and a residual
// replacement r = b - A x once per outer iteration, a diagonal
// preconditioner applied to v (it is not folded into A, unlike BiCGSTAB's).
// The kernel is templated on s (1 <= S <= 4), so the s x s system, f and
// every loop over the shadow space unroll, and M, f and c live in registers
// as the TPU kernel keeps them in its while-loop carry.
//
// What bounds it on the H100: bytes.  An outer iteration makes s + 2
// products (s inner, one for omega, one for the replacement) and its vector
// passes read the s rows of G, U and P several times: an inner step reads
// G[kk..s-1] and U[kk..s-1] for u, P and G for each biorthogonalization dot
// and for the new column of M.  The vector passes move more bytes than the
// products.
//
// What the design does about it: K4's (cg_fused.cu).  Every row belongs to
// one thread in every pass, so passes that read only their own rows follow
// each other without a barrier; a barrier comes before a product (which
// reads its source across rows) and with every reduction.  The
// biorthogonalization is sequential, as the TPU kernel's (:163-187):
// alpha_i is a dot on the g already reduced by alpha_0..alpha_{i-1}, so
// each is one grid reduction, fused with the subtraction of G that precedes
// it.  Every update that no reduction waits for is deferred to the next
// pass that reads the rows anyway, in the plain version's order, so each
// element rounds as before:
//   - U[kk] -= alpha_ib U[ib] (ib = 0..kk-1, in order) and r -= beta_kk
//     G[kk] run in the next own-row pass: the u pass of step kk + 1, or,
//     after the last step, the pass before the dimension-reduction product;
//   - x += beta_0 U[0], ..., x += beta_{s-1} U[s-1], x += om v run in one
//     pass before the replacement, so x is read and written once an outer
//     iteration (U[kk] is final once step kk ends);
//   - v = M r is never stored: t = A v gathers minv[c] * r[c], one float32
//     product as w = M r was, and the x pass forms minv r again.
// The products gather with plain loads: every source was written before
// the last grid barrier, which invalidates L1.  u_new lives in U[kk] itself
// (the TPU kernel stages it and copies it there).  Dot products are
// float64 per-block partials that every block sums in one fixed order
// (coop.cuh); consecutive reductions use the two halves of the partial
// buffer in turn.
//
// Semantics kept from _idr_kernel:
//   - G = U = 0, M = I, om = 1, f = P r0; the monitor starts as r0.r0 when
//     that is already at the threshold, else +inf: an r0 that has
//     converged runs no iteration;
//   - only rows >= kk of column kk of M take the new projections (:203-204);
//     f_j -= beta M_j,kk for j > kk, f_kk = 0 (:221-224);
//   - rho = |<t, r> / (sqrt(t.t) sqrt(r.r))| with r.r from before the x
//     update (:245-253);
//   - the loop runs while it < max_iters && !(mon <= tol_sq), mon the r.r
//     of the replaced residual: a NaN keeps iterating; zero denominators
//     give 0 (gk_sdiv).

#include "coop.cuh"

namespace cg = cooperative_groups;

struct IdrParams {
  const void* diags;
  GkOffsets offs;
  long long n;
  const float* P;  // (S, n) shadow space
  const float* r0;
  const float* x0;
  const float* b;
  const float* minv;    // nullptr: Identity; applied to v
  const float* tol_sq;  // device scalar
  float kappa;
  int max_iters;
  float* x;
  float* r;
  float* G;      // (S, n)
  float* U;      // (S, n)
  double* part;  // 2 * max(S + 1, 3) * gridDim.x per-block partial sums
  int* it_out;
  float* mon_out;
  int* conv_out;
};

// One grid reduction of NV values.  Reductions use the two halves of the
// partial buffer in turn (q counts them): a block writes reduction q + 2's
// partials only after the barrier of reduction q + 1, which no block
// reaches before it has read reduction q's.  The fold loads a thread's
// partials at once (coop.cuh grid_total_batch, grid_total's order).
template <int NV>
__device__ __forceinline__ void idr_reduce(cg::grid_group& grid, double (&acc)[NV],
                                           double* part, int half, int& q,
                                           double (&tot)[NV],
                                           double (&sh)[NV][GK_CG_WARPS],
                                           double (&bc)[NV]) {
  double* buf = part + (long long)(q & 1) * half * gridDim.x;
  block_partial<NV>(acc, buf, sh);
  grid.sync();
  grid_total_batch<NV, GK_CG_FOLD_BATCH(NV)>(buf, NV, 1, NV, tot, sh, bc);
  ++q;
}

// Rows a thread takes at once in every pass: its rows are t0, t0 + stride,
// ... as one row a thread grid-stride, in that order (so the float64 sums
// keep their order), GK_IDR_ROWS of them a trip.  On the H100 (PERF.md
// section 6) 2 beat 1 by 0.3% at s = 2 and 2.7% at s = 4; 4 lost at s = 2.
#define GK_IDR_ROWS 2

// f(i) for this thread's rows i < n, in order, GK_IDR_ROWS a trip.
template <typename F>
__device__ __forceinline__ void idr_rows(long long n, long long t0, long long stride, F f) {
  long long i = t0;
  for (; i + (GK_IDR_ROWS - 1) * stride < n; i += GK_IDR_ROWS * stride) {
#pragma unroll
    for (int q = 0; q < GK_IDR_ROWS; ++q) f(i + q * stride);
  }
  for (; i < n; i += stride) f(i);
}

// Row i of A (M src), minv[c] * src[c] gathered as one float32 product (or
// src[c] with the Identity), summed as gk_dia_row sums.
template <typename TD>
__device__ __forceinline__ float idr_row_m(const TD* __restrict__ D, const GkOffsets& offs,
                                           long long n, long long i, const float* src,
                                           const float* __restrict__ minv) {
  float acc = 0.f;
  for (int d = 0; d < offs.nd; ++d) {
    const long long j = i + offs.off[d];
    if (j >= 0 && j < n) {
      const float v = minv ? minv[j] * src[j] : src[j];
      acc += GkAcc<float>::load(D[d * n + i]) * v;
    }
  }
  return acc;
}

// r -= beta G[kk] and U[kk] -= alpha_ib U[ib] for ib < kk, in order: the
// updates step kk leaves to the next own-row pass.  Returns the new r_i.
template <int S>
__device__ __forceinline__ float idr_settle(int kk, long long i, long long n, float* r,
                                            const float* G, float* U, float beta,
                                            const float (&alpha)[S]) {
  const float ri = r[i] - beta * G[kk * n + i];
  r[i] = ri;
  if (kk > 0) {
    float ui = U[kk * n + i];
#pragma unroll
    for (int ib = 0; ib < S - 1; ++ib)
      if (ib < kk) ui = ui - alpha[ib] * U[ib * n + i];
    U[kk * n + i] = ui;
  }
  return ri;
}

// Blocks an SM that K16's registers must leave room for, at each s: the
// occupancy the kernel had before its updates were deferred (40, 48 and 64
// registers).  Left to itself the compiler took 64 registers at s = 2 and
// 128 at s = 4 (4 and 2 blocks an SM), 8% and 52% slower on the H100 than
// held (PERF.md section 6); 3 blocks an SM at s = 4 lost 17%.
#define GK_IDR_MIN_BLOCKS(S) ((S) == 1 ? 6 : (S) == 2 ? 5 : 4)

template <typename TD, int S>
__global__ void __launch_bounds__(GK_CG_THREADS, GK_IDR_MIN_BLOCKS(S))
    idr_fused_kernel(const IdrParams A) {
  cg::grid_group grid = cg::this_grid();
  constexpr int HALF = S + 1 > 3 ? S + 1 : 3;
  __shared__ double sh1[1][GK_CG_WARPS];
  __shared__ double shS[S][GK_CG_WARPS];
  __shared__ double shS1[S + 1][GK_CG_WARPS];
  __shared__ double sh3[3][GK_CG_WARPS];
  __shared__ double bc1[1];
  __shared__ double bcS[S];
  __shared__ double bcS1[S + 1];
  __shared__ double bc3[3];

  const TD* __restrict__ D = static_cast<const TD*>(A.diags);
  const long long n = A.n;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const float* __restrict__ P = A.P;
  const float* __restrict__ minv = A.minv;
  // x, r and U[kk] are read across rows by a product, always through
  // these pointers
  float* __restrict__ x = A.x;
  float* __restrict__ r = A.r;
  float* __restrict__ G = A.G;
  float* __restrict__ U = A.U;
  const float tol_sq = *A.tol_sq;
  const float kappa = A.kappa;
  int q = 0;

  // init: x = x0, r = r0, G = U = 0; f = P r0 and r0.r0
  double tS1[S + 1];
  {
    double acc[S + 1];
#pragma unroll
    for (int j = 0; j <= S; ++j) acc[j] = 0.0;
    idr_rows(n, t0, stride, [&](long long i) {
      const float ri = A.r0[i];
      x[i] = A.x0[i];
      r[i] = ri;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        G[j * n + i] = 0.f;
        U[j * n + i] = 0.f;
        acc[j] += (double)P[j * n + i] * ri;
      }
      acc[S] += (double)ri * ri;
    });
    idr_reduce<S + 1>(grid, acc, A.part, HALF, q, tS1, shS1, bcS1);
  }
  float f[S], Mm[S * S];
#pragma unroll
  for (int j = 0; j < S; ++j) f[j] = (float)tS1[j];
#pragma unroll
  for (int i = 0; i < S * S; ++i) Mm[i] = (i / S == i % S) ? 1.f : 0.f;
  const float rr0 = (float)tS1[S];
  float om = 1.f;
  float mon = !(rr0 <= tol_sq) ? CUDART_INF_F : rr0;
  int it = 0;

  while (it < A.max_iters && !(mon <= tol_sq)) {
    float beta[S];   // beta_kk of each step, for the x pass
    float alpha[S];  // the alphas of the last step, for its deferred U update
#pragma unroll
    for (int kk = 0; kk < S; ++kk) {
      // c: forward substitution on M[kk:, kk:] c = f[kk:]
      float csol[S];
#pragma unroll
      for (int i = 0; i < S; ++i) csol[i] = 0.f;
#pragma unroll
      for (int i = kk; i < S; ++i) {
        float acc = f[i];
#pragma unroll
        for (int j = kk; j < i; ++j) acc = acc - Mm[i * S + j] * csol[j];
        csol[i] = gk_sdiv(acc, Mm[i * S + i]);
      }

      // step kk - 1's updates, then u = om M (r - sum_j c_j G_j) +
      // sum_j c_j U_j into U[kk]
      idr_rows(n, t0, stride, [&](long long i) {
        float vi = r[i];
        if (kk > 0) vi = idr_settle<S>(kk - 1, i, n, r, G, U, beta[kk > 0 ? kk - 1 : 0], alpha);
#pragma unroll
        for (int j = kk; j < S; ++j) vi = vi - csol[j] * G[j * n + i];
        if (minv) vi = minv[i] * vi;
        float ui = om * vi;
#pragma unroll
        for (int j = kk; j < S; ++j) ui = ui + csol[j] * U[j * n + i];
        U[kk * n + i] = ui;
      });
      grid.sync();

      // g = A u into G[kk]; then the biorthogonalization against
      // P[0..kk-1], one reduction per alpha_i; the last reduction is the
      // new column of M, P g
      double mcol[S];
      if (kk == 0) {
        double acc[S];
#pragma unroll
        for (int j = 0; j < S; ++j) acc[j] = 0.0;
        idr_rows(n, t0, stride, [&](long long i) {
          const float gi = gk_dia_row<false>(D, A.offs, n, i, U + kk * n);
          G[kk * n + i] = gi;
#pragma unroll
          for (int j = 0; j < S; ++j) acc[j] += (double)P[j * n + i] * gi;
        });
        idr_reduce<S>(grid, acc, A.part, HALF, q, mcol, shS, bcS);
      } else {
        double pg[1];
        {
          double acc[1] = {0.0};
          idr_rows(n, t0, stride, [&](long long i) {
            const float gi = gk_dia_row<false>(D, A.offs, n, i, U + kk * n);
            G[kk * n + i] = gi;
            acc[0] += (double)P[i] * gi;
          });
          idr_reduce<1>(grid, acc, A.part, HALF, q, pg, sh1, bc1);
        }
#pragma unroll
        for (int ib = 0; ib < kk; ++ib) {
          alpha[ib] = gk_sdiv((float)pg[0], Mm[ib * S + ib]);
          if (ib + 1 < kk) {
            double acc[1] = {0.0};
            idr_rows(n, t0, stride, [&](long long i) {
              const float gi = G[kk * n + i] - alpha[ib] * G[ib * n + i];
              G[kk * n + i] = gi;
              acc[0] += (double)P[(ib + 1) * n + i] * gi;
            });
            idr_reduce<1>(grid, acc, A.part, HALF, q, pg, sh1, bc1);
          } else {
            double acc[S];
#pragma unroll
            for (int j = 0; j < S; ++j) acc[j] = 0.0;
            idr_rows(n, t0, stride, [&](long long i) {
              const float gi = G[kk * n + i] - alpha[ib] * G[ib * n + i];
              G[kk * n + i] = gi;
#pragma unroll
              for (int j = 0; j < S; ++j) acc[j] += (double)P[j * n + i] * gi;
            });
            idr_reduce<S>(grid, acc, A.part, HALF, q, mcol, shS, bcS);
          }
        }
      }
#pragma unroll
      for (int i = kk; i < S; ++i) Mm[i * S + kk] = (float)mcol[i];
      beta[kk] = gk_sdiv(f[kk], Mm[kk * S + kk]);
#pragma unroll
      for (int j = kk + 1; j < S; ++j) f[j] = f[j] - beta[kk] * Mm[j * S + kk];
      f[kk] = 0.f;
    }

    // the last step's updates; then the dimension-reduction step: t = A M r;
    // t.t, t.r, r.r
    idr_rows(n, t0, stride,
             [&](long long i) { idr_settle<S>(S - 1, i, n, r, G, U, beta[S - 1], alpha); });
    grid.sync();
    double t3[3];
    {
      double acc[3] = {0.0, 0.0, 0.0};
      idr_rows(n, t0, stride, [&](long long i) {
        const float ti = idr_row_m(D, A.offs, n, i, r, minv);
        const float ri = r[i];
        acc[0] += (double)ti * ti;
        acc[1] += (double)ti * ri;
        acc[2] += (double)ri * ri;
      });
      idr_reduce<3>(grid, acc, A.part, HALF, q, t3, sh3, bc3);
    }
    const float tt = (float)t3[0], tr = (float)t3[1], rr = (float)t3[2];
    const float om_raw = gk_sdiv(tr, tt);
    const float rho = fabsf(gk_sdiv(tr, sqrtf(tt) * sqrtf(rr)));
    om = rho < kappa ? om_raw * gk_sdiv(kappa, rho) : om_raw;

    // x += beta_kk U[kk] for each step, then x += om M r; then the residual
    // replacement r = b - A x with f = P r and the monitor r.r
    idr_rows(n, t0, stride, [&](long long i) {
      float xi = x[i];
#pragma unroll
      for (int kk = 0; kk < S; ++kk) xi = xi + beta[kk] * U[kk * n + i];
      const float vi = minv ? minv[i] * r[i] : r[i];
      x[i] = xi + om * vi;
    });
    grid.sync();
    {
      double acc[S + 1];
#pragma unroll
      for (int j = 0; j <= S; ++j) acc[j] = 0.0;
      idr_rows(n, t0, stride, [&](long long i) {
        const float ri = A.b[i] - gk_dia_row<false>(D, A.offs, n, i, x);
        r[i] = ri;
#pragma unroll
        for (int j = 0; j < S; ++j) acc[j] += (double)P[j * n + i] * ri;
        acc[S] += (double)ri * ri;
      });
      idr_reduce<S + 1>(grid, acc, A.part, HALF, q, tS1, shS1, bcS1);
    }
#pragma unroll
    for (int j = 0; j < S; ++j) f[j] = (float)tS1[j];
    mon = (float)tS1[S];
    ++it;
  }

  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *A.it_out = it;
    *A.mon_out = mon;
    *A.conv_out = (mon <= tol_sq) ? 1 : 0;
  }
}

#define GK_IDR_SWITCH_S(s, CALL_S)               \
  switch (s) {                                   \
    case 1: return CALL_S(1);                    \
    case 2: return CALL_S(2);                    \
    case 3: return CALL_S(3);                    \
    case 4: return CALL_S(4);                    \
    default: return (int)cudaErrorInvalidValue;  \
  }

template <int S>
static int idr_grid(int d_dtype, int* blocks) {
  if (d_dtype == GK_F32) return gk_coop_blocks(idr_fused_kernel<float, S>, blocks);
  if (d_dtype == GK_BF16) return gk_coop_blocks(idr_fused_kernel<__nv_bfloat16, S>, blocks);
  return (int)cudaErrorInvalidValue;
}

template <int S>
static int idr_launch(int d_dtype, const IdrParams& p, int blocks, void* stream) {
  if (d_dtype == GK_F32) return gk_coop_launch(idr_fused_kernel<float, S>, p, blocks, stream);
  if (d_dtype == GK_BF16)
    return gk_coop_launch(idr_fused_kernel<__nv_bfloat16, S>, p, blocks, stream);
  return (int)cudaErrorInvalidValue;
}

// Blocks of the cooperative grid for the diagonals' dtype and s (the
// wrapper sizes the partial sums, 2 max(s + 1, 3) doubles a block, from it).
extern "C" int idr_fused_grid(int d_dtype, int s, int* blocks) {
#define GK_GRID_S(S) idr_grid<S>(d_dtype, blocks)
  GK_IDR_SWITCH_S(s, GK_GRID_S)
#undef GK_GRID_S
}

extern "C" int idr_fused_solve(const void* diags, int d_dtype, const long long* offsets,
                               int nd, long long n, int s, const float* P,
                               const float* r0, const float* x0, const float* b,
                               const float* minv, const float* tol_sq, float kappa,
                               int max_iters, float* x, float* r, float* G, float* U,
                               double* part, int blocks, int* it_out,
                               float* mon_out, int* conv_out, void* stream) {
  if (nd < 1 || nd > GK_MAX_DIAGS || blocks < 1) return (int)cudaErrorInvalidValue;
  IdrParams p;
  p.diags = diags;
  p.offs.nd = nd;
  for (int d = 0; d < nd; ++d) p.offs.off[d] = offsets[d];
  p.n = n;
  p.P = P;
  p.r0 = r0;
  p.x0 = x0;
  p.b = b;
  p.minv = minv;
  p.tol_sq = tol_sq;
  p.kappa = kappa;
  p.max_iters = max_iters;
  p.x = x;
  p.r = r;
  p.G = G;
  p.U = U;
  p.part = part;
  p.it_out = it_out;
  p.mon_out = mon_out;
  p.conv_out = conv_out;
#define GK_LAUNCH_S(S) idr_launch<S>(d_dtype, p, blocks, stream)
  GK_IDR_SWITCH_S(s, GK_LAUNCH_S)
#undef GK_LAUNCH_S
}
