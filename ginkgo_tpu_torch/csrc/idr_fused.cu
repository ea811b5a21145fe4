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
// one thread in every pass, so passes that read only their own rows (u,
// r -= beta g, x += beta u, v = M r, x += om v) follow each other without a
// barrier; a barrier comes before a product (which reads its source across
// rows, with __ldcg) and with every reduction.  The biorthogonalization is
// sequential, as the TPU kernel's (:163-187): alpha_i is a dot on the g
// already reduced by alpha_0..alpha_{i-1}, so each is one grid reduction,
// fused with the subtraction that precedes it.  u_new lives in U[kk]
// itself (the TPU kernel stages it and copies it there).  Dot products are
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
  float* w;      // v = M r, the source of the omega step's product
  double* part;  // 2 * max(S + 1, 3) * gridDim.x per-block partial sums
  int* it_out;
  float* mon_out;
  int* conv_out;
};

// One grid reduction of NV values.  Reductions use the two halves of the
// partial buffer in turn (q counts them): a block writes reduction q + 2's
// partials only after the barrier of reduction q + 1, which no block
// reaches before it has read reduction q's.
template <int NV>
__device__ __forceinline__ void idr_reduce(cg::grid_group& grid, double (&acc)[NV],
                                           double* part, int half, int& q,
                                           double (&tot)[NV],
                                           double (&sh)[NV][GK_CG_WARPS],
                                           double (&bc)[NV]) {
  double* buf = part + (long long)(q & 1) * half * gridDim.x;
  block_partial<NV>(acc, buf, sh);
  grid.sync();
  grid_total<NV>(buf, tot, sh, bc);
  ++q;
}

template <typename TD, int S>
__global__ void __launch_bounds__(GK_CG_THREADS) idr_fused_kernel(const IdrParams A) {
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
  float* x = A.x;  // the replacement's product reads it across rows
  float* __restrict__ r = A.r;
  float* __restrict__ G = A.G;
  float* U = A.U;  // U[kk] is the source of g = A u
  float* w = A.w;
  const float tol_sq = *A.tol_sq;
  const float kappa = A.kappa;
  int q = 0;

  // init: x = x0, r = r0, G = U = 0; f = P r0 and r0.r0
  double tS1[S + 1];
  {
    double acc[S + 1];
#pragma unroll
    for (int j = 0; j <= S; ++j) acc[j] = 0.0;
    for (long long i = t0; i < n; i += stride) {
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
    }
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

      // u = om M (r - sum_j c_j G_j) + sum_j c_j U_j, into U[kk]
      for (long long i = t0; i < n; i += stride) {
        float vi = r[i];
#pragma unroll
        for (int j = kk; j < S; ++j) vi = vi - csol[j] * G[j * n + i];
        if (minv) vi = minv[i] * vi;
        float ui = om * vi;
#pragma unroll
        for (int j = kk; j < S; ++j) ui = ui + csol[j] * U[j * n + i];
        U[kk * n + i] = ui;
      }
      grid.sync();

      // g = A u into G[kk]; then the biorthogonalization against
      // P[0..kk-1], one reduction per alpha_i; the last reduction is the
      // new column of M, P g
      double mcol[S];
      if (kk == 0) {
        double acc[S];
#pragma unroll
        for (int j = 0; j < S; ++j) acc[j] = 0.0;
        for (long long i = t0; i < n; i += stride) {
          const float gi = gk_dia_row(D, A.offs, n, i, U + kk * n);
          G[kk * n + i] = gi;
#pragma unroll
          for (int j = 0; j < S; ++j) acc[j] += (double)P[j * n + i] * gi;
        }
        idr_reduce<S>(grid, acc, A.part, HALF, q, mcol, shS, bcS);
      } else {
        double pg[1];
        {
          double acc[1] = {0.0};
          for (long long i = t0; i < n; i += stride) {
            const float gi = gk_dia_row(D, A.offs, n, i, U + kk * n);
            G[kk * n + i] = gi;
            acc[0] += (double)P[i] * gi;
          }
          idr_reduce<1>(grid, acc, A.part, HALF, q, pg, sh1, bc1);
        }
#pragma unroll
        for (int ib = 0; ib < kk; ++ib) {
          const float alpha = gk_sdiv((float)pg[0], Mm[ib * S + ib]);
          if (ib + 1 < kk) {
            double acc[1] = {0.0};
            for (long long i = t0; i < n; i += stride) {
              const float gi = G[kk * n + i] - alpha * G[ib * n + i];
              G[kk * n + i] = gi;
              U[kk * n + i] = U[kk * n + i] - alpha * U[ib * n + i];
              acc[0] += (double)P[(ib + 1) * n + i] * gi;
            }
            idr_reduce<1>(grid, acc, A.part, HALF, q, pg, sh1, bc1);
          } else {
            double acc[S];
#pragma unroll
            for (int j = 0; j < S; ++j) acc[j] = 0.0;
            for (long long i = t0; i < n; i += stride) {
              const float gi = G[kk * n + i] - alpha * G[ib * n + i];
              G[kk * n + i] = gi;
              U[kk * n + i] = U[kk * n + i] - alpha * U[ib * n + i];
#pragma unroll
              for (int j = 0; j < S; ++j) acc[j] += (double)P[j * n + i] * gi;
            }
            idr_reduce<S>(grid, acc, A.part, HALF, q, mcol, shS, bcS);
          }
        }
      }
#pragma unroll
      for (int i = kk; i < S; ++i) Mm[i * S + kk] = (float)mcol[i];
      const float beta = gk_sdiv(f[kk], Mm[kk * S + kk]);

      // r -= beta g; x += beta u (own rows: the next pass reads only its
      // own rows, so no barrier)
      for (long long i = t0; i < n; i += stride) {
        r[i] = r[i] - beta * G[kk * n + i];
        x[i] = x[i] + beta * U[kk * n + i];
      }
#pragma unroll
      for (int j = kk + 1; j < S; ++j) f[j] = f[j] - beta * Mm[j * S + kk];
      f[kk] = 0.f;
    }

    // the dimension-reduction step: v = M r; t = A v; t.t, t.r, r.r
    for (long long i = t0; i < n; i += stride) w[i] = minv ? minv[i] * r[i] : r[i];
    grid.sync();
    double t3[3];
    {
      double acc[3] = {0.0, 0.0, 0.0};
      for (long long i = t0; i < n; i += stride) {
        const float ti = gk_dia_row(D, A.offs, n, i, w);
        const float ri = r[i];
        acc[0] += (double)ti * ti;
        acc[1] += (double)ti * ri;
        acc[2] += (double)ri * ri;
      }
      idr_reduce<3>(grid, acc, A.part, HALF, q, t3, sh3, bc3);
    }
    const float tt = (float)t3[0], tr = (float)t3[1], rr = (float)t3[2];
    const float om_raw = gk_sdiv(tr, tt);
    const float rho = fabsf(gk_sdiv(tr, sqrtf(tt) * sqrtf(rr)));
    om = rho < kappa ? om_raw * gk_sdiv(kappa, rho) : om_raw;

    // x += om v; then the residual replacement r = b - A x with f = P r
    // and the monitor r.r
    for (long long i = t0; i < n; i += stride) x[i] = x[i] + om * w[i];
    grid.sync();
    {
      double acc[S + 1];
#pragma unroll
      for (int j = 0; j <= S; ++j) acc[j] = 0.0;
      for (long long i = t0; i < n; i += stride) {
        const float ri = A.b[i] - gk_dia_row(D, A.offs, n, i, x);
        r[i] = ri;
#pragma unroll
        for (int j = 0; j < S; ++j) acc[j] += (double)P[j * n + i] * ri;
        acc[S] += (double)ri * ri;
      }
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
                               float* w, double* part, int blocks, int* it_out,
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
  p.w = w;
  p.part = part;
  p.it_out = it_out;
  p.mon_out = mon_out;
  p.conv_out = conv_out;
#define GK_LAUNCH_S(S) idr_launch<S>(d_dtype, p, blocks, stream)
  GK_IDR_SWITCH_S(s, GK_LAUNCH_S)
#undef GK_LAUNCH_S
}
