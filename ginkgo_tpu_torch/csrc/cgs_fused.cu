// Whole-solve CGS and BiCG in persistent cooperative kernels: kernels K13
// (cgs_fused) and K14 (bicg_fused) of the PyTorch port, and K20
// (pell_cgs_fused), K13's loop on a Pell in a kernel of its own on K7's
// chunked rows (below).
//
// Replaces ginkgo_tpu/ops/pallas_cgs.py cgs_vmem_solve (_cgs_kernel,
// :61-178) and bicg_vmem_solve (_bicg_kernel, :266-390), and
// ginkgo_tpu/ops/pallas_pell_cg.py pell_cgs_vmem_solve (_pell_cgs_kernel,
// :559).  On a Pell, M is applied explicitly, staged as the TPU kernel
// stages it (y = M p, w = M (u + q)): PELL values have no column fold.
//
// CGS is transpose-free.  As in K12 a diagonal preconditioner is folded
// into the operator before the launch (solver/_fused_gate.fold_minv), and
// minv is applied only in the x update, x += alpha minv (u + q).  Two
// products with A M an iteration.
//
// BiCG carries A's diagonals and those of its conjugate transpose (offsets
// negated, its own range of columns).  A real diagonal M is its own M^H, so
// z = M r and z2 = M r2 are one multiply each, recomputed where they are
// needed.
//
// What bounds them on the H100: bytes.  CGS's bound is (nd sizeof(TD) +
// 36) n (40 n with minv): the diagonals, rr and minv in, x, r, q and p in
// and out.  BiCG's is ((nd + nd_t) sizeof(TD) + 40) n: the diagonals, r,
// r2, p, p2 and x in and out.
//
// What the design does about it: K4's and K12's.  Dot products are float64
// per-block partials that every block sums in one fixed order; consecutive
// reductions with no barrier between them write different partial
// buffers.
//
// CGS (K13) runs three passes and three grid barriers an iteration on
// K14's footing: each row one thread's in every pass (grid-stride,
// GK_CGS_ROWS rows a trip with their loads issued before any store,
// GkStrideRows), so u, q, x and r are read back only by the thread that
// wrote them, and the products gather with plain loads after the barrier
// that follows the pass which wrote their source:
//   1: u = r + beta q; p = u + beta (q + beta p);
//   2: v = (A M) p; partial <rr, v>; fold -> alpha;
//   3: t = (A M) w, w_j = u_j + (u_j - alpha v_j) formed at every gathered
//      column from u and v, in the operations of q = u - alpha v and w =
//      u + q (so with their bits); q = u - alpha v on the own rows;
//      x += alpha (M w); r -= alpha t; partials <rr, r> and r.r; fold ->
//      the next rho and the monitor.
// Bytes a row and iteration: 2 nd sizeof(TD) + 64, 68 with minv (1: r, q,
// p in, u, p out; 2: p gathered, rr in, v out; 3: u and v gathered, rr, x,
// r in, q, x, r out).  The four-pass order (q and w stored in a pass of
// their own, w gathered in a fourth: 2 nd sizeof(TD) + 72) ran 8% slower
// on the H100, its extra barrier and fold costing more than the second
// gathered vector (PERF.md section 6).  The partials are value-major and
// each fold loads them at once (coop.cuh grid_total_batch).
//
// BiCG (K14) runs three passes and three grid barriers an iteration, each
// row one thread's in every pass (grid-stride; a thread takes GK_BICG_ROWS
// rows a trip and issues their loads together, coop.cuh GkStrideRows), so
// a vector is read back at its own row only by the thread that wrote it,
// and the products gather p and p2 with plain loads after the barrier that
// follows their pass (grid.sync() invalidates L1):
//   1: p = M r + beta p, p2 = M r2 + beta p2; x += alpha p of the previous
//      iteration, deferred to the pass that reads p's own rows anyway (a
//      last update runs on the own rows after the loop);
//   2: q = A p, q2 = A^H p2; partial <p2, q> (p2's own row is a gathered
//      line already); fold -> alpha;
//   3: r -= alpha q, r2 -= alpha q2; partials <r2, M r> and r.r; fold.
// Bytes a row and iteration, nd and nd_t diagonals of TD: (nd + nd_t)
// sizeof(TD) + 72, 80 with minv.  The partials are value-major and each
// fold loads them at once (coop.cuh grid_total_batch).
// A two-pass form (K4m's pass A: p_new and p2_new formed at every column
// the products read from r, r2, minv and p_old, p and p2 in two buffers
// each; (nd + nd_t) sizeof(TD) + 64 bytes a row) lost to it on the H100,
// since it gathers r and p_old where pass 2 gathers p alone (PERF.md
// section 6).
//
// Semantics kept from the TPU kernels: shadow residual rr = r0 (BiCG: r2 =
// r0), the first rho = <rr, r0> (BiCG: <r0, M r0>), p = q = 0 (BiCG: p =
// p2 = 0, so the first direction is M r + beta 0), rho_old starts at 1;
// the loop runs while it < max_iters && !(mon <= tol_sq), so a NaN monitor
// keeps iterating; exact mode monitors r.r after the update, implicit mode
// |rho| from before it; zero denominators give 0.

#include "coop.cuh"
#include "pell.cuh"

namespace cg = cooperative_groups;

// K13's rows a thread takes a trip (GkStrideRows) and the blocks an SM its
// registers must leave room for (PERF.md section 6).
#define GK_CGS_ROWS 4
#define GK_CGS_MIN_BLOCKS 4

template <typename TD>
struct CgsParams {
  GkDiaOp<TD> op;  // A M, a diagonal M folded into the Dia
  long long n;
  const float* r0;
  const float* x0;
  const float* minv;    // nullptr: Identity; used in the x update only
  const float* tol_sq;  // device scalar
  int max_iters;
  int implicit;
  float* x;
  float* r;
  float* rr;
  float* q;
  float* u;
  float* v;
  float* p;
  double* part;  // 3 * gridDim.x per-block partial sums
  int* it_out;
  float* mon_out;
  int* conv_out;
};

template <typename TD>
__global__ void __launch_bounds__(GK_CG_THREADS, GK_CGS_MIN_BLOCKS)
    cgs_fused_kernel(const CgsParams<TD> P) {
  constexpr int R = GK_CGS_ROWS;
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[1][GK_CG_WARPS];
  __shared__ double sh2[2][GK_CG_WARPS];
  __shared__ double bc1[1];
  __shared__ double bc2[2];

  const TD* __restrict__ D = P.op.diags;
  const GkOffsets& offs = P.op.offs;
  const long long n = P.n;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int G = gridDim.x;
  double* part_sg = P.part;     // [G]     sigma = <rr, v>
  double* part_u = P.part + G;  // [2][G]  <rr, r>, r.r (the init: <r0, r0>)
  float* __restrict__ x = P.x;
  float* __restrict__ r = P.r;
  float* __restrict__ rr = P.rr;
  float* __restrict__ q = P.q;
  float* __restrict__ u = P.u;  // read across rows by pass 3
  float* __restrict__ v = P.v;  // read across rows by pass 3
  float* p = P.p;  // read across rows by pass 2
  const float* __restrict__ minv = P.minv;

  // init: x = x0, r = rr = r0, q = p = 0; rho = <r0, r0>
  {
    double acc[1] = {0.0};
    for (long long i = t0; i < n; i += stride) {
      const float ri = P.r0[i];
      x[i] = P.x0[i];
      r[i] = ri;
      rr[i] = ri;
      q[i] = 0.f;
      p[i] = 0.f;
      acc[0] += (double)ri * ri;
    }
    block_partial_vm<1>(acc, part_u, sh1);
  }
  grid.sync();
  double tot1[1], tot2[2];
  grid_total_batch<1, 4>(part_u, 1, G, 1, tot1, sh1, bc1);
  float rho_new = (float)tot1[0];
  float rho_old = 1.f;

  const float tol_sq = *P.tol_sq;
  int it = 0;
  float mon = CUDART_INF_F;
  while (it < P.max_iters && !(mon <= tol_sq)) {
    const float beta = gk_sdiv(rho_new, rho_old);

    // pass 1: u = r + beta q; p = u + beta (q + beta p)
    for (long long i0 = t0; i0 < n; i0 += R * stride) {
      const GkStrideRows<R> rows(i0, stride, n);
      float rv[R], qv[R], pv[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const long long i = rows.i[k];
        const bool ok = rows.ok[k];
        rv[k] = ok ? r[i] : 0.f;
        qv[k] = ok ? q[i] : 0.f;
        pv[k] = ok ? p[i] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (!rows.ok[k]) continue;
        const long long i = rows.i[k];
        const float ui = rv[k] + beta * qv[k];
        u[i] = ui;
        p[i] = ui + beta * (qv[k] + beta * pv[k]);
      }
    }
    grid.sync();

    // pass 2: v = (A M) p (plain gathers after the barrier); partial
    // sigma = <rr, v>
    {
      double acc[1] = {0.0};
      for (long long i0 = t0; i0 < n; i0 += R * stride) {
        const GkStrideRows<R> rows(i0, stride, n);
        float vv[R], rrv[R];
        gk_dia_rows<R>(D, offs, n, rows, p, vv);
#pragma unroll
        for (int k = 0; k < R; ++k) rrv[k] = rows.ok[k] ? rr[rows.i[k]] : 0.f;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          if (!rows.ok[k]) continue;
          v[rows.i[k]] = vv[k];
          acc[0] += (double)rrv[k] * vv[k];
        }
      }
      block_partial_vm<1>(acc, part_sg, sh1);
    }
    grid.sync();
    grid_total_batch<1, 4>(part_sg, 1, G, 1, tot1, sh1, bc1);
    const float alpha = gk_sdiv(rho_new, (float)tot1[0]);

    // pass 3: t = (A M) w with w_j = u_j + (u_j - alpha v_j) formed at every
    // gathered column, as q = u - alpha v and w = u + q; q on the own rows;
    // x += alpha (M w); r -= alpha t; partials <rr, r> and r.r
    {
      double acc[2] = {0.0, 0.0};
      for (long long i0 = t0; i0 < n; i0 += R * stride) {
        const GkStrideRows<R> rows(i0, stride, n);
        float tv[R], uv[R], vv[R], mv[R], xv[R], rv[R], rrv[R];
#pragma unroll
        for (int k = 0; k < R; ++k) tv[k] = 0.f;
        for (int d = 0; d < offs.nd; ++d) {
          const long long off = offs.off[d];
          float dv[R], uj[R], vj[R];
          bool in[R];
#pragma unroll
          for (int k = 0; k < R; ++k) {
            const long long j = rows.i[k] + off;
            in[k] = rows.ok[k] && j >= 0 && j < n;
            dv[k] = in[k] ? GkAcc<float>::load(D[d * n + rows.i[k]]) : 0.f;
            uj[k] = in[k] ? u[j] : 0.f;
            vj[k] = in[k] ? v[j] : 0.f;
          }
#pragma unroll
          for (int k = 0; k < R; ++k)
            if (in[k]) tv[k] += dv[k] * (uj[k] + (uj[k] - alpha * vj[k]));
        }
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const long long i = rows.i[k];
          const bool ok = rows.ok[k];
          uv[k] = ok ? u[i] : 0.f;
          vv[k] = ok ? v[i] : 0.f;
          mv[k] = (ok && minv) ? minv[i] : 1.f;
          xv[k] = ok ? x[i] : 0.f;
          rv[k] = ok ? r[i] : 0.f;
          rrv[k] = ok ? rr[i] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < R; ++k) {
          if (!rows.ok[k]) continue;
          const long long i = rows.i[k];
          const float qi = uv[k] - alpha * vv[k];
          q[i] = qi;
          const float wi = uv[k] + qi;
          const float mwi = minv ? mv[k] * wi : wi;
          x[i] = xv[k] + alpha * mwi;
          const float ri = rv[k] - alpha * tv[k];
          r[i] = ri;
          acc[0] += (double)rrv[k] * ri;
          acc[1] += (double)ri * ri;
        }
      }
      block_partial_vm<2>(acc, part_u, sh2);
    }
    grid.sync();
    grid_total_batch<2, 4>(part_u, 1, G, 2, tot2, sh2, bc2);
    mon = P.implicit ? fabsf(rho_new) : (float)tot2[1];
    rho_old = rho_new;
    rho_new = (float)tot2[0];
    ++it;
  }

  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *P.it_out = it;
    *P.mon_out = mon;
    *P.conv_out = (mon <= tol_sq) ? 1 : 0;
  }
}

// K14's rows a thread takes a trip (GkStrideRows) and the blocks an SM its
// registers must leave room for.  On the H100 4 rows at 4 blocks an SM (64
// registers) beat 1 row, 2 rows at 4 and 5 blocks, and 4, 6 and 8 rows at 3
// (80 registers, 6 and 8 rows with a stack frame; PERF.md section 6).
#define GK_BICG_ROWS 4
#define GK_BICG_MIN_BLOCKS 4

struct BicgParams {
  const void* diags;    // (nd, n) of A
  const void* diags_t;  // (nd_t, n) of A^H
  GkOffsets offs;
  GkOffsets offs_t;
  long long n;
  const float* r0;
  const float* x0;
  const float* minv;    // nullptr: Identity
  const float* tol_sq;  // device scalar
  int max_iters;
  int implicit;
  float* x;
  float* r;
  float* r2;
  float* q;
  float* q2;
  float* p;
  float* p2;
  double* part;  // 3 * gridDim.x per-block partial sums
  int* it_out;
  float* mon_out;
  int* conv_out;
};

template <typename TA, typename TT>
__global__ void __launch_bounds__(GK_CG_THREADS, GK_BICG_MIN_BLOCKS)
    bicg_fused_kernel(const BicgParams P) {
  constexpr int R = GK_BICG_ROWS;
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[1][GK_CG_WARPS];
  __shared__ double sh2[2][GK_CG_WARPS];
  __shared__ double bc1[1];
  __shared__ double bc2[2];

  const TA* __restrict__ D = static_cast<const TA*>(P.diags);
  const TT* __restrict__ Dt = static_cast<const TT*>(P.diags_t);
  const long long n = P.n;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int G = gridDim.x;
  double* part_pq = P.part;     // [G]     <p2, q>
  double* part_u = P.part + G;  // [2][G]  <r2, M r>, r.r (the init: <r0, M r0>)
  float* __restrict__ x = P.x;
  float* __restrict__ r = P.r;
  float* __restrict__ r2 = P.r2;
  float* __restrict__ q = P.q;
  float* __restrict__ q2 = P.q2;
  float* p = P.p;  // read across rows by pass 2
  float* p2 = P.p2;
  const float* __restrict__ minv = P.minv;

  // init: x = x0, r = r2 = r0, p = p2 = 0; rho = <r0, M r0>
  {
    double acc[1] = {0.0};
    for (long long i = t0; i < n; i += stride) {
      const float ri = P.r0[i];
      x[i] = P.x0[i];
      r[i] = ri;
      r2[i] = ri;
      p[i] = 0.f;
      p2[i] = 0.f;
      const float zi = minv ? minv[i] * ri : ri;
      acc[0] += (double)ri * zi;
    }
    block_partial_vm<1>(acc, part_u, sh1);
  }
  grid.sync();
  double tot1[1], tot2[2];
  grid_total_batch<1, 4>(part_u, 1, G, 1, tot1, sh1, bc1);
  float rho_new = (float)tot1[0];
  float rho_old = 1.f;
  float alpha = 0.f;

  const float tol_sq = *P.tol_sq;
  int it = 0;
  float mon = CUDART_INF_F;
  while (it < P.max_iters && !(mon <= tol_sq)) {
    const float beta = gk_sdiv(rho_new, rho_old);

    // pass 1: p = M r + beta p; p2 = M r2 + beta p2; the previous
    // iteration's x += alpha p, from p before its update
    for (long long i0 = t0; i0 < n; i0 += R * stride) {
      const GkStrideRows<R> rows(i0, stride, n);
      float rv[R], r2v[R], mv[R], pv[R], p2v[R], xv[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const long long i = rows.i[k];
        const bool ok = rows.ok[k];
        rv[k] = ok ? r[i] : 0.f;
        r2v[k] = ok ? r2[i] : 0.f;
        mv[k] = (ok && minv) ? minv[i] : 1.f;
        pv[k] = ok ? p[i] : 0.f;
        p2v[k] = ok ? p2[i] : 0.f;
        xv[k] = (ok && it > 0) ? x[i] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (!rows.ok[k]) continue;
        const long long i = rows.i[k];
        const float zi = minv ? mv[k] * rv[k] : rv[k];
        const float z2i = minv ? mv[k] * r2v[k] : r2v[k];
        if (it > 0) x[i] = xv[k] + alpha * pv[k];
        p[i] = zi + beta * pv[k];
        p2[i] = z2i + beta * p2v[k];
      }
    }
    grid.sync();

    // pass 2: q = A p, q2 = A^H p2 (plain gathers after the barrier);
    // partial <p2, q>
    {
      double acc[1] = {0.0};
      for (long long i0 = t0; i0 < n; i0 += R * stride) {
        const GkStrideRows<R> rows(i0, stride, n);
        float qv[R], q2v[R], p2v[R];
        gk_dia_rows<R>(D, P.offs, n, rows, p, qv);
        gk_dia_rows<R>(Dt, P.offs_t, n, rows, p2, q2v);
#pragma unroll
        for (int k = 0; k < R; ++k) p2v[k] = rows.ok[k] ? p2[rows.i[k]] : 0.f;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          if (!rows.ok[k]) continue;
          q[rows.i[k]] = qv[k];
          q2[rows.i[k]] = q2v[k];
          acc[0] += (double)p2v[k] * qv[k];
        }
      }
      block_partial_vm<1>(acc, part_pq, sh1);
    }
    grid.sync();
    grid_total_batch<1, 4>(part_pq, 1, G, 1, tot1, sh1, bc1);
    alpha = gk_sdiv(rho_new, (float)tot1[0]);

    // pass 3: r -= alpha q; r2 -= alpha q2; partial <r2, M r> (the next
    // rho) and r.r
    {
      double acc[2] = {0.0, 0.0};
      for (long long i0 = t0; i0 < n; i0 += R * stride) {
        const GkStrideRows<R> rows(i0, stride, n);
        float rv[R], r2v[R], qv[R], q2v[R], mv[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const long long i = rows.i[k];
          const bool ok = rows.ok[k];
          rv[k] = ok ? r[i] : 0.f;
          qv[k] = ok ? q[i] : 0.f;
          r2v[k] = ok ? r2[i] : 0.f;
          q2v[k] = ok ? q2[i] : 0.f;
          mv[k] = (ok && minv) ? minv[i] : 1.f;
        }
#pragma unroll
        for (int k = 0; k < R; ++k) {
          if (!rows.ok[k]) continue;
          const long long i = rows.i[k];
          const float ri = rv[k] - alpha * qv[k];
          r[i] = ri;
          const float r2i = r2v[k] - alpha * q2v[k];
          r2[i] = r2i;
          const float zi = minv ? mv[k] * ri : ri;
          acc[0] += (double)r2i * zi;
          acc[1] += (double)ri * ri;
        }
      }
      block_partial_vm<2>(acc, part_u, sh2);
    }
    grid.sync();
    grid_total_batch<2, 4>(part_u, 1, G, 2, tot2, sh2, bc2);
    mon = P.implicit ? fabsf(rho_new) : (float)tot2[1];
    rho_old = rho_new;
    rho_new = (float)tot2[0];
    ++it;
  }

  // the last iteration's x += alpha p, on this thread's own rows
  if (it > 0) {
    for (long long i = t0; i < n; i += stride) x[i] = x[i] + alpha * p[i];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *P.it_out = it;
    *P.mon_out = mon;
    *P.conv_out = (mon <= tol_sq) ? 1 : 0;
  }
}

static void copy_offsets(GkOffsets& dst, const long long* offsets, int nd) {
  dst.nd = nd;
  for (int d = 0; d < nd; ++d) dst.off[d] = offsets[d];
}

// K13's kernel for diagonals of d_dtype as `kernel`; any other dtype
// returns cudaErrorInvalidValue.
#define GK_CGS_DISPATCH(d_dtype, CALL)                    \
  do {                                                    \
    if (d_dtype == GK_F32) {                              \
      auto kernel = cgs_fused_kernel<float>;              \
      return CALL;                                        \
    }                                                     \
    if (d_dtype == GK_BF16) {                             \
      auto kernel = cgs_fused_kernel<__nv_bfloat16>;      \
      return CALL;                                        \
    }                                                     \
    return (int)cudaErrorInvalidValue;                    \
  } while (0)

// Blocks of K13's cooperative grid (3 doubles of partial sums per block).
extern "C" int cgs_fused_grid(int d_dtype, int* blocks) {
  GK_CGS_DISPATCH(d_dtype, gk_coop_blocks(kernel, blocks));
}

// K13's launch: out = {blocks of the cooperative grid, threads a block,
// blocks an SM, registers a thread}.
extern "C" int cgs_fused_config(int d_dtype, int* out) {
  GK_CGS_DISPATCH(d_dtype, gk_coop_config(kernel, out));
}

template <typename TD>
static int cgs_launch(const void* diags, const long long* offsets, int nd, long long n,
                      const float* r0, const float* x0, const float* minv, const float* tol_sq,
                      int max_iters, int implicit, float* x, float* r, float* rr, float* q,
                      float* u, float* v, float* p, double* part, int blocks,
                      int* it_out, float* mon_out, int* conv_out, void* stream) {
  CgsParams<TD> P;
  P.op = gk_dia_op<TD>(diags, offsets, nd, n);
  P.n = n;
  P.r0 = r0;
  P.x0 = x0;
  P.minv = minv;
  P.tol_sq = tol_sq;
  P.max_iters = max_iters;
  P.implicit = implicit;
  P.x = x;
  P.r = r;
  P.rr = rr;
  P.q = q;
  P.u = u;
  P.v = v;
  P.p = p;
  P.part = part;
  P.it_out = it_out;
  P.mon_out = mon_out;
  P.conv_out = conv_out;
  return gk_coop_launch(cgs_fused_kernel<TD>, P, blocks, stream);
}

extern "C" int cgs_fused_solve(
    const void* diags, int d_dtype, const long long* offsets, int nd, long long n,
    const float* r0, const float* x0, const float* minv, const float* tol_sq,
    int max_iters, int implicit, float* x, float* r, float* rr, float* q, float* u,
    float* v, float* p, double* part, int blocks, int* it_out,
    float* mon_out, int* conv_out, void* stream) {
  if (nd < 1 || nd > GK_MAX_DIAGS || blocks < 1) return (int)cudaErrorInvalidValue;
#define GK_CGS_LAUNCH(TD)                                                                     \
  cgs_launch<TD>(diags, offsets, nd, n, r0, x0, minv, tol_sq, max_iters, implicit, x, r, rr, \
                 q, u, v, p, part, blocks, it_out, mon_out, conv_out, stream)
  if (d_dtype == GK_F32) return GK_CGS_LAUNCH(float);
  if (d_dtype == GK_BF16) return GK_CGS_LAUNCH(__nv_bfloat16);
#undef GK_CGS_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K20 on a Pell: K13's four passes and four grid barriers an iteration on
// K7's chunked rows (pell.cuh GkPellChunks: chunks of GK_PELL_CHUNK_ROWS
// rows a thread, 32-bit rows).  Every pass walks the thread's own rows in
// the same chunk order, so u, p, q, w, x and r are read back only by the
// thread that wrote them, with plain loads; the two products gather p and
// M w across rows with plain loads after the barrier that follows their
// pass (grid.sync() invalidates L1), the tile's slot range and bases read
// once for a thread's rows.
//
//   1: u = r + beta q; p = u + beta (q + beta p)
//   2: v = A (M p); partial <rr, v>; fold -> alpha
//   3: q = u - alpha v; w = M (u + q); x += alpha w
//   4: t = A w; r -= alpha t; partial <rr, r>, r.r; fold -> the next rho
//      and the monitor
//
// M = diag(minv) is staged as in K19 (bicgstab_fused.cu): y = M p in pass
// 1 and w = M (u + q) in pass 3, one float32 product an entry, gathered by
// the products.  The x update runs in pass 3, where w is formed and alpha
// known (the same products in the same order as in pass 4, where K13 runs
// it; 0.2% faster on the H100, PERF.md section 6).  Bytes a row and
// iteration, the plan apart: 72 with the Identity (1: r, q, p in, u, p
// out; 2: p gathered, rr in, v out; 3: u, v, x in, q, w, x out; 4: w
// gathered, r, rr in, r out), 84 with Jacobi (minv in passes 1 and 3, y
// out and gathered).
struct PellCgsParams {
  const void* values;
  const void* qidx;
  const int* bases;
  const int* tile_ptr;
  int S;
  int G;
  int n;
  const float* r0;
  const float* x0;
  const float* minv;    // nullptr: Identity
  const float* tol_sq;  // device scalar
  int max_iters;
  int implicit;
  float* x;
  float* r;
  float* rr;
  float* q;
  float* u;
  float* v;
  float* p;
  float* w;  // M (u + q)
  float* y;  // M p with Jacobi, else unused
  double* part;  // 3 * gridDim.x per-block partial sums
  int* it_out;
  float* mon_out;
  int* conv_out;
};

using CgsChunks = GkPellChunks<GK_CG_THREADS>;

template <typename TV, typename TQ>
__global__ void __launch_bounds__(GK_CG_THREADS, GK_PELL_KRYLOV_MIN_BLOCKS)
    pell_cgs_fused_kernel(const PellCgsParams P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[1][GK_CG_WARPS];
  __shared__ double sh2[2][GK_CG_WARPS];
  __shared__ double bc1[1];
  __shared__ double bc2[2];

  const TV* __restrict__ values = static_cast<const TV*>(P.values);
  const TQ* __restrict__ qidx = static_cast<const TQ*>(P.qidx);
  const int n = P.n;
  const int B = gridDim.x;
  const int chunks = (n + CgsChunks::kChunk - 1) / CgsChunks::kChunk;
  double* part_sg = P.part;     // [B]     sigma = <rr, v>
  double* part_u = P.part + B;  // [2][B]  <rr, r>, r.r (and the init)
  float* __restrict__ x = P.x;
  float* __restrict__ r = P.r;
  float* __restrict__ rr = P.rr;
  float* __restrict__ q = P.q;
  float* __restrict__ u = P.u;
  float* __restrict__ v = P.v;
  float* p = P.p;
  float* w = P.w;
  float* y = P.y;
  const float* __restrict__ minv = P.minv;
  const bool jac = minv != nullptr;
  const float* gp = jac ? y : p;  // M p, which pass 2 gathers

  // init: x = x0, r = rr = r0, q = p = 0; rho = <r0, r0>
  {
    double a[1] = {0.0};
    CgsChunks::own_rows(n, [&](int i) {
      const float ri = P.r0[i];
      x[i] = P.x0[i];
      r[i] = ri;
      rr[i] = ri;
      q[i] = 0.f;
      p[i] = 0.f;
      a[0] += (double)ri * ri;
    });
    block_partial_vm<1>(a, part_u, sh1);
  }
  grid.sync();
  double tot1[1], tot2[2];
  grid_total_batch<1, 4>(part_u, 1, B, 1, tot1, sh1, bc1);
  float rho_new = (float)tot1[0];
  float rho_old = 1.f;

  const float tol_sq = *P.tol_sq;
  int it = 0;
  float mon = CUDART_INF_F;
  while (it < P.max_iters && !(mon <= tol_sq)) {
    const float beta = gk_sdiv(rho_new, rho_old);

    // pass 1: u = r + beta q; p = u + beta (q + beta p); y = M p
    CgsChunks::own_rows(n, [&](int i) {
      const float qi = q[i];
      const float ui = r[i] + beta * qi;
      u[i] = ui;
      const float pi = ui + beta * (qi + beta * p[i]);
      p[i] = pi;
      if (jac) y[i] = minv[i] * pi;
    });
    grid.sync();

    // pass 2: v = A (M p); partial sigma = <rr, v>
    {
      double a[1] = {0.0};
      for (int c = blockIdx.x; c < chunks; c += B) {
        float av[GK_PELL_CHUNK_ROWS];
        CgsChunks::spmv<TV, TQ>(values, qidx, P.bases, P.tile_ptr, P.S, P.G, n, gp, c, av);
#pragma unroll
        for (int k = 0; k < GK_PELL_CHUNK_ROWS; ++k) {
          const int i = CgsChunks::row(c, k);
          if (i < n) {
            v[i] = av[k];
            a[0] += (double)rr[i] * av[k];
          }
        }
      }
      block_partial_vm<1>(a, part_sg, sh1);
    }
    grid.sync();
    grid_total_batch<1, 4>(part_sg, 1, B, 1, tot1, sh1, bc1);
    const float alpha = gk_sdiv(rho_new, (float)tot1[0]);

    // pass 3: q = u - alpha v; w = M (u + q); x += alpha w
    CgsChunks::own_rows(n, [&](int i) {
      const float ui = u[i];
      const float qi = ui - alpha * v[i];
      q[i] = qi;
      const float wi = ui + qi;
      const float mwi = jac ? minv[i] * wi : wi;
      w[i] = mwi;
      x[i] = x[i] + alpha * mwi;
    });
    grid.sync();

    // pass 4: t = A w; r -= alpha t; partial <rr, r> (the next rho) and r.r
    {
      double a[2] = {0.0, 0.0};
      for (int c = blockIdx.x; c < chunks; c += B) {
        float at[GK_PELL_CHUNK_ROWS];
        CgsChunks::spmv<TV, TQ>(values, qidx, P.bases, P.tile_ptr, P.S, P.G, n, w, c, at);
#pragma unroll
        for (int k = 0; k < GK_PELL_CHUNK_ROWS; ++k) {
          const int i = CgsChunks::row(c, k);
          if (i < n) {
            const float ri = r[i] - alpha * at[k];
            r[i] = ri;
            a[0] += (double)rr[i] * ri;
            a[1] += (double)ri * ri;
          }
        }
      }
      block_partial_vm<2>(a, part_u, sh2);
    }
    grid.sync();
    grid_total_batch<2, 4>(part_u, 1, B, 2, tot2, sh2, bc2);
    mon = P.implicit ? fabsf(rho_new) : (float)tot2[1];
    rho_old = rho_new;
    rho_new = (float)tot2[0];
    ++it;
  }

  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *P.it_out = it;
    *P.mon_out = mon;
    *P.conv_out = (mon <= tol_sq) ? 1 : 0;
  }
}

// K20: blocks of the cooperative grid (3 doubles of partial sums a block).
extern "C" int pell_cgs_fused_grid(int v_dtype, int q_dtype, int* blocks) {
  GK_PELL_VQ_DISPATCH(v_dtype, q_dtype, gk_coop_blocks(pell_cgs_fused_kernel<TV, TQ>, blocks));
}

// K20's launch: out = {blocks of the cooperative grid, threads a block,
// blocks an SM, registers a thread}.
extern "C" int pell_cgs_fused_config(int v_dtype, int q_dtype, int* out) {
  GK_PELL_VQ_DISPATCH(v_dtype, q_dtype, gk_coop_config(pell_cgs_fused_kernel<TV, TQ>, out));
}

// K20: CGS on a square Pell (values float32/bfloat16, lane indices
// int8/int32), M = diag(minv) applied explicitly (minv nullptr: Identity;
// y, M p, is used only with minv).
extern "C" int pell_cgs_fused_solve(
    const void* values, int v_dtype, const void* qidx, int q_dtype, const int* bases,
    const int* tile_ptr, int S, int G, long long n, const float* r0, const float* x0,
    const float* minv, const float* tol_sq, int max_iters, int implicit, float* x, float* r,
    float* rr, float* q, float* u, float* v, float* p, float* w, float* y, double* part,
    int blocks, int* it_out, float* mon_out, int* conv_out, void* stream) {
  // rows are 32-bit, with room for a chunk past the last row
  if (S < 1 || G < 1 || blocks < 1 || n < 0 || n > 0x7fffffffLL - CgsChunks::kChunk ||
      (minv != nullptr && y == nullptr))
    return (int)cudaErrorInvalidValue;
  PellCgsParams P;
  P.values = values;
  P.qidx = qidx;
  P.bases = bases;
  P.tile_ptr = tile_ptr;
  P.S = S;
  P.G = G;
  P.n = (int)n;
  P.r0 = r0;
  P.x0 = x0;
  P.minv = minv;
  P.tol_sq = tol_sq;
  P.max_iters = max_iters;
  P.implicit = implicit;
  P.x = x;
  P.r = r;
  P.rr = rr;
  P.q = q;
  P.u = u;
  P.v = v;
  P.p = p;
  P.w = w;
  P.y = y;
  P.part = part;
  P.it_out = it_out;
  P.mon_out = mon_out;
  P.conv_out = conv_out;
  GK_PELL_VQ_DISPATCH(v_dtype, q_dtype,
                      gk_coop_launch(pell_cgs_fused_kernel<TV, TQ>, P, blocks, stream));
}

// K14's kernel bound to the dtypes of A and A^H as `kernel`; any other
// pair returns cudaErrorInvalidValue.
#define GK_BICG_DISPATCH(a_dtype, t_dtype, CALL)                       \
  do {                                                                 \
    if (a_dtype == GK_F32 && t_dtype == GK_F32) {                      \
      auto kernel = bicg_fused_kernel<float, float>;                   \
      return CALL;                                                     \
    }                                                                  \
    if (a_dtype == GK_F32 && t_dtype == GK_BF16) {                     \
      auto kernel = bicg_fused_kernel<float, __nv_bfloat16>;           \
      return CALL;                                                     \
    }                                                                  \
    if (a_dtype == GK_BF16 && t_dtype == GK_F32) {                     \
      auto kernel = bicg_fused_kernel<__nv_bfloat16, float>;           \
      return CALL;                                                     \
    }                                                                  \
    if (a_dtype == GK_BF16 && t_dtype == GK_BF16) {                    \
      auto kernel = bicg_fused_kernel<__nv_bfloat16, __nv_bfloat16>;   \
      return CALL;                                                     \
    }                                                                  \
    return (int)cudaErrorInvalidValue;                                 \
  } while (0)

// Blocks of K14's cooperative grid for the dtypes of A and A^H (3 doubles
// of partial sums per block).
extern "C" int bicg_fused_grid(int a_dtype, int t_dtype, int* blocks) {
  GK_BICG_DISPATCH(a_dtype, t_dtype, gk_coop_blocks(kernel, blocks));
}

// K14's launch: out = {blocks of the cooperative grid, threads a block,
// blocks an SM, registers a thread}.
extern "C" int bicg_fused_config(int a_dtype, int t_dtype, int* out) {
  GK_BICG_DISPATCH(a_dtype, t_dtype, gk_coop_config(kernel, out));
}

// K14: BiCG on A and its conjugate transpose (each float32 or bfloat16).
extern "C" int bicg_fused_solve(
    const void* diags, int a_dtype, const long long* offsets, int nd,
    const void* diags_t, int t_dtype, const long long* offsets_t, int nd_t,
    long long n, const float* r0, const float* x0, const float* minv,
    const float* tol_sq, int max_iters, int implicit, float* x, float* r,
    float* r2, float* q, float* q2, float* p, float* p2, double* part, int blocks,
    int* it_out, float* mon_out, int* conv_out, void* stream) {
  if (nd < 1 || nd > GK_MAX_DIAGS || nd_t < 1 || nd_t > GK_MAX_DIAGS || blocks < 1)
    return (int)cudaErrorInvalidValue;
  BicgParams P;
  P.diags = diags;
  P.diags_t = diags_t;
  copy_offsets(P.offs, offsets, nd);
  copy_offsets(P.offs_t, offsets_t, nd_t);
  P.n = n;
  P.r0 = r0;
  P.x0 = x0;
  P.minv = minv;
  P.tol_sq = tol_sq;
  P.max_iters = max_iters;
  P.implicit = implicit;
  P.x = x;
  P.r = r;
  P.r2 = r2;
  P.q = q;
  P.q2 = q2;
  P.p = p;
  P.p2 = p2;
  P.part = part;
  P.it_out = it_out;
  P.mon_out = mon_out;
  P.conv_out = conv_out;
  GK_BICG_DISPATCH(a_dtype, t_dtype, gk_coop_launch(kernel, P, blocks, stream));
}
