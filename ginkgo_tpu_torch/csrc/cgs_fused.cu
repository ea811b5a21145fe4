// Whole-solve CGS and BiCG in persistent cooperative kernels: kernels K13
// (cgs_fused) and K14 (bicg_fused) of the PyTorch port, and K20
// (pell_cgs_fused), K13's loop on a Pell.
//
// Replaces ginkgo_tpu/ops/pallas_cgs.py cgs_vmem_solve (_cgs_kernel,
// :61-178) and bicg_vmem_solve (_bicg_kernel, :266-390), and
// ginkgo_tpu/ops/pallas_pell_cg.py pell_cgs_vmem_solve (_pell_cgs_kernel,
// :559).  The CGS kernel is templated on its operator (coop.cuh GkDiaOp,
// pell.cuh GkPellOp).  On a Pell, M is applied explicitly on the
// operator's gather (v = A (M p), t = A (M w)), as the TPU kernel stages
// it (PELL values have no column fold); the x update x += alpha (M w) is
// K13's.
//
// CGS is transpose-free.  As in K12 a diagonal preconditioner is folded
// into the operator before the launch (solver/_fused_gate.fold_minv), and
// minv is applied only in the x update, x += alpha minv (u + q).  Four
// passes per iteration, two of them products with A M.
//
// BiCG carries A's diagonals and those of its conjugate transpose (offsets
// negated, its own range of columns) and runs both products in one pass.
// A real diagonal M is its own M^H, so z = M r and z2 = M r2 are one
// multiply each, recomputed where they are needed.  Three passes per
// iteration.
//
// What bounds them on the H100: bytes.  Per iteration CGS moves
// (2 nd sizeof(TD) + 68) n bytes (72 n with minv): u, p from r, q, p; v =
// (A M) p with <rr, v>; q = u - alpha v and w = u + q; t = (A M) w with the
// x and r updates and <rr, r>, r.r.  BiCG moves ((nd + nd_t) sizeof(TD) +
// 64) n (76 n with minv): p, p2 from r, r2; q = A p and q2 = A^H p2 with
// <p2, q>; x, r, r2 from p, q, q2 with <r2, M r> and r.r.
//
// What the design does about it: K4's and K12's.  The vectors that the
// products read across rows (p and w; p and p2) are loaded with __ldcg;
// dot products are float64 per-block partials that every block sums in
// one fixed order; consecutive reductions with no barrier between them
// write different partial buffers.
//
// Semantics kept from the TPU kernels: shadow residual rr = r0 (BiCG: r2 =
// r0), the first rho = <rr, r0> (BiCG: <r0, M r0>), p = q = 0 (BiCG: p =
// p2 = 0), rho_old starts at 1; the loop runs while it < max_iters &&
// !(mon <= tol_sq), so a NaN monitor keeps iterating; exact mode monitors
// r.r after the update, implicit mode |rho| from before it; zero
// denominators give 0.

#include "coop.cuh"
#include "pell.cuh"

namespace cg = cooperative_groups;

template <typename Op>
struct CgsParams {
  Op op;  // A M (Dia, folded), or A with M applied on the gather (Pell)
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
  float* w;
  double* part;  // 3 * gridDim.x per-block partial sums
  int* it_out;
  float* mon_out;
  int* conv_out;
};

template <typename Op>
__global__ void __launch_bounds__(GK_CG_THREADS) cgs_fused_kernel(const CgsParams<Op> P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[1][GK_CG_WARPS];
  __shared__ double sh2[2][GK_CG_WARPS];
  __shared__ double bc1[1];
  __shared__ double bc2[2];

  const long long n = P.n;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int G = gridDim.x;
  double* part_sg = P.part;      // [G]     sigma = <rr, v>
  double* part_u = P.part + G;   // [G][2]  <rr, r>, r.r (and the init)
  float* __restrict__ x = P.x;
  float* __restrict__ r = P.r;
  float* __restrict__ rr = P.rr;
  float* __restrict__ q = P.q;
  float* __restrict__ u = P.u;
  float* __restrict__ v = P.v;
  float* p = P.p;
  float* w = P.w;
  const float* __restrict__ minv = P.minv;

  // init: x = x0, r = rr = r0, q = p = 0; rho = <r0, r0>
  {
    double acc[2] = {0.0, 0.0};
    for (long long i = t0; i < n; i += stride) {
      const float ri = P.r0[i];
      x[i] = P.x0[i];
      r[i] = ri;
      rr[i] = ri;
      q[i] = 0.f;
      p[i] = 0.f;
      acc[0] += (double)ri * ri;
    }
    block_partial<2>(acc, part_u, sh2);
  }
  grid.sync();
  double tot1[1], tot2[2];
  grid_total<2>(part_u, tot2, sh2, bc2);
  float rho_new = (float)tot2[0];
  float rho_old = 1.f;

  const float tol_sq = *P.tol_sq;
  int it = 0;
  float mon = CUDART_INF_F;
  while (it < P.max_iters && !(mon <= tol_sq)) {
    const float beta = gk_sdiv(rho_new, rho_old);

    // pass 1: u = r + beta q; p = u + beta (q + beta p)
    for (long long i = t0; i < n; i += stride) {
      const float qi = q[i];
      const float ui = r[i] + beta * qi;
      u[i] = ui;
      p[i] = ui + beta * (qi + beta * __ldcg(p + i));
    }
    grid.sync();

    // pass 2: v = (A M) p; partial sigma = <rr, v>
    {
      double acc[1] = {0.0};
      for (long long i = t0; i < n; i += stride) {
        const float vi = P.op.row(i, p);
        v[i] = vi;
        acc[0] += (double)rr[i] * vi;
      }
      block_partial<1>(acc, part_sg, sh1);
    }
    grid.sync();
    grid_total<1>(part_sg, tot1, sh1, bc1);
    const float alpha = gk_sdiv(rho_new, (float)tot1[0]);

    // pass 3: q = u - alpha v; w = u + q
    for (long long i = t0; i < n; i += stride) {
      const float ui = u[i];
      const float qi = ui - alpha * v[i];
      q[i] = qi;
      w[i] = ui + qi;
    }
    grid.sync();

    // pass 4: t = (A M) w; x += alpha (M w); r -= alpha t; partial <rr, r>
    // (the next rho) and r.r
    {
      double acc[2] = {0.0, 0.0};
      for (long long i = t0; i < n; i += stride) {
        const float ti = P.op.row(i, w);
        const float wi = __ldcg(w + i);
        const float mwi = minv ? minv[i] * wi : wi;
        x[i] = x[i] + alpha * mwi;
        const float ri = r[i] - alpha * ti;
        r[i] = ri;
        acc[0] += (double)rr[i] * ri;
        acc[1] += (double)ri * ri;
      }
      block_partial<2>(acc, part_u, sh2);
    }
    grid.sync();
    grid_total<2>(part_u, tot2, sh2, bc2);
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
__global__ void __launch_bounds__(GK_CG_THREADS) bicg_fused_kernel(const BicgParams P) {
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
  double* part_pq = P.part;      // [G]     <p2, q>
  double* part_u = P.part + G;   // [G][2]  <r2, M r>, r.r (and the init)
  float* __restrict__ x = P.x;
  float* __restrict__ r = P.r;
  float* __restrict__ r2 = P.r2;
  float* __restrict__ q = P.q;
  float* __restrict__ q2 = P.q2;
  float* p = P.p;
  float* p2 = P.p2;
  const float* __restrict__ minv = P.minv;

  // init: x = x0, r = r2 = r0, p = p2 = 0; rho = <r0, M r0>
  {
    double acc[2] = {0.0, 0.0};
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
    block_partial<2>(acc, part_u, sh2);
  }
  grid.sync();
  double tot1[1], tot2[2];
  grid_total<2>(part_u, tot2, sh2, bc2);
  float rho_new = (float)tot2[0];
  float rho_old = 1.f;

  const float tol_sq = *P.tol_sq;
  int it = 0;
  float mon = CUDART_INF_F;
  while (it < P.max_iters && !(mon <= tol_sq)) {
    const float beta = gk_sdiv(rho_new, rho_old);

    // pass 1: p = M r + beta p; p2 = M r2 + beta p2
    for (long long i = t0; i < n; i += stride) {
      const float ri = r[i];
      const float r2i = r2[i];
      const float zi = minv ? minv[i] * ri : ri;
      const float z2i = minv ? minv[i] * r2i : r2i;
      p[i] = zi + beta * __ldcg(p + i);
      p2[i] = z2i + beta * __ldcg(p2 + i);
    }
    grid.sync();

    // pass 2: q = A p, q2 = A^H p2; partial <p2, q>
    {
      double acc[1] = {0.0};
      for (long long i = t0; i < n; i += stride) {
        const float qi = gk_dia_row(D, P.offs, n, i, p);
        q[i] = qi;
        q2[i] = gk_dia_row(Dt, P.offs_t, n, i, p2);
        acc[0] += (double)__ldcg(p2 + i) * qi;
      }
      block_partial<1>(acc, part_pq, sh1);
    }
    grid.sync();
    grid_total<1>(part_pq, tot1, sh1, bc1);
    const float alpha = gk_sdiv(rho_new, (float)tot1[0]);

    // pass 3: x += alpha p; r -= alpha q; r2 -= alpha q2; partial
    // <r2, M r> (the next rho) and r.r
    {
      double acc[2] = {0.0, 0.0};
      for (long long i = t0; i < n; i += stride) {
        x[i] = x[i] + alpha * __ldcg(p + i);
        const float ri = r[i] - alpha * q[i];
        r[i] = ri;
        const float r2i = r2[i] - alpha * q2[i];
        r2[i] = r2i;
        const float zi = minv ? minv[i] * ri : ri;
        acc[0] += (double)r2i * zi;
        acc[1] += (double)ri * ri;
      }
      block_partial<2>(acc, part_u, sh2);
    }
    grid.sync();
    grid_total<2>(part_u, tot2, sh2, bc2);
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

static void copy_offsets(GkOffsets& dst, const long long* offsets, int nd) {
  dst.nd = nd;
  for (int d = 0; d < nd; ++d) dst.off[d] = offsets[d];
}

template <typename Op>
static CgsParams<Op> cgs_params(const Op& op, long long n, const float* r0, const float* x0,
                                const float* minv, const float* tol_sq, int max_iters,
                                int implicit, float* x, float* r, float* rr, float* q,
                                float* u, float* v, float* p, float* w, double* part,
                                int* it_out, float* mon_out, int* conv_out) {
  CgsParams<Op> P;
  P.op = op;
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
  P.w = w;
  P.part = part;
  P.it_out = it_out;
  P.mon_out = mon_out;
  P.conv_out = conv_out;
  return P;
}

// Blocks of K13's cooperative grid (3 doubles of partial sums per block).
extern "C" int cgs_fused_grid(int d_dtype, int* blocks) {
  if (d_dtype == GK_F32) return gk_coop_blocks(cgs_fused_kernel<GkDiaOp<float>>, blocks);
  if (d_dtype == GK_BF16)
    return gk_coop_blocks(cgs_fused_kernel<GkDiaOp<__nv_bfloat16>>, blocks);
  return (int)cudaErrorInvalidValue;
}

extern "C" int cgs_fused_solve(
    const void* diags, int d_dtype, const long long* offsets, int nd, long long n,
    const float* r0, const float* x0, const float* minv, const float* tol_sq,
    int max_iters, int implicit, float* x, float* r, float* rr, float* q, float* u,
    float* v, float* p, float* w, double* part, int blocks, int* it_out,
    float* mon_out, int* conv_out, void* stream) {
  if (nd < 1 || nd > GK_MAX_DIAGS || blocks < 1) return (int)cudaErrorInvalidValue;
#define GK_DIA_LAUNCH(TD)                                                                   \
  gk_coop_launch(cgs_fused_kernel<GkDiaOp<TD>>,                                             \
                 cgs_params(gk_dia_op<TD>(diags, offsets, nd, n), n, r0, x0, minv, tol_sq,  \
                            max_iters, implicit, x, r, rr, q, u, v, p, w, part, it_out,     \
                            mon_out, conv_out),                                             \
                 blocks, stream)
  if (d_dtype == GK_F32) return GK_DIA_LAUNCH(float);
  if (d_dtype == GK_BF16) return GK_DIA_LAUNCH(__nv_bfloat16);
#undef GK_DIA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// K20: blocks of the Pell form's cooperative grid (3 doubles of partial
// sums per block, as K13).
extern "C" int pell_cgs_fused_grid(int v_dtype, int q_dtype, int* blocks) {
  GK_PELL_VQ_DISPATCH(v_dtype, q_dtype,
                      gk_coop_blocks(cgs_fused_kernel<GkPellOp<TV, TQ>>, blocks));
}

template <typename TV, typename TQ>
static int pell_cgs_launch(const void* values, const void* qidx, const int* bases,
                           const int* tile_ptr, int S, int G, long long n, const float* r0,
                           const float* x0, const float* minv, const float* tol_sq,
                           int max_iters, int implicit, float* x, float* r, float* rr,
                           float* q, float* u, float* v, float* p, float* w, double* part,
                           int blocks, int* it_out, float* mon_out, int* conv_out,
                           void* stream) {
  return gk_coop_launch(
      cgs_fused_kernel<GkPellOp<TV, TQ>>,
      cgs_params(gk_pell_op<TV, TQ>(values, qidx, bases, tile_ptr, S, G, n, minv), n, r0, x0,
                 minv, tol_sq, max_iters, implicit, x, r, rr, q, u, v, p, w, part, it_out,
                 mon_out, conv_out),
      blocks, stream);
}

// K20: CGS on a square Pell (values float32/bfloat16, lane indices
// int8/int32), M = diag(minv) applied explicitly (minv nullptr: Identity).
extern "C" int pell_cgs_fused_solve(
    const void* values, int v_dtype, const void* qidx, int q_dtype, const int* bases,
    const int* tile_ptr, int S, int G, long long n, const float* r0, const float* x0,
    const float* minv, const float* tol_sq, int max_iters, int implicit, float* x, float* r,
    float* rr, float* q, float* u, float* v, float* p, float* w, double* part, int blocks,
    int* it_out, float* mon_out, int* conv_out, void* stream) {
  if (S < 1 || G < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  GK_PELL_VQ_DISPATCH(v_dtype, q_dtype,
                      (pell_cgs_launch<TV, TQ>)(
                          values, qidx, bases, tile_ptr, S, G, n, r0, x0, minv, tol_sq,
                          max_iters, implicit, x, r, rr, q, u, v, p, w, part, blocks, it_out,
                          mon_out, conv_out, stream));
}

// Blocks of K14's cooperative grid for the dtypes of A and A^H (3 doubles
// of partial sums per block).
extern "C" int bicg_fused_grid(int a_dtype, int t_dtype, int* blocks) {
  if (a_dtype == GK_F32 && t_dtype == GK_F32)
    return gk_coop_blocks(bicg_fused_kernel<float, float>, blocks);
  if (a_dtype == GK_F32 && t_dtype == GK_BF16)
    return gk_coop_blocks(bicg_fused_kernel<float, __nv_bfloat16>, blocks);
  if (a_dtype == GK_BF16 && t_dtype == GK_F32)
    return gk_coop_blocks(bicg_fused_kernel<__nv_bfloat16, float>, blocks);
  if (a_dtype == GK_BF16 && t_dtype == GK_BF16)
    return gk_coop_blocks(bicg_fused_kernel<__nv_bfloat16, __nv_bfloat16>, blocks);
  return (int)cudaErrorInvalidValue;
}

extern "C" int bicg_fused_solve(
    const void* diags, int a_dtype, const long long* offsets, int nd,
    const void* diags_t, int t_dtype, const long long* offsets_t, int nd_t,
    long long n, const float* r0, const float* x0, const float* minv,
    const float* tol_sq, int max_iters, int implicit, float* x, float* r,
    float* r2, float* q, float* q2, float* p, float* p2, double* part,
    int blocks, int* it_out, float* mon_out, int* conv_out, void* stream) {
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
  if (a_dtype == GK_F32 && t_dtype == GK_F32)
    return gk_coop_launch(bicg_fused_kernel<float, float>, P, blocks, stream);
  if (a_dtype == GK_F32 && t_dtype == GK_BF16)
    return gk_coop_launch(bicg_fused_kernel<float, __nv_bfloat16>, P, blocks, stream);
  if (a_dtype == GK_BF16 && t_dtype == GK_F32)
    return gk_coop_launch(bicg_fused_kernel<__nv_bfloat16, float>, P, blocks, stream);
  if (a_dtype == GK_BF16 && t_dtype == GK_BF16)
    return gk_coop_launch(bicg_fused_kernel<__nv_bfloat16, __nv_bfloat16>, P, blocks,
                          stream);
  return (int)cudaErrorInvalidValue;
}
