// Sweep triangular solves and ILU-preconditioned whole solves in persistent
// cooperative kernels: kernels K22 (trs_fused), K23 (cg_ilu_fused) and K24
// (bicgstab_ilu_fused) of the PyTorch port, which share one device routine,
// gk_tri_sweeps.
//
// Replaces:
//   - K22: ginkgo_tpu/ops/pallas_trs.py trs_vmem_solve (_trs_kernel, :47):
//     x ~ T^{-1} b by Jacobi-Richardson sweeps, x0 = D^{-1} b,
//     x_{m+1} = D^{-1} (b - N x_m), N the strict triangle as a Dia;
//   - K23: ginkgo_tpu/ops/pallas_cg_ilu.py cg_ilu_vmem_solve
//     (_cg_ilu_kernel, :96): the whole CG with M = U^{-1} L^{-1} applied
//     in the kernel as two such sweep solves;
//   - K24: ginkgo_tpu/ops/pallas_cg_ilu.py bicgstab_ilu_vmem_solve
//     (_bicgstab_ilu_kernel, :321): the whole right-preconditioned
//     BiCGSTAB with the same M.
//
// What bounds them on the H100: bytes.  A sweep reads the triangle's
// diagonals, its source iterate, rhs and the inverse diagonal and writes
// the new iterate: (nd sizeof(TT) + 16) n bytes.  One M apply is
// (1 + sweeps_l) + (1 + sweeps_u) such passes; a CG iteration adds A p and
// the vector work (K4's), a BiCGSTAB iteration two M applies, two products
// with A and its vector work (K12's).
//
// What the design does about it: K4's (cg_fused.cu).  The grid is what the
// SMs hold at once, launched cooperatively, and every pass is a loop over
// the rows with each row owned by one thread in every pass.  The TPU
// kernel keeps the iterate in VMEM and stages the previous one (w_s) so
// that a sweep reads only the old iterate: a Jacobi sweep, not
// Gauss-Seidel (an in-place update would converge faster and give other
// numbers).  Here two device buffers ping-pong, with a grid barrier before
// each sweep: the sweep reads the previous iterate across rows (through
// coop.cuh's gk_dia_row, __ldcg, in the plain versions' row-sum order) and
// the next sweep writes the buffer this one read.  The buffer a solve
// starts in is picked by the parity of the sweep count, so the result
// always lands in `out`.  Rows outside [0, n) read 0.  The dot products
// follow coop.cuh: float64 per-block partials that every block sums in one
// fixed order, so every block takes the same branch of the stop test,
// written as !(mon <= tol_sq) so that a NaN keeps iterating.
//
// The solves multiply by the inverse diagonal (1 / diag rounded to float32,
// the TPU kernels' invd frames), where the streaming TriangularSolver
// divides by the diagonal: the two differ by ulps.  Triangles may be
// float32 or bfloat16 (both of one dtype, widened on read), the operator
// A independently; all arithmetic is float32.

#include "coop.cuh"

namespace cg = cooperative_groups;

// out ~ T^{-1} rhs over this thread's rows: out = invd * rhs, then `sweeps`
// Jacobi-Richardson sweeps out <- invd * (rhs - N out), ping-ponging between
// out and tmp (neither may be rhs).  Call after a barrier that orders every
// earlier cross-row read of out and tmp; rhs is read on this thread's rows
// only.  On return the result is in out, written by this thread's rows: a
// cross-row read of it needs a barrier first.
template <typename Op>
__device__ __forceinline__ void gk_tri_sweeps(cg::grid_group& grid, const Op& N, long long n,
                                              const float* invd, const float* rhs,
                                              float* out, float* tmp, int sweeps) {
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  float* cur = (sweeps & 1) ? tmp : out;
  for (long long i = t0; i < n; i += stride) cur[i] = rhs[i] * invd[i];
  for (int s = 0; s < sweeps; ++s) {
    float* nxt = (cur == out) ? tmp : out;
    grid.sync();
    for (long long i = t0; i < n; i += stride) nxt[i] = (rhs[i] - N.row(i, cur)) * invd[i];
    cur = nxt;
  }
}

// ---------------------------------------------------------------------------
// K22: one triangular solve.

template <typename TT>
struct TrsParams {
  GkDiaOp<TT> t;  // the strict triangle
  long long n;
  const float* invd;
  const float* b;
  int sweeps;
  float* x;
  float* tmp;
};

template <typename TT>
__global__ void __launch_bounds__(GK_CG_THREADS) trs_fused_kernel(const TrsParams<TT> P) {
  cg::grid_group grid = cg::this_grid();
  gk_tri_sweeps(grid, P.t, P.n, P.invd, P.b, P.x, P.tmp, P.sweeps);
}

// ---------------------------------------------------------------------------
// The ILU preconditioner of K23 and K24: the lower and upper strict
// triangles and their inverse diagonals, and the sweep counts (0: x =
// invd * rhs only).

template <typename TT>
struct GkIlu {
  GkDiaOp<TT> l;
  GkDiaOp<TT> u;
  const float* invdl;
  const float* invdu;
  int sweeps_l;
  int sweeps_u;
};

// out = U^{-1} L^{-1} src: the L solve into mid (scratch tl), the U solve
// from mid into out (scratch tu).  The two scratch buffers differ, so the U
// solve never writes a buffer the L solve's last sweep may still be
// reading on another block.  Barrier rules as gk_tri_sweeps.
template <typename TT>
__device__ __forceinline__ void gk_ilu_apply(cg::grid_group& grid, const GkIlu<TT>& M,
                                             long long n, const float* src, float* mid,
                                             float* out, float* tl, float* tu) {
  gk_tri_sweeps(grid, M.l, n, M.invdl, src, mid, tl, M.sweeps_l);
  gk_tri_sweeps(grid, M.u, n, M.invdu, mid, out, tu, M.sweeps_u);
}

// ---------------------------------------------------------------------------
// K23: ILU-preconditioned CG.
//
// Semantics kept from _cg_ilu_kernel (:143-216): z = M r0, p = z,
// rho = r.z; the monitor starts at +inf, so at least one iteration runs;
// per iteration q = A p, alpha = rho / p.q, x += alpha p, r -= alpha q,
// z = M r (q doubles as the L solve's result), rho_new = r.z,
// beta = rho_new / rho, p = z + beta p; the monitor is r.r after the
// update, or in implicit mode |rho| of the rho entering the iteration.
// Zero denominators give 0.  Barriers an iteration: 3 + sweeps_l + sweeps_u.

template <typename TA, typename TT>
struct CgIluParams {
  GkDiaOp<TA> a;
  GkIlu<TT> m;
  long long n;
  const float* r0;
  const float* x0;
  const float* tol_sq;
  int max_iters;
  int implicit;
  float* x;
  float* r;
  float* p;  // read across rows by A p
  float* q;
  float* z;
  float* w1;  // the L solve's scratch
  float* w2;  // the U solve's scratch
  double* part;  // 3 * gridDim.x per-block partial sums
  int* it_out;
  float* mon_out;
  int* conv_out;
};

template <typename TA, typename TT>
__global__ void __launch_bounds__(GK_CG_THREADS) cg_ilu_fused_kernel(const CgIluParams<TA, TT> P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[1][GK_CG_WARPS];
  __shared__ double sh2[2][GK_CG_WARPS];
  __shared__ double bc1[1];
  __shared__ double bc2[2];
  const long long n = P.n;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  double* part1 = P.part;              // [gridDim.x]     p.q
  double* part2 = P.part + gridDim.x;  // [gridDim.x][2]  r.z, r.r

  for (long long i = t0; i < n; i += stride) {
    P.x[i] = P.x0[i];
    P.r[i] = P.r0[i];
  }
  gk_ilu_apply(grid, P.m, n, P.r, P.q, P.z, P.w1, P.w2);
  double tot2[2];
  {
    double s[2] = {0.0, 0.0};
    for (long long i = t0; i < n; i += stride) {
      const float ri = P.r[i];
      const float zi = P.z[i];
      P.p[i] = zi;
      s[0] += (double)ri * zi;
      s[1] += (double)ri * ri;
    }
    block_partial<2>(s, part2, sh2);
  }
  grid.sync();
  grid_total<2>(part2, tot2, sh2, bc2);
  float rho = (float)tot2[0];

  const float tol_sq = *P.tol_sq;
  int it = 0;
  float mon = CUDART_INF_F;
  while (it < P.max_iters && !(mon <= tol_sq)) {
    // pass 1: q = A p, partial p.q
    {
      double s[1] = {0.0};
      for (long long i = t0; i < n; i += stride) {
        const float qi = P.a.row(i, P.p);
        P.q[i] = qi;
        s[0] += (double)__ldcg(P.p + i) * qi;
      }
      block_partial<1>(s, part1, sh1);
    }
    grid.sync();
    double tot1[1];
    grid_total<1>(part1, tot1, sh1, bc1);
    const float alpha = gk_sdiv(rho, (float)tot1[0]);

    // pass 2: x += alpha p, r -= alpha q; this thread's part of r.r waits
    // for the next reduction
    double rr = 0.0;
    for (long long i = t0; i < n; i += stride) {
      P.x[i] = P.x[i] + alpha * __ldcg(P.p + i);
      const float ri = P.r[i] - alpha * P.q[i];
      P.r[i] = ri;
      rr += (double)ri * ri;
    }
    // z = M r, the L solve's result in q
    gk_ilu_apply(grid, P.m, n, P.r, P.q, P.z, P.w1, P.w2);
    {
      double s[2] = {0.0, rr};
      for (long long i = t0; i < n; i += stride) s[0] += (double)P.r[i] * P.z[i];
      block_partial<2>(s, part2, sh2);
    }
    grid.sync();
    grid_total<2>(part2, tot2, sh2, bc2);
    const float rho_new = (float)tot2[0];
    const float beta = gk_sdiv(rho_new, rho);

    // pass 3: p = z + beta p
    for (long long i = t0; i < n; i += stride) P.p[i] = P.z[i] + beta * __ldcg(P.p + i);
    mon = P.implicit ? fabsf(rho) : (float)tot2[1];
    rho = rho_new;
    ++it;
    grid.sync();
  }

  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *P.it_out = it;
    *P.mon_out = mon;
    *P.conv_out = (mon <= tol_sq) ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// K24: right-preconditioned BiCGSTAB with the ILU preconditioner.
//
// Semantics kept from _bicgstab_ilu_kernel (:383-469): shadow rr = r0,
// rho = r0.r0, p = v = 0, and the carried rho_old, alpha and omega start at
// 1; per iteration beta = (rho alpha) / (rho_old omega), p = r + beta (p -
// omega v), y = M p, v = A y, alpha = rho / rr.v, x += alpha y,
// s = r - alpha v, the half-step check on s.s (|rho| in implicit mode),
// z = M s, t = A z, omega = t.s / t.t (0 when the half step converged, and
// carried as 1), x += omega z, r = s - omega t, rho = rr.r.  Zero
// denominators give 0 (_sdiv).  y and z share one buffer.  Barriers an
// iteration: 5 + 2 (sweeps_l + sweeps_u).

template <typename TA, typename TT>
struct BicgstabIluParams {
  GkDiaOp<TA> a;
  GkIlu<TT> m;
  long long n;
  const float* r0;
  const float* x0;
  const float* tol_sq;
  int max_iters;
  int implicit;
  float* x;
  float* r;
  float* rr;
  float* p;
  float* v;
  float* s;
  float* t;
  float* y;  // M p, then M s; read across rows by A y
  float* mid;  // the L solve's result
  float* w1;
  float* w2;
  double* part;  // 7 * gridDim.x per-block partial sums
  int* it_out;
  float* mon_out;
  int* conv_out;
};

template <typename TA, typename TT>
__global__ void __launch_bounds__(GK_CG_THREADS)
    bicgstab_ilu_fused_kernel(const BicgstabIluParams<TA, TT> P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[1][GK_CG_WARPS];
  __shared__ double sh2[2][GK_CG_WARPS];
  __shared__ double sh3[3][GK_CG_WARPS];
  __shared__ double bc1[1];
  __shared__ double bc2[2];
  __shared__ double bc3[3];
  const long long n = P.n;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  double* part_a = P.part;                  // [gridDim.x]     r0.r0
  double* part_b = P.part + gridDim.x;      // [gridDim.x]     rr.v
  double* part_c = P.part + 2 * gridDim.x;  // [gridDim.x][3]  s.s, t.s, t.t
  double* part_d = P.part + 5 * gridDim.x;  // [gridDim.x][2]  rr.r, r.r

  double tot1[1], tot2[2], tot3[3];
  {
    double s[1] = {0.0};
    for (long long i = t0; i < n; i += stride) {
      const float ri = P.r0[i];
      P.x[i] = P.x0[i];
      P.r[i] = ri;
      P.rr[i] = ri;
      P.v[i] = 0.f;
      P.p[i] = 0.f;
      s[0] += (double)ri * ri;
    }
    block_partial<1>(s, part_a, sh1);
  }
  grid.sync();
  grid_total<1>(part_a, tot1, sh1, bc1);
  float rho_new = (float)tot1[0];
  float rho_old = 1.f, alpha = 1.f, omega = 1.f;

  const float tol_sq = *P.tol_sq;
  int it = 0;
  float mon = CUDART_INF_F;
  while (it < P.max_iters && !(mon <= tol_sq)) {
    const float beta = gk_sdiv(rho_new * alpha, rho_old * omega);
    for (long long i = t0; i < n; i += stride)
      P.p[i] = P.r[i] + beta * (P.p[i] - omega * P.v[i]);
    // y = M p; v = A y, partial rr.v
    gk_ilu_apply(grid, P.m, n, P.p, P.mid, P.y, P.w1, P.w2);
    grid.sync();
    {
      double s[1] = {0.0};
      for (long long i = t0; i < n; i += stride) {
        const float vi = P.a.row(i, P.y);
        P.v[i] = vi;
        s[0] += (double)P.rr[i] * vi;
      }
      block_partial<1>(s, part_b, sh1);
    }
    grid.sync();
    grid_total<1>(part_b, tot1, sh1, bc1);
    const float alpha_new = gk_sdiv(rho_new, (float)tot1[0]);

    // x += alpha y; s = r - alpha v; this thread's part of s.s waits for
    // the next reduction
    double ss = 0.0;
    for (long long i = t0; i < n; i += stride) {
      P.x[i] = P.x[i] + alpha_new * __ldcg(P.y + i);
      const float si = P.r[i] - alpha_new * P.v[i];
      P.s[i] = si;
      ss += (double)si * si;
    }
    // z = M s (into y); t = A z, partials s.s, t.s, t.t
    gk_ilu_apply(grid, P.m, n, P.s, P.mid, P.y, P.w1, P.w2);
    grid.sync();
    {
      double s[3] = {ss, 0.0, 0.0};
      for (long long i = t0; i < n; i += stride) {
        const float ti = P.a.row(i, P.y);
        const float si = P.s[i];
        P.t[i] = ti;
        s[1] += (double)ti * si;
        s[2] += (double)ti * ti;
      }
      block_partial<3>(s, part_c, sh3);
    }
    grid.sync();
    grid_total<3>(part_c, tot3, sh3, bc3);
    const bool half_done = (P.implicit ? fabsf(rho_new) : (float)tot3[0]) <= tol_sq;
    const float omega_new = half_done ? 0.f : gk_sdiv((float)tot3[1], (float)tot3[2]);

    // x += omega z; r = s - omega t; partials rr.r, r.r
    {
      double s[2] = {0.0, 0.0};
      for (long long i = t0; i < n; i += stride) {
        P.x[i] = P.x[i] + omega_new * __ldcg(P.y + i);
        const float ri = P.s[i] - omega_new * P.t[i];
        P.r[i] = ri;
        s[0] += (double)P.rr[i] * ri;
        s[1] += (double)ri * ri;
      }
      block_partial<2>(s, part_d, sh2);
    }
    grid.sync();
    grid_total<2>(part_d, tot2, sh2, bc2);
    mon = P.implicit ? fabsf(rho_new) : (float)tot2[1];
    rho_old = rho_new;
    alpha = alpha_new;
    omega = half_done ? 1.f : omega_new;
    rho_new = (float)tot2[0];
    ++it;
  }

  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *P.it_out = it;
    *P.mon_out = mon;
    *P.conv_out = (mon <= tol_sq) ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// C entry points.  Dtype codes (common.cuh GkDtype): the triangles' t_dtype
// and A's a_dtype are each GK_F32 or GK_BF16.

#define GK_T_DISPATCH(t_dtype, CALL)                           \
  do {                                                         \
    if ((t_dtype) == GK_F32) { using TT = float; return CALL; } \
    if ((t_dtype) == GK_BF16) {                                \
      using TT = __nv_bfloat16;                                \
      return CALL;                                             \
    }                                                          \
    return (int)cudaErrorInvalidValue;                         \
  } while (0)

#define GK_AT_DISPATCH(a_dtype, t_dtype, CALL)                       \
  do {                                                               \
    if ((a_dtype) == GK_F32) {                                       \
      using TA = float;                                              \
      GK_T_DISPATCH(t_dtype, CALL);                                  \
    }                                                                \
    if ((a_dtype) == GK_BF16) {                                      \
      using TA = __nv_bfloat16;                                      \
      GK_T_DISPATCH(t_dtype, CALL);                                  \
    }                                                                \
    return (int)cudaErrorInvalidValue;                               \
  } while (0)

static bool gk_nd_ok(int nd) { return nd >= 1 && nd <= GK_MAX_DIAGS; }

template <typename TT>
static GkIlu<TT> gk_ilu(const void* l_diags, const long long* l_offsets, int l_nd,
                        const void* u_diags, const long long* u_offsets, int u_nd, long long n,
                        const float* invdl, const float* invdu, int sweeps_l, int sweeps_u) {
  GkIlu<TT> m;
  m.l = gk_dia_op<TT>(l_diags, l_offsets, l_nd, n);
  m.u = gk_dia_op<TT>(u_diags, u_offsets, u_nd, n);
  m.invdl = invdl;
  m.invdu = invdu;
  m.sweeps_l = sweeps_l;
  m.sweeps_u = sweeps_u;
  return m;
}

// K22: blocks of the cooperative grid.
extern "C" int trs_fused_grid(int t_dtype, int* blocks) {
  GK_T_DISPATCH(t_dtype, gk_coop_blocks(trs_fused_kernel<TT>, blocks));
}

template <typename TT>
static int trs_launch(const void* diags, const long long* offsets, int nd, long long n,
                      const float* invd, const float* b, int sweeps, float* x, float* tmp,
                      int blocks, void* stream) {
  TrsParams<TT> P;
  P.t = gk_dia_op<TT>(diags, offsets, nd, n);
  P.n = n;
  P.invd = invd;
  P.b = b;
  P.sweeps = sweeps;
  P.x = x;
  P.tmp = tmp;
  return gk_coop_launch(trs_fused_kernel<TT>, P, blocks, stream);
}

// K22: x ~ T^{-1} b by `sweeps` sweeps over the strict triangle (nd, n).
extern "C" int trs_fused_solve(const void* diags, int t_dtype, const long long* offsets, int nd,
                               long long n, const float* invd, const float* b, int sweeps,
                               float* x, float* tmp, int blocks, void* stream) {
  if (!gk_nd_ok(nd) || sweeps < 0 || blocks < 1) return (int)cudaErrorInvalidValue;
  GK_T_DISPATCH(t_dtype, (trs_launch<TT>)(diags, offsets, nd, n, invd, b, sweeps, x, tmp,
                                          blocks, stream));
}

// K23: blocks of the cooperative grid (3 doubles of partial sums a block).
extern "C" int cg_ilu_fused_grid(int a_dtype, int t_dtype, int* blocks) {
  GK_AT_DISPATCH(a_dtype, t_dtype, (gk_coop_blocks(cg_ilu_fused_kernel<TA, TT>, blocks)));
}

template <typename TA, typename TT>
static int cg_ilu_launch(const void* a_diags, const long long* a_offsets, int a_nd,
                         const void* l_diags, const long long* l_offsets, int l_nd,
                         const void* u_diags, const long long* u_offsets, int u_nd,
                         long long n, const float* invdl, const float* invdu, const float* r0,
                         const float* x0, const float* tol_sq, int max_iters, int sweeps_l,
                         int sweeps_u, int implicit, float* x, float* r, float* p, float* q,
                         float* z, float* w1, float* w2, double* part, int blocks,
                         int* it_out, float* mon_out, int* conv_out, void* stream) {
  CgIluParams<TA, TT> P;
  P.a = gk_dia_op<TA>(a_diags, a_offsets, a_nd, n);
  P.m = gk_ilu<TT>(l_diags, l_offsets, l_nd, u_diags, u_offsets, u_nd, n, invdl, invdu,
                   sweeps_l, sweeps_u);
  P.n = n;
  P.r0 = r0;
  P.x0 = x0;
  P.tol_sq = tol_sq;
  P.max_iters = max_iters;
  P.implicit = implicit;
  P.x = x;
  P.r = r;
  P.p = p;
  P.q = q;
  P.z = z;
  P.w1 = w1;
  P.w2 = w2;
  P.part = part;
  P.it_out = it_out;
  P.mon_out = mon_out;
  P.conv_out = conv_out;
  return gk_coop_launch(cg_ilu_fused_kernel<TA, TT>, P, blocks, stream);
}

// K23: ILU-preconditioned CG on a square Dia A to the stop test.
extern "C" int cg_ilu_fused_solve(
    const void* a_diags, int a_dtype, const long long* a_offsets, int a_nd,
    const void* l_diags, const long long* l_offsets, int l_nd, const void* u_diags,
    const long long* u_offsets, int u_nd, int t_dtype, long long n, const float* invdl,
    const float* invdu, const float* r0, const float* x0, const float* tol_sq, int max_iters,
    int sweeps_l, int sweeps_u, int implicit, float* x, float* r, float* p, float* q, float* z,
    float* w1, float* w2, double* part, int blocks, int* it_out, float* mon_out,
    int* conv_out, void* stream) {
  if (!gk_nd_ok(a_nd) || !gk_nd_ok(l_nd) || !gk_nd_ok(u_nd) || sweeps_l < 0 || sweeps_u < 0 ||
      max_iters < 0 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  GK_AT_DISPATCH(a_dtype, t_dtype,
                 (cg_ilu_launch<TA, TT>)(a_diags, a_offsets, a_nd, l_diags, l_offsets, l_nd,
                                         u_diags, u_offsets, u_nd, n, invdl, invdu, r0, x0,
                                         tol_sq, max_iters, sweeps_l, sweeps_u, implicit, x, r,
                                         p, q, z, w1, w2, part, blocks, it_out, mon_out,
                                         conv_out, stream));
}

// K24: blocks of the cooperative grid (7 doubles of partial sums a block).
extern "C" int bicgstab_ilu_fused_grid(int a_dtype, int t_dtype, int* blocks) {
  GK_AT_DISPATCH(a_dtype, t_dtype, (gk_coop_blocks(bicgstab_ilu_fused_kernel<TA, TT>, blocks)));
}

template <typename TA, typename TT>
static int bicgstab_ilu_launch(const void* a_diags, const long long* a_offsets, int a_nd,
                               const void* l_diags, const long long* l_offsets, int l_nd,
                               const void* u_diags, const long long* u_offsets, int u_nd,
                               long long n, const float* invdl, const float* invdu,
                               const float* r0, const float* x0, const float* tol_sq,
                               int max_iters, int sweeps_l, int sweeps_u, int implicit,
                               float* const* vecs, double* part, int blocks, int* it_out,
                               float* mon_out, int* conv_out, void* stream) {
  BicgstabIluParams<TA, TT> P;
  P.a = gk_dia_op<TA>(a_diags, a_offsets, a_nd, n);
  P.m = gk_ilu<TT>(l_diags, l_offsets, l_nd, u_diags, u_offsets, u_nd, n, invdl, invdu,
                   sweeps_l, sweeps_u);
  P.n = n;
  P.r0 = r0;
  P.x0 = x0;
  P.tol_sq = tol_sq;
  P.max_iters = max_iters;
  P.implicit = implicit;
  P.x = vecs[0];
  P.r = vecs[1];
  P.rr = vecs[2];
  P.p = vecs[3];
  P.v = vecs[4];
  P.s = vecs[5];
  P.t = vecs[6];
  P.y = vecs[7];
  P.mid = vecs[8];
  P.w1 = vecs[9];
  P.w2 = vecs[10];
  P.part = part;
  P.it_out = it_out;
  P.mon_out = mon_out;
  P.conv_out = conv_out;
  return gk_coop_launch(bicgstab_ilu_fused_kernel<TA, TT>, P, blocks, stream);
}

// K24: ILU right-preconditioned BiCGSTAB on a square Dia A to the stop
// test.  vecs: 11 float32 (n,) buffers x, r, rr, p, v, s, t, y, mid, w1, w2.
extern "C" int bicgstab_ilu_fused_solve(
    const void* a_diags, int a_dtype, const long long* a_offsets, int a_nd,
    const void* l_diags, const long long* l_offsets, int l_nd, const void* u_diags,
    const long long* u_offsets, int u_nd, int t_dtype, long long n, const float* invdl,
    const float* invdu, const float* r0, const float* x0, const float* tol_sq, int max_iters,
    int sweeps_l, int sweeps_u, int implicit, float* const* vecs, double* part, int blocks,
    int* it_out, float* mon_out, int* conv_out, void* stream) {
  if (!gk_nd_ok(a_nd) || !gk_nd_ok(l_nd) || !gk_nd_ok(u_nd) || sweeps_l < 0 || sweeps_u < 0 ||
      max_iters < 0 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  GK_AT_DISPATCH(a_dtype, t_dtype,
                 (bicgstab_ilu_launch<TA, TT>)(a_diags, a_offsets, a_nd, l_diags, l_offsets,
                                               l_nd, u_diags, u_offsets, u_nd, n, invdl, invdu,
                                               r0, x0, tol_sq, max_iters, sweeps_l, sweeps_u,
                                               implicit, vecs, part, blocks, it_out, mon_out,
                                               conv_out, stream));
}
