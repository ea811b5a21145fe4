// Whole-solve right-preconditioned BiCGSTAB in one persistent cooperative
// kernel, templated on its operator (coop.cuh GkDiaOp, pell.cuh GkPellOp):
// kernel K12 of the PyTorch port on a Dia, K19 on a Pell, and the k-column
// form K12m (below).
//
// K12 replaces ginkgo_tpu/ops/pallas_bicgstab.py bicgstab_vmem_solve
// (_bicgstab_kernel, :53-186).  A diagonal preconditioner M is folded into
// the operator before the launch (solver/_fused_gate.fold_minv: diagonal d
// scaled by minv at column i + off_d and rounded back to the diagonals'
// dtype), so the kernel runs on A M and applies minv only in the x update,
// y = minv p and z = minv s.
//
// K19 replaces ginkgo_tpu/ops/pallas_pell_cg.py pell_bicgstab_vmem_solve
// (_pell_bicgstab_kernel, :313): the same loop on a Pell.  PELL values have
// no column fold, so M is applied explicitly, v = A (M p) and t = A (M s):
// the operator's gather multiplies each gathered p or s by minv of its
// column (GkPellOp cminv), the TPU kernel's staged w = M p rounded the same
// way, with no pass of its own.  The x update is the same as K12's.  Per
// iteration it moves the plan twice (values, lane indices, bases) and the
// vectors as K12 does, plus minv gathered with p and s.
//
// What bounds it on the H100: bytes.  Per iteration five passes move
// (2 nd sizeof(TD) + 72) n bytes, 80 n with minv: p = r + beta (p - omega
// v) reads r, p, v and writes p; v = (A M) p reads the diagonals, p and rr
// and writes v; s = r - alpha v reads r, v and writes s; t = (A M) s reads
// the diagonals and s and writes t; the update reads x, p, s, t, rr (and
// minv) and writes x and r.
//
// What the design does about it: K4's (cg_fused.cu).  The grid is what the
// SMs hold at once, launched cooperatively; the loop runs inside the
// kernel with grid-wide barriers between the passes; each row belongs to
// one thread in every pass; p and s, which the products read across rows,
// are loaded with __ldcg.  Dot products are float64 per-block partials that
// every block sums in one fixed order (coop.cuh), so all blocks take the
// same branch.  Consecutive reductions with no barrier between them write
// different partial buffers, so a fast block never overwrites partials a
// slow block is still summing.
//
// Semantics kept from _bicgstab_kernel:
//   - shadow residual rr = r0; rho starts at <r0, r0>; p = v = 0; the
//     carried rho_old, alpha and omega start at 1;
//   - half step: after s = r - alpha v, a solve whose monitor (s.s, or
//     |rho| in implicit mode) is at the threshold takes omega = 0, so
//     r = s, and carries omega = 1 into the next beta;
//   - the next rho = <rr, r_new> is summed in the update pass;
//   - the loop runs while it < max_iters && !(mon <= tol_sq): a NaN monitor
//     keeps iterating; zero denominators give 0 (gk_sdiv).

#include "coop.cuh"
#include "pell.cuh"

namespace cg = cooperative_groups;

template <typename Op>
struct BicgstabParams {
  Op op;  // A M (Dia, folded), or A with M applied on the gather (Pell)
  long long n;
  const float* r0;      // (n,), or (n, K) row-major in K12m
  const float* x0;
  const float* minv;    // (n,) or nullptr: Identity; used in the x update only
  const float* tol_sq;  // device scalar, (K,) in K12m
  int max_iters;
  int implicit;
  float* x;
  float* r;
  float* rr;
  float* v;
  float* t;
  float* p;
  float* s;
  double* part;  // 6 * gridDim.x (6 K gridDim.x in K12m) per-block partial sums
  int* it_out;
  float* mon_out;   // (K,) in K12m
  int* conv_out;    // (K,) in K12m
  int* itc_out;     // K12m: (K,) iteration at which each column stopped
};

template <typename Op>
__global__ void __launch_bounds__(GK_CG_THREADS)
    bicgstab_fused_kernel(const BicgstabParams<Op> P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[1][GK_CG_WARPS];
  __shared__ double sh2[2][GK_CG_WARPS];
  __shared__ double bc1[1];
  __shared__ double bc2[2];

  const long long n = P.n;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int G = gridDim.x;
  double* part_rv = P.part;          // [G]     <rr, v>
  double* part_ss = P.part + G;      // [G]     s.s
  double* part_t = P.part + 2 * G;   // [G][2]  t.s, t.t
  double* part_u = P.part + 4 * G;   // [G][2]  <rr, r>, r.r (and the init)
  float* __restrict__ x = P.x;
  float* __restrict__ r = P.r;
  float* __restrict__ rr = P.rr;
  float* __restrict__ v = P.v;
  float* __restrict__ t = P.t;
  float* p = P.p;
  float* s = P.s;
  const float* __restrict__ minv = P.minv;

  // init: x = x0, r = rr = r0, p = v = 0; rho = <r0, r0>
  {
    double acc[2] = {0.0, 0.0};
    for (long long i = t0; i < n; i += stride) {
      const float ri = P.r0[i];
      x[i] = P.x0[i];
      r[i] = ri;
      rr[i] = ri;
      v[i] = 0.f;
      p[i] = 0.f;
      acc[0] += (double)ri * ri;
    }
    block_partial<2>(acc, part_u, sh2);
  }
  grid.sync();
  double tot1[1], tot2[2];
  grid_total<2>(part_u, tot2, sh2, bc2);
  float rho_new = (float)tot2[0];
  float rho_old = 1.f, alpha = 1.f, omega = 1.f;

  const float tol_sq = *P.tol_sq;
  int it = 0;
  float mon = CUDART_INF_F;
  while (it < P.max_iters && !(mon <= tol_sq)) {
    const float beta = gk_sdiv(rho_new * alpha, rho_old * omega);

    // pass 1: p = r + beta (p - omega v)
    for (long long i = t0; i < n; i += stride) {
      p[i] = r[i] + beta * (__ldcg(p + i) - omega * v[i]);
    }
    grid.sync();

    // pass 2: v = (A M) p; partial <rr, v>
    {
      double acc[1] = {0.0};
      for (long long i = t0; i < n; i += stride) {
        const float vi = P.op.row(i, p);
        v[i] = vi;
        acc[0] += (double)rr[i] * vi;
      }
      block_partial<1>(acc, part_rv, sh1);
    }
    grid.sync();
    grid_total<1>(part_rv, tot1, sh1, bc1);
    const float alpha_new = gk_sdiv(rho_new, (float)tot1[0]);

    // pass 3: s = r - alpha v; partial s.s (the half-step check)
    {
      double acc[1] = {0.0};
      for (long long i = t0; i < n; i += stride) {
        const float si = r[i] - alpha_new * v[i];
        s[i] = si;
        acc[0] += (double)si * si;
      }
      block_partial<1>(acc, part_ss, sh1);
    }
    grid.sync();
    grid_total<1>(part_ss, tot1, sh1, bc1);
    const bool half_done = (P.implicit ? fabsf(rho_new) : (float)tot1[0]) <= tol_sq;

    // pass 4: t = (A M) s; partial t.s, t.t
    {
      double acc[2] = {0.0, 0.0};
      for (long long i = t0; i < n; i += stride) {
        const float ti = P.op.row(i, s);
        t[i] = ti;
        const float si = __ldcg(s + i);
        acc[0] += (double)ti * si;
        acc[1] += (double)ti * ti;
      }
      block_partial<2>(acc, part_t, sh2);
    }
    grid.sync();
    grid_total<2>(part_t, tot2, sh2, bc2);
    const float omega_new = half_done ? 0.f : gk_sdiv((float)tot2[0], (float)tot2[1]);

    // pass 5: x += alpha (M p) + omega (M s); r = s - omega t; partial
    // <rr, r> (the next rho) and r.r
    {
      double acc[2] = {0.0, 0.0};
      for (long long i = t0; i < n; i += stride) {
        const float pi = __ldcg(p + i);
        const float si = __ldcg(s + i);
        const float yi = minv ? minv[i] * pi : pi;
        const float zi = minv ? minv[i] * si : si;
        x[i] = x[i] + alpha_new * yi + omega_new * zi;
        const float ri = si - omega_new * t[i];
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

// k-column BiCGSTAB with per-column stopping: kernel K12m.
//
// Replaces ginkgo_tpu/ops/pallas_bicgstab.py bicgstab_vmem_solve_multi
// (_bicgstab_multi_kernel, :202-426): K columns (2 <= K <= 8) solved
// together in K12's five passes, the vectors (n, K) row-major as K4m's, so
// each diagonal value is read once per row for all K columns.  Every scalar
// of K12 is a K-vector, and every reduction carries K (passes 2, 3) or 2 K
// (passes 4, 5) float64 partials per block.  Per column, as the
// reference's stopping-status-masked step kernels:
//   - a stopped column keeps p, v, x and r: the update is a select on the
//     write, so a frozen column's x and r stay bit-identical from the
//     iteration it stopped; s and t are still computed for it, with
//     alpha_eff = omega_eff = 0, and its carried rho, alpha and omega stay;
//   - the half step fires per column (s.s, or |rho| in implicit mode, at
//     the threshold): omega = 0, carried as 1;
//   - each column records the iteration at which it stopped (itc);
//   - every monitor starts at +inf, so the first iteration always runs,
//     and the loop runs while it < max_iters and any column is active.
// Bytes per iteration: 2 nd sizeof(TD) n + 72 K n (80 K n with minv, read
// once per row for the K columns: + 4 n).
template <typename TD, int K>
__global__ void __launch_bounds__(GK_CG_THREADS)
    bicgstab_fused_multi_kernel(const BicgstabParams<GkDiaOp<TD>> P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[K][GK_CG_WARPS];
  __shared__ double sh2[2 * K][GK_CG_WARPS];
  __shared__ double bc1[K];
  __shared__ double bc2[2 * K];

  const TD* __restrict__ D = P.op.diags;
  const long long n = P.n;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int G = gridDim.x;
  double* part_rv = P.part;              // [G][K]   <rr, v>
  double* part_ss = P.part + G * K;      // [G][K]   s.s
  double* part_t = P.part + 2 * G * K;   // [G][2K]  t.s, t.t
  double* part_u = P.part + 4 * G * K;   // [G][2K]  <rr, r>, r.r (and the init)
  float* __restrict__ x = P.x;
  float* __restrict__ r = P.r;
  float* __restrict__ rr = P.rr;
  float* __restrict__ v = P.v;
  float* __restrict__ t = P.t;
  float* p = P.p;
  float* s = P.s;
  const float* __restrict__ minv = P.minv;

  // init: X = X0, R = RR = R0, P = V = 0; rho_c = <r0_c, r0_c>
  {
    double acc[2 * K];
#pragma unroll
    for (int c = 0; c < 2 * K; ++c) acc[c] = 0.0;
    for (long long i = t0; i < n; i += stride) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const long long e = i * K + c;
        const float ri = P.r0[e];
        x[e] = P.x0[e];
        r[e] = ri;
        rr[e] = ri;
        v[e] = 0.f;
        p[e] = 0.f;
        acc[c] += (double)ri * ri;
      }
    }
    block_partial<2 * K>(acc, part_u, sh2);
  }
  grid.sync();
  double tot1[K], tot2[2 * K];
  grid_total<2 * K>(part_u, tot2, sh2, bc2);
  float rho_new[K], rho_old[K], alpha[K], omega[K], tol[K], mon[K];
  bool act[K];
  int itc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    rho_new[c] = (float)tot2[c];
    rho_old[c] = alpha[c] = omega[c] = 1.f;
    tol[c] = P.tol_sq[c];
    mon[c] = CUDART_INF_F;
    act[c] = true;
    itc[c] = 0;
  }

  int it = 0;
  for (;;) {
    bool any = false;
#pragma unroll
    for (int c = 0; c < K; ++c) any = any || act[c];
    if (!(it < P.max_iters && any)) break;
    float beta[K];
#pragma unroll
    for (int c = 0; c < K; ++c) beta[c] = gk_sdiv(rho_new[c] * alpha[c], rho_old[c] * omega[c]);

    // pass 1: P = R + beta (P - omega V) in the active columns
    for (long long i = t0; i < n; i += stride) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const long long e = i * K + c;
        if (act[c]) p[e] = r[e] + beta[c] * (__ldcg(p + e) - omega[c] * v[e]);
      }
    }
    grid.sync();

    // pass 2: V = (A M) P in the active columns; partial <rr, v>
    {
      double acc[K];
#pragma unroll
      for (int c = 0; c < K; ++c) acc[c] = 0.0;
      for (long long i = t0; i < n; i += stride) {
        float av[K];
        gk_dia_row_cols<TD, float, K>(D, P.op.offs, n, i, p, av);
#pragma unroll
        for (int c = 0; c < K; ++c) {
          const long long e = i * K + c;
          const float vi = act[c] ? av[c] : v[e];
          v[e] = vi;
          acc[c] += (double)rr[e] * vi;
        }
      }
      block_partial<K>(acc, part_rv, sh1);
    }
    grid.sync();
    grid_total<K>(part_rv, tot1, sh1, bc1);
    float alpha_new[K], alpha_eff[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      alpha_new[c] = act[c] ? gk_sdiv(rho_new[c], (float)tot1[c]) : alpha[c];
      alpha_eff[c] = act[c] ? alpha_new[c] : 0.f;
    }

    // pass 3: S = R - alpha_eff V in every column; partial s.s
    {
      double acc[K];
#pragma unroll
      for (int c = 0; c < K; ++c) acc[c] = 0.0;
      for (long long i = t0; i < n; i += stride) {
#pragma unroll
        for (int c = 0; c < K; ++c) {
          const long long e = i * K + c;
          const float si = r[e] - alpha_eff[c] * v[e];
          s[e] = si;
          acc[c] += (double)si * si;
        }
      }
      block_partial<K>(acc, part_ss, sh1);
    }
    grid.sync();
    grid_total<K>(part_ss, tot1, sh1, bc1);
    bool half_done[K];
#pragma unroll
    for (int c = 0; c < K; ++c)
      half_done[c] = act[c] && ((P.implicit ? fabsf(rho_new[c]) : (float)tot1[c]) <= tol[c]);

    // pass 4: T = (A M) S; partial t.s, t.t
    {
      double acc[2 * K];
#pragma unroll
      for (int c = 0; c < 2 * K; ++c) acc[c] = 0.0;
      for (long long i = t0; i < n; i += stride) {
        float at[K];
        gk_dia_row_cols<TD, float, K>(D, P.op.offs, n, i, s, at);
#pragma unroll
        for (int c = 0; c < K; ++c) {
          const long long e = i * K + c;
          t[e] = at[c];
          const float si = __ldcg(s + e);
          acc[c] += (double)at[c] * si;
          acc[K + c] += (double)at[c] * at[c];
        }
      }
      block_partial<2 * K>(acc, part_t, sh2);
    }
    grid.sync();
    grid_total<2 * K>(part_t, tot2, sh2, bc2);
    float omega_eff[K];
#pragma unroll
    for (int c = 0; c < K; ++c)
      omega_eff[c] = (act[c] && !half_done[c]) ? gk_sdiv((float)tot2[c], (float)tot2[K + c]) : 0.f;

    // pass 5: X += alpha (M P) + omega (M S), R = S - omega T in the active
    // columns; partial <rr, r> (the next rho) and r.r
    {
      double acc[2 * K];
#pragma unroll
      for (int c = 0; c < 2 * K; ++c) acc[c] = 0.0;
      for (long long i = t0; i < n; i += stride) {
        const float mi = minv ? minv[i] : 1.f;
#pragma unroll
        for (int c = 0; c < K; ++c) {
          const long long e = i * K + c;
          float ri = r[e];
          if (act[c]) {
            const float pi = __ldcg(p + e);
            const float si = __ldcg(s + e);
            const float yi = minv ? mi * pi : pi;
            const float zi = minv ? mi * si : si;
            x[e] = x[e] + alpha_eff[c] * yi + omega_eff[c] * zi;
            ri = si - omega_eff[c] * t[e];
            r[e] = ri;
          }
          acc[c] += (double)rr[e] * ri;
          acc[K + c] += (double)ri * ri;
        }
      }
      block_partial<2 * K>(acc, part_u, sh2);
    }
    grid.sync();
    grid_total<2 * K>(part_u, tot2, sh2, bc2);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      mon[c] = P.implicit ? fabsf(rho_new[c]) : (float)tot2[K + c];
      if (act[c]) {
        itc[c] = it + 1;
        omega[c] = half_done[c] ? 1.f : omega_eff[c];
      }
      rho_old[c] = rho_new[c];
      alpha[c] = alpha_new[c];
      if (act[c]) rho_new[c] = (float)tot2[c];
      act[c] = act[c] && !(mon[c] <= tol[c]);
    }
    ++it;
  }

  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *P.it_out = it;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      P.mon_out[c] = mon[c];
      P.conv_out[c] = (mon[c] <= tol[c]) ? 1 : 0;
      P.itc_out[c] = itc[c];
    }
  }
}

// The launch parameters shared by every entry point; the operator is set by
// the caller.
template <typename Op>
static BicgstabParams<Op> bicgstab_params(
    const Op& op, long long n, const float* r0, const float* x0, const float* minv,
    const float* tol_sq, int max_iters, int implicit, float* x, float* r, float* rr,
    float* v, float* t, float* p, float* s, double* part, int* it_out, float* mon_out,
    int* conv_out, int* itc_out) {
  BicgstabParams<Op> P;
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
  P.v = v;
  P.t = t;
  P.p = p;
  P.s = s;
  P.part = part;
  P.it_out = it_out;
  P.mon_out = mon_out;
  P.conv_out = conv_out;
  P.itc_out = itc_out;
  return P;
}

// Blocks of the cooperative grid (the wrapper sizes the partial sums, 6
// doubles per block, from it).
extern "C" int bicgstab_fused_grid(int d_dtype, int* blocks) {
  if (d_dtype == GK_F32) return gk_coop_blocks(bicgstab_fused_kernel<GkDiaOp<float>>, blocks);
  if (d_dtype == GK_BF16)
    return gk_coop_blocks(bicgstab_fused_kernel<GkDiaOp<__nv_bfloat16>>, blocks);
  return (int)cudaErrorInvalidValue;
}

extern "C" int bicgstab_fused_solve(
    const void* diags, int d_dtype, const long long* offsets, int nd, long long n,
    const float* r0, const float* x0, const float* minv, const float* tol_sq,
    int max_iters, int implicit, float* x, float* r, float* rr, float* v,
    float* t, float* p, float* s, double* part, int blocks, int* it_out,
    float* mon_out, int* conv_out, void* stream) {
  if (nd < 1 || nd > GK_MAX_DIAGS || blocks < 1) return (int)cudaErrorInvalidValue;
#define GK_DIA_LAUNCH(TD)                                                              \
  gk_coop_launch(bicgstab_fused_kernel<GkDiaOp<TD>>,                                   \
                 bicgstab_params(gk_dia_op<TD>(diags, offsets, nd, n), n, r0, x0, minv, \
                                 tol_sq, max_iters, implicit, x, r, rr, v, t, p, s,     \
                                 part, it_out, mon_out, conv_out, nullptr),             \
                 blocks, stream)
  if (d_dtype == GK_F32) return GK_DIA_LAUNCH(float);
  if (d_dtype == GK_BF16) return GK_DIA_LAUNCH(__nv_bfloat16);
#undef GK_DIA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// K19: blocks of the Pell form's cooperative grid (6 doubles of partial
// sums per block, as K12).
extern "C" int pell_bicgstab_fused_grid(int v_dtype, int q_dtype, int* blocks) {
  GK_PELL_VQ_DISPATCH(v_dtype, q_dtype,
                      gk_coop_blocks(bicgstab_fused_kernel<GkPellOp<TV, TQ>>, blocks));
}

template <typename TV, typename TQ>
static int pell_bicgstab_launch(const void* values, const void* qidx, const int* bases,
                                const int* tile_ptr, int S, int G, long long n,
                                const float* r0, const float* x0, const float* minv,
                                const float* tol_sq, int max_iters, int implicit, float* x,
                                float* r, float* rr, float* v, float* t, float* p, float* s,
                                double* part, int blocks, int* it_out, float* mon_out,
                                int* conv_out, void* stream) {
  return gk_coop_launch(
      bicgstab_fused_kernel<GkPellOp<TV, TQ>>,
      bicgstab_params(gk_pell_op<TV, TQ>(values, qidx, bases, tile_ptr, S, G, n, minv), n,
                      r0, x0, minv, tol_sq, max_iters, implicit, x, r, rr, v, t, p, s, part,
                      it_out, mon_out, conv_out, nullptr),
      blocks, stream);
}

// K19: BiCGSTAB on a square Pell (values float32/bfloat16, lane indices
// int8/int32), M = diag(minv) applied explicitly (minv nullptr: Identity).
extern "C" int pell_bicgstab_fused_solve(
    const void* values, int v_dtype, const void* qidx, int q_dtype, const int* bases,
    const int* tile_ptr, int S, int G, long long n, const float* r0, const float* x0,
    const float* minv, const float* tol_sq, int max_iters, int implicit, float* x, float* r,
    float* rr, float* v, float* t, float* p, float* s, double* part, int blocks,
    int* it_out, float* mon_out, int* conv_out, void* stream) {
  if (S < 1 || G < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  GK_PELL_VQ_DISPATCH(v_dtype, q_dtype,
                      (pell_bicgstab_launch<TV, TQ>)(
                          values, qidx, bases, tile_ptr, S, G, n, r0, x0, minv, tol_sq,
                          max_iters, implicit, x, r, rr, v, t, p, s, part, blocks, it_out,
                          mon_out, conv_out, stream));
}

template <int K>
static int multi_grid(int d_dtype, int* blocks) {
  if (d_dtype == GK_F32) return gk_coop_blocks(bicgstab_fused_multi_kernel<float, K>, blocks);
  if (d_dtype == GK_BF16)
    return gk_coop_blocks(bicgstab_fused_multi_kernel<__nv_bfloat16, K>, blocks);
  return (int)cudaErrorInvalidValue;
}

template <typename TD, int K>
static int multi_launch(const void* diags, const long long* offsets, int nd, long long n,
                        const float* r0, const float* x0, const float* minv,
                        const float* tol_sq, int max_iters, int implicit, float* x, float* r,
                        float* rr, float* v, float* t, float* p, float* s, double* part,
                        int blocks, int* it_out, float* mon_out, int* conv_out,
                        int* itc_out, void* stream) {
  return gk_coop_launch(
      bicgstab_fused_multi_kernel<TD, K>,
      bicgstab_params(gk_dia_op<TD>(diags, offsets, nd, n), n, r0, x0, minv, tol_sq,
                      max_iters, implicit, x, r, rr, v, t, p, s, part, it_out, mon_out,
                      conv_out, itc_out),
      blocks, stream);
}

#define GK_SWITCH_K(k, CALL_K)                   \
  switch (k) {                                   \
    case 2: return CALL_K(2);                    \
    case 3: return CALL_K(3);                    \
    case 4: return CALL_K(4);                    \
    case 5: return CALL_K(5);                    \
    case 6: return CALL_K(6);                    \
    case 7: return CALL_K(7);                    \
    case 8: return CALL_K(8);                    \
    default: return (int)cudaErrorInvalidValue;  \
  }

// Blocks of K12m's cooperative grid for k columns (6 k doubles of partial
// sums per block).
extern "C" int bicgstab_fused_multi_grid(int d_dtype, int k, int* blocks) {
#define GK_GRID_K(K) multi_grid<K>(d_dtype, blocks)
  GK_SWITCH_K(k, GK_GRID_K)
#undef GK_GRID_K
}

extern "C" int bicgstab_fused_multi_solve(
    const void* diags, int d_dtype, const long long* offsets, int nd, long long n, int k,
    const float* r0, const float* x0, const float* minv, const float* tol_sq,
    int max_iters, int implicit, float* x, float* r, float* rr, float* v,
    float* t, float* p, float* s, double* part, int blocks, int* it_out,
    float* mon_out, int* conv_out, int* itc_out, void* stream) {
  if (nd < 1 || nd > GK_MAX_DIAGS || blocks < 1) return (int)cudaErrorInvalidValue;
#define GK_LAUNCH_TD_K(TD, K)                                                             \
  multi_launch<TD, K>(diags, offsets, nd, n, r0, x0, minv, tol_sq, max_iters, implicit, x, \
                      r, rr, v, t, p, s, part, blocks, it_out, mon_out, conv_out, itc_out,   \
                      stream)
#define GK_LAUNCH_F32_K(K) GK_LAUNCH_TD_K(float, K)
#define GK_LAUNCH_BF16_K(K) GK_LAUNCH_TD_K(__nv_bfloat16, K)
  if (d_dtype == GK_F32) GK_SWITCH_K(k, GK_LAUNCH_F32_K)
  if (d_dtype == GK_BF16) GK_SWITCH_K(k, GK_LAUNCH_BF16_K)
#undef GK_LAUNCH_BF16_K
#undef GK_LAUNCH_F32_K
#undef GK_LAUNCH_TD_K
  return (int)cudaErrorInvalidValue;
}
