// Whole-solve restarted GMRES(m) in one persistent cooperative kernel,
// templated on its operator (coop.cuh GkDiaOp, pell.cuh GkPellOp): kernel
// K15 of the PyTorch port on a Dia, K18 on a Pell, and the k-column form
// K15m (below).
//
// K18 replaces ginkgo_tpu/ops/pallas_gmres.py pell_gmres_vmem_solve
// (_gmres_pell_kernel, :857), which runs the same _gmres_core over the
// Pell SpMV: only the operator's row differs (Arnoldi product, true
// residual), and every step moves the plan once in place of the diagonals.
//
// K15 replaces ginkgo_tpu/ops/pallas_gmres.py gmres_vmem_solve
// (_gmres_dia_kernel, :834, over _gmres_core, :110-378): left scalar-Jacobi
// preconditioned GMRES(m) with the Arnoldi process orthogonalized by CGS2,
// the Givens QR of the Hessenberg matrix updated on the fly, the
// back-substitution and the x update at the end of every cycle, and an
// honest re-check of the TRUE residual after every restart.  The kernel
// takes b (not r0) and returns the true r.r, always.
//
// What bounds it on the H100: bytes.  The basis, (m + 1) x n in float32 or
// bfloat16 (the CB-GMRES reduce1/reduce2 storage), lives in device memory:
// 520 MB in float32 at 4.19M rows and m = 30.  Arnoldi step j reads the
// j + 1 basis rows four times (the dots and the subtraction of each of the
// two Gram-Schmidt passes), so the bytes per step grow with j; a bfloat16
// basis halves them.
//
// What the design does about it, and the order of every operation:
//   - K4's cooperative design: the grid is what the SMs hold at once, the
//     loop runs inside the kernel, grid-wide barriers separate the passes,
//     each row belongs to one thread in every pass, and the vectors read
//     across rows (the basis row being multiplied, x in the residual) are
//     loaded with __ldcg.
//   - Per Arnoldi step six barriers: after the product u = M A V_j with the
//     first dots <V_i, u>; after the dots are summed (one block per i, in
//     the fixed order of coop.cuh); after the first subtraction with the
//     second dots; after those are summed; after the second subtraction
//     with u.u; and after V_{j+1} = u / |u| is stored.
//   - CGS2 as the TPU kernel (:233-266): all dots, then all subtractions,
//     twice; per element u -= h_i V_i in i order.
//   - The Givens rotations, the new rotation (phase = sign(a) for real
//     data), g, and the back-substitution are m-sized scalar work: thread 0
//     of every block does them redundantly in float32, in the TPU kernel's
//     order (:288-345), in shared memory, so every block takes the same
//     branch.  The back-substitution sums R[i][k] y[k] for k = i + 1 ..
//     steps - 1 in that order.
//   - x += y_i V_i in i order (:348-360).
//   - The first cycle's stop flag starts from the true residual; inside a
//     cycle the stop test is |g[j+1]|^2 (the preconditioned estimate); the
//     true residual after each restart decides `done` and can retract it.
//   - !(mon <= tol_sq) as the test, so a NaN keeps iterating; 1/0 norms
//     take 1 (inv_beta, inv_h), zero pivots give y = 0.

#include "coop.cuh"
#include "pell.cuh"

namespace cg = cooperative_groups;

// Most Krylov dimensions the kernel takes: its scalar state lives in
// 4 (m^2 + 7 m + 3) bytes of shared memory, under the 48 KB a block gets
// without opting in (ops/gmres.py MAX_FUSED_KRYLOV_DIM).
#define GK_GMRES_MAX_M 100
// K15m keeps that state per column, 4 k (m^2 + 7 m + 3) bytes: m <= 50
// stays under 48 KB for k = 4 (ops/gmres.py MAX_FUSED_KRYLOV_DIM_MULTI).
#define GK_GMRES_MULTI_MAX_M 50

template <typename Op>
struct GmresParams {
  Op op;
  long long n;
  const float* b;
  const float* x0;
  const float* minv;    // nullptr: Identity
  const float* tol_sq;  // device scalar
  int max_iters;
  int m;
  float* x;
  float* u;
  void* V;       // (m + 1, n) basis
  double* part;  // (m + 4) * gridDim.x per-block partial sums
  double* hd;    // (m + 1) summed dots
  int* it_out;
  float* rr_out;
  int* conv_out;
};

__device__ __forceinline__ void gk_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void gk_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Partial sums of <V_i, u> over this block's rows for i = 0..j, block b's
// at part[i * gridDim.x + b].
template <typename TV>
__device__ __forceinline__ void basis_dots(const TV* V, const float* u, int j,
                                           long long n, double* part,
                                           double (&sh)[1][GK_CG_WARPS]) {
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int i = 0; i <= j; ++i) {
    const TV* Vi = V + (long long)i * n;
    double acc[1] = {0.0};
    for (long long k = t0; k < n; k += stride)
      acc[0] += (double)gk_to_float(__ldcg(Vi + k)) * (double)u[k];
    block_partial<1>(acc, part + (long long)i * gridDim.x, sh);
  }
}

// After a grid barrier: hd[i] = the total of the partials of dot i, summed
// by one block in the fixed order of grid_total, for i = 0..j.
__device__ __forceinline__ void sum_dots(const double* part, double* hd, int j,
                                         double (&sh)[1][GK_CG_WARPS],
                                         double (&bc)[1]) {
  for (int i = blockIdx.x; i <= j; i += gridDim.x) {
    double tot[1];
    grid_total<1>(part + (long long)i * gridDim.x, tot, sh, bc);
    if (threadIdx.x == 0) hd[i] = tot[0];
  }
}

template <typename Op, typename TV>
__global__ void __launch_bounds__(GK_CG_THREADS) gmres_fused_kernel(const GmresParams<Op> P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[1][GK_CG_WARPS];
  __shared__ double sh2[2][GK_CG_WARPS];
  __shared__ double bc1[1];
  __shared__ double bc2[2];
  __shared__ int sm_active;
  extern __shared__ float sm[];
  const int m = P.m;
  float* h1 = sm;            // [m + 1] first-pass dots
  float* h2 = h1 + (m + 1);  // [m + 1] second-pass dots
  float* g = h2 + (m + 1);   // [m + 1] rotated right-hand side
  float* cs = g + (m + 1);   // [m]
  float* sn = cs + m;        // [m]
  float* y = sn + m;         // [m]
  float* Rm = y + m;         // [m][m + 1]: row j is column j of R

  TV* V = static_cast<TV*>(P.V);
  const long long n = P.n;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int G = gridDim.x;
  double* part_b = P.part;                     // [m + 1][G] basis dots
  double* part_r = P.part + (long long)(m + 1) * G;  // [G][2] r.r, z.z
  double* part_n = part_r + 2 * G;             // [G] u.u
  float* x = P.x;
  float* __restrict__ u = P.u;
  const float* __restrict__ minv = P.minv;
  const float tol_sq = *P.tol_sq;

  // init: x = x0, u = b - A x0; partial r.r and z.z with z = M u
  {
    double acc[2] = {0.0, 0.0};
    for (long long k = t0; k < n; k += stride) {
      x[k] = P.x0[k];
      const float rk = P.b[k] - P.op.row(k, P.x0);
      u[k] = rk;
      const float zk = minv ? minv[k] * rk : rk;
      acc[0] += (double)rk * rk;
      acc[1] += (double)zk * zk;
    }
    block_partial<2>(acc, part_r, sh2);
  }
  grid.sync();
  double tot2[2], tot1[1];
  grid_total<2>(part_r, tot2, sh2, bc2);
  float rr = (float)tot2[0];
  float beta_sq = (float)tot2[1];
  bool done = (rr <= tol_sq) && (tol_sq >= 0.f);
  int it = 0;

  while (!done && it < P.max_iters) {
    // cycle start: V_0 = z / |z| with z = M u (u holds the true residual)
    const float beta = sqrtf(beta_sq);
    const float inv_beta = beta > 0.f ? 1.f / beta : 1.f;
    for (long long k = t0; k < n; k += stride) {
      const float zk = minv ? minv[k] * u[k] : u[k];
      gk_store(V + k, zk * inv_beta);
    }
    if (threadIdx.x == 0) {
      for (int i = 0; i <= m; ++i) g[i] = 0.f;
      g[0] = beta;
      for (int i = 0; i < m; ++i) cs[i] = sn[i] = 0.f;
      for (int i = 0; i < m * (m + 1); ++i) Rm[i] = 0.f;
    }
    grid.sync();

    int j = 0;
    bool active = !(rr <= tol_sq);
    while (active && j < m) {
      // u = M A V_j; first dots <V_i, u>
      const TV* Vj = V + (long long)j * n;
      for (long long k = t0; k < n; k += stride) {
        const float acc = P.op.row(k, Vj);
        u[k] = minv ? minv[k] * acc : acc;
      }
      basis_dots(V, u, j, n, part_b, sh1);
      grid.sync();
      sum_dots(part_b, P.hd, j, sh1, bc1);
      grid.sync();
      if (threadIdx.x <= j) h1[threadIdx.x] = (float)__ldcg(P.hd + threadIdx.x);
      __syncthreads();

      // first subtraction u -= h1_i V_i in i order; second dots
      for (long long k = t0; k < n; k += stride) {
        float uk = u[k];
        for (int i = 0; i <= j; ++i)
          uk = uk - h1[i] * gk_to_float(__ldcg(V + (long long)i * n + k));
        u[k] = uk;
      }
      basis_dots(V, u, j, n, part_b, sh1);
      grid.sync();
      sum_dots(part_b, P.hd, j, sh1, bc1);
      grid.sync();
      if (threadIdx.x <= j) h2[threadIdx.x] = (float)__ldcg(P.hd + threadIdx.x);
      __syncthreads();

      // second subtraction; partial u.u
      {
        double acc[1] = {0.0};
        for (long long k = t0; k < n; k += stride) {
          float uk = u[k];
          for (int i = 0; i <= j; ++i)
            uk = uk - h2[i] * gk_to_float(__ldcg(V + (long long)i * n + k));
          u[k] = uk;
          acc[0] += (double)uk * uk;
        }
        block_partial<1>(acc, part_n, sh1);
      }
      grid.sync();
      grid_total<1>(part_n, tot1, sh1, bc1);
      const float hnext = sqrtf((float)tot1[0]);
      const float inv_h = hnext > 0.f ? 1.f / hnext : 1.f;

      // the Givens chain on the new Hessenberg column, by thread 0
      if (threadIdx.x == 0) {
        float* h = h1;  // h = h1 + h2 in place, h[j + 1] = |u|
        for (int i = 0; i <= j; ++i) h[i] = h1[i] + h2[i];
        h[j + 1] = hnext;
        for (int i = 0; i < j; ++i) {
          const float hi = h[i], hi1 = h[i + 1];
          h[i] = cs[i] * hi + sn[i] * hi1;
          h[i + 1] = -sn[i] * hi + cs[i] * hi1;
        }
        const float a = h[j], bb = h[j + 1];
        const float denom = sqrtf(a * a + bb * bb);
        const float c = denom > 0.f ? fabsf(a) / denom : 1.f;
        const float phase = fabsf(a) > 0.f ? (a > 0.f ? 1.f : -1.f) : 1.f;
        const float s = denom > 0.f ? phase * bb / denom : 0.f;
        h[j] = c * a + s * bb;
        h[j + 1] = 0.f;
        const float gj = g[j];
        g[j + 1] = -s * gj;
        g[j] = c * gj;
        for (int i = 0; i <= m; ++i) Rm[j * (m + 1) + i] = i <= j ? h[i] : 0.f;
        cs[j] = c;
        sn[j] = s;
        const float res_sq = g[j + 1] * g[j + 1];
        sm_active = (!(res_sq <= tol_sq) && it + 1 < P.max_iters) ? 1 : 0;
      }
      __syncthreads();
      active = sm_active != 0;

      // V_{j+1} = u / |u|
      TV* Vn = V + (long long)(j + 1) * n;
      for (long long k = t0; k < n; k += stride) gk_store(Vn + k, u[k] * inv_h);
      ++it;
      ++j;
      grid.sync();
    }
    const int steps = j;

    // back-substitution R y = g on the first `steps` columns, by thread 0
    if (threadIdx.x == 0) {
      for (int i = 0; i < m; ++i) y[i] = 0.f;
      for (int i = steps - 1; i >= 0; --i) {
        float acc = 0.f;
        for (int k = i + 1; k < steps; ++k) acc = acc + Rm[k * (m + 1) + i] * y[k];
        const float diag = Rm[i * (m + 1) + i];
        y[i] = diag != 0.f ? (g[i] - acc) / diag : 0.f;
      }
    }
    __syncthreads();

    // x += y_i V_i in i order
    for (long long k = t0; k < n; k += stride) {
      float xk = x[k];
      for (int i = 0; i < steps; ++i)
        xk = xk + y[i] * gk_to_float(__ldcg(V + (long long)i * n + k));
      x[k] = xk;
    }
    grid.sync();

    // the true residual u = b - A x; partial r.r and z.z
    {
      double acc[2] = {0.0, 0.0};
      for (long long k = t0; k < n; k += stride) {
        const float rk = P.b[k] - P.op.row(k, x);
        u[k] = rk;
        const float zk = minv ? minv[k] * rk : rk;
        acc[0] += (double)rk * rk;
        acc[1] += (double)zk * zk;
      }
      block_partial<2>(acc, part_r, sh2);
    }
    grid.sync();
    grid_total<2>(part_r, tot2, sh2, bc2);
    rr = (float)tot2[0];
    beta_sq = (float)tot2[1];
    done = (rr <= tol_sq) && (tol_sq >= 0.f);
  }

  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *P.it_out = it;
    *P.rr_out = rr;
    *P.conv_out = done ? 1 : 0;
  }
}

// k-column restarted GMRES(m) with per-column stopping: kernel K15m.
//
// Replaces ginkgo_tpu/ops/pallas_gmres.py gmres_vmem_solve_multi
// (_gmres_multi_dia_kernel, :396-766): K columns (2 <= K <= 4) in K15's
// passes, the vectors (n, K) row-major and the basis (m + 1, n, K), so a
// pass reads each diagonal value once per row for all K columns and the
// six grid barriers of an Arnoldi step are shared by the columns.
//   - One Arnoldi step counter j for all columns; each column has its own
//     g, cs, sn, R (per-column blocks of the dynamic shared memory, run by
//     thread 0 of every block as in K15, with K15's rotation order, phase =
//     sign(a) and in-i-order subtractions).
//   - A column stays active in a cycle while !(g[j+1]^2 <= tol) and
//     it < max_iters; a stopped column's QR freezes, but its basis row is
//     still written.
//   - After the cycle: the back-substitution over the full m (rows past a
//     column's own steps have a zero R diagonal and give y = 0), y = 0 for
//     a column done at the cycle's start, and x += y_i V_i over the shared j.
//   - The true residual of every column then decides `done` (done only
//     grows): a column whose in-cycle stop the true residual does not
//     confirm runs on in the next cycle.  The first `done` comes from r0.
// Bytes per Arnoldi step: K15's with every vector K columns wide; the
// diagonals are read once for all K.
template <typename TV, int K>
__device__ __forceinline__ void basis_dots_cols(const TV* V, const float* u, int j,
                                                long long n, double* part,
                                                double (&sh)[K][GK_CG_WARPS]) {
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int i = 0; i <= j; ++i) {
    const TV* Vi = V + (long long)i * n * K;
    double acc[K];
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] = 0.0;
    for (long long r = t0; r < n; r += stride) {
#pragma unroll
      for (int c = 0; c < K; ++c)
        acc[c] += (double)gk_to_float(__ldcg(Vi + r * K + c)) * (double)u[r * K + c];
    }
    block_partial<K>(acc, part + (long long)i * gridDim.x * K, sh);
  }
}

template <int K>
__device__ __forceinline__ void sum_dots_cols(const double* part, double* hd, int j,
                                              double (&sh)[K][GK_CG_WARPS],
                                              double (&bc)[K]) {
  for (int i = blockIdx.x; i <= j; i += gridDim.x) {
    double tot[K];
    grid_total<K>(part + (long long)i * gridDim.x * K, tot, sh, bc);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < K; ++c) hd[i * K + c] = tot[c];
    }
  }
}

struct GmresMultiParams {
  const void* diags;
  GkOffsets offs;
  long long n;
  const float* b;       // (n, K)
  const float* x0;      // (n, K)
  const float* minv;    // (n,) or nullptr: Identity
  const float* tol_sq;  // (K,)
  int max_iters;
  int m;
  float* x;      // (n, K)
  float* u;      // (n, K)
  void* V;       // (m + 1, n, K) basis
  double* part;  // (m + 4) K gridDim.x per-block partial sums
  double* hd;    // (m + 1) K summed dots
  int* it_out;
  float* rr_out;  // (K,)
  int* conv_out;  // (K,)
  int* itc_out;   // (K,)
};

template <typename TD, typename TV, int K>
__global__ void __launch_bounds__(GK_CG_THREADS)
    gmres_fused_multi_kernel(const GmresMultiParams P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double shK[K][GK_CG_WARPS];
  __shared__ double sh2K[2 * K][GK_CG_WARPS];
  __shared__ double bcK[K];
  __shared__ double bc2K[2 * K];
  __shared__ int sm_act[K];
  extern __shared__ float sm[];
  const int m = P.m;
  const int per_col = m * m + 7 * m + 3;
  // column c's block: h1 [m+1], h2 [m+1], g [m+1], cs [m], sn [m], y [m],
  // Rm [m][m+1] (row j is column j of R), as K15's
  float *h1[K], *h2[K], *g[K], *cs[K], *sn[K], *y[K], *Rm[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    h1[c] = sm + c * per_col;
    h2[c] = h1[c] + (m + 1);
    g[c] = h2[c] + (m + 1);
    cs[c] = g[c] + (m + 1);
    sn[c] = cs[c] + m;
    y[c] = sn[c] + m;
    Rm[c] = y[c] + m;
  }

  const TD* __restrict__ D = static_cast<const TD*>(P.diags);
  TV* V = static_cast<TV*>(P.V);
  const long long n = P.n;
  const long long nK = n * K;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int G = gridDim.x;
  double* part_b = P.part;                                // [m + 1][G][K] basis dots
  double* part_r = P.part + (long long)(m + 1) * G * K;  // [G][2K] r.r, z.z
  double* part_n = part_r + 2 * G * K;                    // [G][K] u.u
  float* x = P.x;
  float* __restrict__ u = P.u;
  const float* __restrict__ minv = P.minv;
  float tol[K], rr[K], beta_sq[K];
  bool done[K];
  int itc[K];

  // init: X = X0, U = B - A X0; partial r.r and z.z with z = M u
  {
    double acc[2 * K];
#pragma unroll
    for (int c = 0; c < 2 * K; ++c) acc[c] = 0.0;
    for (long long k = t0; k < n; k += stride) {
      float ax[K];
      gk_dia_row_cols<TD, float, K>(D, P.offs, n, k, P.x0, ax);
      const float mk = minv ? minv[k] : 1.f;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const long long e = k * K + c;
        x[e] = P.x0[e];
        const float rk = P.b[e] - ax[c];
        u[e] = rk;
        const float zk = minv ? mk * rk : rk;
        acc[c] += (double)rk * rk;
        acc[K + c] += (double)zk * zk;
      }
    }
    block_partial<2 * K>(acc, part_r, sh2K);
  }
  grid.sync();
  double tot2[2 * K], tot1[K];
  grid_total<2 * K>(part_r, tot2, sh2K, bc2K);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    tol[c] = P.tol_sq[c];
    rr[c] = (float)tot2[c];
    beta_sq[c] = (float)tot2[K + c];
    done[c] = rr[c] <= tol[c];
    itc[c] = 0;
  }
  int it = 0;

  for (;;) {
    bool all_done = true;
#pragma unroll
    for (int c = 0; c < K; ++c) all_done = all_done && done[c];
    if (!(!all_done && it < P.max_iters)) break;

    // cycle start: V_0 = z / |z| per column, z = M u (u holds the true residual)
    float inv_beta[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const float beta = sqrtf(beta_sq[c]);
      inv_beta[c] = beta > 0.f ? 1.f / beta : 1.f;
    }
    for (long long k = t0; k < n; k += stride) {
      const float mk = minv ? minv[k] : 1.f;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const long long e = k * K + c;
        const float zk = minv ? mk * u[e] : u[e];
        gk_store(V + e, zk * inv_beta[c]);
      }
    }
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        for (int i = 0; i <= m; ++i) g[c][i] = 0.f;
        g[c][0] = sqrtf(beta_sq[c]);
        for (int i = 0; i < m; ++i) cs[c][i] = sn[c][i] = 0.f;
        for (int i = 0; i < m * (m + 1); ++i) Rm[c][i] = 0.f;
      }
    }
    grid.sync();

    bool act[K];
    bool any_act = false;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      act[c] = !done[c];
      any_act = any_act || act[c];
    }
    int j = 0;
    while (any_act && j < m) {
      // U = M A V_j; first dots <V_i, u>
      const TV* Vj = V + (long long)j * nK;
      for (long long k = t0; k < n; k += stride) {
        float av[K];
        gk_dia_row_cols<TD, TV, K>(D, P.offs, n, k, Vj, av);
        const float mk = minv ? minv[k] : 1.f;
#pragma unroll
        for (int c = 0; c < K; ++c) u[k * K + c] = minv ? mk * av[c] : av[c];
      }
      basis_dots_cols<TV, K>(V, u, j, n, part_b, shK);
      grid.sync();
      sum_dots_cols<K>(part_b, P.hd, j, shK, bcK);
      grid.sync();
      if (threadIdx.x <= j) {
#pragma unroll
        for (int c = 0; c < K; ++c) h1[c][threadIdx.x] = (float)__ldcg(P.hd + threadIdx.x * K + c);
      }
      __syncthreads();

      // first subtraction u -= h1_i V_i in i order; second dots
      for (long long k = t0; k < n; k += stride) {
#pragma unroll
        for (int c = 0; c < K; ++c) {
          const long long e = k * K + c;
          float uk = u[e];
          for (int i = 0; i <= j; ++i)
            uk = uk - h1[c][i] * gk_to_float(__ldcg(V + (long long)i * nK + e));
          u[e] = uk;
        }
      }
      basis_dots_cols<TV, K>(V, u, j, n, part_b, shK);
      grid.sync();
      sum_dots_cols<K>(part_b, P.hd, j, shK, bcK);
      grid.sync();
      if (threadIdx.x <= j) {
#pragma unroll
        for (int c = 0; c < K; ++c) h2[c][threadIdx.x] = (float)__ldcg(P.hd + threadIdx.x * K + c);
      }
      __syncthreads();

      // second subtraction; partial u.u
      {
        double acc[K];
#pragma unroll
        for (int c = 0; c < K; ++c) acc[c] = 0.0;
        for (long long k = t0; k < n; k += stride) {
#pragma unroll
          for (int c = 0; c < K; ++c) {
            const long long e = k * K + c;
            float uk = u[e];
            for (int i = 0; i <= j; ++i)
              uk = uk - h2[c][i] * gk_to_float(__ldcg(V + (long long)i * nK + e));
            u[e] = uk;
            acc[c] += (double)uk * uk;
          }
        }
        block_partial<K>(acc, part_n, shK);
      }
      grid.sync();
      grid_total<K>(part_n, tot1, shK, bcK);
      float inv_h[K], hnext[K];
#pragma unroll
      for (int c = 0; c < K; ++c) {
        hnext[c] = sqrtf((float)tot1[c]);
        inv_h[c] = hnext[c] > 0.f ? 1.f / hnext[c] : 1.f;
      }

      // the Givens chain of every active column, by thread 0
      if (threadIdx.x == 0) {
#pragma unroll
        for (int c = 0; c < K; ++c) {
          if (!act[c]) {
            sm_act[c] = 0;
            continue;
          }
          float* h = h1[c];  // h = h1 + h2 in place, h[j + 1] = |u|
          for (int i = 0; i <= j; ++i) h[i] = h1[c][i] + h2[c][i];
          h[j + 1] = hnext[c];
          for (int i = 0; i < j; ++i) {
            const float hi = h[i], hi1 = h[i + 1];
            h[i] = cs[c][i] * hi + sn[c][i] * hi1;
            h[i + 1] = -sn[c][i] * hi + cs[c][i] * hi1;
          }
          const float a = h[j], bb = h[j + 1];
          const float denom = sqrtf(a * a + bb * bb);
          const float cc = denom > 0.f ? fabsf(a) / denom : 1.f;
          const float phase = fabsf(a) > 0.f ? (a > 0.f ? 1.f : -1.f) : 1.f;
          const float ss = denom > 0.f ? phase * bb / denom : 0.f;
          h[j] = cc * a + ss * bb;
          h[j + 1] = 0.f;
          const float gj = g[c][j];
          g[c][j + 1] = -ss * gj;
          g[c][j] = cc * gj;
          for (int i = 0; i <= m; ++i) Rm[c][j * (m + 1) + i] = i <= j ? h[i] : 0.f;
          cs[c][j] = cc;
          sn[c][j] = ss;
          const float res_sq = g[c][j + 1] * g[c][j + 1];
          sm_act[c] = (!(res_sq <= tol[c]) && it + 1 < P.max_iters) ? 1 : 0;
        }
      }
      __syncthreads();
      any_act = false;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        if (act[c]) itc[c] = it + 1;
        act[c] = sm_act[c] != 0;
        any_act = any_act || act[c];
      }

      // V_{j+1} = u / |u| in every column
      TV* Vn = V + (long long)(j + 1) * nK;
      for (long long k = t0; k < n; k += stride) {
#pragma unroll
        for (int c = 0; c < K; ++c) gk_store(Vn + k * K + c, u[k * K + c] * inv_h[c]);
      }
      ++it;
      ++j;
      grid.sync();
    }
    const int steps = j;

    // guarded back-substitution R y = g over the full m, by thread 0; a
    // column done at the cycle's start gets y = 0
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        for (int i = 0; i < m; ++i) y[c][i] = 0.f;
        if (done[c]) continue;
        for (int i = m - 1; i >= 0; --i) {
          float acc = 0.f;
          for (int k = i + 1; k < m; ++k) acc = acc + Rm[c][k * (m + 1) + i] * y[c][k];
          const float diag = Rm[c][i * (m + 1) + i];
          y[c][i] = diag != 0.f ? (g[c][i] - acc) / diag : 0.f;
        }
      }
    }
    __syncthreads();

    // x += y_i V_i in i order over the shared steps
    for (long long k = t0; k < n; k += stride) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const long long e = k * K + c;
        float xk = x[e];
        for (int i = 0; i < steps; ++i)
          xk = xk + y[c][i] * gk_to_float(__ldcg(V + (long long)i * nK + e));
        x[e] = xk;
      }
    }
    grid.sync();

    // the true residual U = B - A X per column; partial r.r and z.z
    {
      double acc[2 * K];
#pragma unroll
      for (int c = 0; c < 2 * K; ++c) acc[c] = 0.0;
      for (long long k = t0; k < n; k += stride) {
        float ax[K];
        gk_dia_row_cols<TD, float, K>(D, P.offs, n, k, x, ax);
        const float mk = minv ? minv[k] : 1.f;
#pragma unroll
        for (int c = 0; c < K; ++c) {
          const long long e = k * K + c;
          const float rk = P.b[e] - ax[c];
          u[e] = rk;
          const float zk = minv ? mk * rk : rk;
          acc[c] += (double)rk * rk;
          acc[K + c] += (double)zk * zk;
        }
      }
      block_partial<2 * K>(acc, part_r, sh2K);
    }
    grid.sync();
    grid_total<2 * K>(part_r, tot2, sh2K, bc2K);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const float rr_new = (float)tot2[c];
      if (!done[c]) rr[c] = rr_new;
      done[c] = done[c] || (rr_new <= tol[c]);
      beta_sq[c] = (float)tot2[K + c];
    }
  }

  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *P.it_out = it;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      P.rr_out[c] = rr[c];
      P.conv_out[c] = done[c] ? 1 : 0;
      P.itc_out[c] = itc[c];
    }
  }
}

static size_t gmres_smem(int m) { return sizeof(float) * ((size_t)m * m + 7 * (size_t)m + 3); }

#define GK_GMRES_DISPATCH(d_dtype, v_dtype, CALL)                                    \
  if (d_dtype == GK_F32 && v_dtype == GK_F32) return CALL(float, float);             \
  if (d_dtype == GK_F32 && v_dtype == GK_BF16) return CALL(float, __nv_bfloat16);    \
  if (d_dtype == GK_BF16 && v_dtype == GK_F32) return CALL(__nv_bfloat16, float);    \
  if (d_dtype == GK_BF16 && v_dtype == GK_BF16)                                      \
    return CALL(__nv_bfloat16, __nv_bfloat16);                                       \
  return (int)cudaErrorInvalidValue;

template <typename Op>
static GmresParams<Op> gmres_params(const Op& op, long long n, const float* b,
                                    const float* x0, const float* minv, const float* tol_sq,
                                    int max_iters, int m, void* V, float* x, float* u,
                                    double* part, double* hd, int* it_out, float* rr_out,
                                    int* conv_out) {
  GmresParams<Op> P;
  P.op = op;
  P.n = n;
  P.b = b;
  P.x0 = x0;
  P.minv = minv;
  P.tol_sq = tol_sq;
  P.max_iters = max_iters;
  P.m = m;
  P.x = x;
  P.u = u;
  P.V = V;
  P.part = part;
  P.hd = hd;
  P.it_out = it_out;
  P.rr_out = rr_out;
  P.conv_out = conv_out;
  return P;
}

// Blocks of the cooperative grid for the diagonals' and the basis' dtypes
// and the Krylov dimension m (which sizes the shared memory).
extern "C" int gmres_fused_grid(int d_dtype, int v_dtype, int m, int* blocks) {
  if (m < 1 || m > GK_GMRES_MAX_M) return (int)cudaErrorInvalidValue;
  const size_t smem = gmres_smem(m);
#define GK_GRID(TD, TV) gk_coop_blocks(gmres_fused_kernel<GkDiaOp<TD>, TV>, blocks, smem)
  GK_GMRES_DISPATCH(d_dtype, v_dtype, GK_GRID)
#undef GK_GRID
}

extern "C" int gmres_fused_solve(
    const void* diags, int d_dtype, const long long* offsets, int nd, long long n,
    const float* b, const float* x0, const float* minv, const float* tol_sq,
    int max_iters, int m, void* V, int v_dtype, float* x, float* u, double* part,
    double* hd, int blocks, int* it_out, float* rr_out, int* conv_out, void* stream) {
  if (nd < 1 || nd > GK_MAX_DIAGS || blocks < 1 || m < 1 || m > GK_GMRES_MAX_M)
    return (int)cudaErrorInvalidValue;
  const size_t smem = gmres_smem(m);
#define GK_LAUNCH(TD, TV)                                                                 \
  gk_coop_launch(gmres_fused_kernel<GkDiaOp<TD>, TV>,                                     \
                 gmres_params(gk_dia_op<TD>(diags, offsets, nd, n), n, b, x0, minv, tol_sq, \
                              max_iters, m, V, x, u, part, hd, it_out, rr_out, conv_out), \
                 blocks, stream, smem)
  GK_GMRES_DISPATCH(d_dtype, v_dtype, GK_LAUNCH)
#undef GK_LAUNCH
}

template <typename TVal, typename TQ>
static int pell_gmres_grid(int v_dtype, size_t smem, int* blocks) {
  if (v_dtype == GK_F32)
    return gk_coop_blocks(gmres_fused_kernel<GkPellOp<TVal, TQ>, float>, blocks, smem);
  if (v_dtype == GK_BF16)
    return gk_coop_blocks(gmres_fused_kernel<GkPellOp<TVal, TQ>, __nv_bfloat16>, blocks, smem);
  return (int)cudaErrorInvalidValue;
}

// K18: blocks of the Pell form's cooperative grid for the values', lane
// indices' and basis' dtypes and the Krylov dimension m.
extern "C" int pell_gmres_fused_grid(int val_dtype, int q_dtype, int v_dtype, int m,
                                     int* blocks) {
  if (m < 1 || m > GK_GMRES_MAX_M) return (int)cudaErrorInvalidValue;
  const size_t smem = gmres_smem(m);
  GK_PELL_VQ_DISPATCH(val_dtype, q_dtype, (pell_gmres_grid<TV, TQ>)(v_dtype, smem, blocks));
}

template <typename TVal, typename TQ>
static int pell_gmres_launch(const void* values, const void* qidx, const int* bases,
                             const int* tile_ptr, int S, int G, long long n, const float* b,
                             const float* x0, const float* minv, const float* tol_sq,
                             int max_iters, int m, void* V, int v_dtype, float* x, float* u,
                             double* part, double* hd, int blocks, int* it_out,
                             float* rr_out, int* conv_out, void* stream) {
  const GmresParams<GkPellOp<TVal, TQ>> P = gmres_params(
      gk_pell_op<TVal, TQ>(values, qidx, bases, tile_ptr, S, G, n, nullptr), n, b, x0, minv,
      tol_sq, max_iters, m, V, x, u, part, hd, it_out, rr_out, conv_out);
  const size_t smem = gmres_smem(m);
  if (v_dtype == GK_F32)
    return gk_coop_launch(gmres_fused_kernel<GkPellOp<TVal, TQ>, float>, P, blocks, stream,
                          smem);
  if (v_dtype == GK_BF16)
    return gk_coop_launch(gmres_fused_kernel<GkPellOp<TVal, TQ>, __nv_bfloat16>, P, blocks,
                          stream, smem);
  return (int)cudaErrorInvalidValue;
}

// K18: restarted GMRES(m) on a square Pell (values float32/bfloat16, lane
// indices int8/int32), left-preconditioned by minv (nullptr: Identity),
// with a float32 or bfloat16 basis.
extern "C" int pell_gmres_fused_solve(
    const void* values, int val_dtype, const void* qidx, int q_dtype, const int* bases,
    const int* tile_ptr, int S, int G, long long n, const float* b, const float* x0,
    const float* minv, const float* tol_sq, int max_iters, int m, void* V, int v_dtype,
    float* x, float* u, double* part, double* hd, int blocks, int* it_out, float* rr_out,
    int* conv_out, void* stream) {
  if (S < 1 || G < 1 || blocks < 1 || m < 1 || m > GK_GMRES_MAX_M)
    return (int)cudaErrorInvalidValue;
  GK_PELL_VQ_DISPATCH(val_dtype, q_dtype,
                      (pell_gmres_launch<TV, TQ>)(values, qidx, bases, tile_ptr, S, G, n, b,
                                                  x0, minv, tol_sq, max_iters, m, V, v_dtype,
                                                  x, u, part, hd, blocks, it_out, rr_out,
                                                  conv_out, stream));
}

#define GK_GMRES_SWITCH_K(k, CALL_K)             \
  switch (k) {                                   \
    case 2: return CALL_K(2);                    \
    case 3: return CALL_K(3);                    \
    case 4: return CALL_K(4);                    \
    default: return (int)cudaErrorInvalidValue;  \
  }

template <int K>
static int multi_grid(int d_dtype, int v_dtype, size_t smem, int* blocks) {
#define GK_GRID(TD, TV) gk_coop_blocks(gmres_fused_multi_kernel<TD, TV, K>, blocks, smem)
  GK_GMRES_DISPATCH(d_dtype, v_dtype, GK_GRID)
#undef GK_GRID
}

template <int K>
static int multi_launch(int d_dtype, int v_dtype, const GmresMultiParams& P, size_t smem,
                        int blocks, void* stream) {
#define GK_LAUNCH(TD, TV) \
  gk_coop_launch(gmres_fused_multi_kernel<TD, TV, K>, P, blocks, stream, smem)
  GK_GMRES_DISPATCH(d_dtype, v_dtype, GK_LAUNCH)
#undef GK_LAUNCH
}

// Blocks of K15m's cooperative grid for the dtypes, k columns and the
// Krylov dimension m (the per-column shared memory, k gmres_smem(m)).
extern "C" int gmres_fused_multi_grid(int d_dtype, int v_dtype, int k, int m, int* blocks) {
  if (m < 1 || m > GK_GMRES_MULTI_MAX_M) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)k * gmres_smem(m);
#define GK_GRID_K(K) multi_grid<K>(d_dtype, v_dtype, smem, blocks)
  GK_GMRES_SWITCH_K(k, GK_GRID_K)
#undef GK_GRID_K
}

extern "C" int gmres_fused_multi_solve(
    const void* diags, int d_dtype, const long long* offsets, int nd, long long n, int k,
    const float* b, const float* x0, const float* minv, const float* tol_sq,
    int max_iters, int m, void* V, int v_dtype, float* x, float* u, double* part,
    double* hd, int blocks, int* it_out, float* rr_out, int* conv_out, int* itc_out,
    void* stream) {
  if (nd < 1 || nd > GK_MAX_DIAGS || blocks < 1 || m < 1 || m > GK_GMRES_MULTI_MAX_M)
    return (int)cudaErrorInvalidValue;
  GmresMultiParams P;
  P.diags = diags;
  P.offs.nd = nd;
  for (int d = 0; d < nd; ++d) P.offs.off[d] = offsets[d];
  P.n = n;
  P.b = b;
  P.x0 = x0;
  P.minv = minv;
  P.tol_sq = tol_sq;
  P.max_iters = max_iters;
  P.m = m;
  P.x = x;
  P.u = u;
  P.V = V;
  P.part = part;
  P.hd = hd;
  P.it_out = it_out;
  P.rr_out = rr_out;
  P.conv_out = conv_out;
  P.itc_out = itc_out;
  const size_t smem = (size_t)k * gmres_smem(m);
#define GK_LAUNCH_K(K) multi_launch<K>(d_dtype, v_dtype, P, smem, blocks, stream)
  GK_GMRES_SWITCH_K(k, GK_LAUNCH_K)
#undef GK_LAUNCH_K
}
