// Sweep triangular solves and ILU-preconditioned whole solves: kernels K22
// (trs_fused), K23 (cg_ilu_fused) and K24 (bicgstab_ilu_fused) of the
// PyTorch port.  Each triangular solve runs one of two routines: the
// pipelined walk of tri_walk.cuh (where the triangle's offsets are
// one-signed and the walk's rings fit a block's shared memory; K24's only
// where both sides sweep at least once) or the barrier routine
// gk_tri_sweeps otherwise.
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
// What bounds them on the H100: bytes.  A sweep pass of gk_tri_sweeps reads
// the triangle's diagonals, its source iterate, rhs and the inverse
// diagonal and writes the new iterate: (nd sizeof(TT) + 16) n bytes, and a
// solve is 1 + sweeps such passes, each behind a grid barrier.  The TPU
// kernel keeps the iterate in VMEM and streams the diagonals once.  The
// walk does the same with shared memory: one pass, the diagonals, rhs and
// invd read once a row (plus a halo of sweeps * w rows a block), one float
// written a row, and no grid barrier (tri_walk.cuh).
//
// K22 on the walk is a plain launch of one block a range of rows.  K23 on
// the walk runs four grid barriers an iteration where the barrier routine
// runs 3 + sweeps_l + sweeps_u: q = A p; then r_new = r - alpha q fused
// into the L walk, which forms r_new on its halo rows from r and q itself
// (another block may be writing r_new there, so r alternates between two
// buffers); the U walk with the r.z partial; then x += alpha p and
// p = z + beta p in one pass.  K24 on the walk runs seven where the barrier
// routine runs 5 + 2 (sweeps_l + sweeps_u): each of its two M applies an L
// walk that forms its right-hand side (p, then s) itself and a U walk.
//
// The barrier routine is K4's design (cg_fused.cu): the grid is what the SMs
// hold at once, launched cooperatively, and every pass is a loop over the
// rows with each row owned by one thread in every pass.  A sweep reads the
// previous iterate across rows (through coop.cuh's gk_dia_row, __ldcg, in
// the plain versions' row-sum order) and the next sweep writes the buffer
// this one read, so two device buffers ping-pong with a grid barrier before
// each sweep; the buffer a solve starts in is picked by the parity of the
// sweep count, so the result always lands in `out`.  Rows outside [0, n)
// read 0.  The dot products follow coop.cuh: float64 per-block partials that
// every block sums in one fixed order, so every block takes the same branch
// of the stop test, written as !(mon <= tol_sq) so that a NaN keeps
// iterating.
//
// The solves multiply by the inverse diagonal (1 / diag rounded to float32,
// the TPU kernels' invd frames), where the streaming TriangularSolver
// divides by the diagonal: the two differ by ulps.  Triangles may be
// float32 or bfloat16 (both of one dtype, widened on read), the operator
// A independently; all arithmetic is float32.

#include <type_traits>
#include <utility>

#include "coop.cuh"
#include "tri_walk.cuh"

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

// The walk route: block b owns the rows [b T, b T + T), T = ceil(n /
// gridDim.x), and writes x there; a plain launch of blocks of
// GK_TRS_WALK_THREADS threads (512 ran K22 faster than 1024 on the H100,
// PERF.md section 6).
#define GK_TRS_WALK_THREADS 512
template <typename TT>
struct TrsWalkParams {
  GkDiaOp<TT> t;
  GkWalkCfg w;
  const float* invd;
  const float* b;
  float* x;
};

extern __shared__ float4 gk_walk_shared[];

template <typename TT, int DIR, int ND, int SW>
__global__ void __launch_bounds__(GK_TRS_WALK_THREADS)
    trs_walk_kernel(const TrsWalkParams<TT> P) {
  const int n = (int)P.t.n;
  const int T = (n + (int)gridDim.x - 1) / (int)gridDim.x;
  const int a = (int)blockIdx.x * T;
  const int len = n - a < T ? n - a : T;
  if (len <= 0) return;
  const float* vec[1] = {P.b};
  float* x = P.x;
  gk_tri_walk<GK_TRS_WALK_THREADS, TT, DIR, ND, SW, 1>(
      P.t, P.w, vec, P.invd, a, len, reinterpret_cast<char*>(gk_walk_shared),
      [](const float* v, int, int e) { return v[e]; }, [](int, float) {},
      [x](int row, float v) { x[row] = v; });
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

// Rows a thread of K23's walk kernel loads at once in the passes outside
// the walks, and its block: 1024 threads (512 ran K23 20% slower on the
// H100: its passes outside the walks want the warps, PERF.md section 6).
#define GK_WALK_ROWS 4
#define GK_CG_ILU_WALK_THREADS 1024
#define GK_CG_ILU_WALK_WARPS (GK_CG_ILU_WALK_THREADS / 32)

// K23 on the walk: the same semantics in four grid barriers an iteration
// (see the header), in blocks of GK_CG_ILU_WALK_THREADS threads; L walks forward,
// U backward.  x += alpha p joins the p pass.  Block b owns the rows [b T, b T + T), T = ceil(n /
// gridDim.x), in both walks and in every loop over its own rows; q = A p
// alone loops over all rows.  r alternates between r[0] and r[1]: the L
// walk of iteration it reads r[it & 1] (and q) on its halo rows and writes
// r[(it + 1) & 1] on the block's own rows.  The r returned is copied into
// r[0] at the end.

template <typename TA, typename TT>
struct CgIluWalkParams {
  GkDiaOp<TA> a;
  GkDiaOp<TT> l;
  GkDiaOp<TT> u;
  GkWalkCfg wl;
  GkWalkCfg wu;
  const float* invdl;
  const float* invdu;
  long long n;
  const float* r0;
  const float* x0;
  const float* tol_sq;
  int max_iters;
  int implicit;
  float* x;
  float* r[2];
  float* p;  // read across rows by A p
  float* q;  // read across rows by the L walk
  float* z;
  float* mid;  // L^{-1} r, read across rows by the U walk
  double* part;  // 3 * gridDim.x per-block partial sums
  int* it_out;
  float* mon_out;
  int* conv_out;
};

template <typename TA, typename TT, int ND, int SW>
__global__ void __launch_bounds__(GK_CG_ILU_WALK_THREADS)
    cg_ilu_walk_kernel(const CgIluWalkParams<TA, TT> P) {
  constexpr int WT = GK_CG_ILU_WALK_THREADS;
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[1][GK_CG_ILU_WALK_WARPS];
  __shared__ double sh2[2][GK_CG_ILU_WALK_WARPS];
  __shared__ double bc1[1];
  __shared__ double bc2[2];
  char* smem = reinterpret_cast<char*>(gk_walk_shared);
  const long long n = P.n;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int T = ((int)n + (int)gridDim.x - 1) / (int)gridDim.x;
  const int a = (int)blockIdx.x * T;
  const int len = (int)n - a < T ? ((int)n - a > 0 ? (int)n - a : 0) : T;
  const int end = a + len;
  double* part1 = P.part;              // [gridDim.x]     p.q
  double* part2 = P.part + gridDim.x;  // [gridDim.x][2]  r.z, r.r
  float* mid = P.mid;
  float* z = P.z;
  auto same = [](const float* v, int, int e) { return v[e]; };
  auto none = [](int, float) {};
  auto to_mid = [mid](int row, float v) { mid[row] = v; };
  auto to_z = [z](int row, float v) { z[row] = v; };

  // z = M r0: mid = L^{-1} r0, z = U^{-1} mid; p = z; r.z, r.r
  float* r0buf = P.r[0];
  float* r1buf = P.r[1];
  for (int i = a + threadIdx.x; i < end; i += blockDim.x) {
    P.x[i] = P.x0[i];
    r0buf[i] = P.r0[i];
  }
  if (len > 0) {
    const float* src[1] = {P.r0};
    gk_tri_walk<WT, TT, 1, ND, SW, 1>(P.l, P.wl, src, P.invdl, a, len, smem, same, none, to_mid);
  }
  grid.sync();
  if (len > 0) {
    const float* src[1] = {mid};
    gk_tri_walk<WT, TT, -1, ND, SW, 1>(P.u, P.wu, src, P.invdu, a, len, smem, same, none, to_z);
  }
  double tot2[2];
  {
    double s[2] = {0.0, 0.0};
    for (int i = a + threadIdx.x; i < end; i += blockDim.x) {
      const float ri = P.r0[i];
      const float zi = z[i];
      P.p[i] = zi;
      s[0] += (double)ri * zi;
      s[1] += (double)ri * ri;
    }
    block_partial<2>(s, part2, sh2);
  }
  grid.sync();
  grid_total_batch<2, 4>(part2, 2, 1, 2, tot2, sh2, bc2);
  float rho = (float)tot2[0];

  const float tol_sq = *P.tol_sq;
  int it = 0;
  float mon = CUDART_INF_F;
  while (it < P.max_iters && !(mon <= tol_sq)) {
    // q = A p, partial p.q: GK_WALK_ROWS rows a thread at once, each summed
    // as gk_dia_row sums it
    {
      double s[1] = {0.0};
      for (long long i0 = t0; i0 < n; i0 += GK_WALK_ROWS * stride) {
        float acc[GK_WALK_ROWS], pv[GK_WALK_ROWS];
#pragma unroll
        for (int u = 0; u < GK_WALK_ROWS; ++u) {
          acc[u] = 0.f;
          pv[u] = i0 + u * stride < n ? __ldcg(P.p + i0 + u * stride) : 0.f;
        }
        for (int d = 0; d < P.a.offs.nd; ++d) {
#pragma unroll
          for (int u = 0; u < GK_WALK_ROWS; ++u) {
            const long long i = i0 + u * stride;
            const long long j = i + P.a.offs.off[d];
            if (i < n && j >= 0 && j < n)
              acc[u] += GkAcc<float>::load(P.a.diags[d * n + i]) * __ldcg(P.p + j);
          }
        }
#pragma unroll
        for (int u = 0; u < GK_WALK_ROWS; ++u) {
          if (i0 + u * stride < n) {
            P.q[i0 + u * stride] = acc[u];
            s[0] += (double)pv[u] * acc[u];
          }
        }
      }
      block_partial<1>(s, part1, sh1);
    }
    grid.sync();
    double tot1[1];
    grid_total_batch<1, 4>(part1, 1, 1, 1, tot1, sh1, bc1);
    const float alpha = gk_sdiv(rho, (float)tot1[0]);

    // the L walk on r_new = r - alpha q, which writes r_new and sums r.r on
    // the own rows, and mid = L^{-1} r_new (x += alpha p waits for the p pass)
    const float* r_old = (it & 1) ? r1buf : r0buf;
    float* r_new = (it & 1) ? r0buf : r1buf;
    double rr = 0.0;
    if (len > 0) {
      const float* src[2] = {r_old, P.q};
      gk_tri_walk<WT, TT, 1, ND, SW, 2>(
          P.l, P.wl, src, P.invdl, a, len, smem,
          [alpha](const float* v, int C, int e) { return v[e] - alpha * v[C + e]; },
          [r_new, &rr](int row, float ri) {
            r_new[row] = ri;
            rr += (double)ri * ri;
          },
          to_mid);
    }
    grid.sync();
    // z = U^{-1} mid, partials r.z, r.r
    if (len > 0) {
      const float* src[1] = {mid};
      gk_tri_walk<WT, TT, -1, ND, SW, 1>(P.u, P.wu, src, P.invdu, a, len, smem, same, none, to_z);
    }
    {
      double s[2] = {0.0, rr};
      for (int i0 = a + threadIdx.x; i0 < end; i0 += GK_WALK_ROWS * WT) {
        float rv[GK_WALK_ROWS], zv[GK_WALK_ROWS];
#pragma unroll
        for (int u = 0; u < GK_WALK_ROWS; ++u) {
          const int i = i0 + u * WT;
          rv[u] = i < end ? __ldcg(r_new + i) : 0.f;
          zv[u] = i < end ? __ldcg(z + i) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < GK_WALK_ROWS; ++u)
          if (i0 + u * WT < end) s[0] += (double)rv[u] * zv[u];
      }
      block_partial<2>(s, part2, sh2);
    }
    grid.sync();
    grid_total_batch<2, 4>(part2, 2, 1, 2, tot2, sh2, bc2);
    const float rho_new = (float)tot2[0];
    const float beta = gk_sdiv(rho_new, rho);

    // x += alpha p, p = z + beta p
    for (int i0 = a + threadIdx.x; i0 < end; i0 += GK_WALK_ROWS * WT) {
      float xv[GK_WALK_ROWS], pv[GK_WALK_ROWS], zv[GK_WALK_ROWS];
#pragma unroll
      for (int u = 0; u < GK_WALK_ROWS; ++u) {
        const int i = i0 + u * WT;
        xv[u] = i < end ? P.x[i] : 0.f;
        pv[u] = i < end ? __ldcg(P.p + i) : 0.f;
        zv[u] = i < end ? __ldcg(z + i) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < GK_WALK_ROWS; ++u) {
        const int i = i0 + u * WT;
        if (i < end) {
          P.x[i] = xv[u] + alpha * pv[u];
          P.p[i] = zv[u] + beta * pv[u];
        }
      }
    }
    mon = P.implicit ? fabsf(rho) : (float)tot2[1];
    rho = rho_new;
    ++it;
    grid.sync();
  }

  if (it & 1) {
    for (int i = a + threadIdx.x; i < end; i += blockDim.x) r0buf[i] = __ldcg(r1buf + i);
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

// K24 on the walk: the same semantics in seven grid barriers an iteration
// where the barrier routine runs 5 + 2 (sweeps_l + sweeps_u), in blocks of
// GK_CG_ILU_WALK_THREADS threads, each triangle read once a walk
// (tri_walk.cuh); L walks forward, U backward.  Block b owns the rows [b T, b T + T), T =
// ceil(n / gridDim.x), in every walk and in every pass; the products gather
// their source with plain loads after the barrier that follows the walk
// which wrote it.  An iteration:
//   1: the L walk forms p_new = r + beta (p_old - omega v) on every row it
//      reads, halo included, from r, p_old and v staged in its ring, writes
//      p_new and mid = L^{-1} p_new on the own rows;
//   2: the U walk, y = U^{-1} mid;
//   3: v = A y, partial rr.v; fold -> alpha;
//   4: the L walk forms s = r - alpha v (K23's fusion), writes s and
//      mid = L^{-1} s on the own rows and sums s.s;
//   5: the U walk, z = U^{-1} mid;
//   6: t = A z, partials t.s and t.t; fold with s.s -> omega (0 where the
//      half step converged, and carried as 1);
//   7: x = (x + alpha y) + omega z (the two updates of the barrier routine
//      in one pass, the same two roundings), r = s - omega t, partials rr.r
//      and r.r; fold -> the next rho and the monitor.
// Another block's halo reads p_old while a block writes p_new, so p
// alternates between p[0] and p[1]: iteration it reads p[it & 1].  r, v
// and mid are written only in passes after the last walk that reads them
// across rows.  Where step 1's three staged vectors do not fit a block's
// shared memory and step 4's two do (PSPLIT, the generic kernel only), p_new
// is formed in a pass of its own and the L walk stages it alone: eight
// barriers an iteration.  A dot is a float64 sum of the block's own rows
// (K23's order): each thread its rows in order, the block folded
// (coop.cuh block_sum), the blocks in block order.

template <typename TA, typename TT>
struct BicgstabIluWalkParams {
  GkDiaOp<TA> a;
  GkDiaOp<TT> l;
  GkDiaOp<TT> u;
  GkWalkCfg wl;
  GkWalkCfg wu;
  const float* invdl;
  const float* invdu;
  long long n;
  const float* r0;
  const float* x0;
  const float* tol_sq;
  int max_iters;
  int implicit;
  float* x;
  float* r;  // read across rows by the L walks
  float* rr;
  float* p[2];  // p_old read across rows by the L walk of step 1
  float* v;     // read across rows by the L walks
  float* s;
  float* t;
  float* y;    // M p, read across rows by A y
  float* z;    // M s, read across rows by A z
  float* mid;  // L^{-1} p or L^{-1} s, read across rows by the U walks
  double* part;  // 7 * gridDim.x per-block partial sums
  int* it_out;
  float* mon_out;
  int* conv_out;
};

// dst = A src on the block's rows [a, end), GK_WALK_ROWS rows a thread a
// trip, each summed as gk_dia_row sums it, with plain gathers of src
// (written before the last grid barrier); dot += other . dst and, with SQ,
// sq += dst . dst, each thread over its rows in order.
template <bool SQ, typename TA>
__device__ __forceinline__ void gk_walk_product(const GkDiaOp<TA>& A, int a, int end,
                                                const float* src, float* dst, const float* other,
                                                double& dot, double& sq) {
  constexpr int R = GK_WALK_ROWS;
  for (int i0 = a + (int)threadIdx.x; i0 < end; i0 += R * (int)blockDim.x) {
    const GkStrideRows<R> rows(i0, blockDim.x, end);
    float av[R], ov[R];
    gk_dia_rows<R>(A.diags, A.offs, A.n, rows, src, av);
#pragma unroll
    for (int k = 0; k < R; ++k) ov[k] = rows.ok[k] ? other[rows.i[k]] : 0.f;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (!rows.ok[k]) continue;
      dst[rows.i[k]] = av[k];
      dot += (double)ov[k] * av[k];
      if (SQ) sq += (double)av[k] * av[k];
    }
  }
}

template <typename TA, typename TT, int ND, int SW, bool PSPLIT>
__global__ void __launch_bounds__(GK_CG_ILU_WALK_THREADS)
    bicgstab_ilu_walk_kernel(const BicgstabIluWalkParams<TA, TT> P) {
  constexpr int WT = GK_CG_ILU_WALK_THREADS;
  constexpr int R = GK_WALK_ROWS;
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[1][GK_CG_ILU_WALK_WARPS];
  __shared__ double sh2[2][GK_CG_ILU_WALK_WARPS];
  __shared__ double sh3[3][GK_CG_ILU_WALK_WARPS];
  __shared__ double bc1[1];
  __shared__ double bc2[2];
  __shared__ double bc3[3];
  char* smem = reinterpret_cast<char*>(gk_walk_shared);
  const int n = (int)P.n;
  const int G = (int)gridDim.x;
  const int T = (n + G - 1) / G;
  const int a = (int)blockIdx.x * T;
  const int len = n - a < T ? (n - a > 0 ? n - a : 0) : T;
  const int end = a + len;
  double* part_a = P.part;          // [G]     r0.r0
  double* part_b = P.part + G;      // [G]     rr.v
  double* part_c = P.part + 2 * G;  // [G][3]  s.s, t.s, t.t
  double* part_d = P.part + 5 * G;  // [G][2]  rr.r, r.r
  float* __restrict__ x = P.x;
  float* r = P.r;
  float* __restrict__ rr = P.rr;
  float* v = P.v;
  float* s = P.s;
  float* t = P.t;
  float* y = P.y;
  float* z = P.z;
  float* mid = P.mid;
  auto same = [](const float* vb, int, int e) { return vb[e]; };
  auto none = [](int, float) {};
  // one lambda type for every store, so that the two U walks are one
  // instantiation of the walk
  auto store = [](float* dst) { return [dst](int row, float val) { dst[row] = val; }; };

  // x = x0, r = rr = r0, p = v = 0; rho = r0.r0
  double tot1[1], tot2[2], tot3[3];
  {
    double acc[1] = {0.0};
    for (int i = a + (int)threadIdx.x; i < end; i += WT) {
      const float ri = P.r0[i];
      x[i] = P.x0[i];
      r[i] = ri;
      rr[i] = ri;
      v[i] = 0.f;
      P.p[0][i] = 0.f;
      acc[0] += (double)ri * ri;
    }
    block_partial<1>(acc, part_a, sh1);
  }
  grid.sync();
  grid_total_batch<1, 4>(part_a, 1, 1, 1, tot1, sh1, bc1);
  float rho_new = (float)tot1[0];
  float rho_old = 1.f, alpha = 1.f, omega = 1.f;

  const float tol_sq = *P.tol_sq;
  int it = 0;
  float mon = CUDART_INF_F;
  while (it < P.max_iters && !(mon <= tol_sq)) {
    const float beta = gk_sdiv(rho_new * alpha, rho_old * omega);
    const float* p_old = P.p[it & 1];
    float* p_new = P.p[(it + 1) & 1];

    // 1: p_new = r + beta (p_old - omega v) and mid = L^{-1} p_new
    if constexpr (PSPLIT) {
      for (int i0 = a + (int)threadIdx.x; i0 < end; i0 += R * WT) {
        const GkStrideRows<R> rows(i0, WT, end);
        float rv[R], pv[R], vv[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const long long i = rows.i[k];
          rv[k] = rows.ok[k] ? r[i] : 0.f;
          pv[k] = rows.ok[k] ? p_old[i] : 0.f;
          vv[k] = rows.ok[k] ? v[i] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < R; ++k)
          if (rows.ok[k]) p_new[rows.i[k]] = rv[k] + beta * (pv[k] - omega * vv[k]);
      }
      grid.sync();
      if (len > 0) {
        const float* src[1] = {p_new};
        gk_tri_walk<WT, TT, 1, ND, SW, 1>(P.l, P.wl, src, P.invdl, a, len, smem, same, none,
                                          store(mid));
      }
    } else if (len > 0) {
      const float* src[3] = {r, p_old, v};
      gk_tri_walk<WT, TT, 1, ND, SW, 3>(
          P.l, P.wl, src, P.invdl, a, len, smem,
          [beta, omega](const float* vb, int C, int e) {
            return vb[e] + beta * (vb[C + e] - omega * vb[2 * C + e]);
          },
          store(p_new), store(mid));
    }
    grid.sync();
    // 2: y = U^{-1} mid
    if (len > 0) {
      const float* src[1] = {mid};
      gk_tri_walk<WT, TT, -1, ND, SW, 1>(P.u, P.wu, src, P.invdu, a, len, smem, same, none,
                                         store(y));
    }
    grid.sync();
    // 3: v = A y, partial rr.v
    {
      double acc[1] = {0.0}, unused = 0.0;
      gk_walk_product<false>(P.a, a, end, y, v, rr, acc[0], unused);
      block_partial<1>(acc, part_b, sh1);
    }
    grid.sync();
    grid_total_batch<1, 4>(part_b, 1, 1, 1, tot1, sh1, bc1);
    const float alpha_new = gk_sdiv(rho_new, (float)tot1[0]);

    // 4: s = r - alpha v, s.s and mid = L^{-1} s
    double ss = 0.0;
    if (len > 0) {
      const float* src[2] = {r, v};
      gk_tri_walk<WT, TT, 1, ND, SW, 2>(
          P.l, P.wl, src, P.invdl, a, len, smem,
          [alpha_new](const float* vb, int C, int e) { return vb[e] - alpha_new * vb[C + e]; },
          [s, &ss](int row, float si) {
            s[row] = si;
            ss += (double)si * si;
          },
          store(mid));
    }
    grid.sync();
    // 5: z = U^{-1} mid
    if (len > 0) {
      const float* src[1] = {mid};
      gk_tri_walk<WT, TT, -1, ND, SW, 1>(P.u, P.wu, src, P.invdu, a, len, smem, same, none,
                                         store(z));
    }
    grid.sync();
    // 6: t = A z, partials s.s, t.s, t.t
    {
      double acc[3] = {ss, 0.0, 0.0};
      gk_walk_product<true>(P.a, a, end, z, t, s, acc[1], acc[2]);
      block_partial<3>(acc, part_c, sh3);
    }
    grid.sync();
    grid_total_batch<3, 4>(part_c, 3, 1, 3, tot3, sh3, bc3);
    const bool half_done = (P.implicit ? fabsf(rho_new) : (float)tot3[0]) <= tol_sq;
    const float omega_new = half_done ? 0.f : gk_sdiv((float)tot3[1], (float)tot3[2]);

    // 7: x = (x + alpha y) + omega z; r = s - omega t; partials rr.r, r.r
    {
      double acc[2] = {0.0, 0.0};
      for (int i0 = a + (int)threadIdx.x; i0 < end; i0 += R * WT) {
        const GkStrideRows<R> rows(i0, WT, end);
        float xv[R], yv[R], zv[R], sv[R], tv[R], rrv[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const long long i = rows.i[k];
          const bool ok = rows.ok[k];
          xv[k] = ok ? x[i] : 0.f;
          yv[k] = ok ? y[i] : 0.f;
          zv[k] = ok ? z[i] : 0.f;
          sv[k] = ok ? s[i] : 0.f;
          tv[k] = ok ? t[i] : 0.f;
          rrv[k] = ok ? rr[i] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < R; ++k) {
          if (!rows.ok[k]) continue;
          const long long i = rows.i[k];
          const float xa = xv[k] + alpha_new * yv[k];
          x[i] = xa + omega_new * zv[k];
          const float ri = sv[k] - omega_new * tv[k];
          r[i] = ri;
          acc[0] += (double)rrv[k] * ri;
          acc[1] += (double)ri * ri;
        }
      }
      block_partial<2>(acc, part_d, sh2);
    }
    grid.sync();
    grid_total_batch<2, 4>(part_d, 2, 1, 2, tot2, sh2, bc2);
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
// The kernels compiled for each shape of gk_walk_unrolled, 192 of them, take
// most of the library's build, so nvcc compiles them in translation units of
// their own, in parallel (ginkgo_tpu_torch/_build.py PARTS): GK_PART = 1 .. 4
// K23's for one (A, T) dtype pair each (f32 f32, f32 bf16, bf16 f32, bf16
// bf16), 5 K22's, 6 .. 9 K24's for one dtype pair each, in the order of 1 ..
// 4.  Such a part defines only the getter of its kernels; part 0 holds every
// other kernel and every entry point.

#ifndef GK_PART
#define GK_PART 0
#endif

// Entry I of a getter's table: nd = I / GK_WALK_MAX_SWEEPS + 1, sweeps = I %
// GK_WALK_MAX_SWEEPS + 1.
constexpr int gk_walk_shape(int nd, int sweeps) {
  return (nd - 1) * GK_WALK_MAX_SWEEPS + sweeps - 1;
}

// K22's kernel for triangles of t_dtype in the direction dir, compiled for
// the shape (gk_walk_shape).
extern "C" const void* trs_walk_shape_kernel(int t_dtype, int dir, int shape);
// K23's kernel compiled for the shape, for the dtype pair of part 1 .. 4.
extern "C" const void* cg_ilu_walk_shape_kernel_1(int shape);
extern "C" const void* cg_ilu_walk_shape_kernel_2(int shape);
extern "C" const void* cg_ilu_walk_shape_kernel_3(int shape);
extern "C" const void* cg_ilu_walk_shape_kernel_4(int shape);
// K24's kernel compiled for the shape, for the dtype pair of part 6 .. 9.
extern "C" const void* bicgstab_ilu_walk_shape_kernel_6(int shape);
extern "C" const void* bicgstab_ilu_walk_shape_kernel_7(int shape);
extern "C" const void* bicgstab_ilu_walk_shape_kernel_8(int shape);
extern "C" const void* bicgstab_ilu_walk_shape_kernel_9(int shape);

#if GK_PART != 0
constexpr auto GK_WALK_SHAPES =
    std::make_integer_sequence<int, GK_WALK_MAX_ND * GK_WALK_MAX_SWEEPS>{};

template <typename TT, int DIR, int... I>
static const void* trs_walk_unrolled(int shape, std::integer_sequence<int, I...>) {
  static const void* const table[] = {(const void*)trs_walk_kernel<
      TT, DIR, I / GK_WALK_MAX_SWEEPS + 1, I % GK_WALK_MAX_SWEEPS + 1>...};
  return table[shape];
}

template <typename TA, typename TT, int... I>
static const void* cg_ilu_walk_unrolled(int shape, std::integer_sequence<int, I...>) {
  static const void* const table[] = {(const void*)cg_ilu_walk_kernel<
      TA, TT, I / GK_WALK_MAX_SWEEPS + 1, I % GK_WALK_MAX_SWEEPS + 1>...};
  return table[shape];
}

template <typename TA, typename TT, int... I>
static const void* bicgstab_ilu_walk_unrolled(int shape, std::integer_sequence<int, I...>) {
  static const void* const table[] = {(const void*)bicgstab_ilu_walk_kernel<
      TA, TT, I / GK_WALK_MAX_SWEEPS + 1, I % GK_WALK_MAX_SWEEPS + 1, false>...};
  return table[shape];
}
#endif

#if GK_PART == 5
extern "C" const void* trs_walk_shape_kernel(int t_dtype, int dir, int shape) {
  if (t_dtype == GK_F32)
    return dir > 0 ? trs_walk_unrolled<float, 1>(shape, GK_WALK_SHAPES)
                   : trs_walk_unrolled<float, -1>(shape, GK_WALK_SHAPES);
  return dir > 0 ? trs_walk_unrolled<__nv_bfloat16, 1>(shape, GK_WALK_SHAPES)
                 : trs_walk_unrolled<__nv_bfloat16, -1>(shape, GK_WALK_SHAPES);
}
#elif GK_PART >= 1 && GK_PART <= 4
#define GK_CAT2(a, b) a##b
#define GK_CAT(a, b) GK_CAT2(a, b)
extern "C" const void* GK_CAT(cg_ilu_walk_shape_kernel_, GK_PART)(int shape) {
  using TA = std::conditional_t<GK_PART <= 2, float, __nv_bfloat16>;
  using TT = std::conditional_t<GK_PART % 2 == 1, float, __nv_bfloat16>;
  return cg_ilu_walk_unrolled<TA, TT>(shape, GK_WALK_SHAPES);
}
#elif GK_PART >= 6 && GK_PART <= 9
#define GK_CAT2(a, b) a##b
#define GK_CAT(a, b) GK_CAT2(a, b)
extern "C" const void* GK_CAT(bicgstab_ilu_walk_shape_kernel_, GK_PART)(int shape) {
  using TA = std::conditional_t<GK_PART <= 7, float, __nv_bfloat16>;
  using TT = std::conditional_t<GK_PART % 2 == 0, float, __nv_bfloat16>;
  return bicgstab_ilu_walk_unrolled<TA, TT>(shape, GK_WALK_SHAPES);
}
#endif

#if GK_PART == 0
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

// ---------------------------------------------------------------------------
// The plans and the walk route's entry points (K22 and K23).  A plan is the
// route a solve takes and its launch: GK_PLAN_HEAD figures, then
// GK_PLAN_WALK for each walk of the solve (zeros on the barrier route), in
// the order of ops/tri_walk.py PLAN_FIELDS and WALK_FIELDS.  The walk is
// derived from the offsets and the sweep count here alone (gk_walk_plan),
// by the plan and again by the entry point that launches it.

#define GK_PLAN_HEAD 9
#define GK_PLAN_WALK 5

// The plan's head: route (1 the walk, 0 the barrier routine), blocks,
// threads a block, rows a walk step, dynamic shared memory a block, blocks
// an SM, registers a thread, grid barriers (K22 a launch, K23 an
// iteration), and whether the kernel was compiled for the shape.
static void gk_plan_head(long long* out, int walk, int blocks, int threads, long long smem,
                         const GkOccupancy& o, int barriers, bool unrolled) {
  const long long v[GK_PLAN_HEAD] = {walk,     blocks, threads,  walk ? GK_WALK_CHUNK : 0,
                                     smem,     o.per_sm, o.regs, barriers,
                                     unrolled ? 1 : 0};
  for (int i = 0; i < GK_PLAN_HEAD; ++i) out[i] = v[i];
}

// A walk of the plan: direction, w, level-ring rows, input stages, and the
// interior steps of all blocks.
static void gk_plan_walk(long long* out, const GkWalkCfg& W, long long n, int blocks) {
  const long long v[GK_PLAN_WALK] = {W.dir, W.width, W.ring_rows, W.stages,
                                     gk_walk_interior_steps(W, n, blocks)};
  for (int i = 0; i < GK_PLAN_WALK; ++i) out[i] = v[i];
}

// The barrier routine's plan: the cooperative grid (blocks an SM x SMs).
template <typename Kernel>
static int gk_barrier_plan(Kernel kernel, int barriers, int walks, long long* out) {
  GkOccupancy o;
  int blocks = 0;
  int e = gk_occupancy(kernel, 0, GK_CG_THREADS, &o);
  if (e == 0) e = gk_coop_blocks(kernel, &blocks);
  if (e != 0) return e;
  gk_plan_head(out, 0, blocks, GK_CG_THREADS, 0, o, barriers, false);
  for (int i = 0; i < walks * GK_PLAN_WALK; ++i) out[GK_PLAN_HEAD + i] = 0;
  return 0;
}

// K22's walk, where it takes one: offsets of one sign and at least one
// sweep (at 0 sweeps the barrier routine is one pass with no barrier, and
// beat the walk on the H100, PERF.md section 6).
// K22's walk kernel for a direction, nd diagonals and a sweep count: the
// one compiled for the shape where gk_walk_unrolled, else the one with
// runtime counts.
template <typename TT>
static const void* trs_walk_fn(int dir, int nd, int sweeps) {
  if (!gk_walk_unrolled(nd, sweeps))
    return dir > 0 ? (const void*)trs_walk_kernel<TT, 1, 0, 0>
                   : (const void*)trs_walk_kernel<TT, -1, 0, 0>;
  return trs_walk_shape_kernel(std::is_same<TT, float>::value ? GK_F32 : GK_BF16, dir,
                               gk_walk_shape(nd, sweeps));
}

template <typename TT>
static bool trs_walk(const long long* offsets, int nd, long long n, int sweeps, GkWalkCfg* W,
                     long long* smem) {
  if (sweeps < 1 || !gk_walk_plan(offsets, nd, n, sweeps, W)) return false;
  *smem = gk_walk_smem(*W, nd, (int)sizeof(TT), 1);
  return true;
}

// K22's plan: the walk where trs_walk takes one and a block of the walk
// fits an SM, else the barrier routine (one grid barrier a sweep).
template <typename TT>
static int trs_plan(const long long* offsets, int nd, long long n, int sweeps, long long* out) {
  GkWalkCfg W;
  long long smem = 0;
  if (trs_walk<TT>(offsets, nd, n, sweeps, &W, &smem)) {
    GkOccupancy o;
    const int e = gk_occupancy(trs_walk_fn<TT>(W.dir, nd, sweeps), smem, GK_TRS_WALK_THREADS, &o);
    if (e != 0) return e;
    if (o.per_sm >= 1) {
      const int blocks = o.per_sm * o.sms;
      gk_plan_head(out, 1, blocks, GK_TRS_WALK_THREADS, smem, o, 0,
                   gk_walk_unrolled(nd, sweeps));
      gk_plan_walk(out + GK_PLAN_HEAD, W, n, blocks);
      return 0;
    }
  }
  return gk_barrier_plan(trs_fused_kernel<TT>, sweeps, 1, out);
}

extern "C" int trs_fused_plan(int t_dtype, const long long* offsets, int nd, long long n,
                              int sweeps, long long* out) {
  if (!gk_nd_ok(nd) || sweeps < 0) return (int)cudaErrorInvalidValue;
  GK_T_DISPATCH(t_dtype, (trs_plan<TT>)(offsets, nd, n, sweeps, out));
}

template <typename TT>
static int trs_walk_launch(const void* diags, const long long* offsets, int nd, long long n,
                           const float* invd, const float* b, int sweeps, float* x, int blocks,
                           void* stream) {
  GkWalkCfg W;
  long long smem = 0;
  if (!trs_walk<TT>(offsets, nd, n, sweeps, &W, &smem)) return (int)cudaErrorInvalidValue;
  TrsWalkParams<TT> P;
  P.t = gk_dia_op<TT>(diags, offsets, nd, n);
  P.w = W;
  P.invd = invd;
  P.b = b;
  P.x = x;
  const void* kernel = trs_walk_fn<TT>(W.dir, nd, sweeps);
  int e = gk_smem_optin(kernel, smem);
  if (e != 0) return e;
  void* args[] = {&P};
  e = (int)cudaLaunchKernel((const void*)kernel, dim3(blocks), dim3(GK_TRS_WALK_THREADS), args,
                            (size_t)smem, (cudaStream_t)stream);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

// K22 on the walk: x ~ T^{-1} b over the strict triangle (nd, n) in
// `blocks` ranges of rows, where trs_fused_plan chose the walk.  invd, b
// and x are 16-byte aligned.
extern "C" int trs_walk_solve(const void* diags, int t_dtype, const long long* offsets, int nd,
                              long long n, const float* invd, const float* b, int sweeps,
                              float* x, int blocks, void* stream) {
  if (!gk_nd_ok(nd) || blocks < 1) return (int)cudaErrorInvalidValue;
  GK_T_DISPATCH(t_dtype, (trs_walk_launch<TT>)(diags, offsets, nd, n, invd, b, sweeps, x, blocks,
                                               stream));
}

// Whether K23's walk kernel is compiled for the shape: both triangles with
// nd diagonals and the same sweep count (an IC's triangles mirror each
// other, as do an ILU's of a structurally symmetric A under one sweep
// count), where gk_walk_unrolled.
static bool cg_ilu_unrolled(int l_nd, int u_nd, int sweeps_l, int sweeps_u) {
  return l_nd == u_nd && sweeps_l == sweeps_u && gk_walk_unrolled(l_nd, sweeps_l);
}

template <typename TA, typename TT>
static const void* cg_ilu_walk_fn(int l_nd, int u_nd, int sweeps_l, int sweeps_u) {
  if (!cg_ilu_unrolled(l_nd, u_nd, sweeps_l, sweeps_u))
    return (const void*)cg_ilu_walk_kernel<TA, TT, 0, 0>;
  const int shape = gk_walk_shape(l_nd, sweeps_l);
  if (std::is_same<TA, float>::value)
    return std::is_same<TT, float>::value ? cg_ilu_walk_shape_kernel_1(shape)
                                          : cg_ilu_walk_shape_kernel_2(shape);
  return std::is_same<TT, float>::value ? cg_ilu_walk_shape_kernel_3(shape)
                                        : cg_ilu_walk_shape_kernel_4(shape);
}

// K23's walks, where it takes them: L's forward and U's backward; smem the
// larger of the two (an iteration's L walk stages r and q, the U walk mid).
template <typename TT>
static bool cg_ilu_walks(const long long* l_offsets, int l_nd, const long long* u_offsets,
                         int u_nd, long long n, int sweeps_l, int sweeps_u, GkWalkCfg* wl,
                         GkWalkCfg* wu, long long* smem) {
  if (!gk_walk_plan(l_offsets, l_nd, n, sweeps_l, wl) ||
      !gk_walk_plan(u_offsets, u_nd, n, sweeps_u, wu) || wl->dir != 1 || wu->dir != -1)
    return false;
  const long long sl = gk_walk_smem(*wl, l_nd, (int)sizeof(TT), 2);
  const long long su = gk_walk_smem(*wu, u_nd, (int)sizeof(TT), 1);
  *smem = sl > su ? sl : su;
  return true;
}

// K23's plan: the walks where cg_ilu_walks takes them and a block fits an
// SM (four grid barriers an iteration), else the barrier routine (3 +
// sweeps_l + sweeps_u).
template <typename TA, typename TT>
static int cg_ilu_plan(const long long* l_offsets, int l_nd, const long long* u_offsets,
                       int u_nd, long long n, int sweeps_l, int sweeps_u, long long* out) {
  GkWalkCfg wl, wu;
  long long smem = 0;
  if (cg_ilu_walks<TT>(l_offsets, l_nd, u_offsets, u_nd, n, sweeps_l, sweeps_u, &wl, &wu,
                       &smem)) {
    GkOccupancy o;
    const int e = gk_occupancy(cg_ilu_walk_fn<TA, TT>(l_nd, u_nd, sweeps_l, sweeps_u), smem,
                               GK_CG_ILU_WALK_THREADS, &o);
    if (e != 0) return e;
    if (o.per_sm >= 1) {
      const int blocks = o.per_sm * o.sms;
      gk_plan_head(out, 1, blocks, GK_CG_ILU_WALK_THREADS, smem, o, 4,
                   cg_ilu_unrolled(l_nd, u_nd, sweeps_l, sweeps_u));
      gk_plan_walk(out + GK_PLAN_HEAD, wl, n, blocks);
      gk_plan_walk(out + GK_PLAN_HEAD + GK_PLAN_WALK, wu, n, blocks);
      return 0;
    }
  }
  return gk_barrier_plan(cg_ilu_fused_kernel<TA, TT>, 3 + sweeps_l + sweeps_u, 2, out);
}

extern "C" int cg_ilu_fused_plan(int a_dtype, int t_dtype, const long long* l_offsets, int l_nd,
                                 const long long* u_offsets, int u_nd, long long n, int sweeps_l,
                                 int sweeps_u, long long* out) {
  if (!gk_nd_ok(l_nd) || !gk_nd_ok(u_nd) || sweeps_l < 0 || sweeps_u < 0)
    return (int)cudaErrorInvalidValue;
  GK_AT_DISPATCH(a_dtype, t_dtype,
                 (cg_ilu_plan<TA, TT>)(l_offsets, l_nd, u_offsets, u_nd, n, sweeps_l, sweeps_u,
                                       out));
}

template <typename TA, typename TT>
static int cg_ilu_walk_launch(const void* a_diags, const long long* a_offsets, int a_nd,
                              const void* l_diags, const long long* l_offsets, int l_nd,
                              const void* u_diags, const long long* u_offsets, int u_nd,
                              long long n, const float* invdl, const float* invdu,
                              const float* r0, const float* x0, const float* tol_sq,
                              int max_iters, int implicit, int sweeps_l, int sweeps_u,
                              float* const* vecs, double* part, int blocks, int* it_out,
                              float* mon_out, int* conv_out, void* stream) {
  GkWalkCfg wl, wu;
  long long smem = 0;
  if (!cg_ilu_walks<TT>(l_offsets, l_nd, u_offsets, u_nd, n, sweeps_l, sweeps_u, &wl, &wu,
                        &smem))
    return (int)cudaErrorInvalidValue;
  CgIluWalkParams<TA, TT> P;
  P.a = gk_dia_op<TA>(a_diags, a_offsets, a_nd, n);
  P.l = gk_dia_op<TT>(l_diags, l_offsets, l_nd, n);
  P.u = gk_dia_op<TT>(u_diags, u_offsets, u_nd, n);
  P.wl = wl;
  P.wu = wu;
  P.invdl = invdl;
  P.invdu = invdu;
  P.n = n;
  P.r0 = r0;
  P.x0 = x0;
  P.tol_sq = tol_sq;
  P.max_iters = max_iters;
  P.implicit = implicit;
  P.x = vecs[0];
  P.r[0] = vecs[1];
  P.r[1] = vecs[2];
  P.p = vecs[3];
  P.q = vecs[4];
  P.z = vecs[5];
  P.mid = vecs[6];
  P.part = part;
  P.it_out = it_out;
  P.mon_out = mon_out;
  P.conv_out = conv_out;
  const void* kernel = cg_ilu_walk_fn<TA, TT>(l_nd, u_nd, sweeps_l, sweeps_u);
  const int e = gk_smem_optin(kernel, smem);
  if (e != 0) return e;
  return gk_coop_launch(kernel, P, blocks, stream, (size_t)smem, GK_CG_ILU_WALK_THREADS);
}

// K23 on the walk: ILU-preconditioned CG on a square Dia A to the stop
// test, where cg_ilu_fused_plan chose the walks.  vecs: 7 float32 (n,)
// buffers x, r, r', p, q, z, mid, 16-byte aligned, as are r0, invdl and
// invdu; r returns in the second.
extern "C" int cg_ilu_walk_solve(
    const void* a_diags, int a_dtype, const long long* a_offsets, int a_nd,
    const void* l_diags, const long long* l_offsets, int l_nd, const void* u_diags,
    const long long* u_offsets, int u_nd, int t_dtype, long long n, const float* invdl,
    const float* invdu, const float* r0, const float* x0, const float* tol_sq, int max_iters,
    int sweeps_l, int sweeps_u, int implicit, float* const* vecs, double* part, int blocks,
    int* it_out, float* mon_out, int* conv_out, void* stream) {
  if (!gk_nd_ok(a_nd) || !gk_nd_ok(l_nd) || !gk_nd_ok(u_nd) || max_iters < 0 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  GK_AT_DISPATCH(a_dtype, t_dtype,
                 (cg_ilu_walk_launch<TA, TT>)(a_diags, a_offsets, a_nd, l_diags, l_offsets,
                                              l_nd, u_diags, u_offsets, u_nd, n, invdl, invdu,
                                              r0, x0, tol_sq, max_iters, implicit, sweeps_l,
                                              sweeps_u, vecs, part, blocks, it_out, mon_out,
                                              conv_out, stream));
}

// K24's walk kernel for the shapes of L and U: the one compiled for them
// where both triangles have nd diagonals and one sweep count
// (cg_ilu_unrolled), else the one with runtime counts; PSPLIT (p formed in
// a pass of its own) only with runtime counts.
template <typename TA, typename TT>
static const void* bicgstab_ilu_walk_fn(int l_nd, int u_nd, int sweeps_l, int sweeps_u,
                                        bool psplit) {
  if (psplit) return (const void*)bicgstab_ilu_walk_kernel<TA, TT, 0, 0, true>;
  if (!cg_ilu_unrolled(l_nd, u_nd, sweeps_l, sweeps_u))
    return (const void*)bicgstab_ilu_walk_kernel<TA, TT, 0, 0, false>;
  const int shape = gk_walk_shape(l_nd, sweeps_l);
  if (std::is_same<TA, float>::value)
    return std::is_same<TT, float>::value ? bicgstab_ilu_walk_shape_kernel_6(shape)
                                          : bicgstab_ilu_walk_shape_kernel_7(shape);
  return std::is_same<TT, float>::value ? bicgstab_ilu_walk_shape_kernel_8(shape)
                                        : bicgstab_ilu_walk_shape_kernel_9(shape);
}

// K24's walks, where it takes them: both sides with at least one sweep, L's
// offsets all negative and U's all positive.  smem: the shared memory of
// the largest walk, with step 1 staging three vectors (r, p_old and v) or,
// psplit, one (step 4 then stages the most, r and v).
template <typename TT>
static bool bicgstab_ilu_walks(const long long* l_offsets, int l_nd, const long long* u_offsets,
                               int u_nd, long long n, int sweeps_l, int sweeps_u, bool psplit,
                               GkWalkCfg* wl, GkWalkCfg* wu, long long* smem) {
  if (sweeps_l < 1 || sweeps_u < 1 || !gk_walk_plan(l_offsets, l_nd, n, sweeps_l, wl) ||
      !gk_walk_plan(u_offsets, u_nd, n, sweeps_u, wu) || wl->dir != 1 || wu->dir != -1)
    return false;
  const long long sl = gk_walk_smem(*wl, l_nd, (int)sizeof(TT), psplit ? 2 : 3);
  const long long su = gk_walk_smem(*wu, u_nd, (int)sizeof(TT), 1);
  *smem = sl > su ? sl : su;
  return true;
}

// K24's plan: the walks where bicgstab_ilu_walks takes them and a block fits
// an SM (seven grid barriers an iteration; eight where only the form with
// p's own pass fits, route 2), else the barrier routine (5 + 2 (sweeps_l +
// sweeps_u)).
template <typename TA, typename TT>
static int bicgstab_ilu_plan(const long long* l_offsets, int l_nd, const long long* u_offsets,
                             int u_nd, long long n, int sweeps_l, int sweeps_u, long long* out) {
  for (int psplit = 0; psplit <= 1; ++psplit) {
    GkWalkCfg wl, wu;
    long long smem = 0;
    if (!bicgstab_ilu_walks<TT>(l_offsets, l_nd, u_offsets, u_nd, n, sweeps_l, sweeps_u,
                                psplit != 0, &wl, &wu, &smem))
      break;
    GkOccupancy o;
    const int e = gk_occupancy(
        bicgstab_ilu_walk_fn<TA, TT>(l_nd, u_nd, sweeps_l, sweeps_u, psplit != 0), smem,
        GK_CG_ILU_WALK_THREADS, &o);
    if (e != 0) return e;
    if (o.per_sm >= 1) {
      const int blocks = o.per_sm * o.sms;
      gk_plan_head(out, 1 + psplit, blocks, GK_CG_ILU_WALK_THREADS, smem, o, 7 + psplit,
                   !psplit && cg_ilu_unrolled(l_nd, u_nd, sweeps_l, sweeps_u));
      gk_plan_walk(out + GK_PLAN_HEAD, wl, n, blocks);
      gk_plan_walk(out + GK_PLAN_HEAD + GK_PLAN_WALK, wu, n, blocks);
      return 0;
    }
  }
  return gk_barrier_plan(bicgstab_ilu_fused_kernel<TA, TT>, 5 + 2 * (sweeps_l + sweeps_u), 2,
                         out);
}

extern "C" int bicgstab_ilu_fused_plan(int a_dtype, int t_dtype, const long long* l_offsets,
                                       int l_nd, const long long* u_offsets, int u_nd,
                                       long long n, int sweeps_l, int sweeps_u, long long* out) {
  if (!gk_nd_ok(l_nd) || !gk_nd_ok(u_nd) || sweeps_l < 0 || sweeps_u < 0)
    return (int)cudaErrorInvalidValue;
  GK_AT_DISPATCH(a_dtype, t_dtype,
                 (bicgstab_ilu_plan<TA, TT>)(l_offsets, l_nd, u_offsets, u_nd, n, sweeps_l,
                                             sweeps_u, out));
}

template <typename TA, typename TT>
static int bicgstab_ilu_walk_launch(const void* a_diags, const long long* a_offsets, int a_nd,
                                    const void* l_diags, const long long* l_offsets, int l_nd,
                                    const void* u_diags, const long long* u_offsets, int u_nd,
                                    long long n, const float* invdl, const float* invdu,
                                    const float* r0, const float* x0, const float* tol_sq,
                                    int max_iters, int implicit, int sweeps_l, int sweeps_u,
                                    int psplit, float* const* vecs, double* part, int blocks,
                                    int* it_out, float* mon_out, int* conv_out, void* stream) {
  GkWalkCfg wl, wu;
  long long smem = 0;
  if (!bicgstab_ilu_walks<TT>(l_offsets, l_nd, u_offsets, u_nd, n, sweeps_l, sweeps_u,
                              psplit != 0, &wl, &wu, &smem))
    return (int)cudaErrorInvalidValue;
  BicgstabIluWalkParams<TA, TT> P;
  P.a = gk_dia_op<TA>(a_diags, a_offsets, a_nd, n);
  P.l = gk_dia_op<TT>(l_diags, l_offsets, l_nd, n);
  P.u = gk_dia_op<TT>(u_diags, u_offsets, u_nd, n);
  P.wl = wl;
  P.wu = wu;
  P.invdl = invdl;
  P.invdu = invdu;
  P.n = n;
  P.r0 = r0;
  P.x0 = x0;
  P.tol_sq = tol_sq;
  P.max_iters = max_iters;
  P.implicit = implicit;
  P.x = vecs[0];
  P.r = vecs[1];
  P.rr = vecs[2];
  P.p[0] = vecs[3];
  P.p[1] = vecs[4];
  P.v = vecs[5];
  P.s = vecs[6];
  P.t = vecs[7];
  P.y = vecs[8];
  P.z = vecs[9];
  P.mid = vecs[10];
  P.part = part;
  P.it_out = it_out;
  P.mon_out = mon_out;
  P.conv_out = conv_out;
  const void* kernel = bicgstab_ilu_walk_fn<TA, TT>(l_nd, u_nd, sweeps_l, sweeps_u, psplit != 0);
  const int e = gk_smem_optin(kernel, smem);
  if (e != 0) return e;
  return gk_coop_launch(kernel, P, blocks, stream, (size_t)smem, GK_CG_ILU_WALK_THREADS);
}

// K24 on the walk: ILU right-preconditioned BiCGSTAB on a square Dia A to
// the stop test, where bicgstab_ilu_fused_plan chose the walks (psplit: its
// route 2).  vecs: 11 float32 (n,) buffers x, r, rr, p, p', v, s, t, y, z,
// mid, 16-byte aligned, as are invdl and invdu.
extern "C" int bicgstab_ilu_walk_solve(
    const void* a_diags, int a_dtype, const long long* a_offsets, int a_nd,
    const void* l_diags, const long long* l_offsets, int l_nd, const void* u_diags,
    const long long* u_offsets, int u_nd, int t_dtype, long long n, const float* invdl,
    const float* invdu, const float* r0, const float* x0, const float* tol_sq, int max_iters,
    int sweeps_l, int sweeps_u, int implicit, int psplit, float* const* vecs, double* part,
    int blocks, int* it_out, float* mon_out, int* conv_out, void* stream) {
  if (!gk_nd_ok(a_nd) || !gk_nd_ok(l_nd) || !gk_nd_ok(u_nd) || max_iters < 0 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  GK_AT_DISPATCH(a_dtype, t_dtype,
                 (bicgstab_ilu_walk_launch<TA, TT>)(a_diags, a_offsets, a_nd, l_diags,
                                                    l_offsets, l_nd, u_diags, u_offsets, u_nd, n,
                                                    invdl, invdu, r0, x0, tol_sq, max_iters,
                                                    implicit, sweeps_l, sweeps_u, psplit, vecs,
                                                    part, blocks, it_out, mon_out, conv_out,
                                                    stream));
}

#endif  // GK_PART == 0
