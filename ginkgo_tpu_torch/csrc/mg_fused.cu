// Fused algebraic multigrid in persistent cooperative kernels: kernels K25
// (mg_vcycle), K26 (mg_cg_fused), K27 (mg_solve_fused) and K28
// (mg_bicgstab_fused) of the PyTorch port, which share one device routine,
// gk_mg_cycle.
//
// Replaces:
//   - K25: ginkgo_tpu/ops/pallas_mg.py mg_vmem_vcycle (_mg_kernel, :609;
//     the cycle _vcycle_refs, :268): one V/W/F/K cycle over an all-Dia
//     hierarchy with damped-Jacobi smoothing, stride-pair transfers and a
//     dense coarse inverse;
//   - K26: mg_cg_vmem_solve (_mg_cg_kernel, :718): CG or FCG with
//     z = one cycle from zero on r;
//   - K27: mg_vmem_solve (_mg_solve_kernel, :962): cycles from x0 to the
//     stop test on the true residual;
//   - K28: mg_bicgstab_vmem_solve (_bicgstab_mg_kernel, :1109): right-
//     preconditioned BiCGSTAB with M one cycle from zero.
//
// What bounds them on the H100: bytes, and at the coarse levels the grid
// barriers.  A pass streams one level's diagonals and a few vectors; the
// levels halve, so a cycle moves about twice level 0's traffic, but every
// pass ends with a grid barrier whatever its size.
//
// What the design does about it.  The TPU kernel unrolls the cycle's
// recursion at trace time.  Here ops/mg.py compiles it on the host into a
// pass list (op, level, src, dst; a relaxation factor each) that
// gk_mg_cycle walks, one loop over the level's rows and a grid barrier per
// pass, except the K-cycle's JUMP (kcycle_check_stop), a branch every block
// takes alike from the same float64 sums.  A smoothing sweep reads x
// across rows, so it writes the level's other x buffer (ping-pong, the
// host tracks where x is); the residual is computed inside the restriction
// pass at the two fine rows of each coarse row, so no residual vector is
// stored.  Two pairs of passes run as one (ops/mg.fuse_passes): the first
// sweep from zero with the restriction after it (MG_RESTRICT_ZERO: the
// restriction forms x = w dinv b at each column it gathers and writes x on
// its fine rows), and the prolongation with the sweep after it
// (MG_PROLONG_SMOOTH: the sweep forms x + x_c[p(j)] at each column it
// gathers), so a 12-level V(1,1) cycle takes 25 passes and barriers where
// it took 49, each element through the same float operations.  The index
// maps of the transfers divide by S and 2S with a multiply-high (MgDiv),
// rows in 32 bits.  A pass over a level of GK_MG_ND diagonals is compiled
// for that count (offsets in registers, a row's loads unrolled); the
// kernels are held at GK_MG_MIN_BLOCKS blocks an SM.  Level data live in
// device memory: a level table (pointers, rows, diagonal count, stride;
// MgLevel below, mirrored by ops/mg.py) and the offsets.  Level 0's rhs and
// x buffers come with each launch, so the solvers point the cycle at r, p
// or s without a copy.  Every buffer a pass gathers from is another than
// the ones it writes, so gathers are plain loads (a grid barrier
// invalidates L1).  The coarse solve is one warp per coarse row over the
// float32 dense inverse, summed in float64 and rounded once.  Dot products
// follow coop.cuh: float64 per-block partials, summed in one order by
// every block; K26 sums r.z in the cycle's last pass, which writes z.
// Small levels leave most threads idle between barriers (PERF.md section
// 6 for the probes and what they showed).

#include "coop.cuh"

namespace cg = cooperative_groups;

#define MG_MAX_LEVELS 32

enum MgOp : int {
  MG_SMOOTH_ZERO = 0,
  MG_SMOOTH = 1,
  MG_RESTRICT = 2,
  MG_PROLONG = 3,
  MG_COARSE = 4,
  MG_VPASS = 5,
  MG_S1 = 6,
  MG_JUMP = 7,
  MG_WPASS = 8,
  MG_COMB = 9,
  MG_COPY = 10,
  MG_RESTRICT_ZERO = 11,
  MG_PROLONG_SMOOTH = 12
};

// One level of the table (all fields 8 bytes: ops/mg.py writes it as
// int64).  Level 0's xa, xb and b are unused (the launch's); the coarsest
// level L has only xa, b and n.
struct MgLevel {
  const void* diags;  // (nd, n) float32 or bfloat16
  const long long* offs;
  const float* dinv;
  float* xa;
  float* xb;
  float* b;
  float* r;  // K-cycle: v = A c1
  float* k;  // K-cycle: c1 stashed for a second inner solve, or null
  long long n;
  long long nd;
  long long stride;  // of the transfer to level + 1
  long long unused;
};

struct MgCycle {
  const MgLevel* lv;  // L + 1 levels
  int L;
  const int* passes;  // npasses rows of op, level, src, dst
  const float* relax;
  int npasses;
  const float* minv;  // (n_L, n_L) row-major: x_L = minv b_L
  float krt2;         // kcycle_rel_tol^2
};

// the K-cycle's scalars of one level
enum MgKs : int { KS_RHO, KS_ALPHA, KS_BB, KS_TEMPE, KS_FIN, KS_G2, KS_GAMMA, KS_BETA, KS_ZETA,
                  KS_N };

// Partial-sum slots of the cycle's dot passes, each its own, so that two
// consecutive dot passes never share one: [G][3] VPASS, [G] S1, [G][3]
// WPASS.  The solvers' slots start after MG_CYCLE_PARTS * G.
#define MG_CYCLE_PARTS 7

// Blocks an SM that the kernels' registers leave room for: 4, the parent
// design's occupancy at 64 registers (left to the compiler, the cycle's
// compiled passes took 78 to 126 registers, 2 or 3 blocks an SM, and ran
// up to 40% slower).
#define GK_MG_MIN_BLOCKS 4

// Levels of this many diagonals (every level of a 5-point stencil's
// hierarchy) run a pass compiled for them, the offsets in registers and a
// row's loads unrolled; other levels run the pass that reads its offsets
// from the table (MgRows<TD, 0>), which took K25's 12-level cycle 21%
// longer at the same occupancy (PERF.md section 6).
#define GK_MG_ND 5

// A level's product rows: sum(i, f) = sum_d D[d][i] f(i + off_d) over the
// columns in [0, n), from +0.0 in offset order (ops/dia.py's order),
// compiled for ND diagonals, or for any count (ND = 0).
template <typename TD, int ND>
struct MgRows {
  const TD* D;
  const long long* offs;
  int n, nd;
  int off[ND > 0 ? ND : 1];
  __device__ explicit MgRows(const MgLevel& lv)
      : D(static_cast<const TD*>(lv.diags)), offs(lv.offs), n((int)lv.n), nd((int)lv.nd) {
    if constexpr (ND > 0) {
#pragma unroll
      for (int d = 0; d < ND; ++d) off[d] = (int)lv.offs[d];
    }
  }
  template <typename F>
  __device__ __forceinline__ float sum(int i, F f) const {
    float acc = 0.f;
    if constexpr (ND > 0) {
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const int j = i + off[d];
        if (j >= 0 && j < n) acc += GkAcc<float>::load(D[(long long)d * n + i]) * f(j);
      }
    } else {
      for (int d = 0; d < nd; ++d) {
        const int j = i + (int)offs[d];
        if (j >= 0 && j < n) acc += GkAcc<float>::load(D[(long long)d * n + i]) * f(j);
      }
    }
    return acc;
  }
};

struct MgLevel0 {
  const float* b;
  float* xa;
  float* xb;
};

// floor(x / d) for 0 <= x < 2^31 by a multiply-high (Granlund and
// Montgomery: m = floor(2^32 (2^l - d) / d) + 1, l = ceil(log2 d)), where a
// 64-bit division takes some 70 instructions; the transfers' index maps run
// it at every gathered column.
struct MgDiv {
  unsigned m, d;
  int l;
  __device__ explicit MgDiv(unsigned dv) : d(dv), l(0) {
    while ((1u << l) < dv && l < 31) ++l;
    m = (unsigned)(((1ull << 32) * ((1ull << l) - dv)) / dv + 1);
  }
  __device__ __forceinline__ unsigned div(unsigned x) const {
    return (__umulhi(m, x) + x) >> l;
  }
};

// The stride-S pairing of a level's rows (ops/mg.py): fine row i takes
// coarse row p(i) = (i / 2S) S + i % 2S mod S; coarse row c takes the fine
// rows f0 = 2S (c / S) + c % S and f0 + S.  Rows at most 2^30
// (ops/mg._device_state).
struct MgPairing {
  MgDiv by_s, by_2s;
  __device__ explicit MgPairing(long long S) : by_s((unsigned)S), by_2s((unsigned)(2 * S)) {}
  __device__ __forceinline__ int coarse(int i) const {
    const unsigned u = (unsigned)i;
    const unsigned g = by_2s.div(u);
    const unsigned m = u - g * by_2s.d;
    return (int)(g * by_s.d + (m < by_s.d ? m : m - by_s.d));
  }
  __device__ __forceinline__ int fine0(int c) const {
    const unsigned u = (unsigned)c;
    const unsigned g = by_s.div(u);
    return (int)(g * by_2s.d + (u - g * by_s.d));
  }
};

__device__ __forceinline__ float* mg_x(const MgLevel& lv, int l, int parity, const MgLevel0& z) {
  if (l == 0) return parity ? z.xb : z.xa;
  return parity ? lv.xb : lv.xa;
}

// The block's shared state of a cycle: the dot passes' reduction scratch
// and every level's K-cycle scalars.
struct MgShared {
  double sh1[1][GK_CG_WARPS];
  double sh3[3][GK_CG_WARPS];
  double bc1[1];
  double bc3[3];
  float ks[MG_MAX_LEVELS][KS_N];
};

// K26's dots of z = M r, summed in the cycle's last pass, which writes z on
// level 0 (ops/mg.compile_passes ends every list so), so that no pass of
// K26's own reads r and z again: r.z, r_old.z (flexible, q holding r_old)
// and the caller's partial r.r, into part as block_partial<3> writes them.
struct MgDots {
  const float* q;
  double* part;
  double rr;
};

// One pass of the list (any op but JUMP) on level l, its rows' products
// compiled for ND diagonals (0: any).  Vectors that other threads wrote
// before the last grid barrier are plain loads: every buffer a pass
// gathers from is another than the ones it writes, and the barrier
// invalidates L1 (__ldcg ran 1-2% slower, PERF.md section 6).  Partials of the dot passes go to
// part; the caller waits at the grid barrier and folds them.  dots: the
// pass writes z on level 0 and sums K26's dots of it (else null).
template <typename TD, int ND>
__device__ void mg_pass(const MgCycle& C, const MgLevel0& z, int op, int l, int src, int dst,
                        float w, double* part, MgShared& S, const MgDots* dots) {
  // rows at most 2^30 (ops/mg._device_state): 32-bit row indices
  const int t0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int G = gridDim.x;
  double* part_v = part;          // [G][3]
  double* part_s = part + 3 * G;  // [G]
  double* part_w = part + 4 * G;  // [G][3]
  const MgLevel lv = C.lv[l];
  const int n = (int)lv.n;
  const float* b = (l == 0) ? z.b : lv.b;
  float* xs = mg_x(lv, l, src, z);
  float* xd = mg_x(lv, l, dst, z);
  double ds[3] = {0.0, 0.0, dots ? dots->rr : 0.0};
  auto dot = [&](int i, float zi) {
    if (dots) {
      ds[0] += (double)b[i] * zi;
      if (dots->q) ds[1] += (double)dots->q[i] * zi;
    }
  };
  switch (op) {
    case MG_SMOOTH_ZERO:
      for (int i = t0; i < n; i += stride) xd[i] = w * (lv.dinv[i] * b[i]);
      break;
    case MG_SMOOTH: {
      const MgRows<TD, ND> A(lv);
      for (int i = t0; i < n; i += stride) {
        const float xi = xs[i] +
                         w * (lv.dinv[i] *
                              (b[i] - A.sum(i, [&](int j) { return xs[j]; })));
        xd[i] = xi;
        dot(i, xi);
      }
      break;
    }
    case MG_RESTRICT:
    case MG_RESTRICT_ZERO: {
      // b_{l+1} = r[f0] + r[f1], r = b - A x; RESTRICT_ZERO forms x = w
      // (dinv b) at each gathered column and writes it on every fine row
      const MgLevel nx = C.lv[l + 1];
      const long long S = lv.stride;
      const MgPairing pr(S);
      const MgRows<TD, ND> A(lv);
      const bool zero = op == MG_RESTRICT_ZERO;
      const float* xr = zero ? nullptr : xs;
      auto x_at = [&](int j) {
        return zero ? w * (lv.dinv[j] * b[j]) : xr[j];
      };
      for (int c = t0; c < nx.n; c += stride) {
        const int f0 = pr.fine0(c);
        const int f1 = f0 + (int)S;
        const float b0 = b[f0];
        const float r0 = b0 - A.sum(f0, x_at);
        if (zero) xd[f0] = w * (lv.dinv[f0] * b0);
        float r1 = 0.f;
        if (f1 < n) {
          const float b1 = b[f1];
          r1 = b1 - A.sum(f1, x_at);
          if (zero) xd[f1] = w * (lv.dinv[f1] * b1);
        }
        nx.b[c] = r0 + r1;
      }
      // fine rows that no coarse row takes (none in a full stride pairing)
      if (zero) {
        for (int i = (int)(2 * S * (nx.n / S)) + t0; i < n; i += stride)
          if (pr.coarse(i) >= nx.n) xd[i] = w * (lv.dinv[i] * b[i]);
      }
      break;
    }
    case MG_PROLONG: {
      const MgLevel nx = C.lv[l + 1];
      const float* xc = mg_x(nx, l + 1, src, z);
      const MgPairing pr(lv.stride);
      for (int i = t0; i < n; i += stride) {
        const int p = pr.coarse(i);
        const float xi = xd[i] + (p < nx.n ? xc[p] : 0.f);
        xd[i] = xi;
        dot(i, xi);
      }
      break;
    }
    case MG_PROLONG_SMOOTH: {
      // x' = x_dst + x_c[p(.)] formed at each gathered column; the sweep
      // from x' into the level's other buffer
      const MgLevel nx = C.lv[l + 1];
      const float* xc = mg_x(nx, l + 1, src, z);
      float* xo = mg_x(lv, l, 1 - dst, z);
      const MgPairing pr(lv.stride);
      const MgRows<TD, ND> A(lv);
      auto x_at = [&](int j) {
        const int p = pr.coarse(j);
        return xd[j] + (p < nx.n ? xc[p] : 0.f);
      };
      for (int i = t0; i < n; i += stride) {
        const float ax = A.sum(i, x_at);
        const float xi = x_at(i) + w * (lv.dinv[i] * (b[i] - ax));
        xo[i] = xi;
        dot(i, xi);
      }
      break;
    }
    case MG_COARSE: {
      const int lane = threadIdx.x & 31;
      for (int row = t0 >> 5; row < n; row += stride >> 5) {
        const float* mrow = C.minv + (long long)row * n;
        double s = 0.0;
        for (int j = lane; j < n; j += 32) s += (double)mrow[j] * (double)b[j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
        if (lane == 0) lv.xa[row] = (float)s;
      }
      break;
    }
    case MG_VPASS: {
      const MgRows<TD, ND> A(lv);
      double s[3] = {0.0, 0.0, 0.0};
      for (int i = t0; i < n; i += stride) {
        const float c1 = xs[i];
        const float vi = A.sum(i, [&](int j) { return xs[j]; });
        const float bi = b[i];
        lv.r[i] = vi;
        if (lv.k) lv.k[i] = c1;
        s[0] += (double)c1 * vi;
        s[1] += (double)c1 * bi;
        s[2] += (double)bi * bi;
      }
      block_partial<3>(s, part_v, S.sh3);
      break;
    }
    case MG_S1: {
      const bool fin = S.ks[l][KS_FIN] != 0.f;
      const float tempe = S.ks[l][KS_TEMPE];
      double s[1] = {0.0};
      for (int i = t0; i < n; i += stride) {
        const float bi = b[i];
        const float nb = fin ? bi - tempe * lv.r[i] : bi;
        lv.b[i] = nb;
        const float xi = xs[i];
        xs[i] = fin ? tempe * xi : xi;
        s[0] += (double)nb * nb;
      }
      block_partial<1>(s, part_s, S.sh1);
      break;
    }
    case MG_WPASS: {
      const MgRows<TD, ND> A(lv);
      double s[3] = {0.0, 0.0, 0.0};
      for (int i = t0; i < n; i += stride) {
        const float wi = A.sum(i, [&](int j) { return xs[j]; });
        const float c2 = xs[i];
        s[0] += (double)lv.k[i] * wi;
        s[1] += (double)c2 * wi;
        s[2] += (double)c2 * b[i];
      }
      block_partial<3>(s, part_w, S.sh3);
      break;
    }
    case MG_COMB: {
      // kcycle_step_2: the A-optimal combination of e1 = temp c1 and c2
      const float* k = S.ks[l];
      float sd = k[KS_ZETA] / (k[KS_BETA] - k[KS_GAMMA] * k[KS_GAMMA] / k[KS_RHO]);
      float se = 1.f - k[KS_GAMMA] / k[KS_ALPHA] * sd;
      const bool ok = isfinite(sd) && isfinite(se);
      se = ok ? se : 1.f;
      sd = ok ? sd : 0.f;
      const float e1s = se * k[KS_TEMPE];
      for (int i = t0; i < n; i += stride) xs[i] = e1s * lv.k[i] + sd * xs[i];
      break;
    }
    case MG_COPY:
      for (int i = t0; i < n; i += stride) {
        const float xi = xs[i];
        xd[i] = xi;
        dot(i, xi);
      }
      break;
    default:
      break;
  }
  if (dots) block_partial<3>(ds, dots->part, S.sh3);
}

// One cycle on level 0's rhs z.b; the result lands in z.xa (z.xb is
// scratch).  Call after a barrier that orders every earlier cross-row read
// of z.xa and z.xb.  b_written: z.b was written since the last grid
// barrier (on this thread's own rows); a first pass that reads it across
// rows (a restriction, ops/mg.lead_barrier) then waits at a grid barrier
// first, and other first passes read it on those rows only.  Ends with a
// grid barrier.  part: MG_CYCLE_PARTS * gridDim.x doubles.  C and z come by
// value, so that a call the compiler does not inline (K26 and K28 call it
// twice) keeps them in registers.  dots (K26): summed in the last pass.
template <typename TD>
__device__ void gk_mg_cycle(cg::grid_group& grid, const MgCycle C, const MgLevel0 z,
                            double* part, bool b_written, const MgDots* dots = nullptr) {
  __shared__ MgShared S;
  const int G = gridDim.x;
  if (b_written && (C.passes[0] == MG_RESTRICT_ZERO || C.passes[0] == MG_RESTRICT) &&
      C.passes[1] == 0)
    grid.sync();
  int pc = 0;
  while (pc < C.npasses) {
    const int op = C.passes[4 * pc];
    const int l = C.passes[4 * pc + 1];
    const int src = C.passes[4 * pc + 2];
    const int dst = C.passes[4 * pc + 3];
    if (op == MG_JUMP) {  // kcycle_check_stop: a second inner solve iff g2 > rel_tol^2 bb
      pc = (S.ks[l][KS_G2] > C.krt2 * S.ks[l][KS_BB]) ? pc + 1 : src;
      continue;
    }
    const float w = C.relax[pc];
    const MgDots* d = pc == C.npasses - 1 ? dots : nullptr;
    if (op != MG_COARSE && C.lv[l].nd == GK_MG_ND)
      mg_pass<TD, GK_MG_ND>(C, z, op, l, src, dst, w, part, S, d);
    else
      mg_pass<TD, 0>(C, z, op, l, src, dst, w, part, S, d);
    grid.sync();
    if (op == MG_VPASS || op == MG_WPASS) {
      double tot[3];
      grid_total<3>(op == MG_VPASS ? part : part + 4 * G, tot, S.sh3, S.bc3);
      if (threadIdx.x == 0) {
        float* k = S.ks[l];
        if (op == MG_VPASS) {
          k[KS_RHO] = (float)tot[0];
          k[KS_ALPHA] = (float)tot[1];
          k[KS_BB] = (float)tot[2];
          const float temp = k[KS_ALPHA] / k[KS_RHO];
          const bool fin = isfinite(temp);
          k[KS_FIN] = fin ? 1.f : 0.f;
          k[KS_TEMPE] = fin ? temp : 1.f;
        } else {
          k[KS_GAMMA] = (float)tot[0];
          k[KS_BETA] = (float)tot[1];
          k[KS_ZETA] = (float)tot[2];
        }
      }
      __syncthreads();
    } else if (op == MG_S1) {
      double tot[1];
      grid_total<1>(part + 3 * G, tot, S.sh1, S.bc1);
      if (threadIdx.x == 0) S.ks[l][KS_G2] = (float)tot[0];
      __syncthreads();
    }
    ++pc;
  }
}

// ---------------------------------------------------------------------------
// K25: one cycle, from x0 (the pass list for a given x) or from zero.

struct VcycleParams {
  MgCycle c;
  const float* b;
  const float* x0;  // or null
  float* x;
  float* xalt;
  double* part;
};

template <typename TD>
__global__ void __launch_bounds__(GK_CG_THREADS, GK_MG_MIN_BLOCKS) mg_vcycle_kernel(const VcycleParams P) {
  cg::grid_group grid = cg::this_grid();
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const MgCycle& C = P.c;
  if (P.x0) {
    const long long n = C.lv[0].n;
    for (long long i = t0; i < n; i += stride) P.x[i] = P.x0[i];
    grid.sync();
  }
  MgLevel0 z = {P.b, P.x, P.xalt};
  gk_mg_cycle<TD>(grid, C, z, P.part, false);
}

// ---------------------------------------------------------------------------
// K27: cycles from x0 while it < max_iters and !(r.r <= tol_sq), r = b - A x
// after each cycle (A: level 0's operator); the monitor starts at +inf.
// Barriers a cycle: the pass list's plus one.

struct SolveParams {
  MgCycle c;
  const float* b;
  const float* x0;
  const float* tol_sq;
  int max_iters;
  float* x;
  float* xalt;
  double* part;  // (MG_CYCLE_PARTS + 1) * gridDim.x
  int* it_out;
  float* rr_out;
  int* conv_out;
};

template <typename TD>
__global__ void __launch_bounds__(GK_CG_THREADS, GK_MG_MIN_BLOCKS) mg_solve_fused_kernel(const SolveParams P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[1][GK_CG_WARPS];
  __shared__ double bc1[1];
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const MgCycle& C = P.c;
  const MgRows<TD, 0> A0(C.lv[0]);
  const long long n = A0.n;
  double* part_r = P.part + MG_CYCLE_PARTS * gridDim.x;
  for (long long i = t0; i < n; i += stride) P.x[i] = P.x0[i];
  grid.sync();
  const MgLevel0 z = {P.b, P.x, P.xalt};
  const float tol_sq = *P.tol_sq;
  int it = 0;
  float rr = CUDART_INF_F;
  while (it < P.max_iters && !(rr <= tol_sq)) {
    gk_mg_cycle<TD>(grid, C, z, P.part, false);
    double s[1] = {0.0};
    for (long long i = t0; i < n; i += stride) {
      const float ri = P.b[i] - A0.sum((int)i, [&](int j) { return __ldcg(P.x + j); });
      s[0] += (double)ri * ri;
    }
    block_partial<1>(s, part_r, sh1);
    grid.sync();
    double tot[1];
    grid_total<1>(part_r, tot, sh1, bc1);
    rr = (float)tot[0];
    ++it;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *P.it_out = it;
    *P.rr_out = rr;
    *P.conv_out = (rr <= tol_sq) ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// K26: CG (FCG with `flexible`) with z = one cycle from zero on r.
//
// Semantics kept from _mg_cg_kernel (:777-855): z = M r0, p = z, rho = r.z;
// the monitor starts at +inf; per iteration q = A p, alpha = rho / p.q,
// x += alpha p, r -= alpha q (flexible: q keeps r_old), z = M r,
// rho_new = r.z, beta = (rho_new, or rho_new - r_old.z) / rho,
// p = z + beta p; the monitor is r.r after the update, or in implicit mode
// |rho| of the rho entering the iteration.  Zero denominators give 0.
// Barriers an iteration: the cycle's plus 3, and one before the cycle where
// its first pass restricts (ops/mg.lead_barrier), since the cycle's b is r.

template <typename TA>
struct CgParams {
  MgCycle c;
  GkDiaOp<TA> a;
  long long n;
  const float* r0;
  const float* x0;
  const float* tol_sq;
  int max_iters;
  int implicit;
  int flexible;
  float* x;
  float* r;
  float* p;
  float* q;
  float* z;
  float* zalt;
  double* part;  // (MG_CYCLE_PARTS + 4) * gridDim.x
  int* it_out;
  float* mon_out;
  int* conv_out;
};

template <typename TA, typename TD>
__global__ void __launch_bounds__(GK_CG_THREADS, GK_MG_MIN_BLOCKS) mg_cg_fused_kernel(const CgParams<TA> P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[1][GK_CG_WARPS];
  __shared__ double sh3[3][GK_CG_WARPS];
  __shared__ double bc1[1];
  __shared__ double bc3[3];
  const long long n = P.n;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  double* part3 = P.part + MG_CYCLE_PARTS * gridDim.x;        // [G][3] r.z, r_old.z, r.r
  double* part1 = P.part + (MG_CYCLE_PARTS + 3) * gridDim.x;  // [G]    p.q
  const MgLevel0 z = {P.r, P.z, P.zalt};
  const MgCycle& C = P.c;

  for (long long i = t0; i < n; i += stride) {
    P.x[i] = P.x0[i];
    P.r[i] = P.r0[i];
  }
  gk_mg_cycle<TD>(grid, C, z, P.part, true);
  double tot3[3];
  {
    double s[3] = {0.0, 0.0, 0.0};
    for (long long i = t0; i < n; i += stride) {
      const float ri = P.r[i];
      const float zi = __ldcg(P.z + i);
      P.p[i] = zi;
      s[0] += (double)ri * zi;
    }
    block_partial<3>(s, part3, sh3);
  }
  grid.sync();
  grid_total<3>(part3, tot3, sh3, bc3);
  float rho = (float)tot3[0];

  const float tol_sq = *P.tol_sq;
  int it = 0;
  float mon = CUDART_INF_F;
  while (it < P.max_iters && !(mon <= tol_sq)) {
    // q = A p, partial p.q
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

    // x += alpha p, r -= alpha q (FCG: q keeps r_old); this thread's part of
    // r.r waits for the next reduction
    double rr = 0.0;
    for (long long i = t0; i < n; i += stride) {
      P.x[i] = P.x[i] + alpha * __ldcg(P.p + i);
      const float r_old = P.r[i];
      const float ri = r_old - alpha * P.q[i];
      P.r[i] = ri;
      if (P.flexible) P.q[i] = r_old;
      rr += (double)ri * ri;
    }
    // z = M r, with the dots r.z (and r_old.z) summed in its last pass
    const MgDots dots = {P.flexible ? P.q : nullptr, part3, rr};
    gk_mg_cycle<TD>(grid, C, z, P.part, true, &dots);
    grid_total<3>(part3, tot3, sh3, bc3);
    const float rho_new = (float)tot3[0];
    const float num = P.flexible ? rho_new - (float)tot3[1] : rho_new;
    const float beta = gk_sdiv(num, rho);

    // p = z + beta p
    for (long long i = t0; i < n; i += stride) P.p[i] = __ldcg(P.z + i) + beta * __ldcg(P.p + i);
    mon = P.implicit ? fabsf(rho) : (float)tot3[2];
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
// K28: right-preconditioned BiCGSTAB, M one cycle from zero.
//
// Semantics kept from _bicgstab_mg_kernel (:1190-1281), the same scalars as
// K24 (trs_fused.cu): rr = r0, rho = r0.r0, p = v = 0, rho_old = alpha =
// omega = 1; beta = (rho alpha) / (rho_old omega), p = r + beta (p - omega
// v), y = M p, v = A y, alpha = rho / rr.v, x += alpha y, s = r - alpha v,
// the half-step check on s.s (|rho| in implicit mode), z = M s, t = A z,
// omega = t.s / t.t (0 when the half step converged, carried as 1),
// x += omega z, r = s - omega t, rho = rr.r.  y and z share one buffer.
// Barriers an iteration: two cycles' plus 3, and one before each cycle
// where its first pass restricts (its b, p or s, was just written).

template <typename TA>
struct BicgstabParams {
  MgCycle c;
  GkDiaOp<TA> a;
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
  float* yalt;
  double* part;  // (MG_CYCLE_PARTS + 7) * gridDim.x
  int* it_out;
  float* mon_out;
  int* conv_out;
};

template <typename TA, typename TD>
__global__ void __launch_bounds__(GK_CG_THREADS, GK_MG_MIN_BLOCKS)
    mg_bicgstab_fused_kernel(const BicgstabParams<TA> P) {
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
  const int G = gridDim.x;
  double* part_a = P.part + MG_CYCLE_PARTS * G;        // [G]     r0.r0
  double* part_b = P.part + (MG_CYCLE_PARTS + 1) * G;  // [G]     rr.v
  double* part_c = P.part + (MG_CYCLE_PARTS + 2) * G;  // [G][3]  s.s, t.s, t.t
  double* part_d = P.part + (MG_CYCLE_PARTS + 5) * G;  // [G][2]  rr.r, r.r
  const MgLevel0 zp = {P.p, P.y, P.yalt};
  const MgLevel0 zs = {P.s, P.y, P.yalt};
  const MgCycle& C = P.c;

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
    gk_mg_cycle<TD>(grid, C, zp, P.part, true);  // y = M p
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
    gk_mg_cycle<TD>(grid, C, zs, P.part, true);  // z = M s (into y)
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
// C entry points.  Dtype codes (common.cuh GkDtype): the levels' diagonals
// (all one dtype) and A's are each GK_F32 or GK_BF16.

#define MG_D_DISPATCH(d_dtype, CALL)                            \
  do {                                                          \
    if ((d_dtype) == GK_F32) { using TD = float; return CALL; } \
    if ((d_dtype) == GK_BF16) {                                 \
      using TD = __nv_bfloat16;                                 \
      return CALL;                                              \
    }                                                           \
    return (int)cudaErrorInvalidValue;                          \
  } while (0)

#define MG_AD_DISPATCH(a_dtype, d_dtype, CALL) \
  do {                                         \
    if ((a_dtype) == GK_F32) {                 \
      using TA = float;                        \
      MG_D_DISPATCH(d_dtype, CALL);            \
    }                                          \
    if ((a_dtype) == GK_BF16) {                \
      using TA = __nv_bfloat16;                \
      MG_D_DISPATCH(d_dtype, CALL);            \
    }                                          \
    return (int)cudaErrorInvalidValue;         \
  } while (0)

static bool mg_cycle_ok(int L, int npasses, int blocks) {
  return L >= 1 && L <= MG_MAX_LEVELS && npasses >= 1 && blocks >= 1;
}

static MgCycle mg_cycle(const void* levels, int L, const int* passes, const float* relax,
                        int npasses, const float* minv, float krt2) {
  MgCycle c;
  c.lv = static_cast<const MgLevel*>(levels);
  c.L = L;
  c.passes = passes;
  c.relax = relax;
  c.npasses = npasses;
  c.minv = minv;
  c.krt2 = krt2;
  return c;
}

// K25: blocks of the cooperative grid.
extern "C" int mg_vcycle_grid(int d_dtype, int* blocks) {
  MG_D_DISPATCH(d_dtype, gk_coop_blocks(mg_vcycle_kernel<TD>, blocks));
}

template <typename TD>
static int vcycle_launch(const VcycleParams& P, int blocks, void* stream) {
  return gk_coop_launch(mg_vcycle_kernel<TD>, P, blocks, stream);
}

// K25: one cycle; x0 null starts from zero (the pass list must match).
extern "C" int mg_vcycle_solve(int d_dtype, const void* levels, int L, const int* passes,
                               const float* relax, int npasses, const float* minv, float krt2,
                               const float* b, const float* x0, float* x, float* xalt,
                               double* part, int blocks, void* stream) {
  if (!mg_cycle_ok(L, npasses, blocks)) return (int)cudaErrorInvalidValue;
  VcycleParams P;
  P.c = mg_cycle(levels, L, passes, relax, npasses, minv, krt2);
  P.b = b;
  P.x0 = x0;
  P.x = x;
  P.xalt = xalt;
  P.part = part;
  MG_D_DISPATCH(d_dtype, (vcycle_launch<TD>)(P, blocks, stream));
}

// K27: blocks of the cooperative grid.
extern "C" int mg_solve_fused_grid(int d_dtype, int* blocks) {
  MG_D_DISPATCH(d_dtype, gk_coop_blocks(mg_solve_fused_kernel<TD>, blocks));
}

template <typename TD>
static int solve_launch(const SolveParams& P, int blocks, void* stream) {
  return gk_coop_launch(mg_solve_fused_kernel<TD>, P, blocks, stream);
}

// K27: cycles from x0 (the pass list for a given x) to the stop test.
extern "C" int mg_solve_fused_solve(int d_dtype, const void* levels, int L, const int* passes,
                                    const float* relax, int npasses, const float* minv,
                                    float krt2, const float* b, const float* x0,
                                    const float* tol_sq, int max_iters, float* x, float* xalt,
                                    double* part, int blocks, int* it_out, float* rr_out,
                                    int* conv_out, void* stream) {
  if (!mg_cycle_ok(L, npasses, blocks) || max_iters < 0) return (int)cudaErrorInvalidValue;
  SolveParams P;
  P.c = mg_cycle(levels, L, passes, relax, npasses, minv, krt2);
  P.b = b;
  P.x0 = x0;
  P.tol_sq = tol_sq;
  P.max_iters = max_iters;
  P.x = x;
  P.xalt = xalt;
  P.part = part;
  P.it_out = it_out;
  P.rr_out = rr_out;
  P.conv_out = conv_out;
  MG_D_DISPATCH(d_dtype, (solve_launch<TD>)(P, blocks, stream));
}

// K26: blocks of the cooperative grid.
extern "C" int mg_cg_fused_grid(int a_dtype, int d_dtype, int* blocks) {
  MG_AD_DISPATCH(a_dtype, d_dtype, (gk_coop_blocks(mg_cg_fused_kernel<TA, TD>, blocks)));
}

template <typename TA, typename TD>
static int cg_launch(const MgCycle& c, const void* a_diags, const long long* a_offsets, int a_nd,
                     long long n, const float* r0, const float* x0, const float* tol_sq,
                     int max_iters, int implicit, int flexible, float* const* vecs,
                     double* part, int blocks, int* it_out, float* mon_out, int* conv_out,
                     void* stream) {
  CgParams<TA> P;
  P.c = c;
  P.a = gk_dia_op<TA>(a_diags, a_offsets, a_nd, n);
  P.n = n;
  P.r0 = r0;
  P.x0 = x0;
  P.tol_sq = tol_sq;
  P.max_iters = max_iters;
  P.implicit = implicit;
  P.flexible = flexible;
  P.x = vecs[0];
  P.r = vecs[1];
  P.p = vecs[2];
  P.q = vecs[3];
  P.z = vecs[4];
  P.zalt = vecs[5];
  P.part = part;
  P.it_out = it_out;
  P.mon_out = mon_out;
  P.conv_out = conv_out;
  return gk_coop_launch(mg_cg_fused_kernel<TA, TD>, P, blocks, stream);
}

// K26: MG-preconditioned CG/FCG on a square Dia A (level 0's rows).
// vecs: 6 float32 (n,) buffers x, r, p, q, z, zalt.
extern "C" int mg_cg_fused_solve(int d_dtype, const void* a_diags, int a_dtype,
                                 const long long* a_offsets, int a_nd, long long n,
                                 const void* levels, int L, const int* passes, const float* relax,
                                 int npasses, const float* minv, float krt2, const float* r0,
                                 const float* x0, const float* tol_sq, int max_iters,
                                 int implicit, int flexible, float* const* vecs, double* part,
                                 int blocks, int* it_out, float* mon_out, int* conv_out,
                                 void* stream) {
  if (!mg_cycle_ok(L, npasses, blocks) || a_nd < 1 || a_nd > GK_MAX_DIAGS || max_iters < 0)
    return (int)cudaErrorInvalidValue;
  const MgCycle c = mg_cycle(levels, L, passes, relax, npasses, minv, krt2);
  MG_AD_DISPATCH(a_dtype, d_dtype,
                 (cg_launch<TA, TD>)(c, a_diags, a_offsets, a_nd, n, r0, x0, tol_sq, max_iters,
                                     implicit, flexible, vecs, part, blocks, it_out, mon_out,
                                     conv_out, stream));
}

// K28: blocks of the cooperative grid.
extern "C" int mg_bicgstab_fused_grid(int a_dtype, int d_dtype, int* blocks) {
  MG_AD_DISPATCH(a_dtype, d_dtype, (gk_coop_blocks(mg_bicgstab_fused_kernel<TA, TD>, blocks)));
}

template <typename TA, typename TD>
static int bicgstab_launch(const MgCycle& c, const void* a_diags, const long long* a_offsets,
                           int a_nd, long long n, const float* r0, const float* x0,
                           const float* tol_sq, int max_iters, int implicit,
                           float* const* vecs, double* part, int blocks, int* it_out,
                           float* mon_out, int* conv_out, void* stream) {
  BicgstabParams<TA> P;
  P.c = c;
  P.a = gk_dia_op<TA>(a_diags, a_offsets, a_nd, n);
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
  P.yalt = vecs[8];
  P.part = part;
  P.it_out = it_out;
  P.mon_out = mon_out;
  P.conv_out = conv_out;
  return gk_coop_launch(mg_bicgstab_fused_kernel<TA, TD>, P, blocks, stream);
}

// K28: MG right-preconditioned BiCGSTAB on a square Dia A (level 0's
// rows).  vecs: 9 float32 (n,) buffers x, r, rr, p, v, s, t, y, yalt.
extern "C" int mg_bicgstab_fused_solve(int d_dtype, const void* a_diags, int a_dtype,
                                       const long long* a_offsets, int a_nd, long long n,
                                       const void* levels, int L, const int* passes,
                                       const float* relax, int npasses, const float* minv,
                                       float krt2, const float* r0, const float* x0,
                                       const float* tol_sq, int max_iters, int implicit,
                                       float* const* vecs, double* part, int blocks,
                                       int* it_out, float* mon_out, int* conv_out,
                                       void* stream) {
  if (!mg_cycle_ok(L, npasses, blocks) || a_nd < 1 || a_nd > GK_MAX_DIAGS || max_iters < 0)
    return (int)cudaErrorInvalidValue;
  const MgCycle c = mg_cycle(levels, L, passes, relax, npasses, minv, krt2);
  MG_AD_DISPATCH(a_dtype, d_dtype,
                 (bicgstab_launch<TA, TD>)(c, a_diags, a_offsets, a_nd, n, r0, x0, tol_sq,
                                           max_iters, implicit, vecs, part, blocks, it_out,
                                           mon_out, conv_out, stream));
}
