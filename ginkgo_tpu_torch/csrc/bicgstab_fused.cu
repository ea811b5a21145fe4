// Whole-solve right-preconditioned BiCGSTAB in persistent cooperative
// kernels: K12 of the PyTorch port on a Dia (the five-pass kernel
// bicgstab_fused_kernel, templated on its operator, coop.cuh GkDiaOp, and
// the ring route), the k-column form K12m, and K19 on a Pell (below, a
// kernel of its own on K7's chunked rows).
//
// K12 replaces ginkgo_tpu/ops/pallas_bicgstab.py bicgstab_vmem_solve
// (_bicgstab_kernel, :53-186).  A diagonal preconditioner M is folded into
// the operator before the launch (solver/_fused_gate.fold_minv: diagonal d
// scaled by minv at column i + off_d and rounded back to the diagonals'
// dtype), so the kernel runs on A M and applies minv only in the x update,
// y = minv p and z = minv s.  K12 has two routes, chosen from the offsets
// alone (ops/bicgstab.ring_plan): the ring route (bicgstab_ring_kernel,
// below), three passes an iteration, where its ring fits a block's shared
// memory; else the five-pass kernel of this header (bicgstab_fused_kernel).
//
// K19 replaces ginkgo_tpu/ops/pallas_pell_cg.py pell_bicgstab_vmem_solve
// (_pell_bicgstab_kernel, :313): the same loop on a Pell, in the five-pass
// kernel's order with one fold fewer an iteration, on K7's chunked rows
// (pell_bicgstab_fused_kernel).  PELL values have no column fold, so M is
// applied explicitly, staged as the TPU kernel stages it (y = M p, z = M s).
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

#include <stdint.h>

#include <type_traits>

#include "async.cuh"
#include "coop.cuh"
#include "pell.cuh"

namespace cg = cooperative_groups;

template <typename Op>
struct BicgstabParams {
  Op op;  // A M, a diagonal M folded into the Dia
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
  float* p1;      // the ring route and K12m: p and v alternate between P.p, P.p1 and P.v, P.v1
  float* v1;
  int ring_rows;  // the ring route's ring (a power of two) and w = max |offset|
  int width;
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

// ---------------------------------------------------------------------------
// K12's ring route on a Dia: three passes and three grid barriers an
// iteration where bicgstab_fused_kernel takes five.
//
// Each block owns the contiguous rows [a, a+len) (len a multiple of 8, the
// last block's shorter) and keeps that range in every pass.  Passes A and B
// are walks over the range plus a halo of w = max |offset| rows on each
// side, [lo, hi), C = GK_BCG_CHUNK rows a step:
//   A: form p_new = r + beta (p_old - omega v_old) on every row of the walk,
//      into a ring of shared memory (and to device memory on the own rows),
//      and v = (A M) p_new on the own rows from the ring; partial <rr, v>.
//   B: form s = r - alpha v on every row of the walk into the ring, and
//      t = (A M) s on the own rows; partial s.s, t.s and t.t in one fold,
//      after which the half step and omega are decided.
//   C: x += alpha (M p) + omega (M s) and r = s - omega t on the own rows,
//      s formed again from r and v (the same operands, the same bits);
//      partial <rr, r> and r.r.
// A halo row is formed by every block that reads it, from vectors that no
// block writes in that pass: p and v alternate between two buffers (pass A
// reads p_old and v_old on its halo while their owners write p_new and
// v_new), and r changes only in pass C.  Every value is formed from the
// five-pass kernel's operands in its order, and each product row as
// gk_dia_row sums it (from +0.0, the diagonals in offset order, a column
// outside [0, n) skipped), so only the order of the float64 dot sums
// differs from it.
//
// The walk.  Step t forms chunk t (positions [tC, tC + C) of the walk, row
// lo + position, lo a multiple of 4) and takes the product of the own chunk
// c = t - L, L = ceil((H + w) / C) + 1 (H = a - lo): every position that
// chunk reads was formed in an earlier step, and one block barrier a step
// orders them.  The ring holds ring_rows positions, a power of two >= 2w +
// 3C, indexed by position mod ring_rows: the 2w + C positions a step reads
// and the chunk it writes never meet (ops/bicgstab.ring_plan, and the CPU
// model in tests/test_torch_bicgstab_order.py).  A step's inputs (the
// vectors its rows are formed from; the diagonals and rr of the rows it
// multiplies) stream into a ring of GK_BCG_STAGES stages by cp.async,
// GK_BCG_PREFETCH steps ahead of the step that reads them, so that a step
// never waits on device memory: the vectors 16 bytes at a time past L1
// (other blocks rewrote them since the last grid barrier), the diagonals,
// constant during a launch, 16 bytes at a time where n sizeof(TD) is a
// multiple of 16, else 4 (a diagonal's chunk may start mid-word).  A first form without the stages, each step's
// loads issued at the end of the one before, waited on device memory every
// step and lost to the five-pass kernel (PERF.md section 6).
//
// Bytes a row and iteration in float32 (nd diagonals of TD): A reads r,
// p_old, v_old (the halo's too), the diagonals and rr and writes p_new and
// v; B reads r and v (the halo's too) and the diagonals and writes t; C
// reads x, r, p, v, t, rr and writes x and r: 2 nd sizeof(TD) + 64, plus the
// halo's 20 B a row times 2w / len, plus 4 with minv.  The partials are
// value-major (coop.cuh block_partial_vm) and each fold loads them at once
// (grid_total_batch).

// Rows a walk step forms (and the rows of a product chunk).  On the H100
// 1024 rows beat 512 (PERF.md section 6).
#define GK_BCG_CHUNK 1024
// Steps the copies run ahead of the step that reads them, and the stages of
// the input ring: 2 beat 1 and 3.
#define GK_BCG_PREFETCH 2
#define GK_BCG_STAGES (GK_BCG_PREFETCH + 1)
// Most rows of the ring: 128 KB of shared memory a block.
#define GK_BCG_MAX_RING 32768

// Bytes of one diagonal's chunk in a stage: C values and the 4-byte word a
// bfloat16 chunk that starts mid-word needs, rounded up to 16.
__host__ __device__ inline int gk_bcg_diag_bytes(int esz) {
  return (GK_BCG_CHUNK * esz + 4 + 15) & ~15;
}

// A stage: up to four vectors of C floats (a pass's formed vectors, then
// rr), then nd diagonals of esz bytes.
__host__ __device__ inline long long gk_bcg_slot(int nd, int esz) {
  return 16LL * GK_BCG_CHUNK + (long long)nd * gk_bcg_diag_bytes(esz);
}

// Dynamic shared memory of the ring route: the ring, then the stages.
__host__ __device__ inline long long gk_bcg_smem(int ring_rows, int nd, int esz) {
  return 4LL * ring_rows + GK_BCG_STAGES * gk_bcg_slot(nd, esz);
}

// Pass A's rows: p_new = r + beta (p_old - omega v_old) from the staged r,
// p_old, v_old, written to device memory on the own rows.
struct GkBcgFormP {
  static constexpr int NV = 3;
  const float* src[NV];  // r, p_old, v_old
  float* p_new;
  float beta, omega;
  __device__ __forceinline__ float value(const float* st, int e) const {
    return st[e] + beta * (st[GK_BCG_CHUNK + e] - omega * st[2 * GK_BCG_CHUNK + e]);
  }
  __device__ __forceinline__ void own(int i, float v) const { p_new[i] = v; }
};

// Pass B's rows: s = r - alpha v from the staged r and v, kept in the ring
// alone.
struct GkBcgFormS {
  static constexpr int NV = 2;
  const float* src[NV];  // r, v
  float alpha;
  __device__ __forceinline__ float value(const float* st, int e) const {
    return st[e] - alpha * st[GK_BCG_CHUNK + e];
  }
  __device__ __forceinline__ void own(int, float) const {}
};

// One walk over the block's rows [a, a+len) (a a multiple of 8; see above):
// form.value on every row of [lo, hi); on every own row i, use(i, (A M)
// ring at row i, ring at row i, aux[i]) (aux nullptr: 0).  ND > 0: compiled
// for ND diagonals.  smem: the ring of ring_rows floats, then the stages.
// Call with the whole block; on return every copy has landed and every
// thread has left the walk's shared memory.
template <typename TD, int ND, typename Form, typename Use>
__device__ __forceinline__ void gk_bcg_walk(const GkDiaOp<TD>& op, int w, int ring_rows, int a,
                                            int len, char* smem, const Form& form,
                                            const float* aux, Use use) {
  constexpr int C = GK_BCG_CHUNK;
  constexpr int RPT = GK_BCG_CHUNK / GK_CG_THREADS;
  constexpr int NDA = ND > 0 ? ND : 1;
  constexpr int esz = (int)sizeof(TD);
  const int n = (int)op.n;
  const int nd = ND > 0 ? ND : op.offs.nd;
  const int lo = (a - w > 0 ? a - w : 0) & ~3;
  const int hi = a + len + w < n ? a + len + w : n;
  const int H = a - lo, total = hi - lo;
  const int nF = (total + C - 1) / C, nS = (len + C - 1) / C;
  const int lag = (H + w + C - 1) / C + 1;
  const int mask = ring_rows - 1;
  const int tid = threadIdx.x;
  float* ring = reinterpret_cast<float*>(smem);
  char* stages = smem + 4LL * ring_rows;
  const int dbytes = gk_bcg_diag_bytes(esz);
  const int slot = (int)gk_bcg_slot(nd, esz);
  // the diagonals move 16 bytes a copy where every chunk of every diagonal
  // starts on 16 bytes (n esz a multiple of 16; chunks start on multiples of
  // 8 rows), else 4 bytes a copy
  const bool wide = (n * esz) % 16 == 0 && (uintptr_t)op.diags % 16 == 0;
  // |offset| of each diagonal, and where its chunk starts in its staged
  // words (the same for every chunk: chunks start on multiples of 4 rows)
  int off[NDA], dsh[NDA];
#pragma unroll
  for (int d = 0; d < NDA; ++d) {
    off[d] = (int)op.offs.off[d];
    dsh[d] = esz == 4 ? 0 : (d & n & 1) * 2;
  }

  // the inputs of step t into its stage: the vectors of formed chunk t and
  // rr and the diagonals of product chunk t - lag
  auto issue = [&](int t) {
    char* dst = stages + (t % GK_BCG_STAGES) * slot;
    auto vec = [&](char* to, const float* src, int r0) {
      for (int u = tid; u < C / 4; u += GK_CG_THREADS) {
        const int r = r0 + 4 * u;
        const int nb = r < n ? (n - r < 4 ? n - r : 4) * 4 : 0;
        gk_cp16_n(to + 16 * u, nb ? src + r : src, nb);
      }
    };
    if (t < nF) {
#pragma unroll
      for (int m = 0; m < Form::NV; ++m) vec(dst + m * C * 4, form.src[m], lo + t * C);
    }
    const int c = t - lag;
    if (c >= 0 && c < nS) {
      const int i0 = a + c * C;
      if (aux) vec(dst + 3 * C * 4, aux, i0);
      const long long lo_b = (long long)(uintptr_t)op.diags;
      const long long hi_b = lo_b + (long long)nd * n * esz;
      if (wide) {
        // every diagonal's chunk starts on 16 bytes: 16 bytes a copy
        for (int d = 0; d < nd; ++d) {
          const long long g0 = lo_b + ((long long)d * n + i0) * esz;
          for (int u = tid; u < C * esz / 16; u += GK_CG_THREADS) {
            const long long g = g0 + 16LL * u;
            const int nb = g < hi_b ? (int)(hi_b - g < 16 ? hi_b - g : 16) : 0;
            gk_cp16_n(dst + 16 * C + d * dbytes + 16 * u,
                      nb ? (const void*)(uintptr_t)g : (const void*)op.diags, nb);
          }
        }
      } else {
        const int words = C * esz / 4 + (esz < 4 ? 1 : 0);
        for (int d = 0; d < nd; ++d) {
          const long long g0 = (lo_b + ((long long)d * n + i0) * esz) & ~3LL;
          for (int u = tid; u < words; u += GK_CG_THREADS) {
            const long long g = g0 + 4LL * u;
            const int nb = (g >= lo_b && g < hi_b) ? (int)(hi_b - g < 4 ? hi_b - g : 4) : 0;
            gk_cp4_n(dst + 16 * C + d * dbytes + 4 * u,
                     nb ? (const void*)(uintptr_t)g : (const void*)op.diags, nb);
          }
        }
      }
    }
  };

  for (int t = 0; t < GK_BCG_PREFETCH; ++t) {
    issue(t);
    gk_cp_commit();
  }
  for (int t = 0; t < nS + lag; ++t) {
    // stage t has landed, the positions formed in step t - 1 are in the
    // ring, and every thread has left stage t - 1
    gk_cp_wait<GK_BCG_PREFETCH - 1>();
    __syncthreads();
    issue(t + GK_BCG_PREFETCH);  // into stage t - 1's place
    gk_cp_commit();
    const char* st = stages + (t % GK_BCG_STAGES) * slot;
    const float* sv = reinterpret_cast<const float*>(st);
    const int c = t - lag;
    if (c >= 0) {
#pragma unroll
      for (int u = 0; u < RPT; ++u) {
        const int e = u * GK_CG_THREADS + tid;
        const int i = a + c * C + e;
        if (i >= a + len) continue;
        float acc = 0.f;
        auto term = [&](int d, int od, int sh) {
          const int j = i + od;
          if (j >= 0 && j < n)
            acc += GkAcc<float>::load(
                       reinterpret_cast<const TD*>(st + 16 * C + d * dbytes + sh)[e]) *
                   ring[(j - lo) & mask];
        };
        if constexpr (ND > 0) {
#pragma unroll
          for (int d = 0; d < ND; ++d) term(d, off[d], dsh[d]);
        } else {
          for (int d = 0; d < nd; ++d)
            term(d, (int)op.offs.off[d], esz == 4 ? 0 : (d & n & 1) * 2);
        }
        use(i, acc, ring[(i - lo) & mask], sv[3 * C + e]);
      }
    }
    if (t < nF) {
#pragma unroll
      for (int u = 0; u < RPT; ++u) {
        const int e = u * GK_CG_THREADS + tid;
        const int pos = t * C + e;
        if (pos < total) {
          const float v = form.value(sv, e);
          ring[pos & mask] = v;
          const int row = lo + pos;
          if (row >= a && row < a + len) form.own(row, v);
        }
      }
    }
  }
  gk_cp_wait<0>();
  __syncthreads();
}

template <typename TD, int ND>
__global__ void __launch_bounds__(GK_CG_THREADS)
    bicgstab_ring_kernel(const BicgstabParams<GkDiaOp<TD>> P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  __shared__ double sh1[1][GK_CG_WARPS];
  __shared__ double sh2[2][GK_CG_WARPS];
  __shared__ double sh3[3][GK_CG_WARPS];
  __shared__ double bc1[1];
  __shared__ double bc2[2];
  __shared__ double bc3[3];

  const int n = (int)P.n;
  const int G = gridDim.x;
  const int span = ((n + G - 1) / G + 7) & ~7;
  const int a = (int)blockIdx.x * span < n ? (int)blockIdx.x * span : n;
  const int len = n - a < span ? n - a : span;
  const int w = P.width, R = P.ring_rows;
  double* part_a = P.part;          // [G]     <rr, v>
  double* part_b = P.part + G;      // [3][G]  s.s, t.s, t.t
  double* part_c = P.part + 4 * G;  // [2][G]  <rr, r>, r.r (and the init)
  float* __restrict__ x = P.x;
  float* __restrict__ r = P.r;
  float* __restrict__ rr = P.rr;
  float* __restrict__ t = P.t;
  float* const pb[2] = {P.p, P.p1};
  float* const vb[2] = {P.v, P.v1};
  const float* __restrict__ minv = P.minv;

  // init: x = x0, r = rr = r0, p = v = 0 (the first p_old and v_old); rho =
  // <r0, r0>
  {
    double acc[2] = {0.0, 0.0};
    for (int i = a + threadIdx.x; i < a + len; i += GK_CG_THREADS) {
      const float ri = P.r0[i];
      x[i] = P.x0[i];
      r[i] = ri;
      rr[i] = ri;
      P.v[i] = 0.f;
      P.p[i] = 0.f;
      acc[0] += (double)ri * ri;
    }
    block_partial_vm<2>(acc, part_c, sh2);
  }
  grid.sync();
  double tot1[1], tot2[2], tot3[3];
  grid_total_batch<2, 4>(part_c, 1, G, 1, tot2, sh2, bc2);
  float rho_new = (float)tot2[0];
  float rho_old = 1.f, alpha = 1.f, omega = 1.f;

  const float tol_sq = *P.tol_sq;
  int it = 0;
  float mon = CUDART_INF_F;
  while (it < P.max_iters && !(mon <= tol_sq)) {
    const float beta = gk_sdiv(rho_new * alpha, rho_old * omega);
    const int cur = it & 1;
    float* p_new = pb[cur ^ 1];
    float* v_new = vb[cur ^ 1];

    // pass A: p_new = r + beta (p_old - omega v_old); v = (A M) p_new;
    // partial <rr, v>
    {
      double acc[1] = {0.0};
      const GkBcgFormP form{{r, pb[cur], vb[cur]}, p_new, beta, omega};
      gk_bcg_walk<TD, ND>(P.op, w, R, a, len, smem, form, rr,
                          [&](int i, float vi, float, float rri) {
                            v_new[i] = vi;
                            acc[0] += (double)rri * vi;
                          });
      block_partial_vm<1>(acc, part_a, sh1);
    }
    grid.sync();
    grid_total_batch<1, 4>(part_a, 1, G, 1, tot1, sh1, bc1);
    const float alpha_new = gk_sdiv(rho_new, (float)tot1[0]);

    // pass B: s = r - alpha v; t = (A M) s; partial s.s, t.s, t.t
    {
      double acc[3] = {0.0, 0.0, 0.0};
      const GkBcgFormS form{{r, v_new}, alpha_new};
      gk_bcg_walk<TD, ND>(P.op, w, R, a, len, smem, form, nullptr,
                          [&](int i, float ti, float si, float) {
                            t[i] = ti;
                            acc[0] += (double)si * si;
                            acc[1] += (double)ti * si;
                            acc[2] += (double)ti * ti;
                          });
      block_partial_vm<3>(acc, part_b, sh3);
    }
    grid.sync();
    grid_total_batch<3, 4>(part_b, 1, G, 3, tot3, sh3, bc3);
    const bool half_done = (P.implicit ? fabsf(rho_new) : (float)tot3[0]) <= tol_sq;
    const float omega_new = half_done ? 0.f : gk_sdiv((float)tot3[1], (float)tot3[2]);

    // pass C: x += alpha (M p) + omega (M s); r = s - omega t; partial
    // <rr, r> (the next rho) and r.r
    {
      // rows in groups of RPT a thread, every load of a group before its
      // arithmetic, so that the group's loads overlap
      constexpr int RPT = 8;
      double acc[2] = {0.0, 0.0};
      for (int i0 = a; i0 < a + len; i0 += RPT * GK_CG_THREADS) {
        float xi[RPT], pi[RPT], vi[RPT], ri[RPT], ti[RPT], rri[RPT], mi[RPT];
#pragma unroll
        for (int u = 0; u < RPT; ++u) {
          const int i = i0 + u * GK_CG_THREADS + threadIdx.x;
          if (i < a + len) {
            xi[u] = x[i];
            pi[u] = __ldcg(p_new + i);
            vi[u] = __ldcg(v_new + i);
            ri[u] = r[i];
            ti[u] = t[i];
            rri[u] = rr[i];
            mi[u] = minv ? minv[i] : 1.f;
          }
        }
#pragma unroll
        for (int u = 0; u < RPT; ++u) {
          const int i = i0 + u * GK_CG_THREADS + threadIdx.x;
          if (i >= a + len) continue;
          const float si = ri[u] - alpha_new * vi[u];
          const float yi = minv ? mi[u] * pi[u] : pi[u];
          const float zi = minv ? mi[u] * si : si;
          x[i] = xi[u] + alpha_new * yi + omega_new * zi;
          const float rn = si - omega_new * ti[u];
          r[i] = rn;
          acc[0] += (double)rri[u] * rn;
          acc[1] += (double)rn * rn;
        }
      }
      block_partial_vm<2>(acc, part_c, sh2);
    }
    grid.sync();
    grid_total_batch<2, 4>(part_c, 1, G, 2, tot2, sh2, bc2);
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
// together, the vectors (n, K) row-major as K4m's (cg_fused.cu), so each
// diagonal value is read once a row for all K columns and a row of K
// columns moves as one access (GkRow: 8 bytes at K = 2, 16 at K = 4, two
// 16-byte accesses at K = 8, K scalars at K = 3, 5, 6, 7).  Every scalar of
// K12 is a K-vector.  Three passes and three grid barriers an iteration,
// the order of K12's ring route:
//
//   A: P_new = R + beta (P_old - omega V_old) formed at every column a row
//      gathers, V = (A M) P_new on the own row; P_new and V written on the
//      own row; partial <rr, v>.
//   B: S = R - alpha V formed at every column a row gathers, T = (A M) S on
//      the own row; partial s.s, t.s and t.t in one fold, after which the
//      half step and omega are decided.
//   C: X += alpha (M P) + omega (M S) and R = S - omega T on the own row, S
//      formed again from R and V (the same operands, the same bits);
//      partial <rr, r> and r.r.
//
// A gathered row is formed by every thread that reads it, from vectors no
// thread writes in that pass: P and V alternate between two buffers (pass A
// reads P_old and V_old across rows while P_new and V are written), R
// changes only in pass C, and each pass ends at a grid barrier, which
// invalidates L1 (PERF.md section 6), so the gathers are plain loads.
//
// Per column, as the reference's stopping-status-masked step kernels:
//   - a stopped column keeps p, v, x and r bit for bit from its stop: pass A
//     forms P_new = P_old and takes V = V_old in it (a select, so a NaN of
//     the discarded value never reaches it), pass C writes its old x and r;
//     s and t are still computed for it, with alpha_eff = omega_eff = 0, and
//     its carried rho, alpha and omega stay;
//   - the half step fires per column (s.s, or |rho| in implicit mode, at
//     the threshold): omega = 0, carried as 1;
//   - each column records the iteration at which it stopped (itc);
//   - every monitor starts at +inf, so the first iteration always runs, and
//     the loop runs while it < max_iters and any column is active; a column
//     stays active while ~(mon <= tol).
//
// Bytes a row and iteration (nd diagonals of TD): A reads the diagonals, R,
// P_old, V_old and rr and writes P_new and V; B reads the diagonals, R and V
// and writes T; C reads X, R, P, V, T and rr and writes X and R:
// 2 nd sizeof(TD) + 68 K, plus 4 with minv (the five-pass design moved
// 2 nd sizeof(TD) + 72 K in 4-byte accesses).  A gathered row at offset +-1
// hits L1 or L2.  The partials are value-major (coop.cuh block_partial_vm)
// and each fold loads them at once (grid_total_batch).  The kernel is held
// at K4m's blocks an SM (coop.cuh GK_CG_MULTI_MIN_BLOCKS).

// Pass A's row j: p_new = r + beta (p_old - omega v_old) in an active
// column, p_old in a stopped one; v_old of the row in vo.  The rows are
// plain loads: no thread writes them in the pass, and the grid barrier
// before it invalidates L1 (__ldcg ran 3-4% slower at K = 2 and 4, and
// spilled at K = 8, 50% slower).
template <int K>
__device__ __forceinline__ void gk_bcg_form_p(const float* r, const float* p_old,
                                              const float* v_old, const float (&beta)[K],
                                              const float (&omega)[K], const bool (&act)[K],
                                              long long j, float (&out)[K], float (&vo)[K]) {
  float rj[K];
  GkRow<K>::load(r, j, rj);
  GkRow<K>::load(p_old, j, out);
  GkRow<K>::load(v_old, j, vo);
#pragma unroll
  for (int c = 0; c < K; ++c)
    if (act[c]) out[c] = rj[c] + beta[c] * (out[c] - omega[c] * vo[c]);
}

// Pass B's row j: s = r - alpha_eff v in every column.
template <int K>
__device__ __forceinline__ void gk_bcg_form_s(const float* r, const float* v,
                                              const float (&alpha_eff)[K], long long j,
                                              float (&out)[K]) {
  float vj[K];
  GkRow<K>::load(r, j, out);
  GkRow<K>::load(v, j, vj);
#pragma unroll
  for (int c = 0; c < K; ++c) out[c] = out[c] - alpha_eff[c] * vj[c];
}

template <typename TD, int K>
__global__ void __launch_bounds__(GK_CG_THREADS, GK_CG_MULTI_MIN_BLOCKS(K))
    bicgstab_fused_multi_kernel(const BicgstabParams<GkDiaOp<TD>> P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[K][GK_CG_WARPS];
  __shared__ double sh2[2 * K][GK_CG_WARPS];
  __shared__ double sh3[3 * K][GK_CG_WARPS];
  __shared__ double bc1[K];
  __shared__ double bc2[2 * K];
  __shared__ double bc3[3 * K];

  const TD* __restrict__ D = P.op.diags;
  const long long n = P.n;
  const int nd = P.op.offs.nd;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int G = gridDim.x;
  double* part_a = P.part;              // [K][G]   <rr, v>
  double* part_b = P.part + K * G;      // [3K][G]  s.s, t.s, t.t
  double* part_c = P.part + 4 * K * G;  // [2K][G]  <rr, r>, r.r (and the init)
  float* __restrict__ x = P.x;
  float* __restrict__ r = P.r;
  float* __restrict__ rr = P.rr;
  float* __restrict__ t = P.t;
  float* const pb[2] = {P.p, P.p1};
  float* const vb[2] = {P.v, P.v1};
  const float* __restrict__ minv = P.minv;

  // init: X = X0, R = RR = R0, P = V = 0 (the first P_old and V_old); rho_c =
  // <r0_c, r0_c>
  {
    double acc[2 * K];
#pragma unroll
    for (int c = 0; c < 2 * K; ++c) acc[c] = 0.0;
    float zero[K];
#pragma unroll
    for (int c = 0; c < K; ++c) zero[c] = 0.f;
    for (long long i = t0; i < n; i += stride) {
      // the caller's r0 and x0 need not be 16-byte aligned
      float ri[K], xi[K];
#pragma unroll
      for (int c = 0; c < K; ++c) {
        ri[c] = P.r0[i * K + c];
        xi[c] = P.x0[i * K + c];
      }
      GkRow<K>::store(x, i, xi);
      GkRow<K>::store(r, i, ri);
      GkRow<K>::store(rr, i, ri);
      GkRow<K>::store(P.v, i, zero);
      GkRow<K>::store(P.p, i, zero);
#pragma unroll
      for (int c = 0; c < K; ++c) acc[c] += (double)ri[c] * ri[c];
    }
    block_partial_vm<2 * K>(acc, part_c, sh2);
  }
  grid.sync();
  double tot1[K], tot2[2 * K], tot3[3 * K];
  grid_total_batch<2 * K, GK_CG_FOLD_BATCH(2 * K)>(part_c, 1, G, K, tot2, sh2, bc2);
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
    const int cur = it & 1;
    const float* p_old = pb[cur];
    const float* v_old = vb[cur];
    float* p_new = pb[cur ^ 1];
    float* v_new = vb[cur ^ 1];

    // pass A: P_new formed at every gathered row; V = (A M) P_new in the
    // active columns, V_old in the stopped ones; partial <rr, v>
    {
      double acc[K];
#pragma unroll
      for (int c = 0; c < K; ++c) acc[c] = 0.0;
      for (long long i = t0; i < n; i += stride) {
        float av[K];
#pragma unroll
        for (int c = 0; c < K; ++c) av[c] = 0.f;
        for (int d = 0; d < nd; ++d) {
          const long long j = i + P.op.offs.off[d];
          if (j >= 0 && j < n) {
            const float a = GkAcc<float>::load(D[d * n + i]);
            float pj[K], vj[K];
            gk_bcg_form_p<K>(r, p_old, v_old, beta, omega, act, j, pj, vj);
#pragma unroll
            for (int c = 0; c < K; ++c) av[c] += a * pj[c];
          }
        }
        float pi[K], vi[K], rri[K];
        gk_bcg_form_p<K>(r, p_old, v_old, beta, omega, act, i, pi, vi);
        GkRow<K>::load(rr, i, rri);
#pragma unroll
        for (int c = 0; c < K; ++c) {
          if (act[c]) vi[c] = av[c];
          acc[c] += (double)rri[c] * vi[c];
        }
        GkRow<K>::store(p_new, i, pi);
        GkRow<K>::store(v_new, i, vi);
      }
      block_partial_vm<K>(acc, part_a, sh1);
    }
    grid.sync();
    grid_total_batch<K, GK_CG_FOLD_BATCH(K)>(part_a, 1, G, K, tot1, sh1, bc1);
    float alpha_new[K], alpha_eff[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      alpha_new[c] = act[c] ? gk_sdiv(rho_new[c], (float)tot1[c]) : alpha[c];
      alpha_eff[c] = act[c] ? alpha_new[c] : 0.f;
    }

    // pass B: S formed at every gathered row; T = (A M) S; partial s.s, t.s,
    // t.t
    {
      double acc[3 * K];
#pragma unroll
      for (int c = 0; c < 3 * K; ++c) acc[c] = 0.0;
      for (long long i = t0; i < n; i += stride) {
        float at[K];
#pragma unroll
        for (int c = 0; c < K; ++c) at[c] = 0.f;
        for (int d = 0; d < nd; ++d) {
          const long long j = i + P.op.offs.off[d];
          if (j >= 0 && j < n) {
            const float a = GkAcc<float>::load(D[d * n + i]);
            float sj[K];
            gk_bcg_form_s<K>(r, v_new, alpha_eff, j, sj);
#pragma unroll
            for (int c = 0; c < K; ++c) at[c] += a * sj[c];
          }
        }
        float si[K];
        gk_bcg_form_s<K>(r, v_new, alpha_eff, i, si);
        GkRow<K>::store(t, i, at);
#pragma unroll
        for (int c = 0; c < K; ++c) {
          acc[c] += (double)si[c] * si[c];
          acc[K + c] += (double)at[c] * si[c];
          acc[2 * K + c] += (double)at[c] * at[c];
        }
      }
      block_partial_vm<3 * K>(acc, part_b, sh3);
    }
    grid.sync();
    grid_total_batch<3 * K, GK_CG_FOLD_BATCH(3 * K)>(part_b, 1, G, 3 * K, tot3, sh3, bc3);
    bool half_done[K];
    float omega_eff[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      half_done[c] = act[c] && ((P.implicit ? fabsf(rho_new[c]) : (float)tot3[c]) <= tol[c]);
      omega_eff[c] = (act[c] && !half_done[c])
                         ? gk_sdiv((float)tot3[K + c], (float)tot3[2 * K + c])
                         : 0.f;
    }

    // pass C: X += alpha (M P) + omega (M S), R = S - omega T in the active
    // columns; partial <rr, r> (the next rho) and r.r
    {
      double acc[2 * K];
#pragma unroll
      for (int c = 0; c < 2 * K; ++c) acc[c] = 0.0;
      for (long long i = t0; i < n; i += stride) {
        const float mi = minv ? minv[i] : 1.f;
        float xi[K], ri[K], pi[K], vi[K], ti[K], rri[K];
        GkRow<K>::load(x, i, xi);
        GkRow<K>::load(r, i, ri);
        GkRow<K>::load(p_new, i, pi);
        GkRow<K>::load(v_new, i, vi);
        GkRow<K>::load(t, i, ti);
        GkRow<K>::load(rr, i, rri);
#pragma unroll
        for (int c = 0; c < K; ++c) {
          const float si = ri[c] - alpha_eff[c] * vi[c];
          if (act[c]) {
            const float yi = minv ? mi * pi[c] : pi[c];
            const float zi = minv ? mi * si : si;
            xi[c] = xi[c] + alpha_eff[c] * yi + omega_eff[c] * zi;
            ri[c] = si - omega_eff[c] * ti[c];
          }
          acc[c] += (double)rri[c] * ri[c];
          acc[K + c] += (double)ri[c] * ri[c];
        }
        GkRow<K>::store(x, i, xi);
        GkRow<K>::store(r, i, ri);
      }
      block_partial_vm<2 * K>(acc, part_c, sh2);
    }
    grid.sync();
    grid_total_batch<2 * K, GK_CG_FOLD_BATCH(2 * K)>(part_c, 1, G, 2 * K, tot2, sh2, bc2);
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
  P.p1 = nullptr;
  P.v1 = nullptr;
  P.ring_rows = 0;
  P.width = 0;
  P.part = part;
  P.it_out = it_out;
  P.mon_out = mon_out;
  P.conv_out = conv_out;
  P.itc_out = itc_out;
  return P;
}

// Blocks of the five-pass kernel's cooperative grid (the wrapper sizes the
// partial sums, 6 doubles per block, from it).
extern "C" int bicgstab_fused_grid(int d_dtype, int* blocks) {
  if (d_dtype == GK_F32) return gk_coop_blocks(bicgstab_fused_kernel<GkDiaOp<float>>, blocks);
  if (d_dtype == GK_BF16)
    return gk_coop_blocks(bicgstab_fused_kernel<GkDiaOp<__nv_bfloat16>>, blocks);
  return (int)cudaErrorInvalidValue;
}

// f(kernel, (TD*)nullptr) on the ring kernel for the diagonals' dtype TD
// and count: compiled for the 3 and 5 diagonals of 1-D and 2-D stencils,
// else with a runtime count.
template <typename F>
static int bicgstab_ring_dispatch(int d_dtype, int nd, F f) {
#define GK_RING_ND(TD)                                                   \
  switch (nd) {                                                          \
    case 3: return f(bicgstab_ring_kernel<TD, 3>, (TD*)nullptr);         \
    case 5: return f(bicgstab_ring_kernel<TD, 5>, (TD*)nullptr);         \
    default: return f(bicgstab_ring_kernel<TD, 0>, (TD*)nullptr);        \
  }
  if (d_dtype == GK_F32) GK_RING_ND(float)
  if (d_dtype == GK_BF16) GK_RING_ND(__nv_bfloat16)
#undef GK_RING_ND
  return (int)cudaErrorInvalidValue;
}

// The ring route's launch for nd diagonals of d_dtype and a ring of
// ring_rows rows, into out: blocks of the cooperative grid, threads a
// block, dynamic shared memory a block, blocks an SM, registers a thread.
// The route itself is chosen from the offsets by ops/bicgstab.ring_plan.
extern "C" int bicgstab_ring_config(int d_dtype, int nd, int ring_rows, long long* out) {
  if (nd < 1 || nd > GK_MAX_DIAGS || ring_rows < 1 || ring_rows > GK_BCG_MAX_RING ||
      (ring_rows & (ring_rows - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = gk_bcg_smem(ring_rows, nd, d_dtype == GK_BF16 ? 2 : 4);
  return bicgstab_ring_dispatch(d_dtype, nd, [&](auto kernel, auto*) {
    GkOccupancy o;
    const int e = gk_occupancy(kernel, smem, GK_CG_THREADS, &o);
    if (e != 0) return e;
    if (o.per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    const long long v[5] = {(long long)o.per_sm * o.sms, GK_CG_THREADS, smem, o.per_sm,
                            o.regs};
    for (int i = 0; i < 5; ++i) out[i] = v[i];
    return 0;
  });
}

// K12 on a Dia: the ring route where ring_rows > 0 (p1 and v1 the second
// direction and product buffers, s unused), else the five-pass kernel (p1
// and v1 unused).  The ring must be a power of two >= 2 w + 3 C rows (w =
// max |offset|) within GK_BCG_MAX_RING, as ring_plan sizes it.
extern "C" int bicgstab_fused_solve(
    const void* diags, int d_dtype, const long long* offsets, int nd, long long n,
    const float* r0, const float* x0, const float* minv, const float* tol_sq,
    int max_iters, int implicit, float* x, float* r, float* rr, float* v,
    float* t, float* p, float* s, float* p1, float* v1, int ring_rows, double* part,
    int blocks, int* it_out, float* mon_out, int* conv_out, void* stream) {
  if (nd < 1 || nd > GK_MAX_DIAGS || blocks < 1) return (int)cudaErrorInvalidValue;
  if (ring_rows > 0) {
    long long w = 0;
    for (int d = 0; d < nd; ++d) {
      const long long m = offsets[d] < 0 ? -offsets[d] : offsets[d];
      w = m > w ? m : w;
    }
    if (ring_rows > GK_BCG_MAX_RING || (ring_rows & (ring_rows - 1)) != 0 ||
        ring_rows < 2 * w + 3LL * GK_BCG_CHUNK || n + ring_rows >= (1LL << 30) ||
        !p1 || !v1)
      return (int)cudaErrorInvalidValue;
    const long long smem = gk_bcg_smem(ring_rows, nd, d_dtype == GK_BF16 ? 2 : 4);
    return bicgstab_ring_dispatch(d_dtype, nd, [&](auto kernel, auto* tag) {
      using TD = std::remove_pointer_t<decltype(tag)>;
      auto P = bicgstab_params(gk_dia_op<TD>(diags, offsets, nd, n), n, r0, x0, minv, tol_sq,
                               max_iters, implicit, x, r, rr, v, t, p, s, part, it_out,
                               mon_out, conv_out, nullptr);
      P.p1 = p1;
      P.v1 = v1;
      P.ring_rows = ring_rows;
      P.width = (int)w;
      const int e = gk_smem_optin(kernel, smem);
      if (e != 0) return e;
      return gk_coop_launch(kernel, P, blocks, stream, (size_t)smem);
    });
  }
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

// ---------------------------------------------------------------------------
// K19 on a Pell: five passes and five grid barriers an iteration, as the
// five-pass kernel, on K7's chunked rows (pell.cuh GkPellChunks: chunks of
// GK_PELL_CHUNK_ROWS rows a thread, 32-bit rows).  Every pass walks the
// thread's own rows in the same chunk order, so p, s, v, t, r and x are
// read back only by the thread that wrote them, with plain loads; the two
// products gather p and s across rows with plain loads after the barrier
// that follows their pass (grid.sync() invalidates L1), the tile's slot
// range and bases read once for a thread's rows.  Pass 3's s.s partial is
// folded with pass 4's t.s and t.t after pass 4's barrier (one fold where
// two, as the ring route's pass B): the half step decides only omega,
// which pass 5 first reads.
//
//   1: p = r + beta (p - omega v)
//   2: v = A (M p); partial <rr, v>; fold -> alpha
//   3: s = r - alpha v; partial s.s
//   4: t = A (M s); partial t.s, t.t; fold of s.s, t.s, t.t -> omega
//   5: x += alpha (M p) + omega (M s); r = s - omega t; partial <rr, r>,
//      r.r; fold -> the next rho and the monitor
//
// M = diag(minv) is applied explicitly (PELL values have no column fold),
// staged as the TPU kernel stages it: y = M p in pass 1 and z = M s in
// pass 3, one float32 product an entry, which the products gather and pass
// 5 adds to x.  Multiplying minv[col] into every gathered value instead
// (no y or z) ran 21% slower an iteration with Jacobi on the H100 at the
// same 3 blocks an SM (PERF.md section 6): it doubles the gathers.  Bytes
// a row and iteration, the plan apart: 76 with the Identity (1: r, p, v
// in, p out; 2: p gathered, rr in, v out; 3: r, v in, s out; 4: s
// gathered, t out; 5: x, p, s, t, rr in, x, r out), 100 with Jacobi (minv
// in passes 1 and 3, y and z out, gathered and read in pass 5).
struct PellBicgstabParams {
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
  float* v;
  float* t;
  float* p;
  float* s;
  float* y;  // M p and M s with Jacobi, else unused
  float* z;
  double* part;  // 6 * gridDim.x per-block partial sums
  int* it_out;
  float* mon_out;
  int* conv_out;
};

using BcgChunks = GkPellChunks<GK_CG_THREADS>;

template <typename TV, typename TQ>
__global__ void __launch_bounds__(GK_CG_THREADS, GK_PELL_KRYLOV_MIN_BLOCKS)
    pell_bicgstab_fused_kernel(const PellBicgstabParams P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[1][GK_CG_WARPS];
  __shared__ double sh2[2][GK_CG_WARPS];
  __shared__ double sh3[3][GK_CG_WARPS];
  __shared__ double bc1[1];
  __shared__ double bc2[2];
  __shared__ double bc3[3];

  const TV* __restrict__ values = static_cast<const TV*>(P.values);
  const TQ* __restrict__ qidx = static_cast<const TQ*>(P.qidx);
  const int n = P.n;
  const int B = gridDim.x;
  const int chunks = (n + BcgChunks::kChunk - 1) / BcgChunks::kChunk;
  double* part_rv = P.part;         // [B]     <rr, v>
  double* part_st = P.part + B;     // [3][B]  s.s (pass 3), t.s, t.t (pass 4)
  double* part_u = P.part + 4 * B;  // [2][B]  <rr, r>, r.r (and the init)
  float* __restrict__ x = P.x;
  float* __restrict__ r = P.r;
  float* __restrict__ rr = P.rr;
  float* __restrict__ v = P.v;
  float* __restrict__ t = P.t;
  float* p = P.p;
  float* s = P.s;
  float* y = P.y;
  float* z = P.z;
  const float* __restrict__ minv = P.minv;
  const bool jac = minv != nullptr;
  // what the products gather: M p and M s
  const float* gp = jac ? y : p;
  const float* gs = jac ? z : s;

  // init: x = x0, r = rr = r0, p = v = 0; rho = <r0, r0>
  {
    double a[1] = {0.0};
    BcgChunks::own_rows(n, [&](int i) {
      const float ri = P.r0[i];
      x[i] = P.x0[i];
      r[i] = ri;
      rr[i] = ri;
      v[i] = 0.f;
      p[i] = 0.f;
      a[0] += (double)ri * ri;
    });
    block_partial_vm<1>(a, part_u, sh1);
  }
  grid.sync();
  double tot1[1], tot2[2], tot3[3];
  grid_total_batch<1, 4>(part_u, 1, B, 1, tot1, sh1, bc1);
  float rho_new = (float)tot1[0];
  float rho_old = 1.f, alpha = 1.f, omega = 1.f;

  const float tol_sq = *P.tol_sq;
  int it = 0;
  float mon = CUDART_INF_F;
  while (it < P.max_iters && !(mon <= tol_sq)) {
    const float beta = gk_sdiv(rho_new * alpha, rho_old * omega);

    // pass 1: p = r + beta (p - omega v); y = M p
    BcgChunks::own_rows(n, [&](int i) {
      const float pi = r[i] + beta * (p[i] - omega * v[i]);
      p[i] = pi;
      if (jac) y[i] = minv[i] * pi;
    });
    grid.sync();

    // pass 2: v = A (M p); partial <rr, v>
    {
      double a[1] = {0.0};
      for (int c = blockIdx.x; c < chunks; c += B) {
        float av[GK_PELL_CHUNK_ROWS];
        BcgChunks::spmv<TV, TQ>(values, qidx, P.bases, P.tile_ptr, P.S, P.G, n, gp, c, av);
#pragma unroll
        for (int q = 0; q < GK_PELL_CHUNK_ROWS; ++q) {
          const int i = BcgChunks::row(c, q);
          if (i < n) {
            v[i] = av[q];
            a[0] += (double)rr[i] * av[q];
          }
        }
      }
      block_partial_vm<1>(a, part_rv, sh1);
    }
    grid.sync();
    grid_total_batch<1, 4>(part_rv, 1, B, 1, tot1, sh1, bc1);
    const float alpha_new = gk_sdiv(rho_new, (float)tot1[0]);

    // pass 3: s = r - alpha v; z = M s; partial s.s, folded after pass 4
    {
      double a[1] = {0.0};
      BcgChunks::own_rows(n, [&](int i) {
        const float si = r[i] - alpha_new * v[i];
        s[i] = si;
        if (jac) z[i] = minv[i] * si;
        a[0] += (double)si * si;
      });
      block_partial_vm<1>(a, part_st, sh1);
    }
    grid.sync();

    // pass 4: t = A (M s); partial t.s, t.t
    {
      double a[2] = {0.0, 0.0};
      for (int c = blockIdx.x; c < chunks; c += B) {
        float at[GK_PELL_CHUNK_ROWS];
        BcgChunks::spmv<TV, TQ>(values, qidx, P.bases, P.tile_ptr, P.S, P.G, n, gs, c, at);
#pragma unroll
        for (int q = 0; q < GK_PELL_CHUNK_ROWS; ++q) {
          const int i = BcgChunks::row(c, q);
          if (i < n) {
            t[i] = at[q];
            const float si = s[i];
            a[0] += (double)at[q] * si;
            a[1] += (double)at[q] * at[q];
          }
        }
      }
      block_partial_vm<2>(a, part_st + B, sh2);
    }
    grid.sync();
    grid_total_batch<3, 4>(part_st, 1, B, 3, tot3, sh3, bc3);
    const bool half_done = (P.implicit ? fabsf(rho_new) : (float)tot3[0]) <= tol_sq;
    const float omega_new = half_done ? 0.f : gk_sdiv((float)tot3[1], (float)tot3[2]);

    // pass 5: x += alpha (M p) + omega (M s); r = s - omega t; partial
    // <rr, r> (the next rho) and r.r
    {
      double a[2] = {0.0, 0.0};
      BcgChunks::own_rows(n, [&](int i) {
        const float si = s[i];
        const float yi = jac ? y[i] : p[i];
        const float zi = jac ? z[i] : si;
        x[i] = x[i] + alpha_new * yi + omega_new * zi;
        const float ri = si - omega_new * t[i];
        r[i] = ri;
        a[0] += (double)rr[i] * ri;
        a[1] += (double)ri * ri;
      });
      block_partial_vm<2>(a, part_u, sh2);
    }
    grid.sync();
    grid_total_batch<2, 4>(part_u, 1, B, 2, tot2, sh2, bc2);
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

// K19: blocks of the cooperative grid (6 doubles of partial sums a block).
extern "C" int pell_bicgstab_fused_grid(int v_dtype, int q_dtype, int* blocks) {
  GK_PELL_VQ_DISPATCH(v_dtype, q_dtype,
                      gk_coop_blocks(pell_bicgstab_fused_kernel<TV, TQ>, blocks));
}

// K19's launch: out = {blocks of the cooperative grid, threads a block,
// blocks an SM, registers a thread}.
extern "C" int pell_bicgstab_fused_config(int v_dtype, int q_dtype, int* out) {
  GK_PELL_VQ_DISPATCH(v_dtype, q_dtype,
                      gk_coop_config(pell_bicgstab_fused_kernel<TV, TQ>, out));
}

// K19: BiCGSTAB on a square Pell (values float32/bfloat16, lane indices
// int8/int32), M = diag(minv) applied explicitly (minv nullptr: Identity;
// y and z, M p and M s, are used only with minv).
extern "C" int pell_bicgstab_fused_solve(
    const void* values, int v_dtype, const void* qidx, int q_dtype, const int* bases,
    const int* tile_ptr, int S, int G, long long n, const float* r0, const float* x0,
    const float* minv, const float* tol_sq, int max_iters, int implicit, float* x, float* r,
    float* rr, float* v, float* t, float* p, float* s, float* y, float* z, double* part,
    int blocks, int* it_out, float* mon_out, int* conv_out, void* stream) {
  // rows are 32-bit, with room for a chunk past the last row
  if (S < 1 || G < 1 || blocks < 1 || n < 0 || n > 0x7fffffffLL - BcgChunks::kChunk ||
      (minv != nullptr && (y == nullptr || z == nullptr)))
    return (int)cudaErrorInvalidValue;
  PellBicgstabParams P;
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
  P.v = v;
  P.t = t;
  P.p = p;
  P.s = s;
  P.y = y;
  P.z = z;
  P.part = part;
  P.it_out = it_out;
  P.mon_out = mon_out;
  P.conv_out = conv_out;
  GK_PELL_VQ_DISPATCH(v_dtype, q_dtype,
                      gk_coop_launch(pell_bicgstab_fused_kernel<TV, TQ>, P, blocks, stream));
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
                        float* rr, float* v, float* t, float* p, float* p1, float* v1,
                        double* part, int blocks, int* it_out, float* mon_out, int* conv_out,
                        int* itc_out, void* stream) {
  auto P = bicgstab_params(gk_dia_op<TD>(diags, offsets, nd, n), n, r0, x0, minv, tol_sq,
                           max_iters, implicit, x, r, rr, v, t, p, nullptr, part, it_out,
                           mon_out, conv_out, itc_out);
  P.p1 = p1;
  P.v1 = v1;
  return gk_coop_launch(bicgstab_fused_multi_kernel<TD, K>, P, blocks, stream);
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

// K12m: vectors (n, k) row-major; p and p1, v and v1 the two buffers of the
// direction and of its product.
extern "C" int bicgstab_fused_multi_solve(
    const void* diags, int d_dtype, const long long* offsets, int nd, long long n, int k,
    const float* r0, const float* x0, const float* minv, const float* tol_sq,
    int max_iters, int implicit, float* x, float* r, float* rr, float* v,
    float* t, float* p, float* p1, float* v1, double* part, int blocks, int* it_out,
    float* mon_out, int* conv_out, int* itc_out, void* stream) {
  if (nd < 1 || nd > GK_MAX_DIAGS || blocks < 1 || !p1 || !v1) return (int)cudaErrorInvalidValue;
#define GK_LAUNCH_TD_K(TD, K)                                                             \
  multi_launch<TD, K>(diags, offsets, nd, n, r0, x0, minv, tol_sq, max_iters, implicit, x, \
                      r, rr, v, t, p, p1, v1, part, blocks, it_out, mon_out, conv_out,       \
                      itc_out, stream)
#define GK_LAUNCH_F32_K(K) GK_LAUNCH_TD_K(float, K)
#define GK_LAUNCH_BF16_K(K) GK_LAUNCH_TD_K(__nv_bfloat16, K)
  if (d_dtype == GK_F32) GK_SWITCH_K(k, GK_LAUNCH_F32_K)
  if (d_dtype == GK_BF16) GK_SWITCH_K(k, GK_LAUNCH_BF16_K)
#undef GK_LAUNCH_BF16_K
#undef GK_LAUNCH_F32_K
#undef GK_LAUNCH_TD_K
  return (int)cudaErrorInvalidValue;
}
