// Whole-solve CG / FCG in one persistent cooperative kernel: kernel K4 of the
// PyTorch port, and its k-RHS form K4m (below).
//
// Replaces ginkgo_tpu/ops/pallas_cg.py cg_vmem_solve (_cg_kernel): the whole
// Krylov loop, the preconditioner (Identity or an inverse diagonal) and the
// stop test run on the device, with no host round trip per iteration.
//
// What bounds it on the H100: bytes.  One SM cannot hold the solve's state
// (the TPU kernel keeps it all in 128 MiB of VMEM), so x, r, p, q and the
// diagonals live in device memory and L2.  Per iteration the three passes
// move (nd * sizeof(TD) + 44) * n bytes, 52 instead of 44 with an inverse
// diagonal: A p reads the diagonals and p and writes q; the update reads x,
// p, q, r (and minv) and writes x and r; the direction update reads r (and
// minv) and p and writes p.
//
// What the design does about it: the grid is sized to what the SMs hold at
// once (occupancy x SM count) and launched cooperatively, so the loop runs
// inside the kernel and the three passes are separated by grid-wide
// barriers (cooperative_groups::this_grid().sync()) instead of kernel
// launches and host syncs.  Every row belongs to the same thread in every
// pass, so x, r and q are only ever read back by the thread that wrote them;
// p is read across rows by the SpMV and is loaded with __ldcg (L2, never a
// stale L1 line).  The dot products follow coop.cuh: float64 per-block
// partials that every block sums in the same fixed order.
//
// Semantics kept from _cg_kernel (ops/pallas_cg.py:96-221):
//   - the monitor starts at +inf, so the first iteration always runs;
//   - the loop runs while it < max_iters && !(mon <= tol_sq): a NaN monitor
//     keeps iterating, and a negative tol_sq runs to max_iters;
//   - implicit mode monitors |rho| from before the update;
//   - zero denominators give 0 (_sdiv);
//   - converged = (mon <= tol_sq).

#include "coop.cuh"

namespace cg = cooperative_groups;

struct CgParams {
  const void* diags;
  GkOffsets offs;
  long long n;
  const float* r0;
  const float* x0;
  const float* minv;    // nullptr: Identity
  const float* tol_sq;  // device scalar
  int max_iters;
  int implicit;
  int flexible;
  float* x;
  float* r;
  float* p;
  float* q;
  double* part;  // 4 * gridDim.x per-block partial sums
  int* it_out;
  float* mon_out;
  int* conv_out;
};

struct CgMultiParams {
  const void* diags;
  GkOffsets offs;
  long long n;
  const float* r0;      // (n, K) row-major
  const float* x0;      // (n, K)
  const float* minv;    // (n,) or nullptr: Identity
  const float* tol_sq;  // (K,) per-column thresholds on the device
  int max_iters;
  int implicit;
  int flexible;
  float* x;
  float* r;
  float* p;
  float* q;
  double* part;  // 4 * K * gridDim.x per-block partial sums
  int* it_out;
  float* mon_out;  // (K,)
  int* conv_out;   // (K,)
  int* itc_out;    // (K,) iteration at which each column stopped
};

template <typename TD>
__global__ void __launch_bounds__(GK_CG_THREADS)
    cg_fused_kernel(const CgParams P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[1][GK_CG_WARPS];
  __shared__ double sh3[3][GK_CG_WARPS];
  __shared__ double bc1[1];
  __shared__ double bc3[3];

  const TD* __restrict__ D = static_cast<const TD*>(P.diags);
  const long long n = P.n;
  const int nd = P.offs.nd;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  double* part1 = P.part;                  // [gridDim.x]     p.q
  double* part3 = P.part + gridDim.x;      // [gridDim.x][3]  rho, r.r, rho_t
  float* __restrict__ x = P.x;
  float* __restrict__ r = P.r;
  float* p = P.p;
  float* __restrict__ q = P.q;
  const float* __restrict__ minv = P.minv;

  // init: x = x0, r = r0, p = z = M r; rho = r.z, rr = r.r
  {
    double s[3] = {0.0, 0.0, 0.0};
    for (long long i = t0; i < n; i += stride) {
      const float ri = P.r0[i];
      const float zi = minv ? minv[i] * ri : ri;
      x[i] = P.x0[i];
      r[i] = ri;
      p[i] = zi;
      s[0] += (double)ri * zi;
      s[1] += (double)ri * ri;
    }
    block_partial<3>(s, part3, sh3);
  }
  grid.sync();
  double tot3[3];
  grid_total<3>(part3, tot3, sh3, bc3);
  float rho = (float)tot3[0];

  const float tol_sq = *P.tol_sq;
  int it = 0;
  float mon = CUDART_INF_F;
  while (it < P.max_iters && !(mon <= tol_sq)) {
    // pass 1: q = A p, partial p.q
    {
      double s[1] = {0.0};
      for (long long i = t0; i < n; i += stride) {
        float acc = 0.f;
        for (int d = 0; d < nd; ++d) {
          const long long j = i + P.offs.off[d];
          if (j >= 0 && j < n) {
            acc += GkAcc<float>::load(D[d * n + i]) * __ldcg(p + j);
          }
        }
        q[i] = acc;
        s[0] += (double)__ldcg(p + i) * acc;
      }
      block_partial<1>(s, part1, sh1);
    }
    grid.sync();
    double tot1[1];
    grid_total<1>(part1, tot1, sh1, bc1);
    const float alpha = gk_sdiv(rho, (float)tot1[0]);

    // pass 2: x += alpha p, r -= alpha q; partial rho_new, r.r and, for
    // FCG, the Polak-Ribiere numerator (r_new - r_old).z_new
    {
      double s[3] = {0.0, 0.0, 0.0};
      for (long long i = t0; i < n; i += stride) {
        const float pi = __ldcg(p + i);
        x[i] = x[i] + alpha * pi;
        const float ro = r[i];
        const float rn = ro - alpha * q[i];
        r[i] = rn;
        const float zi = minv ? minv[i] * rn : rn;
        s[0] += (double)rn * zi;
        s[1] += (double)rn * rn;
        if (P.flexible) s[2] += (double)(rn - ro) * zi;
      }
      block_partial<3>(s, part3, sh3);
    }
    grid.sync();
    grid_total<3>(part3, tot3, sh3, bc3);
    const float rho_new = (float)tot3[0];
    const float rr_new = (float)tot3[1];
    const float beta = gk_sdiv(P.flexible ? (float)tot3[2] : rho_new, rho);

    // pass 3: p = z + beta p (z recomputed from r)
    for (long long i = t0; i < n; i += stride) {
      const float ri = r[i];
      const float zi = minv ? minv[i] * ri : ri;
      p[i] = zi + beta * __ldcg(p + i);
    }
    mon = P.implicit ? fabsf(rho) : rr_new;
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

// k-RHS CG / FCG with per-column stopping: kernel K4m.
//
// Replaces ginkgo_tpu/ops/pallas_cg.py cg_vmem_solve_multi
// (_cg_multi_kernel, :257-424): K columns (2 <= K <= 8) solved together in
// K4's three passes.  The vectors are (n, K) row-major, so each diagonal
// value is read once per row for all K columns and a row's K entries are
// one contiguous run.  Each column has its own rho, alpha and beta and its
// own active flag (the reference's stopping-status byte): a stopped column
// gets alpha = 0 (x += 0 p and r -= 0 q still run, as in the TPU kernel,
// :351-358), its p stays frozen (:386-389), and it records the iteration
// at which it stopped (itc).  The loop runs while it < max_iters and any
// column is active; a column's stop test is !(mon_j <= tol_j), so a NaN
// monitor stays active.  Bytes per iteration: (nd * sizeof(TD) + 44 K) n,
// plus 12 n with an inverse diagonal.
template <typename TD, int K>
__global__ void __launch_bounds__(GK_CG_THREADS)
    cg_fused_multi_kernel(const CgMultiParams P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[K][GK_CG_WARPS];
  __shared__ double sh3[3 * K][GK_CG_WARPS];
  __shared__ double bc1[K];
  __shared__ double bc3[3 * K];

  const TD* __restrict__ D = static_cast<const TD*>(P.diags);
  const long long n = P.n;
  const int nd = P.offs.nd;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  double* part1 = P.part;                  // [gridDim.x][K]   p.q
  double* part3 = P.part + gridDim.x * K;  // [gridDim.x][3K]  rho, r.r, rho_t
  float* __restrict__ x = P.x;
  float* __restrict__ r = P.r;
  float* p = P.p;
  float* __restrict__ q = P.q;
  const float* __restrict__ minv = P.minv;

  double tot1[K];
  double tot3[3 * K];
  float rho[K], tol[K], mon[K];
  bool act[K];
  int itc[K];

  // init: X = X0, R = R0, P = Z = M R; rho_c = r_c.z_c
  {
    double s[3 * K];
#pragma unroll
    for (int c = 0; c < 3 * K; ++c) s[c] = 0.0;
    for (long long i = t0; i < n; i += stride) {
      const float mi = minv ? minv[i] : 1.f;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const long long e = i * K + c;
        const float ri = P.r0[e];
        const float zi = minv ? mi * ri : ri;
        x[e] = P.x0[e];
        r[e] = ri;
        p[e] = zi;
        s[c] += (double)ri * zi;
        s[K + c] += (double)ri * ri;
      }
    }
    block_partial<3 * K>(s, part3, sh3);
  }
  grid.sync();
  grid_total<3 * K>(part3, tot3, sh3, bc3);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    rho[c] = (float)tot3[c];
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

    // pass 1: Q = A P, each diagonal value read once for all K columns
    {
      double s[K];
#pragma unroll
      for (int c = 0; c < K; ++c) s[c] = 0.0;
      for (long long i = t0; i < n; i += stride) {
        float acc[K];
#pragma unroll
        for (int c = 0; c < K; ++c) acc[c] = 0.f;
        for (int d = 0; d < nd; ++d) {
          const long long j = i + P.offs.off[d];
          if (j >= 0 && j < n) {
            const float v = GkAcc<float>::load(D[d * n + i]);
#pragma unroll
            for (int c = 0; c < K; ++c) acc[c] += v * __ldcg(p + j * K + c);
          }
        }
#pragma unroll
        for (int c = 0; c < K; ++c) {
          q[i * K + c] = acc[c];
          s[c] += (double)__ldcg(p + i * K + c) * acc[c];
        }
      }
      block_partial<K>(s, part1, sh1);
    }
    grid.sync();
    grid_total<K>(part1, tot1, sh1, bc1);
    float alpha[K];
#pragma unroll
    for (int c = 0; c < K; ++c)
      alpha[c] = act[c] ? gk_sdiv(rho[c], (float)tot1[c]) : 0.f;

    // pass 2: X += alpha P, R -= alpha Q in every column
    {
      double s[3 * K];
#pragma unroll
      for (int c = 0; c < 3 * K; ++c) s[c] = 0.0;
      for (long long i = t0; i < n; i += stride) {
        const float mi = minv ? minv[i] : 1.f;
#pragma unroll
        for (int c = 0; c < K; ++c) {
          const long long e = i * K + c;
          const float pi = __ldcg(p + e);
          x[e] = x[e] + alpha[c] * pi;
          const float ro = r[e];
          const float rn = ro - alpha[c] * q[e];
          r[e] = rn;
          const float zi = minv ? mi * rn : rn;
          s[c] += (double)rn * zi;
          s[K + c] += (double)rn * rn;
          if (P.flexible) s[2 * K + c] += (double)(rn - ro) * zi;
        }
      }
      block_partial<3 * K>(s, part3, sh3);
    }
    grid.sync();
    grid_total<3 * K>(part3, tot3, sh3, bc3);
    float beta[K];
#pragma unroll
    for (int c = 0; c < K; ++c)
      beta[c] = gk_sdiv(P.flexible ? (float)tot3[2 * K + c] : (float)tot3[c],
                        rho[c]);

    // pass 3: P = Z + beta P in the active columns; stopped ones freeze
    for (long long i = t0; i < n; i += stride) {
      const float mi = minv ? minv[i] : 1.f;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        if (act[c]) {
          const long long e = i * K + c;
          const float ri = r[e];
          const float zi = minv ? mi * ri : ri;
          p[e] = zi + beta[c] * __ldcg(p + e);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < K; ++c) {
      mon[c] = P.implicit ? fabsf(rho[c]) : (float)tot3[K + c];
      if (act[c]) itc[c] = it + 1;
      act[c] = act[c] && !(mon[c] <= tol[c]);
      rho[c] = (float)tot3[c];
    }
    ++it;
    grid.sync();
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

// Number of blocks the cooperative grid will have (the wrapper sizes the
// partial-sum scratch, 4 doubles per block, from it).
extern "C" int cg_fused_grid(int d_dtype, int* blocks) {
  if (d_dtype == GK_F32) return gk_coop_blocks(cg_fused_kernel<float>, blocks);
  if (d_dtype == GK_BF16)
    return gk_coop_blocks(cg_fused_kernel<__nv_bfloat16>, blocks);
  return (int)cudaErrorInvalidValue;
}

extern "C" int cg_fused_solve(const void* diags, int d_dtype,
                              const long long* offsets, int nd, long long n,
                              const float* r0, const float* x0,
                              const float* minv, const float* tol_sq,
                              int max_iters, int implicit, int flexible,
                              float* x, float* r, float* p, float* q,
                              double* part, int blocks, int* it_out,
                              float* mon_out, int* conv_out, void* stream) {
  if (nd < 1 || nd > GK_MAX_DIAGS || blocks < 1) return (int)cudaErrorInvalidValue;
  CgParams P;
  P.diags = diags;
  P.offs.nd = nd;
  for (int d = 0; d < nd; ++d) P.offs.off[d] = offsets[d];
  P.n = n;
  P.r0 = r0;
  P.x0 = x0;
  P.minv = minv;
  P.tol_sq = tol_sq;
  P.max_iters = max_iters;
  P.implicit = implicit;
  P.flexible = flexible;
  P.x = x;
  P.r = r;
  P.p = p;
  P.q = q;
  P.part = part;
  P.it_out = it_out;
  P.mon_out = mon_out;
  P.conv_out = conv_out;
  if (d_dtype == GK_F32) return gk_coop_launch(cg_fused_kernel<float>, P, blocks, stream);
  if (d_dtype == GK_BF16)
    return gk_coop_launch(cg_fused_kernel<__nv_bfloat16>, P, blocks, stream);
  return (int)cudaErrorInvalidValue;
}

template <int K>
static int multi_grid(int d_dtype, int* blocks) {
  if (d_dtype == GK_F32) return gk_coop_blocks(cg_fused_multi_kernel<float, K>, blocks);
  if (d_dtype == GK_BF16)
    return gk_coop_blocks(cg_fused_multi_kernel<__nv_bfloat16, K>, blocks);
  return (int)cudaErrorInvalidValue;
}

template <int K>
static int multi_launch(int d_dtype, const CgMultiParams& P, int blocks,
                        void* stream) {
  if (d_dtype == GK_F32)
    return gk_coop_launch(cg_fused_multi_kernel<float, K>, P, blocks, stream);
  if (d_dtype == GK_BF16)
    return gk_coop_launch(cg_fused_multi_kernel<__nv_bfloat16, K>, P, blocks,
                          stream);
  return (int)cudaErrorInvalidValue;
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

// Blocks of K4m's cooperative grid for k columns (4 k doubles of partial
// sums per block).
extern "C" int cg_fused_multi_grid(int d_dtype, int k, int* blocks) {
#define GK_GRID_K(K) multi_grid<K>(d_dtype, blocks)
  GK_SWITCH_K(k, GK_GRID_K)
#undef GK_GRID_K
}

extern "C" int cg_fused_multi_solve(
    const void* diags, int d_dtype, const long long* offsets, int nd,
    long long n, int k, const float* r0, const float* x0, const float* minv,
    const float* tol_sq, int max_iters, int implicit, int flexible, float* x,
    float* r, float* p, float* q, double* part, int blocks, int* it_out,
    float* mon_out, int* conv_out, int* itc_out, void* stream) {
  if (nd < 1 || nd > GK_MAX_DIAGS || blocks < 1) return (int)cudaErrorInvalidValue;
  CgMultiParams P;
  P.diags = diags;
  P.offs.nd = nd;
  for (int d = 0; d < nd; ++d) P.offs.off[d] = offsets[d];
  P.n = n;
  P.r0 = r0;
  P.x0 = x0;
  P.minv = minv;
  P.tol_sq = tol_sq;
  P.max_iters = max_iters;
  P.implicit = implicit;
  P.flexible = flexible;
  P.x = x;
  P.r = r;
  P.p = p;
  P.q = q;
  P.part = part;
  P.it_out = it_out;
  P.mon_out = mon_out;
  P.conv_out = conv_out;
  P.itc_out = itc_out;
#define GK_LAUNCH_K(K) multi_launch<K>(d_dtype, P, blocks, stream)
  GK_SWITCH_K(k, GK_LAUNCH_K)
#undef GK_LAUNCH_K
}
