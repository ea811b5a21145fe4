// Whole-solve CG / FCG in one persistent cooperative kernel: kernel K4 of the
// PyTorch port (one right-hand side) and its k-RHS form K4m (2 <= K <= 8
// columns with per-column stopping).
//
// Replaces ginkgo_tpu/ops/pallas_cg.py cg_vmem_solve (_cg_kernel) and
// cg_vmem_solve_multi (_cg_multi_kernel, :257-424): the whole Krylov loop,
// the preconditioner (Identity or an inverse diagonal) and the stop test run
// on the device, with no host round trip per iteration.
//
// What bounds it on the H100: bytes.  One SM cannot hold the solve's state
// (the TPU kernel keeps it all in 128 MiB of VMEM), so x, r, p, q and the
// diagonals live in device memory and L2.
//
// What the design does about it: the grid is sized to what the SMs hold at
// once (occupancy x SM count) and launched cooperatively, so the loop runs
// inside the kernel and its passes are separated by grid-wide barriers
// (cooperative_groups::this_grid().sync()) instead of kernel launches and
// host syncs.  Every row belongs to the same thread in every pass, so x, r,
// q and p are only read back at their own row by the thread that wrote
// them; a vector read across rows (rows other blocks wrote before the
// barrier) is loaded with __ldcg (L2, never a stale L1 line).  The dot
// products follow coop.cuh: float64 per-block partials that every block
// sums in the same fixed order.
//
// K4m, two passes and two grid barriers an iteration, the floor for
// classical CG's two global reductions:
//
//   pass A: Q = A P and the partial p.q.  The direction update
//           p = z + beta p of the previous iteration is folded in: the
//           thread of row i forms each neighbour's p_new[j] = z_j +
//           beta p_old[j] from r[j], minv[j] and p_old[j] (the same two
//           float32 operations, so the same bits), writes p_new[i] for its
//           own row and sums p_new[i].q[i].  P alternates between two
//           buffers; the first iteration takes the P the init pass wrote,
//           as it is (no z + 0 p, which would turn an inf into a NaN).
//   pass B: X += alpha P, R -= alpha Q; partial rho_new, r.r and, for FCG,
//           the Polak-Ribiere numerator (r_new - r_old).z_new.
//
// Bytes a row and iteration, K columns and nd diagonals of TD: pass A reads
// the diagonals, R and P_old and writes P_new and Q (nd sizeof(TD) + 16 K);
// pass B reads and writes X and R and reads P_new and Q (24 K); in all
// (nd sizeof(TD) + 40 K), plus 8 with an inverse diagonal (the three-pass
// design moved nd sizeof(TD) + 44 K, plus 12).  A row's K columns are one
// 16-byte access at K = 4, two at K = 8, one 8-byte access at K = 2, and K
// scalars at K = 3, 5, 6, 7 (GkRow; no padding of the row stride).  The
// partials are stored value-major (coop.cuh block_partial_vm).
//
// K4 keeps three passes and three grid barriers an iteration: q = A p with
// p.q; the x and r update with its dots; p = z + beta p.  It moves
// (nd sizeof(TD) + 44) bytes a row, 52 instead of 44 with an inverse
// diagonal.  At one column the two-pass order lost to it on the card in
// every form tried (PERF.md section 6): the two-pass A gathers r and p_old at
// every neighbour where the SpMV gathers p alone, and at 40 registers and
// 6 blocks an SM those gathers cost more than the pass and the barrier
// they save.  Its folds load their partials at once (grid_total_batch).
//
// Semantics kept from _cg_kernel and _cg_multi_kernel:
//   - the monitor starts at +inf, so the first iteration always runs;
//   - a column stays active while !(mon <= tol_sq): a NaN monitor keeps
//     iterating and a negative tol_sq runs to max_iters; the loop runs while
//     it < max_iters and any column is active;
//   - implicit mode monitors |rho| from before the update;
//   - zero denominators give 0 (_sdiv);
//   - a stopped column gets alpha = 0 (x += 0 p and r -= 0 q still run, as
//     in the TPU kernel, :351-358), and its p is copied from p_old to p_new,
//     so it stays frozen; it records the iteration at which it stopped (itc);
//   - converged = (mon <= tol_sq).

#include "coop.cuh"

namespace cg = cooperative_groups;

struct CgParams {
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
  float* p[2];  // the direction (K4m alternates between the two; K4 uses p[0])
  float* q;
  double* part;  // 4 * K * gridDim.x per-block partial sums
  int* it_out;
  float* mon_out;  // (K,)
  int* conv_out;   // (K,)
  int* itc_out;    // (K,) iteration at which each column stopped (K4m)
};

// p_new at row j: z_j + beta p_old[j] in a column whose direction is
// updated, p_old[j] in a frozen one (z = minv r, or r).
template <int K>
__device__ __forceinline__ void gk_cg_direction(
    const float* r, const float* __restrict__ minv, const float* p_old,
    const float (&beta)[K], const bool (&upd)[K], long long j, float (&out)[K]) {
  float rj[K];
  GkRow<K>::load_cg(r, j, rj);
  GkRow<K>::load_cg(p_old, j, out);
  const float mj = minv ? minv[j] : 1.f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float zj = minv ? mj * rj[c] : rj[c];
    if (upd[c]) out[c] = zj + beta[c] * out[c];
  }
}

// K4: the three-pass solve at one column (see the header).
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
  float* p = P.p[0];
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
  grid_total_batch<3, GK_CG_FOLD_BATCH(3)>(part3, 3, 1, 2, tot3, sh3, bc3);
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
    grid_total_batch<1, GK_CG_FOLD_BATCH(1)>(part1, 1, 1, 1, tot1, sh1, bc1);
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
    grid_total_batch<3, GK_CG_FOLD_BATCH(3)>(part3, 3, 1, P.flexible ? 3 : 2, tot3, sh3,
                                             bc3);
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


// Pass A of K4m: Q = A P with P = p_new formed from r, minv and p_old
// (kFirst: the init pass's P as it is), p_new written at the own row; the
// partial p.q per column.  Each row's sum runs in offset order from 0, as
// ops/dia.py's plain version sums it.
template <typename TD, int K, bool kFirst>
__device__ __forceinline__ void gk_cg_pass_a(const CgParams& P, const float* p_old,
                                             float* p_cur, const float (&beta)[K],
                                             const bool (&upd)[K], double (&s)[K]) {
  const TD* __restrict__ D = static_cast<const TD*>(P.diags);
  const long long n = P.n;
  const int nd = P.offs.nd;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float acc[K];
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] = 0.f;
    for (int d = 0; d < nd; ++d) {
      const long long j = i + P.offs.off[d];
      if (j >= 0 && j < n) {
        const float v = GkAcc<float>::load(D[d * n + i]);
        float pj[K];
        if constexpr (kFirst)
          GkRow<K>::load_cg(p_cur, j, pj);
        else
          gk_cg_direction<K>(P.r, P.minv, p_old, beta, upd, j, pj);
#pragma unroll
        for (int c = 0; c < K; ++c) acc[c] += v * pj[c];
      }
    }
    float pi[K];
    if constexpr (kFirst) {
      GkRow<K>::load_cg(p_cur, i, pi);
    } else {
      gk_cg_direction<K>(P.r, P.minv, p_old, beta, upd, i, pi);
      GkRow<K>::store(p_cur, i, pi);
    }
    GkRow<K>::store(P.q, i, acc);
#pragma unroll
    for (int c = 0; c < K; ++c) s[c] += (double)pi[c] * acc[c];
  }
}

template <typename TD, int K>
__global__ void __launch_bounds__(GK_CG_THREADS, GK_CG_MULTI_MIN_BLOCKS(K))
    cg_fused_multi_kernel(const CgParams P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[K][GK_CG_WARPS];
  __shared__ double sh3[3 * K][GK_CG_WARPS];
  __shared__ double bc1[K];
  __shared__ double bc3[3 * K];

  const long long n = P.n;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // per-block partials, value-major (coop.cuh block_partial_vm)
  double* part1 = P.part;                  // [K][gridDim.x]   p.q
  double* part3 = P.part + gridDim.x * K;  // [3K][gridDim.x]  rho, r.r, rho_t
  const int nv3 = P.flexible ? 3 * K : 2 * K;  // rho_t only for FCG
  float* __restrict__ x = P.x;
  float* __restrict__ r = P.r;
  const float* __restrict__ minv = P.minv;

  double tot1[K];
  double tot3[3 * K];
  float rho[K], tol[K], mon[K], beta[K];
  bool act[K], upd[K];
  int itc[K];

  // init: X = X0, R = R0, P = Z = M R; rho_c = r_c.z_c
  {
    double s[3 * K];
#pragma unroll
    for (int c = 0; c < 3 * K; ++c) s[c] = 0.0;
    for (long long i = t0; i < n; i += stride) {
      const float mi = minv ? minv[i] : 1.f;
      float xi[K], ri[K], zi[K];
#pragma unroll
      for (int c = 0; c < K; ++c) {
        xi[c] = P.x0[i * K + c];
        ri[c] = P.r0[i * K + c];
        zi[c] = minv ? mi * ri[c] : ri[c];
        s[c] += (double)ri[c] * zi[c];
        s[K + c] += (double)ri[c] * ri[c];
      }
      GkRow<K>::store(x, i, xi);
      GkRow<K>::store(r, i, ri);
      GkRow<K>::store(P.p[0], i, zi);
    }
    block_partial_vm<3 * K>(s, part3, sh3);
  }
  grid.sync();
  grid_total_batch<3 * K, GK_CG_FOLD_BATCH(3 * K)>(part3, 1, gridDim.x, 2 * K, tot3, sh3,
                                                bc3);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    rho[c] = (float)tot3[c];
    tol[c] = P.tol_sq[c];
    mon[c] = CUDART_INF_F;
    beta[c] = 0.f;
    act[c] = true;
    upd[c] = false;
    itc[c] = 0;
  }

  int it = 0;
  for (;;) {
    bool any = false;
#pragma unroll
    for (int c = 0; c < K; ++c) any = any || act[c];
    if (!(it < P.max_iters && any)) break;
    float* p_cur = P.p[it & 1];

    // pass A: Q = A P, the direction update folded in
    {
      double s[K];
#pragma unroll
      for (int c = 0; c < K; ++c) s[c] = 0.0;
      if (it == 0)
        gk_cg_pass_a<TD, K, true>(P, nullptr, p_cur, beta, upd, s);
      else
        gk_cg_pass_a<TD, K, false>(P, P.p[(it + 1) & 1], p_cur, beta, upd, s);
      block_partial_vm<K>(s, part1, sh1);
    }
    grid.sync();
    grid_total_batch<K, GK_CG_FOLD_BATCH(K)>(part1, 1, gridDim.x, K, tot1, sh1, bc1);
    float alpha[K];
#pragma unroll
    for (int c = 0; c < K; ++c)
      alpha[c] = act[c] ? gk_sdiv(rho[c], (float)tot1[c]) : 0.f;

    // pass B: X += alpha P, R -= alpha Q in every column
    {
      double s[3 * K];
#pragma unroll
      for (int c = 0; c < 3 * K; ++c) s[c] = 0.0;
      for (long long i = t0; i < n; i += stride) {
        const float mi = minv ? minv[i] : 1.f;
        float pi[K], xi[K], ri[K], qi[K];
        GkRow<K>::load_cg(p_cur, i, pi);
        GkRow<K>::load(x, i, xi);
        GkRow<K>::load(r, i, ri);
        GkRow<K>::load(P.q, i, qi);
#pragma unroll
        for (int c = 0; c < K; ++c) {
          xi[c] = xi[c] + alpha[c] * pi[c];
          const float ro = ri[c];
          const float rn = ro - alpha[c] * qi[c];
          ri[c] = rn;
          const float zi = minv ? mi * rn : rn;
          s[c] += (double)rn * zi;
          s[K + c] += (double)rn * rn;
          if (P.flexible) s[2 * K + c] += (double)(rn - ro) * zi;
        }
        GkRow<K>::store(x, i, xi);
        GkRow<K>::store(r, i, ri);
      }
      block_partial_vm<3 * K>(s, part3, sh3);
    }
    grid.sync();
    grid_total_batch<3 * K, GK_CG_FOLD_BATCH(3 * K)>(part3, 1, gridDim.x, nv3, tot3, sh3,
                                                  bc3);
    // the next pass A updates the direction of the columns active in this
    // iteration (the reference's p = where(act, z + beta p, p))
#pragma unroll
    for (int c = 0; c < K; ++c) {
      beta[c] = gk_sdiv(P.flexible ? (float)tot3[2 * K + c] : (float)tot3[c], rho[c]);
      mon[c] = P.implicit ? fabsf(rho[c]) : (float)tot3[K + c];
      if (act[c]) itc[c] = it + 1;
      upd[c] = act[c];
      act[c] = act[c] && !(mon[c] <= tol[c]);
      rho[c] = (float)tot3[c];
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

// The kernel of K columns: K4 at one, K4m above.
template <typename TD, int K>
static auto solve_kernel() {
  if constexpr (K == 1)
    return cg_fused_kernel<TD>;
  else
    return cg_fused_multi_kernel<TD, K>;
}

template <int K>
static int solve_grid(int d_dtype, int* blocks) {
  if (d_dtype == GK_F32) return gk_coop_blocks(solve_kernel<float, K>(), blocks);
  if (d_dtype == GK_BF16) return gk_coop_blocks(solve_kernel<__nv_bfloat16, K>(), blocks);
  return (int)cudaErrorInvalidValue;
}

template <int K>
static int solve_launch(int d_dtype, const CgParams& P, int blocks, void* stream) {
  if (d_dtype == GK_F32)
    return gk_coop_launch(solve_kernel<float, K>(), P, blocks, stream);
  if (d_dtype == GK_BF16)
    return gk_coop_launch(solve_kernel<__nv_bfloat16, K>(), P, blocks, stream);
  return (int)cudaErrorInvalidValue;
}

// The launch of K columns: {blocks of the cooperative grid, threads a
// block, blocks an SM, registers a thread}.
template <typename TD, int K>
static int config_of(int* out) {
  cudaFuncAttributes attr;
  int blocks = 0;
  int e = gk_coop_blocks(solve_kernel<TD, K>(), &blocks);
  if (e == 0) e = (int)cudaFuncGetAttributes(&attr, solve_kernel<TD, K>());
  if (e != 0) return e;
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int v[4] = {blocks, GK_CG_THREADS, sms ? blocks / sms : 0, attr.numRegs};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
  return 0;
}

template <int K>
static int solve_config(int d_dtype, int* out) {
  if (d_dtype == GK_F32) return config_of<float, K>(out);
  if (d_dtype == GK_BF16) return config_of<__nv_bfloat16, K>(out);
  return (int)cudaErrorInvalidValue;
}

#define GK_SWITCH_K(k, CALL_K)                   \
  switch (k) {                                   \
    case 1: return CALL_K(1);                    \
    case 2: return CALL_K(2);                    \
    case 3: return CALL_K(3);                    \
    case 4: return CALL_K(4);                    \
    case 5: return CALL_K(5);                    \
    case 6: return CALL_K(6);                    \
    case 7: return CALL_K(7);                    \
    case 8: return CALL_K(8);                    \
    default: return (int)cudaErrorInvalidValue;  \
  }

// Blocks of the cooperative grid for k columns (the wrapper sizes the
// partial-sum scratch, 4 k doubles a block, from it).
extern "C" int cg_fused_grid(int d_dtype, int k, int* blocks) {
#define GK_GRID_K(K) solve_grid<K>(d_dtype, blocks)
  GK_SWITCH_K(k, GK_GRID_K)
#undef GK_GRID_K
}

extern "C" int cg_fused_config(int d_dtype, int k, int* out) {
#define GK_CONFIG_K(K) solve_config<K>(d_dtype, out)
  GK_SWITCH_K(k, GK_CONFIG_K)
#undef GK_CONFIG_K
}

// K4 (k = 1) and K4m (2 <= k <= 8); K4 reads p0 alone and writes no itc_out.
extern "C" int cg_fused_solve(const void* diags, int d_dtype, const long long* offsets,
                              int nd, long long n, int k, const float* r0, const float* x0,
                              const float* minv, const float* tol_sq, int max_iters,
                              int implicit, int flexible, float* x, float* r, float* p0,
                              float* p1, float* q, double* part, int blocks, int* it_out,
                              float* mon_out, int* conv_out, int* itc_out, void* stream) {
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
  P.p[0] = p0;
  P.p[1] = p1;
  P.q = q;
  P.part = part;
  P.it_out = it_out;
  P.mon_out = mon_out;
  P.conv_out = conv_out;
  P.itc_out = itc_out;
#define GK_LAUNCH_K(K) solve_launch<K>(d_dtype, P, blocks, stream)
  GK_SWITCH_K(k, GK_LAUNCH_K)
#undef GK_LAUNCH_K
}
