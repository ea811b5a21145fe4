// Whole-solve CG / FCG in one persistent cooperative kernel: kernel K4 of the
// PyTorch port.
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
// stale L1 line).  Dot products are summed per thread in double, reduced
// per block, and written as per-block partials; after the barrier every
// block sums all partials in the same fixed order, so all blocks hold
// bit-identical scalars and take the same branch of the loop condition.
//
// Semantics kept from _cg_kernel (ops/pallas_cg.py:96-221):
//   - the monitor starts at +inf, so the first iteration always runs;
//   - the loop runs while it < max_iters && !(mon <= tol_sq): a NaN monitor
//     keeps iterating, and a negative tol_sq runs to max_iters;
//   - implicit mode monitors |rho| from before the update;
//   - zero denominators give 0 (_sdiv);
//   - converged = (mon <= tol_sq).

#include <cooperative_groups.h>
#include <math_constants.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define GK_CG_THREADS 256
#define GK_CG_WARPS (GK_CG_THREADS / 32)

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

__device__ __forceinline__ float gk_sdiv(float num, float den) {
  return den != 0.f ? num / den : 0.f;
}

// Sum NV values over the block; the result is valid in thread 0.
template <int NV>
__device__ __forceinline__ void block_sum(double (&v)[NV],
                                          double (&sh)[NV][GK_CG_WARPS]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < NV; ++c) v[c] += __shfl_down_sync(0xffffffffu, v[c], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < NV; ++c) sh[c][warp] = v[c];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < NV; ++c) v[c] = lane < GK_CG_WARPS ? sh[c][lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int c = 0; c < NV; ++c)
        v[c] += __shfl_down_sync(0xffffffffu, v[c], o);
    }
  }
  __syncthreads();
}

// Write this block's NV partial sums to part[blockIdx.x * NV + c].
template <int NV>
__device__ __forceinline__ void block_partial(double (&v)[NV], double* part,
                                              double (&sh)[NV][GK_CG_WARPS]) {
  block_sum<NV>(v, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < NV; ++c) part[blockIdx.x * NV + c] = v[c];
  }
}

// After a grid barrier: every block sums all partials in the same order.
template <int NV>
__device__ __forceinline__ void grid_total(const double* part, double (&tot)[NV],
                                           double (&sh)[NV][GK_CG_WARPS],
                                           double (&bc)[NV]) {
  double v[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) v[c] = 0.0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x) {
#pragma unroll
    for (int c = 0; c < NV; ++c) v[c] += __ldcg(part + b * NV + c);
  }
  block_sum<NV>(v, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < NV; ++c) bc[c] = v[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < NV; ++c) tot[c] = bc[c];
  __syncthreads();
}

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

template <typename TD>
static int grid_blocks(int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int coop = 0, sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, cg_fused_kernel<TD>, GK_CG_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  return 0;
}

// Number of blocks the cooperative grid will have (the wrapper sizes the
// partial-sum scratch, 4 doubles per block, from it).
extern "C" int cg_fused_grid(int d_dtype, int* blocks) {
  if (d_dtype == GK_F32) return grid_blocks<float>(blocks);
  if (d_dtype == GK_BF16) return grid_blocks<__nv_bfloat16>(blocks);
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
  void* args[] = {&P};
  cudaError_t e;
  if (d_dtype == GK_F32) {
    e = cudaLaunchCooperativeKernel((const void*)cg_fused_kernel<float>,
                                    dim3(blocks), dim3(GK_CG_THREADS), args, 0,
                                    (cudaStream_t)stream);
  } else if (d_dtype == GK_BF16) {
    e = cudaLaunchCooperativeKernel((const void*)cg_fused_kernel<__nv_bfloat16>,
                                    dim3(blocks), dim3(GK_CG_THREADS), args, 0,
                                    (cudaStream_t)stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
