// Helpers of the persistent cooperative whole-solve kernels (K4, K4m, K7,
// K12-K17, K12m, K15m).
//
// A solve runs in one cooperative launch whose grid is what the SMs hold at
// once; passes are separated by cooperative_groups::this_grid().sync().  Dot
// products are summed per thread in double, reduced per block and written
// as per-block partials; after the barrier every block sums all partials in
// the same fixed order, so all blocks hold bit-identical scalars and take
// the same branch of the loop condition (a block that left the loop early
// would deadlock the next barrier).
#pragma once

#include <cooperative_groups.h>
#include <math_constants.h>

#include "common.cuh"

#define GK_CG_THREADS 256
#define GK_CG_WARPS (GK_CG_THREADS / 32)

// num/den with den == 0 mapping to 0 (pallas_cg._sdiv).
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

// block_partial with the partials stored value-major,
// part[c * gridDim.x + b] (K4m): after the barrier a warp then reads 32
// consecutive doubles of one value, where the block-major layout spreads a
// warp's load over 32 sectors at NV >= 4.
template <int NV>
__device__ __forceinline__ void block_partial_vm(double (&v)[NV], double* part,
                                                 double (&sh)[NV][GK_CG_WARPS]) {
  block_sum<NV>(v, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < NV; ++c) part[c * gridDim.x + blockIdx.x] = v[c];
  }
}

// grid_total's sum, in grid_total's order (so with its bits), of partials
// at part[b * b_stride + c * c_stride] (block-major: NV, 1; value-major: 1,
// gridDim.x), only the first nv values read (the others sum to 0).  Each
// thread loads B of its partials before it adds them, one L2 round trip
// where grid_total's loop waits on one a partial: after a barrier every
// block reads the same partials at once, and on the H100 K4's three folds
// an iteration took 7 of its 124 us that way (PERF.md section 6).
template <int NV, int B>
__device__ __forceinline__ void grid_total_batch(const double* part, int b_stride,
                                                 int c_stride, int nv, double (&tot)[NV],
                                                 double (&sh)[NV][GK_CG_WARPS],
                                                 double (&bc)[NV]) {
  const int blocks = (int)gridDim.x;
  double v[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) v[c] = 0.0;
  for (int b0 = threadIdx.x; b0 < blocks; b0 += B * blockDim.x) {
    double w[B][NV];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int b = b0 + u * blockDim.x;
#pragma unroll
      for (int c = 0; c < NV; ++c)
        w[u][c] = (b < blocks && c < nv) ? __ldcg(part + b * b_stride + c * c_stride) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if (b0 + u * (int)blockDim.x < blocks) {
#pragma unroll
        for (int c = 0; c < NV; ++c)
          if (c < nv) v[c] += w[u][c];
      }
    }
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

// Row i of a DIA product, sum_d D[d][i] * src[i + off_d] over the columns
// in [0, n), summed in offset order from 0 as ops/dia.py's plain version
// does.  `src` is float32, or bfloat16 (a GMRES basis) widened on read; it
// is read with __ldcg: the whole-solve kernels rewrite it between passes,
// and a row of another block must never come from a stale L1 line.
template <typename TD, typename TS>
__device__ __forceinline__ float gk_dia_row(const TD* __restrict__ D,
                                            const GkOffsets& offs, long long n,
                                            long long i, const TS* src) {
  float acc = 0.f;
  for (int d = 0; d < offs.nd; ++d) {
    const long long j = i + offs.off[d];
    if (j >= 0 && j < n)
      acc += GkAcc<float>::load(D[d * n + i]) * gk_to_float(__ldcg(src + j));
  }
  return acc;
}

// The operator of a whole-solve kernel that is templated on it (K12, K13,
// K15, K17 and their Pell forms): row(i, src) is row i of the product with
// a vector that other blocks may have written since the last grid barrier.
// A Dia: (nd, n) diagonals and their offsets; for BiCGSTAB and CGS they
// are A M with the preconditioner folded in (solver/_fused_gate.fold_minv).
// The Pell operator is pell.cuh's GkPellOp.
template <typename TD>
struct GkDiaOp {
  const TD* diags;
  GkOffsets offs;
  long long n;

  template <typename TS>
  __device__ __forceinline__ float row(long long i, const TS* src) const {
    return gk_dia_row(diags, offs, n, i, src);
  }
};

// The Dia operator of the C entry points' arguments (nd in [1, GK_MAX_DIAGS],
// which the entry points check).
template <typename TD>
static GkDiaOp<TD> gk_dia_op(const void* diags, const long long* offsets, int nd,
                             long long n) {
  GkDiaOp<TD> op;
  op.diags = static_cast<const TD*>(diags);
  op.offs.nd = nd;
  for (int d = 0; d < nd; ++d) op.offs.off[d] = offsets[d];
  op.n = n;
  return op;
}

// Row i of a DIA product on the K columns of a row-major (n, K) source,
// each diagonal value read once for all K columns; every column is summed
// as gk_dia_row sums one (the plain versions' dia_spmv_reference order).
// The source is float32, or bfloat16 (a GMRES basis) widened on read.
template <typename TD, typename TS, int K>
__device__ __forceinline__ void gk_dia_row_cols(const TD* __restrict__ D,
                                                const GkOffsets& offs, long long n,
                                                long long i, const TS* src,
                                                float (&acc)[K]) {
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = 0.f;
  for (int d = 0; d < offs.nd; ++d) {
    const long long j = i + offs.off[d];
    if (j >= 0 && j < n) {
      const float v = GkAcc<float>::load(D[d * n + i]);
#pragma unroll
      for (int c = 0; c < K; ++c) acc[c] += v * gk_to_float(__ldcg(src + j * K + c));
    }
  }
}

// Blocks of a cooperative grid for `kernel`: co-resident blocks per SM
// (occupancy at GK_CG_THREADS threads and `smem` bytes of dynamic shared
// memory) times the SM count.
template <typename Kernel>
static int gk_coop_blocks(Kernel kernel, int* blocks, size_t smem = 0) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int coop = 0, sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    GK_CG_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  return 0;
}

// Launch `kernel(params)` cooperatively on `blocks` blocks with `smem` bytes
// of dynamic shared memory.
template <typename Kernel, typename Params>
static int gk_coop_launch(Kernel kernel, const Params& params, int blocks,
                          void* stream, size_t smem = 0) {
  void* args[] = {const_cast<Params*>(&params)};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3(blocks), dim3(GK_CG_THREADS), args, smem,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
