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

// Sum NV values over the block of WARPS warps (GK_CG_WARPS in every kernel
// but the sweep walk's K23, tri_walk.cuh); the result is valid in thread 0.
template <int NV, int WARPS>
__device__ __forceinline__ void block_sum(double (&v)[NV],
                                          double (&sh)[NV][WARPS]) {
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
    for (int c = 0; c < NV; ++c) v[c] = lane < WARPS ? sh[c][lane] : 0.0;
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
template <int NV, int WARPS>
__device__ __forceinline__ void block_partial(double (&v)[NV], double* part,
                                              double (&sh)[NV][WARPS]) {
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
template <int NV, int B, int WARPS>
__device__ __forceinline__ void grid_total_batch(const double* part, int b_stride,
                                                 int c_stride, int nv, double (&tot)[NV],
                                                 double (&sh)[NV][WARPS],
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

// Partials each thread loads at once in a fold (grid_total_batch) of K4,
// K4m and K12m: 4 up to 3 values, 2 up to 6, else 1, within the registers
// the passes use.
#define GK_CG_FOLD_BATCH(NV) ((NV) <= 3 ? 4 : (NV) <= 6 ? 2 : 1)

// Row i of a DIA product, sum_d D[d][i] * src[i + off_d] over the columns
// in [0, n), summed in offset order from 0 as ops/dia.py's plain version
// does.  `src` is float32, or bfloat16 (a GMRES basis) widened on read; it
// is read with __ldcg (LDCG), or with plain loads where every write to it
// came before the last grid barrier (grid.sync() invalidates L1).
template <bool LDCG = true, typename TD, typename TS>
__device__ __forceinline__ float gk_dia_row(const TD* __restrict__ D,
                                            const GkOffsets& offs, long long n,
                                            long long i, const TS* src) {
  float acc = 0.f;
  for (int d = 0; d < offs.nd; ++d) {
    const long long j = i + offs.off[d];
    if (j >= 0 && j < n)
      acc += GkAcc<float>::load(D[d * n + i]) * gk_to_float(LDCG ? __ldcg(src + j) : src[j]);
  }
  return acc;
}

// R rows of a grid-stride schedule that a thread takes in one trip: rows
// i0, i0 + stride, ..., i0 + (R - 1) stride, ok where below n (K14, K17).
// The thread's rows and their order are those of a one-row loop, so its
// float64 sums keep their order; the R rows' loads are issued together.
template <int R>
struct GkStrideRows {
  long long i[R];
  bool ok[R];
  __device__ __forceinline__ GkStrideRows(long long i0, long long stride, long long n) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      i[q] = i0 + q * stride;
      ok[q] = i[q] < n;
    }
  }
};

// gk_dia_row for the R rows of a trip with plain loads (src written before
// the last grid barrier): each diagonal's values and gathers of the R rows
// are loaded before they are summed, each row in gk_dia_row's order.
template <int R, typename TD, typename TS>
__device__ __forceinline__ void gk_dia_rows(const TD* __restrict__ D, const GkOffsets& offs,
                                            long long n, const GkStrideRows<R>& rows,
                                            const TS* src, float (&acc)[R]) {
#pragma unroll
  for (int q = 0; q < R; ++q) acc[q] = 0.f;
  for (int d = 0; d < offs.nd; ++d) {
    const long long off = offs.off[d];
    float v[R], xv[R];
    bool in[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const long long j = rows.i[q] + off;
      in[q] = rows.ok[q] && j >= 0 && j < n;
      v[q] = in[q] ? GkAcc<float>::load(D[d * n + rows.i[q]]) : 0.f;
      xv[q] = in[q] ? gk_to_float(src[j]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (in[q]) acc[q] += v[q] * xv[q];
  }
}

// The operator of a whole-solve kernel that is templated on it (K12, K13,
// K15, K17 and their Pell forms): row(i, src) is row i of the product with
// a vector that other blocks may have written since the last grid barrier.
// A Dia: (nd, n) diagonals and their offsets; for BiCGSTAB and CGS they
// are A M with the preconditioner folded in (solver/_fused_gate.fold_minv).
// The Pell operator is pell.cuh's GkPellOp.
template <typename TD, bool LDCG = true>
struct GkDiaOp {
  const TD* diags;
  GkOffsets offs;
  long long n;

  template <typename TS>
  __device__ __forceinline__ float row(long long i, const TS* src) const {
    return gk_dia_row<LDCG>(diags, offs, n, i, src);
  }
};

// The Dia operator of the C entry points' arguments (nd in [1, GK_MAX_DIAGS],
// which the entry points check).
template <typename TD, bool LDCG = true>
static GkDiaOp<TD, LDCG> gk_dia_op(const void* diags, const long long* offsets, int nd,
                                   long long n) {
  GkDiaOp<TD, LDCG> op;
  op.diags = static_cast<const TD*>(diags);
  op.offs.nd = nd;
  for (int d = 0; d < nd; ++d) op.offs.off[d] = offsets[d];
  op.n = n;
  return op;
}

// Blocks an SM that K4m's and K12m's registers must leave room for: 5 at
// K = 2 (48 registers), 4 at K = 3 and 4 (64), 3 at K = 5 (80), 2 at K = 6
// to 8 (128), K4m's three-pass kernel's occupancy.  Left to itself the
// compiler took 111 registers for K4m at K = 4 (2 blocks an SM, 21% slower
// on the card) and 149-188 at K = 5 to 8 (1 block an SM).
#define GK_CG_MULTI_MIN_BLOCKS(K) ((K) == 2 ? 5 : (K) <= 4 ? 4 : (K) == 5 ? 3 : 2)

// Row i of a row-major (n, K) float32 vector as K registers (K4m, K12m).
// The vectors that use it are the wrappers' own allocations, aligned to 256
// bytes, so a row of K = 2, 4 or 8 floats is 8- or 16-byte aligned.
template <int K>
struct GkRow {
  // from L2: rows that other blocks wrote since the last grid barrier
  static __device__ __forceinline__ void load_cg(const float* v, long long i,
                                                 float (&out)[K]) {
    const float* row = v + i * K;
    if constexpr (K == 2) {
      const float2 a = __ldcg(reinterpret_cast<const float2*>(row));
      out[0] = a.x;
      out[1] = a.y;
    } else if constexpr (K % 4 == 0) {
#pragma unroll
      for (int c = 0; c < K; c += 4) {
        const float4 a = __ldcg(reinterpret_cast<const float4*>(row + c));
        out[c] = a.x;
        out[c + 1] = a.y;
        out[c + 2] = a.z;
        out[c + 3] = a.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < K; ++c) out[c] = __ldcg(row + c);
    }
  }
  // a row this thread wrote itself
  static __device__ __forceinline__ void load(const float* v, long long i,
                                              float (&out)[K]) {
    const float* row = v + i * K;
    if constexpr (K == 2) {
      const float2 a = *reinterpret_cast<const float2*>(row);
      out[0] = a.x;
      out[1] = a.y;
    } else if constexpr (K % 4 == 0) {
#pragma unroll
      for (int c = 0; c < K; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(row + c);
        out[c] = a.x;
        out[c + 1] = a.y;
        out[c + 2] = a.z;
        out[c + 3] = a.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < K; ++c) out[c] = row[c];
    }
  }
  static __device__ __forceinline__ void store(float* v, long long i,
                                               const float (&in)[K]) {
    float* row = v + i * K;
    if constexpr (K == 2) {
      *reinterpret_cast<float2*>(row) = make_float2(in[0], in[1]);
    } else if constexpr (K % 4 == 0) {
#pragma unroll
      for (int c = 0; c < K; c += 4)
        *reinterpret_cast<float4*>(row + c) =
            make_float4(in[c], in[c + 1], in[c + 2], in[c + 3]);
    } else {
#pragma unroll
      for (int c = 0; c < K; ++c) row[c] = in[c];
    }
  }
};

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

// Opt `kernel` in to smem bytes of dynamic shared memory a block (above the
// 48 KB every kernel may use without asking).
template <typename Kernel>
static int gk_smem_optin(Kernel kernel, long long smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// A kernel's blocks an SM at smem bytes of dynamic shared memory and
// `threads` threads a block (0 where smem exceeds what a block may opt in
// to), its registers a thread, and the SMs.
struct GkOccupancy {
  int per_sm, regs, sms;
};

template <typename Kernel>
static int gk_occupancy(Kernel kernel, long long smem, int threads, GkOccupancy* o) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&o->sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  o->regs = attr.numRegs;
  o->per_sm = 0;
  if (smem > (long long)optin - (long long)attr.sharedSizeBytes) return 0;
  const int st = gk_smem_optin(kernel, smem);
  if (st != 0) return st;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o->per_sm, kernel, threads,
                                                            (size_t)smem);
}

// A cooperative kernel's launch at GK_CG_THREADS threads and no dynamic
// shared memory: out = {blocks of the grid, threads a block, blocks an SM,
// registers a thread}.
template <typename Kernel>
static int gk_coop_config(Kernel kernel, int* out) {
  GkOccupancy o;
  const int st = gk_occupancy(kernel, 0, GK_CG_THREADS, &o);
  if (st != 0) return st;
  const int v[4] = {o.per_sm * o.sms, GK_CG_THREADS, o.per_sm, o.regs};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
  return 0;
}

// Launch `kernel(params)` cooperatively on `blocks` blocks of `threads`
// threads with `smem` bytes of dynamic shared memory.
template <typename Kernel, typename Params>
static int gk_coop_launch(Kernel kernel, const Params& params, int blocks,
                          void* stream, size_t smem = 0, int threads = GK_CG_THREADS) {
  void* args[] = {const_cast<Params*>(&params)};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3(blocks), dim3(threads), args, smem,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
