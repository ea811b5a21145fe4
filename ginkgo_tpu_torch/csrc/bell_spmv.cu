// Blocked-ELL (BELL) SpMV and SpMM for Hopper: kernels K10 and K11 of the
// PyTorch port.
//
// Replaces the Pallas TPU kernels of ginkgo_tpu/ops/pallas_bell.py:
//   K10 bell_spmv <- bell_spmv_pallas: _bell_kernel (x streamed panel by
//                    panel) and _bell_vmem_kernel (x resident in VMEM); the
//                    two compute the same function and differ only in how x
//                    reaches the TPU's VMEM, so one kernel serves both
//   K11 bell_spmm <- bell_spmm_pallas / _bell_spmm_kernel (an MXU dot per
//                    panel on the TPU)
//
// Layout (ginkgo_tpu_torch/matrix/bell.py): values (NRB, K, BR, 128) dense
// panels, float32 or bfloat16; panel_ids (NRB, K) int32, padding panels with
// id 0 and zero values.  Row r of row block rb = r / BR reads, from each of
// its K panels, the 128 lanes of x's panel pid:
//
//   y[r] = sum_k sum_l values[rb, k, r % BR, l] * x[128 * pid[rb, k] + l]
//
// with x's last panel cut at n_cols (columns past it read 0).  Padding
// panels are multiplied like any other, as on the TPU, so a NaN in
// x[0:128] reaches every row with a padding panel.  Vectors are float32 and
// the sums run in float32.
//
// Order: for each panel k in order, a lane sum from 0 over l = 0..127 in
// order, then the panel sum adds into the row's total (the TPU kernels add
// one lane-reduced panel after another; their lane reduction order is the
// hardware's, so the plain version fixes this one instead).  K11 keeps the
// same order for each of its columns.
//
// What bounds it on the H100: bytes, the panels read once (512 bytes a
// panel row in float32, 256 in bfloat16) against 2 flops a cell; x is read
// a panel at a time and stays in L2.  On the Bell that choose_format makes
// of block_structured(2048, 16, 6, 256) (32,768 rows, BR = 8, K = 6) the
// panels are 101.0 MB: 30.2 us at 3.35 TB/s, 33.7 us at the 3,000 GB/s a
// device-to-device copy reaches on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py).
//
// K10's design.  One thread a row gave 128 blocks of 8 warps for 132 SMs on
// that Bell, each thread walking its own 3 KB with 16-byte loads 512 bytes
// apart: too few bytes in flight, 62 us, 0.54 of the copy rate.  Now:
//  - The panel rows of the matrix, values viewed as (NRB * K * BR, 128), are
//    one stream.  Persistent blocks, as many as the SMs hold, each take a
//    run of whole row blocks, GK_BELL_STAGE_ROWS panel rows a stage.
//  - A stage's panel rows and the x panels they read arrive by cp.async in
//    a ring of GK_BELL_STAGES stages, two stages ahead of the sums; the
//    panel ids that address x are loaded a stage earlier still, so that
//    issuing a stage waits on no load.  x's cut at n_cols is applied while
//    staging (4-byte copies that write zeros), and an x that is not 16-byte
//    aligned is staged 4 bytes at a time.
//  - A panel row takes 128 + 4 words of shared memory (bfloat16: 64 + 4):
//    the threads of a quarter warp read consecutive rows at the same lane,
//    which the 4-word pad spreads over all 32 banks (without it the kernel
//    took 88 us instead of 73 on that card, in a first version).
//  - One thread a (row, panel) pair sums its 128 lanes in order from shared
//    memory into a panel sum; then one thread a row adds its panel sums in
//    panel order into a running total in shared memory and writes y when
//    the row block's last panel is in: the one-thread-a-row kernel's bits,
//    and the plain version's.
//  - 64 rows a stage, 64 threads and 3 stages (114 KB, two blocks an SM)
//    came out best among 32-128 rows, 32-128 threads and 2-5 stages: 41.9 us
//    in float32 (0.81 of the copy rate) and 28.0 us with bfloat16 panels on
//    that card (PERF.md).  The plan's copies carry no L2 hint: with one,
//    nvcc 12.9's code for the unrolled prologue stopped on an illegal
//    instruction in every block with a second stage.
// K11 reads each panel once for up to GK_BELL_COLS right-hand sides, one
// thread a row.  No tensor cores.

#include <stdint.h>

#include "async.cuh"
#include "common.cuh"

#define GK_BELL_THREADS 256
#define GK_BELL_COLS 8
// K10: threads a block, panel rows a stage (one lane sum a thread) and
// stages in the ring
#define GK_BELL_RING_THREADS 64
#define GK_BELL_STAGE_ROWS 64
#define GK_BELL_STAGES 3
// words of shared memory a staged x panel takes (128 and a 4-word pad)
#define GK_BELL_XROW 132

// Eight consecutive panel values, widened to float (16-byte aligned).
__device__ __forceinline__ void gk_bell_load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void gk_bell_load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
}

// Bytes of shared memory a staged panel row takes: 128 values and a 16-byte
// pad.
template <typename TV>
__host__ __device__ constexpr int gk_bell_row_bytes() {
  return GK_LANES * (int)sizeof(TV) + 16;
}

// x panels a stage can touch: the stage's rows start on a multiple of
// gcd(R, BR) past a row block's start.
__host__ __device__ inline int gk_bell_xpanels(int R, int BR) {
  if (R % BR == 0) return R / BR;
  if (BR % R == 0) return 1;
  return R / BR + 2;
}

template <typename TV>
__host__ __device__ inline int gk_bell_stage_bytes(int BR) {
  return GK_BELL_STAGE_ROWS * gk_bell_row_bytes<TV>() +
         gk_bell_xpanels(GK_BELL_STAGE_ROWS, BR) * GK_BELL_XROW * 4;
}

// The ring, then a lane sum a staged row and a running total a row of the
// row block.
template <typename TV>
static size_t gk_bell_block_bytes(int BR) {
  return (size_t)GK_BELL_STAGES * gk_bell_stage_bytes<TV>(BR) +
         (size_t)(GK_BELL_STAGE_ROWS + BR) * sizeof(float);
}

extern __shared__ __align__(16) unsigned char gk_bell_smem[];

// x pieces (16 bytes) a stage holds and a thread copies at most (BR >= 8)
#define GK_BELL_XQ (GK_LANES / 4)
#define GK_BELL_XPT \
  (((GK_BELL_STAGE_ROWS / 8 + 2) * GK_BELL_XQ + GK_BELL_RING_THREADS - 1) / GK_BELL_RING_THREADS)

// The panel ids of the x pieces this thread copies for panel rows
// [q0, q0 + n); loaded a stage before the copies that need them, so that
// issuing a stage waits on no load.
__device__ __forceinline__ void gk_bell_stage_pids(int* pid, const int* __restrict__ pids, int q0,
                                                   int n, int BR) {
  const int p0 = q0 / BR;
  const int np = (q0 + n - 1) / BR - p0 + 1;
#pragma unroll
  for (int k = 0; k < GK_BELL_XPT; ++k) {
    const int i = threadIdx.x + k * GK_BELL_RING_THREADS;
    pid[k] = i < np * GK_BELL_XQ ? pids[p0 + i / GK_BELL_XQ] : 0;
  }
}

// Issue the copies of panel rows [q0, q0 + n) and of the x panels they read
// (pid from gk_bell_stage_pids) into a stage; every thread of the block takes
// a share.
template <typename TV>
__device__ __forceinline__ void gk_bell_stage_load(unsigned char* st, const TV* __restrict__ values,
                                                   const int* pid, int q0, int n, int BR,
                                                   const float* __restrict__ x, long long n_cols,
                                                   bool x_aligned) {
  constexpr int VP = GK_LANES * (int)sizeof(TV) / 16;  // 16-byte pieces a row
  const unsigned char* src = reinterpret_cast<const unsigned char*>(values + (long long)q0 * GK_LANES);
  for (int i = threadIdx.x; i < n * VP; i += GK_BELL_RING_THREADS) {
    const int row = i / VP, j = i % VP;
    gk_cp16(st + row * gk_bell_row_bytes<TV>() + j * 16,
            src + (long long)row * GK_LANES * sizeof(TV) + j * 16);
  }
  float* xs = reinterpret_cast<float*>(st + GK_BELL_STAGE_ROWS * gk_bell_row_bytes<TV>());
  const int np = (q0 + n - 1) / BR - q0 / BR + 1;
#pragma unroll
  for (int k = 0; k < GK_BELL_XPT; ++k) {
    const int i = threadIdx.x + k * GK_BELL_RING_THREADS;
    if (i < np * GK_BELL_XQ) {
      const int u = i / GK_BELL_XQ, j = (i % GK_BELL_XQ) * 4;
      const long long col = (long long)pid[k] * GK_LANES + j;
      float* dst = xs + u * GK_BELL_XROW + j;
      if (x_aligned && col + 4 <= n_cols) {
        gk_cp16(dst, x + col);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const bool in = col + jj < n_cols;
          gk_cp4_or_zero(dst + jj, in ? x + col + jj : x, in);
        }
      }
    }
  }
}

// Panel rows are counted in int: the launcher declines a Bell of 2^31 or
// more (256 GB of float32 panels).
template <typename TV>
__global__ void __launch_bounds__(GK_BELL_RING_THREADS)
    bell_spmv_kernel(const TV* __restrict__ values, const int* __restrict__ pids, int K,
                     int BR, const float* __restrict__ x, float* __restrict__ y,
                     long long n_rows, long long n_cols, int nrb) {
  constexpr int R = GK_BELL_STAGE_ROWS, NS = GK_BELL_STAGES;
  const int stage_bytes = gk_bell_stage_bytes<TV>(BR);
  float* psum = reinterpret_cast<float*>(gk_bell_smem + NS * stage_bytes);
  float* tot = psum + R;
  // this block's row blocks, as panel rows [q_begin, q_end)
  const int rows_rb = K * BR;
  const int q_begin = (int)((long long)nrb * blockIdx.x / gridDim.x) * rows_rb;
  const int q_end = (int)((long long)nrb * (blockIdx.x + 1) / gridDim.x) * rows_rb;
  const int ng = (q_end - q_begin + R - 1) / R;
  const bool x_aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  for (int r = threadIdx.x; r < BR; r += GK_BELL_RING_THREADS) tot[r] = 0.0f;
  int pid[GK_BELL_XPT];
#pragma unroll
  for (int g = 0; g < NS - 1; ++g) {
    if (g < ng) {
      const int q0 = q_begin + g * R, n = min(R, q_end - q0);
      gk_bell_stage_pids(pid, pids, q0, n, BR);
      gk_bell_stage_load<TV>(gk_bell_smem + g * stage_bytes, values, pid, q0, n, BR, x, n_cols,
                             x_aligned);
    }
    gk_cp_commit();
  }
  if (NS - 1 < ng) {
    const int q0 = q_begin + (NS - 1) * R;
    gk_bell_stage_pids(pid, pids, q0, min(R, q_end - q0), BR);
  }
  for (int g = 0; g < ng; ++g) {
    gk_cp_wait<NS - 2>();
    __syncthreads();  // stage g is in; every thread is done with stage g - 1
    const int gn = g + NS - 1;
    if (gn < ng) {
      const int q0 = q_begin + gn * R;
      gk_bell_stage_load<TV>(gk_bell_smem + (gn % NS) * stage_bytes, values, pid, q0,
                             min(R, q_end - q0), BR, x, n_cols, x_aligned);
      if (gn + 1 < ng) {  // the next stage's panel ids, used an iteration later
        const int q1 = q0 + R;
        gk_bell_stage_pids(pid, pids, q1, min(R, q_end - q1), BR);
      }
    }
    gk_cp_commit();
    const unsigned char* st = gk_bell_smem + (g % NS) * stage_bytes;
    const float* xs = reinterpret_cast<const float*>(st + R * gk_bell_row_bytes<TV>());
    const int q0 = q_begin + g * R;
    const int n = min(R, q_end - q0);
    const int p0 = q0 / BR;  // the stage's first panel
    // one lane sum a staged panel row, lanes in order
    for (int i = threadIdx.x; i < n; i += GK_BELL_RING_THREADS) {
      const TV* v = reinterpret_cast<const TV*>(st + i * gk_bell_row_bytes<TV>());
      const float* xr = xs + ((q0 + i) / BR - p0) * GK_BELL_XROW;
      float lane_sum = 0.0f;
#pragma unroll 4
      for (int l0 = 0; l0 < GK_LANES; l0 += 8) {
        float vv[8], xv[8];
        gk_bell_load8(v + l0, vv);
        gk_bell_load8(xr + l0, xv);
#pragma unroll
        for (int j = 0; j < 8; ++j) lane_sum += vv[j] * xv[j];
      }
      psum[i] = lane_sum;
    }
    __syncthreads();
    // one thread a row: its panel sums in panel order into its total; row r
    // of the stage's panels sits at q = q0 + i, i = first, first + BR, ...
    for (int r = threadIdx.x; r < BR; r += GK_BELL_RING_THREADS) {
      const int first = (r - q0 % BR + BR) % BR;
      float t = tot[r];
      int panel = (q0 + first) / BR;
      int k = panel % K;
      int rb = panel / K;
      for (int i = first; i < n; i += BR) {
        t += psum[i];
        if (++k == K) {
          const long long row = (long long)rb * BR + r;
          if (row < n_rows) y[row] = t;
          t = 0.0f;
          k = 0;
          ++rb;
        }
      }
      tot[r] = t;
    }
  }
}

template <typename TV>
__global__ void __launch_bounds__(GK_BELL_THREADS)
    bell_spmm_kernel(const TV* __restrict__ values, const int* __restrict__ pids,
                     int K, int BR, const float* __restrict__ X,
                     float* __restrict__ Y, long long n_rows, long long n_cols,
                     int k) {
  const long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const long long rb = row / BR;
  const int r = (int)(row % BR);
  const int cb = blockIdx.y * GK_BELL_COLS;
  const int kc = min(GK_BELL_COLS, k - cb);
  float total[GK_BELL_COLS];
#pragma unroll
  for (int c = 0; c < GK_BELL_COLS; ++c) total[c] = 0.0f;
  for (int p = 0; p < K; ++p) {
    const long long c0 = (long long)pids[rb * K + p] * GK_LANES;
    const TV* v = values + ((rb * K + p) * BR + r) * GK_LANES;
    float lane_sum[GK_BELL_COLS];
#pragma unroll
    for (int c = 0; c < GK_BELL_COLS; ++c) lane_sum[c] = 0.0f;
    for (int l0 = 0; l0 < GK_LANES; l0 += 8) {
      float vv[8];
      gk_bell_load8(v + l0, vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long col = c0 + l0 + j;
        const bool in = col < n_cols;
        const float* xr = X + (in ? col : 0) * k + cb;
#pragma unroll
        for (int c = 0; c < GK_BELL_COLS; ++c) {
          if (c < kc) lane_sum[c] += vv[j] * (in ? xr[c] : 0.0f);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < GK_BELL_COLS; ++c) total[c] += lane_sum[c];
  }
  float* yr = Y + row * k + cb;
#pragma unroll
  for (int c = 0; c < GK_BELL_COLS; ++c) {
    if (c < kc) yr[c] = total[c];
  }
}

struct GkRingLaunch {
  int grid;     // blocks launched
  int threads;  // threads a block
  int smem;     // dynamic shared memory a block, bytes
  int per_sm;   // blocks an SM holds at once
  int regs;     // registers a thread (cudaFuncGetAttributes; 0 unless asked)
};

// Opt `kernel` in to `smem` bytes of dynamic shared memory and size its
// persistent grid: as many blocks as the SMs hold at once, and no more than
// `work` items.  Returns a cudaError_t.
template <typename Kernel>
static int gk_ring_launch(Kernel kernel, int threads, size_t smem, long long work,
                          bool want_regs, GkRingLaunch* L) {
  int dev = 0, sms = 0, max_smem = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  L->regs = 0;
  if (e == cudaSuccess && want_regs) {
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel);
    L->regs = attr.numRegs;
  }
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long cap = (long long)sms * per_sm;
  L->grid = (int)(work < 1 ? 1 : (work < cap ? work : cap));
  L->threads = threads;
  L->smem = (int)smem;
  L->per_sm = per_sm;
  return 0;
}

// K10's persistent grid on this device; nrb: the row blocks that hold rows.
template <typename TV>
static int gk_bell_spmv_plan(int K, int BR, long long n_rows, bool want_regs, GkRingLaunch* L,
                             int* nrb) {
  const long long blocks = (n_rows + BR - 1) / BR;
  if (BR % 8 || blocks * K * BR > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *nrb = (int)blocks;
  return gk_ring_launch(bell_spmv_kernel<TV>, GK_BELL_RING_THREADS, gk_bell_block_bytes<TV>(BR),
                        blocks, want_regs, L);
}

template <typename TV>
static int launch_spmv(const void* values, const int* pids, int K, int BR,
                       const float* x, float* y, long long n_rows,
                       long long n_cols, cudaStream_t stream) {
  GkRingLaunch L;
  int nrb;
  const int status = gk_bell_spmv_plan<TV>(K, BR, n_rows, false, &L, &nrb);
  if (status) return status;
  bell_spmv_kernel<TV><<<L.grid, L.threads, L.smem, stream>>>(
      (const TV*)values, pids, K, BR, x, y, n_rows, n_cols, nrb);
  return (int)cudaGetLastError();
}

template <typename TV>
static int launch_spmm(const void* values, const int* pids, int K, int BR,
                       const float* X, float* Y, long long n_rows,
                       long long n_cols, int k, cudaStream_t stream) {
  const long long bx = (n_rows + GK_BELL_THREADS - 1) / GK_BELL_THREADS;
  const int by = (k + GK_BELL_COLS - 1) / GK_BELL_COLS;
  bell_spmm_kernel<TV><<<dim3((unsigned)bx, (unsigned)by), GK_BELL_THREADS, 0,
                         stream>>>((const TV*)values, pids, K, BR, X, Y,
                                   n_rows, n_cols, k);
  return (int)cudaGetLastError();
}

// values: float32 or bfloat16, 16-byte aligned; vectors float32.
extern "C" int bell_spmv(const void* values, int v_dtype, const int* pids,
                         int K, int BR, const float* x, float* y,
                         long long n_rows, long long n_cols, void* stream) {
  if (K < 1 || BR < 1) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  if (v_dtype == GK_F32)
    return launch_spmv<float>(values, pids, K, BR, x, y, n_rows, n_cols,
                              (cudaStream_t)stream);
  if (v_dtype == GK_BF16)
    return launch_spmv<__nv_bfloat16>(values, pids, K, BR, x, y, n_rows,
                                      n_cols, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int bell_spmm(const void* values, int v_dtype, const int* pids,
                         int K, int BR, const float* X, float* Y,
                         long long n_rows, long long n_cols, int k,
                         void* stream) {
  if (K < 1 || BR < 1) return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || k == 0) return 0;
  if (v_dtype == GK_F32)
    return launch_spmm<float>(values, pids, K, BR, X, Y, n_rows, n_cols, k,
                              (cudaStream_t)stream);
  if (v_dtype == GK_BF16)
    return launch_spmm<__nv_bfloat16>(values, pids, K, BR, X, Y, n_rows,
                                      n_cols, k, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// K10's launch on this device for a Bell of K panels and BR rows a block: out = {blocks,
// threads a block, dynamic shared bytes a block, blocks an SM, registers a
// thread, panel rows a stage, stages}.
extern "C" int bell_spmv_config(int v_dtype, int K, int BR, long long n_rows, int* out) {
  if (K < 1 || BR < 1) return (int)cudaErrorInvalidValue;
  GkRingLaunch L;
  int nrb;
  int status;
  if (v_dtype == GK_F32) {
    status = gk_bell_spmv_plan<float>(K, BR, n_rows, true, &L, &nrb);
  } else if (v_dtype == GK_BF16) {
    status = gk_bell_spmv_plan<__nv_bfloat16>(K, BR, n_rows, true, &L, &nrb);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (status) return status;
  const int v[7] = {L.grid, L.threads, L.smem, L.per_sm, L.regs, GK_BELL_STAGE_ROWS,
                    GK_BELL_STAGES};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}
