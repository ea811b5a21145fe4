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
//
// K11's design.  One thread a row (256-thread blocks, 128 of them on that
// Bell) read X's row for every lane from device memory, 8 predicated column
// slots at a time, and each panel again for every further group of 8
// columns: 254 us at k = 4, 0.40 TB/s.  Now K10's stream at k columns:
//  - Persistent blocks, each a run of whole row blocks, stream the panel
//    rows through a ring of shared memory, a stage at a time.  Warp 0 is a
//    producer: it issues a stage's cp.async copies (the panel ids loaded a
//    stage ahead), and a stage's full mbarrier completes when they land;
//    the consumer warps sum the stage and release it through its empty
//    mbarrier.  Sums and copies overlap across warps, where K10's threads
//    do both in turn: with every thread issuing its copies and summing, a
//    stage's copies took a third of a block's time on that card.
//  - A stage's x panels arrive k columns wide, laid out [lane][column]: in
//    row-major X the 128 rows of a panel are one run of 512 k bytes, copied
//    16 bytes at a time when X is 16-byte aligned (the piece that straddles
//    n_cols copies its bytes inside X and zero-fills the rest), 4 bytes at a
//    time otherwise.  Four lanes' columns are 16 k bytes at a 16-byte
//    boundary, so a thread reads them with k vector loads; the 8 threads of
//    a quarter warp read one panel (BR is a multiple of 8), one address.
//  - One consumer thread a staged panel row keeps k lane sums, each from 0
//    over l = 0..127 in order; then one thread a (row, column) pair adds the
//    panel sums in panel order: column j is K10 on column j, bit for bit.
//    No tensor cores: they would not keep the order, and the 8 flops a cell
//    are a few us of CUDA-core issue.
//  - Columns go in groups of GK_BELL_COLS, a launch a group; each launch
//    reads the panels once.  A group narrower than X stages each lane's
//    columns, 16 bytes at a time where X, k and the group allow it.
//  - The x panels add k / BR of the panels' bytes in L2-to-SM traffic (half
//    at k = 4, BR = 8), and the copies reached about 3.3 TB/s from L2 and
//    device memory together on that card: 43 us at k = 4 in float32, 30 us
//    with bfloat16 panels (PERF.md, with the shapes that lost).
//
// Wide row blocks.  A row's running total lives in shared memory while its
// row block streams past, BR floats a block for K10 and BR * KC for K11.
// Where they would not fit a block's shared memory beside the ring (K10
// from about 32,000 rows a block, K11 at 8 columns from about 5,200), the
// launcher takes the kernels' TG form: the totals live in y (Y) itself.
// One thread a staged panel row (K10) or a (staged row, column) pair (K11)
// adds its panel sum into the row's y: 0 before the row block's first
// panel, y after it.  A block owns its row blocks, the stage's rows are
// distinct (BR >= the rows a stage), and the stages are ordered by the
// block's barriers, so the same adds run in the same order: the same bits
// as the shared totals, with no atomics.  The rows a stage of K10 and K11
// are both at most 64, and the JAX package's Bell takes BR = 8 to any
// multiple of 8, so every Bell it accepts gets one of the two forms.

#include <stdint.h>

#include "async.cuh"
#include "common.cuh"

// K11: columns a launch
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

// The ring, then a lane sum a staged row and (TG false) a running total a
// row of the row block.
template <typename TV, bool TG>
static size_t gk_bell_block_bytes(int BR) {
  return (size_t)GK_BELL_STAGES * gk_bell_stage_bytes<TV>(BR) +
         (size_t)(GK_BELL_STAGE_ROWS + (TG ? 0 : BR)) * sizeof(float);
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
          gk_cp4_n(dst + jj, in ? x + col + jj : x, in ? 4 : 0);
        }
      }
    }
  }
}

// Panel rows are counted in int: the launcher declines a Bell of 2^31 or
// more (256 GB of float32 panels).  TG: the running totals live in y (BR
// at least the rows a stage).
template <typename TV, bool TG>
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
  if (!TG)
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
    if (TG) {
      // one thread a staged panel row: its panel sum into its row's total
      // in y, 0 before the row block's first panel; a row appears once a
      // stage, and the stages are ordered by the barriers above
      for (int i = threadIdx.x; i < n; i += GK_BELL_RING_THREADS) {
        const int panel = (q0 + i) / BR;
        const long long row = (long long)(panel / K) * BR + (q0 + i - panel * BR);
        if (row < n_rows) {
          float t = panel % K == 0 ? 0.0f : y[row];
          t += psum[i];
          y[row] = t;
        }
      }
      continue;
    }
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

// -- K11 ----------------------------------------------------------------------------

// K11's shape for float32 or bfloat16 panels at KC columns: consumer warps a
// block (one panel row a thread), stages in the ring, panel rows a stage,
// threads a block (one producer warp besides) and the x panels a stage can
// touch at most (BR a multiple of 8).  Two consumer warps and two stages
// where two such blocks fit an SM at BR = 8 (113 KB a block), else one
// consumer warp and three stages (float32 panels at 6 columns or more): on
// that card each lost 10-27% where the other was chosen (PERF.md).
template <typename TV, int KC>
struct GkBellmShape {
  static constexpr int WC =
      2 * (16 + 64 * gk_bell_row_bytes<TV>() + 8 * GK_LANES * KC * 4) + (2 * 64 + 8) * KC * 4 <=
              113 * 1024
          ? 2
          : 1;
  static constexpr int NS = WC == 1 ? 3 : 2;
  static constexpr int R = 32 * WC;
  static constexpr int T = 32 * (WC + 1);
  static constexpr int XP = R / 8 + 2;
};

// How a column group of X reaches shared memory: the panel's run of 512 k
// bytes in 16-byte pieces (the group is all of X, X 16-byte aligned), each
// lane's columns in 16-byte pieces (X aligned, k and the group multiples of
// 4), or 4 bytes at a time.
enum GkBellXMode : int { GK_BELLX_RUN = 0, GK_BELLX_LANE16 = 1, GK_BELLX_LANE4 = 2 };

template <typename TV, int KC>
__host__ __device__ inline int gk_bellm_stage_bytes(int BR) {
  using S = GkBellmShape<TV, KC>;
  return S::R * gk_bell_row_bytes<TV>() + gk_bell_xpanels(S::R, BR) * GK_LANES * KC * 4;
}

// The ring's full and empty barriers (16 bytes a stage), the ring, KC lane
// sums a staged row twice over (consecutive stages alternate) and (TG
// false) KC running totals a row of the row block.
template <typename TV, int KC, bool TG>
static size_t gk_bellm_block_bytes(int BR) {
  using S = GkBellmShape<TV, KC>;
  return (size_t)S::NS * (16 + gk_bellm_stage_bytes<TV, KC>(BR)) +
         (size_t)(2 * S::R + (TG ? 0 : BR)) * KC * sizeof(float);
}

// The panel ids of the x panels that panel rows [q0, q0 + n) read, loaded a
// stage before the copies that need them.
template <int XP>
__device__ __forceinline__ void gk_bellm_stage_pids(int* pid, const int* __restrict__ pids, int q0,
                                                    int n, int BR) {
  const int p0 = q0 / BR;
  const int np = (q0 + n - 1) / BR - p0 + 1;
#pragma unroll
  for (int u = 0; u < XP; ++u) pid[u] = u < np ? pids[p0 + u] : 0;
}

// The producer warp's copies of panel rows [q0, q0 + n) and of the x panels
// they read, columns [cb, cb + KC) of X, into a stage; lane `lane` takes its
// share.  The trip counts are the compiler's, so that a copy of a panel row
// is one instruction at a fixed offset.
template <typename TV, int KC>
__device__ __forceinline__ void gk_bellm_stage_load(unsigned char* st,
                                                    const TV* __restrict__ values, const int* pid,
                                                    int q0, int n, int BR,
                                                    const float* __restrict__ X, long long n_cols,
                                                    int k, int cb, int xmode, int lane) {
  using S = GkBellmShape<TV, KC>;
  constexpr int RB = gk_bell_row_bytes<TV>();
  constexpr int VP = GK_LANES * (int)sizeof(TV) / 16;  // 16-byte pieces a panel row
  static_assert(32 % VP == 0 && S::R % (32 / VP) == 0, "a lane copies one piece of whole rows");
  constexpr int TR = 32 / VP;  // rows a pass of the warp copies
  const int row0 = lane / VP, piece = lane % VP;
  unsigned char* dst = st + row0 * RB + piece * 16;
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(values + ((long long)q0 + row0) * GK_LANES) + piece * 16;
#pragma unroll
  for (int j = 0; j < S::R / TR; ++j) {
    if (row0 + j * TR < n) gk_cp16(dst + j * TR * RB, src + (long long)j * TR * GK_LANES * sizeof(TV));
  }
  float* xs = reinterpret_cast<float*>(st + S::R * RB);
  const int np = (q0 + n - 1) / BR - q0 / BR + 1;
  constexpr int XQ = GK_LANES * KC / 4;  // 16-byte pieces of a panel's run of X
#pragma unroll
  for (int u = 0; u < S::XP; ++u) {
    if (u >= np) break;
    float* dx = xs + u * GK_LANES * KC;
    const long long r0 = (long long)pid[u] * GK_LANES;  // the panel's first row of X
    if (xmode == GK_BELLX_RUN) {
      // k == KC: rows [r0, r0 + 128) of X are KC * 128 floats in a row
      const float* run = X + r0 * KC;
      const long long left = (n_cols - r0) * KC;  // floats of the run inside X
      if (left >= GK_LANES * KC) {
#pragma unroll
        for (int m = 0; m < (XQ + 31) / 32; ++m) {
          const int j = lane + m * 32;
          if (XQ % 32 == 0 || j < XQ) gk_cp16(dx + 4 * j, run + 4 * j);
        }
      } else {  // X's last panel: its bytes inside X, zeros past n_cols
        for (int j = lane; j < XQ; j += 32) {
          const long long e = 4LL * j;
          const int bytes = left - e >= 4 ? 16 : (left > e ? (int)(left - e) * 4 : 0);
          gk_cp16_n(dx + 4 * j, bytes ? run + e : X, bytes);
        }
      }
    } else if (KC % 4 == 0 && xmode == GK_BELLX_LANE16) {
      constexpr int LP = KC / 4 > 0 ? KC / 4 : 1;  // 16-byte pieces a lane
      for (int j = lane; j < GK_LANES * LP; j += 32) {
        const int l = j / LP, part = j % LP;
        const bool in = r0 + l < n_cols;
        gk_cp16_n(dx + l * KC + 4 * part, in ? X + (r0 + l) * k + cb + 4 * part : X, in ? 16 : 0);
      }
    } else {
      for (int j = lane; j < GK_LANES * KC; j += 32) {
        const int l = j / KC, c = j % KC;
        const bool in = r0 + l < n_cols;
        gk_cp4_n(dx + j, in ? X + (r0 + l) * k + cb + c : X, in ? 4 : 0);
      }
    }
  }
}

// Y[:, cb:cb + KC] = A X[:, cb:cb + KC] for row-major X (n_cols, k) and Y
// (n_rows, k).  Warp 0 is the producer: it fills the ring's stages by
// cp.async, and each stage's full barrier completes once its copies have
// landed.  The consumer warps take one panel row a thread, release the
// stage through its empty barrier, and add the panel sums.  Panel rows are
// counted in int, as in K10.  TG: the running totals live in Y.
template <typename TV, int KC, bool TG>
__global__ void __launch_bounds__(GkBellmShape<TV, KC>::T)
    bell_spmm_kernel(const TV* __restrict__ values, const int* __restrict__ pids, int K, int BR,
                     const float* __restrict__ X, float* __restrict__ Y, long long n_rows,
                     long long n_cols, int k, int cb, int nrb, int xmode) {
  using S = GkBellmShape<TV, KC>;
  constexpr int R = S::R, NS = S::NS, XP = S::XP, NC = 32 * S::WC;  // NC: consumer threads
  unsigned long long* full = reinterpret_cast<unsigned long long*>(gk_bell_smem);
  unsigned long long* empty = full + NS;
  unsigned char* ring = gk_bell_smem + 16 * NS;
  const int stage_bytes = gk_bellm_stage_bytes<TV, KC>(BR);
  float* psum = reinterpret_cast<float*>(ring + NS * stage_bytes);  // (2, R, KC)
  float* tot = psum + 2 * R * KC;                                   // (BR, KC)
  const int rows_rb = K * BR;
  const int rb_begin = (int)((long long)nrb * blockIdx.x / gridDim.x);
  const int q_begin = rb_begin * rows_rb;
  const int q_end = (int)((long long)nrb * (blockIdx.x + 1) / gridDim.x) * rows_rb;
  const int ng = (q_end - q_begin + R - 1) / R;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      gk_mbar_init(full + s, 32);
      gk_mbar_init(empty + s, NC);
    }
  }
  if (!TG)
    for (int t = threadIdx.x; t < BR * KC; t += S::T) tot[t] = 0.0f;
  __syncthreads();
  if (threadIdx.x < 32) {  // the producer warp
    const int lane = threadIdx.x;
    int pid[XP];
    if (ng > 0) gk_bellm_stage_pids<XP>(pid, pids, q_begin, min(R, q_end - q_begin), BR);
    for (int g = 0; g < ng; ++g) {
      const int s = g % NS;
      if (g >= NS) gk_mbar_wait(empty + s, (g / NS - 1) & 1);  // the consumers are done with it
      const int q0 = q_begin + g * R;
      gk_bellm_stage_load<TV, KC>(ring + s * stage_bytes, values, pid, q0, min(R, q_end - q0), BR,
                                  X, n_cols, k, cb, xmode, lane);
      gk_cp_mbar_arrive(full + s);
      if (g + 1 < ng) gk_bellm_stage_pids<XP>(pid, pids, q0 + R, min(R, q_end - q0 - R), BR);
    }
    gk_cp_wait_all();
    return;
  }
  // a consumer thread's panel row of a stage; the 8 rows of a quarter warp
  // lie in one panel (BR and the stage's start are multiples of 8)
  const int i = threadIdx.x - 32;
  // where the stage starts in the stream: q0 % BR, and its first panel's
  // place in its row block and that row block
  int q_mod = 0, p_k = 0, p_rb = rb_begin;
  for (int g = 0; g < ng; ++g) {
    const int s = g % NS;
    gk_mbar_wait(full + s, (g / NS) & 1);
    const unsigned char* st = ring + s * stage_bytes;
    const float* xs = reinterpret_cast<const float*>(st + R * gk_bell_row_bytes<TV>());
    float* ps = psum + (g & 1) * R * KC;
    const int n = min(R, q_end - q_begin - g * R);
    // KC lane sums of the row, lanes in order
    if (i < n) {
      const TV* v = reinterpret_cast<const TV*>(st + i * gk_bell_row_bytes<TV>());
      const float* xr = xs + ((q_mod + i) / BR) * GK_LANES * KC;
      float acc[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) acc[c] = 0.0f;
#pragma unroll 2
      for (int l0 = 0; l0 < GK_LANES; l0 += 8) {
        float w[8];
        gk_bell_load8(v + l0, w);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // lanes l0 + 4h .. l0 + 4h + 3, KC columns each: KC aligned float4s
          float xv[4 * KC];
          const float4* xq = reinterpret_cast<const float4*>(xr + (l0 + 4 * h) * KC);
#pragma unroll
          for (int m = 0; m < KC; ++m) {
            const float4 q = xq[m];
            xv[4 * m] = q.x; xv[4 * m + 1] = q.y; xv[4 * m + 2] = q.z; xv[4 * m + 3] = q.w;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int c = 0; c < KC; ++c) acc[c] += w[4 * h + j] * xv[j * KC + c];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < KC; ++c) ps[i * KC + c] = acc[c];
    }
    gk_mbar_arrive(empty + s);  // this thread is done with the stage
    asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");  // the stage's lane sums are in
    if (TG) {
      // one thread a (staged row, column) pair: its panel sum into the
      // row's total in Y, 0 before the row block's first panel; a row
      // appears once a stage, and the stages are ordered by the barrier
      const int q0 = q_begin + g * R;
      for (int t = i; t < n * KC; t += NC) {
        const int ii = t / KC, c = t % KC;
        const int panel = (q0 + ii) / BR;
        const long long row = (long long)(panel / K) * BR + (q0 + ii - panel * BR);
        if (row < n_rows) {
          float* yp = Y + row * k + cb + c;
          float tt = panel % K == 0 ? 0.0f : *yp;
          tt += ps[ii * KC + c];
          *yp = tt;
        }
      }
    }
    // one thread a (row, column) pair: its panel sums in panel order into
    // its total; row r of the stage's panels sits at i = first, first + BR,
    // ... (at most XP of them, BR >= 8), loaded before they are added
    for (int t = i; !TG && t < BR * KC; t += NC) {
      const int r = t / KC, c = t % KC;
      const bool next = r < q_mod;  // row r's first panel here is the stage's second
      const int first = next ? r - q_mod + BR : r - q_mod;
      int kk = p_k + next, rb = p_rb;
      if (kk == K) {
        kk = 0;
        ++rb;
      }
      float pv[XP];
#pragma unroll
      for (int j = 0; j < XP; ++j) {
        const int ii = first + j * BR;
        pv[j] = ii < n ? ps[ii * KC + c] : 0.0f;
      }
      float tt = tot[t];
#pragma unroll
      for (int j = 0; j < XP; ++j) {
        if (first + j * BR < n) {
          tt += pv[j];
          if (++kk == K) {
            const long long row = (long long)rb * BR + r;
            if (row < n_rows) Y[row * k + cb + c] = tt;
            tt = 0.0f;
            kk = 0;
            ++rb;
          }
        }
      }
      tot[t] = tt;
    }
    // the next stage starts R rows on
    q_mod += R;
    while (q_mod >= BR) {
      q_mod -= BR;
      if (++p_k == K) {
        p_k = 0;
        ++p_rb;
      }
    }
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

// K10's persistent grid on this device; nrb: the row blocks that hold rows;
// tg: the totals live in y (the form whose shared memory does not grow with
// BR), where the shared totals do not fit.
template <typename TV>
static int gk_bell_spmv_plan(int K, int BR, long long n_rows, bool want_regs, GkRingLaunch* L,
                             int* nrb, int* tg) {
  const long long blocks = (n_rows + BR - 1) / BR;
  if (BR % 8 || blocks * K * BR > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *nrb = (int)blocks;
  *tg = 0;
  const int status = gk_ring_launch(bell_spmv_kernel<TV, false>, GK_BELL_RING_THREADS,
                                    gk_bell_block_bytes<TV, false>(BR), blocks, want_regs, L);
  if (status != (int)cudaErrorInvalidConfiguration || BR < GK_BELL_STAGE_ROWS) return status;
  *tg = 1;
  return gk_ring_launch(bell_spmv_kernel<TV, true>, GK_BELL_RING_THREADS,
                        gk_bell_block_bytes<TV, true>(BR), blocks, want_regs, L);
}

template <typename TV>
static int launch_spmv(const void* values, const int* pids, int K, int BR,
                       const float* x, float* y, long long n_rows,
                       long long n_cols, cudaStream_t stream) {
  GkRingLaunch L;
  int nrb, tg;
  const int status = gk_bell_spmv_plan<TV>(K, BR, n_rows, false, &L, &nrb, &tg);
  if (status) return status;
  if (tg)
    bell_spmv_kernel<TV, true><<<L.grid, L.threads, L.smem, stream>>>(
        (const TV*)values, pids, K, BR, x, y, n_rows, n_cols, nrb);
  else
    bell_spmv_kernel<TV, false><<<L.grid, L.threads, L.smem, stream>>>(
        (const TV*)values, pids, K, BR, x, y, n_rows, n_cols, nrb);
  return (int)cudaGetLastError();
}

// K11's persistent grid for one column group of KC columns; tg as for K10.
template <typename TV, int KC>
static int gk_bell_spmm_plan(int K, int BR, long long n_rows, bool want_regs, GkRingLaunch* L,
                             int* nrb, int* tg) {
  const long long blocks = (n_rows + BR - 1) / BR;
  if (BR % 8 || blocks * K * BR > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *nrb = (int)blocks;
  *tg = 0;
  const int status = gk_ring_launch(bell_spmm_kernel<TV, KC, false>, GkBellmShape<TV, KC>::T,
                                    gk_bellm_block_bytes<TV, KC, false>(BR), blocks, want_regs, L);
  if (status != (int)cudaErrorInvalidConfiguration || BR < GkBellmShape<TV, KC>::R) return status;
  *tg = 1;
  return gk_ring_launch(bell_spmm_kernel<TV, KC, true>, GkBellmShape<TV, KC>::T,
                        gk_bellm_block_bytes<TV, KC, true>(BR), blocks, want_regs, L);
}

// Plan (and, when `launch`, launch) the group of columns [cb, cb + KC);
// shape = {panel rows a stage, stages, dynamic shared bytes a block of the
// shared totals' form, totals in Y}.
template <typename TV, int KC>
static int gk_bell_spmm_group(const void* values, const int* pids, int K, int BR, const float* X,
                              float* Y, long long n_rows, long long n_cols, int k, int cb,
                              bool launch, cudaStream_t stream, GkRingLaunch* L, int* shape) {
  shape[0] = GkBellmShape<TV, KC>::R;
  shape[1] = GkBellmShape<TV, KC>::NS;
  shape[2] = (int)gk_bellm_block_bytes<TV, KC, false>(BR);
  int nrb;
  const int status = gk_bell_spmm_plan<TV, KC>(K, BR, n_rows, !launch, L, &nrb, &shape[3]);
  if (status || !launch) return status;
  const bool aligned = (reinterpret_cast<uintptr_t>(X) & 15) == 0;
  const int xmode = aligned && KC == k ? GK_BELLX_RUN
                    : aligned && k % 4 == 0 && KC % 4 == 0 ? GK_BELLX_LANE16
                                                           : GK_BELLX_LANE4;
  if (shape[3])
    bell_spmm_kernel<TV, KC, true><<<L->grid, L->threads, L->smem, stream>>>(
        (const TV*)values, pids, K, BR, X, Y, n_rows, n_cols, k, cb, nrb, xmode);
  else
    bell_spmm_kernel<TV, KC, false><<<L->grid, L->threads, L->smem, stream>>>(
        (const TV*)values, pids, K, BR, X, Y, n_rows, n_cols, k, cb, nrb, xmode);
  return (int)cudaGetLastError();
}

template <typename TV>
static int gk_bell_spmm_cols(int kc, const void* values, const int* pids, int K, int BR,
                             const float* X, float* Y, long long n_rows, long long n_cols, int k,
                             int cb, bool launch, cudaStream_t stream, GkRingLaunch* L,
                             int* shape) {
#define GK_BELLM_CASE(N)                                                                  \
  case N:                                                                                \
    return gk_bell_spmm_group<TV, N>(values, pids, K, BR, X, Y, n_rows, n_cols, k, cb,    \
                                     launch, stream, L, shape);
  switch (kc) {
    GK_BELLM_CASE(1) GK_BELLM_CASE(2) GK_BELLM_CASE(3) GK_BELLM_CASE(4)
    GK_BELLM_CASE(5) GK_BELLM_CASE(6) GK_BELLM_CASE(7) GK_BELLM_CASE(8)
  }
#undef GK_BELLM_CASE
  return (int)cudaErrorInvalidValue;
}

// One launch a group of GK_BELL_COLS columns (the last one narrower).
template <typename TV>
static int launch_spmm(const void* values, const int* pids, int K, int BR, const float* X,
                       float* Y, long long n_rows, long long n_cols, int k,
                       cudaStream_t stream) {
  for (int cb = 0; cb < k; cb += GK_BELL_COLS) {
    GkRingLaunch L;
    int shape[4];
    const int kc = k - cb < GK_BELL_COLS ? k - cb : GK_BELL_COLS;
    const int status = gk_bell_spmm_cols<TV>(kc, values, pids, K, BR, X, Y, n_rows, n_cols, k,
                                             cb, true, stream, &L, shape);
    if (status) return status;
  }
  return 0;
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
// thread, panel rows a stage, stages, 1 where the totals live in y}.
extern "C" int bell_spmv_config(int v_dtype, int K, int BR, long long n_rows, int* out) {
  if (K < 1 || BR < 1) return (int)cudaErrorInvalidValue;
  GkRingLaunch L;
  int nrb, tg;
  int status;
  if (v_dtype == GK_F32) {
    status = gk_bell_spmv_plan<float>(K, BR, n_rows, true, &L, &nrb, &tg);
  } else if (v_dtype == GK_BF16) {
    status = gk_bell_spmv_plan<__nv_bfloat16>(K, BR, n_rows, true, &L, &nrb, &tg);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (status) return status;
  const int v[8] = {L.grid, L.threads, L.smem, L.per_sm, L.regs, GK_BELL_STAGE_ROWS,
                    GK_BELL_STAGES, tg};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// K11's launch on this device for a Bell of K panels and BR rows a block at
// k columns: out = {blocks, threads a block, dynamic shared bytes a block,
// blocks an SM, registers a thread, panel rows a stage, stages, 1 where the
// totals live in Y, launches (column groups)}, of the first column group
// (the widest).  Where no form fits the card, out[2] holds the bytes the
// shared totals' form asks for.
extern "C" int bell_spmm_config(int v_dtype, int K, int BR, long long n_rows, int k, int* out) {
  if (K < 1 || BR < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const int kc = k < GK_BELL_COLS ? k : GK_BELL_COLS;
  GkRingLaunch L;
  int shape[4];
  int status;
  if (v_dtype == GK_F32) {
    status = gk_bell_spmm_cols<float>(kc, nullptr, nullptr, K, BR, nullptr, nullptr, n_rows, 0,
                                      k, 0, false, 0, &L, shape);
  } else if (v_dtype == GK_BF16) {
    status = gk_bell_spmm_cols<__nv_bfloat16>(kc, nullptr, nullptr, K, BR, nullptr, nullptr,
                                              n_rows, 0, k, 0, false, 0, &L, shape);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  out[2] = shape[2];
  if (status) return status;
  const int v[9] = {L.grid, L.threads, L.smem, L.per_sm, L.regs, shape[0], shape[1], shape[3],
                    (k + GK_BELL_COLS - 1) / GK_BELL_COLS};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}
