// WELL SpMV and SpMM for Hopper: kernels K8 and K9 of the PyTorch port.
//
// Replaces the Pallas TPU kernels of ginkgo_tpu/ops/spmv_well.py:
//   K8 well_spmv <- well_spmv / _well_call / _well_kernel (T = 1) and
//                   _well_xl_kernel (T > 1)                      (y = A x)
//   K9 well_spmm <- well_spmm / _well_spmm_call / _well_spmm_kernel and
//                   _well_xl_spmm_kernel                         (Y = A X)
//
// Plan layout (ginkgo_tpu_torch/ops/well.py WellPlan): values, qidx, rt and,
// for T > 1, tsb are (slots, 8, 128); bases (slots,) is each slot's window
// base panel.  Cell c = (slot, s, l) adds
//
//   values[c] * x[128 * (bases[slot] + rt[slot, s, q]) + q],  q = qidx[c],
//
// into row 1024 * (T * st + tsb[c]) + 128 * s + l of its supertile st.  The
// routing tile is read at lane q of the cell's own sublane: the TPU's chained
// sublane-then-lane gather.  A column at or past n_cols reads 0 (the TPU
// reads zero pad panels); every other cell, padding included, is multiplied,
// so a NaN in x reaches the same rows as on the TPU.
//
// What bounds it on the H100: bytes.  Every cell of the padded plan is read
// once, sizeof(value) + 2 bytes (+ 1 for tsb when T > 1) against 2 flops
// (K9: 2 a column), plus one x gather per cell from L2 (x is 4 MB at 2^20
// rows).  No kernel that reads this plan can beat its bytes over the HBM
// rate.
//
// What the design does about it.  The plan's supertiles are as long as their
// longest row: on a power-law matrix the hub row's supertile holds a third
// of the slots, and one block per supertile walked it alone.  So the work is
// a list of chunks (ops/well.py chunk_list): each supertile cut into pieces
// of at most CHUNK_SLOTS slots, on whole G-slot steps.  One block of 128
// threads walks one (chunk, sublane) (K9: and one group of up to 4 columns),
// one thread per lane, so that the hub's supertile spreads over hundreds of
// blocks.
//  - The slot rows the block needs (values, q, rt, tsb and the slot's base)
//    stream into a ring of shared memory by cp.async, two stages ahead of the
//    walk, marked to leave L2 first (x, gathered many times, stays).  The
//    routed rt byte, q and the value come from shared memory; only x is
//    gathered from device memory.  (Loading each thread's own cells into
//    registers instead, with only the rt rows in the ring, was slower on the
//    H100: PERF.md, PR 9.)
//  - A thread owns the T rows (st, b, s, l), b < T, of its lane and keeps
//    their sums in shared memory, in its own column (no bank conflicts, no
//    atomics, no barrier for them); T = 1 keeps them in registers.  K9 keeps
//    a lane's KC sums of a row side by side, one wide access a cell.
//  - A chunk of a supertile that is one chunk writes its rows; the chunks of
//    a split supertile write partial sums to scratch, and a second launch
//    (well_fold_kernel) adds them in chunk order.  No float atomics: two
//    calls give the same bits.
//
// Order, as on the TPU inside a chunk.  K8: the G cells of a step add into T
// step sums (the cell into sum tsb), then the step sums add into the chunk's
// sums, step after step.  K9: each cell's products add straight into the
// chunk's sums, slot after slot (the TPU SpMM kernel keeps no step sum).  The
// TPU adds where(tsb == b, contrib, 0) into all T sums, and K8 adds every
// step sum into its output; here a cell adds into sum tsb only, and K8 folds
// only the step sums its step touched (a per-thread 64-bit mask).  Both are
// bit for bit the same: every sum starts at +0.0 and only adds under
// round-to-nearest, so no sum is ever -0.0 (+0 + -0 is +0, and an exact
// cancellation gives +0), and adding +0.0 to a value that is not -0.0 leaves
// it unchanged, NaN and inf included.  Then the chunks of a supertile add in
// chunk order: y = ((p0 + p1) + p2) ...; the plain versions in ops/well.py
// take the same order.

#include "async.cuh"
#include "common.cuh"

#define GK_WELL_SUB 8
#define GK_WELL_TILE (GK_WELL_SUB * GK_LANES)
// Slots per ring stage and stages, K8 and K9: the walk reads one stage while
// the others are in flight.
#define GK_WELL_SPMV_U 8
#define GK_WELL_SPMV_STAGES 3
#define GK_WELL_SPMM_U 4
#define GK_WELL_SPMM_STAGES 3
#define GK_WELL_MAX_T 64

struct WellPlanArgs {
  const void* values;
  const signed char* qidx;
  const signed char* rt;
  const signed char* tsb;  // null when T == 1
  const int* bases;
  int T;
  int G;
};

// One ring stage: the rows of sublane s of U consecutive slots.  Every
// member's size is a multiple of 16 bytes, so each stays 16-byte aligned for
// cp.async.
template <typename TV, int U>
struct WellStage {
  TV v[U][GK_LANES];
  signed char q[U][GK_LANES];
  signed char rt[U][GK_LANES];
  signed char tsb[U][GK_LANES];
  int base[U];
};

extern __shared__ __align__(16) unsigned char gk_well_smem[];

// Issue the copies of slots [slot0, slot0 + n) of sublane s into a stage;
// every thread of the block takes a share.
template <typename TV, int U>
__device__ __forceinline__ void gk_well_stage_load(WellStage<TV, U>& st, const WellPlanArgs& P,
                                                   long long slot0, int n, int s, bool subs) {
  constexpr int VE = 16 / sizeof(TV);       // values in a 16-byte piece
  constexpr int VP = GK_LANES / VE;         // pieces in a values row
  constexpr int BP = GK_LANES / 16;         // pieces in a byte row
  const TV* vals = static_cast<const TV*>(P.values);
  const unsigned long long policy = gk_evict_first();
  for (int i = threadIdx.x; i < n * VP; i += blockDim.x) {
    const int u = i / VP, j = (i % VP) * VE;
    gk_cp16(&st.v[u][j], vals + ((slot0 + u) * GK_WELL_SUB + s) * GK_LANES + j, policy);
  }
  for (int i = threadIdx.x; i < n * BP; i += blockDim.x) {
    const int u = i / BP, j = (i % BP) * 16;
    const long long off = ((slot0 + u) * GK_WELL_SUB + s) * GK_LANES + j;
    gk_cp16(&st.q[u][j], P.qidx + off, policy);
    gk_cp16(&st.rt[u][j], P.rt + off, policy);
    if (subs) gk_cp16(&st.tsb[u][j], P.tsb + off, policy);
  }
  if ((int)threadIdx.x < n) gk_cp4(&st.base[threadIdx.x], P.bases + slot0 + threadIdx.x);
}

// The ring walk over the slots [slot0, slot1) of one chunk, sublane s:
// body(stage, n) runs for each group of n <= U slots, in slot order, once
// the group's stage is in shared memory.  Every thread of the block takes the
// same trips, so the barrier is uniform.
template <typename TV, int U, int S, typename Body>
__device__ __forceinline__ void gk_well_walk(const WellPlanArgs& P, int slot0, int slot1, int s,
                                             bool subs, Body body) {
  auto* ring = reinterpret_cast<WellStage<TV, U>*>(gk_well_smem);
  const int len = slot1 - slot0;
  const int ng = (len + U - 1) / U;
#pragma unroll
  for (int g = 0; g < S - 1; ++g) {
    if (g < ng)
      gk_well_stage_load<TV, U>(ring[g], P, slot0 + (long long)g * U, min(U, len - g * U), s,
                                subs);
    gk_cp_commit();
  }
  for (int g = 0; g < ng; ++g) {
    gk_cp_wait<S - 2>();
    __syncthreads();  // stage g is in; every thread is done with stage g - 1
    const int gn = g + S - 1;
    if (gn < ng)
      gk_well_stage_load<TV, U>(ring[gn % S], P, slot0 + (long long)gn * U,
                                min(U, len - gn * U), s, subs);
    gk_cp_commit();
    body(ring[g % S], min(U, len - g * U));
  }
}

// Column of cell (u, l) of a stage, from shared memory.
template <typename TV, int U>
__device__ __forceinline__ long long gk_well_col(const WellStage<TV, U>& st, int u, int l) {
  const int q = st.q[u][l];
  return ((long long)st.base[u] + st.rt[u][q]) * GK_LANES + q;
}

template <typename TV, typename TX, bool SUBS>
__global__ void __launch_bounds__(GK_LANES)
    well_spmv_kernel(const WellPlanArgs P, const int4* __restrict__ work,
                     const TX* __restrict__ x, TX* __restrict__ y, TX* __restrict__ part,
                     long long n_rows, long long n_cols) {
  const int4 w = work[blockIdx.x];  // supertile, first slot, end slot, partial
  const int s = blockIdx.y;
  const int l = threadIdx.x;
  const int T = SUBS ? P.T : 1;
  const int G = P.G;
  // T > 1: the step sums and the chunk's sums, (T, 128) each, after the ring
  constexpr int U = GK_WELL_SPMV_U, S = GK_WELL_SPMV_STAGES;
  TX* acc = reinterpret_cast<TX*>(gk_well_smem + S * sizeof(WellStage<TV, U>));
  TX* out = acc + T * GK_LANES;
  TX acc1 = 0, out1 = 0;  // T = 1
  if (SUBS) {
    for (int b = 0; b < T; ++b) {
      acc[b * GK_LANES + l] = 0;
      out[b * GK_LANES + l] = 0;
    }
  }
  int left = G;                  // slots left in the current step
  unsigned long long mask = 0;   // sub-tiles the current step touched
  gk_well_walk<TV, U, S>(P, w.y, w.z, s, SUBS, [&](const WellStage<TV, U>& st, int n) {
    TX v[U], xv[U];
    int sub[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < n) {
        const long long col = gk_well_col(st, u, l);
        v[u] = GkAcc<TX>::load(st.v[u][l]);
        sub[u] = SUBS ? (int)st.tsb[u][l] : 0;
        xv[u] = col < n_cols ? __ldg(x + col) : TX(0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < n) {
        const TX prod = v[u] * xv[u];
        if (SUBS) {
          acc[sub[u] * GK_LANES + l] += prod;
          mask |= 1ull << sub[u];
        } else {
          acc1 += prod;
        }
        if (--left == 0) {  // end of a step: fold the sums it touched
          left = G;
          if (SUBS) {
            while (mask) {
              const int b = __ffsll((long long)mask) - 1;
              mask &= mask - 1;
              out[b * GK_LANES + l] += acc[b * GK_LANES + l];
              acc[b * GK_LANES + l] = 0;
            }
          } else {
            out1 += acc1;
            acc1 = 0;
          }
        }
      }
    }
  });
  // a chunk ends on a step boundary, so every step sum is folded
  for (int b = 0; b < T; ++b) {
    const TX o = SUBS ? out[b * GK_LANES + l] : out1;
    const long long r = (long long)b * GK_WELL_TILE + s * GK_LANES + l;
    if (w.w < 0) {
      const long long row = (long long)w.x * T * GK_WELL_TILE + r;
      if (row < n_rows) y[row] = o;
    } else {
      __stcs(part + (long long)w.w * T * GK_WELL_TILE + r, o);
    }
  }
}

// KC consecutive entries as wide accesses of at most 16 bytes (the caller
// keeps them aligned to their width): a row of X through the read-only
// cache, a lane's K9 sums in shared memory, a row of Y or of a partial.
template <typename TX, int KC>
struct GkWide;
template <> struct GkWide<float, 4> { using V = float4; static constexpr int N = 1; };
template <> struct GkWide<float, 2> { using V = float2; static constexpr int N = 1; };
template <> struct GkWide<float, 1> { using V = float; static constexpr int N = 1; };
template <> struct GkWide<double, 4> { using V = double2; static constexpr int N = 2; };
template <> struct GkWide<double, 2> { using V = double2; static constexpr int N = 1; };
template <> struct GkWide<double, 1> { using V = double; static constexpr int N = 1; };

__device__ __forceinline__ void gk_unpack(const float4& t, float* o) {
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}
__device__ __forceinline__ void gk_unpack(const float2& t, float* o) { o[0] = t.x; o[1] = t.y; }
__device__ __forceinline__ void gk_unpack(const double2& t, double* o) { o[0] = t.x; o[1] = t.y; }
__device__ __forceinline__ void gk_unpack(float t, float* o) { o[0] = t; }
__device__ __forceinline__ void gk_unpack(double t, double* o) { o[0] = t; }
__device__ __forceinline__ void gk_pack(const float* o, float4& t) {
  t = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void gk_pack(const float* o, float2& t) { t = make_float2(o[0], o[1]); }
__device__ __forceinline__ void gk_pack(const double* o, double2& t) { t = make_double2(o[0], o[1]); }
__device__ __forceinline__ void gk_pack(const float* o, float& t) { t = o[0]; }
__device__ __forceinline__ void gk_pack(const double* o, double& t) { t = o[0]; }

template <int KC, typename TX>
__device__ __forceinline__ void gk_ldg_row(const TX* p, TX* o) {
  using W = GkWide<TX, KC>;
#pragma unroll
  for (int h = 0; h < W::N; ++h)
    gk_unpack(__ldg(reinterpret_cast<const typename W::V*>(p) + h), o + h * (KC / W::N));
}

template <int KC, typename TX>
__device__ __forceinline__ void gk_lds_row(const TX* p, TX* o) {
  using W = GkWide<TX, KC>;
#pragma unroll
  for (int h = 0; h < W::N; ++h)
    gk_unpack(reinterpret_cast<const typename W::V*>(p)[h], o + h * (KC / W::N));
}

// a plain store (shared memory, Y) or, with STREAM, one read once (partials)
template <int KC, bool STREAM = false, typename TX>
__device__ __forceinline__ void gk_st_row(TX* p, const TX* o) {
  using W = GkWide<TX, KC>;
#pragma unroll
  for (int h = 0; h < W::N; ++h) {
    typename W::V t;
    gk_pack(o + h * (KC / W::N), t);
    if (STREAM) {
      __stcs(reinterpret_cast<typename W::V*>(p) + h, t);
    } else {
      reinterpret_cast<typename W::V*>(p)[h] = t;
    }
  }
}

template <typename TV, typename TX, bool SUBS, int KC>
__global__ void __launch_bounds__(GK_LANES)
    well_spmm_kernel(const WellPlanArgs P, const int4* __restrict__ work,
                     const TX* __restrict__ X, TX* __restrict__ Y, TX* __restrict__ part,
                     long long n_rows, long long n_cols, int k, int vec_x, int vec_out) {
  constexpr int U = GK_WELL_SPMM_U, S = GK_WELL_SPMM_STAGES;
  const int4 w = work[blockIdx.x];
  const int s = blockIdx.y;
  const int l = threadIdx.x;
  const int T = SUBS ? P.T : 1;
  const int c0 = blockIdx.z * KC;
  const int kc = min(KC, k - c0);
  const bool wide = vec_x && kc == KC;
  // T > 1: the chunk's sums, (T, 128, KC), after the ring: a cell's KC sums
  // are one wide access
  TX* out = reinterpret_cast<TX*>(gk_well_smem + S * sizeof(WellStage<TV, U>));
  TX out1[KC];  // T = 1
#pragma unroll
  for (int c = 0; c < KC; ++c) out1[c] = 0;
  if (SUBS) {
    for (int b = 0; b < T; ++b) gk_st_row<KC>(out + (b * GK_LANES + l) * KC, out1);
  }
  gk_well_walk<TV, U, S>(P, w.y, w.z, s, SUBS, [&](const WellStage<TV, U>& st, int n) {
    TX v[U], xv[U][KC];
    int sub[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < n) {
        const long long col = gk_well_col(st, u, l);
        const bool in = col < n_cols;
        const TX* xr = X + (in ? col : 0) * k + c0;
        v[u] = GkAcc<TX>::load(st.v[u][l]);
        sub[u] = SUBS ? (int)st.tsb[u][l] : 0;
        if (wide) {
          gk_ldg_row<KC>(xr, xv[u]);
        } else {
#pragma unroll
          for (int c = 0; c < KC; ++c) xv[u][c] = c < kc ? __ldg(xr + c) : TX(0);
        }
        if (!in) {
#pragma unroll
          for (int c = 0; c < KC; ++c) xv[u][c] = 0;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < n) {
        if (SUBS) {
          TX* o = out + (sub[u] * GK_LANES + l) * KC;
          TX cur[KC];
          gk_lds_row<KC>(o, cur);
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            if (c < kc) cur[c] += v[u] * xv[u][c];
          }
          gk_st_row<KC>(o, cur);
        } else {
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            if (c < kc) out1[c] += v[u] * xv[u][c];
          }
        }
      }
    }
  });
  for (int b = 0; b < T; ++b) {
    const long long r = (long long)b * GK_WELL_TILE + s * GK_LANES + l;
    TX* dst;
    if (w.w < 0) {
      const long long row = (long long)w.x * T * GK_WELL_TILE + r;
      if (row >= n_rows) continue;
      dst = Y + row * k + c0;
    } else {
      dst = part + ((long long)w.w * T * GK_WELL_TILE + r) * k + c0;
    }
    TX o[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) o[c] = SUBS ? out[(b * GK_LANES + l) * KC + c] : out1[c];
    if (vec_out && kc == KC) {
      if (w.w < 0) {
        gk_st_row<KC>(dst, o);
      } else {
        gk_st_row<KC, true>(dst, o);  // read once, by the fold
      }
    } else {
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        if (c < kc) {
          if (w.w < 0) {
            dst[c] = o[c];
          } else {
            __stcs(dst + c, o[c]);
          }
        }
      }
    }
  }
}

// y rows of the split supertiles: the partials of each added in chunk order.
// A partial is (T, 8, 128, k); block (f, b * 8 + s, j) sums entries
// [128 j, 128 j + 128) of the (b, s) row tile of split supertile f, whose
// 128 k entries are contiguous.  The loads of GK_WELL_FOLD_BATCH partials
// are issued before their adds, which run in order.
#define GK_WELL_FOLD_BATCH 8

template <typename TX>
__global__ void __launch_bounds__(GK_LANES)
    well_fold_kernel(const int* __restrict__ fold, const TX* __restrict__ part,
                     TX* __restrict__ y, int T, int k, long long n_rows) {
  const int st = fold[3 * blockIdx.x];
  const int p0 = fold[3 * blockIdx.x + 1];
  const int np = fold[3 * blockIdx.x + 2];
  const int bs = blockIdx.y;
  const int e = blockIdx.z * GK_LANES + threadIdx.x;  // entry in the tile
  const long long row0 = (long long)st * T * GK_WELL_TILE + (long long)bs * GK_LANES;
  if (row0 + e / k >= n_rows) return;
  const long long size = (long long)T * GK_WELL_TILE * k;  // one partial
  const TX* src = part + (long long)p0 * size + (long long)bs * GK_LANES * k + e;
  TX sum = src[0];
  int i = 1;
  for (; i + GK_WELL_FOLD_BATCH <= np; i += GK_WELL_FOLD_BATCH) {
    TX v[GK_WELL_FOLD_BATCH];
#pragma unroll
    for (int j = 0; j < GK_WELL_FOLD_BATCH; ++j) v[j] = src[(i + j) * size];
#pragma unroll
    for (int j = 0; j < GK_WELL_FOLD_BATCH; ++j) sum += v[j];
  }
  for (; i < np; ++i) sum += src[i * size];
  y[row0 * k + e] = sum;
}

static int gk_max_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return bytes;
}

// Dynamic shared memory of a block: the ring, then K8's step sums and sums
// (T > 1) or K9's sums of KC columns (T > 1).
template <typename TV, typename TX>
static size_t gk_block_bytes(int T, int kc) {
  const size_t sums = T > 1 ? (size_t)T * GK_LANES * sizeof(TX) * (kc == 0 ? 2 : kc) : 0;
  return (kc == 0 ? GK_WELL_SPMV_STAGES * sizeof(WellStage<TV, GK_WELL_SPMV_U>)
                  : GK_WELL_SPMM_STAGES * sizeof(WellStage<TV, GK_WELL_SPMM_U>)) +
         sums;
}

// K9's column group: 4 columns (k >= 3), 2 or 1, halved until a block fits.
template <typename TV, typename TX>
static int gk_spmm_kc(int T, int k, int max_smem) {
  for (int kc = k >= 3 ? 4 : k; kc >= 1; kc /= 2)
    if (gk_block_bytes<TV, TX>(T, kc) <= (size_t)max_smem) return kc;
  return 0;
}

template <typename Kernel>
static int gk_prepare(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename TX>
static int launch_fold(const int* fold, int n_split, const void* part, void* y, int T, int k,
                       long long n_rows, cudaStream_t stream) {
  if (n_split == 0) return 0;
  well_fold_kernel<TX><<<dim3((unsigned)n_split, (unsigned)(T * GK_WELL_SUB), (unsigned)k),
                         GK_LANES, 0, stream>>>(fold, (const TX*)part, (TX*)y, T, k, n_rows);
  return (int)cudaGetLastError();
}

template <typename TV, typename TX, bool SUBS>
static int launch_spmv(const WellPlanArgs& P, const int* work, int n_chunks, const int* fold,
                       int n_split, void* part, const void* x, void* y, long long n_rows,
                       long long n_cols, cudaStream_t stream) {
  const size_t bytes = gk_block_bytes<TV, TX>(P.T, 0);
  if (bytes > (size_t)gk_max_smem()) return (int)cudaErrorInvalidConfiguration;
  int status = gk_prepare(well_spmv_kernel<TV, TX, SUBS>, bytes);
  if (status) return status;
  well_spmv_kernel<TV, TX, SUBS>
      <<<dim3((unsigned)n_chunks, GK_WELL_SUB), GK_LANES, bytes, stream>>>(
          P, (const int4*)work, (const TX*)x, (TX*)y, (TX*)part, n_rows, n_cols);
  status = (int)cudaGetLastError();
  if (status) return status;
  return launch_fold<TX>(fold, n_split, part, y, P.T, 1, n_rows, stream);
}

template <typename TV, typename TX, bool SUBS, int KC>
static int launch_spmm_kc(const WellPlanArgs& P, const int* work, int n_chunks, const int* fold,
                          int n_split, void* part, const void* X, void* Y, long long n_rows,
                          long long n_cols, int k, cudaStream_t stream) {
  const size_t bytes = gk_block_bytes<TV, TX>(P.T, KC);
  int status = gk_prepare(well_spmm_kernel<TV, TX, SUBS, KC>, bytes);
  if (status) return status;
  // wide accesses of KC entries need the row starts aligned to their width
  const size_t width = KC * sizeof(TX) < 16 ? KC * sizeof(TX) : 16;
  const bool rows = (k * sizeof(TX)) % width == 0;
  const int vec_x = rows && (size_t)X % width == 0;
  const int vec_out = rows && (size_t)Y % width == 0 && (size_t)part % width == 0;
  const unsigned groups = (unsigned)((k + KC - 1) / KC);
  well_spmm_kernel<TV, TX, SUBS, KC>
      <<<dim3((unsigned)n_chunks, GK_WELL_SUB, groups), GK_LANES, bytes, stream>>>(
          P, (const int4*)work, (const TX*)X, (TX*)Y, (TX*)part, n_rows, n_cols, k, vec_x,
          vec_out);
  status = (int)cudaGetLastError();
  if (status) return status;
  return launch_fold<TX>(fold, n_split, part, Y, P.T, k, n_rows, stream);
}

template <typename TV, typename TX, bool SUBS>
static int launch_spmm(const WellPlanArgs& P, const int* work, int n_chunks, const int* fold,
                       int n_split, void* part, const void* X, void* Y, long long n_rows,
                       long long n_cols, int k, cudaStream_t stream) {
  switch (gk_spmm_kc<TV, TX>(P.T, k, gk_max_smem())) {
    case 4:
      return launch_spmm_kc<TV, TX, SUBS, 4>(P, work, n_chunks, fold, n_split, part, X, Y,
                                             n_rows, n_cols, k, stream);
    case 2:
      return launch_spmm_kc<TV, TX, SUBS, 2>(P, work, n_chunks, fold, n_split, part, X, Y,
                                             n_rows, n_cols, k, stream);
    case 1:
      return launch_spmm_kc<TV, TX, SUBS, 1>(P, work, n_chunks, fold, n_split, part, X, Y,
                                             n_rows, n_cols, k, stream);
    default:
      return (int)cudaErrorInvalidConfiguration;
  }
}

// (vector, value) dtypes and whether the sums are routed by sub-tile
#define GK_WELL_DISPATCH_T(TV_, TX_, T_, CALL) \
  do {                                         \
    using TV = TV_;                            \
    using TX = TX_;                            \
    if (T_ == 1) {                             \
      constexpr bool SUBS = false;             \
      return CALL;                             \
    }                                          \
    constexpr bool SUBS = true;                \
    return CALL;                               \
  } while (0)

#define GK_WELL_DISPATCH_V(TX_, v_dtype, T_, CALL)                              \
  do {                                                                         \
    if (v_dtype == GK_F32) GK_WELL_DISPATCH_T(float, TX_, T_, CALL);           \
    if (v_dtype == GK_F64) GK_WELL_DISPATCH_T(double, TX_, T_, CALL);          \
    if (v_dtype == GK_BF16) GK_WELL_DISPATCH_T(__nv_bfloat16, TX_, T_, CALL);  \
    return (int)cudaErrorInvalidValue;                                         \
  } while (0)

#define GK_WELL_DISPATCH(x_dtype, v_dtype, T_, CALL)                     \
  do {                                                                  \
    if (x_dtype == GK_F32) GK_WELL_DISPATCH_V(float, v_dtype, T_, CALL);  \
    if (x_dtype == GK_F64) GK_WELL_DISPATCH_V(double, v_dtype, T_, CALL); \
    return (int)cudaErrorInvalidValue;                                  \
  } while (0)

static bool gk_well_args(WellPlanArgs* P, const void* values, const void* qidx,
                         const void* rt, const void* tsb, const int* bases, int T, int G,
                         int n_split, const void* part) {
  if (T < 1 || T > GK_WELL_MAX_T || G < 1 || (T > 1 && tsb == nullptr) ||
      (n_split > 0 && part == nullptr))
    return false;
  P->values = values;
  P->qidx = static_cast<const signed char*>(qidx);
  P->rt = static_cast<const signed char*>(rt);
  P->tsb = static_cast<const signed char*>(tsb);
  P->bases = bases;
  P->T = T;
  P->G = G;
  return true;
}

// work: (n_chunks, 4) int32 and fold: (n_split, 3) int32, as ops/well.py
// chunk_list builds them; part: room for the partials of every chunk of a
// split supertile, T * 1024 (K9: T * 1024 * k) entries each.
extern "C" int well_spmv(const void* values, int v_dtype, const void* qidx, const void* rt,
                         const void* tsb, const int* bases, int T, int G, const int* work,
                         int n_chunks, const int* fold, int n_split, void* part, const void* x,
                         int x_dtype, void* y, long long n_rows, long long n_cols, void* stream) {
  WellPlanArgs P;
  if (!gk_well_args(&P, values, qidx, rt, tsb, bases, T, G, n_split, part))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || n_chunks == 0) return 0;
  GK_WELL_DISPATCH(x_dtype, v_dtype, T,
                   (launch_spmv<TV, TX, SUBS>(P, work, n_chunks, fold, n_split, part, x, y,
                                              n_rows, n_cols, (cudaStream_t)stream)));
}

extern "C" int well_spmm(const void* values, int v_dtype, const void* qidx, const void* rt,
                         const void* tsb, const int* bases, int T, int G, const int* work,
                         int n_chunks, const int* fold, int n_split, void* part, const void* X,
                         int x_dtype, void* Y, long long n_rows, long long n_cols, int k,
                         void* stream) {
  WellPlanArgs P;
  if (!gk_well_args(&P, values, qidx, rt, tsb, bases, T, G, n_split, part))
    return (int)cudaErrorInvalidValue;
  if (k > 65535) return (int)cudaErrorInvalidValue;  // a grid dimension holds the columns
  if (n_rows == 0 || n_chunks == 0 || k == 0) return 0;
  GK_WELL_DISPATCH(x_dtype, v_dtype, T,
                   (launch_spmm<TV, TX, SUBS>(P, work, n_chunks, fold, n_split, part, X, Y,
                                              n_rows, n_cols, k, (cudaStream_t)stream)));
}

// Dynamic shared memory one block asks for: K8 (k == 0) or K9 with k
// columns; -1 when it does not fit the current card.
template <typename TV, typename TX>
static int gk_well_block_smem(int T, int k) {
  const int max_smem = gk_max_smem();
  if (k == 0) {
    const size_t bytes = gk_block_bytes<TV, TX>(T, 0);
    return bytes <= (size_t)max_smem ? (int)bytes : -1;
  }
  const int kc = gk_spmm_kc<TV, TX>(T, k, max_smem);
  return kc ? (int)gk_block_bytes<TV, TX>(T, kc) : -1;
}

extern "C" int well_block_smem(int v_dtype, int x_dtype, int T, int k) {
  if (T < 1 || T > GK_WELL_MAX_T || k < 0) return -1;
  GK_WELL_DISPATCH(x_dtype, v_dtype, T, (gk_well_block_smem<TV, TX>(SUBS ? T : 1, k)));
}
