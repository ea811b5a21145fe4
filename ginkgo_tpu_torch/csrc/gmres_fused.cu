// Whole-solve restarted GMRES(m) in one persistent cooperative kernel,
// templated on its operator (coop.cuh GkDiaOp, pell.cuh GkPellOp): kernel
// K15 of the PyTorch port on a Dia, K18 on a Pell, and the k-column form
// K15m (below).
//
// K18 replaces ginkgo_tpu/ops/pallas_gmres.py pell_gmres_vmem_solve
// (_gmres_pell_kernel, :857), which runs the same _gmres_core over the
// Pell SpMV: only the operator's row differs (Arnoldi product, true
// residual), and every step moves the plan once in place of the diagonals.
//
// K15 replaces ginkgo_tpu/ops/pallas_gmres.py gmres_vmem_solve
// (_gmres_dia_kernel, :834, over _gmres_core, :110-378): left scalar-Jacobi
// preconditioned GMRES(m) with the Arnoldi process orthogonalized by CGS2,
// the Givens QR of the Hessenberg matrix updated on the fly, the
// back-substitution and the x update at the end of every cycle, and an
// honest re-check of the TRUE residual after every restart.  The kernel
// takes b (not r0) and returns the true r.r, always.
//
// What bounds it on the H100: bytes.  The basis, (m + 1) x n in float32 or
// bfloat16 (the CB-GMRES reduce1/reduce2 storage), lives in device memory:
// 520 MB in float32 at 4.19M rows and m = 30.  Arnoldi step j of CGS2
// reads the j + 1 basis rows in each of its two dot phases and two
// subtractions, so the bytes per step grow with j; a bfloat16 basis halves
// them.
//
// What the design does about it: K15m's tiled passes (below) at one
// column, a row being 4 consecutive elements.  The basis and u hold n4 = n
// rounded up to 4 elements a row (those from n zero), taken as n4 / 4 rows
// of 4: a thread's row moves as one 16-byte access of a float32 basis (8
// of a bfloat16 one), where one element a thread moved 4 (2) and the
// kernel waited on its loads.  The passes of a step go over the rows of 4
// in tiles of GK_CG_THREADS * GK_GMRES1_TILE_ROWS, the same rows for a
// thread in every pass of the step:
//   A: u = M A V_j for the thread's 4 elements (gk_rows4: a Pell's four
//      rows share one walk over their tile's slots), kept in registers and
//      written once, and the first dots <V_i, u> for i = 0..j, each basis
//      row read once, row i + 1's loads issued before row i's arithmetic
//      (gk_tile_dot_rows);
//   B: u -= h1_i V_i in i order, written once, then the second dots, from
//      row j down to 0, so the rows the subtraction read last are read
//      again first, while still in L2;
//   C: u -= h2_i V_i in i order, and u.u;
//   D: V_{j+1} = u / |u|.
// The dots are float64: a thread sums its elements' products, a warp folds
// them by shuffles into its own running sums in shared memory once a tile
// and dot, the block adds its warps' sums in a fixed order into one
// partial a dot (gk_block_dots), and after a grid barrier one block a dot
// folds the partials in coop.cuh's fixed order, loading them at once
// (sum_dots_cols); every block then reads the sums.  Six grid barriers a
// step, as before: after pass A, after the first sums, after pass B, after
// the second sums, after pass C, after pass D.  Bytes a row and step
// (float32 basis, nd diagonals of TD): 4 nd + 32 + 16 (j + 1), 12 (j + 1)
// of them from device memory where pass B's second read of a basis row
// comes from L2; a Pell reads its plan (sizeof(value) + sizeof(q) a cell)
// in place of the diagonals.  The gathers of the operator's rows are plain
// loads (GmresDiaOp, GmresPellOp).  The rest of a cycle (V_0, the x update,
// the true residual) runs once a cycle, an element a thread grid-stride.
//
// The order of every operation, as the TPU kernel's:
//   - CGS2 as the TPU kernel (:233-266): all dots, then all subtractions,
//     twice; per element u -= h_i V_i in i order.
//   - The Givens rotations, the new rotation (phase = sign(a) for real
//     data), g, and the back-substitution are m-sized scalar work: thread 0
//     of every block does them redundantly in float32, in the TPU kernel's
//     order (:288-345), in shared memory, so every block takes the same
//     branch.  The back-substitution sums R[i][k] y[k] for k = i + 1 ..
//     steps - 1 in that order.
//   - x += y_i V_i in i order (:348-360).
//   - The first cycle's stop flag starts from the true residual; inside a
//     cycle the stop test is |g[j+1]|^2 (the preconditioned estimate); the
//     true residual after each restart decides `done` and can retract it.
//   - !(mon <= tol_sq) as the test, so a NaN keeps iterating; 1/0 norms
//     take 1 (inv_beta, inv_h), zero pivots give y = 0.

#include <type_traits>

#include "coop.cuh"
#include "pell.cuh"

namespace cg = cooperative_groups;

// Most Krylov dimensions the kernel takes: its scalar state, 4 (m^2 + 7 m
// + 3) bytes, and its warps' running dot sums, 64 (m + 1) bytes, live in
// shared memory, 49,280 bytes at m = 100 (opted in above 48 KB;
// ops/gmres.py MAX_FUSED_KRYLOV_DIM).
#define GK_GMRES_MAX_M 100
// K15m keeps that state per column, 4 k (m^2 + 7 m + 3) bytes, beside its
// warps' running dot sums (gmres_multi_smem): 58,704 bytes at m = 50 and
// k = 4 (ops/gmres.py MAX_FUSED_KRYLOV_DIM_MULTI).
#define GK_GMRES_MULTI_MAX_M 50

// K15's and K18's rows of 4 elements a thread takes of a tile, and the
// blocks an SM their launch bounds ask the compiler to leave room for (64
// registers a thread): on the H100 two rows at 4 blocks an SM beat one row
// (by up to 20% a step with a bfloat16 basis), rows left to the compiler
// (103-122 registers, 2 blocks an SM; 25-37% slower) and 5 or 6 blocks an
// SM (PERF.md section 6).
#define GK_GMRES1_TILE_ROWS 2
#define GK_GMRES1_MIN_BLOCKS 4

template <typename Op>
struct GmresParams {
  Op op;
  long long n;
  const float* b;
  const float* x0;
  const float* minv;    // nullptr: Identity
  const float* tol_sq;  // device scalar
  int max_iters;
  int m;
  float* x;
  float* u;      // (n4,)
  void* V;       // (m + 1, n4) basis, n4 = n rounded up to 4
  double* part;  // (m + 4) * gridDim.x per-block partial sums
  double* hd;    // (m + 1) summed dots
  int* it_out;
  float* rr_out;
  int* conv_out;
};

__device__ __forceinline__ void gk_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void gk_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// k-column restarted GMRES(m) with per-column stopping: kernel K15m.
//
// Replaces ginkgo_tpu/ops/pallas_gmres.py gmres_vmem_solve_multi
// (_gmres_multi_dia_kernel, :396-766): K columns (2 <= K <= 4) in K15's
// passes, the vectors (n, K) row-major and the basis (m + 1, n, K), so a
// pass reads each diagonal value once per row for all K columns and the
// six grid barriers of an Arnoldi step are shared by the columns.
//   - One Arnoldi step counter j for all columns; each column has its own
//     g, cs, sn, R (per-column blocks of the dynamic shared memory, run by
//     thread 0 of every block as in K15, with K15's rotation order, phase =
//     sign(a) and in-i-order subtractions).
//   - A column stays active in a cycle while !(g[j+1]^2 <= tol) and
//     it < max_iters; a stopped column's QR freezes, but its basis row is
//     still written.
//   - After the cycle: the back-substitution over the full m (rows past a
//     column's own steps have a zero R diagonal and give y = 0), y = 0 for
//     a column done at the cycle's start, and x += y_i V_i over the shared j.
//   - The true residual of every column then decides `done` (done only
//     grows): a column whose in-cycle stop the true residual does not
//     confirm runs on in the next cycle.  The first `done` comes from r0.
//
// What bounds it on the H100: bytes, the basis rows above all.  Arnoldi
// step j of CGS2 reads basis rows 0..j in each of its two dot phases and
// two subtractions.  The passes of a step go over the rows in tiles of
// GK_CG_THREADS * GK_GMRES_TILE_ROWS rows, a thread GK_GMRES_TILE_ROWS rows
// of a tile, the same rows in every pass of the step:
//   A: u = M A V_j, kept in registers and written once, and the first dots
//      <V_i, u> for i = 0..j, each basis row read once;
//   B: u -= h1_i V_i in i order, written once, then the second dots, each
//      basis row read again while the tile's rows are still in L2;
//   C: u -= h2_i V_i in i order, and u.u;
//   D: V_{j+1} = u / |u|.
// A row's K values move as one access: 16 bytes for float32 at K = 4, 8 for
// K = 2 or bfloat16 at K = 4, 4 for bfloat16 at K = 2, K scalars at K = 3
// (GkRowK).  The dots are float64: a thread sums its rows' products, a warp
// folds them by shuffles into its own running sums in shared memory once a
// tile and dot, and the block adds its warps' sums in a fixed order into
// one partial a dot and column, which sum_dots_cols folds after the
// barrier.  Bytes a row and step (float32 basis, K = 4, nd diagonals of
// TD): nd sizeof(TD) + 128 + 64 (j + 1) (A: V_j, u out, j + 1 basis rows;
// B and C: u in and out, the basis rows, twice in B; D: u in, V_{j+1}
// out), 48 (j + 1) of them from device memory where pass B's second read
// of a basis row comes from L2.
// K15m's rows a thread takes of a tile: on the H100 4 beat 2 and 8 at k = 4
// (PERF.md section 6).
#define GK_GMRES_TILE_ROWS 4

// Row e of a row-major (n, K) array of T (float32 or bfloat16) as K floats,
// and back (a bfloat16 rounded to nearest even, as gk_store).  load_cg
// reads past L1: rows that other blocks wrote since the last grid barrier.
template <typename T, int K>
struct GkRowK {
  static constexpr int BYTES = K * (int)sizeof(T);
  static __device__ __forceinline__ void load_cg(const T* base, long long e, float (&out)[K]) {
    const T* row = base + e * K;
    if constexpr (std::is_same<T, float>::value && BYTES == 16) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(row));
      out[0] = a.x;
      out[1] = a.y;
      out[2] = a.z;
      out[3] = a.w;
    } else if constexpr (std::is_same<T, float>::value && BYTES == 8) {
      const float2 a = __ldcg(reinterpret_cast<const float2*>(row));
      out[0] = a.x;
      out[1] = a.y;
    } else if constexpr (!std::is_same<T, float>::value && (BYTES == 8 || BYTES == 4)) {
      unsigned w[BYTES / 4];
      if constexpr (BYTES == 8) {
        const uint2 a = __ldcg(reinterpret_cast<const uint2*>(row));
        w[0] = a.x;
        w[1] = a.y;
      } else {
        w[0] = __ldcg(reinterpret_cast<const unsigned*>(row));
      }
#pragma unroll
      for (int c = 0; c < K; ++c)
        out[c] = __uint_as_float((c & 1) ? (w[c / 2] & 0xffff0000u) : (w[c / 2] << 16));
    } else {
#pragma unroll
      for (int c = 0; c < K; ++c) out[c] = gk_to_float(__ldcg(row + c));
    }
  }
  static __device__ __forceinline__ void store(T* base, long long e, const float (&in)[K]) {
    T* row = base + e * K;
    if constexpr (std::is_same<T, float>::value && BYTES == 16) {
      *reinterpret_cast<float4*>(row) = make_float4(in[0], in[1], in[2], in[3]);
    } else if constexpr (std::is_same<T, float>::value && BYTES == 8) {
      *reinterpret_cast<float2*>(row) = make_float2(in[0], in[1]);
    } else if constexpr (!std::is_same<T, float>::value && (BYTES == 8 || BYTES == 4)) {
      unsigned w[BYTES / 4];
#pragma unroll
      for (int q = 0; q < BYTES / 4; ++q) {
        const __nv_bfloat16 lo = __float2bfloat16(in[2 * q]);
        const __nv_bfloat16 hi = __float2bfloat16(in[2 * q + 1]);
        w[q] = (unsigned)*reinterpret_cast<const unsigned short*>(&lo) |
               ((unsigned)*reinterpret_cast<const unsigned short*>(&hi) << 16);
      }
      if constexpr (BYTES == 8)
        *reinterpret_cast<uint2*>(row) = make_uint2(w[0], w[1]);
      else
        *reinterpret_cast<unsigned*>(row) = w[0];
    } else {
#pragma unroll
      for (int c = 0; c < K; ++c) gk_store(row + c, in[c]);
    }
  }
};

// Row i of a DIA product on the K columns of a row-major (n, K) source of
// TS, gk_dia_row_cols's sums with each source row read as one access.
template <typename TD, typename TS, int K>
__device__ __forceinline__ void gk_dia_row_rows(const TD* __restrict__ D, const GkOffsets& offs,
                                                long long n, long long i, const TS* src,
                                                float (&acc)[K]) {
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = 0.f;
  for (int d = 0; d < offs.nd; ++d) {
    const long long j = i + offs.off[d];
    if (j >= 0 && j < n) {
      const float v = GkAcc<float>::load(D[d * n + i]);
      float s[K];
      GkRowK<TS, K>::load_cg(src, j, s);
#pragma unroll
      for (int c = 0; c < K; ++c) acc[c] += v * s[c];
    }
  }
}

// The rows of a tile of an Arnoldi step's passes, T rows a thread: row q
// of this thread in tile tt.
template <int T>
__device__ __forceinline__ long long gk_tile_row(long long tt, int q) {
  return (tt * T + q) * GK_CG_THREADS + threadIdx.x;
}

// This thread's rows of tile tt of the basis row Vi (rows past n: none read).
template <typename TV, int K, int T>
__device__ __forceinline__ void gk_tile_load(const TV* Vi, long long n, long long tt,
                                             float (&v)[T][K]) {
#pragma unroll
  for (int q = 0; q < T; ++q) {
    const long long row = gk_tile_row<T>(tt, q);
    if (row < n) GkRowK<TV, K>::load_cg(Vi, row, v[q]);
  }
}

// One dot of a tile: the thread's products vi[q][c] ud[q][c] summed over its
// rows q < n in order, folded over the warp by shuffles, added by lane 0
// to the warp's running sums ws[c].
template <int K, int T>
__device__ __forceinline__ void gk_warp_dots(const float (&vi)[T][K], const double (&ud)[T][K],
                                             long long n, long long tt, double* ws) {
  double acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = 0.0;
#pragma unroll
  for (int q = 0; q < T; ++q) {
    if (gk_tile_row<T>(tt, q) < n) {
#pragma unroll
      for (int c = 0; c < K; ++c) acc[c] += (double)vi[q][c] * ud[q][c];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] += __shfl_down_sync(0xffffffffu, acc[c], o);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < K; ++c) ws[c] += acc[c];
  }
}

// gk_warp_dots of one dot over all K values of a row: the thread's
// products summed over its rows q < n, each row's values in order c = 0..K-1,
// then folded over the warp, lane 0 adding the fold to ws[0].
template <int K, int T>
__device__ __forceinline__ void gk_warp_dot_rows(const float (&vi)[T][K],
                                                 const double (&ud)[T][K], long long n,
                                                 long long tt, double* ws) {
  double acc = 0.0;
#pragma unroll
  for (int q = 0; q < T; ++q) {
    if (gk_tile_row<T>(tt, q) < n) {
#pragma unroll
      for (int c = 0; c < K; ++c) acc += (double)vi[q][c] * ud[q][c];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) ws[0] += acc;
}

// The one-column dots <V_i, u> of one tile, a row being K consecutive
// elements (gk_warp_dot_rows), for i = 0..j, or from j down to 0 (`down`:
// pass B, whose subtraction has just read the later rows); basis row i's
// successor's loads issued before row i's arithmetic.
template <typename TV, int K, int T>
__device__ __forceinline__ void gk_tile_dot_rows(const TV* V, long long n, int j, long long tt,
                                                 const double (&ud)[T][K], double* ws,
                                                 bool down) {
  float nx[T][K];
  gk_tile_load<TV, K, T>(V + (long long)(down ? j : 0) * n * K, n, tt, nx);
  for (int k = 0; k <= j; ++k) {
    const int i = down ? j - k : k;
    float vi[T][K];
#pragma unroll
    for (int q = 0; q < T; ++q) {
#pragma unroll
      for (int c = 0; c < K; ++c) vi[q][c] = nx[q][c];
    }
    if (k < j) gk_tile_load<TV, K, T>(V + (long long)(down ? i - 1 : i + 1) * n * K, n, tt, nx);
    gk_warp_dot_rows<K, T>(vi, ud, n, tt, ws + i);
  }
}

// The dots <V_i, u> of one tile for i = 0..j, u the thread's rows in
// float64 (rows past n hold 0 and read no basis row): each warp adds its
// fold of every dot to its running sums ws[i * K + c].  Basis row i + 1's
// loads are issued before row i's arithmetic.
template <typename TV, int K, int T>
__device__ __forceinline__ void gk_tile_dots(const TV* V, long long n, int j, long long tt,
                                             const double (&ud)[T][K], double* ws) {
  float nx[T][K];
  gk_tile_load<TV, K, T>(V, n, tt, nx);
  for (int i = 0; i <= j; ++i) {
    float vi[T][K];
#pragma unroll
    for (int q = 0; q < T; ++q) {
#pragma unroll
      for (int c = 0; c < K; ++c) vi[q][c] = nx[q][c];
    }
    if (i < j) gk_tile_load<TV, K, T>(V + (long long)(i + 1) * n * K, n, tt, nx);
    gk_warp_dots<K, T>(vi, ud, n, tt, ws + i * K);
  }
}

// u -= h_i V_i for i = 0..j in i order on the thread's rows of tile tt
// (h[c] column c's coefficients), basis row i + 1's loads issued before row
// i's arithmetic.
template <typename TV, int K, int T>
__device__ __forceinline__ void gk_tile_subtract(const TV* V, long long n, int j, long long tt,
                                                 float* const (&h)[K], float (&uk)[T][K]) {
  float nx[T][K];
  gk_tile_load<TV, K, T>(V, n, tt, nx);
  for (int i = 0; i <= j; ++i) {
    float vi[T][K];
#pragma unroll
    for (int q = 0; q < T; ++q) {
#pragma unroll
      for (int c = 0; c < K; ++c) vi[q][c] = nx[q][c];
    }
    if (i < j) gk_tile_load<TV, K, T>(V + (long long)(i + 1) * n * K, n, tt, nx);
    float hi[K];
#pragma unroll
    for (int c = 0; c < K; ++c) hi[c] = h[c][i];
#pragma unroll
    for (int q = 0; q < T; ++q) {
      if (gk_tile_row<T>(tt, q) < n) {
#pragma unroll
        for (int c = 0; c < K; ++c) uk[q][c] = uk[q][c] - hi[c] * vi[q][c];
      }
    }
  }
}

// After the pass's tiles: the block's partial of dot (i, c), its warps'
// running sums added in warp order, to part[(i * gridDim.x + b) * K + c]
// (sum_dots_cols's layout); then every warp's sums are zeroed for the next
// pass.  Call with the whole block.
template <int K>
__device__ __forceinline__ void gk_block_dots(double* wsum, int stride, int j, double* part) {
  __syncthreads();
  for (int e = threadIdx.x; e < (j + 1) * K; e += GK_CG_THREADS) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < GK_CG_WARPS; ++w) s += wsum[w * stride + e];
    part[((long long)(e / K) * gridDim.x + blockIdx.x) * K + e % K] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < GK_CG_WARPS * stride; e += GK_CG_THREADS) wsum[e] = 0.0;
  __syncthreads();
}

// After a grid barrier: hd[i * K + c] = the total of the partials of dot
// (i, c), folded by one block for each i in grid_total's order (so with its
// bits), the block's partials loaded at once (coop.cuh grid_total_batch).
template <int K>
__device__ __forceinline__ void sum_dots_cols(const double* part, double* hd, int j,
                                              double (&sh)[K][GK_CG_WARPS],
                                              double (&bc)[K]) {
  for (int i = blockIdx.x; i <= j; i += gridDim.x) {
    double tot[K];
    grid_total_batch<K, K <= 3 ? 4 : 2>(part + (long long)i * gridDim.x * K, K, 1, K, tot, sh,
                                        bc);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < K; ++c) hd[i * K + c] = tot[c];
    }
  }
}

// Rows e0 .. e0 + 3 of the operator's product with src (rows from n: 0),
// each summed as op.row sums it.  A Dia takes the four rows diagonal by
// diagonal; a Pell's four rows are lanes l .. l + 3 (l a multiple of 4) of
// one sublane of one tile, so they walk the tile's slots once, each slot's
// base read once and the rows' value, lane index and gather loads issued
// before their sums (pell.cuh's order a row).
template <typename TD, bool LDCG, typename TS>
__device__ __forceinline__ void gk_rows4(const GkDiaOp<TD, LDCG>& op, long long e0, long long n,
                                         const TS* src, float (&out)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = 0.f;
  for (int d = 0; d < op.offs.nd; ++d) {
    const long long off = op.offs.off[d];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long i = e0 + k, c = i + off;
      if (i < n && c >= 0 && c < n)
        out[k] += GkAcc<float>::load(op.diags[d * n + i]) *
                  gk_to_float(LDCG ? __ldcg(src + c) : src[c]);
    }
  }
}

template <typename TV, typename TQ, bool LDCG, typename TS>
__device__ __forceinline__ void gk_rows4(const GkPellOp<TV, TQ, LDCG>& op, long long e0,
                                         long long n, const TS* src, float (&out)[4]) {
  const int S = op.S, G = op.G;
  const long long t = e0 / ((long long)S * GK_LANES);
  const int s = (int)((e0 / GK_LANES) % S);
  const int l = (int)(e0 % GK_LANES);
  const int end = op.tile_ptr[t + 1];
  float total[4] = {0.f, 0.f, 0.f, 0.f};
  for (int slot0 = op.tile_ptr[t]; slot0 < end; slot0 += G) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int g = 0; g < G; ++g) {
      const long long slot = slot0 + g;
      const long long cell = (slot * S + s) * GK_LANES + l;
      const long long panel = ((long long)op.bases[slot] - (S - 1) + s) * GK_LANES;
      float v[4], xv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long c = panel + (int)op.qidx[cell + k];
        v[k] = GkAcc<float>::load(op.values[cell + k]);
        xv[k] = 0.f;
        if (c >= 0 && c < op.n_cols) {
          const float x = gk_to_float(LDCG ? __ldcg(src + c) : src[c]);
          xv[k] = op.cminv ? op.cminv[c] * x : x;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] += v[k] * xv[k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) total[k] += acc[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = e0 + k < n ? total[k] : 0.f;
}

// Floats of K15's scalar state (h1, h2, g, cs, sn, y, R), rounded up to
// whole doubles; the warps' running dot sums follow it (gmres_smem).
__host__ __device__ inline int gmres_state_floats(int m) { return (m * m + 7 * m + 3 + 1) & ~1; }

// K15 and K18: the one-column solve in tiled passes (see the header).  The
// basis and u hold n4 = n rounded up to 4 elements a row, the elements from
// n zero, and a pass takes them as n4 / 4 rows of 4 (GkRowK<T, 4>).
template <typename Op, typename TV>
__global__ void __launch_bounds__(GK_CG_THREADS, GK_GMRES1_MIN_BLOCKS)
    gmres_fused_kernel(const GmresParams<Op> P) {
  constexpr int T = GK_GMRES1_TILE_ROWS;
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[1][GK_CG_WARPS];
  __shared__ double sh2[2][GK_CG_WARPS];
  __shared__ double bc1[1];
  __shared__ double bc2[2];
  __shared__ int sm_active;
  extern __shared__ float sm[];
  const int m = P.m;
  float* h1 = sm;            // [m + 1] first-pass dots
  float* h2 = h1 + (m + 1);  // [m + 1] second-pass dots
  float* g = h2 + (m + 1);   // [m + 1] rotated right-hand side
  float* cs = g + (m + 1);   // [m]
  float* sn = cs + m;        // [m]
  float* y = sn + m;         // [m]
  float* Rm = y + m;         // [m][m + 1]: row j is column j of R
  // the warps' running dot sums: warp w's at wsum[w * (m + 1) ..]
  double* wsum = reinterpret_cast<double*>(sm + gmres_state_floats(m));
  double* ws = wsum + (threadIdx.x >> 5) * (m + 1);
  for (int e = threadIdx.x; e < GK_CG_WARPS * (m + 1); e += GK_CG_THREADS) wsum[e] = 0.0;
  float* const hh1[4] = {h1, h1, h1, h1};
  float* const hh2[4] = {h2, h2, h2, h2};

  TV* V = static_cast<TV*>(P.V);
  const long long n = P.n;
  const long long n4 = (n + 3) & ~3LL;
  const long long nv = n4 / 4;  // rows of 4 elements
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long ntiles = (nv + (long long)GK_CG_THREADS * T - 1) / ((long long)GK_CG_THREADS * T);
  const int G = gridDim.x;
  double* part_b = P.part;                           // [m + 1][G] basis dots
  double* part_r = P.part + (long long)(m + 1) * G;  // [2][G] r.r, z.z
  double* part_n = part_r + 2 * G;                   // [G] u.u
  float* x = P.x;
  float* __restrict__ u = P.u;
  const float* __restrict__ minv = P.minv;
  const float tol_sq = *P.tol_sq;

  // init: x = x0, u = b - A x0; partial r.r and z.z with z = M u
  {
    double acc[2] = {0.0, 0.0};
    for (long long k = t0; k < n; k += stride) {
      x[k] = P.x0[k];
      const float rk = P.b[k] - P.op.row(k, P.x0);
      u[k] = rk;
      const float zk = minv ? minv[k] * rk : rk;
      acc[0] += (double)rk * rk;
      acc[1] += (double)zk * zk;
    }
    block_partial_vm<2>(acc, part_r, sh2);
  }
  grid.sync();
  double tot2[2], tot1[1];
  grid_total_batch<2, 4>(part_r, 1, G, 2, tot2, sh2, bc2);
  float rr = (float)tot2[0];
  float beta_sq = (float)tot2[1];
  bool done = (rr <= tol_sq) && (tol_sq >= 0.f);
  int it = 0;

  while (!done && it < P.max_iters) {
    // cycle start: V_0 = z / |z| with z = M u (u holds the true residual),
    // the elements from n zero
    const float beta = sqrtf(beta_sq);
    const float inv_beta = beta > 0.f ? 1.f / beta : 1.f;
    for (long long k = t0; k < n4; k += stride) {
      float v0 = 0.f;
      if (k < n) v0 = (minv ? minv[k] * u[k] : u[k]) * inv_beta;
      gk_store(V + k, v0);
    }
    if (threadIdx.x == 0) {
      for (int i = 0; i <= m; ++i) g[i] = 0.f;
      g[0] = beta;
      for (int i = 0; i < m; ++i) cs[i] = sn[i] = 0.f;
      for (int i = 0; i < m * (m + 1); ++i) Rm[i] = 0.f;
    }
    grid.sync();

    int j = 0;
    bool active = !(rr <= tol_sq);
    while (active && j < m) {
      // pass A: u = M A V_j; first dots <V_i, u>
      const TV* Vj = V + (long long)j * n4;
      for (long long tt = blockIdx.x; tt < ntiles; tt += G) {
        double ud[T][4];
#pragma unroll
        for (int q = 0; q < T; ++q) {
          const long long r = gk_tile_row<T>(tt, q);
          float uk[4] = {0.f, 0.f, 0.f, 0.f};
          if (r < nv) {
            gk_rows4(P.op, 4 * r, n, Vj, uk);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (minv && 4 * r + c < n) uk[c] = minv[4 * r + c] * uk[c];
            GkRowK<float, 4>::store(u, r, uk);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) ud[q][c] = uk[c];
        }
        gk_tile_dot_rows<TV, 4, T>(V, nv, j, tt, ud, ws, false);
      }
      gk_block_dots<1>(wsum, m + 1, j, part_b);
      grid.sync();
      sum_dots_cols<1>(part_b, P.hd, j, sh1, bc1);
      grid.sync();
      if (threadIdx.x <= j) h1[threadIdx.x] = (float)__ldcg(P.hd + threadIdx.x);
      __syncthreads();

      // pass B: u -= h1_i V_i in i order; second dots
      for (long long tt = blockIdx.x; tt < ntiles; tt += G) {
        float uk[T][4];
#pragma unroll
        for (int q = 0; q < T; ++q) {
          const long long r = gk_tile_row<T>(tt, q);
#pragma unroll
          for (int c = 0; c < 4; ++c) uk[q][c] = 0.f;
          if (r < nv) GkRowK<float, 4>::load_cg(u, r, uk[q]);
        }
        gk_tile_subtract<TV, 4, T>(V, nv, j, tt, hh1, uk);
        double ud[T][4];
#pragma unroll
        for (int q = 0; q < T; ++q) {
          if (gk_tile_row<T>(tt, q) < nv) GkRowK<float, 4>::store(u, gk_tile_row<T>(tt, q), uk[q]);
#pragma unroll
          for (int c = 0; c < 4; ++c) ud[q][c] = uk[q][c];
        }
        gk_tile_dot_rows<TV, 4, T>(V, nv, j, tt, ud, ws, true);
      }
      gk_block_dots<1>(wsum, m + 1, j, part_b);
      grid.sync();
      sum_dots_cols<1>(part_b, P.hd, j, sh1, bc1);
      grid.sync();
      if (threadIdx.x <= j) h2[threadIdx.x] = (float)__ldcg(P.hd + threadIdx.x);
      __syncthreads();

      // pass C: u -= h2_i V_i in i order; partial u.u
      {
        double acc[1] = {0.0};
        for (long long tt = blockIdx.x; tt < ntiles; tt += G) {
          float uk[T][4];
#pragma unroll
          for (int q = 0; q < T; ++q) {
            const long long r = gk_tile_row<T>(tt, q);
#pragma unroll
            for (int c = 0; c < 4; ++c) uk[q][c] = 0.f;
            if (r < nv) GkRowK<float, 4>::load_cg(u, r, uk[q]);
          }
          gk_tile_subtract<TV, 4, T>(V, nv, j, tt, hh2, uk);
#pragma unroll
          for (int q = 0; q < T; ++q) {
            const long long r = gk_tile_row<T>(tt, q);
            if (r < nv) {
              GkRowK<float, 4>::store(u, r, uk[q]);
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[0] += (double)uk[q][c] * uk[q][c];
            }
          }
        }
        block_partial<1>(acc, part_n, sh1);
      }
      grid.sync();
      grid_total_batch<1, 4>(part_n, 1, 1, 1, tot1, sh1, bc1);
      const float hnext = sqrtf((float)tot1[0]);
      const float inv_h = hnext > 0.f ? 1.f / hnext : 1.f;

      // the Givens chain on the new Hessenberg column, by thread 0
      if (threadIdx.x == 0) {
        float* h = h1;  // h = h1 + h2 in place, h[j + 1] = |u|
        for (int i = 0; i <= j; ++i) h[i] = h1[i] + h2[i];
        h[j + 1] = hnext;
        for (int i = 0; i < j; ++i) {
          const float hi = h[i], hi1 = h[i + 1];
          h[i] = cs[i] * hi + sn[i] * hi1;
          h[i + 1] = -sn[i] * hi + cs[i] * hi1;
        }
        const float a = h[j], bb = h[j + 1];
        const float denom = sqrtf(a * a + bb * bb);
        const float c = denom > 0.f ? fabsf(a) / denom : 1.f;
        const float phase = fabsf(a) > 0.f ? (a > 0.f ? 1.f : -1.f) : 1.f;
        const float s = denom > 0.f ? phase * bb / denom : 0.f;
        h[j] = c * a + s * bb;
        h[j + 1] = 0.f;
        const float gj = g[j];
        g[j + 1] = -s * gj;
        g[j] = c * gj;
        for (int i = 0; i <= m; ++i) Rm[j * (m + 1) + i] = i <= j ? h[i] : 0.f;
        cs[j] = c;
        sn[j] = s;
        const float res_sq = g[j + 1] * g[j + 1];
        sm_active = (!(res_sq <= tol_sq) && it + 1 < P.max_iters) ? 1 : 0;
      }
      __syncthreads();
      active = sm_active != 0;

      // pass D: V_{j+1} = u / |u|
      TV* Vn = V + (long long)(j + 1) * n4;
      for (long long tt = blockIdx.x; tt < ntiles; tt += G) {
#pragma unroll
        for (int q = 0; q < T; ++q) {
          const long long r = gk_tile_row<T>(tt, q);
          if (r < nv) {
            float uk[4];
            GkRowK<float, 4>::load_cg(u, r, uk);
#pragma unroll
            for (int c = 0; c < 4; ++c) uk[c] = uk[c] * inv_h;
            GkRowK<TV, 4>::store(Vn, r, uk);
          }
        }
      }
      ++it;
      ++j;
      grid.sync();
    }
    const int steps = j;

    // back-substitution R y = g on the first `steps` columns, by thread 0
    if (threadIdx.x == 0) {
      for (int i = 0; i < m; ++i) y[i] = 0.f;
      for (int i = steps - 1; i >= 0; --i) {
        float acc = 0.f;
        for (int k = i + 1; k < steps; ++k) acc = acc + Rm[k * (m + 1) + i] * y[k];
        const float diag = Rm[i * (m + 1) + i];
        y[i] = diag != 0.f ? (g[i] - acc) / diag : 0.f;
      }
    }
    __syncthreads();

    // x += y_i V_i in i order
    for (long long k = t0; k < n; k += stride) {
      float xk = x[k];
      for (int i = 0; i < steps; ++i)
        xk = xk + y[i] * gk_to_float(__ldcg(V + (long long)i * n4 + k));
      x[k] = xk;
    }
    grid.sync();

    // the true residual u = b - A x; partial r.r and z.z
    {
      double acc[2] = {0.0, 0.0};
      for (long long k = t0; k < n; k += stride) {
        const float rk = P.b[k] - P.op.row(k, x);
        u[k] = rk;
        const float zk = minv ? minv[k] * rk : rk;
        acc[0] += (double)rk * rk;
        acc[1] += (double)zk * zk;
      }
      block_partial_vm<2>(acc, part_r, sh2);
    }
    grid.sync();
    grid_total_batch<2, 4>(part_r, 1, G, 2, tot2, sh2, bc2);
    rr = (float)tot2[0];
    beta_sq = (float)tot2[1];
    done = (rr <= tol_sq) && (tol_sq >= 0.f);
  }

  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *P.it_out = it;
    *P.rr_out = rr;
    *P.conv_out = done ? 1 : 0;
  }
}

struct GmresMultiParams {
  const void* diags;
  GkOffsets offs;
  long long n;
  const float* b;       // (n, K)
  const float* x0;      // (n, K)
  const float* minv;    // (n,) or nullptr: Identity
  const float* tol_sq;  // (K,)
  int max_iters;
  int m;
  float* x;      // (n, K)
  float* u;      // (n, K)
  void* V;       // (m + 1, n, K) basis
  double* part;  // (m + 4) K gridDim.x per-block partial sums
  double* hd;    // (m + 1) K summed dots
  int* it_out;
  float* rr_out;  // (K,)
  int* conv_out;  // (K,)
  int* itc_out;   // (K,)
};

// Floats of K15m's per-column scalar state, rounded up to whole doubles; the
// warps' running dot sums follow it (gmres_multi_smem).
__host__ __device__ inline int gmres_multi_state_floats(int k, int m) {
  return (k * (m * m + 7 * m + 3) + 1) & ~1;
}

template <typename TD, typename TV, int K>
__global__ void __launch_bounds__(GK_CG_THREADS)
    gmres_fused_multi_kernel(const GmresMultiParams P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double shK[K][GK_CG_WARPS];
  __shared__ double sh2K[2 * K][GK_CG_WARPS];
  __shared__ double bcK[K];
  __shared__ double bc2K[2 * K];
  __shared__ int sm_act[K];
  extern __shared__ float sm[];
  const int m = P.m;
  const int per_col = m * m + 7 * m + 3;
  // column c's block: h1 [m+1], h2 [m+1], g [m+1], cs [m], sn [m], y [m],
  // Rm [m][m+1] (row j is column j of R), as K15's
  float *h1[K], *h2[K], *g[K], *cs[K], *sn[K], *y[K], *Rm[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    h1[c] = sm + c * per_col;
    h2[c] = h1[c] + (m + 1);
    g[c] = h2[c] + (m + 1);
    cs[c] = g[c] + (m + 1);
    sn[c] = cs[c] + m;
    y[c] = sn[c] + m;
    Rm[c] = y[c] + m;
  }
  // the warps' running dot sums: warp w's at wsum[w * (m + 1) K ..]
  const int ws_stride = (m + 1) * K;
  double* wsum = reinterpret_cast<double*>(sm + gmres_multi_state_floats(K, m));
  double* ws = wsum + (threadIdx.x >> 5) * ws_stride;
  for (int e = threadIdx.x; e < GK_CG_WARPS * ws_stride; e += GK_CG_THREADS) wsum[e] = 0.0;

  const TD* __restrict__ D = static_cast<const TD*>(P.diags);
  TV* V = static_cast<TV*>(P.V);
  const long long n = P.n;
  const long long nK = n * K;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long ntiles = (n + (long long)GK_CG_THREADS * GK_GMRES_TILE_ROWS - 1) /
                           ((long long)GK_CG_THREADS * GK_GMRES_TILE_ROWS);
  const int G = gridDim.x;
  double* part_b = P.part;                                // [m + 1][G][K] basis dots
  double* part_r = P.part + (long long)(m + 1) * G * K;  // [G][2K] r.r, z.z
  double* part_n = part_r + 2 * G * K;                    // [G][K] u.u
  float* x = P.x;
  float* __restrict__ u = P.u;
  const float* __restrict__ minv = P.minv;
  float tol[K], rr[K], beta_sq[K];
  bool done[K];
  int itc[K];

  // init: X = X0, U = B - A X0; partial r.r and z.z with z = M u
  {
    double acc[2 * K];
#pragma unroll
    for (int c = 0; c < 2 * K; ++c) acc[c] = 0.0;
    for (long long k = t0; k < n; k += stride) {
      float ax[K];
      // x0 is the caller's: read as scalars, whatever its alignment
      gk_dia_row_cols<TD, float, K>(D, P.offs, n, k, P.x0, ax);
      const float mk = minv ? minv[k] : 1.f;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const long long e = k * K + c;
        x[e] = P.x0[e];
        const float rk = P.b[e] - ax[c];
        u[e] = rk;
        const float zk = minv ? mk * rk : rk;
        acc[c] += (double)rk * rk;
        acc[K + c] += (double)zk * zk;
      }
    }
    block_partial<2 * K>(acc, part_r, sh2K);
  }
  grid.sync();
  double tot2[2 * K], tot1[K];
  grid_total<2 * K>(part_r, tot2, sh2K, bc2K);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    tol[c] = P.tol_sq[c];
    rr[c] = (float)tot2[c];
    beta_sq[c] = (float)tot2[K + c];
    done[c] = rr[c] <= tol[c];
    itc[c] = 0;
  }
  int it = 0;

  for (;;) {
    bool all_done = true;
#pragma unroll
    for (int c = 0; c < K; ++c) all_done = all_done && done[c];
    if (!(!all_done && it < P.max_iters)) break;

    // cycle start: V_0 = z / |z| per column, z = M u (u holds the true residual)
    float inv_beta[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const float beta = sqrtf(beta_sq[c]);
      inv_beta[c] = beta > 0.f ? 1.f / beta : 1.f;
    }
    for (long long k = t0; k < n; k += stride) {
      const float mk = minv ? minv[k] : 1.f;
      float v0[K];
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const float uk = u[k * K + c];
        const float zk = minv ? mk * uk : uk;
        v0[c] = zk * inv_beta[c];
      }
      GkRowK<TV, K>::store(V, k, v0);
    }
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        for (int i = 0; i <= m; ++i) g[c][i] = 0.f;
        g[c][0] = sqrtf(beta_sq[c]);
        for (int i = 0; i < m; ++i) cs[c][i] = sn[c][i] = 0.f;
        for (int i = 0; i < m * (m + 1); ++i) Rm[c][i] = 0.f;
      }
    }
    grid.sync();

    bool act[K];
    bool any_act = false;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      act[c] = !done[c];
      any_act = any_act || act[c];
    }
    int j = 0;
    while (any_act && j < m) {
      // pass A: U = M A V_j; first dots <V_i, u>
      const TV* Vj = V + (long long)j * nK;
      for (long long tt = blockIdx.x; tt < ntiles; tt += G) {
        double ud[GK_GMRES_TILE_ROWS][K];
#pragma unroll
        for (int q = 0; q < GK_GMRES_TILE_ROWS; ++q) {
          const long long row = gk_tile_row<GK_GMRES_TILE_ROWS>(tt, q);
          float uk[K];
#pragma unroll
          for (int c = 0; c < K; ++c) uk[c] = 0.f;
          if (row < n) {
            gk_dia_row_rows<TD, TV, K>(D, P.offs, n, row, Vj, uk);
            const float mk = minv ? minv[row] : 1.f;
#pragma unroll
            for (int c = 0; c < K; ++c) uk[c] = minv ? mk * uk[c] : uk[c];
            GkRowK<float, K>::store(u, row, uk);
          }
#pragma unroll
          for (int c = 0; c < K; ++c) ud[q][c] = uk[c];
        }
        gk_tile_dots<TV, K, GK_GMRES_TILE_ROWS>(V, n, j, tt, ud, ws);
      }
      gk_block_dots<K>(wsum, ws_stride, j, part_b);
      grid.sync();
      sum_dots_cols<K>(part_b, P.hd, j, shK, bcK);
      grid.sync();
      if (threadIdx.x <= j) {
#pragma unroll
        for (int c = 0; c < K; ++c) h1[c][threadIdx.x] = (float)__ldcg(P.hd + threadIdx.x * K + c);
      }
      __syncthreads();

      // pass B: u -= h1_i V_i in i order; second dots
      for (long long tt = blockIdx.x; tt < ntiles; tt += G) {
        float uk[GK_GMRES_TILE_ROWS][K];
#pragma unroll
        for (int q = 0; q < GK_GMRES_TILE_ROWS; ++q) {
          const long long row = gk_tile_row<GK_GMRES_TILE_ROWS>(tt, q);
#pragma unroll
          for (int c = 0; c < K; ++c) uk[q][c] = 0.f;
          if (row < n) GkRowK<float, K>::load_cg(u, row, uk[q]);
        }
        gk_tile_subtract<TV, K, GK_GMRES_TILE_ROWS>(V, n, j, tt, h1, uk);
        double ud[GK_GMRES_TILE_ROWS][K];
#pragma unroll
        for (int q = 0; q < GK_GMRES_TILE_ROWS; ++q) {
          const long long row = gk_tile_row<GK_GMRES_TILE_ROWS>(tt, q);
          if (row < n) GkRowK<float, K>::store(u, row, uk[q]);
#pragma unroll
          for (int c = 0; c < K; ++c) ud[q][c] = uk[q][c];
        }
        gk_tile_dots<TV, K, GK_GMRES_TILE_ROWS>(V, n, j, tt, ud, ws);
      }
      gk_block_dots<K>(wsum, ws_stride, j, part_b);
      grid.sync();
      sum_dots_cols<K>(part_b, P.hd, j, shK, bcK);
      grid.sync();
      if (threadIdx.x <= j) {
#pragma unroll
        for (int c = 0; c < K; ++c) h2[c][threadIdx.x] = (float)__ldcg(P.hd + threadIdx.x * K + c);
      }
      __syncthreads();

      // pass C: u -= h2_i V_i in i order; partial u.u
      {
        double acc[K];
#pragma unroll
        for (int c = 0; c < K; ++c) acc[c] = 0.0;
        for (long long tt = blockIdx.x; tt < ntiles; tt += G) {
          float uk[GK_GMRES_TILE_ROWS][K];
#pragma unroll
          for (int q = 0; q < GK_GMRES_TILE_ROWS; ++q) {
            const long long row = gk_tile_row<GK_GMRES_TILE_ROWS>(tt, q);
#pragma unroll
            for (int c = 0; c < K; ++c) uk[q][c] = 0.f;
            if (row < n) GkRowK<float, K>::load_cg(u, row, uk[q]);
          }
          gk_tile_subtract<TV, K, GK_GMRES_TILE_ROWS>(V, n, j, tt, h2, uk);
#pragma unroll
          for (int q = 0; q < GK_GMRES_TILE_ROWS; ++q) {
            const long long row = gk_tile_row<GK_GMRES_TILE_ROWS>(tt, q);
            if (row < n) {
              GkRowK<float, K>::store(u, row, uk[q]);
#pragma unroll
              for (int c = 0; c < K; ++c) acc[c] += (double)uk[q][c] * uk[q][c];
            }
          }
        }
        block_partial<K>(acc, part_n, shK);
      }
      grid.sync();
      grid_total<K>(part_n, tot1, shK, bcK);
      float inv_h[K], hnext[K];
#pragma unroll
      for (int c = 0; c < K; ++c) {
        hnext[c] = sqrtf((float)tot1[c]);
        inv_h[c] = hnext[c] > 0.f ? 1.f / hnext[c] : 1.f;
      }

      // the Givens chain of every active column, by thread 0
      if (threadIdx.x == 0) {
#pragma unroll
        for (int c = 0; c < K; ++c) {
          if (!act[c]) {
            sm_act[c] = 0;
            continue;
          }
          float* h = h1[c];  // h = h1 + h2 in place, h[j + 1] = |u|
          for (int i = 0; i <= j; ++i) h[i] = h1[c][i] + h2[c][i];
          h[j + 1] = hnext[c];
          for (int i = 0; i < j; ++i) {
            const float hi = h[i], hi1 = h[i + 1];
            h[i] = cs[c][i] * hi + sn[c][i] * hi1;
            h[i + 1] = -sn[c][i] * hi + cs[c][i] * hi1;
          }
          const float a = h[j], bb = h[j + 1];
          const float denom = sqrtf(a * a + bb * bb);
          const float cc = denom > 0.f ? fabsf(a) / denom : 1.f;
          const float phase = fabsf(a) > 0.f ? (a > 0.f ? 1.f : -1.f) : 1.f;
          const float ss = denom > 0.f ? phase * bb / denom : 0.f;
          h[j] = cc * a + ss * bb;
          h[j + 1] = 0.f;
          const float gj = g[c][j];
          g[c][j + 1] = -ss * gj;
          g[c][j] = cc * gj;
          for (int i = 0; i <= m; ++i) Rm[c][j * (m + 1) + i] = i <= j ? h[i] : 0.f;
          cs[c][j] = cc;
          sn[c][j] = ss;
          const float res_sq = g[c][j + 1] * g[c][j + 1];
          sm_act[c] = (!(res_sq <= tol[c]) && it + 1 < P.max_iters) ? 1 : 0;
        }
      }
      __syncthreads();
      any_act = false;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        if (act[c]) itc[c] = it + 1;
        act[c] = sm_act[c] != 0;
        any_act = any_act || act[c];
      }

      // pass D: V_{j+1} = u / |u| in every column
      TV* Vn = V + (long long)(j + 1) * nK;
      for (long long tt = blockIdx.x; tt < ntiles; tt += G) {
#pragma unroll
        for (int q = 0; q < GK_GMRES_TILE_ROWS; ++q) {
          const long long row = gk_tile_row<GK_GMRES_TILE_ROWS>(tt, q);
          if (row < n) {
            float uk[K];
            GkRowK<float, K>::load_cg(u, row, uk);
#pragma unroll
            for (int c = 0; c < K; ++c) uk[c] = uk[c] * inv_h[c];
            GkRowK<TV, K>::store(Vn, row, uk);
          }
        }
      }
      ++it;
      ++j;
      grid.sync();
    }
    const int steps = j;

    // guarded back-substitution R y = g over the full m, by thread 0; a
    // column done at the cycle's start gets y = 0
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        for (int i = 0; i < m; ++i) y[c][i] = 0.f;
        if (done[c]) continue;
        for (int i = m - 1; i >= 0; --i) {
          float acc = 0.f;
          for (int k = i + 1; k < m; ++k) acc = acc + Rm[c][k * (m + 1) + i] * y[c][k];
          const float diag = Rm[c][i * (m + 1) + i];
          y[c][i] = diag != 0.f ? (g[c][i] - acc) / diag : 0.f;
        }
      }
    }
    __syncthreads();

    // x += y_i V_i in i order over the shared steps
    for (long long k = t0; k < n; k += stride) {
      float xk[K];
#pragma unroll
      for (int c = 0; c < K; ++c) xk[c] = x[k * K + c];
      for (int i = 0; i < steps; ++i) {
        float vi[K];
        GkRowK<TV, K>::load_cg(V + (long long)i * nK, k, vi);
#pragma unroll
        for (int c = 0; c < K; ++c) xk[c] = xk[c] + y[c][i] * vi[c];
      }
#pragma unroll
      for (int c = 0; c < K; ++c) x[k * K + c] = xk[c];
    }
    grid.sync();

    // the true residual U = B - A X per column; partial r.r and z.z
    {
      double acc[2 * K];
#pragma unroll
      for (int c = 0; c < 2 * K; ++c) acc[c] = 0.0;
      for (long long k = t0; k < n; k += stride) {
        float ax[K];
        gk_dia_row_rows<TD, float, K>(D, P.offs, n, k, x, ax);
        const float mk = minv ? minv[k] : 1.f;
#pragma unroll
        for (int c = 0; c < K; ++c) {
          const long long e = k * K + c;
          const float rk = P.b[e] - ax[c];
          u[e] = rk;
          const float zk = minv ? mk * rk : rk;
          acc[c] += (double)rk * rk;
          acc[K + c] += (double)zk * zk;
        }
      }
      block_partial<2 * K>(acc, part_r, sh2K);
    }
    grid.sync();
    grid_total<2 * K>(part_r, tot2, sh2K, bc2K);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const float rr_new = (float)tot2[c];
      if (!done[c]) rr[c] = rr_new;
      done[c] = done[c] || (rr_new <= tol[c]);
      beta_sq[c] = (float)tot2[K + c];
    }
  }

  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *P.it_out = it;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      P.rr_out[c] = rr[c];
      P.conv_out[c] = done[c] ? 1 : 0;
      P.itc_out[c] = itc[c];
    }
  }
}

// The library is built from three translation units at once
// (ginkgo_tpu_torch/_build.py PARTS): part 0 holds K15's entry points, part
// 1 K18's, part 2 K15m's, and each compiles the kernels it launches.
#ifndef GK_PART
#define GK_PART 0
#endif

#define GK_GMRES_DISPATCH(d_dtype, v_dtype, CALL)                                    \
  if (d_dtype == GK_F32 && v_dtype == GK_F32) return CALL(float, float);             \
  if (d_dtype == GK_F32 && v_dtype == GK_BF16) return CALL(float, __nv_bfloat16);    \
  if (d_dtype == GK_BF16 && v_dtype == GK_F32) return CALL(__nv_bfloat16, float);    \
  if (d_dtype == GK_BF16 && v_dtype == GK_BF16)                                      \
    return CALL(__nv_bfloat16, __nv_bfloat16);                                       \
  return (int)cudaErrorInvalidValue;

#if GK_PART <= 1
// K15's dynamic shared memory: the scalar state and the warps' running dot
// sums, 8 GK_CG_WARPS (m + 1) bytes (opted in above 48 KB).
static size_t gmres_smem(int m) {
  return sizeof(float) * (size_t)gmres_state_floats(m) +
         sizeof(double) * GK_CG_WARPS * (size_t)(m + 1);
}

// The operators K15 and K18 are instantiated on.
// Their gathers are plain loads: every write to the vector a pass gathers
// from (V_j, x) came before the last grid barrier, and the four rows of a
// thread read neighbouring elements, which L1 then holds (K18 ran 14%
// faster a step than with __ldcg, K15 the same; PERF.md section 6).
template <typename TD>
using GmresDiaOp = GkDiaOp<TD, false>;
template <typename TVal, typename TQ>
using GmresPellOp = GkPellOp<TVal, TQ, false>;

template <typename Op>
static GmresParams<Op> gmres_params(const Op& op, long long n, const float* b,
                                    const float* x0, const float* minv, const float* tol_sq,
                                    int max_iters, int m, void* V, float* x, float* u,
                                    double* part, double* hd, int* it_out, float* rr_out,
                                    int* conv_out) {
  GmresParams<Op> P;
  P.op = op;
  P.n = n;
  P.b = b;
  P.x0 = x0;
  P.minv = minv;
  P.tol_sq = tol_sq;
  P.max_iters = max_iters;
  P.m = m;
  P.x = x;
  P.u = u;
  P.V = V;
  P.part = part;
  P.hd = hd;
  P.it_out = it_out;
  P.rr_out = rr_out;
  P.conv_out = conv_out;
  return P;
}

// Blocks of K15's or K18's cooperative grid at Krylov dimension m; with
// `out`, its launch: {blocks, threads a block, blocks an SM, registers a
// thread, dynamic shared bytes a block, rows of 4 elements a thread takes
// of a tile}.
template <typename Op, typename TV>
static int gmres_grid_of(int m, int* blocks, int* out = nullptr) {
  const size_t smem = gmres_smem(m);
  GkOccupancy o;
  const int st = gk_occupancy(gmres_fused_kernel<Op, TV>, (long long)smem, GK_CG_THREADS, &o);
  if (st != 0) return st;
  if (o.per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (blocks) {
    const int e = gk_coop_blocks(gmres_fused_kernel<Op, TV>, blocks, smem);
    if (e != 0) return e;
  }
  if (out) {
    const int v[6] = {o.per_sm * o.sms, GK_CG_THREADS, o.per_sm, o.regs, (int)smem,
                      GK_GMRES1_TILE_ROWS};
    for (int i = 0; i < 6; ++i) out[i] = v[i];
  }
  return 0;
}

template <typename Op, typename TV>
static int gmres_launch_of(const GmresParams<Op>& P, int blocks, void* stream) {
  const size_t smem = gmres_smem(P.m);
  const int st = gk_smem_optin(gmres_fused_kernel<Op, TV>, (long long)smem);
  if (st != 0) return st;
  return gk_coop_launch(gmres_fused_kernel<Op, TV>, P, blocks, stream, smem);
}

#endif  // GK_PART <= 1

#if GK_PART == 0
// Blocks of the cooperative grid for the diagonals' and the basis' dtypes
// and the Krylov dimension m (which sizes the shared memory).
extern "C" int gmres_fused_grid(int d_dtype, int v_dtype, int m, int* blocks) {
  if (m < 1 || m > GK_GMRES_MAX_M) return (int)cudaErrorInvalidValue;
#define GK_GRID(TD, TV) gmres_grid_of<GmresDiaOp<TD>, TV>(m, blocks)
  GK_GMRES_DISPATCH(d_dtype, v_dtype, GK_GRID)
#undef GK_GRID
}

// K15's launch (gmres_grid_of's six values).
extern "C" int gmres_fused_config(int d_dtype, int v_dtype, int m, int* out) {
  if (m < 1 || m > GK_GMRES_MAX_M) return (int)cudaErrorInvalidValue;
#define GK_CONFIG(TD, TV) gmres_grid_of<GmresDiaOp<TD>, TV>(m, nullptr, out)
  GK_GMRES_DISPATCH(d_dtype, v_dtype, GK_CONFIG)
#undef GK_CONFIG
}

extern "C" int gmres_fused_solve(
    const void* diags, int d_dtype, const long long* offsets, int nd, long long n,
    const float* b, const float* x0, const float* minv, const float* tol_sq,
    int max_iters, int m, void* V, int v_dtype, float* x, float* u, double* part,
    double* hd, int blocks, int* it_out, float* rr_out, int* conv_out, void* stream) {
  if (nd < 1 || nd > GK_MAX_DIAGS || blocks < 1 || m < 1 || m > GK_GMRES_MAX_M)
    return (int)cudaErrorInvalidValue;
#define GK_LAUNCH(TD, TV)                                                                  \
  gmres_launch_of<GmresDiaOp<TD>, TV>(                                                     \
      gmres_params(gk_dia_op<TD, false>(diags, offsets, nd, n), n, b, x0,                 \
                   minv, tol_sq, max_iters, m, V, x, u, part, hd, it_out, rr_out,          \
                   conv_out),                                                              \
      blocks, stream)
  GK_GMRES_DISPATCH(d_dtype, v_dtype, GK_LAUNCH)
#undef GK_LAUNCH
}

#endif  // GK_PART == 0

#if GK_PART == 1
template <typename TVal, typename TQ>
static int pell_gmres_grid(int v_dtype, int m, int* blocks, int* out) {
  if (v_dtype == GK_F32) return gmres_grid_of<GmresPellOp<TVal, TQ>, float>(m, blocks, out);
  if (v_dtype == GK_BF16)
    return gmres_grid_of<GmresPellOp<TVal, TQ>, __nv_bfloat16>(m, blocks, out);
  return (int)cudaErrorInvalidValue;
}

// K18: blocks of the Pell form's cooperative grid for the values', lane
// indices' and basis' dtypes and the Krylov dimension m.
extern "C" int pell_gmres_fused_grid(int val_dtype, int q_dtype, int v_dtype, int m,
                                     int* blocks) {
  if (m < 1 || m > GK_GMRES_MAX_M) return (int)cudaErrorInvalidValue;
  GK_PELL_VQ_DISPATCH(val_dtype, q_dtype, (pell_gmres_grid<TV, TQ>)(v_dtype, m, blocks, nullptr));
}

// K18's launch (gmres_grid_of's six values).
extern "C" int pell_gmres_fused_config(int val_dtype, int q_dtype, int v_dtype, int m,
                                       int* out) {
  if (m < 1 || m > GK_GMRES_MAX_M) return (int)cudaErrorInvalidValue;
  GK_PELL_VQ_DISPATCH(val_dtype, q_dtype, (pell_gmres_grid<TV, TQ>)(v_dtype, m, nullptr, out));
}

template <typename TVal, typename TQ>
static int pell_gmres_launch(const void* values, const void* qidx, const int* bases,
                             const int* tile_ptr, int S, int G, long long n, const float* b,
                             const float* x0, const float* minv, const float* tol_sq,
                             int max_iters, int m, void* V, int v_dtype, float* x, float* u,
                             double* part, double* hd, int blocks, int* it_out,
                             float* rr_out, int* conv_out, void* stream) {
  const GmresParams<GmresPellOp<TVal, TQ>> P = gmres_params(
      gk_pell_op<TVal, TQ, false>(values, qidx, bases, tile_ptr, S, G, n, nullptr),
      n, b, x0, minv, tol_sq, max_iters, m, V, x, u, part, hd, it_out, rr_out, conv_out);
  if (v_dtype == GK_F32)
    return gmres_launch_of<GmresPellOp<TVal, TQ>, float>(P, blocks, stream);
  if (v_dtype == GK_BF16)
    return gmres_launch_of<GmresPellOp<TVal, TQ>, __nv_bfloat16>(P, blocks, stream);
  return (int)cudaErrorInvalidValue;
}

// K18: restarted GMRES(m) on a square Pell (values float32/bfloat16, lane
// indices int8/int32), left-preconditioned by minv (nullptr: Identity),
// with a float32 or bfloat16 basis.
extern "C" int pell_gmres_fused_solve(
    const void* values, int val_dtype, const void* qidx, int q_dtype, const int* bases,
    const int* tile_ptr, int S, int G, long long n, const float* b, const float* x0,
    const float* minv, const float* tol_sq, int max_iters, int m, void* V, int v_dtype,
    float* x, float* u, double* part, double* hd, int blocks, int* it_out, float* rr_out,
    int* conv_out, void* stream) {
  if (S < 1 || G < 1 || blocks < 1 || m < 1 || m > GK_GMRES_MAX_M)
    return (int)cudaErrorInvalidValue;
  GK_PELL_VQ_DISPATCH(val_dtype, q_dtype,
                      (pell_gmres_launch<TV, TQ>)(values, qidx, bases, tile_ptr, S, G, n, b,
                                                  x0, minv, tol_sq, max_iters, m, V, v_dtype,
                                                  x, u, part, hd, blocks, it_out, rr_out,
                                                  conv_out, stream));
}

#endif  // GK_PART == 1

#if GK_PART == 2
#define GK_GMRES_SWITCH_K(k, CALL_K)             \
  switch (k) {                                   \
    case 2: return CALL_K(2);                    \
    case 3: return CALL_K(3);                    \
    case 4: return CALL_K(4);                    \
    default: return (int)cudaErrorInvalidValue;  \
  }

// K15m's dynamic shared memory: the per-column scalar state and the warps'
// running dot sums, 8 GK_CG_WARPS (m + 1) k bytes (opted in above 48 KB).
static size_t gmres_multi_smem(int k, int m) {
  return sizeof(float) * (size_t)gmres_multi_state_floats(k, m) +
         sizeof(double) * GK_CG_WARPS * (size_t)(m + 1) * k;
}

template <int K>
static int multi_grid(int d_dtype, int v_dtype, size_t smem, int* blocks) {
#define GK_GRID(TD, TV)                                                           \
  (gk_smem_optin(gmres_fused_multi_kernel<TD, TV, K>, (long long)smem) != 0        \
       ? (int)cudaErrorInvalidValue                                               \
       : gk_coop_blocks(gmres_fused_multi_kernel<TD, TV, K>, blocks, smem))
  GK_GMRES_DISPATCH(d_dtype, v_dtype, GK_GRID)
#undef GK_GRID
}

template <int K>
static int multi_launch(int d_dtype, int v_dtype, const GmresMultiParams& P, size_t smem,
                        int blocks, void* stream) {
#define GK_LAUNCH(TD, TV)                                                          \
  (gk_smem_optin(gmres_fused_multi_kernel<TD, TV, K>, (long long)smem) != 0         \
       ? (int)cudaErrorInvalidValue                                                \
       : gk_coop_launch(gmres_fused_multi_kernel<TD, TV, K>, P, blocks, stream, smem))
  GK_GMRES_DISPATCH(d_dtype, v_dtype, GK_LAUNCH)
#undef GK_LAUNCH
}

// Blocks of K15m's cooperative grid for the dtypes, k columns and the
// Krylov dimension m (which size the shared memory, gmres_multi_smem).
extern "C" int gmres_fused_multi_grid(int d_dtype, int v_dtype, int k, int m, int* blocks) {
  if (m < 1 || m > GK_GMRES_MULTI_MAX_M) return (int)cudaErrorInvalidValue;
  const size_t smem = gmres_multi_smem(k, m);
#define GK_GRID_K(K) multi_grid<K>(d_dtype, v_dtype, smem, blocks)
  GK_GMRES_SWITCH_K(k, GK_GRID_K)
#undef GK_GRID_K
}

extern "C" int gmres_fused_multi_solve(
    const void* diags, int d_dtype, const long long* offsets, int nd, long long n, int k,
    const float* b, const float* x0, const float* minv, const float* tol_sq,
    int max_iters, int m, void* V, int v_dtype, float* x, float* u, double* part,
    double* hd, int blocks, int* it_out, float* rr_out, int* conv_out, int* itc_out,
    void* stream) {
  if (nd < 1 || nd > GK_MAX_DIAGS || blocks < 1 || m < 1 || m > GK_GMRES_MULTI_MAX_M)
    return (int)cudaErrorInvalidValue;
  GmresMultiParams P;
  P.diags = diags;
  P.offs.nd = nd;
  for (int d = 0; d < nd; ++d) P.offs.off[d] = offsets[d];
  P.n = n;
  P.b = b;
  P.x0 = x0;
  P.minv = minv;
  P.tol_sq = tol_sq;
  P.max_iters = max_iters;
  P.m = m;
  P.x = x;
  P.u = u;
  P.V = V;
  P.part = part;
  P.hd = hd;
  P.it_out = it_out;
  P.rr_out = rr_out;
  P.conv_out = conv_out;
  P.itc_out = itc_out;
  const size_t smem = gmres_multi_smem(k, m);
#define GK_LAUNCH_K(K) multi_launch<K>(d_dtype, v_dtype, P, smem, blocks, stream)
  GK_GMRES_SWITCH_K(k, GK_LAUNCH_K)
#undef GK_LAUNCH_K
}
#endif  // GK_PART == 2
