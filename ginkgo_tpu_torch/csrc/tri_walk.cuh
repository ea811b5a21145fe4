// The pipelined sweep solve of K22 (trs_fused) and K23 (cg_ilu_fused):
// every sweep of a triangular solve in one walk over a block's rows, the
// iterates in shared memory.
//
// The solve is coop.cuh's and trs_fused.cu's gk_tri_sweeps: level 0 is
// x0 = invd * rhs, level s is x_s = invd * (rhs - N x_{s-1}), s = 1 ..
// sweeps, N the strict triangle as a Dia.  gk_tri_sweeps runs each level as
// a pass over all n rows behind a grid barrier, and each pass reads the
// diagonals, rhs, invd and the previous iterate from device memory again.
//
// Why one walk is enough.  The triangle is strict, so its offsets are all of
// one sign: all negative for L, all positive for U.  In L, row i of level s
// reads level s-1 at rows i + off < i only; so a walk over the rows in
// increasing order can form every level, each one chunk behind the one
// before it.  A block owns the rows [a, a+len) and starts its walk sweeps *
// w rows before a (w = max |offset|): level s is exact from (sweeps - s) w
// rows before a on, and only the last level, on the block's own rows,
// leaves the walk.  The halo rows are recomputed by every block that needs
// them, so the blocks never wait for one another: no grid barrier.  U is
// the same walk in decreasing row order.  Every value is formed from the
// operands gk_tri_sweeps uses, in its order (gk_dia_row's: from +0.0, the
// diagonals in offset order, a column outside [0, n) skipped), so the
// result keeps its bits.
//
// The walk.  Position p = 0, 1, ... counts the walk's rows from its start
// (row row0 + p forward, row0 - p backward).  Step t takes chunk t (rows
// [tC, tC + C) of p) for level 0, chunk t - 1 for level 1, ..., chunk t - s
// for level s: level s of chunk c reads level s-1 of chunks c - ceil(w/C)
// to c, all formed in earlier steps, so one block barrier a step orders
// them.  Levels 0 .. sweeps-1 live in rings of `ring_rows` rows of shared
// memory, a power of two >= w + 2C, indexed by p mod ring_rows: the rows a
// step reads (w + C of them) and the chunk it writes never meet.  The last
// level goes to device memory on the block's own rows.
//
// What bounds it on the H100: bytes.  The walk reads the triangle's
// diagonals, rhs (K23: r and q) and invd once for each of its rows, the
// halo included, and writes one float a row; gk_tri_sweeps reads and writes
// (sweeps + 1) times as much.  The rows of a chunk stream into a ring of
// `stages` = sweeps + 1 + GK_WALK_PREFETCH chunks by cp.async, the chunks
// of GK_WALK_PREFETCH steps ahead in flight while a step computes; a chunk
// stays until the last level has read it.  Vectors, which other blocks may
// have rewritten since the last grid barrier (K23), and invd are copied 16
// bytes at a time past L1 (.cg), so every chunk starts at a row that is a
// multiple of 4; the diagonals, constant during a launch, 4 bytes at a time
// (a row of another diagonal may start mid-word).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "async.cuh"
#include "coop.cuh"

// Chunks the input ring keeps in flight ahead of the step that reads them.
#define GK_WALK_PREFETCH 2
// The rows of a step.  A block of THREADS threads (a template parameter of
// the walk: K22 512, K23 1024) takes GK_WALK_CHUNK / THREADS rows of every
// level a step, unrolled, so that their chains of shared-memory loads
// overlap.  A longer step halves the steps and their block barriers, a
// shorter one doubles the halo-to-range ratio: on the H100 a chunk of 1024
// rows in one block an SM beat 512 rows in two (PERF.md section 6).
#define GK_WALK_CHUNK 1024
// The interior steps (below) run every level and diagonal unrolled in
// kernels compiled for each shape of 1 .. GK_WALK_MAX_ND diagonals and
// 1 .. GK_WALK_MAX_SWEEPS sweeps; other shapes run the same walk with
// runtime counts.
#define GK_WALK_MAX_ND 4
#define GK_WALK_MAX_SWEEPS 4

// One walk's shape (gk_walk_plan).
struct GkWalkCfg {
  int ring_rows;  // rows of a level ring: a power of two >= w + 2C (0: sweeps == 0)
  int stages;     // chunks of the input ring: sweeps + 1 + GK_WALK_PREFETCH
  int sweeps;
  int dir;        // +1: every offset < 0, an increasing walk; -1: every offset > 0
  int width;      // w = max |offset|
};

// The walk of a `sweeps`-sweep solve over the strict triangle (offsets, nd)
// on n rows, into *W: false where the offsets are not all of one sign, or
// where the walk's positions would not fit an int.
static bool gk_walk_plan(const long long* offsets, int nd, long long n, int sweeps,
                         GkWalkCfg* W) {
  if (nd < 1 || sweeps < 0) return false;
  const bool lower = offsets[0] < 0;
  long long w = 0;
  for (int d = 0; d < nd; ++d) {
    if (offsets[d] == 0 || (offsets[d] < 0) != lower) return false;
    const long long m = offsets[d] < 0 ? -offsets[d] : offsets[d];
    w = m > w ? m : w;
  }
  if (n + (long long)sweeps * w + 2LL * GK_WALK_CHUNK >= (1LL << 30)) return false;
  // the rows a step reads (w + C) and the chunk it writes never share a
  // place in the ring
  long long ring = 0;
  if (sweeps > 0)
    for (ring = 1; ring < w + 2LL * GK_WALK_CHUNK;) ring <<= 1;
  W->ring_rows = (int)ring;
  W->stages = sweeps + 1 + GK_WALK_PREFETCH;
  W->sweeps = sweeps;
  W->dir = lower ? 1 : -1;
  W->width = (int)w;
  return true;
}

// True where a kernel compiled for nd diagonals and `sweeps` sweeps exists.
__host__ __device__ inline bool gk_walk_unrolled(int nd, int sweeps) {
  return nd >= 1 && nd <= GK_WALK_MAX_ND && sweeps >= 1 && sweeps <= GK_WALK_MAX_SWEEPS;
}

// Bytes of one diagonal's chunk in the ring: C values and the 4-byte word a
// bfloat16 chunk that starts mid-word needs, rounded up to 16.
__host__ __device__ inline int gk_walk_diag_bytes(int chunk, int esz) {
  return (chunk * esz + 4 + 15) & ~15;
}

// Dynamic shared memory of a walk over nd diagonals of esz bytes, staging nv
// vectors and invd: the level rings, then the input ring.
__host__ __device__ inline long long gk_walk_smem(const GkWalkCfg& W, int nd, int esz, int nv) {
  const long long slot = (long long)nd * gk_walk_diag_bytes(GK_WALK_CHUNK, esz) +
                         (long long)(nv + 1) * GK_WALK_CHUNK * 4;
  return (long long)W.sweeps * W.ring_rows * 4 + (long long)W.stages * slot;
}

// A block's walk over its rows [a, a+len): H halo rows, then its own; row0
// is position 0's row, pbeg the first position on a row < n (a backward
// walk starts on a multiple of 4, which may lie past the last row), total
// = H + len positions in nc chunks.
struct GkWalkSpan {
  int H, row0, pbeg, total, nc;
};

__host__ __device__ inline GkWalkSpan gk_walk_span(int dir, int S, int w, int n, int a, int len) {
  GkWalkSpan s;
  if (dir > 0) {
    const int s0 = (a - S * w > 0 ? a - S * w : 0) & ~3;
    s.H = a - s0;
    s.row0 = s0;
    s.pbeg = 0;
  } else {
    const int top = a + len + S * w;
    const int e0 = ((top < n ? top : n) + 3) & ~3;
    s.H = e0 - (a + len);
    s.row0 = e0 - 1;
    s.pbeg = e0 - n;
  }
  s.total = s.H + len;
  s.nc = (s.total + GK_WALK_CHUNK - 1) / GK_WALK_CHUNK;
  return s;
}

// Step t of the walk s is an interior step: every level's chunk lies wholly
// in the walk and reads no column outside it, and the last level's rows are
// all own.
__host__ __device__ inline bool gk_walk_interior(const GkWalkSpan& s, int t, int S, int w) {
  constexpr int C = GK_WALK_CHUNK;
  return t >= S && (t + 1) * C <= s.total && (t - S) * C - w >= s.pbeg && (t - S) * C >= s.H;
}

// The interior steps of every block of the walk W over n rows in `blocks`
// ranges (block b owns [b T, b T + T), T = ceil(n / blocks), as the kernels
// cut them).
static long long gk_walk_interior_steps(const GkWalkCfg& W, long long n, int blocks) {
  const int T = (int)((n + blocks - 1) / blocks);
  long long steps = 0;
  for (int a = 0; a < n; a += T) {
    const int len = n - a < T ? (int)n - a : T;
    const GkWalkSpan s = gk_walk_span(W.dir, W.sweeps, W.width, (int)n, a, len);
    for (int t = W.sweeps; (t + 1) * GK_WALK_CHUNK <= s.total; ++t)
      steps += gk_walk_interior(s, t, W.sweeps, W.width);
  }
  return steps;
}

// The last level of the walk over the triangle T, x = T-solve of rhs with
// W.sweeps sweeps, on the block's rows [a, a+len) (len >= 1), in the
// direction DIR (== W.dir) over ND diagonals (0: T.offs.nd).  Call with the
// whole block of THREADS threads.  rhs(v, C, e) forms the
// right-hand side of the chunk's row e from the NV staged vectors (vector m
// at v + m C); own0(row, rhs) sees the right-hand side of each own row once;
// fin(row, x) takes the last level of each own row.  SW > 0 (with ND > 0,
// gk_walk_unrolled): compiled for W.sweeps == SW, so that an interior step
// runs its levels unrolled.  The staged vectors and invd are 16-byte aligned, the
// diagonals 4-byte; other blocks may rewrite nothing the walk reads.  On
// return every copy has landed and every thread has left the walk's shared
// memory.
template <int THREADS, typename TT, int DIR, int ND, int SW, int NV, typename Rhs,
          typename Own0, typename Fin>
__device__ __forceinline__ void gk_tri_walk(const GkDiaOp<TT>& T, const GkWalkCfg& W,
                                            const float* const (&vec)[NV], const float* invd,
                                            int a, int len, char* smem, Rhs rhs, Own0 own0,
                                            Fin fin) {
  const int n = (int)T.n;
  const int nd = ND > 0 ? ND : T.offs.nd;
  constexpr int C = GK_WALK_CHUNK;
  constexpr int RPT = C / THREADS;
  static_assert(C % THREADS == 0, "a step's rows spread evenly over the block");
  const int S = SW > 0 ? SW : W.sweeps;
  const int w = W.width;
  const int tid = threadIdx.x;
  const GkWalkSpan sp = gk_walk_span(DIR, S, w, n, a, len);
  const int H = sp.H, row0 = sp.row0, pbeg = sp.pbeg, total = sp.total, nc = sp.nc;
  const int dbytes = gk_walk_diag_bytes(C, (int)sizeof(TT));
  const int slot = nd * dbytes + (NV + 1) * C * 4;
  const int mask = W.ring_rows - 1;
  float* lev = reinterpret_cast<float*>(smem);
  char* ring = smem + (size_t)S * W.ring_rows * 4;
  // |offset| of each diagonal, and where a diagonal's chunk starts in its
  // staged words: a bfloat16 chunk may start at a word's second half (the
  // same for every chunk: chunks start on even rows)
  int aoff[ND > 0 ? ND : 1], dsh[ND > 0 ? ND : 1];
#pragma unroll
  for (int d = 0; d < (ND > 0 ? ND : 1); ++d) {
    aoff[d] = (int)(DIR > 0 ? -T.offs.off[d] : T.offs.off[d]);
    dsh[d] = sizeof(TT) == 4 ? 0 : (d & n & 1) * 2;
  }
  // the first row of chunk c's span of rows, a multiple of 4
  auto span = [&](int c) { return DIR > 0 ? row0 + c * C : row0 + 1 - (c + 1) * C; };

  auto issue = [&](int c) {
    char* dst = ring + (c % W.stages) * slot;
    const long long rf = span(c);
    const long long lo = (long long)(uintptr_t)T.diags;
    const long long hi = lo + (long long)nd * n * (long long)sizeof(TT);
    const int words = C * (int)sizeof(TT) / 4 + (sizeof(TT) < 4 ? 1 : 0);
    for (int d = 0; d < nd; ++d) {
      const long long g0 = (lo + ((long long)d * n + rf) * (long long)sizeof(TT)) & ~3LL;
      for (int u = tid; u < words; u += THREADS) {
        const long long g = g0 + 4LL * u;
        const int nb = (g >= lo && g < hi) ? (int)(hi - g < 4 ? hi - g : 4) : 0;
        gk_cp4_n(dst + d * dbytes + 4 * u, nb ? (const void*)(uintptr_t)g : (const void*)T.diags,
                 nb);
      }
    }
#pragma unroll
    for (int m = 0; m <= NV; ++m) {
      const float* src = m < NV ? vec[m] : invd;
      char* vd = dst + nd * dbytes + m * C * 4;
      for (int u = tid; u < C / 4; u += THREADS) {
        const int r = (int)rf + 4 * u;
        const int nb = (r >= 0 && r < n) ? (n - r < 4 ? n - r : 4) * 4 : 0;
        gk_cp16_n(vd + 16 * u, nb ? src + r : src, nb);
      }
    }
  };

  // Level k (>= 1) of chunk c, read from stage st.  FULL: every row of the
  // chunk and every column it reads lies in the walk (no check a row).
  auto level = [&](auto full, int k, int c, const char* st) {
    constexpr bool FULL = decltype(full)::value;
    const float* vb = reinterpret_cast<const float*>(st + nd * dbytes);
    const float* inv = vb + NV * C;
    const float* src = lev + (k - 1) * W.ring_rows;
    float* dst = k < S ? lev + k * W.ring_rows : nullptr;
    const int p0 = c * C;
    // every row's value first, then the stores: the loads of the RPT rows
    // may overlap
    float v[RPT];
#pragma unroll
    for (int u = 0; u < RPT; ++u) {
      const int e = tid + u * THREADS;
      const int p = p0 + e;
      if (!FULL && (p >= total || p < pbeg)) continue;
      const int ep = DIR > 0 ? e : C - 1 - e;  // the row's place in the staged span
      const float b = rhs(vb, C, ep);
      float acc = 0.f;
      for (int d = 0; d < nd; ++d) {  // unrolled where ND is given
        const int ad = ND > 0 ? aoff[d] : (int)(DIR > 0 ? -T.offs.off[d] : T.offs.off[d]);
        const int sh = ND > 0 ? dsh[d] : (sizeof(TT) == 4 ? 0 : (d & n & 1) * 2);
        const int pj = p - ad;
        if (FULL || pj >= pbeg) {
          const TT* dg = reinterpret_cast<const TT*>(st + d * dbytes + sh);
          acc += gk_to_float(dg[ep]) * src[pj & mask];
        }
      }
      v[u] = (b - acc) * inv[ep];
    }
#pragma unroll
    for (int u = 0; u < RPT; ++u) {
      const int p = p0 + tid + u * THREADS;
      if (!FULL && (p >= total || p < pbeg)) continue;
      if (dst)
        dst[p & mask] = v[u];
      else if (p >= H)
        fin(DIR > 0 ? row0 + p : row0 - p, v[u]);
    }
  };

  for (int c = 0; c < GK_WALK_PREFETCH; ++c) {
    if (c < nc) issue(c);
    gk_cp_commit();
  }
  for (int t = 0; t < nc + S; ++t) {
    // chunk t has landed, and every level of step t - 1 is in the rings
    gk_cp_wait<GK_WALK_PREFETCH - 1>();
    __syncthreads();
    // into the stage of chunk t + PREFETCH - stages <= t - S - 1, which no
    // level reads from this step on
    if (t + GK_WALK_PREFETCH < nc) issue(t + GK_WALK_PREFETCH);
    gk_cp_commit();
    // the stage of chunk t - k
    const int st0 = t % W.stages;
    auto stage = [&](int k) -> const char* {
      const int st = st0 - k;
      return ring + (st < 0 ? st + W.stages : st) * slot;
    };
    if constexpr (SW > 0) {
      if (gk_walk_interior(sp, t, S, w)) {
        // An interior step: levels 0 .. SW unrolled, every value before any
        // store, so that the (SW + 1) RPT chains of loads overlap.
        float v[SW + 1][RPT], b0[RPT];
#pragma unroll
        for (int k = 0; k <= SW; ++k) {
          const char* st = stage(k);
          const float* vb = reinterpret_cast<const float*>(st + nd * dbytes);
          const float* inv = vb + NV * C;
          const float* src = lev + (k > 0 ? k - 1 : 0) * W.ring_rows;
#pragma unroll
          for (int u = 0; u < RPT; ++u) {
            const int e = tid + u * THREADS;
            const int p = (t - k) * C + e;
            const int ep = DIR > 0 ? e : C - 1 - e;
            const float b = rhs(vb, C, ep);
            if (k == 0) {
              b0[u] = b;
              v[0][u] = b * inv[ep];
            } else {
              float acc = 0.f;
#pragma unroll
              for (int d = 0; d < nd; ++d) {
                const TT* dg = reinterpret_cast<const TT*>(st + d * dbytes + dsh[d]);
                acc += gk_to_float(dg[ep]) * src[(p - aoff[d]) & mask];
              }
              v[k][u] = (b - acc) * inv[ep];
            }
          }
        }
#pragma unroll
        for (int k = 0; k <= SW; ++k) {
#pragma unroll
          for (int u = 0; u < RPT; ++u) {
            const int p = (t - k) * C + tid + u * THREADS;
            const int row = DIR > 0 ? row0 + p : row0 - p;
            if (k == 0) own0(row, b0[u]);
            if (k < SW)
              lev[k * W.ring_rows + (p & mask)] = v[k][u];
            else
              fin(row, v[k][u]);
          }
        }
        continue;
      }
    }
    // level 0 of chunk t
    if (t < nc && (long long)(t + 1) * C > H - (long long)S * w) {
      const char* st = stage(0);
      const float* vb = reinterpret_cast<const float*>(st + nd * dbytes);
      const float* inv = vb + NV * C;
#pragma unroll
      for (int u = 0; u < RPT; ++u) {
        const int e = tid + u * THREADS;
        const int p = t * C + e;
        if (p >= total || p < pbeg) continue;
        const int ep = DIR > 0 ? e : C - 1 - e;
        const float b = rhs(vb, C, ep);
        const float v = b * inv[ep];
        const bool own = p >= H;
        const int row = DIR > 0 ? row0 + p : row0 - p;
        if (own) own0(row, b);
        if (S > 0)
          lev[p & mask] = v;
        else if (own)
          fin(row, v);
      }
    }
    // levels 1 .. S of chunks t - 1 .. t - S; level k is exact from
    // position H - (S - k) w on, and earlier chunks of it reach no own row
    for (int k = 1; k <= S; ++k) {
      const int c = t - k;
      if (c < 0 || c >= nc || (long long)(c + 1) * C <= H - (long long)(S - k) * w) continue;
      if (c * C - w >= pbeg && (c + 1) * C <= total)
        level(std::true_type{}, k, c, stage(k));
      else
        level(std::false_type{}, k, c, stage(k));
    }
  }
  gk_cp_wait<0>();
  __syncthreads();
}
