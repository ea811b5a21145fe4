// Whole-solve IR / Richardson (damped Jacobi) in one persistent cooperative
// kernel: kernel K17 of the PyTorch port, with two entry points over one set
// of passes; and K21, the same sweeps on a Pell, in a kernel of its own.
//
// Replaces ginkgo_tpu/ops/pallas_ir.py, one TPU site (_common_call, :211)
// for two kernels that share _make_passes (:63-88):
//   - ir_fused_solve (_ir_kernel, :150-204): sweeps to the stop test;
//   - ir_smooth (_smooth_kernel, :91-147): a fixed number of sweeps, as
//     multigrid's fixed smoother runs them; with x0 = nullptr it starts
//     from zero with r = b and skips the first product; without
//     with_residual it runs iters - 1 full sweeps and one last update, so
//     r is left from before that update.
//
// What bounds it on the H100: bytes.  A sweep reads the diagonals, x_j, b
// (and minv) and writes x_{j+1}: (nd sizeof(TD) + 12) n bytes, 16 n with
// an inverse diagonal; r is used at once on the rows that form it and is
// not stored in a sweep.
//
// What the design does about it: K21's schedule (below) on the Dia, one
// pass and one grid barrier a sweep.  The grid is what the SMs hold at
// once, launched cooperatively; each row belongs to one thread in every
// pass (grid-stride; a thread takes GK_IR_ROWS rows a trip and issues
// their loads together, coop.cuh GkStrideRows).  Pass j reads x_j
// across rows with plain loads (every block wrote it before the last grid
// barrier, and grid.sync() invalidates L1) and, on its own rows, forms
// r_j = b - A x_j as gk_dia_row sums a row, writes x_{j+1} = x_j + omega
// M r_j into the other of two x buffers and adds r_j.r_j to a float64
// partial.  The solve then folds the partials (coop.cuh: every block in
// one fixed order, so every block takes the same branch); with one barrier
// a sweep a fast block writes sweep j + 1's partials while a slow one may
// still fold sweep j's, so they alternate between two halves of the
// buffer.  On exit the result is the x the last pass read (its r.r with
// it), and that pass's x_{j+1} is discarded: each thread copies its rows
// of the result into the output buffer where it is not there, and forms r
// = b - A x there once, as the sweeps formed it.  The smoother sums
// nothing and takes the same pass with no fold: its barrier orders the
// pass that reads x_{j+1} across rows after the one that wrote it (and
// the pass after, which writes x_j's buffer, after the reads of x_j).  It
// stores r only on its last pass (iters - 1 sweeps and one last update:
// r_{iters-1}), or with with_residual forms r = b - A x_iters in one more
// pass with no update.  r is recomputed from b every sweep, never updated
// (ROADMAP, "IR sweep order").
//
// Semantics kept from _ir_kernel: the monitor starts at +inf, so the first
// sweep always runs; the loop runs while it < max_iters && !(rr <= tol_sq),
// rr the post-sweep r.r (a NaN keeps sweeping); the reported rr is the last
// sweep's, or r0's when max_iters = 0.
//
// K21 (pell_ir_fused_solve, pell_ir_fused_kernel) replaces
// ginkgo_tpu/ops/pallas_pell_cg.py pell_ir_vmem_solve (_pell_ir_kernel,
// :794).  That TPU kernel's monitor starts at the r.r of r0 = b - A x0, not
// at +inf, so a solve whose r0 already meets the threshold runs no sweep;
// every other rule is K17's.  Bound: the plan once (values, lane indices,
// bases), x gathered once, b and minv in and x_{j+1} out: plan + 12 n bytes
// a sweep, 16 n with Jacobi.  r is not stored in the sweep: r_j is used at
// once on the rows that form it.
// Design: one pass and one grid barrier a sweep, at K7's footing
// (pell.cuh GkPellChunks: chunks of 4 rows a thread, 32-bit rows, the
// tile's slots read once a chunk, plain gathers).  Pass j reads x_j across
// rows and, on its own rows, forms r_j = b - A x_j, writes x_{j+1} = x_j +
// omega M r_j into the other of two x buffers and adds r_j.r_j to its
// partial; then the reduction barrier and the stop test.  With one barrier
// a sweep a fast block writes sweep j + 1's partials while a slow one may
// still sum sweep j's, so the partials alternate between two halves of the
// buffer.  The first pass reads x0 itself; on exit the result is the x the
// last pass read (its r.r with it), and that pass's x_{j+1} is discarded.
// After the last barrier each thread copies its own rows of the result
// into the output buffer where it is not there, and, where the caller asks
// for r, forms r = b - A x there once as the sweeps formed it.  The
// float64 r.r sums in K7's chunk order (pell_cg_fused.cu).

#include "coop.cuh"
#include "pell.cuh"

namespace cg = cooperative_groups;

// Rows a thread takes a trip in K17's passes (GkStrideRows), and the blocks
// an SM its registers must leave room for.  On the H100 4 rows at 5 blocks
// an SM (48 registers) beat 1 row at 8 blocks (32 registers), 2 rows at 6,
// 4, 6 and 8 rows at 4, and 8 rows at 2 (PERF.md section 6).
#define GK_IR_ROWS 4
#define GK_IR_MIN_BLOCKS 5

template <typename TD>
struct IrParams {
  GkDiaOp<TD, false> op;  // plain gathers: every source was written before the last barrier
  long long n;
  const float* b;
  const float* x0;      // ir_smooth: nullptr starts from zero
  const float* minv;    // nullptr: Identity
  const float* tol_sq;  // ir_fused_solve: device scalar
  float omega;
  int iters;  // ir_fused_solve: max_iters; ir_smooth: the sweep count
  int with_residual;
  float* x;   // the result; x_j for odd j in the solve
  float* xb;  // the other x buffer
  float* r;
  double* part;  // ir_fused_solve: 2 * gridDim.x per-block partial sums, used in turn
  int* it_out;
  float* rr_out;
  int* conv_out;
};

// One pass over this thread's rows: r_j = b - A x_j from src = x_j, read
// across rows (ZERO: x_j = 0, so r_j = b and no product); with UPDATE
// dst = x_{j+1} = x_j + omega M r_j, with STORE_R r_j into P.r; returns
// this thread's part of r_j.r_j, its rows in order.
template <bool ZERO, bool STORE_R, bool UPDATE, typename TD>
__device__ __forceinline__ double ir_pass(const IrParams<TD>& P, const float* src, float* dst) {
  constexpr int R = GK_IR_ROWS;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  double acc = 0.0;
  for (long long i0 = t0; i0 < P.n; i0 += R * stride) {
    const GkStrideRows<R> rows(i0, stride, P.n);
    float ax[R], bv[R], mv[R], sv[R];
    if (!ZERO) gk_dia_rows<R>(P.op.diags, P.op.offs, P.n, rows, src, ax);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const long long i = rows.i[q];
      bv[q] = rows.ok[q] ? P.b[i] : 0.f;
      mv[q] = (UPDATE && P.minv && rows.ok[q]) ? P.minv[i] : 1.f;
      sv[q] = (UPDATE && !ZERO && rows.ok[q]) ? src[i] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (!rows.ok[q]) continue;
      const long long i = rows.i[q];
      const float ri = ZERO ? bv[q] : bv[q] - ax[q];
      if (STORE_R) P.r[i] = ri;
      if (UPDATE) dst[i] = sv[q] + P.omega * (P.minv ? mv[q] * ri : ri);
      acc += (double)ri * ri;
    }
  }
  return acc;
}

template <typename TD>
__global__ void __launch_bounds__(GK_CG_THREADS, GK_IR_MIN_BLOCKS)
    ir_fused_kernel(const IrParams<TD> P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[1][GK_CG_WARPS];
  __shared__ double bc1[1];
  const float tol_sq = *P.tol_sq;

  // pass j reads src = x_j across rows and writes dst = x_{j+1}
  const float* src = P.x0;
  float* dst = P.x;
  int it = 0;
  float rr;
  for (;;) {
    double s[1] = {ir_pass<false, false, true>(P, src, dst)};
    // a fast block writes the next sweep's partials while a slow one may
    // still fold these: the halves alternate
    double* part = P.part + (it & 1) * gridDim.x;
    block_partial_vm<1>(s, part, sh1);
    grid.sync();
    double tot[1];
    grid_total_batch<1, 4>(part, 1, gridDim.x, 1, tot, sh1, bc1);
    rr = (float)tot[0];
    // the monitor starts at +inf: the first sweep always runs
    const float mon = it == 0 ? CUDART_INF_F : rr;
    if (!(it < P.iters && !(mon <= tol_sq))) break;
    ++it;
    src = dst;
    dst = (it & 1) ? P.xb : P.x;
  }

  // the result is x_it, the last pass's source (x0, P.x for odd it, else
  // P.xb), read before the barrier and written by no pass after it: each
  // thread forms r = b - A x_it on its own rows as the sweeps formed it,
  // and copies x_it into P.x where it is not there
  ir_pass<false, true, false>(P, src, nullptr);
  if (src != P.x) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < P.n; i += stride)
      P.x[i] = src[i];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *P.it_out = it;
    *P.rr_out = rr;
    *P.conv_out = (rr <= tol_sq) ? 1 : 0;
  }
}

// A smoother's update pass from src (nullptr: zero), storing r_j where
// store_r says.
template <typename TD>
__device__ __forceinline__ void ir_smooth_pass(const IrParams<TD>& P, const float* src,
                                               float* dst, bool store_r) {
  if (src == nullptr) {
    if (store_r) ir_pass<true, true, true>(P, src, dst);
    else ir_pass<true, false, true>(P, src, dst);
  } else {
    if (store_r) ir_pass<false, true, true>(P, src, dst);
    else ir_pass<false, false, true>(P, src, dst);
  }
}

template <typename TD>
__global__ void __launch_bounds__(GK_CG_THREADS, GK_IR_MIN_BLOCKS)
    ir_smooth_kernel(const IrParams<TD> P) {
  cg::grid_group grid = cg::this_grid();
  const int iters = P.iters;

  // pass j reads src = x_j across rows (nullptr: zero) and writes x_{j+1}
  // into the buffer that leaves x_iters in P.x
  const float* src = P.x0;
  for (int j = 0; j < iters; ++j) {
    float* dst = ((iters - 1 - j) & 1) ? P.xb : P.x;
    const bool last = j == iters - 1;
    // without the residual the last pass stores r_{iters-1}: the plain
    // version's iters - 1 sweeps and one last update
    ir_smooth_pass(P, src, dst, last && !P.with_residual);
    // the next pass reads dst across rows and writes src's buffer
    if (!last || P.with_residual) grid.sync();
    src = dst;
  }
  // r = b - A x of the result: with the residual, or with no sweep (the
  // result is then x0, or zero, copied into P.x)
  if (P.with_residual || iters == 0) {
    if (src == nullptr) ir_pass<true, true, false>(P, src, nullptr);
    else ir_pass<false, true, false>(P, src, nullptr);
    if (src != P.x) {
      const long long stride = (long long)gridDim.x * blockDim.x;
      for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < P.n;
           i += stride)
        P.x[i] = src ? src[i] : 0.f;
    }
  }
}

// Blocks of the cooperative grid, the smaller of the two kernels' (both
// entry points launch this many).
extern "C" int ir_fused_grid(int d_dtype, int* blocks) {
  int a = 0, b = 0, e = 0;
  if (d_dtype == GK_F32) {
    if ((e = gk_coop_blocks(ir_fused_kernel<float>, &a)) != 0) return e;
    if ((e = gk_coop_blocks(ir_smooth_kernel<float>, &b)) != 0) return e;
  } else if (d_dtype == GK_BF16) {
    if ((e = gk_coop_blocks(ir_fused_kernel<__nv_bfloat16>, &a)) != 0) return e;
    if ((e = gk_coop_blocks(ir_smooth_kernel<__nv_bfloat16>, &b)) != 0) return e;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  *blocks = a < b ? a : b;
  return 0;
}

// K17's launch: out = {blocks of the cooperative grid, threads a block,
// blocks an SM, registers a thread} of the solve (smooth = 0) or the
// smoother's kernel.
extern "C" int ir_fused_config(int d_dtype, int smooth, int* out) {
  if (d_dtype == GK_F32)
    return smooth ? gk_coop_config(ir_smooth_kernel<float>, out)
                  : gk_coop_config(ir_fused_kernel<float>, out);
  if (d_dtype == GK_BF16)
    return smooth ? gk_coop_config(ir_smooth_kernel<__nv_bfloat16>, out)
                  : gk_coop_config(ir_fused_kernel<__nv_bfloat16>, out);
  return (int)cudaErrorInvalidValue;
}

template <typename TD>
static IrParams<TD> ir_params(const void* diags, const long long* offsets, int nd, long long n,
                              const float* b, const float* x0, const float* minv, float omega,
                              int iters, float* x, float* xb, float* r) {
  IrParams<TD> P;
  P.op = gk_dia_op<TD, false>(diags, offsets, nd, n);
  P.n = n;
  P.b = b;
  P.x0 = x0;
  P.minv = minv;
  P.omega = omega;
  P.iters = iters;
  P.x = x;
  P.xb = xb;
  P.r = r;
  P.tol_sq = nullptr;
  P.with_residual = 0;
  P.part = nullptr;
  P.it_out = nullptr;
  P.rr_out = nullptr;
  P.conv_out = nullptr;
  return P;
}

// K17's stop-test launch.
template <typename TD>
static int ir_solve_launch(const void* diags, const long long* offsets, int nd, long long n,
                           const float* b, const float* x0, const float* minv,
                           const float* tol_sq, float omega, int max_iters, float* x, float* xb,
                           float* r, double* part, int blocks, int* it_out, float* rr_out,
                           int* conv_out, void* stream) {
  IrParams<TD> P = ir_params<TD>(diags, offsets, nd, n, b, x0, minv, omega, max_iters, x, xb, r);
  P.tol_sq = tol_sq;
  P.part = part;
  P.it_out = it_out;
  P.rr_out = rr_out;
  P.conv_out = conv_out;
  return gk_coop_launch(ir_fused_kernel<TD>, P, blocks, stream);
}

// K17: IR/Richardson sweeps on a Dia to the stop test; x and xb are the two
// x buffers, x the result; r = b - A x; part holds 2 * blocks doubles.
extern "C" int ir_fused_solve(const void* diags, int d_dtype, const long long* offsets,
                              int nd, long long n, const float* b, const float* x0,
                              const float* minv, const float* tol_sq, float omega,
                              int max_iters, float* x, float* xb, float* r, double* part,
                              int blocks, int* it_out, float* rr_out, int* conv_out,
                              void* stream) {
  if (nd < 1 || nd > GK_MAX_DIAGS || max_iters < 0 || blocks < 1 || x0 == nullptr)
    return (int)cudaErrorInvalidValue;
  if (d_dtype == GK_F32)
    return ir_solve_launch<float>(diags, offsets, nd, n, b, x0, minv, tol_sq, omega, max_iters,
                                  x, xb, r, part, blocks, it_out, rr_out, conv_out, stream);
  if (d_dtype == GK_BF16)
    return ir_solve_launch<__nv_bfloat16>(diags, offsets, nd, n, b, x0, minv, tol_sq, omega,
                                          max_iters, x, xb, r, part, blocks, it_out, rr_out,
                                          conv_out, stream);
  return (int)cudaErrorInvalidValue;
}

// K17's fixed-sweep launch: iters sweeps from x0 (nullptr: zero); x and xb
// are the two x buffers, x the result.
extern "C" int ir_smooth(const void* diags, int d_dtype, const long long* offsets, int nd,
                         long long n, const float* b, const float* x0, const float* minv,
                         float omega, int iters, int with_residual, float* x, float* xb,
                         float* r, int blocks, void* stream) {
  if (nd < 1 || nd > GK_MAX_DIAGS || iters < 0 || blocks < 1)
    return (int)cudaErrorInvalidValue;
#define GK_DIA_LAUNCH(TD)                                                                   \
  do {                                                                                      \
    IrParams<TD> P =                                                                        \
        ir_params<TD>(diags, offsets, nd, n, b, x0, minv, omega, iters, x, xb, r);          \
    P.with_residual = with_residual;                                                        \
    return gk_coop_launch(ir_smooth_kernel<TD>, P, blocks, stream);                         \
  } while (0)
  if (d_dtype == GK_F32) GK_DIA_LAUNCH(float);
  if (d_dtype == GK_BF16) GK_DIA_LAUNCH(__nv_bfloat16);
#undef GK_DIA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// K21's rows: K7's chunks (pell_cg_fused.cu).
using IrChunks = GkPellChunks<GK_CG_THREADS>;

struct PellIrParams {
  const void* values;
  const void* qidx;
  const int* bases;
  const int* tile_ptr;
  int S;
  int G;
  int n;
  const float* b;
  const float* x0;
  const float* minv;    // nullptr: Identity
  const float* tol_sq;  // device scalar
  float omega;
  int max_iters;
  float* x;      // x_j for odd j, and the result
  float* xb;     // x_j for even j >= 2
  float* r;      // nullptr: r not asked for
  double* part;  // 2 * gridDim.x per-block partial sums, used in turn
  int* it_out;
  float* rr_out;
  int* conv_out;
};

// As K7's, the launch bounds name 1 block an SM, so that nvcc takes the
// registers of K7's 4 blocks an SM rather than holding them to its own
// choice.
template <typename TV, typename TQ>
__global__ void __launch_bounds__(GK_CG_THREADS, 1) pell_ir_fused_kernel(const PellIrParams P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[1][GK_CG_WARPS];
  __shared__ double bc1[1];

  const TV* __restrict__ values = static_cast<const TV*>(P.values);
  const TQ* __restrict__ qidx = static_cast<const TQ*>(P.qidx);
  const int n = P.n;
  const float* __restrict__ b = P.b;
  const float* __restrict__ minv = P.minv;
  const float omega = P.omega;
  const float tol_sq = *P.tol_sq;
  const int chunks = (n + IrChunks::kChunk - 1) / IrChunks::kChunk;

  // pass j reads src = x_j across rows and writes dst = x_{j+1}
  const float* src = P.x0;
  float* dst = P.x;
  int it = 0;
  float rr;
  for (;;) {
    double s[1] = {0.0};
    for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
      float ax[GK_PELL_CHUNK_ROWS];
      IrChunks::spmv<TV, TQ>(values, qidx, P.bases, P.tile_ptr, P.S, P.G, n, src, c, ax);
#pragma unroll
      for (int q = 0; q < GK_PELL_CHUNK_ROWS; ++q) {
        const int i = IrChunks::row(c, q);
        if (i < n) {
          const float ri = b[i] - ax[q];
          const float di = minv ? minv[i] * ri : ri;
          dst[i] = src[i] + omega * di;
          s[0] += (double)ri * ri;
        }
      }
    }
    double* part = P.part + (it & 1) * gridDim.x;
    block_partial_vm<1>(s, part, sh1);
    grid.sync();
    double tot[1];
    grid_total_batch<1, 4>(part, 1, gridDim.x, 1, tot, sh1, bc1);
    rr = (float)tot[0];
    if (!(it < P.max_iters && !(rr <= tol_sq))) break;
    ++it;
    src = dst;
    dst = (it & 1) ? P.xb : P.x;
  }

  // the result is x_it, the last pass's source: x0 (it = 0), P.x (it odd)
  // or P.xb.  The last pass read it before the barrier and nothing writes
  // it after, so each thread copies its own rows into P.x where it is not
  // there, and forms r = b - A x_it on them where r is asked for
  const bool copy = src != P.x;
  if (P.r != nullptr) {
    float* __restrict__ r = P.r;
    for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
      float ax[GK_PELL_CHUNK_ROWS];
      IrChunks::spmv<TV, TQ>(values, qidx, P.bases, P.tile_ptr, P.S, P.G, n, src, c, ax);
#pragma unroll
      for (int q = 0; q < GK_PELL_CHUNK_ROWS; ++q) {
        const int i = IrChunks::row(c, q);
        if (i < n) {
          r[i] = b[i] - ax[q];
          if (copy) P.x[i] = src[i];
        }
      }
    }
  } else if (copy) {
    IrChunks::own_rows(n, [&](int i) { P.x[i] = src[i]; });
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *P.it_out = it;
    *P.rr_out = rr;
    *P.conv_out = (rr <= tol_sq) ? 1 : 0;
  }
}

// K21: blocks of the cooperative grid (two doubles of partial sums a
// block).
extern "C" int pell_ir_fused_grid(int v_dtype, int q_dtype, int* blocks) {
  GK_PELL_VQ_DISPATCH(v_dtype, q_dtype,
                      gk_coop_blocks(pell_ir_fused_kernel<TV, TQ>, blocks));
}

// K21: IR/Richardson sweeps on a square Pell (values float32/bfloat16, lane
// indices int8/int32) to the stop test, the monitor starting at r0's r.r;
// x and xb are the two x buffers, x the result; r (nullptr: none) b - A x.
extern "C" int pell_ir_fused_solve(const void* values, int v_dtype, const void* qidx,
                                   int q_dtype, const int* bases, const int* tile_ptr, int S,
                                   int G, long long n, const float* b, const float* x0,
                                   const float* minv, const float* tol_sq, float omega,
                                   int max_iters, float* x, float* xb, float* r, double* part,
                                   int blocks, int* it_out, float* rr_out, int* conv_out,
                                   void* stream) {
  // rows are 32-bit, with room for a chunk past the last row
  if (S < 1 || G < 1 || max_iters < 0 || blocks < 1 || x0 == nullptr || n < 0 ||
      n > 0x7fffffffLL - IrChunks::kChunk)
    return (int)cudaErrorInvalidValue;
  PellIrParams P;
  P.values = values;
  P.qidx = qidx;
  P.bases = bases;
  P.tile_ptr = tile_ptr;
  P.S = S;
  P.G = G;
  P.n = (int)n;
  P.b = b;
  P.x0 = x0;
  P.minv = minv;
  P.tol_sq = tol_sq;
  P.omega = omega;
  P.max_iters = max_iters;
  P.x = x;
  P.xb = xb;
  P.r = r;
  P.part = part;
  P.it_out = it_out;
  P.rr_out = rr_out;
  P.conv_out = conv_out;
  GK_PELL_VQ_DISPATCH(v_dtype, q_dtype,
                      gk_coop_launch(pell_ir_fused_kernel<TV, TQ>, P, blocks, stream));
}
