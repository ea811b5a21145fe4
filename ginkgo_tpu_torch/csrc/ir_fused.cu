// Whole-solve IR / Richardson (damped Jacobi) in one persistent cooperative
// kernel: kernel K17 of the PyTorch port, with two entry points over one set
// of passes.
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
// What bounds it on the H100: bytes.  A sweep is two passes: the update
// x += omega M r reads x, r (and minv) and writes x; the residual
// r = b - A x reads the diagonals, x and b and writes r: (nd sizeof(TD) +
// 20) n bytes a sweep, 24 n with an inverse diagonal.
//
// What the design does about it: K4's (cg_fused.cu).  The grid is what the
// SMs hold at once, launched cooperatively; each row belongs to one thread
// in every pass.  The product reads x across rows (with __ldcg), so a
// barrier separates it from the update on either side: in the solve the
// stop test's reduction is the one after it; the smoother, which sums
// nothing, pays a barrier of its own there.  The stop test sums r.r
// in float64 per-block partials that every block adds in one fixed order
// (coop.cuh), so every block takes the same branch.  r is recomputed from b
// every sweep, never updated (ROADMAP, "IR sweep order").
//
// Semantics kept from _ir_kernel: the monitor starts at +inf, so the first
// sweep always runs; the loop runs while it < max_iters && !(rr <= tol_sq),
// rr the post-sweep r.r (a NaN keeps sweeping); the reported rr is the last
// sweep's, or r0's when max_iters = 0.
//
// The passes are templated on the operator (coop.cuh GkDiaOp, pell.cuh
// GkPellOp): on a Pell, ir_fused_kernel is K21 (pell_ir_fused_solve), which
// replaces ginkgo_tpu/ops/pallas_pell_cg.py pell_ir_vmem_solve
// (_pell_ir_kernel, :794).  That TPU kernel's monitor starts at the r.r of
// r0 = b - A x0, not at +inf, so a solve whose r0 already meets the
// threshold runs no sweep (the template flag kMonitorFromR0); every other
// rule is K17's.  A sweep moves the plan once (values, lane indices, bases)
// and the vectors as K17 does.

#include "coop.cuh"
#include "pell.cuh"

namespace cg = cooperative_groups;

template <typename Op>
struct IrParams {
  Op op;
  long long n;
  const float* b;
  const float* x0;      // ir_smooth: nullptr starts from zero
  const float* minv;    // nullptr: Identity
  const float* tol_sq;  // ir_fused_solve: device scalar
  float omega;
  int iters;  // ir_fused_solve: max_iters; ir_smooth: the sweep count
  int with_residual;
  float* x;  // read across rows by the residual's product
  float* r;
  double* part;  // gridDim.x per-block partial sums
  int* it_out;
  float* rr_out;
  int* conv_out;
};

// x += omega M r over this thread's rows.
template <typename Op>
__device__ __forceinline__ void ir_update(const IrParams<Op>& P) {
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = t0; i < P.n; i += stride) {
    const float ri = P.r[i];
    const float di = P.minv ? P.minv[i] * ri : ri;
    P.x[i] = P.x[i] + P.omega * di;
  }
}

// r = b - A x over this thread's rows; returns this thread's part of r.r.
template <typename Op>
__device__ __forceinline__ double ir_residual(const IrParams<Op>& P) {
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  double acc = 0.0;
  for (long long i = t0; i < P.n; i += stride) {
    const float ri = P.b[i] - P.op.row(i, P.x);
    P.r[i] = ri;
    acc += (double)ri * ri;
  }
  return acc;
}

template <typename Op, bool kMonitorFromR0>
__global__ void __launch_bounds__(GK_CG_THREADS) ir_fused_kernel(const IrParams<Op> P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[1][GK_CG_WARPS];
  __shared__ double bc1[1];
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;

  for (long long i = t0; i < P.n; i += stride) P.x[i] = P.x0[i];
  grid.sync();
  double acc[1] = {ir_residual(P)};
  block_partial<1>(acc, P.part, sh1);
  grid.sync();
  double tot[1];
  grid_total<1>(P.part, tot, sh1, bc1);
  float rr = (float)tot[0];

  const float tol_sq = *P.tol_sq;
  float mon = kMonitorFromR0 ? rr : CUDART_INF_F;
  int it = 0;
  while (it < P.iters && !(mon <= tol_sq)) {
    ir_update(P);
    grid.sync();
    acc[0] = ir_residual(P);
    // a block writes these partials after the barrier above, which no
    // block reaches before it has read the previous sweep's
    block_partial<1>(acc, P.part, sh1);
    grid.sync();
    grid_total<1>(P.part, tot, sh1, bc1);
    rr = (float)tot[0];
    mon = rr;
    ++it;
  }

  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *P.it_out = it;
    *P.rr_out = rr;
    *P.conv_out = (rr <= tol_sq) ? 1 : 0;
  }
}

template <typename Op>
__global__ void __launch_bounds__(GK_CG_THREADS) ir_smooth_kernel(const IrParams<Op> P) {
  cg::grid_group grid = cg::this_grid();
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;

  if (P.x0 == nullptr) {
    // r0 = b: no product on an all-zero x
    for (long long i = t0; i < P.n; i += stride) {
      P.x[i] = 0.f;
      P.r[i] = P.b[i];
    }
  } else {
    for (long long i = t0; i < P.n; i += stride) P.x[i] = P.x0[i];
    grid.sync();
    ir_residual(P);
  }
  // The residual's product reads x across rows and, with no reduction
  // here, nothing else orders it before the next update writes x: a
  // barrier after each residual pass does.
  const int sweeps = P.with_residual ? P.iters : (P.iters > 0 ? P.iters - 1 : 0);
  for (int s = 0; s < sweeps; ++s) {
    grid.sync();
    ir_update(P);
    grid.sync();
    ir_residual(P);
  }
  if (!P.with_residual && P.iters > 0) grid.sync();
  if (!P.with_residual && P.iters > 0) ir_update(P);
}

// Blocks of the cooperative grid, the smaller of the two kernels' (both
// entry points launch this many).
extern "C" int ir_fused_grid(int d_dtype, int* blocks) {
  int a = 0, b = 0, e = 0;
  if (d_dtype == GK_F32) {
    if ((e = gk_coop_blocks(ir_fused_kernel<GkDiaOp<float>, false>, &a)) != 0) return e;
    if ((e = gk_coop_blocks(ir_smooth_kernel<GkDiaOp<float>>, &b)) != 0) return e;
  } else if (d_dtype == GK_BF16) {
    if ((e = gk_coop_blocks(ir_fused_kernel<GkDiaOp<__nv_bfloat16>, false>, &a)) != 0) return e;
    if ((e = gk_coop_blocks(ir_smooth_kernel<GkDiaOp<__nv_bfloat16>>, &b)) != 0) return e;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  *blocks = a < b ? a : b;
  return 0;
}

template <typename Op>
static IrParams<Op> ir_params(const Op& op, long long n, const float* b, const float* x0,
                              const float* minv, float omega, int iters, float* x, float* r) {
  IrParams<Op> P;
  P.op = op;
  P.n = n;
  P.b = b;
  P.x0 = x0;
  P.minv = minv;
  P.omega = omega;
  P.iters = iters;
  P.x = x;
  P.r = r;
  P.tol_sq = nullptr;
  P.with_residual = 0;
  P.part = nullptr;
  P.it_out = nullptr;
  P.rr_out = nullptr;
  P.conv_out = nullptr;
  return P;
}

// The stop-test entry points' launch (K17 on a Dia, K21 on a Pell).
template <typename Op, bool kMonitorFromR0>
static int ir_solve_launch(const Op& op, long long n, const float* b, const float* x0,
                           const float* minv, const float* tol_sq, float omega, int max_iters,
                           float* x, float* r, double* part, int blocks, int* it_out,
                           float* rr_out, int* conv_out, void* stream) {
  IrParams<Op> P = ir_params(op, n, b, x0, minv, omega, max_iters, x, r);
  P.tol_sq = tol_sq;
  P.part = part;
  P.it_out = it_out;
  P.rr_out = rr_out;
  P.conv_out = conv_out;
  return gk_coop_launch(ir_fused_kernel<Op, kMonitorFromR0>, P, blocks, stream);
}

extern "C" int ir_fused_solve(const void* diags, int d_dtype, const long long* offsets,
                              int nd, long long n, const float* b, const float* x0,
                              const float* minv, const float* tol_sq, float omega,
                              int max_iters, float* x, float* r, double* part, int blocks,
                              int* it_out, float* rr_out, int* conv_out, void* stream) {
  if (nd < 1 || nd > GK_MAX_DIAGS || max_iters < 0 || blocks < 1 || x0 == nullptr)
    return (int)cudaErrorInvalidValue;
#define GK_DIA_LAUNCH(TD)                                                                  \
  ir_solve_launch<GkDiaOp<TD>, false>(gk_dia_op<TD>(diags, offsets, nd, n), n, b, x0, minv, \
                                      tol_sq, omega, max_iters, x, r, part, blocks, it_out, \
                                      rr_out, conv_out, stream)
  if (d_dtype == GK_F32) return GK_DIA_LAUNCH(float);
  if (d_dtype == GK_BF16) return GK_DIA_LAUNCH(__nv_bfloat16);
#undef GK_DIA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" int ir_smooth(const void* diags, int d_dtype, const long long* offsets, int nd,
                         long long n, const float* b, const float* x0, const float* minv,
                         float omega, int iters, int with_residual, float* x, float* r,
                         int blocks, void* stream) {
  if (nd < 1 || nd > GK_MAX_DIAGS || iters < 0 || blocks < 1)
    return (int)cudaErrorInvalidValue;
#define GK_DIA_LAUNCH(TD)                                                                  \
  do {                                                                                     \
    IrParams<GkDiaOp<TD>> P =                                                              \
        ir_params(gk_dia_op<TD>(diags, offsets, nd, n), n, b, x0, minv, omega, iters, x, r); \
    P.with_residual = with_residual;                                                       \
    return gk_coop_launch(ir_smooth_kernel<GkDiaOp<TD>>, P, blocks, stream);               \
  } while (0)
  if (d_dtype == GK_F32) GK_DIA_LAUNCH(float);
  if (d_dtype == GK_BF16) GK_DIA_LAUNCH(__nv_bfloat16);
#undef GK_DIA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// K21: blocks of the Pell form's cooperative grid (one double of partial
// sums per block).
extern "C" int pell_ir_fused_grid(int v_dtype, int q_dtype, int* blocks) {
  GK_PELL_VQ_DISPATCH(v_dtype, q_dtype,
                      gk_coop_blocks(ir_fused_kernel<GkPellOp<TV, TQ>, true>, blocks));
}

template <typename TV, typename TQ>
static int pell_ir_launch(const void* values, const void* qidx, const int* bases,
                          const int* tile_ptr, int S, int G, long long n, const float* b,
                          const float* x0, const float* minv, const float* tol_sq,
                          float omega, int max_iters, float* x, float* r, double* part,
                          int blocks, int* it_out, float* rr_out, int* conv_out,
                          void* stream) {
  return ir_solve_launch<GkPellOp<TV, TQ>, true>(
      gk_pell_op<TV, TQ>(values, qidx, bases, tile_ptr, S, G, n, nullptr), n, b, x0, minv,
      tol_sq, omega, max_iters, x, r, part, blocks, it_out, rr_out, conv_out, stream);
}

// K21: IR/Richardson sweeps on a square Pell (values float32/bfloat16, lane
// indices int8/int32) to the stop test, the monitor starting at r0's r.r.
extern "C" int pell_ir_fused_solve(const void* values, int v_dtype, const void* qidx,
                                   int q_dtype, const int* bases, const int* tile_ptr, int S,
                                   int G, long long n, const float* b, const float* x0,
                                   const float* minv, const float* tol_sq, float omega,
                                   int max_iters, float* x, float* r, double* part,
                                   int blocks, int* it_out, float* rr_out, int* conv_out,
                                   void* stream) {
  if (S < 1 || G < 1 || max_iters < 0 || blocks < 1 || x0 == nullptr)
    return (int)cudaErrorInvalidValue;
  GK_PELL_VQ_DISPATCH(v_dtype, q_dtype,
                      (pell_ir_launch<TV, TQ>)(values, qidx, bases, tile_ptr, S, G, n, b, x0,
                                               minv, tol_sq, omega, max_iters, x, r, part,
                                               blocks, it_out, rr_out, conv_out, stream));
}
