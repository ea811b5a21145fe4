// Whole-solve CG / FCG on a PELL operator in one persistent cooperative
// kernel: kernel K7 of the PyTorch port.
//
// Replaces ginkgo_tpu/ops/pallas_pell_cg.py pell_cg_vmem_solve
// (_pell_cg_kernel): the Krylov loop, the slot SpMV of a general
// unstructured matrix, the preconditioner (Identity or an inverse diagonal)
// and the stop test run on the device with no host round trip per
// iteration.
//
// What bounds it on the H100: bytes.  The TPU kernel keeps the slot arrays
// and the vectors in VMEM; here they stay in device memory and L2.  Per
// iteration the SpMV reads every slot cell (sizeof(value) + sizeof(q)
// bytes) and gathers p, and the vector passes move 44 bytes a row (52 with
// an inverse diagonal), as in K4 (cg_fused.cu).
//
// What the design does about it: K4's design (coop.cuh), with the SpMV
// pass at K5's footing (pell_spmv.cu).  The grid is sized as occupancy x
// SM count and launched cooperatively; the three passes are separated by
// grid barriers; float64 per-block partials, stored value-major, are
// summed by every block in one fixed order, each thread loading its
// partials at once (coop.cuh grid_total_batch).  The rows go in chunks of
// GK_CG_THREADS * GK_PELL_CHUNK_ROWS rows, dealt to the blocks in turn; a
// thread takes GK_PELL_CHUNK_ROWS rows of a chunk, 256 apart (pell.cuh
// GkPellChunks), the same rows in every pass, so x, r, q and p are only read back at
// their own rows by the thread that wrote them.  Where a chunk lies in one
// PELL tile (S a multiple of 8) the tile's slot range and each slot's base
// are read once for the thread's rows, the row index math is 32-bit, and
// the rows' value, lane index and gather loads of a slot are issued before
// their sums; other S take the rows one at a time (pell.cuh's row).  The
// gathers of p are plain loads, as K5's: they hit L1 where the cells of a
// warp read the same lines, and grid.sync() invalidates L1 (CCTL.IVALL
// after its fence in the SASS), so no line of an earlier pass survives a
// barrier.  The row sum is pell.cuh's, in the TPU kernel's order
// (_make_pell_spmv, pallas_pell_cg.py:67-101): G slots into a step sum,
// then the step sums in slot order.
//
// Semantics kept from _pell_cg_kernel (pallas_pell_cg.py:104-220), the same
// as K4's: the monitor starts at +inf; the loop runs while it < max_iters
// && !(mon <= tol_sq); exact r.r or implicit |rho| monitor; zero
// denominators give 0; flexible = FCG's Polak-Ribiere beta.  The TPU kernel
// sums its dot products in float32, this one in float64 (as K4).

#include "coop.cuh"
#include "pell.cuh"

namespace cg = cooperative_groups;

using CgChunks = GkPellChunks<GK_CG_THREADS>;

struct PellCgParams {
  const void* values;
  const void* qidx;
  const int* bases;
  const int* tile_ptr;
  int S;
  int G;
  int n;
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

// After a grid barrier: the total of NV value-major partials
// (block_partial_vm), nv of them read.
template <int NV>
__device__ __forceinline__ void gk_fold(const double* part, int nv, double (&tot)[NV],
                                        double (&sh)[NV][GK_CG_WARPS], double (&bc)[NV]) {
  grid_total_batch<NV, 4>(part, 1, gridDim.x, nv, tot, sh, bc);
}

// The launch bounds name 1 block an SM: with the thread count alone nvcc
// held the kernel to 44 registers (5 blocks an SM), 7% slower on the H100.
template <typename TV, typename TQ>
__global__ void __launch_bounds__(GK_CG_THREADS, 1)
    pell_cg_fused_kernel(const PellCgParams P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh1[1][GK_CG_WARPS];
  __shared__ double sh3[3][GK_CG_WARPS];
  __shared__ double bc1[1];
  __shared__ double bc3[3];

  const TV* __restrict__ values = static_cast<const TV*>(P.values);
  const TQ* __restrict__ qidx = static_cast<const TQ*>(P.qidx);
  const int n = P.n;
  double* part1 = P.part;              // p.q
  double* part3 = P.part + gridDim.x;  // rho, r.r, rho_t
  float* __restrict__ x = P.x;
  float* __restrict__ r = P.r;
  float* p = P.p;
  float* __restrict__ q = P.q;
  const float* __restrict__ minv = P.minv;

  // init: x = x0, r = r0, p = z = M r; rho = r.z
  {
    double s[3] = {0.0, 0.0, 0.0};
    CgChunks::own_rows(n, [&](int i) {
      const float ri = P.r0[i];
      const float zi = minv ? minv[i] * ri : ri;
      x[i] = P.x0[i];
      r[i] = ri;
      p[i] = zi;
      s[0] += (double)ri * zi;
      s[1] += (double)ri * ri;
    });
    block_partial_vm<3>(s, part3, sh3);
  }
  grid.sync();
  double tot3[3];
  gk_fold<3>(part3, 2, tot3, sh3, bc3);
  float rho = (float)tot3[0];

  const float tol_sq = *P.tol_sq;
  int it = 0;
  float mon = CUDART_INF_F;
  while (it < P.max_iters && !(mon <= tol_sq)) {
    // pass 1: q = A p over the PELL slots, partial p.q
    {
      double s[1] = {0.0};
      const int chunks = (n + CgChunks::kChunk - 1) / CgChunks::kChunk;
      for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
        float acc[GK_PELL_CHUNK_ROWS];
        CgChunks::spmv<TV, TQ>(values, qidx, P.bases, P.tile_ptr, P.S, P.G, n, p, c, acc);
#pragma unroll
        for (int k = 0; k < GK_PELL_CHUNK_ROWS; ++k) {
          const int i = CgChunks::row(c, k);
          if (i < n) {
            q[i] = acc[k];
            s[0] += (double)p[i] * acc[k];
          }
        }
      }
      block_partial_vm<1>(s, part1, sh1);
    }
    grid.sync();
    double tot1[1];
    gk_fold<1>(part1, 1, tot1, sh1, bc1);
    const float alpha = gk_sdiv(rho, (float)tot1[0]);

    // pass 2: x += alpha p, r -= alpha q; partial rho_new, r.r and, for
    // FCG, the Polak-Ribiere numerator (r_new - r_old).z_new
    {
      double s[3] = {0.0, 0.0, 0.0};
      CgChunks::own_rows(n, [&](int i) {
        const float pi = p[i];
        x[i] = x[i] + alpha * pi;
        const float ro = r[i];
        const float rn = ro - alpha * q[i];
        r[i] = rn;
        const float zi = minv ? minv[i] * rn : rn;
        s[0] += (double)rn * zi;
        s[1] += (double)rn * rn;
        if (P.flexible) s[2] += (double)(rn - ro) * zi;
      });
      block_partial_vm<3>(s, part3, sh3);
    }
    grid.sync();
    gk_fold<3>(part3, P.flexible ? 3 : 2, tot3, sh3, bc3);
    const float rho_new = (float)tot3[0];
    const float rr_new = (float)tot3[1];
    const float beta = gk_sdiv(P.flexible ? (float)tot3[2] : rho_new, rho);

    // pass 3: p = z + beta p (z recomputed from r)
    CgChunks::own_rows(n, [&](int i) {
      const float ri = r[i];
      const float zi = minv ? minv[i] * ri : ri;
      p[i] = zi + beta * p[i];
    });
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

// Number of blocks the cooperative grid will have (the wrapper sizes the
// partial-sum scratch, 4 doubles per block, from it).
extern "C" int pell_cg_fused_grid(int v_dtype, int q_dtype, int* blocks) {
  GK_PELL_VQ_DISPATCH(v_dtype, q_dtype,
                      gk_coop_blocks(pell_cg_fused_kernel<TV, TQ>, blocks));
}

// K7's launch on this device: out = {blocks of the cooperative grid,
// threads a block, blocks an SM, registers a thread}.
extern "C" int pell_cg_fused_config(int v_dtype, int q_dtype, int* out) {
  GK_PELL_VQ_DISPATCH(v_dtype, q_dtype, gk_coop_config(pell_cg_fused_kernel<TV, TQ>, out));
}

extern "C" int pell_cg_fused_solve(
    const void* values, int v_dtype, const void* qidx, int q_dtype,
    const int* bases, const int* tile_ptr, int S, int G, long long n,
    const float* r0, const float* x0, const float* minv, const float* tol_sq,
    int max_iters, int implicit, int flexible, float* x, float* r, float* p,
    float* q, double* part, int blocks, int* it_out, float* mon_out,
    int* conv_out, void* stream) {
  // rows are 32-bit, with room for a chunk past the last row
  if (S < 1 || G < 1 || blocks < 1 || n < 0 || n > 0x7fffffffLL - CgChunks::kChunk)
    return (int)cudaErrorInvalidValue;
  PellCgParams P;
  P.values = values;
  P.qidx = qidx;
  P.bases = bases;
  P.tile_ptr = tile_ptr;
  P.S = S;
  P.G = G;
  P.n = (int)n;
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
  GK_PELL_VQ_DISPATCH(v_dtype, q_dtype,
                      gk_coop_launch(pell_cg_fused_kernel<TV, TQ>, P, blocks,
                                     stream));
}
