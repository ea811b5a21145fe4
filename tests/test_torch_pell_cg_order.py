"""The schedule K7 (``pell_cg_fused``) keeps, held on the CPU against the
plain version its CUDA kernel is checked against.

The kernel (``csrc/pell_cg_fused.cu``) runs CG / FCG in three passes a
iteration with grid barriers between them.  Its rows go in chunks of 256 *
R rows (R = ``GK_PELL_CHUNK_ROWS``, ``pell.cuh``), dealt to the blocks in turn (chunk c to
block c mod B); a thread takes rows c 256 R + q 256 + t for q = 0 .. R - 1,
the same rows in every pass.  Each row's SpMV sum runs in ``pell.cuh``'s
order, tile by tile: the G slots of a step sum into a step sum from 0, the
step sums add into the row's total in slot order, a column outside [0, n)
reads 0.  A dot is a float64 sum: a thread adds its rows' products in
chunk and row order, a warp folds its 32 threads by shuffles (lane l adds
lane l + o for o = 16, 8, 4, 2, 1), warp 0 folds the 8 warp sums into the
block's partial, and every block folds the partials in block order
(``coop.cuh`` ``grid_total_batch``, grid_total's order); the total is
rounded to float32.

An independent numpy loop of that schedule, float32 throughout, must equal
``ops/pell_cg.pell_cg_solve_reference`` bit for bit: x, r, the iteration
count and the monitor, on Pells the JAX package builds, carried across by
``interop``; the plain version is held against the JAX kernel
``pell_cg_vmem_solve`` in Pallas interpret mode by
``tests/test_torch_pell_cg.py``.  Cases: S = 1, 8 and 16; G > 1; n not a
multiple of a chunk or a tile; several chunks a block; a NaN in b;
bfloat16 values and int32 lane indices; Jacobi; FCG; implicit mode.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu_torch
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.matrix.csr import Csr as JCsr
from ginkgo_tpu.matrix.pell import Pell as JPell
from ginkgo_tpu_torch import interop
from ginkgo_tpu_torch.ops.pell import pell_spmv_reference
from ginkgo_tpu_torch.ops.pell_cg import pell_cg_solve_reference
from ginkgo_tpu_torch.utils import generators

F32, F64 = np.float32, np.float64
LANES, THREADS, WARPS = 128, 256, 8

_SOURCE = (Path(ginkgo_tpu_torch.__file__).parent / "csrc" / "pell.cuh").read_text()
#: rows a thread takes of a chunk: the kernels' own constant
ROWS = int(re.search(r"#define GK_PELL_CHUNK_ROWS (\d+)", _SOURCE).group(1))
CHUNK = THREADS * ROWS


@pytest.fixture(autouse=True)
def _one_thread():
    """The loops run many small tensor ops: one intra-op thread each, so
    that they do not spin against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def shifted_poisson_3d(nside, seed=7):
    """The 3-D Poisson matrix with a seeded positive diagonal shift (SPD,
    Jacobi not a multiple of I), as ``chip_smoke.shifted_poisson_3d``."""
    data = generators.poisson_3d(nside, dtype=F32)
    vals = data.values.copy()
    diag = data.rows == data.cols
    vals[diag] += np.random.default_rng(seed).uniform(0.0, 2.0, int(diag.sum())).astype(F32)
    return data.shape, data.rows, data.cols, vals


def jax_pell(nside, S, G, q, bf16):
    """The JAX package's Pell of the shifted 3-D Poisson matrix, carried
    across bit for bit: the port's Pell on the CPU."""
    shape, rows, cols, vals = shifted_poisson_3d(nside)
    JP = JPell.from_csr(JCsr.from_matrix_data(JMatrixData.from_coo(shape, rows, cols, vals)),
                        G=G, S=S, q_dtype=q)
    values = np.asarray(JP.values)
    if bf16:
        values = np.asarray(jnp.asarray(values).astype(jnp.bfloat16))
    return interop.pell_from_arrays(values, np.asarray(JP.qidx), np.asarray(JP.bases),
                                    np.asarray(JP.tile_of_step), shape=JP.shape,
                                    n_steps=JP.n_steps, nnz=JP.nnz, G=JP.G, NT=JP.NT, NP=JP.NP,
                                    S=JP.S, device="cpu")


class SlotSum:
    """q = A p in ``pell.cuh``'s order, tile by tile, in numpy float32."""

    def __init__(self, A):
        self.S, self.G, self.n = A.S, A.G, A.shape[0]
        self.vals = A.values.float().numpy()
        sub = np.arange(self.S)[None, :, None]
        self.cols = ((A.bases.numpy().astype(np.int64)[:, None, None] - (self.S - 1) + sub)
                     * LANES + A.qidx.numpy().astype(np.int64))
        self.ok = (self.cols >= 0) & (self.cols < self.n)
        self.cols = np.clip(self.cols, 0, self.n - 1)
        self.tile_ptr = A.tile_ptr.numpy()

    @np.errstate(invalid="ignore")
    def __call__(self, p):
        S, G = self.S, self.G
        tiles = len(self.tile_ptr) - 1
        y = np.zeros(tiles * S * LANES, F32)
        for t in range(tiles):
            total = np.zeros((S, LANES), F32)
            for slot0 in range(self.tile_ptr[t], self.tile_ptr[t + 1], G):
                acc = np.zeros((S, LANES), F32)
                for slot in range(slot0, slot0 + G):
                    xv = np.where(self.ok[slot], p[self.cols[slot]], F32(0))
                    acc = acc + self.vals[slot] * xv
                total = total + acc
            y[t * S * LANES:(t + 1) * S * LANES] = total.reshape(-1)
        return y[:self.n]


def owners(n, blocks):
    """(block, thread) of every row under the chunk schedule."""
    r = np.arange(n)
    return (r // CHUNK) % blocks, r % THREADS


def warp_fold(a):
    """Lane 0 of a warp's shuffle fold over the last axis (32 lanes)."""
    a = a.copy()
    for o in (16, 8, 4, 2, 1):
        a[..., :o] = a[..., :o] + a[..., o:2 * o]
    return a[..., 0]


def block_sum(v):
    """coop.cuh block_sum of the block's 256 threads' values."""
    lanes = np.zeros(32)
    lanes[:WARPS] = warp_fold(v.reshape(WARPS, 32))
    return warp_fold(lanes)


def kernel_dot(a, b, blocks):
    """sum a b in the kernel's order, rounded to float32."""
    n = a.shape[0]
    chunks = -(-n // CHUNK)
    prod = np.zeros(chunks * CHUNK)
    prod[:n] = a.astype(F64) * b.astype(F64)
    prod = prod.reshape(chunks, ROWS, THREADS)
    valid = (np.arange(chunks * CHUNK) < n).reshape(chunks, ROWS, THREADS)
    part = np.zeros(blocks)
    for blk in range(blocks):
        acc = np.zeros(THREADS)
        for c in range(blk, chunks, blocks):
            for q in range(ROWS):
                acc = np.where(valid[c, q], acc + prod[c, q], acc)
        part[blk] = block_sum(acc)
    v = np.zeros(THREADS)
    v[:blocks] = 0.0 + part
    return F32(block_sum(v))


def sdiv(num, den):
    return num / den if den != 0 else F32(0)


@np.errstate(invalid="ignore", over="ignore")
def schedule_loop(A, r0, x0, minv, tol, max_iters, implicit, flexible, blocks):
    """K7's three passes in numpy float32.  Returns (x, r, iterations,
    monitor) as pell_cg_solve_reference does."""
    spmv = SlotSum(A)
    x, r = x0.copy(), r0.copy()
    z = r if minv is None else minv * r
    p = z.copy()
    rho = kernel_dot(r, z, blocks)
    it, mon = 0, F32(np.inf)
    while it < max_iters and not (mon <= tol):
        q = spmv(p)  # pass 1
        alpha = sdiv(rho, kernel_dot(p, q, blocks))
        x = x + alpha * p  # pass 2
        ro = r
        r = ro - alpha * q
        z = r if minv is None else minv * r
        rho_new = kernel_dot(r, z, blocks)
        rr_new = kernel_dot(r, r, blocks)
        beta = sdiv(kernel_dot(r - ro, z, blocks) if flexible else rho_new, rho)
        p = z + beta * p  # pass 3
        mon = abs(rho) if implicit else rr_new
        rho = rho_new
        it += 1
    return x, r, it, mon


CASES = {
    # name: (nside, S, G, q dtype, bf16 values, Jacobi, FCG, implicit, NaN in b, blocks)
    "S8": (13, 8, "auto", np.int8, False, False, False, False, False, 2),
    "S8_G4_jacobi_fcg": (13, 8, 4, np.int8, False, True, True, False, False, 2),
    "S1_G4_jacobi": (13, 1, 4, np.int8, False, True, False, False, False, 3),
    "S16_int32_bf16_implicit": (13, 16, "auto", np.int32, True, False, False, True, False, 2),
    "S8_bf16_fcg_several_chunks": (20, 8, "auto", np.int8, True, False, True, False, False, 3),
    "S8_nan": (13, 8, "auto", np.int8, False, False, False, False, True, 2),
}


def _bits(a, b):
    a, b = np.asarray(a, F32), np.asarray(b, F32)
    nan = np.isnan(b)
    return (a.shape == b.shape and np.array_equal(np.isnan(a), nan)
            and np.array_equal(a[~nan].view(np.int32), b[~nan].view(np.int32)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunk_schedule_matches_plain_version(case):
    nside, S, G, q, bf16, jacobi, fcg, implicit, nan, blocks = CASES[case]
    A = jax_pell(nside, S, G, q, bf16)
    n = A.shape[0]
    assert n % CHUNK != 0 and n % (A.S * LANES) != 0
    if G == 4:
        assert A.G == 4 and (np.diff(A.tile_ptr.numpy()) > A.G).any()  # several steps a tile
    blk, thr = owners(n, blocks)
    assert blk.max() == min(blocks, -(-n // CHUNK)) - 1 and thr.max() == THREADS - 1
    if "several_chunks" in case:
        assert -(-n // CHUNK) > 2 * blocks
    rng = np.random.default_rng(n + S)
    b = rng.uniform(0.5, 1.5, n).astype(F32)
    if nan:
        b[n // 2] = np.nan
    tol = F32((1e-6 * np.linalg.norm(np.nan_to_num(b).astype(F64))) ** 2)
    cap = 7 if nan else 500
    minv = None
    if jacobi:
        minv = (1.0 / A.extract_diagonal().values.float()).numpy()
    # the slot sum is the plain version's, bit for bit
    p = rng.standard_normal(n).astype(F32)
    assert _bits(SlotSum(A)(p), pell_spmv_reference(A, torch.from_numpy(p)).numpy())
    x, r, it, mon = schedule_loop(A, b, np.zeros(n, F32), minv, tol, cap, implicit, fcg, blocks)
    want = pell_cg_solve_reference(A, torch.from_numpy(b), torch.zeros(n),
                                   None if minv is None else torch.from_numpy(minv),
                                   tol_sq_eff=float(tol), max_iters=cap, use_implicit=implicit,
                                   flexible=fcg)
    assert it == int(want[2])
    assert _bits(x, want[0].numpy()) and _bits(r, want[1].numpy())
    assert _bits(mon, want[3].numpy())
    if nan:
        assert it == cap and np.isnan(mon)
    else:
        assert mon <= tol and it < cap
