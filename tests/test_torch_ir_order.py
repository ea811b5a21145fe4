"""The schedule K21 (``pell_ir_fused``) keeps, held on the CPU against the
plain version its CUDA kernel is checked against, and the route's row
limit.

The kernel (``csrc/ir_fused.cu`` ``pell_ir_fused_kernel``) runs one pass
and one grid barrier a sweep on K7's chunked rows (``pell.cuh``
``GkPellChunks``: chunks of 256 R rows dealt to the blocks in turn, R =
``GK_PELL_CHUNK_ROWS``).  Pass j reads x_j across rows and, on a thread's
own rows, forms r_j = b - A x_j in ``pell.cuh``'s slot order, writes
x_{j+1} = x_j + omega M r_j into the other of two x buffers and adds
r_j.r_j to the thread's float64 sum (r_j is not stored); the block's partial goes into half j
mod 2 of the partial buffer, and after the barrier every block folds that
half in block order.  The stop test then reads the monitor, which starts at
r0's r.r.  The first pass reads x0 itself; on exit the result is the x the
last pass read, copied into the output buffer where it is not there, and
r = b - A x is formed once on the own rows where it is asked for.  The
float64 r.r sums in K7's chunk order (``tests/test_torch_pell_cg_order.py``
states that order; the plain version's ``torch.sum`` adds in another, and
the totals round to the same float32).

An independent numpy loop of that schedule, float32 throughout, must equal
``ops/pell_cg.pell_ir_solve_reference`` bit for bit: x, r, the sweep count
and r.r, on Pells the JAX package builds, carried across by ``interop``;
the plain version is held against the JAX kernel ``pell_ir_vmem_solve``
in Pallas interpret mode by ``tests/test_torch_pell_krylov.py``.  The loop
lets one block fold each sweep's partials only after every other block has
written the next sweep's, the widest interleaving one barrier a sweep
allows.  Cases: S = 1, 8 and 16; n not a multiple of a chunk; several
chunks a block; zero sweeps; ``max_iters`` 0 and 1; a NaN in b; bfloat16
values; int32 lane indices; the Identity and Jacobi.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu_torch import stop
from ginkgo_tpu_torch.ops import pell_cg as ops_pc
from ginkgo_tpu_torch.solver import cg as solver_cg
from ginkgo_tpu_torch.solver import ir as solver_ir
from tests.test_torch_pell_cg_order import (CHUNK, F32, F64, ROWS, THREADS, SlotSum, _bits,
                                            block_sum, jax_pell, owners, shifted_poisson_3d)

_CSRC = Path(gt.__file__).parent / "csrc"
_SOURCE = (_CSRC / "ir_fused.cu").read_text()


@pytest.fixture(autouse=True)
def _one_thread():
    """The loops run many small tensor ops: one intra-op thread each, so
    that they do not spin against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_chunk_constants_agree():
    """K21 takes K7's chunks, the Python limit is the kernels' guard, and
    the route's CHUNK_ROWS is the chunk both kernels walk."""
    assert "using IrChunks = GkPellChunks<GK_CG_THREADS>;" in _SOURCE
    assert ops_pc.CHUNK_ROWS == CHUNK == THREADS * ROWS
    assert ops_pc.MAX_CHUNKED_ROWS == 0x7FFFFFFF - CHUNK
    assert "n > 0x7fffffffLL - IrChunks::kChunk" in _SOURCE
    assert "n > 0x7fffffffLL - CgChunks::kChunk" in (_CSRC / "pell_cg_fused.cu").read_text()
    assert ops_pc.chunk_rows_fit(ops_pc.MAX_CHUNKED_ROWS)
    assert not ops_pc.chunk_rows_fit(ops_pc.MAX_CHUNKED_ROWS + 1)


class Partials:
    """Two halves of per-block partials, as the kernel holds them."""

    def __init__(self, blocks):
        self.halves = np.full((2, blocks), np.nan)

    def write(self, j, blk, value):
        self.halves[j & 1, blk] = value

    def fold(self, j):
        v = np.zeros(THREADS)
        v[:self.halves.shape[1]] = 0.0 + self.halves[j & 1]
        return F32(block_sum(v))


@np.errstate(invalid="ignore", over="ignore")
def schedule_loop(A, b, x0, minv, omega, tol, max_iters, blocks):
    """K21's one-pass schedule in numpy float32.  Returns (x, r, sweeps,
    r.r) as pell_ir_solve_reference does."""
    n = A.shape[0]
    spmv = SlotSum(A)
    blk, _ = owners(n, blocks)
    chunks = -(-n // CHUNK)
    row_of = np.arange(chunks * CHUNK).reshape(chunks, ROWS, THREADS)
    om = F32(omega)
    buf = {"x": np.full(n, np.nan, F32), "xb": np.full(n, np.nan, F32)}
    r = np.full(n, np.nan, F32)
    part = Partials(blocks)

    def run_pass(j, src, dst):
        """Pass j over every block's chunks: r, dst and the partials."""
        ax = spmv(src)
        for blk_id in range(blocks):
            acc = np.zeros(THREADS)
            for c in range(blk_id, chunks, blocks):
                for q in range(ROWS):
                    rows = row_of[c, q]
                    ok = rows < n
                    i = rows[ok]
                    ri = b[i] - ax[i]
                    di = ri if minv is None else minv[i] * ri
                    dst[i] = src[i] + om * di
                    acc[ok] = acc[ok] + ri.astype(F64) * ri.astype(F64)
            part.write(j, blk_id, block_sum(acc))

    src, dst, it = x0, buf["x"], 0
    run_pass(0, src, dst)
    while True:
        rr = part.fold(it)
        if not (it < max_iters and not (rr <= tol)):
            break
        it += 1
        src, dst = dst, buf["xb"] if it & 1 else buf["x"]
        run_pass(it, src, dst)
        # the slowest block folds sweep it - 1 only now: the next sweep's
        # partials, written above, went into the other half
        assert _bits(part.fold(it - 1), rr)
    # after the last barrier: the result into the output buffer, and r of
    # it formed once as the sweeps formed it
    ax = spmv(src)
    for c in range(chunks):
        for q in range(ROWS):
            i = row_of[c, q][row_of[c, q] < n]
            r[i] = b[i] - ax[i]
            if src is not buf["x"]:
                buf["x"][i] = src[i]
    assert blk.max() == min(blocks, chunks) - 1
    return buf["x"], r.copy(), it, rr


CASES = {
    # name: (nside, S, G, q dtype, bf16 values, Jacobi, omega, start, cap, NaN in b, blocks)
    "S8_jacobi": (13, 8, "auto", np.int8, False, True, 1.0, "zero", 400, False, 2),
    "S8_identity": (13, 8, 4, np.int8, False, False, 0.1, "zero", 400, False, 2),
    "S1_jacobi": (13, 1, 4, np.int8, False, True, 0.9, "guess", 400, False, 3),
    "S16_int32_bf16_jacobi": (13, 16, "auto", np.int32, True, True, 1.0, "zero", 400, False, 2),
    "S8_bf16_several_chunks": (20, 8, "auto", np.int8, True, True, 1.0, "zero", 400, False, 3),
    "S8_zero_sweeps": (13, 8, "auto", np.int8, False, True, 1.0, "solution", 400, False, 2),
    "S8_max_iters_0": (13, 8, "auto", np.int8, False, True, 1.0, "guess", 0, False, 2),
    "S8_max_iters_1": (13, 8, "auto", np.int8, False, False, 0.1, "guess", 1, False, 2),
    "S8_max_iters_2": (13, 8, "auto", np.int8, False, True, 1.0, "zero", 2, False, 2),
    "S8_nan": (13, 8, "auto", np.int8, False, True, 1.0, "zero", 7, True, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_pass_schedule_matches_plain_version(case):
    nside, S, G, q, bf16, jacobi, omega, start, cap, nan, blocks = CASES[case]
    A = jax_pell(nside, S, G, q, bf16)
    n = A.shape[0]
    assert n % CHUNK != 0 and A.S == S and A.qidx.dtype == torch.from_numpy(np.zeros(1, q)).dtype
    if "several_chunks" in case:
        assert -(-n // CHUNK) > 2 * blocks
    rng = np.random.default_rng(n + S)
    b = rng.uniform(0.5, 1.5, n).astype(F32)
    if nan:
        b[n // 2] = np.nan
    minv = (1.0 / A.extract_diagonal().values.float()).numpy() if jacobi else None
    if start == "zero":
        x0 = np.zeros(n, F32)
    elif start == "guess":
        x0 = rng.uniform(-0.1, 0.1, n).astype(F32)
    else:  # the float64 solution: r0 already meets the threshold
        shape, rows, cols, vals = shifted_poisson_3d(nside)
        dense = np.zeros(shape)
        dense[rows, cols] = vals
        x0 = np.linalg.solve(dense, b.astype(F64)).astype(F32)
    tol = F32((1e-3 * np.linalg.norm(np.nan_to_num(b).astype(F64))) ** 2)
    x, r, it, rr = schedule_loop(A, b, x0, minv, omega, tol, cap, blocks)
    t = torch.from_numpy
    want = ops_pc.pell_ir_solve_reference(A, t(b), t(x0), None if minv is None else t(minv),
                                          omega=omega, tol_sq_eff=float(tol), max_iters=cap,
                                          with_residual=True)
    assert it == int(want[2])
    assert _bits(x, want[0].numpy()) and _bits(r, want[1].numpy()) and _bits(rr, want[3].numpy())
    if nan:
        assert it == cap and np.isnan(rr)
    elif start == "solution":
        assert it == 0 and rr <= tol and _bits(x, x0)
    elif cap <= 2:
        assert it == cap and not rr <= tol
        if cap == 0:
            assert _bits(x, x0)
    else:
        assert rr <= tol and 0 < it < cap


@pytest.mark.parametrize("solver", ["ir", "cg"])
def test_route_declines_beyond_chunk_rows(monkeypatch, solver):
    """K21's and K7's rows are 32-bit: where the kernel's guard would
    refuse a Pell, the route declines and the streaming loop runs.  The
    limit is lowered here so that a small Pell lies beyond it."""
    A = jax_pell(8, 8, "auto", np.int8, False)
    n = A.shape[0]
    b = torch.from_numpy(np.random.default_rng(3).uniform(0.5, 1.5, (n, 1)).astype(F32))
    crit = [stop.Iteration(max_iters=50), stop.ResidualNorm(tolerance=1e-4)]
    jac = gt.Jacobi.build(max_block_size=1)
    if solver == "ir":
        s = gt.Ir.build(criteria=crit, preconditioner=jac).generate(A)
        module, kernel = solver_ir, "pell_ir_fused"
    else:
        s = gt.Cg.build(criteria=crit, preconditioner=jac).generate(A)
        module, kernel = solver_cg, "pell_cg_fused"
    seen = []
    real = getattr(module, kernel)
    monkeypatch.setattr(module, kernel, lambda *a, **k: seen.append(1) or real(*a, **k))
    x_fused, _ = s.solve(b)
    assert seen == [1]
    monkeypatch.setattr(ops_pc, "MAX_CHUNKED_ROWS", n - 1)
    x_stream, info = s.solve(b)
    assert seen == [1] and bool(info.converged.all())
    assert float((x_stream - x_fused).abs().max()) <= 1e-3 * float(x_fused.abs().max())
