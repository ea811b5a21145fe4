"""The schedule K21 (``pell_ir_fused``) keeps, held on the CPU against the
plain version its CUDA kernel is checked against, and the route's row
limit; and the same one-pass schedule in K17 (``ir_fused``, ``ir_smooth``)
on a Dia, its grid barriers read from the source (the section at the end).

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
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.matrix.dia import Dia as JDia
from ginkgo_tpu_torch import interop, stop
from ginkgo_tpu_torch.ops import ir as ops_ir
from ginkgo_tpu_torch.ops import pell_cg as ops_pc
from ginkgo_tpu_torch.solver import cg as solver_cg
from ginkgo_tpu_torch.solver import ir as solver_ir
from tests.test_torch_bicgstab import dia_pair
from tests.test_torch_pell_bicgstab_cgs_order import kernel_body
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


# -- K17: the same one-pass schedule on a Dia (ir_fused and ir_smooth) ------------
#
# ``csrc/ir_fused.cu`` ``ir_fused_kernel`` and ``ir_smooth_kernel`` take one
# row a thread, grid-stride: row i is thread i mod (blocks 256)'s, the same
# in every pass, and a thread adds its rows' float64 r_j.r_j in row order.
# Pass j reads x_j across rows and, on its own rows, forms r_j = b - A x_j
# (the diagonals summed in offset order from 0, a column outside [0, n)
# skipped) and writes x_{j+1} = x_j + omega M r_j into the other of two x
# buffers.  The solve folds after each pass's one barrier (partials in two
# halves), and its monitor starts at +inf, so the first sweep always runs;
# on exit r = b - A x is formed once from the result.  The smoother folds
# nothing: its passes leave x_iters in the output buffer, the last one
# stores r_{iters-1} (the plain version's iters - 1 sweeps and a last
# update), and with ``with_residual`` one more pass forms r = b - A x_iters;
# from a zero start its first pass forms r_0 = b with no product.



def banded(n, offsets, seed):
    """A diagonally dominant nonsymmetric band with the given offsets (the
    diagonal 4.5 plus a seeded [0, 1) shift; -1.3 below it, -0.7 above), as
    the JAX package's Dia builds it, carried across."""
    i = np.arange(n)
    rows, cols, vals = [], [], []
    for off in offsets:
        keep = (i + off >= 0) & (i + off < n)
        rows.append(i[keep])
        cols.append(i[keep] + off)
        if off == 0:
            vals.append(4.5 + np.random.default_rng(seed).uniform(0.0, 1.0, n))
        else:
            vals.append(np.full(int(keep.sum()), -1.3 if off < 0 else -0.7))
    JA = JDia.from_matrix_data(JMatrixData.from_coo(
        (n, n), np.concatenate(rows), np.concatenate(cols),
        np.concatenate(vals).astype(F32)))
    return JA, interop.dia_from_arrays(np.asarray(JA.diags), JA.offsets, JA.shape, device="cpu")


def dia_operator(name, storage="f32"):
    """The port's Dia of a named operator and its diagonals in float32."""
    if name == "convdiff32":  # nd 5, offsets -32, -1, 0, 1, 32
        JA, A = dia_pair("convdiff32_jitter", storage)
    elif name == "diagonal":  # nd 1
        JA, A = banded(1500, (0,), 3)
    else:  # "wide": offsets past a block's 256 rows, n past two rounds of 2 blocks
        JA, A = banded(1500, (-600, -1, 0, 1, 300), 4)
        if storage == "bf16":
            A = A.reduce_storage()
    assert A.shape[0] == JA.shape[0]
    return A, A.diags.float().numpy(), list(A.offsets)


@np.errstate(invalid="ignore", over="ignore")
def dia_product(D, offsets, x):
    """A x, each row summed as gk_dia_row sums it, in numpy float32."""
    n = x.shape[0]
    i = np.arange(n)
    acc = np.zeros(n, F32)
    for d, off in enumerate(offsets):
        ok = (i + off >= 0) & (i + off < n)
        acc[ok] = acc[ok] + D[d, ok] * x[i[ok] + off]
    return acc


def stride_partials(prod, blocks):
    """Each block's float64 partial of the row values ``prod``: a thread
    adds its rows (grid-stride) in row order, then block_sum."""
    T = blocks * THREADS
    rounds = -(-prod.shape[0] // T)
    pad = np.zeros(rounds * T)
    pad[:prod.shape[0]] = prod
    valid = np.arange(rounds * T) < prod.shape[0]
    acc = np.zeros(T)
    for k in range(rounds):
        s = slice(k * T, (k + 1) * T)
        acc = np.where(valid[s], acc + pad[s], acc)
    return [block_sum(acc[b * THREADS:(b + 1) * THREADS]) for b in range(blocks)]


@np.errstate(invalid="ignore", over="ignore")
def dia_sweep(D, offsets, b, src, minv, om):
    """One pass: (r_j, x_{j+1}) from x_j = src (None: zero, r_j = b)."""
    r = b.copy() if src is None else b - dia_product(D, offsets, src)
    d = r if minv is None else minv * r
    return r, (F32(0) if src is None else src) + om * d


def dia_solve_loop(D, offsets, b, x0, minv, omega, tol, max_iters, blocks):
    """K17's one-pass solve in numpy.  Returns (x, r, sweeps, r.r) as
    ir_solve_reference does."""
    n = b.shape[0]
    om = F32(omega)
    buf = {"x": np.full(n, np.nan, F32), "xb": np.full(n, np.nan, F32)}
    part = Partials(blocks)

    def run_pass(j, src, dst):
        r, dst[:] = dia_sweep(D, offsets, b, src, minv, om)
        for blk, v in enumerate(stride_partials(r.astype(F64) * r.astype(F64), blocks)):
            part.write(j, blk, v)

    src, dst, it = x0, buf["x"], 0
    run_pass(0, src, dst)
    while True:
        rr = part.fold(it)
        mon = F32(np.inf) if it == 0 else rr
        if not (it < max_iters and not (mon <= tol)):
            break
        it += 1
        src, dst = dst, buf["xb"] if it & 1 else buf["x"]
        run_pass(it, src, dst)
        # a slow block folds sweep it - 1 only now, from the other half
        assert _bits(part.fold(it - 1), rr)
    r = dia_sweep(D, offsets, b, src, minv, om)[0]
    if src is not buf["x"]:
        buf["x"][:] = src
    return buf["x"], r, it, rr


def dia_smooth_loop(D, offsets, b, x0, minv, omega, iters, with_residual):
    """K17's smoother in numpy: (x, r) as ir_smooth_reference returns them."""
    n = b.shape[0]
    om = F32(omega)
    buf = {"x": np.full(n, np.nan, F32), "xb": np.full(n, np.nan, F32)}
    r = np.full(n, np.nan, F32)
    src = x0
    for j in range(iters):
        dst = buf["xb"] if (iters - 1 - j) & 1 else buf["x"]
        rj, dst[:] = dia_sweep(D, offsets, b, src, minv, om)
        if j == iters - 1 and not with_residual:
            r[:] = rj
        src = dst
    assert iters == 0 or src is buf["x"]
    if with_residual or iters == 0:
        r[:] = dia_sweep(D, offsets, b, src, minv, om)[0]
        if src is not buf["x"]:
            buf["x"][:] = 0.0 if src is None else src
    return buf["x"], r


@pytest.mark.parametrize("kernel", ["ir_fused_kernel", "ir_smooth_kernel"])
def test_dia_kernels_take_one_barrier_a_sweep(kernel):
    """K17's two kernels hold one grid barrier a sweep (the solve's is its
    fold's), with plain gathers, and the solve folds once a sweep."""
    body = kernel_body(_SOURCE, kernel)
    assert body.count("grid.sync()") == 1
    assert body.count("grid_total_batch<") == (kernel == "ir_fused_kernel")
    assert "__ldcg" not in body
    assert "GkDiaOp<TD, false> op;" in _SOURCE


SOLVE_CASES = {
    # name: (operator, storage, Jacobi, omega, start, cap, NaN in b, blocks)
    "convdiff32_jacobi": ("convdiff32", "f32", True, 1.0, "zero", 400, False, 2),
    "convdiff32_identity_bf16": ("convdiff32", "bf16", False, 0.2, "guess", 400, False, 3),
    "diagonal_jacobi_nd1": ("diagonal", "f32", True, 0.9, "guess", 400, False, 2),
    "wide_offsets_jacobi": ("wide", "f32", True, 1.0, "zero", 400, False, 2),
    "wide_offsets_bf16": ("wide", "bf16", False, 0.15, "guess", 400, False, 3),
    "max_iters_0": ("convdiff32", "f32", True, 1.0, "guess", 0, False, 2),
    "max_iters_1": ("wide", "f32", False, 0.15, "guess", 1, False, 2),
    "solution_start_sweeps_once": ("convdiff32", "f32", True, 1.0, "solution", 400, False, 2),
    "nan_monitor": ("convdiff32", "f32", True, 1.0, "zero", 7, True, 2),
}


@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_dia_one_pass_solve_matches_plain_version(case):
    name, storage, jacobi, omega, start, cap, nan, blocks = SOLVE_CASES[case]
    A, D, offsets = dia_operator(name, storage)
    n = A.shape[0]
    rng = np.random.default_rng(n + len(offsets))
    b = rng.uniform(0.5, 1.5, n).astype(F32)
    if nan:
        b[n // 2] = np.nan
    minv = (1.0 / A.extract_diagonal().values.float()).numpy() if jacobi else None
    if start == "zero":
        x0 = np.zeros(n, F32)
    elif start == "guess":
        x0 = rng.uniform(-0.1, 0.1, n).astype(F32)
    else:  # the float64 solution: r0 already meets the threshold
        dense = np.zeros((n, n))
        for d, off in enumerate(offsets):
            i = np.arange(max(0, -off), min(n, n - off))
            dense[i, i + off] = D[d, i]
        x0 = np.linalg.solve(dense, b.astype(F64)).astype(F32)
    tol = F32((1e-4 * np.linalg.norm(np.nan_to_num(b).astype(F64))) ** 2)
    x, r, it, rr = dia_solve_loop(D, offsets, b, x0, minv, omega, tol, cap, blocks)
    t = torch.from_numpy
    want = ops_ir.ir_solve_reference(A.diags, A.offsets, t(b), t(x0),
                                     None if minv is None else t(minv), omega=omega,
                                     tol_sq_eff=float(tol), max_iters=cap)
    assert it == int(want[2])
    assert _bits(x, want[0].numpy()) and _bits(r, want[1].numpy())
    assert _bits(rr, want[3].numpy()) and bool(rr <= tol) == bool(want[4])
    if nan:
        assert it == cap and np.isnan(rr)
    elif start == "solution":
        assert it == 1 and rr <= tol  # the monitor starts at +inf
    elif cap <= 1:
        assert it == cap
        if cap == 0:
            assert _bits(x, x0)
    else:
        assert rr <= tol and 1 < it < cap


@pytest.mark.parametrize("iters", [0, 1, 2, 3])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("start", ["zero", "x0"])
@pytest.mark.parametrize("name", ["convdiff32", "diagonal", "wide"])
def test_dia_smoother_matches_plain_version(name, start, with_residual, iters):
    A, D, offsets = dia_operator(name, "bf16" if name == "wide" else "f32")
    n = A.shape[0]
    rng = np.random.default_rng(7 * n + iters)
    b = rng.standard_normal(n).astype(F32)
    x0 = None if start == "zero" else rng.standard_normal(n).astype(F32)
    minv = (1.0 / A.extract_diagonal().values.float()).numpy()
    x, r = dia_smooth_loop(D, offsets, b, x0, minv, 0.8, iters, with_residual)
    t = torch.from_numpy
    want = ops_ir.ir_smooth_reference(A.diags, A.offsets, t(b), None if x0 is None else t(x0),
                                      t(minv), omega=0.8, iters=iters,
                                      with_residual=with_residual)
    assert _bits(x, want[0].numpy()) and _bits(r, want[1].numpy())
    if iters == 0:
        assert _bits(x, np.zeros(n, F32) if x0 is None else x0)
