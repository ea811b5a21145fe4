"""The schedules K19 (``pell_bicgstab_fused``) and K20 (``pell_cgs_fused``)
keep, held on the CPU against the plain versions their CUDA kernels are
checked against, and the routes' row limit.

Both kernels (``csrc/bicgstab_fused.cu`` ``pell_bicgstab_fused_kernel``,
``csrc/cgs_fused.cu`` ``pell_cgs_fused_kernel``) walk K7's chunked rows
(``pell.cuh`` ``GkPellChunks``: chunks of 256 R rows dealt to the blocks in
turn, R = ``GK_PELL_CHUNK_ROWS``, a thread's rows the same in every pass),
each product row summed in ``pell.cuh``'s slot order from M p (M s, M w),
one float32 product an entry.  A dot is a float64 sum in K7's chunk order
(``tests/test_torch_pell_cg_order.py`` states it): each block writes its
partial after a pass, and after a grid barrier every block folds the
partials in block order; the total rounds to float32.

K19, five passes and five barriers an iteration, three folds:

1. p = r + beta (p - omega v);
2. v = A M p, partial <rr, v>; fold -> alpha;
3. s = r - alpha v, partial s.s (not folded here);
4. t = A M s, partials t.s and t.t; one fold of s.s, t.s and t.t -> the
   half step and omega;
5. x += alpha M p + omega M s, r = s - omega t, partials <rr, r> and r.r;
   fold.

K20, four passes and four barriers, two folds: 1. u = r + beta q, p = u +
beta (q + beta p); 2. v = A M p, <rr, v>, fold; 3. q = u - alpha v, w = u +
q; 4. t = A M w, x += alpha M w, r -= alpha t, <rr, r> and r.r, fold.

An independent numpy loop of each schedule, float32 vectors and float64
partials, must equal ``ops/pell_cg.pell_bicgstab_solve_reference`` or
``pell_cgs_solve_reference`` bit for bit: x, r, the iteration count and
the monitor, on Pells the JAX package builds, carried across by
``interop``; the plain versions are held against the JAX kernels in Pallas
interpret mode by ``tests/test_torch_pell_krylov.py``.  Cases: S = 1, 8
and 16; n not a multiple of a chunk; several chunks a block;
``max_iters`` 0 and 1; a NaN in b; the half step (2 I: s = 0 in the first
iteration); implicit mode; bfloat16 values; int32 lane indices; the
Identity and Jacobi.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.matrix.csr import Csr as JCsr
from ginkgo_tpu.matrix.pell import Pell as JPell
from ginkgo_tpu_torch import interop, stop
from ginkgo_tpu_torch.ops import pell_cg as ops_pc
from ginkgo_tpu_torch.solver import bicgstab as solver_bicgstab
from tests.test_torch_pell_cg_order import (CHUNK, F32, F64, ROWS, THREADS, SlotSum, _bits,
                                            block_sum, jax_pell, owners)

_CSRC = Path(gt.__file__).parent / "csrc"


@pytest.fixture(autouse=True)
def _one_thread():
    """The loops run many small tensor ops: one intra-op thread each, so
    that they do not spin against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def kernel_body(source, name):
    """The text of the __global__ function ``name`` in a CUDA source."""
    start = source.index(f" {name}(")
    body = source.index("{", start)
    depth, i = 0, body
    while True:
        depth += {"{": 1, "}": -1}.get(source[i], 0)
        if depth == 0:
            return source[body:i + 1]
        i += 1


@pytest.mark.parametrize("kernel, source, syncs, folds", [
    ("pell_bicgstab_fused_kernel", "bicgstab_fused.cu", 6, 4),
    ("pell_cgs_fused_kernel", "cgs_fused.cu", 5, 3),
])
def test_kernel_keeps_the_declared_schedule(kernel, source, syncs, folds):
    """The kernels walk K7's chunks, guard their 32-bit rows as the route's
    limit says, and hold the barriers and folds the schedule declares: the
    init's and one a pass; K19 folds three times an iteration, K20 twice."""
    text = (_CSRC / source).read_text()
    body = kernel_body(text, kernel)
    assert body.count("grid.sync()") == syncs
    assert body.count("grid_total_batch<") == folds
    assert "__ldcg" not in body
    chunks = re.search(r"using (\w+) = GkPellChunks<GK_CG_THREADS>;", text).group(1)
    assert f"n > 0x7fffffffLL - {chunks}::kChunk" in text
    assert ops_pc.CHUNK_ROWS == CHUNK == THREADS * ROWS


def diag_pell(n, value):
    """The JAX package's S = 8 Pell of value * I, carried across."""
    rows = np.arange(n)
    JP = JPell.from_csr(JCsr.from_matrix_data(JMatrixData.from_coo(
        (n, n), rows, rows, np.full(n, value, F32))))
    return interop.pell_from_arrays(np.asarray(JP.values), np.asarray(JP.qidx),
                                    np.asarray(JP.bases), np.asarray(JP.tile_of_step),
                                    shape=JP.shape, n_steps=JP.n_steps, nnz=JP.nnz, G=JP.G,
                                    NT=JP.NT, NP=JP.NP, S=JP.S, device="cpu")


class Dots:
    """Per-block float64 partials in the chunk order, and their folds."""

    def __init__(self, n, blocks):
        self.n, self.blocks = n, blocks
        self.chunks = -(-n // CHUNK)
        self.valid = (np.arange(self.chunks * CHUNK) < n).reshape(self.chunks, ROWS, THREADS)
        self.folds = 0

    def partials(self, a, b):
        """A block's partial of sum a b: its threads' sums in chunk and row
        order, folded over the block."""
        prod = np.zeros(self.chunks * CHUNK)
        prod[:self.n] = a.astype(F64) * b.astype(F64)
        prod = prod.reshape(self.chunks, ROWS, THREADS)
        part = np.zeros(self.blocks)
        for blk in range(self.blocks):
            acc = np.zeros(THREADS)
            for c in range(blk, self.chunks, self.blocks):
                for q in range(ROWS):
                    acc = np.where(self.valid[c, q], acc + prod[c, q], acc)
            part[blk] = block_sum(acc)
        return part

    def fold(self, *parts):
        """One fold after a barrier: each value's partials in block order,
        rounded to float32."""
        self.folds += 1
        out = []
        for part in parts:
            v = np.zeros(THREADS)
            v[:self.blocks] = 0.0 + part
            out.append(F32(block_sum(v)))
        return out


def sdiv(num, den):
    return num / den if den != 0 else F32(0)


@np.errstate(invalid="ignore", over="ignore", divide="ignore")
def bicgstab_schedule(A, r0, x0, minv, tol, max_iters, implicit, blocks):
    """K19's five passes in numpy.  Returns (x, r, iterations, monitor, the
    iterations that took the half step, folds)."""
    n = A.shape[0]
    spmv, dots = SlotSum(A), Dots(n, blocks)
    M = (lambda a: a) if minv is None else (lambda a: minv * a)
    x, r, rr = x0.copy(), r0.copy(), r0.copy()
    v, p = np.zeros(n, F32), np.zeros(n, F32)
    (rho_new,) = dots.fold(dots.partials(r, r))
    rho_old = alpha = omega = F32(1)
    it, mon, halves = 0, F32(np.inf), []
    while it < max_iters and not (mon <= tol):
        beta = sdiv(rho_new * alpha, rho_old * omega)
        p = r + beta * (p - omega * v)  # pass 1
        v = spmv(M(p))  # pass 2
        (rv,) = dots.fold(dots.partials(rr, v))
        alpha_new = sdiv(rho_new, rv)
        s = r - alpha_new * v  # pass 3: s.s waits for pass 4's fold
        part_ss = dots.partials(s, s)
        t = spmv(M(s))  # pass 4
        ss, ts, tt = dots.fold(part_ss, dots.partials(t, s), dots.partials(t, t))
        half = (abs(rho_new) if implicit else ss) <= tol
        omega_new = F32(0) if half else sdiv(ts, tt)
        x = x + alpha_new * M(p) + omega_new * M(s)  # pass 5
        r = s - omega_new * t
        rho_next, rr_new = dots.fold(dots.partials(rr, r), dots.partials(r, r))
        mon = abs(rho_new) if implicit else rr_new
        if half:
            halves.append(it)
        rho_old, alpha = rho_new, alpha_new
        omega = F32(1) if half else omega_new
        rho_new = rho_next
        it += 1
    return x, r, it, mon, halves, dots.folds


@np.errstate(invalid="ignore", over="ignore", divide="ignore")
def cgs_schedule(A, r0, x0, minv, tol, max_iters, implicit, blocks):
    """K20's four passes in numpy.  Returns (x, r, iterations, monitor, no
    half steps, folds)."""
    n = A.shape[0]
    spmv, dots = SlotSum(A), Dots(n, blocks)
    M = (lambda a: a) if minv is None else (lambda a: minv * a)
    x, r, rr = x0.copy(), r0.copy(), r0.copy()
    q, p = np.zeros(n, F32), np.zeros(n, F32)
    (rho_new,) = dots.fold(dots.partials(r, r))
    rho_old = F32(1)
    it, mon = 0, F32(np.inf)
    while it < max_iters and not (mon <= tol):
        beta = sdiv(rho_new, rho_old)
        u = r + beta * q  # pass 1
        p = u + beta * (q + beta * p)
        v = spmv(M(p))  # pass 2
        (sigma,) = dots.fold(dots.partials(rr, v))
        alpha = sdiv(rho_new, sigma)
        q = u - alpha * v  # pass 3
        mw = M(u + q)
        t = spmv(mw)  # pass 4
        x = x + alpha * mw
        r = r - alpha * t
        rho_next, rr_new = dots.fold(dots.partials(rr, r), dots.partials(r, r))
        mon = abs(rho_new) if implicit else rr_new
        rho_old, rho_new = rho_new, rho_next
        it += 1
    return x, r, it, mon, [], dots.folds


SCHEDULES = {"bicgstab": (bicgstab_schedule, ops_pc.pell_bicgstab_solve_reference, 3),
             "cgs": (cgs_schedule, ops_pc.pell_cgs_solve_reference, 2)}

CASES = {
    # name: (Pell: nside or "2I", S, G, q dtype, bf16 values, Jacobi, implicit, cap, NaN in b,
    #        blocks)
    "S8": (13, 8, "auto", np.int8, False, False, False, 500, False, 2),
    "S8_G4_jacobi": (13, 8, 4, np.int8, False, True, False, 500, False, 2),
    "S1_G4_jacobi": (13, 1, 4, np.int8, False, True, False, 500, False, 3),
    "S16_int32_bf16_implicit": (13, 16, "auto", np.int32, True, False, True, 500, False, 2),
    "S8_bf16_jacobi_several_chunks": (20, 8, "auto", np.int8, True, True, False, 500, False, 3),
    "S8_max_iters_0": (13, 8, "auto", np.int8, False, True, False, 0, False, 2),
    "S8_max_iters_1": (13, 8, "auto", np.int8, False, False, False, 1, False, 2),
    "S8_nan": (13, 8, "auto", np.int8, False, True, False, 7, True, 2),
    "2I_half_step": ("2I", 8, "auto", np.int8, False, False, False, 50, False, 3),
    "2I_half_step_jacobi": ("2I", 8, "auto", np.int8, False, True, False, 50, False, 3),
}


@pytest.mark.parametrize("solver", sorted(SCHEDULES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_chunk_schedule_matches_plain_version(solver, case):
    nside, S, G, q, bf16, jacobi, implicit, cap, nan, blocks = CASES[case]
    A = diag_pell(5000, 2.0) if nside == "2I" else jax_pell(nside, S, G, q, bf16)
    n = A.shape[0]
    assert n % CHUNK != 0 and A.S == S and A.qidx.dtype == torch.from_numpy(np.zeros(1, q)).dtype
    blk, thr = owners(n, blocks)
    assert blk.max() == min(blocks, -(-n // CHUNK)) - 1 and thr.max() == THREADS - 1
    if "several_chunks" in case:
        assert -(-n // CHUNK) > 2 * blocks
    rng = np.random.default_rng(n + S)
    b = rng.uniform(0.5, 1.5, n).astype(F32)
    if nan:
        b[n // 2] = np.nan
    tol = F32((1e-6 * np.linalg.norm(np.nan_to_num(b).astype(F64))) ** 2)
    minv = (1.0 / A.extract_diagonal().values.float()).numpy() if jacobi else None
    schedule, reference, folds = SCHEDULES[solver]
    x0 = np.zeros(n, F32)
    x, r, it, mon, halves, n_folds = schedule(A, b, x0, minv, tol, cap, implicit, blocks)
    t = torch.from_numpy
    want = reference(A, t(b), t(x0), None if minv is None else t(minv), tol_sq_eff=float(tol),
                     max_iters=cap, use_implicit=implicit)
    assert it == int(want[2]) and n_folds == 1 + folds * it
    assert _bits(x, want[0].numpy()) and _bits(r, want[1].numpy())
    assert _bits(mon, want[3].numpy())
    if nan:
        assert it == cap and np.isnan(mon)
    elif cap <= 1:
        assert it == cap and not mon <= tol
        if cap == 0:
            assert _bits(x, x0) and np.isinf(mon)
    elif nside == "2I":
        assert it == 1 and mon <= tol
        if solver == "bicgstab":
            assert halves == [0] and not np.any(r)  # omega = 0: r = s = 0
    else:
        assert mon <= tol and 0 < it < cap


@pytest.mark.parametrize("solver", ["bicgstab", "cgs"])
def test_route_declines_beyond_chunk_rows(monkeypatch, solver):
    """K19's and K20's rows are 32-bit: where the kernels' guard would
    refuse a Pell, the route declines and the streaming loop runs.  The
    limit is lowered here so that a small Pell lies beyond it."""
    A = jax_pell(8, 8, "auto", np.int8, False)
    n = A.shape[0]
    b = torch.from_numpy(np.random.default_rng(3).uniform(0.5, 1.5, (n, 1)).astype(F32))
    crit = [stop.Iteration(max_iters=100), stop.ResidualNorm(tolerance=1e-5)]
    jac = gt.Jacobi.build(max_block_size=1)
    factory = gt.Bicgstab if solver == "bicgstab" else gt.Cgs
    s = factory.build(criteria=crit, preconditioner=jac).generate(A)
    kernel = f"pell_{solver}_fused"
    seen = []
    real = getattr(solver_bicgstab, kernel)
    monkeypatch.setattr(solver_bicgstab, kernel, lambda *a, **k: seen.append(1) or real(*a, **k))
    x_fused, _ = s.solve(b)
    assert seen == [1]
    monkeypatch.setattr(ops_pc, "MAX_CHUNKED_ROWS", n - 1)
    x_stream, info = s.solve(b)
    assert seen == [1] and bool(info.converged.all())
    assert float((x_stream - x_fused).abs().max()) <= 1e-3 * float(x_fused.abs().max())
