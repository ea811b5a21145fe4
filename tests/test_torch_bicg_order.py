"""The schedule K14 (``bicg_fused``) keeps, held on the CPU against the
plain version its CUDA kernel is checked against.

The kernel (``csrc/cgs_fused.cu`` ``bicg_fused_kernel``) takes one row a
thread, grid-stride (row i is thread i mod (blocks 256)'s in every pass),
and runs three passes and three grid barriers an iteration:

1. p = M r + beta p, p2 = M r2 + beta p2; x += alpha p of the previous
   iteration, deferred to this pass, which reads p's own rows anyway;
2. q = A p, q2 = A^H p2 (plain gathers after the barrier); partial
   <p2, q>; fold -> alpha;
3. r -= alpha q, r2 -= alpha q2; partials <r2, M r> and r.r; fold -> the
   next rho and the monitor;

and after the loop the last iteration's x += alpha p on the own rows.  A
dot is a float64 sum: a thread adds its rows' products in row order, a
block folds its threads (``coop.cuh`` ``block_sum``), and every block folds
the partials in block order; the total rounds to float32.  Semantics: r2 =
r0, rho = <r0, M r0>, p = p2 = 0, rho_old = 1, the loop runs while it <
max_iters and not (mon <= tol) (a NaN monitor keeps iterating), exact mode
monitors r.r after the update, implicit mode |rho| from before it, zero
denominators give 0.

An independent numpy loop of that schedule, float32 vectors and float64
partials, must equal ``ops/cgs.bicg_solve_reference`` bit for bit: x, r,
the iteration count and the monitor, on Dias the JAX package builds,
carried across by ``interop`` (the plain version is held against the JAX
kernel ``bicg_vmem_solve`` in Pallas interpret mode by
``tests/test_torch_cgs_bicg.py``).  Cases: float32 and bfloat16 diagonals,
offsets past a block's rows, the Identity and Jacobi, exact and implicit
monitors, ``max_iters`` 0 and 1, a NaN in b.  The kernel's barriers and
folds are read from its source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu_torch.ops import cgs as ops_cgs
from tests.test_torch_ir_order import dia_operator, dia_product, stride_partials
from tests.test_torch_pell_bicgstab_cgs_order import kernel_body
from tests.test_torch_pell_cg_order import F32, F64, THREADS, _bits, block_sum

_SOURCE = (Path(gt.__file__).parent / "csrc" / "cgs_fused.cu").read_text()


@pytest.fixture(autouse=True)
def _one_thread():
    """The loops run many small tensor ops: one intra-op thread each, so
    that they do not spin against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_kernel_keeps_the_declared_schedule():
    """Three grid barriers an iteration and the init's, two folds an
    iteration and the init's, plain gathers, R rows a trip."""
    assert int(re.search(r"#define GK_BICG_ROWS (\d+)", _SOURCE).group(1)) >= 1
    body = kernel_body(_SOURCE, "bicg_fused_kernel")
    assert body.count("grid.sync()") == 4
    assert body.count("grid_total_batch<") == 3
    assert "__ldcg" not in body
    assert body.count("gk_dia_rows<R>(") == 2


def fold(*parts):
    """One fold after a barrier: each value's partials in block order,
    rounded to float32."""
    out = []
    for part in parts:
        v = np.zeros(THREADS)
        v[:len(part)] = 0.0 + np.asarray(part)
        out.append(F32(block_sum(v)))
    return out


def sdiv(num, den):
    return num / den if den != 0 else F32(0)


@np.errstate(invalid="ignore", over="ignore", divide="ignore")
def bicg_schedule(DA, offA, DT, offT, r0, x0, minv, tol, max_iters, implicit, blocks):
    """K14's three passes in numpy.  Returns (x, r, iterations, monitor)."""
    M = (lambda a: a) if minv is None else (lambda a: minv * a)

    def dots(*pairs):
        return fold(*(stride_partials(a.astype(F64) * b.astype(F64), blocks) for a, b in pairs))

    x, r, r2 = x0.copy(), r0.copy(), r0.copy()
    p, p2 = np.zeros_like(r0), np.zeros_like(r0)
    (rho_new,) = dots((r0, M(r0)))
    rho_old, alpha, mon, it = F32(1), F32(0), F32(np.inf), 0
    while it < max_iters and not (mon <= tol):
        beta = sdiv(rho_new, rho_old)
        # pass 1, with the previous iteration's x update
        if it > 0:
            x = x + alpha * p
        p = M(r) + beta * p
        p2 = M(r2) + beta * p2
        # pass 2
        q = dia_product(DA, offA, p)
        q2 = dia_product(DT, offT, p2)
        (pq,) = dots((p2, q))
        alpha = sdiv(rho_new, pq)
        # pass 3
        r = r - alpha * q
        r2 = r2 - alpha * q2
        rho_next, rr = dots((r2, M(r)), (r, r))
        mon = abs(rho_new) if implicit else rr
        rho_old, rho_new = rho_new, rho_next
        it += 1
    if it > 0:
        x = x + alpha * p
    return x, r, it, mon


CASES = {
    # name: (operator, storage, Jacobi, implicit, cap, NaN in b, blocks)
    "convdiff32_identity": ("convdiff32", "f32", False, False, 400, False, 2),
    "convdiff32_jacobi": ("convdiff32", "f32", True, False, 400, False, 3),
    "convdiff32_identity_implicit": ("convdiff32", "f32", False, True, 400, False, 2),
    "convdiff32_jacobi_implicit_bf16": ("convdiff32", "bf16", True, True, 400, False, 2),
    "convdiff32_bf16": ("convdiff32", "bf16", False, False, 400, False, 3),
    "wide_offsets_identity": ("wide", "f32", False, False, 400, False, 2),
    "wide_offsets_jacobi_bf16": ("wide", "bf16", True, False, 400, False, 3),
    "diagonal_identity_nd1": ("diagonal", "f32", False, False, 400, False, 2),
    "max_iters_0": ("convdiff32", "f32", True, False, 0, False, 2),
    "max_iters_1": ("wide", "f32", False, False, 1, False, 2),
    "nan_monitor": ("convdiff32", "f32", False, False, 7, True, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_pass_schedule_matches_plain_version(case):
    name, storage, jacobi, implicit, cap, nan, blocks = CASES[case]
    A, DA, offA = dia_operator(name, storage)
    At = A.conj_transpose()
    DT, offT = At.diags.float().numpy(), list(At.offsets)
    n = A.shape[0]
    rng = np.random.default_rng(n + 11)
    b = rng.uniform(0.5, 1.5, n).astype(F32)
    if nan:
        b[n // 2] = np.nan
    x0 = rng.uniform(-0.1, 0.1, n).astype(F32)
    r0 = b - dia_product(DA, offA, x0)
    minv = (1.0 / A.extract_diagonal().values.float()).numpy() if jacobi else None
    tol = F32((1e-5 * np.linalg.norm(np.nan_to_num(b).astype(F64))) ** 2)
    x, r, it, mon = bicg_schedule(DA, offA, DT, offT, r0, x0, minv, tol, cap, implicit, blocks)
    t = torch.from_numpy
    want = ops_cgs.bicg_solve_reference(A.diags, A.offsets, At.diags, At.offsets, t(r0), t(x0),
                                        None if minv is None else t(minv), tol_sq_eff=float(tol),
                                        max_iters=cap, use_implicit=implicit)
    assert it == int(want[2])
    assert _bits(x, want[0].numpy()) and _bits(r, want[1].numpy())
    assert _bits(mon, want[3].numpy()) and bool(mon <= tol) == bool(want[4])
    if nan:
        assert it == cap and np.isnan(mon)
    elif cap <= 1:
        assert it == cap
        if cap == 0:
            assert _bits(x, x0)
    else:
        assert mon <= tol and 1 < it < cap
