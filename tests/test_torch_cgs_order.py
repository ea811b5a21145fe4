"""The schedule K13 (``cgs_fused``) keeps, held on the CPU against the
plain version its CUDA kernel is checked against.

The kernel (``csrc/cgs_fused.cu`` ``cgs_fused_kernel``) runs CGS on A M, a
diagonal M folded into the diagonals (``solver/_fused_gate.fold_minv``),
with minv applied only in the x update.  Each row is one thread's in every
pass (grid-stride: row i is thread i mod (blocks 256)'s; a thread takes
``GK_CGS_ROWS`` of its rows a trip, their loads issued together, in the
order of a one-row loop), three passes and three grid barriers an
iteration:

1. u = r + beta q; p = u + beta (q + beta p);
2. v = (A M) p (plain gathers after the barrier); partial <rr, v>; fold ->
   alpha;
3. t = (A M) w, w_j = u_j + (u_j - alpha v_j) formed at every gathered
   column from u and v (plain gathers); q = u - alpha v on the own rows;
   x += alpha (M w); r -= alpha t; partials <rr, r> and r.r; fold -> the
   next rho and the monitor.

A dot is a float64 sum: a thread adds its rows' products in row order, a
block folds its threads (``coop.cuh`` ``block_sum``), and every block folds
the partials in block order; the total rounds to float32.  Semantics: rr =
r0, rho = <r0, r0>, p = q = 0, rho_old = 1, the loop runs while it <
max_iters and not (mon <= tol) (a NaN monitor keeps iterating), exact mode
monitors r.r after the update, implicit mode |rho| from before it, zero
denominators give 0.

An independent numpy loop of that schedule, float32 vectors and float64
partials, must equal ``ops/cgs.cgs_solve_reference`` bit for bit: x, r,
the iteration count and the monitor, on Dias the JAX package builds,
carried across by ``interop`` (the plain version is held against the JAX
kernel ``cgs_vmem_solve`` in Pallas interpret mode by
``tests/test_torch_cgs_bicg.py``).  Cases: float32 and bfloat16 diagonals,
offsets past a block's rows, the Identity and Jacobi (minv folded into A
and applied in the x update), exact and implicit monitors, ``max_iters`` 0
and 1 from a seeded x0, a NaN in b.  The kernel's rows a trip, barriers,
folds and launch bounds are read from its source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu_torch.ops import cgs as ops_cgs
from ginkgo_tpu_torch.solver._fused_gate import fold_minv
from tests.test_torch_bicg_order import fold, sdiv
from tests.test_torch_ir_order import dia_operator, dia_product, stride_partials
from tests.test_torch_pell_bicgstab_cgs_order import kernel_body
from tests.test_torch_pell_cg_order import F32, F64, _bits

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
    iteration and the init's, plain gathers (pass 2 through gk_dia_rows,
    pass 3 forming w at its gathered columns), R rows a trip, and launch
    bounds that hold the kernel's registers to its blocks an SM."""
    assert int(re.search(r"#define GK_CGS_ROWS (\d+)", _SOURCE).group(1)) >= 1
    assert int(re.search(r"#define GK_CGS_MIN_BLOCKS (\d+)", _SOURCE).group(1)) >= 1
    assert re.search(r"__launch_bounds__\(GK_CG_THREADS, GK_CGS_MIN_BLOCKS\)\s+"
                     r"cgs_fused_kernel\(", _SOURCE)
    body = kernel_body(_SOURCE, "cgs_fused_kernel")
    assert body.count("grid.sync()") == 4
    assert body.count("grid_total_batch<") == 3
    assert "__ldcg" not in body
    assert body.count("gk_dia_rows<R>(") == 1
    assert body.count("uj[k] + (uj[k] - alpha * vj[k])") == 1
    assert body.count("GkStrideRows<R> rows(") == 3


@np.errstate(invalid="ignore", over="ignore")
def gathered_w_product(D, offsets, u, v, alpha):
    """Pass 3's t = (A M) w, each row summed as gk_dia_row sums it, with
    w_j = u_j + (u_j - alpha v_j) formed at each gathered column."""
    n = u.shape[0]
    i = np.arange(n)
    acc = np.zeros(n, F32)
    for d, off in enumerate(offsets):
        ok = (i + off >= 0) & (i + off < n)
        uj, vj = u[i[ok] + off], v[i[ok] + off]
        acc[ok] = acc[ok] + D[d, ok] * (uj + (uj - alpha * vj))
    return acc


@np.errstate(invalid="ignore", over="ignore", divide="ignore")
def cgs_schedule(D, offsets, r0, x0, minv, tol, max_iters, implicit, blocks):
    """K13's three passes in numpy, D the diagonals of A M.  Returns (x,
    r, iterations, monitor)."""

    def dots(*pairs):
        return fold(*(stride_partials(a.astype(F64) * b.astype(F64), blocks) for a, b in pairs))

    x, r, rr = x0.copy(), r0.copy(), r0.copy()
    q, p = np.zeros_like(r0), np.zeros_like(r0)
    (rho_new,) = dots((r0, r0))
    rho_old, mon, it = F32(1), F32(np.inf), 0
    while it < max_iters and not (mon <= tol):
        beta = sdiv(rho_new, rho_old)
        u = r + beta * q  # pass 1
        p = u + beta * (q + beta * p)
        v = dia_product(D, offsets, p)  # pass 2
        (sigma,) = dots((rr, v))
        alpha = sdiv(rho_new, sigma)
        t = gathered_w_product(D, offsets, u, v, alpha)  # pass 3
        q = u - alpha * v
        w = u + q
        x = x + alpha * (w if minv is None else minv * w)
        r = r - alpha * t
        rho_next, rr_new = dots((rr, r), (r, r))
        mon = abs(rho_new) if implicit else rr_new
        rho_old, rho_new = rho_new, rho_next
        it += 1
    return x, r, it, mon


CASES = {
    # name: (operator, storage, Jacobi, implicit, cap, NaN in b, seeded x0, blocks)
    "convdiff32_identity": ("convdiff32", "f32", False, False, 400, False, False, 2),
    "convdiff32_jacobi": ("convdiff32", "f32", True, False, 400, False, False, 3),
    "convdiff32_identity_implicit": ("convdiff32", "f32", False, True, 400, False, False, 2),
    "convdiff32_jacobi_implicit_bf16": ("convdiff32", "bf16", True, True, 400, False, False, 2),
    "convdiff32_bf16": ("convdiff32", "bf16", False, False, 400, False, False, 3),
    "wide_offsets_identity": ("wide", "f32", False, False, 400, False, False, 2),
    "wide_offsets_jacobi_bf16": ("wide", "bf16", True, False, 400, False, False, 3),
    "diagonal_identity_nd1": ("diagonal", "f32", False, False, 400, False, False, 2),
    "max_iters_0": ("convdiff32", "f32", True, False, 0, False, True, 2),
    "max_iters_1": ("wide", "f32", False, False, 1, False, True, 2),
    "nan_monitor": ("convdiff32", "f32", False, False, 7, True, False, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_pass_schedule_matches_plain_version(case):
    name, storage, jacobi, implicit, cap, nan, seeded, blocks = CASES[case]
    A, DA, offA = dia_operator(name, storage)
    n = A.shape[0]
    rng = np.random.default_rng(n + 13)
    b = rng.uniform(0.5, 1.5, n).astype(F32)
    if nan:
        b[n // 2] = np.nan
    x0 = (rng.uniform(-0.1, 0.1, n) if seeded else np.zeros(n)).astype(F32)
    r0 = b - dia_product(DA, offA, x0)
    minv = (1.0 / A.extract_diagonal().values.float()) if jacobi else None
    diags = A.diags if minv is None else fold_minv(A, minv)
    assert diags.dtype == A.diags.dtype
    D = diags.float().numpy()
    mv = None if minv is None else minv.numpy()
    tol = F32((1e-5 * np.linalg.norm(np.nan_to_num(b).astype(F64))) ** 2)
    x, r, it, mon = cgs_schedule(D, offA, r0, x0, mv, tol, cap, implicit, blocks)
    t = torch.from_numpy
    want = ops_cgs.cgs_solve_reference(diags, A.offsets, t(r0), t(x0), minv,
                                       tol_sq_eff=float(tol), max_iters=cap,
                                       use_implicit=implicit)
    assert it == int(want[2])
    assert _bits(x, want[0].numpy()) and _bits(r, want[1].numpy())
    assert _bits(mon, want[3].numpy()) and bool(mon <= tol) == bool(want[4])
    if nan:
        assert it == cap and np.isnan(mon)
    elif cap <= 1:
        assert it == cap
        if cap == 0:
            assert _bits(x, x0) and np.isinf(mon)
    else:
        assert mon <= tol and 1 < it < cap
