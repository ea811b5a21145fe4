"""Gates for the whole-solve fused Krylov kernels on the GPU.

Counterpart of ``ginkgo_tpu/solver/_fused_gate.py``.  The gates look only
at the solve's structure, never at the device, so the CPU (where each
kernel's plain version runs) and the card route a solve the same way.
Every fused route needs:

- float32 right-hand sides, one column (2 to 8 for the k-RHS kernel K4m);
- an Identity, Diagonal or scalar-Jacobi preconditioner (block Jacobi
  streams);
- a criterion that ``analyze_simple_residual`` accepts;
- no history tracking.

``prepare_fused_dia`` adds a square ``Dia`` with 1 to 64 diagonals stored
as float32 or bfloat16 (kernels K4, K4m, K12-K17; ``fused_transpose_ok``
adds BiCG's A^H for K14); ``prepare_fused_pell`` a square ``Pell`` with
float32 or bfloat16 values and S = 8, the layout both packages' fused
kernels are routed to (K7, K18-K21), for one column.  ``fold_minv`` builds
the A M operator that the fused BiCGSTAB and CGS kernels run on a Dia;
on a Pell they apply M explicitly.  ``prepare_fused_dia_ilu`` takes an
``IluPreconditioner`` of two 'sweeps' triangular solvers on Dia triangles
in place of the diagonal one, for one column on such a Dia (kernels K23
and K24, which apply M inside the solve); ``prepare_fused_mg`` a
``Multigrid`` whose hierarchy the fused multigrid kernels take (K26 and
K28, one cycle as M inside the solve).

The TPU gates' VMEM/SMEM budgets and environment flags have no
counterpart: the GPU kernels keep their state in device memory, so no
size limit applies.
"""

from __future__ import annotations

import torch

from ..matrix.dia import Dia
from ..matrix.diagonal import Diagonal, Identity
from ..matrix.pell import Pell
from ..ops.cg import FUSED_DIAG_DTYPES
from ..ops.dia import MAX_DIAGS
from ..ops.pell import FUSED_VALUE_DTYPES
from ..preconditioner.jacobi import Jacobi
from ..stop.criterion import analyze_simple_residual
from .multigrid import Multigrid
from .solver_base import SolveInfo, extract_max_iters, norm2
from .triangular import TriangularSolver

#: the slot layout the fused Pell kernel is routed to
FUSED_PELL_S = 8
#: most sweeps per triangle that the ILU whole-solve kernels are routed
#: (ginkgo_tpu solver/_fused_gate.py:146)
_MAX_FUSED_TRI_SWEEPS = 8


def _common_checks(solver, b, max_cols):
    """Checks that neither the operator nor the preconditioner enters (the
    JAX package's ``_common_checks``, _fused_gate.py:35); None or a partial
    ctx."""
    if getattr(solver, "track_history", False):
        return None
    if not 1 <= b.shape[1] <= max_cols or b.dtype != torch.float32:
        return None
    simple = analyze_simple_residual(solver.criterion)
    if simple is None:
        return None
    tol, baseline, implicit, has_res = simple
    return {
        "A": solver.A,
        "tol": tol,
        "baseline": baseline,
        "implicit": implicit,
        "has_res": has_res,
        "cap": extract_max_iters(solver.criterion),
    }


def _prepare_common(solver, b, max_cols):
    """:func:`_common_checks` and a diagonal preconditioner; None or a
    partial ctx with its inverse diagonal (None for the Identity)."""
    M = solver.preconditioner
    if isinstance(M, Identity):
        minv = None
    elif isinstance(M, Diagonal):
        minv = M.values
    elif isinstance(M, Jacobi) and M.max_block_size == 1 and M.inv_diag is not None:
        minv = M.inv_diag
    else:
        return None
    ctx = _common_checks(solver, b, max_cols)
    if ctx is not None:
        ctx["minv"] = minv
    return ctx


def prepare_fused_dia(solver, b, max_cols=1):
    """None (another route runs) or a dict with what K4 (one column) or
    K4m (``max_cols`` up to 8) needs: A, minv, tol/baseline/implicit/
    has_res, cap."""
    A = solver.A
    if not isinstance(A, Dia) or A.shape[0] != A.shape[1]:
        return None
    if not 1 <= A.num_diags <= MAX_DIAGS or A.dtype not in FUSED_DIAG_DTYPES:
        return None
    return _prepare_common(solver, b, max_cols)


def fused_transpose_ok(A, At):
    """BiCG's fused kernel K14 also takes At (A^H): a square ``Dia`` with
    1 to 64 float32/bfloat16 diagonals and A's shape (ginkgo_tpu
    solver/bicgstab.py:615-628)."""
    return (isinstance(At, Dia) and At.shape == A.shape
            and 1 <= At.num_diags <= MAX_DIAGS and At.dtype in FUSED_DIAG_DTYPES)


def fold_minv(A, minv):
    """The diagonals of A M for a diagonal M = diag(minv): diagonal d scaled
    by minv at column i + off_d (0 outside the columns), in float32, then
    rounded back to ``A.diags.dtype``, so bfloat16 diagonals stay bfloat16
    (ginkgo_tpu solver/bicgstab.py:72-83).  The fused BiCGSTAB and CGS
    kernels run on it; the solver and the tests both call this one
    function, since parity depends on that rounding."""
    n = A.shape[1]
    mv = minv.to(torch.float32)
    out = torch.empty_like(A.diags)
    for d, off in enumerate(A.offsets):
        shifted = torch.zeros(A.diags.shape[1], dtype=torch.float32, device=A.diags.device)
        lo, hi = max(0, -off), min(A.diags.shape[1], n - off)
        if hi > lo:
            shifted[lo:hi] = mv[lo + off:hi + off]
        out[d] = (A.diags[d].to(torch.float32) * shifted).to(A.diags.dtype)
    return out


def prepare_fused_pell(solver, b):
    """None or the ctx a whole-solve Pell kernel (K7, K18-K21) needs, for
    one column on a square Pell."""
    A = solver.A
    if not isinstance(A, Pell) or A.shape[0] != A.shape[1]:
        return None
    if A.dtype not in FUSED_VALUE_DTYPES or A.values.shape[0] == 0:
        return None
    if A.S != FUSED_PELL_S:
        return None
    return _prepare_common(solver, b, 1)


def _fusable_dia(op, n):
    """An n x n Dia with 1 to 64 float32/bfloat16 diagonals."""
    return (isinstance(op, Dia) and op.shape == (n, n) and 1 <= op.num_diags <= MAX_DIAGS
            and op.dtype in FUSED_DIAG_DTYPES)


def prepare_fused_dia_ilu(solver, b):
    """None or the ctx of the ILU-preconditioned whole-solve kernels K23
    (CG) and K24 (BiCGSTAB): a square Dia operator with 1 to 64
    float32/bfloat16 diagonals, an ``IluPreconditioner`` applied forward
    (not ``reverse_apply``) whose two ``TriangularSolver``s run the 'sweeps'
    algorithm with 0 to ``_MAX_FUSED_TRI_SWEEPS`` sweeps on such Dia strict
    triangles of A's size, and :func:`_common_checks` for one column
    (ginkgo_tpu solver/_fused_gate.py:149-201).  The ctx adds l_solver and
    u_solver."""
    # imported here: preconditioner/ilu.py imports the solver package
    from ..preconditioner.ilu import IluPreconditioner

    A = solver.A
    n = A.shape[0]
    if not _fusable_dia(A, n):
        return None
    M = solver.preconditioner
    if not isinstance(M, IluPreconditioner) or M.reverse_apply:
        return None
    for t in (M.l_solver, M.u_solver):
        if not isinstance(t, TriangularSolver) or t.algorithm != "sweeps":
            return None
        if not (0 <= t.sweeps <= _MAX_FUSED_TRI_SWEEPS and _fusable_dia(t.off_csr, n)):
            return None
    ctx = _common_checks(solver, b, 1)
    if ctx is not None:
        ctx.update(l_solver=M.l_solver, u_solver=M.u_solver)
    return ctx


def solve_fused_ilu(ctx, b, x0, run):
    """(x, SolveInfo) of an ILU whole-solve kernel ``run`` (K23 or K24) on
    the ctx of :func:`prepare_fused_dia_ilu`: the triangles' inverse
    diagonals 1 / diag rounded to float32, as the JAX package's frames."""
    A, lt, ut = ctx["A"], ctx["l_solver"], ctx["u_solver"]
    r0 = b - A.apply(x0)
    tol = tol_sq_eff(ctx, b, r0)
    invdl = (1.0 / lt.diag).to(torch.float32).contiguous()
    invdu = (1.0 / ut.diag).to(torch.float32).contiguous()
    x, _r, it, mon, conv = run(A, lt.off_csr, ut.off_csr, invdl, invdu, r0[:, 0].contiguous(),
                               x0[:, 0].contiguous(), sweeps_l=lt.sweeps, sweeps_u=ut.sweeps,
                               tol_sq_eff=tol, max_iters=ctx["cap"],
                               use_implicit=ctx["implicit"])
    return x[:, None], fused_info(ctx, b, it, mon[None], conv[None])


def prepare_fused_mg(solver, b):
    """None or the ctx of the multigrid-preconditioned whole-solve kernels
    K26 (CG/FCG) and K28 (BiCGSTAB): a square Dia operator with 1 to 64
    float32/bfloat16 diagonals, a ``Multigrid`` preconditioner whose
    hierarchy passes its fused gate (``Multigrid._fused_hierarchy``) with
    level 0 of A's rows, and :func:`_common_checks` for one column
    (ginkgo_tpu solver/cg.py:289-320, solver/bicgstab.py:219-250).  The ctx
    adds the hierarchy."""
    A, M = solver.A, solver.preconditioner
    if not isinstance(M, Multigrid) or not _fusable_dia(A, A.shape[0]):
        return None
    ctx = _common_checks(solver, b, 1)
    if ctx is None:
        return None
    h = M._fused_hierarchy()
    if h is None or h.sizes[0] != A.shape[0]:
        return None
    ctx["hierarchy"] = h
    return ctx


def solve_fused_mg(ctx, b, x0, run, **kw):
    """(x, SolveInfo) of a multigrid whole-solve kernel ``run`` (K26 or
    K28) on the ctx of :func:`prepare_fused_mg`."""
    A = ctx["A"]
    r0 = b - A.apply(x0)
    tol = tol_sq_eff(ctx, b, r0)
    x, _r, it, mon, conv = run(A, ctx["hierarchy"], r0[:, 0].contiguous(),
                               x0[:, 0].contiguous(), tol_sq_eff=tol, max_iters=ctx["cap"],
                               use_implicit=ctx["implicit"], **kw)
    return x[:, None], fused_info(ctx, b, it, mon[None], conv[None])


def fused_info(ctx, b, it, mon, conv):
    """The SolveInfo of a whole-solve kernel's (k,) monitor and converged
    flags: the residual norm where an exact-residual criterion is tracked
    (else inf, the streaming loop's fill, solver_base._check_stop), and
    converged only under a residual criterion."""
    if ctx["has_res"] and not ctx["implicit"]:
        rn = torch.sqrt(mon).to(b.dtype)
    else:
        rn = torch.full(mon.shape, float("inf"), dtype=b.dtype, device=b.device)
    conv_mask = conv if ctx["has_res"] else torch.zeros_like(conv)
    return SolveInfo(iterations=it, residual_norm=rn, converged=conv_mask)


def kernel_inputs(ctx, b, x0):
    """What every whole-solve kernel takes besides the operator: r0 = b - A
    x0, the inverse diagonal as contiguous float32 (or None) and the
    per-column squared thresholds (:func:`tol_sq_eff`)."""
    r0 = b - ctx["A"].apply(x0)
    minv = ctx["minv"]
    if minv is not None:
        minv = minv.to(torch.float32).contiguous()
    return r0, minv, tol_sq_eff(ctx, b, r0)


def tol_sq_eff(ctx, b, r0):
    """Per-column squared absolute stop thresholds, (k,) float32 on the
    device (negative: no residual criterion, run to the cap)."""
    k, dev = b.shape[1], b.device
    if not ctx["has_res"]:
        return torch.full((k,), -1.0, dtype=torch.float32, device=dev)
    if ctx["baseline"] == "absolute":
        base = torch.ones(k, dtype=torch.float32, device=dev)
    elif ctx["baseline"] == "initial_resnorm":
        base = norm2(r0).to(torch.float32)
    else:
        base = norm2(b).to(torch.float32)
    return (torch.full((k,), ctx["tol"], dtype=torch.float32, device=dev) * base) ** 2
