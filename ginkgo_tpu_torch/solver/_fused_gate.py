"""Gate for the whole-solve fused CG kernel on the GPU.

Counterpart of ``ginkgo_tpu/solver/_fused_gate.py``.  It looks only at the
solve's structure, never at the device, so the CPU (where the kernel's
plain version runs) and the card route a solve the same way.  A solve is
accepted when all of these hold:

- the operator is a square ``Dia`` with 1 to 64 diagonals stored as
  float32 or bfloat16;
- the right-hand side is a single float32 column;
- the preconditioner is Identity, Diagonal or scalar Jacobi;
- ``analyze_simple_residual`` accepts the criterion;
- the solver tracks no history.

The TPU gate's VMEM budget and environment flags have no counterpart: the
GPU kernel keeps its state in device memory, so no size limit applies.
"""

from __future__ import annotations

import torch

from ..matrix.dia import Dia
from ..matrix.diagonal import Diagonal, Identity
from ..ops.cg import FUSED_DIAG_DTYPES
from ..ops.dia import MAX_DIAGS
from ..preconditioner.jacobi import Jacobi
from ..stop.criterion import analyze_simple_residual
from .solver_base import extract_max_iters, norm2


def prepare_fused_dia(solver, b):
    """Return None (the streaming loop runs) or a dict with what the fused
    kernel needs: A, minv, tol/baseline/implicit/has_res, cap."""
    A = solver.A
    if not isinstance(A, Dia) or A.shape[0] != A.shape[1]:
        return None
    if not 1 <= A.num_diags <= MAX_DIAGS or A.dtype not in FUSED_DIAG_DTYPES:
        return None
    if getattr(solver, "track_history", False):
        return None
    if b.shape[1] != 1 or b.dtype != torch.float32:
        return None
    M = solver.preconditioner
    if isinstance(M, Identity):
        minv = None
    elif isinstance(M, Diagonal):
        minv = M.values
    elif isinstance(M, Jacobi):
        minv = M.inv_diag
    else:
        return None
    simple = analyze_simple_residual(solver.criterion)
    if simple is None:
        return None
    tol, baseline, implicit, has_res = simple
    return {
        "A": A,
        "minv": minv,
        "tol": tol,
        "baseline": baseline,
        "implicit": implicit,
        "has_res": has_res,
        "cap": extract_max_iters(solver.criterion),
    }


def tol_sq_eff(ctx, b, r0):
    """Squared absolute stop threshold, a float32 device scalar (negative:
    no residual criterion, run to the cap)."""
    dev = b.device
    if not ctx["has_res"]:
        return torch.full((), -1.0, dtype=torch.float32, device=dev)
    if ctx["baseline"] == "absolute":
        base = torch.ones((), dtype=torch.float32, device=dev)
    elif ctx["baseline"] == "initial_resnorm":
        base = norm2(r0)[0].to(torch.float32)
    else:
        base = norm2(b)[0].to(torch.float32)
    return (torch.full((), ctx["tol"], dtype=torch.float32, device=dev) * base) ** 2
