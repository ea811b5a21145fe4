"""Iterative refinement / (relaxed) Richardson iteration.

Counterpart of ``ginkgo_tpu/solver/ir.py`` (reference core/solver/ir.cpp,
ir.hpp:66-81: ``relaxation_factor`` and the inner ``solver``).  With an
inner scalar-Jacobi solver this is damped Jacobi.

A solve takes the first route that accepts it, in the JAX package's order
(solver/ir.py:98-100):

- one float32 column on a square S = 8 ``Pell`` with an Identity,
  Diagonal or scalar Jacobi inner solver and a criterion that is not
  implicit (IR has no rho), within the kernel's 32-bit rows
  (``ops/pell_cg.chunk_rows_fit``): the whole-solve kernel K21
  (``ops/pell_cg.pell_ir_fused``).  Its monitor starts at r0's r.r, as the
  JAX package's Pell kernel's does, so an initial guess that already meets
  the tolerance runs no sweep, where the Dia kernel and the streaming loop
  run one;
- one float32 column on a ``Dia`` under the same gate: K17
  (``ops/ir.ir_fused``);
- otherwise the streaming loop, step for step as the JAX package's: k > 1
  columns, the implicit criterion, any other inner solver or operator.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..base.linop import LinOp
from ..matrix.pell import Pell
from ..ops.ir import ir_fused
from ..ops.pell_cg import chunk_rows_fit, pell_ir_fused
from ._fused_gate import kernel_inputs, prepare_fused_dia, prepare_fused_pell
from .solver_base import IterativeSolverMixin, SolveInfo, extract_max_iters, masked_cols


@dataclasses.dataclass(eq=False)
class Ir(IterativeSolverMixin, LinOp):
    A: Any
    preconditioner: Any  # the inner solver ("solver" parameter in ir.hpp)
    criterion: Any
    relaxation_factor: float = 1.0

    @classmethod
    def create(cls, A, preconditioner, criterion, relaxation_factor=1.0, **params):
        return cls(A=A, preconditioner=preconditioner, criterion=criterion,
                   relaxation_factor=relaxation_factor, **params)

    # the reference's name for the inner operator
    @property
    def solver(self):
        return self.preconditioner

    def _solve_impl(self, b, x0):
        fast = self._try_fused(b, x0)
        return fast if fast is not None else self._solve_streaming(b, x0)

    def _try_fused(self, b, x0):
        """K21 on a Pell, K17 on a Dia, or None.  The residual norm is
        reported where a residual criterion is present, else inf
        (ginkgo_tpu solver/ir.py:130-133)."""
        ctx = prepare_fused_pell(self, b) or prepare_fused_dia(self, b)
        if ctx is None or ctx["implicit"]:
            return None
        A = ctx["A"]
        if isinstance(A, Pell) and not chunk_rows_fit(A.shape[0]):
            return None
        _r0, minv, tol = kernel_inputs(ctx, b, x0)
        b1, x01 = b[:, 0].contiguous(), x0[:, 0].contiguous()
        kw = {"omega": self.relaxation_factor, "tol_sq_eff": tol, "max_iters": ctx["cap"]}
        if isinstance(A, Pell):
            x, _r, it, rr, conv = pell_ir_fused(A, b1, x01, minv, **kw)
        else:
            x, _r, it, rr, conv = ir_fused(A.diags, A.offsets, b1, x01, minv, **kw)
        if ctx["has_res"]:
            rn = torch.sqrt(rr)[None].to(b.dtype)
        else:
            rn = torch.full((1,), float("inf"), dtype=b.dtype, device=b.device)
        conv = conv[None] if ctx["has_res"] else torch.zeros(1, dtype=torch.bool,
                                                             device=b.device)
        return x[:, None], SolveInfo(iterations=it, residual_norm=rn, converged=conv)

    def _solve_streaming(self, b, x0):
        """Step for step as ginkgo_tpu's Ir loop (solver/ir.py:49-84): d =
        M r, x += omega d, r = b - A x recomputed, stopped columns frozen.
        b, x0: (n, k)."""
        A, M = self.A, self.preconditioner
        cap = extract_max_iters(self.criterion)
        k, dev = b.shape[1], b.device
        omega = torch.tensor(self.relaxation_factor, dtype=b.dtype, device=dev)

        x = x0
        r = b - A.apply(x0)
        baselines = self._baselines(b, r)
        rn = baselines["initial_resnorm"]
        stopped = torch.zeros(k, dtype=torch.bool, device=dev)
        it = 0
        # host sync once per sweep on the stop flags
        while it < cap and not bool(torch.all(stopped)):
            d = M.apply(r)  # the inner solve (ir.cpp solver->apply(residual, inner))
            x_new = masked_cols(x + omega * d, x, stopped)
            r_new = masked_cols(b - A.apply(x_new), r, stopped)
            stopped, rn = self._check_stop(it + 1, stopped, r=r_new, rho=None,
                                           baselines=baselines)
            x, r = x_new, r_new
            it += 1
        return x, SolveInfo(iterations=torch.tensor(it, dtype=torch.int32, device=dev),
                            residual_norm=rn, converged=stopped)


# Richardson is the reference's documented alias for IR (ir.hpp:60)
Richardson = Ir
