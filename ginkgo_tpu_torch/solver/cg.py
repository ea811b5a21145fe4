"""Conjugate gradient (and flexible CG).

Counterpart of ``ginkgo_tpu/solver/cg.py`` (reference core/solver/cg.cpp,
main loop :107-190, and fcg.cpp).  A solve takes the first route that
accepts it, in the JAX package's order (solver/cg.py:48-78):

- k > 1 columns on a ``Dia``: the k-RHS fused kernel K4m
  (``ops/cg.cg_fused_multi``), with per-column stopping;
- one column on a ``Pell`` within K7's 32-bit rows
  (``ops/pell_cg.chunk_rows_fit``): the whole-solve kernel K7
  (``ops/pell_cg.pell_cg_fused``);
- one column on a ``Dia`` with an ``Ilu``/``Ic`` preconditioner whose two
  triangular solvers run 0 to 8 'sweeps' on ``Dia`` triangles: the
  whole-solve kernel K23 (``ops/cg_ilu.cg_ilu_fused``), M applied inside
  it (CG only: Fcg streams, as in the JAX package, solver/cg.py:62-72);
- one column on a ``Dia`` with a ``Multigrid`` preconditioner whose
  hierarchy the fused multigrid kernels take: the whole-solve kernel K26
  (``ops/mg.mg_cg_fused``), one cycle from zero as M inside it, for Cg and
  Fcg (solver/cg.py:73-78);
- one column on a ``Dia``: the whole-solve kernel K4 (``ops/cg.cg_fused``);
- otherwise the streaming route (``_solve_streaming``): one SpMV kernel
  launch per iteration (K1/K5 for one column, K3/K6 for k), and an ILU
  preconditioner's sweeps in one K22 launch per triangle on ``Dia``
  triangles, with
  per-column stop masks freezing converged columns.  Eager PyTorch
  evaluates the loop condition on the host, so this route syncs with the
  device once per iteration, as the reference Ginkgo does with its stop
  flag (cg.cpp:166-171).

The gates are in ``_fused_gate.py``; Fcg takes the same fused routes with
FCG's Polak-Ribiere beta (``flexible=True``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..base import types
from ..base.linop import LinOp
from ..matrix.pell import Pell
from ..ops.cg import MAX_FUSED_COLS, cg_fused, cg_fused_multi
from ..ops.cg_ilu import cg_ilu_fused
from ..ops.mg import mg_cg_fused
from ..ops.pell_cg import chunk_rows_fit, pell_cg_fused
from ._fused_gate import (
    fused_info,
    kernel_inputs,
    prepare_fused_dia,
    prepare_fused_dia_ilu,
    prepare_fused_mg,
    prepare_fused_pell,
    solve_fused_ilu,
    solve_fused_mg,
)
from .solver_base import (
    IterativeSolverMixin,
    SolveInfo,
    extract_max_iters,
    masked_cols,
    safe_div,
    vdot,
)


def _solve_fused(b, x0, ctx, flexible):
    """The whole solve in one kernel: K4m for (n, k) on a Dia, K7 on a
    Pell, K4 on a Dia.  b, x0: (n, k) float32."""
    A = ctx["A"]
    r0, minv, tol = kernel_inputs(ctx, b, x0)
    kw = {"tol_sq_eff": tol, "max_iters": ctx["cap"], "use_implicit": ctx["implicit"],
          "flexible": flexible}
    if b.shape[1] > 1:
        x, _r, it, mon, conv, _itc = cg_fused_multi(
            A.diags, A.offsets, r0.contiguous(), x0.contiguous(), minv, **kw)
    else:
        r0_1, x0_1 = r0[:, 0].contiguous(), x0[:, 0].contiguous()
        if isinstance(A, Pell):
            x, _r, it, mon, conv = pell_cg_fused(A, r0_1, x0_1, minv, **kw)
        else:
            x, _r, it, mon, conv = cg_fused(A.diags, A.offsets, r0_1, x0_1, minv, **kw)
        x, mon, conv = x[:, None], mon[None], conv[None]
    return x, fused_info(ctx, b, it, mon, conv)


def _try_fused(solver, b, x0, flexible):
    """(x, SolveInfo) from the first fused route whose gate accepts the
    solve, or None.  The ILU route is plain CG's only, as in the JAX
    package (Fcg passes ``flexible=True``); the multigrid route serves
    both."""
    if b.shape[1] > 1:
        ctx = prepare_fused_dia(solver, b, max_cols=MAX_FUSED_COLS)
    else:
        ctx = prepare_fused_pell(solver, b)
        if ctx is not None and not chunk_rows_fit(ctx["A"].shape[0]):
            return None  # beyond K7's 32-bit rows: the streaming route
        if ctx is None and not flexible:
            ilu = prepare_fused_dia_ilu(solver, b)
            if ilu is not None:
                return solve_fused_ilu(ilu, b, x0, cg_ilu_fused)
        if ctx is None:
            mg = prepare_fused_mg(solver, b)
            if mg is not None:
                return solve_fused_mg(mg, b, x0, mg_cg_fused, flexible=flexible)
        ctx = ctx or prepare_fused_dia(solver, b)
    return None if ctx is None else _solve_fused(b, x0, ctx, flexible)


@dataclasses.dataclass(eq=False)
class Cg(IterativeSolverMixin, LinOp):
    A: Any
    preconditioner: Any
    criterion: Any
    track_history: bool = False

    def _solve_impl(self, b, x0):
        fast = _try_fused(self, b, x0, flexible=False)
        return fast if fast is not None else self._solve_streaming(b, x0)

    def _solve_streaming(self, b, x0):
        """One iteration per loop trip.  b, x0: (n, k)."""
        x, info, _ = self._solve_with_state(b, x0, None)
        return x, info

    def _solve_with_state(self, b, x0, resume):
        """The streaming loop, step for step as ginkgo_tpu's
        Cg._solve_with_state (solver/cg.py:349-415).  ``resume`` carries
        (r, p, rho_prev, fresh) from the previous chunk of ``solve_chunked``
        so that chunking does not restart the recurrence; the third return
        value is that state."""
        A, M = self.A, self.preconditioner
        cap = extract_max_iters(self.criterion)
        k = b.shape[1]
        dev = b.device

        if resume is None:
            r = b - A.apply(x0)  # cg.cpp:142
            p = torch.zeros_like(b)
            rho_prev = torch.ones(k, dtype=b.dtype, device=dev)
            fresh = True
        else:
            r, p, rho_prev, fresh = resume
        baselines = self._baselines(b, r)
        hist = (
            torch.zeros((cap, k), dtype=types.real_dtype(b.dtype), device=dev)
            if self.track_history
            else None
        )
        x = x0
        it = 0
        stopped = torch.zeros(k, dtype=torch.bool, device=dev)
        resnorm = baselines["initial_resnorm"]
        # host sync once per iteration on the stop flags (cg.cpp:166-171)
        while it < cap and not bool(torch.all(stopped)):
            z = M.apply(r)  # cg.cpp:159
            rho = vdot(r, z)  # cg.cpp:161
            # step_1: p = z + beta p with beta = rho/rho_prev (cg.cpp:177)
            beta = safe_div(rho, rho_prev)
            p_new = z if it == 0 and fresh else z + beta[None, :] * p
            p_new = masked_cols(p_new, p, stopped)
            q = A.apply(p_new)  # cg.cpp:181
            pq = vdot(p_new, q)  # cg.cpp:183
            alpha = torch.where(stopped, 0, safe_div(rho, pq))
            # step_2: x += alpha p; r -= alpha q (cg.cpp:187)
            x = x + alpha[None, :] * p_new
            r = r - alpha[None, :] * q
            stopped, resnorm = self._check_stop(
                it + 1, stopped, r=r, rho=rho, baselines=baselines
            )
            if hist is not None:
                hist[it] = resnorm.to(hist.dtype)
            p, rho_prev = p_new, rho
            it += 1
        info = SolveInfo(
            iterations=torch.tensor(it, dtype=torch.int32, device=dev),
            residual_norm=resnorm,
            converged=stopped,
            history=hist,
        )
        return x, info, (r, p, rho_prev, False)


@dataclasses.dataclass(eq=False)
class Fcg(IterativeSolverMixin, LinOp):
    """Flexible CG (reference core/solver/fcg.cpp): Polak-Ribiere style
    rho_t = dot(r_new - r_old, z_new) so the preconditioner may vary."""

    A: Any
    preconditioner: Any
    criterion: Any
    track_history: bool = False

    def _solve_impl(self, b, x0):
        # the fused kernels carry the Polak-Ribiere numerator as a third
        # reduction of their update pass (flexible=True)
        fast = _try_fused(self, b, x0, flexible=True)
        return fast if fast is not None else self._solve_streaming(b, x0)

    def _solve_streaming(self, b, x0):
        """Step for step as ginkgo_tpu's Fcg loop (solver/cg.py:433-486)."""
        A, M = self.A, self.preconditioner
        cap = extract_max_iters(self.criterion)
        k = b.shape[1]
        dev = b.device

        r = b - A.apply(x0)
        baselines = self._baselines(b, r)
        x = x0
        r_old = torch.zeros_like(b)
        p = torch.zeros_like(b)
        rho_prev = torch.ones(k, dtype=b.dtype, device=dev)
        it = 0
        stopped = torch.zeros(k, dtype=torch.bool, device=dev)
        resnorm = baselines["initial_resnorm"]
        # host sync once per iteration on the stop flags (fcg.cpp)
        while it < cap and not bool(torch.all(stopped)):
            z = M.apply(r)
            rho = vdot(r, z)
            rho_t = vdot(r - r_old, z)  # fcg extra t-vector
            beta = safe_div(rho_t, rho_prev)
            p_new = z if it == 0 else z + beta[None, :] * p
            p_new = masked_cols(p_new, p, stopped)
            q = A.apply(p_new)
            pq = vdot(p_new, q)
            alpha = torch.where(stopped, 0, safe_div(rho, pq))
            x = x + alpha[None, :] * p_new
            r, r_old = r - alpha[None, :] * q, r
            stopped, resnorm = self._check_stop(
                it + 1, stopped, r=r, rho=rho, baselines=baselines
            )
            p, rho_prev = p_new, rho
            it += 1
        info = SolveInfo(
            iterations=torch.tensor(it, dtype=torch.int32, device=dev),
            residual_norm=resnorm,
            converged=stopped,
        )
        return x, info
