"""Conjugate gradient (and flexible CG).

Counterpart of ``ginkgo_tpu/solver/cg.py`` (reference core/solver/cg.cpp,
main loop :107-190, and fcg.cpp).  A solve takes one of two routes:

- the fused route (``ops/cg.cg_fused``, kernel K4) when the gate of
  ``_fused_gate.py`` accepts it: the whole loop and the stop test run in
  one kernel with no host round trip;
- the streaming route (``_solve_streaming``) otherwise: one SpMV kernel
  launch per iteration (K1 for one column, K3 for k), with per-column stop
  masks freezing converged columns.  Eager PyTorch evaluates the loop
  condition on the host, so this route syncs with the device once per
  iteration, as the reference Ginkgo does with its stop flag
  (cg.cpp:166-171).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..base import types
from ..base.linop import LinOp
from ..ops.cg import cg_fused
from ._fused_gate import prepare_fused_dia, tol_sq_eff
from .solver_base import (
    IterativeSolverMixin,
    SolveInfo,
    extract_max_iters,
    masked_cols,
    safe_div,
    vdot,
)


def _solve_fused(b, x0, ctx, flexible):
    """The whole solve in kernel K4 (ops/cg.py); b, x0: (n, 1) float32."""
    A = ctx["A"]
    r0 = b - A.apply(x0)
    tol_sq = tol_sq_eff(ctx, b, r0)
    minv = ctx["minv"]
    if minv is not None:
        minv = minv.to(torch.float32).contiguous()
    x, _r, it, mon, conv = cg_fused(
        A.diags, A.offsets, r0[:, 0].contiguous(), x0[:, 0].contiguous(), minv,
        tol_sq_eff=tol_sq, max_iters=ctx["cap"], use_implicit=ctx["implicit"],
        flexible=flexible,
    )
    if ctx["has_res"] and not ctx["implicit"]:
        rn = torch.sqrt(mon)[None].to(b.dtype)
    else:
        # the streaming loop's fill when no exact-residual criterion is
        # tracked (solver_base._check_stop)
        rn = torch.full((1,), float("inf"), dtype=b.dtype, device=b.device)
    conv_mask = (conv if ctx["has_res"] else torch.zeros_like(conv))[None]
    info = SolveInfo(iterations=it, residual_norm=rn, converged=conv_mask)
    return x[:, None], info


@dataclasses.dataclass(eq=False)
class Cg(IterativeSolverMixin, LinOp):
    A: Any
    preconditioner: Any
    criterion: Any
    track_history: bool = False

    def _solve_impl(self, b, x0):
        ctx = prepare_fused_dia(self, b)
        if ctx is not None:
            return _solve_fused(b, x0, ctx, flexible=False)
        return self._solve_streaming(b, x0)

    def _solve_streaming(self, b, x0):
        """One iteration per loop trip, step for step as ginkgo_tpu's
        Cg._solve_with_state (solver/cg.py:349-415).  b, x0: (n, k)."""
        A, M = self.A, self.preconditioner
        cap = extract_max_iters(self.criterion)
        k = b.shape[1]
        dev = b.device

        r = b - A.apply(x0)  # cg.cpp:142
        p = torch.zeros_like(b)
        rho_prev = torch.ones(k, dtype=b.dtype, device=dev)
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
            p_new = z if it == 0 else z + beta[None, :] * p
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
        return x, info


@dataclasses.dataclass(eq=False)
class Fcg(IterativeSolverMixin, LinOp):
    """Flexible CG (reference core/solver/fcg.cpp): Polak-Ribiere style
    rho_t = dot(r_new - r_old, z_new) so the preconditioner may vary."""

    A: Any
    preconditioner: Any
    criterion: Any
    track_history: bool = False

    def _solve_impl(self, b, x0):
        # the fused kernel carries the Polak-Ribiere numerator as a third
        # reduction of its update pass (flexible=True)
        ctx = prepare_fused_dia(self, b)
        if ctx is not None:
            return _solve_fused(b, x0, ctx, flexible=True)
        return self._solve_streaming(b, x0)

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
