"""Nonsymmetric Krylov solvers: BiCGSTAB, CGS, BiCG.

Counterpart of ``ginkgo_tpu/solver/bicgstab.py`` (reference
core/solver/bicgstab.cpp, cgs.cpp, bicg.cpp).  A solve takes the first
route that accepts it, in the JAX package's order (solver/bicgstab.py:
52-63, 413-416):

- BiCGSTAB with 2 to 8 float32 columns on a ``Dia`` with an Identity,
  Diagonal or scalar Jacobi preconditioner and a simple residual
  criterion: the k-column kernel K12m (``ops/bicgstab.bicgstab_fused_multi``),
  per-column stopping in the kernel, on A M as K12; a k > 1 solve tries no
  other kernel;
- one float32 column on a square S = 8 ``Pell`` under the same gate:
  BiCGSTAB's K19 (``ops/pell_cg.pell_bicgstab_fused``) or CGS's K20
  (``ops/pell_cg.pell_cgs_fused``), M applied explicitly (PELL values have
  no column fold), where the Pell's rows fit the kernels' 32-bit rows
  (``ops/pell_cg.chunk_rows_fit``; beyond them the streaming loop).  BiCG
  has no Pell kernel, in the JAX package either;
- BiCGSTAB with one float32 column on a ``Dia`` with an ``Ilu``
  preconditioner whose two triangular solvers run 0 to 8 'sweeps' on
  ``Dia`` triangles: K24 (``ops/cg_ilu.bicgstab_ilu_fused``), M applied
  inside the kernel;
- BiCGSTAB with one float32 column on a ``Dia`` with a ``Multigrid``
  preconditioner whose hierarchy the fused multigrid kernels take: K28
  (``ops/mg.mg_bicgstab_fused``), one cycle from zero as M inside it;
- one float32 column on a ``Dia`` under the same gate: K12
  (``ops/bicgstab.bicgstab_fused``), K13 (``ops/cgs.cgs_fused``) or K14
  (``ops/cgs.bicg_fused``).  BiCGSTAB and CGS run on A M with the diagonal
  M folded into the diagonals (``_fused_gate.fold_minv``); BiCG also needs
  A^H as a ``Dia``;
- otherwise the streaming loop (``_solve_streaming``), step for step as
  the JAX package's: more than 8 columns (CGS and BiCG: more than one;
  the JAX package has no k-column kernel for them), block Jacobi or any
  other preconditioner, BiCG on a ``Pell``, a ``Csr``/``Well``/``Bell``
  operator, an ILU preconditioner under CGS or BiCG (an ILU's sweeps on
  ``Dia`` triangles then run in one K22 launch per triangle).  The JAX
  package's multigrid fused routes are not ported yet and stream here.
  Per-column stop masks freeze converged columns; the loop condition is
  read on the host once per iteration.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch

from ..base.linop import LinOp
from ..ops.bicgstab import bicgstab_fused, bicgstab_fused_multi
from ..ops.cg import MAX_FUSED_COLS
from ..ops.cg_ilu import bicgstab_ilu_fused
from ..ops.mg import mg_bicgstab_fused
from ..ops.cgs import bicg_fused, cgs_fused
from ..ops.pell_cg import chunk_rows_fit, pell_bicgstab_fused, pell_cgs_fused
from ._fused_gate import (
    fold_minv,
    fused_info,
    fused_transpose_ok,
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
    norm2,
    safe_div,
    vdot,
)


def _solve_fused(solver, b, x0, run, fold, max_cols=1):
    """(x, SolveInfo) from a whole-solve kernel ``run`` taking (diags,
    offsets, r0, x0, minv), or None when the gate declines.  One column
    goes to ``run`` as (n,) vectors; with ``max_cols`` > 1, k columns go as
    (n, k) to a k-column kernel.  With ``fold`` the kernel runs on A M and
    takes minv for the x update."""
    ctx = prepare_fused_dia(solver, b, max_cols=max_cols)
    if ctx is None:
        return None
    A = ctx["A"]
    r0, minv, tol = kernel_inputs(ctx, b, x0)
    diags = A.diags if (minv is None or not fold) else fold_minv(A, minv)
    kw = {"tol_sq_eff": tol, "max_iters": ctx["cap"], "use_implicit": ctx["implicit"]}
    if b.shape[1] > 1:
        x, _r, it, mon, conv, _itc = run(diags, A.offsets, r0.contiguous(), x0.contiguous(),
                                         minv, **kw)
        return x, fused_info(ctx, b, it, mon, conv)
    x, _r, it, mon, conv = run(diags, A.offsets, r0[:, 0].contiguous(),
                               x0[:, 0].contiguous(), minv, **kw)
    return x[:, None], fused_info(ctx, b, it, mon[None], conv[None])


def _solve_fused_pell(solver, b, x0, run):
    """(x, SolveInfo) from a whole-solve Pell kernel ``run`` taking (A, r0,
    x0, minv) for one column, or None when the gate declines or the Pell
    lies beyond the kernels' 32-bit rows.  The kernel applies M explicitly
    and takes minv for the x update too."""
    ctx = prepare_fused_pell(solver, b)
    if ctx is None or not chunk_rows_fit(ctx["A"].shape[0]):
        return None
    r0, minv, tol = kernel_inputs(ctx, b, x0)
    x, _r, it, mon, conv = run(ctx["A"], r0[:, 0].contiguous(), x0[:, 0].contiguous(), minv,
                               tol_sq_eff=tol, max_iters=ctx["cap"],
                               use_implicit=ctx["implicit"])
    return x[:, None], fused_info(ctx, b, it, mon[None], conv[None])


def _info(it, rn, stopped, dev):
    return SolveInfo(
        iterations=torch.tensor(it, dtype=torch.int32, device=dev),
        residual_norm=rn,
        converged=stopped,
    )


@dataclasses.dataclass(eq=False)
class Bicgstab(IterativeSolverMixin, LinOp):
    A: Any
    preconditioner: Any
    criterion: Any

    def _solve_impl(self, b, x0):
        fast = self._try_fused(b, x0)
        return fast if fast is not None else self._solve_streaming(b, x0)

    def _try_fused(self, b, x0):
        """K12m for 2 to 8 columns; for one, K19 on a Pell, K24 with an ILU
        preconditioner on a Dia, K28 with a Multigrid one, else K12 on A M
        (the JAX package's order, solver/bicgstab.py:52-66, 176, 277), or
        None."""
        if b.shape[1] > 1:
            return _solve_fused(self, b, x0, bicgstab_fused_multi, fold=True,
                                max_cols=MAX_FUSED_COLS)
        fast = _solve_fused_pell(self, b, x0, pell_bicgstab_fused)
        if fast is None:
            ilu = prepare_fused_dia_ilu(self, b)
            if ilu is not None:
                return solve_fused_ilu(ilu, b, x0, bicgstab_ilu_fused)
            mg = prepare_fused_mg(self, b)
            if mg is not None:
                return solve_fused_mg(mg, b, x0, mg_bicgstab_fused)
        return fast or _solve_fused(self, b, x0, bicgstab_fused, fold=True)

    def _solve_streaming(self, b, x0):
        """Right-preconditioned BiCGSTAB with the half-step check on s,
        step for step as ginkgo_tpu's Bicgstab loop (solver/bicgstab.py:
        320-399).  b, x0: (n, k)."""
        A, M = self.A, self.preconditioner
        cap = extract_max_iters(self.criterion)
        k, dev = b.shape[1], b.device

        r = b - A.apply(x0)
        rr = r  # shadow residual (bicgstab.cpp initialize)
        baselines = self._baselines(b, r)
        x = x0
        p = torch.zeros_like(b)
        v = torch.zeros_like(b)
        rho = alpha = omega = torch.ones(k, dtype=b.dtype, device=dev)
        rn = baselines["initial_resnorm"]
        stopped = torch.zeros(k, dtype=torch.bool, device=dev)
        it = 0
        while it < cap and not bool(torch.all(stopped)):
            rho_new = vdot(rr, r)
            beta = safe_div(rho_new * alpha, rho * omega)
            p_new = r + beta[None, :] * (p - omega[None, :] * v)
            y = M.apply(p_new)
            v_new = A.apply(y)
            alpha_new = torch.where(stopped, 0, safe_div(rho_new, vdot(rr, v_new)))
            s = r - alpha_new[None, :] * v_new
            # half-step convergence on s: a half-done column takes omega = 0
            # (r = s) and carries omega as 1
            half_ctx = dict(baselines)
            half_ctx.update(iteration=it + 1, residual_norm=norm2(s),
                            implicit_sq_residual_norm=torch.abs(rho_new))
            half_done = self.criterion.check_converged(half_ctx) & ~stopped
            z = M.apply(s)
            t = A.apply(z)
            omega_new = torch.where(stopped | half_done, 0,
                                    safe_div(vdot(t, s), vdot(t, t)))
            x_new = masked_cols(x + alpha_new[None, :] * y + omega_new[None, :] * z, x, stopped)
            r_new = masked_cols(s - omega_new[None, :] * t, r, stopped)
            stopped_new, rn = self._check_stop(
                it + 1, stopped | half_done, r=r_new, rho=rho_new, baselines=baselines
            )
            p = masked_cols(p_new, p, stopped)
            v = masked_cols(v_new, v, stopped)
            rho = torch.where(stopped, rho, rho_new)
            alpha = torch.where(stopped, alpha, alpha_new)
            omega = torch.where(stopped, omega, torch.where(half_done, 1.0, omega_new))
            x, r, stopped = x_new, r_new, stopped_new
            it += 1
        return x, _info(it, rn, stopped, dev)


@dataclasses.dataclass(eq=False)
class Cgs(IterativeSolverMixin, LinOp):
    A: Any
    preconditioner: Any
    criterion: Any

    def _solve_impl(self, b, x0):
        fast = self._try_fused(b, x0)
        return fast if fast is not None else self._solve_streaming(b, x0)

    def _try_fused(self, b, x0):
        """K20 on a Pell, else K13 on A M (the JAX package's order,
        solver/bicgstab.py:413-416, 464), or None."""
        return (_solve_fused_pell(self, b, x0, pell_cgs_fused)
                or _solve_fused(self, b, x0, cgs_fused, fold=True))

    def _solve_streaming(self, b, x0):
        """Step for step as ginkgo_tpu's Cgs loop (solver/bicgstab.py:
        505-565)."""
        A, M = self.A, self.preconditioner
        cap = extract_max_iters(self.criterion)
        k, dev = b.shape[1], b.device

        r = b - A.apply(x0)
        rr = r
        baselines = self._baselines(b, r)
        x = x0
        p = torch.zeros_like(b)
        q = torch.zeros_like(b)
        u = torch.zeros_like(b)
        rho = torch.ones(k, dtype=b.dtype, device=dev)
        rn = baselines["initial_resnorm"]
        stopped = torch.zeros(k, dtype=torch.bool, device=dev)
        it = 0
        while it < cap and not bool(torch.all(stopped)):
            rho_new = vdot(rr, r)
            beta = safe_div(rho_new, rho)[None, :]
            u_new = r + beta * q
            p_new = u_new + beta * (q + beta * p)
            v = A.apply(M.apply(p_new))
            alpha = torch.where(stopped, 0, safe_div(rho_new, vdot(rr, v)))[None, :]
            q_new = u_new - alpha * v
            t = M.apply(u_new + q_new)
            x_new = masked_cols(x + alpha * t, x, stopped)
            r_new = masked_cols(r - alpha * A.apply(t), r, stopped)
            stopped_new, rn = self._check_stop(
                it + 1, stopped, r=r_new, rho=rho_new, baselines=baselines
            )
            p = masked_cols(p_new, p, stopped)
            q = masked_cols(q_new, q, stopped)
            u = masked_cols(u_new, u, stopped)
            rho = torch.where(stopped, rho, rho_new)
            x, r, stopped = x_new, r_new, stopped_new
            it += 1
        return x, _info(it, rn, stopped, dev)


@dataclasses.dataclass(eq=False)
class Bicg(IterativeSolverMixin, LinOp):
    """Classic BiCG with A^H and M^H (bicg.cpp).  The conjugate transposes
    are built once, at generate time."""

    A: Any
    preconditioner: Any
    criterion: Any
    At: Any = None
    Mt: Any = None

    @classmethod
    def create(cls, A, preconditioner, criterion, **params):
        if hasattr(A, "conj_transpose"):
            At = A.conj_transpose()
        else:
            # BiCG needs A^H for the shadow recurrence; A itself is right
            # only for a Hermitian operator
            warnings.warn(
                "Bicg: operator has no conj_transpose(); using A itself for "
                "the shadow recurrence, which is only correct for Hermitian "
                "operators. Provide conj_transpose() for nonsymmetric A.",
                stacklevel=2,
            )
            At = A
        M = preconditioner
        Mt = M.conj_transpose() if hasattr(M, "conj_transpose") else M
        return cls(A=A, preconditioner=M, criterion=criterion, At=At, Mt=Mt, **params)

    def _solve_impl(self, b, x0):
        fast = self._try_fused(b, x0)
        return fast if fast is not None else self._solve_streaming(b, x0)

    def _try_fused(self, b, x0):
        """K14 with A and A^H, or None.  A real diagonal M is its own M^H."""
        if not fused_transpose_ok(self.A, self.At):
            return None
        At = self.At

        def run(diags, offsets, r0, x0_1, minv, **kw):
            return bicg_fused(diags, offsets, At.diags, At.offsets, r0, x0_1, minv, **kw)

        return _solve_fused(self, b, x0, run, fold=False)

    def _solve_streaming(self, b, x0):
        """Step for step as ginkgo_tpu's Bicg loop (solver/bicgstab.py:
        664-724)."""
        A, M, At, Mt = self.A, self.preconditioner, self.At, self.Mt
        cap = extract_max_iters(self.criterion)
        k, dev = b.shape[1], b.device

        r = b - A.apply(x0)
        baselines = self._baselines(b, r)
        x = x0
        r2 = torch.conj(r)
        p = torch.zeros_like(b)
        p2 = torch.zeros_like(b)
        rho = torch.ones(k, dtype=b.dtype, device=dev)
        rn = baselines["initial_resnorm"]
        stopped = torch.zeros(k, dtype=torch.bool, device=dev)
        it = 0
        while it < cap and not bool(torch.all(stopped)):
            z = M.apply(r)
            z2 = Mt.apply(r2)
            rho_new = vdot(r2, z)
            beta = safe_div(rho_new, rho)[None, :]
            p_new = z if it == 0 else z + beta * p
            p2_new = z2 if it == 0 else z2 + torch.conj(beta) * p2
            q = A.apply(p_new)
            q2 = At.apply(p2_new)
            alpha = torch.where(stopped, 0, safe_div(rho_new, vdot(p2_new, q)))[None, :]
            x_new = masked_cols(x + alpha * p_new, x, stopped)
            r_new = masked_cols(r - alpha * q, r, stopped)
            r2_new = masked_cols(r2 - torch.conj(alpha) * q2, r2, stopped)
            stopped_new, rn = self._check_stop(
                it + 1, stopped, r=r_new, rho=rho_new, baselines=baselines
            )
            p = masked_cols(p_new, p, stopped)
            p2 = masked_cols(p2_new, p2, stopped)
            rho = torch.where(stopped, rho, rho_new)
            x, r, r2, stopped = x_new, r_new, r2_new, stopped_new
            it += 1
        return x, _info(it, rn, stopped, dev)
