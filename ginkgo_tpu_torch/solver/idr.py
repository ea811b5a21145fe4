"""IDR(s): induced dimension reduction.

Counterpart of ``ginkgo_tpu/solver/idr.py`` (reference core/solver/idr.cpp,
the biorthogonal IDR(s) variant with the kappa omega safeguard).  The
shadow space P is drawn and orthonormalized on the host at generate time,
exactly as the JAX package does (numpy's generator from ``seed``, QR of
P^T, rows cast to the operator's dtype), so P is bit for bit the JAX
package's and a solve is deterministic.

A solve takes the first route that accepts it:

- one float32 column on a ``Dia`` with an Identity, Diagonal or scalar
  Jacobi preconditioner, a simple residual criterion and s <=
  ``MAX_FUSED_IDR_S`` (4): the whole-solve kernel K16
  (``ops/idr.idr_fused``);
- otherwise the streaming loop ``_solve_single``, run per column where the
  JAX package vmaps it: k > 1 columns, s > 4, any other preconditioner or
  operator.  The loop condition is read on the host once per outer
  iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..base import types
from ..base.linop import LinOp
from ..ops.idr import MAX_FUSED_IDR_S, idr_fused
from ._fused_gate import kernel_inputs, prepare_fused_dia
from .solver_base import (
    IterativeSolverMixin,
    SolveInfo,
    extract_max_iters,
    solve_triangular,
)


@dataclasses.dataclass(eq=False)
class Idr(IterativeSolverMixin, LinOp):
    A: Any
    preconditioner: Any
    criterion: Any
    P: Any = None  # (s, n) orthonormal shadow space
    subspace_dim: int = 2
    kappa: float = 0.7  # omega safeguard (idr.hpp kappa)
    deterministic: bool = True

    @classmethod
    def create(cls, A, preconditioner, criterion, subspace_dim=2, kappa=0.7,
               deterministic=True, seed=42, **params):
        """The shadow space as ginkgo_tpu/solver/idr.py:50-61 draws it:
        standard normal rows from ``np.random.default_rng(seed)`` (complex
        for a complex operator), orthonormalized by ``np.linalg.qr`` of
        P^T, cast from float64 to A's dtype."""
        s, n = int(subspace_dim), A.shape[0]
        dtype = types.to_torch_dtype(A.dtype)
        rng = np.random.default_rng(seed)
        P = rng.standard_normal((s, n))
        if dtype.is_complex:
            P = P + 1j * rng.standard_normal((s, n))
        q, _ = np.linalg.qr(P.T)
        P = torch.from_numpy(np.ascontiguousarray(q.T[:s])).to(device=A.device, dtype=dtype)
        return cls(A=A, preconditioner=preconditioner, criterion=criterion, P=P,
                   subspace_dim=s, kappa=kappa, deterministic=deterministic, **params)

    def _solve_impl(self, b, x0):
        if b.shape[1] == 1:
            fast = self._try_fused(b, x0)
            if fast is not None:
                return fast
        cols = [self._solve_single(b[:, c], x0[:, c]) for c in range(b.shape[1])]
        x = torch.stack([c[0] for c in cols], dim=1)
        return x, SolveInfo(
            iterations=torch.stack([c[1] for c in cols]).max(),
            residual_norm=torch.stack([c[3] for c in cols]),
            converged=torch.stack([c[2] for c in cols]),
        )

    def _try_fused(self, b, x0):
        """K16, or None.  The monitor is the replaced residual's r.r in
        exact and implicit modes alike, so the residual norm is reported
        from it in both (ginkgo_tpu solver/idr.py:246-249)."""
        s = self.subspace_dim
        if s > MAX_FUSED_IDR_S or self.P is None:
            return None
        ctx = prepare_fused_dia(self, b)
        if ctx is None:
            return None
        A = ctx["A"]
        r0, minv, tol = kernel_inputs(ctx, b, x0)
        x, _r, it, mon, conv = idr_fused(
            A.diags, A.offsets, self.P.to(torch.float32).contiguous(), r0[:, 0].contiguous(),
            x0[:, 0].contiguous(), b[:, 0].contiguous(), minv, kappa=self.kappa,
            tol_sq_eff=tol, max_iters=ctx["cap"],
        )
        conv = conv[None] if ctx["has_res"] else torch.zeros(1, dtype=torch.bool,
                                                             device=b.device)
        return x[:, None], SolveInfo(iterations=it, residual_norm=torch.sqrt(mon)[None].to(b.dtype),
                                     converged=conv)

    def _solve_single(self, b, x0):
        """b, x0: (n,).  Step for step as ginkgo_tpu's Idr._solve_single
        (solver/idr.py:85-190), with the residual replacement r = b - A x
        once per outer iteration.  Returns (x, iterations, stopped,
        residual norm)."""
        A, M = self.A, self.preconditioner
        s = self.subspace_dim
        cap = extract_max_iters(self.criterion)
        dt, dev = b.dtype, b.device
        P = self.P.to(dt)

        def apply1(op, v):
            return op.apply(v[:, None])[:, 0]

        def pnorm(v):
            return torch.sqrt(torch.sum(torch.abs(v) ** 2))

        def pdot(a, v):
            return torch.sum(torch.conj(a) * v)

        def safe(x, d):
            ok = torch.abs(d) > 0
            return torch.where(ok, x / torch.where(ok, d, torch.ones_like(d)),
                               torch.zeros_like(x))

        r = b - apply1(A, x0)
        r0_norm = pnorm(r)
        baselines = {"num_cols": 1, "device": dev, "rhs_norm": pnorm(b)[None],
                     "initial_resnorm": r0_norm[None]}

        def crit_check(it, rnorm):
            ctx = dict(baselines)
            ctx.update(iteration=it, residual_norm=rnorm[None],
                       implicit_sq_residual_norm=(rnorm ** 2)[None])
            return self.criterion.check_converged(ctx)[0]

        kappa = torch.tensor(self.kappa, dtype=r0_norm.dtype, device=dev)
        x = x0
        G = torch.zeros((s, b.shape[0]), dtype=dt, device=dev)
        U = torch.zeros_like(G)
        Mm = torch.eye(s, dtype=dt, device=dev)
        om = torch.ones((), dtype=dt, device=dev)
        it = 0
        stopped = crit_check(0, r0_norm)
        # host sync once per outer iteration on the stop flag
        while it < cap and not bool(stopped):
            f = torch.conj(P) @ r
            for kk in range(s):
                csol = solve_triangular(Mm[kk:, kk:], f[kk:, None], upper=False)[:, 0]
                c = torch.zeros(s, dtype=dt, device=dev)
                c[kk:] = csol
                v = apply1(M, r - c @ G)
                u_new = om * v + c @ U
                g_new = apply1(A, u_new)
                for i in range(kk):  # biorthogonalize against P[0..kk-1]
                    alpha = safe(pdot(P[i], g_new), Mm[i, i])
                    g_new = g_new - alpha * G[i]
                    u_new = u_new - alpha * U[i]
                mcol = torch.conj(P) @ g_new
                Mm[kk:, kk] = mcol[kk:]
                beta = safe(f[kk], Mm[kk, kk])
                r = r - beta * g_new
                x = x + beta * u_new
                f = f - beta * Mm[:, kk]
                f[kk] = 0
                G[kk] = g_new
                U[kk] = u_new
            # the dimension-reduction step
            v = apply1(M, r)
            t = apply1(A, v)
            tt = pdot(t, t)
            tr = pdot(t, r)
            om_raw = safe(tr, tt)
            rho = torch.abs(safe(tr, torch.sqrt(tt.real) * pnorm(r)))
            om = torch.where(rho < kappa, om_raw * safe(kappa, rho), om_raw)
            x = x + om * v
            # residual replacement (the JAX package's f32 honesty fix,
            # solver/idr.py:164-170)
            r = b - apply1(A, x)
            it += 1
            stopped = crit_check(it, pnorm(r))
        return x, torch.tensor(it, dtype=torch.int32, device=dev), stopped, pnorm(r)
