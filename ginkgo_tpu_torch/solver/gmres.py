"""Restarted GMRES and compressed-basis GMRES (CB-GMRES).

Counterpart of ``ginkgo_tpu/solver/gmres.py`` (reference
core/solver/gmres.cpp and cb_gmres.cpp with its ``storage_precision``
accessor modes keep, reduce1, reduce2, integer, ireduce1, ireduce2).
Left-preconditioned, CGS2 orthogonalization, Givens QR applied on the
fly, and an honest re-check of the true residual after every restart.

A solve takes the first route that accepts it, in the JAX package's order
(solver/gmres.py:300-309):

- one float32 column on a square S = 8 ``Pell`` with an Identity,
  Diagonal or scalar Jacobi preconditioner, a simple residual criterion, a
  float storage mode (keep: float32 basis; reduce1/reduce2: bfloat16) and
  krylov_dim <= 100: the whole-solve kernel K18
  (``ops/gmres.pell_gmres_fused``); ``CbGmres`` "auto" at 2^19 rows or more
  reaches it with a bfloat16 basis;
- one float32 column on a ``Dia`` under the same gate: K15
  (``ops/gmres.gmres_fused``);
- 2 to 4 float32 columns on a ``Dia`` under the same gate and
  krylov_dim <= 50: the k-column kernel K15m
  (``ops/gmres.gmres_fused_multi``), per-column stopping in the kernel.  As
  in the JAX package (solver/gmres.py:304-306) a k > 1 solve never tries a
  one-column kernel.  The JAX package's gate for it is a VMEM fit, not a
  cap on krylov_dim: a k-column solve with krylov_dim > 50 streams here;
- otherwise the streaming loop: ``_solve_single`` per column, the loop
  that ``jax.vmap`` runs over the columns in the JAX package.  Integer
  storage modes, more than 4 columns (more than one on a ``Pell``) and
  krylov_dim > 100 stream here.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..base.linop import LinOp
from ..matrix.pell import Pell
from ..ops.gmres import (
    MAX_FUSED_GMRES_COLS,
    MAX_FUSED_KRYLOV_DIM,
    MAX_FUSED_KRYLOV_DIM_MULTI,
    gmres_fused,
    gmres_fused_multi,
    pell_gmres_fused,
)
from ._fused_gate import kernel_inputs, prepare_fused_dia, prepare_fused_pell
from .solver_base import (
    IterativeSolverMixin,
    SolveInfo,
    extract_max_iters,
    solve_triangular,
)

# -- basis storage accessors (cb_gmres_accessor.hpp analog) --------------------

_INT_MODES = {"integer": torch.int16, "ireduce1": torch.int16, "ireduce2": torch.int8}


def _storage_dtype(mode: str, arith_dtype):
    if mode == "keep":
        return arith_dtype
    if mode == "reduce1":
        return torch.float32 if arith_dtype == torch.float64 else torch.bfloat16
    if mode == "reduce2":
        return torch.bfloat16
    if mode in _INT_MODES:
        return _INT_MODES[mode]
    raise ValueError(mode)


def _encode(w, mode: str, sdtype):
    """vector -> (stored, scale)."""
    if mode == "keep":
        return w, torch.ones((), dtype=w.dtype, device=w.device)
    if mode in _INT_MODES:
        imax = 32767.0 if sdtype == torch.int16 else 127.0
        amax = torch.max(torch.abs(w))
        scale = torch.where(amax > 0, amax / imax, 1.0)
        q = torch.clamp(torch.round(w / scale), -imax, imax).to(sdtype)
        return q, scale.to(w.dtype)
    return w.to(sdtype), torch.ones((), dtype=w.dtype, device=w.device)


def _decode(stored, scale, arith_dtype):
    return stored.to(arith_dtype) * scale


def _decode_basis(Vs, sc, mode: str, dt):
    """The (m+1, n) basis in the arithmetic dtype: float storage modes carry
    unit scales and only widen; integer modes multiply by each vector's
    scale."""
    if mode in _INT_MODES:
        return Vs.to(dt) * sc[:, None]
    return Vs.to(dt)


@dataclasses.dataclass(eq=False)
class Gmres(IterativeSolverMixin, LinOp):
    A: Any
    preconditioner: Any
    criterion: Any
    krylov_dim: int = 30  # gmres.hpp default 100; 30 typical
    storage_precision: str = "keep"

    def _solve_impl(self, b, x0):
        fast = self._try_fused(b, x0)
        return fast if fast is not None else self._solve_streaming(b, x0)

    def _solve_streaming(self, b, x0):
        """``_solve_single`` on each column (the JAX package vmaps it);
        the solve reports the largest iteration count."""
        cols = [self._solve_single(b[:, c], x0[:, c]) for c in range(b.shape[1])]
        x = torch.stack([c[0] for c in cols], dim=1)
        return x, SolveInfo(
            iterations=torch.stack([c[1] for c in cols]).max(),
            residual_norm=torch.stack([c[3] for c in cols]),
            converged=torch.stack([c[2] for c in cols]),
        )

    def _fused_basis_dtype(self):
        """The fused kernel's basis dtype, or None when the storage mode
        streams: float32 for keep, bfloat16 for reduce1/reduce2 (unit
        scales, widened on read); the integer modes carry per-vector
        scales."""
        mode = self.storage_precision
        return None if mode in _INT_MODES else _storage_dtype(mode, torch.float32)

    def _try_fused(self, b, x0):
        """K18 for one column on a Pell, K15 on a Dia, K15m for 2 to 4
        columns on a Dia, or None.  Reports the true residual norms,
        always."""
        basis_dtype = self._fused_basis_dtype()
        m = int(self.krylov_dim)
        k = b.shape[1]
        cap_m = MAX_FUSED_KRYLOV_DIM if k == 1 else MAX_FUSED_KRYLOV_DIM_MULTI
        if basis_dtype is None or not 1 <= m <= cap_m:
            return None
        ctx = (prepare_fused_pell(self, b)
               or prepare_fused_dia(self, b, max_cols=MAX_FUSED_GMRES_COLS))
        if ctx is None:
            return None
        A = ctx["A"]
        _r0, minv, tol = kernel_inputs(ctx, b, x0)
        kw = {"m": m, "tol_sq_eff": tol, "max_iters": ctx["cap"], "basis_dtype": basis_dtype}
        if k > 1:
            x, it, rr, conv, _itc = gmres_fused_multi(A.diags, A.offsets, b.contiguous(),
                                                      x0.contiguous(), minv, **kw)
        else:
            b1, x01 = b[:, 0].contiguous(), x0[:, 0].contiguous()
            if isinstance(A, Pell):
                x, it, rr, conv = pell_gmres_fused(A, b1, x01, minv, **kw)
            else:
                x, it, rr, conv = gmres_fused(A.diags, A.offsets, b1, x01, minv, **kw)
            x, rr, conv = x[:, None], rr[None], conv[None]
        conv = conv if ctx["has_res"] else torch.zeros_like(conv)
        return x, SolveInfo(iterations=it, residual_norm=torch.sqrt(rr).to(b.dtype),
                            converged=conv)

    def _solve_single(self, b, x0):
        """b, x0: (n,).  Left-preconditioned restarted GMRES, step for step
        as ginkgo_tpu's Gmres._solve_single (solver/gmres.py:101-255): each
        cycle runs the m Arnoldi steps under an active mask, as the JAX
        loop does, and the outer loop reads its condition on the host once
        per restart.  Returns (x, iterations, converged, residual norm)."""
        A, M = self.A, self.preconditioner
        m = int(self.krylov_dim)
        cap = extract_max_iters(self.criterion)
        n, dt, dev = b.shape[0], b.dtype, b.device
        mode = self.storage_precision
        sdtype = _storage_dtype(mode, dt)

        def pnorm(v):
            return torch.sqrt(torch.sum(torch.abs(v) ** 2))

        def apply1(op, v):
            return op.apply(v[:, None])[:, 0]

        r0 = b - apply1(A, x0)
        baselines = {
            "num_cols": 1,
            "device": dev,
            "rhs_norm": pnorm(b)[None],
            "initial_resnorm": pnorm(r0)[None],
        }

        def crit_check(it, rnorm, rho):
            ctx = dict(baselines)
            ctx.update(iteration=it, residual_norm=rnorm[None],
                       implicit_sq_residual_norm=torch.abs(rho)[None])
            return self.criterion.check_converged(ctx)[0]

        def cycle(x, it, stopped):
            r = b - apply1(A, x)
            z = apply1(M, r)
            beta = pnorm(z)
            v0 = torch.where(beta > 0, z / torch.where(beta > 0, beta, 1), z)
            Vs = torch.zeros((m + 1, n), dtype=sdtype, device=dev)
            sc = torch.ones(m + 1, dtype=dt, device=dev)
            Vs[0], sc[0] = _encode(v0, mode, sdtype)
            H = torch.zeros((m + 1, m), dtype=dt, device=dev)  # rotated Hessenberg
            g = torch.zeros(m + 1, dtype=dt, device=dev)
            g[0] = beta
            cs = torch.zeros(m, dtype=dt, device=dev)
            sn = torch.zeros(m, dtype=dt, device=dev)
            rn0 = pnorm(r)
            stopped = stopped | crit_check(it, rn0, rn0 ** 2)
            steps = torch.zeros((), dtype=torch.int64, device=dev)
            rows = torch.arange(m + 1, device=dev)
            for j in range(m):
                active = ~stopped & (it < cap)
                w = apply1(M, apply1(A, _decode(Vs[j], sc[j], dt)))
                # CGS2 against rows 0..j (rows > j masked)
                rowmask = (rows <= j).to(dt)
                Vd = _decode_basis(Vs, sc, mode, dt)
                h1 = (torch.conj(Vd) @ w) * rowmask
                w = w - Vd.T @ h1
                h2 = (torch.conj(Vd) @ w) * rowmask
                w = w - Vd.T @ h2
                h = h1 + h2
                hnext = pnorm(w).to(dt)
                wnorm = torch.where(hnext > 0, w / torch.where(hnext > 0, hnext, 1), w)
                enc, s_enc = _encode(wnorm, mode, sdtype)
                Vs[j + 1] = torch.where(active, enc, Vs[j + 1])
                sc[j + 1] = torch.where(active, s_enc, sc[j + 1])
                # the earlier Givens rotations, then the one zeroing h[j+1]
                h[j + 1] = hnext
                for i in range(j):
                    hi, hi1 = h[i].clone(), h[i + 1].clone()
                    h[i] = cs[i] * hi + sn[i] * hi1
                    h[i + 1] = -torch.conj(sn[i]) * hi + cs[i] * hi1
                a_, b_ = h[j], h[j + 1]
                denom = torch.sqrt(torch.abs(a_) ** 2 + torch.abs(b_) ** 2)
                safe = torch.where(denom > 0, denom, 1)
                c_new = torch.where(denom > 0, torch.abs(a_) / safe, 1.0).to(dt)
                abs_a = torch.abs(a_)
                phase = torch.where(abs_a > 0, a_ / torch.where(abs_a > 0, abs_a, 1), 1.0)
                s_new = torch.where(denom > 0, phase * torch.conj(b_) / safe, 0.0).to(dt)
                h_rot = h.clone()
                h_rot[j] = c_new * h[j] + s_new * h[j + 1]
                h_rot[j + 1] = 0
                g_new = g.clone()
                g_new[j + 1] = -torch.conj(s_new) * g[j]
                g_new[j] = c_new * g[j]
                H[:, j] = torch.where(active, h_rot, H[:, j])
                g = torch.where(active, g_new, g)
                cs[j] = torch.where(active, c_new, cs[j])
                sn[j] = torch.where(active, s_new, sn[j])
                it = torch.where(active, it + 1, it)
                steps = torch.where(active, steps + 1, steps)
                rnorm_est = torch.abs(g[j + 1])
                stopped = stopped | (active & crit_check(it, rnorm_est, rnorm_est ** 2))
            # solve R y = g on the first `steps` columns; pad the diagonal with 1
            taken = torch.arange(m, device=dev) < steps
            R = H[:m, :] + torch.diag(torch.where(taken, 0, 1).to(dt))
            gy = torch.where(taken, g[:m], 0)
            y = solve_triangular(R, gy[:, None], upper=True)[:, 0]
            dx = _decode_basis(Vs, sc, mode, dt)[:m].T @ y
            return x + dx, it, stopped

        x = x0
        it = torch.zeros((), dtype=torch.int32, device=dev)
        stopped = torch.zeros((), dtype=torch.bool, device=dev)
        rn = baselines["initial_resnorm"][0]
        # host sync once per restart on the outer condition
        while not bool(stopped) and int(it) < cap:
            x, it, stopped = cycle(x, it, stopped)
            rn = pnorm(b - apply1(A, x))
            # honest convergence: the in-cycle estimate |g[j+1]| is the
            # PRECONDITIONED residual norm and may under-report; the true
            # residual decides, and can retract a premature in-cycle stop
            stopped = crit_check(it, rn, rn ** 2)
        return x, it, stopped, rn


@dataclasses.dataclass(eq=False)
class CbGmres(IterativeSolverMixin, LinOp):
    """CB-GMRES: GMRES with a reduced-precision basis accessor
    (cb_gmres.hpp:88-95).  storage_precision in {auto, keep, reduce1,
    reduce2, integer, ireduce1, ireduce2}.

    "auto" resolves per problem size with the JAX package's rule: keep
    below ``_AUTO_REDUCE_ROWS`` rows, reduce1 at or above it."""

    A: Any
    preconditioner: Any
    criterion: Any
    krylov_dim: int = 30
    storage_precision: str = "auto"

    #: the crossover measured on a TPU v5e (ginkgo_tpu solver/gmres.py:495),
    #: kept so that both packages resolve the same mode; not yet measured
    #: on the H100
    _AUTO_REDUCE_ROWS = 1 << 19

    def _resolved_mode(self) -> str:
        if self.storage_precision != "auto":
            return self.storage_precision
        return "keep" if self.shape[0] < self._AUTO_REDUCE_ROWS else "reduce1"

    def _inner(self):
        return Gmres(
            A=self.A, preconditioner=self.preconditioner, criterion=self.criterion,
            krylov_dim=self.krylov_dim, storage_precision=self._resolved_mode(),
        )

    def _solve_impl(self, b, x0):
        return self._inner()._solve_impl(b, x0)
