"""Common solver machinery.

Counterpart of ``ginkgo_tpu/solver/solver_base.py`` (reference
include/ginkgo/core/solver/solver_base.hpp:57-148).  A solver is a plain
dataclass holding the system operator, the generated preconditioner and a
combined stopping criterion.  Solves run eagerly under
``torch.no_grad()``; per-column stop masks freeze converged columns as the
reference's stopping_status-masked step kernels do.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..base.linop import as_2d, restore_1d
from ..base import types
from ..matrix.diagonal import Identity
from ..stop.criterion import Combined, Criterion, Iteration, combine, default_criteria

HARD_ITER_CAP = 10_000


# -- reductions ------------------------------------------------------------------


def vdot(a, b):
    """Column-wise conjugated dot, (k,)."""
    return torch.sum(torch.conj(a) * b, dim=0)


def norm2(a):
    """Column-wise 2-norm, (k,), in the real dtype of ``a``."""
    return torch.sqrt(torch.sum(torch.abs(a) ** 2, dim=0))


def safe_div(num, den):
    """num/den with 0 where den == 0 (stopped columns carry zeroed scalars,
    mirroring the reference's stopping-status-masked step kernels)."""
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)), 0)


def masked_cols(new, old, stopped):
    """Freeze columns that have stopped: (n, k) update masked by (k,) bools."""
    return torch.where(stopped[None, :], old, new)


# -- solve result ------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class SolveInfo:
    iterations: torch.Tensor  # 0-d int32: iterations performed
    residual_norm: torch.Tensor  # (k,) final tracked residual norm
    converged: torch.Tensor  # (k,) bool
    history: Any = None  # (cap, k) per-iteration residual norms or None

    @property
    def num_iterations(self):
        return int(self.iterations)


def solve_triangular(T, rhs, *, upper):
    """T^-1 rhs for a triangular T, computed in T's arithmetic dtype and
    returned in T's dtype: PyTorch has no bfloat16 triangular solve on the
    CPU, and the JAX package solves a bfloat16 system too."""
    work = types.arithmetic_dtype(T.dtype)
    out = torch.linalg.solve_triangular(T.to(work), rhs.to(work), upper=upper)
    return out.to(T.dtype)


def extract_max_iters(criterion: Criterion, default: int = HARD_ITER_CAP) -> int:
    found = []

    def walk(c):
        if isinstance(c, Iteration):
            found.append(c.max_iters)
        elif isinstance(c, Combined):
            for ch in c.criteria:
                walk(ch)

    walk(criterion)
    return min(found) if found else default


# -- factory (GKO_ENABLE_LIN_OP_FACTORY analog, lin_op.hpp:1038) ----------------


class SolverFactory:
    """Fluent factory: Cg.build(criteria=[...], preconditioner=JacobiFactory())
    .generate(A) -> solver LinOp."""

    def __init__(self, solver_cls, criteria=None, preconditioner=None, **params):
        self.solver_cls = solver_cls
        self.criteria = criteria
        self.preconditioner = preconditioner
        self.params = params

    def with_criteria(self, *criteria):
        self.criteria = list(criteria)
        return self

    def with_preconditioner(self, factory):
        self.preconditioner = factory
        return self

    def generate(self, A):
        crit = combine(self.criteria) if self.criteria is not None else (
            default_criteria()
        )
        if self.preconditioner is None:
            M = Identity.create(A.shape[0], A.dtype)
        elif hasattr(self.preconditioner, "generate"):
            M = self.preconditioner.generate(A)
        else:
            M = self.preconditioner  # already a LinOp
        return self.solver_cls.create(
            A=A, preconditioner=M, criterion=crit, **self.params
        )


class IterativeSolverMixin:
    """Shared apply/solve plumbing for Krylov solvers."""

    @classmethod
    def build(cls, criteria=None, preconditioner=None, **params) -> SolverFactory:
        return SolverFactory(
            cls, criteria=criteria, preconditioner=preconditioner, **params
        )

    @classmethod
    def create(cls, A, preconditioner, criterion, **params):
        return cls(A=A, preconditioner=preconditioner, criterion=criterion, **params)

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return self.A.dtype

    def apply(self, b):
        x, _ = self.solve(b)
        return x

    def apply_with_initial_guess(self, b, x0):
        x, _ = self.solve(b, x0)
        return x

    def solve(self, b, x0=None):
        """Returns (x, SolveInfo).

        The solve runs in the OPERATOR's precision and x comes back in the
        caller's (precision_dispatch, core/base/precision_dispatch.hpp).
        Reduced-storage operators (bf16/f16 via ``reduce_storage``) are a
        storage format with float32 arithmetic, not a solve precision: the
        solve never drops below the caller's float32/float64."""
        from ..base.exceptions import assert_conformant

        barr, was_1d = as_2d(b)
        assert_conformant(self.A, barr)
        caller_dtype = barr.dtype
        op_dtype = types.to_torch_dtype(self.A.dtype)
        storage_reduced = (
            op_dtype in types.STORAGE_TYPES and caller_dtype.itemsize >= 4
        )
        convert = (
            not storage_reduced
            and caller_dtype != op_dtype
            and caller_dtype.is_complex == op_dtype.is_complex
        )
        if convert:
            barr = barr.to(op_dtype)
        if x0 is None:
            xarr = torch.zeros_like(barr)
        else:
            xarr, _ = as_2d(x0)
            if convert:
                xarr = xarr.to(op_dtype)
        with torch.no_grad():
            x, info = self._solve_impl(barr, xarr)
        if convert:
            x = x.to(caller_dtype)
        return restore_1d(x, was_1d), info

    # -- criterion evaluation inside the loop --------------------------------

    def _check_stop(self, iteration, stopped, r=None, rho=None, baselines=None):
        k = baselines["num_cols"]
        # fallback fills carry the solver's real dtype
        real_dt = baselines["rhs_norm"].dtype
        dev = baselines["device"]
        ctx = dict(baselines)
        ctx["iteration"] = iteration
        if r is not None and self.criterion.needs_residual_norm:
            ctx["residual_norm"] = norm2(r)
        else:
            ctx["residual_norm"] = torch.full((k,), float("inf"), dtype=real_dt, device=dev)
        ctx["implicit_sq_residual_norm"] = (
            torch.abs(rho) if rho is not None
            else torch.full((k,), float("inf"), dtype=real_dt, device=dev)
        )
        return stopped | self.criterion.check_converged(ctx), ctx["residual_norm"]

    def _baselines(self, b, r0):
        return {
            "num_cols": b.shape[1],
            "device": b.device,
            "rhs_norm": norm2(b),
            "initial_resnorm": norm2(r0),
        }
