"""Common solver machinery.

Counterpart of ``ginkgo_tpu/solver/solver_base.py`` (reference
include/ginkgo/core/solver/solver_base.hpp:57-148).  A solver is a plain
dataclass holding the system operator, the generated preconditioner and a
combined stopping criterion.  Solves run eagerly under
``torch.no_grad()``; per-column stop masks freeze converged columns as the
reference's stopping_status-masked step kernels do.

``solve(b, x0, loggers=)`` brackets a solve with ``linop_apply`` events and
replays ``iteration_complete`` from its ``SolveInfo`` (a whole-solve kernel
has no per-iteration hook); ``solve_chunked`` runs fixed-size chunks with a
host check between them, which is where a ``Time`` criterion stops a solve.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Any

import torch

from ..base.linop import as_2d, restore_1d
from ..base import types
from ..matrix.diagonal import Identity
from ..log.logger import Event, fanout, global_log, global_loggers
from ..stop.criterion import (
    Combined,
    Criterion,
    Iteration,
    Time,
    combine,
    default_criteria,
    freeze_initial_baseline,
)

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


def extract_time_limit(criterion: Criterion):
    found = []

    def walk(c):
        if isinstance(c, Time):
            found.append(c.time_limit_sec)
        elif isinstance(c, Combined):
            for ch in c.criteria:
                walk(ch)

    walk(criterion)
    return min(found) if found else None


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

    def on(self, exec=None):
        """Executor placement: a no-op, as in the JAX package; the solver
        lives on its operator's device."""
        return self

    def generate(self, A):
        global_log(Event.linop_factory_generate_started, factory=self.solver_cls.__name__)
        crit = combine(self.criteria) if self.criteria is not None else (
            default_criteria()
        )
        if self.preconditioner is None:
            M = Identity.create(A.shape[0], A.dtype)
        elif hasattr(self.preconditioner, "generate"):
            pname = type(self.preconditioner).__name__
            global_log(Event.linop_factory_generate_started, factory=pname)
            M = self.preconditioner.generate(A)
            global_log(Event.linop_factory_generate_completed, factory=pname)
        else:
            M = self.preconditioner  # already a LinOp
        solver = self.solver_cls.create(
            A=A, preconditioner=M, criterion=crit, **self.params
        )
        global_log(Event.linop_factory_generate_completed, factory=self.solver_cls.__name__,
                   solver=solver)
        return solver


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

    def solve(self, b, x0=None, loggers=()):
        """Returns (x, SolveInfo).

        The solve runs in the OPERATOR's precision and x comes back in the
        caller's (precision_dispatch, core/base/precision_dispatch.hpp).
        Reduced-storage operators (bf16/f16 via ``reduce_storage``) are a
        storage format with float32 arithmetic, not a solve precision: the
        solve never drops below the caller's float32/float64.

        Logging (logger.hpp:336-481): ``linop_apply`` events bracket the
        solve, and ``iteration_complete`` is replayed from the SolveInfo
        afterwards, once a recorded history row when the solver tracks
        history, then once with the final state.  Events go to ``loggers``
        and to the global registry; with neither the solve reads nothing
        back for them."""
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
        emit = bool(loggers) or bool(global_loggers())
        if emit:
            fanout(loggers, Event.linop_apply_started, solver=self)
        with torch.no_grad():
            x, info = self._solve_impl(barr, xarr)
        if emit:
            self._replay_iterations(loggers, info)
            fanout(loggers, Event.linop_apply_completed, solver=self)
        if convert:
            x = x.to(caller_dtype)
        return restore_1d(x, was_1d), info

    def _replay_iterations(self, loggers, info):
        if info.history is not None:
            hist = types.to_host(info.history)
            for i in range(min(int(info.iterations), hist.shape[0])):
                fanout(loggers, Event.iteration_complete, solver=self, iteration=i + 1,
                       residual_norm=hist[i])
        fanout(loggers, Event.iteration_complete, solver=self,
               iteration=int(info.iterations), residual_norm=info.residual_norm,
               converged=bool(torch.all(info.converged)))

    def solve_chunked(self, b, x0=None, chunk: int = 50, loggers=()):
        """A host-driven solve in chunks of at most ``chunk`` iterations,
        with ``iteration_complete`` and the criterion events sent to
        ``loggers`` after each chunk, and a ``Time`` criterion checked there
        (the host check of the reference's per-iteration loop).

        A solver with ``_solve_with_state`` (Cg) carries its recurrence
        across the chunk boundary; the others restart at it.  Residual
        baselines are not re-taken: a criterion against
        ``initial_resnorm`` is frozen to the original initial residual
        first, which also makes the whole-solve kernels decline, so a
        resumable solver's chunks run the streaming loop."""
        limit = extract_time_limit(self.criterion)
        max_iters = extract_max_iters(self.criterion)
        barr, was_1d = as_2d(b)
        with torch.no_grad():
            x = torch.zeros_like(barr) if x0 is None else as_2d(x0)[0]
            frozen = freeze_initial_baseline(self.criterion, norm2(barr - self.A.apply(x)))
            solver = self if frozen is self.criterion else self.replace(criterion=frozen)
            start = _time.perf_counter()
            done_iters = 0
            info = None
            chunk_solver = None
            resumable = hasattr(solver, "_solve_with_state")
            state = None
            while done_iters < max_iters:
                n_now = min(chunk, max_iters - done_iters)
                if chunk_solver is None or n_now != chunk:
                    chunk_solver = solver._replace_iteration_cap(n_now)
                if resumable:
                    x, info, state = chunk_solver._solve_with_state(barr, x, state)
                else:
                    x, info = chunk_solver._solve_impl(barr, x)
                done_iters += int(info.iterations)
                conv_now = bool(torch.all(info.converged))
                fanout(loggers, Event.iteration_complete, solver=solver, iteration=done_iters,
                       residual_norm=info.residual_norm, converged=conv_now)
                fanout(loggers, Event.criterion_check_started, solver=solver,
                       iteration=done_iters)
                fanout(loggers, Event.criterion_check_completed, solver=solver,
                       iteration=done_iters, converged=conv_now)
                if conv_now:
                    break
                if limit is not None and _time.perf_counter() - start > limit:
                    break
        info = SolveInfo(
            iterations=torch.tensor(done_iters, dtype=torch.int32, device=barr.device),
            residual_norm=info.residual_norm, converged=info.converged, history=None)
        return restore_1d(x, was_1d), info

    def _replace_iteration_cap(self, n):
        def swap(c):
            if isinstance(c, Iteration):
                return Iteration(max_iters=n)
            if isinstance(c, Combined):
                return Combined(criteria=tuple(swap(ch) for ch in c.criteria))
            return c

        newc = swap(self.criterion)
        if extract_max_iters(newc, default=-1) == -1:
            newc = Combined(criteria=(Iteration(max_iters=n), newc))
        return self.replace(criterion=newc)

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
