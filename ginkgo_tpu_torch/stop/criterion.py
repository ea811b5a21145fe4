"""Stopping criteria.

Counterpart of ``ginkgo_tpu/stop/criterion.py`` (reference
include/ginkgo/core/stop/: criterion.hpp:64-152, stopping_status.hpp:62-145,
iteration.hpp:52, residual_norm.hpp:65-193, combined.hpp:55).  A criterion's
``check(ctx)`` returns a per-column boolean stop mask as a tensor on the
solve's device; ``ctx`` is a dict the solver fills with what it tracks:

  iteration                    python int
  residual_norm                (k,) true residual 2-norm, if tracked
  implicit_sq_residual_norm    (k,) recurrent rho, if tracked
  rhs_norm, initial_resnorm    (k,) baselines captured at solve start
  num_cols, device             k and the device of the masks

``Time`` is inert inside a solve: ``solve_chunked`` checks it between
chunks, against a ``FrozenBaselineResidualNorm`` that keeps the original
initial residual as the baseline.

The whole-solve kernel evaluates the same criteria on the device through
:func:`analyze_simple_residual`.
"""

from __future__ import annotations

import dataclasses

import torch


class Criterion:
    needs_residual_norm = False
    needs_implicit_norm = False
    #: does a True mask mean *converged* (vs merely stopped)?  Mirrors the
    #: converged/stopped bit split of stopping_status.hpp:62-145.
    is_convergence = True

    def check(self, ctx) -> torch.Tensor:
        """Return (k,) bool mask of columns that should stop now."""
        from ..base.exceptions import NotImplementedError_

        raise NotImplementedError_(type(self).__name__)

    def check_converged(self, ctx) -> torch.Tensor:
        """Mask of columns stopped *by convergence* (Iteration excluded).
        Column updates are frozen by this mask; the loop exit additionally
        uses the iteration cap, which hits all columns at once."""
        if self.is_convergence:
            return self.check(ctx)
        return _no_stop(ctx)

    def generate(self, A=None, b=None, x=None, r=None):
        return self


def _no_stop(ctx):
    return torch.zeros(ctx["num_cols"], dtype=torch.bool, device=ctx["device"])


def _baseline(ctx, baseline):
    if baseline == "absolute":
        return 1.0
    if baseline == "initial_resnorm":
        return ctx["initial_resnorm"]
    return ctx["rhs_norm"]


@dataclasses.dataclass(eq=False)
class Iteration(Criterion):
    """Stop after max_iters (iteration.hpp:52)."""

    max_iters: int = 100
    is_convergence = False

    def check(self, ctx):
        return torch.full(
            (ctx["num_cols"],), ctx["iteration"] >= self.max_iters,
            dtype=torch.bool, device=ctx["device"],
        )


@dataclasses.dataclass(eq=False)
class ResidualNorm(Criterion):
    """||r|| <= tolerance * baseline (residual_norm.hpp:65,137).

    baseline: 'rhs_norm' (default, like the reference), 'initial_resnorm',
    'absolute'."""

    tolerance: float = 1e-8
    baseline: str = "rhs_norm"

    needs_residual_norm = True

    def check(self, ctx):
        return ctx["residual_norm"] <= self.tolerance * _baseline(ctx, self.baseline)


@dataclasses.dataclass(eq=False)
class ImplicitResidualNorm(Criterion):
    """sqrt(|implicit rho|) <= tolerance * baseline (residual_norm.hpp:193)."""

    tolerance: float = 1e-8
    baseline: str = "rhs_norm"

    needs_implicit_norm = True

    def check(self, ctx):
        rn = torch.sqrt(torch.abs(ctx["implicit_sq_residual_norm"]))
        return rn <= self.tolerance * _baseline(ctx, self.baseline)


@dataclasses.dataclass(eq=False)
class Combined(Criterion):
    """OR-combination (combined.hpp:55)."""

    criteria: tuple = ()

    @property
    def needs_residual_norm(self):
        return any(c.needs_residual_norm for c in self.criteria)

    @property
    def needs_implicit_norm(self):
        return any(c.needs_implicit_norm for c in self.criteria)

    def check(self, ctx):
        mask = None
        for c in self.criteria:
            m = c.check(ctx)
            mask = m if mask is None else (mask | m)
        return mask

    def check_converged(self, ctx):
        mask = _no_stop(ctx)
        for c in self.criteria:
            mask = mask | c.check_converged(ctx)
        return mask


@dataclasses.dataclass(eq=False)
class Time(Criterion):
    """Wall-clock limit (time.hpp:52).  Checked on the host between the
    chunks of ``solve_chunked``; inert inside a solve's loop."""

    time_limit_sec: float = float("inf")
    is_convergence = False

    def check(self, ctx):
        return _no_stop(ctx)


@dataclasses.dataclass(eq=False)
class FrozenBaselineResidualNorm(Criterion):
    """ResidualNorm against a per-column baseline captured beforehand: the
    chunked driver's ``initial_resnorm`` stays the ORIGINAL initial residual
    instead of each chunk's restart residual."""

    tolerance: float = 1e-8
    baseline_vals: torch.Tensor = None  # (k,)

    needs_residual_norm = True

    def check(self, ctx):
        return ctx["residual_norm"] <= self.tolerance * self.baseline_vals


def freeze_initial_baseline(criterion, initial_resnorm):
    """Replace every ResidualNorm/ImplicitResidualNorm with
    ``baseline='initial_resnorm'`` by a frozen-baseline equivalent; the same
    object back when there is none."""

    def walk(c):
        if isinstance(c, (ResidualNorm, ImplicitResidualNorm)) and (
                c.baseline == "initial_resnorm"):
            return FrozenBaselineResidualNorm(tolerance=c.tolerance,
                                              baseline_vals=initial_resnorm)
        if isinstance(c, Combined):
            return Combined(criteria=tuple(walk(ch) for ch in c.criteria))
        return c

    new = walk(criterion)
    return new if _tree_differs(new, criterion) else criterion


def _tree_differs(a, b) -> bool:
    if a is b:
        return False
    if isinstance(a, Combined) and isinstance(b, Combined):
        return any(_tree_differs(x, y) for x, y in zip(a.criteria, b.criteria))
    return type(a) is not type(b)


def analyze_simple_residual(criterion):
    """Decompose a criterion tree into (tolerance, baseline, implicit,
    has_residual_criterion) when it is a plain Iteration/Time/residual-norm
    combination — the shape the whole-solve kernel evaluates on the device.
    Returns None for custom criteria, a frozen baseline or more than one
    residual criterion."""
    found = []
    ok = [True]

    def walk(c):
        if isinstance(c, Combined):
            for ch in c.criteria:
                walk(ch)
        elif isinstance(c, (Iteration, Time)):
            pass  # the kernel's max_iters; Time is inert inside a solve
        elif isinstance(c, ResidualNorm):
            found.append((c.tolerance, c.baseline, False))
        elif isinstance(c, ImplicitResidualNorm):
            found.append((c.tolerance, c.baseline, True))
        else:
            ok[0] = False

    walk(criterion)
    if not ok[0] or len(found) > 1:
        return None
    if not found:
        return (0.0, "absolute", False, False)
    tol, baseline, implicit = found[0]
    return (tol, baseline, implicit, True)


def combine(criteria) -> Criterion:
    """Normalize a criterion / list of criteria to a single Criterion."""
    if criteria is None:
        return Combined(criteria=(Iteration(max_iters=1000), ResidualNorm()))
    if isinstance(criteria, Criterion):
        return criteria
    crits = tuple(criteria)
    if len(crits) == 1:
        return crits[0]
    return Combined(criteria=crits)


def default_criteria(max_iters=1000, tolerance=1e-8):
    return Combined(
        criteria=(Iteration(max_iters=max_iters), ResidualNorm(tolerance=tolerance))
    )
