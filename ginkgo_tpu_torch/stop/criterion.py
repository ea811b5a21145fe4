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


def analyze_simple_residual(criterion):
    """Decompose a criterion tree into (tolerance, baseline, implicit,
    has_residual_criterion) when it is a plain Iteration/residual-norm
    combination — the shape the whole-solve kernel evaluates on the device.
    Returns None for custom criteria or more than one residual criterion."""
    found = []
    ok = [True]

    def walk(c):
        if isinstance(c, Combined):
            for ch in c.criteria:
                walk(ch)
        elif isinstance(c, Iteration):
            pass  # the kernel's max_iters
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
