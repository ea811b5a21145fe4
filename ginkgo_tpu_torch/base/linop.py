"""LinOp protocol — the universal "y = Op(x)" abstraction.

Counterpart of ``ginkgo_tpu/base/linop.py``.  A LinOp is a plain
dataclass that holds tensors; ``replace()`` is ``dataclasses.replace``.
Capability mixins of the reference (Transposable, DiagonalExtractable,
...) stay optional duck-typed methods.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


def _not_implemented():
    from .exceptions import NotImplementedError_

    return NotImplementedError_("operation not implemented for this type")


class LinOp:
    """Duck-typed base.  Concrete ops are plain dataclasses."""

    @property
    def shape(self) -> tuple[int, int]:
        raise _not_implemented()

    @property
    def dtype(self):
        raise _not_implemented()

    def apply(self, b):
        """x = self @ b.  b: (m,) or (m, k) tensor (or Dense)."""
        raise _not_implemented()

    def apply_advanced(self, alpha, b, beta, x):
        """x := alpha * self @ b + beta * x  (reference lin_op.hpp:236)."""
        return alpha * self.apply(b) + beta * _values_of(x)

    def __matmul__(self, b):
        return self.apply(b)

    @property
    def size(self) -> tuple[int, int]:
        return self.shape

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def _values_of(x):
    """Accept raw tensors or Dense-like wrappers (a tensor's own ``values``
    is the sparse-tensor accessor, so tensors pass through first)."""
    if isinstance(x, torch.Tensor):
        return x
    return getattr(x, "values", x)


def as_2d(b):
    """Normalize vector input to (n, k); return (tensor, was_1d)."""
    arr = _values_of(b)
    if arr.dim() == 1:
        return arr[:, None], True
    return arr, False


def restore_1d(x, was_1d):
    return x[:, 0] if was_1d else x


def _scalar(c):
    """A coefficient as a factor: a tensor becomes 0-d, a python number
    stays one (so it takes the operand's dtype instead of float32)."""
    return c.reshape(()) if isinstance(c, torch.Tensor) else c


# ---------------------------------------------------------------------------
# Utility LinOps (reference: core/base/combination.hpp:59, composition.hpp:67,
# perturbation.hpp:67)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class Combination(LinOp):
    """sum_i coef_i * op_i  (reference combination.hpp:59)."""

    coefficients: tuple  # scalars or 1-element tensors
    operators: tuple  # LinOps, all same shape

    @property
    def shape(self):
        return self.operators[0].shape

    @property
    def dtype(self):
        return self.operators[0].dtype

    def apply(self, b):
        out = None
        for c, op in zip(self.coefficients, self.operators):
            y = op.apply(b)
            term = _scalar(c) * y
            out = term if out is None else out + term
        return out


@dataclasses.dataclass(eq=False)
class Composition(LinOp):
    """op_0 ∘ op_1 ∘ ... (apply right-to-left; reference composition.hpp:67)."""

    operators: tuple

    @property
    def shape(self):
        return (self.operators[0].shape[0], self.operators[-1].shape[1])

    @property
    def dtype(self):
        return self.operators[0].dtype

    def apply(self, b):
        x = b
        for op in reversed(self.operators):
            x = op.apply(x)
        return x


@dataclasses.dataclass(eq=False)
class Perturbation(LinOp):
    """identity + scalar * basis @ projector  (reference perturbation.hpp:67).

    basis: (n, k) tensor, projector: (k, n) LinOp or tensor."""

    scalar: Any
    basis: Any
    projector: Any

    @property
    def shape(self):
        n = self.basis.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.basis.dtype

    def apply(self, b):
        arr, was_1d = as_2d(b)
        proj = (
            self.projector.apply(arr)
            if hasattr(self.projector, "apply")
            else self.projector @ arr
        )
        out = arr + _scalar(self.scalar) * (self.basis @ proj)
        return restore_1d(out, was_1d)
