"""Exception taxonomy.

Reference: include/ginkgo/core/base/exception.hpp — Error, NotImplemented,
NotCompiled, NotSupported, DimensionMismatch, BadDimension, AllocationError,
OutOfBoundsError, StreamError, KernelNotFound (+ the GKO_ASSERT_* helper
macros of exception_helpers.hpp).  SURVEY §5: "mirror the exception
taxonomy"; allocation/stream errors have no analog (XLA owns memory), the
rest map 1:1.
"""

from __future__ import annotations


class Error(Exception):
    """Base of the taxonomy (exception.hpp Error)."""


class NotImplementedError_(Error, NotImplementedError):
    """Operation not implemented for this type (exception.hpp
    NotImplemented).  Also subclasses the builtin NotImplementedError so
    duck-typed hasattr/try protocols keep working; raised by the abstract
    LinOp/Criterion/Executor surfaces."""


class NotSupported(Error):
    """Object/type not supported in this context (exception.hpp NotSupported)."""


class NotCompiled(Error):
    """Feature needs an unavailable module — e.g. the native IO library or a
    TPU-only Pallas path (exception.hpp NotCompiled / device_hooks)."""


class DimensionMismatch(Error):
    """Operator/vector dimensions do not line up (exception.hpp
    DimensionMismatch)."""

    def __init__(self, op_name, op_shape, arg_name, arg_shape, note=""):
        self.op_shape = tuple(op_shape)
        self.arg_shape = tuple(arg_shape)
        super().__init__(
            f"{op_name} with shape {tuple(op_shape)} cannot be applied to "
            f"{arg_name} with shape {tuple(arg_shape)}"
            + (f": {note}" if note else "")
        )


class BadDimension(Error):
    """A dimension value is invalid (exception.hpp BadDimension)."""


class OutOfBoundsError(Error):
    """Index beyond its bound (exception.hpp OutOfBoundsError)."""


def assert_conformant(op, b):
    """GKO_ASSERT_CONFORMANT analog: op (n, m) applies to b (m[, k])."""
    m = op.shape[1]
    blen = b.shape[0] if hasattr(b, "shape") else len(b)
    if blen != m:
        raise DimensionMismatch(
            type(op).__name__, op.shape, "operand", getattr(b, "shape", (blen,))
        )


def assert_square(op):
    """GKO_ASSERT_IS_SQUARE_MATRIX analog."""
    n, m = op.shape
    if n != m:
        raise BadDimension(f"{type(op).__name__} must be square, got {op.shape}")
