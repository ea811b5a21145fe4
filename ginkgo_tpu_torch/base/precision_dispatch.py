"""Argument precision conversion at apply boundaries.

Counterpart of ``ginkgo_tpu/base/precision_dispatch.py`` (reference
core/base/precision_dispatch.hpp): ``precision_dispatch`` converts the
arguments to the operator's value type, runs the apply and hands the result
back in the caller's precision, so a float operator applied to double
vectors works.  A real operator applied to complex vectors applies to the
real and imaginary parts separately (real_complex_dispatch,
precision_dispatch.hpp:167-219); a complex operator applied to real vectors
promotes them.  ``IterativeSolverMixin.solve`` runs a whole solve in the
operator's precision by the same rule.
"""

from __future__ import annotations

import torch

from . import types
from .linop import as_2d, restore_1d


def dispatch_dtype(op_dtype, arg_dtype) -> torch.dtype:
    """The compute dtype the reference's dispatch picks: always the
    OPERATOR's value type (arguments are converted to it)."""
    del arg_dtype
    return types.to_torch_dtype(op_dtype)


def precision_dispatch(apply_fn, op_dtype, b):
    """``apply_fn(b)`` computed in the operator's precision and returned in
    b's dtype."""
    arr, was_1d = as_2d(b)
    op_dtype = types.to_torch_dtype(op_dtype)
    if arr.dtype == op_dtype:
        return apply_fn(restore_1d(arr, was_1d))
    if arr.dtype.is_complex and not op_dtype.is_complex:
        re = apply_fn(restore_1d(arr.real.to(op_dtype), was_1d))
        im = apply_fn(restore_1d(arr.imag.to(op_dtype), was_1d))
        return torch.complex(re.to(arr.real.dtype), im.to(arr.real.dtype))
    return apply_fn(restore_1d(arr.to(op_dtype), was_1d)).to(arr.dtype)


def precision_dispatch_advanced(apply_advanced_fn, op_dtype, alpha, b, beta, x):
    """x := alpha op b + beta x with the arguments converted to the
    operator's precision and the result returned in x's."""
    barr, _ = as_2d(b)
    xarr, was_1d = as_2d(x)
    op_dtype = types.to_torch_dtype(op_dtype)
    if barr.dtype == op_dtype and xarr.dtype == op_dtype:
        return apply_advanced_fn(alpha, b, beta, x)
    out = apply_advanced_fn(
        torch.as_tensor(alpha, device=xarr.device).to(op_dtype),
        barr.to(op_dtype),
        torch.as_tensor(beta, device=xarr.device).to(op_dtype),
        xarr.to(op_dtype),
    )
    return restore_1d(out.to(xarr.dtype), was_1d)
