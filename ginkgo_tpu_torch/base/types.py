"""Value type helpers for the PyTorch port.

Counterpart of ``ginkgo_tpu/base/types.py``.  Dtypes are ``torch.dtype``
objects; host-side code (``MatrixData``) keeps numpy dtypes, and
:func:`to_torch_dtype` translates them.
"""

from __future__ import annotations

import numpy as np
import torch

#: Storage-only types (reduced diagonal storage; arithmetic is float32).
STORAGE_TYPES = (torch.bfloat16, torch.float16)

DEFAULT_VALUE_TYPE = torch.float32

_NP_TO_TORCH = {
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}


def to_torch_dtype(dtype) -> torch.dtype:
    """Normalize a numpy or torch dtype-like to a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NP_TO_TORCH[np.dtype(dtype)]


def real_dtype(dtype) -> torch.dtype:
    """remove_complex<T> analog (types.hpp `remove_complex`)."""
    d = to_torch_dtype(dtype)
    return d.to_real() if d.is_complex else d


def arithmetic_dtype(dtype) -> torch.dtype:
    """The dtype arithmetic runs in for values stored as ``dtype``:
    reduced storage (bf16/f16) computes in float32."""
    d = to_torch_dtype(dtype)
    return torch.float32 if d in STORAGE_TYPES else d


def to_host(x) -> np.ndarray:
    """Tensor -> numpy array on the host (bf16 widens to float32, numpy has
    no bfloat16).  No-op for numpy inputs."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)
