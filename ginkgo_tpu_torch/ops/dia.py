"""DIA (banded) SpMV family: kernels K1-K3 and their plain versions.

Counterpart of ``ginkgo_tpu/ops/pallas_dia.py``.  Diagonals are stored as
``(nd, n_rows)`` with ``diags[d, i] = A[i, i + off_d]``:

  y[i] = sum_d diags[d, i] * x[i + off_d],   0 <= i + off_d < n_cols

Each operation has a plain PyTorch version (``*_reference``) and a wrapper
that launches the hand-written CUDA kernel of ``csrc/dia_spmv.cu`` for a
CUDA tensor.  A wrapper takes the plain version only for a tensor on the
CPU; on any other device it launches the kernel or raises.  Each wrapper
counts its launches in a ``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

#: Most diagonals a kernel takes (csrc/common.cuh GK_MAX_DIAGS); a DIA
#: operator beyond it is not worth the format (matrix/dia.suitable_for_dia).
MAX_DIAGS = 64

#: dtype codes of csrc/common.cuh (GkDtype)
DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
VECTOR_DTYPES = (torch.float32, torch.float64)


def _lib():
    lib = _build.load("dia_spmv")
    if not hasattr(lib, "gk_typed"):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        offs = ctypes.POINTER(ctypes.c_longlong)
        lib.dia_spmv.argtypes = [P, I, offs, I, P, I, P, L, L, P]
        lib.dia_spmv_advanced.argtypes = [P, I, offs, I, P, I, P, P, P, P, L, L, P]
        lib.dia_spmm.argtypes = [P, I, offs, I, P, I, P, L, L, I, P]
        for fn in (lib.dia_spmv, lib.dia_spmv_advanced, lib.dia_spmm):
            fn.restype = I
        lib.gk_error_string.argtypes = [I]
        lib.gk_error_string.restype = ctypes.c_char_p
        lib.gk_typed = True
    return lib


def offsets_array(offsets):
    """Offsets as the C ``long long[]`` the kernels copy by value."""
    return (ctypes.c_longlong * max(len(offsets), 1))(*offsets)


def check_status(lib, status: int, what: str) -> None:
    if status != 0:
        msg = lib.gk_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain path).  A tensor on any device
    other than the CPU or a CUDA card is refused."""
    kind = t.device.type
    if kind == "cpu":
        return True
    if kind == "cuda":
        return False
    raise RuntimeError(f"no kernel for device {t.device}")


def _check_spmv_operands(diags, offsets, x, n_cols, what):
    if not (diags.is_cuda and diags.device == x.device):
        raise RuntimeError(f"{what}: diags on {diags.device}, x on {x.device}")
    if diags.dim() != 2 or diags.shape[0] != len(offsets):
        raise ValueError(f"{what}: diags must be (nd, n_rows) with nd = len(offsets)")
    if len(offsets) > MAX_DIAGS:
        raise ValueError(f"{what}: {len(offsets)} diagonals, the kernel takes {MAX_DIAGS}")
    if x.dtype not in VECTOR_DTYPES:
        raise TypeError(f"{what}: vectors must be float32/float64, got {x.dtype}")
    if diags.dtype not in DTYPE_CODE or diags.element_size() > x.element_size():
        raise TypeError(f"{what}: diagonals {diags.dtype} with vectors {x.dtype}")
    if x.shape[0] != n_cols:
        raise ValueError(f"{what}: x has {x.shape[0]} rows, operator {n_cols} columns")
    if not (diags.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{what}: operands must be contiguous")


# -- plain versions ------------------------------------------------------------


def dia_spmv_reference(diags, offsets, x, n_cols):
    """y = A x (x: (n_cols,) or (n_cols, k)) with plain tensor ops: one
    shifted slice per diagonal, summed in offset order; reduced-storage
    diagonals widen to ``x.dtype`` (the arithmetic dtype)."""
    n = diags.shape[1]
    y = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n_cols - off)
        if hi <= lo:
            continue
        dv = diags[d, lo:hi].to(x.dtype)
        if x.dim() == 2:
            dv = dv[:, None]
        y[lo:hi] += dv * x[lo + off:hi + off]
    return y


def dia_spmv_advanced_reference(diags, offsets, x, alpha, beta, y, n_cols):
    """alpha * A x + beta * y with plain tensor ops."""
    acc = dia_spmv_reference(diags, offsets, x, n_cols)
    return alpha.reshape(()) * acc + beta.reshape(()) * y


def dia_spmm_reference(diags, offsets, X, n_cols):
    """Y = A X for X of shape (n_cols, k)."""
    return dia_spmv_reference(diags, offsets, X, n_cols)


# -- kernel wrappers -------------------------------------------------------------


def dia_spmv(diags, offsets, x, n_cols):
    """K1: y = A x for one right-hand side x of shape (n_cols,)."""
    if on_cpu(x):
        return dia_spmv_reference(diags, offsets, x, n_cols)
    _check_spmv_operands(diags, offsets, x, n_cols, "dia_spmv")
    if x.dim() != 1:
        raise ValueError("dia_spmv: x must be 1-D")
    lib = _lib()
    y = torch.empty(diags.shape[1], dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.dia_spmv(
            diags.data_ptr(), DTYPE_CODE[diags.dtype], offsets_array(offsets),
            len(offsets), x.data_ptr(), DTYPE_CODE[x.dtype], y.data_ptr(),
            diags.shape[1], n_cols, torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "dia_spmv")
    dia_spmv.launches += 1
    return y


dia_spmv.launches = 0


def dia_spmv_advanced(diags, offsets, x, alpha, beta, y, n_cols):
    """K2: alpha * A x + beta * y in one pass.  alpha and beta are
    1-element tensors on x's device, read by the kernel from device memory
    (no host sync)."""
    if on_cpu(x):
        return dia_spmv_advanced_reference(diags, offsets, x, alpha, beta, y, n_cols)
    _check_spmv_operands(diags, offsets, x, n_cols, "dia_spmv_advanced")
    n_rows = diags.shape[1]
    if x.dim() != 1 or y.shape != (n_rows,) or y.dtype != x.dtype:
        raise ValueError("dia_spmv_advanced: x and y must be 1-D of x's dtype")
    for name, s in (("alpha", alpha), ("beta", beta)):
        if s.device != x.device or s.dtype != x.dtype or s.numel() != 1:
            raise ValueError(f"dia_spmv_advanced: {name} must be one {x.dtype} on {x.device}")
    if not y.is_contiguous():
        raise ValueError("dia_spmv_advanced: y must be contiguous")
    lib = _lib()
    out = torch.empty(n_rows, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.dia_spmv_advanced(
            diags.data_ptr(), DTYPE_CODE[diags.dtype], offsets_array(offsets),
            len(offsets), x.data_ptr(), DTYPE_CODE[x.dtype], alpha.data_ptr(),
            beta.data_ptr(), y.data_ptr(), out.data_ptr(), n_rows, n_cols,
            torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "dia_spmv_advanced")
    dia_spmv_advanced.launches += 1
    return out


dia_spmv_advanced.launches = 0


def dia_spmm(diags, offsets, X, n_cols):
    """K3: Y = A X for X of shape (n_cols, k), row-major."""
    if on_cpu(X):
        return dia_spmm_reference(diags, offsets, X, n_cols)
    _check_spmv_operands(diags, offsets, X, n_cols, "dia_spmm")
    if X.dim() != 2:
        raise ValueError("dia_spmm: X must be (n_cols, k)")
    lib = _lib()
    k = X.shape[1]
    Y = torch.empty((diags.shape[1], k), dtype=X.dtype, device=X.device)
    with torch.cuda.device(X.device):
        status = lib.dia_spmm(
            diags.data_ptr(), DTYPE_CODE[diags.dtype], offsets_array(offsets),
            len(offsets), X.data_ptr(), DTYPE_CODE[X.dtype], Y.data_ptr(),
            diags.shape[1], n_cols, k, torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "dia_spmm")
    dia_spmm.launches += 1
    return Y


dia_spmm.launches = 0
