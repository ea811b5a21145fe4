"""Dense matrix / multivector.

Counterpart of ``ginkgo_tpu/matrix/dense.py`` (reference
include/ginkgo/core/matrix/dense.hpp): doubles as the multivector type,
with the column-wise BLAS-1 surface.  Apply is a plain dense product.
"""

from __future__ import annotations

import dataclasses
import numbers

import numpy as np
import torch

from ..base import types
from ..base.linop import LinOp, _values_of, as_2d, restore_1d
from ..base.matrix_data import MatrixData


@dataclasses.dataclass(eq=False)
class Dense(LinOp):
    values: torch.Tensor  # (n, k)

    # -- construction --------------------------------------------------------

    @staticmethod
    def create(values, *, device) -> "Dense":
        arr = torch.as_tensor(values, device=device)
        if arr.dim() == 1:
            arr = arr[:, None]
        return Dense(values=arr)

    @staticmethod
    def zeros(shape, dtype=types.DEFAULT_VALUE_TYPE, *, device) -> "Dense":
        return Dense(values=torch.zeros(shape, dtype=dtype, device=device))

    @staticmethod
    def from_matrix_data(data: MatrixData, *, device) -> "Dense":
        return Dense(values=torch.as_tensor(data.to_dense(), device=device))

    read = from_matrix_data

    # -- core ----------------------------------------------------------------

    @property
    def shape(self):
        return tuple(self.values.shape)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def num_stored_elements(self):
        return self.values.numel()

    def _product(self, arr):
        """values @ arr computed in the arithmetic dtype and returned in
        ``promote_types(self.dtype, arr.dtype)`` (the JAX package's
        ``result_type``)."""
        work = torch.promote_types(types.arithmetic_dtype(self.dtype), arr.dtype)
        out = self.values.to(work) @ arr.to(work)
        return out.to(torch.promote_types(self.dtype, arr.dtype))

    def apply(self, b):
        arr, was_1d = as_2d(b)
        return restore_1d(self._product(arr), was_1d)

    def apply_advanced(self, alpha, b, beta, x):
        arr, was_1d = as_2d(b)
        xa, _ = as_2d(x)
        out = _col_scalar(alpha, xa) * self._product(arr) + _col_scalar(beta, xa) * xa
        return restore_1d(out, was_1d)

    # -- BLAS-1 column-wise ----------------------------------------------------

    def compute_dot(self, other) -> torch.Tensor:
        o, _ = as_2d(other)
        return torch.sum(self.values * o, dim=0)

    def compute_conj_dot(self, other) -> torch.Tensor:
        o, _ = as_2d(other)
        return torch.sum(torch.conj(self.values) * o, dim=0)

    def compute_norm2(self) -> torch.Tensor:
        return torch.sqrt(torch.sum(torch.abs(self.values) ** 2, dim=0))

    def compute_norm1(self) -> torch.Tensor:
        return torch.sum(torch.abs(self.values), dim=0)

    def scale(self, alpha) -> "Dense":
        return Dense(values=self.values * _col_scalar(alpha, self.values))

    def inv_scale(self, alpha) -> "Dense":
        return Dense(values=self.values / _col_scalar(alpha, self.values))

    def add_scaled(self, alpha, other) -> "Dense":
        o, _ = as_2d(other)
        return Dense(values=self.values + _col_scalar(alpha, self.values) * o)

    def sub_scaled(self, alpha, other) -> "Dense":
        o, _ = as_2d(other)
        return Dense(values=self.values - _col_scalar(alpha, self.values) * o)

    # -- structure ops --------------------------------------------------------

    def transpose(self) -> "Dense":
        return Dense(values=self.values.T.contiguous())

    def conj_transpose(self) -> "Dense":
        return Dense(values=torch.conj(self.values).T.contiguous())

    def extract_diagonal(self):
        from .diagonal import Diagonal

        return Diagonal(values=torch.diagonal(self.values).contiguous())

    def compute_absolute(self) -> "Dense":
        return Dense(values=torch.abs(self.values))

    def astype(self, dtype) -> "Dense":
        return Dense(values=self.values.to(dtype))

    def column(self, j) -> "Dense":
        return Dense(values=self.values[:, j:j + 1])

    # -- IO / conversion -------------------------------------------------------

    def to_matrix_data(self, drop_tol: float = 0.0) -> MatrixData:
        return MatrixData.from_dense(types.to_host(self.values), drop_tol)

    write = to_matrix_data

    def to_dense(self) -> "Dense":
        return self

    def __getitem__(self, idx):
        return self.values[idx]


def _col_scalar(alpha, values):
    """alpha may be a python scalar, a (k,) per-column vector, or a (1, k)
    Dense row (the reference uses 1 x k Dense scalars).  Python numbers and
    numpy values keep their precision (torch would make them float32)."""
    a = _values_of(alpha)
    if isinstance(a, numbers.Number):
        return a
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a))
    a = a.to(values.device)
    return a if a.dim() == 0 else a.reshape(1, -1)
