"""Diagonal and Identity — small structural LinOps.

Counterpart of the Diagonal/Identity part of ``ginkgo_tpu/matrix/diagonal.py``
(reference include/ginkgo/core/matrix/diagonal.hpp:270, identity.hpp:131).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..base import types
from ..base.linop import LinOp, _values_of, as_2d, restore_1d
from ..base.matrix_data import MatrixData


@dataclasses.dataclass(eq=False)
class Diagonal(LinOp):
    """Diagonal matrix; apply scales rows, rapply scales columns."""

    values: torch.Tensor  # (n,)

    @staticmethod
    def create(values, *, device):
        return Diagonal(values=torch.as_tensor(values, device=device))

    @staticmethod
    def from_matrix_data(data: MatrixData, *, device):
        n = min(data.shape)
        diag = np.zeros(n, dtype=data.values.dtype)
        mask = data.rows == data.cols
        np.add.at(diag, data.rows[mask], data.values[mask])
        return Diagonal(values=torch.as_tensor(diag, device=device))

    read = from_matrix_data

    @property
    def shape(self):
        n = self.values.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.values.dtype

    def apply(self, b):
        arr, was_1d = as_2d(b)
        return restore_1d(self.values[:, None] * arr, was_1d)

    def rapply(self, b):
        """Column scaling: b @ D."""
        arr, was_1d = as_2d(b)
        return restore_1d(arr * self.values[None, :], was_1d)

    def inverse_apply(self, b):
        arr, was_1d = as_2d(b)
        return restore_1d(arr / self.values[:, None], was_1d)

    def transpose(self):
        return self

    def conj_transpose(self):
        return Diagonal(values=torch.conj(self.values))

    def compute_absolute(self):
        return Diagonal(values=torch.abs(self.values))

    def inverse(self):
        return Diagonal(values=1.0 / self.values)

    def to_dense(self):
        from .dense import Dense

        return Dense(values=torch.diag(self.values))

    def to_matrix_data(self) -> MatrixData:
        n = self.shape[0]
        idx = np.arange(n)
        return MatrixData(self.shape, idx, idx, types.to_host(self.values))

    write = to_matrix_data


@dataclasses.dataclass(eq=False)
class Identity(LinOp):
    """Identity LinOp; the default preconditioner (identity.hpp:131)."""

    n: int = 0
    value_dtype: torch.dtype = torch.float32

    @staticmethod
    def create(n, dtype=torch.float32):
        return Identity(n=int(n), value_dtype=types.to_torch_dtype(dtype))

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.value_dtype

    def apply(self, b):
        return _values_of(b)

    def apply_advanced(self, alpha, b, beta, x):
        return alpha * _values_of(b) + beta * _values_of(x)

    def transpose(self):
        return self

    conj_transpose = transpose

