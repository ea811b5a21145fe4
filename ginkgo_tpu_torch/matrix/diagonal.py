"""Diagonal, Identity, Permutation and RowGatherer: small structural LinOps.

Counterpart of ``ginkgo_tpu/matrix/diagonal.py`` (reference
include/ginkgo/core/matrix/diagonal.hpp:270, identity.hpp:131/166,
permutation.hpp:271, row_gatherer.hpp:176).
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

    def to_csr(self, strategy="auto"):
        from .csr import Csr

        n = self.shape[0]
        idx = torch.arange(n + 1, dtype=torch.int32, device=self.values.device)
        return Csr(row_ptrs=idx, col_idxs=idx[:n], values=self.values, shape=self.shape,
                   strategy=strategy)

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


class IdentityFactory:
    """Factory of the Identity (identity.hpp:166): generate(A) is the
    Identity of A's rows."""

    def __init__(self, dtype=torch.float32):
        self.dtype = dtype

    def generate(self, A):
        return Identity.create(A.shape[0], self.dtype)


@dataclasses.dataclass(eq=False)
class Permutation(LinOp):
    """Permutation LinOp (permutation.hpp:271): apply(b) = b[perm]."""

    permutation: torch.Tensor  # (n,) int32

    @staticmethod
    def create(perm, *, device):
        return Permutation(permutation=torch.as_tensor(perm, device=device).to(torch.int32))

    @property
    def shape(self):
        n = self.permutation.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.permutation.dtype

    def apply(self, b):
        arr, was_1d = as_2d(b)
        return restore_1d(arr[self.permutation.to(torch.int64)], was_1d)

    def inverse_apply(self, b):
        arr, was_1d = as_2d(b)
        out = torch.zeros_like(arr)
        out[self.permutation.to(torch.int64)] = arr
        return restore_1d(out, was_1d)

    def transpose(self):
        inv = torch.empty_like(self.permutation)
        inv[self.permutation.to(torch.int64)] = torch.arange(
            self.permutation.shape[0], dtype=self.permutation.dtype,
            device=self.permutation.device)
        return Permutation(permutation=inv)

    def to_host(self) -> np.ndarray:
        return types.to_host(self.permutation)


@dataclasses.dataclass(eq=False)
class RowGatherer(LinOp):
    """Rows of b as a LinOp (row_gatherer.hpp:176); rectangular (k, n)."""

    row_idxs: torch.Tensor  # (k,) int32
    n_cols: int = 0

    @staticmethod
    def create(row_idxs, n_cols, *, device):
        return RowGatherer(row_idxs=torch.as_tensor(row_idxs, device=device).to(torch.int32),
                           n_cols=int(n_cols))

    @property
    def shape(self):
        return (self.row_idxs.shape[0], self.n_cols)

    @property
    def dtype(self):
        return self.row_idxs.dtype

    def apply(self, b):
        arr, was_1d = as_2d(b)
        return restore_1d(arr[self.row_idxs.to(torch.int64)], was_1d)
