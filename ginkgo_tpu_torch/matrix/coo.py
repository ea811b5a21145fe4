"""COO sparse matrix.

Counterpart of ``ginkgo_tpu/matrix/coo.py`` (reference
include/ginkgo/core/matrix/coo.hpp:372).  Entries are kept row-major
sorted.  ``apply`` takes the streaming route (``ops/spmv.try_streaming``:
the CSR view's PELL or WELL plan, kernels K5/K6 or K8/K9) on a CUDA
tensor, and the sorted segment sum ``coo_spmv`` where the route declines or
the tensor is on the CPU; ``apply2`` (x += A b without zeroing,
core/matrix/coo.cpp:62-65) is always the segment sum, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses

import torch

from ..base import types
from ..base.linop import LinOp, _scalar, as_2d, restore_1d
from ..base.matrix_data import MatrixData
from ..ops import spmv as spmv_ops


@dataclasses.dataclass(eq=False)
class Coo(LinOp):
    rows: torch.Tensor  # (nnz,)
    cols: torch.Tensor  # (nnz,)
    values: torch.Tensor  # (nnz,)
    shape: tuple = (0, 0)

    @staticmethod
    def from_matrix_data(data: MatrixData, *, device, index_dtype=torch.int32) -> "Coo":
        d = data.sum_duplicates()
        return Coo(
            rows=torch.as_tensor(d.rows, dtype=index_dtype, device=device),
            cols=torch.as_tensor(d.cols, dtype=index_dtype, device=device),
            values=torch.as_tensor(d.values, device=device),
            shape=tuple(d.shape),
        )

    read = from_matrix_data

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    def apply(self, b):
        arr, was_1d = as_2d(b)
        out = spmv_ops.try_streaming(self, arr)
        if out is None:
            out = spmv_ops.coo_spmv(self.rows, self.cols, self.values, arr, self.shape[0])
        return restore_1d(out, was_1d)

    def apply2(self, b, x):
        """x + A b (reference coo apply2)."""
        arr, was_1d = as_2d(b)
        xa, _ = as_2d(x)
        out = xa + spmv_ops.coo_spmv(self.rows, self.cols, self.values, arr, self.shape[0])
        return restore_1d(out, was_1d)

    def apply_advanced(self, alpha, b, beta, x):
        arr, was_1d = as_2d(b)
        xa, _ = as_2d(x)
        return restore_1d(spmv_ops.advanced(self.apply(arr), alpha, beta, xa), was_1d)

    def transpose(self) -> "Coo":
        # order by (column, row): a stable sort on the combined key
        key = self.cols.to(torch.int64) * max(self.shape[0], 1) + self.rows.to(torch.int64)
        order = torch.argsort(key, stable=True)
        return Coo(rows=self.cols[order], cols=self.rows[order], values=self.values[order],
                   shape=(self.shape[1], self.shape[0]))

    def conj_transpose(self) -> "Coo":
        t = self.transpose()
        return t.replace(values=torch.conj(t.values))

    def scale(self, alpha) -> "Coo":
        return self.replace(values=self.values * _scalar(alpha))

    def compute_absolute(self) -> "Coo":
        return self.replace(values=torch.abs(self.values))

    def extract_diagonal(self):
        from .diagonal import Diagonal

        n = min(self.shape)
        on_diag = (self.rows == self.cols) & (self.rows < n)
        diag = torch.zeros(n, dtype=self.dtype, device=self.device)
        diag.index_add_(0, self.rows[on_diag].to(torch.int64), self.values[on_diag])
        return Diagonal(values=diag)

    def to_matrix_data(self) -> MatrixData:
        return MatrixData(self.shape, types.to_host(self.rows), types.to_host(self.cols),
                          types.to_host(self.values))

    write = to_matrix_data

    def to_csr(self, strategy="auto"):
        from .csr import Csr

        counts = torch.bincount(self.rows.to(torch.int64), minlength=self.shape[0])
        row_ptrs = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        return Csr(row_ptrs=row_ptrs.to(self.rows.dtype), col_idxs=self.cols,
                   values=self.values, shape=self.shape, strategy=strategy)

    def to_dense(self):
        from .dense import Dense

        vals = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        vals.index_put_((self.rows.to(torch.int64), self.cols.to(torch.int64)), self.values,
                        accumulate=True)
        return Dense(values=vals)

    def to_coo(self):
        return self

    def astype(self, dtype) -> "Coo":
        return self.replace(values=self.values.to(dtype))
