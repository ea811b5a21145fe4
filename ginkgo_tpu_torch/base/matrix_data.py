"""Host/device COO assembly staging.

Counterpart of ``ginkgo_tpu/base/matrix_data.py``.  Assembly (dedup,
sorting, zero removal) produces dynamic sizes, so ``MatrixData`` stays on
the host in numpy; ``DeviceMatrixData`` is the same triple as torch
tensors on a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class MatrixData:
    """Host COO triples; rows/cols int64 numpy, values numpy.

    Mirrors matrix_data.hpp:155 including the canonicalization helpers
    `sum_duplicates`, `sort_row_major`, `remove_zeros`
    (matrix_data.hpp:441-470).
    """

    shape: tuple
    rows: np.ndarray
    cols: np.ndarray
    values: np.ndarray

    # -- constructors --------------------------------------------------------

    @staticmethod
    def empty(shape, dtype=np.float32, index_dtype=np.int64):
        return MatrixData(
            tuple(shape),
            np.zeros(0, index_dtype),
            np.zeros(0, index_dtype),
            np.zeros(0, dtype),
        )

    @staticmethod
    def from_coo(shape, rows, cols, values):
        # int64 keys: int32 triplets would overflow the row-major flat key
        # rows*m + cols used by sum_duplicates once n*m exceeds 2^31
        rows = np.asarray(rows).astype(np.int64, copy=False)
        cols = np.asarray(cols).astype(np.int64, copy=False)
        values = np.asarray(values)
        return MatrixData(tuple(shape), rows, cols, values)

    @staticmethod
    def from_dense(dense, drop_tol: float = 0.0):
        dense = np.asarray(dense)
        mask = np.abs(dense) > drop_tol
        rows, cols = np.nonzero(mask)
        return MatrixData(dense.shape, rows, cols, dense[rows, cols])

    @staticmethod
    def diag(shape, diag_values):
        n = min(shape)
        idx = np.arange(n)
        return MatrixData(tuple(shape), idx, idx, np.asarray(diag_values)[:n])

    # -- canonicalization ----------------------------------------------------

    @property
    def nnz(self) -> int:
        return len(self.values)

    def sort_row_major(self) -> "MatrixData":
        if self.nnz > 1:
            # O(nnz) sortedness probe: canonical CSR triplets are already
            # row-major, and a lexsort costs seconds at 10^7 nnz
            key = self.rows.astype(np.int64) * np.int64(self.shape[1]) + self.cols
            if bool(np.all(key[:-1] <= key[1:])):
                return self
        order = np.lexsort((self.cols, self.rows))
        return MatrixData(
            self.shape, self.rows[order], self.cols[order], self.values[order]
        )

    def sum_duplicates(self) -> "MatrixData":
        d = self.sort_row_major()
        if d.nnz == 0:
            return d
        # run-length dedup on the sorted int64 keys
        key = d.rows.astype(np.int64) * np.int64(self.shape[1]) + d.cols
        first = np.empty(len(key), bool)
        first[0] = True
        np.not_equal(key[1:], key[:-1], out=first[1:])
        if bool(first.all()):  # no duplicates: skip the scatter-add
            return d
        seg = np.cumsum(first) - 1
        vals = np.zeros(int(seg[-1]) + 1, dtype=d.values.dtype)
        np.add.at(vals, seg, d.values)
        keep = np.nonzero(first)[0]
        return MatrixData(self.shape, d.rows[keep], d.cols[keep], vals)

    def remove_zeros(self) -> "MatrixData":
        keep = self.values != 0
        return MatrixData(
            self.shape, self.rows[keep], self.cols[keep], self.values[keep]
        )

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.values.dtype)
        np.add.at(out, (self.rows, self.cols), self.values)
        return out

    # -- structure edits ---------------------------------------------------

    def transpose(self) -> "MatrixData":
        return MatrixData(
            (self.shape[1], self.shape[0]), self.cols, self.rows, self.values
        )

    def conj_transpose(self) -> "MatrixData":
        return MatrixData(
            (self.shape[1], self.shape[0]),
            self.cols,
            self.rows,
            np.conj(self.values),
        )

    def astype(self, dtype) -> "MatrixData":
        return MatrixData(self.shape, self.rows, self.cols, self.values.astype(dtype))

    def to_device(self, *, device, index_dtype=torch.int32) -> "DeviceMatrixData":
        d = self.sum_duplicates()
        return DeviceMatrixData(
            rows=torch.as_tensor(d.rows, dtype=index_dtype, device=device),
            cols=torch.as_tensor(d.cols, dtype=index_dtype, device=device),
            values=torch.as_tensor(d.values, device=device),
            shape=d.shape,
        )


@dataclasses.dataclass(eq=False)
class DeviceMatrixData:
    """Device-resident sorted COO staging (device_matrix_data.hpp:63)."""

    rows: torch.Tensor
    cols: torch.Tensor
    values: torch.Tensor
    shape: tuple = (0, 0)

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self):
        return self.values.dtype

    def sort_row_major(self) -> "DeviceMatrixData":
        key = self.rows.to(torch.int64) * self.shape[1] + self.cols.to(torch.int64)
        order = torch.argsort(key, stable=True)
        return DeviceMatrixData(
            rows=self.rows[order],
            cols=self.cols[order],
            values=self.values[order],
            shape=self.shape,
        )

    def to_host(self) -> MatrixData:
        from .types import to_host

        return MatrixData(
            self.shape,
            to_host(self.rows),
            to_host(self.cols),
            to_host(self.values),
        )
