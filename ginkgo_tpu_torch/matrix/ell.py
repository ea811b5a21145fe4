"""ELL and SELL-P padded sparse formats.

Counterpart of ``ginkgo_tpu/matrix/ell.py`` (reference
include/ginkgo/core/matrix/ell.hpp and sellp.hpp: ``default_slice_size``
64, ``stride_factor``, slice-local padding through the ``slice_sets``
prefix sum).  ELL stores (n, K) row-major, padding at column 0 with value
0; SELL-P stacks its slices as (total_slots, slice_size).  ``apply`` takes
the streaming route (``ops/spmv.try_streaming``) on a CUDA tensor and the
format's own gather product (``ell_spmv``, ``sellp_spmv``) where the route
declines or the tensor is on the CPU.  The conversions from ``Csr`` place
every entry in one scatter on the matrix's device (the JAX package loops
over the rows of each slice on the host).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..base import types
from ..base.linop import LinOp, _scalar, as_2d, restore_1d
from ..base.matrix_data import MatrixData
from ..ops import spmv as spmv_ops


def _entry_positions(csr):
    """Per stored entry of ``csr``: its row (int64) and its place in the row."""
    rows = csr.row_ids().to(torch.int64)
    pos = torch.arange(csr.nnz, dtype=torch.int64, device=csr.device) - \
        csr.row_ptrs.to(torch.int64)[rows]
    return rows, pos


@dataclasses.dataclass(eq=False)
class Ell(LinOp):
    col_idxs: torch.Tensor  # (n, K) int32, padding column 0
    values: torch.Tensor  # (n, K), padding value 0
    shape: tuple = (0, 0)

    @staticmethod
    def from_matrix_data(data: MatrixData, max_nnz_per_row: int | None = None, *,
                         device) -> "Ell":
        from .csr import Csr

        return Ell.from_csr(Csr.from_matrix_data(data, device=device), max_nnz_per_row)

    read = from_matrix_data

    @staticmethod
    def from_csr(csr, max_nnz_per_row: int | None = None) -> "Ell":
        """K = ``max_nnz_per_row`` (the longest row by default, at least 1);
        a longer row keeps its first K entries, as in the JAX package."""
        rl = csr.host_row_lengths()
        K = max(int(max_nnz_per_row or (rl.max() if len(rl) else 0)), 1)
        n = csr.shape[0]
        rows, pos = _entry_positions(csr)
        keep = pos < K
        cols = torch.zeros((n, K), dtype=torch.int32, device=csr.device)
        vals = torch.zeros((n, K), dtype=csr.dtype, device=csr.device)
        cols[rows[keep], pos[keep]] = csr.col_idxs[keep].to(torch.int32)
        vals[rows[keep], pos[keep]] = csr.values[keep]
        return Ell(col_idxs=cols, values=vals, shape=tuple(csr.shape))

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def max_nnz_per_row(self) -> int:
        return self.values.shape[1]

    @property
    def nnz(self) -> int:
        return self.values.numel()

    def apply(self, b):
        arr, was_1d = as_2d(b)
        out = spmv_ops.try_streaming(self, arr)
        if out is None:
            out = spmv_ops.ell_spmv(self.col_idxs, self.values, arr, self.shape[0])
        return restore_1d(out, was_1d)

    def apply_advanced(self, alpha, b, beta, x):
        arr, was_1d = as_2d(b)
        xa, _ = as_2d(x)
        return restore_1d(spmv_ops.advanced(self.apply(arr), alpha, beta, xa), was_1d)

    def extract_diagonal(self):
        from .diagonal import Diagonal

        n = min(self.shape)
        rows = torch.arange(self.shape[0], device=self.device)[:, None]
        on_diag = (self.col_idxs == rows) & (self.values != 0)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        return Diagonal(values=torch.where(on_diag, self.values, zero).sum(dim=1)[:n])

    def compute_absolute(self):
        return self.replace(values=torch.abs(self.values))

    def scale(self, alpha):
        return self.replace(values=self.values * _scalar(alpha))

    def to_matrix_data(self) -> MatrixData:
        """The stored entries, row-major sorted; stored zeros are dropped."""
        cols = types.to_host(self.col_idxs)
        vals = types.to_host(self.values)
        n, K = vals.shape
        rows = np.repeat(np.arange(n), K)
        keep = vals.ravel() != 0
        return MatrixData.from_coo(self.shape, rows[keep], cols.ravel()[keep],
                                   vals.ravel()[keep]).sort_row_major()

    write = to_matrix_data

    def to_csr(self, strategy="auto"):
        from .csr import Csr

        return Csr.from_matrix_data(self.to_matrix_data(), device=self.device,
                                    strategy=strategy).astype(self.dtype)

    def astype(self, dtype):
        return self.replace(values=self.values.to(dtype))

    def to_dense(self):
        from .dense import Dense

        rows = torch.arange(self.shape[0], device=self.device)[:, None].expand(
            -1, self.max_nnz_per_row)
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        out.index_put_((rows, self.col_idxs.to(torch.int64)), self.values, accumulate=True)
        return Dense(values=out)


@dataclasses.dataclass(eq=False)
class Sellp(LinOp):
    slice_sets: torch.Tensor  # (num_slices + 1,) int32 slot-row prefix sum
    col_idxs: torch.Tensor  # (total_slots, C) int32
    values: torch.Tensor  # (total_slots, C)
    shape: tuple = (0, 0)
    slice_size: int = 64

    default_slice_size = 64  # sellp.hpp:45
    default_stride_factor = 1  # sellp.hpp:47

    @staticmethod
    def from_matrix_data(data: MatrixData, slice_size=64, stride_factor=1, *,
                         device) -> "Sellp":
        from .csr import Csr

        return Sellp.from_csr(Csr.from_matrix_data(data, device=device), slice_size,
                              stride_factor)

    read = from_matrix_data

    @staticmethod
    def from_csr(csr, slice_size: int = 64, stride_factor: int = 1) -> "Sellp":
        """Slice s holds rows [s C, (s + 1) C) in slot-rows [slice_sets[s],
        slice_sets[s + 1]), as many as its longest row rounded up to
        ``stride_factor``; entry j of row r sits at slot-row slice_sets[r //
        C] + j, lane r % C."""
        n = csr.shape[0]
        C = int(slice_size)
        rl = csr.host_row_lengths()
        num_slices = max(-(-n // C), 1)
        rl_pad = np.zeros(num_slices * C, np.int64)
        rl_pad[:n] = rl
        slice_len = rl_pad.reshape(num_slices, C).max(axis=1)
        slice_len = -(-slice_len // stride_factor) * stride_factor
        slice_sets = np.zeros(num_slices + 1, np.int64)
        slice_sets[1:] = np.cumsum(slice_len)
        total = int(slice_sets[-1])
        cols = torch.zeros((max(total, 1), C), dtype=torch.int32, device=csr.device)
        vals = torch.zeros((max(total, 1), C), dtype=csr.dtype, device=csr.device)
        rows, pos = _entry_positions(csr)
        starts = torch.as_tensor(slice_sets, device=csr.device)
        slot = starts[rows // C] + pos
        cols[slot, rows % C] = csr.col_idxs.to(torch.int32)
        vals[slot, rows % C] = csr.values
        return Sellp(slice_sets=torch.as_tensor(slice_sets, dtype=torch.int32, device=csr.device),
                     col_idxs=cols, values=vals, shape=tuple(csr.shape), slice_size=C)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def num_slices(self) -> int:
        return self.slice_sets.shape[0] - 1

    @property
    def total_cols(self) -> int:  # total slot-rows (reference: total_cols)
        return self.values.shape[0]

    def apply(self, b):
        arr, was_1d = as_2d(b)
        out = spmv_ops.try_streaming(self, arr)
        if out is None:
            out = spmv_ops.sellp_spmv(self.slice_sets, self.col_idxs, self.values, arr,
                                      self.shape[0], self.slice_size)
        return restore_1d(out, was_1d)

    def apply_advanced(self, alpha, b, beta, x):
        arr, was_1d = as_2d(b)
        xa, _ = as_2d(x)
        return restore_1d(spmv_ops.advanced(self.apply(arr), alpha, beta, xa), was_1d)

    def compute_absolute(self):
        return self.replace(values=torch.abs(self.values))

    def scale(self, alpha):
        return self.replace(values=self.values * _scalar(alpha))

    def extract_diagonal(self):
        return self.to_csr().extract_diagonal()

    def to_matrix_data(self) -> MatrixData:
        """The stored entries inside the matrix, row-major sorted; stored
        zeros are dropped."""
        ss = types.to_host(self.slice_sets).astype(np.int64)
        cols = types.to_host(self.col_idxs)
        vals = types.to_host(self.values)
        C = self.slice_size
        total = int(ss[-1])
        slice_of = np.repeat(np.arange(self.num_slices), np.diff(ss))
        rows = slice_of[:, None] * C + np.arange(C)[None, :]
        keep = (vals[:total] != 0) & (rows < self.shape[0])
        return MatrixData.from_coo(self.shape, rows[keep], cols[:total][keep],
                                   vals[:total][keep]).sort_row_major()

    write = to_matrix_data

    def to_csr(self, strategy="auto"):
        from .csr import Csr

        return Csr.from_matrix_data(self.to_matrix_data(), device=self.device,
                                    strategy=strategy).astype(self.dtype)

    def astype(self, dtype):
        return self.replace(values=self.values.to(dtype))

    def to_dense(self):
        return self.to_csr().to_dense()
