"""Hybrid (ELL + COO tail) format.

Counterpart of ``ginkgo_tpu/matrix/hybrid.py`` (reference
include/ginkgo/core/matrix/hybrid.hpp: the partition strategies
``column_limit``, ``imbalance_limit`` (default the 80th percentile of the
row lengths) and ``automatic``).  Each row's first K entries go to the
ELL part, the rest to a COO tail.  ``apply`` takes the streaming route
with one plan for both parts on a CUDA tensor; where it declines, or on
the CPU, the ELL part's product (which tries the route on its own) plus
the COO tail's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..base.linop import LinOp, _scalar, as_2d, restore_1d
from ..base.matrix_data import MatrixData
from ..ops import spmv as spmv_ops
from .coo import Coo
from .ell import Ell, _entry_positions


def _ell_limit(row_lengths: np.ndarray, strategy: str, arg) -> int:
    if strategy == "column_limit":
        return int(arg)
    if strategy == "imbalance_limit":
        percent = arg if arg is not None else 0.8  # hybrid.hpp default
        if len(row_lengths) == 0:
            return 0
        return int(np.quantile(row_lengths, percent))
    if strategy == "automatic":
        # the reference's automatic: the imbalance limit at its default
        if len(row_lengths) == 0:
            return 0
        return int(np.quantile(row_lengths, 0.8))
    raise ValueError(strategy)


@dataclasses.dataclass(eq=False)
class Hybrid(LinOp):
    ell: Ell
    coo: Coo
    shape: tuple = (0, 0)

    @staticmethod
    def from_matrix_data(data: MatrixData, strategy: str = "automatic", strategy_arg=None, *,
                         device) -> "Hybrid":
        from .csr import Csr

        return Hybrid.from_csr(Csr.from_matrix_data(data, device=device), strategy,
                               strategy_arg)

    read = from_matrix_data

    @staticmethod
    def from_csr(csr, strategy: str = "automatic", strategy_arg=None) -> "Hybrid":
        rl = csr.host_row_lengths()
        K = max(_ell_limit(rl, strategy, strategy_arg), 1)
        rows, pos = _entry_positions(csr)
        tail = pos >= K
        coo = Coo(rows=rows[tail].to(torch.int32), cols=csr.col_idxs[tail].to(torch.int32),
                  values=csr.values[tail], shape=tuple(csr.shape))
        return Hybrid(ell=Ell.from_csr(csr, K), coo=coo, shape=tuple(csr.shape))

    @property
    def dtype(self):
        return self.ell.dtype

    @property
    def device(self):
        return self.ell.device

    @property
    def nnz(self) -> int:
        return self.ell.nnz + self.coo.nnz

    def apply(self, b):
        arr, was_1d = as_2d(b)
        y = spmv_ops.try_streaming(self, arr)  # one plan for the ELL and COO parts
        if y is None:
            y = as_2d(self.ell.apply(arr))[0]
            if self.coo.nnz > 0:
                y = as_2d(self.coo.apply2(arr, y))[0]
        return restore_1d(y, was_1d)

    def apply_advanced(self, alpha, b, beta, x):
        arr, was_1d = as_2d(b)
        xa, _ = as_2d(x)
        return restore_1d(_scalar(alpha) * as_2d(self.apply(arr))[0] + _scalar(beta) * xa,
                          was_1d)

    def compute_absolute(self):
        return Hybrid(ell=self.ell.compute_absolute(), coo=self.coo.compute_absolute(),
                      shape=self.shape)

    def extract_diagonal(self):
        return self.to_csr().extract_diagonal()

    def to_matrix_data(self) -> MatrixData:
        de = self.ell.to_matrix_data()
        dc = self.coo.to_matrix_data()
        return MatrixData.from_coo(
            self.shape, np.concatenate([de.rows, dc.rows]), np.concatenate([de.cols, dc.cols]),
            np.concatenate([de.values, dc.values])).sort_row_major()

    write = to_matrix_data

    def astype(self, dtype):
        return self.replace(ell=self.ell.astype(dtype), coo=self.coo.astype(dtype))

    def to_csr(self, strategy="auto"):
        from .csr import Csr

        return Csr.from_matrix_data(self.to_matrix_data(), device=self.device,
                                    strategy=strategy).astype(self.dtype)

    def to_dense(self):
        return self.to_csr().to_dense()
