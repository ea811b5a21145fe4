"""SparsityCsr: a CSR pattern with one implicit value.

Counterpart of ``ginkgo_tpu/matrix/sparsity_csr.py`` (reference
include/ginkgo/core/matrix/sparsity_csr.hpp): an adjacency structure with
an SpMV by the implicit value, diagonal removal and transposition.
``apply`` takes the streaming route on a CUDA tensor and the classical
gather product by the value where the route declines or the tensor is on
the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..base import types
from ..base.linop import LinOp, as_2d, restore_1d
from ..base.matrix_data import MatrixData
from ..ops import spmv as spmv_ops


@dataclasses.dataclass(eq=False)
class SparsityCsr(LinOp):
    row_ptrs: torch.Tensor
    col_idxs: torch.Tensor
    value: torch.Tensor  # 0-d, the implicit value (default 1)
    shape: tuple = (0, 0)

    @staticmethod
    def from_matrix_data(data: MatrixData, value=1.0, *, device) -> "SparsityCsr":
        """The pattern of ``data``; the value takes ``data``'s value dtype."""
        from .csr import Csr

        c = Csr.from_matrix_data(data, device=device)
        dtype = types.to_torch_dtype(np.asarray(data.values).dtype)
        return SparsityCsr(row_ptrs=c.row_ptrs, col_idxs=c.col_idxs,
                           value=torch.as_tensor(np.asarray(value), device=device).to(dtype),
                           shape=c.shape)

    read = from_matrix_data

    @property
    def dtype(self):
        return self.value.dtype

    @property
    def device(self):
        return self.col_idxs.device

    @property
    def nnz(self) -> int:
        return self.col_idxs.shape[0]

    num_nonzeros = nnz

    def _values(self):
        return self.value.reshape(()).expand(self.nnz).contiguous()

    def apply(self, b):
        arr, was_1d = as_2d(b)
        out = spmv_ops.try_streaming(self, arr)
        if out is None:
            out = spmv_ops.csr_spmv_classical(self.row_ptrs, self.col_idxs, self._values(), arr,
                                              self.shape[0])
        return restore_1d(out, was_1d)

    def transpose(self) -> "SparsityCsr":
        from .csr import Csr

        t = Csr(row_ptrs=self.row_ptrs, col_idxs=self.col_idxs,
                values=torch.ones(self.nnz, dtype=self.dtype, device=self.device),
                shape=self.shape).transpose()
        return SparsityCsr(row_ptrs=t.row_ptrs, col_idxs=t.col_idxs, value=self.value,
                           shape=t.shape)

    def to_adjacency_matrix(self) -> "SparsityCsr":
        """The pattern without its diagonal entries; as in the JAX package,
        the value is rebuilt from float64 data, so it comes back float64."""
        rp = types.to_host(self.row_ptrs)
        ci = types.to_host(self.col_idxs)
        rows = np.repeat(np.arange(self.shape[0]), rp[1:] - rp[:-1])
        keep = rows != ci
        data = MatrixData.from_coo(self.shape, rows[keep], ci[keep], np.ones(keep.sum()))
        return SparsityCsr.from_matrix_data(data, value=types.to_host(self.value),
                                            device=self.device)

    def astype(self, dtype):
        return self.replace(value=self.value.to(dtype))

    def to_matrix_data(self) -> MatrixData:
        rp = types.to_host(self.row_ptrs)
        rows = np.repeat(np.arange(self.shape[0]), rp[1:] - rp[:-1])
        return MatrixData.from_coo(self.shape, rows, types.to_host(self.col_idxs),
                                   np.full(len(rows), float(types.to_host(self.value))))

    write = to_matrix_data

    def to_csr(self, strategy="auto"):
        from .csr import Csr

        return Csr(row_ptrs=self.row_ptrs, col_idxs=self.col_idxs, values=self._values(),
                   shape=self.shape, strategy=strategy)

    def to_dense(self):
        return self.to_csr().to_dense()
