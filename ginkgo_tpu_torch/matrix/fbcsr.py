"""FBCSR: fixed-size block CSR (BSR).

Counterpart of ``ginkgo_tpu/matrix/fbcsr.py`` (reference
include/ginkgo/core/matrix/fbcsr.hpp): dense bs x bs blocks on a block-CSR
skeleton, stored as a (num_blocks, bs, bs) batch.  ``apply`` takes the
streaming route on a CUDA tensor; where it declines, or on the CPU, a
batched product of each block with its gathered x block, then a sorted
segment sum over the block rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..base import types
from ..base.linop import LinOp, _scalar, as_2d, restore_1d
from ..base.matrix_data import MatrixData
from ..ops import spmv as spmv_ops


@dataclasses.dataclass(eq=False)
class Fbcsr(LinOp):
    block_row_ptrs: torch.Tensor  # (nbr + 1,) int32
    block_cols: torch.Tensor  # (nb,) int32
    blocks: torch.Tensor  # (nb, bs, bs)
    shape: tuple = (0, 0)
    block_size: int = 1

    @staticmethod
    def from_matrix_data(data: MatrixData, block_size: int, *, device) -> "Fbcsr":
        d = data.sum_duplicates()
        bs = int(block_size)
        n, m = d.shape
        nbr = -(-n // bs)
        nbc = -(-m // bs)
        # int64 block keys: a Csr's host triples carry int32 indices, whose
        # keys pass 2^31 at nbr * nbc >= 2^31 (the JAX package's wrap there)
        rows, cols = d.rows.astype(np.int64), d.cols.astype(np.int64)
        key = (rows // bs) * nbc + cols // bs
        uniq, inv = np.unique(key, return_inverse=True)
        nb = len(uniq)
        blocks = np.zeros((max(nb, 1), bs, bs), d.values.dtype)
        blocks[inv, rows % bs, cols % bs] = d.values
        rp = np.zeros(nbr + 1, np.int64)
        np.add.at(rp, uniq // nbc + 1, 1)
        rp = np.cumsum(rp)
        return Fbcsr(
            block_row_ptrs=torch.as_tensor(rp, dtype=torch.int32, device=device),
            block_cols=torch.as_tensor(uniq % nbc if nb else np.zeros(1), dtype=torch.int32,
                                       device=device),
            blocks=torch.as_tensor(blocks, device=device),
            shape=(n, m),
            block_size=bs,
        )

    read = from_matrix_data

    @staticmethod
    def from_csr(csr, block_size: int) -> "Fbcsr":
        return Fbcsr.from_matrix_data(csr.to_matrix_data(), block_size,
                                      device=csr.device).astype(csr.dtype)

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def device(self):
        return self.blocks.device

    @property
    def num_blocks(self) -> int:
        return self.blocks.shape[0]

    @property
    def nnz(self) -> int:
        return self.blocks.numel()

    def _block_product(self, arr):
        """Each block times its gathered x block, summed over the block rows
        in block order; computed in the arithmetic dtype and returned in
        the promoted one."""
        bs = self.block_size
        n, m = self.shape
        k = arr.shape[1]
        nbr = self.block_row_ptrs.shape[0] - 1
        work = torch.promote_types(types.arithmetic_dtype(self.dtype), arr.dtype)
        mpad = -(-m // bs) * bs
        xp = torch.zeros((mpad, k), dtype=work, device=arr.device)
        xp[:m] = arr
        gathered = xp.view(-1, bs, k)[self.block_cols.to(torch.int64)]  # (nb, bs, k)
        prod = torch.bmm(self.blocks.to(work), gathered)  # (nb, bs, k)
        brids = spmv_ops.row_ids_from_ptrs(self.block_row_ptrs, self.num_blocks)
        ysum = torch.zeros((nbr, bs, k), dtype=work, device=arr.device)
        ysum.index_add_(0, brids.to(torch.int64), prod)
        return ysum.reshape(nbr * bs, k)[:n].to(torch.promote_types(self.dtype, arr.dtype))

    def apply(self, b):
        arr, was_1d = as_2d(b)
        out = spmv_ops.try_streaming(self, arr)
        if out is None:
            out = self._block_product(arr)
        return restore_1d(out, was_1d)

    def apply_advanced(self, alpha, b, beta, x):
        arr, was_1d = as_2d(b)
        xa, _ = as_2d(x)
        return restore_1d(_scalar(alpha) * as_2d(self.apply(arr))[0] + _scalar(beta) * xa,
                          was_1d)

    def compute_absolute(self):
        return self.replace(blocks=torch.abs(self.blocks))

    def extract_diagonal(self):
        return self.to_csr().extract_diagonal()

    def transpose(self) -> "Fbcsr":
        return Fbcsr.from_matrix_data(self.to_matrix_data().transpose(), self.block_size,
                                      device=self.device).astype(self.dtype)

    def to_matrix_data(self) -> MatrixData:
        """The stored entries inside the matrix, row-major sorted; stored
        zeros are dropped."""
        bs = self.block_size
        brids = types.to_host(spmv_ops.row_ids_from_ptrs(self.block_row_ptrs, self.num_blocks))
        bcols = types.to_host(self.block_cols)
        blocks = types.to_host(self.blocks)
        li, lj = np.meshgrid(np.arange(bs), np.arange(bs), indexing="ij")
        rows = (brids[:, None, None].astype(np.int64) * bs + li[None]).ravel()
        cols = (bcols[:, None, None].astype(np.int64) * bs + lj[None]).ravel()
        vals = blocks.ravel()
        keep = (vals != 0) & (rows < self.shape[0]) & (cols < self.shape[1])
        return MatrixData.from_coo(self.shape, rows[keep], cols[keep], vals[keep]).sort_row_major()

    write = to_matrix_data

    def astype(self, dtype):
        return self.replace(blocks=self.blocks.to(dtype))

    def to_csr(self, strategy="auto"):
        from .csr import Csr

        return Csr.from_matrix_data(self.to_matrix_data(), device=self.device,
                                    strategy=strategy).astype(self.dtype)

    def to_dense(self):
        return self.to_csr().to_dense()
