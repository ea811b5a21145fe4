"""Scalar Jacobi preconditioner.

Counterpart of the scalar path of ``ginkgo_tpu/preconditioner/jacobi.py``
(``max_block_size=1``, jacobi.py:229-246; reference jacobi.hpp:203): the
inverted diagonal, with zero diagonal entries mapped to 1.  Block Jacobi
(block detection, batched inversion, adaptive-precision storage) is not
ported yet and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..base.exceptions import NotImplementedError_
from ..base.linop import LinOp, as_2d, restore_1d


@dataclasses.dataclass(eq=False)
class Jacobi(LinOp):
    inv_diag: Any  # (n,) inverted diagonal
    n: int = 0
    max_block_size: int = 1

    @staticmethod
    def build(max_block_size: int = 1, block_pointers=None,
              storage_optimization=None) -> "JacobiFactory":
        return JacobiFactory(
            max_block_size=max_block_size,
            block_pointers=block_pointers,
            storage_optimization=storage_optimization,
        )

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.inv_diag.dtype

    def apply(self, b):
        arr, was_1d = as_2d(b)
        return restore_1d(self.inv_diag[:, None] * arr, was_1d)

    def transpose(self) -> "Jacobi":
        return self

    conj_transpose = transpose

    def to_dense(self):
        from ..matrix.dense import Dense

        return Dense(values=torch.diag(self.inv_diag))


class JacobiFactory:
    """jacobi.hpp factory analog; generate() inverts the diagonal."""

    def __init__(self, max_block_size: int = 1, block_pointers=None,
                 storage_optimization=None):
        self.max_block_size = int(max_block_size)
        self.block_pointers = block_pointers
        self.storage_optimization = storage_optimization

    def generate(self, A) -> Jacobi:
        if (self.max_block_size != 1 or self.block_pointers is not None
                or self.storage_optimization is not None):
            raise NotImplementedError_(
                "block Jacobi is not ported yet: use max_block_size=1"
            )
        diag = A.extract_diagonal().values
        ok = diag != 0
        one = torch.ones_like(diag)
        inv = torch.where(ok, 1.0 / torch.where(ok, diag, one), one)
        return Jacobi(inv_diag=inv, n=A.shape[0], max_block_size=1)
