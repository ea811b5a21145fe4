"""ScaledReordered: a solver wrapped in row/column scaling and a permutation.

Counterpart of ``ginkgo_tpu/reorder/scaled_reordered.py`` (reference
core/reorder/scaled_reordered.cpp): solves (R P A P^T C) y = R P b and
returns x = P^T C y, R and C diagonal scalings and P a permutation (from
``Rcm``, say).  The scaled and permuted operator is built on the host at
generate time, as in the JAX package; the inner solver runs on A's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..base import types
from ..base.linop import LinOp, as_2d, restore_1d
from ..base.matrix_data import MatrixData


@dataclasses.dataclass(eq=False)
class ScaledReordered(LinOp):
    inner_solver: Any
    permutation: Any  # Permutation or None
    row_scaling: Any  # Diagonal or None
    col_scaling: Any

    @property
    def shape(self):
        return self.inner_solver.shape

    @property
    def dtype(self):
        return self.inner_solver.dtype

    def apply(self, b):
        rhs, was_1d = as_2d(b)
        if self.row_scaling is not None:
            rhs = self.row_scaling.apply(rhs)
        if self.permutation is not None:
            rhs = self.permutation.apply(rhs)
        y = self.inner_solver.apply(rhs)
        if not isinstance(y, torch.Tensor):  # a Dense
            y = y.values
        if y.dim() == 1:
            y = y[:, None]
        if self.permutation is not None:
            y = self.permutation.inverse_apply(y)
        if self.col_scaling is not None:
            y = self.col_scaling.apply(y)
        return restore_1d(y, was_1d)

    solve = apply


class ScaledReorderedFactory:
    """scaled_reordered factory: a reordering (``RcmFactory``, say), optional
    row and column scaling ``Diagonal``s, and the inner solver's factory."""

    def __init__(self, solver, reordering=None, row_scaling=None, col_scaling=None):
        self.solver_factory = solver
        self.reordering = reordering
        self.row_scaling = row_scaling
        self.col_scaling = col_scaling

    def generate(self, A) -> ScaledReordered:
        csr = A.to_csr() if hasattr(A, "to_csr") else A
        dev = csr.device
        work = csr
        for scaling, side in ((self.row_scaling, "row"), (self.col_scaling, "col")):
            if scaling is None:
                continue
            d = types.to_host(scaling.values)
            sp = work.to_scipy().tocoo()
            vals = d[sp.row] * sp.data if side == "row" else sp.data * d[sp.col]
            work = type(csr).from_matrix_data(
                MatrixData.from_coo(sp.shape, sp.row, sp.col, vals), device=dev)
        perm = None
        if self.reordering is not None:
            perm = self.reordering.generate(work)
            work = work.symm_permute(perm.to_host())
        return ScaledReordered(
            inner_solver=self.solver_factory.generate(work),
            permutation=perm,
            row_scaling=self.row_scaling,
            col_scaling=self.col_scaling,
        )
