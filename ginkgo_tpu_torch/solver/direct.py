"""Direct solver: an LU factorization and two triangular solves.

Counterpart of ``ginkgo_tpu/solver/direct.py`` (reference
core/solver/direct.cpp; experimental::solver::Direct = factorization::Lu +
lower/upper trs).  The factorization is a host set-up step; the solves run
on the factors' device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..base.linop import LinOp, as_2d
from ..factorization.lu import LuFactory
from .solver_base import SolveInfo
from .triangular import LowerTrsFactory, UpperTrsFactory


@dataclasses.dataclass(eq=False)
class Direct(LinOp):
    l_solver: Any
    u_solver: Any
    #: pivot permutation of the factorization (P A = L U): a solve takes
    #: L U x = b[row_perm]
    row_perm: Any = None
    #: back-permutation of a symmetrically reordered factor (P A P^T = L U):
    #: x = y[col_perm]
    col_perm: Any = None

    @property
    def shape(self):
        return self.l_solver.shape

    @property
    def dtype(self):
        return self.l_solver.dtype

    def apply(self, b):
        if self.row_perm is not None:
            b = b[self.row_perm.to(torch.int64)]
        y = self.u_solver.apply(self.l_solver.apply(b))
        if self.col_perm is not None:
            y = y[self.col_perm.to(torch.int64)]
        return y

    def solve(self, b, x0=None):
        x = self.apply(b)
        k = as_2d(x)[0].shape[1]
        return x, SolveInfo(
            iterations=torch.tensor(1, dtype=torch.int32, device=x.device),
            residual_norm=torch.zeros(k, device=x.device),
            converged=torch.ones(k, dtype=torch.bool, device=x.device),
        )

    @staticmethod
    def build(factorization=None, l_solver=None, u_solver=None, **kw):
        return DirectFactory(factorization, l_solver, u_solver)


class DirectFactory:
    def __init__(self, factorization=None, l_solver=None, u_solver=None):
        self.ff = factorization or LuFactory()
        self.lf = l_solver or LowerTrsFactory()
        self.uf = u_solver or UpperTrsFactory()

    def generate(self, A) -> Direct:
        fact = A if hasattr(A, "get_l_factor") else self.ff.generate(A)
        return Direct(
            l_solver=self.lf.generate(fact.get_l_factor()),
            u_solver=self.uf.generate(fact.get_u_factor()),
            row_perm=getattr(fact, "row_perm", None),
            col_perm=getattr(fact, "col_perm", None),
        )
