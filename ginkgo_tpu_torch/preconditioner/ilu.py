"""ILU / IC preconditioners: the L and U factors wrapped into two inner
triangular solvers.

Counterpart of ``ginkgo_tpu/preconditioner/ilu.py`` (reference
include/ginkgo/core/preconditioner/ilu.hpp:114, Ilu<LSolver, USolver,
ReverseApply>, and ic.hpp:107, Ic<LSolver>: solve L, then L^H).  The inner
solver factories default to the triangular solvers of
``solver/triangular.py``; any solver factory can take their place, as the
reference's template parameters allow.  An Ilu whose two solvers run the
'sweeps' algorithm on ``Dia`` triangles is applied inside the whole-solve
kernels K23 (``Cg``) and K24 (``Bicgstab``) on a ``Dia`` operator.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..base.linop import LinOp
from ..factorization.factorization import Factorization
from ..factorization.par_ilu import ParIcFactory, ParIluFactory
from ..solver.triangular import LowerTrsFactory, UpperTrsFactory


@dataclasses.dataclass(eq=False)
class IluPreconditioner(LinOp):
    l_solver: Any
    u_solver: Any
    reverse_apply: bool = False

    @property
    def shape(self):
        return self.l_solver.shape

    @property
    def dtype(self):
        return self.l_solver.dtype

    def apply(self, b):
        if self.reverse_apply:
            return self.l_solver.apply(self.u_solver.apply(b))
        return self.u_solver.apply(self.l_solver.apply(b))

    def get_l_solver(self):
        return self.l_solver

    def get_u_solver(self):
        return self.u_solver


def _reject_reordered(fact, what):
    if getattr(fact, "col_perm", None) is not None:
        raise ValueError(
            f"the factorization carries a fill-reducing reorder; an {what} preconditioner "
            "would silently drop the permutations: use solver.Direct, or generate the "
            "factorization with reorder=None")


class IluPreconditionerFactory:
    """preconditioner::Ilu factory.  generate() takes a system matrix (run
    through ``factorization_factory`` first, ParILU by default, as in the
    reference), or a Factorization or Composition of two factors."""

    def __init__(self, l_solver_factory=None, u_solver_factory=None,
                 factorization_factory=None, reverse_apply: bool = False):
        self.lf = l_solver_factory or LowerTrsFactory(unit_diagonal=False)
        self.uf = u_solver_factory or UpperTrsFactory()
        self.ff = factorization_factory or ParIluFactory()
        self.reverse_apply = reverse_apply

    def generate(self, op) -> IluPreconditioner:
        if hasattr(op, "get_l_factor"):
            fact = op
            _reject_reordered(fact, "ILU")
        elif hasattr(op, "operators") and len(op.operators) == 2:
            fact = Factorization(l_factor=op.operators[0], u_factor=op.operators[1],
                                 shape=op.shape)
        else:
            fact = self.ff.generate(op)
        return IluPreconditioner(l_solver=self.lf.generate(fact.get_l_factor()),
                                 u_solver=self.uf.generate(fact.get_u_factor()),
                                 reverse_apply=self.reverse_apply)


class IcPreconditionerFactory:
    """preconditioner::Ic factory: solve L, then L^H (ic.hpp:107)."""

    def __init__(self, l_solver_factory=None, factorization_factory=None):
        self.lf = l_solver_factory or LowerTrsFactory()
        self.ff = factorization_factory or ParIcFactory()

    def generate(self, op) -> IluPreconditioner:
        if hasattr(op, "get_l_factor"):
            fact = op
            _reject_reordered(fact, "IC")
        else:
            fact = self.ff.generate(op)
        lt = fact.get_l_factor()
        # the reference's Ic takes one solver type for L and L^H (ic.hpp:107):
        # the upper solver mirrors the lower factory, so a sweeps-configured
        # IC stays fusable
        uf = UpperTrsFactory(
            algorithm=getattr(self.lf, "algorithm", "block_scan"),
            block=getattr(self.lf, "block", 64),
            sweeps=getattr(self.lf, "sweeps", None),
            unit_diagonal=getattr(self.lf, "unit_diagonal", False),
        )
        return IluPreconditioner(l_solver=self.lf.generate(lt),
                                 u_solver=uf.generate(lt.conj_transpose()), reverse_apply=False)


class Ilu:
    @staticmethod
    def build(**kw):
        return IluPreconditionerFactory(**kw)


class Ic:
    @staticmethod
    def build(**kw):
        return IcPreconditionerFactory(**kw)
