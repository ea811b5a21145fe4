"""Factorization container: the L and U (or L and L^H) factors.

Counterpart of ``ginkgo_tpu/factorization/factorization.py`` (reference
include/ginkgo/core/factorization/factorization.hpp:104, and the
Composition output convention of the ilu/ic/par_ilu factories,
factorization/ilu.hpp:71).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..base.linop import Composition, LinOp


@dataclasses.dataclass(eq=False)
class Factorization(LinOp):
    l_factor: Any
    u_factor: Any
    #: row permutation p with P A = L U, i.e. A x = b <=> L U x = b[p]; None
    #: for pivot-free factorizations.  With a fill-reducing reorder the row
    #: pivots are folded in, so p maps b to the permuted system in one gather.
    row_perm: Any = None
    #: back-permutation of a symmetrically reordered factor (P A P^T = L U):
    #: the permuted solution y maps back as x = y[col_perm]; None when the
    #: factor is of A itself.
    col_perm: Any = None
    shape: tuple = (0, 0)

    @property
    def dtype(self):
        return self.l_factor.dtype

    def get_l_factor(self):
        return self.l_factor

    def get_u_factor(self):
        return self.u_factor

    get_lower_factor = get_l_factor
    get_upper_factor = get_u_factor

    def apply(self, b):
        """L U b, the composed operator (as Composition(L, U))."""
        return self.l_factor.apply(self.u_factor.apply(b))

    def to_composition(self) -> Composition:
        return Composition(operators=(self.l_factor, self.u_factor))
