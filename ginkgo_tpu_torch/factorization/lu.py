"""Direct LU factorization with symbolic analysis.

Counterpart of the Lu half of ``ginkgo_tpu/factorization/lu.py``
(reference core/factorization/lu.cpp, symbolic.cpp and
elimination_forest.cpp): the elimination forest and the symbolic Cholesky
fill pattern are host numpy (copies of the JAX package's); the numeric LU
is a set-up computation on the host, SuperLU without pivoting in natural
order (the vendor-library analog), whose factors come back as ``Csr``
operators on the matrix's device for the triangular solvers.

Not ported yet (ROADMAP queue A): the fill-reducing reorderings ('rcm',
'nd', 'auto', which need ``reorder/``) and ``CholeskyFactory`` with its
native kernel.  ``reorder=None`` and an explicit permutation work.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

from ..base.exceptions import NotImplementedError_
from ..matrix.csr import Csr
from .factorization import Factorization


def elimination_forest(pattern) -> np.ndarray:
    """Elimination tree of a symmetric pattern (parent array, -1 = root),
    by Liu's algorithm (reference core/factorization/elimination_forest.cpp)."""
    a = pattern.tocsr()
    n = a.shape[0]
    parent = np.full(n, -1, np.int64)
    ancestor = np.full(n, -1, np.int64)
    for j in range(n):
        for t in range(a.indptr[j], a.indptr[j + 1]):
            i = a.indices[t]
            if i >= j:
                continue
            # walk from i to the root, compressing the path via `ancestor`
            while True:
                anc = ancestor[i]
                ancestor[i] = j
                if anc == -1:
                    if parent[i] == -1 and i != j:
                        parent[i] = j
                    break
                if anc == j:
                    break
                i = anc
    return parent


def symbolic_cholesky(pattern):
    """Fill pattern of the Cholesky factor, row structures by an etree walk
    (reference core/factorization/symbolic.cpp)."""
    a = (pattern + pattern.T).tocsr()
    n = a.shape[0]
    parent = elimination_forest(a)
    rows, cols = [], []
    for i in range(n):
        mark = np.zeros(n, bool)
        mark[i] = True
        rows.append(i)
        cols.append(i)
        for t in range(a.indptr[i], a.indptr[i + 1]):
            k = a.indices[t]
            if k >= i:
                continue
            while k != -1 and k < i and not mark[k]:
                mark[k] = True
                rows.append(i)
                cols.append(k)
                k = parent[k]
    return sps.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=a.shape)


def _resolve_reorder(reorder) -> np.ndarray | None:
    """None, or an explicit forward permutation p (row i of the permuted
    system is row p[i] of A; an object with a ``permutation`` attribute or
    an index array).  The named reorderings wait for their port."""
    if reorder is None:
        return None
    if isinstance(reorder, str):
        raise NotImplementedError_(
            f"reorder={reorder!r}: the fill-reducing reorderings (reorder/rcm.py, nd.py, "
            "scaled_reordered.py) are not ported yet (ROADMAP queue A, the direct-solver "
            "item after slice 8); pass reorder=None or an explicit permutation")
    return np.asarray(getattr(reorder, "permutation", reorder), dtype=np.int64)


def _inv_perm(p: np.ndarray) -> np.ndarray:
    inv = np.empty_like(p)
    inv[p] = np.arange(len(p))
    return inv


class LuFactory:
    """factorization::Lu (direct).  symbolic_algorithm is kept for the
    interface; the numeric LU is unpivoted sparse LU.  With ``reorder`` a
    permutation p is composed in: P A P^T = L U is factored and the
    permutations ride the Factorization (row_perm gathers b, col_perm
    gathers the solution back), which ``Direct`` applies."""

    def __init__(self, symbolic_algorithm: str = "general", skip_sorting=False, reorder=None):
        self.symbolic_algorithm = symbolic_algorithm
        self.reorder = reorder

    def generate(self, A) -> Factorization:
        csr = A.to_csr() if hasattr(A, "to_csr") else A
        dev = csr.device
        p = _resolve_reorder(self.reorder)
        if p is not None:
            csr = csr.symm_permute(p)
        a = csr.to_scipy().tocsc()
        lu = spla.splu(a, permc_spec="NATURAL", diag_pivot_thresh=0.0,
                       options=dict(SymmetricMode=True))
        # SuperLU may row-permute (Pr A = L U).  Folding Pr into L would make
        # it non-triangular, so L stays triangular and the permutation is
        # carried: A x = b <=> L U x = (Pr b) = b[row_perm]
        n = a.shape[0]
        row_perm = np.argsort(lu.perm_r)
        # SuperLU computes in double; the factors take the operator's dtype
        L = lu.L.tocsr().astype(a.dtype)
        U = lu.U.tocsr().astype(a.dtype)
        if np.array_equal(lu.perm_r, np.arange(n)):
            total_row = p
        elif p is None:
            total_row = row_perm
        else:  # b -> b[p] -> b[p][row_perm] = b[p[row_perm]]
            total_row = p[row_perm]

        def perm(v):
            return None if v is None else torch.as_tensor(v.astype(np.int32), device=dev)

        return Factorization(
            l_factor=Csr.from_scipy(L, device=dev),
            u_factor=Csr.from_scipy(U, device=dev),
            row_perm=perm(total_row),
            col_perm=perm(None if p is None else _inv_perm(p)),
            shape=tuple(a.shape),
        )


Lu = LuFactory
