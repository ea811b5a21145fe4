"""Direct LU and Cholesky factorizations with symbolic analysis.

Counterpart of ``ginkgo_tpu/factorization/lu.py`` (reference
core/factorization/lu.cpp, cholesky.cpp, symbolic.cpp and
elimination_forest.cpp): the elimination forest and the symbolic Cholesky
fill pattern are host numpy (copies of the JAX package's); the numeric
factorizations are set-up computations on the host whose factors come back
as ``Csr`` operators on the matrix's device for the triangular solvers:

- ``Lu``: SuperLU without pivoting in natural order (the vendor-library
  analog);
- ``Cholesky``: the up-looking sparse LL^T of ``native/cholesky.cpp``,
  built and loaded by the port's own ``_native`` loader, O(nnz(L)) memory.
  A complex Hermitian matrix takes a dense LL^H (the native kernel is
  real), up to 8192 rows; with no C++ compiler at all, a real matrix takes
  the same bounded dense factor, as in the JAX package.  A compiler that
  refuses the source raises.  ``CholeskyFactory.routes`` counts the route
  each factorization took.

Both take a fill-reducing ``reorder``: 'rcm', 'nd', 'auto' (nested
dissection above 2048 rows, else RCM), a ``Permutation`` or an index array;
P A P^T is factored and the permutations ride the ``Factorization``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

from ..base import types
from .. import _native
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


def _resolve_reorder(reorder, csr) -> np.ndarray | None:
    """Fill-reducing reorder parameter: None | 'rcm' | 'nd' | 'auto' |
    Permutation | index array -> forward permutation p (row i of the
    permuted system is row p[i] of A), or None.  'auto' picks nested
    dissection above 2048 rows (a profile ordering like RCM still fills
    about n * bandwidth; ND is O(n log n) on grid and planar graphs)."""
    if reorder is None:
        return None
    if isinstance(reorder, str):
        if reorder == "auto":
            reorder = "nd" if csr.shape[0] > 2048 else "rcm"
        if reorder == "rcm":
            from ..reorder.rcm import rcm_permutation

            return rcm_permutation(csr)
        if reorder == "nd":
            from ..reorder.nd import nd_permutation

            return nd_permutation(csr)
        raise ValueError(f"unknown reorder {reorder!r} (use 'rcm', 'nd', 'auto')")
    perm = getattr(reorder, "permutation", reorder)
    return np.asarray(types.to_host(perm), dtype=np.int64)


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
        p = _resolve_reorder(self.reorder, csr)
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


#: the bounded dense fallback's limit (n^2 float64 <= 512 MB)
_DENSE_FALLBACK_MAX_N = 8192


def _dense_cholesky(a: sps.csr_matrix) -> sps.csr_matrix:
    """Dense LL^T (LL^H) on the host, bounded to sizes where forming the
    dense matrix is harmless."""
    n = a.shape[0]
    if n > _DENSE_FALLBACK_MAX_N:
        raise RuntimeError(
            "sparse Cholesky requires the native kernel (native/cholesky.cpp) for n > "
            f"{_DENSE_FALLBACK_MAX_N}; no C++ compiler was found to build it")
    return sps.csr_matrix(np.linalg.cholesky(a.toarray()))


class CholeskyFactory:
    """factorization::Cholesky (reference core/factorization/
    cholesky_kernels.hpp, symbolic.cpp): P A P^T = L L^H by the native
    up-looking kernel, no densification.  ``reorder`` defaults to 'auto'
    (nested dissection beyond 2048 rows, which is what makes a 2-D Poisson
    matrix of a million rows factorable at all); the permutation rides the
    Factorization and ``Direct`` applies it.  ``reorder=None`` factors A
    itself.  A breakdown raises ``numpy.linalg.LinAlgError``."""

    #: factorizations by route: the native kernel, the dense fallback for a
    #: real matrix (no C++ compiler), the dense LL^H of a complex one
    routes = {"native": 0, "dense": 0, "complex_dense": 0}

    def __init__(self, skip_sorting=False, reorder="auto"):
        self.reorder = reorder

    def generate(self, A) -> Factorization:
        csr = A.to_csr() if hasattr(A, "to_csr") else A
        dev = csr.device
        dt = csr.dtype
        p = _resolve_reorder(self.reorder, csr)
        if p is not None:
            csr = csr.symm_permute(p)

        def perm(v):
            return None if v is None else torch.as_tensor(v.astype(np.int32), device=dev)

        perms = dict(row_perm=perm(p), col_perm=perm(None if p is None else _inv_perm(p)))
        a = csr.to_scipy().tocsr()
        a.sum_duplicates()
        a.sort_indices()
        if np.iscomplexobj(a):
            # Hermitian LL^H: the native kernel is real float64 only, and U
            # is the conjugate transpose of L
            if a.shape[0] > _DENSE_FALLBACK_MAX_N:
                raise NotImplementedError(
                    f"complex sparse Cholesky beyond n={_DENSE_FALLBACK_MAX_N} is not "
                    "supported (the native kernel is real-valued)")
            Ls = _dense_cholesky(a)
            CholeskyFactory.routes["complex_dense"] += 1
            return Factorization(
                l_factor=Csr.from_scipy(Ls, device=dev).astype(dt),
                u_factor=Csr.from_scipy(Ls.conj().T.tocsr(), device=dev).astype(dt),
                shape=tuple(a.shape), **perms)
        try:
            out = _native.sparse_cholesky(a.indptr, a.indices, a.data)
        except _native.NotPositiveDefinite as e:
            raise np.linalg.LinAlgError(str(e)) from e
        if out is not None:
            col_ptr, row_idx, val = out
            # the CSC of L is the CSR of U = L^T
            U = sps.csr_matrix((val, row_idx, col_ptr), shape=a.shape)
            Ls = U.T.tocsr()
            CholeskyFactory.routes["native"] += 1
        else:  # no C++ compiler: the bounded dense fallback
            Ls = _dense_cholesky(a)
            U = Ls.T.tocsr()
            CholeskyFactory.routes["dense"] += 1
        return Factorization(
            l_factor=Csr.from_scipy(Ls.tocsr(), device=dev).astype(dt),
            u_factor=Csr.from_scipy(U, device=dev).astype(dt),
            shape=tuple(a.shape), **perms)


Lu = LuFactory
Cholesky = CholeskyFactory
