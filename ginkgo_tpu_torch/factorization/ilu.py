"""Exact ILU(0) / IC(0) factorizations.

Counterpart of ``ginkgo_tpu/factorization/ilu.py`` (reference
core/factorization/ilu.cpp and ic.cpp, where vendor libraries provide
csrilu0/csric0).  The exact sequential IKJ factorization runs on the host
at generate time, a set-up path like the reference's sparselib call, and
the factors are ``Csr`` operators on the device of the matrix they came
from: ``Factorization(L unit lower, U upper)``, factorization/ilu.hpp:71's
Composition convention.  The host routines are copies of the JAX package's
(numpy only).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps

from ..matrix.csr import Csr
from .factorization import Factorization


def ilu0_host(sp):
    """Exact ILU(0), IKJ variant, on the CSR pattern of ``sp`` (scipy)."""
    a = sp.tocsr().copy()
    a.sort_indices()
    n = a.shape[0]
    indptr, indices, data = a.indptr, a.indices, a.data
    for i in range(n):
        row_s, row_e = indptr[i], indptr[i + 1]
        row_cols = indices[row_s:row_e]
        for kk in range(row_s, row_e):
            k = indices[kk]
            if k >= i:
                break
            # ILU(0) on the original pattern needs a stored diagonal in
            # every row, as the reference's csrilu0 does
            ks, ke = indptr[k], indptr[k + 1]
            dpos = ks + np.searchsorted(indices[ks:ke], k)
            if dpos >= ke or indices[dpos] != k:
                raise ValueError(
                    f"ILU(0) requires a stored diagonal entry in every row; row {k} has none")
            dkk = data[dpos]
            if dkk == 0:
                dkk = 1e-30
            data[kk] = data[kk] / dkk
            lik = data[kk]
            # subtract lik * row k (its upper part) on row i's pattern
            for jj in range(dpos + 1, ke):
                j = indices[jj]
                pos = row_s + np.searchsorted(row_cols, j)
                if pos < row_e and indices[pos] == j:
                    data[pos] -= lik * data[jj]
    return a


def split_factors(a, *, device):
    """Split in-place ILU storage into L (unit diagonal) and U, as ``Csr``
    on ``device``."""
    n = a.shape[0]
    L = sps.tril(a, -1).tocsr() + sps.eye(n, format="csr", dtype=a.dtype)
    U = sps.triu(a, 0).tocsr()
    return Csr.from_scipy(L, device=device), Csr.from_scipy(U, device=device)


def _as_csr(A):
    return A.to_csr() if hasattr(A, "to_csr") else A


class IluFactory:
    """factorization::Ilu (exact, the 'sparselib' analog)."""

    def __init__(self, skip_sorting: bool = False):
        pass

    def generate(self, A) -> Factorization:
        csr = _as_csr(A)
        a = ilu0_host(csr.to_scipy())
        L, U = split_factors(a, device=csr.device)
        return Factorization(l_factor=L, u_factor=U, shape=tuple(a.shape))


class IcFactory:
    """factorization::Ic (exact IC(0)): L and L^H."""

    def __init__(self, skip_sorting: bool = False):
        pass

    def generate(self, A) -> Factorization:
        csr = _as_csr(A)
        sp = csr.to_scipy().tocsr()
        sp.sort_indices()
        n = sp.shape[0]
        # IC(0): up-looking on the lower-triangular pattern
        Lpat = sps.tril(sp, 0).tocsr()
        Lpat.sort_indices()
        indptr, indices = Lpat.indptr, Lpat.indices
        data = Lpat.data.astype(np.result_type(Lpat.data.dtype, np.float64)).copy()
        dense_rows = [
            dict(zip(indices[indptr[i]:indptr[i + 1]], range(indptr[i], indptr[i + 1])))
            for i in range(n)
        ]
        for i in range(n):
            s, e = indptr[i], indptr[i + 1]
            for t in range(s, e):
                j = indices[t]
                # l_ij = (a_ij - sum_{k<j} l_ik conj(l_jk)) / l_jj; l_jj = sqrt(...)
                acc = data[t]
                row_i = dense_rows[i]
                js, je = indptr[j], indptr[j + 1]
                for tt in range(js, je):
                    k = indices[tt]
                    if k >= j:
                        break
                    if k in row_i:
                        acc -= data[row_i[k]] * np.conj(data[tt])
                if j < i:
                    djj = data[dense_rows[j][j]]
                    data[t] = acc / (djj if djj != 0 else 1e-30)
                else:
                    data[t] = (np.sqrt(max(acc, 1e-30)) if not np.iscomplexobj(data)
                               else np.sqrt(acc))
        Lf = sps.csr_matrix((data.astype(sp.data.dtype), indices, indptr), shape=sp.shape)
        L = Csr.from_scipy(Lf, device=csr.device)
        return Factorization(l_factor=L, u_factor=L.conj_transpose(), shape=sp.shape)


Ilu = IluFactory
Ic = IcFactory
