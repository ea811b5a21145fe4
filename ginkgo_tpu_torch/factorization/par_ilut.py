"""ParILUT / ParICT: threshold-based adaptive incomplete factorizations.

Counterpart of ``ginkgo_tpu/factorization/par_ilut.py`` (reference
core/factorization/par_ilut.cpp, ops :63-79: add_candidates ->
compute_l_u_factors sweeps -> threshold_select -> threshold_filter, and
par_ict.cpp).  The pattern-adaptive outer loop runs on the host (scipy
symbolic products at generate time, where the reference spends its SpGEMM
and SpGEAM calls); every numeric sweep runs on the device through the
static ParILU product plan (``par_ilu.parilu_sweeps``).  threshold_select
is an exact host partition; filtering keeps the diagonal, as the reference
does.  Parameters as par_ilut.hpp: iterations (default 5), fill_in_limit
(default 2.0), approximate_select.

The JAX package pads each plan to bucketed sizes so that its jit compiles
O(log) kernels over the adaptive loop (``pad_plan_to_buckets``); PyTorch
runs eagerly and needs no padding.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps

from ..base import types
from ..matrix.csr import Csr
from .factorization import Factorization
from .par_ilu import parilu_sweeps, split_lu_pattern


def _threshold_filter(m, max_nnz: int, approximate=False):
    """The max_nnz largest-|.| entries of m, always with its diagonal.

    approximate=True takes the threshold from an 8192-entry sample (the
    reference's sampleselect approximation, par_ilut_select kernels)."""
    m = m.tocoo()
    absval = np.abs(m.data)
    is_diag = m.row == m.col
    if m.nnz <= max_nnz:
        keep = np.ones(m.nnz, bool)
    else:
        noff = max(max_nnz - is_diag.sum(), 0)
        off_abs = absval[~is_diag]
        if noff == 0 or len(off_abs) == 0:
            keep = is_diag
        else:
            noff = min(noff, len(off_abs))
            if approximate and len(off_abs) > 8192:
                rng = np.random.default_rng(0)
                sample = rng.choice(off_abs, size=8192, replace=False)
                thresh = np.quantile(sample, 1.0 - noff / len(off_abs))
            else:
                thresh = np.partition(off_abs, -noff)[-noff]
            keep = is_diag | (absval >= thresh)
    return sps.csr_matrix((m.data[keep], (m.row[keep], m.col[keep])), shape=m.shape)


def _pattern_mask(pat):
    m = pat.copy()
    m.data = np.ones_like(m.data)
    return m


def _sweeps_on_pattern(A_sp, pattern_sp, sweeps: int, device):
    """Chow-Patel sweeps with A's values on an explicit pattern (pattern
    entries not in A are structural zeros; entries of A outside it are
    dropped); returns host scipy L and U."""
    pat = pattern_sp.tocsr().copy()
    pat.sort_indices()
    pat.data = np.zeros_like(pat.data)
    both = (pat + A_sp.tocsr().multiply(_pattern_mask(pat))).tocsr()
    both.sort_indices()
    plan = split_lu_pattern(Csr.from_scipy(both, device="cpu"))
    lv, uv = parilu_sweeps(plan, sweeps, device=device)
    n = both.shape[0]
    L = sps.csr_matrix((types.to_host(lv), plan["l_cols"], plan["l_indptr"]), shape=(n, n))
    U = sps.csr_matrix((types.to_host(uv), plan["u_cols"], plan["u_indptr"]), shape=(n, n))
    return L, U


class ParIlutFactory:
    def __init__(self, iterations: int = 5, fill_in_limit: float = 2.0,
                 sweeps_per_iteration: int = 3, approximate_select: bool = False):
        self.iterations = int(iterations)
        self.fill_in_limit = float(fill_in_limit)
        self.sweeps = int(sweeps_per_iteration)
        self.approximate_select = bool(approximate_select)

    def generate(self, A) -> Factorization:
        csr = A.to_csr() if hasattr(A, "to_csr") else A
        dev = csr.device
        a = csr.to_scipy().tocsr()
        a.sort_indices()
        n = a.shape[0]
        eye = sps.eye(n, format="csr")
        max_l = int(self.fill_in_limit * sps.tril(a, 0).nnz)
        max_u = int(self.fill_in_limit * sps.triu(a, 0).nnz)
        # the reference's loop order (par_ilut.cpp:63-79): add_candidates ->
        # sweeps on the candidates -> threshold filter -> sweeps on the
        # filtered pattern
        pattern = (a + eye).tocsr()  # with the diagonal
        L, U = _sweeps_on_pattern(a, pattern, self.sweeps, dev)
        for _ in range(self.iterations):
            LU = (L @ U).tocsr()
            cand = (_pattern_mask((a + eye).tocsr()) + _pattern_mask(LU)).tocsr()
            L2, U2 = _sweeps_on_pattern(a, cand, self.sweeps, dev)
            Lf = _threshold_filter(sps.tril(L2, 0).tocsr(), max_l,
                                   approximate=self.approximate_select)
            Uf = _threshold_filter(sps.triu(U2, 0).tocsr(), max_u,
                                   approximate=self.approximate_select)
            pattern = (_pattern_mask(Lf) + _pattern_mask(Uf) + _pattern_mask(eye)).tocsr()
            L, U = _sweeps_on_pattern(a, pattern, self.sweeps, dev)
        return Factorization(l_factor=Csr.from_scipy(L, device=dev),
                             u_factor=Csr.from_scipy(U, device=dev), shape=(n, n))


class ParIctFactory:
    """par_ict.cpp analog: threshold IC, symmetric candidates, L only."""

    def __init__(self, iterations: int = 5, fill_in_limit: float = 2.0,
                 sweeps_per_iteration: int = 3, approximate_select: bool = False):
        self.iterations = int(iterations)
        self.fill_in_limit = float(fill_in_limit)
        self.sweeps = int(sweeps_per_iteration)
        self.approximate_select = bool(approximate_select)

    def generate(self, A) -> Factorization:
        csr = A.to_csr() if hasattr(A, "to_csr") else A
        dev = csr.device
        a = csr.to_scipy().tocsr()
        n = a.shape[0]
        eye = sps.eye(n, format="csr")
        max_l = int(self.fill_in_limit * sps.tril(a, 0).nnz)
        pattern = (a + eye).tocsr()
        L, U = _sweeps_on_pattern(a, pattern, self.sweeps, dev)
        for _ in range(self.iterations):
            du = np.sqrt(np.maximum(U.diagonal(), 1e-30))
            Lic = (L @ sps.diags(du)).tocsr()
            LLt = (Lic @ Lic.T).tocsr()
            cand = (_pattern_mask((a + eye).tocsr()) + _pattern_mask(LLt)).tocsr()
            cand = (_pattern_mask(sps.tril(cand)) + _pattern_mask(sps.tril(cand).T)).tocsr()
            L2, _ = _sweeps_on_pattern(a, cand, self.sweeps, dev)
            Lf = _threshold_filter(sps.tril(L2, 0).tocsr(), max_l)
            sym = _pattern_mask(Lf) + _pattern_mask(Lf).T
            pattern = (sym + _pattern_mask(eye)).tocsr()
            L, U = _sweeps_on_pattern(a, pattern, self.sweeps, dev)
        du = np.sqrt(np.maximum(U.diagonal(), 1e-30))
        Lic = Csr.from_scipy((L @ sps.diags(du)).tocsr(), device=dev)
        return Factorization(l_factor=Lic, u_factor=Lic.conj_transpose(), shape=(n, n))


ParIlut = ParIlutFactory
ParIct = ParIctFactory
