"""Nested-dissection ordering via recursive BFS bisection.

Counterpart of ``ginkgo_tpu/reorder/nd.py``, a copy of its host code
(numpy and scipy; the separators are the level sets of
``csgraph.dijkstra``), so the permutations are equal element for element.
The JAX package's notes follow.

Fill-reducing ordering for the direct-factorization stack: RCM bounds
PROFILE fill (nnz(L) ~ n * bandwidth — still ~s^3 on an s x s grid),
while nested dissection bounds it at O(n log n) for planar/grid graphs
(George 1973), which is what lets a 1M-row Poisson Cholesky factor at
all.  The reference composes reorderings into factorizations through
core/reorder/scaled_reordered.cpp and relies on vendor/external ND
(METIS) where available; this is a self-contained host implementation:
separators are BFS level sets chosen to balance the halves, recursing
until leaf blocks, separators ordered LAST (eliminated latest).

Host/setup-path code (numpy + scipy.sparse), same tier as symbolic
factorization; O(nnz log n) total work.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps
from scipy.sparse import csgraph


_LEAF = 96  # blocks at/below this size are emitted in natural order


def _bfs_levels_sp(sub, start):
    """Unweighted BFS distances from `start` (inf = unreachable)."""
    return csgraph.dijkstra(
        sub, indices=start, unweighted=True, min_only=False, directed=False
    )


def _order_subgraph(sub, nodes, out):
    """Append the ND ordering of `nodes` (global ids, sub = their
    subgraph) to `out`: order(A) ++ order(B) ++ separator."""
    n = len(nodes)
    if n <= _LEAF:
        out.append(nodes)
        return
    # pseudo-peripheral-ish start: two BFS sweeps from node 0
    lv0 = _bfs_levels_sp(sub, 0)
    reach = np.isfinite(lv0)
    if not reach.all():
        # disconnected: recurse per component (cheap: label once)
        ncomp, labels = csgraph.connected_components(sub, directed=False)
        for c in range(ncomp):
            m = labels == c
            idx = np.flatnonzero(m)
            _order_subgraph(sub[idx][:, idx], nodes[idx], out)
        return
    far = int(np.argmax(lv0))
    lv = _bfs_levels_sp(sub, far).astype(np.int64)
    ecc = int(lv.max())
    if ecc < 2:  # clique-ish: no useful separator
        out.append(nodes)
        return
    # separator = the level set whose cumulative split is most balanced
    counts = np.bincount(lv, minlength=ecc + 1)
    below = np.cumsum(counts) - counts  # nodes strictly below level m
    # balance objective: |below - (n - below - counts)| minimized over
    # interior levels 1..ecc-1
    interior = np.arange(1, ecc)
    bal = np.abs(2 * below[interior] + counts[interior] - n)
    m = int(interior[np.argmin(bal)])
    a = np.flatnonzero(lv < m)
    b = np.flatnonzero(lv > m)
    sep = np.flatnonzero(lv == m)
    if len(a) == 0 or len(b) == 0:  # degenerate split
        out.append(nodes)
        return
    _order_subgraph(sub[a][:, a], nodes[a], out)
    _order_subgraph(sub[b][:, b], nodes[b], out)
    out.append(nodes[sep])


def nd_permutation(csr) -> np.ndarray:
    """Returns forward permutation p: row i of the reordered system is
    row p[i] of A (same convention as rcm_permutation), separators
    ordered last within every dissection level."""
    sp = csr.to_scipy().tocsr() if hasattr(csr, "to_scipy") else sps.csr_matrix(csr)
    sym = sp + sp.T
    sym.data[:] = 1.0
    sym = sym.tocsr()
    n = sym.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    import sys

    depth = max(64, 4 * int(np.log2(max(n, 2))) + 64)
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, depth * 4 + 1000))
    try:
        out: list[np.ndarray] = []
        _order_subgraph(sym, np.arange(n, dtype=np.int64), out)
    finally:
        sys.setrecursionlimit(old)
    p = np.concatenate(out) if out else np.zeros(0, np.int64)
    assert len(p) == n and len(np.unique(p)) == n
    return p


class NestedDissectionFactory:
    """Reorder factory analog (rcm.hpp pattern): generate() -> Permutation
    on A's device."""

    def generate(self, A):
        from ..matrix.diagonal import Permutation

        csr = A.to_csr() if hasattr(A, "to_csr") else A
        return Permutation.create(nd_permutation(csr), device=csr.device)


class NestedDissection:
    @staticmethod
    def build(**kw):
        return NestedDissectionFactory()
