"""Reverse Cuthill-McKee reordering.

Counterpart of ``ginkgo_tpu/reorder/rcm.py`` (reference
core/reorder/rcm.cpp; ``starting_strategy`` pseudo_peripheral (the default)
or minimum_degree, rcm.hpp:63, :145).  The reference's GPU backends run it
on the host, and so does the port: numpy on the symmetrized pattern, the
permutation handed back as a ``Permutation`` on A's device.

The breadth-first searches run level by level in numpy and visit the nodes
in the JAX package's queue order, so the permutations are equal element
for element: the next level is the current level's neighbours in the
current level's order, each node's neighbours in CSR order (Cuthill-McKee:
sorted stably by degree), a node claimed by its first parent only.
"""

from __future__ import annotations

import numpy as np

from ..matrix.diagonal import Permutation


def _neighbours(indptr, indices, frontier):
    """The neighbour lists of ``frontier``'s nodes, concatenated in order,
    and the position in ``frontier`` of each entry's parent."""
    starts = indptr[frontier]
    lens = indptr[frontier + 1] - starts
    total = int(lens.sum())
    parent = np.repeat(np.arange(len(frontier)), lens)
    offs = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    return indices[starts[parent] + offs], parent


def _next_level(indptr, indices, frontier, visited, degrees=None):
    """The next BFS level in queue order, marked visited.  With ``degrees``
    each parent's unvisited neighbours are ordered stably by degree
    (Cuthill-McKee)."""
    nb, parent = _neighbours(indptr, indices, frontier)
    keep = ~visited[nb]
    nb, parent = nb[keep], parent[keep]
    # first claim wins: the first occurrence of each node
    _, first = np.unique(nb, return_index=True)
    first.sort()
    nb, parent = nb[first], parent[first]
    if degrees is not None and len(nb):
        order = np.lexsort((np.arange(len(nb)), degrees[nb], parent))
        nb = nb[order]
    visited[nb] = True
    return nb


def _bfs_levels(indptr, indices, start, n):
    """BFS from ``start``: (level of every node, -1 if unreached; the
    reached nodes in visit order)."""
    level = np.full(n, -1, np.int64)
    visited = np.zeros(n, bool)
    visited[start] = True
    frontier = np.asarray([start], dtype=np.int64)
    order = []
    depth = 0
    while len(frontier):
        level[frontier] = depth
        order.append(frontier)
        frontier = _next_level(indptr, indices, frontier, visited)
        depth += 1
    return level, np.concatenate(order)


def _pseudo_peripheral(indptr, indices, comp_nodes, degrees):
    """George-Liu pseudo-peripheral node finder."""
    n = len(degrees)
    u = comp_nodes[np.argmin(degrees[comp_nodes])]
    last_ecc = -1
    while True:
        level, _ = _bfs_levels(indptr, indices, u, n)
        comp_levels = level[comp_nodes]
        ecc = comp_levels.max()
        if ecc <= last_ecc:
            return u
        last_ecc = ecc
        far = comp_nodes[comp_levels == ecc]
        u = far[np.argmin(degrees[far])]


def rcm_permutation(csr, starting_strategy: str = "pseudo_peripheral") -> np.ndarray:
    """The permutation p such that A[p][:, p] has a reduced bandwidth:
    p[i] is the old index of new row i (``Csr.symm_permute``'s convention)."""
    sp = csr.to_scipy().tocsr()
    sym = (sp + sp.T).tocsr()
    n = sym.shape[0]
    indptr = sym.indptr.astype(np.int64)
    indices = sym.indices.astype(np.int64)
    degrees = np.diff(indptr)
    visited = np.zeros(n, bool)
    cm = []
    seed = 0
    while True:
        unvisited = np.flatnonzero(~visited[seed:])
        if not len(unvisited):
            break
        seed += int(unvisited[0])
        _, comp_nodes = _bfs_levels(indptr, indices, seed, n)
        if starting_strategy == "pseudo_peripheral":
            start = _pseudo_peripheral(indptr, indices, comp_nodes, degrees)
        else:  # minimum_degree
            start = comp_nodes[np.argmin(degrees[comp_nodes])]
        # Cuthill-McKee BFS, each node's neighbours visited by degree
        visited[start] = True
        frontier = np.asarray([start], dtype=np.int64)
        while len(frontier):
            cm.append(frontier)
            frontier = _next_level(indptr, indices, frontier, visited, degrees)
    return np.concatenate(cm)[::-1].astype(np.int64) if cm else np.zeros(0, np.int64)


class RcmFactory:
    """rcm.hpp factory."""

    def __init__(self, starting_strategy: str = "pseudo_peripheral"):
        assert starting_strategy in ("pseudo_peripheral", "minimum_degree")
        self.starting_strategy = starting_strategy

    def generate(self, A) -> Permutation:
        csr = A.to_csr() if hasattr(A, "to_csr") else A
        return Permutation.create(rcm_permutation(csr, self.starting_strategy),
                                  device=csr.device)


class Rcm:
    @staticmethod
    def build(**kw):
        return RcmFactory(**kw)


def bandwidth(csr) -> int:
    sp = csr.to_scipy().tocoo()
    if sp.nnz == 0:
        return 0
    return int(np.abs(sp.row.astype(np.int64) - sp.col).max())
