"""Reusable kernel components.

Counterpart of ``ginkgo_tpu/ops/components.py`` (reference
core/components/: prefix_sum, fill_array, reduce_array, absolute_array,
precision_conversion, format_conversion (row pointers <-> row indices) and
disjoint_sets.hpp, the union-find of the symbolic factorization).  Each is
one tensor expression here; ``DisjointSets`` is a host structure.
"""

from __future__ import annotations

import numpy as np
import torch

from .spmv import row_ids_from_ptrs


def prefix_sum_nonnegative(a):
    """Exclusive prefix sum along axis 0: out[0] = 0."""
    c = torch.cumsum(a, dim=0).to(a.dtype)
    return torch.cat([torch.zeros_like(c[:1]), c[:-1]], dim=0)


def inclusive_prefix_sum(a):
    return torch.cumsum(a, dim=0).to(a.dtype)


def fill_array(shape, value, dtype=None, *, device):
    return torch.full(shape, value, dtype=dtype, device=device)


def fill_seq_array(n, dtype=torch.int32, *, device):
    """0, 1, ..., n - 1 (fill_seq_array)."""
    return torch.arange(n, dtype=dtype, device=device)


def reduce_add_array(a, init=0):
    return torch.sum(a) + init


def max_array(a):
    return torch.max(a)


def absolute_array(a):
    return torch.abs(a)


def convert_precision(a, dtype):
    return a.to(dtype)


def convert_ptrs_to_idxs(ptrs, num_entries: int):
    """Row pointers -> one row index per entry."""
    return row_ids_from_ptrs(ptrs, num_entries)


def convert_idxs_to_ptrs(idxs, num_rows: int, dtype=torch.int32):
    """Row indices -> row pointers (a count per row, then an inclusive sum
    behind a leading 0)."""
    counts = torch.bincount(idxs.to(torch.int64), minlength=num_rows)[:num_rows]
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(dtype)


class DisjointSets:
    """Union-find with path halving and union by size (host; the symbolic
    factorization's elimination forest)."""

    def __init__(self, size: int):
        self.parent = np.full(size, -1, dtype=np.int64)  # negative: -size

    def is_representative(self, x) -> bool:
        return self.parent[x] < 0

    def find(self, x: int) -> int:
        p = self.parent
        while p[x] >= 0:
            if p[p[x]] >= 0:  # path halving
                p[x] = p[p[x]]
            x_next = p[x]
            if x_next < 0:
                break
            x = x_next
        return x

    def size_of(self, x: int) -> int:
        return int(-self.parent[self.find(x)])

    def join(self, a: int, b: int) -> int:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        if -self.parent[ra] < -self.parent[rb]:  # the smaller under the larger
            ra, rb = rb, ra
        self.parent[ra] += self.parent[rb]
        self.parent[rb] = ra
        return ra

    def __len__(self):
        return len(self.parent)
