"""IndexSet: sorted-interval index set.

Counterpart of ``ginkgo_tpu/base/index_set.py``, a host structure (reference
include/ginkgo/core/base/index_set.hpp:85, index_set_kernels.hpp:
populate_subsets and the global-to-local and local-to-global maps).  Stores a
set of indices as sorted disjoint [begin, end) intervals plus cumulative
offsets ("superset" positions).
"""

from __future__ import annotations

import numpy as np


class IndexSet:
    """Host-side sorted-interval set over [0, size)."""

    def __init__(self, size: int, indices=None, is_sorted: bool = False):
        self.size = int(size)
        if indices is None or len(indices) == 0:
            self.begins = np.zeros(0, np.int64)
            self.ends = np.zeros(0, np.int64)
            self.offsets = np.zeros(1, np.int64)
            return
        idx = np.asarray(indices, dtype=np.int64)
        if not is_sorted:
            idx = np.unique(idx)
        else:
            idx = idx[np.concatenate([[True], np.diff(idx) > 0])]
        if idx.size and (idx[0] < 0 or idx[-1] >= self.size):
            raise ValueError("index out of range")
        # find interval breaks (index_set_kernels populate_subsets)
        breaks = np.flatnonzero(np.diff(idx) > 1) + 1
        starts = np.concatenate([[0], breaks])
        stops = np.concatenate([breaks, [idx.size]])
        self.begins = idx[starts]
        self.ends = idx[stops - 1] + 1
        lens = self.ends - self.begins
        self.offsets = np.concatenate([[0], np.cumsum(lens)])

    # -- queries (index_set.hpp surface) ---------------------------------------

    @property
    def num_subsets(self) -> int:
        return len(self.begins)

    def get_num_elems(self) -> int:
        return int(self.offsets[-1])

    def get_size(self) -> int:
        return self.size

    def contains(self, value) -> np.ndarray:
        """Elementwise membership (index_set.hpp `contains`)."""
        v = np.atleast_1d(np.asarray(value, dtype=np.int64))
        pos = np.searchsorted(self.begins, v, side="right") - 1
        ok = pos >= 0
        safe = np.clip(pos, 0, max(0, self.num_subsets - 1))
        inside = ok & (v < self.ends[safe]) if self.num_subsets else np.zeros_like(ok)
        return inside if np.ndim(value) else bool(inside[0])

    def get_global_index(self, local):
        """local (position within the set) -> global index
        (index_set.hpp get_global_index / local->global kernel)."""
        l = np.atleast_1d(np.asarray(local, dtype=np.int64))
        if np.any((l < 0) | (l >= self.get_num_elems())):
            raise IndexError("local index out of range")
        s = np.searchsorted(self.offsets, l, side="right") - 1
        g = self.begins[s] + (l - self.offsets[s])
        return g if np.ndim(local) else int(g[0])

    def get_local_index(self, global_idx):
        """global index -> position within the set, -1 if absent
        (global->local kernel)."""
        g = np.atleast_1d(np.asarray(global_idx, dtype=np.int64))
        if self.num_subsets == 0:
            out = np.full(g.shape, -1, np.int64)
            return out if np.ndim(global_idx) else -1
        pos = np.searchsorted(self.begins, g, side="right") - 1
        safe = np.clip(pos, 0, self.num_subsets - 1)
        inside = (pos >= 0) & (g < self.ends[safe])
        loc = self.offsets[safe] + (g - self.begins[safe])
        out = np.where(inside, loc, -1)
        return out if np.ndim(global_idx) else int(out[0])

    def to_global_indices(self) -> np.ndarray:
        """Decompress to the full sorted index list."""
        if self.num_subsets == 0:
            return np.zeros(0, np.int64)
        return np.concatenate(
            [np.arange(b, e) for b, e in zip(self.begins, self.ends)]
        )

    def complement(self) -> "IndexSet":
        mask = np.ones(self.size, bool)
        mask[self.to_global_indices()] = False
        return IndexSet(self.size, np.flatnonzero(mask), is_sorted=True)

    def __repr__(self):
        return (
            f"IndexSet(size={self.size}, elems={self.get_num_elems()}, "
            f"subsets={self.num_subsets})"
        )
