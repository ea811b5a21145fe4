"""Multigrid coarsening: PGM (parallel graph match) and FixedCoarsening.

Counterpart of ``ginkgo_tpu/multigrid/pgm.py`` (reference
core/multigrid/pgm.cpp and fixed_coarsening.cpp).  PGM is size-2
aggregation by strongest-neighbour matching on the symmetrized strength
graph, unmatched nodes merged into their strongest aggregated neighbour;
the coarse operator is the triple product R A P with piecewise-constant P.
Aggregation and the triple product run on the host at generate time
(numpy/scipy, copied from the JAX package so that both give identical
aggregates); the transfers are device ops:

- ``BandedRestriction``/``BandedProlongation`` when the aggregation stays
  near the stride pattern base(i) = (i // 2S) S + i % S: per distinct
  delta a mask, a (n / 2S, 2, S) reshape-sum and a shift, no gather.  With
  deltas == (0,) (every 2-D stencil hierarchy) the restriction is the
  reshape-sum alone and the prolongation its broadcast, for any stride;
- otherwise ``Restriction`` (a sorted segment sum, never float atomics, so
  a restriction is bit-reproducible on the card) and ``Prolongation`` (a
  row gather by aggregate id).

The TPU lane frame of the banded transfers and their MXU pair matrices
are not carried over.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import scipy.sparse as sps
import torch

from ..base import types
from ..base.linop import LinOp, as_2d, restore_1d
from ..base.matrix_data import MatrixData


def _device_of(A):
    dev = getattr(A, "device", None)
    if dev is not None:
        return dev
    for f in dataclasses.fields(A):
        v = getattr(A, f.name)
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


@dataclasses.dataclass(eq=False)
class Prolongation(LinOp):
    """Piecewise-constant prolongation P: (n_fine, n_coarse)."""

    agg: torch.Tensor  # (n_fine,) int64 aggregate id of each fine row
    n_coarse: int = 0

    @property
    def shape(self):
        return (self.agg.shape[0], self.n_coarse)

    @property
    def dtype(self):
        return torch.float64

    def apply(self, b):
        arr, was_1d = as_2d(b)
        return restore_1d(arr[self.agg], was_1d)


@dataclasses.dataclass(eq=False)
class Restriction(LinOp):
    """R = P^T: sum the fine values of each aggregate.  The rows are sorted
    by aggregate once (a stable sort, so each aggregate sums its rows in
    ascending order) and summed with ``torch.segment_reduce``."""

    agg: torch.Tensor
    n_coarse: int = 0
    order: Any = None  # (n_fine,) rows sorted by aggregate
    lengths: Any = None  # (n_coarse,) rows per aggregate

    def __post_init__(self):
        if self.order is None:
            self.order = torch.argsort(self.agg, stable=True)
            self.lengths = torch.bincount(self.agg, minlength=self.n_coarse)

    @property
    def shape(self):
        return (self.n_coarse, self.agg.shape[0])

    @property
    def dtype(self):
        return torch.float64

    def apply(self, b):
        arr, was_1d = as_2d(b)
        out = torch.segment_reduce(arr[self.order], "sum", lengths=self.lengths, axis=0,
                                   unsafe=True)
        return restore_1d(out, was_1d)


@dataclasses.dataclass(eq=False)
class MultigridLevel(LinOp):
    """One level: fine op + restrict/prolong + coarse op (reference
    multigrid_level.hpp EnableMultigridLevel)."""

    fine_op: Any
    restrict_op: Any
    prolong_op: Any
    coarse_op: Any
    #: host seconds of the level's set-up by phase, where its factory
    #: records them (``PgmFactory``: "aggregate", "triple_product_and_format")
    setup_seconds: Any = None

    @property
    def shape(self):
        return self.fine_op.shape

    @property
    def dtype(self):
        return self.fine_op.dtype

    def apply(self, b):
        return self.fine_op.apply(b)

    def get_fine_op(self):
        return self.fine_op

    def get_coarse_op(self):
        return self.coarse_op

    def get_restrict_op(self):
        return self.restrict_op

    def get_prolong_op(self):
        return self.prolong_op


def _pair_base(n: int, stride: int) -> np.ndarray:
    """Coarse id of fine row i under perfect stride-S pairing (i, i+S)
    with aggregates renumbered by root: base = (i//(2S))*S + i%S."""
    i = np.arange(n)
    return (i // (2 * stride)) * stride + i % stride


def _pair_blocks(n, stride):
    """Pair blocks of 2S rows covering n rows, and the padding."""
    nb = -(-n // (2 * stride))
    return nb, 2 * stride * nb - n


@dataclasses.dataclass(eq=False)
class BandedRestriction(LinOp):
    """Gather-free R = P^T for near-stride-pattern aggregations: the coarse
    id of fine row i is base(i) + delta_i with few distinct bounded deltas,
    so per delta a mask, a (n / 2S, 2, S) reshape-sum and a shift."""

    delta: torch.Tensor  # (n_fine,) int32: agg[i] - base(i)
    deltas: tuple = ()  # distinct shifts
    n_coarse: int = 0
    stride: int = 1

    @property
    def shape(self):
        return (self.n_coarse, self.delta.shape[0])

    @property
    def dtype(self):
        return torch.float64

    @property
    def agg(self):
        """Aggregate ids (Restriction-compatible introspection)."""
        n = self.delta.shape[0]
        base = torch.as_tensor(_pair_base(n, self.stride), device=self.delta.device)
        return base.to(self.delta.dtype) + self.delta

    def apply(self, b):
        arr, was_1d = as_2d(b)
        n, k = arr.shape
        S = self.stride
        nb, pad = _pair_blocks(n, S)
        arr_p = torch.nn.functional.pad(arr, (0, 0, 0, pad))
        nc, Lb = self.n_coarse, nb * S
        if self.deltas == (0,):
            t = arr_p.reshape(nb, 2, S, k).sum(dim=1).reshape(Lb, k)
            return restore_1d(t[:nc], was_1d)
        delta_p = torch.nn.functional.pad(self.delta, (0, pad), value=2**30)
        out = torch.zeros((nc, k), dtype=arr.dtype, device=arr.device)
        for d in self.deltas:
            m = (delta_p == d)[:, None].to(arr.dtype)
            t = (arr_p * m).reshape(nb, 2, S, k).sum(dim=1).reshape(Lb, k)
            if d >= 0:
                ln = min(Lb, nc - d)
                out[d:d + ln] += t[:ln]
            else:
                ln = min(Lb + d, nc)
                out[:ln] += t[-d:-d + ln]
        return restore_1d(out, was_1d)


@dataclasses.dataclass(eq=False)
class BandedProlongation(LinOp):
    """Gather-free piecewise-constant P for near-stride-pattern
    aggregations: fine[i] = coarse[base(i) + delta_i] via per-delta shift,
    pairwise broadcast and mask (see BandedRestriction)."""

    delta: torch.Tensor
    deltas: tuple = ()
    n_coarse: int = 0
    stride: int = 1

    @property
    def shape(self):
        return (self.delta.shape[0], self.n_coarse)

    @property
    def dtype(self):
        return torch.float64

    @property
    def agg(self):
        """Aggregate ids (Prolongation-compatible introspection)."""
        n = self.delta.shape[0]
        base = torch.as_tensor(_pair_base(n, self.stride), device=self.delta.device)
        return base.to(self.delta.dtype) + self.delta

    def apply(self, b):
        arr, was_1d = as_2d(b)
        nc, k = arr.shape
        n = self.delta.shape[0]
        S = self.stride
        nb, pad = _pair_blocks(n, S)
        Lb = nb * S
        if self.deltas == (0,):
            s = torch.zeros((Lb, k), dtype=arr.dtype, device=arr.device)
            ln = min(Lb, nc)
            s[:ln] = arr[:ln]
            out = s.reshape(nb, 1, S, k).expand(nb, 2, S, k).reshape(nb * 2 * S, k)
            return restore_1d(out[:n], was_1d)
        out = torch.zeros((nb * 2 * S, k), dtype=arr.dtype, device=arr.device)
        delta_p = torch.nn.functional.pad(self.delta, (0, pad), value=2**30)
        for d in self.deltas:
            # s[c] = coarse[c + d] on the base-coarse frame, zero outside
            s = torch.zeros((Lb, k), dtype=arr.dtype, device=arr.device)
            if d >= 0:
                ln = min(Lb, nc - d)
                s[:ln] = arr[d:d + ln]
            else:
                ln = min(Lb + d, nc)
                s[-d:-d + ln] = arr[:ln]
            expand = s.reshape(nb, 1, S, k).expand(nb, 2, S, k).reshape(nb * 2 * S, k)
            m = (delta_p == d)[:, None].to(arr.dtype)
            out = out + expand * m
        return restore_1d(out[:n], was_1d)


# banded transfers activate when the aggregation stays this close to the
# stride-pattern base
_BANDED_MAX_DELTA = 64
_BANDED_MAX_DISTINCT = 24


def _detect_stride(agg: np.ndarray, nc: int) -> int:
    """Dominant partner distance of the size-2 aggregates (1 if none)."""
    n = len(agg)
    order = np.argsort(agg, kind="stable")
    sorted_agg = agg[order]
    starts = np.searchsorted(sorted_agg, np.arange(nc))
    sizes = np.diff(np.append(starts, n))
    pair = sizes == 2
    if not pair.any():
        return 1
    d = order[starts[pair] + 1] - order[starts[pair]]
    d = d[d > 0]
    if len(d) == 0:
        return 1
    return int(np.bincount(d).argmax())


def _banded_transfer_ops(agg: np.ndarray, nc: int, device):
    """(restrict, prolong) — banded if the aggregation permits, else the
    general segment-sum/gather pair."""
    n = len(agg)
    best = None
    for stride in {1, _detect_stride(agg, nc)}:
        delta = agg - _pair_base(n, stride)
        distinct = np.unique(delta)
        ok = (
            n > 0
            and np.abs(delta).max(initial=0) <= _BANDED_MAX_DELTA
            and len(distinct) <= _BANDED_MAX_DISTINCT
        )
        if ok and (best is None or len(distinct) < best[3]):
            best = (stride, delta, distinct, len(distinct))
    if best is not None:
        stride, delta, distinct, _ = best
        delta_dev = torch.as_tensor(delta.astype(np.int32), device=device)
        ds = tuple(int(d) for d in distinct)
        return (
            BandedRestriction(delta=delta_dev, deltas=ds, n_coarse=nc, stride=stride),
            BandedProlongation(delta=delta_dev, deltas=ds, n_coarse=nc, stride=stride),
        )
    agg_dev = torch.as_tensor(np.asarray(agg, np.int64), device=device)
    return (
        Restriction(agg=agg_dev, n_coarse=nc),
        Prolongation(agg=agg_dev, n_coarse=nc),
    )


def pgm_aggregate(
    sp, deterministic=True, max_iterations=15, max_unassigned_ratio=0.05
) -> np.ndarray:
    """Iterated strongest-neighbor size-2 matching (pgm.cpp match_edge loop
    until the unassigned ratio target), then leftover merge; returns
    renumbered agg ids.  The JAX package's host code, unchanged, so both
    packages aggregate identically."""
    n = sp.shape[0]
    W = abs(sp) + abs(sp).T  # symmetrized strength (pgm strength graph)
    W = W.tocsr()
    W.setdiag(0)
    W.eliminate_zeros()
    agg = np.full(n, -1, np.int64)

    # Tie-breaks inside _strongest_vectorized: index proximity, then a
    # stride-parity direction preference (prefer j > i iff (i // |j-i|) is
    # even).  The direction rule alternates along any stride chain
    # (i, i±S, ...), so uniform-weight grid rows form mutual pairs in one
    # parallel round, and the aggregate ids follow the stride pattern that
    # activates the banded transfer operators.
    all_rows = np.repeat(np.arange(n), np.diff(W.indptr))

    def _seg_starts(rows):
        """Start offsets of equal-row runs in a row-sorted triplet list."""
        return np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])

    def _strongest_vectorized(is_unagg):
        """Strongest-unaggregated-neighbor for all rows at once via segment
        reductions over the row-sorted adjacency."""
        ok = is_unagg[W.indices] & is_unagg[all_rows]
        rows, cols, wts = all_rows[ok], W.indices[ok], W.data[ok]
        if len(rows) == 0:
            return np.full(n, -1, np.int64)
        # pass 1: per-row max weight (rows stays sorted under the mask)
        starts = _seg_starts(rows)
        wmax_seg = np.maximum.reduceat(wts, starts)
        seg_len = np.diff(np.r_[starts, len(rows)])
        keep = wts >= np.repeat(wmax_seg, seg_len) * (1 - 1e-12)
        rows, cols = rows[keep], cols[keep]
        # pass 2: among max-weight candidates minimize (distance,
        # wrong_direction, col) packed into one int64
        d = np.maximum(np.abs(cols - rows), 1)
        wrong = ((cols > rows) != ((rows // d) % 2 == 0)).astype(np.int64)
        score = (d.astype(np.int64) << 34) | (wrong << 33) | cols
        starts = _seg_starts(rows)
        best = np.minimum.reduceat(score, starts)
        strongest = np.full(n, -1, np.int64)
        strongest[rows[starts]] = best & ((1 << 33) - 1)
        return strongest

    # every round is a parallel mutual strongest-neighbor match (the
    # reference's match_edge), repeated until the unassigned ratio target
    for it in range(max_iterations):
        unagg = np.nonzero(agg < 0)[0]
        if len(unagg) <= max_unassigned_ratio * n:
            break
        is_unagg = agg < 0
        strongest = _strongest_vectorized(is_unagg)
        strongest[~is_unagg] = -1
        j = strongest
        valid = j >= 0
        mutual = valid & (np.where(valid, strongest[j], -2) == np.arange(n))
        lower = mutual & (np.arange(n) < j)
        if not lower.any():
            break
        i_lo = np.nonzero(lower)[0]
        agg[i_lo] = i_lo
        agg[j[i_lo]] = i_lo

    # leftover merge into the strongest aggregated neighbor (a snapshot
    # prevents aggregate-chaining cascades): scatter-max of weights, then
    # scatter-min of (distance, col)-packed keys among the max-weight
    # candidates
    snapshot = agg.copy()
    left = agg < 0
    if left.any():
        ok = left[all_rows] & (snapshot[W.indices] >= 0)
        rows, cols, wts = all_rows[ok], W.indices[ok], W.data[ok]
        if len(rows):
            wmax = np.full(n, -np.inf, wts.dtype)
            np.maximum.at(wmax, rows, wts)
            keep = wts >= wmax[rows]
            rows, cols = rows[keep], cols[keep]
            d = np.abs(cols - rows).astype(np.int64)
            score = (d << 33) | cols.astype(np.int64)
            best = np.full(n, np.iinfo(np.int64).max, np.int64)
            np.minimum.at(best, rows, score)
            got = (best != np.iinfo(np.int64).max) & left
            bcol = best[got] & ((1 << 33) - 1)
            agg[got] = snapshot[bcol]
        # isolated leftovers (no aggregated neighbor) become singletons
        agg[agg < 0] = np.nonzero(agg < 0)[0]
    uniq, renum = np.unique(agg, return_inverse=True)
    return renum


@dataclasses.dataclass(eq=False)
class RowSelector(LinOp):
    """Rectangular selection op: picks idx rows (FixedCoarsening restrict)."""

    idx: torch.Tensor
    n_from: int = 0

    @property
    def shape(self):
        return (self.idx.shape[0], self.n_from)

    def apply(self, b):
        arr, was_1d = as_2d(b)
        return restore_1d(arr[self.idx], was_1d)


@dataclasses.dataclass(eq=False)
class RowScatter(LinOp):
    """Adjoint of RowSelector: scatters into idx rows (prolong)."""

    idx: torch.Tensor
    n_to: int = 0

    @property
    def shape(self):
        return (self.n_to, self.idx.shape[0])

    def apply(self, b):
        arr, was_1d = as_2d(b)
        out = torch.zeros((self.n_to, arr.shape[1]), dtype=arr.dtype, device=arr.device)
        out[self.idx] = arr
        return restore_1d(out, was_1d)


def _host_scipy(A):
    """(scipy CSR, dtype of the coarse values) of an operator, by a
    format-direct conversion where the format has one (no triplet sort):
    the operator's dtype, or its host triples' where it has no
    ``to_scipy`` (ginkgo_tpu multigrid/pgm.py:511-529)."""
    if hasattr(A, "to_scipy"):
        sp = A.to_scipy().tocsr()
        sp.eliminate_zeros()
        return sp, A.dtype
    if not hasattr(A, "to_matrix_data"):
        return _host_scipy(A.to_csr())
    md = A.to_matrix_data()
    vals = md.values
    if vals.dtype not in (np.float32, np.float64, np.complex64, np.complex128):
        vals = vals.astype(np.float32)
    sp = sps.csr_matrix((vals, (md.rows, md.cols)), shape=md.shape)
    return sp, types.to_torch_dtype(md.values.dtype)


class PgmFactory:
    """pgm.hpp factory: max_iterations, max_unassigned_ratio, deterministic."""

    def __init__(
        self,
        max_iterations: int = 15,
        max_unassigned_ratio: float = 0.05,
        deterministic: bool = True,
        skip_sorting: bool = True,
    ):
        self.max_iterations = max_iterations
        self.max_unassigned_ratio = max_unassigned_ratio
        self.deterministic = deterministic

    def generate(self, A) -> MultigridLevel:
        from ..matrix.auto import choose_format

        sp, dtype = _host_scipy(A)
        t0 = time.perf_counter()
        agg = pgm_aggregate(sp, self.deterministic, self.max_iterations,
                            self.max_unassigned_ratio)
        t1 = time.perf_counter()
        nc = int(agg.max()) + 1 if len(agg) else 0
        # coarse operator: R A P (triple product on the host)
        n = sp.shape[0]
        P = sps.csr_matrix((np.ones(n, sp.data.dtype), (np.arange(n), agg)), shape=(n, nc))
        Ac = (P.T @ sp @ P).tocsr()
        Ac.sort_indices()
        device = _device_of(A)
        restrict_op, prolong_op = _banded_transfer_ops(agg, nc, device)
        # the values are rounded to the fine operator's dtype, as the JAX
        # package's; host triples have no bfloat16, so a bfloat16 hierarchy
        # is chosen on the rounded float32 values and cast back
        vals = torch.as_tensor(Ac.data).to(dtype)
        vals = types.to_host(vals)
        Ac_rows = np.repeat(np.arange(Ac.shape[0]), np.diff(Ac.indptr))
        coarse = choose_format(MatrixData.from_coo(Ac.shape, Ac_rows, Ac.indices, vals),
                               device=device)
        if coarse.dtype != dtype:
            coarse = coarse.astype(dtype)
        seconds = {"aggregate": t1 - t0, "triple_product_and_format": time.perf_counter() - t1}
        return MultigridLevel(
            # the caller's operator stays the fine op, so smoother and
            # residual products keep its format
            fine_op=A, restrict_op=restrict_op, prolong_op=prolong_op, coarse_op=coarse,
            setup_seconds=seconds,
        )


Pgm = PgmFactory


class FixedCoarseningFactory:
    """fixed_coarsening.cpp: keep user-selected rows."""

    def __init__(self, coarse_rows):
        self.coarse_rows = np.asarray(coarse_rows, np.int64)

    def generate(self, A) -> MultigridLevel:
        from ..matrix.csr import Csr

        csr = A.to_csr() if hasattr(A, "to_csr") else A
        sp = csr.to_scipy().tocsr()
        n = sp.shape[0]
        rows = self.coarse_rows
        nc = len(rows)
        P = sps.csr_matrix((np.ones(nc), (rows, np.arange(nc))), shape=(n, nc))
        Ac = (P.T @ sp @ P).tocsr()
        device = _device_of(csr)
        sel = torch.as_tensor(rows, device=device)
        return MultigridLevel(
            fine_op=A,
            restrict_op=RowSelector(idx=sel, n_from=n),
            prolong_op=RowScatter(idx=sel, n_to=n),
            coarse_op=Csr.from_scipy(Ac, device=device).astype(csr.dtype),
        )


FixedCoarsening = FixedCoarseningFactory
