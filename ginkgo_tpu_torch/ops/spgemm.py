"""SpGEMM and SpGEAM: sparse times sparse, sparse plus sparse.

Counterpart of ``ginkgo_tpu/ops/spgemm.py`` (reference csr spgemm,
advanced spgemm and spgeam kernels).  Symbolic on the host, numeric on the
device: the host pass (scipy and numpy, set-up) finds the output pattern
and a static expansion map; the numeric pass gathers, multiplies and sums
on the matrices' device, and can be rerun for new values on the same
patterns.

The sums run in a fixed order on every device: SpGEMM's products are
sorted by their output slot (stable, so in the order of A's entries and
then B's) and each slot's run is summed by ``torch.segment_reduce`` from
its lengths, not by an atomic scatter; SpGEAM gives each slot at most one
entry of A and one of B and adds them in that order, A first.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.linop import _scalar


def _pattern(csr):
    """The scipy CSR of ``csr``'s pattern, every stored value 1."""
    m = csr.to_scipy().tocsr()
    m.sort_indices()
    m.data = np.ones_like(m.data)
    return m


class SpgemmPlan:
    """The expansion map of C = A B on fixed patterns: product t is
    A.values[prod_a[t]] * B.values[prod_b[t]], summed into C.values in runs
    of ``lengths`` (products sorted by output slot)."""

    def __init__(self, A_csr, B_csr):
        a = _pattern(A_csr)
        b = _pattern(B_csr)
        c = (a @ b).tocsr()
        c.sort_indices()
        c.sum_duplicates()
        self.c_indptr = c.indptr.copy()
        self.c_indices = c.indices.copy()
        self.c_shape = (a.shape[0], b.shape[1])
        # the products of each A entry (i, k) with B's row k
        a_rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(a.indptr))
        b_len = np.diff(b.indptr).astype(np.int64)
        rep = b_len[a.indices]
        total = int(rep.sum())
        prod_a = np.repeat(np.arange(a.nnz, dtype=np.int64), rep)
        group_start = np.concatenate([[0], np.cumsum(rep)[:-1]])
        within = np.arange(total, dtype=np.int64) - group_start[prod_a]
        prod_b = b.indptr[a.indices][prod_a] + within
        # the slot of (i, j) in C by one search over C's row-major keys
        ncols = np.int64(b.shape[1])
        c_rows = np.repeat(np.arange(c.shape[0], dtype=np.int64), np.diff(c.indptr))
        ckey = c_rows * (ncols + 1) + c.indices.astype(np.int64)
        prod_out = np.searchsorted(ckey, a_rows[prod_a] * (ncols + 1)
                                   + b.indices[prod_b].astype(np.int64))
        order = np.argsort(prod_out, kind="stable")
        self.nnz_c = c.nnz
        dev = A_csr.values.device
        self.prod_a = torch.as_tensor(prod_a[order], device=dev)
        self.prod_b = torch.as_tensor(prod_b[order], device=dev)
        self.prod_out = torch.as_tensor(prod_out[order], device=dev)
        self.lengths = torch.as_tensor(
            np.bincount(prod_out, minlength=max(self.nnz_c, 1)), device=dev)

    def numeric(self, a_values, b_values):
        """C's values, in ``promote_types`` of the two value dtypes."""
        contrib = a_values[self.prod_a] * b_values[self.prod_b]
        return torch.segment_reduce(contrib, "sum", lengths=self.lengths, unsafe=True)


def spgemm(A_csr, B_csr):
    """C = A B (the reference's apply of a Csr to a Csr)."""
    from ..matrix.csr import Csr

    plan = SpgemmPlan(A_csr, B_csr)
    dev = A_csr.values.device
    return Csr(
        row_ptrs=torch.as_tensor(plan.c_indptr, dtype=torch.int32, device=dev),
        col_idxs=torch.as_tensor(plan.c_indices, dtype=torch.int32, device=dev),
        values=plan.numeric(A_csr.values, B_csr.values),
        shape=plan.c_shape,
        strategy=A_csr.strategy,
    )


def advanced_spgemm(alpha, A_csr, B_csr, beta, C_csr):
    """alpha A B + beta C (the advanced spgemm kernel)."""
    return spgeam(alpha, spgemm(A_csr, B_csr), beta, C_csr)


def _slots_of(m, u):
    """For each entry of scipy CSR m, its slot in the union pattern u."""
    ncols = np.int64(u.shape[1])
    u_rows = np.repeat(np.arange(u.shape[0], dtype=np.int64), np.diff(u.indptr))
    ukey = u_rows * (ncols + 1) + u.indices.astype(np.int64)
    m_rows = np.repeat(np.arange(m.shape[0], dtype=np.int64), np.diff(m.indptr))
    return np.searchsorted(ukey, m_rows * (ncols + 1) + m.indices.astype(np.int64))


class SpgeamPlan:
    """The union pattern of alpha A + beta B and the slot of every entry of
    A and of B in it."""

    def __init__(self, A_csr, B_csr):
        a = _pattern(A_csr)
        b = _pattern(B_csr)
        u = (a + b).tocsr()
        u.sort_indices()
        self.u_indptr = u.indptr.copy()
        self.u_indices = u.indices.copy()
        self.shape = a.shape
        self.nnz = u.nnz
        dev = A_csr.values.device
        self.a_slots = torch.as_tensor(_slots_of(a, u), device=dev)
        self.b_slots = torch.as_tensor(_slots_of(b, u), device=dev)

    def numeric(self, alpha, a_values, beta, b_values):
        dtype = torch.promote_types(a_values.dtype, b_values.dtype)
        out = torch.zeros(max(self.nnz, 1), dtype=dtype, device=a_values.device)
        # each slot takes at most one entry of A and one of B: A's first
        out.index_add_(0, self.a_slots, (_scalar(alpha) * a_values).to(dtype))
        out.index_add_(0, self.b_slots, (_scalar(beta) * b_values).to(dtype))
        return out


def spgeam(alpha, A_csr, beta, B_csr):
    """alpha A + beta B on the union pattern."""
    from ..matrix.csr import Csr

    plan = SpgeamPlan(A_csr, B_csr)
    dev = A_csr.values.device
    return Csr(
        row_ptrs=torch.as_tensor(plan.u_indptr, dtype=torch.int32, device=dev),
        col_idxs=torch.as_tensor(plan.u_indices, dtype=torch.int32, device=dev),
        values=plan.numeric(alpha, A_csr.values, beta, B_csr.values),
        shape=plan.shape,
        strategy=A_csr.strategy,
    )
