"""CSR SpMV strategies as PyTorch ops.

Counterpart of ``ginkgo_tpu/ops/spmv.py`` (:34-78, :133).  These are
gather code in the JAX package (XLA, no Pallas), and plain tensor ops here:

- ``classical``   gather x by column, then a sorted segment sum over rows
                  (``index_add_``);
- ``merge_path``  gather, a cumulative sum over the nnz stream, and the
                  differences at the row boundaries: no scatter.

Both take raw tensors (row_ptrs, col_idxs, values) and x of shape (m,) or
(m, k).
"""

from __future__ import annotations

import torch

from ..base.linop import _scalar


def row_ids_from_ptrs(row_ptrs: torch.Tensor, nnz: int) -> torch.Tensor:
    """One row id per stored entry, in row_ptrs' dtype."""
    k = torch.arange(nnz, dtype=row_ptrs.dtype, device=row_ptrs.device)
    ids = torch.searchsorted(row_ptrs[1:-1].contiguous(), k, right=True)
    return ids.to(row_ptrs.dtype)


def _products(values, col_idxs, x):
    """values[e] * x[col_idxs[e]] per stored entry: (nnz,) or (nnz, k)."""
    xg = x.index_select(0, col_idxs)
    return values * xg if x.dim() == 1 else values[:, None] * xg


def _empty_result(values, x, n_rows):
    shape = (n_rows,) if x.dim() == 1 else (n_rows, x.shape[1])
    return torch.zeros(shape, dtype=torch.promote_types(values.dtype, x.dtype),
                       device=x.device)


def csr_spmv_classical(row_ptrs, col_idxs, values, x, n_rows: int):
    """Gather + sorted segment sum (the reference's classical /
    load_balance role)."""
    nnz = values.shape[0]
    if nnz == 0:
        return _empty_result(values, x, n_rows)
    prod = _products(values, col_idxs, x)
    out = torch.zeros((n_rows,) + tuple(prod.shape[1:]), dtype=prod.dtype,
                      device=prod.device)
    return out.index_add_(0, row_ids_from_ptrs(row_ptrs, nnz), prod)


def csr_spmv_merge_path(row_ptrs, col_idxs, values, x, n_rows: int):
    """Scatter-free: y[r] = cs[ptr[r + 1]] - cs[ptr[r]] over the exclusive
    prefix sum cs of the products."""
    nnz = values.shape[0]
    if nnz == 0:
        return _empty_result(values, x, n_rows)
    prod = _products(values, col_idxs, x)
    cs = torch.cumsum(prod, dim=0)
    cs = torch.cat([torch.zeros_like(cs[:1]), cs], dim=0)
    ptr = row_ptrs.to(torch.int64)
    return cs[ptr[1:]] - cs[ptr[:-1]]


def advanced(spmv_out, alpha, beta, c):
    """alpha * spmv_out + beta * c (alpha, beta: numbers or 1-element
    tensors)."""
    return _scalar(alpha) * spmv_out + _scalar(beta) * c
