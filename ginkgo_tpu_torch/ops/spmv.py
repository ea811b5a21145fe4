"""SpMV strategies as PyTorch ops.

Counterpart of ``ginkgo_tpu/ops/spmv.py``.  These are gather code in the
JAX package (XLA, no Pallas), and plain tensor ops here:

- ``classical``   gather x by column, then a sorted segment sum over rows
                  (``index_add_``);
- ``merge_path``  gather, a cumulative sum over the nnz stream, and the
                  differences at the row boundaries: no scatter;
- ``coo_spmv``, ``ell_spmv``, ``sellp_spmv``: the COO, ELL and SELL-P
                  formats' own products, which those formats fall back to
                  where the streaming route declines.

All take raw tensors and x of shape (m,) or (m, k).  :func:`try_streaming`
is the streaming route of the unstructured formats (``ops/pell.py``
``linop_streaming_spmv``): a format's CSR view through a PELL or WELL plan
and kernels K5/K6 or K8/K9, taken for a CUDA tensor only.
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


def coo_spmv(rows, cols, values, x, n_rows: int):
    """COO SpMV: gather + segment sum over the entries' rows."""
    if values.shape[0] == 0:
        return _empty_result(values, x, n_rows)
    prod = _products(values, cols, x)
    out = torch.zeros((n_rows,) + tuple(prod.shape[1:]), dtype=prod.dtype, device=prod.device)
    return out.index_add_(0, rows.to(torch.int64), prod)


def ell_spmv(col_idxs, values, x, n_rows: int):
    """ELL SpMV: values/col_idxs are (n, K) padded (pad value 0, pad column
    0); y = sum over K of values * x[col_idxs]."""
    xg = x[col_idxs.to(torch.int64)]  # (n, K[, k])
    if x.dim() == 1:
        return torch.sum(values * xg, dim=1)
    return torch.sum(values[:, :, None] * xg, dim=1)


def sellp_spmv(slice_sets, col_idxs, values, x, n_rows: int, slice_size: int):
    """SELL-P SpMV: slice s owns slot-rows slice_sets[s]:slice_sets[s + 1] of
    the (total_slots, slice_size) arrays; a sorted segment sum over the
    slot-rows gives each slice's rows."""
    total_slots = values.shape[0]
    num_slices = slice_sets.shape[0] - 1
    if total_slots == 0:
        return _empty_result(values, x, n_rows)
    slot_ids = row_ids_from_ptrs(slice_sets, total_slots).to(torch.int64)
    xg = x[col_idxs.to(torch.int64)]  # (slots, C[, k])
    prod = values[..., None] * xg if x.dim() > 1 else values * xg
    per_slice = torch.zeros((num_slices,) + tuple(prod.shape[1:]), dtype=prod.dtype,
                            device=prod.device).index_add_(0, slot_ids, prod)
    flat = per_slice.reshape((num_slices * slice_size,) + tuple(per_slice.shape[2:]))
    return flat[:n_rows]


def try_streaming(op, arr):
    """The streaming route for an unstructured format on a CUDA tensor: its
    CSR view's PELL or WELL plan through kernels K5/K6 or K8/K9 (see
    ``ops/pell.linop_streaming_spmv``).  Returns the product, or None where
    the route declines (a CPU tensor, an empty pattern, a plan whose
    padding fails the gates); the caller then takes its own product."""
    if not arr.is_cuda:
        return None
    from . import pell

    return pell.linop_streaming_spmv(op, arr)
