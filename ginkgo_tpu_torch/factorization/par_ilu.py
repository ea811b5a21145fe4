"""ParILU / ParIC: Chow-Patel fixed-point incomplete factorizations.

Counterpart of ``ginkgo_tpu/factorization/par_ilu.py`` (reference
core/factorization/par_ilu.cpp and par_ic.cpp, the compute_l_u_factors
sweeps of common/cuda_hip/factorization/par_ilu_kernels.hpp.inc).  The
dependency structure

    l_ij = (a_ij - sum_{k < min(i, j)} l_ik u_kj) / u_jj

is expanded on the host at generate time (:func:`split_lu_pattern`, a copy
of the JAX package's) into a static product map (pl, pu, pout): one entry
per (l_ik, u_kj) pair feeding an output nonzero.  Each sweep on the device
is then gather, multiply, segment sum, divide and scatter, the async-free
Jacobi form of the reference's sweeps, as PyTorch ops.

Two things differ from the JAX sweeps, for the GPU:

- the segment sum runs over the product map sorted by output on the host
  (a stable sort, so each output sums its products in the map's order)
  through ``torch.segment_reduce``, never through float atomics: two
  factorizations of one matrix are bit-identical;
- the scatters write only the entries of their own factor (index masks
  built once), where the JAX sweeps send the others out of bounds and
  drop them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..matrix.csr import Csr
from ..ops.cg import _sqrt
from .factorization import Factorization


def split_lu_pattern(A: Csr):
    """Host: the L (unit diagonal, strict lower + diagonal) and U (upper
    with the diagonal) CSR patterns of A's pattern, and the index maps of
    the sweeps, as numpy arrays."""
    a = A.to_scipy().tocsr()
    a.sort_indices()
    n = a.shape[0]
    rows = np.repeat(np.arange(n), np.diff(a.indptr))
    cols = a.indices
    vals = a.data

    lower_mask = rows > cols
    upper_mask = ~lower_mask  # includes the diagonal
    # L pattern: strict lower + an explicit unit diagonal; the strict-lower
    # subset of sorted A is sorted, so the diagonal merges in by one
    # searchsorted + np.insert
    N1 = np.int64(n + 1)
    low_keys = rows[lower_mask].astype(np.int64) * N1 + cols[lower_mask]
    diag_keys = np.arange(n, dtype=np.int64) * (N1 + 1)
    ins = np.searchsorted(low_keys, diag_keys)
    l_rows = np.insert(rows[lower_mask], ins, np.arange(n))
    l_cols = np.insert(cols[lower_mask], ins, np.arange(n))
    l_indptr = np.concatenate([[0], np.cumsum(np.bincount(l_rows, minlength=n))])
    # U pattern: upper with the diagonal (rows lacking one get it merged in)
    u_rows = rows[upper_mask]
    u_cols = cols[upper_mask]
    have_diag = np.zeros(n, bool)
    have_diag[u_rows[u_rows == u_cols]] = True
    add_d = np.nonzero(~have_diag)[0]
    if len(add_d):
        up_keys = u_rows.astype(np.int64) * N1 + u_cols
        ins = np.searchsorted(up_keys, add_d.astype(np.int64) * (N1 + 1))
        u_rows = np.insert(u_rows, ins, add_d)
        u_cols = np.insert(u_cols, ins, add_d)
    u_indptr = np.concatenate([[0], np.cumsum(np.bincount(u_rows, minlength=n))])

    # sorted global keys row * (n + 1) + col turn every (i, j) -> slot
    # lookup into one searchsorted; the product map is built SpGEMM-style
    # from strict-lower L entries crossed with their U rows, filtered to A's
    # pattern
    lkeys = l_rows.astype(np.int64) * N1 + l_cols.astype(np.int64)
    ukeys = u_rows.astype(np.int64) * N1 + u_cols.astype(np.int64)
    akeys = rows.astype(np.int64) * N1 + cols.astype(np.int64)
    diag_q = np.arange(n, dtype=np.int64) * N1 + np.arange(n, dtype=np.int64)
    l_diag = np.searchsorted(lkeys, diag_q)
    u_diag = np.searchsorted(ukeys, diag_q)

    # products: strict-lower L entry (i, k) crossed with U row k -> (k, j),
    # kept for j > k (so k < min(i, j)) and (i, j) in A
    l_strict = l_cols < l_rows
    li = l_rows[l_strict].astype(np.int64)
    lk = l_cols[l_strict].astype(np.int64)
    lslot = np.nonzero(l_strict)[0]
    uL = np.diff(u_indptr)
    rep = uL[lk]
    T = int(rep.sum())
    src = np.repeat(np.arange(len(lk), dtype=np.int64), rep)
    grp = np.concatenate([[0], np.cumsum(rep)[:-1]])
    within = np.arange(T, dtype=np.int64) - grp[src]
    pu_all = u_indptr[lk][src] + within
    pj = u_cols[pu_all].astype(np.int64)
    pk = lk[src]
    strict = pj > pk
    src = src[strict]
    pu_all = pu_all[strict]
    pj = pj[strict]
    q = li[src] * N1 + pj
    pos = np.searchsorted(akeys, q)
    posc = np.minimum(pos, max(a.nnz - 1, 0))
    hit = (pos < a.nnz) & (akeys[posc] == q)

    target = np.where(lower_mask, np.searchsorted(lkeys, akeys), np.searchsorted(ukeys, akeys))
    return dict(
        n=n,
        shape=a.shape,
        a_vals=vals,
        a_rows=rows.astype(np.int64),
        a_cols=np.asarray(cols, np.int64),
        l_indptr=l_indptr,
        l_cols=np.asarray(l_cols, np.int64),
        u_indptr=u_indptr,
        u_cols=np.asarray(u_cols, np.int64),
        l_diag=l_diag,
        u_diag=u_diag,
        pl=np.asarray(lslot[src][hit], np.int64),
        pu=np.asarray(pu_all[hit], np.int64),
        pout=np.asarray(pos[hit], np.int64),
        target=target.astype(np.int64),
        is_lower=lower_mask,
        udiag_of_entry=np.where(lower_mask, u_diag[cols], 0).astype(np.int64),
        nnz_l=len(l_cols),
        nnz_u=len(u_cols),
    )


def _index(a, device):
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def parilu_sweeps(plan, sweeps: int, *, device):
    """Chow-Patel sweeps on ``device`` from the host plan of
    :func:`split_lu_pattern`; returns the values of L and U, (nnz_l,) and
    (nnz_u,), in the dtype of A's host values."""
    n, nnz_l, nnz_u = plan["n"], plan["nnz_l"], plan["nnz_u"]
    a_vals = torch.as_tensor(np.asarray(plan["a_vals"]), device=device)
    a_rows, a_cols = plan["a_rows"], plan["a_cols"]
    is_lower = np.asarray(plan["is_lower"], bool)
    low, up = np.nonzero(is_lower)[0], np.nonzero(~is_lower)[0]
    low_t, up_t = _index(low, device), _index(up, device)
    l_tgt, u_tgt = _index(plan["target"][low], device), _index(plan["target"][up], device)
    udiag_low = _index(plan["udiag_of_entry"][low], device)
    u_diag = _index(plan["u_diag"], device)
    # the product map sorted by output: each segment of the sum contiguous,
    # in the map's order (a stable sort)
    order = np.argsort(plan["pout"], kind="stable")
    pl_s, pu_s = _index(plan["pl"][order], device), _index(plan["pu"][order], device)
    lengths = _index(np.bincount(plan["pout"], minlength=len(a_rows)), device)
    dt = a_vals.dtype

    # initial guess: u = upper(A); l = lower(A) / diag(A) with a unit
    # diagonal; rows lacking a diagonal divide by 1
    diag_slots = np.nonzero(a_rows == a_cols)[0]
    diag_a = torch.ones(n, dtype=dt, device=device)
    diag_a[_index(a_rows[diag_slots], device)] = a_vals[_index(diag_slots, device)]
    safe_diag = torch.where(diag_a != 0, diag_a, torch.ones_like(diag_a))
    lv = torch.zeros(nnz_l, dtype=dt, device=device)
    lv[_index(plan["l_diag"], device)] = 1.0
    lv[l_tgt] = a_vals[low_t] / safe_diag[_index(a_cols[low], device)]
    uv = torch.zeros(nnz_u, dtype=dt, device=device)
    uv[u_tgt] = a_vals[up_t]
    ud = uv[u_diag]
    uv[u_diag] = torch.where(torch.abs(ud) > 0, ud, ud + 1)  # a nonzero U diagonal

    for _ in range(int(sweeps)):
        contrib = lv[pl_s] * uv[pu_s]
        s = torch.segment_reduce(contrib, "sum", lengths=lengths, unsafe=True)
        rhs = a_vals - s
        udiag = uv[udiag_low]
        udiag = torch.where(udiag != 0, udiag, torch.ones_like(udiag))
        # a Jacobi sweep: everything above read the old values
        lv[l_tgt] = rhs[low_t] / udiag
        uv[u_tgt] = rhs[up_t]
    return lv, uv


def _factor_csr(indptr, cols, vals, shape, device):
    return Csr(row_ptrs=torch.as_tensor(indptr.astype(np.int32), device=device),
               col_idxs=torch.as_tensor(cols.astype(np.int32), device=device),
               values=vals, shape=tuple(shape))


class ParIluFactory:
    """par_ilu.hpp factory: iterations (sweeps), skip_sorting."""

    def __init__(self, iterations: int = 5, skip_sorting: bool = True):
        self.iterations = int(iterations)

    def generate(self, A) -> Factorization:
        csr = A.to_csr() if hasattr(A, "to_csr") else A
        dev = csr.device
        plan = split_lu_pattern(csr)
        lv, uv = parilu_sweeps(plan, self.iterations, device=dev)
        L = _factor_csr(plan["l_indptr"], plan["l_cols"], lv, plan["shape"], dev)
        U = _factor_csr(plan["u_indptr"], plan["u_cols"], uv, plan["shape"], dev)
        return Factorization(l_factor=L, u_factor=U, shape=tuple(plan["shape"]))


class ParIcFactory:
    """par_ic.cpp analog: the ParILU sweeps on the symmetric pattern, then
    L_ic = L sqrt(diag(U)), so A ~ L_ic L_ic^H; returns L_ic and L_ic^H."""

    def __init__(self, iterations: int = 5, skip_sorting: bool = True):
        self.iterations = int(iterations)

    def generate(self, A) -> Factorization:
        csr = A.to_csr() if hasattr(A, "to_csr") else A
        dev = csr.device
        plan = split_lu_pattern(csr)
        lv, uv = parilu_sweeps(plan, self.iterations, device=dev)
        du = uv[_index(plan["u_diag"], dev)]
        du = torch.where(du.real > 0, du, torch.ones_like(du))
        # real square roots through float64, rounded once (ops/cg._sqrt)
        sq = torch.sqrt(du) if du.is_complex() else _sqrt(du)
        lic = lv * sq[_index(plan["l_cols"], dev)]
        L = _factor_csr(plan["l_indptr"], plan["l_cols"], lic, plan["shape"], dev)
        return Factorization(l_factor=L, u_factor=L.conj_transpose(), shape=tuple(plan["shape"]))


ParIlu = ParIluFactory
ParIc = ParIcFactory
