"""ISAI: incomplete sparse approximate inverse preconditioners.

Counterpart of ``ginkgo_tpu/preconditioner/isai.py`` (reference
core/preconditioner/isai.cpp :66-260, isai.hpp ``isai_type {lower, upper,
general, spd}`` and ``sparsity_power``; the spd "general_solve" normalizes
by the square root of the solution's diagonal entry,
isai_kernels.hpp.inc:245-289).  Row i of the approximate inverse M solves
the small dense system on M's row pattern J_i:
M[i, J_i] A[J_i, J_i] = e_i[J_i].

Every row is padded to the largest pattern size S and all rows are solved
as one batched (chunk, S, S) dense solve, ``torch.linalg.solve`` on the
matrix's device (the JAX package leaves it to XLA).  The gather of the
local systems is host numpy (a copy of the JAX package's set-up: one
sorted-key searchsorted over A's entries, chunked to bound memory).  The
result is a ``Csr`` with A's dtype on A's device; "spd" returns the
Composition M^H M (isai.hpp:246-251).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import torch

from ..base import types
from ..base.linop import Composition
from ..matrix.csr import Csr


def _pattern(sp, isai_type: str, power: int):
    pa = sp.copy()
    pa.data = np.ones_like(pa.data)
    if isai_type in ("lower", "spd"):
        pa = sps.tril(pa).tocsr()
    elif isai_type == "upper":
        pa = sps.triu(pa).tocsr()
    pat = pa
    for _ in range(power - 1):
        pat = (pat @ pa).tocsr()
        pat.data = np.ones_like(pat.data)
    pat.sort_indices()
    return pat


def generate_isai(A_csr: Csr, isai_type: str = "general", sparsity_power: int = 1) -> Csr:
    """The approximate inverse as a ``Csr`` on the requested pattern.  For
    "spd" the local systems come from the full symmetric A and each row is
    scaled by 1 / sqrt of its diagonal solution entry
    (isai_kernels.hpp.inc:278-281), so that M ~ L^{-1} for the exact
    Cholesky factor L."""
    dev = A_csr.device
    sp = A_csr.to_scipy().tocsr()
    sp.sort_indices()
    n = sp.shape[0]
    pat = _pattern(sp, isai_type, sparsity_power)
    lengths = np.diff(pat.indptr)
    S = max(int(lengths.max()) if n else 1, 1)

    # sorted global entry keys row * (n + 1) + col: every A[r, c] probe is
    # one searchsorted into one array
    arows = np.repeat(np.arange(n, dtype=np.int64), np.diff(sp.indptr))
    akey = arows * (n + 1) + sp.indices.astype(np.int64)
    avals = sp.data
    nnz_a = len(akey)

    vals = np.zeros(pat.nnz, sp.data.dtype)
    # chunks keep the (chunk, S, S) int64 key tensor near 64 MB
    chunk = int(max(1024, min(n if n else 1, (1 << 23) // max(S * S, 1))))
    lane = np.arange(S)
    for r0 in range(0, max(n, 1), chunk):
        r1 = min(n, r0 + chunk)
        nr = r1 - r0
        if nr <= 0:
            break
        m = lengths[r0:r1]
        maskJ = lane[None, :] < m[:, None]
        Jpad = np.zeros((nr, S), np.int64)
        Jpad[maskJ] = pat.indices[pat.indptr[r0]:pat.indptr[r1]]
        key = Jpad[:, :, None] * (n + 1) + Jpad[:, None, :]
        p = np.searchsorted(akey, key.ravel())
        pc = np.minimum(p, max(nnz_a - 1, 0))
        hit = (p < nnz_a) & (akey[pc] == key.ravel())
        G = np.where(hit, avals[pc], 0).reshape(nr, S, S)
        G = np.where(maskJ[:, :, None] & maskJ[:, None, :], G, 0.0)
        # identity-extend the padding so the batched solve stays regular
        G[:, lane, lane] = np.where(~maskJ, 1.0, G[:, lane, lane])
        # rhs: e_i at the position of i within J_i (absent: a zero row)
        rows_idx = np.arange(r0, r1, dtype=np.int64)
        eq = (Jpad == rows_idx[:, None]) & maskJ
        has = eq.any(axis=1)
        pos = np.argmax(eq, axis=1)
        E = np.zeros((nr, S), sp.data.dtype)
        E[np.arange(nr)[has], pos[has]] = 1.0
        # M[i, J] A[J, J] = e_i  =>  A[J, J]^T m^T = e, one batched solve
        Gt = torch.as_tensor(np.ascontiguousarray(np.swapaxes(G.astype(sp.data.dtype), 1, 2)),
                             device=dev)
        Mrows = torch.linalg.solve(Gt, torch.as_tensor(E, device=dev)[..., None])[..., 0]
        mhost = types.to_host(Mrows).astype(sp.data.dtype)
        if isai_type == "spd":
            # scale by 1/sqrt of the solution at the position of i within J_i
            # (rows lacking a diagonal stay as they are)
            diag = mhost[np.arange(nr), pos]
            with np.errstate(invalid="ignore", divide="ignore"):
                scale = 1.0 / np.sqrt(diag)
            ok = has & np.isfinite(scale) & (diag > 0)
            mhost = mhost * np.where(ok, scale, 1.0)[:, None]
        vals[pat.indptr[r0]:pat.indptr[r1]] = mhost[maskJ]
    return Csr.create((n, n), pat.indptr, pat.indices, vals, device=dev).astype(A_csr.dtype)


class IsaiFactory:
    """isai.hpp factory: isai_type in {lower, upper, general, spd},
    sparsity_power."""

    def __init__(self, isai_type: str = "general", sparsity_power: int = 1):
        if isai_type not in ("lower", "upper", "general", "spd"):
            raise ValueError(f"unknown isai_type {isai_type!r}")
        self.isai_type = isai_type
        self.sparsity_power = int(sparsity_power)

    def generate(self, A):
        csr = A.to_csr() if hasattr(A, "to_csr") else A
        approx = generate_isai(csr, self.isai_type, self.sparsity_power)
        if self.isai_type == "spd":
            # M ~ L^{-1}; the preconditioner is M^H M (isai.hpp:246-251)
            return Composition(operators=(approx.conj_transpose(), approx))
        return approx


class Isai:
    @staticmethod
    def build(isai_type="general", sparsity_power=1, **kw):
        return IsaiFactory(isai_type, sparsity_power)


# aliases of the reference's typedefs (isai.hpp:316-330)
def LowerIsai(sparsity_power=1):
    return IsaiFactory("lower", sparsity_power)


def UpperIsai(sparsity_power=1):
    return IsaiFactory("upper", sparsity_power)


def GeneralIsai(sparsity_power=1):
    return IsaiFactory("general", sparsity_power)


def SpdIsai(sparsity_power=1):
    return IsaiFactory("spd", sparsity_power)
