"""Sparse triangular solvers (LowerTrs / UpperTrs).

Counterpart of ``ginkgo_tpu/solver/triangular.py`` (reference
core/solver/lower_trs.cpp / upper_trs.cpp).  Two algorithms, the JAX
package's:

- 'block_scan' (exact, the default): at generate time the factor is packed
  into dense diagonal blocks, inverted (``torch.linalg.inv``, batched), and
  per-block panels of the entries off the block diagonal.  A solve walks the
  block columns in order, x_b = invD_b (rhs_b - offdiag_b x), a Python loop
  of PyTorch ops: the sequential depth drops from n to n / B.
- 'sweeps' (iterative): Jacobi-Richardson sweeps x <- D^{-1}(b - N x), N
  the strict triangle, exact after the level count (``sweeps=None`` runs
  ``_level_count`` at generate time, a Python loop over the rows).  The
  strict triangle goes through ``choose_format``, so the banded factors of
  banded operators become a ``Dia`` and each sweep streams.

A 'sweeps' solve on a ``Dia`` triangle with 1 to 64 float32/bfloat16
diagonals, a float32 right-hand side and at least one sweep runs all its
sweeps in one launch of kernel K22 (``ops/trs.trs_fused``), one launch per
column, as the JAX package's ``_try_fused_sweeps``.  The kernel multiplies
by the float32 inverse diagonal where the streaming loop divides by the
diagonal, so the two differ by ulps.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import scipy.sparse as sps
import torch

from ..base import types
from ..base.linop import LinOp, as_2d, restore_1d
from ..base.matrix_data import MatrixData
from ..matrix.auto import choose_format
from ..matrix.dia import Dia
from ..ops.cg import FUSED_DIAG_DTYPES
from ..ops.dia import MAX_DIAGS
from ..ops.trs import trs_fused


def _level_count(sp, lower: bool) -> int:
    """Longest dependency chain (number of level-scheduling levels)."""
    n = sp.shape[0]
    indptr, indices = sp.indptr, sp.indices
    level = np.zeros(n, np.int64)
    rng = range(n) if lower else range(n - 1, -1, -1)
    for i in rng:
        deps = indices[indptr[i]:indptr[i + 1]]
        deps = deps[deps < i] if lower else deps[deps > i]
        if len(deps):
            level[i] = level[deps].max() + 1
    return int(level.max()) + 1


@dataclasses.dataclass(eq=False)
class TriangularSolver(LinOp):
    inv_diag_blocks: Any  # (nb, B, B) inverted diagonal blocks
    off_csr: Any  # 'sweeps': the strict triangle (choose_format's operator)
    diag: Any  # (n,) diagonal
    #: block_scan per-block panels: the entries of block row bi padded to
    #: the largest per-block count W, so step bi touches only its own
    off_cols: Any = None  # (nb, W) column of each entry
    off_vals: Any = None  # (nb, W) values (0 padding)
    off_lrow: Any = None  # (nb, W) row within the block
    n: int = 0
    block: int = 64
    lower: bool = True
    unit_diag: bool = False
    algorithm: str = "block_scan"
    sweeps: int = 0

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.diag.dtype

    def apply(self, b):
        arr, was_1d = as_2d(b)
        if self.algorithm == "sweeps":
            out = self._solve_sweeps(arr)
        else:
            out = self._solve_block_scan(arr)
        return restore_1d(out, was_1d)

    solve = apply

    def _solve_sweeps(self, arr):
        out = self._try_fused_sweeps(arr)
        if out is not None:
            return out
        T = self.off_csr
        d = self.diag[:, None]
        x = arr / d
        for _ in range(self.sweeps):
            x = (arr - T.apply(x)) / d
        return x

    def _try_fused_sweeps(self, arr):
        """All the sweeps in one K22 launch per column when the strict
        triangle is a Dia with 1 to 64 float32/bfloat16 diagonals, the
        right-hand side float32 and sweeps >= 1 (ginkgo_tpu
        solver/triangular.py:95-140); else None."""
        T = self.off_csr
        if self.algorithm != "sweeps" or not isinstance(T, Dia):
            return None
        if arr.dtype != torch.float32 or self.sweeps < 1:
            return None
        if not 1 <= T.num_diags <= MAX_DIAGS or T.dtype not in FUSED_DIAG_DTYPES:
            return None
        invd = (1.0 / self.diag).to(torch.float32).contiguous()
        cols = [trs_fused(T, invd, arr[:, j].contiguous(), sweeps=self.sweeps)
                for j in range(arr.shape[1])]
        return torch.stack(cols, dim=1).to(arr.dtype)

    def _solve_block_scan(self, arr):
        B = self.block
        nb = self.inv_diag_blocks.shape[0]
        k = arr.shape[1]
        npad = nb * B
        rhs = arr
        if npad > self.n:
            rhs = torch.cat([arr, arr.new_zeros((npad - self.n, k))])
        inv = self.inv_diag_blocks.to(arr.dtype)
        vals = self.off_vals.to(arr.dtype)
        rows = torch.arange(B, device=arr.device)[:, None]
        x = arr.new_zeros((npad, k))
        order = range(nb) if self.lower else range(nb - 1, -1, -1)
        for bi in order:
            # block bi's off-diagonal entries, summed into their rows by a
            # one-hot product (no atomics: the same sum on every run)
            terms = vals[bi][:, None] * x[self.off_cols[bi]]
            onehot = (self.off_lrow[bi][None, :] == rows).to(arr.dtype)
            seg = onehot @ terms
            x[bi * B:(bi + 1) * B] = inv[bi] @ (rhs[bi * B:(bi + 1) * B] - seg)
        return x[:self.n]


def _build(csr_mat, lower: bool, unit_diag: bool, algorithm: str, block: int, sweeps):
    dev = csr_mat.device
    sp = csr_mat.to_scipy().tocsr()
    sp.sort_indices()
    n = sp.shape[0]
    dense_diag = sp.diagonal().copy()
    if unit_diag:
        dense_diag = np.ones(n, dense_diag.dtype)
    dense_diag[dense_diag == 0] = 1

    if algorithm == "sweeps":
        strict = (sps.tril(sp, -1) if lower else sps.triu(sp, 1)).tocoo()
        # the fastest suitable format for the strict triangle: ILU/IC
        # factors of banded operators are banded, so a sweep streams
        # through a Dia
        data = MatrixData.from_coo(strict.shape, strict.row, strict.col, strict.data)
        T = choose_format(data.sort_row_major(), device=dev)
        nsweeps = sweeps if sweeps is not None else _level_count(sp, lower)
        return TriangularSolver(
            inv_diag_blocks=torch.zeros((1, 1, 1), dtype=types.to_torch_dtype(sp.data.dtype),
                                        device=dev),
            off_csr=T, diag=torch.as_tensor(dense_diag, device=dev), n=n, block=block,
            lower=lower, unit_diag=unit_diag, algorithm="sweeps", sweeps=int(nsweeps))

    # block_scan: invert the dense diagonal blocks, keep the rest sparse
    B = int(block)
    nb = -(-n // B)
    blocks = np.zeros((nb, B, B), sp.data.dtype)
    rows = np.repeat(np.arange(n), np.diff(sp.indptr))
    cols = sp.indices
    vals = sp.data.copy()
    if unit_diag:
        on_d = rows == cols
        vals[on_d] = 1.0
        missing = np.setdiff1d(np.arange(n), rows[on_d])
        rows = np.concatenate([rows, missing])
        cols = np.concatenate([cols, missing])
        vals = np.concatenate([vals, np.ones(len(missing), vals.dtype)])
    in_blk = rows // B == cols // B
    blocks[rows[in_blk] // B, rows[in_blk] % B, cols[in_blk] % B] = vals[in_blk]
    # identity-extend the padding rows and any zero diagonal entry
    g = np.arange(nb * B).reshape(nb, B)
    lane = np.arange(B)
    fix = (g >= n) | (blocks[:, lane, lane] == 0)
    blocks[:, lane, lane] = np.where(fix, 1.0, blocks[:, lane, lane])
    inv_blocks = torch.linalg.inv(torch.as_tensor(blocks, device=dev))
    # the off-block part as per-block padded panels
    orows, ocols, ovals = rows[~in_blk], cols[~in_blk], vals[~in_blk]
    blk_of = orows // B
    counts = np.bincount(blk_of, minlength=nb)
    W = max(int(counts.max()) if len(counts) else 0, 1)
    off_cols = np.zeros((nb, W), np.int64)
    off_vals = np.zeros((nb, W), vals.dtype)
    off_lrow = np.zeros((nb, W), np.int64)
    order = np.argsort(blk_of, kind="stable")
    slot = np.arange(len(orows)) - np.concatenate([[0], np.cumsum(counts)])[blk_of[order]]
    off_cols[blk_of[order], slot] = ocols[order]
    off_vals[blk_of[order], slot] = ovals[order]
    off_lrow[blk_of[order], slot] = orows[order] % B
    return TriangularSolver(
        inv_diag_blocks=inv_blocks, off_csr=None,
        off_cols=torch.as_tensor(off_cols, device=dev),
        off_vals=torch.as_tensor(off_vals, device=dev),
        off_lrow=torch.as_tensor(off_lrow, device=dev),
        diag=torch.as_tensor(dense_diag, device=dev), n=n, block=B, lower=lower,
        unit_diag=unit_diag, algorithm="block_scan", sweeps=0)


class _TrsFactory:
    lower = True

    def __init__(self, algorithm="block_scan", block=64, sweeps=None, unit_diagonal=False):
        self.algorithm = algorithm
        self.block = block
        self.sweeps = sweeps
        self.unit_diagonal = unit_diagonal

    def generate(self, T) -> TriangularSolver:
        csr = T.to_csr() if hasattr(T, "to_csr") else T
        return _build(csr, self.lower, self.unit_diagonal, self.algorithm, self.block,
                      self.sweeps)


class LowerTrsFactory(_TrsFactory):
    lower = True


class UpperTrsFactory(_TrsFactory):
    lower = False


class LowerTrs:
    @staticmethod
    def build(**kw):
        return LowerTrsFactory(**kw)


class UpperTrs:
    @staticmethod
    def build(**kw):
        return UpperTrsFactory(**kw)
