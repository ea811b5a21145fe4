"""(Block-)Jacobi preconditioner with adaptive-precision storage.

Counterpart of ``ginkgo_tpu/preconditioner/jacobi.py`` (reference
core/preconditioner/jacobi.cpp, jacobi.hpp: ``max_block_size``, block
detection by supervariable agglomeration, batched block inversion,
per-block adaptive storage through ``storage_optimization``, and the
scalar path at block size 1, jacobi.hpp:203).

- Block size 1: the inverted diagonal, a zero diagonal entry mapped to 1;
  ``block_pointers`` and ``storage_optimization`` are ignored there, as in
  the JAX package.
- Larger blocks: the block pointers come from ``find_natural_blocks`` (a
  host numpy pass, vectorized) or from the caller.  The blocks are padded
  to one size ``max_block_size`` and stored as an (nb, bs, bs) tensor on
  the operator's device, each short block extended by the identity so it
  stays invertible.  The blocks are filled by plain assignment of the
  in-block entries (each slot takes one value), inverted by
  ``torch.linalg.inv`` in one batched call, and applied by a batched
  product written as an elementwise multiply and a sum over the block's
  columns, which no TF32 mode touches.  The JAX package computes both
  outside any Pallas kernel (``jnp.linalg.inv``, an ``einsum`` at HIGHEST
  precision), so these are library calls here too.
- Adaptive storage keeps the inverted blocks in a reduced dtype: the
  precision reduction's storage dtype (bfloat16 for
  ``precision_reduction(0, 1)`` on float32), or int8 with a per-block
  max-abs scale when the storage dtype asked for is int8; the apply reads
  them back in the right-hand side's dtype.

The whole-solve kernels take the scalar path only
(``solver/_fused_gate.py``): a block Jacobi solve streams.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..base import types
from ..base.linop import LinOp, as_2d, restore_1d


def find_natural_blocks(csr, max_block_size: int) -> np.ndarray:
    """Supervariable agglomeration (the jacobi find_blocks kernel): runs of
    consecutive rows with the same sparsity pattern, cut every
    ``max_block_size`` rows, then adjacent runs agglomerated greedily up to
    ``max_block_size`` rows.  Returns the block pointers (nb + 1,), the JAX
    package's.

    Pattern equality of adjacent rows is one shifted compare over the
    column indices; the greedy walk (from a bound, to the largest bound at
    most ``max_block_size`` rows on) is followed by doubling its jump
    table, O(log nb) numpy passes."""
    rp = types.to_host(csr.row_ptrs).astype(np.int64)
    ci = types.to_host(csr.col_idxs)
    n = csr.shape[0]
    if n <= 1:
        return np.asarray([0, n], dtype=np.int64)
    L = np.diff(rp)
    same_len = np.concatenate([[False], L[1:] == L[:-1]])
    # entry t of row r against entry t of row r - 1, at rp[r - 1] + t; only
    # rows as long as the one before are read
    prev_len = np.concatenate([[0], L[:-1]])
    differs = ci != ci[np.arange(len(ci), dtype=np.int64) - np.repeat(prev_len, L)]
    all_eq = np.ones(n, dtype=bool)
    all_eq[np.repeat(np.arange(n, dtype=np.int64), L)[differs]] = False
    brk = ~(same_len & all_eq)  # brk[r]: row r starts a new pattern run
    brk[0] = True
    run_id = np.cumsum(brk) - 1
    idx = np.arange(n, dtype=np.int64)
    run_start = idx[brk][run_id]
    bounds = np.concatenate([idx[brk | ((idx - run_start) % max_block_size == 0)], [n]])
    # the greedy walk's jump table over the bounds, and its path from 0
    m = len(bounds)
    bi = np.arange(m)
    nxt = np.searchsorted(bounds, bounds + max_block_size, side="right") - 1
    nxt = np.minimum(np.where(nxt <= bi, bi + 1, nxt), m - 1)
    nxt[m - 1] = m - 1
    on_path = np.zeros(m, dtype=bool)  # the walk's first 2^k steps
    on_path[0] = True
    jump = nxt  # 2^k steps of the walk
    while True:
        step = jump[on_path]
        if on_path[step].all():
            break
        on_path[step] = True
        jump = jump[jump]
    return bounds[on_path].astype(np.int64)


@dataclasses.dataclass(eq=False)
class Jacobi(LinOp):
    inv_diag: Any  # scalar path: (n,) inverted diagonal, else None
    inv_blocks: Any = None  # block path: (nb, bs, bs) in the storage dtype
    block_scales: Any = None  # (nb,) float32 scales (1 where storage preserves)
    row_block: Any = None  # (n,) block of each row
    row_local: Any = None  # (n,) index of each row in its block
    block_starts: Any = None  # (nb,) first row of each block
    n: int = 0
    max_block_size: int = 1

    @staticmethod
    def build(max_block_size: int = 1, block_pointers=None, storage_optimization=None,
              skip_sorting: bool = True) -> "JacobiFactory":
        return JacobiFactory(
            max_block_size=max_block_size,
            block_pointers=block_pointers,
            storage_optimization=storage_optimization,
        )

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        # the JAX package's: the inverted diagonal's dtype, float32 for blocks
        return self.inv_diag.dtype if self.inv_diag is not None else torch.float32

    @property
    def num_blocks(self):
        return self.block_starts.shape[0] if self.block_starts is not None else self.n

    def _blocks(self, dtype):
        """The inverted blocks in ``dtype``, scales applied."""
        return self.inv_blocks.to(dtype) * self.block_scales.to(dtype)[:, None, None]

    def _block_sizes(self):
        ends = torch.cat([self.block_starts[1:],
                          self.block_starts.new_tensor([self.n])])
        return ends - self.block_starts

    def apply(self, b):
        arr, was_1d = as_2d(b)
        if self.inv_diag is not None:  # scalar path (jacobi.hpp:203)
            return restore_1d(self.inv_diag[:, None] * arr, was_1d)
        bs = self.max_block_size
        # gather the right-hand side's rows into (nb, bs, k); a padding row
        # reads a zero row
        arr_pad = torch.cat([arr, arr.new_zeros((1, arr.shape[1]))])
        idx = self.block_starts[:, None] + torch.arange(bs, device=arr.device)[None, :]
        r_blk = arr_pad[torch.where(idx < self.n, idx, self.n)]
        y_blk = (self._blocks(arr.dtype)[..., None] * r_blk[:, None, :, :]).sum(dim=2)
        # each row reads its (block, local) slot: no scatter
        return restore_1d(y_blk[self.row_block, self.row_local], was_1d)

    def to_matrix_data(self):
        """WritableToMatrixData (jacobi.cpp:61-74): the explicit
        (block-)diagonal inverse, its O(n bs) entries, without forming the
        n x n operator."""
        from ..base.matrix_data import MatrixData

        if self.inv_diag is not None:
            idx = np.arange(self.n)
            return MatrixData.from_coo((self.n, self.n), idx, idx,
                                       types.to_host(self.inv_diag))
        bs = self.max_block_size
        work = torch.promote_types(self.inv_blocks.dtype, torch.float32)
        inv = types.to_host(self._blocks(work))
        starts = types.to_host(self.block_starts)
        sizes = types.to_host(self._block_sizes())
        bi, li, lj = np.meshgrid(np.arange(len(starts)), np.arange(bs), np.arange(bs),
                                 indexing="ij")
        ok = (li < sizes[bi]) & (lj < sizes[bi])
        return MatrixData.from_coo((self.n, self.n), (starts[bi] + li)[ok],
                                   (starts[bi] + lj)[ok], inv[bi, li, lj][ok]).sort_row_major()

    write = to_matrix_data

    def transpose(self) -> "Jacobi":
        if self.inv_diag is not None:
            return self
        return self.replace(inv_blocks=self.inv_blocks.transpose(1, 2))

    conj_transpose = transpose  # real blocks: the transpose

    def to_dense(self):
        from ..matrix.dense import Dense

        if self.inv_diag is not None:
            return Dense(values=torch.diag(self.inv_diag))
        work = torch.promote_types(self.inv_blocks.dtype, torch.float32)
        inv = self._blocks(work)
        bs = self.max_block_size
        lane = torch.arange(bs, device=inv.device)
        ok = lane[None, :] < self._block_sizes()[:, None]
        rows = self.block_starts[:, None] + lane[None, :]
        mask = ok[:, :, None] & ok[:, None, :]
        bi, li, lj = torch.nonzero(mask, as_tuple=True)
        out = torch.zeros((self.n, self.n), dtype=work, device=inv.device)
        out[rows[bi, li], rows[bi, lj]] = inv[bi, li, lj]
        return Dense(values=out)


class JacobiFactory:
    """jacobi.hpp factory; ``generate`` detects the blocks on the host and
    inverts them on the operator's device."""

    def __init__(self, max_block_size: int = 1, block_pointers=None,
                 storage_optimization=None):
        self.max_block_size = int(max_block_size)
        self.block_pointers = block_pointers
        self.storage_optimization = storage_optimization

    def generate(self, A) -> Jacobi:
        if not hasattr(A, "extract_diagonal"):
            A = A.to_csr()  # operators that only provide to_csr
        n = A.shape[0]
        if self.max_block_size == 1:
            diag = A.extract_diagonal().values
            ok = diag != 0
            one = torch.ones_like(diag)
            inv = torch.where(ok, 1.0 / torch.where(ok, diag, one), one)
            return Jacobi(inv_diag=inv, n=n, max_block_size=1)

        csr = A.to_csr() if hasattr(A, "to_csr") else A
        dev = csr.values.device
        if self.block_pointers is not None:
            ptrs = np.asarray(types.to_host(self.block_pointers), dtype=np.int64)
        else:
            ptrs = find_natural_blocks(csr, self.max_block_size)
        bs = self.max_block_size
        nb = len(ptrs) - 1
        starts = ptrs[:-1]
        sizes = np.diff(ptrs)
        row_block = np.repeat(np.arange(nb), sizes)
        row_local = np.arange(n) - starts[row_block]

        # the diagonal blocks: the entries whose row and column lie in one
        # block, each written to its own slot
        def dev_tensor(a):
            return torch.as_tensor(a, dtype=torch.int64, device=dev)

        rb, rl, st, sz = map(dev_tensor, (row_block, row_local, starts, sizes))
        rids = csr.row_ids().to(torch.int64)
        e_blk = rb[rids]
        e_lc = csr.col_idxs.to(torch.int64) - st[e_blk]
        ok = (e_lc >= 0) & (e_lc < sz[e_blk])
        work = types.arithmetic_dtype(csr.values.dtype)
        blocks = torch.zeros((nb, bs, bs), dtype=work, device=dev)
        blocks[e_blk[ok], rl[rids][ok], e_lc[ok]] = csr.values[ok].to(work)
        # extend each short block by the identity so it stays invertible
        lane = torch.arange(bs, device=dev)
        pad = (lane[None, :] >= sz[:, None]).to(work)
        blocks[:, lane, lane] += pad
        inv = torch.linalg.inv(blocks)

        scales = torch.ones(nb, dtype=torch.float32, device=dev)
        storage = inv
        if self.storage_optimization is not None:
            sd = types.to_torch_dtype(self.storage_optimization.storage_dtype(csr.values.dtype))
            if sd == torch.int8:
                amax = torch.amax(torch.abs(inv), dim=(1, 2))
                q_scales = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
                storage = torch.clamp(torch.round(inv / q_scales[:, None, None]),
                                      -127, 127).to(torch.int8)
                scales = q_scales.to(torch.float32)
            else:
                storage = inv.to(sd)
        return Jacobi(inv_diag=None, inv_blocks=storage, block_scales=scales,
                      row_block=rb, row_local=rl, block_starts=st, n=n, max_block_size=bs)
