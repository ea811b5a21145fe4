"""CSR sparse matrix.

Counterpart of ``ginkgo_tpu/matrix/csr.py`` (reference
include/ginkgo/core/matrix/csr.hpp).  A strategy is a string that picks
the SpMV; the names are the JAX package's, so user code carries over:

  'classical'    gather + sorted segment sum      (ops/spmv.py)
  'merge_path'   scan + row-boundary difference   (ops/spmv.py)
  'sparselib'    torch.sparse CSR product (the vendor-library binding)
  'pallas'       the cached PELL or WELL plan (ops/pell.plan_for) and
                 kernels K5/K6 or K8/K9
  'auto'         on a CUDA tensor the JAX package's accelerator branch:
                 'pallas' when the PELL plan's inflation is at most 16, or
                 else when the WELL plan's is at most 16 or its padded
                 bytes at most 256 MiB, and the plan's slots fit
                 HARD_PAD_BYTES; 'classical' otherwise.  On a CPU tensor
                 its host branch, 'merge_path' for skewed rows and
                 'classical' otherwise
  'sellp'        not ported yet (the Ell/Sellp formats come with queue A
                 item 2's streaming formats)

Structure ops run as tensor ops on the matrix's device; permutations and
``to_scipy`` are host set-up paths, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..base import types
from ..base.exceptions import NotImplementedError_
from ..base.linop import LinOp, _scalar, as_2d, restore_1d
from ..base.matrix_data import MatrixData
from ..ops import pell as ops_pell
from ..ops import spmv as spmv_ops
from ..ops import well as ops_well

STRATEGIES = ("classical", "merge_path", "sparselib", "sellp", "pallas", "auto")


@dataclasses.dataclass(eq=False)
class Csr(LinOp):
    row_ptrs: torch.Tensor  # (n + 1,)
    col_idxs: torch.Tensor  # (nnz,)
    values: torch.Tensor  # (nnz,)
    shape: tuple = (0, 0)
    strategy: str = "auto"

    # -- construction ---------------------------------------------------------

    @staticmethod
    def create(shape, row_ptrs, col_idxs, values, *, device, strategy="auto") -> "Csr":
        return Csr(
            row_ptrs=torch.as_tensor(np.asarray(row_ptrs), device=device),
            col_idxs=torch.as_tensor(np.asarray(col_idxs), device=device),
            values=torch.as_tensor(np.asarray(values), device=device),
            shape=tuple(int(s) for s in shape),
            strategy=strategy,
        )

    @staticmethod
    def from_matrix_data(data: MatrixData, *, device, index_dtype=torch.int32,
                         strategy="auto") -> "Csr":
        d = data.sum_duplicates()
        row_ptrs = np.zeros(d.shape[0] + 1, dtype=np.int64)
        np.add.at(row_ptrs, d.rows + 1, 1)
        row_ptrs = np.cumsum(row_ptrs)
        return Csr(
            row_ptrs=torch.as_tensor(row_ptrs, dtype=index_dtype, device=device),
            col_idxs=torch.as_tensor(d.cols, dtype=index_dtype, device=device),
            values=torch.as_tensor(d.values, device=device),
            shape=tuple(d.shape),
            strategy=strategy,
        )

    read = from_matrix_data

    @staticmethod
    def from_scipy(sp, *, device, strategy="auto") -> "Csr":
        m = sp.tocsr()
        return Csr.create(m.shape, m.indptr, m.indices, m.data, device=device,
                          strategy=strategy)

    # -- core -----------------------------------------------------------------

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    num_stored_elements = nnz

    def with_strategy(self, strategy: str) -> "Csr":
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}")
        return self.replace(strategy=strategy)

    def _resolve_strategy(self) -> str:
        """The 'auto' pick, memoized on the instance (the statistics pass
        costs seconds at millions of nonzeros and a Csr's storage does not
        change); the memo is keyed on what the decision reads."""
        if self.strategy != "auto":
            return self.strategy
        key = (self.device.type, ops_pell.HARD_PAD_BYTES)
        cached = getattr(self, "_strategy_memo", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        if self.device.type == "cuda":
            resolved = self._resolve_unstructured()
        else:
            lengths = self.host_row_lengths()
            skewed = len(lengths) and lengths.max() > 4 * max(lengths.mean(), 1)
            resolved = "merge_path" if skewed else "classical"
        self._strategy_memo = (key, resolved)
        return resolved

    def _resolve_unstructured(self) -> str:
        """The accelerator branch: a streaming plan when its storage
        inflation is acceptable, else the gather kernel.  PELL is tried
        first; a locality-free pattern gets the WELL plan under the same
        gates as the JAX package's (statistics-only passes, nothing is
        allocated)."""
        host = [types.to_host(t) for t in (self.row_ptrs, self.col_idxs, self.values)]
        itemsize = self.values.element_size()
        stats = ops_pell.PellPlan(*host, self.shape, q_dtype=np.int8,
                                  materialize=False, value_itemsize=itemsize)
        if stats.inflation <= 16.0 and stats.total_cells * 8 <= ops_pell.HARD_PAD_BYTES:
            return "pallas"
        if stats.nnz > 0:
            ws = ops_well.WellPlan(*host, self.shape, materialize=False,
                                   value_itemsize=itemsize)
            # the cells bound is plan_for's max_cells, so that 'pallas'
            # never resolves to a plan that plan_for then declines
            if ((ws.inflation <= 16.0 or ws.padded_bytes <= 256 << 20)
                    and ws.total_cells * 8 <= ops_pell.HARD_PAD_BYTES):
                return "pallas"
        return "classical"

    def apply(self, b):
        if isinstance(b, Csr):
            raise NotImplementedError_("Csr x Csr (SpGEMM) is not ported yet")
        arr, was_1d = as_2d(b)
        strat = self._resolve_strategy()
        if strat == "classical":
            out = spmv_ops.csr_spmv_classical(
                self.row_ptrs, self.col_idxs, self.values, arr, self.shape[0])
        elif strat == "merge_path":
            out = spmv_ops.csr_spmv_merge_path(
                self.row_ptrs, self.col_idxs, self.values, arr, self.shape[0])
        elif strat == "sparselib":
            out = self._sparselib_apply(arr)
        elif strat == "pallas":
            out = ops_pell.csr_spmv(
                self.row_ptrs, self.col_idxs, self.values, arr, self.shape[0])
        elif strat == "sellp":
            raise NotImplementedError_(
                "strategy 'sellp' needs the Ell/Sellp formats, which are not "
                "ported yet (queue A item 2, the unstructured streaming formats)")
        else:
            raise ValueError(f"unknown strategy {strat!r}")
        return restore_1d(out, was_1d)

    def apply_advanced(self, alpha, b, beta, x):
        arr, was_1d = as_2d(b)
        xa, _ = as_2d(x)
        out = spmv_ops.advanced(self.apply(arr), alpha, beta, xa)
        return restore_1d(out, was_1d)

    def _sparselib_apply(self, arr):
        work = torch.promote_types(types.arithmetic_dtype(self.dtype), arr.dtype)
        idx = torch.int64 if torch.int64 in (self.row_ptrs.dtype, self.col_idxs.dtype) else torch.int32
        sp = torch.sparse_csr_tensor(
            self.row_ptrs.to(idx), self.col_idxs.to(idx), self.values.to(work),
            size=self.shape,
        )
        return sp @ arr.to(work)

    # -- structure ops ----------------------------------------------------------

    def row_ids(self):
        return spmv_ops.row_ids_from_ptrs(self.row_ptrs, self.nnz)

    def transpose(self) -> "Csr":
        rids = self.row_ids()
        # order by (column, row): a stable sort on the combined key
        key = self.col_idxs.to(torch.int64) * self.shape[0] + rids.to(torch.int64)
        order = torch.argsort(key, stable=True)
        new_rows = self.col_idxs[order]
        counts = torch.bincount(new_rows.to(torch.int64), minlength=self.shape[1])
        row_ptrs = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        return Csr(
            row_ptrs=row_ptrs.to(self.row_ptrs.dtype),
            col_idxs=rids[order],
            values=self.values[order],
            shape=(self.shape[1], self.shape[0]),
            strategy=self.strategy,
        )

    def conj_transpose(self) -> "Csr":
        t = self.transpose()
        return t.replace(values=torch.conj(t.values))

    def scale(self, alpha) -> "Csr":
        return self.replace(values=self.values * _scalar(alpha))

    def inv_scale(self, alpha) -> "Csr":
        return self.replace(values=self.values / _scalar(alpha))

    def extract_diagonal(self):
        from .diagonal import Diagonal

        n = min(self.shape)
        rids = self.row_ids()
        on_diag = (rids == self.col_idxs) & (rids < n)
        diag = torch.zeros(n, dtype=self.dtype, device=self.device)
        diag.index_add_(0, rids[on_diag].to(torch.int64), self.values[on_diag])
        return Diagonal(values=diag)

    def compute_absolute(self) -> "Csr":
        return self.replace(values=torch.abs(self.values))

    def add_scaled_identity(self, alpha, beta) -> "Csr":
        """self := alpha I + beta self; every diagonal entry must be in the
        sparsity pattern (the reference kernel's precondition)."""
        is_diag = self.row_ids() == self.col_idxs
        a = torch.as_tensor(alpha, dtype=self.dtype, device=self.device).reshape(())
        shift = torch.where(is_diag, a, torch.zeros_like(a))
        return self.replace(values=_scalar(beta) * self.values + shift)

    # permutations: result row i is source row perm[i] (reference Permutable
    # semantics, lin_op.hpp:507); host set-up paths
    def row_permute(self, perm) -> "Csr":
        return _permute_csr(self, row_perm=np.asarray(perm), col_perm=None)

    def column_permute(self, perm) -> "Csr":
        return _permute_csr(self, row_perm=None, col_perm=np.asarray(perm))

    def symm_permute(self, perm) -> "Csr":
        p = np.asarray(perm)
        return _permute_csr(self, row_perm=p, col_perm=p)

    def inverse_row_permute(self, perm) -> "Csr":
        return self.row_permute(_inverse(np.asarray(perm)))

    def inverse_column_permute(self, perm) -> "Csr":
        return self.column_permute(_inverse(np.asarray(perm)))

    # -- entry lookup (csr_lookup.hpp analog) -----------------------------------

    def lookup(self, rows, cols):
        """Value-array index of entry (row, col), or -1 if absent: a lower
        bound search for the entry's (row, col) key over the row-sorted,
        column-sorted storage."""
        rows_t = torch.as_tensor(np.asarray(rows), device=self.device)
        out_shape = rows_t.shape
        if self.nnz == 0:
            return torch.full(out_shape, -1, dtype=torch.int32, device=self.device)
        m = self.shape[1]
        r = rows_t.reshape(-1).to(torch.int64)
        c = torch.as_tensor(np.asarray(cols), device=self.device).reshape(-1).to(torch.int64)
        keys = self.row_ids().to(torch.int64) * m + self.col_idxs.to(torch.int64)
        pos = torch.searchsorted(keys, r * m + c)
        end = self.row_ptrs.to(torch.int64)[r + 1]
        safe = pos.clamp(max=self.nnz - 1)
        hit = (pos < end) & (keys[safe] == r * m + c)
        out = torch.where(hit, pos, torch.full_like(pos, -1))
        return out.to(torch.int32).reshape(out_shape)

    # -- conversions ----------------------------------------------------------

    def to_matrix_data(self) -> MatrixData:
        return MatrixData(
            self.shape,
            types.to_host(self.row_ids()),
            types.to_host(self.col_idxs),
            types.to_host(self.values),
        )

    write = to_matrix_data

    def to_dense(self):
        from .dense import Dense

        vals = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        vals.index_put_((self.row_ids().to(torch.int64), self.col_idxs.to(torch.int64)),
                        self.values, accumulate=True)
        return Dense(values=vals)

    def to_csr(self):
        return self

    # The host triples of bfloat16 values are float32 (types.to_host); the
    # conversions keep the values' dtype, as the JAX package's do.
    def to_dia(self):
        from .dia import Dia

        return Dia.from_matrix_data(self.to_matrix_data(), device=self.device).astype(self.dtype)

    def to_bell(self, block_rows: int = 8):
        from .bell import Bell

        return Bell.from_csr(self, block_rows)

    def to_scipy(self):
        """scipy CSR on the host; bfloat16 widens to float32 (scipy has no
        bfloat16)."""
        import scipy.sparse as sps

        return sps.csr_matrix(
            (types.to_host(self.values), types.to_host(self.col_idxs),
             types.to_host(self.row_ptrs)),
            shape=self.shape,
        )

    def astype(self, dtype) -> "Csr":
        return self.replace(values=self.values.to(dtype))

    def host_row_lengths(self) -> np.ndarray:
        rp = types.to_host(self.row_ptrs)
        return rp[1:] - rp[:-1]


def _inverse(p):
    inv = np.empty_like(p)
    inv[p] = np.arange(len(p))
    return inv


def _permute_csr(m: Csr, row_perm, col_perm) -> Csr:
    """Host-side structural permutation (the structure changes: set-up)."""
    sp = m.to_scipy().tocoo()
    rows, cols = sp.row, sp.col
    if row_perm is not None:
        rows = _inverse(row_perm)[rows]
    if col_perm is not None:
        cols = _inverse(col_perm)[cols]
    data = MatrixData.from_coo(m.shape, rows, cols, sp.data)
    return Csr.from_matrix_data(data, device=m.device, strategy=m.strategy)
