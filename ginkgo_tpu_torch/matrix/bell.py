"""Bell — Blocked-ELL, the panel-streaming format for block-structured
matrices.

Counterpart of ``ginkgo_tpu/matrix/bell.py``.  Rows are grouped in blocks
of ``block_rows``, columns in 128-wide panels; each row block stores its
nonzero panels densely, ELL-padded to the largest panel count K: values
(NRB, K, block_rows, 128) and panel ids (NRB, K).  Storage inflates by
panel area over nonzeros; ``storage_inflation`` reports it and
``suitable_for_bell`` gates the automatic choice (``matrix/auto.py``).

``apply`` runs K10 (``bell_spmv``) for one right-hand side and K11
(``bell_spmm``) for k, for float32 vectors on float32 or bfloat16 panels:
the types for which the JAX package takes its Pallas kernels.  Every other
type takes the JAX package's XLA-path arithmetic (a panel gather of x and
one contraction, in the promoted type).  Construction is a host set-up
pass.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..base import types
from ..base.linop import LinOp, _scalar, as_2d, restore_1d
from ..base.matrix_data import MatrixData
from ..ops import spmv as spmv_ops
from ..ops.bell import LANES, PANEL_DTYPES, bell_spmm, bell_spmv


@dataclasses.dataclass(eq=False)
class Bell(LinOp):
    values: torch.Tensor  # (NRB, K, BR, 128) dense panels
    panel_ids: torch.Tensor  # (NRB, K) int32 column panel, 0-padded
    panel_valid: torch.Tensor  # (NRB, K) float32 1.0 for real panels
    #: flat slot (into values.reshape(-1)) of each stored entry, row-major
    #: sorted: keeps the sparsity pattern, explicit zeros included
    ent_flat: torch.Tensor | None = None
    shape: tuple = (0, 0)
    block_rows: int = 8
    nnz_stored: int = 0

    # -- construction -----------------------------------------------------------

    @staticmethod
    def from_matrix_data(data: MatrixData, block_rows: int = 8, *, device) -> "Bell":
        d = data.sum_duplicates()
        n, m = d.shape
        BR = int(block_rows)
        if BR % 8:
            raise ValueError("block_rows must be a multiple of 8")
        NRB = -(-n // BR)
        NPC = -(-m // LANES)
        rb = d.rows // BR
        pc = d.cols // LANES
        keys = rb * NPC + pc
        order = np.argsort(keys, kind="stable")
        rows_s, cols_s, vals_s = d.rows[order], d.cols[order], d.values[order]
        rb_s, pc_s = rb[order], pc[order]
        uniq, starts = np.unique(rb_s * NPC + pc_s, return_index=True)
        counts = np.diff(np.append(starts, len(rows_s)))
        u_rb, u_pc = uniq // NPC, uniq % NPC
        K = int(np.bincount(u_rb, minlength=NRB).max()) if len(uniq) else 1
        K = max(K, 1)

        panel_ids = np.zeros((NRB, K), np.int32)
        panel_valid = np.zeros((NRB, K), np.float32)
        values = np.zeros((NRB, K, BR, LANES), d.values.dtype)
        # a panel's slot in its row block is its rank among the block's
        # panels (uniq is sorted by (rb, pc))
        first_idx = np.searchsorted(u_rb, np.arange(NRB), side="left")
        slot_of_panel = np.arange(len(uniq)) - first_idx[u_rb]
        panel_ids[u_rb, slot_of_panel] = u_pc
        panel_valid[u_rb, slot_of_panel] = 1.0
        panel_of_entry = np.repeat(np.arange(len(uniq)), counts)
        k_of_entry = slot_of_panel[panel_of_entry]
        values[rb_s, k_of_entry, rows_s % BR, cols_s % LANES] = vals_s
        ent_flat = (((rb_s.astype(np.int64) * K + k_of_entry) * BR + rows_s % BR) * LANES
                    + cols_s % LANES)
        if ent_flat.size and ent_flat.max() >= 2**31:
            raise ValueError("Bell slot space exceeds the int32 range; use larger "
                             "block_rows or another format")
        # the pattern, row-major again (entries arrived grouped by panel)
        ent_flat = ent_flat[np.lexsort((cols_s, rows_s))].astype(np.int32)
        return Bell(
            values=torch.from_numpy(values).to(device),
            panel_ids=torch.from_numpy(panel_ids).to(device),
            panel_valid=torch.from_numpy(panel_valid).to(device),
            ent_flat=torch.from_numpy(ent_flat).to(device),
            shape=(n, m),
            block_rows=BR,
            nnz_stored=int(d.nnz),
        )

    read = from_matrix_data

    @staticmethod
    def from_csr(csr, block_rows: int = 8) -> "Bell":
        """The panels of a ``Csr``, in its values' dtype (the host triples
        of bfloat16 values are float32)."""
        return Bell.from_matrix_data(csr.to_matrix_data(), block_rows,
                                     device=csr.device).astype(csr.dtype)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def nnz(self):
        return self.nnz_stored

    @property
    def num_panels(self):
        return int(self.values.shape[0] * self.values.shape[1])

    def storage_inflation(self) -> float:
        """Allocated panel cells over stored entries, the ELL padding to the
        largest panel count included (what occupies memory and streams
        through the kernel)."""
        if self.nnz_stored == 0:
            return 1.0
        return self.values.numel() / self.nnz_stored

    # -- SpMV --------------------------------------------------------------------

    def _use_kernel(self, dtype) -> bool:
        """The types the JAX package sends to its Pallas kernels."""
        return dtype == torch.float32 and self.values.dtype in PANEL_DTYPES

    def apply(self, b):
        arr, was_1d = as_2d(b)
        n, m = self.shape
        k = arr.shape[1]
        if self._use_kernel(arr.dtype):
            if k == 1:
                y = bell_spmv(self, arr[:, 0].contiguous())[:, None]
            else:
                y = bell_spmm(self, arr.contiguous())
            return restore_1d(y, was_1d)
        # the JAX package's XLA path: a panel gather of x and one contraction,
        # in the promoted type (bfloat16 storage computes in float32 or wider)
        NRB, K, BR, _ = self.values.shape
        npc = -(-m // LANES)
        work = torch.promote_types(self.values.dtype, arr.dtype)
        xp = torch.zeros((npc * LANES, k), dtype=arr.dtype, device=arr.device)
        xp[:m] = arr
        xg = xp.view(npc, LANES, k)[self.panel_ids.reshape(-1).to(torch.int64)]
        xg = xg.view(NRB, K, LANES, k) * self.panel_valid[..., None, None].to(work)
        y = torch.einsum("rkbc,rkcj->rbj", self.values.to(work), xg.to(work))
        return restore_1d(y.reshape(NRB * BR, k)[:n].to(work), was_1d)

    def apply_advanced(self, alpha, b, beta, x):
        arr, was_1d = as_2d(b)
        xa, _ = as_2d(x)
        out = spmv_ops.advanced(self.apply(arr), alpha, beta, xa)
        return restore_1d(out, was_1d)

    def reduce_storage(self, dtype=torch.bfloat16) -> "Bell":
        """bfloat16 panels with float32 sums in the kernels: half the panel
        bytes."""
        return self.replace(values=self.values.to(dtype))

    # -- structure ----------------------------------------------------------------

    def scale(self, alpha) -> "Bell":
        return self.replace(values=self.values * _scalar(alpha))

    def compute_absolute(self) -> "Bell":
        return self.replace(values=torch.abs(self.values))

    def astype(self, dtype) -> "Bell":
        return self.replace(values=self.values.to(dtype))

    def extract_diagonal(self):
        """The diagonal from the stored entries alone, without densifying."""
        from .diagonal import Diagonal

        rows, cols, vals = self._decode_entries()
        nmin = min(self.shape)
        diag = np.zeros(nmin, vals.dtype)
        on = (rows == cols) & (rows < nmin)
        diag[rows[on]] = vals[on]
        return Diagonal(values=torch.from_numpy(diag).to(self.device).to(self.dtype))

    def transpose(self) -> "Bell":
        return Bell.from_matrix_data(self.to_matrix_data().transpose(), self.block_rows,
                                     device=self.device)

    def conj_transpose(self) -> "Bell":
        return Bell.from_matrix_data(self.to_matrix_data().conj_transpose(),
                                     self.block_rows, device=self.device)

    # -- conversions ----------------------------------------------------------------

    def _decode_entries(self):
        """(rows, cols, vals) of the stored entries, on the host: the
        inverse of the slot encoding of ``from_matrix_data``."""
        NRB, K, BR, _ = self.values.shape
        flat = types.to_host(self.ent_flat).astype(np.int64)
        vals = types.to_host(self.values).reshape(-1)[flat]
        pids = types.to_host(self.panel_ids)
        cl = flat % LANES
        rest = flat // LANES
        brl = rest % BR
        rest //= BR
        kl = rest % K
        rbl = rest // K
        rows = rbl * BR + brl
        cols = pids[rbl, kl] * LANES + cl
        return rows, cols, vals

    def to_matrix_data(self) -> MatrixData:
        rows, cols, vals = self._decode_entries()
        return MatrixData.from_coo(self.shape, rows, cols, vals).sort_row_major()

    write = to_matrix_data

    def to_csr(self, strategy="auto"):
        from .csr import Csr

        return Csr.from_matrix_data(self.to_matrix_data(), device=self.device,
                                    strategy=strategy).astype(self.dtype)

    def to_dense(self):
        from .dense import Dense

        return Dense(values=torch.from_numpy(self.to_matrix_data().to_dense())
                     .to(self.device).to(self.dtype))


def bell_inflation_estimate(data: MatrixData, block_rows: int = 8) -> float:
    """Allocated-cell inflation of ``Bell.from_matrix_data``: the ELL padding
    to the largest panel count is allocated and streamed, so one row block
    touching many panels inflates every block."""
    if data.nnz == 0:
        return 1.0
    NRB = max(1, -(-data.shape[0] // block_rows))
    NPC = max(1, -(-data.shape[1] // LANES))
    rb = data.rows // block_rows
    pc = data.cols // LANES
    keys = np.unique(rb * NPC + pc)
    per_block = np.bincount(keys // NPC, minlength=NRB)
    K = max(int(per_block.max()) if len(per_block) else 1, 1)
    return NRB * K * block_rows * LANES / data.nnz


def suitable_for_bell(data: MatrixData, block_rows: int = 8,
                      max_inflation: float = 40.0) -> bool:
    """BELL pays off when panels are reasonably full: allocated inflation at
    most ``max_inflation``."""
    return bell_inflation_estimate(data, block_rows) <= max_inflation
