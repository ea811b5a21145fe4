"""Pell — panel-gathered ELL, the general unstructured format.

Counterpart of ``ginkgo_tpu/matrix/pell.py``: the PELL plan of
``ops/pell.py`` held as a format, on the device.  ``apply`` runs K5
(``pell_spmv``) for one right-hand side and K6 (``pell_spmm``) for k; a
solver on a Pell runs the whole CG/FCG solve in K7 when the gate of
``solver/_fused_gate.py`` accepts it.  Construction (``from_csr``) is a
host set-up pass, as every format conversion.

Defaults follow the JAX package: int8 lane indices, and S = 8, the tile
layout both packages' whole-solve kernels route to (pass ``S="auto"``
for an operator that is only ever applied).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..base import types
from ..base.linop import LinOp, as_2d, restore_1d
from ..base.matrix_data import MatrixData
from ..ops import spmv as spmv_ops
from ..ops.dia import VECTOR_DTYPES
from ..ops.pell import LANES, PellPlan, pell_spmm, pell_spmv


@dataclasses.dataclass(eq=False)
class Pell(LinOp):
    values: torch.Tensor  # (slots, S, 128) zero-padded slot cells
    qidx: torch.Tensor  # (slots, S, 128) int8/int32 lane within the panel
    bases: torch.Tensor  # (slots,) int32 padded-panel base per slot
    tile_ptr: torch.Tensor  # (NT + 1,) int32 slot range of each output tile
    shape: tuple = (0, 0)
    n_steps: int = 0
    nnz: int = 0
    G: int = 4
    NT: int = 0
    NP: int = 0
    S: int = 8

    # -- construction ---------------------------------------------------------

    @staticmethod
    def from_csr(csr, G="auto", S=8, q_dtype=np.int8) -> "Pell":
        plan = PellPlan(
            types.to_host(csr.row_ptrs), types.to_host(csr.col_idxs),
            types.to_host(csr.values), csr.shape, G=G, S=S, q_dtype=q_dtype,
            value_itemsize=csr.values.element_size(),
        )
        return Pell.from_plan(plan, device=csr.device, dtype=csr.dtype)

    @staticmethod
    def from_plan(plan: PellPlan, *, device, dtype=None) -> "Pell":
        values = torch.from_numpy(plan.values).to(device)
        return Pell(
            values=values if dtype is None else values.to(dtype),
            qidx=torch.from_numpy(plan.qidx).to(device),
            bases=torch.from_numpy(plan.bases).to(device),
            tile_ptr=torch.from_numpy(plan.tile_ptr).to(device),
            shape=tuple(plan.shape),
            n_steps=plan.n_steps,
            nnz=plan.nnz,
            G=plan.G,
            NT=plan.NT,
            NP=plan.NP,
            S=plan.S,
        )

    @staticmethod
    def from_matrix_data(data: MatrixData, *, device, G="auto", S=8,
                         q_dtype=np.int8) -> "Pell":
        from .csr import Csr

        return Pell.from_csr(Csr.from_matrix_data(data, device=device), G=G,
                             S=S, q_dtype=q_dtype)

    read = from_matrix_data

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def inflation(self) -> float:
        return self.values.numel() / max(self.nnz, 1)

    @property
    def num_stored_elements(self) -> int:
        return self.nnz

    def storage_bytes(self) -> int:
        """Bytes of the plan arrays on the device."""
        return sum(t.numel() * t.element_size()
                   for t in (self.values, self.qidx, self.bases, self.tile_ptr))

    # -- apply ----------------------------------------------------------------

    def apply(self, b):
        """A b in b's dtype, as the JAX package's; a vector dtype the
        kernels do not take (bfloat16) is computed in float32."""
        arr, was_1d = as_2d(b)
        dtype = arr.dtype
        if dtype not in VECTOR_DTYPES:
            arr = arr.to(torch.float32)
        if arr.shape[1] > 1:
            out = pell_spmm(self, arr.contiguous())
        else:
            out = pell_spmv(self, arr[:, 0].contiguous())[:, None]
        return restore_1d(out.to(dtype) if dtype.is_floating_point else out, was_1d)

    def apply_advanced(self, alpha, b, beta, x):
        arr, was_1d = as_2d(b)
        xa, _ = as_2d(x)
        out = spmv_ops.advanced(self.apply(arr), alpha, beta, xa)
        return restore_1d(out, was_1d)

    # -- structure ops --------------------------------------------------------

    def extract_diagonal(self):
        return self.to_csr().extract_diagonal()

    def scale(self, alpha) -> "Pell":
        if isinstance(alpha, torch.Tensor):
            alpha = alpha.reshape(())
        return self.replace(values=self.values * alpha)

    def compute_absolute(self) -> "Pell":
        return self.replace(values=torch.abs(self.values))

    def astype(self, dtype) -> "Pell":
        return self.replace(values=self.values.to(dtype))

    def reduce_storage(self, dtype=torch.bfloat16) -> "Pell":
        """bfloat16 slot values and int8 lane indices: both streams of the
        SpMV shrink, while the sums stay in float32."""
        return self.replace(values=self.values.to(dtype),
                            qidx=self.qidx.to(torch.int8))

    def _q_dtype(self):
        return np.int8 if self.qidx.dtype == torch.int8 else np.int32

    def transpose(self) -> "Pell":
        return Pell.from_csr(self.to_csr().transpose(), G=self.G, S=self.S,
                             q_dtype=self._q_dtype())

    def conj_transpose(self) -> "Pell":
        return Pell.from_csr(self.to_csr().conj_transpose(), G=self.G,
                             S=self.S, q_dtype=self._q_dtype())

    # -- conversions ----------------------------------------------------------

    def to_matrix_data(self) -> MatrixData:
        """COO entries from the occupied plan cells.  Stored zeros of the
        source pattern are dropped: their cells look like padding, and the
        SpMV treats them the same."""
        vals = types.to_host(self.values)
        q = types.to_host(self.qidx)
        bases = types.to_host(self.bases)
        tile_ptr = types.to_host(self.tile_ptr).astype(np.int64)
        slot_tile = np.repeat(np.arange(len(tile_ptr) - 1), np.diff(tile_ptr))
        sl, s, lane = np.nonzero(vals != 0)
        rows = slot_tile[sl] * (self.S * LANES) + s * LANES + lane
        cols = ((bases[sl].astype(np.int64) - (self.S - 1) + s) * LANES
                + q[sl, s, lane].astype(np.int64))
        order = np.lexsort((cols, rows))
        return MatrixData(self.shape, rows[order], cols[order],
                          vals[sl, s, lane][order])

    write = to_matrix_data

    def to_csr(self):
        from .csr import Csr

        return Csr.from_matrix_data(self.to_matrix_data(),
                                    device=self.device).astype(self.dtype)

    def to_dense(self):
        return self.to_csr().to_dense()
