"""Well — windowed gather-ELL, the locality-free unstructured format.

Counterpart of ``ginkgo_tpu/matrix/well.py``: the WELL plan of
``ops/well.py`` (its docstring has the layout) held as a format, on the
device.  It takes the role of the reference's load-balance CSR kernels for
patterns with no column locality (power-law graphs, circuit matrices);
``Pell`` wins where locality exists.  ``apply`` runs K8 (``well_spmv``) for
one right-hand side and K9 (``well_spmm``) for k.  Construction is a host
set-up pass, as every format conversion.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..base import types
from ..base.linop import LinOp, _scalar, as_2d, restore_1d
from ..base.matrix_data import MatrixData
from ..ops import spmv as spmv_ops
from ..ops.dia import VECTOR_DTYPES
from ..ops.well import LANES, TILE_ROWS, WellPlan, well_spmm, well_spmv


@dataclasses.dataclass(eq=False)
class Well(LinOp):
    values: torch.Tensor  # (slots, 8, 128) zero-padded window cells
    qidx: torch.Tensor  # (slots, 8, 128) int8 column residue per cell
    rt: torch.Tensor  # (slots, 8, 128) int8 window row, routed by residue
    bases: torch.Tensor  # (slots,) int32 window base panel
    tile_ptr: torch.Tensor  # (NST + 1,) int32 slot range of each supertile
    tsb: torch.Tensor | None = None  # (slots, 8, 128) int8 sub-tile (T > 1)
    shape: tuple = (0, 0)
    n_steps: int = 0
    nnz: int = 0
    G: int = 4
    T: int = 1
    NT: int = 0
    NST: int = 0
    NP: int = 0
    NW: int = 0

    # -- construction ---------------------------------------------------------

    @staticmethod
    def from_csr(csr, G="auto", T="auto") -> "Well":
        plan = WellPlan(
            types.to_host(csr.row_ptrs), types.to_host(csr.col_idxs),
            types.to_host(csr.values), csr.shape, G=G, T=T,
            value_itemsize=csr.values.element_size(),
        )
        return Well.from_plan(plan, device=csr.device, dtype=csr.dtype)

    @staticmethod
    def from_plan(plan: WellPlan, *, device, dtype=None) -> "Well":
        values = torch.from_numpy(plan.values).to(device)
        return Well(
            values=values if dtype is None else values.to(dtype),
            qidx=torch.from_numpy(plan.qidx).to(device),
            rt=torch.from_numpy(plan.rt).to(device),
            bases=torch.from_numpy(plan.bases).to(device),
            tile_ptr=torch.from_numpy(plan.tile_ptr).to(device),
            tsb=None if plan.tsb is None else torch.from_numpy(plan.tsb).to(device),
            shape=tuple(plan.shape),
            n_steps=plan.n_steps,
            nnz=plan.nnz,
            G=plan.G,
            T=plan.T,
            NT=plan.NT,
            NST=plan.NST,
            NP=plan.NP,
            NW=plan.NW,
        )

    @staticmethod
    def from_matrix_data(data: MatrixData, *, device, G="auto", T="auto") -> "Well":
        from .csr import Csr

        return Well.from_csr(Csr.from_matrix_data(data, device=device), G=G, T=T)

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
        arrays = (self.values, self.qidx, self.rt, self.tsb, self.bases, self.tile_ptr)
        return sum(t.numel() * t.element_size() for t in arrays if t is not None)

    # -- apply ----------------------------------------------------------------

    def apply(self, b):
        """A b in b's dtype, as the JAX package's; a vector dtype the
        kernels do not take (bfloat16) is computed in float32."""
        arr, was_1d = as_2d(b)
        dtype = arr.dtype
        if dtype not in VECTOR_DTYPES:
            arr = arr.to(torch.float32)
        if arr.shape[1] > 1:
            out = well_spmm(self, arr.contiguous())
        else:
            out = well_spmv(self, arr[:, 0].contiguous())[:, None]
        return restore_1d(out.to(dtype) if dtype.is_floating_point else out, was_1d)

    def apply_advanced(self, alpha, b, beta, x):
        arr, was_1d = as_2d(b)
        xa, _ = as_2d(x)
        out = spmv_ops.advanced(self.apply(arr), alpha, beta, xa)
        return restore_1d(out, was_1d)

    # -- structure ops --------------------------------------------------------

    def extract_diagonal(self):
        return self.to_csr().extract_diagonal()

    def scale(self, alpha) -> "Well":
        return self.replace(values=self.values * _scalar(alpha))

    def compute_absolute(self) -> "Well":
        return self.replace(values=torch.abs(self.values))

    def astype(self, dtype) -> "Well":
        return self.replace(values=self.values.to(dtype))

    def reduce_storage(self, dtype=torch.bfloat16) -> "Well":
        """bfloat16 cell values (q, rt and tsb are int8 already): the largest
        stream of the SpMV shrinks, while the sums stay in float32."""
        return self.replace(values=self.values.to(dtype))

    def transpose(self) -> "Well":
        return Well.from_csr(self.to_csr().transpose(), G=self.G)

    def conj_transpose(self) -> "Well":
        return Well.from_csr(self.to_csr().conj_transpose(), G=self.G)

    # -- conversions ----------------------------------------------------------

    def to_matrix_data(self) -> MatrixData:
        """COO entries from the occupied cells, decoded through the same
        chained gather the kernel evaluates (the routing tile read at lane
        q).  Stored zeros of the source pattern are dropped: their cells
        look like padding, and the SpMV treats them the same."""
        vals = types.to_host(self.values)
        q = types.to_host(self.qidx).astype(np.int64)
        rt = types.to_host(self.rt).astype(np.int64)
        bases = types.to_host(self.bases).astype(np.int64)
        tile_ptr = types.to_host(self.tile_ptr).astype(np.int64)
        slot_blk = np.repeat(np.arange(len(tile_ptr) - 1), np.diff(tile_ptr))
        sl, s, lane = np.nonzero(vals)
        sub = (types.to_host(self.tsb).astype(np.int64)[sl, s, lane]
               if self.T > 1 else 0)
        rows = (slot_blk[sl] * self.T + sub) * TILE_ROWS + s * LANES + lane
        qv = q[sl, s, lane]
        cols = (bases[sl] + rt[sl, s, qv]) * LANES + qv
        order = np.lexsort((cols, rows))
        return MatrixData(self.shape, rows[order], cols[order], vals[sl, s, lane][order])

    write = to_matrix_data

    def to_csr(self):
        from .csr import Csr

        return Csr.from_matrix_data(self.to_matrix_data(),
                                    device=self.device).astype(self.dtype)

    def to_dense(self):
        return self.to_csr().to_dense()
