"""DIA (diagonal) sparse format for banded and stencil matrices.

Counterpart of ``ginkgo_tpu/matrix/dia.py``.  The diagonals are stored as
``diags`` of shape ``(nd, n_rows)`` with ``diags[d, i] = A[i, i + off_d]``
(zero where ``i + off_d`` falls outside the columns), and

  y = sum_d diags[d] * shift(x, off_d)

runs through the kernels of ``ops/dia.py``: K1 for one right-hand side, K3
for k, and K2 for the fused ``alpha * A x + beta * y``.  The TPU's
``(R, 128)`` lane frame and its lane-shift permutation matrices are not
carried over: a GPU reads ``x[i + off]`` directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..base import types
from ..base.linop import LinOp, as_2d, restore_1d
from ..base.matrix_data import MatrixData
from ..ops.dia import dia_spmm, dia_spmv, dia_spmv_advanced


@dataclasses.dataclass(eq=False)
class Dia(LinOp):
    diags: torch.Tensor  # (nd, n_rows) diagonal values, row-aligned
    offsets: tuple = ()  # ints, sorted ascending
    shape: tuple = (0, 0)

    # -- construction ---------------------------------------------------------

    @staticmethod
    def from_matrix_data(data: MatrixData, *, device) -> "Dia":
        d = data.sum_duplicates()
        n, _ = d.shape
        offs = np.unique(d.cols - d.rows)
        diags = np.zeros((len(offs), n), dtype=d.values.dtype)
        off_idx = np.searchsorted(offs, d.cols - d.rows)
        diags[off_idx, d.rows] = d.values
        return Dia(
            diags=torch.as_tensor(diags, device=device),
            offsets=tuple(int(o) for o in offs),
            shape=tuple(d.shape),
        )

    read = from_matrix_data

    @staticmethod
    def from_csr(csr) -> "Dia":
        """The ``Dia`` of a ``Csr``, on its device, with its values' dtype
        (the host triples of bfloat16 values are float32)."""
        return Dia.from_matrix_data(csr.to_matrix_data(), device=csr.device).astype(csr.dtype)

    @property
    def dtype(self):
        return self.diags.dtype

    @property
    def device(self):
        return self.diags.device

    @property
    def num_diags(self):
        return len(self.offsets)

    @property
    def nnz(self):  # stored elements (dense diagonals)
        return self.diags.numel()

    def reduce_storage(self, dtype=torch.bfloat16) -> "Dia":
        """Accessor-style storage reduction: diagonal values stored in
        ``dtype``, arithmetic in float32 — halves the matrix traffic of a
        bandwidth-bound SpMV."""
        return self.replace(diags=self.diags.to(dtype))

    # -- apply ----------------------------------------------------------------

    def _operand(self, arr):
        """x cast to the arithmetic dtype: the promotion of the diagonals'
        arithmetic dtype (bf16 storage computes in f32) with x's dtype."""
        work = torch.promote_types(types.arithmetic_dtype(self.dtype), arr.dtype)
        return arr.to(work).contiguous()

    def apply(self, b):
        """A b in ``promote_types(self.dtype, b.dtype)``, computed in the
        arithmetic dtype (bfloat16 storage computes in float32), as the
        JAX package's ``result_type``."""
        arr, was_1d = as_2d(b)
        n, m = self.shape
        xa = self._operand(arr)
        if xa.shape[1] == 1:
            y = dia_spmv(self.diags, self.offsets, xa[:, 0], m)[:, None]
        else:
            y = dia_spmm(self.diags, self.offsets, xa, m)
        return restore_1d(y.to(torch.promote_types(self.dtype, arr.dtype)), was_1d)

    def apply_advanced(self, alpha, b, beta, x):
        """x := alpha * A b + beta * x; one fused K2 pass for a single
        right-hand side."""
        arr, was_1d = as_2d(b)
        xa, _ = as_2d(x)
        barr = self._operand(arr)
        work = barr.dtype
        a = _device_scalar(alpha, work, barr.device)
        c = _device_scalar(beta, work, barr.device)
        if barr.shape[1] == 1 and xa.dtype == work:
            out = dia_spmv_advanced(
                self.diags, self.offsets, barr[:, 0], a, c,
                xa[:, 0].contiguous(), self.shape[1],
            )[:, None]
            return restore_1d(out, was_1d)
        out = a.reshape(()) * as_2d(self.apply(barr))[0] + c.reshape(()) * xa
        return restore_1d(out, was_1d)

    # -- structure ops ----------------------------------------------------------

    def extract_diagonal(self):
        from .diagonal import Diagonal

        n = min(self.shape)
        if 0 in self.offsets:
            j = self.offsets.index(0)
            return Diagonal(values=self.diags[j, :n].contiguous())
        return Diagonal(
            values=torch.zeros(n, dtype=self.dtype, device=self.device)
        )

    def scale(self, alpha):
        if isinstance(alpha, torch.Tensor):
            alpha = alpha.reshape(())
        return self.replace(diags=self.diags * alpha)

    def compute_absolute(self):
        return self.replace(diags=torch.abs(self.diags))

    # The host triples of bfloat16 diagonals are float32; the transpose
    # keeps the diagonals' dtype, as the JAX package's does.
    def transpose(self) -> "Dia":
        return Dia.from_matrix_data(
            self.to_matrix_data().transpose(), device=self.device
        ).astype(self.dtype)

    def conj_transpose(self) -> "Dia":
        return Dia.from_matrix_data(
            self.to_matrix_data().conj_transpose(), device=self.device
        ).astype(self.dtype)

    # -- conversions --------------------------------------------------------------

    def to_matrix_data(self) -> MatrixData:
        """Host COO triples (bf16 storage exports as float32)."""
        n, m = self.shape
        host = types.to_host(self.diags).reshape(self.num_diags, -1)[:, :n]
        # (n, nd) views: the offsets ascend, so reading them row by row
        # gives row-major triples with no sort
        cols = np.arange(n)[:, None] + np.asarray(self.offsets, np.int64)[None, :]
        vals = host.T
        keep = (cols >= 0) & (cols < m) & (vals != 0)
        rows = np.broadcast_to(np.arange(n)[:, None], keep.shape)
        return MatrixData.from_coo(self.shape, rows[keep], cols[keep], vals[keep])

    write = to_matrix_data

    def to_scipy(self):
        """scipy ``dia_matrix`` on the host, one shifted slice copy per
        diagonal (scipy's DIA data is column-indexed, ours row-indexed);
        bfloat16 widens to float32, as the JAX package's does (scipy has no
        bfloat16)."""
        import scipy.sparse as sps

        n, m = self.shape
        host = types.to_host(self.diags).reshape(self.num_diags, -1)
        data = np.zeros((self.num_diags, m), host.dtype)
        for k, off in enumerate(self.offsets):
            c0, c1 = max(0, off), min(m, n + off)
            if c1 > c0:
                data[k, c0:c1] = host[k, c0 - off:c1 - off]
        return sps.dia_matrix((data, np.asarray(self.offsets, np.int64)), shape=(n, m))

    def to_csr(self, strategy="auto"):
        """The ``Csr`` of the stored nonzeros, on the diagonals' device and
        with their dtype (bfloat16 stays bfloat16, as in the JAX package)."""
        from .csr import Csr

        return Csr.from_matrix_data(self.to_matrix_data(), device=self.device,
                                    strategy=strategy).astype(self.dtype)

    def to_dense(self):
        from .dense import Dense

        return Dense(
            values=torch.as_tensor(self.to_matrix_data().to_dense(), device=self.device)
        )

    def astype(self, dtype):
        return self.replace(diags=self.diags.to(dtype))


def _device_scalar(s, dtype, device):
    """A python or tensor scalar as a 1-element tensor on ``device``; a
    python number is filled in place on the device (no blocking copy)."""
    if isinstance(s, torch.Tensor):
        return s.to(dtype=dtype, device=device).reshape(1)
    return torch.full((1,), s, dtype=dtype, device=device)


def suitable_for_dia(data: MatrixData, max_diags: int = 64) -> bool:
    """Heuristic: DIA pays off when distinct offsets are few and diagonals
    are reasonably full (storage = nd * n values)."""
    if data.nnz == 0:
        return False
    offs = np.unique(data.cols - data.rows)
    if len(offs) > max_diags:
        return False
    fill = data.nnz / (len(offs) * data.shape[0])
    return fill > 0.2
