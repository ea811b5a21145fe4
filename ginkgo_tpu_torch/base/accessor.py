"""Accessors: storage precision apart from arithmetic precision.

Counterpart of ``ginkgo_tpu/base/accessor.py`` (reference accessor/:
``range<Accessor>`` with ``row_major``, ``block_col_major``,
``reduced_row_major`` and ``scaled_reduced_row_major``; the machinery of
CB-GMRES's compressed basis, core/solver/cb_gmres_accessor.hpp:53-97).
Data lives in a storage dtype (bfloat16, float16, int8, int16) and every
read converts to the arithmetic dtype; a write rounds to the storage dtype.
"""

from __future__ import annotations

import dataclasses

import torch

from . import types


def _iinfo(dtype):
    return torch.iinfo(dtype)


@dataclasses.dataclass(eq=False)
class ReducedRowMajor:
    """reduced_row_major: storage in ``storage`` (any shape), reads return
    ``arith_dtype``, writes round to the storage dtype."""

    storage: torch.Tensor
    arith_dtype: torch.dtype = torch.float32

    @staticmethod
    def create(values, storage_dtype=None, arith_dtype=None):
        arith = types.to_torch_dtype(arith_dtype or values.dtype)
        sdt = types.to_torch_dtype(storage_dtype) if storage_dtype is not None else (
            types.reduce_precision(arith))
        return ReducedRowMajor(storage=torch.as_tensor(values).to(sdt), arith_dtype=arith)

    @property
    def shape(self):
        return tuple(self.storage.shape)

    @property
    def storage_dtype(self):
        return self.storage.dtype

    def read(self, idx=Ellipsis):
        return self.storage[idx].to(self.arith_dtype)

    def write(self, idx, values):
        storage = self.storage.clone()
        storage[idx] = torch.as_tensor(values, device=storage.device).to(storage.dtype)
        return dataclasses.replace(self, storage=storage)


@dataclasses.dataclass(eq=False)
class ScaledReducedRowMajor:
    """scaled_reduced_row_major: integer storage with a scale broadcast along
    an axis, value = scale * storage (CB-GMRES's ``integer`` modes)."""

    storage: torch.Tensor  # integer dtype
    scale: torch.Tensor  # broadcastable to storage.shape
    arith_dtype: torch.dtype = torch.float32

    @staticmethod
    def create(values, storage_dtype=torch.int16, arith_dtype=None, axis=-1):
        arith = types.to_torch_dtype(arith_dtype or values.dtype)
        sdt = types.to_torch_dtype(storage_dtype)
        v = torch.as_tensor(values).to(arith)
        info = _iinfo(sdt)
        amax = torch.amax(torch.abs(v), dim=axis, keepdim=True)
        scale = torch.where(amax > 0, amax / info.max, torch.ones_like(amax)).to(arith)
        q = torch.clamp(torch.round(v / scale), info.min, info.max).to(sdt)
        return ScaledReducedRowMajor(storage=q, scale=scale, arith_dtype=arith)

    @property
    def shape(self):
        return tuple(self.storage.shape)

    def read(self, idx=Ellipsis):
        return (self.storage[idx].to(self.arith_dtype)
                * torch.broadcast_to(self.scale, self.storage.shape)[idx])

    def write(self, idx, values):
        """Re-quantize against the existing scale (the reference sets the
        scale per write_scale call, not per element write)."""
        v = torch.as_tensor(values, device=self.storage.device).to(self.arith_dtype)
        s = torch.broadcast_to(self.scale, self.storage.shape)[idx]
        info = _iinfo(self.storage.dtype)
        q = torch.clamp(torch.round(v / s), info.min, info.max).to(self.storage.dtype)
        storage = self.storage.clone()
        storage[idx] = q
        return dataclasses.replace(self, storage=storage)


def row_major(values):
    """range<row_major>: a plain tensor view (row-major is PyTorch's layout)."""
    return torch.as_tensor(values)


def block_col_major(values, block_size: int):
    """block_col_major: (rows, cols) -> (nblocks, cols, block_size), each
    block's columns contiguous (the reference's block-Jacobi storage)."""
    v = torch.as_tensor(values)
    n, m = v.shape
    nb = -(-n // block_size)
    pad = nb * block_size - n
    if pad:
        v = torch.cat([v, v.new_zeros((pad, m))])
    return v.reshape(nb, block_size, m).transpose(1, 2)
