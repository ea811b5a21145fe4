"""Executor: device placement and event hooks.

Counterpart of ``ginkgo_tpu/base/executor.py`` (reference
include/ginkgo/core/base/executor.hpp:602-800).  The reference's Executor
owns memory, dispatches kernels and synchronizes; under PyTorch the
tensor's device does the first two, so an Executor is a device, the
logging hooks of executor.hpp:663-735 (allocation, copy and operation
events) and a synchronization.  ``ReferenceExecutor`` is the host CPU,
``CudaExecutor`` one CUDA device (``TpuExecutor``, the JAX package's name
for its accelerator executor, is the same class).  The JAX package's
``MeshExecutor`` belongs to the distributed layer, not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..log.logger import Event, Loggable


def _to_device(obj, device):
    """Tensors, lists, tuples, dicts and dataclass LinOps with every tensor
    moved to ``device``; other leaves unchanged."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    return obj


class Executor(Loggable):
    def __init__(self):
        super().__init__()

    @property
    def device(self) -> torch.device:
        from .exceptions import NotImplementedError_

        raise NotImplementedError_(type(self).__name__)

    def run(self, name: str, fn, *args, **kwargs):
        """Run a named operation with the logging hooks, new tensors made on
        this executor's device (Executor::run(Operation), executor.hpp:623)."""
        self.log(Event.operation_launched, executor=self, name=name)
        with torch.device(self.device):
            out = fn(*args, **kwargs)
        self.log(Event.operation_completed, executor=self, name=name)
        return out

    def put(self, tree):
        """Place tensors (a tensor, a container of them or a LinOp) on this
        executor's device (the allocation and copy analog)."""
        self.log(Event.allocation_started, executor=self)
        out = _to_device(tree, self.device)
        self.log(Event.allocation_completed, executor=self)
        return out

    def copy_from(self, other_exec, tree):
        self.log(Event.copy_started, executor=self, source=other_exec)
        out = _to_device(tree, self.device)
        self.log(Event.copy_completed, executor=self, source=other_exec)
        return out

    def synchronize(self, tree=None):
        """Wait for this executor's device to finish its queued work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def get_master(self) -> "Executor":
        return ReferenceExecutor.create()

    def memory_accessible(self, other) -> bool:
        return self.device == other.device


class ReferenceExecutor(Executor):
    """Host CPU executor, the numerical ground-truth tier (executor.hpp:1320)."""

    @staticmethod
    def create():
        return ReferenceExecutor()

    @property
    def device(self):
        return torch.device("cpu")

    def get_master(self):
        return self


#: OmpExecutor (executor.hpp:1249), a multithreaded CPU backend: PyTorch's
#: CPU ops are multithreaded already, so it is the same device
OmpExecutor = ReferenceExecutor


class CudaExecutor(Executor):
    """One CUDA device (CudaExecutor, executor.hpp:1384)."""

    def __init__(self, device_id: int = 0):
        super().__init__()
        self._device_id = int(device_id)

    @staticmethod
    def create(device_id: int = 0):
        return CudaExecutor(device_id)

    @property
    def device(self):
        return torch.device("cuda", self._device_id)


#: the JAX package's name for its accelerator executor
TpuExecutor = CudaExecutor


def default_executor() -> Executor:
    if torch.cuda.is_available():
        return CudaExecutor.create()
    return ReferenceExecutor.create()
