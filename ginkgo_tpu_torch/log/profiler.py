"""Profiler integration: named ranges in ``torch.profiler`` traces and NVTX.

Counterpart of ``ginkgo_tpu/log/profiler.py`` (the vendor-range role of the
reference's logger system; its PAPI logger exports counters,
papi.hpp:92-275).  Here the ranges go to ``torch.profiler`` (a
``record_function``) and, on a CUDA device, to NVTX as well.

Usage::

    with profile_region("solve", device=b.device):
        x, info = solver.solve(b)

    prof = ProfilerRange()                   # one range per started/completed
    solver.solve_chunked(b, loggers=[prof])  # event pair

    with trace("/path/to/dir") as p:         # a full torch.profiler trace,
        x, info = solver.solve(b)            # written to dir/trace.json
"""

from __future__ import annotations

import contextlib
import os

import torch

from .logger import Event, Logger

_STARTED = {
    Event.linop_apply_started: Event.linop_apply_completed,
    Event.linop_advanced_apply_started: Event.linop_advanced_apply_completed,
    Event.linop_factory_generate_started: Event.linop_factory_generate_completed,
    Event.criterion_check_started: Event.criterion_check_completed,
    Event.operation_launched: Event.operation_completed,
    Event.copy_started: Event.copy_completed,
    Event.allocation_started: Event.allocation_completed,
}
_COMPLETED = {v: k for k, v in _STARTED.items()}


def _nvtx_on(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


@contextlib.contextmanager
def profile_region(name: str, device=None):
    """A named range in ``torch.profiler`` traces, and an NVTX range when
    ``device`` is a CUDA device."""
    nvtx = _nvtx_on(device)
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA when a device
    is present), written to ``log_dir/trace.json``; yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class ProfilerRange(Logger):
    """Opens a named range at every ``*_started`` event and closes it at the
    matching ``*_completed``; marks each ``iteration_complete`` with an empty
    range ``iteration_<n>``.  The ranges are ``torch.profiler``
    ``record_function``s, and NVTX ranges too when ``device`` is a CUDA
    device."""

    def __init__(self, events=None, device=None):
        super().__init__(
            events or (frozenset(_STARTED) | frozenset(_COMPLETED) | {Event.iteration_complete}))
        self.nvtx = _nvtx_on(device)
        self._open = []

    def _enter(self, name):
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        if self.nvtx:
            torch.cuda.nvtx.range_push(name)
        return rf

    def _exit(self, rf):
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        rf.__exit__(None, None, None)

    def on(self, event, **data):
        if event in _STARTED:
            name = data.get("name") or event.value.rsplit("_", 1)[0]
            self._open.append((event, self._enter(str(name))))
        elif event in _COMPLETED:
            want = _COMPLETED[event]
            for i in range(len(self._open) - 1, -1, -1):
                if self._open[i][0] == want:
                    self._exit(self._open.pop(i)[1])
                    break
        elif event == Event.iteration_complete:
            self._exit(self._enter(f"iteration_{data.get('iteration', '?')}"))

    def close(self):
        while self._open:
            self._exit(self._open.pop()[1])
