"""Event-hook logging protocol.

Counterpart of ``ginkgo_tpu/log/logger.py`` (reference log::Logger with its
24 registered events, include/ginkgo/core/log/logger.hpp:148-481, and the
EnableLogging mixin).  A ``Loggable`` object takes any number of loggers;
events carry keyword payloads.  The loggers follow the reference set:
``Convergence`` (convergence.hpp:55-121), ``Stream``, ``Record`` and
``PerformanceHint`` (performance_hint.hpp:58-75); PAPI is replaced by the
plain ``Counters`` logger and the ``torch.profiler`` integration of
``profiler.py``.

The process-wide registry stands in for the reference's executor loggers:
a logger added with :func:`add_global_logger` sees the events of every
factory, solver and kernel wrapper.  :func:`logged_kernel` wraps each
kernel's dispatching wrapper (``ops/``) and fires
``operation_launched``/``operation_completed`` once per call, on the card
and on the plain version alike; with no global logger a call costs one
empty-list test.
"""

from __future__ import annotations

import enum
import functools
import sys
import time
from collections import defaultdict


class Event(enum.Enum):
    # executor events (executor.hpp:663-735)
    allocation_started = "allocation_started"
    allocation_completed = "allocation_completed"
    free_started = "free_started"
    free_completed = "free_completed"
    copy_started = "copy_started"
    copy_completed = "copy_completed"
    operation_launched = "operation_launched"
    operation_completed = "operation_completed"
    # polymorphic-object lifecycle (logger.hpp:248-330)
    polymorphic_object_create_started = "polymorphic_object_create_started"
    polymorphic_object_create_completed = "polymorphic_object_create_completed"
    polymorphic_object_copy_started = "polymorphic_object_copy_started"
    polymorphic_object_copy_completed = "polymorphic_object_copy_completed"
    polymorphic_object_move_started = "polymorphic_object_move_started"
    polymorphic_object_move_completed = "polymorphic_object_move_completed"
    polymorphic_object_deleted = "polymorphic_object_deleted"
    # linop events (logger.hpp:336-430)
    linop_apply_started = "linop_apply_started"
    linop_apply_completed = "linop_apply_completed"
    linop_advanced_apply_started = "linop_advanced_apply_started"
    linop_advanced_apply_completed = "linop_advanced_apply_completed"
    linop_factory_generate_started = "linop_factory_generate_started"
    linop_factory_generate_completed = "linop_factory_generate_completed"
    # criterion events (logger.hpp:436-460)
    criterion_check_started = "criterion_check_started"
    criterion_check_completed = "criterion_check_completed"
    # solver iteration (logger.hpp:472)
    iteration_complete = "iteration_complete"


ALL_EVENTS = frozenset(Event)


class Logger:
    """Subscribes to a set of events; override ``on(event, **data)``."""

    def __init__(self, events=ALL_EVENTS):
        self.enabled_events = frozenset(events)

    def on(self, event: Event, **data):
        pass


# -- the global registry -------------------------------------------------------------

_GLOBAL_LOGGERS: list[Logger] = []


def add_global_logger(logger: Logger) -> Logger:
    _GLOBAL_LOGGERS.append(logger)
    return logger


def remove_global_logger(logger: Logger):
    _GLOBAL_LOGGERS.remove(logger)


def clear_global_loggers():
    _GLOBAL_LOGGERS.clear()


def global_loggers() -> tuple:
    return tuple(_GLOBAL_LOGGERS)


def global_log(event: Event, **data):
    for lg in _GLOBAL_LOGGERS:
        if event in lg.enabled_events:
            lg.on(event, **data)


def logged_kernel(fn=None, *, name: str | None = None):
    """Fire ``operation_launched``/``operation_completed`` (with
    ``kernel=True``) around a kernel's dispatching wrapper through the
    global registry, named by the kernel's name.  The events bracket the
    call whether it launches the CUDA kernel or, for a CPU tensor, runs the
    plain version; eager PyTorch fires them once per call.  With no global
    logger the call costs one empty-list test."""

    def deco(f):
        kname = name or f.__name__

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            if not _GLOBAL_LOGGERS:
                return f(*args, **kwargs)
            global_log(Event.operation_launched, name=kname, kernel=True)
            try:
                return f(*args, **kwargs)
            finally:
                global_log(Event.operation_completed, name=kname, kernel=True)

        return wrapper

    return deco(fn) if fn is not None else deco


def fanout(loggers, event: Event, **data):
    """Deliver an event to explicit loggers and to the global registry."""
    for lg in loggers:
        if event in lg.enabled_events:
            lg.on(event, **data)
    global_log(event, **data)


class Loggable:
    """EnableLogging analog: a list of loggers and ``log()`` to reach them."""

    def __init__(self):
        self._loggers: list[Logger] = []

    @property
    def loggers(self):
        if not hasattr(self, "_loggers"):
            self._loggers = []
        return self._loggers

    def add_logger(self, logger: Logger):
        self.loggers.append(logger)
        return logger

    def remove_logger(self, logger: Logger):
        self.loggers.remove(logger)

    def clear_loggers(self):
        self.loggers.clear()

    def log(self, event: Event, **data):
        for lg in self.loggers:
            if event in lg.enabled_events:
                lg.on(event, **data)


class Stream(Logger):
    """Text stream logger (reference log/stream.hpp)."""

    def __init__(self, events=ALL_EVENTS, out=sys.stderr, prefix="[LOG] "):
        super().__init__(events)
        self.out = out
        self.prefix = prefix

    def on(self, event, **data):
        payload = ", ".join(f"{k}={_brief(v)}" for k, v in data.items() if k != "solver")
        print(f"{self.prefix}{event.value}: {payload}", file=self.out)


class Record(Logger):
    """In-memory history of the events (reference log/record.hpp)."""

    def __init__(self, events=ALL_EVENTS, max_storage=0):
        super().__init__(events)
        self.history: list[tuple[Event, dict]] = []
        self.max_storage = max_storage

    def on(self, event, **data):
        self.history.append((event, data))
        if self.max_storage and len(self.history) > self.max_storage:
            del self.history[0]

    def filtered(self, event):
        return [d for (e, d) in self.history if e == event]


class Convergence(Logger):
    """Iteration count and final residual norm from ``iteration_complete``
    (reference log/convergence.hpp:55-121)."""

    def __init__(self):
        super().__init__({Event.iteration_complete})
        self.num_iterations = 0
        self.residual_norm = None
        self.implicit_sq_residual_norm = None
        self.has_converged = False

    def on(self, event, **data):
        self.num_iterations = int(data.get("iteration", self.num_iterations))
        if data.get("residual_norm") is not None:
            self.residual_norm = data["residual_norm"]
        if data.get("implicit_sq_residual_norm") is not None:
            self.implicit_sq_residual_norm = data["implicit_sq_residual_norm"]
        if data.get("converged") is not None:
            self.has_converged = bool(data["converged"])


class Counters(Logger):
    """Event counts and host seconds per operation name, with the launches of
    each kernel wrapper in ``kernel_counts``; replaces the PAPI-SDE exporter
    (log/papi.hpp:92-275)."""

    def __init__(self, events=ALL_EVENTS):
        super().__init__(events)
        self.counts = defaultdict(int)
        self.op_seconds = defaultdict(float)
        self.kernel_counts = defaultdict(int)
        self._op_start = {}

    def on(self, event, **data):
        self.counts[event.value] += 1
        name = data.get("name")
        if event == Event.operation_launched and name:
            self._op_start[name] = time.perf_counter()
            if data.get("kernel"):
                self.kernel_counts[name] += 1
        elif event == Event.operation_completed and name in self._op_start:
            self.op_seconds[name] += time.perf_counter() - self._op_start.pop(name)


class PerformanceHint(Logger):
    """Detects copy and allocation churn and prints advice (reference
    log/performance_hint.hpp:58-75)."""

    def __init__(self, out=sys.stderr, copy_threshold=10, alloc_threshold=100):
        super().__init__({Event.copy_started, Event.allocation_started})
        self.out = out
        self.copies = 0
        self.allocs = 0
        self.copy_threshold = copy_threshold
        self.alloc_threshold = alloc_threshold
        self._warned = set()

    def on(self, event, **data):
        if event == Event.copy_started:
            self.copies += 1
            if self.copies == self.copy_threshold and "copy" not in self._warned:
                self._warned.add("copy")
                print("[PERF HINT] many cross-device copies detected; keep data "
                      "resident on one executor's device", file=self.out)
        elif event == Event.allocation_started:
            self.allocs += 1
            if self.allocs == self.alloc_threshold and "alloc" not in self._warned:
                self._warned.add("alloc")
                print("[PERF HINT] frequent allocations; reuse buffers or "
                      "preallocate workspaces", file=self.out)


def _brief(v):
    s = repr(v)
    return s if len(s) < 60 else s[:57] + "..."


class LoggedLinOp(Loggable):
    """Wraps a LinOp so that every apply fires the linop_apply events
    (logger.hpp:336-430).

    Usage: ``op = LoggedLinOp(A, loggers=[Record()]); op.apply(b)``."""

    def __init__(self, op, loggers=(), name=None):
        super().__init__()
        self.op = op
        self.name = name or type(op).__name__
        for lg in loggers:
            self.add_logger(lg)

    def __getattr__(self, item):
        return getattr(self.op, item)

    def _fan(self, event, **data):
        self.log(event, **data)
        global_log(event, **data)

    def apply(self, b):
        self._fan(Event.linop_apply_started, op=self.name)
        out = self.op.apply(b)
        self._fan(Event.linop_apply_completed, op=self.name)
        return out

    def apply_advanced(self, alpha, b, beta, x):
        self._fan(Event.linop_advanced_apply_started, op=self.name)
        out = self.op.apply_advanced(alpha, b, beta, x)
        self._fan(Event.linop_advanced_apply_completed, op=self.name)
        return out
