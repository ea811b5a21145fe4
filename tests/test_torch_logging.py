"""Loggers, ``solve_chunked`` and the profiler ranges (slice 10): the port
against the JAX package on the CPU.

- ``solve(b, loggers=[Record(), Convergence()])``: the sequence of solver
  events (kinds, iterations, converged) equals the JAX package's on a
  streaming ``Cg`` (float64; the JAX package with GINKGO_TPU_NO_PALLAS=1),
  with history tracking (one ``iteration_complete`` a history row, then
  the final one) and without, and on a fused-route ``Cg`` (float32 on a
  ``Dia``; the JAX package with GINKGO_TPU_FORCE_VMEM_CG=1 in Pallas
  interpret mode, the port through K4's plain version).  Operation events
  fire once per kernel call in the port and once per trace under JAX's
  ``jit``, so only their presence is compared; the residual norms within
  1e-12 (float64) and 1e-5 (float32).
- ``solve_chunked`` with ``Time``, a relative (``initial_resnorm``)
  baseline frozen to the original residual, and chunks of 7: the JAX
  package's iterations, events and x within 1e-12 (float64); the frozen
  criterion makes ``analyze_simple_residual`` decline, so no whole-solve
  kernel runs inside a chunk even where the one-shot solve takes it.
- ``LoggedLinOp``, ``PerformanceHint``, ``Counters``, ``Stream``.
- ``ProfilerRange`` and ``profile_region`` under ``torch.profiler`` record
  their range names; ``trace`` writes a trace file.
- ``logged_kernel`` fires on a plain-version dispatch and, with no global
  logger, calls the wrapped function and nothing else.
"""

import io
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu import stop as jstop
from ginkgo_tpu.log import logger as jlog
from ginkgo_tpu.matrix.dia import Dia as JDia
from ginkgo_tpu.solver.cg import Cg as JCg
from ginkgo_tpu.stop.criterion import (
    analyze_simple_residual as j_analyze,
    freeze_initial_baseline as j_freeze,
)
from ginkgo_tpu.utils import generators as jgen
from ginkgo_tpu_torch import interop, stop
from ginkgo_tpu_torch import log as plog
from ginkgo_tpu_torch.ops import dia as ops_dia

SOLVER_EVENTS = {"linop_apply_started", "linop_apply_completed", "iteration_complete",
                 "criterion_check_started", "criterion_check_completed"}


@pytest.fixture(autouse=True)
def _one_thread():
    """Solver loops of many small tensor ops: one intra-op thread, so that
    they do not spin against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(nside, dtype):
    data = jgen.poisson_2d(nside, dtype=dtype)
    port = interop.matrix_data_from_arrays(data.shape, data.rows, data.cols, data.values)
    return JDia.from_matrix_data(data), gt.Dia.from_matrix_data(port, device="cpu")


def _events(record):
    """(kind, iteration, converged) of each solver event, in order."""
    out = []
    for ev, data in record.history:
        if ev.value in SOLVER_EVENTS:
            conv = data.get("converged")
            out.append((ev.value, data.get("iteration"), None if conv is None else bool(conv)))
    return out


def _norms(record):
    return [np.asarray(d["residual_norm"], dtype=np.float64).ravel()
            for e, d in record.history if e.value == "iteration_complete"]


def _crit(max_iters, tol, baseline="rhs_norm", time_limit=None):
    j = [jstop.Iteration(max_iters=max_iters), jstop.ResidualNorm(tolerance=tol, baseline=baseline)]
    p = [stop.Iteration(max_iters=max_iters), stop.ResidualNorm(tolerance=tol, baseline=baseline)]
    if time_limit is not None:
        j.append(jstop.Time(time_limit_sec=time_limit))
        p.append(stop.Time(time_limit_sec=time_limit))
    return j, p


@pytest.mark.parametrize("route, history", [("streaming", False), ("streaming", True),
                                            ("fused", False)])
def test_solve_loggers_see_jax_events(monkeypatch, route, history):
    if route == "streaming":
        monkeypatch.setenv("GINKGO_TPU_NO_PALLAS", "1")
        dtype, rtol = np.float64, 1e-12
    else:
        monkeypatch.setenv("GINKGO_TPU_FORCE_VMEM_CG", "1")
        dtype, rtol = np.float32, 1e-5
    JA, A = _problem(12, dtype)
    jc, pc = _crit(300, 1e-7)
    b = np.random.default_rng(4).uniform(0.5, 1.5, A.shape[0]).astype(dtype)
    jrec, jconv = jlog.Record(), jlog.Convergence()
    prec, pconv = plog.Record(), plog.Convergence()
    jx, jinfo = JCg.build(criteria=jc, track_history=history).generate(JA).solve(
        jnp.asarray(b), loggers=[jrec, jconv])
    counter = plog.add_global_logger(plog.Counters())
    try:
        x, info = gt.Cg.build(criteria=pc, track_history=history).generate(A).solve(
            torch.from_numpy(b), loggers=[prec, pconv])
    finally:
        plog.remove_global_logger(counter)
    assert _events(prec) == _events(jrec)
    assert len(_events(prec)) == (int(info.iterations) if history else 0) + 3
    for mine, theirs in zip(_norms(prec), _norms(jrec)):
        np.testing.assert_allclose(mine, theirs, rtol=rtol, atol=rtol)
    assert (pconv.num_iterations, pconv.has_converged) == (jconv.num_iterations,
                                                           jconv.has_converged)
    assert pconv.has_converged and pconv.num_iterations == int(jinfo.iterations)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=rtol, atol=rtol)
    # the kernels' own events: present (once per call here, once per trace
    # under the JAX package's jit)
    kernel = "cg_fused" if route == "fused" else "dia_spmv"
    assert counter.kernel_counts[kernel] >= 1, dict(counter.kernel_counts)
    assert counter.counts["linop_factory_generate_started"] == 1
    assert ("cg_fused" in counter.kernel_counts) == (route == "fused")


@pytest.mark.parametrize("baseline", ["initial_resnorm", "rhs_norm"])
def test_solve_chunked_matches_jax(monkeypatch, baseline):
    """Chunks of 7 with Time and a relative criterion, float64: JAX's
    iterations, events and x within 1e-12."""
    monkeypatch.setenv("GINKGO_TPU_NO_PALLAS", "1")
    JA, A = _problem(14, np.float64)
    jc, pc = _crit(500, 1e-9, baseline, time_limit=3600.0)
    b = np.random.default_rng(6).uniform(0.5, 1.5, A.shape[0])
    x0 = np.random.default_rng(7).standard_normal(A.shape[0]) * 0.1
    jrec, prec = jlog.Record(), plog.Record()
    jx, jinfo = JCg.build(criteria=jc).generate(JA).solve_chunked(
        jnp.asarray(b), jnp.asarray(x0), chunk=7, loggers=[jrec])
    x, info = gt.Cg.build(criteria=pc).generate(A).solve_chunked(
        torch.from_numpy(b), torch.from_numpy(x0), chunk=7, loggers=[prec])
    assert int(info.iterations) == int(jinfo.iterations)
    assert bool(info.converged.all()) and bool(np.asarray(jinfo.converged).all())
    assert _events(prec) == _events(jrec)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-12, atol=1e-12)
    # the chunked recurrence is the one-shot streaming solve's
    one, oinfo = gt.Cg.build(criteria=pc).generate(A).solve(torch.from_numpy(b),
                                                            torch.from_numpy(x0))
    if baseline == "rhs_norm":
        assert int(oinfo.iterations) == int(info.iterations)
        np.testing.assert_allclose(x.numpy(), one.numpy(), rtol=1e-12, atol=1e-12)


def test_frozen_baseline_declines_the_fused_route():
    """float32 on a Dia: the one-shot solve runs K4 (its plain version
    here); the chunked solve with a frozen relative baseline streams."""
    _, A = _problem(12, np.float32)
    _, pc = _crit(400, 1e-5, "initial_resnorm", time_limit=60.0)
    solver = gt.Cg.build(criteria=pc).generate(A)
    assert stop.analyze_simple_residual(solver.criterion) is not None
    frozen = stop.freeze_initial_baseline(solver.criterion, torch.ones(1))
    assert stop.analyze_simple_residual(frozen) is None
    jfrozen = j_freeze(jstop.Combined(criteria=(jstop.Iteration(max_iters=4),
                                                jstop.ResidualNorm(baseline="initial_resnorm"))),
                       jnp.ones(1))
    assert j_analyze(jfrozen) is None
    b = torch.ones(A.shape[0])
    counts = []
    for run in (lambda: solver.solve(b), lambda: solver.solve_chunked(b, chunk=25)):
        c = plog.add_global_logger(plog.Counters())
        try:
            _, info = run()
        finally:
            plog.remove_global_logger(c)
        assert bool(info.converged.all())
        counts.append(dict(c.kernel_counts))
    # the one-shot solve: r0 = b - A x0, then K4
    assert counts[0] == {"dia_spmv": 1, "cg_fused": 1}
    assert "cg_fused" not in counts[1] and counts[1]["dia_spmv"] > 10


def test_time_criterion_stops_between_chunks():
    _, A = _problem(16, np.float64)
    crit = [stop.Iteration(max_iters=10_000), stop.ResidualNorm(tolerance=1e-300),
            stop.Time(time_limit_sec=0.0)]
    solver = gt.Cg.build(criteria=crit).generate(A)
    assert gt.solver.solver_base.extract_time_limit(solver.criterion) == 0.0
    # inert inside a solve: the one-shot solve runs to the iteration cap
    assert stop.analyze_simple_residual(solver.criterion) == (1e-300, "rhs_norm", False, True)
    rec = plog.Record()
    x, info = solver.solve_chunked(torch.ones(A.shape[0]), chunk=5, loggers=[rec])
    assert int(info.iterations) == 5 and not bool(info.converged.all())
    assert [kind for kind, _, _ in _events(rec)].count("iteration_complete") == 1


def test_solver_factory_on_is_a_no_op():
    factory = gt.Cg.build(criteria=[stop.Iteration(max_iters=3)])
    assert factory.on(gt.ReferenceExecutor.create()) is factory


def test_logged_linop_and_hints():
    _, A = _problem(6, np.float64)
    rec = plog.Record()
    op = plog.LoggedLinOp(A, loggers=[rec], name="A")
    y = op.apply(torch.ones(A.shape[0]))
    op.apply_advanced(2.0, torch.ones(A.shape[0]), 0.5, y)
    assert [e.value for e, _ in rec.history] == [
        "linop_apply_started", "linop_apply_completed", "linop_advanced_apply_started",
        "linop_advanced_apply_completed"]
    assert all(d["op"] == "A" for _, d in rec.history)
    assert op.shape == A.shape  # other attributes pass through
    out = io.StringIO()
    hint = plog.PerformanceHint(out=out, copy_threshold=2, alloc_threshold=3)
    ex = gt.ReferenceExecutor.create()
    ex.add_logger(hint)
    for _ in range(3):
        ex.put(torch.ones(2))
        ex.copy_from(ex, torch.ones(2))
    assert "cross-device copies" in out.getvalue() and "allocations" in out.getvalue()
    stream = io.StringIO()
    plog.Stream(out=stream, prefix="> ").on(plog.Event.iteration_complete, iteration=3)
    assert stream.getvalue() == "> iteration_complete: iteration=3\n"


def test_counters_count_kernel_calls():
    _, A = _problem(8, np.float32)
    c = plog.add_global_logger(plog.Counters())
    try:
        for _ in range(3):
            A.apply(torch.ones(A.shape[0]))
    finally:
        plog.remove_global_logger(c)
    assert c.kernel_counts["dia_spmv"] == 3
    assert c.counts["operation_launched"] == c.counts["operation_completed"] == 3
    assert c.op_seconds["dia_spmv"] > 0.0
    assert ops_dia.dia_spmv.launches == 0  # the plain version ran: no launch


def test_logged_kernel_costs_nothing_without_a_logger():
    calls = []

    @plog.logged_kernel(name="probe")
    def probe(x):
        calls.append(x)
        return x + 1

    assert plog.global_loggers() == ()
    assert probe(1) == 2 and calls == [1]
    rec = plog.add_global_logger(plog.Record())
    try:
        assert probe(2) == 3
    finally:
        plog.remove_global_logger(rec)
    assert [(e.value, d) for e, d in rec.history] == [
        ("operation_launched", {"name": "probe", "kernel": True}),
        ("operation_completed", {"name": "probe", "kernel": True})]
    assert probe.__wrapped__(5) == 6 and probe.__name__ == "probe"


def test_profiler_ranges_are_recorded(tmp_path):
    _, A = _problem(10, np.float64)
    solver = gt.Cg.build(criteria=[stop.Iteration(max_iters=20)]).generate(A)
    b = torch.ones(A.shape[0])
    with plog.trace(str(tmp_path)) as prof:
        pr = plog.ProfilerRange()
        plog.add_global_logger(pr)
        try:
            with plog.profile_region("whole_solve", device=b.device):
                solver.solve_chunked(b, chunk=10, loggers=())
        finally:
            plog.remove_global_logger(pr)
            pr.close()
    names = {e.key for e in prof.key_averages()}
    assert {"whole_solve", "dia_spmv", "iteration_10", "iteration_20",
            "criterion_check"} <= names, names
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(ev.get("name") == "whole_solve" for ev in trace["traceEvents"])
