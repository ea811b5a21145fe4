"""Slice 5, IDR(s): the port (ginkgo_tpu_torch) against the JAX package
(ginkgo_tpu) on the CPU.

- K16's plain version (ops/idr.idr_solve_reference) against the JAX
  whole-solve kernel idr_vmem_solve in Pallas interpret mode, on the same
  diagonals and the same shadow space, s in {1, 2, 4}, float32 and
  bfloat16 diagonals, with and without an inverse diagonal, and a NaN
  right-hand side: outer iterations equal or one apart (float32 against
  float64 dot sums; the JAX package's own kernel test allows the same,
  tests/test_pallas_idr.py:51), x to 1e-4 relative.
- ``Idr.P`` is bit for bit the JAX package's for float32, bfloat16 and
  float64 operators.
- Idr against the JAX solver's streaming route (GINKGO_TPU_NO_PALLAS=1):
  k = 2 float64 columns to 1e-10 (the port's per-column loop where the JAX
  package vmaps), and the fused route (K16's plain version) for one
  float32 column.
- Gates: s = 5, k = 2 and a Pell stream and say so.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu.matrix.dia import Dia as JDia
from ginkgo_tpu.ops.pallas_idr import idr_vmem_solve
from ginkgo_tpu.solver._fused_gate import frame_cols
from ginkgo_tpu.solver.idr import Idr as JIdr
from ginkgo_tpu_torch import stop
from ginkgo_tpu_torch.ops.idr import MAX_FUSED_IDR_S, idr_fused, idr_solve_reference
from tests.test_torch_bicgstab import (
    assert_kernel_parity,
    dia_pair,
    jax_frame,
    jax_streaming,
    kernel_inputs,
    matrices,
    solver_pair,
)

KERNEL_CASES = {
    "s1": dict(matrix="tridiag700", storage="f32", s=1, jacobi=False, tol=1e-6, rhs="random"),
    "s2_bf16_jacobi": dict(matrix="convdiff32_jitter", storage="bf16", s=2, jacobi=True,
                           tol=1e-6, rhs="random"),
    "s4": dict(matrix="tridiag700", storage="f32", s=4, jacobi=False, tol=1e-6, rhs="random"),
    "nan": dict(matrix="tridiag700", storage="f32", s=2, jacobi=False, tol=1e-6, rhs="nan"),
}


def shadow(A, s):
    """The port's shadow space of an Idr(s) on A, as the kernels take it."""
    return gt.Idr.build(criteria=[stop.Iteration(max_iters=1)], subspace_dim=s).generate(
        A).P.to(torch.float32)


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_idr_reference_matches_pallas_kernel(name):
    case = KERNEL_CASES[name]
    JA, A = dia_pair(case["matrix"], case["storage"])
    n, R = A.shape[0], JA.diags.shape[1]
    # IDR(1) is as sensitive to float32 dot sums as BiCGSTAB: for some
    # right-hand sides the JAX kernel's float32 sums and the port's float64
    # ones stop 2-4 outer iterations apart (tridiag700, seed 17: 13 against
    # 11; convdiff32, seed 17: 24 against 28); with seed 23 they agree
    b, x0, minv, tol = kernel_inputs(A, case, np.random.default_rng(23))
    max_iters = 10 if case["rhs"] == "nan" else 300
    t = torch.from_numpy
    mv = None if minv is None else t(minv)
    P = shadow(A, case["s"])
    jx, jit_, jmon, jconv = idr_vmem_solve(
        jax_frame(A.diags, R), JA.offsets, frame_cols(jnp.asarray(P.numpy().T), R),
        jax_frame(t(b), R), jax_frame(t(x0), R), jax_frame(t(b), R),
        None if mv is None else jax_frame(mv, R), s=case["s"], kappa=0.7, tol_sq_eff=tol,
        max_iters=max_iters, interpret=True,
    )
    x, r, it, mon, conv = idr_solve_reference(
        A.diags, A.offsets, P, t(b), t(x0), t(b), mv, kappa=0.7, tol_sq_eff=float(tol),
        max_iters=max_iters,
    )
    assert it.dtype == torch.int32 and mon.dtype == torch.float32 and x.dtype == torch.float32
    jx = np.asarray(jx).reshape(-1)[:n]
    assert_kernel_parity(it, jit_, x.numpy(), jx, mon, jmon, conv, jconv, case, max_iters)
    if case["rhs"] != "nan":
        # the monitor is the replaced residual's r.r: r = b - A x in float32
        rr = t(b) - A.apply(x)
        assert torch.equal(r, rr) and float(mon) == float((rr.double() ** 2).sum().float())


def test_idr_converged_r0_runs_no_iteration():
    """The monitor starts at r0.r0 when that already meets the threshold
    (pallas_idr.py:291), unlike K12's and K17's +inf: no iteration runs."""
    _, A = dia_pair("tridiag700")
    x0 = torch.from_numpy(np.random.default_rng(2).standard_normal(A.shape[0]).astype(np.float32))
    b = A.apply(x0)
    r0 = b - A.apply(x0)
    x, r, it, mon, conv = idr_fused(A.diags, A.offsets, shadow(A, 2), r0, x0, b, None,
                                    kappa=0.7, tol_sq_eff=1e-12, max_iters=50)
    assert int(it) == 0 and bool(conv) and float(mon) == 0.0 and torch.equal(x, x0)


def test_idr_fused_takes_plain_version_on_cpu():
    _, A = dia_pair("tridiag700")
    b = torch.ones(A.shape[0])
    z = torch.zeros_like(b)
    kw = dict(kappa=0.7, tol_sq_eff=1e-10, max_iters=40)
    before = idr_fused.launches
    got = idr_fused(A.diags, A.offsets, shadow(A, 2), b, z, b, None, **kw)
    want = idr_solve_reference(A.diags, A.offsets, shadow(A, 2), b, z, b, None, **kw)
    assert idr_fused.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_shadow_space_equals_jax(dtype):
    """numpy's generator, QR of P^T and the cast to A's dtype, as
    ginkgo_tpu/solver/idr.py:50-61: the same bits."""
    jd, pd = matrices("convdiff32")
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float64": jnp.float64}[dtype]
    JA = JDia.from_matrix_data(jd).astype(jdt)
    A = gt.Dia.from_matrix_data(pd, device="cpu").astype(getattr(torch, dtype))
    for s, seed in ((3, 42), (2, 7)):
        jP = JIdr.build(criteria=None, subspace_dim=s, seed=seed).generate(JA).P
        pP = gt.Idr.build(criteria=None, subspace_dim=s, seed=seed).generate(A).P
        assert pP.dtype == A.dtype and pP.shape == (s, A.shape[0])
        if dtype == "bfloat16":
            np.testing.assert_array_equal(pP.view(torch.int16).numpy(),
                                          np.asarray(jP).view(np.int16))
        else:
            np.testing.assert_array_equal(pP.numpy(), np.asarray(jP))


# -- the solver against the JAX solver's streaming route ---------------------------


def test_idr_streaming_k2_matches_jax_float64(monkeypatch):
    """k = 2 float64 columns stream in both packages (the port loops over
    the columns where the JAX package vmaps): the same iterations, stop
    flags, residual norms and x to 1e-10."""
    jd, pd = matrices("convdiff32_jitter")
    JA = JDia.from_matrix_data(jd).astype(jnp.float64)
    A = gt.Dia.from_matrix_data(pd, device="cpu").astype(torch.float64)
    n = A.shape[0]
    js, ps = solver_pair(JIdr, gt.Idr, JA, A, ("resnorm", 200, 1e-10), True, subspace_dim=3)
    rng = np.random.default_rng(5)
    b = np.stack([rng.standard_normal(n), rng.uniform(0, 1, n)], axis=1)
    x0 = np.full((n, 2), 0.1)
    assert ps._try_fused(torch.from_numpy(b[:, :1]), torch.from_numpy(x0[:, :1])) is None
    jx, jinfo = jax_streaming(js, b, x0, monkeypatch)
    px, pinfo = ps.solve(torch.from_numpy(b), torch.from_numpy(x0))
    assert int(pinfo.iterations) == int(jinfo.iterations)
    np.testing.assert_array_equal(pinfo.converged.numpy(), np.asarray(jinfo.converged))
    assert pinfo.converged.all()
    np.testing.assert_allclose(pinfo.residual_norm.numpy(), np.asarray(jinfo.residual_norm),
                               rtol=1e-6, atol=1e-12 * np.linalg.norm(b, axis=0).max())
    np.testing.assert_allclose(px.numpy(), jx, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("crit", ["resnorm", "implicit"])
def test_idr_fused_route_matches_jax_streaming(crit, monkeypatch):
    """One float32 column through K16's plain version against the JAX
    streaming loop: outer iterations one apart, the same stop flag, x to
    1e-4 relative; the residual norm is the replaced residual's, in
    implicit mode too (ginkgo_tpu solver/idr.py:246-249)."""
    JA, A = dia_pair("tridiag700")
    n = A.shape[0]
    js, ps = solver_pair(JIdr, gt.Idr, JA, A, (crit, 300, 1e-6), True, subspace_dim=2)
    b = np.random.default_rng(3).standard_normal((n, 1)).astype(np.float32)
    bt = torch.from_numpy(b)
    assert ps._try_fused(bt, torch.zeros(n, 1)) is not None
    jx, jinfo = jax_streaming(js, b, monkeypatch=monkeypatch)
    px, pinfo = ps.solve(bt)
    assert abs(int(pinfo.iterations) - int(jinfo.iterations)) <= 1
    np.testing.assert_array_equal(pinfo.converged.numpy(), np.asarray(jinfo.converged))
    np.testing.assert_allclose(px.numpy(), jx, rtol=0, atol=1e-4 * np.abs(jx).max())
    rr = ((bt - A.apply(px)).double() ** 2).sum(dim=0).float().sqrt()
    torch.testing.assert_close(pinfo.residual_norm, rr, rtol=0, atol=0)


def test_idr_declined_routes_stream(monkeypatch):
    """s above MAX_FUSED_IDR_S, k = 2 columns and a Pell operator stream
    (the JAX package's rule, solver/idr.py:211, 256); each still solves."""
    jd, pd = matrices("tridiag700")
    _, A = dia_pair("tridiag700")
    crit = [stop.Iteration(max_iters=200), stop.ResidualNorm(tolerance=1e-5)]
    b1, b2 = torch.ones(A.shape[0], 1), torch.ones(A.shape[0], 2)
    ok = gt.Idr.build(criteria=crit, subspace_dim=MAX_FUSED_IDR_S).generate(A)
    assert ok._try_fused(b1, torch.zeros_like(b1)) is not None
    big = gt.Idr.build(criteria=crit, subspace_dim=MAX_FUSED_IDR_S + 1).generate(A)
    assert big._try_fused(b1, torch.zeros_like(b1)) is None
    P = gt.Pell.from_matrix_data(pd, device="cpu")
    sp = gt.Idr.build(criteria=crit).generate(P)
    assert sp._try_fused(b1, torch.zeros_like(b1)) is None
    seen = []
    monkeypatch.setattr(gt.Idr, "_try_fused", lambda self, b, x0: seen.append(b.shape))
    for solver, b in ((big, b1), (ok, b2), (sp, b1)):
        x, info = solver.solve(b)
        assert x.shape == b.shape and bool(info.converged.all())
    assert seen == [(A.shape[0], 1), (A.shape[0], 1)]  # k = 2 never asks the gate
