"""Slice 4, GMRES and CB-GMRES: the port (ginkgo_tpu_torch) against the JAX
package (ginkgo_tpu) on the CPU.

- K15's plain version (ops/gmres.gmres_solve_reference) against the JAX
  whole-solve kernel gmres_vmem_solve in Pallas interpret mode, on the
  same diagonals (carried into the JAX lane frame bit for bit): restarts
  (m = 4 on 16^2), a bfloat16 basis, bfloat16 diagonals with Jacobi,
  Iteration only and a NaN right-hand side.  The JAX kernel sums its dot
  products in float32, the port in float64, so the iteration counts may
  differ by one; x agrees to 1e-4 relative.
- Gmres and CbGmres against the JAX solvers' streaming route
  (GINKGO_TPU_NO_PALLAS=1): the fused route (K15's plain version) within
  one restart cycle of iterations, as tests/test_pallas_gmres.py holds the
  JAX kernel to its own streaming loop; the streaming loop in float64 to
  1e-10 in all six CB-GMRES storage modes and for k = 3 columns.
- Gates: integer storage modes, k > 4 columns, a Pell operator and a
  Krylov dimension beyond the kernel's stream and say so (k = 2 takes the
  k-column kernel K15m); "auto" resolves as the JAX package does.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu import stop as jstop
from ginkgo_tpu.matrix.dia import Dia as JDia
from ginkgo_tpu.ops.pallas_gmres import gmres_vmem_solve
from ginkgo_tpu.solver.gmres import CbGmres as JCbGmres, Gmres as JGmres
from ginkgo_tpu_torch import stop
from ginkgo_tpu_torch.ops.gmres import (
    MAX_FUSED_KRYLOV_DIM,
    gmres_fused,
    gmres_solve_reference,
)
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
    "restarts_m4": dict(matrix="poisson16", storage="f32", jacobi=False, m=4,
                        basis="f32", tol=1e-5, rhs="random"),
    "bf16_basis": dict(matrix="convdiff32", storage="f32", jacobi=False, m=10,
                       basis="bf16", tol=1e-6, rhs="random"),
    "bf16_diags_jacobi": dict(matrix="convdiff32_jitter", storage="bf16", jacobi=True,
                              m=10, basis="f32", tol=1e-6, rhs="random"),
    "iteration_only": dict(matrix="tridiag700", storage="f32", jacobi=True, m=6,
                           basis="f32", tol=None, rhs="random"),
    "nan": dict(matrix="poisson16", storage="f32", jacobi=False, m=4, basis="f32",
                tol=1e-6, rhs="nan"),
}
BASIS = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_gmres_reference_matches_pallas_kernel(name):
    case = KERNEL_CASES[name]
    JA, A = dia_pair(case["matrix"], case["storage"])
    R = JA.diags.shape[1]
    b, x0, minv, tol = kernel_inputs(A, case, np.random.default_rng(13))
    max_iters = 25 if case["tol"] is None or case["rhs"] == "nan" else 600
    t = torch.from_numpy
    mv = None if minv is None else t(minv)
    jb, pb = BASIS[case["basis"]]
    jx, jit_, jrr, jconv = gmres_vmem_solve(
        jax_frame(A.diags, R), JA.offsets, jax_frame(t(b), R), jax_frame(t(x0), R),
        None if mv is None else jax_frame(mv, R), m=case["m"], tol_sq_eff=tol,
        max_iters=max_iters, basis_dtype=jb, interpret=True,
    )
    x, it, rr, conv = gmres_solve_reference(
        A.diags, A.offsets, t(b), t(x0), mv, m=case["m"], tol_sq_eff=float(tol),
        max_iters=max_iters, basis_dtype=pb,
    )
    assert it.dtype == torch.int32 and rr.dtype == torch.float32 and x.dtype == torch.float32
    jx = np.asarray(jx).reshape(-1)[: A.shape[0]]
    assert_kernel_parity(it, jit_, x.numpy(), jx, rr, jrr, conv, jconv, case, max_iters)
    if case["rhs"] != "nan":
        # the returned r.r is the true residual of the returned x
        r = b.astype(np.float64) - A.to_dense().values.double().numpy() @ x.double().numpy()
        np.testing.assert_allclose(float(rr), float(r @ r), rtol=1e-2)
    if name == "restarts_m4":
        assert int(it) > 4 * 3  # several restart cycles ran


def test_gmres_fused_takes_plain_version_on_cpu():
    _, A = dia_pair("poisson16")
    b = torch.ones(A.shape[0])
    before = gmres_fused.launches
    kw = dict(m=5, tol_sq_eff=1e-8, max_iters=60)
    got = gmres_fused(A.diags, A.offsets, b, torch.zeros_like(b), None, **kw)
    want = gmres_solve_reference(A.diags, A.offsets, b, torch.zeros_like(b), None, **kw)
    assert gmres_fused.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _relres(A, x, b):
    r = b.double() - A.apply(x.double())
    return float(r.norm() / b.double().norm())


FUSED_SOLVER_CASES = [
    # (cls, matrix, storage, crit, jacobi, m, storage_precision)
    ("gmres", "poisson16", "f32", "resnorm", False, 10, "keep"),
    ("gmres", "convdiff32_jitter", "f32", "resnorm", True, 10, "keep"),
    ("gmres", "convdiff32", "bf16", "resnorm", False, 30, "keep"),
    ("gmres", "tridiag700", "f32", "iteration", False, 6, "keep"),
    ("cbgmres", "convdiff32", "f32", "resnorm", False, 10, "reduce1"),
    ("cbgmres", "convdiff32", "f32", "resnorm", True, 10, "reduce2"),
    ("cbgmres", "poisson16", "f32", "resnorm", False, 10, "keep"),
]
SOLVERS = {"gmres": (JGmres, gt.Gmres), "cbgmres": (JCbGmres, gt.CbGmres)}


@pytest.mark.parametrize("cls,matrix,storage,crit,jacobi,m,mode", FUSED_SOLVER_CASES)
def test_fused_route_matches_jax_streaming(cls, matrix, storage, crit, jacobi, m, mode,
                                           monkeypatch):
    JA, A = dia_pair(matrix, storage)
    n = A.shape[0]
    max_iters = 12 if crit == "iteration" else 400
    tol = 1e-5 if matrix == "poisson16" else 1e-6
    js, ps = solver_pair(*SOLVERS[cls], JA, A, (crit, max_iters, tol), jacobi,
                         krylov_dim=m, storage_precision=mode)
    b = np.random.default_rng(3).standard_normal((n, 1)).astype(np.float32)
    inner = ps._inner() if cls == "cbgmres" else ps
    assert inner._try_fused(torch.from_numpy(b), torch.zeros(n, 1)) is not None
    jx, jinfo = jax_streaming(js, b, monkeypatch=monkeypatch)
    px, pinfo = ps.solve(torch.from_numpy(b))
    assert px.dtype == torch.float32 and px.shape == (n, 1)
    np.testing.assert_array_equal(pinfo.converged.numpy(), np.asarray(jinfo.converged))
    if crit == "iteration":
        assert int(pinfo.iterations) == int(jinfo.iterations) == max_iters
        np.testing.assert_allclose(px.numpy(), jx, rtol=0, atol=1e-4 * np.abs(jx).max())
        return
    # restart boundaries may move by round-off: one cycle apart at most
    assert abs(int(pinfo.iterations) - int(jinfo.iterations)) <= m
    assert _relres(A, px, torch.from_numpy(b)) <= tol
    # the fused route reports the true residual norm
    np.testing.assert_allclose(
        float(pinfo.residual_norm[0]),
        float((torch.from_numpy(b).double() - A.apply(px.double())).norm()), rtol=1e-2)
    np.testing.assert_allclose(px.numpy(), jx, rtol=0, atol=1e-3 * np.abs(jx).max())


MODES = ["keep", "reduce1", "reduce2", "integer", "ireduce1", "ireduce2"]


@pytest.mark.parametrize("mode", MODES)
def test_cbgmres_streaming_modes_match_jax_float64(mode, monkeypatch):
    """All six storage modes on the streaming loop, float64 arithmetic:
    equal iterations, stop flags, residual norms and x."""
    jd, pd = matrices("convdiff32_jitter")
    JA = JDia.from_matrix_data(jd).astype(jnp.float64)
    A = gt.Dia.from_matrix_data(pd, device="cpu").astype(torch.float64)
    n = A.shape[0]
    js, ps = solver_pair(JCbGmres, gt.CbGmres, JA, A, ("resnorm", 120, 1e-7), True,
                         krylov_dim=8, storage_precision=mode)
    b = np.random.default_rng(6).standard_normal((n, 1))
    assert ps._inner()._try_fused(torch.from_numpy(b), torch.zeros(n, 1)) is None
    jx, jinfo = jax_streaming(js, b, monkeypatch=monkeypatch)
    px, pinfo = ps.solve(torch.from_numpy(b))
    assert int(pinfo.iterations) == int(jinfo.iterations)
    np.testing.assert_array_equal(pinfo.converged.numpy(), np.asarray(jinfo.converged))
    np.testing.assert_allclose(pinfo.residual_norm.numpy(), np.asarray(jinfo.residual_norm),
                               rtol=1e-6)
    np.testing.assert_allclose(px.numpy(), jx, rtol=1e-8, atol=1e-10)


def test_gmres_streaming_k3_matches_jax(monkeypatch):
    """k = 3 float64 columns stream in the port (a loop over the columns
    where the JAX package vmaps; the k-column kernel takes float32 only, in
    both), each with its own iteration count and stop flag; the solve
    reports the largest count."""
    JA, A = dia_pair("poisson16")
    JA, A = JA.astype(jnp.float64), A.astype(torch.float64)
    n = A.shape[0]
    js, ps = solver_pair(JGmres, gt.Gmres, JA, A, ("resnorm", 300, 1e-10), False, krylov_dim=10)
    rng = np.random.default_rng(8)
    b = np.stack([np.ones(n), rng.standard_normal(n), np.zeros(n)], axis=1)
    b[0, 2] = 1.0
    assert ps._try_fused(torch.from_numpy(b), torch.zeros(n, 3, dtype=torch.float64)) is None
    jx, jinfo = jax_streaming(js, b, monkeypatch=monkeypatch)
    px, pinfo = ps.solve(torch.from_numpy(b))
    assert int(pinfo.iterations) == int(jinfo.iterations)
    np.testing.assert_array_equal(pinfo.converged.numpy(), np.asarray(jinfo.converged))
    # a residual at 1e-10 of |b| is b - A x after cancellation: it agrees to
    # |b| times the iterates' relative gap (~1e-12, summation orders of the
    # basis products and the triangular solve), not to 1e-6 of itself
    np.testing.assert_allclose(pinfo.residual_norm.numpy(), np.asarray(jinfo.residual_norm),
                               rtol=1e-6, atol=1e-12 * np.linalg.norm(b, axis=0).max())
    np.testing.assert_allclose(px.numpy(), jx, rtol=1e-8, atol=1e-10)


def test_gmres_declined_routes_stream():
    """Integer storage, k = 5 columns (beyond the JAX k-column kernel's 4,
    gmres.py:351-377; k = 2 takes K15m) and a Krylov dimension beyond the
    kernel's shared memory stream; one column on an S = 8 Pell takes the
    Pell kernel K18 (the JAX Pell kernel, gmres.py:418; ported in slice 6),
    two stream there; "auto" resolves to keep below 2^19 rows and reduce1
    at or above, as the JAX package's rule does."""
    jd, pd = matrices("poisson16")
    _, A = dia_pair("poisson16")
    b1, b2, b5 = (torch.ones(A.shape[0], k) for k in (1, 2, 5))
    crit = [stop.Iteration(max_iters=20), stop.ResidualNorm(tolerance=1e-6)]
    ok = gt.Gmres.build(criteria=crit).generate(A)
    assert ok._try_fused(b1, torch.zeros_like(b1)) is not None
    assert ok._try_fused(b2, torch.zeros_like(b2)) is not None
    assert ok._try_fused(b5, torch.zeros_like(b5)) is None
    for mode in ("integer", "ireduce1", "ireduce2"):
        s = gt.Gmres.build(criteria=crit, storage_precision=mode).generate(A)
        assert s._try_fused(b1, torch.zeros_like(b1)) is None
    big = gt.Gmres.build(criteria=crit, krylov_dim=MAX_FUSED_KRYLOV_DIM + 1).generate(A)
    assert big._try_fused(b1, torch.zeros_like(b1)) is None
    P = gt.Pell.from_matrix_data(pd, device="cpu")
    sp = gt.Gmres.build(criteria=crit).generate(P)
    assert sp._try_fused(b1, torch.zeros_like(b1)) is not None
    assert sp._try_fused(b2, torch.zeros_like(b2)) is None
    x, info = sp.solve(b1)
    assert x.shape == b1.shape and int(info.iterations) == 20
    auto = gt.CbGmres.build(criteria=crit).generate(A)
    assert auto._resolved_mode() == "keep"
    big_op = gt.Dia(diags=torch.ones(1, 1 << 19), offsets=(0,), shape=(1 << 19, 1 << 19))
    assert gt.CbGmres.build(criteria=crit).generate(big_op)._resolved_mode() == "reduce1"
    jauto = JCbGmres.build(criteria=[jstop.Iteration(max_iters=20)]).generate(
        JDia.from_matrix_data(jd))
    assert jauto._resolved_mode() == auto._resolved_mode()
    assert gt.CbGmres._AUTO_REDUCE_ROWS == JCbGmres._AUTO_REDUCE_ROWS
