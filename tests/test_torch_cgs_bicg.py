"""Slice 4, CGS and BiCG: the port (ginkgo_tpu_torch) against the JAX
package (ginkgo_tpu) on the CPU.

- K13's and K14's plain versions (ops/cgs.py) against the JAX whole-solve
  kernels cgs_vmem_solve and bicg_vmem_solve in Pallas interpret mode, on
  the same diagonals (CGS: A M folded by fold_minv; BiCG: A and the port's
  conjugate transpose), carried into the JAX lane frame bit for bit.  The
  JAX kernels sum their dot products in float32, the port in float64, so
  the iteration counts may differ by one; x agrees to 1e-4 relative.  The
  BiCG cases avoid the 32^2 convection-diffusion matrix with a tolerance:
  its BiCG residual jumps by 100x from one iteration to the next near
  1e-6, so the dot sums' rounding moves the stop by several iterations.
- Cgs and Bicg against the JAX solvers' streaming routes
  (GINKGO_TPU_NO_PALLAS=1), fused (the plain versions on the CPU) and
  streaming (float64, k = 3 columns).
- BiCG on a nonsymmetric A differs from "BiCG with At = A", so a missing
  transpose fails; declined routes stream.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu.matrix.dia import Dia as JDia
from ginkgo_tpu.ops.pallas_cgs import bicg_vmem_solve, cgs_vmem_solve
from ginkgo_tpu.solver.bicgstab import Bicg as JBicg, Cgs as JCgs
from ginkgo_tpu_torch import stop
from ginkgo_tpu_torch.ops.cgs import (
    bicg_fused,
    bicg_solve_reference,
    cgs_fused,
    cgs_solve_reference,
)
from ginkgo_tpu_torch.solver._fused_gate import fold_minv
from tests.test_torch_bicgstab import (
    assert_fused_vs_streaming,
    assert_kernel_parity,
    dia_pair,
    jax_frame,
    jax_streaming,
    kernel_inputs,
    matrices,
    solver_pair,
)

KERNEL_CASES = {
    "cgs_f32": dict(solver="cgs", matrix="convdiff32", storage="f32", jacobi=False,
                    implicit=False, tol=1e-6, rhs="random"),
    "cgs_bf16_jacobi": dict(solver="cgs", matrix="convdiff32_jitter", storage="bf16",
                            jacobi=True, implicit=False, tol=1e-6, rhs="random"),
    "cgs_implicit": dict(solver="cgs", matrix="tridiag700", storage="f32", jacobi=False,
                         implicit=True, tol=1e-6, rhs="random"),
    "cgs_nan": dict(solver="cgs", matrix="convdiff32", storage="f32", jacobi=False,
                    implicit=False, tol=1e-6, rhs="nan"),
    "bicg_f32": dict(solver="bicg", matrix="tridiag700", storage="f32", jacobi=False,
                     implicit=False, tol=1e-6, rhs="random"),
    "bicg_bf16_jacobi": dict(solver="bicg", matrix="tridiag700", storage="bf16",
                             jacobi=True, implicit=False, tol=1e-6, rhs="random"),
    "bicg_iteration_only": dict(solver="bicg", matrix="convdiff32_jitter", storage="f32",
                                jacobi=True, implicit=False, tol=None, rhs="random"),
    "bicg_nan": dict(solver="bicg", matrix="tridiag700", storage="f32", jacobi=False,
                     implicit=False, tol=1e-6, rhs="nan"),
}


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_reference_matches_pallas_kernel(name):
    case = KERNEL_CASES[name]
    JA, A = dia_pair(case["matrix"], case["storage"])
    R = JA.diags.shape[1]
    b, x0, minv, tol = kernel_inputs(A, case, np.random.default_rng(11))
    max_iters = 25 if case["tol"] is None or case["rhs"] == "nan" else 500
    t = torch.from_numpy
    mv = None if minv is None else t(minv)
    kw = dict(tol_sq_eff=float(tol), max_iters=max_iters, use_implicit=case["implicit"])
    jkw = dict(tol_sq_eff=tol, max_iters=max_iters, use_implicit=case["implicit"],
               interpret=True)
    jvec = [jax_frame(t(b), R), jax_frame(t(x0), R), None if mv is None else jax_frame(mv, R)]
    if case["solver"] == "cgs":
        diags = A.diags if mv is None else fold_minv(A, mv)
        jx, jit_, jmon, jconv = cgs_vmem_solve(jax_frame(diags, R), JA.offsets, *jvec, **jkw)
        x, r, it, mon, conv = cgs_solve_reference(diags, A.offsets, t(b), t(x0), mv, **kw)
    else:
        At = A.conj_transpose()
        assert At.dtype == A.dtype
        jx, jit_, jmon, jconv = bicg_vmem_solve(
            jax_frame(A.diags, R), JA.offsets, jax_frame(At.diags, R), At.offsets, *jvec, **jkw)
        x, r, it, mon, conv = bicg_solve_reference(
            A.diags, A.offsets, At.diags, At.offsets, t(b), t(x0), mv, **kw)
    jx = np.asarray(jx).reshape(-1)[: A.shape[0]]
    assert_kernel_parity(it, jit_, x.numpy(), jx, mon, jmon, conv, jconv, case, max_iters)


def test_wrappers_take_plain_versions_on_cpu():
    _, A = dia_pair("tridiag700")
    At = A.conj_transpose()
    b = torch.ones(A.shape[0])
    z = torch.zeros_like(b)
    kw = dict(tol_sq_eff=1e-10, max_iters=100)
    before = (cgs_fused.launches, bicg_fused.launches)
    pairs = ((cgs_fused(A.diags, A.offsets, b, z, None, **kw),
              cgs_solve_reference(A.diags, A.offsets, b, z, None, **kw)),
             (bicg_fused(A.diags, A.offsets, At.diags, At.offsets, b, z, None, **kw),
              bicg_solve_reference(A.diags, A.offsets, At.diags, At.offsets, b, z, None, **kw)))
    assert (cgs_fused.launches, bicg_fused.launches) == before
    for got, want in pairs:
        for g, w in zip(got, want):
            assert torch.equal(g, w)


SOLVERS = {"cgs": (JCgs, gt.Cgs), "bicg": (JBicg, gt.Bicg)}

FUSED_SOLVER_CASES = [
    # (solver, matrix, storage, crit, jacobi)
    ("cgs", "tridiag700", "f32", "resnorm", False),
    ("cgs", "convdiff32_jitter", "f32", "resnorm", True),
    ("cgs", "convdiff32", "bf16", "resnorm", False),
    ("cgs", "convdiff32", "f32", "iteration", False),
    ("bicg", "tridiag700", "f32", "resnorm", False),
    ("bicg", "tridiag700", "f32", "resnorm", True),
    ("bicg", "tridiag700", "bf16", "implicit", False),
    ("bicg", "poisson16", "f32", "resnorm", False),
]


@pytest.mark.parametrize("solver,matrix,storage,crit,jacobi", FUSED_SOLVER_CASES)
def test_fused_route_matches_jax_streaming(solver, matrix, storage, crit, jacobi,
                                           monkeypatch):
    JA, A = dia_pair(matrix, storage)
    n = A.shape[0]
    max_iters = 30 if crit == "iteration" else 400
    js, ps = solver_pair(*SOLVERS[solver], JA, A, (crit, max_iters, 1e-6), jacobi)
    b = np.random.default_rng(3).standard_normal((n, 1)).astype(np.float32)
    assert ps._try_fused(torch.from_numpy(b), torch.zeros(n, 1)) is not None
    jx, jinfo = jax_streaming(js, b, monkeypatch=monkeypatch)
    px, pinfo = ps.solve(torch.from_numpy(b))
    assert px.dtype == torch.float32 and px.shape == (n, 1)
    assert_fused_vs_streaming(px, pinfo, jx, jinfo, crit, max_iters)


@pytest.mark.parametrize("solver", ["cgs", "bicg"])
def test_streaming_k3_matches_jax_float64(solver, monkeypatch):
    jd, pd = matrices("tridiag700")
    JA = JDia.from_matrix_data(jd).astype(jnp.float64)
    A = gt.Dia.from_matrix_data(pd, device="cpu").astype(torch.float64)
    n = A.shape[0]
    js, ps = solver_pair(*SOLVERS[solver], JA, A, ("resnorm", 300, 1e-10), True)
    rng = np.random.default_rng(4)
    b = np.stack([np.ones(n), rng.standard_normal(n), rng.uniform(0, 1, n)], axis=1)
    assert ps._try_fused(torch.from_numpy(b), torch.zeros(n, 3)) is None
    jx, jinfo = jax_streaming(js, b, monkeypatch=monkeypatch)
    px, pinfo = ps.solve(torch.from_numpy(b))
    assert int(pinfo.iterations) == int(jinfo.iterations)
    np.testing.assert_array_equal(pinfo.converged.numpy(), np.asarray(jinfo.converged))
    np.testing.assert_allclose(pinfo.residual_norm.numpy(), np.asarray(jinfo.residual_norm),
                               rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(px.numpy(), jx, rtol=1e-10, atol=1e-12)


def test_bicg_needs_the_transpose():
    """On a nonsymmetric A, BiCG with the true A^H and BiCG with At = A
    take different paths; Bicg.create builds A^H (offsets negated) and
    keeps the diagonals' dtype."""
    for storage in ("f32", "bf16"):
        _, A = dia_pair("tridiag700", storage)
        s = gt.Bicg.build(criteria=[stop.Iteration(max_iters=60),
                                    stop.ResidualNorm(tolerance=1e-6)]).generate(A)
        assert s.At.offsets == tuple(-o for o in reversed(A.offsets))
        assert s.At.dtype == A.dtype
        b = torch.from_numpy(np.random.default_rng(3).standard_normal((700, 1))
                             .astype(np.float32))
        x, info = s.solve(b)
        wrong = gt.Bicg(A=A, preconditioner=s.preconditioner, criterion=s.criterion,
                        At=A, Mt=s.Mt)
        xw, infow = wrong.solve(b)
        assert bool(info.converged[0])
        assert int(info.iterations) != int(infow.iterations) or not torch.allclose(x, xw)


def test_declined_routes_stream(monkeypatch):
    """k-column CGS and BiCG have no kernel: 2-column solves stream; a Bicg
    whose At is not a Dia streams, and Bicg on a Pell (no Pell BiCG kernel
    in the JAX package either).  Cgs on an S = 8 Pell takes the Pell kernel
    K20 (the JAX Pell CGS kernel, bicgstab.py:413; ported in slice 6) and
    solves as the JAX loop does."""
    jd, pd = matrices("tridiag700")
    crit = [stop.Iteration(max_iters=200), stop.ResidualNorm(tolerance=1e-6)]
    P = gt.Pell.from_matrix_data(pd, device="cpu")
    b1, b2 = torch.ones(700, 1), torch.ones(700, 2)
    sp = gt.Cgs.build(criteria=crit).generate(P)
    assert sp._try_fused(b1, torch.zeros_like(b1)) is not None
    assert sp._try_fused(b2, torch.zeros_like(b2)) is None
    spb = gt.Bicg.build(criteria=crit).generate(P)
    assert spb._try_fused(b1, torch.zeros_like(b1)) is None
    _, A = dia_pair("tridiag700")
    for cls in (gt.Cgs, gt.Bicg):
        s = cls.build(criteria=crit).generate(A)
        assert s._try_fused(b2, torch.zeros_like(b2)) is None
        assert s._try_fused(b1, torch.zeros_like(b1)) is not None
    sb = gt.Bicg.build(criteria=crit).generate(A)
    sb.At = sb.At.to_dense()
    assert sb._try_fused(b1, torch.zeros_like(b1)) is None
    # the Pell solve runs K20's plain version and matches the JAX loop
    js, _ = solver_pair(JCgs, gt.Cgs, JDia.from_matrix_data(jd), A,
                        ("resnorm", 200, 1e-6), False)
    b = np.random.default_rng(3).standard_normal((700, 1)).astype(np.float32)
    jx, jinfo = jax_streaming(js, b, monkeypatch=monkeypatch)
    px, pinfo = sp.solve(torch.from_numpy(b))
    assert abs(int(pinfo.iterations) - int(jinfo.iterations)) <= 1
    np.testing.assert_allclose(px.numpy(), jx, rtol=0, atol=1e-4 * np.abs(jx).max())
