"""Slice 5, IR / Richardson: the port (ginkgo_tpu_torch) against the JAX
package (ginkgo_tpu) on the CPU.

- K17's plain versions (ops/ir.ir_solve_reference, ir_smooth_reference)
  against the JAX kernels ir_vmem_solve and ir_vmem_smooth in Pallas
  interpret mode, on the same diagonals.  IR sums one dot a sweep (r.r), so
  the sweep counts are equal or one apart (float32 against float64 sums)
  and x agrees to 1e-4 relative.  The smoother has no dots, yet it is not
  bit for bit: XLA on the CPU contracts the update x + omega d and the
  product's sums acc + d x into fused multiply-adds
  (``test_xla_contracts_multiply_adds`` shows it), while the port rounds
  every product first, as the CUDA kernel does, compiled with -fmad=false.
  So the smoother is held bit for bit where no arithmetic runs (r0 = b from
  a zero start), x to 2 iters float32 epsilons of max |x| + max |x0| (one
  extra rounding of omega d per sweep, bounded by the update's operands)
  and r to 2 (iters + 1) epsilons of max |b| + 10 max |x| (the product's
  roundings; |A|_inf < 10 here).
- Ir against the JAX solver's streaming route (GINKGO_TPU_NO_PALLAS=1):
  k = 3 float64 columns to 1e-10, and the fused route for one float32
  column.
- Gates: IR on a Pell (the JAX package's Pell kernel is slice 6), the
  implicit criterion, k > 1 and a preconditioner that is not diagonal
  stream and say so; ``solver`` and ``Richardson`` alias as in the JAX
  package.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu.matrix.dia import Dia as JDia
from ginkgo_tpu.ops.pallas_ir import ir_vmem_smooth, ir_vmem_solve
from ginkgo_tpu.solver.ir import Ir as JIr
from ginkgo_tpu_torch import stop
from ginkgo_tpu_torch.ops.ir import ir_fused, ir_smooth, ir_smooth_reference, ir_solve_reference
from tests.test_torch_bicgstab import (
    assert_kernel_parity,
    dia_pair,
    jax_frame,
    jax_streaming,
    kernel_inputs,
    matrices,
    solver_pair,
)

EPS32 = float(np.finfo(np.float32).eps)

# Richardson converges on these: damped Jacobi on the diagonally dominant
# matrices, omega = 0.2 on convdiff32 (|I - 0.2 A| <= 0.9)
KERNEL_CASES = {
    "jacobi": dict(matrix="poisson16", storage="f32", jacobi=True, omega=0.9, tol=1e-5,
                   rhs="random"),
    "identity_bf16": dict(matrix="convdiff32", storage="bf16", jacobi=False, omega=0.2,
                          tol=1e-6, rhs="random"),
    "iteration_only": dict(matrix="tridiag700", storage="f32", jacobi=True, omega=1.0,
                           tol=None, rhs="random"),
    "nan": dict(matrix="convdiff32", storage="f32", jacobi=False, omega=0.2, tol=1e-6,
                rhs="nan"),
}


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_ir_reference_matches_pallas_kernel(name):
    case = KERNEL_CASES[name]
    JA, A = dia_pair(case["matrix"], case["storage"])
    n, R = A.shape[0], JA.diags.shape[1]
    b, x0, minv, tol = kernel_inputs(A, case, np.random.default_rng(29))
    max_iters = 25 if case["tol"] is None or case["rhs"] == "nan" else 2000
    t = torch.from_numpy
    mv = None if minv is None else t(minv)
    jx, jit_, jrr, jconv = ir_vmem_solve(
        jax_frame(A.diags, R), JA.offsets, jax_frame(t(b), R), jax_frame(t(x0), R),
        None if mv is None else jax_frame(mv, R), omega=case["omega"], tol_sq_eff=tol,
        max_iters=max_iters, interpret=True,
    )
    x, r, it, rr, conv = ir_solve_reference(
        A.diags, A.offsets, t(b), t(x0), mv, omega=case["omega"], tol_sq_eff=float(tol),
        max_iters=max_iters,
    )
    assert it.dtype == torch.int32 and rr.dtype == torch.float32 and x.dtype == torch.float32
    jx = np.asarray(jx).reshape(-1)[:n]
    assert_kernel_parity(it, jit_, x.numpy(), jx, rr, jrr, conv, jconv, case, max_iters)
    if case["rhs"] != "nan":
        # r is recomputed as b - A x every sweep, never updated
        assert torch.equal(r, t(b) - A.apply(x))


def test_ir_first_sweep_always_runs():
    """The monitor starts at +inf (pallas_ir.py:180-191): an r0 that meets
    the threshold still takes one sweep; with max_iters = 0 the reported
    r.r is r0's."""
    _, A = dia_pair("poisson16")
    x0 = torch.ones(A.shape[0])
    b = A.apply(x0)
    x, r, it, rr, conv = ir_fused(A.diags, A.offsets, b, x0, None, omega=0.5,
                                  tol_sq_eff=1e-6, max_iters=10)
    assert int(it) == 1 and bool(conv)
    x, r, it, rr, conv = ir_fused(A.diags, A.offsets, b + 1.0, x0, None, omega=0.5,
                                  tol_sq_eff=1e-6, max_iters=0)
    assert int(it) == 0 and float(rr) == A.shape[0] and torch.equal(x, x0)


def test_xla_contracts_multiply_adds():
    """Why the smoother is not held bit for bit: XLA on the CPU evaluates
    x + omega d (and the product's acc + d x) as one fused multiply-add
    (one rounding), the port's plain version and its -fmad=false kernel as
    a product and a sum (two)."""
    rng = np.random.default_rng(0)
    x, d = rng.standard_normal((2, 4096)).astype(np.float32)
    om = np.float32(0.8)
    xla = np.asarray(jax.jit(lambda a, o, v: a + o * v)(x, om, d))
    two = (x + (om * d).astype(np.float32)).astype(np.float32)
    one = (x.astype(np.float64) + np.float64(om) * d.astype(np.float64)).astype(np.float32)
    assert not np.array_equal(xla, two)
    np.testing.assert_array_equal(xla, one)
    port = ir_smooth_reference(torch.zeros(1, 4096), (0,), torch.from_numpy(x),
                               torch.from_numpy(np.zeros(4096, np.float32)), None,
                               omega=0.8, iters=0)
    assert torch.equal(port[1], torch.from_numpy(x))  # r = b - 0 x: no rounding yet


@pytest.mark.parametrize("x0_zero", [True, False])
@pytest.mark.parametrize("with_residual", [True, False])
@pytest.mark.parametrize("iters", [1, 3])
def test_ir_smooth_matches_pallas_kernel(x0_zero, with_residual, iters):
    JA, A = dia_pair("convdiff32_jitter")
    n, R = A.shape[0], JA.diags.shape[1]
    rng = np.random.default_rng(31)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    x0 = None if x0_zero else torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    minv = 1.0 / A.extract_diagonal().values.float()
    jx, jr = ir_vmem_smooth(
        jax_frame(A.diags, R), JA.offsets, jax_frame(b, R),
        None if x0 is None else jax_frame(x0, R), jax_frame(minv, R), omega=0.8,
        iters=iters, with_residual=with_residual, interpret=True,
    )
    x, r = ir_smooth_reference(A.diags, A.offsets, b, x0, minv, omega=0.8, iters=iters,
                               with_residual=with_residual)
    jx = np.asarray(jx).reshape(-1)[:n]
    scale = np.abs(jx).max() + (0.0 if x0 is None else float(x0.abs().max()))
    np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=2 * iters * EPS32 * scale)
    if with_residual:
        jr = np.asarray(jr).reshape(-1)[:n]
        assert torch.equal(r, b - A.apply(x))
        scale_r = float(b.abs().max()) + 10 * np.abs(jx).max()
        np.testing.assert_allclose(r.numpy(), jr, rtol=0,
                                   atol=2 * (iters + 1) * EPS32 * scale_r)
    if x0_zero and iters == 1:
        # from a zero start no arithmetic precedes the first sweep: r0 = b
        _, r0 = ir_smooth_reference(A.diags, A.offsets, b, None, minv, omega=0.8, iters=0,
                                    with_residual=with_residual)
        _, jr0 = ir_vmem_smooth(jax_frame(A.diags, R), JA.offsets, jax_frame(b, R), None,
                                jax_frame(minv, R), omega=0.8, iters=0,
                                with_residual=with_residual, interpret=True)
        assert torch.equal(r0, b)
        np.testing.assert_array_equal(r0.numpy(), np.asarray(jr0).reshape(-1)[:n])


def test_ir_wrappers_take_plain_versions_on_cpu():
    _, A = dia_pair("poisson16")
    b = torch.ones(A.shape[0])
    z = torch.zeros_like(b)
    before = (ir_fused.launches, ir_smooth.launches)
    got = ir_fused(A.diags, A.offsets, b, z, None, omega=0.2, tol_sq_eff=1e-6, max_iters=50)
    want = ir_solve_reference(A.diags, A.offsets, b, z, None, omega=0.2, tol_sq_eff=1e-6,
                              max_iters=50)
    got_s = ir_smooth(A.diags, A.offsets, b, None, None, omega=0.2, iters=3)
    want_s = ir_smooth_reference(A.diags, A.offsets, b, None, None, omega=0.2, iters=3)
    assert (ir_fused.launches, ir_smooth.launches) == before
    for g, w in list(zip(got, want)) + list(zip(got_s, want_s)):
        assert torch.equal(g, w)


# -- the solver against the JAX solver's streaming route ---------------------------


def test_ir_streaming_k3_matches_jax_float64(monkeypatch):
    """k = 3 float64 columns stream in both packages: the same sweeps, stop
    flags, residual norms and x to 1e-10."""
    jd, pd = matrices("convdiff32_jitter")
    JA = JDia.from_matrix_data(jd).astype(jnp.float64)
    A = gt.Dia.from_matrix_data(pd, device="cpu").astype(torch.float64)
    n = A.shape[0]
    js, ps = solver_pair(JIr, gt.Ir, JA, A, ("resnorm", 400, 1e-10), True,
                         relaxation_factor=0.9)
    rng = np.random.default_rng(4)
    b = np.stack([np.ones(n), rng.standard_normal(n), rng.uniform(0, 1, n)], axis=1)
    x0 = np.full((n, 3), 0.1)
    assert ps._try_fused(torch.from_numpy(b), torch.from_numpy(x0)) is None
    jx, jinfo = jax_streaming(js, b, x0, monkeypatch)
    px, pinfo = ps.solve(torch.from_numpy(b), torch.from_numpy(x0))
    assert int(pinfo.iterations) == int(jinfo.iterations)
    np.testing.assert_array_equal(pinfo.converged.numpy(), np.asarray(jinfo.converged))
    assert pinfo.converged.all()
    np.testing.assert_allclose(pinfo.residual_norm.numpy(), np.asarray(jinfo.residual_norm),
                               rtol=1e-6, atol=1e-12 * np.linalg.norm(b, axis=0).max())
    np.testing.assert_allclose(px.numpy(), jx, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("crit", ["resnorm", "iteration"])
def test_ir_fused_route_matches_jax_streaming(crit, monkeypatch):
    """One float32 column through K17's plain version against the JAX
    streaming loop (scalar Jacobi, relaxation 0.9): sweeps one apart, the
    same stop flag, x to 1e-4 relative; the residual norm is sqrt(r.r)
    under a residual criterion, else inf (ginkgo_tpu solver/ir.py:130-133)."""
    JA, A = dia_pair("convdiff32_jitter")
    n = A.shape[0]
    js, ps = solver_pair(JIr, gt.Ir, JA, A, (crit, 300 if crit == "resnorm" else 40, 1e-6),
                         True, relaxation_factor=0.9)
    b = np.random.default_rng(3).standard_normal((n, 1)).astype(np.float32)
    bt = torch.from_numpy(b)
    assert ps._try_fused(bt, torch.zeros(n, 1)) is not None
    jx, jinfo = jax_streaming(js, b, monkeypatch=monkeypatch)
    px, pinfo = ps.solve(bt)
    assert abs(int(pinfo.iterations) - int(jinfo.iterations)) <= 1
    np.testing.assert_array_equal(pinfo.converged.numpy(), np.asarray(jinfo.converged))
    np.testing.assert_allclose(px.numpy(), jx, rtol=0, atol=1e-4 * np.abs(jx).max())
    if crit == "resnorm":
        assert bool(pinfo.converged[0])
        rr = ((bt - A.apply(px)).double() ** 2).sum(dim=0).float().sqrt()
        torch.testing.assert_close(pinfo.residual_norm, rr, rtol=0, atol=0)
    else:
        assert int(pinfo.iterations) == 40 and torch.isinf(pinfo.residual_norm).all()


def test_ir_declined_routes_stream(monkeypatch):
    """The implicit criterion (ir.py:107), k = 2 and a preconditioner that
    is not diagonal stream, on a Dia and on a Pell; each still solves.  One
    column on an S = 8 Pell takes the Pell kernel K21 (the JAX package's
    Pell kernel, solver/ir.py:98-100, 140-180; ported in slice 6)."""
    jd, pd = matrices("tridiag700")
    _, A = dia_pair("tridiag700")
    crit = [stop.Iteration(max_iters=300), stop.ResidualNorm(tolerance=1e-6)]
    jac = gt.Jacobi.build(max_block_size=1)
    b1, b2 = torch.ones(A.shape[0], 1), torch.ones(A.shape[0], 2)
    ok = gt.Ir.build(criteria=crit, preconditioner=jac).generate(A)
    assert ok._try_fused(b1, torch.zeros_like(b1)) is not None
    assert ok._try_fused(b2, torch.zeros_like(b2)) is None
    P = gt.Pell.from_matrix_data(pd, device="cpu")
    sp = gt.Ir.build(criteria=crit, preconditioner=jac).generate(P)
    assert sp._try_fused(b1, torch.zeros_like(b1)) is not None
    assert sp._try_fused(b2, torch.zeros_like(b2)) is None
    spi = gt.Ir.build(criteria=[stop.Iteration(max_iters=30),
                                stop.ImplicitResidualNorm(tolerance=1e-6)],
                      preconditioner=jac).generate(P)
    assert spi._try_fused(b1, torch.zeros_like(b1)) is None
    implicit = [stop.Iteration(max_iters=30), stop.ImplicitResidualNorm(tolerance=1e-6)]
    si = gt.Ir.build(criteria=implicit, preconditioner=jac).generate(A)
    assert si._try_fused(b1, torch.zeros_like(b1)) is None
    general = gt.Composition(operators=(jac.generate(A),))
    sg = gt.Ir.build(criteria=crit, preconditioner=general).generate(A)
    assert sg._try_fused(b1, torch.zeros_like(b1)) is None
    before = ir_fused.launches
    for solver, b in ((sp, b1), (ok, b2), (sg, b1)):
        x, info = solver.solve(b)
        assert x.shape == b.shape and bool(info.converged.all())
    x, info = si.solve(b1)  # IR has no rho: the implicit criterion never fires
    assert int(info.iterations) == 30 and not bool(info.converged.any())
    assert ir_fused.launches == before
    # the JAX package's aliases
    assert gt.Richardson is gt.Ir and ok.solver is ok.preconditioner
    jsolver = JIr.build(criteria=None).generate(JDia.from_matrix_data(jd))
    assert jsolver.solver is jsolver.preconditioner
