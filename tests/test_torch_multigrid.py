"""Slice 8, the multigrid solver's streaming routes: the port's
``solver/multigrid.py`` against the JAX package's generic path on the CPU,
in float64, where neither package takes a fused route (the fused gates
take float32/bfloat16 diagonals and one float32 column).

Both packages build their hierarchies from the same float64 ``Dia``
(``tests/test_torch_pgm.py`` shows the levels identical), then:

- one cycle (``cycle_apply`` from a random x and ``apply`` from zero) for
  V, W and F with the four mid_case values and K with kcycle_rel_tol 0,
  0.25, +inf and nan (the factory's sentinel for +inf): equal to 1e-12 of
  the result's largest entry;
- ``Multigrid.solve``: equal iteration counts, x to 1e-10;
- ``Cg``, ``Fcg`` with a K-cycle, ``Bicgstab`` and ``Gmres`` with a
  multigrid preconditioner: equal iteration counts, x to 1e-10;
- the routes: the fused gate declines float64, and a float32 hierarchy
  with two columns streams.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import ginkgo_tpu as gko
import ginkgo_tpu_torch as gt
from ginkgo_tpu import stop as jstop
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu_torch import stop

NSIDE = 16


def _pair(nside=NSIDE, dtype=np.float64, **kw):
    data = gt.generators.poisson_2d(nside, dtype=dtype)
    jd = JMatrixData.from_coo(data.shape, data.rows, data.cols, data.values)
    JA = gko.matrix.dia.Dia.from_matrix_data(jd)
    A = gt.Dia.from_matrix_data(data, device="cpu")
    kw.setdefault("max_levels", 3)
    kw.setdefault("min_coarse_rows", 16)
    jm = gko.solver.Multigrid.build(**kw).generate(JA)
    pm = gt.Multigrid.build(**kw).generate(A)
    return JA, A, jm, pm


# a V-cycle never takes the mid role, so mid_case varies only W and F
CYCLES = ([("v", "standalone", 0.25)]
          + [(c, m, 0.25) for c in "wf"
             for m in ("standalone", "both", "pre_smoother", "post_smoother")]
          + [("k", "standalone", rt) for rt in (0.0, 0.25, float("inf"), float("nan"))])


@pytest.mark.parametrize("cycle,mid_case,rel_tol", CYCLES)
def test_cycle_matches_jax_f64(cycle, mid_case, rel_tol):
    _, A, jm, pm = _pair(cycle=cycle, mid_case=mid_case, kcycle_rel_tol=rel_tol,
                         smoother_iters=2)
    assert pm._fused_hierarchy() is None  # float64: the streaming cycle
    rng = np.random.default_rng(7)
    b = rng.uniform(0.5, 1.5, (A.shape[0], 1))
    x0 = rng.standard_normal((A.shape[0], 1))
    # one compiled cycle serves both: JAX's apply is the cycle from zeros
    jcycle = jax.jit(lambda b, x: jm.cycle_apply(b, x))
    jy = np.asarray(jcycle(jnp.asarray(b), jnp.asarray(x0)))
    y = pm.cycle_apply(torch.from_numpy(b), torch.from_numpy(x0)).numpy()
    np.testing.assert_allclose(y, jy, rtol=0, atol=1e-12 * np.abs(jy).max())
    jz = np.asarray(jcycle(jnp.asarray(b), jnp.zeros_like(jnp.asarray(b))))[:, 0]
    z = pm.apply(torch.from_numpy(b[:, 0])).numpy()
    np.testing.assert_allclose(z, jz, rtol=0, atol=1e-12 * np.abs(jz).max())


@pytest.mark.parametrize("cycle", ["v", "k"])
def test_solve_matches_jax_f64(cycle):
    crit = dict(max_iters=60, tol=1e-8)
    _, A, jm, pm = _pair(cycle=cycle)
    jm = jm.replace(criterion=jstop.combine(
        [jstop.Iteration(max_iters=crit["max_iters"]), jstop.ResidualNorm(tolerance=crit["tol"])]))
    pm = pm.replace(criterion=stop.combine(
        [stop.Iteration(max_iters=crit["max_iters"]), stop.ResidualNorm(tolerance=crit["tol"])]))
    b = np.ones(A.shape[0])
    jx, jinfo = jm.solve(jnp.asarray(b))
    x, info = pm.solve(torch.from_numpy(b))
    assert int(info.iterations) == int(jinfo.iterations)
    assert bool(info.converged.all()) == bool(np.asarray(jinfo.converged).all())
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-10)
    np.testing.assert_allclose(info.residual_norm.numpy(), np.asarray(jinfo.residual_norm),
                               rtol=0, atol=1e-12)


KRYLOV = [("Cg", "v"), ("Fcg", "k"), ("Bicgstab", "v"), ("Gmres", "v")]


@pytest.mark.parametrize("solver,cycle", KRYLOV)
def test_mg_preconditioned_krylov_matches_jax_f64(solver, cycle):
    JA, A, jm, pm = _pair(cycle=cycle)
    jc = [jstop.Iteration(max_iters=100), jstop.ResidualNorm(tolerance=1e-10)]
    pc = [stop.Iteration(max_iters=100), stop.ResidualNorm(tolerance=1e-10)]
    b = np.random.default_rng(4).uniform(0.5, 1.5, A.shape[0])
    js = getattr(gko.solver, solver).build(criteria=jc, preconditioner=jm).generate(JA)
    ps = getattr(gt, solver).build(criteria=pc, preconditioner=pm).generate(A)
    jx, jinfo = js.solve(jnp.asarray(b))
    x, info = ps.solve(torch.from_numpy(b))
    assert bool(info.converged.all()) and bool(np.asarray(jinfo.converged).all())
    assert int(info.iterations) == int(jinfo.iterations)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-10)
    plain = getattr(gt, solver).build(criteria=pc).generate(A).solve(torch.from_numpy(b))[1]
    assert int(info.iterations) < int(plain.iterations)


def test_fused_gate_declines_k_columns_and_float64():
    _, A, _, pm = _pair()
    assert pm._fused_hierarchy() is None
    A32 = A.astype(torch.float32)
    pm32 = gt.Multigrid.build(max_levels=4, min_coarse_rows=16).generate(A32)
    assert pm32._fused_hierarchy() is not None
    B = torch.ones(A.shape[0], 2)
    assert pm32._try_fused_vcycle(B, None) is None  # two columns stream
    assert pm32._try_fused_vcycle(B[:, :1], None) is not None
    Y = pm32.apply(B)
    y0 = pm32.apply(B[:, 0])
    np.testing.assert_allclose(Y[:, 0].numpy(), y0.numpy(), rtol=1e-4,
                               atol=1e-5 * float(y0.abs().max()))


def test_fixed_smoother_kernel_route_matches_loop():
    """One float32 column on a Dia takes K17's ir_smooth (its plain version
    here); two columns the tensor loop: equal to rounding, and
    solve_with_residual's r is b - A x."""
    from ginkgo_tpu_torch.solver.multigrid import _fixed_smoother

    A = gt.Dia.from_matrix_data(gt.generators.poisson_2d(12, dtype=np.float32), device="cpu")
    sm = _fixed_smoother(A, iters=3, relax=0.8)
    rng = np.random.default_rng(2)
    B = torch.as_tensor(rng.uniform(0.5, 1.5, (A.shape[0], 2)).astype(np.float32))
    X0 = torch.as_tensor(rng.standard_normal((A.shape[0], 2)).astype(np.float32))
    assert sm._kernel_ok(B[:, :1]) and not sm._kernel_ok(B)
    for x0 in (None, X0):
        Xl = sm.solve(B, x0=x0)[0]
        x1 = sm.solve(B[:, 0], x0=None if x0 is None else x0[:, 0])[0]
        np.testing.assert_allclose(x1.numpy(), Xl[:, 0].numpy(), rtol=1e-5, atol=1e-5)
        x, r = sm.solve_with_residual(B[:, :1], x0=None if x0 is None else x0[:, :1])
        np.testing.assert_allclose(r.numpy(), (B[:, :1] - A.apply(x)).numpy(), rtol=0,
                                   atol=1e-5)


def test_cpu_multigrid_launches_no_kernel():
    """Every multigrid route on CPU tensors takes its plain version."""
    from ginkgo_tpu_torch.ops import dia, ir, mg

    A = gt.Dia.from_matrix_data(gt.generators.poisson_2d(16, dtype=np.float32), device="cpu")
    M = gt.Multigrid.build(max_levels=3, min_coarse_rows=16).generate(A)
    b = torch.ones(A.shape[0])
    crit = [stop.Iteration(max_iters=50), stop.ResidualNorm(tolerance=1e-6)]
    for cls in (gt.Cg, gt.Bicgstab):
        assert bool(cls.build(criteria=crit, preconditioner=M).generate(A).solve(b)[1]
                    .converged.all())
    gt.Gmres.build(criteria=crit, preconditioner=M).generate(A).solve(b)
    M.solve(b)
    M.replace(coarse_dense_inv=None).apply(b)
    assert [f.launches for f in (mg.mg_vcycle, mg.mg_cg_fused, mg.mg_solve_fused,
                                 mg.mg_bicgstab_fused, ir.ir_smooth, dia.dia_spmv)] == [0] * 6
