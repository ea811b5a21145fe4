"""Slice 1 end to end: Poisson MatrixData -> Dia -> Cg/Fcg(...).solve(b), the
port (ginkgo_tpu_torch) against the JAX package (ginkgo_tpu) on the CPU.

- Fused route: JAX with GINKGO_TPU_FORCE_VMEM_CG=1 runs the whole-solve
  Pallas kernel in interpret mode; the port's gate accepts the same solves
  and runs K4's plain version.  float32; equal iterations; x to float32
  round-off (tolerances of tests/test_pallas_cg.py).
- Streaming route: JAX with GINKGO_TPU_NO_PALLAS=1 runs its
  lax.while_loop; the port runs Cg._solve_streaming.  float64 at rtol
  1e-10 and float32 as above, equal iterations, k-column stop masks equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu import stop as jstop
from ginkgo_tpu.matrix.dia import Dia as JDia
from ginkgo_tpu.preconditioner.jacobi import Jacobi as JJacobi
from ginkgo_tpu.solver.cg import Cg as JCg, Fcg as JFcg
from ginkgo_tpu.utils import generators as jgen
from ginkgo_tpu_torch import interop, stop

SOLVERS = {"cg": (JCg, gt.Cg), "fcg": (JFcg, gt.Fcg)}


def _problem(nside, dtype, shifted=False):
    data = jgen.poisson_2d(nside, dtype=dtype)
    if shifted:  # SPD with a non-constant diagonal, so Jacobi matters
        vals = data.values.copy()
        diag = data.rows == data.cols
        vals[diag] += np.random.default_rng(11).uniform(0, 2, int(diag.sum())).astype(dtype)
        data = type(data)(data.shape, data.rows, data.cols, vals)
    port_data = interop.matrix_data_from_arrays(data.shape, data.rows, data.cols, data.values)
    return data, JDia.from_matrix_data(data), gt.Dia.from_matrix_data(port_data, device="cpu")


def _criteria(kind, max_iters, tol):
    """The same criteria list in both packages."""
    if kind == "resnorm":
        return ([jstop.Iteration(max_iters=max_iters), jstop.ResidualNorm(tolerance=tol)],
                [stop.Iteration(max_iters=max_iters), stop.ResidualNorm(tolerance=tol)])
    if kind == "initial":
        return ([jstop.Iteration(max_iters=max_iters),
                 jstop.ResidualNorm(tolerance=tol, baseline="initial_resnorm")],
                [stop.Iteration(max_iters=max_iters),
                 stop.ResidualNorm(tolerance=tol, baseline="initial_resnorm")])
    if kind == "implicit":
        return ([jstop.Iteration(max_iters=max_iters), jstop.ImplicitResidualNorm(tolerance=tol)],
                [stop.Iteration(max_iters=max_iters), stop.ImplicitResidualNorm(tolerance=tol)])
    return ([jstop.Iteration(max_iters=max_iters)], [stop.Iteration(max_iters=max_iters)])


def _solvers(solver, JA, A, crit_kind, max_iters, tol, jacobi, **params):
    JS, PS = SOLVERS[solver]
    jc, pc = _criteria(crit_kind, max_iters, tol)
    jpre = JJacobi.build(max_block_size=1) if jacobi else None
    ppre = gt.Jacobi.build(max_block_size=1) if jacobi else None
    return (JS.build(criteria=jc, preconditioner=jpre, **params).generate(JA),
            PS.build(criteria=pc, preconditioner=ppre, **params).generate(A))


def _assert_info(pinfo, jinfo, rtol, atol=0.0):
    assert int(pinfo.iterations) == int(jinfo.iterations)
    np.testing.assert_array_equal(pinfo.converged.numpy(), np.asarray(jinfo.converged))
    np.testing.assert_allclose(
        pinfo.residual_norm.numpy(), np.asarray(jinfo.residual_norm),
        rtol=rtol, atol=atol,
    )


FUSED_CASES = [
    # (solver, crit, jacobi, storage, nside)
    ("cg", "resnorm", False, "f32", 16),
    ("cg", "resnorm", True, "f32", 16),
    ("cg", "implicit", False, "f32", 16),
    ("cg", "initial", True, "f32", 48),
    ("cg", "iteration", False, "f32", 16),
    ("cg", "resnorm", False, "bf16", 16),
    ("fcg", "resnorm", False, "f32", 16),
    ("fcg", "resnorm", True, "f32", 16),
]


@pytest.mark.parametrize("solver,crit,jacobi,storage,nside", FUSED_CASES)
def test_fused_route_matches_jax(solver, crit, jacobi, storage, nside, monkeypatch):
    data, JA, A = _problem(nside, np.float32, shifted=jacobi)
    if storage == "bf16":
        JA, A = JA.reduce_storage(), A.reduce_storage()
    n = data.shape[0]
    js, ps = _solvers(solver, JA, A, crit, 30 if crit == "iteration" else 500, 1e-6, jacobi)
    b = np.ones((n, 1), np.float32)
    monkeypatch.setenv("GINKGO_TPU_FORCE_VMEM_CG", "1")
    jx, jinfo = js.solve(jnp.asarray(b))
    assert gt.solver._fused_gate.prepare_fused_dia(ps, torch.from_numpy(b)) is not None
    px, pinfo = ps.solve(torch.from_numpy(b))
    assert px.dtype == torch.float32 and px.shape == (n, 1)
    _assert_info(pinfo, jinfo, rtol=1e-3)
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=2e-6, atol=2e-5)


STREAMING_CASES = [
    # (solver, crit, jacobi, dtype)
    ("cg", "resnorm", False, np.float64),
    ("cg", "resnorm", True, np.float64),
    ("cg", "implicit", True, np.float64),
    ("cg", "iteration", False, np.float64),
    ("fcg", "resnorm", True, np.float64),
    ("cg", "resnorm", False, np.float32),
    ("cg", "resnorm", True, np.float32),
    ("fcg", "initial", False, np.float32),
]


@pytest.mark.parametrize("solver,crit,jacobi,dtype", STREAMING_CASES)
def test_streaming_route_matches_jax(solver, crit, jacobi, dtype, monkeypatch):
    monkeypatch.setenv("GINKGO_TPU_NO_PALLAS", "1")
    data, JA, A = _problem(16, dtype, shifted=jacobi)
    n = data.shape[0]
    tol = 1e-10 if dtype == np.float64 else 1e-6
    js, ps = _solvers(solver, JA, A, crit, 40 if crit == "iteration" else 500, tol, jacobi)
    b = np.random.default_rng(3).standard_normal((n, 1)).astype(dtype)
    x0 = np.full((n, 1), 0.25, dtype)
    jx, jinfo = js.solve(jnp.asarray(b), jnp.asarray(x0))
    px, pinfo = ps._solve_streaming(torch.from_numpy(b), torch.from_numpy(x0))
    if dtype == np.float64:
        _assert_info(pinfo, jinfo, rtol=1e-10)
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-10, atol=1e-12)
    else:
        _assert_info(pinfo, jinfo, rtol=1e-3)
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=2e-6, atol=2e-5)


@pytest.mark.parametrize("solver", ["cg", "fcg"])
def test_multi_rhs_column_masks_match_jax(solver, monkeypatch):
    """k = 3 columns: one eigenvector (converges in one iteration and is
    frozen), ones and random (not converged at the cap)."""
    monkeypatch.setenv("GINKGO_TPU_NO_PALLAS", "1")
    nside = 16
    data, JA, A = _problem(nside, np.float64)
    n = data.shape[0]
    i = np.arange(nside) + 1
    eig = np.outer(np.sin(np.pi * i / (nside + 1)), np.sin(2 * np.pi * i / (nside + 1)))
    rng = np.random.default_rng(5)
    b = np.stack([np.ones(n), rng.standard_normal(n), eig.reshape(-1)], axis=1)
    js, ps = _solvers(solver, JA, A, "resnorm", 20, 1e-8, False)
    jx, jinfo = js.solve(jnp.asarray(b))
    px, pinfo = ps.solve(torch.from_numpy(b))
    # the frozen column's residual is at float64 round-off (~4e-14)
    _assert_info(pinfo, jinfo, rtol=1e-10, atol=1e-15)
    np.testing.assert_array_equal(pinfo.converged.numpy(), [False, False, True])
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-10, atol=1e-12)


def test_history_matches_jax(monkeypatch):
    monkeypatch.setenv("GINKGO_TPU_NO_PALLAS", "1")
    data, JA, A = _problem(16, np.float64)
    js, ps = _solvers("cg", JA, A, "resnorm", 60, 1e-9, True, track_history=True)
    b = np.ones((data.shape[0], 1))
    jx, jinfo = js.solve(jnp.asarray(b))
    px, pinfo = ps.solve(torch.from_numpy(b))
    _assert_info(pinfo, jinfo, rtol=1e-10)
    np.testing.assert_allclose(pinfo.history.numpy(), np.asarray(jinfo.history), rtol=1e-10)


def test_entry_pipeline_matches_jax(monkeypatch):
    """The user's path, 1-D right-hand side in and out: generators ->
    Dia.from_matrix_data -> Cg.build(...).generate(A).solve(b)."""
    monkeypatch.setenv("GINKGO_TPU_FORCE_VMEM_CG", "1")
    data = gt.generators.poisson_2d(16, dtype=np.float32)
    A = gt.Dia.from_matrix_data(data, device="cpu")
    crit = [stop.Iteration(max_iters=500), stop.ResidualNorm(tolerance=1e-6)]
    x, info = gt.Cg.build(criteria=crit).generate(A).solve(torch.ones(A.shape[0]))
    JA = JDia.from_matrix_data(jgen.poisson_2d(16, dtype=np.float32))
    jx, jinfo = JCg.build(
        criteria=[jstop.Iteration(max_iters=500), jstop.ResidualNorm(tolerance=1e-6)]
    ).generate(JA).solve(jnp.ones(JA.shape[0], jnp.float32))
    assert x.shape == (A.shape[0],)
    _assert_info(info, jinfo, rtol=1e-3)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=2e-6, atol=2e-5)
    res = torch.ones(A.shape[0]) - A.apply(x)
    assert float(res.norm()) <= 1e-5 * float(np.sqrt(A.shape[0]))


def test_jacobi_from_jax_arrays_matches_generated():
    data, JA, A = _problem(16, np.float32, shifted=True)
    jj = JJacobi.build(max_block_size=1).generate(JA)
    pj = gt.Jacobi.build(max_block_size=1).generate(A)
    carried = interop.jacobi_from_arrays(np.asarray(jj.inv_diag), device="cpu")
    assert torch.equal(carried.inv_diag, pj.inv_diag)
    # block Jacobi (slice 10): the JAX package's stored blocks, carried
    # across, apply as the generated ones do
    jb = JJacobi.build(max_block_size=4).generate(JA)
    pb = gt.Jacobi.build(max_block_size=4).generate(A)
    carried = interop.jacobi_from_arrays(
        device="cpu", inv_blocks=np.asarray(jb.inv_blocks), block_scales=np.asarray(jb.block_scales),
        row_block=np.asarray(jb.row_block), row_local=np.asarray(jb.row_local),
        block_starts=np.asarray(jb.block_starts), n=jb.n, max_block_size=4)
    assert torch.equal(carried.block_starts, pb.block_starts)
    b = torch.ones(A.shape[0])
    torch.testing.assert_close(carried.apply(b), pb.apply(b), rtol=1e-6, atol=1e-6)


def test_gate_declines_what_the_kernel_does_not_take():
    """Multi-column, float64, history and custom-criterion solves stream."""
    from ginkgo_tpu_torch.solver._fused_gate import prepare_fused_dia

    _, _, A = _problem(8, np.float32)
    n = A.shape[0]
    crit = [stop.Iteration(max_iters=5), stop.ResidualNorm(tolerance=1e-6)]
    s = gt.Cg.build(criteria=crit).generate(A)
    assert prepare_fused_dia(s, torch.ones(n, 1)) is not None
    assert prepare_fused_dia(s, torch.ones(n, 2)) is None
    assert prepare_fused_dia(s, torch.ones(n, 1, dtype=torch.float64)) is None
    hist = gt.Cg.build(criteria=crit, track_history=True).generate(A)
    assert prepare_fused_dia(hist, torch.ones(n, 1)) is None

    class Weird(stop.Criterion):
        def check(self, ctx):
            return torch.zeros(ctx["num_cols"], dtype=torch.bool)

    weird = gt.Cg.build(criteria=[stop.Iteration(max_iters=5), Weird()]).generate(A)
    assert prepare_fused_dia(weird, torch.ones(n, 1)) is None
    dense = gt.Cg.build(criteria=crit).generate(A.to_dense())
    assert prepare_fused_dia(dense, torch.ones(n, 1)) is None


# -- the base layer the slice runs through ---------------------------------------


def test_matrix_data_matches_jax():
    """from_coo / sum_duplicates / sort_row_major / to_dense / transpose on
    unsorted triples with duplicates, and the device stage."""
    from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData

    rng = np.random.default_rng(9)
    rows = rng.integers(0, 30, 200)
    cols = rng.integers(0, 40, 200)
    vals = rng.standard_normal(200)
    jd = JMatrixData.from_coo((30, 40), rows, cols, vals)
    pd = interop.matrix_data_from_arrays((30, 40), rows, cols, vals)
    for jm, pm in ((jd.sum_duplicates(), pd.sum_duplicates()),
                   (jd.sort_row_major(), pd.sort_row_major()),
                   (jd.transpose().sum_duplicates(), pd.transpose().sum_duplicates())):
        assert jm.shape == pm.shape
        for f in ("rows", "cols", "values"):
            np.testing.assert_array_equal(getattr(pm, f), getattr(jm, f))
    np.testing.assert_array_equal(pd.to_dense(), jd.to_dense())
    dev = pd.to_device(device="cpu")
    back = dev.sort_row_major().to_host()
    ref = jd.to_device().sort_row_major()
    assert dev.nnz == int(ref.nnz) and dev.rows.dtype == torch.int32
    for f in ("rows", "cols", "values"):
        np.testing.assert_array_equal(getattr(back, f), np.asarray(getattr(ref, f)))


def test_dense_and_diagonal_match_jax():
    from ginkgo_tpu.matrix.dense import Dense as JDense
    from ginkgo_tpu.matrix.diagonal import Diagonal as JDiagonal

    rng = np.random.default_rng(10)
    M = rng.standard_normal((12, 12))
    X = rng.standard_normal((12, 3))
    Y = rng.standard_normal((12, 3))
    jD, pD = JDense.create(M), gt.Dense.create(M, device="cpu")
    t = torch.from_numpy
    # dense products sum in another order: float64 round-off on values ~1
    np.testing.assert_allclose(
        pD.apply(t(X)).numpy(), np.asarray(jD.apply(X)), rtol=1e-12, atol=1e-14
    )
    np.testing.assert_allclose(
        pD.apply_advanced(0.3, t(X), -1.7, t(Y)).numpy(),
        np.asarray(jD.apply_advanced(0.3, X, -1.7, Y)), rtol=1e-12, atol=1e-14,
    )
    jX, pX = JDense.create(X), gt.Dense.create(X, device="cpu")
    np.testing.assert_allclose(pX.compute_norm2().numpy(), np.asarray(jX.compute_norm2()), rtol=1e-12)
    np.testing.assert_allclose(pX.compute_dot(t(Y)).numpy(), np.asarray(jX.compute_dot(Y)), rtol=1e-12)
    np.testing.assert_allclose(
        pX.add_scaled(np.array([1.0, -1.0, 2.0]), t(Y)).values.numpy(),
        np.asarray(jX.add_scaled(np.array([1.0, -1.0, 2.0]), Y).values), rtol=1e-12,
    )
    d = rng.uniform(1, 2, 12)
    jG, pG = JDiagonal.create(d), gt.Diagonal.create(d, device="cpu")
    np.testing.assert_array_equal(pG.apply(t(X)).numpy(), np.asarray(jG.apply(X)))
    np.testing.assert_array_equal(pG.inverse_apply(t(X)).numpy(), np.asarray(jG.inverse_apply(X)))
    np.testing.assert_array_equal(pD.extract_diagonal().values.numpy(), np.diag(M))


def test_linop_compositions_match_jax(monkeypatch):
    from ginkgo_tpu.base.linop import Combination, Composition, Perturbation

    monkeypatch.setenv("GINKGO_TPU_NO_PALLAS", "1")
    data, JA, A = _problem(8, np.float64)
    n = data.shape[0]
    rng = np.random.default_rng(12)
    x = rng.standard_normal((n, 2))
    basis = rng.standard_normal((n, 2))
    proj = rng.standard_normal((2, n))
    t = torch.from_numpy
    pairs = [
        (Combination(coefficients=(2.0, -0.5), operators=(JA, JA)),
         gt.Combination(coefficients=(2.0, -0.5), operators=(A, A))),
        (Composition(operators=(JA, JA)), gt.Composition(operators=(A, A))),
        (Perturbation(scalar=0.3, basis=jnp.asarray(basis), projector=jnp.asarray(proj)),
         gt.Perturbation(scalar=0.3, basis=t(basis), projector=t(proj))),
    ]
    for jop, pop in pairs:
        assert pop.shape == jop.shape
        np.testing.assert_allclose(
            pop.apply(t(x)).numpy(), np.asarray(jop.apply(jnp.asarray(x))), rtol=1e-12
        )
