"""K4m (k-RHS whole-solve CG/FCG on a Dia) against the JAX package on the
CPU.

- K4m's plain version (ops/cg.cg_multi_solve_reference) against the JAX
  kernel cg_vmem_solve_multi in Pallas interpret mode, on the JAX Dia's own
  diagonals: per-column iteration counts, stop flags and the total count
  equal; x to float32 round-off (rtol 2e-6, atol 2e-5, the tolerances of
  tests/test_pallas_cg.py: the JAX kernel sums its dot products in float32
  chunks, the port in float64).
- Cg/Fcg with 2 to 8 float32 columns on a Dia route to K4m, as the JAX
  solvers do with GINKGO_TPU_FORCE_VMEM_CG=1.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu import stop as jstop
from ginkgo_tpu.matrix.dia import Dia as JDia
from ginkgo_tpu.ops.pallas_cg import cg_vmem_solve_multi
from ginkgo_tpu.preconditioner.jacobi import Jacobi as JJacobi
from ginkgo_tpu.solver.cg import Cg as JCg, Fcg as JFcg
from ginkgo_tpu.utils import generators as jgen
from ginkgo_tpu_torch import interop, stop
from ginkgo_tpu_torch.ops.cg import cg_fused, cg_fused_multi, cg_multi_solve_reference
from ginkgo_tpu_torch.solver._fused_gate import prepare_fused_dia

LANES = 128
NSIDE = 16


def _operator(shifted):
    data = jgen.poisson_2d(NSIDE, dtype=np.float32)
    if shifted:
        vals = data.values.copy()
        diag = data.rows == data.cols
        vals[diag] += np.random.default_rng(11).uniform(0, 2, int(diag.sum())).astype(np.float32)
        data = type(data)(data.shape, data.rows, data.cols, vals)
    JA = JDia.from_matrix_data(data)
    A = interop.dia_from_arrays(np.asarray(JA.diags), JA.offsets, JA.shape, device="cpu")
    return data, JA, A


def _columns(n, k, rng):
    """ones, random, the (1, 2) Laplacian eigenvector (CG stops it after
    one iteration, so its column freezes), then more random columns."""
    i = np.arange(NSIDE) + 1
    eig = np.outer(np.sin(np.pi * i / (NSIDE + 1)), np.sin(2 * np.pi * i / (NSIDE + 1)))
    cols = [np.ones(n), rng.standard_normal(n), eig.reshape(-1)]
    cols += [rng.standard_normal(n) for _ in range(k - 3)]
    return np.stack(cols[:k], axis=1).astype(np.float32)


def _frames(V, R):
    """(n, k) -> (k, R, 128) zero-padded frames."""
    out = np.zeros((V.shape[1], R * LANES), np.float32)
    out[:, : V.shape[0]] = V.T
    return jnp.asarray(out.reshape(V.shape[1], R, LANES))


CASES = {
    # name: (k, max_iters, tol mode, implicit, flexible, jacobi, x0 value)
    "resnorm_k3": (3, 500, "rel", False, False, False, 0.0),
    "implicit_k3": (3, 500, "rel", True, False, False, 0.0),
    "flexible_jacobi_k4": (4, 500, "rel", False, True, True, 0.0),
    "initial_guess_k2": (2, 500, "rel", False, False, False, 0.5),
    "iteration_only_k5": (5, 20, "negative", False, False, False, 0.0),
    "mixed_thresholds_k3": (3, 60, "mixed", False, False, False, 0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cg_multi_reference_matches_pallas(case):
    k, max_iters, tol_mode, implicit, flexible, jacobi, x0v = CASES[case]
    data, JA, A = _operator(shifted=jacobi)
    n = data.shape[0]
    R = JA.diags.shape[1]
    rng = np.random.default_rng(7)
    Ad = data.to_dense().astype(np.float64)
    B = _columns(n, k, rng)
    X0 = np.full((n, k), x0v, np.float32)
    R0 = (B - Ad @ X0).astype(np.float32)
    bn = np.linalg.norm(B, axis=0)
    if tol_mode == "rel":
        tol_sq = (1e-6 * bn) ** 2
    elif tol_mode == "negative":
        tol_sq = np.full(k, -1.0)
    else:  # column 0 stops early, column 1 runs to the cap, column 2 stops at once
        tol_sq = np.array([(1e-2 * bn[0]) ** 2, -1.0, (1e-5 * bn[2]) ** 2])
    tol_sq = tol_sq.astype(np.float32)
    minv = (1.0 / np.diag(Ad)).astype(np.float32) if jacobi else None
    jx, jit_, jmon, jconv, jitc = cg_vmem_solve_multi(
        JA.diags, JA.offsets, _frames(R0, R), _frames(X0, R),
        None if minv is None else _frames(minv[:, None], R)[0],
        tol_sq_eff=tol_sq, max_iters=max_iters, use_implicit=implicit,
        flexible=flexible, interpret=True,
    )
    t = torch.from_numpy
    x, r, it, mon, conv, itc = cg_multi_solve_reference(
        A.diags, A.offsets, t(R0), t(X0), None if minv is None else t(minv),
        tol_sq_eff=t(tol_sq), max_iters=max_iters, use_implicit=implicit, flexible=flexible,
    )
    assert x.shape == (n, k) and itc.dtype == torch.int32
    assert int(it) == int(jit_)
    np.testing.assert_array_equal(itc.numpy(), np.asarray(jitc))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(jconv))
    jx = np.asarray(jx).reshape(k, -1)[:, :n].T
    np.testing.assert_allclose(x.numpy(), jx, rtol=2e-6, atol=2e-5)
    if tol_mode == "rel" and k >= 3 and not (implicit or jacobi or x0v):
        assert int(itc[2]) == 1  # the eigenvector column froze after one step
        assert int(it) > 1
    if tol_mode == "negative":
        assert int(it) == max_iters and not conv.any()
    if tol_mode == "mixed":
        assert int(itc[1]) == max_iters and int(itc[0]) < max_iters
    # every column's r is the recurrence residual of its own x
    np.testing.assert_allclose(r.numpy(), (B - Ad @ x.double().numpy()).astype(np.float32), atol=1e-4)


def test_frozen_column_keeps_its_x():
    """After a column stops, its x and p freeze: a run with a larger cap
    leaves the stopped column's x bit for bit unchanged."""
    data, JA, A = _operator(shifted=False)
    n = data.shape[0]
    B = torch.from_numpy(_columns(n, 3, np.random.default_rng(2)))
    tol = (1e-6 * B.norm(dim=0)) ** 2
    short = cg_multi_solve_reference(A.diags, A.offsets, B, torch.zeros_like(B),
                                     tol_sq_eff=tol, max_iters=5)
    long = cg_multi_solve_reference(A.diags, A.offsets, B, torch.zeros_like(B),
                                    tol_sq_eff=tol, max_iters=50)
    assert int(short[5][2]) == int(long[5][2]) == 1
    assert torch.equal(short[0][:, 2], long[0][:, 2])
    assert not torch.equal(short[0][:, 0], long[0][:, 0])


def test_cg_fused_multi_wrapper_takes_plain_version_on_cpu():
    data, JA, A = _operator(shifted=False)
    n = data.shape[0]
    B = torch.ones(n, 4)
    before = (cg_fused_multi.launches, cg_fused.launches)
    got = cg_fused_multi(A.diags, A.offsets, B, torch.zeros(n, 4), None,
                         tol_sq_eff=1e-10, max_iters=100)
    want = cg_multi_solve_reference(A.diags, A.offsets, B, torch.zeros(n, 4), None,
                                    tol_sq_eff=1e-10, max_iters=100)
    assert (cg_fused_multi.launches, cg_fused.launches) == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("solver,jacobi,k", [("cg", False, 3), ("cg", True, 8), ("fcg", True, 2)])
def test_multi_column_solves_route_to_k4m_as_in_jax(solver, jacobi, k, monkeypatch):
    data, JA, A = _operator(shifted=jacobi)
    n = data.shape[0]
    B = _columns(n, k, np.random.default_rng(5))
    JS, PS = {"cg": (JCg, gt.Cg), "fcg": (JFcg, gt.Fcg)}[solver]
    jcrit = [jstop.Iteration(max_iters=500), jstop.ResidualNorm(tolerance=1e-6)]
    pcrit = [stop.Iteration(max_iters=500), stop.ResidualNorm(tolerance=1e-6)]
    js = JS.build(criteria=jcrit, preconditioner=JJacobi.build() if jacobi else None).generate(JA)
    ps = PS.build(criteria=pcrit, preconditioner=gt.Jacobi.build() if jacobi else None).generate(A)
    monkeypatch.setenv("GINKGO_TPU_FORCE_VMEM_CG", "1")
    jx, jinfo = js.solve(jnp.asarray(B))
    assert prepare_fused_dia(ps, torch.from_numpy(B), max_cols=8) is not None
    px, pinfo = ps.solve(torch.from_numpy(B))
    assert int(pinfo.iterations) == int(jinfo.iterations)
    np.testing.assert_array_equal(pinfo.converged.numpy(), np.asarray(jinfo.converged))
    np.testing.assert_allclose(pinfo.residual_norm.numpy(), np.asarray(jinfo.residual_norm),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=2e-6, atol=2e-5)


def test_multi_gate_caps_the_columns():
    _, _, A = _operator(shifted=False)
    n = A.shape[0]
    s = gt.Cg.build(criteria=[stop.Iteration(max_iters=5)]).generate(A)
    assert prepare_fused_dia(s, torch.ones(n, 8), max_cols=8) is not None
    assert prepare_fused_dia(s, torch.ones(n, 9), max_cols=8) is None
    assert prepare_fused_dia(s, torch.ones(n, 2)) is None  # one column by default
    X, info = s.solve(torch.ones(n, 9))  # nine columns stream through K3
    assert X.shape == (n, 9) and int(info.iterations) == 5
