"""K7 (whole-solve CG/FCG on a Pell) and slice 2 end to end, the port
against the JAX package on the CPU.

- K7's plain version (ops/pell_cg.pell_cg_solve_reference) against the
  JAX whole-solve kernel pell_cg_vmem_solve in Pallas interpret mode, on the
  JAX Pell's own arrays (carried across by interop.pell_from_arrays).  The
  JAX kernel sums its dot products in float32, the port in float64, so the
  iteration counts may differ by one; where they are equal x agrees to
  float32 round-off (rtol 2e-6, atol 2e-5, as tests/test_pallas_cg.py).
- Cg/Fcg on a Pell against the JAX solvers with GINKGO_TPU_FORCE_VMEM_CG=1
  (both take their fused routes), and the whole user path
  MatrixData -> Csr -> Pell -> Cg, float64 streaming at 1e-10.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu import stop as jstop
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.matrix.csr import Csr as JCsr
from ginkgo_tpu.matrix.pell import Pell as JPell
from ginkgo_tpu.ops.pallas_pell_cg import pell_cg_vmem_solve
from ginkgo_tpu.preconditioner.jacobi import Jacobi as JJacobi
from ginkgo_tpu.solver.cg import Cg as JCg, Fcg as JFcg
from ginkgo_tpu_torch import interop, stop
from ginkgo_tpu_torch.ops.pell_cg import pell_cg_fused, pell_cg_solve_reference
from ginkgo_tpu_torch.solver._fused_gate import prepare_fused_pell

LANES = 128


def _shifted_poisson_3d(nside, dtype=np.float32, seed=7):
    """3-D Poisson with a random positive diagonal shift: SPD, with a
    non-constant diagonal so Jacobi is not a scalar multiple of I."""
    data = gt.generators.poisson_3d(nside, dtype=dtype)
    diag = data.rows == data.cols
    vals = data.values.copy()
    vals[diag] += np.random.default_rng(seed).uniform(0.0, 2.0, int(diag.sum())).astype(dtype)
    return type(data)(data.shape, data.rows, data.cols, vals)


def _pells(data, storage="f32", S=8):
    """The JAX Pell and the port's, on the same arrays."""
    JA = JCsr.from_matrix_data(JMatrixData.from_coo(data.shape, data.rows, data.cols, data.values))
    JP = JPell.from_csr(JA, S=S)
    if storage == "bf16":
        JP = JP.reduce_storage()
    P = interop.pell_from_arrays(
        np.asarray(JP.values), np.asarray(JP.qidx), np.asarray(JP.bases),
        np.asarray(JP.tile_of_step), shape=JP.shape, n_steps=JP.n_steps, nnz=JP.nnz,
        G=JP.G, NT=JP.NT, NP=JP.NP, S=JP.S, device="cpu")
    return JP, P


def _frame(v, Rf):
    out = np.zeros(Rf * LANES, np.float32)
    out[: v.shape[0]] = v
    return jnp.asarray(out.reshape(Rf, LANES))


CASES = {
    # name: (max_iters, tol mode, implicit, flexible, jacobi, x0 value, storage)
    "cg_resnorm": (500, "rel", False, False, False, 0.0, "f32"),
    "cg_jacobi": (500, "rel", False, False, True, 0.0, "f32"),
    "cg_implicit": (500, "rel", True, False, False, 0.0, "f32"),
    "cg_initial_guess": (500, "rel", False, False, True, 0.5, "f32"),
    "fcg_jacobi": (500, "rel", False, True, True, 0.0, "f32"),
    "fcg_bf16_jacobi_implicit": (500, "rel", True, True, True, 0.0, "bf16"),
    "cg_bf16_initial_guess": (500, "rel", False, False, False, 0.5, "bf16"),
    "fcg_bf16_iteration_only": (25, "none", False, True, True, 0.0, "bf16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pell_cg_reference_matches_pallas(case):
    max_iters, tol_mode, implicit, flexible, jacobi, x0v, storage = CASES[case]
    data = _shifted_poisson_3d(10)
    JP, P = _pells(data, storage)
    n = data.shape[0]
    Rf = JP.NT * 8
    Ad = P.to_dense().values.double().numpy()
    b = np.ones(n, np.float32)
    x0 = np.full(n, x0v, np.float32)
    r0 = (b - Ad @ x0).astype(np.float32)
    tol_sq = np.float32((1e-6 * np.linalg.norm(b)) ** 2) if tol_mode == "rel" else np.float32(-1.0)
    minv = (1.0 / np.diag(Ad)).astype(np.float32) if jacobi else None
    jx, jit_, jmon, jconv = pell_cg_vmem_solve(
        JP, _frame(r0, Rf), _frame(x0, Rf), None if minv is None else _frame(minv, Rf),
        tol_sq_eff=tol_sq, max_iters=max_iters, use_implicit=implicit, flexible=flexible,
        interpret=True,
    )
    t = torch.from_numpy
    x, r, it, mon, conv = pell_cg_solve_reference(
        P, t(r0), t(x0), None if minv is None else t(minv), tol_sq_eff=float(tol_sq),
        max_iters=max_iters, use_implicit=implicit, flexible=flexible,
    )
    assert it.dtype == torch.int32 and mon.dtype == torch.float32
    assert abs(int(it) - int(jit_)) <= 1
    assert bool(conv) == bool(jconv)
    jx = np.asarray(jx).reshape(-1)[:n]
    if tol_mode == "none":
        assert int(it) == int(jit_) == max_iters and not bool(conv)
    if int(it) == int(jit_):
        np.testing.assert_allclose(x.numpy(), jx, rtol=2e-6, atol=2e-5)
        np.testing.assert_allclose(float(mon), float(jmon), rtol=1e-3, atol=1e-30)
    else:  # one more or fewer step at the threshold: x within the tolerance
        np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=1e-4 * np.abs(jx).max())
    # r is the recurrence residual the kernel carries
    np.testing.assert_allclose(r.numpy(), (b - Ad @ x.double().numpy()).astype(np.float32), atol=1e-4)


def test_pell_cg_wrapper_takes_plain_version_on_cpu():
    JP, P = _pells(gt.generators.poisson_3d(8, dtype=np.float32))
    n = P.shape[0]
    b = torch.ones(n)
    before = pell_cg_fused.launches
    got = pell_cg_fused(P, b, torch.zeros(n), None, tol_sq_eff=1e-10, max_iters=100)
    want = pell_cg_solve_reference(P, b, torch.zeros(n), None, tol_sq_eff=1e-10, max_iters=100)
    assert pell_cg_fused.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _criteria(kind, max_iters, tol):
    if kind == "resnorm":
        return ([jstop.Iteration(max_iters=max_iters), jstop.ResidualNorm(tolerance=tol)],
                [stop.Iteration(max_iters=max_iters), stop.ResidualNorm(tolerance=tol)])
    if kind == "initial":
        return ([jstop.Iteration(max_iters=max_iters),
                 jstop.ResidualNorm(tolerance=tol, baseline="initial_resnorm")],
                [stop.Iteration(max_iters=max_iters),
                 stop.ResidualNorm(tolerance=tol, baseline="initial_resnorm")])
    return ([jstop.Iteration(max_iters=max_iters), jstop.ImplicitResidualNorm(tolerance=tol)],
            [stop.Iteration(max_iters=max_iters), stop.ImplicitResidualNorm(tolerance=tol)])


SOLVER_CASES = [
    # (solver, criterion, jacobi, storage)
    ("cg", "resnorm", False, "f32"),
    ("cg", "resnorm", True, "f32"),
    ("fcg", "initial", True, "f32"),
    ("cg", "implicit", False, "bf16"),
]


@pytest.mark.parametrize("solver,crit,jacobi,storage", SOLVER_CASES)
def test_fused_pell_route_matches_jax(solver, crit, jacobi, storage, monkeypatch):
    data = _shifted_poisson_3d(10)
    JP, P = _pells(data, storage)
    n = data.shape[0]
    jc, pc = _criteria(crit, 500, 1e-6)
    JS, PS = {"cg": (JCg, gt.Cg), "fcg": (JFcg, gt.Fcg)}[solver]
    js = JS.build(criteria=jc, preconditioner=JJacobi.build() if jacobi else None).generate(JP)
    ps = PS.build(criteria=pc, preconditioner=gt.Jacobi.build() if jacobi else None).generate(P)
    b = np.ones((n, 1), np.float32)
    monkeypatch.setenv("GINKGO_TPU_FORCE_VMEM_CG", "1")
    jx, jinfo = js.solve(jnp.asarray(b))
    assert prepare_fused_pell(ps, torch.from_numpy(b)) is not None
    before = pell_cg_fused.launches
    px, pinfo = ps.solve(torch.from_numpy(b))
    assert pell_cg_fused.launches == before  # the plain version on the CPU
    assert px.dtype == torch.float32 and px.shape == (n, 1)
    assert abs(int(pinfo.iterations) - int(jinfo.iterations)) <= 1
    np.testing.assert_array_equal(pinfo.converged.numpy(), np.asarray(jinfo.converged))
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=2e-5, atol=1e-4)


def test_gate_declines_what_k7_does_not_take():
    data = gt.generators.poisson_3d(8, dtype=np.float32)
    C = gt.Csr.from_matrix_data(data, device="cpu")
    n = C.shape[0]
    crit = [stop.Iteration(max_iters=5), stop.ResidualNorm(tolerance=1e-6)]
    P = gt.Pell.from_csr(C)
    b1, b2 = torch.ones(n, 1), torch.ones(n, 2)
    assert prepare_fused_pell(gt.Cg.build(criteria=crit).generate(P), b1) is not None
    assert prepare_fused_pell(gt.Cg.build(criteria=crit).generate(P), b2) is None
    assert prepare_fused_pell(gt.Cg.build(criteria=crit).generate(gt.Pell.from_csr(C, S=16)), b1) is None
    assert prepare_fused_pell(gt.Cg.build(criteria=crit).generate(P.astype(torch.float64)), b1) is None
    assert prepare_fused_pell(gt.Cg.build(criteria=crit).generate(C), b1) is None
    block = gt.Jacobi(inv_diag=None, n=n, max_block_size=4)
    assert prepare_fused_pell(gt.Cg(A=P, preconditioner=block, criterion=stop.combine(crit)), b1) is None
    hist = gt.Cg.build(criteria=crit, track_history=True).generate(P)
    assert prepare_fused_pell(hist, b1) is None
    # k > 1 and S != 8 stream through K6 / K5 instead
    X, info = gt.Cg.build(criteria=crit).generate(P).solve(b2)
    assert X.shape == (n, 2) and int(info.iterations) == 5


def test_slice_path_matches_jax_float64(monkeypatch):
    """The user's path: MatrixData -> Csr -> Pell -> Cg and Cg on the Csr
    itself (streaming, float64 at rtol 1e-10), against the JAX package."""
    monkeypatch.setenv("GINKGO_TPU_NO_PALLAS", "1")
    data = _shifted_poisson_3d(8, dtype=np.float64)
    jd = JMatrixData.from_coo(data.shape, data.rows, data.cols, data.values)
    JA = JCsr.from_matrix_data(jd)
    C = gt.Csr.from_matrix_data(data, device="cpu")
    n = data.shape[0]
    b = np.random.default_rng(3).standard_normal((n, 2))
    jc, pc = _criteria("resnorm", 300, 1e-10)
    jx, jinfo = JCg.build(criteria=jc, preconditioner=JJacobi.build()).generate(JA).solve(jnp.asarray(b))
    for A in (C, gt.Pell.from_csr(C)):
        px, pinfo = gt.Cg.build(criteria=pc, preconditioner=gt.Jacobi.build()).generate(A).solve(
            torch.from_numpy(b))
        assert int(pinfo.iterations) == int(jinfo.iterations)
        np.testing.assert_array_equal(pinfo.converged.numpy(), np.asarray(jinfo.converged))
        np.testing.assert_allclose(pinfo.residual_norm.numpy(), np.asarray(jinfo.residual_norm),
                                   rtol=1e-6, atol=1e-14)
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-10, atol=1e-12)


def test_slice_path_on_cpu_runs_no_kernel():
    """generators -> Csr ("auto") -> Pell -> Cg fused, and Cg on the Csr: on
    CPU tensors every wrapper takes its plain version."""
    from ginkgo_tpu_torch.ops import pell as ops_pell

    data = gt.generators.poisson_3d(8, dtype=np.float32)
    C = gt.Csr.from_matrix_data(data, device="cpu")
    crit = [stop.Iteration(max_iters=200), stop.ResidualNorm(tolerance=1e-6)]
    counts = (ops_pell.pell_spmv.launches, ops_pell.pell_spmm.launches, pell_cg_fused.launches)
    b = torch.ones(C.shape[0])
    x1, i1 = gt.Cg.build(criteria=crit).generate(gt.Pell.from_csr(C)).solve(b)
    x2, i2 = gt.Cg.build(criteria=crit).generate(C.with_strategy("pallas")).solve(b)
    assert bool(i1.converged.all()) and bool(i2.converged.all())
    torch.testing.assert_close(x1, x2, rtol=1e-4, atol=1e-4)
    assert (ops_pell.pell_spmv.launches, ops_pell.pell_spmm.launches,
            pell_cg_fused.launches) == counts
