"""Slice 4, BiCGSTAB: the port (ginkgo_tpu_torch) against the JAX package
(ginkgo_tpu) on the CPU.

- K12's plain version (ops/bicgstab.bicgstab_solve_reference) against the
  JAX whole-solve kernel bicgstab_vmem_solve in Pallas interpret mode, on
  the same diagonals (A M folded by the port's fold_minv, carried into the
  JAX lane frame bit for bit, bfloat16 included).  The JAX kernel sums its
  dot products in float32, the port in float64, so the iteration counts
  may differ by one (the K7 precedent); x agrees to 1e-4 relative.
- Bicgstab against the JAX solver's streaming route (GINKGO_TPU_NO_PALLAS=1)
  in both of the port's routes: the fused one (K12's plain version on the
  CPU) and the streaming loop (float64 to 1e-10, k = 3 columns).
- Gates: the routes the port does not take yet (a Pell operator, a
  preconditioner that is not diagonal, as ILU and multigrid are to the
  gate) stream and say so; k = 2 columns take the k-column kernel K12m and
  k = 9 streams, as in the JAX package.

The helpers here (the test matrices, the JAX frame) serve the other slice-4
test files too.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu import stop as jstop
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.matrix.dia import Dia as JDia
from ginkgo_tpu.ops.pallas_bicgstab import bicgstab_vmem_solve
from ginkgo_tpu.preconditioner.jacobi import Jacobi as JJacobi
from ginkgo_tpu.solver.bicgstab import Bicgstab as JBicgstab
from ginkgo_tpu.utils import generators as jgen
from ginkgo_tpu_torch import interop, stop
from ginkgo_tpu_torch.ops.bicgstab import bicgstab_fused, bicgstab_solve_reference
from ginkgo_tpu_torch.solver._fused_gate import fold_minv
from tests.conftest import nonsym_tridiag

LANES = 128


# -- shared helpers ----------------------------------------------------------------


def convdiff_2d(nside, jitter_seed=None):
    """The nonsymmetric 5-point convection-diffusion operator of one
    backward-Euler step on an nside^2 grid: diagonal 4.5, west/south -1.3,
    east/north -0.7 (tests/conftest.py nonsym_tridiag in 2-D plus a 0.5
    mass shift).  With ``jitter_seed`` the diagonal gets a seeded uniform
    [0, 1) shift, so scalar Jacobi is not a multiple of I.  Returns
    (shape, rows, cols, values float32)."""
    n = nside * nside
    i = np.arange(n)
    ix, iy = i % nside, i // nside
    diag = np.full(n, 4.5)
    if jitter_seed is not None:
        diag = diag + np.random.default_rng(jitter_seed).uniform(0.0, 1.0, n)
    rows, cols, vals = [i], [i], [diag]
    for keep, off, v in ((ix > 0, -1, -1.3), (ix < nside - 1, 1, -0.7),
                         (iy > 0, -nside, -1.3), (iy < nside - 1, nside, -0.7)):
        rows.append(i[keep])
        cols.append(i[keep] + off)
        vals.append(np.full(int(keep.sum()), v))
    return ((n, n), np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals).astype(np.float32))


def matrices(name):
    """(JAX MatrixData, port MatrixData) of a named test matrix."""
    if name == "poisson16":
        jd = jgen.poisson_2d(16, dtype=np.float32)
        parts = (jd.shape, jd.rows, jd.cols, jd.values)
    elif name == "tridiag700":
        jd = nonsym_tridiag(700)
        parts = (jd.shape, jd.rows, jd.cols, jd.values)
    else:  # "convdiff32" / "convdiff32_jitter"
        parts = convdiff_2d(32, jitter_seed=5 if name.endswith("jitter") else None)
        jd = JMatrixData.from_coo(*parts)
    return jd, interop.matrix_data_from_arrays(*parts)


def dia_pair(name, storage="f32"):
    """The JAX Dia and the port's Dia built from its arrays (bit for bit,
    bfloat16 included)."""
    jd, _ = matrices(name)
    JA = JDia.from_matrix_data(jd)
    if storage == "bf16":
        JA = JA.reduce_storage()
    A = interop.dia_from_arrays(np.asarray(JA.diags), JA.offsets, JA.shape, device="cpu")
    return JA, A


def jax_frame(t, R):
    """A port tensor (n,) or (nd, n) as the JAX lane frame (..., R, 128),
    zero padded; bfloat16 carried bit for bit."""
    a = t.detach()
    if a.dtype == torch.bfloat16:
        a = a.view(torch.int16).numpy().view(jnp.bfloat16)
    else:
        a = a.numpy()
    pad = [(0, 0)] * (a.ndim - 1) + [(0, R * LANES - a.shape[-1])]
    return jnp.asarray(np.pad(a, pad).reshape(a.shape[:-1] + (R, LANES)))


def kernel_inputs(A, case, rng):
    """b (with a NaN for the "nan" case), x0 = 0, minv (1/diag or None) and
    the squared threshold of a kernel parity case."""
    n = A.shape[0]
    b = rng.standard_normal(n).astype(np.float32)
    if case["rhs"] == "nan":
        b[3] = np.nan
    diag = A.extract_diagonal().values.float().numpy()
    minv = (1.0 / diag).astype(np.float32) if case["jacobi"] else None
    tol = np.float32(-1.0) if case["tol"] is None else np.float32(
        (case["tol"] * np.linalg.norm(np.nan_to_num(b))) ** 2)
    return b, np.zeros(n, np.float32), minv, tol


def assert_kernel_parity(it, jit_, x, jx, mon, jmon, conv, jconv, case, max_iters):
    """Iterations equal or one apart (float64 against float32 dot sums);
    x to 1e-4 relative; the NaN case runs to the cap on both."""
    if case["rhs"] == "nan":
        assert int(it) == int(jit_) == max_iters
        assert np.isnan(float(mon)) and np.isnan(float(jmon))
        assert not bool(conv) and not bool(jconv)
        return
    assert abs(int(it) - int(jit_)) <= 1
    if case["tol"] is None:
        assert int(it) == int(jit_) == max_iters and not bool(conv)
    else:
        assert bool(conv) and bool(jconv)
    assert np.isfinite(x).all()
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-4 * np.abs(jx).max())


# one JAX interpret compile per case: the cases cover f32/bf16 diagonals,
# with and without minv, exact and implicit residual, Iteration only, NaN
KERNEL_CASES = {
    "f32": dict(matrix="convdiff32", storage="f32", jacobi=False, implicit=False,
                tol=1e-6, rhs="random"),
    "bf16_jacobi": dict(matrix="convdiff32_jitter", storage="bf16", jacobi=True,
                        implicit=False, tol=1e-6, rhs="random"),
    "jacobi_implicit": dict(matrix="tridiag700", storage="f32", jacobi=True, implicit=True,
                            tol=1e-6, rhs="random"),
    "iteration_only": dict(matrix="convdiff32", storage="f32", jacobi=False,
                           implicit=False, tol=None, rhs="random"),
    "nan": dict(matrix="convdiff32", storage="f32", jacobi=False, implicit=False,
                tol=1e-6, rhs="nan"),
}


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_bicgstab_reference_matches_pallas_kernel(name):
    case = KERNEL_CASES[name]
    JA, A = dia_pair(case["matrix"], case["storage"])
    R = JA.diags.shape[1]
    b, x0, minv, tol = kernel_inputs(A, case, np.random.default_rng(7))
    max_iters = 25 if case["tol"] is None or case["rhs"] == "nan" else 500
    t = torch.from_numpy
    mv = None if minv is None else t(minv)
    diags = A.diags if mv is None else fold_minv(A, mv)
    jx, jit_, jmon, jconv = bicgstab_vmem_solve(
        jax_frame(diags, R), JA.offsets, jax_frame(t(b), R), jax_frame(t(x0), R),
        None if mv is None else jax_frame(mv, R), tol_sq_eff=tol, max_iters=max_iters,
        use_implicit=case["implicit"], interpret=True,
    )
    x, r, it, mon, conv = bicgstab_solve_reference(
        diags, A.offsets, t(b), t(x0), mv, tol_sq_eff=float(tol), max_iters=max_iters,
        use_implicit=case["implicit"],
    )
    assert it.dtype == torch.int32 and mon.dtype == torch.float32 and x.dtype == torch.float32
    jx = np.asarray(jx).reshape(-1)[: A.shape[0]]
    assert_kernel_parity(it, jit_, x.numpy(), jx, mon, jmon, conv, jconv, case, max_iters)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_fold_minv_matches_jax_fold(storage):
    """fold_minv rounds A M exactly as the JAX solver's fold (its
    Dia._flat_shift of the framed minv, solver/bicgstab.py:72-83), bit for
    bit, and bfloat16 diagonals stay bfloat16."""
    JA, A = dia_pair("convdiff32_jitter", storage)
    R = JA.diags.shape[1]
    minv = torch.from_numpy(np.random.default_rng(3).uniform(0.1, 0.3, A.shape[0])
                            .astype(np.float32))
    m2 = jax_frame(minv, R)
    want = jnp.stack([
        (JA.diags[j].astype(jnp.float32) * JA._flat_shift(m2, off)).astype(JA.diags.dtype)
        for j, off in enumerate(JA.offsets)
    ])
    got = fold_minv(A, minv)
    assert got.dtype == A.dtype
    np.testing.assert_array_equal(jax_frame(got, R).astype(jnp.float32),
                                  np.asarray(want).astype(np.float32))


def test_bicgstab_fused_takes_plain_version_on_cpu():
    _, A = dia_pair("convdiff32")
    b = torch.ones(A.shape[0])
    before = bicgstab_fused.launches
    got = bicgstab_fused(A.diags, A.offsets, b, torch.zeros_like(b), None,
                         tol_sq_eff=1e-10, max_iters=100)
    want = bicgstab_solve_reference(A.diags, A.offsets, b, torch.zeros_like(b), None,
                                    tol_sq_eff=1e-10, max_iters=100)
    assert bicgstab_fused.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- the solver against the JAX solver's streaming route -----------------------------


def criteria(kind, max_iters, tol):
    """The same criteria list in both packages."""
    if kind == "resnorm":
        return ([jstop.Iteration(max_iters=max_iters), jstop.ResidualNorm(tolerance=tol)],
                [stop.Iteration(max_iters=max_iters), stop.ResidualNorm(tolerance=tol)])
    if kind == "implicit":
        return ([jstop.Iteration(max_iters=max_iters), jstop.ImplicitResidualNorm(tolerance=tol)],
                [stop.Iteration(max_iters=max_iters), stop.ImplicitResidualNorm(tolerance=tol)])
    return ([jstop.Iteration(max_iters=max_iters)], [stop.Iteration(max_iters=max_iters)])


def solver_pair(JS, PS, JA, A, crit, jacobi, **params):
    jc, pc = criteria(*crit)
    jpre = JJacobi.build(max_block_size=1) if jacobi else None
    ppre = gt.Jacobi.build(max_block_size=1) if jacobi else None
    return (JS.build(criteria=jc, preconditioner=jpre, **params).generate(JA),
            PS.build(criteria=pc, preconditioner=ppre, **params).generate(A))


def jax_streaming(js, b, x0=None, monkeypatch=None):
    monkeypatch.setenv("GINKGO_TPU_NO_PALLAS", "1")
    args = (jnp.asarray(b),) if x0 is None else (jnp.asarray(b), jnp.asarray(x0))
    x, info = js.solve(*args)
    monkeypatch.delenv("GINKGO_TPU_NO_PALLAS")
    return np.asarray(x), info


def assert_fused_vs_streaming(px, pinfo, jx, jinfo, crit_kind, max_iters):
    """The port's fused route against the JAX streaming loop: iterations
    equal or one apart (float64 against float32 dot sums), the same stop
    flags, x to 1e-4 relative."""
    assert abs(int(pinfo.iterations) - int(jinfo.iterations)) <= 1
    np.testing.assert_array_equal(pinfo.converged.numpy(), np.asarray(jinfo.converged))
    if crit_kind == "iteration":
        assert int(pinfo.iterations) == max_iters
    np.testing.assert_allclose(px.numpy(), jx, rtol=0, atol=1e-4 * np.abs(jx).max())


FUSED_SOLVER_CASES = [
    # (matrix, storage, crit, jacobi)
    ("tridiag700", "f32", "resnorm", False),
    ("convdiff32_jitter", "f32", "resnorm", True),
    ("convdiff32", "bf16", "resnorm", False),
    ("tridiag700", "f32", "implicit", False),
    ("convdiff32", "f32", "iteration", False),
]


@pytest.mark.parametrize("matrix,storage,crit,jacobi", FUSED_SOLVER_CASES)
def test_bicgstab_fused_route_matches_jax_streaming(matrix, storage, crit, jacobi,
                                                    monkeypatch):
    JA, A = dia_pair(matrix, storage)
    n = A.shape[0]
    max_iters = 30 if crit == "iteration" else 400
    js, ps = solver_pair(JBicgstab, gt.Bicgstab, JA, A, (crit, max_iters, 1e-6), jacobi)
    b = np.random.default_rng(3).standard_normal((n, 1)).astype(np.float32)
    assert ps._try_fused(torch.from_numpy(b), torch.zeros(n, 1)) is not None
    jx, jinfo = jax_streaming(js, b, monkeypatch=monkeypatch)
    px, pinfo = ps.solve(torch.from_numpy(b))
    assert px.dtype == torch.float32 and px.shape == (n, 1)
    assert_fused_vs_streaming(px, pinfo, jx, jinfo, crit, max_iters)


@pytest.mark.parametrize("jacobi", [False, True])
def test_bicgstab_streaming_k3_matches_jax_float64(jacobi, monkeypatch):
    """k = 3 float64 columns stream in both packages (the k-column kernel
    takes float32 only, in both): equal iterations, stop masks and x."""
    jd, pd = matrices("convdiff32_jitter")
    JA = JDia.from_matrix_data(jd).astype(jnp.float64)
    A = gt.Dia.from_matrix_data(pd, device="cpu").astype(torch.float64)
    n = A.shape[0]
    js, ps = solver_pair(JBicgstab, gt.Bicgstab, JA, A, ("resnorm", 200, 1e-10), jacobi)
    rng = np.random.default_rng(4)
    b = np.stack([np.ones(n), rng.standard_normal(n), rng.uniform(0, 1, n)], axis=1)
    x0 = np.full((n, 3), 0.1)
    assert ps._try_fused(torch.from_numpy(b), torch.from_numpy(x0)) is None
    jx, jinfo = jax_streaming(js, b, x0, monkeypatch)
    px, pinfo = ps.solve(torch.from_numpy(b), torch.from_numpy(x0))
    assert int(pinfo.iterations) == int(jinfo.iterations)
    np.testing.assert_array_equal(pinfo.converged.numpy(), np.asarray(jinfo.converged))
    np.testing.assert_allclose(pinfo.residual_norm.numpy(), np.asarray(jinfo.residual_norm),
                               rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(px.numpy(), jx, rtol=1e-10, atol=1e-12)


def test_bicgstab_half_step_matches_jax(monkeypatch):
    """A right-hand side that converges at the half step: s meets the
    tolerance, omega is 0 and r = s, as in the JAX loop."""
    JA, A = dia_pair("convdiff32")
    n = A.shape[0]
    b = np.zeros((n, 1))
    b[0] = 1.0
    JA64, A64 = JA.astype(jnp.float64), A.astype(torch.float64)
    js, ps = solver_pair(JBicgstab, gt.Bicgstab, JA64, A64, ("resnorm", 50, 0.5), False)
    jx, jinfo = jax_streaming(js, b, monkeypatch=monkeypatch)
    px, pinfo = ps.solve(torch.from_numpy(b))
    assert int(pinfo.iterations) == int(jinfo.iterations) == 1
    np.testing.assert_allclose(px.numpy(), jx, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(pinfo.residual_norm.numpy(), np.asarray(jinfo.residual_norm),
                               rtol=1e-10)


def _declines(solver, A, k=1):
    b = torch.ones(A.shape[0], k)
    return solver._try_fused(b, torch.zeros_like(b)) is None


def test_bicgstab_declined_routes_stream(monkeypatch):
    """Routes the JAX package takes and the port does not yet: a general
    preconditioner (what ILU and multigrid are to the gate, :176, :219)
    streams (``_try_fused`` returns None).  Columns follow the JAX
    package's rule (:52-54, 108-174): k = 2 takes the k-column kernel
    K12m, k = 9 streams.  A one-column solve on an S = 8 Pell takes the
    Pell kernel K19 (the JAX Pell kernel, bicgstab.py:277; ported in slice
    6) and solves as the JAX loop does; on the Pell, k = 2 streams."""
    jd, pd = matrices("tridiag700")
    crit = [stop.Iteration(max_iters=200), stop.ResidualNorm(tolerance=1e-6)]
    P = gt.Pell.from_matrix_data(pd, device="cpu")
    sp = gt.Bicgstab.build(criteria=crit).generate(P)
    assert not _declines(sp, P) and _declines(sp, P, k=2)
    _, A = dia_pair("tridiag700")
    general = gt.Composition(operators=(gt.Jacobi.build().generate(A),))
    sg = gt.Bicgstab.build(criteria=crit, preconditioner=general).generate(A)
    assert _declines(sg, A)
    sk = gt.Bicgstab.build(criteria=crit).generate(A)
    assert not _declines(sk, A, k=2) and _declines(sk, A, k=9) and not _declines(sk, A)
    # the Pell solve runs K19's plain version and matches the JAX loop
    js = JBicgstab.build(criteria=criteria("resnorm", 200, 1e-6)[0]).generate(
        JDia.from_matrix_data(jd))
    b = np.random.default_rng(3).standard_normal((700, 1)).astype(np.float32)
    jx, jinfo = jax_streaming(js, b, monkeypatch=monkeypatch)
    px, pinfo = sp.solve(torch.from_numpy(b))
    assert abs(int(pinfo.iterations) - int(jinfo.iterations)) <= 1
    np.testing.assert_allclose(px.numpy(), jx, rtol=0, atol=1e-4 * np.abs(jx).max())
