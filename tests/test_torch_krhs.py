"""Slice 5, the k-column whole-solve kernels: the port (ginkgo_tpu_torch)
against the JAX package (ginkgo_tpu) on the CPU.

- K12m's and K15m's plain versions (ops/bicgstab.bicgstab_solve_multi_reference,
  ops/gmres.gmres_solve_multi_reference) against the JAX k-column kernels
  bicgstab_vmem_solve_multi and gmres_vmem_solve_multi in Pallas interpret
  mode, on the same diagonals, with k = 3 columns that stop at different
  iterations: the iteration count and every column's stop iteration equal
  or one apart (the JAX kernels sum their dots in float32, the port in
  float64: the K7 precedent), x to 1e-4 relative per column, a NaN column
  running to the cap while the others stop.  The JAX wrappers drop the
  per-column stop iterations from the kernels' stats; ``capture`` keeps the
  raw pallas_call outputs to read them.
- Bicgstab and Gmres with k = 3 float32 columns: the fused k-column route
  against the JAX solvers' streaming route (GINKGO_TPU_NO_PALLAS=1).
- Gates: k-column routes the port does not take stream and say so.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ginkgo_tpu_torch as gt
import ginkgo_tpu.ops.pallas_bicgstab as jbicgstab
import ginkgo_tpu.ops.pallas_gmres as jgmres
from ginkgo_tpu.solver._fused_gate import frame_cols
from ginkgo_tpu.solver.bicgstab import Bicgstab as JBicgstab
from ginkgo_tpu.solver.gmres import Gmres as JGmres
from ginkgo_tpu_torch import stop
from ginkgo_tpu_torch.ops.bicgstab import bicgstab_fused_multi, bicgstab_solve_multi_reference
from ginkgo_tpu_torch.ops.gmres import (
    MAX_FUSED_KRYLOV_DIM_MULTI,
    gmres_fused_multi,
    gmres_solve_multi_reference,
)
from ginkgo_tpu_torch.solver._fused_gate import fold_minv
from tests.test_torch_bicgstab import dia_pair, jax_frame, jax_streaming, solver_pair

K = 3


class _Capture:
    """Stands in for a JAX kernel module's ``pl`` and keeps the outputs of
    the last pallas_call, the stats array included."""

    def __init__(self, pl):
        self._pl = pl
        self.outputs = None

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *args, **kwargs):
        call = self._pl.pallas_call(*args, **kwargs)

        def run(*operands):
            self.outputs = call(*operands)
            return self.outputs

        return run


@pytest.fixture
def capture(monkeypatch):
    def install(module):
        cap = _Capture(module.pl)
        monkeypatch.setattr(module, "pl", cap)
        return cap
    return install


def rhs_cols(n, case, rng):
    """Three columns that stop at different iterations (Gaussian, uniform,
    a ramp), a NaN in the middle one for the "nan" case, and their squared
    thresholds (negative: Iteration only).  A unit vector would be a poor
    column: its residual stalls for a few iterations in float32, so float32
    and float64 dot sums stop it 3 iterations apart."""
    b = np.stack([rng.standard_normal(n), rng.uniform(0.5, 1.5, n), np.linspace(-1, 1, n)],
                 axis=1).astype(np.float32)
    if case["rhs"] == "nan":
        b[4, 1] = np.nan
    norms = np.linalg.norm(np.nan_to_num(b), axis=0)
    tol = (np.full(K, -1.0) if case["tol"] is None else (case["tol"] * norms) ** 2)
    return b, tol.astype(np.float32)


def assert_multi_parity(it, jit_, itc, jitc, x, jx, conv, jconv, case, max_iters):
    """The iteration count and each column's stop iteration equal or one
    apart; the converged flags equal; x to 1e-4 relative per column; a NaN
    column runs to the cap on both while the others stop."""
    itc, jitc = np.asarray(itc), np.asarray(jitc).astype(np.int64)
    assert abs(int(it) - int(jit_)) <= 1
    assert int(it) == itc.max()
    assert np.abs(itc - jitc).max() <= 1, (itc, jitc)
    np.testing.assert_array_equal(np.asarray(conv), np.asarray(jconv))
    if case["tol"] is None:
        assert int(it) == int(jit_) == max_iters and not np.asarray(conv).any()
    elif case["rhs"] == "nan":
        assert itc[1] == jitc[1] == max_iters and np.asarray(conv).tolist() == [True, False, True]
        assert len(set(itc.tolist())) > 1  # the other columns stopped earlier
    else:
        assert np.asarray(conv).all() and len(set(itc.tolist())) > 1
    for c in range(K):
        if case["rhs"] == "nan" and c == 1:
            continue
        np.testing.assert_allclose(x[:, c], jx[:, c], rtol=0,
                                   atol=1e-4 * np.abs(jx[:, c]).max())


def unframe(x3, n):
    return np.asarray(x3).reshape(K, -1)[:, :n].T


BICGSTAB_CASES = {
    "f32": dict(matrix="convdiff32", storage="f32", jacobi=False, implicit=False, tol=1e-6,
                rhs="cols"),
    "bf16_jacobi": dict(matrix="convdiff32_jitter", storage="bf16", jacobi=True,
                        implicit=False, tol=1e-6, rhs="cols"),
    "jacobi_implicit": dict(matrix="tridiag700", storage="f32", jacobi=True, implicit=True,
                            tol=1e-6, rhs="cols"),
    "nan": dict(matrix="convdiff32", storage="f32", jacobi=False, implicit=False, tol=1e-6,
                rhs="nan"),
}


@pytest.mark.parametrize("name", sorted(BICGSTAB_CASES))
def test_bicgstab_multi_reference_matches_pallas_kernel(name, capture):
    case = BICGSTAB_CASES[name]
    JA, A = dia_pair(case["matrix"], case["storage"])
    n, R = A.shape[0], JA.diags.shape[1]
    b, tol = rhs_cols(n, case, np.random.default_rng(11))
    max_iters = 40 if case["rhs"] == "nan" else 500
    mv = (1.0 / A.extract_diagonal().values.float()) if case["jacobi"] else None
    diags = A.diags if mv is None else fold_minv(A, mv)
    cap = capture(jbicgstab)
    jx, jit_, _jmon, jconv = jbicgstab.bicgstab_vmem_solve_multi(
        jax_frame(diags, R), JA.offsets, frame_cols(jnp.asarray(b), R),
        frame_cols(jnp.zeros((n, K), jnp.float32), R), None if mv is None else jax_frame(mv, R),
        tol_sq_eff=tol, max_iters=max_iters, use_implicit=case["implicit"], interpret=True,
    )
    jitc = np.asarray(cap.outputs[2])[1 + 2 * K:1 + 3 * K]
    x, r, it, mon, conv, itc = bicgstab_solve_multi_reference(
        diags, A.offsets, torch.from_numpy(b), torch.zeros(n, K), mv,
        tol_sq_eff=torch.from_numpy(tol), max_iters=max_iters, use_implicit=case["implicit"],
    )
    assert x.shape == (n, K) and mon.shape == (K,) and itc.dtype == torch.int32
    assert_multi_parity(it, jit_, itc, jitc, x.numpy(), unframe(jx, n), conv, jconv, case,
                        max_iters)


def test_bicgstab_multi_freezes_stopped_columns():
    """A column that stopped keeps its x and r bit for bit: a solve capped
    at the column's stop iteration returns the same values in it."""
    _, A = dia_pair("convdiff32")
    n = A.shape[0]
    b, tol = rhs_cols(n, BICGSTAB_CASES["f32"], np.random.default_rng(11))
    kw = dict(tol_sq_eff=torch.from_numpy(tol))
    full = bicgstab_solve_multi_reference(A.diags, A.offsets, torch.from_numpy(b),
                                          torch.zeros(n, K), **kw, max_iters=500)
    itc = full[5]
    c = int(torch.argmin(itc))
    early = bicgstab_solve_multi_reference(A.diags, A.offsets, torch.from_numpy(b),
                                           torch.zeros(n, K), **kw, max_iters=int(itc[c]))
    assert int(itc[c]) < int(full[2])
    assert torch.equal(full[0][:, c], early[0][:, c]) and torch.equal(full[1][:, c],
                                                                       early[1][:, c])


GMRES_CASES = {
    "restarts_m4": dict(matrix="poisson16", storage="f32", jacobi=False, m=4, basis="f32",
                        tol=1e-5, rhs="cols"),
    # a bfloat16 basis stalls GMRES near 1e-6 (44 against 42 steps for the
    # ramp there); at 1e-5 both sides stop every column at the same step
    "bf16_basis": dict(matrix="convdiff32", storage="f32", jacobi=False, m=10, basis="bf16",
                       tol=1e-5, rhs="cols"),
    "bf16_diags_jacobi": dict(matrix="convdiff32_jitter", storage="bf16", jacobi=True, m=10,
                              basis="f32", tol=1e-6, rhs="cols"),
    "nan": dict(matrix="poisson16", storage="f32", jacobi=False, m=4, basis="f32", tol=1e-5,
                rhs="nan"),
}
BASIS = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("name", sorted(GMRES_CASES))
def test_gmres_multi_reference_matches_pallas_kernel(name, capture):
    case = GMRES_CASES[name]
    JA, A = dia_pair(case["matrix"], case["storage"])
    n, R = A.shape[0], JA.diags.shape[1]
    b, tol = rhs_cols(n, case, np.random.default_rng(13))
    # GMRES(4) stops poisson16's columns after 75-177 steps
    max_iters = 200 if case["rhs"] == "nan" else 600
    mv = (1.0 / A.extract_diagonal().values.float()) if case["jacobi"] else None
    jb, pb = BASIS[case["basis"]]
    cap = capture(jgmres)
    jx, jit_, jrr, jconv = jgmres.gmres_vmem_solve_multi(
        jax_frame(A.diags, R), JA.offsets, frame_cols(jnp.asarray(b), R),
        frame_cols(jnp.zeros((n, K), jnp.float32), R), None if mv is None else jax_frame(mv, R),
        m=case["m"], tol_sq_eff=tol, max_iters=max_iters, basis_dtype=jb, interpret=True,
    )
    jitc = np.asarray(cap.outputs[1])[1 + 2 * K:1 + 3 * K]
    x, it, rr, conv, itc = gmres_solve_multi_reference(
        A.diags, A.offsets, torch.from_numpy(b), torch.zeros(n, K), mv, m=case["m"],
        tol_sq_eff=torch.from_numpy(tol), max_iters=max_iters, basis_dtype=pb,
    )
    assert x.shape == (n, K) and rr.shape == (K,) and itc.dtype == torch.int32
    assert_multi_parity(it, jit_, itc, jitc, x.numpy(), unframe(jx, n), conv, jconv, case,
                        max_iters)
    if case["rhs"] != "nan":
        # the returned r.r are the true residuals of the returned x, as the
        # kernel computes them: b - A x in float32, summed in float64
        r = torch.from_numpy(b) - A.apply(x)
        torch.testing.assert_close(rr, (r.double() ** 2).sum(dim=0).float(), rtol=0, atol=0)
    if name == "restarts_m4":
        assert int(it) > 4 * 3  # several restart cycles ran


def test_multi_wrappers_take_plain_versions_on_cpu():
    _, A = dia_pair("poisson16")
    n = A.shape[0]
    B = torch.ones(n, 2)
    kw = dict(tol_sq_eff=torch.full((2,), 1e-8), max_iters=60)
    before = (bicgstab_fused_multi.launches, gmres_fused_multi.launches)
    got_b = bicgstab_fused_multi(A.diags, A.offsets, B, torch.zeros_like(B), None, **kw)
    want_b = bicgstab_solve_multi_reference(A.diags, A.offsets, B, torch.zeros_like(B), None,
                                            **kw)
    got_g = gmres_fused_multi(A.diags, A.offsets, B, torch.zeros_like(B), None, m=5, **kw)
    want_g = gmres_solve_multi_reference(A.diags, A.offsets, B, torch.zeros_like(B), None,
                                         m=5, **kw)
    assert (bicgstab_fused_multi.launches, gmres_fused_multi.launches) == before
    for g, w in list(zip(got_b, want_b)) + list(zip(got_g, want_g)):
        assert torch.equal(g, w)


# -- the k-column routes against the JAX solvers' streaming route -------------------


@pytest.mark.parametrize("cls", ["bicgstab", "gmres"])
def test_k_column_fused_route_matches_jax_streaming(cls, monkeypatch):
    """k = 3 float32 columns on the 32^2 convection-diffusion Dia with
    Jacobi: K12m's or K15m's plain version against the JAX streaming loop;
    the same stop flags, iterations one apart (BiCGSTAB) or within one
    restart cycle (GMRES(10)), x to 1e-4 (1e-3 for GMRES, whose restart
    boundaries may move) relative."""
    JA, A = dia_pair("convdiff32_jitter")
    n = A.shape[0]
    JS, PS = (JBicgstab, gt.Bicgstab) if cls == "bicgstab" else (JGmres, gt.Gmres)
    params = {} if cls == "bicgstab" else {"krylov_dim": 10}
    js, ps = solver_pair(JS, PS, JA, A, ("resnorm", 400, 1e-6), True, **params)
    b, _ = rhs_cols(n, dict(rhs="cols", tol=1e-6), np.random.default_rng(3))
    bt = torch.from_numpy(b)
    kern = bicgstab_fused_multi if cls == "bicgstab" else gmres_fused_multi
    assert ps._try_fused(bt, torch.zeros(n, K)) is not None
    jx, jinfo = jax_streaming(js, b, monkeypatch=monkeypatch)
    before = kern.launches
    px, pinfo = ps.solve(bt)
    assert px.shape == (n, K) and kern.launches == before
    np.testing.assert_array_equal(pinfo.converged.numpy(), np.asarray(jinfo.converged))
    assert pinfo.converged.all()
    slack, rel = (1, 1e-4) if cls == "bicgstab" else (10, 1e-3)
    assert abs(int(pinfo.iterations) - int(jinfo.iterations)) <= slack
    np.testing.assert_allclose(px.numpy(), jx, rtol=0, atol=rel * np.abs(jx).max())
    if cls == "gmres":  # K15m reports the true residual norms, b - A x in float32
        true = ((bt - A.apply(px)).double() ** 2).sum(dim=0).float().sqrt()
        torch.testing.assert_close(pinfo.residual_norm, true, rtol=0, atol=0)


# -- gates ---------------------------------------------------------------------------


def _fused(solver, A, k, dtype=torch.float32):
    b = torch.ones(A.shape[0], k, dtype=dtype)
    return solver._try_fused(b, torch.zeros_like(b)) is not None


def test_k_column_routes_and_declines():
    """The JAX package's k-column rules (solver/bicgstab.py:52-54, 108-174;
    solver/gmres.py:304-306, 351-416): BiCGSTAB takes its k-column kernel
    for 2 <= k <= 8 and streams at k = 9; GMRES for 2 <= k <= 4, streams at
    k = 5, never tries the one-column kernel for k > 1, and, in the port
    only, streams a k-column solve with krylov_dim above 50 (K15m's shared
    memory); float64 columns stream in both; CGS and BiCG, which have no
    k-column kernel in either package, stream at k = 4."""
    _, A = dia_pair("poisson16")
    crit = [stop.Iteration(max_iters=20), stop.ResidualNorm(tolerance=1e-6)]
    bs = gt.Bicgstab.build(criteria=crit).generate(A)
    assert _fused(bs, A, 2) and _fused(bs, A, 8) and not _fused(bs, A, 9)
    assert not _fused(bs, A, 2, torch.float64)
    gm = gt.Gmres.build(criteria=crit).generate(A)
    assert _fused(gm, A, 2) and _fused(gm, A, 4) and not _fused(gm, A, 5)
    edge = gt.Gmres.build(criteria=crit, krylov_dim=MAX_FUSED_KRYLOV_DIM_MULTI).generate(A)
    over = gt.Gmres.build(criteria=crit, krylov_dim=MAX_FUSED_KRYLOV_DIM_MULTI + 1).generate(A)
    assert _fused(edge, A, 4) and not _fused(over, A, 2) and _fused(over, A, 1)
    for mode in ("integer", "ireduce1", "ireduce2"):
        s = gt.Gmres.build(criteria=crit, storage_precision=mode).generate(A)
        assert not _fused(s, A, 3)
    for cls in (gt.Cgs, gt.Bicg):
        assert not _fused(cls.build(criteria=crit).generate(A), A, 4)
    # the streamed solves still solve, without the k-column kernels
    before = (bicgstab_fused_multi.launches, gmres_fused_multi.launches)
    # float32 GMRES(30) stalls near 1.4e-6 relative on poisson16
    solve = [stop.Iteration(max_iters=200), stop.ResidualNorm(tolerance=1e-4)]
    for cls, k in ((gt.Bicgstab, 9), (gt.Gmres, 5)):
        x, info = cls.build(criteria=solve).generate(A).solve(torch.ones(A.shape[0], k))
        assert x.shape == (A.shape[0], k) and bool(info.converged.all())
    assert (bicgstab_fused_multi.launches, gmres_fused_multi.launches) == before


def test_cbgmres_auto_takes_k15m_with_a_bfloat16_basis(monkeypatch):
    """CbGmres inherits the k-column route: "auto" at >= 2^19 rows resolves
    to reduce1, and a k = 2 solve runs K15m with a bfloat16 basis."""
    n = 1 << 19
    A = gt.Dia(diags=torch.full((1, n), 2.0), offsets=(0,), shape=(n, n))
    solver = gt.CbGmres.build(criteria=[stop.Iteration(max_iters=3)]).generate(A)
    assert solver._resolved_mode() == "reduce1"
    seen = {}

    def spy(*args, **kwargs):
        seen["basis"] = kwargs["basis_dtype"]
        return gmres_fused_multi(*args, **kwargs)

    monkeypatch.setattr("ginkgo_tpu_torch.solver.gmres.gmres_fused_multi", spy)
    x, info = solver.solve(torch.ones(n, 2))
    assert seen["basis"] == torch.bfloat16 and int(info.iterations) == 3
    # x = 0.5 up to the bfloat16 rounding of the basis
    torch.testing.assert_close(x, torch.full((n, 2), 0.5), rtol=0, atol=1e-2)
