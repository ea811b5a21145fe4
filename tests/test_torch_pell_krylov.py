"""Slice 6, the Krylov solvers on a Pell: the port (ginkgo_tpu_torch)
against the JAX package (ginkgo_tpu) on the CPU.

- The plain versions of K19 (BiCGSTAB), K20 (CGS), K21 (IR) and K18
  (GMRES) against the JAX whole-solve kernels pell_bicgstab_vmem_solve,
  pell_cgs_vmem_solve, pell_ir_vmem_solve and pell_gmres_vmem_solve in
  Pallas interpret mode, on the JAX Pell's own arrays (carried across by
  interop.pell_from_arrays): a shifted 10^3 Poisson matrix and the 32^2
  convection-diffusion matrix, float32 and bfloat16 values, int8 and int32
  lane indices, Identity and Jacobi, the implicit criterion, an initial
  guess, Iteration only, GMRES with a float32 and a bfloat16 basis, and
  IR's zero-sweep case.  The JAX kernels sum their dot products in
  float32, the port in float64, so iteration counts may differ by one (as
  tests/test_torch_pell_cg.py holds K7); where they are equal x agrees to
  float32 round-off, else to 1e-4 of its largest entry.
- The whole slice, MatrixData -> Csr -> Pell -> solve(), against the JAX
  package's solve on the same MatrixData, both on their Pell routes.
- The routes: one float32 column on an S = 8 Pell takes the Pell kernel;
  Bicg, Idr, k >= 2, krylov_dim > 100 and IR's implicit criterion stream.
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
from ginkgo_tpu.ops.pallas_gmres import pell_gmres_vmem_solve
from ginkgo_tpu.ops.pallas_pell_cg import (
    pell_bicgstab_vmem_solve,
    pell_cgs_vmem_solve,
    pell_ir_vmem_solve,
)
from ginkgo_tpu.preconditioner.jacobi import Jacobi as JJacobi
from ginkgo_tpu.solver.bicgstab import Bicgstab as JBicgstab, Cgs as JCgs
from ginkgo_tpu.solver.gmres import CbGmres as JCbGmres, Gmres as JGmres
from ginkgo_tpu.solver.ir import Ir as JIr
from ginkgo_tpu_torch import interop, stop
from ginkgo_tpu_torch.ops import gmres as ops_gmres
from ginkgo_tpu_torch.ops import pell_cg as ops_pell_cg
from ginkgo_tpu_torch.ops.gmres import MAX_FUSED_KRYLOV_DIM
from tests.test_torch_bicgstab import convdiff_2d

LANES = 128


def _parts(name):
    """(shape, rows, cols, values float32) of a named test matrix:
    "convdiff32" (with "_jitter", a seeded diagonal shift, so Jacobi is
    not a multiple of I) or "poisson10", shifted the same way."""
    if name.startswith("convdiff32"):
        return convdiff_2d(32, jitter_seed=5 if name.endswith("jitter") else None)
    data = gt.generators.poisson_3d(10, dtype=np.float32)  # "poisson10", shifted
    diag = data.rows == data.cols
    vals = data.values.copy()
    vals[diag] += np.random.default_rng(7).uniform(0.0, 2.0, int(diag.sum())).astype(np.float32)
    return data.shape, data.rows, data.cols, vals


def _pells(name, storage):
    """The JAX Pell (S = 8) and the port's on the same arrays.  storage:
    values/lane indices, "f32/i32", "f32/i8", "bf16/i8" or "bf16/i32"."""
    # float32 values and int8 lane indices, the JAX planner's defaults
    JP = JPell.from_csr(JCsr.from_matrix_data(JMatrixData.from_coo(*_parts(name))), S=8)
    values, index = storage.split("/")
    if values == "bf16":
        JP = JP.astype(jnp.bfloat16)
    if index == "i32":
        JP = JP.replace(qidx=JP.qidx.astype(jnp.int32))
    assert str(JP.values.dtype) == {"f32": "float32", "bf16": "bfloat16"}[values]
    assert str(JP.qidx.dtype) == {"i8": "int8", "i32": "int32"}[index]
    P = interop.pell_from_arrays(
        np.asarray(JP.values), np.asarray(JP.qidx), np.asarray(JP.bases),
        np.asarray(JP.tile_of_step), shape=JP.shape, n_steps=JP.n_steps, nnz=JP.nnz,
        G=JP.G, NT=JP.NT, NP=JP.NP, S=JP.S, device="cpu")
    return JP, P


def _frame(v, Rf):
    out = np.zeros(Rf * LANES, np.float32)
    out[: v.shape[0]] = v
    return jnp.asarray(out.reshape(Rf, LANES))


def _inputs(P, case, rng):
    """b, x0, minv (1/diag or None), the dense operator in float64 and the
    squared threshold of a kernel case."""
    n = P.shape[0]
    Ad = P.to_dense().values.double().numpy()
    b = rng.uniform(0.5, 1.5, n).astype(np.float32)
    x0 = np.zeros(n, np.float32)
    if case.get("x0") == "guess":
        x0 = rng.uniform(-0.1, 0.1, n).astype(np.float32)
    elif case.get("x0") == "solution":  # r0 already meets the tolerance
        x0 = np.linalg.solve(Ad, b.astype(np.float64)).astype(np.float32)
    minv = (1.0 / np.diag(Ad)).astype(np.float32) if case["jacobi"] else None
    tol = np.float32(-1.0) if case["tol"] is None else np.float32(
        (case["tol"] * np.linalg.norm(b)) ** 2)
    return b, x0, minv, Ad, tol


def _assert_parity(it, jit_, x, jx, conv, jconv, case, max_iters):
    """Iterations equal or one apart, and x to 1e-4 of its largest entry
    (tests/test_torch_pell_cg.py's bound where the counts differ, and
    tests/test_torch_bicgstab.py's for these solvers): in BiCGSTAB, CGS and
    IR the float32 and float64 dot sums move x by more than float32
    round-off even at equal counts."""
    assert abs(int(it) - int(jit_)) <= 1
    assert bool(conv) == bool(jconv)
    if case["tol"] is None:
        assert int(it) == int(jit_) == max_iters and not bool(conv)
    else:
        assert bool(conv)
    assert np.isfinite(x).all()
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-4 * np.abs(jx).max())


KRYLOV_CASES = {
    # name: matrix, values/indices, Jacobi, tolerance (None: Iteration only),
    # implicit criterion, initial guess
    "poisson_f32_i32": dict(matrix="poisson10", storage="f32/i32", jacobi=False, tol=1e-6),
    "poisson_f32_i8_jacobi": dict(matrix="poisson10", storage="f32/i8", jacobi=True, tol=1e-6),
    # on the unjittered matrix float32 and float64 dot sums stop CGS three
    # iterations apart here (ROADMAP queue C, "Not faults")
    "convdiff_bf16_i8_jacobi": dict(matrix="convdiff32_jitter", storage="bf16/i8",
                                    jacobi=True, tol=1e-6),
    "convdiff_bf16_i32_guess": dict(matrix="convdiff32", storage="bf16/i32", jacobi=False,
                                    tol=1e-6, x0="guess"),
    "convdiff_f32_i32_implicit": dict(matrix="convdiff32", storage="f32/i32", jacobi=False,
                                      tol=1e-6, implicit=True),
    "convdiff_f32_i8_iteration_only": dict(matrix="convdiff32", storage="f32/i8", jacobi=True,
                                           tol=None),
}
KRYLOV = {
    "bicgstab": (pell_bicgstab_vmem_solve, ops_pell_cg.pell_bicgstab_solve_reference),
    "cgs": (pell_cgs_vmem_solve, ops_pell_cg.pell_cgs_solve_reference),
}


@pytest.mark.parametrize("solver", sorted(KRYLOV))
@pytest.mark.parametrize("case", sorted(KRYLOV_CASES))
def test_pell_bicgstab_cgs_reference_matches_pallas(solver, case):
    c = KRYLOV_CASES[case]
    JP, P = _pells(c["matrix"], c["storage"])
    b, x0, minv, Ad, tol = _inputs(P, c, np.random.default_rng(11))
    r0 = (b - Ad @ x0).astype(np.float32)
    Rf = JP.NT * 8
    implicit = c.get("implicit", False)
    max_iters = 30 if c["tol"] is None else 400
    jax_kernel, plain = KRYLOV[solver]
    jx, jit_, _jmon, jconv = jax_kernel(
        JP, _frame(r0, Rf), _frame(x0, Rf), None if minv is None else _frame(minv, Rf),
        tol_sq_eff=tol, max_iters=max_iters, use_implicit=implicit, interpret=True)
    t = torch.from_numpy
    x, r, it, mon, conv = plain(P, t(r0), t(x0), None if minv is None else t(minv),
                                tol_sq_eff=float(tol), max_iters=max_iters,
                                use_implicit=implicit)
    assert it.dtype == torch.int32 and mon.dtype == torch.float32 and x.dtype == torch.float32
    _assert_parity(it, jit_, x.numpy(), np.asarray(jx).reshape(-1)[: P.shape[0]], conv, jconv,
                   c, max_iters)
    # r is the recurrence residual the kernel carries: b - A x to round-off
    scale = np.abs(b).max()
    np.testing.assert_allclose(r.numpy(), b - Ad @ x.double().numpy(), atol=1e-3 * scale)


IR_CASES = {
    "convdiff_f32_i32_jacobi": dict(matrix="convdiff32", storage="f32/i32", jacobi=True,
                                    tol=1e-6, omega=1.0),
    "convdiff_bf16_i8_identity": dict(matrix="convdiff32", storage="bf16/i8", jacobi=False,
                                      tol=1e-5, omega=0.2),
    "poisson_f32_i8_jacobi_guess": dict(matrix="poisson10", storage="f32/i8", jacobi=True,
                                        tol=1e-6, omega=0.9, x0="guess"),
    "poisson_bf16_i32_iteration_only": dict(matrix="poisson10", storage="bf16/i32",
                                            jacobi=True, tol=None, omega=1.0),
    "zero_sweeps": dict(matrix="convdiff32", storage="f32/i32", jacobi=True, tol=1e-3,
                        omega=1.0, x0="solution"),
}


@pytest.mark.parametrize("case", sorted(IR_CASES))
def test_pell_ir_reference_matches_pallas(case):
    c = IR_CASES[case]
    JP, P = _pells(c["matrix"], c["storage"])
    b, x0, minv, Ad, tol = _inputs(P, c, np.random.default_rng(13))
    Rf = JP.NT * 8
    max_iters = 25 if c["tol"] is None else 400
    jx, jit_, jrr, jconv = pell_ir_vmem_solve(
        JP, _frame(b, Rf), _frame(x0, Rf), None if minv is None else _frame(minv, Rf),
        omega=c["omega"], tol_sq_eff=tol, max_iters=max_iters, interpret=True)
    t = torch.from_numpy
    x, it, rr, conv = ops_pell_cg.pell_ir_solve_reference(
        P, t(b), t(x0), None if minv is None else t(minv), omega=c["omega"],
        tol_sq_eff=float(tol), max_iters=max_iters)
    assert it.dtype == torch.int32 and rr.dtype == torch.float32
    jx = np.asarray(jx).reshape(-1)[: P.shape[0]]
    _assert_parity(it, jit_, x.numpy(), jx, conv, jconv, c, max_iters)
    # the reported r.r is that of the returned x's residual b - A x, in
    # float32 as the kernel forms it
    r = t(b) - ops_pell_cg.pell_spmv_reference(P, x)
    assert torch.equal(rr, (r.double() @ r.double()).float())
    if case == "zero_sweeps":
        # the Pell kernel's monitor starts at r0's r.r: no sweep, x = x0;
        # the Dia kernel's rule (monitor at +inf) would sweep once
        assert int(it) == int(jit_) == 0 and bool(conv)
        np.testing.assert_array_equal(x.numpy(), x0)
        x1, _, it1, _, _ = ops_pell_cg.ir_loop_reference(
            lambda v: ops_pell_cg.pell_spmv_reference(P, v), t(b), t(x0), t(minv),
            omega=1.0, tol_sq_eff=float(tol), max_iters=max_iters)
        assert int(it1) == 1


GMRES_CASES = {
    "poisson_keep_jacobi_m10": dict(matrix="poisson10", storage="f32/i32", jacobi=True,
                                    tol=1e-6, m=10, basis="f32"),
    "poisson_restarts_m4": dict(matrix="poisson10", storage="f32/i8", jacobi=False, tol=1e-6,
                                m=4, basis="f32"),
    "convdiff_bf16_basis": dict(matrix="convdiff32", storage="f32/i32", jacobi=False, tol=1e-6,
                                m=10, basis="bf16"),
    "convdiff_bf16_values_jacobi_guess": dict(matrix="convdiff32", storage="bf16/i8",
                                              jacobi=True, tol=1e-6, m=10, basis="bf16",
                                              x0="guess"),
    "convdiff_iteration_only": dict(matrix="convdiff32", storage="bf16/i32", jacobi=False,
                                    tol=None, m=6, basis="f32"),
}
BASIS = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("case", sorted(GMRES_CASES))
def test_pell_gmres_reference_matches_pallas(case):
    c = GMRES_CASES[case]
    JP, P = _pells(c["matrix"], c["storage"])
    b, x0, minv, Ad, tol = _inputs(P, c, np.random.default_rng(17))
    Rf = JP.NT * 8
    max_iters = 20 if c["tol"] is None else 300
    jb, tb = BASIS[c["basis"]]
    jx, jit_, jrr, jconv = pell_gmres_vmem_solve(
        JP, _frame(b, Rf), _frame(x0, Rf), None if minv is None else _frame(minv, Rf),
        m=c["m"], tol_sq_eff=tol, max_iters=max_iters, basis_dtype=jb, interpret=True)
    t = torch.from_numpy
    x, it, rr, conv = ops_gmres.pell_gmres_solve_reference(
        P, t(b), t(x0), None if minv is None else t(minv), m=c["m"], tol_sq_eff=float(tol),
        max_iters=max_iters, basis_dtype=tb)
    jx = np.asarray(jx).reshape(-1)[: P.shape[0]]
    # GMRES's stop falls at a restart's true residual, whose iteration
    # counts may differ by a cycle's in-cycle estimate; x to 1e-4 relative
    # as tests/test_torch_gmres.py holds K15's plain version
    assert abs(int(it) - int(jit_)) <= 1
    assert bool(conv) == bool(jconv) == (c["tol"] is not None)
    np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=1e-4 * np.abs(jx).max())
    # the true r.r of the returned x, in float32 as the kernel forms it
    r = t(b) - ops_pell_cg.pell_spmv_reference(P, x)
    assert torch.equal(rr, (r.double() @ r.double()).float())


@pytest.mark.parametrize("name", ["bicgstab", "cgs", "ir", "gmres"])
def test_pell_wrappers_take_plain_version_on_cpu(name):
    _, P = _pells("convdiff32", "f32/i8")
    n = P.shape[0]
    b, z = torch.ones(n), torch.zeros(n)
    minv = torch.full((n,), 1.0 / 4.5)
    if name == "gmres":
        fused, plain = ops_gmres.pell_gmres_fused, ops_gmres.pell_gmres_solve_reference
        kw = dict(m=10, tol_sq_eff=1e-8, max_iters=100)
    elif name == "ir":
        fused, plain = ops_pell_cg.pell_ir_fused, ops_pell_cg.pell_ir_solve_reference
        kw = dict(omega=1.0, tol_sq_eff=1e-8, max_iters=100)
    else:
        fused = getattr(ops_pell_cg, f"pell_{name}_fused")
        plain = getattr(ops_pell_cg, f"pell_{name}_solve_reference")
        kw = dict(tol_sq_eff=1e-8, max_iters=100)
    before = fused.launches
    got, want = fused(P, b, z, minv, **kw), plain(P, b, z, minv, **kw)
    assert fused.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- the whole slice and the routes ----------------------------------------------------

SLICE_SOLVERS = {
    # name: (JAX solver, port solver, build parameters, port kernel)
    "bicgstab": (JBicgstab, gt.Bicgstab, {}, ops_pell_cg.pell_bicgstab_fused),
    "cgs": (JCgs, gt.Cgs, {}, ops_pell_cg.pell_cgs_fused),
    "gmres": (JGmres, gt.Gmres, {"krylov_dim": 20}, ops_gmres.pell_gmres_fused),
    "cbgmres_reduce1": (JCbGmres, gt.CbGmres,
                        {"krylov_dim": 20, "storage_precision": "reduce1"},
                        ops_gmres.pell_gmres_fused),
    "ir": (JIr, gt.Ir, {"relaxation_factor": 1.0}, ops_pell_cg.pell_ir_fused),
}


def _spy(monkeypatch, module, name):
    """Record the calls of module.name (the wrapper still runs)."""
    fn = getattr(module, name)
    seen = []

    def spy(*args, **kwargs):
        seen.append(kwargs)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return seen


@pytest.mark.parametrize("name", sorted(SLICE_SOLVERS))
def test_slice_path_matches_jax(name, monkeypatch):
    """MatrixData -> Csr -> Pell.from_csr -> solve() in both packages, each
    on its Pell route (the JAX kernel in interpret mode): iterations within
    one, x within 1e-4 of its largest entry."""
    from ginkgo_tpu_torch.solver import bicgstab as sol_bicgstab
    from ginkgo_tpu_torch.solver import gmres as sol_gmres
    from ginkgo_tpu_torch.solver import ir as sol_ir

    parts = convdiff_2d(32, jitter_seed=5)
    JS, PS, params, kernel = SLICE_SOLVERS[name]
    JP = JPell.from_csr(JCsr.from_matrix_data(JMatrixData.from_coo(*parts)), S=8)
    P = gt.Pell.from_csr(gt.Csr.from_matrix_data(interop.matrix_data_from_arrays(*parts),
                                                 device="cpu"))
    assert P.S == 8 and P.dtype == torch.float32
    jc = [jstop.Iteration(max_iters=400), jstop.ResidualNorm(tolerance=1e-6)]
    pc = [stop.Iteration(max_iters=400), stop.ResidualNorm(tolerance=1e-6)]
    js = JS.build(criteria=jc, preconditioner=JJacobi.build(), **params).generate(JP)
    ps = PS.build(criteria=pc, preconditioner=gt.Jacobi.build(), **params).generate(P)
    b = np.random.default_rng(5).uniform(0.5, 1.5, (P.shape[0], 1)).astype(np.float32)
    monkeypatch.setenv("GINKGO_TPU_FORCE_VMEM_CG", "1")
    jx, jinfo = js.solve(jnp.asarray(b))
    module = {"gmres": sol_gmres, "cbgmres_reduce1": sol_gmres, "ir": sol_ir}.get(
        name, sol_bicgstab)
    seen = _spy(monkeypatch, module, kernel.__name__)
    before = kernel.launches
    px, pinfo = ps.solve(torch.from_numpy(b))
    assert len(seen) == 1 and kernel.launches == before  # its plain version on the CPU
    if name == "cbgmres_reduce1":
        assert seen[0]["basis_dtype"] == torch.bfloat16
    assert px.dtype == torch.float32 and px.shape == b.shape
    assert bool(pinfo.converged.all()) and bool(np.asarray(jinfo.converged).all())
    assert abs(int(pinfo.iterations) - int(jinfo.iterations)) <= 1
    jx = np.asarray(jx)
    np.testing.assert_allclose(px.numpy(), jx, rtol=0, atol=1e-4 * np.abs(jx).max())


def test_pell_routes_and_declines():
    """One float32 column on an S = 8 Pell takes the Pell kernel; Bicg and
    Idr (no Pell kernel in the JAX package), k = 2 columns, krylov_dim >
    100, an S != 8 plan and IR's implicit criterion stream."""
    parts = convdiff_2d(16)
    C = gt.Csr.from_matrix_data(interop.matrix_data_from_arrays(*parts), device="cpu")
    P = gt.Pell.from_csr(C)
    n = P.shape[0]
    b1, b2 = torch.ones(n, 1), torch.ones(n, 2)
    crit = [stop.Iteration(max_iters=300), stop.ResidualNorm(tolerance=1e-6)]
    implicit = [stop.Iteration(max_iters=30), stop.ImplicitResidualNorm(tolerance=1e-6)]
    jac = gt.Jacobi.build(max_block_size=1)
    kernels = (ops_pell_cg.pell_bicgstab_fused, ops_pell_cg.pell_cgs_fused,
               ops_pell_cg.pell_ir_fused, ops_gmres.pell_gmres_fused)

    def takes(factory, A, b):
        s = factory.generate(A)
        s = s._inner() if isinstance(s, gt.CbGmres) else s  # CbGmres runs a Gmres
        return s._try_fused(b, torch.zeros_like(b)) is not None

    for factory in (gt.Bicgstab.build(criteria=crit), gt.Cgs.build(criteria=crit),
                    gt.Gmres.build(criteria=crit, krylov_dim=MAX_FUSED_KRYLOV_DIM),
                    gt.CbGmres.build(criteria=crit, storage_precision="reduce2"),
                    gt.Ir.build(criteria=crit, preconditioner=jac)):
        assert takes(factory, P, b1)
        assert takes(factory, P.reduce_storage(), b1)
        assert not takes(factory, gt.Pell.from_csr(C, S=16), b1)
    assert not takes(gt.Bicgstab.build(criteria=crit), P, b2)
    assert not takes(gt.Gmres.build(criteria=crit), P, b2)
    assert not takes(gt.Gmres.build(criteria=crit, krylov_dim=MAX_FUSED_KRYLOV_DIM + 1), P, b1)
    assert not takes(gt.Gmres.build(criteria=crit, storage_precision="integer"), P, b1)
    assert not takes(gt.Bicg.build(criteria=crit), P, b1)
    assert not takes(gt.Ir.build(criteria=implicit, preconditioner=jac), P, b1)
    assert not takes(gt.Idr.build(criteria=crit), P, b1)
    before = [k.launches for k in kernels]
    for factory, b in ((gt.Bicg.build(criteria=crit), b1), (gt.Idr.build(criteria=crit), b1),
                       (gt.Bicgstab.build(criteria=crit), b2)):
        x, info = factory.generate(P).solve(b)
        assert x.shape == b.shape and bool(info.converged.all())
    assert [k.launches for k in kernels] == before
