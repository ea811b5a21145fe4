"""bfloat16 where the JAX package keeps it: the port's output dtypes against
the JAX package's on the CPU.

- Every format and conversion of the port (``Dense``, ``Csr``, ``Dia``,
  ``Csr.to_dia``, ``Csr.to_bell``, ``Bell.from_csr``, ``Pell.from_csr``,
  ``Well.from_csr``) with float32 and bfloat16 values, applied to float32,
  bfloat16 and float64 vectors: the operator's dtype and the product's
  dtype equal the JAX package's, and the product its values.  ``Dense``,
  ``Csr``, ``Dia`` and ``Bell`` promote the two dtypes; ``Pell`` and
  ``Well`` return the vector's.
- Cg, Bicgstab, Ir, Gmres and Idr with a bfloat16 right-hand side on a
  bfloat16 ``Dia``: a bfloat16 x after the JAX package's iteration count.
- Slice 7: ``Dia.to_csr`` and ``Dia.from_csr`` in the table above;
  ``Dia.to_scipy`` widens bfloat16 to float32 in both packages; the factors
  of every ported factorization of a float32, bfloat16 and float64 ``Dia``
  (bfloat16 factors as float32, scipy having no bfloat16); the
  ``TriangularSolver`` and ``IluPreconditioner`` of both algorithms, and
  their products with float32, bfloat16 and float64 vectors (block_scan
  computes in the vector's dtype, sweeps promote it with the factor's).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ginkgo_tpu as gko
import ginkgo_tpu_torch as gt
from ginkgo_tpu import stop as jstop
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu_torch import stop

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "f64": (jnp.float64, torch.float64)}


def _data(nside=12):
    data = gt.generators.poisson_2d(nside, dtype=np.float32)
    return data, JMatrixData.from_coo(data.shape, data.rows, data.cols, data.values)


def _operators(name, values):
    """(the JAX operator, the port's) of a format or conversion with
    ``values`` ("f32"/"bf16") stored."""
    data, jd = _data()
    jdt, tdt = DTYPES[values]
    if name == "dense":
        return (gko.matrix.dense.Dense.from_matrix_data(jd).astype(jdt),
                gt.Dense.from_matrix_data(data, device="cpu").astype(tdt))
    if name == "dia":
        return (gko.matrix.dia.Dia.from_matrix_data(jd).astype(jdt),
                gt.Dia.from_matrix_data(data, device="cpu").astype(tdt))
    JC = gko.matrix.csr.Csr.from_matrix_data(jd).astype(jdt)
    C = gt.Csr.from_matrix_data(data, device="cpu").astype(tdt)
    JD = gko.matrix.dia.Dia.from_matrix_data(jd).astype(jdt)
    D = gt.Dia.from_matrix_data(data, device="cpu").astype(tdt)
    return {
        "dia.to_csr": lambda: (JD.to_csr(), D.to_csr()),
        "dia.from_csr": lambda: (gko.matrix.dia.Dia.from_csr(JC), gt.Dia.from_csr(C)),
        "csr": lambda: (JC, C),
        "csr.to_dia": lambda: (JC.to_dia(), C.to_dia()),
        "csr.to_bell": lambda: (JC.to_bell(), C.to_bell()),
        "bell.from_csr": lambda: (gko.matrix.bell.Bell.from_csr(JC), gt.Bell.from_csr(C)),
        "pell.from_csr": lambda: (gko.matrix.pell.Pell.from_csr(JC), gt.Pell.from_csr(C)),
        "well.from_csr": lambda: (gko.matrix.well.Well.from_csr(JC), gt.Well.from_csr(C)),
    }[name]()


FORMATS = ("dense", "csr", "dia", "csr.to_dia", "csr.to_bell", "bell.from_csr",
           "pell.from_csr", "well.from_csr", "dia.to_csr", "dia.from_csr")


@pytest.mark.parametrize("vector", sorted(DTYPES))
@pytest.mark.parametrize("values", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_apply_dtype_matches_jax(fmt, values, vector):
    JA, A = _operators(fmt, values)
    assert str(A.dtype).split(".")[-1] == str(JA.dtype)
    jdt, tdt = DTYPES[vector]
    x = np.random.default_rng(3).uniform(0.5, 1.5, (A.shape[1], 1)).astype(np.float32)
    jy = JA.apply(jnp.asarray(x).astype(jdt))
    y = A.apply(torch.from_numpy(x).to(tdt))
    assert str(y.dtype).split(".")[-1] == str(jy.dtype)
    assert y.shape == tuple(jy.shape)
    # the values: both compute in float32 (float64 for float64 operands)
    # and round the product to the output dtype
    tol = 1e-2 if "bfloat16" in str(jy.dtype) else 1e-5
    np.testing.assert_allclose(y.double().numpy(), np.asarray(jy, np.float64),
                               rtol=tol, atol=tol)


SOLVERS = {
    # name: (JAX solver, port solver, build parameters)
    "cg": (gko.solver.Cg, gt.Cg, {}),
    "bicgstab": (gko.solver.Bicgstab, gt.Bicgstab, {}),
    "ir": (gko.solver.Ir, gt.Ir, {}),
    "gmres": (gko.solver.Gmres, gt.Gmres, {}),
    "idr": (gko.solver.Idr, gt.Idr, {}),
}


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_bf16_solve_on_bf16_dia(name):
    """poisson_2d(8) after reduce_storage(), b = ones in bfloat16,
    Iteration(20) and ResidualNorm(1e-3): both packages return a bfloat16
    x after the same number of iterations (Cg 9, Bicgstab 6, Ir 20; the
    Identity-preconditioned Richardson diverges on this matrix in both)."""
    data, jd = _data(8)
    JS, PS, params = SOLVERS[name]
    JA = gko.matrix.dia.Dia.from_matrix_data(jd).reduce_storage()
    A = gt.Dia.from_matrix_data(data, device="cpu").reduce_storage()
    assert A.dtype == torch.bfloat16
    jc = [jstop.Iteration(max_iters=20), jstop.ResidualNorm(tolerance=1e-3)]
    pc = [stop.Iteration(max_iters=20), stop.ResidualNorm(tolerance=1e-3)]
    b = np.ones((A.shape[0], 1), np.float32)
    jx, jinfo = JS.build(criteria=jc, **params).generate(JA).solve(
        jnp.asarray(b, jnp.bfloat16))
    px, pinfo = PS.build(criteria=pc, **params).generate(A).solve(
        torch.from_numpy(b).to(torch.bfloat16))
    assert str(jx.dtype) == "bfloat16" and px.dtype == torch.bfloat16
    assert px.shape == tuple(jx.shape)
    assert int(pinfo.iterations) == int(jinfo.iterations)
    np.testing.assert_array_equal(pinfo.converged.numpy(), np.asarray(jinfo.converged))
    if bool(pinfo.converged.all()):
        # a bfloat16 x holds 8 bits: the two agree to a few of its ulps
        jxf = np.asarray(jx, np.float32)
        np.testing.assert_allclose(px.float().numpy(), jxf, rtol=0,
                                   atol=4 * 2.0**-8 * np.abs(jxf).max())


@pytest.mark.parametrize("values", sorted(DTYPES))
def test_dia_to_scipy_dtype_matches_jax(values):
    JD, D = _operators("dia", values)
    js, ps = JD.to_scipy(), D.to_scipy()
    assert ps.dtype == js.dtype
    np.testing.assert_array_equal(ps.toarray(), js.toarray())


FACTORIZATIONS = ("ParIlu", "ParIc", "Ilu", "Ic", "Lu", "ParIlut", "ParIct")


@pytest.mark.parametrize("values", sorted(DTYPES))
@pytest.mark.parametrize("name", FACTORIZATIONS)
def test_factor_dtypes_match_jax(name, values):
    JD, D = _operators("dia", values)
    jf = getattr(gko.factorization, name)().generate(JD)
    pf = getattr(gt.factorization, name)().generate(D)
    for jop, op in ((jf.l_factor, pf.l_factor), (jf.u_factor, pf.u_factor)):
        assert str(op.dtype).split(".")[-1] == str(jop.dtype)
        assert op.shape == tuple(jop.shape)


@pytest.mark.parametrize("vector", sorted(DTYPES))
@pytest.mark.parametrize("values", sorted(DTYPES))
@pytest.mark.parametrize("algorithm", ["block_scan", "sweeps"])
def test_ilu_apply_dtypes_match_jax(algorithm, values, vector):
    JD, D = _operators("dia", values)
    kw = dict(algorithm=algorithm, sweeps=2)
    JM = gko.preconditioner.Ilu.build(
        l_solver_factory=gko.solver.LowerTrs.build(**kw),
        u_solver_factory=gko.solver.UpperTrs.build(**kw)).generate(JD)
    M = gt.preconditioner.Ilu.build(
        l_solver_factory=gt.solver.LowerTrs.build(**kw),
        u_solver_factory=gt.solver.UpperTrs.build(**kw)).generate(D)
    for jop, op in ((JM, M), (JM.l_solver, M.l_solver), (JM.u_solver, M.u_solver)):
        assert str(op.dtype).split(".")[-1] == str(jop.dtype)
    jdt, tdt = DTYPES[vector]
    x = np.random.default_rng(5).uniform(0.5, 1.5, (D.shape[0], 1)).astype(np.float32)
    jy = JM.apply(jnp.asarray(x).astype(jdt))
    y = M.apply(torch.from_numpy(x).to(tdt))
    assert str(y.dtype).split(".")[-1] == str(jy.dtype)
    tol = 2e-2 if "bfloat16" in str(jy.dtype) else 1e-5
    np.testing.assert_allclose(y.double().numpy(), np.asarray(jy, np.float64), rtol=tol,
                               atol=tol)


# -- slice 8: multigrid (step 0 of its port) --------------------------------------


def _mg_pair(values, nside=16):
    data, jd = _data(nside)
    jdt, tdt = DTYPES[values]
    JD = gko.matrix.dia.Dia.from_matrix_data(jd).astype(jdt)
    D = gt.Dia.from_matrix_data(data, device="cpu").astype(tdt)
    return JD, D


@pytest.mark.parametrize("values", sorted(DTYPES))
def test_pgm_coarse_and_smoother_dtypes_match_jax(values):
    """The coarse operator out of ``PgmFactory.generate`` keeps the fine
    dtype (bfloat16 included) and ``FixedSmoother.dinv`` takes A's."""
    JD, D = _mg_pair(values)
    jl = gko.multigrid.PgmFactory().generate(JD)
    pl = gt.multigrid.PgmFactory().generate(D)
    assert type(pl.coarse_op).__name__ == type(jl.coarse_op).__name__
    assert str(pl.coarse_op.dtype).split(".")[-1] == str(jl.coarse_op.dtype)
    from ginkgo_tpu.solver.multigrid import _fixed_smoother as jsmoother
    from ginkgo_tpu_torch.solver.multigrid import _fixed_smoother

    js, ps = jsmoother(JD), _fixed_smoother(D)
    assert str(ps.dinv.dtype).split(".")[-1] == str(js.dinv.dtype)
    np.testing.assert_array_equal(ps.dinv.double().numpy(), np.asarray(js.dinv, np.float64))


@pytest.mark.parametrize("vector", sorted(DTYPES))
@pytest.mark.parametrize("k", [1, 2])
def test_transfer_dtypes_match_jax(vector, k):
    JD, D = _mg_pair("f32")
    jl = gko.multigrid.PgmFactory().generate(JD)
    pl = gt.multigrid.PgmFactory().generate(D)
    jdt, tdt = DTYPES[vector]
    rng = np.random.default_rng(2)
    for jop, op, n in ((jl.restrict_op, pl.restrict_op, D.shape[0]),
                       (jl.prolong_op, pl.prolong_op, pl.restrict_op.n_coarse)):
        x = rng.uniform(0.5, 1.5, (n, k)).astype(np.float32)
        jy = jop.apply(jnp.asarray(x).astype(jdt))
        y = op.apply(torch.from_numpy(x).to(tdt))
        assert str(y.dtype).split(".")[-1] == str(jy.dtype)
        assert y.shape == tuple(jy.shape)
        tol = 1e-2 if vector == "bf16" else 1e-6
        np.testing.assert_allclose(y.double().numpy(), np.asarray(jy, np.float64), rtol=tol)


@pytest.mark.parametrize("vector", ["f32", "bf16"])
@pytest.mark.parametrize("values", ["f32", "bf16"])
def test_multigrid_apply_and_solve_dtypes_match_jax(values, vector):
    """``Multigrid.apply`` (one cycle) and ``Multigrid.solve`` (Iteration(3))
    on a float32 or bfloat16 ``Dia`` with a float32 or bfloat16 b.  A
    bfloat16 b on a float32 ``Dia``: the cycle promotes to float32, and the
    JAX package's solve loop, whose carry must keep b's dtype, raises; the
    port returns x in the cycle's float32."""
    JD, D = _mg_pair(values)
    jm = gko.solver.Multigrid.build(criteria=[jstop.Iteration(max_iters=3)],
                                    min_coarse_rows=16).generate(JD)
    pm = gt.Multigrid.build(criteria=[stop.Iteration(max_iters=3)],
                            min_coarse_rows=16).generate(D)
    assert str(pm.dtype).split(".")[-1] == str(jm.dtype)
    jdt, tdt = DTYPES[vector]
    b = np.ones(D.shape[0], np.float32)
    jy = jm.apply(jnp.asarray(b).astype(jdt))
    y = pm.apply(torch.from_numpy(b).to(tdt))
    assert str(y.dtype).split(".")[-1] == str(jy.dtype) and y.shape == tuple(jy.shape)
    x, info = pm.solve(torch.from_numpy(b).to(tdt))
    if (values, vector) == ("f32", "bf16"):
        with pytest.raises(TypeError, match="carry"):
            jm.solve(jnp.asarray(b).astype(jdt))
        assert x.dtype == y.dtype == torch.float32
        return
    jx, jinfo = jm.solve(jnp.asarray(b).astype(jdt))
    assert str(x.dtype).split(".")[-1] == str(jx.dtype) and x.shape == tuple(jx.shape)
    assert int(info.iterations) == int(jinfo.iterations)
    assert str(info.residual_norm.dtype).split(".")[-1] == str(jinfo.residual_norm.dtype)
    tol = 5e-2 if "bfloat16" in (str(jx.dtype), str(jy.dtype)) else 1e-4
    for got, want in ((y, jy), (x, jx)):
        w = np.asarray(want, np.float64)
        np.testing.assert_allclose(got.double().numpy(), w, rtol=0, atol=tol * np.abs(w).max())


# -- slice 9: the streaming formats, their conversions and the route ----------------


def _slice9_operators(name, values):
    """(the JAX operator, the port's) of a slice-9 format or conversion with
    ``values`` stored ("f32", "bf16", "f64")."""
    data, jd = _data()
    jdt, tdt = DTYPES[values]
    J = gko.matrix
    JC = J.csr.Csr.from_matrix_data(jd).astype(jdt)
    C = gt.Csr.from_matrix_data(data, device="cpu").astype(tdt)
    JDn = J.dense.Dense.from_matrix_data(jd).astype(jdt)
    Dn = gt.Dense.from_matrix_data(data, device="cpu").astype(tdt)
    builds = {
        "coo": lambda: (J.coo.Coo.from_matrix_data(jd).astype(jdt),
                        gt.Coo.from_matrix_data(data, device="cpu").astype(tdt)),
        "ell": lambda: (J.ell.Ell.from_matrix_data(jd).astype(jdt),
                        gt.Ell.from_matrix_data(data, device="cpu").astype(tdt)),
        "sellp": lambda: (J.ell.Sellp.from_matrix_data(jd).astype(jdt),
                          gt.Sellp.from_matrix_data(data, device="cpu").astype(tdt)),
        "hybrid": lambda: (J.hybrid.Hybrid.from_matrix_data(jd).astype(jdt),
                           gt.Hybrid.from_matrix_data(data, device="cpu").astype(tdt)),
        "sparsity_csr": lambda: (
            J.sparsity_csr.SparsityCsr.from_matrix_data(jd).astype(jdt),
            gt.SparsityCsr.from_matrix_data(data, device="cpu").astype(tdt)),
        "fbcsr": lambda: (J.fbcsr.Fbcsr.from_matrix_data(jd, 4).astype(jdt),
                          gt.Fbcsr.from_matrix_data(data, 4, device="cpu").astype(tdt)),
        "csr.to_coo": lambda: (JC.to_coo(), C.to_coo()),
        "csr.to_ell": lambda: (JC.to_ell(), C.to_ell()),
        "csr.to_sellp": lambda: (JC.to_sellp(), C.to_sellp()),
        "csr.to_hybrid": lambda: (JC.to_hybrid(), C.to_hybrid()),
        "csr.to_fbcsr": lambda: (JC.to_fbcsr(2), C.to_fbcsr(2)),
        "csr.to_sparsity_csr": lambda: (JC.to_sparsity_csr(), C.to_sparsity_csr()),
        "csr.sellp": lambda: (JC.with_strategy("sellp"), C.with_strategy("sellp")),
        "csr.spgemm": lambda: (JC.apply(JC), C.apply(C)),
        "csr.submatrix": lambda: (JC.create_submatrix(slice(0, 100), slice(20, 144)),
                                  C.create_submatrix(slice(0, 100), slice(20, 144))),
        "ell.to_csr": lambda: (J.ell.Ell.from_csr(JC).to_csr(), gt.Ell.from_csr(C).to_csr()),
        "fbcsr.to_csr": lambda: (J.fbcsr.Fbcsr.from_csr(JC, 3).to_csr(),
                                 gt.Fbcsr.from_csr(C, 3).to_csr()),
        "dense.to_csr": lambda: (JDn.to_csr(), Dn.to_csr()),
        "dense.to_coo": lambda: (JDn.to_coo(), Dn.to_coo()),
        "diagonal.to_csr": lambda: (JC.extract_diagonal().to_csr(),
                                    C.extract_diagonal().to_csr()),
    }
    return builds[name]()


SLICE9 = ("coo", "ell", "sellp", "hybrid", "sparsity_csr", "fbcsr", "csr.to_coo", "csr.to_ell",
          "csr.to_sellp", "csr.to_hybrid", "csr.to_fbcsr", "csr.to_sparsity_csr", "csr.sellp",
          "csr.spgemm", "csr.submatrix", "ell.to_csr", "fbcsr.to_csr", "dense.to_csr",
          "dense.to_coo", "diagonal.to_csr")


@pytest.mark.parametrize("vector", ["f32", "f64"])
@pytest.mark.parametrize("values", sorted(DTYPES))
@pytest.mark.parametrize("fmt", SLICE9)
def test_slice9_apply_dtype_matches_jax(fmt, values, vector):
    """Each slice-9 format and conversion keeps the JAX package's value
    dtype, bfloat16 included; its product (the format's own on the CPU)
    has the JAX package's dtype and values."""
    JA, A = _slice9_operators(fmt, values)
    assert str(A.dtype).split(".")[-1] == str(JA.dtype)
    jdt, tdt = DTYPES[vector]
    x = np.random.default_rng(3).uniform(0.5, 1.5, (A.shape[1], 2)).astype(np.float32)
    jy = JA.apply(jnp.asarray(x).astype(jdt))
    y = A.apply(torch.from_numpy(x).to(tdt))
    assert str(y.dtype).split(".")[-1] == str(jy.dtype) and y.shape == tuple(jy.shape)
    tol = 1e-2 if "bfloat16" in str(jy.dtype) else 1e-5
    np.testing.assert_allclose(y.double().numpy(), np.asarray(jy, np.float64), rtol=tol,
                               atol=tol)


ROUTE9 = ("coo", "ell", "sellp", "hybrid", "sparsity_csr", "fbcsr")


@pytest.mark.parametrize("vector", ["f32", "f64"])
@pytest.mark.parametrize("values", sorted(DTYPES))
@pytest.mark.parametrize("fmt", ROUTE9)
def test_slice9_route_dtype_matches_jax(fmt, values, vector, monkeypatch):
    """The streaming route's product (the kernels' plain versions on CPU
    tensors) in the JAX route's dtype, the vector's, against the JAX route
    forced on the CPU (its Pallas kernels in interpret mode)."""
    from ginkgo_tpu.ops import spmv_pallas
    from ginkgo_tpu_torch.ops import pell as ops_pell

    monkeypatch.setenv("GINKGO_TPU_FORCE_STREAMING", "1")
    JA, A = _slice9_operators(fmt, values)
    jdt, tdt = DTYPES[vector]
    x = np.random.default_rng(4).uniform(0.5, 1.5, (A.shape[1], 1)).astype(np.float32)
    jy = spmv_pallas.linop_streaming_spmv(JA, jnp.asarray(x).astype(jdt))
    y = ops_pell.linop_streaming_spmv(A, torch.from_numpy(x).to(tdt))
    assert jy is not None and y is not None
    assert str(y.dtype).split(".")[-1] == str(jy.dtype) and y.shape == tuple(jy.shape)
    tol = 1e-2 if values == "bf16" else 1e-5
    np.testing.assert_allclose(y.double().numpy(), np.asarray(jy, np.float64), rtol=tol,
                               atol=tol)
