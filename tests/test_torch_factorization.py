"""Slice 7, factorizations, ISAI and the direct solver: the port
(ginkgo_tpu_torch) against the JAX package (ginkgo_tpu) on the CPU.

- ``Dia.to_csr``, ``Dia.to_scipy`` and ``Dia.from_csr``: the same entries
  and dtypes as the JAX package's (bfloat16 stays bfloat16 except in
  ``to_scipy``, which widens to float32 in both).
- ILU(0) and IC(0) (host copies), ParILU and ParIC (the sweeps on the
  device as PyTorch ops), ParILUT and ParICT (host loop, device sweeps),
  in float64 on a 16^2 matrix: the same patterns, and values within 1e-12
  relative (the two packages sum each output's products in the same order,
  the JAX package by a scatter-add, the port by a segment sum over the
  sorted product map); two ParILU runs are bit-identical.
- ISAI, all four types, sparsity power 1 and 2: the approximate inverse
  within 1e-10 relative (batched dense solves through LAPACK in both).
- LU (SuperLU, natural order) and Direct: the factors, the row
  permutation and the solution against the JAX package's; an explicit
  symmetric permutation; the named reorderings raise NotImplementedError_.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.factorization import (
    IcFactory as JIc,
    IluFactory as JIlu,
    LuFactory as JLu,
    ParIcFactory as JParIc,
    ParIctFactory as JParIct,
    ParIluFactory as JParIlu,
    ParIlutFactory as JParIlut,
    elimination_forest as j_elimination_forest,
    symbolic_cholesky as j_symbolic_cholesky,
)
from ginkgo_tpu.matrix.csr import Csr as JCsr
from ginkgo_tpu.matrix.dia import Dia as JDia
from ginkgo_tpu.preconditioner.isai import IsaiFactory as JIsai
from ginkgo_tpu.solver.direct import Direct as JDirect
from ginkgo_tpu_torch import factorization as fz
from ginkgo_tpu_torch.base.exceptions import NotImplementedError_
from ginkgo_tpu_torch.preconditioner import Ilu, IsaiFactory
from ginkgo_tpu_torch.solver import Direct
from tests.test_torch_bicgstab import convdiff_2d


def _parts(name, dtype=np.float64):
    if name == "poisson16":
        d = gt.generators.poisson_2d(16, dtype=np.float64)
        parts = (d.shape, d.rows, d.cols, d.values)
    else:  # "convdiff16": nonsymmetric, jittered diagonal
        parts = convdiff_2d(16, jitter_seed=5)
    shape, rows, cols, vals = parts
    return shape, rows, cols, np.asarray(vals).astype(dtype)


def _csr_pair(name, dtype=np.float64):
    parts = _parts(name, dtype)
    return (JCsr.from_matrix_data(JMatrixData.from_coo(*parts)),
            gt.Csr.from_matrix_data(gt.MatrixData.from_coo(*parts), device="cpu"))


def _assert_csr_equal(J, P, rtol):
    js, ps = J.to_scipy().tocsr(), P.to_scipy().tocsr()
    js.sort_indices()
    ps.sort_indices()
    np.testing.assert_array_equal(ps.indptr, js.indptr)
    np.testing.assert_array_equal(ps.indices, js.indices)
    assert str(P.dtype).split(".")[-1] == str(J.dtype)
    np.testing.assert_allclose(ps.data, js.data, rtol=rtol, atol=rtol * np.abs(js.data).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_dia_conversions_match_jax(dtype):
    data = gt.generators.poisson_2d(8, dtype=np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    JA = JDia.from_matrix_data(JMatrixData.from_coo(data.shape, data.rows, data.cols,
                                                    data.values)).astype(jdt)
    A = gt.Dia.from_matrix_data(data, device="cpu").astype(tdt)
    JC, C = JA.to_csr(), A.to_csr()
    assert str(C.dtype).split(".")[-1] == str(JC.dtype) == dtype
    np.testing.assert_array_equal(C.row_ptrs.numpy(), np.asarray(JC.row_ptrs))
    np.testing.assert_array_equal(C.col_idxs.numpy(), np.asarray(JC.col_idxs))
    np.testing.assert_array_equal(C.values.double().numpy(), np.asarray(JC.values, np.float64))
    js, ps = JA.to_scipy(), A.to_scipy()
    assert ps.dtype == js.dtype and ps.offsets.tolist() == js.offsets.tolist()
    np.testing.assert_array_equal(ps.toarray(), js.toarray())
    JB, B = JDia.from_csr(JC), gt.Dia.from_csr(C)
    assert str(B.dtype).split(".")[-1] == str(JB.dtype) == dtype
    assert B.offsets == JB.offsets
    np.testing.assert_array_equal(B.to_dense().values.double().numpy(),
                                  np.asarray(JB.to_dense().values, np.float64))


@pytest.mark.parametrize("name", ["ilu", "ic"])
def test_exact_incomplete_factorizations_match_jax(name):
    JC, C = _csr_pair("convdiff16" if name == "ilu" else "poisson16")
    jf = (JIlu if name == "ilu" else JIc)().generate(JC)
    pf = (fz.IluFactory if name == "ilu" else fz.IcFactory)().generate(C)
    _assert_csr_equal(jf.l_factor, pf.l_factor, 1e-14)
    _assert_csr_equal(jf.u_factor, pf.u_factor, 1e-14)


@pytest.mark.parametrize("iterations", [1, 5])
@pytest.mark.parametrize("name", ["parilu", "paric"])
def test_parilu_paric_match_jax(name, iterations):
    JC, C = _csr_pair("convdiff16" if name == "parilu" else "poisson16")
    jfac, pfac = (JParIlu, fz.ParIluFactory) if name == "parilu" else (JParIc, fz.ParIcFactory)
    jf = jfac(iterations=iterations).generate(JC)
    pf = pfac(iterations=iterations).generate(C)
    _assert_csr_equal(jf.l_factor, pf.l_factor, 1e-12)
    _assert_csr_equal(jf.u_factor, pf.u_factor, 1e-12)
    again = pfac(iterations=iterations).generate(C)
    assert torch.equal(again.l_factor.values, pf.l_factor.values)
    assert torch.equal(again.u_factor.values, pf.u_factor.values)


@pytest.mark.parametrize("name", ["parilu", "paric"])
def test_parilu_float32_matches_jax(name):
    JC, C = _csr_pair("convdiff16" if name == "parilu" else "poisson16", np.float32)
    jfac, pfac = (JParIlu, fz.ParIluFactory) if name == "parilu" else (JParIc, fz.ParIcFactory)
    jf, pf = jfac().generate(JC), pfac().generate(C)
    _assert_csr_equal(jf.l_factor, pf.l_factor, 1e-6)
    _assert_csr_equal(jf.u_factor, pf.u_factor, 1e-6)


@pytest.mark.parametrize("name", ["parilut", "parict"])
def test_parilut_parict_match_jax(name):
    JC, C = _csr_pair("convdiff16" if name == "parilut" else "poisson16")
    jfac, pfac = (JParIlut, fz.ParIlutFactory) if name == "parilut" else (JParIct,
                                                                          fz.ParIctFactory)
    jf = jfac(iterations=2, fill_in_limit=1.5).generate(JC)
    pf = pfac(iterations=2, fill_in_limit=1.5).generate(C)
    _assert_csr_equal(jf.l_factor, pf.l_factor, 1e-10)
    _assert_csr_equal(jf.u_factor, pf.u_factor, 1e-10)


@pytest.mark.parametrize("power", [1, 2])
@pytest.mark.parametrize("isai_type", ["lower", "upper", "general", "spd"])
def test_isai_matches_jax(isai_type, power):
    JC, C = _csr_pair("poisson16" if isai_type == "spd" else "convdiff16")
    jm = JIsai(isai_type, power).generate(JC)
    pm = IsaiFactory(isai_type, power).generate(C)
    if isai_type == "spd":
        assert isinstance(pm, gt.Composition) and len(pm.operators) == 2
        jm, pm = jm.operators[1], pm.operators[1]
    _assert_csr_equal(jm, pm, 1e-10)


def test_lu_and_direct_match_jax():
    JC, C = _csr_pair("convdiff16")
    jf, pf = JLu().generate(JC), fz.LuFactory().generate(C)
    _assert_csr_equal(jf.l_factor, pf.l_factor, 1e-13)
    _assert_csr_equal(jf.u_factor, pf.u_factor, 1e-13)
    for jp, pp in ((jf.row_perm, pf.row_perm), (jf.col_perm, pf.col_perm)):
        assert (jp is None) == (pp is None)
        if pp is not None:
            np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    n = C.shape[0]
    b = np.random.default_rng(8).standard_normal((n, 2))
    exact = np.linalg.solve(C.to_scipy().toarray(), b)
    perm = np.random.default_rng(9).permutation(n)
    for reorder in (None, perm):
        js = JDirect.build(factorization=JLu(reorder=reorder)).generate(JC)
        ps = Direct.build(factorization=fz.LuFactory(reorder=reorder)).generate(C)
        x, info = ps.solve(torch.from_numpy(b))
        jx, _ = js.solve(jnp.asarray(b))
        assert int(info.iterations) == 1 and bool(info.converged.all())
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(x.numpy(), exact, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("reorder", ["rcm", "nd", "auto"])
def test_lu_reorder_strings_raise(reorder):
    _, C = _csr_pair("poisson16")
    with pytest.raises(NotImplementedError_, match="ROADMAP"):
        fz.LuFactory(reorder=reorder).generate(C)


def test_symbolic_analysis_matches_jax():
    _, C = _csr_pair("poisson16")
    sp = C.to_scipy()
    np.testing.assert_array_equal(fz.elimination_forest(sp), j_elimination_forest(sp))
    np.testing.assert_array_equal(fz.symbolic_cholesky(sp).toarray(),
                                  j_symbolic_cholesky(sp).toarray())


def test_ilu_preconditioner_takes_factors():
    """generate() takes a system matrix, a Factorization or a Composition of
    two factors; a reordered factorization raises."""
    _, C = _csr_pair("convdiff16")
    fact = fz.IluFactory().generate(C)
    b = torch.from_numpy(np.random.default_rng(10).standard_normal(C.shape[0]))
    want = Ilu.build().generate(fact).apply(b)
    for op in (fact.to_composition(), fact):
        assert torch.equal(Ilu.build().generate(op).apply(b), want)
    perm = np.arange(C.shape[0])[::-1].copy()
    with pytest.raises(ValueError, match="reorder"):
        Ilu.build().generate(fz.LuFactory(reorder=perm).generate(C))
