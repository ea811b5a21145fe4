"""Csr of the port (ginkgo_tpu_torch.Csr) against the JAX package's Csr on
the CPU: every ported SpMV strategy, the "auto" host branch, and the
structure ops, on identical operands.

Tolerances: float64 products agree to 1e-12 relative (the two packages sum
a row's products in another order); float32 to 1e-5 relative with an
absolute floor of 1e-5 (2e-4 for merge_path, whose row sums are
differences of a running prefix sum over all products, so their error
scales with the prefix, not with the row).  Structure ops move values
without arithmetic and must agree exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sps
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.matrix.csr import Csr as JCsr
from ginkgo_tpu_torch import interop
from ginkgo_tpu_torch.base.exceptions import NotImplementedError_


def _pattern(m=40, n=50, seed=3, skewed=True, square_diag=False):
    """Random entries with one empty row and, when ``skewed``, one heavy
    row (so the host "auto" branch picks merge_path)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, 160)
    cols = rng.integers(0, n, 160)
    rows = rows[rows != 7]  # row 7 stays empty
    if skewed:
        rows = np.concatenate([rows, np.full(n, 11)])
        cols = np.concatenate([cols[: len(rows) - n], np.arange(n)])
    else:
        cols = cols[: len(rows)]
    if square_diag:
        rows = np.concatenate([rows, np.arange(m)])
        cols = np.concatenate([cols, np.arange(m)])
    vals = rng.standard_normal(len(rows))
    return rows, cols, vals


def _pair(dtype=np.float64, strategy="auto", **kw):
    m, n = kw.pop("m", 40), kw.pop("n", 50)
    rows, cols, vals = _pattern(m, n, **kw)
    vals = vals.astype(dtype)
    jd = JMatrixData.from_coo((m, n), rows, cols, vals)
    pd = interop.matrix_data_from_arrays((m, n), rows, cols, vals)
    JA = JCsr.from_matrix_data(jd, strategy=strategy)
    A = gt.Csr.from_matrix_data(pd, device="cpu", strategy=strategy)
    return JA, A


STRATEGIES = ("classical", "merge_path", "sparselib", "auto")


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("dtype,k", [(np.float64, 1), (np.float32, 3)])
def test_spmv_strategies_match_jax(strategy, dtype, k):
    JA, A = _pair(dtype, strategy)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((50, k)).astype(dtype)
    if k == 1:
        x = x[:, 0]
    got = A.apply(torch.from_numpy(x)).numpy()
    want = np.asarray(JA.apply(jnp.asarray(x)))
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    else:
        atol = 2e-4 if A._resolve_strategy() == "merge_path" else 1e-5
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    # alpha A x + beta y through apply_advanced
    y = rng.standard_normal(got.shape).astype(dtype)
    got = A.apply_advanced(0.5, torch.from_numpy(x), -2.0, torch.from_numpy(y)).numpy()
    want = np.asarray(JA.apply_advanced(0.5, jnp.asarray(x), -2.0, jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=1e-5 if dtype == np.float32 else 1e-12,
                               atol=2e-4 if dtype == np.float32 else 1e-12)


@pytest.mark.parametrize("skewed", [True, False])
def test_auto_host_branch_matches_jax(skewed):
    JA, A = _pair(skewed=skewed)
    assert A._resolve_strategy() == JA._resolve_strategy()
    assert A._resolve_strategy() == ("merge_path" if skewed else "classical")
    np.testing.assert_array_equal(A.host_row_lengths(), JA.host_row_lengths())


def test_sellp_strategy_is_not_ported_yet():
    _, A = _pair(strategy="sellp")
    with pytest.raises(NotImplementedError_, match="Ell/Sellp"):
        A.apply(torch.ones(50, dtype=torch.float64))
    with pytest.raises(ValueError):
        A.with_strategy("fastest")


def test_constructors_match_jax():
    rows, cols, vals = _pattern()
    sp = sps.coo_matrix((vals, (rows, cols)), shape=(40, 50)).tocsr()
    sp.sum_duplicates()
    JA = JCsr.from_scipy(sp)
    for A in (gt.Csr.from_scipy(sp, device="cpu"),
              gt.Csr.create(sp.shape, sp.indptr, sp.indices, sp.data, device="cpu")):
        for f in ("row_ptrs", "col_idxs", "values"):
            np.testing.assert_array_equal(getattr(A, f).numpy(), np.asarray(getattr(JA, f)))
        assert A.shape == JA.shape and A.nnz == JA.nnz
    data = interop.matrix_data_from_arrays((40, 50), rows, cols, vals)
    A64 = gt.Csr.from_matrix_data(data, device="cpu", index_dtype=torch.int64)
    JA64 = JCsr.from_matrix_data(JMatrixData.from_coo((40, 50), rows, cols, vals))
    assert A64.row_ptrs.dtype == A64.col_idxs.dtype == torch.int64
    np.testing.assert_array_equal(A64.col_idxs.numpy(), np.asarray(JA64.col_idxs))
    np.testing.assert_array_equal(A64.to_dense().values.numpy(), np.asarray(JA64.to_dense().values))


def test_transpose_and_value_ops_match_jax():
    JA, A = _pair(m=30, n=30, square_diag=True)
    for jm, pm in ((JA.transpose(), A.transpose()),
                   (JA.conj_transpose(), A.conj_transpose()),
                   (JA.scale(2.5), A.scale(2.5)),
                   (JA.inv_scale(4.0), A.inv_scale(4.0)),
                   (JA.compute_absolute(), A.compute_absolute()),
                   (JA.add_scaled_identity(0.75, -1.5), A.add_scaled_identity(0.75, -1.5))):
        assert pm.shape == jm.shape
        for f in ("row_ptrs", "col_idxs", "values"):
            np.testing.assert_array_equal(getattr(pm, f).numpy(), np.asarray(getattr(jm, f)))
    np.testing.assert_array_equal(A.extract_diagonal().values.numpy(),
                                  np.asarray(JA.extract_diagonal().values))
    # a rectangular transpose keeps the (column, row) order too
    JR, R = _pair()
    T, JT = R.transpose(), JR.transpose()
    assert T.shape == (50, 40)
    for f in ("row_ptrs", "col_idxs", "values"):
        np.testing.assert_array_equal(getattr(T, f).numpy(), np.asarray(getattr(JT, f)))


def test_permutations_match_jax():
    JA, A = _pair(m=30, n=30, square_diag=True)
    perm = np.random.default_rng(8).permutation(30)
    for op in ("row_permute", "column_permute", "symm_permute",
               "inverse_row_permute", "inverse_column_permute"):
        pm, jm = getattr(A, op)(perm), getattr(JA, op)(perm)
        for f in ("row_ptrs", "col_idxs", "values"):
            np.testing.assert_array_equal(getattr(pm, f).numpy(), np.asarray(getattr(jm, f)))


def test_lookup_matches_jax():
    JA, A = _pair()
    rng = np.random.default_rng(9)
    md = A.to_matrix_data()
    pick = rng.integers(0, md.nnz, 25)
    rows = np.concatenate([md.rows[pick], rng.integers(0, 40, 25), [7, 39]])
    cols = np.concatenate([md.cols[pick], rng.integers(0, 50, 25), [0, 49]])
    got = A.lookup(rows, cols).numpy()
    want = np.asarray(JA.lookup(rows, cols))
    np.testing.assert_array_equal(got, want)
    assert (got[:25] >= 0).all() and got.dtype == np.int32
    np.testing.assert_array_equal(A.values.numpy()[got[:25]], md.values[pick])
    grid = A.lookup(rows.reshape(4, 13), cols.reshape(4, 13))
    assert grid.shape == (4, 13)


def test_conversions_match_jax():
    JA, A = _pair()
    md, jmd = A.to_matrix_data(), JA.to_matrix_data()
    for f in ("rows", "cols", "values"):
        np.testing.assert_array_equal(getattr(md, f), getattr(jmd, f))
    np.testing.assert_array_equal(A.to_dense().values.numpy(), np.asarray(JA.to_dense().values))
    np.testing.assert_array_equal(A.to_scipy().toarray(), JA.to_scipy().toarray())
    assert A.astype(torch.float32).dtype == torch.float32
    np.testing.assert_array_equal(A.astype(torch.float32).values.numpy(),
                                  np.asarray(JA.astype(jnp.float32).values))
    # to_dia on a banded matrix
    data = gt.generators.poisson_2d(6)
    B = gt.Csr.from_matrix_data(data, device="cpu")
    JB = JCsr.from_matrix_data(JMatrixData.from_coo(data.shape, data.rows, data.cols, data.values))
    D, JD = B.to_dia(), JB.to_dia()
    assert D.offsets == tuple(int(o) for o in JD.offsets)
    np.testing.assert_array_equal(D.to_dense().values.numpy(), np.asarray(JD.to_dense().values))
    assert B.to_csr() is B


def test_bfloat16_csr_applies_in_float32():
    """Reduced storage: a bfloat16 Csr computes its products in float32 on
    every strategy."""
    _, A = _pair(np.float32)
    Ab = A.astype(torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(50).astype(np.float32))
    want = A.astype(torch.float32).replace(values=Ab.values.float()).apply(x)
    for strategy in ("classical", "merge_path", "sparselib"):
        got = Ab.with_strategy(strategy).apply(x)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-4)
