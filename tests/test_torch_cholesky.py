"""Cholesky on the native up-looking kernel and the reordered direct solve
(slice 10): the port against the JAX package on the CPU.

- ``CholeskyFactory`` on ``poisson_2d(24)`` in float64 under reorder None,
  'rcm', 'nd' and 'auto': the same permutations element for element, the
  same L and U within 1e-12 (both run ``native/cholesky.cpp``; the port
  builds it with its own loader into ``build/native/``), the native route
  counted; L has the symbolic fill pattern and U is its transpose.
- ``Direct`` with it: x within 1e-12 relative of the JAX package's.
- A matrix that is not positive definite raises ``LinAlgError``.
- A complex Hermitian matrix takes the dense LL^H route, the same factors.
- The loader: a source the compiler refuses raises; with no compiler a
  real matrix takes the bounded dense factor, the same as the native one.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.factorization.lu import CholeskyFactory as JCholesky
from ginkgo_tpu.matrix.csr import Csr as JCsr
from ginkgo_tpu.solver.direct import Direct as JDirect
from ginkgo_tpu_torch import _native
from ginkgo_tpu_torch import factorization as fz
from ginkgo_tpu_torch.solver import Direct


@pytest.fixture(autouse=True)
def _one_thread():
    """Solver loops of many small tensor ops: one intra-op thread, so that
    they do not spin against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(shape, rows, cols, vals):
    C = gt.Csr.from_matrix_data(gt.MatrixData.from_coo(shape, rows, cols, vals), device="cpu")
    J = JCsr.from_matrix_data(JMatrixData.from_coo(shape, rows, cols, vals))
    return C, J


def _poisson(nside=24):
    d = gt.generators.poisson_2d(nside, dtype=np.float64)
    return _pair(d.shape, d.rows, d.cols, d.values)


def _assert_factor(f, g):
    """The same L and U within 1e-12 (as dense arrays: where the JAX
    package's loader found no library in this process it takes its dense
    factor, the same numbers), and the same permutations element for
    element."""
    for a, b in ((f.l_factor, g.l_factor), (f.u_factor, g.u_factor)):
        np.testing.assert_allclose(a.to_scipy().toarray(), np.asarray(b.to_scipy().toarray()),
                                   rtol=1e-12, atol=1e-12)
    for mine, theirs in ((f.row_perm, g.row_perm), (f.col_perm, g.col_perm)):
        assert (mine is None) == (theirs is None)
        if mine is not None:
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("reorder", [None, "rcm", "nd", "auto"])
def test_native_factor_matches_jax(reorder):
    C, J = _poisson()
    before = dict(fz.CholeskyFactory.routes)
    f = fz.CholeskyFactory(reorder=reorder).generate(C)
    assert fz.CholeskyFactory.routes["native"] == before["native"] + 1
    g = JCholesky(reorder=reorder).generate(J)
    _assert_factor(f, g)
    L = f.l_factor.to_scipy()
    sym = C.symm_permute(f.row_perm.numpy()).to_scipy() if reorder else C.to_scipy()
    np.testing.assert_array_equal((L != 0).toarray(),
                                  fz.symbolic_cholesky(sym).toarray() != 0)
    assert (f.u_factor.to_scipy() != L.T).nnz == 0
    b = np.random.default_rng(3).standard_normal(C.shape[0])
    x, info = Direct.build(factorization=fz.Cholesky(reorder=reorder)).generate(C).solve(
        torch.from_numpy(b))
    jx, _ = JDirect.build(factorization=JCholesky(reorder=reorder)).generate(J).solve(
        jnp.asarray(b))
    assert bool(info.converged.all())
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(C.to_scipy() @ x.numpy(), b, atol=1e-10)


def test_not_positive_definite_raises():
    d = gt.generators.poisson_2d(8, dtype=np.float64)
    vals = np.where(d.rows == d.cols, -d.values, d.values)
    C, J = _pair(d.shape, d.rows, d.cols, vals)
    with pytest.raises(np.linalg.LinAlgError, match="positive definite"):
        fz.CholeskyFactory(reorder=None).generate(C)
    with pytest.raises(np.linalg.LinAlgError):
        JCholesky(reorder=None).generate(J)


def test_complex_hermitian_takes_the_dense_route():
    d = gt.generators.poisson_2d(6, dtype=np.float64)
    rows, cols = d.rows, d.cols
    skew = 0.3 * (rows - cols) / np.maximum(np.abs(rows - cols), 1)
    vals = d.values + 1j * skew  # Hermitian: A[i, j] = conj(A[j, i])
    C, J = _pair(d.shape, rows, cols, vals.astype(np.complex128))
    before = fz.CholeskyFactory.routes["complex_dense"]
    f = fz.CholeskyFactory(reorder="rcm").generate(C)
    assert fz.CholeskyFactory.routes["complex_dense"] == before + 1
    g = JCholesky(reorder="rcm").generate(J)
    assert f.l_factor.dtype == torch.complex128
    np.testing.assert_allclose(f.l_factor.to_scipy().toarray(),
                               np.asarray(g.l_factor.to_scipy().toarray()), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(f.u_factor.to_scipy().toarray(),
                               f.l_factor.to_scipy().toarray().conj().T)


def test_refused_source_raises_and_no_compiler_falls_back(monkeypatch, tmp_path):
    bad = tmp_path / "cholesky.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "SOURCE", bad)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "_LIB", [])
    if _native.find_cxx() is not None:
        with pytest.raises(_native.NativeBuildError, match="failed"):
            _native.load()
        assert not list((tmp_path / "build").glob("*.so"))
    # no compiler at all: the bounded dense factor, the same factor
    monkeypatch.setattr(_native, "find_cxx", lambda: None)
    C, J = _poisson(10)
    before = fz.CholeskyFactory.routes["dense"]
    f = fz.CholeskyFactory(reorder="nd").generate(C)
    assert fz.CholeskyFactory.routes["dense"] == before + 1
    g = JCholesky(reorder="nd").generate(J)
    np.testing.assert_allclose(f.l_factor.to_scipy().toarray(),
                               np.asarray(g.l_factor.to_scipy().toarray()), rtol=1e-12,
                               atol=1e-12)


def test_library_goes_to_build_native():
    assert _native.load() is not None
    path = _native.library_path()
    assert path.parent == _native.REPO / "build" / "native" and path.exists()
    assert _native.is_built()
