"""The reorderings (slice 10): the port (ginkgo_tpu_torch.reorder) against
the JAX package (ginkgo_tpu.reorder) on the CPU.

- ``rcm_permutation`` with both starting strategies, ``bandwidth`` and
  ``nd_permutation``: equal element for element (``np.array_equal``) on
  2-D Poisson matrices of 16^2 to 48^2 rows under a seeded random
  symmetric permutation, a disconnected nonsymmetric pattern, a pattern
  with a one-sided band, and a 1-row matrix.  The port's RCM walks its
  levels in numpy, the JAX package's node by node; the order must agree.
- The factories return a ``Permutation`` on A's device with those entries.
- ``ScaledReordered`` with RCM and no scaling, row scaling, column scaling
  and both, around a ``Direct`` solver: x within 1e-12 relative of the JAX
  package's in float64.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sps
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.matrix.csr import Csr as JCsr
from ginkgo_tpu.matrix.diagonal import Diagonal as JDiagonal
from ginkgo_tpu.reorder import (
    NestedDissectionFactory as JNd,
    RcmFactory as JRcm,
    ScaledReorderedFactory as JScaledReordered,
    bandwidth as j_bandwidth,
    nd_permutation as j_nd,
    rcm_permutation as j_rcm,
)
from ginkgo_tpu.solver.direct import Direct as JDirect
from ginkgo_tpu_torch import reorder
from ginkgo_tpu_torch.solver import Direct


@pytest.fixture(autouse=True)
def _one_thread():
    """Solver loops of many small tensor ops: one intra-op thread, so that
    they do not spin against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scrambled_poisson(nside, seed=1):
    d = gt.generators.poisson_2d(nside, dtype=np.float64)
    p = np.random.default_rng(seed).permutation(d.shape[0])
    inv = np.empty_like(p)
    inv[p] = np.arange(len(p))
    return d.shape, inv[d.rows], inv[d.cols], d.values


def _parts(name):
    if name.startswith("poisson"):
        return _scrambled_poisson(int(name[len("poisson"):]))
    if name == "disconnected":  # random nonsymmetric pattern, many components
        a = (sps.random(300, 300, density=0.008, random_state=3, format="coo")
             + sps.eye(300)).tocoo()
        return a.shape, a.row, a.col, a.data
    if name == "upper_band":  # nonsymmetric: only the diagonal and two above
        n = 200
        i = np.arange(n)
        rows = np.concatenate([i, i[:-1], i[:-3]])
        cols = np.concatenate([i, i[:-1] + 1, i[:-3] + 3])
        return (n, n), rows, cols, np.linspace(1.0, 2.0, len(rows))
    return (1, 1), np.array([0]), np.array([0]), np.array([2.0])  # one row


def _pair(name):
    shape, rows, cols, vals = _parts(name)
    C = gt.Csr.from_matrix_data(gt.MatrixData.from_coo(shape, rows, cols, vals), device="cpu")
    J = JCsr.from_matrix_data(JMatrixData.from_coo(shape, rows, cols, vals))
    return C, J


CASES = ["poisson16", "poisson33", "poisson48", "disconnected", "upper_band", "one_row"]


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("strategy", ["pseudo_peripheral", "minimum_degree"])
def test_rcm_permutation_matches_jax(name, strategy):
    C, J = _pair(name)
    p = reorder.rcm_permutation(C, strategy)
    assert p.dtype == np.int64
    np.testing.assert_array_equal(p, j_rcm(J, strategy))
    assert sorted(p.tolist()) == list(range(C.shape[0]))
    perm = reorder.Rcm.build(starting_strategy=strategy).generate(C)
    assert perm.permutation.device == C.device
    np.testing.assert_array_equal(perm.to_host(),
                                  np.asarray(JRcm(strategy).generate(J).permutation))


@pytest.mark.parametrize("name", CASES)
def test_bandwidth_and_nd_match_jax(name):
    C, J = _pair(name)
    p = reorder.rcm_permutation(C)
    assert reorder.bandwidth(C) == j_bandwidth(J)
    assert reorder.bandwidth(C.symm_permute(p)) == j_bandwidth(J.symm_permute(p))
    q = reorder.nd_permutation(C)
    np.testing.assert_array_equal(q, j_nd(J))
    perm = reorder.NestedDissection.build().generate(C)
    np.testing.assert_array_equal(perm.to_host(), np.asarray(JNd().generate(J).permutation))


def test_rcm_reduces_the_bandwidth():
    C, _ = _pair("poisson48")
    assert reorder.bandwidth(C.symm_permute(reorder.rcm_permutation(C))) <= 2 * 48
    assert reorder.bandwidth(C) > 1000


@pytest.mark.parametrize("scaling", ["none", "row", "col", "both"])
def test_scaled_reordered_matches_jax(scaling):
    """(R P A P^T C) y = R P b, x = P^T C y, with RCM and a Direct inner
    solver: x within 1e-12 relative of the JAX package's, float64."""
    shape, rows, cols, vals = _parts("poisson16")
    vals = vals + 0.1 * np.sin(np.arange(len(vals)))  # nonsymmetric values
    C = gt.Csr.from_matrix_data(gt.MatrixData.from_coo(shape, rows, cols, vals), device="cpu")
    J = JCsr.from_matrix_data(JMatrixData.from_coo(shape, rows, cols, vals))
    rng = np.random.default_rng(7)
    d_row = rng.uniform(0.5, 2.0, shape[0])
    d_col = rng.uniform(0.5, 2.0, shape[0])
    kw, jkw = {}, {}
    if scaling in ("row", "both"):
        kw["row_scaling"] = gt.Diagonal.create(d_row, device="cpu")
        jkw["row_scaling"] = JDiagonal(values=jnp.asarray(d_row))
    if scaling in ("col", "both"):
        kw["col_scaling"] = gt.Diagonal.create(d_col, device="cpu")
        jkw["col_scaling"] = JDiagonal(values=jnp.asarray(d_col))
    S = reorder.ScaledReorderedFactory(Direct.build(), reordering=reorder.RcmFactory(),
                                       **kw).generate(C)
    JS = JScaledReordered(JDirect.build(), reordering=JRcm(), **jkw).generate(J)
    np.testing.assert_array_equal(S.permutation.to_host(), np.asarray(JS.permutation.permutation))
    b = rng.standard_normal(shape[0])
    x = S.apply(torch.from_numpy(b)).numpy()
    jx = np.asarray(JS.apply(jnp.asarray(b)))
    np.testing.assert_allclose(x, jx, rtol=1e-12, atol=1e-12 * np.abs(jx).max())
    B = rng.standard_normal((shape[0], 2))
    np.testing.assert_allclose(S.solve(torch.from_numpy(B)).numpy(),
                               np.asarray(JS.solve(jnp.asarray(B))), rtol=1e-12, atol=1e-11)
    if scaling == "none":  # then x solves A x = b itself
        np.testing.assert_allclose(C.to_scipy() @ x, b, atol=1e-10)
