"""Slice 8, multigrid coarsening: the port's ``multigrid/pgm.py`` against
the JAX package's on the CPU.

- ``PgmFactory.generate`` on the same operator in both packages: identical
  aggregates, identical coarse operators (class and every entry) and
  identical transfer kinds, strides and deltas, on poisson_2d(32) and (48)
  as ``Dia``, convdiff_2d(32) as ``Dia``, the 9-point Poisson matrix as
  ``Dia`` and a random SPD matrix as ``Csr`` (the general segment-sum
  transfers);
- the transfers' products equal the JAX package's in float64, for one and
  two columns; the banded pair equals the general pair on bounded-delta
  aggregations;
- ``FixedCoarsening``: the coarse operator and the transfers;
- the factory's hierarchy: level sizes, and the dense coarse inverse equal
  to the JAX package's (cut from its padded frame and transposed).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.matrix.csr import Csr as JCsr
from ginkgo_tpu.matrix.dia import Dia as JDia
from ginkgo_tpu.multigrid import pgm as jpgm
from ginkgo_tpu.solver.multigrid import Multigrid as JMultigrid
from ginkgo_tpu.utils import generators as jgen
from ginkgo_tpu_torch.multigrid import pgm
from tests.test_torch_bicgstab import convdiff_2d


def _parts(name):
    if name == "poisson32":
        d = jgen.poisson_2d(32, dtype=np.float64)
    elif name == "poisson48":
        d = jgen.poisson_2d(48, dtype=np.float64)
    elif name == "poisson9pt":
        d = jgen.poisson_2d_9pt(24, dtype=np.float64)
    elif name == "convdiff32":
        shape, r, c, v = convdiff_2d(32)
        return shape, r, c, v.astype(np.float64)
    else:  # a random SPD matrix, unstructured
        d = jgen.make_spd(jgen.generate_random_matrix(300, 300, 2, 6, rng=5))
    return d.shape, d.rows, d.cols, d.values


MATRICES = ["poisson32", "poisson48", "poisson9pt", "convdiff32", "random_spd"]


def _ops(name, dtype=np.float64):
    shape, r, c, v = _parts(name)
    jd = JMatrixData.from_coo(shape, r, c, v.astype(dtype))
    pd = gt.MatrixData.from_coo(shape, r, c, v.astype(dtype))
    if name == "random_spd":
        return JCsr.from_matrix_data(jd), gt.Csr.from_matrix_data(pd, device="cpu")
    return JDia.from_matrix_data(jd), gt.Dia.from_matrix_data(pd, device="cpu")


def _dense(op):
    if hasattr(op, "to_scipy"):
        return np.asarray(op.to_scipy().toarray())
    v = op.to_dense().values
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("name", MATRICES)
def test_pgm_level_identical(name):
    JA, A = _ops(name)
    jl = jpgm.PgmFactory().generate(JA)
    pl = pgm.PgmFactory().generate(A)
    np.testing.assert_array_equal(np.asarray(pl.restrict_op.agg), np.asarray(jl.restrict_op.agg))
    assert type(pl.restrict_op).__name__ == type(jl.restrict_op).__name__
    assert type(pl.prolong_op).__name__ == type(jl.prolong_op).__name__
    if isinstance(jl.restrict_op, jpgm.BandedRestriction):
        assert pl.restrict_op.stride == jl.restrict_op.stride
        assert pl.restrict_op.deltas == jl.restrict_op.deltas
        assert pl.prolong_op.deltas == jl.prolong_op.deltas
        np.testing.assert_array_equal(pl.restrict_op.delta.numpy(),
                                      np.asarray(jl.restrict_op.delta))
    assert pl.restrict_op.n_coarse == jl.restrict_op.n_coarse
    assert type(pl.coarse_op).__name__ == type(jl.coarse_op).__name__
    assert pl.coarse_op.dtype == torch.float64
    np.testing.assert_array_equal(_dense(pl.coarse_op), _dense(jl.coarse_op))
    if name == "random_spd":
        assert isinstance(pl.restrict_op, pgm.Restriction)
    if name.startswith("poisson") and name != "poisson9pt":
        assert pl.restrict_op.deltas == (0,) and isinstance(pl.coarse_op, gt.Dia)


@pytest.mark.parametrize("name", MATRICES)
def test_pgm_aggregate_identical(name):
    JA, A = _ops(name)
    sp = A.to_scipy().tocsr()
    np.testing.assert_array_equal(pgm.pgm_aggregate(sp), jpgm.pgm_aggregate(sp))


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("k", [1, 2])
def test_transfers_match_jax_f64(name, k):
    JA, A = _ops(name)
    jl = jpgm.PgmFactory().generate(JA)
    pl = pgm.PgmFactory().generate(A)
    n, nc = A.shape[0], pl.restrict_op.n_coarse
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, k))
    y = rng.standard_normal((nc, k))
    if k == 1:
        x, y = x[:, 0], y[:, 0]
    np.testing.assert_allclose(pl.restrict_op.apply(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.restrict_op.apply(jnp.asarray(x))),
                               rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(pl.prolong_op.apply(torch.from_numpy(y)).numpy(),
                               np.asarray(jl.prolong_op.apply(jnp.asarray(y))),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n", [37, 64, 101])
def test_banded_transfers_match_general(n):
    """Bounded-delta aggregations of sizes 1-3 (odd n too): the banded pair
    with several deltas equals the segment-sum/gather pair."""
    rng = np.random.default_rng(n)
    agg = np.zeros(n, np.int64)
    c = i = 0
    while i < n:
        size = int(rng.integers(1, 4))
        agg[i:i + size] = c
        i += size
        c += 1
    delta = torch.as_tensor((agg - np.arange(n) // 2).astype(np.int32))
    ds = tuple(int(d) for d in np.unique(delta.numpy()))
    br = pgm.BandedRestriction(delta=delta, deltas=ds, n_coarse=c)
    bp = pgm.BandedProlongation(delta=delta, deltas=ds, n_coarse=c)
    gr = pgm.Restriction(agg=torch.as_tensor(agg), n_coarse=c)
    gp = pgm.Prolongation(agg=torch.as_tensor(agg), n_coarse=c)
    x = torch.as_tensor(rng.standard_normal((n, 2)))
    y = torch.as_tensor(rng.standard_normal((c, 2)))
    np.testing.assert_allclose(br.apply(x).numpy(), gr.apply(x).numpy(), rtol=1e-12)
    np.testing.assert_allclose(bp.apply(y).numpy(), gp.apply(y).numpy(), rtol=1e-12)
    np.testing.assert_array_equal(br.agg.numpy(), agg)


@pytest.mark.parametrize("stride,n", [(1, 999), (16, 192), (48, 2304)])
def test_pure_stride_transfers(stride, n):
    """deltas == (0,) at any stride (the fused kernels' transfers): the
    reshape-sum and its broadcast equal the general pair."""
    agg = pgm._pair_base(n, stride)
    nc = int(agg.max()) + 1
    br, bp = pgm._banded_transfer_ops(agg, nc, "cpu")
    assert isinstance(br, pgm.BandedRestriction) and br.deltas == (0,) and br.stride == stride
    gr = pgm.Restriction(agg=torch.as_tensor(agg), n_coarse=nc)
    gp = pgm.Prolongation(agg=torch.as_tensor(agg), n_coarse=nc)
    rng = np.random.default_rng(stride)
    x = torch.as_tensor(rng.standard_normal(n).astype(np.float32))
    y = torch.as_tensor(rng.standard_normal(nc).astype(np.float32))
    assert torch.equal(br.apply(x), gr.apply(x))
    assert torch.equal(bp.apply(y), gp.apply(y))


def test_fixed_coarsening():
    JA, A = _ops("random_spd")
    rows = np.arange(0, A.shape[0], 3)
    jl = jpgm.FixedCoarseningFactory(rows).generate(JA)
    pl = pgm.FixedCoarseningFactory(rows).generate(A)
    assert isinstance(pl.coarse_op, gt.Csr) and pl.coarse_op.shape == (len(rows), len(rows))
    np.testing.assert_allclose(_dense(pl.coarse_op), _dense(jl.coarse_op), rtol=1e-14)
    x = np.random.default_rng(1).standard_normal(A.shape[0])
    y = np.random.default_rng(2).standard_normal(len(rows))
    np.testing.assert_array_equal(pl.restrict_op.apply(torch.from_numpy(x)).numpy(),
                                  np.asarray(jl.restrict_op.apply(jnp.asarray(x))))
    np.testing.assert_array_equal(pl.prolong_op.apply(torch.from_numpy(y)).numpy(),
                                  np.asarray(jl.prolong_op.apply(jnp.asarray(y))))


@pytest.mark.parametrize("name,max_levels", [("poisson32", 10), ("poisson48", 4),
                                             ("convdiff32", 6), ("random_spd", 10)])
def test_factory_hierarchy_and_coarse_inverse(name, max_levels):
    JA, A = _ops(name, np.float32)
    jm = JMultigrid.build(max_levels=max_levels).generate(JA)
    pm = gt.Multigrid.build(max_levels=max_levels).generate(A)
    assert [lv.fine_op.shape for lv in pm.levels] == [lv.fine_op.shape for lv in jm.levels]
    assert [type(lv.fine_op).__name__ for lv in pm.levels] == [
        type(lv.fine_op).__name__ for lv in jm.levels]
    nc = pm.levels[-1].coarse_op.shape[0]
    if not hasattr(pm.levels[-1].coarse_op, "to_scipy"):  # a Bell: no dense inverse
        assert pm.coarse_dense_inv is None and jm.coarse_dense_inv is None
        return
    assert pm.coarse_dense_inv.shape == (nc, nc) and pm.coarse_dense_inv.dtype == torch.float32
    jinv = np.asarray(jm.coarse_dense_inv)[:nc, :nc].T
    np.testing.assert_array_equal(pm.coarse_dense_inv.numpy(), jinv)
    for ps, js in zip(pm.pre_smoothers, jm.pre_smoothers):
        np.testing.assert_array_equal(ps.dinv.numpy(), np.asarray(js.dinv))


def test_kcycle_nan_sentinel_is_inf():
    assert gt.Multigrid.build(kcycle_rel_tol=float("nan")).kcycle_rel_tol == float("inf")
