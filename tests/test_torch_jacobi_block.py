"""Block and adaptive-storage Jacobi (slice 10): the port against the JAX
package on the CPU.

- ``find_natural_blocks``: the JAX package's block pointers, equal element
  for element, at ``max_block_size`` 1, 3, 4, 8 and 32 on a 2-D Poisson
  matrix (no two adjacent rows share a pattern) and on a 3-unknowns-a-node
  system (runs of 3 equal patterns), and on a 1-row matrix.
- Block ``Jacobi`` at ``max_block_size`` 1, 4 and 32 on the Poisson matrix
  and 8 on the 3-unknowns system, with explicit ``block_pointers``, in
  float64: apply (1 and 3 columns), ``to_dense``,
  ``to_matrix_data`` and ``transpose`` within 1e-12 of the JAX package's;
  the stored blocks carried across by ``interop.jacobi_from_arrays`` apply
  within 1e-12 as well.  Adaptive storage: ``precision_reduction(0, 1)`` on
  float32 stores bfloat16 (within 1e-2 relative), an int8 storage dtype
  stores int8 with per-block scales (within one quantization step).
- ``Cg`` and ``Gmres`` with a block Jacobi take the JAX package's
  iteration counts (float64), and ``Cg``, ``Bicgstab``, ``Gmres``, ``Idr``
  and ``Ir`` stream with it in float32 on a ``Dia``: a global ``Counters``
  logger sees SpMV launches and no whole-solve kernel.
- Scalar Jacobi with a ``storage_optimization`` no longer raises and equals
  the plain scalar Jacobi, as in the JAX package.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sps
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu import stop as jstop
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.base.types import precision_reduction as j_precision_reduction
from ginkgo_tpu.matrix.csr import Csr as JCsr
from ginkgo_tpu.preconditioner.jacobi import JacobiFactory as JJacobi
from ginkgo_tpu.preconditioner.jacobi import find_natural_blocks as j_find_natural_blocks
from ginkgo_tpu.solver.cg import Cg as JCg
from ginkgo_tpu.solver.gmres import Gmres as JGmres
from ginkgo_tpu_torch import interop, stop
from ginkgo_tpu_torch.base.types import precision_reduction
from ginkgo_tpu_torch.log import Counters, add_global_logger, remove_global_logger
from ginkgo_tpu_torch.preconditioner.jacobi import find_natural_blocks


@pytest.fixture(autouse=True)
def _one_thread():
    """Solver loops of many small tensor ops: one intra-op thread, so that
    they do not spin against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _parts(name):
    if name == "poisson":
        d = gt.generators.poisson_2d(12, dtype=np.float64)
        vals = d.values + np.where(d.rows == d.cols, np.linspace(0, 1, len(d.values)), 0)
        return d.shape, d.rows, d.cols, vals
    if name == "three_dof":  # 3 unknowns a node: runs of 3 rows share a pattern
        g = _poisson_sp(7)
        blk = sps.csr_matrix(np.array([[4.0, 1.0, 0.5], [1.0, 5.0, 1.0], [0.5, 1.0, 6.0]]))
        a = (sps.kron(g, blk) + sps.eye(g.shape[0] * 3)).tocoo()
        return a.shape, a.row, a.col, a.data
    return (1, 1), np.array([0]), np.array([0]), np.array([3.0])


def _poisson_sp(nside):
    d = gt.generators.poisson_2d(nside, dtype=np.float64)
    return sps.csr_matrix((d.values, (d.rows, d.cols)), shape=d.shape)


def _pair(name, dtype=np.float64):
    shape, rows, cols, vals = _parts(name)
    vals = np.asarray(vals).astype(dtype)
    C = gt.Csr.from_matrix_data(gt.MatrixData.from_coo(shape, rows, cols, vals), device="cpu")
    J = JCsr.from_matrix_data(JMatrixData.from_coo(shape, rows, cols, vals))
    return C, J


@pytest.mark.parametrize("name", ["poisson", "three_dof", "one_row"])
@pytest.mark.parametrize("mbs", [1, 3, 4, 8, 32])
def test_find_natural_blocks_matches_jax(name, mbs):
    C, J = _pair(name)
    ptrs = find_natural_blocks(C, mbs)
    np.testing.assert_array_equal(ptrs, j_find_natural_blocks(J, mbs))
    assert ptrs[0] == 0 and ptrs[-1] == C.shape[0] and (np.diff(ptrs) <= mbs).all()


def _assert_jacobi(P, J, rtol, atol, jax_dense=False):
    """apply (3 columns, and one column against the first of them),
    to_matrix_data, to_dense and transpose against the JAX package's.  The
    dense forms are held against the JAX package's ``to_dense`` where
    ``jax_dense``, else against its ``to_matrix_data`` made dense (each JAX
    call compiles for its shapes, a second or so)."""
    B = np.random.default_rng(5).standard_normal((P.shape[0], 3))
    want = np.asarray(J.apply(jnp.asarray(B)))
    np.testing.assert_allclose(P.apply(torch.from_numpy(B)).numpy(), want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(P.apply(torch.from_numpy(B[:, 0].copy())).numpy(), want[:, 0],
                               rtol=rtol, atol=atol)
    pm, jm = P.to_matrix_data(), J.to_matrix_data()
    np.testing.assert_array_equal(pm.rows, np.asarray(jm.rows))
    np.testing.assert_array_equal(pm.cols, np.asarray(jm.cols))
    np.testing.assert_allclose(pm.values, np.asarray(jm.values), rtol=rtol, atol=atol)
    if jax_dense:
        dense = np.asarray(J.to_dense().values)
        np.testing.assert_allclose(P.transpose().to_dense().values.numpy(),
                                   np.asarray(J.transpose().to_dense().values), rtol=rtol,
                                   atol=atol)
    else:
        dense = np.zeros(P.shape)
        dense[np.asarray(jm.rows), np.asarray(jm.cols)] = np.asarray(jm.values)
    np.testing.assert_allclose(P.to_dense().values.numpy(), dense, rtol=rtol, atol=atol)
    np.testing.assert_allclose(P.transpose().to_dense().values.numpy(), dense.T, rtol=rtol,
                               atol=atol)
    assert P.num_blocks == J.num_blocks


@pytest.mark.parametrize("name, mbs", [("poisson", 1), ("poisson", 4), ("three_dof", 8),
                                       ("poisson", 32)])
def test_block_jacobi_matches_jax(name, mbs):
    C, J = _pair(name)
    P = gt.Jacobi.build(max_block_size=mbs).generate(C)
    JP = JJacobi(max_block_size=mbs).generate(J)
    _assert_jacobi(P, JP, 1e-12, 1e-12, jax_dense=mbs == 8)
    if mbs == 8:
        carried = interop.jacobi_from_arrays(
            device="cpu", inv_blocks=np.asarray(JP.inv_blocks),
            block_scales=np.asarray(JP.block_scales), row_block=np.asarray(JP.row_block),
            row_local=np.asarray(JP.row_local), block_starts=np.asarray(JP.block_starts),
            n=JP.n, max_block_size=mbs)
        _assert_jacobi(carried, JP, 1e-12, 1e-12)
        np.testing.assert_allclose(P.inv_blocks.numpy(), np.asarray(JP.inv_blocks),
                                   rtol=1e-12, atol=1e-12)


def test_explicit_block_pointers_match_jax():
    C, J = _pair("poisson")
    ptrs = np.array([0, 5, 6, 20, 33, 60, 90, 100, 120, 144])
    P = gt.Jacobi.build(max_block_size=30, block_pointers=ptrs).generate(C)
    JP = JJacobi(max_block_size=30, block_pointers=ptrs).generate(J)
    np.testing.assert_array_equal(P.block_starts.numpy(), ptrs[:-1])
    _assert_jacobi(P, JP, 1e-12, 1e-12)


def test_bfloat16_storage_matches_jax():
    C, J = _pair("three_dof", np.float32)
    P = gt.Jacobi.build(max_block_size=8,
                        storage_optimization=precision_reduction(0, 1)).generate(C)
    JP = JJacobi(max_block_size=8,
                 storage_optimization=j_precision_reduction(0, 1)).generate(J)
    assert P.inv_blocks.dtype == torch.bfloat16
    assert str(JP.inv_blocks.dtype) == "bfloat16"
    scale = float(np.abs(np.asarray(JP.to_dense().values)).max())
    _assert_jacobi(P, JP, 1e-2, 1e-2 * scale)


class _Int8Storage:
    """A storage optimization whose storage dtype is int8 (per-block scales)."""

    def __init__(self, dtype):
        self.dtype = dtype

    def storage_dtype(self, arithmetic_dtype):
        return self.dtype


def test_int8_storage_matches_jax():
    C, J = _pair("poisson")
    P = gt.Jacobi.build(max_block_size=8, storage_optimization=_Int8Storage(torch.int8)
                        ).generate(C)
    JP = JJacobi(max_block_size=8, storage_optimization=_Int8Storage(jnp.int8)).generate(J)
    assert P.inv_blocks.dtype == torch.int8
    np.testing.assert_allclose(P.block_scales.numpy(), np.asarray(JP.block_scales), rtol=1e-6)
    # the same quantized blocks, but for an entry whose rounding the last
    # bits of its inverse decide: within one quantization step
    step = float(np.asarray(JP.block_scales).max())
    assert np.abs(P.inv_blocks.numpy().astype(int) - np.asarray(JP.inv_blocks).astype(int)
                  ).max() <= 1
    _assert_jacobi(P, JP, 0.0, 1.01 * step * 8)
    dense = gt.Jacobi.build(max_block_size=8).generate(C).to_dense().values
    assert float((P.to_dense().values - dense).abs().max()) <= 0.5 * step * 1.01


def test_scalar_jacobi_with_storage_optimization():
    C, J = _pair("poisson")
    P = gt.Jacobi.build(storage_optimization=precision_reduction(0, 1)).generate(C)
    JP = JJacobi(storage_optimization=j_precision_reduction(0, 1)).generate(J)
    assert torch.equal(P.inv_diag, gt.Jacobi.build().generate(C).inv_diag)
    _assert_jacobi(P, JP, 1e-15, 0.0)


@pytest.mark.parametrize("solver", ["cg", "gmres"])
def test_block_jacobi_solves_take_jax_iterations(solver):
    C, J = _pair("three_dof")
    crit = [stop.Iteration(max_iters=200), stop.ResidualNorm(tolerance=1e-10)]
    jcrit = [jstop.Iteration(max_iters=200), jstop.ResidualNorm(tolerance=1e-10)]
    P, JS = (gt.Cg, JCg) if solver == "cg" else (gt.Gmres, JGmres)
    kw = {} if solver == "cg" else {"krylov_dim": 10}
    b = np.random.default_rng(9).standard_normal(C.shape[0])
    x, info = P.build(criteria=crit, preconditioner=gt.Jacobi.build(max_block_size=4),
                      **kw).generate(C).solve(torch.from_numpy(b))
    jx, jinfo = JS.build(criteria=jcrit, preconditioner=JJacobi(max_block_size=4),
                         **kw).generate(J).solve(jnp.asarray(b))
    assert int(info.iterations) == int(jinfo.iterations)
    assert bool(info.converged.all()) and bool(np.asarray(jinfo.converged).all())
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-9, atol=1e-9)


FUSED = ("cg_fused", "bicgstab_fused", "gmres_fused", "idr_fused", "ir_fused")


@pytest.mark.parametrize("solver", ["Cg", "Bicgstab", "Gmres", "Idr", "Ir"])
def test_block_jacobi_streams(solver):
    """float32 on a Dia, where a scalar Jacobi takes the whole-solve
    kernel: a block Jacobi streams (SpMV launches, no fused kernel)."""
    d = gt.generators.poisson_2d(16, dtype=np.float32)
    A = gt.Dia.from_matrix_data(d, device="cpu")
    crit = [stop.Iteration(max_iters=60), stop.ResidualNorm(tolerance=1e-5)]
    b = torch.ones(A.shape[0])
    counts = {}
    for pre in (gt.Jacobi.build(max_block_size=1), gt.Jacobi.build(max_block_size=4)):
        c = add_global_logger(Counters())
        try:
            getattr(gt, solver).build(criteria=crit, preconditioner=pre).generate(A).solve(b)
        finally:
            remove_global_logger(c)
        counts[pre.max_block_size] = dict(c.kernel_counts)
    assert sum(counts[1].get(k, 0) for k in FUSED) == 1, counts[1]
    assert not any(counts[4].get(k, 0) for k in FUSED), counts[4]
    assert counts[4].get("dia_spmv", 0) > 0, counts[4]
