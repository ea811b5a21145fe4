"""PELL plans, the K5/K6 plain versions, Csr's "pallas" strategy and the
Pell format of the port against the JAX package on the CPU.

- The port's numpy planner (ops/pell.PellPlan) equals the JAX PellPlan bit
  for bit: values, lane indices, bases, step -> tile map and geometry.
- K5/K6's plain versions (pell_spmv_reference, pell_spmm_reference) run on
  the JAX plan's own arrays, carried across by interop.pell_from_arrays,
  against pell_spmv / pell_spmm in Pallas interpret mode.  float32 to 1e-5
  relative with an absolute floor of 1e-5 (both sum the same products in
  the same slot order, but XLA's CPU interpreter may fuse differently);
  float64 to 1e-12.
- Csr(strategy="pallas") against the JAX Csr on patterns whose PELL
  inflation is at most 4, where the JAX plan chooser keeps PELL too.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.matrix.csr import Csr as JCsr
from ginkgo_tpu.matrix.pell import Pell as JPell
from ginkgo_tpu.ops import spmv_pallas as jsp
from ginkgo_tpu_torch import interop
from ginkgo_tpu_torch.ops import pell as ops_pell

PATTERNS = {
    "poisson3d": lambda: gt.generators.poisson_3d(12, dtype=np.float32),
    "scatter": lambda: gt.generators.local_scatter(2048),
    "scatter_w32": lambda: gt.generators.local_scatter(4096, half_window=32),
}


def _csr_arrays(name):
    data = PATTERNS[name]()
    JA = JCsr.from_matrix_data(JMatrixData.from_coo(data.shape, data.rows, data.cols, data.values))
    return data, JA, tuple(np.asarray(a) for a in (JA.row_ptrs, JA.col_idxs, JA.values))


def _carry(jp):
    """The port's Pell from a JAX plan's arrays."""
    return interop.pell_from_arrays(
        np.asarray(jp.values), np.asarray(jp.qidx), np.asarray(jp.bases),
        np.asarray(jp.tile_of_step), shape=jp.shape, n_steps=jp.n_steps, nnz=jp.nnz,
        G=jp.G, NT=jp.NT, NP=jp.NP, S=getattr(jp, "S", 8), device="cpu")


@pytest.mark.parametrize("pattern", ["poisson3d", "scatter"])
@pytest.mark.parametrize("S", [8, 16, 32, "auto"])
@pytest.mark.parametrize("q", [np.int8, np.int32])
def test_plan_equals_jax_bit_for_bit(pattern, S, q):
    data, JA, (ip, ci, vv) = _csr_arrays(pattern)
    jp = jsp.PellPlan(ip, ci, vv, data.shape, S=S, q_dtype=q)
    pp = ops_pell.PellPlan(ip, ci, vv, data.shape, S=S, q_dtype=q)
    for f in ("values", "qidx", "bases", "tile_of_step"):
        want = np.asarray(getattr(jp, f))
        got = getattr(pp, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("G", "S", "NT", "NP", "n_steps", "nnz", "total_cells", "shape"):
        assert getattr(pp, f) == getattr(jp, f), f
    assert pp.inflation == jp.inflation
    np.testing.assert_array_equal(
        pp.tile_ptr, ops_pell.tile_ptr_from_steps(pp.tile_of_step, pp.NT, pp.G))
    assert pp.tile_ptr[-1] == pp.values.shape[0]
    # a stats-only plan has the same statistics and no arrays
    st = ops_pell.PellPlan(ip, ci, vv, data.shape, S=S, q_dtype=q, materialize=False)
    assert (st.n_steps, st.total_cells, st.G, st.S) == (pp.n_steps, pp.total_cells, pp.G, pp.S)
    assert st.values is None and st.tile_ptr is None


SPMV_CASES = [
    # (pattern, S, G, q, values, vectors); G = 16 on the scatter pattern,
    # where auto-G picks 64 and the interpreter's compile time grows with G
    ("poisson3d", 8, "auto", np.int8, "f32", np.float32),
    ("scatter", 32, 16, np.int32, "bf16", np.float32),
    ("poisson3d", 16, "auto", np.int32, "f64", np.float64),
]


@pytest.mark.parametrize("pattern,S,G,q,vals,vec", SPMV_CASES)
def test_spmv_spmm_plain_versions_match_pallas(pattern, S, G, q, vals, vec):
    data, JA, (ip, ci, vv) = _csr_arrays(pattern)
    if vals == "f64":
        vv = vv.astype(np.float64)
    jp = jsp.PellPlan(ip, ci, vv, data.shape, G=G, S=S, q_dtype=q)
    if vals == "bf16":
        jp.values = jp.values.astype(jnp.bfloat16)
    A = _carry(jp)
    assert A.values.dtype == {"f32": torch.float32, "f64": torch.float64,
                              "bf16": torch.bfloat16}[vals]
    rng = np.random.default_rng(1)
    n = data.shape[0]
    x = rng.standard_normal(n).astype(vec)
    X = rng.standard_normal((n, 3)).astype(vec)
    tol = dict(rtol=1e-12, atol=1e-12) if vec == np.float64 else dict(rtol=1e-5, atol=1e-5)
    y = ops_pell.pell_spmv(A, torch.from_numpy(x))
    assert y.dtype == torch.from_numpy(x).dtype and y.shape == (n,)
    np.testing.assert_allclose(y.numpy(), np.asarray(jsp.pell_spmv(jp, jnp.asarray(x), interpret=True)), **tol)
    Y = ops_pell.pell_spmm(A, torch.from_numpy(X))
    np.testing.assert_allclose(Y.numpy(), np.asarray(jsp.pell_spmm(jp, jnp.asarray(X), interpret=True)), **tol)
    # and both equal the product of the stored (possibly bfloat16) matrix
    dense = A.to_dense().values.double().numpy()
    np.testing.assert_allclose(Y.numpy(), dense @ X, rtol=1e-5, atol=1e-4)


def test_nan_in_x_propagates_as_in_pallas():
    """A NaN in x reaches every row with a cell on its column, padding
    cells (value 0) inside the column range included, as on the TPU."""
    data, JA, (ip, ci, vv) = _csr_arrays("poisson3d")
    jp = jsp.PellPlan(ip, ci, vv, data.shape, S=8, q_dtype=np.int8)
    A = _carry(jp)
    n = data.shape[0]
    x = np.ones(n, np.float32)
    x[[0, 130, n - 1]] = np.nan
    got = ops_pell.pell_spmv(A, torch.from_numpy(x)).numpy()
    want = np.asarray(jsp.pell_spmv(jp, jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).sum() > 3 * 7  # more rows than the matrix's own neighbours
    ok = ~np.isnan(got)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6)


@pytest.mark.parametrize("pattern", ["poisson3d", "scatter_w32"])
def test_csr_pallas_strategy_matches_jax(pattern):
    data, JA, (ip, ci, vv) = _csr_arrays(pattern)
    stats = ops_pell.PellPlan(ip, ci, vv, data.shape, S="auto", q_dtype=np.int8, materialize=False)
    assert stats.inflation <= 4.0  # the JAX chooser keeps PELL
    JP = JA.with_strategy("pallas")
    A = interop.csr_from_arrays(ip, ci, vv, data.shape, device="cpu", strategy="pallas")
    rng = np.random.default_rng(6)
    n = data.shape[0]
    before = ops_pell.plan_for.builds
    # k = 3 runs K6's plain version on the S = 8 sibling of the cached plan
    # (built once beside it, as the JAX package does)
    for k in ((1, 3) if pattern == "poisson3d" else (1,)):
        x = rng.standard_normal((n, k)).astype(np.float32)
        got = A.apply(torch.from_numpy(x)).numpy()
        want = np.asarray(JP.apply(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    assert A.apply(x).shape == (n,)
    # one plan for all applies of the matrix, S chosen by the cost model
    assert ops_pell.plan_for.builds == before + 1
    plan = ops_pell.plan_for(A.row_ptrs, A.col_idxs, A.values, A.shape)
    assert plan.S == stats.S and plan.qidx.dtype == torch.int8
    # values changed in place get a new plan, not the stale one
    y = A.apply(x)
    A.values.mul_(2.0)
    torch.testing.assert_close(A.apply(x), 2.0 * y)
    assert ops_pell.plan_for.builds == before + 2


def test_plan_cache_is_a_byte_lru(monkeypatch):
    lru = ops_pell._ByteLRU(100)
    lru.put("a", 1, 40)
    lru.put("b", 2, 40)
    assert lru.get("a") == 1  # a is now the most recent
    lru.put("c", 3, 40)
    assert lru.get("b") is None and len(lru) == 2 and lru.total_bytes() == 80
    lru.put("huge", 4, 500)  # kept alone
    assert len(lru) == 1 and lru.get("huge") == 4
    # the padding gate declines before allocating
    data, JA, (ip, ci, vv) = _csr_arrays("scatter")
    A = interop.csr_from_arrays(ip, ci, vv, data.shape, device="cpu", strategy="pallas")
    assert A._resolve_unstructured() == "pallas"
    monkeypatch.setattr(ops_pell, "HARD_PAD_BYTES", 1 << 10)
    with pytest.raises(MemoryError, match="PELL plan"):
        A.apply(torch.ones(data.shape[0]))
    assert A._resolve_unstructured() == "classical"


def test_pell_format_matches_jax():
    data, JA, (ip, ci, vv) = _csr_arrays("scatter")
    JP = JPell.from_csr(JA, G=16)
    C = interop.csr_from_arrays(ip, ci, vv, data.shape, device="cpu")
    P = gt.Pell.from_csr(C, G=16)
    assert (P.S, P.G, P.NT, P.NP, P.n_steps, P.nnz) == (JP.S, JP.G, JP.NT, JP.NP, JP.n_steps, JP.nnz)
    for f in ("values", "qidx", "bases"):
        np.testing.assert_array_equal(getattr(P, f).numpy(), np.asarray(getattr(JP, f)))
    carried = _carry(JP)
    assert torch.equal(carried.tile_ptr, P.tile_ptr)
    assert P.inflation == JP.inflation
    n = data.shape[0]
    X = np.random.default_rng(2).standard_normal((n, 2)).astype(np.float32)
    np.testing.assert_allclose(P.apply(torch.from_numpy(X)).numpy(),
                               np.asarray(JP.apply(jnp.asarray(X))), rtol=1e-5, atol=1e-5)
    y = P.apply_advanced(2.0, torch.from_numpy(X[:, 0]), -1.0, torch.from_numpy(X[:, 1]))
    torch.testing.assert_close(y, 2.0 * P.apply(torch.from_numpy(X[:, 0])) - torch.from_numpy(X[:, 1]))
    np.testing.assert_array_equal(P.extract_diagonal().values.numpy(),
                                  np.asarray(JP.extract_diagonal().values))
    for pm, jm in ((P.scale(-0.5), JP.scale(-0.5)), (P.compute_absolute(), JP.compute_absolute()),
                   (P.transpose(), JP.transpose())):
        for f in ("values", "qidx", "bases"):
            np.testing.assert_array_equal(getattr(pm, f).numpy(), np.asarray(getattr(jm, f)))
    md, jmd = P.to_matrix_data(), JP.to_matrix_data()
    for f in ("rows", "cols", "values"):
        np.testing.assert_array_equal(getattr(md, f), getattr(jmd, f))
    np.testing.assert_array_equal(P.to_dense().values.numpy(), np.asarray(JP.to_dense().values))
    np.testing.assert_array_equal(P.to_csr().to_dense().values.numpy(), data.to_dense())
    R = P.reduce_storage()
    assert R.values.dtype == torch.bfloat16 and R.qidx.dtype == torch.int8
    JR = JP.reduce_storage()
    np.testing.assert_array_equal(R.values.float().numpy(),
                                  np.asarray(JR.values.astype(jnp.float32)))
    assert P.astype(torch.float64).dtype == torch.float64
    P32 = gt.Pell.from_csr(C, G=16, q_dtype=np.int32)
    assert P32.qidx.dtype == torch.int32 and P32.transpose().qidx.dtype == torch.int32
    # from_matrix_data: the user's path
    Pm = gt.Pell.from_matrix_data(data, device="cpu", G=16)
    assert torch.equal(Pm.values, P.values) and torch.equal(Pm.tile_ptr, P.tile_ptr)
