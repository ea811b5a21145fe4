"""WELL plans, the K8/K9 plain versions, the Well format and the Csr routes
through them, in the port against the JAX package on the CPU.

- The port's numpy planner (ops/well.WellPlan) equals the JAX WellPlan bit
  for bit: values, residues, routing, sub-tiles, bases, step -> supertile
  map and every statistic, for T in {1, 4, 16, 32, auto} and G explicit or
  auto; choose_unstructured_plan picks the same kind and layout.
- K8/K9's plain versions (well_spmv_reference, well_spmm_reference) run on
  the JAX plan's own arrays, carried across by interop.well_from_arrays,
  against well_spmv / well_spmm in Pallas interpret mode: float64 to 1e-12
  relative (both sum the same products in the same order; XLA's CPU
  interpreter may fuse a multiply-add), float32 with bfloat16 values to
  1e-5 relative with an absolute floor of 1e-5.
- The Csr routes: "auto" resolves like the JAX package on a locality-free
  pattern (the WELL gate), the plan cache holds whichever plan the chooser
  returns, and k > 1 columns run the S = 8 sibling of an S != 8 PELL plan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu.matrix.csr import Csr as JCsr
from ginkgo_tpu.matrix.well import Well as JWell
from ginkgo_tpu.ops import spmv_pallas as jsp
from ginkgo_tpu.ops import spmv_well as jsw
from ginkgo_tpu_torch import interop
from ginkgo_tpu_torch.ops import pell as ops_pell
from ginkgo_tpu_torch.ops import well as ops_well
from tests.test_well import _powerlaw

PATTERNS = {
    "powerlaw": lambda: _powerlaw(4096),
    "uniform": lambda: sps.random(900, 1100, density=0.01, random_state=1, format="csr"),
    "banded": lambda: sps.diags([np.ones(2000)] * 5, [-512, -1, 0, 1, 512],
                                shape=(2000, 2000)).tocsr(),
}


def _csr(name):
    sp = PATTERNS[name]() if isinstance(name, str) else name
    sp.sum_duplicates()
    sp.sort_indices()
    return sp


def _carry(jp):
    """The port's Well from a JAX WELL plan's arrays."""
    return interop.well_from_arrays(
        np.asarray(jp.values), np.asarray(jp.qidx), np.asarray(jp.rt),
        None if jp.tsb is None else np.asarray(jp.tsb), np.asarray(jp.bases),
        np.asarray(jp.tile_of_step), shape=jp.shape, n_steps=jp.n_steps, nnz=jp.nnz,
        G=jp.G, T=jp.T, NT=jp.NT, NST=jp.NST, NP=jp.NP, NW=jp.NW, device="cpu")


PLAN_FIELDS = ("values", "qidx", "rt", "tsb", "bases", "tile_of_step")
PLAN_SCALARS = ("T", "G", "NT", "NST", "NP", "NW", "n_steps", "nnz", "total_cells",
                "inflation", "padded_bytes", "bytes_per_cell", "modeled_seconds", "shape")


def _assert_same_plan(pp, jp):
    for f in PLAN_FIELDS:
        want, got = getattr(jp, f), getattr(pp, f)
        if want is None:
            assert got is None, f
            continue
        want = np.asarray(want)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in PLAN_SCALARS:
        assert getattr(pp, f) == getattr(jp, f), f


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("T", [1, 4, 16, 32, "auto"])
@pytest.mark.parametrize("G", [8, "auto"])
def test_plan_equals_jax_bit_for_bit(pattern, T, G):
    sp = _csr(pattern)
    args = (sp.indptr, sp.indices, sp.data, sp.shape)
    jp = jsw.WellPlan(*args, G=G, T=T)
    pp = ops_well.WellPlan(*args, G=G, T=T)
    _assert_same_plan(pp, jp)
    np.testing.assert_array_equal(
        pp.tile_ptr, ops_pell.tile_ptr_from_steps(pp.tile_of_step, pp.NST, pp.G))
    assert pp.tile_ptr[-1] == pp.values.shape[0]
    # a statistics-only plan has the same statistics and no arrays
    st = ops_well.WellPlan(*args, G=G, T=T, materialize=False)
    assert all(getattr(st, f) == getattr(pp, f) for f in PLAN_SCALARS)
    assert st.values is None and st.tile_ptr is None
    assert ops_well.WellPlan(*args, G=G, T=T, max_cells=pp.total_cells - 1).too_large


@pytest.mark.parametrize("pattern", ["powerlaw8192", "banded", "uniform", "scatter"])
def test_choose_unstructured_plan_matches_jax(pattern):
    if pattern == "powerlaw8192":
        sp = _csr(_powerlaw(8192))
    elif pattern == "scatter":
        d = gt.generators.local_scatter(4096, half_window=64)
        sp = _csr(sps.csr_matrix((d.values, (d.rows, d.cols)), shape=d.shape))
    else:
        sp = _csr(pattern)
    args = (sp.indptr, sp.indices, sp.data, sp.shape)
    jp = jsw.choose_unstructured_plan(*args)
    pp = ops_well.choose_unstructured_plan(*args)
    assert type(pp).__name__ == type(jp).__name__
    if isinstance(pp, ops_well.WellPlan):
        _assert_same_plan(pp, jp)
    else:
        assert (pp.S, pp.G, pp.n_steps) == (jp.S, jp.G, jp.n_steps)
        np.testing.assert_array_equal(pp.values, np.asarray(jp.values))
    kind = {"powerlaw8192": "WellPlan", "uniform": "WellPlan"}.get(pattern, "PellPlan")
    assert type(pp).__name__ == kind


SPMV_CASES = [
    # (n, seed, T, G, values); G <= 8 keeps the interpreter's unrolled step small
    (4096, 11, 1, 8, "f64"),
    (4096, 11, 4, 8, "f64"),
    (2048, 3, 32, 4, "f64"),
    (4096, 23, "auto", 8, "bf16"),
]


@pytest.mark.parametrize("n,seed,T,G,vals", SPMV_CASES)
def test_spmv_spmm_plain_versions_match_pallas(n, seed, T, G, vals):
    sp = _csr(_powerlaw(n, seed=seed))
    jp = jsw.WellPlan(sp.indptr, sp.indices, sp.data, sp.shape, G=G, T=T)
    if vals == "bf16":
        jp.values = jp.values.astype(jnp.bfloat16)
    A = _carry(jp)
    vec = np.float32 if vals == "bf16" else np.float64
    rng = np.random.default_rng(4)
    x = rng.standard_normal(n).astype(vec)
    X = rng.standard_normal((n, 3)).astype(vec)
    tol = dict(rtol=1e-12, atol=1e-12) if vec == np.float64 else dict(rtol=1e-5, atol=1e-5)
    y = ops_well.well_spmv(A, torch.from_numpy(x))
    assert y.dtype == torch.from_numpy(x).dtype and y.shape == (n,)
    np.testing.assert_allclose(y.numpy(), np.asarray(jsw.well_spmv(jp, jnp.asarray(x), interpret=True)), **tol)
    Y = ops_well.well_spmm(A, torch.from_numpy(X))
    np.testing.assert_allclose(Y.numpy(), np.asarray(jsw.well_spmm(jp, jnp.asarray(X), interpret=True)), **tol)
    # and both equal the product of the stored matrix
    dense = A.to_dense().values.double().numpy()
    np.testing.assert_allclose(Y.numpy(), dense @ X, rtol=1e-5, atol=1e-4)


def test_nan_in_x_reaches_the_same_rows():
    """A NaN in x reaches every row with a cell on its column, padding cells
    (value 0, q 0, sub-tile 0) included, as on the TPU."""
    sp = _csr(_powerlaw(4096, seed=11))
    jp = jsw.WellPlan(sp.indptr, sp.indices, sp.data, sp.shape, G=8, T=4)
    A = _carry(jp)
    x = np.ones(4096)
    x[[0, 1, 1024, 4095]] = np.nan
    got = ops_well.well_spmv(A, torch.from_numpy(x)).numpy()
    want = np.asarray(jsw.well_spmv(jp, jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).sum() > np.isnan(sp @ x).sum()  # padding cells add rows
    ok = ~np.isnan(got)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12)


def test_well_format_matches_jax():
    sp = _csr(_powerlaw(2048, seed=9))
    JA = JCsr.from_scipy(sp)
    JW = JWell.from_csr(JA)
    C = interop.csr_from_arrays(sp.indptr, sp.indices, sp.data, sp.shape, device="cpu")
    W = gt.Well.from_csr(C)
    assert (W.T, W.G, W.NST, W.n_steps, W.nnz) == (JW.T, JW.G, JW.NST, JW.n_steps, JW.nnz)
    for f in ("values", "qidx", "rt", "tsb", "bases"):
        np.testing.assert_array_equal(getattr(W, f).numpy(), np.asarray(getattr(JW, f)))
    assert torch.equal(_carry(JW).tile_ptr, W.tile_ptr)
    assert W.inflation == JW.inflation
    X = np.random.default_rng(2).standard_normal((2048, 2))
    np.testing.assert_allclose(W.apply(torch.from_numpy(X)).numpy(), sp @ X, rtol=1e-12, atol=1e-12)
    y = W.apply_advanced(2.0, torch.from_numpy(X[:, 0]), -1.0, torch.from_numpy(X[:, 1]))
    torch.testing.assert_close(y, 2.0 * W.apply(torch.from_numpy(X[:, 0])) - torch.from_numpy(X[:, 1]))
    np.testing.assert_array_equal(W.extract_diagonal().values.numpy(),
                                  np.asarray(JW.extract_diagonal().values))
    for wm, jm in ((W.scale(-0.5), JW.scale(-0.5)), (W.compute_absolute(), JW.compute_absolute()),
                   (W.transpose(), JW.transpose())):
        for f in ("values", "qidx", "rt", "tsb", "bases"):
            np.testing.assert_array_equal(getattr(wm, f).numpy(), np.asarray(getattr(jm, f)))
    md, jmd = W.to_matrix_data(), JW.to_matrix_data()
    for f in ("rows", "cols", "values"):
        np.testing.assert_array_equal(getattr(md, f), getattr(jmd, f))
    np.testing.assert_array_equal(W.to_csr().to_dense().values.numpy(), sp.toarray())
    np.testing.assert_array_equal(W.to_dense().values.numpy(), np.asarray(JW.to_dense().values))
    R = W.reduce_storage()
    assert R.values.dtype == torch.bfloat16 and R.qidx.dtype == torch.int8
    np.testing.assert_array_equal(R.values.float().numpy(),
                                  np.asarray(JW.reduce_storage().values.astype(jnp.float32)))
    assert W.astype(torch.float32).dtype == torch.float32
    # the user's path, and the storage the plan cache charges
    Wm = gt.Well.from_matrix_data(C.to_matrix_data(), device="cpu")
    assert torch.equal(Wm.values, W.values) and torch.equal(Wm.tile_ptr, W.tile_ptr)
    assert W.storage_bytes() == sum(t.numel() * t.element_size() for t in
                                    (W.values, W.qidx, W.rt, W.tsb, W.bases, W.tile_ptr))


# -- the three Csr routes --------------------------------------------------------------


@pytest.mark.parametrize("cap", [None, 1 << 20])
def test_csr_auto_resolves_like_jax(monkeypatch, cap):
    """On a locality-free pattern PELL inflates past 16, and the JAX package
    takes the WELL plan under its gates; with a small padding cap both fall
    back to 'classical'."""
    sp = _csr(_powerlaw(8192))
    JA = JCsr.from_scipy(sp)
    A = interop.csr_from_arrays(sp.indptr, sp.indices, sp.data, sp.shape, device="cpu")
    if cap is not None:
        monkeypatch.setattr(jsp, "_HARD_PAD_BYTES", cap)
        monkeypatch.setattr(ops_pell, "HARD_PAD_BYTES", cap)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    want = JA._resolve_strategy_uncached()
    assert A._resolve_unstructured() == want
    assert want == ("pallas" if cap is None else "classical")


def test_plan_cache_holds_the_well_plan():
    """Csr 'pallas' on a locality-free pattern builds, caches and runs the
    WELL plan the JAX package's chooser returns (the plain K8/K9 are held
    against the Pallas kernels above)."""
    sp = _csr(_powerlaw(4096))
    JA = JCsr.from_scipy(sp).with_strategy("pallas")
    A = interop.csr_from_arrays(sp.indptr, sp.indices, sp.data, sp.shape, device="cpu",
                                strategy="pallas")
    before = ops_pell.plan_for.builds
    rng = np.random.default_rng(8)
    for k in (1, 3):
        x = rng.standard_normal((4096, k))
        np.testing.assert_allclose(A.apply(torch.from_numpy(x)).numpy(), sp @ x,
                                   rtol=1e-12, atol=1e-12)
    assert ops_pell.plan_for.builds == before + 1
    W = ops_pell.plan_for(A.row_ptrs, A.col_idxs, A.values, A.shape)
    jp = jsp._plan_for(JA.row_ptrs, JA.col_idxs, JA.values, tuple(JA.shape))
    assert isinstance(W, gt.Well) and isinstance(jp, jsw.WellPlan)
    for f in ("values", "qidx", "rt", "tsb", "bases"):
        np.testing.assert_array_equal(getattr(W, f).numpy(), np.asarray(getattr(jp, f)))
    assert ops_pell._PLAN_CACHE.get(
        ops_pell._cache_key(A.row_ptrs, A.col_idxs, A.values, A.shape))[3] is W


def test_k_columns_run_the_s8_sibling_plan():
    """local_scatter with S = "auto" (S = 32 here): one column runs the
    S = 32 plan, k = 4 columns its S = 8 sibling, in both packages."""
    d = gt.generators.local_scatter(4096, half_window=64)
    sp = _csr(sps.csr_matrix((d.values, (d.rows, d.cols)), shape=d.shape))
    JA = JCsr.from_scipy(sp).with_strategy("pallas")
    A = interop.csr_from_arrays(sp.indptr, sp.indices, sp.data, sp.shape, device="cpu",
                                strategy="pallas")
    X = np.random.default_rng(5).standard_normal((4096, 4)).astype(np.float32)
    builds = ops_pell._spmm_plan.builds
    got = A.apply(torch.from_numpy(X)).numpy()
    assert ops_pell._spmm_plan.builds == builds + 1
    P = ops_pell.plan_for(A.row_ptrs, A.col_idxs, A.values, A.shape)
    P8 = ops_pell._spmm_plan(P, A.row_ptrs, A.col_idxs, A.values, A.shape)
    assert ops_pell._spmm_plan.builds == builds + 1  # cached
    jshape = tuple(JA.shape)
    jp = jsp._plan_for(JA.row_ptrs, JA.col_idxs, JA.values, jshape)
    jp8 = jsp._spmm_plan(jp, JA.row_ptrs, JA.col_idxs, JA.values, jshape)
    assert (P.S, jp.S) == (32, 32) and (P8.S, jp8.S) == (8, 8)
    for f in ("values", "qidx", "bases"):
        np.testing.assert_array_equal(getattr(P8, f).numpy(), np.asarray(getattr(jp8, f)))
    torch.testing.assert_close(torch.from_numpy(got),
                               ops_pell.pell_spmm_reference(P8, torch.from_numpy(X)),
                               rtol=0, atol=0)
    np.testing.assert_allclose(got, np.asarray(JA.apply(jnp.asarray(X))), rtol=1e-5, atol=1e-5)
