"""Bell (Blocked-ELL) of the port against the JAX package on the CPU.

- Bell.from_matrix_data builds the JAX package's panels, panel ids,
  validity and entry slots bit for bit; bell_inflation_estimate and
  suitable_for_bell agree exactly.
- K10/K11's plain versions (bell_spmv_reference, bell_spmm_reference) run
  on the JAX Bell's own arrays, carried across by interop.bell_from_arrays,
  against bell_spmv_pallas / bell_spmm_pallas in Pallas interpret mode, in
  float32.  The two sum a row's 128 * K products in different orders (the
  plain version lane by lane in order, the Pallas kernels by the
  interpreter's reduction), so the bound is the worst case of two
  summation orders: |got - want| <= 2 * 128 * K * eps32 * (|A| |x|).
- Every other type takes the JAX package's XLA-path arithmetic: float64 to
  1e-12 relative.  Structure ops move values without arithmetic and must
  agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.matrix import bell as jbell
from ginkgo_tpu.matrix.csr import Csr as JCsr
from ginkgo_tpu.ops.pallas_bell import bell_spmm_pallas, bell_spmv_pallas
from ginkgo_tpu_torch import interop
from ginkgo_tpu_torch.matrix import bell as pbell
from ginkgo_tpu_torch.ops import bell as ops_bell

LANES = 128
EPS32 = float(np.finfo(np.float32).eps)


def block_structured(NRB, BR, K, NPC, density=0.3, seed=7, n_cols=None):
    """The JAX bench's block-structured pattern (bench.py, row_bell): each
    of NRB row blocks of BR rows fills K random 128-column panels of NPC at
    the given density; float32 values uniform in (-0.005, 0.005)."""
    rng = np.random.default_rng(seed)
    rows_l, cols_l = [], []
    for rb in range(NRB):
        for pnl in rng.choice(NPC, size=K, replace=False):
            rr, cc = np.nonzero(rng.random((BR, LANES)) < density)
            rows_l.append(rb * BR + rr)
            cols_l.append(pnl * LANES + cc)
    rows, cols = np.concatenate(rows_l), np.concatenate(cols_l)
    vals = (rng.random(len(rows)).astype(np.float32) - 0.5) * 1e-2
    shape = (NRB * BR, n_cols or NPC * LANES)
    keep = cols < shape[1]
    return rows[keep], cols[keep], vals[keep], shape


def _pair(rows, cols, vals, shape):
    return (JMatrixData.from_coo(shape, rows, cols, vals),
            interop.matrix_data_from_arrays(shape, rows, cols, vals))


PATTERNS = {
    "random": lambda: (lambda d: (d.rows, d.cols, d.values, d.shape))(
        gt.generators.generate_random_matrix(257, 300, 1, 7, 3, dtype=np.float32)),
    "blocks": lambda: block_structured(24, 16, 3, 10),
    # the last panel cut at 1200 columns
    "blocks_cut": lambda: block_structured(16, 8, 4, 10, n_cols=1200),
}


def _carry(JB):
    return interop.bell_from_arrays(
        np.asarray(JB.values), np.asarray(JB.panel_ids), np.asarray(JB.panel_valid),
        np.asarray(JB.ent_flat), shape=JB.shape, block_rows=JB.block_rows,
        nnz_stored=JB.nnz_stored, device="cpu")


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("block_rows", [8, 16])
def test_arrays_equal_jax_bit_for_bit(pattern, block_rows):
    jd, pd = _pair(*PATTERNS[pattern]())
    JB = jbell.Bell.from_matrix_data(jd, block_rows=block_rows)
    B = gt.Bell.from_matrix_data(pd, block_rows=block_rows, device="cpu")
    for f in ("values", "panel_ids", "panel_valid", "ent_flat"):
        want = np.asarray(getattr(JB, f))
        got = getattr(B, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (B.shape, B.block_rows, B.nnz, B.num_panels) == (JB.shape, JB.block_rows, JB.nnz,
                                                            JB.num_panels)
    assert B.storage_inflation() == JB.storage_inflation()
    for br in (8, 16, 32):
        assert pbell.bell_inflation_estimate(pd, br) == jbell.bell_inflation_estimate(jd, br)
        for cap in (2.0, 4.0, 40.0):
            assert pbell.suitable_for_bell(pd, br, cap) == jbell.suitable_for_bell(jd, br, cap)


def _bound(B, x):
    """2 * 128 * K * eps32 * (|A| |x|): two summation orders of a row's
    128 * K products."""
    absA = B.compute_absolute().astype(torch.float64).to_dense().values.numpy()
    K = B.values.shape[1]
    return 2 * LANES * K * EPS32 * (absA @ np.abs(x.astype(np.float64)))


@pytest.mark.parametrize("pattern", ["blocks", "blocks_cut"])
@pytest.mark.parametrize("panels", ["f32", "bf16"])
def test_plain_versions_match_pallas(pattern, panels):
    jd, _ = _pair(*PATTERNS[pattern]())
    JB = jbell.Bell.from_matrix_data(jd, block_rows=8)
    if panels == "bf16":
        JB = JB.reduce_storage()
    B = _carry(JB)
    n, m = B.shape
    rng = np.random.default_rng(11)
    x = rng.standard_normal(m).astype(np.float32)
    X = rng.standard_normal((m, 3)).astype(np.float32)
    npc = -(-m // LANES)
    xp = np.zeros(npc * LANES, np.float32)
    xp[:m] = x
    Xp = np.zeros((npc * LANES, 3), np.float32)
    Xp[:m] = X
    want = np.asarray(bell_spmv_pallas(JB.values, JB.panel_ids, JB.panel_valid,
                                       jnp.asarray(xp.reshape(npc, LANES)), interpret=True))[:n]
    got = ops_bell.bell_spmv(B, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert (np.abs(got.numpy() - want) <= _bound(B, x)).all()
    Want = np.asarray(bell_spmm_pallas(JB.values, JB.panel_ids, jnp.asarray(Xp.T),
                                       interpret=True))[:n]
    Got = ops_bell.bell_spmm(B, torch.from_numpy(X)).numpy()
    for j in range(3):
        assert (np.abs(Got[:, j] - Want[:, j]) <= _bound(B, X[:, j])).all()
    # the k-column order is the one-column order, column by column
    torch.testing.assert_close(torch.from_numpy(Got[:, 1]),
                               ops_bell.bell_spmv(B, torch.from_numpy(X[:, 1].copy())),
                               rtol=0, atol=0)
    # Bell.apply routes float32 vectors to the kernels' plain versions
    torch.testing.assert_close(B.apply(torch.from_numpy(x)), got, rtol=0, atol=0)
    torch.testing.assert_close(B.apply(torch.from_numpy(X)), torch.from_numpy(Got),
                               rtol=0, atol=0)


def test_nan_in_x_reaches_padding_panels():
    """Padding panels (id 0, zero values) are multiplied as on the TPU, so a
    NaN in x[0:128] reaches every row block with a padding panel."""
    rows, cols, vals, shape = block_structured(8, 8, 2, 6, seed=3)
    extra = np.arange(8)  # one row block with three panels: K = 3, the rest pad
    jd, pd = _pair(np.concatenate([rows, extra]), np.concatenate([cols, 5 * LANES + extra]),
                   np.concatenate([vals, np.ones(8, np.float32)]), shape)
    JB = jbell.Bell.from_matrix_data(jd)
    B = gt.Bell.from_matrix_data(pd, device="cpu")
    x = np.ones(shape[1], np.float32)
    x[3] = np.nan
    got = B.apply(torch.from_numpy(x)).numpy()
    want = np.asarray(bell_spmv_pallas(JB.values, JB.panel_ids, JB.panel_valid,
                                       jnp.asarray(x.reshape(-1, LANES)), interpret=True))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want[:shape[0]]))
    assert np.isnan(got).sum() > len(np.unique(pd.rows[pd.cols == 3]))


def test_explicit_zeros_kept():
    rows, cols = np.array([0, 0, 3, 7]), np.array([1, 5, 3, 2])
    vals = np.array([1.0, 0.0, 0.0, 2.0])
    jd, pd = _pair(rows, cols, vals, (10, 10))
    B = gt.Bell.from_matrix_data(pd, device="cpu")
    back = B.to_matrix_data()
    jback = jbell.Bell.from_matrix_data(jd).to_matrix_data()
    assert back.nnz == 4 == B.nnz
    for f in ("rows", "cols", "values"):
        np.testing.assert_array_equal(getattr(back, f), getattr(jback, f))
    np.testing.assert_array_equal(B.extract_diagonal().values.numpy(), [0, 0, 0, 0, 0, 0, 0, 0, 0, 0])


def test_to_bell_reduce_storage_extract_diagonal():
    rows, cols, vals, shape = PATTERNS["random"]()
    # diagonal entries, one of them an explicit zero
    rows = np.concatenate([rows, [5, 7]])
    cols = np.concatenate([cols, [5, 7]])
    vals = np.concatenate([vals, [2.5, 0.0]]).astype(np.float32)
    jd, pd = _pair(rows, cols, vals, shape)
    JB = JCsr.from_matrix_data(jd).to_bell()
    B = gt.Csr.from_matrix_data(pd, device="cpu").to_bell()
    for f in ("values", "panel_ids", "panel_valid", "ent_flat"):
        np.testing.assert_array_equal(getattr(B, f).numpy(), np.asarray(getattr(JB, f)))
    np.testing.assert_array_equal(B.extract_diagonal().values.numpy(),
                                  np.asarray(JB.extract_diagonal().values))
    R, JR = B.reduce_storage(), JB.reduce_storage()
    assert R.values.dtype == torch.bfloat16
    np.testing.assert_array_equal(R.values.float().numpy(),
                                  np.asarray(JR.values.astype(jnp.float32)))
    np.testing.assert_array_equal(R.extract_diagonal().values.float().numpy(),
                                  np.asarray(JR.extract_diagonal().values.astype(jnp.float32)))
    # bfloat16 panels with float32 vectors: float32 sums of the rounded values
    x = np.random.default_rng(1).standard_normal(shape[1]).astype(np.float32)
    want = R.astype(torch.float64).to_dense().values.numpy() @ x.astype(np.float64)
    got = R.apply(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_other_types_take_the_xla_arithmetic():
    rows, cols, vals, shape = PATTERNS["random"]()
    jd, pd = _pair(rows, cols, vals.astype(np.float64), shape)
    JB = jbell.Bell.from_matrix_data(jd, block_rows=16)
    B = gt.Bell.from_matrix_data(pd, block_rows=16, device="cpu")
    rng = np.random.default_rng(3)
    X = rng.standard_normal((shape[1], 2))
    C = rng.standard_normal((shape[0], 2))
    np.testing.assert_allclose(B.apply(torch.from_numpy(X)).numpy(),
                               np.asarray(JB.apply(jnp.asarray(X))), rtol=1e-12, atol=1e-12)
    got = B.apply_advanced(2.0, torch.from_numpy(X), -0.5, torch.from_numpy(C))
    np.testing.assert_allclose(got.numpy(), np.asarray(JB.apply_advanced(
        2.0, jnp.asarray(X), -0.5, jnp.asarray(C))), rtol=1e-12, atol=1e-12)
    # float32 panels with a float64 vector: the promoted type
    B32 = B.astype(torch.float32)
    y = B32.apply(torch.from_numpy(X[:, 0]))
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), np.asarray(JB.astype(jnp.float32).apply(
        jnp.asarray(X[:, 0]))), rtol=1e-12, atol=1e-12)
    for bm, jm in ((B.scale(3.0), JB.scale(3.0)), (B.compute_absolute(), JB.compute_absolute()),
                   (B.transpose(), JB.transpose()), (B.conj_transpose(), JB.conj_transpose())):
        for f in ("values", "panel_ids", "panel_valid", "ent_flat"):
            np.testing.assert_array_equal(getattr(bm, f).numpy(), np.asarray(getattr(jm, f)))
    np.testing.assert_array_equal(B.to_dense().values.numpy(), np.asarray(JB.to_dense().values))
    np.testing.assert_array_equal(B.to_csr().to_dense().values.numpy(), pd.sum_duplicates().to_dense())
