"""Bell (Blocked-ELL) of the port against the JAX package on the CPU.

- Bell.from_matrix_data builds the JAX package's panels, panel ids,
  validity and entry slots bit for bit; bell_inflation_estimate and
  suitable_for_bell agree exactly.
- K10/K11's plain versions (bell_spmv_reference, bell_spmm_reference) run
  on the JAX Bell's own arrays, carried across by interop.bell_from_arrays,
  against bell_spmv_pallas / bell_spmm_pallas in Pallas interpret mode, in
  float32; K11 at 2, 3 and 9 columns.  The two sum a row's 128 * K products in different orders (the
  plain version lane by lane in order, the Pallas kernels by the
  interpreter's reduction), so the bound is the worst case of two
  summation orders: |got - want| <= 2 * 128 * K * eps32 * (|A| |x|).
- The ctypes bindings of csrc/bell_spmv.cu declare every C entry point's
  arguments, and ops.bell.spmm_launch reads K11's launch through
  bell_spmm_config; a CPU bell_spmm launches nothing.
- Every other type takes the JAX package's XLA-path arithmetic: float64 to
  1e-12 relative.  Structure ops move values without arithmetic and must
  agree exactly.
"""

import re
from pathlib import Path

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
    want = np.asarray(bell_spmv_pallas(JB.values, JB.panel_ids, JB.panel_valid,
                                       jnp.asarray(xp.reshape(npc, LANES)), interpret=True))[:n]
    got = ops_bell.bell_spmv(B, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert (np.abs(got.numpy() - want) <= _bound(B, x)).all()
    # K11 at 3 columns (one launch on the card), 2 and 9 (a launch of 8
    # columns and one of 1)
    for k in (3, 2, 9):
        Xk = X if k == 3 else rng.standard_normal((m, k)).astype(np.float32)
        Xp = np.zeros((npc * LANES, k), np.float32)
        Xp[:m] = Xk
        Want = np.asarray(bell_spmm_pallas(JB.values, JB.panel_ids, jnp.asarray(Xp.T),
                                           interpret=True))[:n]
        Got = ops_bell.bell_spmm(B, torch.from_numpy(Xk)).numpy()
        assert Got.shape == (n, k)
        for j in range(k):
            assert (np.abs(Got[:, j] - Want[:, j]) <= _bound(B, Xk[:, j])).all()
        # the k-column order is the one-column order, column by column
        for j in (0, k - 1):
            torch.testing.assert_close(torch.from_numpy(Got[:, j]),
                                       ops_bell.bell_spmv(B, torch.from_numpy(Xk[:, j].copy())),
                                       rtol=0, atol=0)
        if k == 3:
            Got3 = Got
    # Bell.apply routes float32 vectors to the kernels' plain versions
    torch.testing.assert_close(B.apply(torch.from_numpy(x)), got, rtol=0, atol=0)
    torch.testing.assert_close(B.apply(torch.from_numpy(X)), torch.from_numpy(Got3),
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


class _FakeEntry:
    """A C entry point of the kernel library as ctypes would see it:
    argtypes, restype, and a call that fills an out array."""

    def __init__(self, name):
        self.name, self.calls = name, []

    def __call__(self, *args):
        self.calls.append(args)
        out = args[-1]
        for i in range(len(out)):
            out[i] = 10 + i
        return 0


class _FakeLib:
    def __init__(self):
        self.entries = {}

    def __getattr__(self, name):
        if name.startswith("__") or name == "gk_typed":  # set once the bindings are typed
            raise AttributeError(name)
        return self.entries.setdefault(name, _FakeEntry(name))


def test_spmm_launch_binding_is_declared(monkeypatch):
    src = (Path(ops_bell.__file__).resolve().parent.parent / "csrc" / "bell_spmv.cu").read_text()
    params = {name: len(args.split(","))
              for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)}
    assert set(params) >= {"bell_spmv", "bell_spmm", "bell_spmv_config", "bell_spmm_config"}
    lib = _FakeLib()
    monkeypatch.setattr(ops_bell._build, "load", lambda name: lib)
    assert ops_bell._lib() is lib
    for name, n in params.items():
        assert len(getattr(lib, name).argtypes) == n, name
        assert getattr(lib, name).restype is not None, name
    rows, cols, vals, shape = PATTERNS["blocks"]()
    B = gt.Bell.from_matrix_data(_pair(rows, cols, vals, shape)[1], block_rows=16, device="cpu")
    got = ops_bell.spmm_launch(B, 9)
    assert list(got) == list(ops_bell.SPMM_LAUNCH_FIELDS)
    assert list(got.values()) == list(range(10, 10 + len(ops_bell.SPMM_LAUNCH_FIELDS)))
    (call,) = lib.bell_spmm_config.calls
    assert call[:5] == (ops_bell.DTYPE_CODE[torch.float32], B.values.shape[1], 16, shape[0], 9)
    assert ops_bell.SPMM_LAUNCH_FIELDS[:len(ops_bell.LAUNCH_FIELDS)] == ops_bell.LAUNCH_FIELDS
    assert ops_bell.SPMM_LAUNCH_FIELDS[-1] == "column_groups"
    # a CPU bell_spmm takes its plain version and launches nothing
    before = ops_bell.bell_spmm.launches
    X = torch.from_numpy(np.random.default_rng(2).standard_normal((shape[1], 4)).astype(np.float32))
    torch.testing.assert_close(ops_bell.bell_spmm(B, X), ops_bell.bell_spmm_reference(B, X),
                               rtol=0, atol=0)
    assert ops_bell.bell_spmm.launches == before
    assert not lib.bell_spmm.calls


@pytest.mark.parametrize("panels", ["f32", "bf16"])
def test_wide_row_blocks_match_jax(panels):
    """Bells of 8192-row blocks (K11 at 8 columns keeps its row totals in Y
    there on the card, the totals no longer fitting a block's shared
    memory): the arrays equal the JAX Bell's, and the plain versions equal
    the JAX Bell's product within two summation orders' bound, at 1, 4, 8
    and 9 columns."""
    import scipy.sparse as sps

    rows, cols, vals, shape = block_structured(3, 8192, 2, 4, density=0.05, seed=5)
    keep = rows < 3 * 8192 - 5
    rows, cols, vals, shape = rows[keep], cols[keep], vals[keep], (3 * 8192 - 5, shape[1])
    jd, pd = _pair(rows, cols, vals, shape)
    JB = jbell.Bell.from_matrix_data(jd, block_rows=8192)
    B = gt.Bell.from_matrix_data(pd, block_rows=8192, device="cpu")
    for f in ("values", "panel_ids", "panel_valid", "ent_flat"):
        np.testing.assert_array_equal(getattr(B, f).numpy(), np.asarray(getattr(JB, f)))
    if panels == "bf16":
        JB, B = JB.reduce_storage(), B.reduce_storage()
    # |A| as stored (the entries row-major, as ent_flat holds their slots)
    d = pd.sum_duplicates()
    stored = B.values.double().numpy().reshape(-1)[B.ent_flat.numpy()]
    absA = sps.csr_matrix((np.abs(stored), (d.rows, d.cols)), shape=shape)
    rng = np.random.default_rng(9)
    K = B.values.shape[1]
    for k in (None, 4, 8, 9):
        x = rng.standard_normal((shape[1],) if k is None else (shape[1], k)).astype(np.float32)
        want = np.asarray(JB.apply(jnp.asarray(x)), np.float64)
        got = (ops_bell.bell_spmv_reference(B, torch.from_numpy(x)) if k is None
               else ops_bell.bell_spmm_reference(B, torch.from_numpy(x))).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        bound = 2 * LANES * K * EPS32 * (absA @ np.abs(x.astype(np.float64)))
        assert (np.abs(got - want) <= bound).all(), k
