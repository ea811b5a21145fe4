"""The port's Dia and its SpMV family (ginkgo_tpu_torch.matrix.dia,
ginkgo_tpu_torch.ops.dia) against the JAX package.

The same numpy inputs go through the JAX Dia (XLA path, with
GINKGO_TPU_NO_PALLAS set) and through the Pallas kernels of
ginkgo_tpu/ops/pallas_dia.py in interpret mode, called as
tests/test_pallas_kernels.py calls them, and through the port on the CPU
(where each kernel wrapper runs its plain version).  Tolerances: rtol 1e-12
in float64 (summation order is the only difference), rtol/atol 1e-6 in
float32.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.matrix.dia import Dia as JDia
from ginkgo_tpu.ops.pallas_dia import (
    dia_advanced_spmv_pallas,
    dia_spmm_pallas,
    dia_spmv_pallas,
)
from ginkgo_tpu.utils import generators as jgen
from ginkgo_tpu_torch import Dia, interop
from ginkgo_tpu_torch.ops import dia as ops_dia

from tests.conftest import nonsym_tridiag

LANES = 128


def _banded(shape, offs, seed=0):
    rng = np.random.default_rng(seed)
    n, m = shape
    rows_l, cols_l, vals_l = [], [], []
    for o in offs:
        r = np.arange(max(0, -o), min(n, m - o))
        rows_l.append(r)
        cols_l.append(r + o)
        vals_l.append(rng.standard_normal(len(r)))
    return JMatrixData.from_coo(
        shape, np.concatenate(rows_l), np.concatenate(cols_l), np.concatenate(vals_l)
    ).sort_row_major()


MATRICES = {
    "poisson_2d_16": lambda: jgen.poisson_2d(16),
    "poisson_2d_48": lambda: jgen.poisson_2d(48),
    "poisson_1d_300": lambda: jgen.poisson_1d(300),
    "nonsym_tridiag": lambda: nonsym_tridiag(300).astype(np.float64),
    "irregular_offsets": lambda: _banded(
        (700, 700), [-300, -128, -127, -1, 0, 1, 127, 128, 129, 256, 511]
    ),
    "rect_wide": lambda: _banded((200, 460), [-3, 0, 5, 70, 259]),
    "rect_tall": lambda: _banded((460, 200), [-259, -70, -5, 0, 3]),
}
# the Pallas kernels in interpret mode cost seconds a call: a subset
PALLAS_MATRICES = ["poisson_2d_16", "irregular_offsets", "rect_wide", "nonsym_tridiag"]


def _pair(name, dtype):
    data = MATRICES[name]().astype(dtype)
    return data, JDia.from_matrix_data(data), Dia.from_matrix_data(
        interop.matrix_data_from_arrays(data.shape, data.rows, data.cols, data.values),
        device="cpu",
    )


def _frame(v, R):
    """(m,) or (m, k) -> the JAX kernels' (R, 128) / (k, R, 128) frames."""
    v = np.asarray(v)
    out = np.zeros((R * LANES,) + v.shape[1:], v.dtype)
    out[: v.shape[0]] = v
    if v.ndim == 1:
        return jnp.asarray(out.reshape(R, LANES))
    return jnp.asarray(out.T.reshape(v.shape[1], R, LANES))


@pytest.fixture
def xla_only(monkeypatch):
    monkeypatch.setenv("GINKGO_TPU_NO_PALLAS", "1")


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_from_matrix_data_matches_jax_dia(name):
    _, JA, A = _pair(name, np.float64)
    B = interop.dia_from_arrays(np.asarray(JA.diags), JA.offsets, JA.shape, device="cpu")
    assert A.offsets == JA.offsets == B.offsets
    assert A.shape == JA.shape == B.shape
    assert A.diags.shape == (len(A.offsets), A.shape[0])
    assert torch.equal(A.diags, B.diags)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_apply_f64_matches_xla(name, k, xla_only):
    data, JA, A = _pair(name, np.float64)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((data.shape[1], k))
    if k == 1:
        x = x[:, 0]
    want = np.asarray(JA.apply(jnp.asarray(x)))
    got = A.apply(torch.from_numpy(x))
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", PALLAS_MATRICES)
def test_apply_f32_matches_pallas(name):
    data, JA, A = _pair(name, np.float32)
    rng = np.random.default_rng(2)
    n, m = data.shape
    R = JA.diags.shape[1]
    x = rng.standard_normal(m).astype(np.float32)
    want = np.asarray(
        dia_spmv_pallas(JA.diags, JA.offsets, _frame(x, R), block_rows=8, interpret=True)
    ).reshape(-1)[:n]
    got = A.apply(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", PALLAS_MATRICES)
def test_spmm_f32_matches_pallas(name):
    data, JA, A = _pair(name, np.float32)
    rng = np.random.default_rng(3)
    n, m = data.shape
    R = JA.diags.shape[1]
    X = rng.standard_normal((m, 3)).astype(np.float32)
    yk = dia_spmm_pallas(JA.diags, JA.offsets, _frame(X, R), block_rows=8, interpret=True)
    want = np.asarray(yk).reshape(3, R * LANES)[:, :n].T
    got = A.apply(torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["poisson_2d_16", "irregular_offsets"])
def test_bf16_storage_matches_pallas(name):
    data, JA, A = _pair(name, np.float32)
    JB, B = JA.reduce_storage(), A.reduce_storage()
    assert B.dtype == torch.bfloat16
    # the port carries the JAX bf16 diagonals bit for bit
    C = interop.dia_from_arrays(np.asarray(JB.diags), JB.offsets, JB.shape, device="cpu")
    assert torch.equal(B.diags.view(torch.int16), C.diags.view(torch.int16))
    rng = np.random.default_rng(4)
    n = data.shape[0]
    R = JA.diags.shape[1]
    x = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(
        dia_spmv_pallas(JB.diags, JB.offsets, _frame(x, R), block_rows=16, interpret=True)
    ).reshape(-1)[:n]
    got = B.apply(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", PALLAS_MATRICES)
def test_apply_advanced_f32_matches_pallas(name):
    data, JA, A = _pair(name, np.float32)
    rng = np.random.default_rng(5)
    n, m = data.shape
    R = JA.diags.shape[1]
    x = rng.standard_normal(m).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    alpha, beta = np.float32(0.7), np.float32(-0.3)
    want = np.asarray(
        dia_advanced_spmv_pallas(
            JA.diags, JA.offsets, _frame(x, R), alpha, beta, _frame(y, R),
            block_rows=8, interpret=True,
        )
    ).reshape(-1)[:n]
    got = A.apply_advanced(0.7, torch.from_numpy(x), -0.3, torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", ["poisson_2d_48", "rect_tall", "nonsym_tridiag"])
def test_apply_advanced_f64_matches_xla(name, k, xla_only):
    data, JA, A = _pair(name, np.float64)
    rng = np.random.default_rng(6)
    n, m = data.shape
    x = rng.standard_normal((m, k))
    y = rng.standard_normal((n, k))
    want = np.asarray(JA.apply_advanced(1.7, jnp.asarray(x), -0.4, jnp.asarray(y)))
    got = A.apply_advanced(1.7, torch.from_numpy(x), -0.4, torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["poisson_2d_16", "rect_wide", "rect_tall"])
def test_structure_ops_match_jax(name, xla_only):
    data, JA, A = _pair(name, np.float64)
    np.testing.assert_array_equal(
        A.extract_diagonal().values.numpy(), np.asarray(JA.extract_diagonal().values)
    )
    np.testing.assert_array_equal(
        A.to_dense().values.numpy(), np.asarray(JA.to_dense().values)
    )
    np.testing.assert_allclose(
        A.scale(-2.5).diags.numpy(),
        np.asarray(JA.scale(-2.5).diags).reshape(A.num_diags, -1)[:, : A.shape[0]],
        rtol=0, atol=0,
    )
    T, JT = A.transpose(), JA.transpose()
    assert T.shape == JT.shape and T.offsets == JT.offsets
    md, jmd = A.to_matrix_data(), JA.to_matrix_data()
    for f in ("rows", "cols", "values"):
        np.testing.assert_array_equal(getattr(md, f), getattr(jmd, f))
    x = np.random.default_rng(8).standard_normal(T.shape[1])
    np.testing.assert_allclose(
        T.apply(torch.from_numpy(x)).numpy(),
        np.asarray(JT.apply(jnp.asarray(x))), rtol=1e-12, atol=1e-12,
    )


def test_wrappers_take_plain_version_on_cpu():
    """A CPU tensor runs the plain version and launches no kernel."""
    _, _, A = _pair("poisson_2d_16", np.float32)
    counters = (ops_dia.dia_spmv, ops_dia.dia_spmv_advanced, ops_dia.dia_spmm)
    before = [f.launches for f in counters]
    x = torch.ones(A.shape[1])
    y = A.apply(x)
    Y = A.apply(torch.ones(A.shape[1], 2))
    z = A.apply_advanced(2.0, x, 1.0, torch.ones(A.shape[0]))
    assert [f.launches for f in counters] == before
    ref = ops_dia.dia_spmv_reference(A.diags, A.offsets, x, A.shape[1])
    assert torch.equal(y, ref)
    assert torch.equal(Y[:, 0], ref) and torch.equal(Y[:, 1], ref)
    assert torch.equal(z, 2.0 * ref + 1.0)


def test_kernel_wrapper_refuses_other_devices():
    _, _, A = _pair("poisson_1d_300", np.float32)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        ops_dia.dia_spmv(A.diags, A.offsets, torch.ones(300, device="meta"), 300)
