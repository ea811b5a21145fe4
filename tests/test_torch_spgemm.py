"""SpGEMM and SpGEAM of the port (``ops/spgemm.py``, ``Csr.apply(Csr)``,
``Csr.spgemm``/``spgeam``) against the JAX package on the CPU.

The patterns (row pointers and column indices) must equal the JAX
package's exactly; the values agree to 1e-12 in float64 and 1e-5 in
float32 (both sum each output slot's products in the order of A's entries;
the port by ``torch.segment_reduce`` over the plan's run lengths).  A plan's
numeric pass run twice gives the same bits, and the value dtype is the JAX
package's, bfloat16 included.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sps
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu.matrix.csr import Csr as JCsr
from ginkgo_tpu.ops import spgemm as jspgemm
from ginkgo_tpu_torch.ops import spgemm as spgemm_ops
from tests.test_torch_formats import _np, assert_same_storage


def _sp(n, m, dens, seed):
    sp = sps.random(n, m, density=dens, random_state=seed, format="csr")
    sp.data[:] = np.random.default_rng(seed).standard_normal(sp.nnz)
    sp.sum_duplicates()
    sp.sort_indices()
    return sp


def _pair(sp, dtype=np.float64, strategy="auto"):
    sp = sp.astype(dtype)
    return (JCsr.from_scipy(sp, strategy=strategy),
            gt.Csr.from_scipy(sp, device="cpu", strategy=strategy))


def _close(C, JC, dtype):
    assert type(C).__name__ == "Csr" and C.shape == tuple(JC.shape)
    np.testing.assert_array_equal(C.row_ptrs.numpy(), np.asarray(JC.row_ptrs))
    np.testing.assert_array_equal(C.col_idxs.numpy(), np.asarray(JC.col_idxs))
    assert str(C.values.dtype).split(".")[-1] == str(JC.values.dtype)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(_np(C.values), _np(JC.values), rtol=tol, atol=tol)


SHAPES = [((60, 70), (70, 50), 0.08), ((120, 120), (120, 120), 0.03), ((40, 90), (90, 1), 0.2)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("sa,sb,dens", SHAPES)
def test_spgemm_matches_jax(sa, sb, dens, dtype):
    JA, A = _pair(_sp(*sa, dens, 1), dtype, strategy="classical")
    JB, B = _pair(_sp(*sb, dens, 2), dtype)
    C = A.apply(B)
    _close(C, JA.apply(JB), dtype)
    assert C.strategy == "classical"
    _close(A.spgemm(B), JA.spgemm(JB), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_spgeam_and_advanced_spgemm_match_jax(dtype):
    JA, A = _pair(_sp(80, 80, 0.05, 3), dtype)
    JB, B = _pair(_sp(80, 80, 0.05, 4), dtype)
    _close(A.spgeam(0.5, B, -2.0), JA.spgeam(0.5, JB, -2.0), dtype)
    _close(A.spgeam(1.0, A.transpose()), JA.spgeam(1.0, JA.transpose()), dtype)
    _close(spgemm_ops.advanced_spgemm(1.5, A, B, -0.25, A),
           jspgemm.advanced_spgemm(1.5, JA, JB, -0.25, JA), dtype)


def test_numeric_pass_repeats_its_bits_and_reuses_the_plan():
    JA, A = _pair(_sp(100, 100, 0.06, 5))
    plan = spgemm_ops.SpgemmPlan(A, A)
    jplan = jspgemm.SpgemmPlan(JA, JA)
    for f in ("c_indptr", "c_indices"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(jplan, f))
    for f in ("prod_a", "prod_b", "prod_out"):
        np.testing.assert_array_equal(getattr(plan, f).numpy(), np.asarray(getattr(jplan, f)))
    assert plan.nnz_c == jplan.nnz_c and plan.c_shape == jplan.c_shape
    v1, v2 = plan.numeric(A.values, A.values), plan.numeric(A.values, A.values)
    assert torch.equal(v1.view(torch.int64), v2.view(torch.int64))
    # a numeric update on the same patterns
    w = A.values * 3.0
    np.testing.assert_allclose(plan.numeric(w, A.values).numpy(), 3.0 * v1.numpy(),
                               rtol=1e-12, atol=1e-12)
    gplan, jgplan = spgemm_ops.SpgeamPlan(A, A.transpose()), jspgemm.SpgeamPlan(JA, JA.transpose())
    for f in ("a_slots", "b_slots"):
        np.testing.assert_array_equal(getattr(gplan, f).numpy(), np.asarray(getattr(jgplan, f)))
    g1 = gplan.numeric(1.0, A.values, 1.0, A.transpose().values)
    g2 = gplan.numeric(1.0, A.values, 1.0, A.transpose().values)
    assert torch.equal(g1.view(torch.int64), g2.view(torch.int64))


def test_spgemm_dtypes_match_jax():
    """bfloat16 values stay bfloat16 through both products, as in the JAX
    package; a float32 times a float64 matrix promotes."""
    sp = _sp(50, 50, 0.1, 6)
    JA, A = _pair(sp, np.float32)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float64, torch.float64)):
        JB, B = JA.astype(jdt), A.astype(tdt)
        for got, want in ((A.apply(B), JA.apply(JB)), (B.apply(A), JB.apply(JA)),
                          (A.spgeam(1.0, B, 1.0), JA.spgeam(1.0, JB, 1.0))):
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            np.testing.assert_array_equal(got.col_idxs.numpy(), np.asarray(want.col_idxs))
            tol = 2e-2 if "bfloat16" in str(want.dtype) else 1e-5
            np.testing.assert_allclose(_np(got.values), _np(want.values), rtol=tol, atol=tol)


def test_empty_products_match_jax():
    JA, A = _pair(_sp(30, 40, 0.0, 7))
    JB, B = _pair(_sp(40, 20, 0.1, 8))
    C, JC = A.apply(B), JA.apply(JB)
    assert C.nnz == JC.nnz and C.shape == JC.shape
    assert_same_storage(C, JC)
