"""The streaming route of the unstructured formats (``ops/pell.py``
``streaming_plan`` / ``linop_streaming_spmv``) against the JAX package's
``linop_streaming_spmv`` on the CPU.

- The route's plan: for Coo, Ell, Sellp, Hybrid, SparsityCsr and Fbcsr
  built from the same triples, ``streaming_plan`` picks the plan the JAX
  route picks (captured where the JAX route hands it to its kernels, forced
  on the CPU with GINKGO_TPU_FORCE_STREAMING as
  tests/test_streaming_formats.py forces it): the same kind, S, G, T and
  arrays, bit for bit.  A column-local pattern takes PELL, a locality-free
  one WELL, a bfloat16 one is planned at its own value width.
- The route's product (the kernels' plain versions on CPU tensors) agrees
  with the JAX route's (its Pallas kernels in interpret mode): 1e-12 in
  float64, 1e-5 in float32, and returns the vector's dtype; k columns run
  the S = 8 sibling where the JAX route does.
- The route declines where the JAX route declines (an empty pattern, the
  padding gates), counts it, caches the decline, and the formats then take
  their own products; a plan is built once per storage and again after an
  in-place change.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sps
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu.ops import spmv_pallas as jsp
from ginkgo_tpu.ops import spmv_well as jsw
from ginkgo_tpu_torch import interop
from ginkgo_tpu_torch.ops import pell as ops_pell
from ginkgo_tpu_torch.ops import spmv as spmv_ops
from ginkgo_tpu_torch.ops import well as ops_well
from tests.test_torch_formats import FORMAT_PAIRS, _np, _triples

ROUTE_FORMATS = ("coo", "ell", "sellp", "hybrid", "sparsity_csr", "fbcsr2")

PATTERNS = {
    # name: (shape, rows, cols, values), values float64
    "local": lambda: _triples(),
    # no column locality: the route takes WELL (PELL inflation past 4)
    "uniform": lambda: _coo(sps.random(900, 1100, density=0.01, random_state=1, format="coo")),
}


def _coo(sp):
    rng = np.random.default_rng(7)
    return sp.shape, sp.row, sp.col, rng.standard_normal(sp.nnz)


def _pair(name, pattern, dtype=np.float64):
    shape, rows, cols, vals = PATTERNS[pattern]()
    from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData

    vals32 = vals.astype(np.float32 if dtype == "bf16" else dtype)
    jd = JMatrixData.from_coo(shape, rows, cols, vals32)
    pd = interop.matrix_data_from_arrays(shape, rows, cols, vals32)
    jb, pb = FORMAT_PAIRS[name]
    JA, A = jb(jd), pb(pd)
    if dtype == "bf16":
        JA, A = JA.astype(jnp.bfloat16), A.astype(torch.bfloat16)
    return JA, A


@pytest.fixture
def jax_route(monkeypatch):
    """Run the JAX route forced on the CPU; returns (output, the plan it
    handed to its kernels)."""
    monkeypatch.setenv("GINKGO_TPU_FORCE_STREAMING", "1")
    monkeypatch.delenv("GINKGO_TPU_NO_PALLAS", raising=False)
    plans = []
    spmv, spmm = jsw.plan_spmv, jsw.plan_spmm
    monkeypatch.setattr(jsw, "plan_spmv", lambda p, x, **kw: (plans.append(p), spmv(p, x, **kw))[1])
    monkeypatch.setattr(jsw, "plan_spmm", lambda p, X, **kw: (plans.append(p), spmm(p, X, **kw))[1])

    def run(JA, arr, **kw):
        del plans[:]
        out = jsp.linop_streaming_spmv(JA, jnp.asarray(arr), **kw)
        return out, (plans[0] if plans else None)

    return run


def assert_same_plan(A, jp):
    """The port's plan operator holds the JAX route's plan bit for bit."""
    kind = "Well" if isinstance(jp, jsw.WellPlan) else "Pell"
    assert type(A).__name__ == kind
    fields = ("values", "qidx", "bases") + (("rt",) if kind == "Well" else ())
    for f in fields:
        np.testing.assert_array_equal(_np(getattr(A, f)), _np(getattr(jp, f)), err_msg=f)
    if kind == "Well":
        assert A.T == jp.T and (A.tsb is None) == (jp.tsb is None)
        if A.tsb is not None:
            np.testing.assert_array_equal(A.tsb.numpy(), np.asarray(jp.tsb))
        nt = jp.NST
    else:
        assert A.S == jp.S
        nt = jp.NT
    assert (A.G, A.n_steps, A.nnz, tuple(A.shape)) == (jp.G, jp.n_steps, jp.nnz, tuple(jp.shape))
    np.testing.assert_array_equal(A.tile_ptr.numpy(),
                                  ops_pell.tile_ptr_from_steps(jp.tile_of_step, nt, jp.G))


CASES = [(f, "local", np.float64) for f in ROUTE_FORMATS] + [
    (f, "uniform", np.float64) for f in ("coo", "hybrid", "fbcsr2")] + [
    ("ell", "local", "bf16"), ("sellp", "uniform", "bf16"), ("coo", "local", np.float32)]


@pytest.mark.parametrize("name,pattern,dtype", CASES,
                         ids=[f"{c[0]}-{c[1]}-{np.dtype(c[2]).name if c[2] != 'bf16' else 'bf16'}"
                              for c in CASES])
def test_route_plan_and_product_match_jax(name, pattern, dtype, jax_route):
    JA, A = _pair(name, pattern, dtype)
    vec = np.float64 if dtype == np.float64 else np.float32
    x = np.random.default_rng(5).standard_normal((A.shape[1], 1)).astype(vec)
    jy, jp = jax_route(JA, x)
    assert jp is not None, "the JAX route declined"
    P = ops_pell.streaming_plan(A)
    assert_same_plan(P, jp)
    if dtype == np.float64:  # both kinds are reached (at 2 bytes a value
        # the random "local" pattern takes WELL too, in both packages)
        assert type(P).__name__ == ("Well" if pattern == "uniform" else "Pell")
    y = ops_pell.linop_streaming_spmv(A, torch.from_numpy(x))
    assert y.dtype == torch.from_numpy(x).dtype and str(jy.dtype) == np.dtype(vec).name
    tol = 1e-12 if vec == np.float64 else 1e-5
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["ell", "hybrid"])
def test_route_k_columns_match_jax(name, jax_route):
    """k columns: the S = 8 sibling of an S != 8 PELL plan, as the JAX route
    builds it, and the same product."""
    JA, A = _pair(name, "local")
    X = np.random.default_rng(6).standard_normal((A.shape[1], 3))
    jY, jp = jax_route(JA, X)
    Y = ops_pell.linop_streaming_spmv(A, torch.from_numpy(X))
    P = ops_pell.streaming_plan(A)
    sibling = ops_pell._streaming_spmm_plan(A, P)
    assert_same_plan(sibling, jp)
    assert sibling.S == 8 and (sibling is P) == (P.S == 8)
    np.testing.assert_allclose(Y.numpy(), np.asarray(jY), rtol=1e-12, atol=1e-12)


def test_route_declines_where_jax_declines(jax_route, monkeypatch):
    JA, A = _pair("ell", "local")
    x = np.ones((A.shape[1], 1))
    # the padding gates: no plan passes inflation 0 and 0 padded bytes
    assert jax_route(JA, x, max_inflation=0.0, max_pad_bytes=0)[0] is None
    monkeypatch.setattr(ops_pell, "STREAM_MAX_INFLATION", 0.0)
    monkeypatch.setattr(ops_pell, "STREAM_MAX_PAD_BYTES", 0)
    declines = ops_pell.linop_streaming_spmv.declines
    assert ops_pell.linop_streaming_spmv(A, torch.from_numpy(x)) is None
    assert ops_pell.linop_streaming_spmv.declines == declines + 1
    # the decline is cached: no plan choice runs again for this storage
    calls = []
    monkeypatch.setattr(ops_pell, "streaming_plan_choice",
                        lambda *a, **k: calls.append(1))
    assert ops_pell.streaming_plan(A) is None and not calls
    # an empty pattern
    from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData

    empty = gt.Ell.from_matrix_data(gt.MatrixData.empty((40, 40)), device="cpu")
    jempty = FORMAT_PAIRS["ell"][0](JMatrixData.empty((40, 40)))
    assert jax_route(jempty, np.zeros((40, 1)))[0] is None
    monkeypatch.undo()
    assert ops_pell.streaming_plan(empty) is None


def test_plan_built_once_and_again_after_an_inplace_change():
    _, A = _pair("coo", "local")
    x = torch.ones(A.shape[1], 1, dtype=torch.float64)
    builds = ops_pell.streaming_plan.builds
    y1 = ops_pell.linop_streaming_spmv(A, x)
    P = ops_pell.streaming_plan(A)
    assert ops_pell.linop_streaming_spmv(A, x).equal(y1)
    assert ops_pell.streaming_plan.builds == builds + 1 and ops_pell.streaming_plan(A) is P
    A.values.mul_(2.0)  # the same tensor, a new version
    y2 = ops_pell.linop_streaming_spmv(A, x)
    assert ops_pell.streaming_plan.builds == builds + 2
    torch.testing.assert_close(y2, 2 * y1, rtol=1e-15, atol=0)


def test_route_value_width_of_bfloat16():
    """bfloat16 values are planned at 2 bytes a value (a host copy widens
    them to float32): the plan choice of the route equals a planner that
    is told the width."""
    _, A = _pair("coo", "uniform", "bf16")
    csr = A.to_csr()
    host = [ops_pell.types.to_host(t) for t in (csr.row_ptrs, csr.col_idxs, csr.values)]
    narrow = ops_pell.streaming_plan_choice(*host, A.shape, value_itemsize=2)
    P = ops_pell.streaming_plan(A)
    assert P.values.dtype == torch.bfloat16
    assert isinstance(narrow, ops_well.WellPlan) and (P.T, P.G) == (narrow.T, narrow.G)


def test_formats_on_cpu_take_their_own_product():
    """try_streaming is for CUDA tensors; on the CPU each format's product
    is its own, and equals the route's plain product."""
    for name in ROUTE_FORMATS:
        _, A = _pair(name, "local")
        x = torch.from_numpy(np.random.default_rng(1).standard_normal((A.shape[1], 2)))
        assert spmv_ops.try_streaming(A, x) is None
        torch.testing.assert_close(A.apply(x), ops_pell.linop_streaming_spmv(A, x),
                                   rtol=1e-12, atol=1e-12)


# -- the planner's statistics pass stands for the S = "auto" build -------------------------

def _stencil_csr(nside):
    """Path 2's 7-point Poisson pattern at a small grid (float32)."""
    d = gt.generators.poisson_3d(nside, dtype=np.float32)
    m = sps.csr_matrix((d.values, (d.rows, d.cols)), shape=d.shape)
    m.sort_indices()
    return m


def _powerlaw_csr(n):
    """Path 3a's power-law Laplacian at a small size (float32)."""
    from tests.test_torch_auto import powerlaw_laplacian

    shape, rows, cols, vals = powerlaw_laplacian(n)
    m = sps.csr_matrix((vals, (rows, cols)), shape=shape)
    m.sum_duplicates()
    m.sort_indices()
    return m


PLAN_FIELDS = ("S", "G", "NT", "NP", "n_steps", "nnz", "total_cells", "inflation")


@pytest.mark.parametrize("pattern,itemsize", [("poisson_3d(48)", 4), ("poisson_3d(48)", 2),
                                              ("powerlaw(16384)", 4)])
def test_statistics_pass_stands_for_the_auto_build(pattern, itemsize):
    """The planners build a PELL plan at the S that the S = "auto"
    statistics pass chose (``plan_for``, ``streaming_plan_choice``): that
    plan equals the S = "auto" build field by field and array by array, and
    the statistics pass (which reuses the chosen probe) equals a
    materialized plan's statistics; on the path 2 stencil (S = 32) and path
    3a's power-law pattern (S = 8), float32 and bfloat16 value widths."""
    m = _stencil_csr(48) if pattern.startswith("poisson") else _powerlaw_csr(16384)
    args = (m.indptr, m.indices, m.data, m.shape)
    kw = dict(q_dtype=np.int8, value_itemsize=itemsize)
    stats = ops_pell.PellPlan(*args, S="auto", materialize=False, **kw)
    auto = ops_pell.PellPlan(*args, S="auto", **kw)
    at_s = ops_pell.PellPlan(*args, S=stats.S, **kw)
    assert stats.S == (32 if pattern.startswith("poisson") else 8)
    for f in PLAN_FIELDS:
        assert getattr(stats, f) == getattr(auto, f) == getattr(at_s, f), f
    for f in ("values", "qidx", "bases", "tile_ptr", "tile_of_step"):
        np.testing.assert_array_equal(getattr(at_s, f), getattr(auto, f))
    # the JAX package's S = "auto" build of the same pattern (float32 values)
    if itemsize == 4:
        jp = jsp.PellPlan(*args, S="auto", q_dtype=np.int8)
        for f in ("S", "G", "n_steps", "total_cells"):
            assert getattr(jp, f) == getattr(at_s, f), f
        for f in ("values", "qidx", "bases", "tile_of_step"):
            np.testing.assert_array_equal(getattr(at_s, f), np.asarray(getattr(jp, f)))


def test_well_statistics_pass_equals_the_built_plan():
    """The WELL statistics pass, which no longer forms the entries' slots,
    gives the materialized plan's statistics, and ``choose_unstructured_plan``
    on path 3a's power-law pattern returns the JAX package's plan."""
    m = _powerlaw_csr(32768)
    args = (m.indptr, m.indices, m.data, m.shape)
    stats = ops_well.WellPlan(*args, materialize=False)
    built = ops_well.WellPlan(*args, T=stats.T)
    for f in ("T", "G", "NST", "n_steps", "total_cells", "inflation", "modeled_seconds"):
        assert getattr(stats, f) == getattr(built, f), f
    plan = ops_well.choose_unstructured_plan(*args, q_dtype=np.int8)
    jp = jsw.choose_unstructured_plan(*args, q_dtype=np.int8)
    assert isinstance(plan, ops_well.WellPlan) and isinstance(jp, jsw.WellPlan)
    assert (plan.T, plan.G, plan.n_steps) == (jp.T, jp.G, jp.n_steps)
    for f in ("values", "qidx", "rt", "tsb", "bases"):
        np.testing.assert_array_equal(getattr(plan, f), np.asarray(getattr(jp, f)))
