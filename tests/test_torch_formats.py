"""The unstructured formats of the port (Coo, Ell, Sellp, Hybrid, SparsityCsr,
Fbcsr), the rest of Csr, Dense and the diagonal module, IndexSet and the
components, against the JAX package on the CPU.

Every format is built in both packages from the same host triples (seeded
numpy, a few stored zeros among them): its storage must equal the JAX
package's exactly (Sellp's slice sets, Hybrid's split, Fbcsr's blocks);
``apply``/``apply2``/``apply_advanced`` agree to 1e-12 in float64 and 1e-5
in float32 (the two sum a row's products in other orders); structure ops
and conversions move values without arithmetic and must agree exactly.
On CPU tensors every format takes its own product (the streaming route is
for CUDA tensors, as the JAX package's is for a TPU), and no kernel runs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sps
import torch

import ginkgo_tpu as gko
import ginkgo_tpu_torch as gt
from ginkgo_tpu.base.index_set import IndexSet as JIndexSet
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.ops import components as jcomp
from ginkgo_tpu_torch import interop
from ginkgo_tpu_torch.ops import components as comp
from ginkgo_tpu_torch.ops import pell as ops_pell
from ginkgo_tpu_torch.ops import spmv as spmv_ops
from ginkgo_tpu_torch.ops import well as ops_well

J = gko.matrix


def _triples(n=130, m=150, dens=0.04, seed=11, zeros=3):
    """A random pattern with one empty row, one long row and ``zeros``
    stored zeros."""
    rng = np.random.default_rng(seed)
    sp = sps.random(n, m, density=dens, random_state=seed, format="coo")
    rows = np.concatenate([sp.row, np.full(m // 2, 5)])
    cols = np.concatenate([sp.col, rng.choice(m, m // 2, replace=False)])
    keep = rows != 9  # row 9 stays empty
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(len(rows))
    vals[rng.choice(len(vals), zeros, replace=False)] = 0.0
    return (n, m), rows, cols, vals


def _data(dtype=np.float64, **kw):
    shape, rows, cols, vals = _triples(**kw)
    vals = vals.astype(dtype)
    return (JMatrixData.from_coo(shape, rows, cols, vals),
            interop.matrix_data_from_arrays(shape, rows, cols, vals))


FORMAT_PAIRS = {
    # name: (the JAX constructor, the port's), each from (JAX MatrixData, port MatrixData)
    "coo": (lambda d: J.coo.Coo.from_matrix_data(d),
            lambda d: gt.Coo.from_matrix_data(d, device="cpu")),
    "ell": (lambda d: J.ell.Ell.from_matrix_data(d),
            lambda d: gt.Ell.from_matrix_data(d, device="cpu")),
    "ell_k4": (lambda d: J.ell.Ell.from_matrix_data(d, 4),
               lambda d: gt.Ell.from_matrix_data(d, 4, device="cpu")),
    "sellp": (lambda d: J.ell.Sellp.from_matrix_data(d),
              lambda d: gt.Sellp.from_matrix_data(d, device="cpu")),
    "sellp_16_3": (lambda d: J.ell.Sellp.from_matrix_data(d, 16, 3),
                   lambda d: gt.Sellp.from_matrix_data(d, 16, 3, device="cpu")),
    "hybrid": (lambda d: J.hybrid.Hybrid.from_matrix_data(d),
               lambda d: gt.Hybrid.from_matrix_data(d, device="cpu")),
    "hybrid_column_limit": (
        lambda d: J.hybrid.Hybrid.from_matrix_data(d, "column_limit", 2),
        lambda d: gt.Hybrid.from_matrix_data(d, "column_limit", 2, device="cpu")),
    "hybrid_imbalance": (
        lambda d: J.hybrid.Hybrid.from_matrix_data(d, "imbalance_limit", 0.5),
        lambda d: gt.Hybrid.from_matrix_data(d, "imbalance_limit", 0.5, device="cpu")),
    "sparsity_csr": (lambda d: J.sparsity_csr.SparsityCsr.from_matrix_data(d),
                     lambda d: gt.SparsityCsr.from_matrix_data(d, device="cpu")),
    "fbcsr2": (lambda d: J.fbcsr.Fbcsr.from_matrix_data(d, 2),
               lambda d: gt.Fbcsr.from_matrix_data(d, 2, device="cpu")),
    "fbcsr4": (lambda d: J.fbcsr.Fbcsr.from_matrix_data(d, 4),
               lambda d: gt.Fbcsr.from_matrix_data(d, 4, device="cpu")),
}

FIELDS = {
    "Coo": ("rows", "cols", "values"),
    "Ell": ("col_idxs", "values"),
    "Sellp": ("slice_sets", "col_idxs", "values"),
    "SparsityCsr": ("row_ptrs", "col_idxs", "value"),
    "Fbcsr": ("block_row_ptrs", "block_cols", "blocks"),
    "Csr": ("row_ptrs", "col_idxs", "values"),
}


def _np(a):
    """A JAX or torch array as numpy (bfloat16 as float32)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_same_storage(P, JP):
    """The port's format holds exactly the JAX package's arrays."""
    name = type(P).__name__
    assert name == type(JP).__name__
    assert tuple(P.shape) == tuple(JP.shape)
    if name == "Hybrid":
        assert_same_storage(P.ell, JP.ell)
        assert_same_storage(P.coo, JP.coo)
        return
    for f in FIELDS[name]:
        got, want = getattr(P, f), _np(getattr(JP, f))
        assert str(got.dtype).split(".")[-1] == str(np.asarray(getattr(JP, f)).dtype), f
        np.testing.assert_array_equal(_np(got), want, err_msg=f"{name}.{f}")
    for f in ("slice_size", "block_size"):
        if hasattr(JP, f):
            assert getattr(P, f) == getattr(JP, f)


def _pair(name, dtype=np.float64, **kw):
    jd, pd = _data(dtype, **kw)
    jb, pb = FORMAT_PAIRS[name]
    return jb(jd), pb(pd)


@pytest.mark.parametrize("name", sorted(FORMAT_PAIRS))
def test_storage_matches_jax(name):
    JA, A = _pair(name)
    assert_same_storage(A, JA)
    if hasattr(JA, "nnz"):
        assert A.nnz == JA.nnz


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(FORMAT_PAIRS))
def test_apply_matches_jax(name, dtype, k):
    JA, A = _pair(name, dtype)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((A.shape[1], k)).astype(dtype)
    y = rng.standard_normal((A.shape[0], k)).astype(dtype)
    if k == 1:
        x, y = x[:, 0], y[:, 0]
    got = A.apply(torch.from_numpy(x))
    want = JA.apply(jnp.asarray(x))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _close(got, want, dtype)
    got = A.apply_advanced(0.5, torch.from_numpy(x), -2.0, torch.from_numpy(y))
    _close(got, JA.apply_advanced(0.5, jnp.asarray(x), -2.0, jnp.asarray(y)), dtype)
    if name == "coo":
        got = A.apply2(torch.from_numpy(x), torch.from_numpy(y))
        _close(got, JA.apply2(jnp.asarray(x), jnp.asarray(y)), dtype)


@pytest.mark.parametrize("name", sorted(FORMAT_PAIRS))
def test_structure_ops_match_jax(name):
    JA, A = _pair(name)
    if hasattr(JA, "extract_diagonal"):
        np.testing.assert_array_equal(_np(A.extract_diagonal().values),
                                      _np(JA.extract_diagonal().values))
    np.testing.assert_array_equal(_np(A.to_dense().values), _np(JA.to_dense().values))
    assert_same_storage(A.to_csr(), JA.to_csr())
    assert A.to_csr(strategy="classical").strategy == "classical"
    md, jmd = A.to_matrix_data(), JA.to_matrix_data()
    for f in ("rows", "cols", "values"):
        np.testing.assert_array_equal(getattr(md, f), _np(getattr(jmd, f)))
    if hasattr(JA, "compute_absolute"):
        assert_same_storage(A.compute_absolute(), JA.compute_absolute())
    if hasattr(JA, "transpose"):
        assert_same_storage(A.transpose(), JA.transpose())
    if hasattr(JA, "scale"):
        assert_same_storage(A.scale(-1.5), JA.scale(-1.5))
    if hasattr(JA, "conj_transpose"):
        assert_same_storage(A.conj_transpose(), JA.conj_transpose())
    assert_same_storage(A.astype(torch.float32), JA.astype(jnp.float32))


def test_sparsity_csr_adjacency_matches_jax():
    JA, A = _pair("sparsity_csr", n=150, m=150, dens=0.05)
    assert_same_storage(A.to_adjacency_matrix(), JA.to_adjacency_matrix())
    assert A.num_nonzeros == JA.num_nonzeros


def test_format_conversions_keep_stored_zeros_out():
    """Ell, Sellp and Fbcsr drop stored zeros on the way to their CSR view,
    a Hybrid those of its ELL part (as the JAX package's do); Coo keeps
    them."""
    jd, pd = _data()
    C = gt.Csr.from_matrix_data(pd, device="cpu")
    zeros = int((C.values == 0).sum())
    assert zeros == 3
    for name in ("ell", "sellp", "fbcsr2"):
        assert FORMAT_PAIRS[name][1](pd).to_csr().nnz == C.nnz - zeros, name
    H = FORMAT_PAIRS["hybrid"][1](pd)
    padding = H.ell.values.numel() - (C.nnz - H.coo.nnz)
    ell_zeros = int((H.ell.values == 0).sum()) - padding
    assert ell_zeros + int((H.coo.values == 0).sum()) == zeros
    assert H.to_csr().nnz == C.nnz - ell_zeros
    assert FORMAT_PAIRS["coo"][1](pd).to_csr().nnz == C.nnz


# -- Csr additions -------------------------------------------------------------------


def _csr_pair(dtype=np.float64, **kw):
    jd, pd = _data(dtype, **kw)
    return J.csr.Csr.from_matrix_data(jd), gt.Csr.from_matrix_data(pd, device="cpu")


@pytest.mark.parametrize("conv,args", [
    ("to_coo", ()), ("to_ell", ()), ("to_ell", (3,)), ("to_sellp", ()), ("to_sellp", (32, 2)),
    ("to_hybrid", ()), ("to_fbcsr", (3,)), ("to_sparsity_csr", ())])
def test_csr_conversions_match_jax(conv, args):
    JC, C = _csr_pair()
    assert_same_storage(getattr(C, conv)(*args), getattr(JC, conv)(*args))


def test_csr_to_hybrid_strategies_match_jax():
    JC, C = _csr_pair()
    for kw in ({"strategy": "column_limit", "strategy_arg": 3},
               {"strategy": "imbalance_limit", "strategy_arg": 0.3}):
        assert_same_storage(C.to_hybrid(**kw), JC.to_hybrid(**kw))


def test_sellp_and_hybrid_of_a_skewed_csr_match_jax():
    """Vectorized Sellp.from_csr and Hybrid.from_csr against the JAX
    package's row loops: a row count that is no multiple of the slice, empty
    slices, one row of 300 entries."""
    shape, rows, cols, vals = _triples(n=200, m=400, dens=0.01, seed=3)
    rows = np.concatenate([rows, np.full(300, 131)])
    cols = np.concatenate([cols, np.arange(300)])
    vals = np.concatenate([vals, np.ones(300)])
    keep = (rows < 64) | (rows >= 128)  # slice 1 of 64 rows holds nothing
    args = (shape, rows[keep], cols[keep], vals[keep])
    JC = J.csr.Csr.from_matrix_data(JMatrixData.from_coo(*args))
    C = gt.Csr.from_matrix_data(interop.matrix_data_from_arrays(*args), device="cpu")
    for conv, a in (("to_sellp", ()), ("to_sellp", (64, 4)), ("to_sellp", (7, 1)),
                    ("to_hybrid", ()), ("to_ell", ())):
        assert_same_storage(getattr(C, conv)(*a), getattr(JC, conv)(*a))


def test_csr_submatrix_and_sorting_match_jax():
    JC, C = _csr_pair()
    rows = [3, 5, 9, 40, 41, 100]
    jset, pset = JIndexSet(C.shape[1], [1, 2, 3, 70, 149]), gt.IndexSet(C.shape[1],
                                                                         [1, 2, 3, 70, 149])
    for r, c, jc in ((rows, pset, jset), (slice(10, 90), slice(0, 150, 3), slice(0, 150, 3)),
                     (gt.IndexSet(C.shape[0], rows), [7, 5, 5, 0], [7, 5, 5, 0])):
        jr = JIndexSet(C.shape[0], rows) if isinstance(r, gt.IndexSet) else r
        assert_same_storage(C.create_submatrix(r, c), JC.create_submatrix(jr, jc))
    assert C.is_sorted_by_column_index() and JC.is_sorted_by_column_index()
    # rows with their columns reversed, as hand-built storage might hold
    order = np.concatenate([np.arange(a, b)[::-1] for a, b in
                            zip(C.row_ptrs.numpy()[:-1], C.row_ptrs.numpy()[1:])])
    U = C.replace(col_idxs=C.col_idxs[order], values=C.values[order])
    JU = JC.replace(col_idxs=JC.col_idxs[order], values=JC.values[order])
    assert not U.is_sorted_by_column_index() and not JU.is_sorted_by_column_index()
    assert_same_storage(U.sort_by_column_index(), JU.sort_by_column_index())
    assert C.sort_by_column_index() is C


def test_csr_from_device_data_matches_jax():
    shape, rows, cols, vals = _triples()
    perm = np.random.default_rng(1).permutation(len(rows))
    jdd = gko.DeviceMatrixData(rows=jnp.asarray(rows[perm], jnp.int32),
                               cols=jnp.asarray(cols[perm], jnp.int32),
                               values=jnp.asarray(vals[perm]), shape=shape)
    pdd = gt.DeviceMatrixData(rows=torch.as_tensor(rows[perm], dtype=torch.int32),
                              cols=torch.as_tensor(cols[perm], dtype=torch.int32),
                              values=torch.as_tensor(vals[perm]), shape=shape)
    C = gt.Csr.from_device_data(pdd, strategy="classical")
    assert_same_storage(C, J.csr.Csr.from_device_data(jdd))
    assert C.strategy == "classical"


# -- Dense and the diagonal module ---------------------------------------------------


def _dense_pair(dtype=np.float64):
    v = np.random.default_rng(8).standard_normal((9, 6)).astype(dtype)
    v[2, 3] = 0.0
    return J.dense.Dense.create(jnp.asarray(v)), gt.Dense.create(v, device="cpu")


def test_dense_additions_match_jax():
    JD, D = _dense_pair()
    perm_r, perm_c = [3, 0, 8, 1, 2, 7, 6, 5, 4], [5, 1, 0, 3, 4, 2]
    ops = {
        "row_gather": ([2, 2, 7],), "row_permute": (perm_r,),
        "inverse_row_permute": (perm_r,), "column_permute": (perm_c,),
        "inverse_column_permute": (perm_c,), "fill": (2.5,),
        "add_scaled_identity": (0.5, -2.0),
        "create_submatrix": (slice(1, 7), slice(0, 5, 2)),
        "get_real": (), "get_imag": (), "make_complex": (),
    }
    for name, args in ops.items():
        got, want = getattr(D, name)(*args).values, getattr(JD, name)(*args).values
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    np.testing.assert_allclose(D.compute_mean().numpy(), np.asarray(JD.compute_mean()),
                               rtol=1e-14)
    S = gt.Dense.create(np.arange(36.0).reshape(6, 6), device="cpu")
    JS = J.dense.Dense.create(jnp.arange(36.0).reshape(6, 6))
    np.testing.assert_array_equal(S.symm_permute([5, 3, 1, 0, 2, 4]).values.numpy(),
                                  np.asarray(JS.symm_permute([5, 3, 1, 0, 2, 4]).values))
    assert_same_storage(D.to_csr(), JD.to_csr())
    assert_same_storage(D.to_coo(), JD.to_coo())
    C = D.make_complex()
    np.testing.assert_array_equal(C.get_imag().values.numpy(),
                                  np.asarray(JD.make_complex().get_imag().values))


def test_diagonal_module_matches_jax():
    d = np.random.default_rng(2).uniform(1, 2, 12)
    JDg, Dg = J.diagonal.Diagonal.create(d), gt.Diagonal.create(d, device="cpu")
    assert_same_storage(Dg.to_csr(), JDg.to_csr())
    assert Dg.to_csr("classical").strategy == "classical"
    I = gt.IdentityFactory(torch.float64).generate(Dg)
    assert I.shape == (12, 12) and I.dtype == torch.float64
    assert J.diagonal.IdentityFactory(jnp.float64).generate(JDg).shape == I.shape
    perm = np.random.default_rng(3).permutation(12)
    JP, P = J.diagonal.Permutation.create(perm), gt.Permutation.create(perm, device="cpu")
    assert P.shape == JP.shape and str(P.dtype).split(".")[-1] == str(JP.dtype)
    X = np.random.default_rng(4).standard_normal((12, 3))
    for name in ("apply", "inverse_apply"):
        np.testing.assert_array_equal(getattr(P, name)(torch.from_numpy(X)).numpy(),
                                      np.asarray(getattr(JP, name)(jnp.asarray(X))))
    np.testing.assert_array_equal(P.transpose().to_host(), JP.transpose().to_host())
    np.testing.assert_array_equal(P.apply(torch.from_numpy(X[:, 0])).numpy(),
                                  np.asarray(JP.apply(jnp.asarray(X[:, 0]))))
    JR = J.diagonal.RowGatherer.create([4, 4, 0, 11], 12)
    R = gt.RowGatherer.create([4, 4, 0, 11], 12, device="cpu")
    assert R.shape == JR.shape == (4, 12)
    np.testing.assert_array_equal(R.apply(torch.from_numpy(X)).numpy(),
                                  np.asarray(JR.apply(jnp.asarray(X))))


# -- IndexSet and the components ------------------------------------------------------


def test_index_set_matches_jax():
    idx = [0, 1, 2, 7, 8, 20, 21, 22, 23, 59]
    for args in ((60, idx), (60, idx[::-1]), (60, [3, 3, 4]), (10, None), (60, idx, True)):
        JS, S = JIndexSet(*args), gt.IndexSet(*args)
        for f in ("begins", "ends", "offsets"):
            np.testing.assert_array_equal(getattr(S, f), getattr(JS, f))
        assert S.num_subsets == JS.num_subsets and S.get_num_elems() == JS.get_num_elems()
        assert S.get_size() == JS.get_size() and repr(S) == repr(JS)
        np.testing.assert_array_equal(S.to_global_indices(), JS.to_global_indices())
        np.testing.assert_array_equal(S.complement().to_global_indices(),
                                      JS.complement().to_global_indices())
        probe = np.arange(-1, 62) % S.size
        np.testing.assert_array_equal(S.contains(probe), JS.contains(probe))
        np.testing.assert_array_equal(S.get_local_index(probe), JS.get_local_index(probe))
        assert S.get_local_index(5) == JS.get_local_index(5)
        if S.get_num_elems():
            loc = np.arange(S.get_num_elems())
            np.testing.assert_array_equal(S.get_global_index(loc), JS.get_global_index(loc))
            assert S.get_global_index(0) == JS.get_global_index(0)
    with pytest.raises(ValueError):
        gt.IndexSet(5, [7])
    with pytest.raises(IndexError):
        gt.IndexSet(5, [1]).get_global_index(3)


def test_components_match_jax():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 9, 17).astype(np.int32)
    t = torch.from_numpy(a)
    for name in ("prefix_sum_nonnegative", "inclusive_prefix_sum", "absolute_array"):
        np.testing.assert_array_equal(getattr(comp, name)(t).numpy(),
                                      np.asarray(getattr(jcomp, name)(jnp.asarray(a))))
    assert int(comp.reduce_add_array(t, 3)) == int(jcomp.reduce_add_array(jnp.asarray(a), 3))
    assert int(comp.max_array(t)) == int(jcomp.max_array(jnp.asarray(a)))
    np.testing.assert_array_equal(comp.fill_array((2, 3), 1.5, torch.float64, device="cpu"),
                                  np.asarray(jcomp.fill_array((2, 3), 1.5, jnp.float64)))
    np.testing.assert_array_equal(comp.fill_seq_array(6, device="cpu").numpy(),
                                  np.asarray(jcomp.fill_seq_array(6)))
    assert comp.convert_precision(t, torch.float64).dtype == torch.float64
    ptrs = np.concatenate([[0], np.cumsum(a)]).astype(np.int32)
    idxs = comp.convert_ptrs_to_idxs(torch.from_numpy(ptrs), int(ptrs[-1]))
    np.testing.assert_array_equal(
        idxs.numpy(), np.asarray(jcomp.convert_ptrs_to_idxs(jnp.asarray(ptrs), int(ptrs[-1]))))
    back = comp.convert_idxs_to_ptrs(idxs, len(a))
    np.testing.assert_array_equal(back.numpy(), ptrs)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcomp.convert_idxs_to_ptrs(jnp.asarray(idxs.numpy()), len(a))))
    js, ps = jcomp.DisjointSets(10), comp.DisjointSets(10)
    for x, y in ((0, 1), (2, 3), (1, 3), (7, 8), (8, 9), (0, 9), (4, 4)):
        assert ps.join(x, y) == js.join(x, y)
    assert [ps.find(i) for i in range(10)] == [js.find(i) for i in range(10)]
    assert [ps.size_of(i) for i in range(10)] == [js.size_of(i) for i in range(10)]
    assert [ps.is_representative(i) for i in range(10)] == [js.is_representative(i)
                                                           for i in range(10)]
    assert len(ps) == len(js)


def test_cpu_formats_launch_no_kernel():
    """On CPU tensors the formats take their own products: the route and
    its kernels stay untouched."""
    jd, pd = _data(np.float32)
    counters = (ops_pell.pell_spmv, ops_pell.pell_spmm, ops_well.well_spmv,
                ops_well.well_spmm)
    before = [f.launches for f in counters]
    builds = ops_pell.streaming_plan.builds
    x = torch.ones(pd.shape[1])
    for name in sorted(FORMAT_PAIRS):
        A = FORMAT_PAIRS[name][1](pd)
        assert spmv_ops.try_streaming(A, x[:, None]) is None
        A.apply(x)
        A.apply(torch.ones(pd.shape[1], 2))
    assert [f.launches for f in counters] == before
    assert ops_pell.streaming_plan.builds == builds


def test_fbcsr_block_keys_past_int32():
    """Fbcsr.from_csr of poisson_3d(48) at block size 2: 55,296^2 block keys
    pass 2^31, and a Csr's host triples carry int32 indices.  The port
    forms its keys in int64 and equals the Csr's product; the JAX package
    forms them in the indices' int32 and wraps there (a declared
    difference), but agrees where its triples are int64."""
    data = gt.generators.poisson_3d(48, dtype=np.float64)
    C = gt.Csr.from_matrix_data(data, device="cpu")
    F = gt.Fbcsr.from_csr(C, 2)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((C.shape[0], 2)))
    torch.testing.assert_close(F.apply(x), C.apply(x), rtol=1e-12, atol=1e-12)
    jd = JMatrixData.from_coo(data.shape, data.rows, data.cols, data.values)
    assert_same_storage(gt.Fbcsr.from_matrix_data(data, 2, device="cpu"),
                        J.fbcsr.Fbcsr.from_matrix_data(jd, 2))
    JF = J.csr.Csr.from_matrix_data(jd).to_fbcsr(2)  # the JAX package's wrapped keys
    assert not np.allclose(np.asarray(JF.apply(jnp.asarray(x.numpy()))), C.apply(x).numpy())
