"""The chunked K8/K9 work list and the plain versions that walk it, in the
port against the JAX package on the CPU.

- ops/well.chunk_list cuts each supertile into chunks of whole G-slot
  steps; the list covers every slot once, in order.
- The chunked well_spmv_reference / well_spmm_reference (k = 1, 4, 5) on
  power-law patterns whose hub supertile splits, against well_spmv /
  well_spmm in Pallas interpret mode: float64 to 1e-12 relative, float32
  with bfloat16 values to 1e-5 relative with an absolute floor of 1e-5, as
  tests/test_torch_well.py holds the unchunked order.  A split supertile's
  sums are reordered (each chunk sums from +0.0, then the chunks add in
  order), so they are close, not equal.
- Where every supertile is one chunk, the default chunk gives the same bits
  as one chunk of any length: the TPU's order.
- A NaN in x reaches the same rows as in the JAX package over several
  chunks; x with -0.0 and inf gives the same bits through the kernel's
  touched-sub-tile fold as through folding every sub-tile.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ginkgo_tpu.ops import spmv_well as jsw
from ginkgo_tpu_torch.ops import well as ops_well
from tests.test_torch_well import _carry, _csr
from tests.test_well import _powerlaw


def _plan(n, seed, T, G):
    sp = _csr(_powerlaw(n, seed=seed))
    jp = jsw.WellPlan(sp.indptr, sp.indices, sp.data, sp.shape, G=G, T=T)
    return sp, jp, _carry(jp)


def _bits(t):
    return t.contiguous().view(torch.int64 if t.element_size() == 8 else torch.int32)


@pytest.mark.parametrize("T", [1, 4, 16])
@pytest.mark.parametrize("chunk", [8, 20, ops_well.CHUNK_SLOTS])
def test_work_list_covers_every_slot_once_on_whole_steps(T, chunk):
    _, _, A = _plan(8192, 3, T, 4)
    tp = A.tile_ptr.numpy().astype(np.int64)
    ch = ops_well.chunk_list(A, chunk)
    st, s0, s1, part = (ch.work[:, i].astype(np.int64) for i in range(4))
    assert ch.slots % A.G == 0 and ch.slots - A.G < chunk <= ch.slots
    # in slot order, end to end, each chunk inside its supertile
    assert s0[0] == 0 and s1[-1] == A.values.shape[0]
    np.testing.assert_array_equal(s0[1:], s1[:-1])
    assert np.all(np.diff(st) >= 0) and np.all(s0 >= tp[st]) and np.all(s1 <= tp[st + 1])
    # whole steps, at most one chunk long, every supertile covered
    assert np.all((s0 - tp[st]) % A.G == 0) and np.all((s1 - s0) % A.G == 0)
    assert np.all(s1 - s0 <= ch.slots) and np.all(s1 > s0)
    np.testing.assert_array_equal(np.unique(st), np.arange(len(tp) - 1))
    # a supertile of one chunk writes its rows; a split one's partials are
    # consecutive, in chunk order, and the fold list names them
    counts = np.bincount(st, minlength=len(tp) - 1)
    np.testing.assert_array_equal(part[counts[st] == 1], -1)
    np.testing.assert_array_equal(part[counts[st] > 1], np.arange(ch.n_parts))
    assert ch.fold.shape == (int((counts > 1).sum()), 3)
    for f_st, p0, n_parts in ch.fold:
        assert n_parts == counts[f_st] > 1
        np.testing.assert_array_equal(part[st == f_st], np.arange(p0, p0 + n_parts))
    if chunk == 8:
        assert ch.n_parts > 0  # the forced small chunk splits


def test_work_list_refuses_a_partial_step_and_stays_off_the_fields():
    _, _, A = _plan(4096, 11, 4, 8)
    ch = ops_well.chunk_list(A, 16)
    assert ops_well.chunk_list(A, 16) is ch  # cached on the operator
    fields = {f.name for f in dataclasses.fields(A)}
    assert "_well_chunks" not in fields
    assert A.storage_bytes() == sum(t.numel() * t.element_size() for t in
                                    (A.values, A.qidx, A.rt, A.tsb, A.bases, A.tile_ptr))
    R = A.reduce_storage()  # shares tile_ptr, builds its own list
    assert R.tile_ptr is A.tile_ptr and "_well_chunks" not in vars(R)
    np.testing.assert_array_equal(ops_well.chunk_list(R, 16).work, ch.work)
    bad = A.tile_ptr.clone()
    bad[1] += 1
    with pytest.raises(ValueError, match="whole number"):
        ops_well.WellChunks(bad.numpy(), A.G, 16)


JAX_CASES = [
    # (n, seed, T, G, chunk, values): the hub supertile splits into 8, 3, 6
    # and 2 chunks
    (4096, 11, 4, 8, 16, "f64"),
    (8192, 3, 16, 4, 64, "bf16"),
    (4096, 23, 1, 8, 20, "f64"),
    (16384, 3, 16, 8, ops_well.CHUNK_SLOTS, "f64"),
]


@pytest.mark.parametrize("n,seed,T,G,chunk,vals", JAX_CASES)
def test_chunked_plain_versions_match_pallas(n, seed, T, G, chunk, vals):
    sp, jp, A = _plan(n, seed, T, G)
    if vals == "bf16":
        jp.values = jp.values.astype(jnp.bfloat16)
        A = _carry(jp)
    ch = ops_well.chunk_list(A, chunk)
    assert ch.n_parts > 0  # a supertile splits
    vec = np.float32 if vals == "bf16" else np.float64
    tol = dict(rtol=1e-12, atol=1e-12) if vec == np.float64 else dict(rtol=1e-5, atol=1e-5)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(n).astype(vec)
    y = ops_well.well_spmv(A, torch.from_numpy(x), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jsw.well_spmv(jp, jnp.asarray(x), interpret=True)), **tol)
    if chunk == ops_well.CHUNK_SLOTS:
        return  # the largest plan: K8 only, the interpreter's SpMM takes half a minute
    # a column's sums do not depend on the others, so one JAX call with
    # k = 5 holds the port's k = 1, 4 and 5
    X = rng.standard_normal((n, 5)).astype(vec)
    want = np.asarray(jsw.well_spmm(jp, jnp.asarray(X), interpret=True))
    for k in (1, 4, 5):
        Y = ops_well.well_spmm(A, torch.from_numpy(X[:, :k].copy()), chunk)
        assert Y.shape == (n, k) and Y.dtype == torch.from_numpy(X).dtype
        np.testing.assert_allclose(Y.numpy(), want[:, :k], **tol)
    dense = A.to_dense().values.double().numpy()  # the stored values (bfloat16 rounded)
    np.testing.assert_allclose(Y.double().numpy(), dense @ X, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("T,G", [(1, 8), (4, 8), (16, 4)])
def test_default_chunk_is_the_tpu_order_where_no_supertile_splits(T, G):
    _, _, A = _plan(4096, 11, T, G)
    assert ops_well.chunk_list(A).n_parts == 0
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    X = torch.from_numpy(rng.standard_normal((4096, 4)))
    huge = 1 << 30
    assert torch.equal(_bits(ops_well.well_spmv_reference(A, x)),
                       _bits(ops_well.well_spmv_reference(A, x, huge)))
    assert torch.equal(_bits(ops_well.well_spmm_reference(A, X)),
                       _bits(ops_well.well_spmm_reference(A, X, huge)))


def test_nan_in_x_reaches_the_same_rows_over_several_chunks():
    sp, jp, A = _plan(4096, 11, 4, 8)
    assert len(ops_well.chunk_list(A, 16).work) > 4
    x = np.ones(4096)
    x[[0, 1, 1024, 4095]] = np.nan
    got = ops_well.well_spmv(A, torch.from_numpy(x), 16).numpy()
    want = np.asarray(jsw.well_spmv(jp, jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).sum() > np.isnan(sp @ x).sum()  # padding cells add rows
    ok = ~np.isnan(got)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12)


def _spmv_folding_every_subtile(A, x, chunk):
    """K8's chunked order with every step sum added into the chunk's sums,
    touched or not: the TPU kernel's fold."""
    acc = torch.promote_types(x.dtype, torch.float32)
    ch, start, count, max_count = ops_well._chunks(A, chunk, x.device)
    parts = torch.zeros((count.shape[0], A.T, 8, 128), dtype=acc)
    prod, sub = ops_well._all_cells(A, x, acc)
    for j in range(0, max_count, A.G):
        t = torch.nonzero(count > j).flatten()
        step = torch.zeros((t.shape[0], A.T, 8, 128), dtype=acc)
        for g in range(A.G):
            slots = start[t] + j + g
            ops_well._route_add(step, prod[slots], None if sub is None else sub[slots])
        parts[t] = parts[t] + step
    return ops_well._rows(ops_well._fold(parts, ch, A.tile_ptr.shape[0] - 1), A.shape[0]).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_touched_fold_gives_the_bits_of_folding_every_subtile(dtype):
    """No sum is ever -0.0, so skipping the +0.0 step sums of untouched
    sub-tiles changes no bit, with -0.0, inf and the NaNs inf makes in x."""
    _, _, A = _plan(4096, 11, 16, 4)
    rng = np.random.default_rng(9)
    x = rng.standard_normal(4096)
    x[rng.choice(4096, 3072, replace=False)] = -0.0  # rows of -0.0 columns sum to 0
    x[[0, 1024]] = np.inf  # padding cells read columns 0 and 1024: 0 * inf
    x[[5, 2049]] = -np.inf
    xt = torch.from_numpy(x).to(dtype)
    got = ops_well.well_spmv_reference(A, xt, 8)
    want = _spmv_folding_every_subtile(A, xt, 8)
    assert bool(got.isnan().any()) and bool(got.isinf().any()) and bool((got == 0).any())
    assert not bool(torch.signbit(got[got == 0]).any())  # no -0.0 sum
    assert torch.equal(_bits(got), _bits(want))
