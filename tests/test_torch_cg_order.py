"""The pass order K4m (cg_fused_multi) declares, held on the CPU against the
plain version its CUDA kernel is checked against.

The kernel runs each CG iteration in two passes with two grid barriers:

- pass A: q = A p, where the thread of row i forms every p_new[j] it reads
  from r[j], minv[j] and p_old[j] as z_j + beta p_old[j] (the direction
  update of the previous iteration, folded into the SpMV), writes p_new[i]
  and sums p_new.q.  p alternates between two buffers; the first iteration
  takes the p the init pass wrote, as it is.  A column that stopped before
  the previous iteration copies p_old into p_new, so it stays frozen;
- pass B: x += alpha p, r -= alpha q and the dots of the update.

An independent loop of that order on CPU tensors, float32 throughout, must
equal ``ops/cg.cg_loop_reference`` (which updates p in a pass of its own)
bit for bit: x, r, the iteration count, the monitor, the stop flags and the
per-column stop iterations, at k = 4 and at one column too (K4 keeps the
plain version's three passes).  Its SpMV is a row-wise gather per diagonal in
offset order, summed from 0 as the kernel sums a row.  The dot products are
float64 sums rounded to float32, summed as the plain version sums them:
the kernel's float64 order differs from both and is not under test here.
A stopped column's p reaches neither x nor r (its alpha is 0) unless p
holds an inf or a NaN, so which iteration freezes it shows in no output.
"""

import numpy as np
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu_torch.ops.cg import cg_loop_reference
from ginkgo_tpu_torch.ops.dia import dia_spmv_reference

F32 = torch.float32


@pytest.fixture(autouse=True)
def _one_thread():
    """The loops run many small tensor ops: one intra-op thread each, so
    that they do not spin against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dots(a, b):
    return torch.sum(a.to(torch.float64) * b.to(torch.float64), dim=0).to(F32)


def _sdiv(num, den):
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)), 0.0)


def two_pass_loop(diags, offsets, r0, x0, minv, tol, max_iters, implicit, flexible):
    """The kernel's two-pass order.  Returns what cg_loop_reference does."""
    n, k = r0.shape
    D = diags.to(F32)
    m = None if minv is None else minv.to(F32)[:, None]
    rows = torch.arange(n)
    x, r = x0.clone(), r0.clone()
    z = r if m is None else m * r
    pbuf = [z.clone(), torch.empty_like(r0)]
    rho = _dots(r, z)
    act = torch.ones(k, dtype=torch.bool)
    upd = torch.zeros(k, dtype=torch.bool)
    beta = torch.zeros(k, dtype=F32)
    itc = torch.zeros(k, dtype=torch.int32)
    mon = torch.full((k,), float("inf"), dtype=F32)
    it = 0
    while it < max_iters and bool(act.any()):
        p_cur = pbuf[it & 1]
        p_old = pbuf[(it + 1) & 1]

        def p_new(j):
            """p_new at rows j, formed from r, minv and p_old."""
            if it == 0:
                return p_cur[j]
            zj = r[j] if m is None else m[j] * r[j]
            return torch.where(upd, zj + beta * p_old[j], p_old[j])

        # pass A
        acc = torch.zeros((n, k), dtype=F32)
        for d, off in enumerate(offsets):
            ok = (rows + off >= 0) & (rows + off < n)
            acc[ok] = acc[ok] + D[d, ok][:, None] * p_new(rows[ok] + off)
        p_i = p_new(rows)
        p_cur[:] = p_i
        q = acc
        alpha = torch.where(act, _sdiv(rho, _dots(p_i, q)), 0.0)
        # pass B
        x = x + alpha * p_i
        r_old = r
        r = r_old - alpha * q
        z = r if m is None else m * r
        rho_new = _dots(r, z)
        num = _dots(r - r_old, z) if flexible else rho_new
        beta = _sdiv(num, rho)
        mon = torch.abs(rho) if implicit else _dots(r, r)
        itc = torch.where(act, it + 1, itc).to(torch.int32)
        upd = act.clone()
        act = act & ~(mon <= tol)
        rho = rho_new
        it += 1
    return x, r, torch.tensor(it, dtype=torch.int32), mon, mon <= tol, itc


def _bits_equal(a, b):
    a, b = a.contiguous(), b.contiguous()
    if a.dtype == F32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def _operator(nside, shifted, bf16):
    """poisson_2d(nside) as a Dia; ``shifted`` adds a random diagonal in
    [0, 2), so that Jacobi differs from a scaling."""
    data = gt.generators.poisson_2d(nside, dtype=np.float32)
    if shifted:
        vals = data.values.copy()
        diag = data.rows == data.cols
        vals[diag] += np.random.default_rng(nside).uniform(0, 2, int(diag.sum())).astype(np.float32)
        data = type(data)(data.shape, data.rows, data.cols, vals)
    A = gt.Dia.from_matrix_data(data, device="cpu")
    return A.reduce_storage() if bf16 else A


def _columns(nside, k, rng):
    """ones, then (k = 4) random, the (1, 2) Laplacian eigenvector, whose
    column stops early and freezes, and a ramp."""
    n = nside * nside
    if k == 1:
        return np.ones((n, 1), np.float32)
    i = np.arange(nside) + 1
    eig = np.outer(np.sin(np.pi * i / (nside + 1)), np.sin(2 * np.pi * i / (nside + 1)))
    return np.stack([np.ones(n), rng.standard_normal(n), eig.reshape(-1),
                     np.linspace(-1, 1, n)], axis=1).astype(np.float32)


def _run(A, B, *, jacobi, implicit, flexible, max_iters=2000, tol_rel=1e-6, x0=None):
    minv = 1.0 / A.extract_diagonal().values.to(F32) if jacobi else None
    B = torch.as_tensor(B)
    X0 = torch.zeros_like(B) if x0 is None else torch.as_tensor(x0)
    tol = (tol_rel * torch.linalg.vector_norm(B.double(), dim=0)).to(F32) ** 2
    n = B.shape[0]
    want = cg_loop_reference(lambda v: dia_spmv_reference(A.diags, A.offsets, v, n), B, X0,
                             minv, tol_sq_eff=tol, max_iters=max_iters, use_implicit=implicit,
                             flexible=flexible)
    got = two_pass_loop(A.diags, A.offsets, B, X0, minv, tol, max_iters, implicit, flexible)
    return got, want


def _assert_same(got, want):
    for name, g, w in zip(("x", "r", "iterations", "monitor", "converged", "stop_iterations"),
                          got, want):
        assert _bits_equal(g, w), f"{name} differs"


MODES = [(jac, imp, flex) for jac in (False, True) for imp in (False, True) for flex in (False, True)]


@pytest.mark.parametrize("nside", [32, 64])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("jacobi,implicit,flexible", MODES,
                         ids=[f"{'jacobi' if j else 'identity'}-{'implicit' if i else 'exact'}-"
                              f"{'fcg' if f else 'cg'}" for j, i, f in MODES])
def test_two_pass_order_equals_plain_version(nside, k, jacobi, implicit, flexible):
    A = _operator(nside, shifted=False, bf16=False)
    B = _columns(nside, k, np.random.default_rng(nside + k))
    got, want = _run(A, B, jacobi=jacobi, implicit=implicit, flexible=flexible)
    _assert_same(got, want)
    it, itc = int(want[2]), want[5].tolist()
    assert bool(want[4].all()) and it >= 3
    if k == 4:  # the eigenvector column froze while the others ran on
        assert itc[2] < it - 1


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("bf16", [False, True])
def test_two_pass_order_on_shifted_operator_with_jacobi(k, bf16):
    A = _operator(32, shifted=True, bf16=bf16)
    B = _columns(32, k, np.random.default_rng(3))
    x0 = np.random.default_rng(4).uniform(-0.5, 0.5, B.shape).astype(np.float32)
    for flexible in (False, True):
        _assert_same(*_run(A, B, jacobi=True, implicit=False, flexible=flexible, x0=x0))


def test_zero_column_stops_at_iteration_one():
    A = _operator(32, shifted=False, bf16=False)
    B = _columns(32, 4, np.random.default_rng(5))
    B[:, 1] = 0.0
    got, want = _run(A, B, jacobi=False, implicit=False, flexible=False)
    _assert_same(got, want)
    assert int(want[5][1]) == 1 and bool(want[4][1]) and int(want[2]) > 1


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("max_iters", [0, 1, 2])
def test_iteration_caps(k, max_iters):
    A = _operator(32, shifted=False, bf16=False)
    B = _columns(32, k, np.random.default_rng(6))
    got, want = _run(A, B, jacobi=True, implicit=False, flexible=True, max_iters=max_iters)
    _assert_same(got, want)
    assert int(want[2]) == max_iters


def test_nan_column_runs_to_the_cap_and_the_others_freeze():
    A = _operator(32, shifted=False, bf16=False)
    B = _columns(32, 4, np.random.default_rng(7))
    B[5, 3] = np.nan
    got, want = _run(A, B, jacobi=False, implicit=False, flexible=False, max_iters=300)
    _assert_same(got, want)
    assert int(want[2]) == 300 and int(want[5][3]) == 300
    assert max(want[5][:3].tolist()) < 300
