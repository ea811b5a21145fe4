"""The schedule of K12's ring route (``bicgstab_fused`` on a Dia whose ring
fits a block), held on the CPU against the plain version its CUDA kernel
is checked against.

The ring route (``csrc/bicgstab_fused.cu`` ``bicgstab_ring_kernel``) runs a
BiCGSTAB iteration in three passes.  Each block owns a contiguous range of
rows (a multiple of 8 long) and walks it with a halo of w = max |offset|
rows on each side, C rows a step:

- pass A forms p_new = r + beta (p_old - omega v_old) on every row of the
  walk into a ring of ``ring_rows`` positions, writes it on the own rows,
  and takes v = (A M) p_new on the own rows from the ring, the chunk L =
  ceil((H + w) / C) + 1 steps behind the one it forms (H: the halo rows
  before the range); p and v alternate between two buffers;
- pass B forms s = r - alpha v the same way and takes t = (A M) s; the
  half step is decided after its fold (s.s, t.s and t.t together);
- pass C updates x and r on the own rows, s formed again from r and v.

An independent numpy loop of that schedule, float32 throughout, must equal
``ops/bicgstab.bicgstab_solve_reference`` bit for bit: x, r, the iteration
count and the monitor, on operators built by the JAX package and carried
across by ``interop``.  The loop also asserts what the kernel relies on:
every position a step reads was formed in an earlier step and is still in
the ring, no position a step reads is written in the same step, no block
reads a halo row of a buffer that a block writes in the same pass, and
every row is written by exactly one block.  Cases: w = 0 (2 I, which stops
in the first half step), 1, 31 and 2048; w larger than a block's range;
odd n; NaN in b; bfloat16 diagonals; Jacobi folded into A M; implicit
mode.  The dot products are float64 sums rounded to float32, summed as the
plain version sums them: the kernel's float64 order differs and is not
under test here.

K12m (``bicgstab_fused_multi_kernel``) runs the same three passes at k
columns without a ring: each row forms p_new or s at every neighbour it
gathers, from vectors no row writes in that pass (``multi_loop``), and a
stopped column selects its old p and v; it must equal
``bicgstab_solve_multi_reference`` bit for bit, stop iterations included.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.matrix.dia import Dia as JDia
import ginkgo_tpu_torch
from ginkgo_tpu_torch import interop
from ginkgo_tpu_torch.ops import bicgstab as ops_bicgstab
from ginkgo_tpu_torch.ops.bicgstab import bicgstab_solve_reference, ring_plan, ring_smem
from ginkgo_tpu_torch.ops.cg import _dots, _sdiv
from ginkgo_tpu_torch.solver._fused_gate import fold_minv

F32 = np.float32

_SOURCE = (Path(ginkgo_tpu_torch.__file__).parent / "csrc" / "bicgstab_fused.cu").read_text()


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", _SOURCE).group(1))


#: rows a walk step takes: the kernel's own constant
CHUNK = _define("GK_BCG_CHUNK")


@pytest.fixture(autouse=True)
def _one_thread():
    """The loops run many small tensor ops: one intra-op thread each, so
    that they do not spin against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def grid_operator(nx, ny, coeffs, jitter=True):
    """A nonsymmetric diagonally dominant 5-point operator on an nx x ny
    grid (offsets +-1 and +-nx; +-1 alone when ny is 1), coefficients
    (diagonal, west/south, east/north), a zero coefficient leaving its
    diagonals out, built by the JAX package as a Dia and carried across.
    Returns the port's Dia."""
    n = nx * ny
    i = np.arange(n)
    ix, iy = i % nx, i // nx
    diag, lo, hi = coeffs
    extra = np.random.default_rng(nx + ny).uniform(0.0, 0.5, n) if jitter else 0.0
    rows, cols, vals = [i], [i], [diag + extra + np.zeros(n)]
    for on, keep, off, v in ((nx > 1, ix > 0, -1, lo), (nx > 1, ix < nx - 1, 1, hi),
                             (ny > 1, iy > 0, -nx, lo), (ny > 1, iy < ny - 1, nx, hi)):
        if on and v != 0.0:
            rows.append(i[keep])
            cols.append(i[keep] + off)
            vals.append(np.full(int(keep.sum()), v))
    J = JDia.from_matrix_data(JMatrixData.from_coo(
        (n, n), np.concatenate(rows), np.concatenate(cols),
        np.concatenate(vals).astype(F32)))
    return interop.dia_from_arrays(np.asarray(J.diags), J.offsets, J.shape, device="cpu")


def ranges(n, blocks):
    """The kernel's ranges: block b owns [b T, b T + T), T = ceil(n / blocks)
    rounded up to a multiple of 8 (the walk's copies are 16 bytes, of
    bfloat16 diagonals too)."""
    T = (-(-n // blocks) + 7) & ~7
    return [(min(b * T, n), max(0, min(T, n - b * T))) for b in range(blocks)]


class Buffers:
    """The device vectors of one pass: which rows each is read on and
    written on, by which block, so that a block never reads a row of a
    vector that another block writes in the same pass."""

    def __init__(self):
        self.reads, self.writes = {}, {}

    def read(self, name, rows, block):
        self.reads.setdefault(name, []).append((block, rows))

    def write(self, name, rows, block):
        self.writes.setdefault(name, []).append((block, rows))

    def check(self, n):
        for name, ws in self.writes.items():
            seen = np.zeros(n, np.int64)
            for _, rows in ws:
                np.add.at(seen, rows, 1)
            assert (seen == 1).all(), f"{name}: a row written by no block or by two"
            assert name not in self.reads, f"{name} read across rows while it is written"


def walk(D, offsets, n, w, ring_rows, a, ln, form_of, use, block, bufs, form_reads):
    """One block's walk over its rows [a, a+ln) (``gk_bcg_walk``).
    form_of(rows) forms the walk's rows; use(rows, product, ring at rows)
    takes the own rows' products.  Returns the formed own rows and values."""
    C, R = CHUNK, ring_rows
    lo = max(0, a - w) & ~3
    hi = min(n, a + ln + w)
    H, total = a - lo, hi - lo
    nF, nS = -(-total // C), -(-ln // C)
    lag = -(-(H + w) // C) + 1
    ring = np.full(R, np.nan, F32)
    held = np.full(R, -1, np.int64)  # the position each ring place holds
    formed_at = np.full(total, 1 << 30)  # the step that formed each position
    own_rows, own_vals = [], []
    for name in form_reads:
        bufs.read(name, np.arange(lo, hi), block)
    for t in range(nS + lag):
        reads = np.zeros(R, bool)
        c = t - lag
        if 0 <= c < nS:
            rows = a + c * C + np.arange(C)
            rows = rows[rows < a + ln]
            acc = np.zeros(len(rows), F32)
            for d, off in enumerate(offsets):
                j = rows + off
                m = (j >= 0) & (j < n)
                pos = j[m] - lo
                assert (held[pos & (R - 1)] == pos).all(), "a read place holds another position"
                assert (formed_at[pos] < t).all(), "a read position is not formed yet"
                reads[pos & (R - 1)] = True
                acc[m] = acc[m] + D[d, rows[m]] * ring[pos & (R - 1)]
            own = rows - lo
            use(rows, acc, ring[own & (R - 1)])
        if t < nF:
            pos = t * C + np.arange(C)
            pos = pos[pos < total]
            assert not reads[pos & (R - 1)].any(), "a step writes a ring place it reads"
            vals = form_of(lo + pos)
            ring[pos & (R - 1)] = vals
            held[pos & (R - 1)] = pos
            formed_at[pos] = t
            own = (lo + pos >= a) & (lo + pos < a + ln)
            own_rows.append(lo + pos[own])
            own_vals.append(vals[own])
    return (np.concatenate(own_rows) if own_rows else np.zeros(0, np.int64),
            np.concatenate(own_vals) if own_vals else np.zeros(0, F32))


def ring_loop(diags, offsets, r0, x0, minv, *, tol_sq_eff, max_iters, use_implicit, blocks,
              ring_rows=None):
    """K12's ring route, pass by pass.  Returns what bicgstab_solve_reference
    does."""
    n = r0.shape[0]
    D = diags.to(torch.float32).numpy()
    plan = ring_plan(offsets, n, diags.element_size())
    w = plan.width
    R = plan.ring_rows if ring_rows is None else ring_rows
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32)
    mv = None if minv is None else minv.numpy()
    x, r, rr = x0.numpy().copy(), r0.numpy().copy(), r0.numpy().copy()
    pb = [np.zeros(n, F32), np.full(n, np.nan, F32)]
    vb = [np.zeros(n, F32), np.full(n, np.nan, F32)]
    t_vec = np.full(n, np.nan, F32)
    rho_new = _dots(r0, r0)
    one = torch.ones((), dtype=torch.float32)
    rho_old, alpha, omega = one, one, one
    mon = torch.full((), float("inf"), dtype=torch.float32)
    it = 0

    def f(v):
        return F32(v.item())

    while it < max_iters and not bool(mon <= tol):
        beta = f(_sdiv(rho_new * alpha, rho_old * omega))
        cur = it & 1
        p_old, v_old, p_new, v_new = pb[cur], vb[cur], pb[cur ^ 1], vb[cur ^ 1]
        p_new[:] = np.nan
        v_new[:] = np.nan
        om = f(omega)
        bufs = Buffers()
        for block, (a, ln) in enumerate(ranges(n, blocks)):
            def use_a(rows, acc, _, block=block):
                v_new[rows] = acc
                bufs.write(f"v{cur ^ 1}", rows, block)

            rows, vals = walk(D, offsets, n, w, R, a, ln,
                              lambda rw: r[rw] + beta * (p_old[rw] - om * v_old[rw]), use_a,
                              block, bufs, ("r", f"p{cur}", f"v{cur}"))
            p_new[rows] = vals
            bufs.write(f"p{cur ^ 1}", rows, block)
        bufs.check(n)
        alpha_new = _sdiv(rho_new, _dots(torch.from_numpy(rr), torch.from_numpy(v_new)))
        an = f(alpha_new)
        s_own = np.full(n, np.nan, F32)
        bufs = Buffers()
        for block, (a, ln) in enumerate(ranges(n, blocks)):
            def use_b(rows, acc, s_rows, block=block):
                t_vec[rows] = acc
                s_own[rows] = s_rows
                bufs.write("t", rows, block)

            walk(D, offsets, n, w, R, a, ln, lambda rw: r[rw] - an * v_new[rw], use_b, block,
                 bufs, ("r", f"v{cur ^ 1}"))
        bufs.check(n)
        st, tt = torch.from_numpy(s_own), torch.from_numpy(t_vec)
        half_done = (torch.abs(rho_new) if use_implicit else _dots(st, st)) <= tol
        omega_new = torch.where(half_done, 0.0, _sdiv(_dots(tt, st), _dots(tt, tt)))
        on = f(omega_new)
        # pass C on the own rows: s formed again from r and v
        s = r - an * v_new
        assert np.array_equal(s.view(np.uint32), s_own.view(np.uint32))
        y = p_new if mv is None else mv * p_new
        z = s if mv is None else mv * s
        x = x + an * y + on * z
        r = s - on * t_vec
        rt = torch.from_numpy(r)
        rho_next = _dots(torch.from_numpy(rr), rt)
        mon = torch.abs(rho_new) if use_implicit else _dots(rt, rt)
        rho_old, alpha = rho_new, alpha_new
        omega = torch.where(half_done, 1.0, omega_new)
        rho_new = rho_next
        it += 1
    return x, r, it, mon, bool(mon <= tol)


def same_bits(got, want):
    return np.array_equal(np.asarray(got, F32).view(np.uint32),
                          np.asarray(want, F32).view(np.uint32))


CASES = [
    # (label, grid, coefficients, jitter, blocks, storage, Jacobi, implicit, NaN, cap)
    ("w0_half_step", (1, 3000), (2.0, 0.0, 0.0), False, 3, "f32", False, False, False, 50),
    ("w1_odd_n", (3001, 1), (2.6, -1.3, -0.7), True, 3, "f32", False, False, False, 200),
    ("w1_bf16_jacobi", (3001, 1), (2.6, -1.3, -0.7), True, 5, "bf16", True, False, False, 200),
    ("w31_implicit", (31, 40), (4.5, -1.3, -0.7), True, 5, "f32", False, True, False, 200),
    ("w31_nan", (31, 40), (4.5, -1.3, -0.7), True, 4, "f32", False, False, True, 6),
    ("w2048", (2048, 3), (4.5, -1.3, -0.7), True, 2, "f32", True, False, False, 60),
    ("w2048_past_range", (2048, 3), (4.5, -1.3, -0.7), True, 40, "bf16", False, False, False, 60),
]


@pytest.mark.parametrize("label,grid,coeffs,jitter,blocks,storage,jacobi,implicit,nan,cap", CASES,
                         ids=[c[0] for c in CASES])
def test_ring_route_matches_plain_version(label, grid, coeffs, jitter, blocks, storage, jacobi,
                                          implicit, nan, cap):
    A = grid_operator(*grid, coeffs, jitter)
    if storage == "bf16":
        A = A.astype(torch.bfloat16)
    n = A.shape[0]
    rng = np.random.default_rng(n + blocks)
    b = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(F32))
    if nan:
        b[n // 2] = float("nan")
    minv = torch.from_numpy(rng.uniform(0.15, 0.3, n).astype(F32)) if jacobi else None
    diags = A.diags if minv is None else fold_minv(A, minv)
    tol = F32((1e-6 * float(b.norm())) ** 2)
    kw = dict(tol_sq_eff=tol, max_iters=cap, use_implicit=implicit)
    z = torch.zeros(n)
    plan = ring_plan(A.offsets, n, A.diags.element_size())
    assert plan.width == {"w0": 0, "w1": 1, "w31": 31, "w2048": 2048}[label.split("_")[0]]
    x, r, it, mon, conv = ring_loop(diags, A.offsets, b, z, minv, blocks=blocks, **kw)
    wx, wr, wit, wmon, wconv = bicgstab_solve_reference(diags, A.offsets, b, z, minv, **kw)
    assert it == int(wit) and conv == bool(wconv)
    assert same_bits(float(mon), float(wmon))
    assert same_bits(x, wx.numpy()) and same_bits(r, wr.numpy())
    if label == "w0_half_step":
        assert it == 1 and conv  # s = 0 in the first half step: omega = 0
    if nan:
        assert it == cap and not conv and np.isnan(float(mon))


def test_ring_plan_routes_by_offsets():
    """The ring is a power of two >= 2 w + 3 C rows; with its stages it must
    fit a block's shared memory, else the five-pass kernel runs: path 4's
    2048^2 operators take the ring, path 2's 160^3 Poisson (w = 25,600) and
    a 64-diagonal band the five-pass kernel.  The Python plan follows the
    kernel's constants."""
    assert CHUNK == ops_bicgstab.RING_CHUNK
    assert _define("GK_BCG_PREFETCH") + 1 == ops_bicgstab.RING_STAGES
    assert _define("GK_BCG_MAX_RING") == ops_bicgstab.RING_MAX_ROWS
    a2 = ring_plan([-2048, -1, 0, 1, 2048], 2048 * 2048)
    assert (a2.width, a2.ring_rows, a2.chunk) == (2048, 8192, CHUNK)
    assert a2.ring_rows >= 2 * a2.width + 3 * a2.chunk
    assert a2.smem == ring_smem(8192, 5, 4) == 143600
    assert ring_plan([-1, 0, 1], 10).ring_rows == 4096
    assert ring_plan([0], 10).width == 0
    assert ring_plan([-25600, -160, -1, 0, 1, 160, 25600], 160 ** 3) is None
    assert ring_plan(list(range(-32, 32)), 10 ** 5) is None
    edge = [-6656, -1, 0, 1, 6656]
    assert ring_plan(edge, 10 ** 6).ring_rows == 16384
    assert ring_plan([-6657, -1, 0, 1, 6657], 10 ** 6) is None
    assert ring_plan(edge, 2 ** 30 - 16384) is None  # positions must fit an int


def test_model_catches_a_short_ring():
    """The loop's own checks: a ring shorter than 2 w + 3 C positions lets a
    step overwrite a position that it or a later step still reads."""
    A = grid_operator(2048, 3, (4.5, -1.3, -0.7))
    n = A.shape[0]
    b = torch.ones(n)
    with pytest.raises(AssertionError, match="ring place|another position"):
        ring_loop(A.diags, A.offsets, b, torch.zeros(n), None, tol_sq_eff=F32(0.0), max_iters=1,
                  use_implicit=False, blocks=2, ring_rows=4096)


# -- K12m: the three passes at k columns ------------------------------------------------


def multi_loop(diags, offsets, R0, X0, minv, *, tol_sq_eff, max_iters, use_implicit):
    """K12m (``bicgstab_fused_multi_kernel``), pass by pass: each row of k
    columns gathers its neighbours and forms p_new (pass A) or s (pass B)
    at each from vectors that no row writes in that pass; p and v in two
    buffers, the new ones NaN until written; a stopped column selects
    p_old and v_old.  Returns what bicgstab_solve_multi_reference does."""
    n, k = R0.shape
    D = diags.to(torch.float32).numpy()
    tol = np.broadcast_to(np.asarray(tol_sq_eff, F32).reshape(-1), (k,)).astype(F32)
    mv = None if minv is None else minv.numpy()[:, None]
    x, r, rr = X0.numpy().copy(), R0.numpy().copy(), R0.numpy().copy()
    pb = [np.zeros((n, k), F32), np.full((n, k), np.nan, F32)]
    vb = [np.zeros((n, k), F32), np.full((n, k), np.nan, F32)]

    def dots(a, b):
        return _dots(torch.from_numpy(a), torch.from_numpy(b)).numpy()

    def sdiv(a, b):
        return _sdiv(torch.from_numpy(a), torch.from_numpy(b)).numpy()

    def gathered_product(form, written):
        """Row i: sum over the diagonals in offset order, from +0.0, of
        D[d, i] times the row i + off formed by ``form`` (columns outside
        [0, n) skipped); ``written`` are the buffers the pass writes, which
        ``form`` must not read."""
        acc = np.zeros((n, k), F32)
        for d, off in enumerate(offsets):
            i = np.arange(n)
            j = i + off
            m = (j >= 0) & (j < n)
            acc[i[m]] = acc[i[m]] + D[d, i[m], None] * form(j[m], written)
        return acc

    rho_new = dots(r, r)
    rho_old = alpha = omega = np.ones(k, F32)
    act = np.ones(k, bool)
    itc = np.zeros(k, np.int32)
    mon = np.full(k, np.inf, F32)
    it = 0
    while it < max_iters and act.any():
        beta = sdiv(rho_new * alpha, rho_old * omega)
        cur = it & 1
        p_old, v_old, p_new, v_new = pb[cur], vb[cur], pb[cur ^ 1], vb[cur ^ 1]
        p_new[:] = np.nan
        v_new[:] = np.nan

        def form_p(j, written):
            assert not any(buf is p_old or buf is v_old or buf is r for buf in written)
            return np.where(act, r[j] + beta * (p_old[j] - omega * v_old[j]), p_old[j])

        av = gathered_product(form_p, (p_new, v_new))
        p_new[:] = form_p(np.arange(n), (p_new, v_new))
        v_new[:] = np.where(act, av, v_old)
        alpha_new = np.where(act, sdiv(rho_new, dots(rr, v_new)), alpha)
        alpha_eff = np.where(act, alpha_new, F32(0))

        def form_s(j, written):
            assert not any(buf is r or buf is v_new for buf in written)
            return r[j] - alpha_eff * v_new[j]

        t = gathered_product(form_s, ())
        s = form_s(np.arange(n), ())
        half = act & ((np.abs(rho_new) if use_implicit else dots(s, s)) <= tol)
        omega_eff = np.where(act & ~half, sdiv(dots(t, s), dots(t, t)), F32(0))
        # pass C: s formed again from r and v on the own rows
        y = p_new if mv is None else mv * p_new
        z = s if mv is None else mv * s
        x = np.where(act, x + alpha_eff * y + omega_eff * z, x)
        r = np.where(act, s - omega_eff * t, r)
        rho_next = dots(rr, r)
        mon = np.abs(rho_new) if use_implicit else dots(r, r)
        itc = np.where(act, it + 1, itc).astype(np.int32)
        omega = np.where(act, np.where(half, F32(1), omega_eff), omega)
        rho_old, alpha = rho_new, alpha_new
        rho_new = np.where(act, rho_next, rho_new)
        act = act & ~(mon <= tol)
        it += 1
    return x, r, it, mon, mon <= tol, itc


MULTI_CASES = [
    # (label, grid, coefficients, k, storage, Jacobi, implicit, cap)
    ("k2_w1", (1500, 1), (2.6, -1.3, -0.7), 2, "f32", False, False, 80),
    ("k4_w31", (31, 40), (4.5, -1.3, -0.7), 4, "f32", True, False, 80),
    ("k4_w31_bf16_implicit", (31, 40), (4.5, -1.3, -0.7), 4, "bf16", False, True, 80),
    ("k8_w64", (64, 20), (4.5, -1.3, -0.7), 8, "f32", False, False, 60),
]


@pytest.mark.parametrize("label,grid,coeffs,k,storage,jacobi,implicit,cap", MULTI_CASES,
                         ids=[c[0] for c in MULTI_CASES])
def test_multi_schedule_matches_plain_version(label, grid, coeffs, k, storage, jacobi, implicit,
                                              cap):
    """K12m's three-pass order equals ``bicgstab_solve_multi_reference`` bit
    for bit: x, r, the iteration count, each column's monitor and stop
    iteration.  Column 0 stops early (a loose threshold), column 1 carries
    a NaN and runs to the cap, so the other columns stay frozen from their
    stops for the rest of the run."""
    A = grid_operator(*grid, coeffs)
    if storage == "bf16":
        A = A.astype(torch.bfloat16)
    n = A.shape[0]
    rng = np.random.default_rng(n + k)
    B = torch.from_numpy(rng.uniform(0.5, 1.5, (n, k)).astype(F32))
    B[n // 3, 1] = float("nan")
    minv = torch.from_numpy(rng.uniform(0.15, 0.3, n).astype(F32)) if jacobi else None
    diags = A.diags if minv is None else fold_minv(A, minv)
    tol = ((1e-6 * B.double().norm(dim=0)) ** 2).float()
    tol[0] = float(B[:, 0].norm()) ** 2 * 1e-2
    kw = dict(tol_sq_eff=tol, max_iters=cap, use_implicit=implicit)
    Z = torch.zeros(n, k)
    x, r, it, mon, conv, itc = multi_loop(diags, A.offsets, B, Z, minv, **kw)
    wx, wr, wit, wmon, wconv, witc = ops_bicgstab.bicgstab_solve_multi_reference(
        diags, A.offsets, B, Z, minv, **kw)
    assert it == int(wit) == cap
    assert np.array_equal(itc, witc.numpy()) and np.array_equal(conv, wconv.numpy())
    assert same_bits(mon, wmon.numpy())
    assert same_bits(x, wx.numpy()) and same_bits(r, wr.numpy())
    assert itc[0] < cap and itc[1] == cap and not conv[1]
    rest = [c for c in range(k) if c != 1]
    assert conv[rest].all() and itc[0] < itc[rest[1:]].min(initial=cap)
