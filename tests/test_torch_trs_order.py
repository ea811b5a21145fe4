"""The schedule of the pipelined sweep solve (K22 ``trs_fused`` and K23
``cg_ilu_fused`` on their walk route), held on the CPU against the plain
versions their CUDA kernels are checked against.

A sweep solve x ~ T^{-1} rhs is x0 = invd rhs, then ``sweeps`` times
x <- invd (rhs - N x).  On the walk route (``csrc/tri_walk.cuh``) each block
owns a contiguous range of rows and walks it with a halo of sweeps * w rows
before it (w = max |offset|): forward for a lower triangle, backward for an
upper one, C rows a step, level k of the solve on the chunk k steps behind
level 0, levels 0 .. sweeps-1 kept in rings of ``ring_rows`` rows and the
input in a ring of ``stages`` chunks (``gk_walk_plan``).  K23
fuses r_new = r - alpha q into the L walk, which forms r_new on its halo
rows from r and q itself (r alternates between two buffers), then runs the
U walk, and x += alpha p joins p = z + beta p.

An independent numpy loop of that schedule, float32 throughout, must equal
``ops/trs.trs_reference`` and ``ops/cg_ilu.cg_ilu_reference`` bit for bit,
on triangles of the JAX package's ParIc/ParIlu carried across by
``interop``: x, and for K23 also r, the iteration count and the monitor.
The loop also asserts what the kernel relies on: a chunk is still in its
stage of the input ring when a level reads it, no ring position a step
reads is written in the same step, and every row is written by exactly one
block.  Cases: sweeps 0, 1, 3 and 8; w = 1, 31, 2047 and 2048, and w
larger than a block's range; n not a multiple of C, and odd; a -0.0 and a
NaN in rhs; float32 and bfloat16 triangles.  The dot products are float64 sums rounded to
float32, summed as the plain version sums them: the kernel's float64 order
differs and is not under test here.
"""

import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import pytest
import torch

from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.matrix.dia import Dia as JDia
from ginkgo_tpu.preconditioner.ilu import Ic as JIc, Ilu as JIlu
from ginkgo_tpu.solver.triangular import LowerTrs as JLowerTrs, UpperTrs as JUpperTrs
import ginkgo_tpu_torch
from ginkgo_tpu_torch import interop
from ginkgo_tpu_torch.ops.cg_ilu import _dot, bicgstab_ilu_reference, cg_ilu_reference
from ginkgo_tpu_torch.ops.cg import _sdiv
from ginkgo_tpu_torch.ops.dia import dia_spmv_reference
from ginkgo_tpu_torch.ops.trs import trs_reference

F32 = np.float32

_HEADER = (Path(ginkgo_tpu_torch.__file__).parent / "csrc" / "tri_walk.cuh").read_text()
#: rows a walk step takes, and chunks in flight ahead of the step that
#: reads them: the kernel's own constants
CHUNK = int(re.search(r"#define GK_WALK_CHUNK (\d+)", _HEADER).group(1))
PREFETCH = int(re.search(r"#define GK_WALK_PREFETCH (\d+)", _HEADER).group(1))


@dataclass(frozen=True)
class Plan:
    """One walk's shape, as ``gk_walk_plan`` derives it."""

    chunk: int
    ring_rows: int
    stages: int
    direction: int  # +1: every offset < 0, an increasing walk; -1: every offset > 0
    width: int

    def smem(self, sweeps, nd, diag_size, vectors):
        """Shared memory of the walk (``gk_walk_smem``): the level rings,
        then the input ring of nd diagonals, ``vectors`` vectors and invd."""
        diag_bytes = (self.chunk * diag_size + 4 + 15) & ~15
        slot = nd * diag_bytes + (vectors + 1) * self.chunk * 4
        return sweeps * self.ring_rows * 4 + self.stages * slot


def walk_plan(offsets, sweeps):
    """The walk of a ``sweeps``-sweep solve over a strict triangle with
    these offsets, or None where they are not all of one sign: the level
    rings a power of two >= w + 2C rows, so that the rows a step reads
    (w + C) and the chunk it writes never share a place."""
    offs = [int(o) for o in offsets]
    if not offs or not (all(o < 0 for o in offs) or all(o > 0 for o in offs)):
        return None
    width = max(abs(o) for o in offs)
    ring = 0 if sweeps == 0 else 1 << (width + 2 * CHUNK - 1).bit_length()
    return Plan(CHUNK, ring, sweeps + 1 + PREFETCH, 1 if offs[0] < 0 else -1, width)


@pytest.fixture(autouse=True)
def _one_thread():
    """The loops run many small tensor ops: one intra-op thread each, so
    that they do not spin against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def grid_laplacian(nx, ny):
    """The 5-point Laplacian of an nx x ny grid (offsets +-1 and +-nx; a
    line when ny is 1), as COO parts."""
    n = nx * ny
    i = np.arange(n)
    rows, cols, vals = [i], [i], [np.full(n, 4.0 if ny > 1 else 2.0)]
    for off, ok in ((1, i % nx < nx - 1), (-1, i % nx > 0), (nx, i < n - nx), (-nx, i >= nx)):
        if ny > 1 or abs(off) == 1:
            rows.append(i[ok])
            cols.append(i[ok] + off)
            vals.append(np.full(int(ok.sum()), -1.0))
    return (n, n), np.concatenate(rows), np.concatenate(cols), np.concatenate(vals).astype(F32)


_FACTORS = {}


def factors(grid, kind):
    """(A, Tl, Tu, invdl, invdu) of the port, carried from the JAX package's
    ParIc ("ic") or ParIlu ("ilu") of the grid's Laplacian."""
    key = (grid, kind)
    if key not in _FACTORS:
        JA = JDia.from_matrix_data(JMatrixData.from_coo(*grid_laplacian(*grid)))
        lf = JLowerTrs.build(algorithm="sweeps", sweeps=1)
        fac = (JIc.build(l_solver_factory=lf) if kind == "ic" else JIlu.build(
            l_solver_factory=lf, u_solver_factory=JUpperTrs.build(algorithm="sweeps", sweeps=1)))
        M = fac.generate(JA.to_csr())
        port = [interop.dia_from_arrays(np.asarray(J.diags), J.offsets, J.shape, device="cpu")
                for J in (JA, M.l_solver.off_csr, M.u_solver.off_csr)]
        invd = [torch.from_numpy(np.asarray(1.0 / np.asarray(t.diag, np.float64), F32))
                for t in (M.l_solver, M.u_solver)]
        _FACTORS[key] = (*port, *invd)
    return _FACTORS[key]


def walk(T, invd, rhs_of, sweeps, a, ln, plan, own0=None):
    """The kernel's walk over the block rows [a, a+ln) of the triangle T
    (``gk_tri_walk``).  rhs_of(rows) gives the right-hand side of rows;
    own0(rows, rhs) sees each own row's right-hand side once.  Returns the
    own rows and their last level."""
    n = T.shape[0]
    D = T.diags.to(torch.float32).numpy()
    inv = invd.numpy()
    C, R, S, w = plan.chunk, plan.ring_rows, sweeps, plan.width
    if plan.direction > 0:
        s0 = max(0, a - S * w) & ~3
        H, row0, pbeg = a - s0, s0, 0
    else:
        e0 = (min(n, a + ln + S * w) + 3) & ~3
        H, row0, pbeg = e0 - (a + ln), e0 - 1, e0 - n
    total = H + ln
    nc = -(-total // C)
    aoff = [-o if plan.direction > 0 else o for o in T.offsets]
    rings = [np.full(R, np.nan, F32) for _ in range(S)]
    owner = [-1] * plan.stages  # the chunk each stage of the input ring holds
    for c in range(min(PREFETCH, nc)):
        owner[c % plan.stages] = c
    rows_out, vals_out = [], []
    for t in range(nc + S):
        if t + PREFETCH < nc:
            owner[(t + PREFETCH) % plan.stages] = t + PREFETCH
        writes, reads = [], [set() for _ in range(S)]
        for k in range(S + 1):
            c = t - k
            if c < 0 or c >= nc or (c + 1) * C <= H - (S - k) * w:
                continue
            assert owner[c % plan.stages] == c, "a level reads a chunk whose stage was reused"
            p = c * C + np.arange(C)
            p = p[(p < total) & (p >= pbeg)]
            row = row0 + p if plan.direction > 0 else row0 - p
            b = rhs_of(row)
            if k == 0:
                v = b * inv[row]
            else:
                acc = np.zeros(len(p), F32)
                for d, ad in enumerate(aoff):
                    pj = p - ad
                    m = pj >= pbeg
                    acc[m] = acc[m] + D[d, row[m]] * rings[k - 1][pj[m] & (R - 1)]
                    reads[k - 1].update((pj[m] & (R - 1)).tolist())
                v = (b - acc) * inv[row]
            own = p >= H
            if k == 0 and own0 is not None:
                own0(row[own], b[own])
            if k < S:
                writes.append((k, p & (R - 1), v))
            else:
                rows_out.append(row[own])
                vals_out.append(v[own])
        for k, idx, v in writes:
            assert not reads[k] & set(idx.tolist()), "a step writes a ring place it reads"
            rings[k][idx] = v
    return np.concatenate(rows_out), np.concatenate(vals_out)


def ranges(n, blocks):
    """The kernels' block ranges: block b owns [b T, b T + T), T = ceil(n / blocks)."""
    T = -(-n // blocks)
    return [(a, min(T, n - a)) for a in range(0, n, T)]


def walk_solve(T, invd, rhs_of, sweeps, plan, blocks, own0=None):
    """Every block's walk; each row written by exactly one block."""
    n = T.shape[0]
    x = np.full(n, np.nan, F32)
    seen = np.zeros(n, np.int64)
    for a, ln in ranges(n, blocks):
        rows, vals = walk(T, invd, rhs_of, sweeps, a, ln, plan, own0)
        x[rows] = vals
        np.add.at(seen, rows, 1)
    assert (seen == 1).all()
    return x


def same_bits(got, want):
    return np.array_equal(np.asarray(got, F32).view(np.uint32),
                          np.asarray(want, F32).view(np.uint32))


def rhs_vector(n, special, seed=3):
    b = np.random.default_rng(seed).uniform(0.5, 1.5, n).astype(F32)
    if special:
        b[5] = -0.0
        b[n // 2] = np.nan
    return b


TRS_CASES = [
    # (grid, kind, triangle, sweeps, blocks, storage, special rhs)
    ((999, 1), "ic", "l", 3, 7, "f32", False),  # w = 1, n not a multiple of C
    ((3001, 1), "ic", "u", 8, 1, "f32", True),  # one range of several chunks
    ((31, 40), "ilu", "l", 0, 5, "f32", True),  # w = 31
    ((31, 40), "ilu", "u", 1, 9, "bf16", False),
    ((31, 40), "ic", "l", 8, 40, "f32", False),  # ranges of 31 rows, a halo of 248
    ((2048, 3), "ic", "l", 3, 4, "f32", False),  # w = 2048: ring wrap
    ((2047, 5), "ilu", "u", 3, 6, "bf16", True),  # odd n: a bfloat16 chunk mid-word
    ((2048, 3), "ilu", "l", 1, 48, "f32", False),  # w larger than a range (128 rows)
    ((2048, 3), "ic", "u", 8, 2, "f32", False),
]


@pytest.mark.parametrize("grid,kind,tri,sweeps,blocks,storage,special", TRS_CASES)
def test_trs_walk_matches_plain_version(grid, kind, tri, sweeps, blocks, storage, special):
    A, Tl, Tu, invdl, invdu = factors(grid, kind)
    T, invd = (Tl, invdl) if tri == "l" else (Tu, invdu)
    if storage == "bf16":
        T = T.astype(torch.bfloat16)
    n = T.shape[0]
    plan = walk_plan(T.offsets, sweeps)
    assert plan.direction == (1 if tri == "l" else -1)
    assert plan.width == (1 if grid[1] == 1 else grid[0])
    b = rhs_vector(n, special)
    x = walk_solve(T, invd, lambda rows: b[rows], sweeps, plan, blocks)
    want = trs_reference(T, invd, torch.from_numpy(b), sweeps=sweeps).numpy()
    assert same_bits(x, want)


def test_walk_plan_routes_by_shape():
    """A triangle whose offsets change sign has no walk; the rings are as
    large as the walk reads; a wide triangle's rings outgrow a block's
    shared memory (path 7's 160^3 IC: the barrier route)."""
    assert walk_plan([-1, 1], 3) is None
    assert walk_plan([], 3) is None
    p = walk_plan([-2048, -1], 3)
    assert (p.direction, p.width, p.chunk, p.ring_rows, p.stages) == (1, 2048, 1024, 4096, 6)
    assert p.ring_rows >= p.width + 2 * p.chunk
    assert p.smem(3, 2, 4, 1) == 147648  # K22 at path 7's shape, as the card reports it
    assert walk_plan([1, 2048], 0).ring_rows == 0
    wide = walk_plan([1, 160, 25600], 3)
    assert wide.smem(3, 3, 4, 2) > 232448  # the H100's 227 KB a block


def test_model_catches_a_short_ring():
    """The loop's own checks: a level ring shorter than w + 2C rows lets a
    step write a place it reads."""
    _, Tl, _, invdl, _ = factors((31, 40), "ic")
    plan = walk_plan(Tl.offsets, 3)
    short = Plan(plan.chunk, 512, plan.stages, plan.direction, plan.width)
    b = rhs_vector(Tl.shape[0], False)
    with pytest.raises(AssertionError, match="ring place"):
        walk_solve(Tl, invdl, lambda rows: b[rows], 3, short, 1)


def cg_ilu_walk(A, Tl, Tu, invdl, invdu, r0, x0, *, sweeps_l, sweeps_u, tol_sq_eff, max_iters,
                use_implicit, blocks):
    """K23's pass order on the walk route.  Returns what cg_ilu_reference
    does."""
    n = A.shape[0]
    pl = walk_plan(Tl.offsets, sweeps_l)
    pu = walk_plan(Tu.offsets, sweeps_u)
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32)
    r0n = r0.numpy()
    x = x0.numpy().copy()
    rbuf = [r0n.copy(), np.full(n, np.nan, F32)]

    def m_apply(rhs_of, own0=None):
        mid = walk_solve(Tl, invdl, rhs_of, sweeps_l, pl, blocks, own0)
        return walk_solve(Tu, invdu, lambda rows: mid[rows], sweeps_u, pu, blocks)

    z = m_apply(lambda rows: r0n[rows])
    p = z.copy()
    rho = _dot(r0, torch.from_numpy(z))
    mon = torch.full((), float("inf"), dtype=torch.float32)
    it = 0
    while it < max_iters and not bool(mon <= tol):
        pt = torch.from_numpy(p)
        q = dia_spmv_reference(A.diags, A.offsets, pt, n).numpy()
        alpha = _sdiv(rho, _dot(pt, torch.from_numpy(q)))
        af = F32(alpha.item())
        r_old, r_new = rbuf[it & 1], rbuf[(it + 1) & 1]
        r_new[:] = np.nan

        def keep(rows, vals, r_new=r_new):
            r_new[rows] = vals

        # the L walk forms r - alpha q itself on every row it reads
        z = m_apply(lambda rows, r_old=r_old, q=q: r_old[rows] - af * q[rows], keep)
        rt = torch.from_numpy(r_new.copy())
        rr_new = _dot(rt, rt)
        rho_new = _dot(rt, torch.from_numpy(z))
        beta = _sdiv(rho_new, rho)
        x = x + af * p  # the p pass: x += alpha p, then p = z + beta p
        p = z + F32(beta.item()) * p
        mon = torch.abs(rho) if use_implicit else rr_new
        rho = rho_new
        it += 1
    return x, rbuf[it & 1], it, mon, bool(mon <= tol)


CG_CASES = [
    # (grid, kind, sweeps_l, sweeps_u, blocks, storage, implicit, cap)
    ((31, 40), "ic", 3, 3, 6, "f32", False, 300),
    ((31, 40), "ilu", 1, 0, 13, "bf16", False, 300),
    ((31, 40), "ilu", 8, 3, 3, "f32", True, 300),
    ((999, 1), "ic", 0, 1, 5, "f32", False, 40),
    ((2048, 3), "ic", 3, 3, 5, "f32", False, 6),
    ((2048, 3), "ilu", 3, 1, 40, "bf16", False, 4),
]


@pytest.mark.parametrize("grid,kind,sweeps_l,sweeps_u,blocks,storage,implicit,cap", CG_CASES)
def test_cg_ilu_walk_matches_plain_version(grid, kind, sweeps_l, sweeps_u, blocks, storage,
                                           implicit, cap):
    A, Tl, Tu, invdl, invdu = factors(grid, kind)
    if storage == "bf16":
        A, Tl, Tu = (M.astype(torch.bfloat16) for M in (A, Tl, Tu))
    n = A.shape[0]
    b = torch.from_numpy(rhs_vector(n, False, seed=11))
    tol = F32((1e-6 * float(b.norm())) ** 2)
    kw = dict(sweeps_l=sweeps_l, sweeps_u=sweeps_u, tol_sq_eff=tol, max_iters=cap,
              use_implicit=implicit)
    x, r, it, mon, conv = cg_ilu_walk(A, Tl, Tu, invdl, invdu, b, torch.zeros(n),
                                      blocks=blocks, **kw)
    wx, wr, wit, wmon, wconv = cg_ilu_reference(A, Tl, Tu, invdl, invdu, b, torch.zeros(n), **kw)
    assert it == int(wit) and conv == bool(wconv)
    assert same_bits(float(mon), float(wmon))
    assert same_bits(x, wx.numpy()) and same_bits(r, wr.numpy())


def test_cg_ilu_walk_nan_runs_to_the_cap():
    """A NaN in b reaches the monitor of both orders, which then run to the
    cap (the stop test is written !(mon <= tol))."""
    A, Tl, Tu, invdl, invdu = factors((31, 40), "ilu")
    n = A.shape[0]
    b = torch.from_numpy(rhs_vector(n, True, seed=11))
    kw = dict(sweeps_l=3, sweeps_u=3, tol_sq_eff=F32(1e-6), max_iters=7, use_implicit=False)
    x, r, it, mon, conv = cg_ilu_walk(A, Tl, Tu, invdl, invdu, b, torch.zeros(n), blocks=4,
                                      **kw)
    wx, wr, wit, wmon, wconv = cg_ilu_reference(A, Tl, Tu, invdl, invdu, b, torch.zeros(n), **kw)
    assert it == int(wit) == 7 and not conv and not bool(wconv)
    assert np.isnan(float(mon)) and np.isnan(float(wmon))
    assert np.array_equal(np.isnan(x), np.isnan(wx.numpy()))


# -- K24 on the walk ------------------------------------------------------------------

_SOURCE = (Path(ginkgo_tpu_torch.__file__).parent / "csrc" / "trs_fused.cu").read_text()
#: shared memory a block may opt in to on the H100 (227 KB), less the static
#: shared memory of K24's walk kernel (its block folds: 6 x 32 doubles and 6
#: broadcasts)
SMEM_LIMIT = 232448 - (6 * 32 + 6) * 8


def bicgstab_ilu_route(Tl, Tu, sweeps_l, sweeps_u, tri_size=4):
    """K24's route as ``csrc/trs_fused.cu`` ``bicgstab_ilu_plan`` chooses it:
    the walks where both sides sweep at least once, L's offsets are all
    negative and U's all positive and step 1's walk, which stages r, p_old
    and v, fits a block ("pipelined"); where only the form with p in a pass
    of its own fits, whose largest walk is step 4's staging r and v
    ("pipelined_p_pass"); else "barrier"."""
    pl, pu = walk_plan(Tl.offsets, sweeps_l), walk_plan(Tu.offsets, sweeps_u)
    if (sweeps_l < 1 or sweeps_u < 1 or pl is None or pu is None or pl.direction != 1
            or pu.direction != -1):
        return "barrier", 0
    su = pu.smem(sweeps_u, len(Tu.offsets), tri_size, 1)
    for route, nv in (("pipelined", 3), ("pipelined_p_pass", 2)):
        smem = max(pl.smem(sweeps_l, len(Tl.offsets), tri_size, nv), su)
        if smem <= SMEM_LIMIT:
            return route, smem
    return "barrier", 0


def test_bicgstab_ilu_route_by_shape():
    """The plan's rules as the source states them; path 7's A2 (w = 2048,
    3 sweeps) takes the walk at 196,800 B a block; 0 sweeps on either side,
    offsets of both signs and rings past a block take the barrier routine;
    a shape that K23's walk fits and step 1's three vectors do not takes
    the walk with p in a pass of its own."""
    walks = _SOURCE[_SOURCE.index("static bool bicgstab_ilu_walks("):]
    walks = walks[:walks.index("\n}\n")]
    assert "sweeps_l < 1 || sweeps_u < 1" in walks and "psplit ? 2 : 3" in walks
    assert "wl->dir != 1 || wu->dir != -1" in walks

    class Tri:
        def __init__(self, offsets):
            self.offsets = offsets

    L, U = Tri([-2048, -1]), Tri([1, 2048])
    assert bicgstab_ilu_route(L, U, 3, 3) == ("pipelined", 196800)
    assert bicgstab_ilu_route(L, U, 3, 3, 2)[0] == "pipelined"
    assert bicgstab_ilu_route(L, U, 0, 3)[0] == "barrier"
    assert bicgstab_ilu_route(L, U, 3, 0)[0] == "barrier"
    assert bicgstab_ilu_route(L, U, 8, 8)[0] == "barrier"  # 8 sweeps: 11 stages, 8 rings
    assert bicgstab_ilu_route(Tri([-1, 1]), U, 3, 3)[0] == "barrier"
    assert bicgstab_ilu_route(U, L, 3, 3)[0] == "barrier"
    wide_l, wide_u = Tri([-3000, -1]), Tri([1, 3000])
    assert bicgstab_ilu_route(wide_l, wide_u, 3, 3) == ("pipelined_p_pass", 221376)
    assert bicgstab_ilu_route(wide_l, wide_u, 3, 3, 2)[0] == "pipelined"  # bfloat16
    # K23's walks, whose L walk stages r and q, fit the same shape
    assert walk_plan(wide_l.offsets, 3).smem(3, 2, 4, 2) <= SMEM_LIMIT
    assert bicgstab_ilu_route(Tri([-40000, -1]), Tri([1, 40000]), 3, 3)[0] == "barrier"


def bicgstab_ilu_walk(A, Tl, Tu, invdl, invdu, r0, x0, *, sweeps_l, sweeps_u, tol_sq_eff,
                      max_iters, use_implicit, blocks, p_pass=False):
    """K24's pass order on the walk route, seven barriers an iteration (eight
    with ``p_pass``: p_new formed in a pass of its own before an L walk that
    stages it alone).  Returns what bicgstab_ilu_reference does and the
    iterations whose half step converged."""
    n = A.shape[0]
    pl, pu = walk_plan(Tl.offsets, sweeps_l), walk_plan(Tu.offsets, sweeps_u)
    assert sweeps_l >= 1 and sweeps_u >= 1 and pl.direction == 1 and pu.direction == -1
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32)
    t_ = torch.from_numpy
    one = torch.ones((), dtype=torch.float32)
    x, r = x0.numpy().copy(), r0.numpy().copy()
    rr = r.copy()
    v = np.zeros(n, F32)
    pbuf = [np.zeros(n, F32), np.full(n, np.nan, F32)]
    rho_new = _dot(r0, r0)
    rho_old, alpha, omega = one, one, one
    mon = torch.full((), float("inf"), dtype=torch.float32)
    it, halves = 0, []

    def product(src):
        return dia_spmv_reference(A.diags, A.offsets, t_(src), n).numpy()

    def own(dst):
        def keep(rows, vals):
            dst[rows] = vals
        return keep

    while it < max_iters and not bool(mon <= tol):
        beta = _sdiv(rho_new * alpha, rho_old * omega)
        bf, of = F32(beta.item()), F32(omega.item())
        p_old, p_new = pbuf[it & 1], pbuf[(it + 1) & 1]
        p_new[:] = np.nan
        # 1: the L walk on p_new = r + beta (p_old - omega v), formed on
        # every row it reads (or in a pass of its own), mid = L^-1 p_new
        if p_pass:
            p_new[:] = r + bf * (p_old - of * v)
            mid = walk_solve(Tl, invdl, lambda rows, p=p_new: p[rows], sweeps_l, pl, blocks)
        else:
            def rhs(rows, p=p_old, r=r, v=v):
                return r[rows] + bf * (p[rows] - of * v[rows])

            mid = walk_solve(Tl, invdl, rhs, sweeps_l, pl, blocks, own(p_new))
            assert not np.isnan(p_new).any() or np.isnan(r).any()
        # 2: y = U^-1 mid; 3: v = A y, alpha
        y = walk_solve(Tu, invdu, lambda rows, m=mid: m[rows], sweeps_u, pu, blocks)
        v = product(y)
        alpha_new = _sdiv(rho_new, _dot(t_(rr), t_(v)))
        af = F32(alpha_new.item())
        # 4: the L walk on s = r - alpha v, mid = L^-1 s; 5: z = U^-1 mid
        s = np.full(n, np.nan, F32)
        mid = walk_solve(Tl, invdl, lambda rows, r=r, v=v: r[rows] - af * v[rows], sweeps_l, pl,
                         blocks, own(s))
        z = walk_solve(Tu, invdu, lambda rows, m=mid: m[rows], sweeps_u, pu, blocks)
        # 6: t = A z, omega (0 where the half step converged, carried as 1)
        t = product(z)
        st, tt = t_(s), t_(t)
        half_done = bool((torch.abs(rho_new) if use_implicit else _dot(st, st)) <= tol)
        omega_new = (torch.zeros((), dtype=torch.float32) if half_done
                     else _sdiv(_dot(tt, st), _dot(tt, tt)))
        wf = F32(omega_new.item())
        # 7: x = (x + alpha y) + omega z; r = s - omega t
        x = (x + af * y) + wf * z
        r = s - wf * t
        rt = t_(r)
        rho_next = _dot(t_(rr), rt)
        mon = torch.abs(rho_new) if use_implicit else _dot(rt, rt)
        rho_old, alpha = rho_new, alpha_new
        omega = one if half_done else omega_new
        rho_new = rho_next
        halves += [it] if half_done else []
        it += 1
    return x, r, it, mon, bool(mon <= tol), halves


BICGSTAB_CASES = [
    # (grid, sweeps_l, sweeps_u, blocks, storage, implicit, cap, p in a pass of its own)
    ((31, 40), 3, 3, 6, "f32", False, 300, False),  # w = 31
    ((31, 40), 1, 8, 13, "bf16", False, 300, False),
    ((31, 40), 8, 3, 3, "f32", True, 300, False),
    ((31, 40), 3, 3, 4, "f32", False, 300, True),
    ((999, 1), 1, 1, 5, "f32", False, 5, False),  # w = 1
    ((2048, 3), 3, 3, 5, "f32", False, 4, False),  # w = 2048: ring wrap
    ((2048, 3), 3, 1, 48, "bf16", False, 3, False),  # w larger than a range (128 rows)
    ((2047, 5), 3, 3, 6, "bf16", False, 3, False),  # odd n: a bfloat16 chunk mid-word
]


@pytest.mark.parametrize("grid,sweeps_l,sweeps_u,blocks,storage,implicit,cap,p_pass",
                         BICGSTAB_CASES)
def test_bicgstab_ilu_walk_matches_plain_version(grid, sweeps_l, sweeps_u, blocks, storage,
                                                 implicit, cap, p_pass):
    A, Tl, Tu, invdl, invdu = factors(grid, "ilu")
    if storage == "bf16":
        A, Tl, Tu = (M.astype(torch.bfloat16) for M in (A, Tl, Tu))
    n = A.shape[0]
    b = torch.from_numpy(rhs_vector(n, False, seed=13))
    tol = F32((1e-6 * float(b.norm())) ** 2)
    kw = dict(sweeps_l=sweeps_l, sweeps_u=sweeps_u, tol_sq_eff=tol, max_iters=cap,
              use_implicit=implicit)
    x, r, it, mon, conv, _ = bicgstab_ilu_walk(A, Tl, Tu, invdl, invdu, b, torch.zeros(n),
                                               blocks=blocks, p_pass=p_pass, **kw)
    wx, wr, wit, wmon, wconv = bicgstab_ilu_reference(A, Tl, Tu, invdl, invdu, b,
                                                      torch.zeros(n), **kw)
    assert it == int(wit) and conv == bool(wconv)
    assert cap < 10 and it == cap or conv
    assert same_bits(float(mon), float(wmon))
    assert same_bits(x, wx.numpy()) and same_bits(r, wr.numpy())


def test_bicgstab_ilu_walk_half_step_exit():
    """A threshold the first half step meets (s.s is about b.b here):
    omega = 0, so x = x + alpha y + 0 z and r = s, and the solve stops
    after one iteration in both."""
    A, Tl, Tu, invdl, invdu = factors((31, 40), "ilu")
    n = A.shape[0]
    b = torch.from_numpy(rhs_vector(n, False, seed=13))
    kw = dict(sweeps_l=3, sweeps_u=3, tol_sq_eff=F32(100 * float(b.norm()) ** 2), max_iters=50,
              use_implicit=False)
    x, r, it, mon, conv, halves = bicgstab_ilu_walk(A, Tl, Tu, invdl, invdu, b, torch.zeros(n),
                                                    blocks=4, **kw)
    wx, wr, wit, wmon, wconv = bicgstab_ilu_reference(A, Tl, Tu, invdl, invdu, b,
                                                      torch.zeros(n), **kw)
    assert halves == [0] and it == int(wit) == 1 and conv and bool(wconv)
    assert same_bits(float(mon), float(wmon))
    assert same_bits(x, wx.numpy()) and same_bits(r, wr.numpy())


def test_bicgstab_ilu_walk_nan_runs_to_the_cap():
    """A NaN in b reaches the monitor of both orders, which then run to the
    cap; with implicit mode too."""
    A, Tl, Tu, invdl, invdu = factors((31, 40), "ilu")
    n = A.shape[0]
    b = torch.from_numpy(rhs_vector(n, True, seed=13))
    for implicit in (False, True):
        kw = dict(sweeps_l=3, sweeps_u=3, tol_sq_eff=F32(1e-6), max_iters=7,
                  use_implicit=implicit)
        x, r, it, mon, conv, _ = bicgstab_ilu_walk(A, Tl, Tu, invdl, invdu, b, torch.zeros(n),
                                                   blocks=4, **kw)
        wx, wr, wit, wmon, wconv = bicgstab_ilu_reference(A, Tl, Tu, invdl, invdu, b,
                                                          torch.zeros(n), **kw)
        assert it == int(wit) == 7 and not conv and not bool(wconv)
        assert np.isnan(float(mon)) and np.isnan(float(wmon))
        assert np.array_equal(np.isnan(x), np.isnan(wx.numpy()))
