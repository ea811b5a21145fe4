"""The pass order of K15m (``gmres_fused_multi``) and of the one-column
kernel K15 / K18 (``gmres_fused`` on a Dia, ``pell_gmres_fused`` on a Pell),
held on the CPU against the plain versions their CUDA kernels are checked
against.

Each Arnoldi step of the kernels (``csrc/gmres_fused.cu``) goes over the
rows in tiles of 256 * T rows (T = ``GK_GMRES_TILE_ROWS`` for K15m,
``GK_GMRES1_TILE_ROWS`` at one column, where a row is 4 consecutive
elements), a thread T rows of a tile, each row's k values (4 elements)
one access:

- pass A: u = M A V_j, kept in registers, and the first dots <V_i, u>;
- pass B: u -= h1_i V_i in i order, then the second dots;
- pass C: u -= h2_i V_i in i order, and u.u;
- then V_{j+1} = u / |u| and the Givens chain of every column.

A dot is a float64 sum in the kernel's order: a thread adds its rows'
products in row order, a warp folds its 32 threads by shuffles (lane l
adds lane l + o for o = 16, 8, 4, 2, 1) into its running sum in shared
memory once a tile, a block adds its 8 warps' sums in order into one
partial, and every block folds the partials as ``coop.cuh grid_total`` does.

An independent loop of the pass order must equal
``ops/gmres.gmres_solve_multi_reference`` bit for bit: x, the step count,
the per-column stop iterations, the stop flags and the true r.r; the plain
version is held against the JAX package's ``gmres_vmem_solve_multi`` in
Pallas interpret mode by ``tests/test_torch_krhs.py``
(``test_gmres_multi_reference_matches_pallas_kernel``), on operators the
JAX package builds as here.  The dots the loop goes on with are float64 sums
rounded to float32, summed as the plain version sums them; the kernel's
tiled order is modelled beside every one of them (the h1, h2 and u.u of
each step) and must agree within one float32 ulp: it does bit for bit
except where a dot cancels to a few ulps of its terms (CGS2's second pass),
and there the kernel may part from the plain version, as the order of
float64 dot sums is the one freedom it has.  Cases: m = 1, 5, 30; k = 2,
3, 4; columns that stop at different steps, one inside a cycle that
another runs on in; a NaN column; a bfloat16 basis; several tiles a block
and fewer tiles than blocks.

At one column the same loop runs K15's semantics, step by step as
``ops/gmres.gmres_loop_reference`` (the back-substitution over the cycle's
own steps, the true residual deciding ``converged`` after every cycle) on a
Dia and on a Pell the JAX package builds, and must equal
``gmres_solve_reference`` and ``pell_gmres_solve_reference`` bit for bit
in x, the step count and the true r.r, every tiled dot within one ulp of
the plain one.  Cases: m = 1, 5, 30; a stop inside a cycle after a
restart; a NaN in b; a bfloat16 basis; Jacobi.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.matrix.csr import Csr as JCsr
from ginkgo_tpu.matrix.dia import Dia as JDia
from ginkgo_tpu.matrix.pell import Pell as JPell
import ginkgo_tpu_torch
from ginkgo_tpu_torch import interop
from ginkgo_tpu_torch.ops.cg import _dots, _sqrt
from ginkgo_tpu_torch.ops.dia import dia_spmv_reference
from ginkgo_tpu_torch.ops.gmres import (
    _back_substitute,
    _givens,
    _inv_pos,
    gmres_solve_multi_reference,
    gmres_solve_reference,
    pell_gmres_solve_reference,
)
from ginkgo_tpu_torch.ops.pell import pell_spmv_reference

F32 = np.float32
THREADS, WARPS = 256, 8

_SOURCE = (Path(ginkgo_tpu_torch.__file__).parent / "csrc" / "gmres_fused.cu").read_text()
#: rows a thread takes of a tile: the kernel's own constant
TILE_ROWS = int(re.search(r"#define GK_GMRES_TILE_ROWS (\d+)", _SOURCE).group(1))
#: the same at one column (K15, K18)
TILE_ROWS_1 = int(re.search(r"#define GK_GMRES1_TILE_ROWS (\d+)", _SOURCE).group(1))


@pytest.fixture(autouse=True)
def _one_thread():
    """The loops run many small tensor ops: one intra-op thread each, so
    that they do not spin against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def convdiff_coo(nside):
    """The 5-point convection-diffusion operator of ``chip_smoke.py``'s path
    4 on an nside^2 grid as (shape, rows, cols, values)."""
    n = nside * nside
    i = np.arange(n)
    ix, iy = i % nside, i // nside
    rows, cols, vals = [i], [i], [np.full(n, 4.5)]
    for keep, off, v in ((ix > 0, -1, -1.3), (ix < nside - 1, 1, -0.7),
                         (iy > 0, -nside, -1.3), (iy < nside - 1, nside, -0.7)):
        rows.append(i[keep])
        cols.append(i[keep] + off)
        vals.append(np.full(int(keep.sum()), v))
    return (n, n), np.concatenate(rows), np.concatenate(cols), np.concatenate(vals).astype(F32)


def convdiff(nside):
    """``convdiff_coo`` built as a Dia by the JAX package and carried across
    by ``interop``.  Returns the port's Dia."""
    J = JDia.from_matrix_data(JMatrixData.from_coo(*convdiff_coo(nside)))
    return interop.dia_from_arrays(np.asarray(J.diags), J.offsets, J.shape, device="cpu")


def convdiff_pell(nside, q_dtype=np.int8):
    """``convdiff_coo`` built as a Pell (S = 8) by the JAX package and
    carried across by ``interop``.  Returns the port's Pell."""
    JP = JPell.from_csr(JCsr.from_matrix_data(JMatrixData.from_coo(*convdiff_coo(nside))),
                        q_dtype=q_dtype)
    return interop.pell_from_arrays(
        np.asarray(JP.values), np.asarray(JP.qidx), np.asarray(JP.bases),
        np.asarray(JP.tile_of_step), shape=JP.shape, n_steps=JP.n_steps, nnz=JP.nnz, G=JP.G,
        NT=JP.NT, NP=JP.NP, S=JP.S, device="cpu")


def warp_fold(a):
    """Lane 0 of a warp's shuffle fold over the 32 lanes of the second-last
    axis (``__shfl_down_sync``, o = 16 .. 1)."""
    a = a.copy()
    for o in (16, 8, 4, 2, 1):
        a[..., :o, :] = a[..., :o, :] + a[..., o:2 * o, :]
    return a[..., 0, :]


def block_sum(v):
    """coop.cuh block_sum over the block's 256 threads (axis -2): each warp
    folds its lanes, then warp 0 folds the 8 warp sums (lanes 8..31 zero)."""
    w = warp_fold(v.reshape(v.shape[:-2] + (WARPS, 32, v.shape[-1])))
    lanes = np.zeros(w.shape[:-2] + (32, w.shape[-1]))
    lanes[..., :WARPS, :] = w
    return warp_fold(lanes)


def grid_total(part):
    """coop.cuh grid_total of per-block partials (blocks on axis -2, at most
    256): thread t holds 0 + part[t], then the block folds them."""
    v = np.zeros(part.shape[:-2] + (THREADS, part.shape[-1]))
    v[..., :part.shape[-2], :] = 0.0 + part
    return block_sum(v)


def tile_view(a, ntiles, rows=TILE_ROWS):
    """(n, k) rows as (tiles, rows, 256, k): row (t rows + q) 256 + thread,
    rows past n zero."""
    n, k = a.shape
    out = np.zeros((ntiles * rows * THREADS, k))
    out[:n] = a
    return out.reshape(ntiles, rows, THREADS, k)


def tiled_dots(V, u, blocks, rows=TILE_ROWS):
    """<V_i, u> for each basis row of V (j+1, n, k) in the kernel's order,
    T = rows, as float32 (j+1, k)."""
    n = u.shape[0]
    ntiles = -(-n // (rows * THREADS))
    uu = tile_view(u.astype(np.float64), ntiles, rows)
    prod = np.stack([tile_view(Vi.astype(np.float64), ntiles, rows) for Vi in V]) * uu
    thread = np.zeros(prod.shape[:2] + prod.shape[3:])
    for q in range(rows):
        thread = thread + prod[:, :, q]
    lane0 = warp_fold(thread.reshape(thread.shape[:2] + (WARPS, 32, thread.shape[-1])))
    part = np.zeros((len(V), blocks, u.shape[1]))
    for b in range(blocks):
        ws = np.zeros((len(V), WARPS, u.shape[1]))
        for tt in range(b, ntiles, blocks):
            ws = ws + lane0[:, tt]
        s = np.zeros((len(V), u.shape[1]))
        for w in range(WARPS):
            s = s + ws[:, w]
        part[:, b] = s
    return grid_total(part).astype(F32)


def tiled_norm_sq(u, blocks, rows=TILE_ROWS):
    """u.u of pass C in the kernel's order (T = rows): a thread's rows of its
    tiles in tile order, then block_sum and grid_total, as float32 (k,)."""
    n = u.shape[0]
    ntiles = -(-n // (rows * THREADS))
    uu = tile_view(u.astype(np.float64), ntiles, rows)
    sq = uu * uu
    part = np.zeros((blocks, u.shape[1]))
    for b in range(blocks):
        acc = np.zeros((THREADS, u.shape[1]))
        for tt in range(b, ntiles, blocks):
            for q in range(rows):
                acc = acc + sq[tt, q]
        part[b] = block_sum(acc)
    return grid_total(part).astype(F32)


def near(tiled, plain, terms, seen):
    """The kernel's tiled dots against the plain version's: equal, or apart
    by no more than one float32 ulp or the two float64 sums' error bound,
    2 n 2^-53 times the sum of |terms| (a dot that cancels); tallied into
    seen [dots, equal]."""
    gap = np.abs(tiled.astype(np.float64) - plain.astype(np.float64))
    bound = np.maximum(np.spacing(np.abs(plain)).astype(np.float64),
                       2.0 * terms.shape[-2] * 2.0 ** -53 * np.abs(terms).sum(axis=-2))
    same = (tiled.view(np.uint32) == plain.view(np.uint32)) | (np.isnan(tiled) & np.isnan(plain))
    assert (same | (gap <= bound)).all(), (tiled, plain)
    seen[0] += tiled.size
    seen[1] += int(same.sum())


def tiled_loop(A, b, x0, minv, *, m, tol_sq_eff, max_iters, basis_dtype, blocks):
    """K15m's pass order.  Returns what gmres_solve_multi_reference does and
    the tally [dots, equal bit for bit] of the tiled dots against the plain
    version's."""
    n, k = b.shape
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32).reshape(-1).expand(k)
    mv = None if minv is None else minv[:, None]

    def spmv(v):
        return dia_spmv_reference(A.diags, A.offsets, v, n)

    def precond(v):
        return v if mv is None else mv * v

    def residual(x):
        u = b - spmv(x)
        return u, _dots(u, u), _dots(precond(u), precond(u))

    V = torch.zeros((m + 1, n, k), dtype=basis_dtype)
    x = x0.clone()
    u, rr, zz = residual(x)
    done = (rr <= tol).tolist()
    itc = [0] * k
    it = 0
    seen = [0, 0]
    while not all(done) and it < max_iters:
        beta = _sqrt(zz)
        V[0] = (precond(u) * _inv_pos(beta)).to(basis_dtype)
        g = [torch.zeros(m + 1) for _ in range(k)]
        cs = [torch.zeros(m) for _ in range(k)]
        sn = [torch.zeros(m) for _ in range(k)]
        Rm = [torch.zeros((m, m + 1)) for _ in range(k)]
        for c in range(k):
            g[c][0] = beta[c]
        act = [not d for d in done]
        j = 0
        while any(act) and j < m:
            Vj = V[: j + 1].float()
            Vn = Vj.numpy()
            u = precond(spmv(V[j].float()))  # pass A
            h = torch.zeros((m + 1, k))
            for _ in range(2):  # the dots of pass A, then of pass B after its subtraction
                hp = torch.stack([_dots(Vj[i], u) for i in range(j + 1)])
                un = u.numpy()
                near(tiled_dots(Vn, un, blocks), hp.numpy(),
                     Vn.astype(np.float64) * un.astype(np.float64), seen)
                for i in range(j + 1):
                    u = u - hp[i] * Vj[i]
                h[: j + 1] = h[: j + 1] + hp
            uu = _dots(u, u)  # pass C
            un = u.numpy().astype(np.float64)
            near(tiled_norm_sq(u.numpy(), blocks), uu.numpy(), un * un, seen)
            hnext = _sqrt(uu)
            V[j + 1] = (u * _inv_pos(hnext)).to(basis_dtype)
            h[j + 1] = hnext
            it += 1
            for c in range(k):
                if not act[c]:
                    continue
                Rm[c][j] = _givens(h[:, c].clone(), j, cs[c], sn[c], g[c])
                itc[c] = it
                act[c] = not bool(g[c][j + 1] * g[c][j + 1] <= tol[c]) and it < max_iters
            j += 1
        y = torch.stack([torch.zeros(m) if done[c] else _back_substitute(Rm[c], g[c], m)
                         for c in range(k)], dim=1)
        for i in range(j):
            x = x + y[i] * V[i].float()
        u, rr_new, zz = residual(x)
        rr = torch.where(torch.tensor(done), rr, rr_new)
        done = [d or bool(r <= t) for d, r, t in zip(done, rr_new, tol)]
    return x, it, rr, done, itc, seen


def columns(n, k, rng, nan_col=None):
    """k right-hand sides (Gaussian, uniform, a ramp, ones) and their squared
    thresholds at 1e-6 relative."""
    B = np.stack([rng.standard_normal(n), rng.uniform(0.5, 1.5, n), np.linspace(-1, 1, n),
                  np.ones(n)], axis=1)[:, :k].astype(F32)
    if nan_col is not None:
        B[n // 3, nan_col] = np.nan
    tol = ((1e-6 * np.linalg.norm(np.nan_to_num(B), axis=0)) ** 2).astype(F32)
    return torch.from_numpy(B), torch.from_numpy(tol)


CASES = [
    # (label, nside, k, m, basis, Jacobi, blocks, cap, NaN column)
    ("m5_k3", 16, 3, 5, torch.float32, False, 2, 400, None),
    ("m1_k2", 20, 2, 1, torch.float32, False, 3, 40, None),
    ("m30_k4_mid_cycle", 40, 4, 30, torch.float32, False, 3, 400, None),
    ("m30_k4_bf16_jacobi", 40, 4, 30, torch.bfloat16, True, 5, 400, None),
    ("m5_k4_nan", 24, 4, 5, torch.float32, False, 7, 50, 2),
    ("m30_k2_tiles", 72, 2, 30, torch.bfloat16, False, 2, 400, None),
]


@pytest.mark.parametrize("label,nside,k,m,basis,jacobi,blocks,cap,nan_col", CASES,
                         ids=[c[0] for c in CASES])
def test_tiled_passes_match_plain_version(label, nside, k, m, basis, jacobi, blocks, cap,
                                          nan_col):
    A = convdiff(nside)
    n = A.shape[0]
    B, tol = columns(n, k, np.random.default_rng(n + k), nan_col)
    minv = 1.0 / A.extract_diagonal().values.float() if jacobi else None
    kw = dict(m=m, tol_sq_eff=tol, max_iters=cap, basis_dtype=basis)
    Z = torch.zeros(n, k)
    x, it, rr, done, itc, seen = tiled_loop(A, B, Z, minv, blocks=blocks, **kw)
    wx, wit, wrr, wdone, witc = gmres_solve_multi_reference(A.diags, A.offsets, B, Z, minv, **kw)
    assert seen[1] > 0.9 * seen[0]  # most dots bit for bit in either order
    assert it == int(wit) and itc == witc.tolist() and done == wdone.tolist()
    assert np.array_equal(x.numpy().view(np.uint32), wx.numpy().view(np.uint32))
    assert np.array_equal(rr.numpy().view(np.uint32), wrr.numpy().view(np.uint32))
    if nan_col is not None:
        assert itc[nan_col] == cap and not done[nan_col] and all(
            done[c] and itc[c] < cap for c in range(k) if c != nan_col)
    if label == "m30_k4_mid_cycle":
        # a column stopped inside a cycle that another column ran on in
        assert any(c < it and (c - 1) // m == (d - 1) // m for c in itc for d in itc if d > c)
    if label == "m30_k2_tiles":
        assert -(-n // (TILE_ROWS * THREADS)) > 2 * blocks  # several tiles a block


# -- one column: K15 on a Dia, K18 on a Pell -----------------------------------------


def vec_view(a, ntiles, rows):
    """(n,) elements as (tiles, rows, 256, 4): element 4 ((t rows + q) 256 +
    thread) + c, the elements past n zero; and the (tiles, rows, 256) mask
    of the rows of 4 that hold an element."""
    n = a.shape[0]
    nv = -(-n // 4)
    out = np.zeros(ntiles * rows * THREADS * 4)
    out[:n] = a
    valid = np.arange(ntiles * rows * THREADS) < nv
    return out.reshape(ntiles, rows, THREADS, 4), valid.reshape(ntiles, rows, THREADS)


def vec_dots(V, u, blocks, rows):
    """<V_i, u> in the one-column kernel's order (a thread's rows of 4 in
    order, each row's 4 elements in order; the warp fold once a tile; the
    warps' running sums; block partials; grid_total), float32 (j+1, 1)."""
    n = u.shape[0]
    ntiles = -(-(-(-n // 4)) // (rows * THREADS))
    uu, valid = vec_view(u.astype(np.float64), ntiles, rows)
    prod = np.stack([vec_view(Vi.astype(np.float64), ntiles, rows)[0] for Vi in V]) * uu
    thread = np.zeros((len(V), ntiles, THREADS))
    for q in range(rows):
        for c in range(4):
            thread = np.where(valid[:, q], thread + prod[:, :, q, :, c], thread)
    lane0 = warp_fold(thread.reshape(len(V), ntiles, WARPS, 32, 1))
    part = np.zeros((len(V), blocks, 1))
    for b in range(blocks):
        ws = np.zeros((len(V), WARPS, 1))
        for tt in range(b, ntiles, blocks):
            ws = ws + lane0[:, tt]
        s = np.zeros((len(V), 1))
        for w in range(WARPS):
            s = s + ws[:, w]
        part[:, b] = s
    return grid_total(part).astype(F32)


def vec_norm_sq(u, blocks, rows):
    """u.u of pass C in the one-column kernel's order, float32 (1,)."""
    n = u.shape[0]
    ntiles = -(-(-(-n // 4)) // (rows * THREADS))
    uu, valid = vec_view(u.astype(np.float64), ntiles, rows)
    sq = uu * uu
    part = np.zeros((blocks, 1))
    for b in range(blocks):
        acc = np.zeros(THREADS)
        for tt in range(b, ntiles, blocks):
            for q in range(rows):
                for c in range(4):
                    acc = np.where(valid[tt, q], acc + sq[tt, q, :, c], acc)
        part[b] = block_sum(acc[:, None])
    return grid_total(part).astype(F32)


def tiled_loop_one(spmv, b, x0, minv, *, m, tol_sq_eff, max_iters, basis_dtype, blocks):
    """K15's (K18's) pass order at one column, step by step as
    gmres_loop_reference.  Returns (x, steps, true r.r, converged, the
    tally [dots, equal bit for bit])."""
    n = b.shape[0]
    tol = float(torch.as_tensor(tol_sq_eff, dtype=torch.float32))
    tol_t = torch.tensor(tol, dtype=torch.float32)
    T = TILE_ROWS_1

    def precond(v):
        return v if minv is None else minv * v

    def residual(x):
        u = b - spmv(x)
        return u, _dots(u[:, None], u[:, None])[0], _dots(precond(u)[:, None],
                                                          precond(u)[:, None])[0]

    V = torch.zeros((m + 1, n), dtype=basis_dtype)
    x = x0.clone()
    u, rr, zz = residual(x)
    done = bool(rr <= tol_t) and tol >= 0
    it = 0
    seen = [0, 0]
    while not done and it < max_iters:
        beta = _sqrt(zz)
        V[0] = (precond(u) * _inv_pos(beta)).to(basis_dtype)
        g, cs, sn = torch.zeros(m + 1), torch.zeros(m), torch.zeros(m)
        Rm = torch.zeros((m, m + 1))
        g[0] = beta
        j = 0
        active = not bool(rr <= tol_t)
        while active and j < m:
            Vj = V[: j + 1].float()
            Vn = Vj.numpy()[:, :, None]
            u = precond(spmv(V[j].float()))  # pass A
            h = torch.zeros(m + 1)
            for _ in range(2):  # the dots of pass A, then of pass B after its subtraction
                hp = (Vj.double() @ u.double()).float()
                un = u.numpy()[:, None]
                near(vec_dots(Vn[:, :, 0], un[:, 0], blocks, T), hp.numpy()[:, None],
                     Vn.astype(np.float64) * un.astype(np.float64), seen)
                for i in range(j + 1):
                    u = u - hp[i] * Vj[i]
                h[: j + 1] = h[: j + 1] + hp
            uu = _dots(u[:, None], u[:, None])  # pass C
            un = u.numpy()[:, None].astype(np.float64)
            near(vec_norm_sq(u.numpy(), blocks, T), uu.numpy(), un * un, seen)
            hnext = _sqrt(uu[0])
            V[j + 1] = (u * _inv_pos(hnext)).to(basis_dtype)
            h[j + 1] = hnext
            Rm[j] = _givens(h, j, cs, sn, g)
            it += 1
            active = not bool(g[j + 1] * g[j + 1] <= tol_t) and it < max_iters
            j += 1
        y = torch.zeros(m)
        for i in range(j - 1, -1, -1):
            acc = torch.zeros(())
            for k in range(i + 1, j):
                acc = acc + Rm[k, i] * y[k]
            y[i] = (g[i] - acc) / Rm[i, i] if bool(Rm[i, i] != 0) else 0.0
        for i in range(j):
            x = x + y[i] * V[i].float()
        u, rr, zz = residual(x)
        done = bool(rr <= tol_t) and tol >= 0
    return x, it, rr, done, seen


ONE_COLUMN_CASES = [
    # (label, operator, nside, m, basis, Jacobi, blocks, cap, NaN in b)
    ("dia_m5_restarts", "dia", 24, 5, torch.float32, False, 2, 400, False),
    ("dia_m30_bf16_jacobi", "dia", 40, 30, torch.bfloat16, True, 3, 400, False),
    ("dia_m1", "dia", 16, 1, torch.float32, False, 2, 400, False),
    ("dia_m5_nan", "dia", 16, 5, torch.float32, False, 2, 12, True),
    ("pell_m30", "pell", 47, 30, torch.float32, False, 1, 400, False),
    ("pell_m5_bf16_int32", "pell", 24, 5, torch.bfloat16, True, 2, 400, False),
]


@pytest.mark.parametrize("label,op,nside,m,basis,jacobi,blocks,cap,nan",
                         ONE_COLUMN_CASES, ids=[c[0] for c in ONE_COLUMN_CASES])
def test_one_column_tiled_passes_match_plain_version(label, op, nside, m, basis, jacobi,
                                                     blocks, cap, nan):
    if op == "dia":
        A = convdiff(nside)
        spmv = lambda v: dia_spmv_reference(A.diags, A.offsets, v, A.shape[0])  # noqa: E731
        plain = lambda *a, **kw: gmres_solve_reference(A.diags, A.offsets, *a, **kw)  # noqa: E731
    else:
        A = convdiff_pell(nside, np.int32 if "int32" in label else np.int8)
        spmv = lambda v: pell_spmv_reference(A, v)  # noqa: E731
        plain = lambda *a, **kw: pell_gmres_solve_reference(A, *a, **kw)  # noqa: E731
    n = A.shape[0]
    rng = np.random.default_rng(n + m)
    b = rng.uniform(0.5, 1.5, n).astype(F32)
    if nan:
        b[n // 3] = np.nan
    tol = F32((1e-6 * np.linalg.norm(np.nan_to_num(b).astype(np.float64))) ** 2)
    b = torch.from_numpy(b)
    minv = 1.0 / A.extract_diagonal().values.float() if jacobi else None
    kw = dict(m=m, tol_sq_eff=float(tol), max_iters=cap, basis_dtype=basis)
    x, it, rr, done, seen = tiled_loop_one(spmv, b, torch.zeros(n), minv, blocks=blocks, **kw)
    wx, wit, wrr, wdone = plain(b, torch.zeros(n), minv, **kw)
    assert seen[1] > 0.9 * seen[0] or nan  # most dots bit for bit in either order
    assert it == int(wit) and done == bool(wdone)
    assert np.array_equal(np.isnan(x.numpy()), np.isnan(wx.numpy()))
    keep = ~np.isnan(wx.numpy())
    assert np.array_equal(x.numpy()[keep].view(np.uint32), wx.numpy()[keep].view(np.uint32))
    if nan:
        assert it == cap and not done and np.isnan(float(rr))
    else:
        assert np.array_equal(rr.numpy().view(np.uint32), wrr.numpy().view(np.uint32))
        assert done and it < cap
    if label == "dia_m5_restarts":
        assert it > m and it % m != 0  # restarted, stopped inside a later cycle
    tiles = -(-(-(-n // 4)) // (TILE_ROWS_1 * THREADS))
    if label == "pell_m30":
        assert tiles > blocks and n % 4 != 0  # more tiles than blocks, a part row of 4
    if label == "dia_m30_bf16_jacobi":
        assert tiles < blocks  # fewer tiles than blocks
