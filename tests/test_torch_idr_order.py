"""The pass order K16 (``idr_fused``) keeps, held on the CPU against the
plain version its CUDA kernel is checked against.

The kernel (``csrc/idr_fused.cu``) defers every vector update that no
reduction waits for to the next pass that reads those rows anyway:

- the u pass of step kk + 1 first applies step kk's r -= beta_kk G[kk]
  and U[kk] -= alpha_ib U[ib] for ib = 0 .. kk - 1 in order (after the
  last step, the pass before the dimension-reduction product does);
- the biorthogonalization passes change G[kk] only;
- v = M r is not stored: t = A v gathers minv[c] * r[c], and one pass
  before the replacement applies x += beta_0 U[0], ..., x += beta_{s-1}
  U[s-1], then x += om M r.

Every element keeps the plain version's float32 operations in the plain
version's order.  A dot is a float64 sum in the kernel's row layout, one
row a thread, grid-stride (thread g of the grid adds rows g, g + 256 B,
...; B blocks): a warp folds its 32 threads by shuffles, warp 0 the 8 warp
sums, every block the partials in block order (``coop.cuh``), and the
total rounds to float32.  The plain version's ``torch.sum`` adds in
another order; the cases here round to the same float32.

An independent numpy loop of that order, float32 throughout, must equal
``ops/idr.idr_solve_reference`` bit for bit: x, r, the outer-iteration
count and the monitor, at s = 1, 2 and 4, on Dias the JAX package builds,
carried across by ``interop``; the plain version is held against the JAX
kernel ``idr_vmem_solve`` in Pallas interpret mode by
``tests/test_torch_idr.py``.  Cases: the Identity and Jacobi; bfloat16
diagonals; an r0 that already meets the threshold; a NaN in b.
"""

import numpy as np
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu_torch import stop
from ginkgo_tpu_torch.ops.idr import idr_solve_reference
from tests.test_torch_bicgstab import dia_pair
from tests.test_torch_pell_cg_order import F32, F64, THREADS, _bits, block_sum


@pytest.fixture(autouse=True)
def _one_thread():
    """The loops run many small tensor ops: one intra-op thread each, so
    that they do not spin against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def kernel_dot(a, b, blocks):
    """sum a b in K16's order (grid-stride rows), rounded to float32."""
    n = a.shape[0]
    grid = blocks * THREADS
    trips = -(-n // grid)
    prod = np.zeros(trips * grid)
    prod[:n] = a.astype(F64) * b.astype(F64)
    valid = np.arange(trips * grid) < n
    acc = np.zeros(grid)
    for k in range(trips):
        acc = np.where(valid[k * grid:(k + 1) * grid], acc + prod[k * grid:(k + 1) * grid], acc)
    v = np.zeros(THREADS)
    v[:blocks] = [block_sum(acc[blk * THREADS:(blk + 1) * THREADS]) for blk in range(blocks)]
    return F32(block_sum(v))


class DiaRows:
    """y = A (M src) in ``coop.cuh`` gk_dia_row's order (offset order from
    0, columns outside [0, n) skipped), M src one float32 product a
    gathered entry."""

    def __init__(self, A):
        self.D = A.diags.float().numpy()
        self.offs = [int(o) for o in A.offsets]
        self.n = A.shape[0]

    @np.errstate(invalid="ignore", over="ignore")
    def __call__(self, src, minv=None):
        v = src if minv is None else minv * src
        n, acc = self.n, np.zeros(self.n, F32)
        i = np.arange(n)
        for d, o in enumerate(self.offs):
            j = i + o
            ok = (j >= 0) & (j < n)
            acc = np.where(ok, acc + self.D[d] * v[np.clip(j, 0, n - 1)], acc)
        return acc


def sdiv(num, den):
    return F32(num / den) if den != 0 else F32(0)


@np.errstate(invalid="ignore", over="ignore")
def schedule_loop(A, P, r0, x0, b, minv, kappa, tol, max_iters, blocks):
    """K16's deferred pass order in numpy float32.  Returns (x, r,
    iterations, monitor) as idr_solve_reference does."""
    s = P.shape[0]
    spmv = DiaRows(A)
    kap = F32(kappa)

    def dot(a, c):
        return kernel_dot(a, c, blocks)

    x, r = x0.copy(), r0.copy()
    G = np.zeros_like(P)
    U = np.zeros_like(P)
    f = [dot(P[j], r) for j in range(s)]
    rr0 = dot(r, r)
    M = np.eye(s, dtype=F32)
    om = F32(1)
    mon = rr0 if rr0 <= tol else F32(np.inf)

    def settle(kk, beta, alpha):
        """Step kk's deferred updates, in the next own-row pass."""
        r[:] = r - beta[kk] * G[kk]
        for ib in range(kk):
            U[kk] = U[kk] - alpha[ib] * U[ib]

    it = 0
    while it < max_iters and not (mon <= tol):
        beta, alpha = [F32(0)] * s, [F32(0)] * s
        for kk in range(s):
            c = [F32(0)] * s
            for i in range(kk, s):
                acc = f[i]
                for j in range(kk, i):
                    acc = F32(acc - M[i, j] * c[j])
                c[i] = sdiv(acc, M[i, i])
            if kk > 0:  # the u pass
                settle(kk - 1, beta, alpha)
            v = r
            for j in range(kk, s):
                v = v - c[j] * G[j]
            if minv is not None:
                v = minv * v
            u = om * v
            for j in range(kk, s):
                u = u + c[j] * U[j]
            U[kk] = u
            G[kk] = spmv(U[kk])  # the product
            if kk == 0:
                mcol = [dot(P[j], G[kk]) for j in range(s)]
            else:
                pg = dot(P[0], G[kk])
                for ib in range(kk):  # G[kk] only between the reductions
                    alpha[ib] = sdiv(pg, M[ib, ib])
                    G[kk] = G[kk] - alpha[ib] * G[ib]
                    if ib + 1 < kk:
                        pg = dot(P[ib + 1], G[kk])
                    else:
                        mcol = [dot(P[j], G[kk]) for j in range(s)]
            for i in range(kk, s):
                M[i, kk] = mcol[i]
            beta[kk] = sdiv(f[kk], M[kk, kk])
            for j in range(kk + 1, s):
                f[j] = F32(f[j] - beta[kk] * M[j, kk])
            f[kk] = F32(0)
        settle(s - 1, beta, alpha)  # the pass before the product
        t = spmv(r, minv)
        tt, tr, rr = dot(t, t), dot(t, r), dot(r, r)
        om_raw = sdiv(tr, tt)
        rho = F32(abs(sdiv(tr, F32(np.sqrt(tt) * np.sqrt(rr)))))
        om = F32(om_raw * sdiv(kap, rho)) if rho < kap else om_raw
        for kk in range(s):  # the x pass
            x = x + beta[kk] * U[kk]
        x = x + om * (r if minv is None else minv * r)
        r = b - spmv(x)  # the replacement
        f = [dot(P[j], r) for j in range(s)]
        mon = dot(r, r)
        it += 1
    return x, r, it, mon


CASES = {
    # name: (matrix, storage, s, Jacobi, rhs, blocks)
    "s1_identity": ("tridiag700", "f32", 1, False, "random", 2),
    "s2_jacobi": ("convdiff32_jitter", "f32", 2, True, "random", 3),
    "s2_bf16_jacobi": ("convdiff32_jitter", "bf16", 2, True, "random", 3),
    "s4_identity": ("convdiff32", "f32", 4, False, "random", 3),
    "s4_bf16": ("tridiag700", "bf16", 4, False, "random", 2),
    "s2_converged_r0": ("convdiff32", "f32", 2, True, "converged", 3),
    "s2_nan": ("tridiag700", "f32", 2, False, "nan", 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_deferred_pass_order_matches_plain_version(case):
    matrix, storage, s, jacobi, rhs, blocks = CASES[case]
    _, A = dia_pair(matrix, storage)
    n = A.shape[0]
    # some threads take two rows, others one
    assert blocks * THREADS < n < 2 * blocks * THREADS
    P = gt.Idr.build(criteria=[stop.Iteration(max_iters=1)], subspace_dim=s).generate(
        A).P.to(torch.float32).numpy()
    rng = np.random.default_rng(n + s)
    b = rng.uniform(0.5, 1.5, n).astype(F32)
    if rhs == "nan":
        b[n // 3] = np.nan
    minv = (1.0 / A.extract_diagonal().values.float()).numpy() if jacobi else None
    tol = F32((1e-6 * np.linalg.norm(np.nan_to_num(b).astype(F64))) ** 2)
    x0 = np.zeros(n, F32)
    r0 = b.copy()
    if rhs == "converged":  # r0 already at the threshold: no iteration
        r0 = (b * F32(1e-8)).astype(F32)
    cap = 7 if rhs == "nan" else 300
    x, r, it, mon = schedule_loop(A, P, r0, x0, b, minv, 0.7, tol, cap, blocks)
    t = torch.from_numpy
    want = idr_solve_reference(A.diags, A.offsets, t(P), t(r0), t(x0), t(b),
                               None if minv is None else t(minv), kappa=0.7,
                               tol_sq_eff=float(tol), max_iters=cap)
    assert it == int(want[2])
    assert _bits(x, want[0].numpy()) and _bits(r, want[1].numpy()) and _bits(mon, want[3].numpy())
    if rhs == "nan":
        assert it == cap and np.isnan(mon)
    elif rhs == "converged":
        assert it == 0 and _bits(x, x0) and _bits(r, r0)
    else:
        assert mon <= tol and 0 < it < cap
