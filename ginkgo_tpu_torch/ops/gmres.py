"""Whole-solve fused restarted GMRES(m): kernels K15, K15m and K18 and
their plain versions.

Counterpart of ``ginkgo_tpu/ops/pallas_gmres.py`` ``gmres_vmem_solve`` (K15,
``_gmres_dia_kernel`` over ``_gmres_core``, :110-378) and
``gmres_vmem_solve_multi`` (K15m, ``_gmres_multi_dia_kernel``, :396-766, 2
to 4 columns with per-column stopping): left scalar-Jacobi
preconditioned GMRES(m) on a ``Dia``, every restart cycle in one
persistent cooperative CUDA kernel (``csrc/gmres_fused.cu``).  The basis
is stored in float32 or, for CB-GMRES's reduce1/reduce2 modes, bfloat16,
with float32 arithmetic.

Semantics, shared by the kernel and :func:`gmres_solve_reference`, step by
step as ``_gmres_core``:

- a cycle starts from the true residual u = b - A x: V_0 = z / |z| with
  z = M u (1/|z| taken as 1 when |z| is not positive);
- Arnoldi step j: u = M A V_j, then CGS2 against rows 0..j (all dots,
  then u -= h_i V_i in i order, twice; h = h1 + h2), |u| and V_{j+1} =
  u / |u|;
- the Givens rotations, in float32, with phase = sign(a) for real data;
- the cycle stops when |g[j+1]|^2 <= tol_sq_eff (the preconditioned
  estimate; NaN keeps going), at the iteration cap, or after m steps; the
  first cycle's flag starts from the true residual;
- y = R^-1 g by back-substitution (R[i][k] y[k] summed for k = i+1 ..
  steps-1; a zero pivot gives 0), then x += y_i V_i in i order;
- after each cycle the true r.r decides ``converged`` (r.r <= tol_sq_eff
  and tol_sq_eff >= 0), which can retract the in-cycle stop.

It takes b, not r0, and returns the true r.r.  The one-column loop exists
once, :func:`gmres_loop_reference` over an SpMV.  K18 (:func:`pell_gmres_fused`,
``ginkgo_tpu/ops/pallas_gmres.py`` ``pell_gmres_vmem_solve``,
``_gmres_pell_kernel`` :857) is K15 on a square Pell: the same
``_gmres_core`` over the Pell SpMV, in the same CUDA kernel templated on its
operator.

K15m runs k columns through one Arnoldi step counter j.  Each column has
its own g, rotations and R factor; a column's QR freezes once it stops
(its basis row is still written).  In a cycle a column stays active while
``not (g[j+1]^2 <= tol_sq_eff) and it < max_iters``; the back-substitution
runs over the full m (a zero R diagonal gives y = 0, so rows past a
column's own steps add nothing), a column done at the cycle's start gets
y = 0, and x += y_i V_i runs over the shared j.  After each cycle the true
r.r of every column is recomputed: it decides ``done`` (done only grows),
so a column whose in-cycle stop the true residual does not confirm runs
on in the next cycle.  The first ``done`` comes from the true r0.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .cg import _dots, _sqrt, check_fused_diags, check_solve_vectors, coop_grid_blocks
from .dia import DTYPE_CODE, check_status, dia_spmv_reference, offsets_array, on_cpu
from .pell import INDEX_CODE, check_fused_pell, pell_plan_args, pell_spmv_reference

#: basis storage dtypes the kernel takes (keep; reduce1/reduce2)
BASIS_DTYPES = (torch.float32, torch.bfloat16)
#: largest Krylov dimension the kernel takes: its scalar state (R factor,
#: rotations, g, y) lives in shared memory (csrc/gmres_fused.cu GK_GMRES_MAX_M)
MAX_FUSED_KRYLOV_DIM = 100
#: most columns K15m takes (the JAX package's k-column GMRES has the same cap)
MAX_FUSED_GMRES_COLS = 4
#: largest Krylov dimension K15m takes: 4 k (m^2 + 7 m + 3) bytes of
#: per-column scalar state in shared memory stay under the 48 KB a block
#: gets without opting in for k = 4 (csrc/gmres_fused.cu GK_GMRES_MULTI_MAX_M).
#: The JAX package's gate is a VMEM fit instead; a larger m streams here.
MAX_FUSED_KRYLOV_DIM_MULTI = 50


def _inv_pos(v):
    """1/v where v > 0, else 1 (pallas_gmres inv_beta / inv_h)."""
    ok = v > 0
    return torch.where(ok, 1.0 / torch.where(ok, v, torch.ones_like(v)), 1.0)


def _givens(h, j, cs, sn, g):
    """Rotate the new Hessenberg column h (float32 on the host, entries
    0..j+1) by the earlier rotations and a new one, in the TPU kernel's
    order; updates cs, sn, g in place and returns the rotated column."""
    for i in range(j):
        hi, hi1 = h[i].clone(), h[i + 1].clone()
        h[i] = cs[i] * hi + sn[i] * hi1
        h[i + 1] = -sn[i] * hi + cs[i] * hi1
    a, bb = h[j].clone(), h[j + 1].clone()
    denom = _sqrt(a * a + bb * bb)
    pos = bool(denom > 0)
    c = torch.abs(a) / denom if pos else torch.ones_like(a)
    phase = torch.sign(a) if bool(torch.abs(a) > 0) else torch.ones_like(a)
    s = phase * bb / denom if pos else torch.zeros_like(a)
    h[j] = c * a + s * bb
    h[j + 1] = 0.0
    gj = g[j].clone()
    g[j + 1] = -s * gj
    g[j] = c * gj
    cs[j], sn[j] = c, s
    return h


def gmres_loop_reference(spmv, b, x0, minv=None, *, m, tol_sq_eff, max_iters,
                         basis_dtype=torch.float32):
    """The whole solve, step by step as K15 and K18, for any operator.
    spmv: (n,) -> (n,) float32; b, x0, minv: (n,) float32; m: the Krylov
    dimension; basis_dtype: float32 or bfloat16.  The m-sized scalar work
    runs on the host in float32.  Returns (x, iterations int32, true r.r
    float32, converged)."""
    n = b.shape[0]
    dev = b.device
    m = int(m)
    tol = float(torch.as_tensor(tol_sq_eff, dtype=torch.float32))
    tol_t = torch.tensor(tol, dtype=torch.float32)
    mv = None if minv is None else minv.to(torch.float32)

    def precond(v):
        return v if mv is None else mv * v

    def residual(x):
        u = b - spmv(x)
        return u, _dots(u, u), _dots(precond(u), precond(u))

    V = torch.zeros((m + 1, n), dtype=basis_dtype, device=dev)
    x = x0.clone()
    u, rr, zz = residual(x)
    rr_h = rr.cpu()
    done = bool(rr_h <= tol_t) and tol >= 0
    it = 0
    while not done and it < max_iters:
        beta = _sqrt(zz)
        V[0] = (precond(u) * _inv_pos(beta)).to(basis_dtype)
        g = torch.zeros(m + 1, dtype=torch.float32)
        cs = torch.zeros(m, dtype=torch.float32)
        sn = torch.zeros(m, dtype=torch.float32)
        Rm = torch.zeros((m, m + 1), dtype=torch.float32)  # row j: column j of R
        g[0] = beta.cpu()
        j = 0
        active = not bool(rr_h <= tol_t)
        while active and j < m:
            u = precond(spmv(V[j].float()))
            h = torch.zeros(m + 1, dtype=torch.float32)
            for _ in range(2):  # CGS2: all dots, then all subtractions
                Vj = V[: j + 1].float()
                hp = (Vj.double() @ u.double()).float()
                for i in range(j + 1):
                    u = u - hp[i] * Vj[i]
                h[: j + 1] = h[: j + 1] + hp.cpu()
            hnext = _sqrt(_dots(u, u))
            V[j + 1] = (u * _inv_pos(hnext)).to(basis_dtype)
            h[j + 1] = hnext.cpu()
            Rm[j] = _givens(h, j, cs, sn, g)
            it += 1
            active = not bool(g[j + 1] * g[j + 1] <= tol_t) and it < max_iters
            j += 1
        y = torch.zeros(m, dtype=torch.float32)
        for i in range(j - 1, -1, -1):
            acc = torch.zeros((), dtype=torch.float32)
            for k in range(i + 1, j):
                acc = acc + Rm[k, i] * y[k]
            diag = Rm[i, i]
            y[i] = (g[i] - acc) / diag if bool(diag != 0) else 0.0
        y = y.to(dev)
        for i in range(j):
            x = x + y[i] * V[i].float()
        u, rr, zz = residual(x)
        rr_h = rr.cpu()
        done = bool(rr_h <= tol_t) and tol >= 0
    iters = torch.tensor(it, dtype=torch.int32, device=dev)
    return x, iters, rr, torch.tensor(done, device=dev)


def gmres_solve_reference(diags, offsets, b, x0, minv=None, *, m, tol_sq_eff, max_iters,
                          basis_dtype=torch.float32):
    """K15's plain version.  diags: (nd, n); b, x0, minv: (n,) float32.
    Returns (x, iterations int32, true r.r float32, converged)."""
    n = b.shape[0]
    return gmres_loop_reference(
        lambda v: dia_spmv_reference(diags, offsets, v, n), b, x0, minv, m=m,
        tol_sq_eff=tol_sq_eff, max_iters=max_iters, basis_dtype=basis_dtype,
    )


def pell_gmres_solve_reference(A, b, x0, minv=None, *, m, tol_sq_eff, max_iters,
                               basis_dtype=torch.float32):
    """K18's plain version.  A: a square Pell; b, x0, minv: (n,) float32.
    Returns (x, iterations int32, true r.r float32, converged)."""
    return gmres_loop_reference(
        lambda v: pell_spmv_reference(A, v), b, x0, minv, m=m, tol_sq_eff=tol_sq_eff,
        max_iters=max_iters, basis_dtype=basis_dtype,
    )


def _back_substitute(Rm, g, m):
    """y = R^-1 g over the full m, by rows from the last: R[i][k] y[k]
    summed for k = i+1 .. m-1 in that order, a zero pivot giving 0 (the
    k-column kernel's guarded back-substitution).  Rm: (m, m+1), row j
    holding column j of R."""
    y = torch.zeros(m, dtype=torch.float32)
    for i in range(m - 1, -1, -1):
        acc = torch.zeros((), dtype=torch.float32)
        for k in range(i + 1, m):
            acc = acc + Rm[k, i] * y[k]
        diag = Rm[i, i]
        y[i] = (g[i] - acc) / diag if bool(diag != 0) else 0.0
    return y


def gmres_solve_multi_reference(diags, offsets, b, x0, minv=None, *, m, tol_sq_eff,
                                max_iters, basis_dtype=torch.float32):
    """K15m's plain version, step by step as the kernel.  b, x0: (n, k)
    float32; minv: (n,) or None; tol_sq_eff: one or k squared thresholds;
    the basis is (m+1, n, k) of basis_dtype.  The m-sized scalar work of
    each column runs on the host in float32.  Returns (x, iterations
    int32, true r.r (k,), converged (k,), stop_iterations (k,) int32)."""
    n, k = b.shape
    dev = b.device
    m = int(m)
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32).reshape(-1).expand(k).cpu()
    mv = None if minv is None else minv.to(torch.float32)[:, None]

    def spmv(v):
        return dia_spmv_reference(diags, offsets, v, n)

    def precond(v):
        return v if mv is None else mv * v

    def residual(x):
        u = b - spmv(x)
        return u, _dots(u, u), _dots(precond(u), precond(u))

    V = torch.zeros((m + 1, n, k), dtype=basis_dtype, device=dev)
    x = x0.clone()
    u, rr, zz = residual(x)
    done = (rr.cpu() <= tol).tolist()
    itc = [0] * k
    it = 0
    while not all(done) and it < max_iters:
        beta = _sqrt(zz)
        V[0] = (precond(u) * _inv_pos(beta)).to(basis_dtype)
        beta_h = beta.cpu()
        g = [torch.zeros(m + 1, dtype=torch.float32) for _ in range(k)]
        cs = [torch.zeros(m, dtype=torch.float32) for _ in range(k)]
        sn = [torch.zeros(m, dtype=torch.float32) for _ in range(k)]
        Rm = [torch.zeros((m, m + 1), dtype=torch.float32) for _ in range(k)]
        for c in range(k):
            g[c][0] = beta_h[c]
        act = [not d for d in done]
        j = 0
        while any(act) and j < m:
            u = precond(spmv(V[j].float()))
            h = torch.zeros((m + 1, k), dtype=torch.float32)
            for _ in range(2):  # CGS2: all dots, then all subtractions, per column
                Vj = V[: j + 1].float()
                hp = torch.stack([_dots(Vj[i], u) for i in range(j + 1)])
                for i in range(j + 1):
                    u = u - hp[i] * Vj[i]
                h[: j + 1] = h[: j + 1] + hp.cpu()
            hnext = _sqrt(_dots(u, u))
            V[j + 1] = (u * _inv_pos(hnext)).to(basis_dtype)
            h[j + 1] = hnext.cpu()
            it += 1
            for c in range(k):
                if not act[c]:
                    continue  # a stopped column's QR stays frozen
                Rm[c][j] = _givens(h[:, c].clone(), j, cs[c], sn[c], g[c])
                itc[c] = it
                act[c] = not bool(g[c][j + 1] * g[c][j + 1] <= tol[c]) and it < max_iters
            j += 1
        y = torch.stack([torch.zeros(m) if done[c] else _back_substitute(Rm[c], g[c], m)
                         for c in range(k)], dim=1).to(dev)
        for i in range(j):
            x = x + y[i] * V[i].float()
        u, rr_new, zz = residual(x)
        was_done = torch.tensor(done, device=dev)
        rr = torch.where(was_done, rr, rr_new)
        done = [d or bool(r <= t) for d, r, t in zip(done, rr_new.cpu(), tol)]
    iters = torch.tensor(it, dtype=torch.int32, device=dev)
    return (x, iters, rr, torch.tensor(done, device=dev),
            torch.tensor(itc, dtype=torch.int32, device=dev))


def _lib():
    lib = _build.load("gmres_fused")
    if not hasattr(lib, "gk_typed"):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        offs, blocks = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
        lib.gmres_fused_grid.argtypes = [I, I, I, blocks]
        lib.gmres_fused_multi_grid.argtypes = [I, I, I, I, blocks]
        lib.gmres_fused_solve.argtypes = [
            P, I, offs, I, L,  # diags, offsets, n
            P, P, P, P,  # b, x0, minv, tol_sq
            I, I, P, I,  # max_iters, m, basis, basis dtype
            P, P, P, P, I,  # x, u, partials, summed dots, blocks
            P, P, P, P,  # it_out, rr_out, conv_out, stream
        ]
        lib.gmres_fused_multi_solve.argtypes = [
            P, I, offs, I, L, I,  # diags, offsets, n, k
            P, P, P, P,  # b, x0, minv, tol_sq
            I, I, P, I,  # max_iters, m, basis, basis dtype
            P, P, P, P, I,  # x, u, partials, summed dots, blocks
            P, P, P, P, P,  # it_out, rr_out, conv_out, itc_out, stream
        ]
        lib.pell_gmres_fused_grid.argtypes = [I, I, I, I, blocks]
        lib.pell_gmres_fused_solve.argtypes = [
            P, I, P, I, P, P, I, I, L,  # values, qidx, bases, tile_ptr, S, G, n
            P, P, P, P,  # b, x0, minv, tol_sq
            I, I, P, I,  # max_iters, m, basis, basis dtype
            P, P, P, P, I,  # x, u, partials, summed dots, blocks
            P, P, P, P,  # it_out, rr_out, conv_out, stream
        ]
        for fn in (lib.gmres_fused_grid, lib.gmres_fused_solve,
                   lib.gmres_fused_multi_grid, lib.gmres_fused_multi_solve,
                   lib.pell_gmres_fused_grid, lib.pell_gmres_fused_solve):
            fn.restype = I
        lib.gk_error_string.argtypes = [I]
        lib.gk_error_string.restype = ctypes.c_char_p
        lib.gk_typed = True
    return lib


def _check_m_basis(what, m, basis_dtype):
    if not 1 <= m <= MAX_FUSED_KRYLOV_DIM:
        raise ValueError(f"{what}: takes 1 <= m <= {MAX_FUSED_KRYLOV_DIM}, got {m}")
    if basis_dtype not in BASIS_DTYPES:
        raise TypeError(f"{what}: the basis must be float32/bfloat16, got {basis_dtype}")


def gmres_fused(diags, offsets, b, x0, minv=None, *, m, tol_sq_eff, max_iters,
                basis_dtype=torch.float32):
    """K15: run restarted GMRES(m) to the stop test in one kernel.  diags:
    (nd, n) float32/bfloat16; b, x0, minv: (n,) float32; tol_sq_eff: the
    squared absolute threshold on both the in-cycle estimate and the true
    residual (negative: run to max_iters), a float32 tensor on the device;
    basis_dtype: float32 or bfloat16.  Returns (x, iterations int32, true
    r.r float32, converged bool) as device tensors."""
    if on_cpu(b):
        return gmres_solve_reference(
            diags, offsets, b, x0, minv, m=m, tol_sq_eff=tol_sq_eff,
            max_iters=max_iters, basis_dtype=basis_dtype,
        )
    dev = b.device
    m = int(m)
    _check_m_basis("gmres_fused", m, basis_dtype)
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(1).contiguous()
    check_fused_diags(diags, offsets, dev, "gmres_fused")
    n = diags.shape[1]
    check_solve_vectors("gmres_fused", (n,), dev, (b, x0), minv, tol, 1)
    lib = _lib()
    dcode, vcode = DTYPE_CODE[diags.dtype], DTYPE_CODE[basis_dtype]
    blocks = coop_grid_blocks(lib, "gmres_fused_grid", (dcode, vcode, m), dev)
    V = torch.empty((m + 1, n), dtype=basis_dtype, device=dev)
    x = torch.empty_like(b)
    u = torch.empty_like(b)
    part = torch.empty((m + 4) * blocks, dtype=torch.float64, device=dev)
    hd = torch.empty(m + 1, dtype=torch.float64, device=dev)
    it_conv = torch.empty(2, dtype=torch.int32, device=dev)
    rr = torch.empty(1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.gmres_fused_solve(
            diags.data_ptr(), dcode, offsets_array(offsets), len(offsets), n,
            b.data_ptr(), x0.data_ptr(), None if minv is None else minv.data_ptr(),
            tol.data_ptr(), min(int(max_iters), 2**31 - 1), m, V.data_ptr(), vcode,
            x.data_ptr(), u.data_ptr(), part.data_ptr(), hd.data_ptr(), blocks,
            it_conv.data_ptr(), rr.data_ptr(), it_conv[1:].data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "gmres_fused")
    gmres_fused.launches += 1
    return x, it_conv[0], rr[0], it_conv[1] != 0


gmres_fused.launches = 0


def pell_gmres_fused(A, b, x0, minv=None, *, m, tol_sq_eff, max_iters,
                     basis_dtype=torch.float32):
    """K18: run restarted GMRES(m) to the stop test in one kernel on a
    square Pell (values float32/bfloat16, lane indices int8/int32), with
    K15's semantics.  b, x0, minv: (n,) float32; tol_sq_eff: as K15's, a
    float32 tensor on the device; basis_dtype: float32 or bfloat16.
    Returns (x, iterations int32, true r.r float32, converged bool) as
    device tensors."""
    if on_cpu(b):
        return pell_gmres_solve_reference(A, b, x0, minv, m=m, tol_sq_eff=tol_sq_eff,
                                          max_iters=max_iters, basis_dtype=basis_dtype)
    dev = b.device
    m = int(m)
    _check_m_basis("pell_gmres_fused", m, basis_dtype)
    n = check_fused_pell(A, dev, "pell_gmres_fused")
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(1).contiguous()
    check_solve_vectors("pell_gmres_fused", (n,), dev, (b, x0), minv, tol, 1)
    lib = _lib()
    codes = (DTYPE_CODE[A.values.dtype], INDEX_CODE[A.qidx.dtype], DTYPE_CODE[basis_dtype])
    blocks = coop_grid_blocks(lib, "pell_gmres_fused_grid", (*codes, m), dev)
    V = torch.empty((m + 1, n), dtype=basis_dtype, device=dev)
    x = torch.empty_like(b)
    u = torch.empty_like(b)
    part = torch.empty((m + 4) * blocks, dtype=torch.float64, device=dev)
    hd = torch.empty(m + 1, dtype=torch.float64, device=dev)
    it_conv = torch.empty(2, dtype=torch.int32, device=dev)
    rr = torch.empty(1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.pell_gmres_fused_solve(
            *pell_plan_args(A), n, b.data_ptr(), x0.data_ptr(),
            None if minv is None else minv.data_ptr(), tol.data_ptr(),
            min(int(max_iters), 2**31 - 1), m, V.data_ptr(), codes[2],
            x.data_ptr(), u.data_ptr(), part.data_ptr(), hd.data_ptr(), blocks,
            it_conv.data_ptr(), rr.data_ptr(), it_conv[1:].data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "pell_gmres_fused")
    pell_gmres_fused.launches += 1
    return x, it_conv[0], rr[0], it_conv[1] != 0


pell_gmres_fused.launches = 0


def gmres_fused_multi(diags, offsets, b, x0, minv=None, *, m, tol_sq_eff, max_iters,
                      basis_dtype=torch.float32):
    """K15m: restarted GMRES(m) on 2 to 4 right-hand sides in one kernel,
    with per-column stopping.  diags: (nd, n) float32/bfloat16; b, x0: (n,
    k) float32 row-major; minv: (n,) or None; tol_sq_eff: (k,) squared
    thresholds; m <= MAX_FUSED_KRYLOV_DIM_MULTI; basis_dtype: float32 or
    bfloat16 (the basis is (m+1, n, k) in device memory).  Returns (x,
    iterations, true r.r (k,), converged (k,), stop_iterations (k,)) as
    device tensors."""
    if on_cpu(b):
        return gmres_solve_multi_reference(
            diags, offsets, b, x0, minv, m=m, tol_sq_eff=tol_sq_eff,
            max_iters=max_iters, basis_dtype=basis_dtype,
        )
    dev = b.device
    m = int(m)
    if b.dim() != 2 or not 2 <= b.shape[1] <= MAX_FUSED_GMRES_COLS:
        raise ValueError(f"gmres_fused_multi: takes (n, k) with 2 <= k <= {MAX_FUSED_GMRES_COLS}")
    if not 1 <= m <= MAX_FUSED_KRYLOV_DIM_MULTI:
        raise ValueError(f"gmres_fused_multi: takes 1 <= m <= {MAX_FUSED_KRYLOV_DIM_MULTI}, got {m}")
    if basis_dtype not in BASIS_DTYPES:
        raise TypeError(f"gmres_fused_multi: the basis must be float32/bfloat16, got {basis_dtype}")
    k = b.shape[1]
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(-1)
    tol = tol.expand(k).contiguous()
    check_fused_diags(diags, offsets, dev, "gmres_fused_multi")
    n = diags.shape[1]
    check_solve_vectors("gmres_fused_multi", (n, k), dev, (b, x0), minv, tol, k)
    lib = _lib()
    dcode, vcode = DTYPE_CODE[diags.dtype], DTYPE_CODE[basis_dtype]
    blocks = coop_grid_blocks(lib, "gmres_fused_multi_grid", (dcode, vcode, k, m), dev)
    V = torch.empty((m + 1, n, k), dtype=basis_dtype, device=dev)
    x = torch.empty_like(b)
    u = torch.empty_like(b)
    part = torch.empty((m + 4) * k * blocks, dtype=torch.float64, device=dev)
    hd = torch.empty((m + 1) * k, dtype=torch.float64, device=dev)
    ints = torch.empty(1 + 2 * k, dtype=torch.int32, device=dev)  # it, conv, itc
    rr = torch.empty(k, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.gmres_fused_multi_solve(
            diags.data_ptr(), dcode, offsets_array(offsets), len(offsets), n, k,
            b.data_ptr(), x0.data_ptr(), None if minv is None else minv.data_ptr(),
            tol.data_ptr(), min(int(max_iters), 2**31 - 1), m, V.data_ptr(), vcode,
            x.data_ptr(), u.data_ptr(), part.data_ptr(), hd.data_ptr(), blocks,
            ints.data_ptr(), rr.data_ptr(), ints[1:].data_ptr(), ints[1 + k:].data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "gmres_fused_multi")
    gmres_fused_multi.launches += 1
    return x, ints[0], rr, ints[1:1 + k] != 0, ints[1 + k:]


gmres_fused_multi.launches = 0
