"""Whole-solve fused CGS and BiCG: kernels K13 and K14 and their plain
versions.

Counterpart of ``ginkgo_tpu/ops/pallas_cgs.py`` ``cgs_vmem_solve``
(``_cgs_kernel``, :61-178) and ``bicg_vmem_solve`` (``_bicg_kernel``,
:266-390); both kernels are in ``csrc/cgs_fused.cu``.

- CGS runs on A M with a diagonal M folded into the diagonals
  (``solver/_fused_gate.fold_minv``); ``minv`` is applied only in the x
  update, x += alpha minv (u + q).  The loop exists once,
  :func:`cgs_loop_reference` over an SpMV; K20's plain version
  (``ops/pell_cg.py``) runs it on a Pell.
- BiCG takes A's diagonals and those of A^H (the ``Dia`` conjugate
  transpose: offsets negated) and runs both products in one pass; a real
  diagonal M is its own M^H, so z = M r and z2 = M r2.

Semantics shared by the kernels and the plain versions: the monitor starts
at +inf and the loop runs while it < max_iters and ``not (mon <=
tol_sq_eff)`` (a NaN monitor keeps iterating); exact mode monitors r.r
after the update, implicit mode |rho| from before it; zero denominators
give 0.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..log.logger import logged_kernel
from .cg import _dots, _sdiv, check_fused_diags, check_solve_vectors, coop_grid_blocks
from .dia import DTYPE_CODE, check_status, dia_spmv_reference, offsets_array, on_cpu


def _start(r0, tol_sq_eff):
    dev = r0.device
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(())
    mon = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    return tol, mon, torch.ones((), dtype=torch.float32, device=dev)


def cgs_loop_reference(spmv, r0, x0, minv=None, *, tol_sq_eff, max_iters,
                       use_implicit=False):
    """The whole CGS solve in K13's and K20's operations, for any operator.
    spmv: (n,) -> (n,) float32, A M in either form (folded, or M applied
    before A); minv: (n,) or None, applied in the x update; r0, x0: (n,)
    float32.  Returns (x, r, iterations int32, monitored_sq float32,
    converged)."""
    tol, mon, rho_old = _start(r0, tol_sq_eff)
    mv = None if minv is None else minv.to(torch.float32)

    x = x0.clone()
    r = r0.clone()
    rr = r0.clone()
    q = torch.zeros_like(r0)
    p = torch.zeros_like(r0)
    rho_new = _dots(r, r)
    it = 0
    # the loop condition reads the monitor on the host once per iteration
    while it < max_iters and not bool(mon <= tol):
        beta = _sdiv(rho_new, rho_old)
        u = r + beta * q
        p = u + beta * (q + beta * p)
        v = spmv(p)
        alpha = _sdiv(rho_new, _dots(rr, v))
        q = u - alpha * v
        w = u + q
        t = spmv(w)
        x = x + alpha * (w if mv is None else mv * w)
        r = r - alpha * t
        rho_next = _dots(rr, r)
        mon = torch.abs(rho_new) if use_implicit else _dots(r, r)
        rho_old, rho_new = rho_new, rho_next
        it += 1
    iters = torch.tensor(it, dtype=torch.int32, device=r0.device)
    return x, r, iters, mon, mon <= tol


def cgs_solve_reference(diags, offsets, r0, x0, minv=None, *, tol_sq_eff, max_iters,
                        use_implicit=False):
    """K13's plain version.  diags: (nd, n) of A M; r0, x0, minv: (n,)
    float32.  Returns (x, r, iterations int32, monitored_sq float32,
    converged)."""
    n = r0.shape[0]
    return cgs_loop_reference(
        lambda v: dia_spmv_reference(diags, offsets, v, n), r0, x0, minv,
        tol_sq_eff=tol_sq_eff, max_iters=max_iters, use_implicit=use_implicit,
    )


def bicg_solve_reference(diags, offsets, diags_t, offsets_t, r0, x0, minv=None, *,
                         tol_sq_eff, max_iters, use_implicit=False):
    """K14's plain version, pass by pass as the kernel.  diags/offsets: A;
    diags_t/offsets_t: A^H; r0, x0, minv: (n,) float32.  Returns (x, r,
    iterations int32, monitored_sq float32, converged)."""
    n = r0.shape[0]
    tol, mon, rho_old = _start(r0, tol_sq_eff)
    mv = None if minv is None else minv.to(torch.float32)

    def precond(v):
        return v if mv is None else mv * v

    x = x0.clone()
    r = r0.clone()
    r2 = r0.clone()
    p = torch.zeros_like(r0)
    p2 = torch.zeros_like(r0)
    rho_new = _dots(r, precond(r))
    it = 0
    while it < max_iters and not bool(mon <= tol):
        beta = _sdiv(rho_new, rho_old)
        p = precond(r) + beta * p
        p2 = precond(r2) + beta * p2
        q = dia_spmv_reference(diags, offsets, p, n)
        q2 = dia_spmv_reference(diags_t, offsets_t, p2, n)
        alpha = _sdiv(rho_new, _dots(p2, q))
        x = x + alpha * p
        r = r - alpha * q
        r2 = r2 - alpha * q2
        rho_next = _dots(r2, precond(r))
        mon = torch.abs(rho_new) if use_implicit else _dots(r, r)
        rho_old, rho_new = rho_new, rho_next
        it += 1
    iters = torch.tensor(it, dtype=torch.int32, device=r0.device)
    return x, r, iters, mon, mon <= tol


def _lib():
    lib = _build.load("cgs_fused")
    if not hasattr(lib, "gk_typed"):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        offs, blocks = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
        lib.cgs_fused_grid.argtypes = [I, blocks]
        lib.cgs_fused_config.argtypes = [I, blocks]
        lib.bicg_fused_grid.argtypes = [I, I, blocks]
        lib.bicg_fused_config.argtypes = [I, I, blocks]
        lib.cgs_fused_solve.argtypes = [
            P, I, offs, I, L,  # diags, offsets, n
            P, P, P, P,  # r0, x0, minv, tol_sq
            I, I,  # max_iters, implicit
            P, P, P, P, P, P, P,  # x, r, rr, q, u, v, p
            P, I,  # partials, blocks
            P, P, P, P,  # it_out, mon_out, conv_out, stream
        ]
        lib.bicg_fused_solve.argtypes = [
            P, I, offs, I,  # diags, offsets of A
            P, I, offs, I,  # diags, offsets of A^H
            L, P, P, P, P,  # n, r0, x0, minv, tol_sq
            I, I,  # max_iters, implicit
            P, P, P, P, P, P, P,  # x, r, r2, q, q2, p, p2
            P, I,  # partials, blocks
            P, P, P, P,  # it_out, mon_out, conv_out, stream
        ]
        lib.pell_cgs_fused_grid.argtypes = [I, I, blocks]
        lib.pell_cgs_fused_config.argtypes = [I, I, blocks]
        lib.pell_cgs_fused_solve.argtypes = [
            P, I, P, I, P, P, I, I, L,  # values, qidx, bases, tile_ptr, S, G, n
            P, P, P, P,  # r0, x0, minv, tol_sq
            I, I,  # max_iters, implicit
            P, P, P, P, P, P, P, P, P,  # x, r, rr, q, u, v, p, w (M w), y (M p with Jacobi)
            P, I,  # partials, blocks
            P, P, P, P,  # it_out, mon_out, conv_out, stream
        ]
        for fn in (lib.cgs_fused_grid, lib.cgs_fused_config, lib.bicg_fused_grid,
                   lib.bicg_fused_config, lib.cgs_fused_solve,
                   lib.bicg_fused_solve, lib.pell_cgs_fused_grid, lib.pell_cgs_fused_config,
                   lib.pell_cgs_fused_solve):
            fn.restype = I
        lib.gk_error_string.argtypes = [I]
        lib.gk_error_string.restype = ctypes.c_char_p
        lib.gk_typed = True
    return lib


def _outputs(r0, blocks, n_vec):
    dev = r0.device
    vecs = [torch.empty_like(r0) for _ in range(n_vec)]
    part = torch.empty(3 * blocks, dtype=torch.float64, device=dev)
    it_conv = torch.empty(2, dtype=torch.int32, device=dev)
    mon = torch.empty(1, dtype=torch.float32, device=dev)
    return vecs, part, it_conv, mon


@logged_kernel
def cgs_fused(diags, offsets, r0, x0, minv=None, *, tol_sq_eff, max_iters,
              use_implicit=False):
    """K13: run CGS to the stop test in one kernel.  diags: (nd, n)
    float32/bfloat16 of A M; r0, x0, minv: (n,) float32; tol_sq_eff: a
    float32 tensor on the device.  Returns (x, r, iterations int32,
    monitored_sq float32, converged bool) as device tensors."""
    if on_cpu(r0):
        return cgs_solve_reference(
            diags, offsets, r0, x0, minv, tol_sq_eff=tol_sq_eff,
            max_iters=max_iters, use_implicit=use_implicit,
        )
    dev = r0.device
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(1).contiguous()
    check_fused_diags(diags, offsets, dev, "cgs_fused")
    n = diags.shape[1]
    check_solve_vectors("cgs_fused", (n,), dev, (r0, x0), minv, tol, 1)
    lib = _lib()
    code = DTYPE_CODE[diags.dtype]
    blocks = coop_grid_blocks(lib, "cgs_fused_grid", (code,), dev)
    vecs, part, it_conv, mon = _outputs(r0, blocks, 7)
    with torch.cuda.device(dev):
        status = lib.cgs_fused_solve(
            diags.data_ptr(), code, offsets_array(offsets), len(offsets), n,
            r0.data_ptr(), x0.data_ptr(), None if minv is None else minv.data_ptr(),
            tol.data_ptr(), min(int(max_iters), 2**31 - 1), int(bool(use_implicit)),
            *(v.data_ptr() for v in vecs), part.data_ptr(), blocks,
            it_conv.data_ptr(), mon.data_ptr(), it_conv[1:].data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "cgs_fused")
    cgs_fused.launches += 1
    return vecs[0], vecs[1], it_conv[0], mon[0], it_conv[1] != 0


cgs_fused.launches = 0


@logged_kernel
def bicg_fused(diags, offsets, diags_t, offsets_t, r0, x0, minv=None, *, tol_sq_eff,
               max_iters, use_implicit=False):
    """K14: run BiCG to the stop test in one kernel.  diags/offsets: A;
    diags_t/offsets_t: A^H, each (nd, n) float32/bfloat16; r0, x0, minv:
    (n,) float32.  Returns (x, r, iterations int32, monitored_sq float32,
    converged bool) as device tensors."""
    if on_cpu(r0):
        return bicg_solve_reference(
            diags, offsets, diags_t, offsets_t, r0, x0, minv, tol_sq_eff=tol_sq_eff,
            max_iters=max_iters, use_implicit=use_implicit,
        )
    dev = r0.device
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(1).contiguous()
    check_fused_diags(diags, offsets, dev, "bicg_fused")
    check_fused_diags(diags_t, offsets_t, dev, "bicg_fused")
    n = diags.shape[1]
    if diags_t.shape[1] != n:
        raise ValueError("bicg_fused: A and A^H must have the same rows")
    check_solve_vectors("bicg_fused", (n,), dev, (r0, x0), minv, tol, 1)
    lib = _lib()
    codes = (DTYPE_CODE[diags.dtype], DTYPE_CODE[diags_t.dtype])
    blocks = coop_grid_blocks(lib, "bicg_fused_grid", codes, dev)
    vecs, part, it_conv, mon = _outputs(r0, blocks, 7)
    with torch.cuda.device(dev):
        status = lib.bicg_fused_solve(
            diags.data_ptr(), codes[0], offsets_array(offsets), len(offsets),
            diags_t.data_ptr(), codes[1], offsets_array(offsets_t), len(offsets_t),
            n, r0.data_ptr(), x0.data_ptr(), None if minv is None else minv.data_ptr(),
            tol.data_ptr(), min(int(max_iters), 2**31 - 1), int(bool(use_implicit)),
            *(v.data_ptr() for v in vecs), part.data_ptr(), blocks,
            it_conv.data_ptr(), mon.data_ptr(), it_conv[1:].data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "bicg_fused")
    bicg_fused.launches += 1
    return vecs[0], vecs[1], it_conv[0], mon[0], it_conv[1] != 0


bicg_fused.launches = 0
