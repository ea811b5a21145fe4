"""Whole-solve fused IR / Richardson (damped Jacobi): kernel K17 and its plain
versions.

Counterpart of ``ginkgo_tpu/ops/pallas_ir.py``: one TPU site
(``_common_call``, :211) with two kernels over one set of passes
(``_make_passes``, :63-88), and so one CUDA source (``csrc/ir_fused.cu``)
with two entry points over shared passes:

- :func:`ir_fused` (``_ir_kernel``, :150-204): sweeps to the stop test;
- :func:`ir_smooth` (``_smooth_kernel``, :91-147): a fixed number of
  sweeps, as multigrid's fixed smoother runs them.

A sweep is the update pass x += omega M r (M: an inverse diagonal or the
identity), then the residual pass r = b - A x; r is recomputed from b every
sweep, never updated.  In ``ir_fused`` the monitor starts at +inf, so the
first sweep always runs, and the loop runs while it < max_iters and
``not (r.r <= tol_sq_eff)``, r.r of the residual after the sweep (a NaN
keeps sweeping); the reported r.r is the last sweep's, or r0's when
max_iters is 0.  The sweep loop exists once, :func:`ir_loop_reference`
over an SpMV; K21's plain version (``ops/pell_cg.py``) runs it on a Pell,
with the monitor starting at r0's r.r as the TPU Pell kernel's does.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .cg import _dots, check_fused_diags, check_solve_vectors, coop_grid_blocks
from .dia import DTYPE_CODE, check_status, dia_spmv_reference, offsets_array, on_cpu


def _passes(spmv, b, minv, omega):
    """The two passes of a sweep, as plain tensor ops over the product
    ``spmv``."""
    om = torch.tensor(omega, dtype=torch.float32).to(b.device)
    mv = None if minv is None else minv.to(torch.float32)

    def resid(x):
        return b - spmv(x)

    def update(x, r):
        return x + om * (r if mv is None else mv * r)

    return resid, update


def _dia(diags, offsets, n):
    return lambda v: dia_spmv_reference(diags, offsets, v, n)


def ir_loop_reference(spmv, b, x0, minv=None, *, omega, tol_sq_eff, max_iters,
                      monitor_from_r0=False):
    """The sweeps to the stop test, pass by pass as K17 and K21, for any
    operator.  spmv: (n,) -> (n,) float32; b, x0, minv: (n,) float32.  The
    monitor starts at +inf, so the first sweep always runs (K17), or with
    ``monitor_from_r0`` at r0's r.r, so an r0 at the threshold runs none
    (K21, the TPU Pell kernel's rule).  Returns (x, r, iterations int32,
    r.r float32, converged)."""
    dev = b.device
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(())
    resid, update = _passes(spmv, b, minv, omega)
    x = x0.clone()
    r = resid(x)
    rr = _dots(r, r)
    mon = rr if monitor_from_r0 else torch.full((), float("inf"), dtype=torch.float32,
                                                device=dev)
    it = 0
    # the loop condition reads the monitor on the host once per sweep
    while it < max_iters and not bool(mon <= tol):
        x = update(x, r)
        r = resid(x)
        rr = _dots(r, r)
        mon = rr
        it += 1
    iters = torch.tensor(it, dtype=torch.int32, device=dev)
    return x, r, iters, rr, rr <= tol


def ir_solve_reference(diags, offsets, b, x0, minv=None, *, omega, tol_sq_eff, max_iters):
    """K17's plain version of ``ir_fused``.  diags: (nd, n); b, x0, minv:
    (n,) float32.  Returns (x, r, iterations int32, r.r float32,
    converged)."""
    return ir_loop_reference(_dia(diags, offsets, b.shape[0]), b, x0, minv, omega=omega,
                             tol_sq_eff=tol_sq_eff, max_iters=max_iters)


def ir_smooth_reference(diags, offsets, b, x0=None, minv=None, *, omega, iters,
                        with_residual=False):
    """K17's plain version of ``ir_smooth``: x0 None starts from zero with
    r = b (no product); with ``with_residual`` every sweep ends with
    r = b - A x, else iters - 1 sweeps and a last update.  Returns (x, r)."""
    resid, update = _passes(_dia(diags, offsets, b.shape[0]), b, minv, omega)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b.clone() if x0 is None else resid(x)
    sweeps = iters if with_residual else max(iters - 1, 0)
    for _ in range(sweeps):
        x = update(x, r)
        r = resid(x)
    if not with_residual and iters > 0:
        x = update(x, r)
    return x, r


def _lib():
    lib = _build.load("ir_fused")
    if not hasattr(lib, "gk_typed"):
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        offs, blocks = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
        lib.ir_fused_grid.argtypes = [I, blocks]
        lib.ir_fused_solve.argtypes = [
            P, I, offs, I, L,  # diags, offsets, n
            P, P, P, P, F, I,  # b, x0, minv, tol_sq, omega, max_iters
            P, P, P, I,  # x, r, partials, blocks
            P, P, P, P,  # it_out, rr_out, conv_out, stream
        ]
        lib.ir_smooth.argtypes = [
            P, I, offs, I, L,  # diags, offsets, n
            P, P, P, F, I, I,  # b, x0 (or null), minv, omega, iters, with_residual
            P, P, I, P,  # x, r, blocks, stream
        ]
        lib.pell_ir_fused_grid.argtypes = [I, I, blocks]
        lib.pell_ir_fused_solve.argtypes = [
            P, I, P, I, P, P, I, I, L,  # values, qidx, bases, tile_ptr, S, G, n
            P, P, P, P, F, I,  # b, x0, minv, tol_sq, omega, max_iters
            P, P, P, I,  # x, r, partials, blocks
            P, P, P, P,  # it_out, rr_out, conv_out, stream
        ]
        for fn in (lib.ir_fused_grid, lib.ir_fused_solve, lib.ir_smooth,
                   lib.pell_ir_fused_grid, lib.pell_ir_fused_solve):
            fn.restype = I
        lib.gk_error_string.argtypes = [I]
        lib.gk_error_string.restype = ctypes.c_char_p
        lib.gk_typed = True
    return lib


def ir_fused(diags, offsets, b, x0, minv=None, *, omega, tol_sq_eff, max_iters):
    """K17: run IR/Richardson sweeps to the stop test in one kernel.  diags:
    (nd, n) float32/bfloat16; b, x0, minv: (n,) float32; omega: the
    relaxation factor; tol_sq_eff: the squared absolute threshold on r.r
    (negative: run to max_iters), a float32 tensor on the device.  Returns
    (x, r, iterations int32, r.r float32, converged bool) as device
    tensors."""
    if on_cpu(b):
        return ir_solve_reference(diags, offsets, b, x0, minv, omega=omega,
                                  tol_sq_eff=tol_sq_eff, max_iters=max_iters)
    dev = b.device
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(1).contiguous()
    check_fused_diags(diags, offsets, dev, "ir_fused")
    n = diags.shape[1]
    check_solve_vectors("ir_fused", (n,), dev, (b, x0), minv, tol, 1)
    lib = _lib()
    blocks = coop_grid_blocks(lib, "ir_fused_grid", (DTYPE_CODE[diags.dtype],), dev)
    x = torch.empty_like(b)
    r = torch.empty_like(b)
    part = torch.empty(blocks, dtype=torch.float64, device=dev)
    it_conv = torch.empty(2, dtype=torch.int32, device=dev)
    rr = torch.empty(1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.ir_fused_solve(
            diags.data_ptr(), DTYPE_CODE[diags.dtype], offsets_array(offsets), len(offsets),
            n, b.data_ptr(), x0.data_ptr(), None if minv is None else minv.data_ptr(),
            tol.data_ptr(), float(omega), min(int(max_iters), 2**31 - 1),
            x.data_ptr(), r.data_ptr(), part.data_ptr(), blocks, it_conv.data_ptr(),
            rr.data_ptr(), it_conv[1:].data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "ir_fused")
    ir_fused.launches += 1
    return x, r, it_conv[0], rr[0], it_conv[1] != 0


ir_fused.launches = 0


def ir_smooth(diags, offsets, b, x0=None, minv=None, *, omega, iters, with_residual=False):
    """K17's fixed-sweep entry point: ``iters`` damped Richardson/Jacobi
    sweeps in one kernel.  x0: (n,) float32, or None to start from zero
    (then r0 = b and the first product is skipped).  Returns (x, r).

    With ``with_residual`` r is b - A x of the returned x.  Without it the
    kernel runs iters - 1 full sweeps and one last update only, so r is the
    residual from before that update: its content is not the residual of x
    and callers must not use it.  ``iters = 0`` returns x0 (or zeros)."""
    if on_cpu(b):
        return ir_smooth_reference(diags, offsets, b, x0, minv, omega=omega, iters=iters,
                                   with_residual=with_residual)
    dev = b.device
    if int(iters) < 0:
        raise ValueError(f"ir_smooth: iters must be >= 0, got {iters}")
    check_fused_diags(diags, offsets, dev, "ir_smooth")
    n = diags.shape[1]
    vecs = (b,) if x0 is None else (b, x0)
    check_solve_vectors("ir_smooth", (n,), dev, vecs, minv,
                        torch.zeros(1, dtype=torch.float32, device=dev), 1)
    lib = _lib()
    blocks = coop_grid_blocks(lib, "ir_fused_grid", (DTYPE_CODE[diags.dtype],), dev)
    x = torch.empty_like(b)
    r = torch.empty_like(b)
    with torch.cuda.device(dev):
        status = lib.ir_smooth(
            diags.data_ptr(), DTYPE_CODE[diags.dtype], offsets_array(offsets), len(offsets),
            n, b.data_ptr(), None if x0 is None else x0.data_ptr(),
            None if minv is None else minv.data_ptr(), float(omega), int(iters),
            int(bool(with_residual)), x.data_ptr(), r.data_ptr(), blocks,
            torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "ir_smooth")
    ir_smooth.launches += 1
    return x, r


ir_smooth.launches = 0
