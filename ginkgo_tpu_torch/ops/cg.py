"""Whole-solve fused CG/FCG: kernel K4 and its plain version.

Counterpart of ``ginkgo_tpu/ops/pallas_cg.py`` ``cg_vmem_solve``.  The
whole Krylov loop, with an Identity or inverse-diagonal preconditioner and
the stop test, runs in one persistent cooperative CUDA kernel
(``csrc/cg_fused.cu``); the iteration count never reaches the host during
the solve.

Semantics, shared by the kernel and :func:`cg_solve_reference`:

- the monitor starts at +inf, so the first iteration always runs;
- the loop runs while ``it < max_iters and not (mon <= tol_sq_eff)``: a
  NaN monitor keeps iterating and a negative ``tol_sq_eff`` runs to
  ``max_iters``;
- exact mode monitors r.r after the update, implicit mode |rho| before it;
- zero denominators give 0;
- ``flexible=True`` is FCG's Polak-Ribiere beta, (r_new - r_old).z / rho.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .dia import (
    DTYPE_CODE,
    MAX_DIAGS,
    check_status,
    dia_spmv_reference,
    offsets_array,
    on_cpu,
)

FUSED_DIAG_DTYPES = (torch.float32, torch.bfloat16)


def _sdiv(num, den):
    """num/den with den == 0 mapping to 0 (pallas_cg._sdiv)."""
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)), 0.0)


def _dot(a, b):
    """float32 dot product summed in float64 and rounded to float32, as the
    kernel sums its partials."""
    return torch.sum(a.to(torch.float64) * b.to(torch.float64)).to(torch.float32)


def cg_solve_reference(diags, offsets, r0, x0, minv=None, *, tol_sq_eff,
                       max_iters, use_implicit=False, flexible=False):
    """The fused solve with plain tensor ops.  r0, x0, minv: (n,) float32.
    Returns (x, r, iterations int32, monitored_sq float32, converged)."""
    n = r0.shape[0]
    dev = r0.device
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(())
    mv = None if minv is None else minv.to(torch.float32)

    def precond(v):
        return v if mv is None else mv * v

    x = x0.clone()
    r = r0.clone()
    z = precond(r)
    p = z.clone()
    rho = _dot(r, z)
    it = 0
    mon = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    # the loop condition reads the monitor on the host once per iteration
    while it < max_iters and not bool(mon <= tol):
        q = dia_spmv_reference(diags, offsets, p, n)
        alpha = _sdiv(rho, _dot(p, q))
        x = x + alpha * p
        r_old = r
        r = r_old - alpha * q
        z = precond(r)
        rho_new = _dot(r, z)
        rr_new = _dot(r, r)
        num = _dot(r - r_old, z) if flexible else rho_new
        beta = _sdiv(num, rho)
        p = z + beta * p
        mon = torch.abs(rho) if use_implicit else rr_new
        rho = rho_new
        it += 1
    iters = torch.tensor(it, dtype=torch.int32, device=dev)
    return x, r, iters, mon, mon <= tol


def _lib():
    lib = _build.load("cg_fused")
    if not hasattr(lib, "gk_typed"):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.cg_fused_grid.argtypes = [I, ctypes.POINTER(ctypes.c_int)]
        lib.cg_fused_grid.restype = I
        lib.cg_fused_solve.argtypes = [
            P, I, ctypes.POINTER(ctypes.c_longlong), I, L,  # diags, offsets, n
            P, P, P, P,  # r0, x0, minv, tol_sq
            I, I, I,  # max_iters, implicit, flexible
            P, P, P, P, P, I,  # x, r, p, q, partials, blocks
            P, P, P, P,  # it_out, mon_out, conv_out, stream
        ]
        lib.cg_fused_solve.restype = I
        lib.gk_error_string.argtypes = [I]
        lib.gk_error_string.restype = ctypes.c_char_p
        lib.gk_typed = True
    return lib


_GRID_BLOCKS: dict = {}


def _grid_blocks(lib, dtype, device) -> int:
    key = (device.index, dtype)
    if key not in _GRID_BLOCKS:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(device):
            status = lib.cg_fused_grid(DTYPE_CODE[dtype], ctypes.byref(blocks))
        check_status(lib, status, "cg_fused_grid")
        _GRID_BLOCKS[key] = blocks.value
    return _GRID_BLOCKS[key]


def _check_cg_operands(diags, offsets, r0, x0, minv, tol):
    dev = r0.device
    if diags.device != dev or x0.device != dev or tol.device != dev:
        raise RuntimeError("cg_fused: all operands must be on one device")
    if diags.dtype not in FUSED_DIAG_DTYPES:
        raise TypeError(f"cg_fused: diagonals must be float32/bfloat16, got {diags.dtype}")
    if diags.dim() != 2 or diags.shape[0] != len(offsets):
        raise ValueError("cg_fused: diags must be (nd, n) with nd = len(offsets)")
    if not 1 <= len(offsets) <= MAX_DIAGS:
        raise ValueError(f"cg_fused: takes 1 to {MAX_DIAGS} diagonals, got {len(offsets)}")
    n = diags.shape[1]
    vecs = [r0, x0] + ([] if minv is None else [minv])
    for v in vecs:
        if v.dtype != torch.float32 or v.shape != (n,) or not v.is_contiguous():
            raise ValueError(f"cg_fused: vectors must be contiguous float32 ({n},)")
    if minv is not None and minv.device != dev:
        raise RuntimeError("cg_fused: minv on another device")
    if tol.dtype != torch.float32 or tol.numel() != 1:
        raise ValueError("cg_fused: tol_sq_eff must be one float32")
    if not diags.is_contiguous():
        raise ValueError("cg_fused: diags must be contiguous")


def cg_fused(diags, offsets, r0, x0, minv=None, *, tol_sq_eff, max_iters,
             use_implicit=False, flexible=False):
    """K4: run CG (FCG with ``flexible=True``) to the stop test in one
    kernel.  diags: (nd, n) float32/bfloat16; r0, x0, minv: (n,) float32;
    tol_sq_eff: squared absolute threshold on r.r (|rho| when
    ``use_implicit``), a float32 tensor on the device so no host sync is
    needed.  Returns (x, r, iterations int32, monitored_sq float32,
    converged bool) as device tensors."""
    if on_cpu(r0):
        return cg_solve_reference(
            diags, offsets, r0, x0, minv, tol_sq_eff=tol_sq_eff,
            max_iters=max_iters, use_implicit=use_implicit, flexible=flexible,
        )
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=r0.device)
    _check_cg_operands(diags, offsets, r0, x0, minv, tol)
    lib = _lib()
    dev = r0.device
    n = diags.shape[1]
    blocks = _grid_blocks(lib, diags.dtype, dev)
    x = torch.empty_like(r0)
    r = torch.empty_like(r0)
    p = torch.empty_like(r0)
    q = torch.empty_like(r0)
    part = torch.empty(4 * blocks, dtype=torch.float64, device=dev)
    it_conv = torch.empty(2, dtype=torch.int32, device=dev)
    mon = torch.empty(1, dtype=torch.float32, device=dev)
    tol = tol.reshape(1).contiguous()
    with torch.cuda.device(dev):
        status = lib.cg_fused_solve(
            diags.data_ptr(), DTYPE_CODE[diags.dtype], offsets_array(offsets),
            len(offsets), n, r0.data_ptr(), x0.data_ptr(),
            None if minv is None else minv.data_ptr(), tol.data_ptr(),
            min(int(max_iters), 2**31 - 1), int(bool(use_implicit)),
            int(bool(flexible)),
            x.data_ptr(), r.data_ptr(), p.data_ptr(), q.data_ptr(),
            part.data_ptr(), blocks, it_conv.data_ptr(),
            mon.data_ptr(), it_conv[1:].data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "cg_fused")
    cg_fused.launches += 1
    return x, r, it_conv[0], mon[0], it_conv[1] != 0


cg_fused.launches = 0
