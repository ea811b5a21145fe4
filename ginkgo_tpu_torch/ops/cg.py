"""Whole-solve fused CG/FCG: kernels K4 and K4m and their plain version.

Counterpart of ``ginkgo_tpu/ops/pallas_cg.py`` ``cg_vmem_solve`` (K4, one
right-hand side) and ``cg_vmem_solve_multi`` (K4m, 2 to 8 right-hand sides
with per-column stopping).  The whole Krylov loop, with an Identity or
inverse-diagonal preconditioner and the stop test, runs in one persistent
cooperative CUDA kernel (``csrc/cg_fused.cu``); the iteration count never
reaches the host during the solve.  K4m takes two passes and two grid
barriers an iteration: it folds the direction update p = z + beta p into
the next iteration's SpMV, with p in two alternating buffers.  K4 keeps
three passes, which ran faster on the card at one column.

Semantics, shared by the kernels and :func:`cg_loop_reference`:

- the monitor starts at +inf, so the first iteration always runs;
- a column stays active while ``not (mon <= tol_sq_eff)``: a NaN monitor
  keeps iterating and a negative threshold runs to ``max_iters``; the loop
  runs while ``it < max_iters`` and any column is active;
- exact mode monitors r.r after the update, implicit mode |rho| before it;
- zero denominators give 0;
- ``flexible=True`` is FCG's Polak-Ribiere beta, (r_new - r_old).z / rho;
- a stopped column gets alpha = 0 and a frozen p, and records the
  iteration at which it stopped.
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
#: most right-hand sides K4m takes (ginkgo_tpu's k-RHS kernel has the same cap)
MAX_FUSED_COLS = 8


def _sdiv(num, den):
    """num/den with den == 0 mapping to 0 (pallas_cg._sdiv)."""
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)), 0.0)


def _sqrt(v):
    """Square root in v's real dtype, correctly rounded as the kernels'
    sqrtf is: taken in float64 and rounded once to float32, which is exact
    for a square root (53 >= 2 * 24 + 2 bits).  PyTorch's float32 sqrt on
    the CPU, where the plain versions do their scalar work, misrounds some
    inputs by an ulp."""
    return torch.sqrt(v.to(torch.float64)).to(v.dtype)


def _dots(a, b):
    """Column-wise float32 dot products of (n, k) operands, summed in
    float64 and rounded to float32, as the kernels sum their partials."""
    return torch.sum(a.to(torch.float64) * b.to(torch.float64), dim=0).to(torch.float32)


def cg_loop_reference(spmv, r0, x0, minv=None, *, tol_sq_eff, max_iters,
                      use_implicit=False, flexible=False):
    """The fused solve with plain tensor ops, for any operator.

    spmv: (n, k) -> (n, k) float32 product with A; r0, x0: (n, k) float32;
    minv: (n,) inverse diagonal or None; tol_sq_eff: one or k squared
    thresholds.  Returns (x, r, iterations int32, monitored_sq (k,),
    converged (k,), stop_iterations (k,) int32)."""
    k = r0.shape[1]
    dev = r0.device
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(-1)
    mv = None if minv is None else minv.to(torch.float32)[:, None]

    def precond(v):
        return v if mv is None else mv * v

    x = x0.clone()
    r = r0.clone()
    z = precond(r)
    p = z.clone()
    rho = _dots(r, z)
    it = 0
    act = torch.ones(k, dtype=torch.bool, device=dev)
    itc = torch.zeros(k, dtype=torch.int32, device=dev)
    mon = torch.full((k,), float("inf"), dtype=torch.float32, device=dev)
    # the loop condition reads the stop flags on the host once per iteration
    while it < max_iters and bool(act.any()):
        q = spmv(p)
        alpha = torch.where(act, _sdiv(rho, _dots(p, q)), 0.0)
        x = x + alpha * p
        r_old = r
        r = r_old - alpha * q
        z = precond(r)
        rho_new = _dots(r, z)
        rr_new = _dots(r, r)
        num = _dots(r - r_old, z) if flexible else rho_new
        beta = _sdiv(num, rho)
        p = torch.where(act, z + beta * p, p)
        mon = torch.abs(rho) if use_implicit else rr_new
        itc = torch.where(act, it + 1, itc).to(torch.int32)
        act = act & ~(mon <= tol)
        rho = rho_new
        it += 1
    iters = torch.tensor(it, dtype=torch.int32, device=dev)
    return x, r, iters, mon, mon <= tol, itc


def cg_solve_reference(diags, offsets, r0, x0, minv=None, *, tol_sq_eff,
                       max_iters, use_implicit=False, flexible=False):
    """K4's plain version.  r0, x0, minv: (n,) float32.  Returns (x, r,
    iterations int32, monitored_sq float32, converged)."""
    n = r0.shape[0]
    x, r, it, mon, conv, _ = cg_loop_reference(
        lambda v: dia_spmv_reference(diags, offsets, v, n), r0[:, None],
        x0[:, None], minv, tol_sq_eff=tol_sq_eff, max_iters=max_iters,
        use_implicit=use_implicit, flexible=flexible,
    )
    return x[:, 0], r[:, 0], it, mon[0], conv[0]


def cg_multi_solve_reference(diags, offsets, r0, x0, minv=None, *, tol_sq_eff,
                             max_iters, use_implicit=False, flexible=False):
    """K4m's plain version.  r0, x0: (n, k) float32; tol_sq_eff: (k,).
    Returns (x, r, iterations, monitored_sq (k,), converged (k,),
    stop_iterations (k,))."""
    n = r0.shape[0]
    return cg_loop_reference(
        lambda v: dia_spmv_reference(diags, offsets, v, n), r0, x0, minv,
        tol_sq_eff=tol_sq_eff, max_iters=max_iters, use_implicit=use_implicit,
        flexible=flexible,
    )


def _lib():
    lib = _build.load("cg_fused")
    if not hasattr(lib, "gk_typed"):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        offs, ints = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
        lib.cg_fused_grid.argtypes = [I, I, ints]
        lib.cg_fused_config.argtypes = [I, I, ints]
        lib.cg_fused_solve.argtypes = [
            P, I, offs, I, L, I,  # diags, offsets, n, k
            P, P, P, P,  # r0, x0, minv, tol_sq
            I, I, I,  # max_iters, implicit, flexible
            P, P, P, P, P, P, I,  # x, r, p0, p1, q, partials, blocks
            P, P, P, P, P,  # it_out, mon_out, conv_out, itc_out, stream
        ]
        for fn in (lib.cg_fused_grid, lib.cg_fused_config, lib.cg_fused_solve):
            fn.restype = I
        lib.gk_error_string.argtypes = [I]
        lib.gk_error_string.restype = ctypes.c_char_p
        lib.gk_typed = True
    return lib


_GRID_BLOCKS: dict = {}


def coop_grid_blocks(lib, grid_fn: str, codes, device) -> int:
    """Blocks of a cooperative whole-solve grid (occupancy x SM count),
    asked once per (function, dtype codes, device) from ``grid_fn``."""
    key = (grid_fn, tuple(codes), device.index)
    if key not in _GRID_BLOCKS:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(device):
            status = getattr(lib, grid_fn)(*codes, ctypes.byref(blocks))
        check_status(lib, status, grid_fn)
        _GRID_BLOCKS[key] = blocks.value
    return _GRID_BLOCKS[key]


def check_solve_vectors(what, shape, dev, vecs, minv, tol, k):
    """The vectors of a whole-solve kernel: contiguous float32 of ``shape``
    on ``dev``, an (n,) inverse diagonal or None, k float32 thresholds."""
    for v in vecs:
        if v.device != dev or v.dtype != torch.float32 or v.shape != shape or not v.is_contiguous():
            raise ValueError(f"{what}: vectors must be contiguous float32 {shape} on {dev}")
    if minv is not None and (minv.device != dev or minv.dtype != torch.float32
                             or minv.shape != shape[:1] or not minv.is_contiguous()):
        raise ValueError(f"{what}: minv must be contiguous float32 ({shape[0]},) on {dev}")
    if tol.device != dev or tol.dtype != torch.float32 or tol.numel() != k:
        raise ValueError(f"{what}: tol_sq_eff must be {k} float32 on {dev}")


def check_fused_diags(diags, offsets, dev, what):
    """The diagonals of a whole-solve kernel: contiguous (nd, n) float32 or
    bfloat16 on ``dev``, 1 to MAX_DIAGS of them."""
    if diags.device != dev:
        raise RuntimeError(f"{what}: all operands must be on one device")
    if diags.dtype not in FUSED_DIAG_DTYPES:
        raise TypeError(f"{what}: diagonals must be float32/bfloat16, got {diags.dtype}")
    if diags.dim() != 2 or diags.shape[0] != len(offsets):
        raise ValueError(f"{what}: diags must be (nd, n) with nd = len(offsets)")
    if not 1 <= len(offsets) <= MAX_DIAGS:
        raise ValueError(f"{what}: takes 1 to {MAX_DIAGS} diagonals, got {len(offsets)}")
    if not diags.is_contiguous():
        raise ValueError(f"{what}: diags must be contiguous")


#: cg_fused_launch's fields, in the order csrc/cg_fused.cu cg_fused_config writes them
LAUNCH_FIELDS = ("blocks", "threads", "blocks_per_sm", "registers")


def cg_fused_launch(diag_dtype=torch.float32, k=1, device=None):
    """K4's (k = 1) or K4m's launch on a CUDA device: the cooperative
    grid's blocks, threads a block, blocks an SM and registers a thread."""
    lib = _lib()
    out = (ctypes.c_int * len(LAUNCH_FIELDS))()
    with torch.cuda.device(device):
        status = lib.cg_fused_config(DTYPE_CODE[diag_dtype], k, out)
    check_status(lib, status, "cg_fused_config")
    return dict(zip(LAUNCH_FIELDS, out))


def _launch(diags, offsets, r0, x0, minv, tol, max_iters, use_implicit, flexible):
    """Run csrc/cg_fused.cu on checked operands: r0, x0 (n,) for K4 or
    (n, k) for K4m, which alternates its direction between two buffers.
    Returns (x, r, iterations, monitored_sq (k,), converged (k,),
    stop_iterations (k,))."""
    dev = r0.device
    k = 1 if r0.dim() == 1 else r0.shape[1]
    n = diags.shape[1]
    lib = _lib()
    code = DTYPE_CODE[diags.dtype]
    blocks = coop_grid_blocks(lib, "cg_fused_grid", (code, k), dev)
    x, r, p0, q = (torch.empty_like(r0) for _ in range(4))
    p1 = p0 if k == 1 else torch.empty_like(r0)  # K4 keeps one direction buffer
    part = torch.empty(4 * k * blocks, dtype=torch.float64, device=dev)
    ints = torch.empty(1 + 2 * k, dtype=torch.int32, device=dev)  # it, conv, itc
    mon = torch.empty(k, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.cg_fused_solve(
            diags.data_ptr(), code, offsets_array(offsets), len(offsets), n, k,
            r0.data_ptr(), x0.data_ptr(),
            None if minv is None else minv.data_ptr(), tol.data_ptr(),
            min(int(max_iters), 2**31 - 1), int(bool(use_implicit)), int(bool(flexible)),
            x.data_ptr(), r.data_ptr(), p0.data_ptr(), p1.data_ptr(), q.data_ptr(),
            part.data_ptr(), blocks, ints.data_ptr(), mon.data_ptr(),
            ints[1:].data_ptr(), ints[1 + k:].data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "cg_fused" if k == 1 else "cg_fused_multi")
    return x, r, ints[0], mon, ints[1:1 + k] != 0, ints[1 + k:]


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
    dev = r0.device
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(1).contiguous()
    check_fused_diags(diags, offsets, dev, "cg_fused")
    n = diags.shape[1]
    check_solve_vectors("cg_fused", (n,), dev, (r0, x0), minv, tol, 1)
    x, r, it, mon, conv, _ = _launch(diags, offsets, r0, x0, minv, tol, max_iters,
                                     use_implicit, flexible)
    cg_fused.launches += 1
    return x, r, it, mon[0], conv[0]


cg_fused.launches = 0


def cg_fused_multi(diags, offsets, r0, x0, minv=None, *, tol_sq_eff, max_iters,
                   use_implicit=False, flexible=False):
    """K4m: CG/FCG on 2 to 8 right-hand sides in one kernel, with per-column
    stopping.  r0, x0: (n, k) float32 row-major; minv: (n,) or None;
    tol_sq_eff: (k,) squared thresholds (negative: that column runs to the
    cap).  Returns (x, r, iterations, monitored_sq (k,), converged (k,),
    stop_iterations (k,)) as device tensors."""
    if on_cpu(r0):
        return cg_multi_solve_reference(
            diags, offsets, r0, x0, minv, tol_sq_eff=tol_sq_eff,
            max_iters=max_iters, use_implicit=use_implicit, flexible=flexible,
        )
    dev = r0.device
    if r0.dim() != 2 or not 2 <= r0.shape[1] <= MAX_FUSED_COLS:
        raise ValueError(f"cg_fused_multi: takes (n, k) with 2 <= k <= {MAX_FUSED_COLS}")
    k = r0.shape[1]
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(-1)
    tol = tol.expand(k).contiguous()
    check_fused_diags(diags, offsets, dev, "cg_fused_multi")
    n = diags.shape[1]
    check_solve_vectors("cg_fused_multi", (n, k), dev, (r0, x0), minv, tol, k)
    out = _launch(diags, offsets, r0, x0, minv, tol, max_iters, use_implicit, flexible)
    cg_fused_multi.launches += 1
    return out


cg_fused_multi.launches = 0
