"""Whole-solve fused BiCGSTAB: kernels K12 and K12m and their plain versions.

Counterpart of ``ginkgo_tpu/ops/pallas_bicgstab.py`` ``bicgstab_vmem_solve``
(K12, ``_bicgstab_kernel``, :53-186) and ``bicgstab_vmem_solve_multi`` (K12m,
``_bicgstab_multi_kernel``, :202-426, 2 to 8 columns with per-column
stopping).  The one-column loop exists once, :func:`bicgstab_loop_reference`
over an SpMV; K12's plain version runs it on a Dia, K19's
(``ops/pell_cg.py``) on a Pell.  Right-preconditioned BiCGSTAB with a
diagonal M folded into the operator: ``diags`` hold A M
(``solver/_fused_gate.fold_minv``), and ``minv`` is applied only in the x
update.  The whole loop, with the half-step check on s and the stop test,
runs in one persistent cooperative CUDA kernel (``csrc/bicgstab_fused.cu``).

K12 has two routes, chosen from the offsets alone by :func:`ring_plan`:
the ring route, three passes and three grid barriers an iteration, each
block walking its own rows and a halo of w = max |offset| rows on each
side through a ring of shared memory; or, where the ring does not fit a
block (w above 6,656 rows with five float32 diagonals), the five-pass
kernel, whose pass order K19 keeps on a Pell.  Both give the plain version's
bits; ``bicgstab_fused.routes`` counts the launches of each route.

Semantics, shared by the kernel and :func:`bicgstab_solve_reference`:

- shadow residual rr = r0, rho = <r0, r0>, p = v = 0, and the carried
  rho_old, alpha and omega start at 1;
- the monitor starts at +inf and the loop runs while it < max_iters and
  ``not (mon <= tol_sq_eff)``: a NaN monitor keeps iterating;
- exact mode monitors r.r after the update, implicit mode |rho| from
  before it;
- half step: when the monitor of s (s.s, or |rho| in implicit mode) is at
  the threshold, omega = 0 (so r = s) and omega is carried as 1;
- zero denominators give 0.

K12m keeps these per column, as the reference's stopping-status-masked
step kernels do: a stopped column keeps p, v, x and r (a select on the
write) and its carried scalars; s and t are still computed for it, with
alpha and omega taken as 0; it records the iteration at which it stopped.
The loop runs while it < max_iters and any column is active.  K12m runs the
ring route's three passes an iteration without a ring: each row gathers
its neighbours' r, p_old and v_old (pass A) or r and v (pass B) and forms
p_new or s at each, rows of k columns moving as one access; p and v
alternate between two buffers.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .. import _build
from ..log.logger import logged_kernel
from .cg import (
    MAX_FUSED_COLS,
    _dots,
    _sdiv,
    check_fused_diags,
    check_solve_vectors,
    coop_grid_blocks,
)
from .dia import DTYPE_CODE, check_status, dia_spmv_reference, offsets_array, on_cpu

#: rows a step of K12's ring walk forms (csrc/bicgstab_fused.cu GK_BCG_CHUNK)
RING_CHUNK = 1024
#: stages of the walk's input ring (GK_BCG_STAGES)
RING_STAGES = 3
#: most rows of K12's ring (GK_BCG_MAX_RING)
RING_MAX_ROWS = 32768
#: most dynamic shared memory the ring route asks for: an H100 block's
#: 227 KB, less 2 KB for the kernel's static shared memory
RING_MAX_SMEM = 227 * 1024 - 2048


@dataclass(frozen=True)
class RingPlan:
    """K12's ring: w = max |offset|; the rows of the ring, a power of two
    >= 2 w + 3 C (the 2 w + C positions a walk step reads and the C it
    writes never share a place); the dynamic shared memory of the ring and
    the stages of the input ring (``gk_bcg_smem``)."""

    width: int
    ring_rows: int
    smem: int
    chunk: int = RING_CHUNK


def ring_smem(ring_rows, nd, diag_size):
    """Shared memory of the ring route (``gk_bcg_smem``): the ring, then
    RING_STAGES stages of four vectors and nd diagonals of a chunk each."""
    diag_bytes = (RING_CHUNK * diag_size + 4 + 15) & ~15
    return 4 * ring_rows + RING_STAGES * (16 * RING_CHUNK + nd * diag_bytes)


def ring_plan(offsets, n, diag_size=4):
    """K12's route for a Dia with these offsets, n rows and diagonals of
    ``diag_size`` bytes: its ring, or None where the ring and its stages
    would outgrow a block's shared memory (the five-pass kernel then
    runs)."""
    width = max(abs(int(o)) for o in offsets)
    rows = 1 << (2 * width + 3 * RING_CHUNK - 1).bit_length()
    smem = ring_smem(rows, len(offsets), diag_size)
    if rows > RING_MAX_ROWS or smem > RING_MAX_SMEM or n + rows >= 2**30:
        return None
    return RingPlan(width, rows, smem)


def bicgstab_loop_reference(spmv, r0, x0, minv=None, *, tol_sq_eff, max_iters,
                            use_implicit=False):
    """The one-column whole solve, pass by pass as K12 and K19, for any
    operator.  spmv: (n,) -> (n,) float32, the product the kernel runs
    on p and s, A M in either form (folded, or M applied before A); minv:
    (n,) or None, applied in the x update; r0, x0: (n,) float32.  Returns
    (x, r, iterations int32, monitored_sq float32, converged)."""
    dev = r0.device
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(())
    mv = None if minv is None else minv.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=dev)

    x = x0.clone()
    r = r0.clone()
    rr = r0.clone()
    v = torch.zeros_like(r0)
    p = torch.zeros_like(r0)
    rho_new = _dots(r, r)
    rho_old, alpha, omega = one, one, one
    mon = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    it = 0
    # the loop condition reads the monitor on the host once per iteration
    while it < max_iters and not bool(mon <= tol):
        beta = _sdiv(rho_new * alpha, rho_old * omega)
        p = r + beta * (p - omega * v)
        v = spmv(p)
        alpha_new = _sdiv(rho_new, _dots(rr, v))
        s = r - alpha_new * v
        half_done = (torch.abs(rho_new) if use_implicit else _dots(s, s)) <= tol
        t = spmv(s)
        omega_new = torch.where(half_done, 0.0, _sdiv(_dots(t, s), _dots(t, t)))
        y = p if mv is None else mv * p
        z = s if mv is None else mv * s
        x = x + alpha_new * y + omega_new * z
        r = s - omega_new * t
        rho_next = _dots(rr, r)
        mon = torch.abs(rho_new) if use_implicit else _dots(r, r)
        rho_old, alpha = rho_new, alpha_new
        omega = torch.where(half_done, 1.0, omega_new)
        rho_new = rho_next
        it += 1
    iters = torch.tensor(it, dtype=torch.int32, device=dev)
    return x, r, iters, mon, mon <= tol


def bicgstab_solve_reference(diags, offsets, r0, x0, minv=None, *, tol_sq_eff,
                             max_iters, use_implicit=False):
    """K12's plain version.  diags: (nd, n) of A M; r0, x0, minv: (n,)
    float32.  Returns (x, r, iterations int32, monitored_sq float32,
    converged)."""
    n = r0.shape[0]
    return bicgstab_loop_reference(
        lambda v: dia_spmv_reference(diags, offsets, v, n), r0, x0, minv,
        tol_sq_eff=tol_sq_eff, max_iters=max_iters, use_implicit=use_implicit,
    )


def bicgstab_solve_multi_reference(diags, offsets, r0, x0, minv=None, *, tol_sq_eff,
                                   max_iters, use_implicit=False):
    """K12m's plain version, pass by pass as the kernel.  diags: (nd, n) of
    A M; r0, x0: (n, k) float32; minv: (n,) or None; tol_sq_eff: one or k
    squared thresholds.  Returns (x, r, iterations int32, monitored_sq (k,),
    converged (k,), stop_iterations (k,) int32)."""
    n, k = r0.shape
    dev = r0.device
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(-1).expand(k)
    mv = None if minv is None else minv.to(torch.float32)[:, None]
    ones = torch.ones(k, dtype=torch.float32, device=dev)

    def spmv(v):
        return dia_spmv_reference(diags, offsets, v, n)

    x = x0.clone()
    r = r0.clone()
    rr = r0.clone()
    v = torch.zeros_like(r0)
    p = torch.zeros_like(r0)
    rho_new = _dots(r, r)
    rho_old, alpha, omega = ones, ones, ones
    act = torch.ones(k, dtype=torch.bool, device=dev)
    itc = torch.zeros(k, dtype=torch.int32, device=dev)
    mon = torch.full((k,), float("inf"), dtype=torch.float32, device=dev)
    it = 0
    # the loop condition reads the stop flags on the host once per iteration
    while it < max_iters and bool(act.any()):
        beta = _sdiv(rho_new * alpha, rho_old * omega)
        p = torch.where(act, r + beta * (p - omega * v), p)
        v = torch.where(act, spmv(p), v)
        alpha_new = torch.where(act, _sdiv(rho_new, _dots(rr, v)), alpha)
        alpha_eff = torch.where(act, alpha_new, 0.0)
        s = r - alpha_eff * v
        half_done = act & ((torch.abs(rho_new) if use_implicit else _dots(s, s)) <= tol)
        t = spmv(s)
        omega_eff = torch.where(act & ~half_done, _sdiv(_dots(t, s), _dots(t, t)), 0.0)
        y = p if mv is None else mv * p
        z = s if mv is None else mv * s
        x = torch.where(act, x + alpha_eff * y + omega_eff * z, x)
        r = torch.where(act, s - omega_eff * t, r)
        rho_next = _dots(rr, r)
        mon = torch.abs(rho_new) if use_implicit else _dots(r, r)
        itc = torch.where(act, it + 1, itc).to(torch.int32)
        omega = torch.where(act, torch.where(half_done, 1.0, omega_eff), omega)
        rho_old, alpha = rho_new, alpha_new
        rho_new = torch.where(act, rho_next, rho_new)
        act = act & ~(mon <= tol)
        it += 1
    iters = torch.tensor(it, dtype=torch.int32, device=dev)
    return x, r, iters, mon, mon <= tol, itc


def _lib():
    lib = _build.load("bicgstab_fused")
    if not hasattr(lib, "gk_typed"):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        offs, blocks = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
        lib.bicgstab_fused_grid.argtypes = [I, blocks]
        lib.bicgstab_fused_multi_grid.argtypes = [I, I, blocks]
        lib.bicgstab_ring_config.argtypes = [I, I, I, ctypes.POINTER(L)]
        lib.bicgstab_fused_solve.argtypes = [
            P, I, offs, I, L,  # diags, offsets, n
            P, P, P, P,  # r0, x0, minv, tol_sq
            I, I,  # max_iters, implicit
            P, P, P, P, P, P, P,  # x, r, rr, v, t, p, s
            P, P, I,  # p1, v1, ring rows (0: the five-pass kernel)
            P, I,  # partials, blocks
            P, P, P, P,  # it_out, mon_out, conv_out, stream
        ]
        lib.bicgstab_fused_multi_solve.argtypes = [
            P, I, offs, I, L, I,  # diags, offsets, n, k
            P, P, P, P,  # r0, x0, minv, tol_sq
            I, I,  # max_iters, implicit
            P, P, P, P, P, P, P, P,  # x, r, rr, v, t, p, p1, v1
            P, I,  # partials, blocks
            P, P, P, P, P,  # it_out, mon_out, conv_out, itc_out, stream
        ]
        lib.pell_bicgstab_fused_grid.argtypes = [I, I, blocks]
        lib.pell_bicgstab_fused_config.argtypes = [I, I, blocks]
        lib.pell_bicgstab_fused_solve.argtypes = [
            P, I, P, I, P, P, I, I, L,  # values, qidx, bases, tile_ptr, S, G, n
            P, P, P, P,  # r0, x0, minv, tol_sq
            I, I,  # max_iters, implicit
            P, P, P, P, P, P, P,  # x, r, rr, v, t, p, s
            P, P,  # y, z: M p and M s with Jacobi
            P, I,  # partials, blocks
            P, P, P, P,  # it_out, mon_out, conv_out, stream
        ]
        for fn in (lib.bicgstab_fused_grid, lib.bicgstab_ring_config, lib.bicgstab_fused_solve,
                   lib.bicgstab_fused_multi_grid, lib.bicgstab_fused_multi_solve,
                   lib.pell_bicgstab_fused_grid, lib.pell_bicgstab_fused_config,
                   lib.pell_bicgstab_fused_solve):
            fn.restype = I
        lib.gk_error_string.argtypes = [I]
        lib.gk_error_string.restype = ctypes.c_char_p
        lib.gk_typed = True
    return lib


#: bicgstab_fused_launch's figures, in the order bicgstab_ring_config writes them
LAUNCH_FIELDS = ("blocks", "threads", "smem", "blocks_per_sm", "registers")
_LAUNCHES: dict = {}


def bicgstab_fused_launch(diags, offsets, device):
    """K12's route and launch for these diagonals on a CUDA device, asked
    once per (dtype, offsets, n, device): "route" ("ring" or "barrier"),
    the grid's blocks, threads a block, dynamic shared memory a block,
    blocks an SM and registers a thread (the ring route's), the ring's rows
    and width, and the grid barriers an iteration."""
    n = diags.shape[1]
    key = (diags.dtype, tuple(int(o) for o in offsets), n, device.index)
    if key not in _LAUNCHES:
        lib = _lib()
        code = DTYPE_CODE[diags.dtype]
        plan = ring_plan(offsets, n, diags.element_size())
        if plan is None:
            blocks = coop_grid_blocks(lib, "bicgstab_fused_grid", (code,), device)
            launch = {"route": "barrier", "blocks": blocks, "ring_rows": 0, "width": 0,
                      "grid_barriers": 5}
        else:
            out = (ctypes.c_longlong * len(LAUNCH_FIELDS))()
            with torch.cuda.device(device):
                status = lib.bicgstab_ring_config(code, len(offsets), plan.ring_rows, out)
            check_status(lib, status, "bicgstab_ring_config")
            launch = {"route": "ring", **dict(zip(LAUNCH_FIELDS, out)),
                      "ring_rows": plan.ring_rows, "width": plan.width, "grid_barriers": 3}
        _LAUNCHES[key] = launch
    return _LAUNCHES[key]


@logged_kernel
def bicgstab_fused(diags, offsets, r0, x0, minv=None, *, tol_sq_eff, max_iters,
                   use_implicit=False):
    """K12: run BiCGSTAB to the stop test in one kernel.  diags: (nd, n)
    float32/bfloat16 of A M; r0, x0, minv: (n,) float32; tol_sq_eff: the
    squared absolute threshold, a float32 tensor on the device so no host
    sync is needed.  Returns (x, r, iterations int32, monitored_sq float32,
    converged bool) as device tensors."""
    if on_cpu(r0):
        return bicgstab_solve_reference(
            diags, offsets, r0, x0, minv, tol_sq_eff=tol_sq_eff,
            max_iters=max_iters, use_implicit=use_implicit,
        )
    dev = r0.device
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(1).contiguous()
    check_fused_diags(diags, offsets, dev, "bicgstab_fused")
    n = diags.shape[1]
    check_solve_vectors("bicgstab_fused", (n,), dev, (r0, x0), minv, tol, 1)
    lib = _lib()
    launch = bicgstab_fused_launch(diags, offsets, dev)
    ring = launch["route"] == "ring"
    x, r, rr, v, t, p = (torch.empty_like(r0) for _ in range(6))
    # the ring route alternates p and v between two buffers and keeps s in
    # shared memory; the five-pass kernel writes s
    s, p1, v1 = (torch.empty_like(r0), None, None) if not ring else (
        None, torch.empty_like(r0), torch.empty_like(r0))
    part = torch.empty(6 * launch["blocks"], dtype=torch.float64, device=dev)
    it_conv = torch.empty(2, dtype=torch.int32, device=dev)
    mon = torch.empty(1, dtype=torch.float32, device=dev)

    def ptr(a):
        return None if a is None else a.data_ptr()

    with torch.cuda.device(dev):
        status = lib.bicgstab_fused_solve(
            diags.data_ptr(), DTYPE_CODE[diags.dtype], offsets_array(offsets), len(offsets), n,
            r0.data_ptr(), x0.data_ptr(), ptr(minv), tol.data_ptr(),
            min(int(max_iters), 2**31 - 1), int(bool(use_implicit)),
            x.data_ptr(), r.data_ptr(), rr.data_ptr(), v.data_ptr(), t.data_ptr(),
            p.data_ptr(), ptr(s), ptr(p1), ptr(v1), launch["ring_rows"], part.data_ptr(),
            launch["blocks"], it_conv.data_ptr(), mon.data_ptr(), it_conv[1:].data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "bicgstab_fused")
    bicgstab_fused.launches += 1
    bicgstab_fused.routes[launch["route"]] += 1
    return x, r, it_conv[0], mon[0], it_conv[1] != 0


bicgstab_fused.launches = 0
bicgstab_fused.routes = {"ring": 0, "barrier": 0}


@logged_kernel
def bicgstab_fused_multi(diags, offsets, r0, x0, minv=None, *, tol_sq_eff, max_iters,
                         use_implicit=False):
    """K12m: BiCGSTAB on 2 to 8 right-hand sides in one kernel, with
    per-column stopping.  diags: (nd, n) float32/bfloat16 of A M; r0, x0:
    (n, k) float32 row-major; minv: (n,) or None (the x update only);
    tol_sq_eff: (k,) squared thresholds (negative: that column runs to the
    cap).  Returns (x, r, iterations, monitored_sq (k,), converged (k,),
    stop_iterations (k,)) as device tensors."""
    if on_cpu(r0):
        return bicgstab_solve_multi_reference(
            diags, offsets, r0, x0, minv, tol_sq_eff=tol_sq_eff,
            max_iters=max_iters, use_implicit=use_implicit,
        )
    dev = r0.device
    if r0.dim() != 2 or not 2 <= r0.shape[1] <= MAX_FUSED_COLS:
        raise ValueError(f"bicgstab_fused_multi: takes (n, k) with 2 <= k <= {MAX_FUSED_COLS}")
    k = r0.shape[1]
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(-1)
    tol = tol.expand(k).contiguous()
    check_fused_diags(diags, offsets, dev, "bicgstab_fused_multi")
    n = diags.shape[1]
    check_solve_vectors("bicgstab_fused_multi", (n, k), dev, (r0, x0), minv, tol, k)
    lib = _lib()
    code = DTYPE_CODE[diags.dtype]
    blocks = coop_grid_blocks(lib, "bicgstab_fused_multi_grid", (code, k), dev)
    x, r, rr, v, t, p, p1, v1 = (torch.empty_like(r0) for _ in range(8))
    part = torch.empty(6 * k * blocks, dtype=torch.float64, device=dev)
    ints = torch.empty(1 + 2 * k, dtype=torch.int32, device=dev)  # it, conv, itc
    mon = torch.empty(k, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.bicgstab_fused_multi_solve(
            diags.data_ptr(), code, offsets_array(offsets), len(offsets), n, k,
            r0.data_ptr(), x0.data_ptr(), None if minv is None else minv.data_ptr(),
            tol.data_ptr(), min(int(max_iters), 2**31 - 1), int(bool(use_implicit)),
            x.data_ptr(), r.data_ptr(), rr.data_ptr(), v.data_ptr(), t.data_ptr(),
            p.data_ptr(), p1.data_ptr(), v1.data_ptr(), part.data_ptr(), blocks, ints.data_ptr(),
            mon.data_ptr(), ints[1:].data_ptr(), ints[1 + k:].data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "bicgstab_fused_multi")
    bicgstab_fused_multi.launches += 1
    return x, r, ints[0], mon, ints[1:1 + k] != 0, ints[1 + k:]


bicgstab_fused_multi.launches = 0
