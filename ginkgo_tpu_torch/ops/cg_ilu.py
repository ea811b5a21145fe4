"""Whole-solve ILU-preconditioned CG and BiCGSTAB: kernels K23 and K24 and
their plain versions.

Counterpart of ``ginkgo_tpu/ops/pallas_cg_ilu.py`` ``cg_ilu_vmem_solve``
(K23, ``_cg_ilu_kernel``, :96-244) and ``bicgstab_ilu_vmem_solve`` (K24,
``_bicgstab_ilu_kernel``, :321-481).  The preconditioner M = U^{-1} L^{-1}
of an ``IluPreconditioner`` whose two ``TriangularSolver``s run the
'sweeps' algorithm on ``Dia`` strict triangles is applied inside the
kernel: each triangular solve is ``_tri_sweeps`` (:54), x0 = D^{-1} rhs
then ``sweeps`` Jacobi-Richardson sweeps x <- D^{-1}(rhs - N x), with the
inverse diagonal multiplied in.  The whole Krylov loop, both M applies and
the stop test run in one persistent cooperative CUDA kernel
(``csrc/trs_fused.cu``, which also holds K22).  K23 takes the pipelined
walk (``csrc/tri_walk.cuh``, four grid barriers an iteration) where both
triangles' shapes allow it (``ops/tri_walk.py``), the barrier routine (3 +
sweeps_l + sweeps_u) otherwise; K24 takes the walk for both of its M
applies (seven grid barriers an iteration; eight where p takes a pass of
its own, "pipelined_p_pass") where both triangles sweep at least once and
their shapes allow it, the barrier routine (5 + 2 (sweeps_l + sweeps_u))
otherwise.  ``cg_ilu_fused.routes`` and ``bicgstab_ilu_fused.routes`` count
each route's launches.

Semantics, shared by the kernels and the plain versions:

- the monitor starts at +inf, so at least one iteration runs, and the
  loop runs while it < max_iters and ``not (mon <= tol_sq_eff)``: a NaN
  monitor keeps iterating;
- K23: z = M r0, p = z, rho = r.z; exact mode monitors r.r after the
  update, implicit mode |rho| of the rho entering the iteration;
- K24: right preconditioning, y = M p, v = A y, the half-step check on s,
  z = M s, t = A z; rr = r0, rho = r0.r0, p = v = 0 and the carried
  rho_old, alpha and omega start at 1; omega = 0 when the half step
  converged, carried as 1;
- zero denominators give 0; dot products are float64 sums rounded to
  float32 (``ops/cg._dots``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..log.logger import logged_kernel
from . import tri_walk
from .cg import _dots, _sdiv, check_fused_diags
from .dia import DTYPE_CODE, check_status, dia_spmv_reference, offsets_array, on_cpu


def _dot(a, b):
    return _dots(a[:, None], b[:, None])[0]


def _tri_sweeps(T, invd, rhs, sweeps):
    """x ~ T^{-1} rhs with plain tensor ops: x = rhs * invd, then ``sweeps``
    sweeps x = (rhs - N x) * invd, N = ``T`` (a ``Dia`` strict triangle),
    invd the float32 inverse diagonal.  rhs: (n,) float32."""
    n = rhs.shape[0]
    x = rhs * invd
    for _ in range(int(sweeps)):
        x = (rhs - dia_spmv_reference(T.diags, T.offsets, x, n)) * invd
    return x


def _ilu_apply(Tl, Tu, invdl, invdu, sweeps_l, sweeps_u):
    """v -> U^{-1} L^{-1} v by two sweep solves."""
    def apply(v):
        return _tri_sweeps(Tu, invdu, _tri_sweeps(Tl, invdl, v, sweeps_l), sweeps_u)
    return apply


def _tol(tol_sq_eff, dev):
    return torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(())


def cg_ilu_reference(A, Tl, Tu, invdl, invdu, r0, x0, *, sweeps_l, sweeps_u, tol_sq_eff,
                     max_iters, use_implicit=False):
    """K23's plain version, pass by pass as the kernel.  A: square ``Dia``;
    Tl, Tu: the ``Dia`` strict triangles of L and U; invdl, invdu, r0, x0:
    (n,) float32.  Returns (x, r, iterations int32, monitored_sq float32,
    converged)."""
    dev = r0.device
    tol = _tol(tol_sq_eff, dev)
    n = r0.shape[0]
    M = _ilu_apply(Tl, Tu, invdl, invdu, sweeps_l, sweeps_u)
    x, r = x0.clone(), r0.clone()
    z = M(r)
    p = z
    rho = _dot(r, z)
    mon = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    it = 0
    # the loop condition reads the monitor on the host once per iteration
    while it < max_iters and not bool(mon <= tol):
        q = dia_spmv_reference(A.diags, A.offsets, p, n)
        alpha = _sdiv(rho, _dot(p, q))
        x = x + alpha * p
        r = r - alpha * q
        rr_new = _dot(r, r)
        z = M(r)
        rho_new = _dot(r, z)
        p = z + _sdiv(rho_new, rho) * p
        mon = torch.abs(rho) if use_implicit else rr_new
        rho = rho_new
        it += 1
    return x, r, torch.tensor(it, dtype=torch.int32, device=dev), mon, mon <= tol


def bicgstab_ilu_reference(A, Tl, Tu, invdl, invdu, r0, x0, *, sweeps_l, sweeps_u, tol_sq_eff,
                           max_iters, use_implicit=False):
    """K24's plain version, pass by pass as the kernel; operands as
    :func:`cg_ilu_reference`."""
    dev = r0.device
    tol = _tol(tol_sq_eff, dev)
    n = r0.shape[0]
    M = _ilu_apply(Tl, Tu, invdl, invdu, sweeps_l, sweeps_u)
    one = torch.ones((), dtype=torch.float32, device=dev)
    x, r, rr = x0.clone(), r0.clone(), r0.clone()
    p = torch.zeros_like(r0)
    v = torch.zeros_like(r0)
    rho_new = _dot(r, r)
    rho_old, alpha, omega = one, one, one
    mon = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    it = 0
    while it < max_iters and not bool(mon <= tol):
        beta = _sdiv(rho_new * alpha, rho_old * omega)
        p = r + beta * (p - omega * v)
        y = M(p)
        v = dia_spmv_reference(A.diags, A.offsets, y, n)
        alpha_new = _sdiv(rho_new, _dot(rr, v))
        x = x + alpha_new * y
        s = r - alpha_new * v
        half_done = (torch.abs(rho_new) if use_implicit else _dot(s, s)) <= tol
        z = M(s)
        t = dia_spmv_reference(A.diags, A.offsets, z, n)
        omega_new = torch.where(half_done, 0.0, _sdiv(_dot(t, s), _dot(t, t)))
        x = x + omega_new * z
        r = s - omega_new * t
        rho_next = _dot(rr, r)
        mon = torch.abs(rho_new) if use_implicit else _dot(r, r)
        rho_old, alpha = rho_new, alpha_new
        omega = torch.where(half_done, 1.0, omega_new)
        rho_new = rho_next
        it += 1
    return x, r, torch.tensor(it, dtype=torch.int32, device=dev), mon, mon <= tol


# -- kernel wrappers ----------------------------------------------------------------


def _lib():
    lib = _build.load("trs_fused")
    if not hasattr(lib, "gk_typed"):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        offs = ctypes.POINTER(ctypes.c_longlong)
        vecs = ctypes.POINTER(ctypes.c_void_p)
        lib.trs_fused_solve.argtypes = [P, I, offs, I, L, P, P, I, P, P, I, P]
        three_ops = [P, I, offs, I, P, offs, I, P, offs, I, I, L]  # A, L, U, t_dtype, n
        lib.cg_ilu_fused_solve.argtypes = three_ops + [
            P, P, P, P, P,  # invdl, invdu, r0, x0, tol_sq
            I, I, I, I,  # max_iters, sweeps_l, sweeps_u, implicit
            P, P, P, P, P, P, P,  # x, r, p, q, z, w1, w2
            P, I, P, P, P, P,  # part, blocks, it_out, mon_out, conv_out, stream
        ]
        lib.bicgstab_ilu_fused_solve.argtypes = three_ops + [
            P, P, P, P, P, I, I, I, I,  # invdl, invdu, r0, x0, tol_sq, max_iters, sweeps, implicit
            vecs, P, I, P, P, P, P,  # vecs, part, blocks, it_out, mon_out, conv_out, stream
        ]
        plan = ctypes.POINTER(ctypes.c_longlong)
        lib.trs_fused_plan.argtypes = [I, offs, I, L, I, plan]
        lib.cg_ilu_fused_plan.argtypes = [I, I, offs, I, offs, I, L, I, I, plan]
        lib.trs_walk_solve.argtypes = [P, I, offs, I, L, P, P, I, P, I, P]
        lib.cg_ilu_walk_solve.argtypes = three_ops + [
            P, P, P, P, P,  # invdl, invdu, r0, x0, tol_sq
            I, I, I, I,  # max_iters, sweeps_l, sweeps_u, implicit
            vecs, P, I, P, P, P, P,  # vecs, part, blocks, it_out, mon_out, conv_out, stream
        ]
        lib.bicgstab_ilu_fused_plan.argtypes = [I, I, offs, I, offs, I, L, I, I, plan]
        lib.bicgstab_ilu_walk_solve.argtypes = three_ops + [
            P, P, P, P, P,  # invdl, invdu, r0, x0, tol_sq
            I, I, I, I, I,  # max_iters, sweeps_l, sweeps_u, implicit, p in a pass of its own
            vecs, P, I, P, P, P, P,  # vecs, part, blocks, it_out, mon_out, conv_out, stream
        ]
        for fn in (lib.trs_fused_solve, lib.cg_ilu_fused_solve, lib.bicgstab_ilu_fused_solve,
                   lib.trs_fused_plan, lib.cg_ilu_fused_plan, lib.trs_walk_solve,
                   lib.cg_ilu_walk_solve, lib.bicgstab_ilu_fused_plan,
                   lib.bicgstab_ilu_walk_solve):
            fn.restype = I
        lib.gk_error_string.argtypes = [I]
        lib.gk_error_string.restype = ctypes.c_char_p
        lib.gk_typed = True
    return lib


def check_vector(what, v, n, dev):
    if v.device != dev or v.dtype != torch.float32 or v.shape != (n,) or not v.is_contiguous():
        raise ValueError(f"{what}: vectors must be contiguous float32 ({n},) on {dev}")


def _triangles(Tl, Tu, dev, what):
    """The diagonals of the two strict triangles, of one dtype: a bfloat16
    triangle beside a float32 one is widened to float32, which is exact
    (the kernel widens it on read anyway)."""
    ld, ud = Tl.diags, Tu.diags
    if ld.dtype != ud.dtype:
        ld, ud = ld.to(torch.float32), ud.to(torch.float32)
    check_fused_diags(ld, Tl.offsets, dev, what)
    check_fused_diags(ud, Tu.offsets, dev, what)
    return ld, ud


def _ilu_operands(A, Tl, Tu, invdl, invdu, r0, x0, sweeps_l, sweeps_u, what):
    dev = r0.device
    n = A.shape[0]
    if A.shape != (n, n) or Tl.shape != (n, n) or Tu.shape != (n, n):
        raise ValueError(f"{what}: A, L and U must be square of one size")
    check_fused_diags(A.diags, A.offsets, dev, what)
    ld, ud = _triangles(Tl, Tu, dev, what)
    for v in (invdl, invdu, r0, x0):
        check_vector(what, v, n, dev)
    if sweeps_l < 0 or sweeps_u < 0:
        raise ValueError(f"{what}: sweep counts must be >= 0")
    args = [A.diags.data_ptr(), DTYPE_CODE[A.diags.dtype], offsets_array(A.offsets),
            len(A.offsets), ld.data_ptr(), offsets_array(Tl.offsets), len(Tl.offsets),
            ud.data_ptr(), offsets_array(Tu.offsets), len(Tu.offsets), DTYPE_CODE[ld.dtype], n,
            invdl.data_ptr(), invdu.data_ptr(), r0.data_ptr(), x0.data_ptr()]
    return dev, n, (DTYPE_CODE[A.diags.dtype], DTYPE_CODE[ld.dtype]), args, (ld, ud)


def _launch(fn, A, Tl, Tu, sweeps_l, sweeps_u, device):
    ld, ud = Tl.diags, Tu.diags
    t_dtype = ld.dtype if ld.dtype == ud.dtype else torch.float32  # as _triangles widens
    args = (DTYPE_CODE[A.diags.dtype], DTYPE_CODE[t_dtype], tuple(Tl.offsets), len(Tl.offsets),
            tuple(Tu.offsets), len(Tu.offsets), A.shape[0], int(sweeps_l), int(sweeps_u))
    return tri_walk.plan(_lib(), fn, args, 2, device)


def cg_ilu_fused_launch(A, Tl, Tu, sweeps_l, sweeps_u, device):
    """K23's route and launch on a CUDA device (``ops/tri_walk.plan``):
    "pipelined" where both triangles take the walk (four grid barriers an
    iteration), else "barrier" (3 + sweeps_l + sweeps_u)."""
    return _launch("cg_ilu_fused_plan", A, Tl, Tu, sweeps_l, sweeps_u, device)


def bicgstab_ilu_fused_launch(A, Tl, Tu, sweeps_l, sweeps_u, device):
    """K24's route and launch on a CUDA device (``ops/tri_walk.plan``):
    "pipelined" where both triangles take the walk with at least one sweep
    (seven grid barriers an iteration), "pipelined_p_pass" where only the
    form with p in a pass of its own fits a block (eight), else "barrier"
    (5 + 2 (sweeps_l + sweeps_u))."""
    return _launch("bicgstab_ilu_fused_plan", A, Tl, Tu, sweeps_l, sweeps_u, device)


@logged_kernel
def cg_ilu_fused(A, Tl, Tu, invdl, invdu, r0, x0, *, sweeps_l, sweeps_u, tol_sq_eff,
                 max_iters, use_implicit=False):
    """K23: ILU-preconditioned CG to the stop test in one kernel.  A: square
    ``Dia`` with 1 to 64 float32/bfloat16 diagonals; Tl, Tu: the strict
    triangles of L and U as such ``Dia``; invdl, invdu: their float32
    inverse diagonals; r0, x0: (n,) float32; tol_sq_eff: squared absolute
    threshold on r.r (|rho| when ``use_implicit``) as a float32 tensor on
    the device.  Returns (x, r, iterations int32, monitored_sq float32,
    converged bool) as device tensors."""
    kw = dict(sweeps_l=sweeps_l, sweeps_u=sweeps_u, tol_sq_eff=tol_sq_eff,
              max_iters=max_iters, use_implicit=use_implicit)
    if on_cpu(r0):
        return cg_ilu_reference(A, Tl, Tu, invdl, invdu, r0, x0, **kw)
    dev, n, _, args, _keep = _ilu_operands(A, Tl, Tu, invdl, invdu, r0, x0, sweeps_l,
                                           sweeps_u, "cg_ilu_fused")
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(1).contiguous()
    lib = _lib()
    launch = cg_ilu_fused_launch(A, Tl, Tu, sweeps_l, sweeps_u, dev)
    blocks = launch["blocks"]
    part = torch.empty(3 * blocks, dtype=torch.float64, device=dev)
    it_conv = torch.empty(2, dtype=torch.int32, device=dev)
    mon = torch.empty(1, dtype=torch.float32, device=dev)
    head = (tol.data_ptr(), min(int(max_iters), 2**31 - 1), int(sweeps_l), int(sweeps_u),
            int(bool(use_implicit)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if launch["route"] == "pipelined":
            # the walks stage the triangles from 4-byte words, invdl, invdu,
            # r0 and the buffers 16 bytes at a time
            staged = [tri_walk.aligned(t) for t in (*_keep, invdl, invdu, r0)]
            args[4], args[7] = staged[0].data_ptr(), staged[1].data_ptr()
            args[12:15] = [t.data_ptr() for t in staged[2:]]
            bufs = [torch.empty_like(r0) for _ in range(7)]  # x r r' p q z mid
            vecs = (ctypes.c_void_p * 7)(*(t.data_ptr() for t in bufs))
            status = lib.cg_ilu_walk_solve(
                *args, *head, vecs, part.data_ptr(), blocks, it_conv.data_ptr(), mon.data_ptr(),
                it_conv[1:].data_ptr(), stream,
            )
            x, r = bufs[0], bufs[1]
        else:
            x, r, p, q, z, w1, w2 = (torch.empty_like(r0) for _ in range(7))
            status = lib.cg_ilu_fused_solve(
                *args, *head, x.data_ptr(), r.data_ptr(), p.data_ptr(), q.data_ptr(), z.data_ptr(),
                w1.data_ptr(), w2.data_ptr(), part.data_ptr(), blocks, it_conv.data_ptr(),
                mon.data_ptr(), it_conv[1:].data_ptr(), stream,
            )
    check_status(lib, status, "cg_ilu_fused")
    cg_ilu_fused.launches += 1
    cg_ilu_fused.routes[launch["route"]] += 1
    return x, r, it_conv[0], mon[0], it_conv[1] != 0


cg_ilu_fused.launches = 0
cg_ilu_fused.routes = {"pipelined": 0, "barrier": 0}


@logged_kernel
def bicgstab_ilu_fused(A, Tl, Tu, invdl, invdu, r0, x0, *, sweeps_l, sweeps_u, tol_sq_eff,
                       max_iters, use_implicit=False):
    """K24: ILU right-preconditioned BiCGSTAB to the stop test in one kernel;
    operands and result as :func:`cg_ilu_fused`."""
    kw = dict(sweeps_l=sweeps_l, sweeps_u=sweeps_u, tol_sq_eff=tol_sq_eff,
              max_iters=max_iters, use_implicit=use_implicit)
    if on_cpu(r0):
        return bicgstab_ilu_reference(A, Tl, Tu, invdl, invdu, r0, x0, **kw)
    dev, n, _, args, _keep = _ilu_operands(A, Tl, Tu, invdl, invdu, r0, x0, sweeps_l,
                                           sweeps_u, "bicgstab_ilu_fused")
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(1).contiguous()
    lib = _lib()
    launch = bicgstab_ilu_fused_launch(A, Tl, Tu, sweeps_l, sweeps_u, dev)
    blocks = launch["blocks"]
    # 11 buffers, 16-byte aligned each (the walks stage them): x r rr p p' v
    # s t y z mid on the walk, x r rr p v s t y mid w1 w2 on the barrier route
    bufs = [torch.empty_like(r0) for _ in range(11)]
    vecs = (ctypes.c_void_p * 11)(*(t.data_ptr() for t in bufs))
    part = torch.empty(7 * blocks, dtype=torch.float64, device=dev)
    it_conv = torch.empty(2, dtype=torch.int32, device=dev)
    mon = torch.empty(1, dtype=torch.float32, device=dev)
    head = (tol.data_ptr(), min(int(max_iters), 2**31 - 1), int(sweeps_l), int(sweeps_u),
            int(bool(use_implicit)))
    tail = (vecs, part.data_ptr(), blocks, it_conv.data_ptr(), mon.data_ptr(),
            it_conv[1:].data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if launch["route"] == "barrier":
            status = lib.bicgstab_ilu_fused_solve(*args, *head, *tail, stream)
        else:
            # the walks stage the triangles from 4-byte words, invdl and
            # invdu 16 bytes at a time
            staged = [tri_walk.aligned(t) for t in (*_keep, invdl, invdu)]
            args[4], args[7] = staged[0].data_ptr(), staged[1].data_ptr()
            args[12:14] = [t.data_ptr() for t in staged[2:]]
            status = lib.bicgstab_ilu_walk_solve(
                *args, *head, int(launch["route"] == "pipelined_p_pass"), *tail, stream)
    check_status(lib, status, "bicgstab_ilu_fused")
    bicgstab_ilu_fused.launches += 1
    bicgstab_ilu_fused.routes[launch["route"]] += 1
    return bufs[0], bufs[1], it_conv[0], mon[0], it_conv[1] != 0


bicgstab_ilu_fused.launches = 0
bicgstab_ilu_fused.routes = {"pipelined": 0, "pipelined_p_pass": 0, "barrier": 0}
