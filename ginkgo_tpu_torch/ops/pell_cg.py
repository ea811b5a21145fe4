"""Whole-solve Krylov kernels on a Pell operator: K7 (CG/FCG), K19
(BiCGSTAB), K20 (CGS) and K21 (IR/Richardson), with their plain versions.

Counterpart of ``ginkgo_tpu/ops/pallas_pell_cg.py``, which holds the four
TPU kernels: ``pell_cg_vmem_solve`` (``_pell_cg_kernel``),
``pell_bicgstab_vmem_solve`` (``_pell_bicgstab_kernel``, :313),
``pell_cgs_vmem_solve`` (``_pell_cgs_kernel``, :559) and
``pell_ir_vmem_solve`` (``_pell_ir_kernel``, :794).  The Krylov loop of a
general unstructured matrix, its slot SpMV, an Identity or
inverse-diagonal preconditioner and the stop test run in one persistent
cooperative CUDA kernel.  K7 is ``csrc/pell_cg_fused.cu``; K19, K20 and K21
are the Dia kernels K12, K13 and K17 instantiated on the Pell operator
(``csrc/bicgstab_fused.cu``, ``cgs_fused.cu``, ``ir_fused.cu``, pell.cuh
``GkPellOp``), so each loop exists once, as do its plain versions
(``ops/bicgstab.bicgstab_loop_reference``, ``ops/cgs.cgs_loop_reference``,
``ops/ir.ir_loop_reference``) over an SpMV callable.

What differs on a Pell, as in the TPU kernels:

- BiCGSTAB and CGS apply M explicitly, v = A (M p): PELL values have no
  column fold, so ``fold_minv`` does not apply.  M p is one float32
  product per entry, the TPU kernels' staged w = M p; with bfloat16 values
  the folded form would round A M to bfloat16 and give other bits.  The x
  updates are the Dia kernels': x += alpha M p + omega M s (BiCGSTAB),
  x += alpha M (u + q) (CGS).
- IR's monitor starts at the r.r of r0 = b - A x0, not at +inf, so a
  solve whose r0 already meets the threshold runs no sweep (the Dia kernel
  and the streaming loop run one).  It returns x and the last r.r.

The JAX kernels sum their dot products in float32, these kernels and their
plain versions in float64, so iteration counts agree with the JAX kernels
only up to a tolerance.  GMRES on a Pell (K18) is ``ops/gmres.py``'s.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import bicgstab as _bicgstab
from . import cgs as _cgs
from . import ir as _ir
from .bicgstab import bicgstab_loop_reference
from .cg import check_solve_vectors, cg_loop_reference, coop_grid_blocks
from .cgs import cgs_loop_reference
from .dia import DTYPE_CODE, check_status, on_cpu
from .ir import ir_loop_reference
from .pell import INDEX_CODE, check_fused_pell, pell_plan_args, pell_spmv_reference


def _explicit(A, minv):
    """v -> A (M v) with M = diag(minv) applied before the product, as the
    kernels' gather does."""
    mv = None if minv is None else minv.to(torch.float32)
    return lambda v: pell_spmv_reference(A, v if mv is None else mv * v)


def pell_cg_solve_reference(A, r0, x0, minv=None, *, tol_sq_eff, max_iters,
                            use_implicit=False, flexible=False):
    """K7's plain version.  A: a square Pell; r0, x0, minv: (n,) float32.
    Returns (x, r, iterations int32, monitored_sq float32, converged)."""
    x, r, it, mon, conv, _ = cg_loop_reference(
        lambda v: pell_spmv_reference(A, v[:, 0])[:, None], r0[:, None],
        x0[:, None], minv, tol_sq_eff=tol_sq_eff, max_iters=max_iters,
        use_implicit=use_implicit, flexible=flexible,
    )
    return x[:, 0], r[:, 0], it, mon[0], conv[0]


def pell_bicgstab_solve_reference(A, r0, x0, minv=None, *, tol_sq_eff, max_iters,
                                  use_implicit=False):
    """K19's plain version.  A: a square Pell; r0, x0, minv: (n,) float32.
    Returns (x, r, iterations int32, monitored_sq float32, converged)."""
    return bicgstab_loop_reference(_explicit(A, minv), r0, x0, minv, tol_sq_eff=tol_sq_eff,
                                   max_iters=max_iters, use_implicit=use_implicit)


def pell_cgs_solve_reference(A, r0, x0, minv=None, *, tol_sq_eff, max_iters,
                             use_implicit=False):
    """K20's plain version.  A: a square Pell; r0, x0, minv: (n,) float32.
    Returns (x, r, iterations int32, monitored_sq float32, converged)."""
    return cgs_loop_reference(_explicit(A, minv), r0, x0, minv, tol_sq_eff=tol_sq_eff,
                              max_iters=max_iters, use_implicit=use_implicit)


def pell_ir_solve_reference(A, b, x0, minv=None, *, omega, tol_sq_eff, max_iters):
    """K21's plain version.  A: a square Pell; b, x0, minv: (n,) float32.
    Returns (x, iterations int32, r.r float32, converged)."""
    x, _r, it, rr, conv = ir_loop_reference(
        lambda v: pell_spmv_reference(A, v), b, x0, minv, omega=omega,
        tol_sq_eff=tol_sq_eff, max_iters=max_iters, monitor_from_r0=True,
    )
    return x, it, rr, conv


def _lib():
    lib = _build.load("pell_cg_fused")
    if not hasattr(lib, "gk_typed"):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pell_cg_fused_grid.argtypes = [I, I, ctypes.POINTER(ctypes.c_int)]
        lib.pell_cg_fused_solve.argtypes = [
            P, I, P, I, P, P, I, I, L,  # values, qidx, bases, tile_ptr, S, G, n
            P, P, P, P,  # r0, x0, minv, tol_sq
            I, I, I,  # max_iters, implicit, flexible
            P, P, P, P, P, I,  # x, r, p, q, partials, blocks
            P, P, P, P,  # it_out, mon_out, conv_out, stream
        ]
        lib.pell_cg_fused_grid.restype = I
        lib.pell_cg_fused_solve.restype = I
        lib.gk_error_string.argtypes = [I]
        lib.gk_error_string.restype = ctypes.c_char_p
        lib.gk_typed = True
    return lib


def _prepare(A, vec, tol_sq_eff, what):
    """Check a whole-solve Pell kernel's operands; returns (n, codes, tol)."""
    dev = vec.device
    n = check_fused_pell(A, dev, what)
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(1).contiguous()
    return n, (DTYPE_CODE[A.values.dtype], INDEX_CODE[A.qidx.dtype]), tol


def _status(it_conv, mon):
    return it_conv[0], mon[0], it_conv[1] != 0


def pell_cg_fused(A, r0, x0, minv=None, *, tol_sq_eff, max_iters,
                  use_implicit=False, flexible=False):
    """K7: run CG (FCG with ``flexible=True``) on a square Pell to the stop
    test in one kernel.  Values float32/bfloat16, lane indices int8/int32;
    r0, x0, minv: (n,) float32; tol_sq_eff: a float32 device scalar.
    Returns (x, r, iterations int32, monitored_sq float32, converged bool)
    as device tensors."""
    if on_cpu(r0):
        return pell_cg_solve_reference(
            A, r0, x0, minv, tol_sq_eff=tol_sq_eff, max_iters=max_iters,
            use_implicit=use_implicit, flexible=flexible,
        )
    dev = r0.device
    n, codes, tol = _prepare(A, r0, tol_sq_eff, "pell_cg_fused")
    check_solve_vectors("pell_cg_fused", (n,), dev, (r0, x0), minv, tol, 1)
    lib = _lib()
    blocks = coop_grid_blocks(lib, "pell_cg_fused_grid", codes, dev)
    x, r, p, q = (torch.empty_like(r0) for _ in range(4))
    part = torch.empty(4 * blocks, dtype=torch.float64, device=dev)
    it_conv = torch.empty(2, dtype=torch.int32, device=dev)
    mon = torch.empty(1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.pell_cg_fused_solve(
            *pell_plan_args(A), n, r0.data_ptr(), x0.data_ptr(),
            None if minv is None else minv.data_ptr(), tol.data_ptr(),
            min(int(max_iters), 2**31 - 1), int(bool(use_implicit)),
            int(bool(flexible)),
            x.data_ptr(), r.data_ptr(), p.data_ptr(), q.data_ptr(),
            part.data_ptr(), blocks, it_conv.data_ptr(), mon.data_ptr(),
            it_conv[1:].data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "pell_cg_fused")
    pell_cg_fused.launches += 1
    return (x, r, *_status(it_conv, mon))


pell_cg_fused.launches = 0


def pell_bicgstab_fused(A, r0, x0, minv=None, *, tol_sq_eff, max_iters, use_implicit=False):
    """K19: run right-preconditioned BiCGSTAB (M applied explicitly) on a
    square Pell to the stop test in one kernel, with K12's semantics.
    Values float32/bfloat16, lane indices int8/int32; r0, x0, minv: (n,)
    float32; tol_sq_eff: a float32 device scalar.  Returns (x, r,
    iterations int32, monitored_sq float32, converged bool) as device
    tensors."""
    if on_cpu(r0):
        return pell_bicgstab_solve_reference(A, r0, x0, minv, tol_sq_eff=tol_sq_eff,
                                             max_iters=max_iters, use_implicit=use_implicit)
    dev = r0.device
    n, codes, tol = _prepare(A, r0, tol_sq_eff, "pell_bicgstab_fused")
    check_solve_vectors("pell_bicgstab_fused", (n,), dev, (r0, x0), minv, tol, 1)
    lib = _bicgstab._lib()
    blocks = coop_grid_blocks(lib, "pell_bicgstab_fused_grid", codes, dev)
    x, r, rr, v, t, p, s = (torch.empty_like(r0) for _ in range(7))
    part = torch.empty(6 * blocks, dtype=torch.float64, device=dev)
    it_conv = torch.empty(2, dtype=torch.int32, device=dev)
    mon = torch.empty(1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.pell_bicgstab_fused_solve(
            *pell_plan_args(A), n, r0.data_ptr(), x0.data_ptr(),
            None if minv is None else minv.data_ptr(), tol.data_ptr(),
            min(int(max_iters), 2**31 - 1), int(bool(use_implicit)),
            x.data_ptr(), r.data_ptr(), rr.data_ptr(), v.data_ptr(), t.data_ptr(),
            p.data_ptr(), s.data_ptr(), part.data_ptr(), blocks, it_conv.data_ptr(),
            mon.data_ptr(), it_conv[1:].data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "pell_bicgstab_fused")
    pell_bicgstab_fused.launches += 1
    return (x, r, *_status(it_conv, mon))


pell_bicgstab_fused.launches = 0


def pell_cgs_fused(A, r0, x0, minv=None, *, tol_sq_eff, max_iters, use_implicit=False):
    """K20: run CGS (M applied explicitly) on a square Pell to the stop test
    in one kernel, with K13's semantics.  Operands as K19's.  Returns (x,
    r, iterations int32, monitored_sq float32, converged bool) as device
    tensors."""
    if on_cpu(r0):
        return pell_cgs_solve_reference(A, r0, x0, minv, tol_sq_eff=tol_sq_eff,
                                        max_iters=max_iters, use_implicit=use_implicit)
    dev = r0.device
    n, codes, tol = _prepare(A, r0, tol_sq_eff, "pell_cgs_fused")
    check_solve_vectors("pell_cgs_fused", (n,), dev, (r0, x0), minv, tol, 1)
    lib = _cgs._lib()
    blocks = coop_grid_blocks(lib, "pell_cgs_fused_grid", codes, dev)
    vecs = [torch.empty_like(r0) for _ in range(8)]  # x, r, rr, q, u, v, p, w
    part = torch.empty(3 * blocks, dtype=torch.float64, device=dev)
    it_conv = torch.empty(2, dtype=torch.int32, device=dev)
    mon = torch.empty(1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.pell_cgs_fused_solve(
            *pell_plan_args(A), n, r0.data_ptr(), x0.data_ptr(),
            None if minv is None else minv.data_ptr(), tol.data_ptr(),
            min(int(max_iters), 2**31 - 1), int(bool(use_implicit)),
            *(v.data_ptr() for v in vecs), part.data_ptr(), blocks, it_conv.data_ptr(),
            mon.data_ptr(), it_conv[1:].data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "pell_cgs_fused")
    pell_cgs_fused.launches += 1
    return (vecs[0], vecs[1], *_status(it_conv, mon))


pell_cgs_fused.launches = 0


def pell_ir_fused(A, b, x0, minv=None, *, omega, tol_sq_eff, max_iters):
    """K21: run IR/Richardson sweeps on a square Pell to the stop test in
    one kernel, the monitor starting at r0's r.r (no sweep when r0 meets
    the threshold).  b, x0, minv: (n,) float32; omega: the relaxation
    factor; tol_sq_eff: the squared absolute threshold on r.r (negative:
    run to max_iters), a float32 device scalar.  Returns (x, iterations
    int32, r.r float32, converged bool) as device tensors."""
    if on_cpu(b):
        return pell_ir_solve_reference(A, b, x0, minv, omega=omega, tol_sq_eff=tol_sq_eff,
                                       max_iters=max_iters)
    dev = b.device
    n, codes, tol = _prepare(A, b, tol_sq_eff, "pell_ir_fused")
    check_solve_vectors("pell_ir_fused", (n,), dev, (b, x0), minv, tol, 1)
    lib = _ir._lib()
    blocks = coop_grid_blocks(lib, "pell_ir_fused_grid", codes, dev)
    x = torch.empty_like(b)
    r = torch.empty_like(b)
    part = torch.empty(blocks, dtype=torch.float64, device=dev)
    it_conv = torch.empty(2, dtype=torch.int32, device=dev)
    rr = torch.empty(1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.pell_ir_fused_solve(
            *pell_plan_args(A), n, b.data_ptr(), x0.data_ptr(),
            None if minv is None else minv.data_ptr(), tol.data_ptr(), float(omega),
            min(int(max_iters), 2**31 - 1), x.data_ptr(), r.data_ptr(), part.data_ptr(),
            blocks, it_conv.data_ptr(), rr.data_ptr(), it_conv[1:].data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "pell_ir_fused")
    pell_ir_fused.launches += 1
    it, rr_out, conv = _status(it_conv, rr)
    return x, it, rr_out, conv


pell_ir_fused.launches = 0
