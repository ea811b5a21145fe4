"""Whole-solve fused CG/FCG on a Pell operator: kernel K7 and its plain
version.

Counterpart of ``ginkgo_tpu/ops/pallas_pell_cg.py`` ``pell_cg_vmem_solve``
(``_pell_cg_kernel``).  The Krylov loop of a general unstructured matrix,
its slot SpMV, an Identity or inverse-diagonal preconditioner and the stop
test run in one persistent cooperative CUDA kernel
(``csrc/pell_cg_fused.cu``), with the semantics of K4 (``ops/cg.py``).
The JAX kernel sums its dot products in float32, K7 and its plain version
in float64, so iteration counts agree with the JAX kernel only up to a
tolerance.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .cg import check_solve_vectors, cg_loop_reference, coop_grid_blocks
from .dia import DTYPE_CODE, check_status, on_cpu
from .pell import INDEX_CODE, check_plan, pell_spmv_reference

FUSED_VALUE_DTYPES = (torch.float32, torch.bfloat16)


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
    check_plan(A, dev, "pell_cg_fused")
    n = A.shape[0]
    if A.shape[1] != n:
        raise ValueError(f"pell_cg_fused: the operator must be square, got {A.shape}")
    if A.values.dtype not in FUSED_VALUE_DTYPES:
        raise TypeError(f"pell_cg_fused: values must be float32/bfloat16, got {A.values.dtype}")
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(1).contiguous()
    check_solve_vectors("pell_cg_fused", (n,), dev, (r0, x0), minv, tol, 1)
    lib = _lib()
    codes = (DTYPE_CODE[A.values.dtype], INDEX_CODE[A.qidx.dtype])
    blocks = coop_grid_blocks(lib, "pell_cg_fused_grid", codes, dev)
    x = torch.empty_like(r0)
    r = torch.empty_like(r0)
    p = torch.empty_like(r0)
    q = torch.empty_like(r0)
    part = torch.empty(4 * blocks, dtype=torch.float64, device=dev)
    it_conv = torch.empty(2, dtype=torch.int32, device=dev)
    mon = torch.empty(1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.pell_cg_fused_solve(
            A.values.data_ptr(), codes[0], A.qidx.data_ptr(), codes[1],
            A.bases.data_ptr(), A.tile_ptr.data_ptr(), A.S, A.G, n,
            r0.data_ptr(), x0.data_ptr(),
            None if minv is None else minv.data_ptr(), tol.data_ptr(),
            min(int(max_iters), 2**31 - 1), int(bool(use_implicit)),
            int(bool(flexible)),
            x.data_ptr(), r.data_ptr(), p.data_ptr(), q.data_ptr(),
            part.data_ptr(), blocks, it_conv.data_ptr(), mon.data_ptr(),
            it_conv[1:].data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "pell_cg_fused")
    pell_cg_fused.launches += 1
    return x, r, it_conv[0], mon[0], it_conv[1] != 0


pell_cg_fused.launches = 0
