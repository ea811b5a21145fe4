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
are kernels of their own beside the Dia kernels K12, K13 and K17
(``csrc/bicgstab_fused.cu``, ``cgs_fused.cu``, ``ir_fused.cu``), all four
on K7's chunked rows (pell.cuh ``GkPellChunks``: a thread's rows are the
same in every pass, the tile's slot range is read once for them, and the
gathers are plain loads).  K19 keeps K12's five passes with one fold fewer
an iteration (s.s folded with t.s and t.t); K20 keeps K13's four; K21 runs
one pass and one grid barrier a sweep.  The plain versions are the loops
over an SpMV callable (``ops/bicgstab.bicgstab_loop_reference``,
``ops/cgs.cgs_loop_reference``, ``ops/ir.ir_loop_reference``).

The four kernels index rows in 32 bits, a chunk of :data:`CHUNK_ROWS` rows
past the last: :func:`chunk_rows_fit` says whether a Pell of n rows fits,
and the solvers' routes decline one that does not.

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
from ..log.logger import logged_kernel
from . import bicgstab as _bicgstab
from . import cgs as _cgs
from . import ir as _ir
from .bicgstab import bicgstab_loop_reference
from .cg import check_solve_vectors, cg_loop_reference, coop_grid_blocks
from .cgs import cgs_loop_reference
from .dia import DTYPE_CODE, check_status, on_cpu
from .ir import ir_loop_reference
from .pell import INDEX_CODE, check_fused_pell, pell_plan_args, pell_spmv_reference


#: rows of a chunk of K7 and K19-K21 (256 threads x 4 rows; csrc/pell.cuh
#: GK_PELL_CHUNK_ROWS)
CHUNK_ROWS = 1024
#: most rows K7 and K19-K21 take: their rows are 32-bit, with a chunk past the last
MAX_CHUNKED_ROWS = 2**31 - 1 - CHUNK_ROWS


def chunk_rows_fit(n: int) -> bool:
    """Whether the 32-bit rows of K7 and K19-K21 reach an n-row Pell."""
    return n <= MAX_CHUNKED_ROWS


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


def pell_ir_solve_reference(A, b, x0, minv=None, *, omega, tol_sq_eff, max_iters,
                            with_residual=False):
    """K21's plain version.  A: a square Pell; b, x0, minv: (n,) float32.
    Returns (x, r, iterations int32, r.r float32, converged), r = b - A x
    with ``with_residual``, else None."""
    x, r, it, rr, conv = ir_loop_reference(
        lambda v: pell_spmv_reference(A, v), b, x0, minv, omega=omega,
        tol_sq_eff=tol_sq_eff, max_iters=max_iters, monitor_from_r0=True,
    )
    return x, r if with_residual else None, it, rr, conv


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
        lib.pell_cg_fused_config.argtypes = [I, I, ctypes.POINTER(ctypes.c_int)]
        lib.pell_cg_fused_grid.restype = I
        lib.pell_cg_fused_config.restype = I
        lib.pell_cg_fused_solve.restype = I
        lib.gk_error_string.argtypes = [I]
        lib.gk_error_string.restype = ctypes.c_char_p
        lib.gk_typed = True
    return lib


#: the fields of :func:`pell_cg_fused_launch`, in the C entry point's order
LAUNCH_FIELDS = ("blocks", "threads", "blocks_per_sm", "registers")


def pell_cg_fused_launch(A, device=None):
    """K7's launch for the value and lane-index dtypes of the Pell A on a
    CUDA device: the cooperative grid's blocks, threads a block, blocks an
    SM and registers a thread."""
    lib = _lib()
    out = (ctypes.c_int * len(LAUNCH_FIELDS))()
    with torch.cuda.device(device):
        status = lib.pell_cg_fused_config(DTYPE_CODE[A.values.dtype], INDEX_CODE[A.qidx.dtype],
                                          out)
    check_status(lib, status, "pell_cg_fused_config")
    return dict(zip(LAUNCH_FIELDS, out))


def _prepare(A, vec, tol_sq_eff, what):
    """Check a whole-solve Pell kernel's operands; returns (n, codes, tol)."""
    dev = vec.device
    n = check_fused_pell(A, dev, what)
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(1).contiguous()
    return n, (DTYPE_CODE[A.values.dtype], INDEX_CODE[A.qidx.dtype]), tol


def _status(it_conv, mon):
    return it_conv[0], mon[0], it_conv[1] != 0


@logged_kernel
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


def pell_krylov_launch(kernel, A, device):
    """K19's (``kernel`` "pell_bicgstab_fused") or K20's
    ("pell_cgs_fused") launch for the value and lane-index dtypes of the
    Pell A on a CUDA device: the cooperative grid's blocks, threads a
    block, blocks an SM and registers a thread."""
    lib = (_bicgstab if kernel == "pell_bicgstab_fused" else _cgs)._lib()
    out = (ctypes.c_int * len(LAUNCH_FIELDS))()
    with torch.cuda.device(device):
        status = getattr(lib, f"{kernel}_config")(
            DTYPE_CODE[A.values.dtype], INDEX_CODE[A.qidx.dtype], out)
    check_status(lib, status, f"{kernel}_config")
    return dict(zip(LAUNCH_FIELDS, out))


def _krylov_start(what, lib, A, r0, x0, minv, tol_sq_eff, n_vec, n_part):
    """Check K19's or K20's operands; returns (n, tol, blocks, n_vec
    vectors, n_part doubles of partials a block, the iterations and stop
    flag, the monitor), the buffers on r0's device."""
    dev = r0.device
    n, codes, tol = _prepare(A, r0, tol_sq_eff, what)
    check_solve_vectors(what, (n,), dev, (r0, x0), minv, tol, 1)
    blocks = coop_grid_blocks(lib, f"{what}_grid", codes, dev)
    vecs = [torch.empty_like(r0) for _ in range(n_vec)]
    part = torch.empty(n_part * blocks, dtype=torch.float64, device=dev)
    it_conv = torch.empty(2, dtype=torch.int32, device=dev)
    mon = torch.empty(1, dtype=torch.float32, device=dev)
    return n, tol, blocks, vecs, part, it_conv, mon


def _ptr(a):
    return None if a is None else a.data_ptr()


@logged_kernel
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
    lib = _bicgstab._lib()
    # x, r, rr, v, t, p, s, and y = M p, z = M s with Jacobi
    n, tol, blocks, vecs, part, it_conv, mon = _krylov_start(
        "pell_bicgstab_fused", lib, A, r0, x0, minv, tol_sq_eff, 7 + 2 * (minv is not None), 6)
    with torch.cuda.device(r0.device):
        status = lib.pell_bicgstab_fused_solve(
            *pell_plan_args(A), n, r0.data_ptr(), x0.data_ptr(), _ptr(minv), tol.data_ptr(),
            min(int(max_iters), 2**31 - 1), int(bool(use_implicit)),
            *(v.data_ptr() for v in vecs[:7]), *(_ptr(v) for v in (vecs[7:] or [None, None])),
            part.data_ptr(), blocks, it_conv.data_ptr(), mon.data_ptr(), it_conv[1:].data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "pell_bicgstab_fused")
    pell_bicgstab_fused.launches += 1
    return (vecs[0], vecs[1], *_status(it_conv, mon))


pell_bicgstab_fused.launches = 0


@logged_kernel
def pell_cgs_fused(A, r0, x0, minv=None, *, tol_sq_eff, max_iters, use_implicit=False):
    """K20: run CGS (M applied explicitly) on a square Pell to the stop test
    in one kernel, with K13's semantics.  Operands as K19's.  Returns (x,
    r, iterations int32, monitored_sq float32, converged bool) as device
    tensors."""
    if on_cpu(r0):
        return pell_cgs_solve_reference(A, r0, x0, minv, tol_sq_eff=tol_sq_eff,
                                        max_iters=max_iters, use_implicit=use_implicit)
    lib = _cgs._lib()
    # x, r, rr, q, u, v, p, w = M (u + q), and y = M p with Jacobi
    n, tol, blocks, vecs, part, it_conv, mon = _krylov_start(
        "pell_cgs_fused", lib, A, r0, x0, minv, tol_sq_eff, 8 + (minv is not None), 3)
    with torch.cuda.device(r0.device):
        status = lib.pell_cgs_fused_solve(
            *pell_plan_args(A), n, r0.data_ptr(), x0.data_ptr(), _ptr(minv), tol.data_ptr(),
            min(int(max_iters), 2**31 - 1), int(bool(use_implicit)),
            *(v.data_ptr() for v in vecs[:8]), _ptr(vecs[8] if len(vecs) > 8 else None),
            part.data_ptr(), blocks, it_conv.data_ptr(), mon.data_ptr(), it_conv[1:].data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "pell_cgs_fused")
    pell_cgs_fused.launches += 1
    return (vecs[0], vecs[1], *_status(it_conv, mon))


pell_cgs_fused.launches = 0


@logged_kernel
def pell_ir_fused(A, b, x0, minv=None, *, omega, tol_sq_eff, max_iters, with_residual=False):
    """K21: run IR/Richardson sweeps on a square Pell to the stop test in
    one kernel, the monitor starting at r0's r.r (no sweep when r0 meets
    the threshold).  b, x0, minv: (n,) float32; omega: the relaxation
    factor; tol_sq_eff: the squared absolute threshold on r.r (negative:
    run to max_iters), a float32 device scalar.  Returns (x, r, iterations
    int32, r.r float32, converged bool) as device tensors; r = b - A x is
    formed once, after the last sweep, with ``with_residual``, else None."""
    if on_cpu(b):
        return pell_ir_solve_reference(A, b, x0, minv, omega=omega, tol_sq_eff=tol_sq_eff,
                                       max_iters=max_iters, with_residual=with_residual)
    dev = b.device
    n, codes, tol = _prepare(A, b, tol_sq_eff, "pell_ir_fused")
    check_solve_vectors("pell_ir_fused", (n,), dev, (b, x0), minv, tol, 1)
    lib = _ir._lib()
    blocks = coop_grid_blocks(lib, "pell_ir_fused_grid", codes, dev)
    x, xb = torch.empty_like(b), torch.empty_like(b)
    r = torch.empty_like(b) if with_residual else None
    # two halves used in turn, one double a block each
    part = torch.empty(2 * blocks, dtype=torch.float64, device=dev)
    it_conv = torch.empty(2, dtype=torch.int32, device=dev)
    rr = torch.empty(1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.pell_ir_fused_solve(
            *pell_plan_args(A), n, b.data_ptr(), x0.data_ptr(),
            None if minv is None else minv.data_ptr(), tol.data_ptr(), float(omega),
            min(int(max_iters), 2**31 - 1), x.data_ptr(), xb.data_ptr(),
            None if r is None else r.data_ptr(),
            part.data_ptr(), blocks, it_conv.data_ptr(), rr.data_ptr(), it_conv[1:].data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "pell_ir_fused")
    pell_ir_fused.launches += 1
    return (x, r, *_status(it_conv, rr))


pell_ir_fused.launches = 0
