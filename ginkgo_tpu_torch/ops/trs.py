"""Whole-solve sweep triangular solve: kernel K22 and its plain version.

Counterpart of ``ginkgo_tpu/ops/pallas_trs.py`` ``trs_vmem_solve`` (K22,
``_trs_kernel``, :47-84): x ~ T^{-1} b by all the Jacobi-Richardson sweeps
of ``TriangularSolver``'s 'sweeps' algorithm in one kernel launch,

    x0 = invd * b,    x <- invd * (b - N x)   (``sweeps`` times),

N the strict triangle as a ``Dia`` (float32 or bfloat16 diagonals), invd
the float32 inverse diagonal, b one float32 column.  The kernel is in
``csrc/trs_fused.cu`` with K23 and K24, which run the same sweeps inside
their solves; the plain version is their shared ``ops/cg_ilu._tri_sweeps``.
"""

from __future__ import annotations

import torch

from .cg import check_fused_diags, coop_grid_blocks
from .cg_ilu import _lib, _tri_sweeps, check_vector
from .dia import DTYPE_CODE, check_status, offsets_array, on_cpu


def trs_reference(T, invd, b, *, sweeps):
    """K22's plain version.  T: ``Dia`` strict triangle; invd, b: (n,)
    float32.  Returns x (n,) float32."""
    return _tri_sweeps(T, invd, b, sweeps)


def trs_fused(T, invd, b, *, sweeps):
    """K22: x ~ T^{-1} b by ``sweeps`` sweeps in one kernel.  T: square
    ``Dia`` strict triangle with 1 to 64 float32/bfloat16 diagonals; invd,
    b: (n,) float32 on its device.  Returns x (n,) float32."""
    if on_cpu(b):
        return trs_reference(T, invd, b, sweeps=sweeps)
    dev = b.device
    n = T.shape[0]
    if T.shape != (n, n):
        raise ValueError("trs_fused: the triangle must be square")
    check_fused_diags(T.diags, T.offsets, dev, "trs_fused")
    check_vector("trs_fused", invd, n, dev)
    check_vector("trs_fused", b, n, dev)
    if sweeps < 0:
        raise ValueError("trs_fused: sweeps must be >= 0")
    lib = _lib()
    code = DTYPE_CODE[T.diags.dtype]
    blocks = coop_grid_blocks(lib, "trs_fused_grid", (code,), dev)
    x = torch.empty_like(b)
    tmp = torch.empty_like(b)
    with torch.cuda.device(dev):
        status = lib.trs_fused_solve(
            T.diags.data_ptr(), code, offsets_array(T.offsets), len(T.offsets), n,
            invd.data_ptr(), b.data_ptr(), int(sweeps), x.data_ptr(), tmp.data_ptr(), blocks,
            torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "trs_fused")
    trs_fused.launches += 1
    return x


trs_fused.launches = 0
