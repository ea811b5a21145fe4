"""Whole-solve sweep triangular solve: kernel K22 and its plain version.

Counterpart of ``ginkgo_tpu/ops/pallas_trs.py`` ``trs_vmem_solve`` (K22,
``_trs_kernel``, :47-84): x ~ T^{-1} b by all the Jacobi-Richardson sweeps
of ``TriangularSolver``'s 'sweeps' algorithm in one kernel launch,

    x0 = invd * b,    x <- invd * (b - N x)   (``sweeps`` times),

N the strict triangle as a ``Dia`` (float32 or bfloat16 diagonals), invd
the float32 inverse diagonal, b one float32 column.  The kernel is in
``csrc/trs_fused.cu`` with K23 and K24, which run the same sweeps inside
their solves; the plain version is their shared ``ops/cg_ilu._tri_sweeps``.

Two routes, chosen by the solve's shape (``ops/tri_walk.py``): where the
triangle's offsets are all of one sign, there is at least one sweep and the
walk's rings fit a block's shared memory, a plain launch of the pipelined
walk (``csrc/tri_walk.cuh``, no grid barrier); otherwise the cooperative
barrier routine, one grid barrier a sweep.  Both give the plain version's bits.  ``trs_fused.routes`` counts
the launches of each route.
"""

from __future__ import annotations

import torch

from ..log.logger import logged_kernel
from . import tri_walk
from .cg import check_fused_diags
from .cg_ilu import _lib, _tri_sweeps, check_vector
from .dia import DTYPE_CODE, check_status, offsets_array, on_cpu


def trs_reference(T, invd, b, *, sweeps):
    """K22's plain version.  T: ``Dia`` strict triangle; invd, b: (n,)
    float32.  Returns x (n,) float32."""
    return _tri_sweeps(T, invd, b, sweeps)


def trs_fused_launch(T, sweeps, device):
    """K22's route and launch for the triangle T at ``sweeps`` sweeps on a
    CUDA device (``ops/tri_walk.plan``): "pipelined", a plain launch with
    no grid barrier, or "barrier", one grid barrier a sweep."""
    args = (DTYPE_CODE[T.diags.dtype], tuple(T.offsets), len(T.offsets), T.shape[0], int(sweeps))
    return tri_walk.plan(_lib(), "trs_fused_plan", args, 1, device)


@logged_kernel
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
    launch = trs_fused_launch(T, sweeps, dev)
    x = torch.empty_like(b)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if launch["route"] == "pipelined":
            diags, invd, b = (tri_walk.aligned(t) for t in (T.diags, invd, b))
            status = lib.trs_walk_solve(
                diags.data_ptr(), code, offsets_array(T.offsets), len(T.offsets), n,
                invd.data_ptr(), b.data_ptr(), int(sweeps), x.data_ptr(), launch["blocks"], stream,
            )
        else:
            tmp = torch.empty_like(b)
            status = lib.trs_fused_solve(
                T.diags.data_ptr(), code, offsets_array(T.offsets), len(T.offsets), n,
                invd.data_ptr(), b.data_ptr(), int(sweeps), x.data_ptr(), tmp.data_ptr(),
                launch["blocks"], stream,
            )
    check_status(lib, status, "trs_fused")
    trs_fused.launches += 1
    trs_fused.routes[launch["route"]] += 1
    return x


trs_fused.launches = 0
trs_fused.routes = {"pipelined": 0, "barrier": 0}
