"""Blocked-ELL (BELL) SpMV and SpMM: kernels K10 and K11 with their plain
versions.

Counterpart of ``ginkgo_tpu/ops/pallas_bell.py``.  Layout
(``matrix/bell.py``): values (NRB, K, BR, 128) dense panels, panel_ids
(NRB, K) int32 with padding panels at id 0 and zero values:

  y[r] = sum_k sum_l values[r // BR, k, r % BR, l] * x[128 * pid[r // BR, k] + l]

with x's last panel cut at n_cols.  The kernels (``csrc/bell_spmv.cu``)
take float32 vectors with float32 or bfloat16 panels, the types the JAX
package sends to its Pallas kernels; ``matrix.bell.Bell.apply`` takes the
JAX package's XLA-path arithmetic for every other type.  The sums run in a
fixed order, kept by kernel and plain version alike: per panel a lane sum
over l = 0..127 from 0, then the panel sums in panel order.  K10 streams
the panel rows and the x panels they read through a ring of shared memory
in persistent blocks; K11 streams them the same way with X's panels k
columns wide, a launch for every group of 8 columns.  A row's running total
lives in shared memory while its row block streams past; where a block's
totals do not fit (wide row blocks: K10 from about 32,000 rows, K11 at 8
columns from about 5,200), they live in y itself, with the same adds in the
same order (``global_totals`` in the launch).
:func:`spmv_launch` and :func:`spmm_launch` report their launches.  A wrapper
takes the plain version only for a tensor on the CPU; on a CUDA tensor it
launches the kernel or raises, and counts its launches in ``launches``.
The operator argument ``A`` is anything with ``values, panel_ids, shape``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..log.logger import logged_kernel
from .dia import DTYPE_CODE, check_status, on_cpu

LANES = 128
PANEL_DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = _build.load("bell_spmv")
    if not hasattr(lib, "gk_typed"):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # values, v_dtype, panel_ids, K, BR
        plan = [P, I, P, I, I]
        lib.bell_spmv.argtypes = plan + [P, P, L, L, P]
        lib.bell_spmm.argtypes = plan + [P, P, L, L, I, P]
        lib.bell_spmv.restype = I
        lib.bell_spmm.restype = I
        lib.bell_spmv_config.argtypes = [I, I, I, L, P]
        lib.bell_spmv_config.restype = I
        lib.bell_spmm_config.argtypes = [I, I, I, L, I, P]
        lib.bell_spmm_config.restype = I
        lib.gk_error_string.argtypes = [I]
        lib.gk_error_string.restype = ctypes.c_char_p
        lib.gk_typed = True
    return lib


# -- plain versions ----------------------------------------------------------------


def _panel_products(A, x):
    """values * x of every panel cell: (NRB, K, BR, 128) for an (n_cols,)
    x, (NRB, K, BR, 128, k) for (n_cols, k); float32."""
    n_cols = A.shape[1]
    npc = -(-n_cols // LANES)
    xp = torch.zeros((npc * LANES,) + tuple(x.shape[1:]), dtype=torch.float32,
                     device=x.device)
    xp[:n_cols] = x
    xg = xp.view((npc, LANES) + tuple(x.shape[1:]))[A.panel_ids.to(torch.int64)]
    vals = A.values.float()
    if x.dim() == 2:
        vals = vals[..., None]
    return vals * xg[:, :, None]


def _ordered_sum(prod):
    """Lane sums over l = 0..127 in order, then panel sums in order:
    (NRB, K, BR, 128[, k]) -> (NRB * BR[, k])."""
    lane = torch.zeros_like(prod[:, :, :, 0])
    for lane_idx in range(LANES):
        lane = lane + prod[:, :, :, lane_idx]
    total = torch.zeros_like(lane[:, 0])
    for k in range(lane.shape[1]):
        total = total + lane[:, k]
    return total.reshape((-1,) + tuple(total.shape[2:]))


def bell_spmv_reference(A, x):
    """y = A x with plain tensor ops, in the kernel's order."""
    return _ordered_sum(_panel_products(A, x))[:A.shape[0]]


def bell_spmm_reference(A, X):
    """Y = A X for X of shape (n_cols, k), each column in the kernel's order."""
    return _ordered_sum(_panel_products(A, X))[:A.shape[0]]


# -- kernel wrappers -------------------------------------------------------------------


def _check_operands(A, x, what):
    if not x.is_cuda:
        raise RuntimeError(f"{what}: x on {x.device}")
    V, pids = A.values, A.panel_ids
    if V.device != x.device or pids.device != x.device:
        raise RuntimeError(f"{what}: the panels and the vectors must be on one device")
    if V.dtype not in PANEL_DTYPES or x.dtype != torch.float32:
        raise TypeError(f"{what}: panels {V.dtype} with vectors {x.dtype}; the kernel "
                        "takes float32/bfloat16 panels with float32 vectors")
    if pids.dtype != torch.int32:
        raise TypeError(f"{what}: panel_ids must be int32")
    if V.dim() != 4 or V.shape[3] != LANES or tuple(pids.shape) != tuple(V.shape[:2]):
        raise ValueError(f"{what}: values must be (NRB, K, BR, 128), panel_ids (NRB, K)")
    if V.shape[0] * V.shape[2] < A.shape[0] or V.shape[1] < 1:
        raise ValueError(f"{what}: the panels cover fewer than {A.shape[0]} rows")
    if not (V.is_contiguous() and pids.is_contiguous()) or V.data_ptr() % 16:
        raise ValueError(f"{what}: panels must be contiguous and 16-byte aligned")
    if x.shape[0] != A.shape[1] or not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous with {A.shape[1]} rows")


def _panel_args(A):
    return (A.values.data_ptr(), DTYPE_CODE[A.values.dtype], A.panel_ids.data_ptr(),
            A.values.shape[1], A.values.shape[2])


#: the fields of :func:`spmv_launch`, in the C entry point's order
LAUNCH_FIELDS = ("blocks", "threads", "smem_bytes", "blocks_per_sm", "registers", "stage_rows",
                 "stages", "global_totals")
#: the fields of :func:`spmm_launch`: K10's and the launches a call makes
SPMM_LAUNCH_FIELDS = LAUNCH_FIELDS + ("column_groups",)
#: columns a K11 launch takes (``GK_BELL_COLS``)
COLUMN_GROUP = 8
#: cudaErrorInvalidConfiguration, the status of a ring that does not fit
_NO_FIT = 9


def spmv_launch(A):
    """K10's launch on the current CUDA device for ``A``'s panels: the
    persistent grid, threads and dynamic shared memory a block, blocks an
    SM, registers a thread, panel rows a stage, stages of the ring and 1
    where the row totals live in y."""
    lib = _lib()
    out = (ctypes.c_int * len(LAUNCH_FIELDS))()
    status = lib.bell_spmv_config(DTYPE_CODE[A.values.dtype], A.values.shape[1],
                                  A.values.shape[2], A.shape[0], out)
    check_status(lib, status, "bell_spmv_config")
    return dict(zip(LAUNCH_FIELDS, out))


def _spmm_config(lib, A, k):
    out = (ctypes.c_int * len(SPMM_LAUNCH_FIELDS))()
    status = lib.bell_spmm_config(DTYPE_CODE[A.values.dtype], A.values.shape[1],
                                  A.values.shape[2], A.shape[0], k, out)
    return status, out


def spmm_launch(A, k):
    """K11's launch on the current CUDA device for ``A``'s panels at ``k``
    columns: as :func:`spmv_launch` for the first (widest) column group,
    and the launches a call makes, one for every group of 8 columns."""
    lib = _lib()
    status, out = _spmm_config(lib, A, k)
    check_status(lib, status, "bell_spmm_config")
    return dict(zip(SPMM_LAUNCH_FIELDS, out))


@logged_kernel
def bell_spmv(A, x):
    """K10: y = A x for one float32 right-hand side x of shape (n_cols,)."""
    if on_cpu(x):
        return bell_spmv_reference(A, x)
    _check_operands(A, x, "bell_spmv")
    if x.dim() != 1:
        raise ValueError("bell_spmv: x must be 1-D")
    lib = _lib()
    y = torch.empty(A.shape[0], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.bell_spmv(*_panel_args(A), x.data_ptr(), y.data_ptr(), A.shape[0],
                               A.shape[1], torch.cuda.current_stream().cuda_stream)
    check_status(lib, status, "bell_spmv")
    bell_spmv.launches += 1
    return y


bell_spmv.launches = 0


@logged_kernel
def bell_spmm(A, X):
    """K11: Y = A X for float32 X of shape (n_cols, k), row-major; each panel
    is read once for every group of 8 columns.  A Bell whose ring does not
    fit a block's shared memory at these columns raises (none that the
    planner accepts: the ring's bytes do not grow with the row blocks)."""
    if on_cpu(X):
        return bell_spmm_reference(A, X)
    _check_operands(A, X, "bell_spmm")
    if X.dim() != 2:
        raise ValueError("bell_spmm: X must be (n_cols, k)")
    lib = _lib()
    k = X.shape[1]
    Y = torch.empty((A.shape[0], k), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        status = lib.bell_spmm(*_panel_args(A), X.data_ptr(), Y.data_ptr(), A.shape[0],
                               A.shape[1], k, torch.cuda.current_stream().cuda_stream)
        if status == _NO_FIT:
            _, out = _spmm_config(lib, A, k)
            raise RuntimeError(
                f"bell_spmm: the ring of {A.values.shape[2]}-row blocks at "
                f"{min(k, COLUMN_GROUP)} columns needs {out[2]} bytes of shared memory a "
                "block, more than this card gives one")
    check_status(lib, status, "bell_spmm")
    bell_spmm.launches += 1
    return Y


bell_spmm.launches = 0
