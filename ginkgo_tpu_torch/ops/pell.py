"""PELL ("panel-gathered ELL") SpMV: the host planner, kernels K5 and K6
with their plain versions, and the Csr plan cache.

Counterpart of ``ginkgo_tpu/ops/spmv_pallas.py``.  Layout: output rows
are tiled S * 128 at a time; a *slot* of tile t is one (S, 128) values
tile, one (S, 128) lane-index tile q and one panel base b.  Cell (s, l) of
a slot holds at most one nonzero of row t * S * 128 + s * 128 + l, whose
column is (b - (S - 1) + s) * 128 + q[s, l]: the S sublanes of a slot read
S consecutive 128-column panels, which lines them up with the diagonal of
any matrix with column locality.  Padding cells hold value 0 and q 0.

:class:`PellPlan` is a copy of the JAX package's numpy planner
(``spmv_pallas.py:91-266``): the same ``values/qidx/bases/tile_of_step``
and ``G/S/NT/NP`` bit for bit, plus one array of its own, ``tile_ptr``
(NT + 1): steps are sorted by tile, so the slots of tile t are the range
``[tile_ptr[t], tile_ptr[t + 1])``, a whole number of G-slot steps.  The
native planner (``native/pell_plan.cpp``) is not carried over.

K5 ``pell_spmv`` and K6 ``pell_spmm`` are ``csrc/pell_spmv.cu``.  A
wrapper takes the plain version only for a tensor on the CPU; on a CUDA
tensor it launches the kernel or raises, and counts its launches in a
``launches`` attribute.  The operator argument ``A`` of the functions here
is anything with ``values, qidx, bases, tile_ptr, S, G, shape``
(``matrix.pell.Pell``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import _build
from ..base import types
from ..log.logger import logged_kernel
from .dia import DTYPE_CODE, VECTOR_DTYPES, check_status, on_cpu

LANES = 128
SUBLANES = 8

# -- auto-G / auto-S cost model --------------------------------------------------
# Kept from the JAX package unchanged so that both planners choose the same
# layout.  They are a TPU's numbers (grid-step overhead, HBM rate) and only
# choose a layout here; measuring them again on the H100 is later work.
_G_STEP_SECONDS = 2e-7
_G_HBM_BYTES_PER_S = 8.3e11
_G_CANDIDATES = (4, 8, 16, 32, 64)
_S_CANDIDATES = (8, 16, 32)

#: Ceiling on the padded slot bytes of a plan the Csr "pallas" strategy
#: builds (8 bytes a cell, as the JAX package counts them).
HARD_PAD_BYTES = 2 << 30
#: Budget of the plan cache (the Csr plans, the route's, and their S = 8
#: siblings), in slot bytes.
PLAN_CACHE_BYTES = 2 << 30

#: index dtype codes of csrc/common.cuh (GkDtype)
INDEX_CODE = {torch.int8: 3, torch.int32: 4}
VALUE_DTYPES = (torch.float32, torch.float64, torch.bfloat16)
#: value dtypes of the whole-solve Pell kernels (K7, K18-K21)
FUSED_VALUE_DTYPES = (torch.float32, torch.bfloat16)


def _g_cost(n_steps: int, total_slots: int, S: int, bytes_per_cell: int) -> float:
    return (
        n_steps * _G_STEP_SECONDS
        + total_slots * S * LANES * bytes_per_cell / _G_HBM_BYTES_PER_S
    )


class PellPlan:
    """Static PELL expansion of a CSR pattern, built on the host in numpy.

    S: sublanes per slot tile (8, 16, 32 or "auto", which scores the three
    with the cost model); G: slots per step ("auto" scores 4 to 64);
    q_dtype: storage of the lane indices (int8 or int32).
    ``materialize=False`` computes the statistics only (n_steps,
    total_cells, inflation), and ``max_cells`` declines a plan
    (``too_large``) before its arrays are allocated.  ``value_itemsize``
    overrides the value width the cost model charges (bfloat16 values reach
    the planner widened to float32)."""

    def __init__(self, indptr, indices, values, shape, G="auto",
                 S=SUBLANES, q_dtype=np.int32, *, materialize: bool = True,
                 max_cells: int | None = None, value_itemsize: int | None = None):
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        values = np.asarray(values)
        nnz_real = int(indptr[-1]) if len(indptr) else 0
        if len(indices) > nnz_real:  # padded storage
            indices = indices[:nnz_real]
            values = values[:nnz_real]
        n_rows, n_cols = int(shape[0]), int(shape[1])
        nnz = len(indices)
        self.shape = (n_rows, n_cols)
        auto_g = G == "auto"
        if value_itemsize is None:
            value_itemsize = values.dtype.itemsize
        bytes_per_cell = value_itemsize + np.dtype(q_dtype).itemsize
        if S == "auto":
            # stats-only probe per candidate (auto-G inside each), keep the
            # least modeled apply cost, then build that layout below
            best = None
            for s_c in _S_CANDIDATES:
                p = PellPlan(indptr, indices, values, shape, G=G, S=s_c,
                             q_dtype=q_dtype, materialize=False,
                             value_itemsize=value_itemsize)
                c = (p.n_steps * _G_STEP_SECONDS
                     + p.total_cells * bytes_per_cell / _G_HBM_BYTES_PER_S)
                if best is None or c < best[0]:
                    best = (c, s_c, p)
            S = best[1]
            if not materialize:
                # the chosen probe is this statistics pass already
                self.__dict__.update(best[2].__dict__)
                self.too_large = max_cells is not None and self.total_cells > max_cells
                return
        self.G = _G_CANDIDATES[0] if auto_g else int(G)
        G = self.G
        self.S = int(S)
        self.pad = self.S - 1
        tile_rows = self.S * LANES
        NT = max(-(-n_rows // tile_rows), 1)
        NP = max(-(-n_cols // LANES), 1)
        self.NT, self.NP = NT, NP
        self.nnz = nnz

        rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
        cols = indices.astype(np.int64)
        t = rows // tile_rows
        s = (rows >> 7) % self.S
        lane = (rows & 127).astype(np.int64)
        p = cols >> 7
        q = (cols & 127).astype(np.int64)
        base = p - s + self.pad  # in [0, NP + 2*pad - 1]

        # occurrence index within each (row, panel) run (cols sorted
        # within rows, so runs are contiguous); < 128 by construction
        rp_key = rows * NP + p
        new_run = np.ones(nnz, bool)
        new_run[1:] = rp_key[1:] != rp_key[:-1]
        run_id = np.cumsum(new_run) - 1
        run_start = np.nonzero(new_run)[0][run_id] if nnz else run_id
        occ = np.arange(nnz, dtype=np.int64) - run_start

        # slot identity per tile: distinct (base, occurrence) pairs,
        # shared across the S sublanes (the diagonal-base alignment)
        NB = NP + 2 * self.pad + 1
        K = (t * NB + base) * 128 + occ
        # each entry's slot (the inverse) only where the arrays are built: a
        # statistics pass takes the sorted keys alone, at a third of the cost
        if materialize:
            uniqK, slot_inv = np.unique(K, return_inverse=True)
        else:
            uniqK = np.unique(K)
        u_t = uniqK // (np.int64(NB) * 128)
        u_base = (uniqK // 128) % NB
        t_change = np.ones(len(uniqK), bool)
        t_change[1:] = u_t[1:] != u_t[:-1]
        g_id = np.cumsum(t_change) - 1
        g_start = np.nonzero(t_change)[0][g_id] if len(uniqK) else g_id
        slot_in_t = np.arange(len(uniqK), dtype=np.int64) - g_start

        K_t = np.zeros(NT, np.int64)
        if len(uniqK):
            np.add.at(K_t, u_t, 1)
        if auto_g:
            best = None
            for g in _G_CANDIDATES:
                st = int(np.maximum(-(-K_t // g), 1).sum())
                c = _g_cost(st, st * g, self.S, bytes_per_cell)
                if best is None or c < best[0]:
                    best = (c, g)
            self.G = G = best[1]
        steps_t = np.maximum(-(-K_t // G), 1)
        K_t_pad = steps_t * G
        slot_off = np.concatenate([[0], np.cumsum(K_t_pad)])
        total_slots = int(slot_off[-1])
        self.n_steps = int(steps_t.sum())
        self.total_cells = total_slots * tile_rows
        self.inflation = self.total_cells / max(nnz, 1)
        self.val_dtype = values.dtype
        self.q_dtype = np.dtype(q_dtype)

        # the padding gate runs before the padded arrays exist
        self.too_large = max_cells is not None and self.total_cells > max_cells
        if not materialize or self.too_large:
            self.values = self.qidx = self.bases = None
            self.tile_of_step = self.tile_ptr = None
            return

        vals_arr = np.zeros((total_slots, self.S, LANES), values.dtype)
        q_arr = np.zeros((total_slots, self.S, LANES), q_dtype)
        bases = np.zeros(total_slots, np.int32)
        if nnz:
            slot_of_pair = slot_off[u_t] + slot_in_t
            gslot = slot_of_pair[slot_inv]
            vals_arr[gslot, s, lane] = values
            q_arr[gslot, s, lane] = q
            bases[slot_of_pair] = u_base.astype(np.int32)
        self.values = vals_arr
        self.qidx = q_arr
        self.bases = bases
        self.tile_of_step = np.repeat(np.arange(NT, dtype=np.int32), steps_t)
        self.tile_ptr = slot_off.astype(np.int32)


def tile_ptr_from_steps(tile_of_step, NT: int, G: int) -> np.ndarray:
    """tile_ptr from a plan's step -> tile map (steps sorted by tile)."""
    steps_t = np.bincount(np.asarray(tile_of_step, np.int64), minlength=NT)
    return np.concatenate([[0], np.cumsum(steps_t * G)]).astype(np.int32)


def _lib():
    lib = _build.load("pell_spmv")
    if not hasattr(lib, "gk_typed"):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        plan = [P, I, P, I, P, P, I, I]  # values, qidx, bases, tile_ptr, S, G
        lib.pell_spmv.argtypes = plan + [P, I, P, L, L, P]
        lib.pell_spmm.argtypes = plan + [P, I, P, L, L, I, P]
        lib.pell_spmv.restype = I
        lib.pell_spmm.restype = I
        # v_dtype, q_dtype, x_dtype, n_rows, out
        lib.pell_spmv_config.argtypes = [I, I, I, L, P]
        lib.pell_spmv_config.restype = I
        lib.gk_error_string.argtypes = [I]
        lib.gk_error_string.restype = ctypes.c_char_p
        lib.gk_typed = True
    return lib


def check_plan(A, dev, what):
    """The plan arrays of ``A`` as the kernels take them, on ``dev``."""
    slots = A.values.shape[0]
    cells = (slots, A.S, LANES)
    if any(t.device != dev for t in (A.values, A.qidx, A.bases, A.tile_ptr)):
        raise RuntimeError(f"{what}: the plan and the vectors must be on one device")
    if A.values.dtype not in VALUE_DTYPES or A.qidx.dtype not in INDEX_CODE:
        raise TypeError(f"{what}: values {A.values.dtype}, lane indices {A.qidx.dtype}")
    if A.bases.dtype != torch.int32 or A.tile_ptr.dtype != torch.int32:
        raise TypeError(f"{what}: bases and tile_ptr must be int32")
    if tuple(A.values.shape) != cells or tuple(A.qidx.shape) != cells:
        raise ValueError(f"{what}: values and qidx must be (slots, S, 128)")
    if A.bases.shape != (slots,) or A.tile_ptr.dim() != 1:
        raise ValueError(f"{what}: bases must be (slots,), tile_ptr (NT + 1,)")
    if (A.tile_ptr.shape[0] - 1) * A.S * LANES < A.shape[0]:
        raise ValueError(f"{what}: the plan's tiles cover fewer than {A.shape[0]} rows")
    if not all(t.is_contiguous() for t in (A.values, A.qidx, A.bases, A.tile_ptr)):
        raise ValueError(f"{what}: plan arrays must be contiguous")


def check_fused_pell(A, dev, what):
    """The operator of a whole-solve Pell kernel (K7, K18-K21): a square
    plan on ``dev`` with float32 or bfloat16 values.  Returns its rows."""
    check_plan(A, dev, what)
    n = A.shape[0]
    if A.shape[1] != n:
        raise ValueError(f"{what}: the operator must be square, got {A.shape}")
    if A.values.dtype not in FUSED_VALUE_DTYPES:
        raise TypeError(f"{what}: values must be float32/bfloat16, got {A.values.dtype}")
    return n


def _check_operands(A, x, what):
    if not x.is_cuda:
        raise RuntimeError(f"{what}: x on {x.device}")
    check_plan(A, x.device, what)
    if x.dtype not in VECTOR_DTYPES:
        raise TypeError(f"{what}: vectors must be float32/float64, got {x.dtype}")
    if x.shape[0] != A.shape[1] or not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous with {A.shape[1]} rows")


# -- plain versions ----------------------------------------------------------------


def _slot_products(A, x, slots, acc_dtype):
    """values * x[column] of every cell of ``slots``: (len, S, 128) for an
    (n_cols,) x, (len, S, 128, k) for (n_cols, k).  A column outside
    [0, n_cols) reads 0, as the TPU kernel's zero pad panels do."""
    S, n_cols = A.S, A.shape[1]
    sub = torch.arange(S, device=x.device)
    panel = A.bases[slots].to(torch.int64)[:, None] - (S - 1) + sub[None, :]
    col = panel[:, :, None] * LANES + A.qidx[slots].to(torch.int64)
    ok = (col >= 0) & (col < n_cols)
    xv = x.to(acc_dtype)[col.clamp(0, max(n_cols - 1, 0))]
    vals = A.values[slots].to(acc_dtype)
    if x.dim() == 2:
        ok, vals = ok[..., None], vals[..., None]
    return vals * torch.where(ok, xv, torch.zeros((), dtype=acc_dtype, device=x.device))


def _tiles(A, device):
    start = A.tile_ptr[:-1].to(torch.int64).to(device)
    count = A.tile_ptr[1:].to(torch.int64).to(device) - start
    return start, count, int(count.max()) if count.numel() else 0


def pell_spmv_reference(A, x):
    """y = A x with plain tensor ops, in the kernel's order: the products
    of G slots sum into a step sum, and the step sums add in slot order."""
    n_rows, n_cols = A.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    S, G = A.S, A.G
    start, count, max_count = _tiles(A, x.device)
    out = torch.zeros((count.shape[0], S, LANES), dtype=acc, device=x.device)
    if n_cols > 0:
        for j in range(0, max_count, G):
            t = torch.nonzero(count > j).flatten()
            step = torch.zeros((t.shape[0], S, LANES), dtype=acc, device=x.device)
            for g in range(G):
                step = step + _slot_products(A, x, start[t] + j + g, acc)
            out[t] = out[t] + step
    return out.reshape(-1)[:n_rows].to(x.dtype)


def pell_spmm_reference(A, X):
    """Y = A X for X of shape (n_cols, k), slot by slot in the kernel's
    order (the TPU SpMM kernel adds each slot's products into the output
    tile directly)."""
    n_rows, n_cols = A.shape
    k = X.shape[1]
    acc = torch.promote_types(X.dtype, torch.float32)
    start, count, max_count = _tiles(A, X.device)
    out = torch.zeros((count.shape[0], A.S, LANES, k), dtype=acc, device=X.device)
    if n_cols > 0:
        for j in range(max_count):
            t = torch.nonzero(count > j).flatten()
            out[t] = out[t] + _slot_products(A, X, start[t] + j, acc)
    return out.reshape(-1, k)[:n_rows].to(X.dtype)


# -- kernel wrappers -------------------------------------------------------------------


def pell_plan_args(A):
    """The plan arguments every Pell kernel's C entry point starts with."""
    return (A.values.data_ptr(), DTYPE_CODE[A.values.dtype], A.qidx.data_ptr(),
            INDEX_CODE[A.qidx.dtype], A.bases.data_ptr(), A.tile_ptr.data_ptr(),
            A.S, A.G)


#: the fields of :func:`spmv_launch`, in the C entry point's order
LAUNCH_FIELDS = ("blocks", "threads", "smem_bytes", "blocks_per_sm", "registers")


def spmv_launch(A, vec_dtype=torch.float32):
    """K5's launch on the current CUDA device for plan ``A`` and vectors of
    ``vec_dtype``: blocks, threads and dynamic shared memory a block,
    blocks an SM and registers a thread."""
    lib = _lib()
    out = (ctypes.c_int * len(LAUNCH_FIELDS))()
    status = lib.pell_spmv_config(DTYPE_CODE[A.values.dtype], INDEX_CODE[A.qidx.dtype],
                                  DTYPE_CODE[vec_dtype], A.shape[0], out)
    check_status(lib, status, "pell_spmv_config")
    return dict(zip(LAUNCH_FIELDS, out))


@logged_kernel
def pell_spmv(A, x):
    """K5: y = A x for one right-hand side x of shape (n_cols,)."""
    if on_cpu(x):
        return pell_spmv_reference(A, x)
    _check_operands(A, x, "pell_spmv")
    if x.dim() != 1:
        raise ValueError("pell_spmv: x must be 1-D")
    lib = _lib()
    y = torch.empty(A.shape[0], dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.pell_spmv(
            *pell_plan_args(A), x.data_ptr(), DTYPE_CODE[x.dtype], y.data_ptr(),
            A.shape[0], A.shape[1], torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "pell_spmv")
    pell_spmv.launches += 1
    return y


pell_spmv.launches = 0


@logged_kernel
def pell_spmm(A, X):
    """K6: Y = A X for X of shape (n_cols, k), row-major; the plan is read
    once for up to 8 columns."""
    if on_cpu(X):
        return pell_spmm_reference(A, X)
    _check_operands(A, X, "pell_spmm")
    if X.dim() != 2:
        raise ValueError("pell_spmm: X must be (n_cols, k)")
    lib = _lib()
    k = X.shape[1]
    Y = torch.empty((A.shape[0], k), dtype=X.dtype, device=X.device)
    with torch.cuda.device(X.device):
        status = lib.pell_spmm(
            *pell_plan_args(A), X.data_ptr(), DTYPE_CODE[X.dtype], Y.data_ptr(),
            A.shape[0], A.shape[1], k, torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "pell_spmm")
    pell_spmm.launches += 1
    return Y


pell_spmm.launches = 0


# -- plan cache + Csr-facing entry ----------------------------------------------------


class _ByteLRU:
    """Bytes-budgeted LRU of plans: eviction by the sum of slot bytes,
    oldest use first; one plan larger than the budget is still kept alone,
    so repeated applies of one huge matrix do not rebuild it."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._d: dict = {}  # key -> (payload, nbytes); insertion = LRU order

    def get(self, key):
        hit = self._d.get(key)
        if hit is None:
            return None
        self._d.pop(key)
        self._d[key] = hit  # most recent use last
        return hit[0]

    def put(self, key, payload, nbytes: int):
        self._d.pop(key, None)
        self._d[key] = (payload, nbytes)
        total = sum(b for _, b in self._d.values())
        while total > self.max_bytes and len(self._d) > 1:
            oldest = next(iter(self._d))
            total -= self._d.pop(oldest)[1]

    def clear(self):
        self._d.clear()

    def __len__(self):
        return len(self._d)

    def total_bytes(self):
        return sum(b for _, b in self._d.values())


_PLAN_CACHE = _ByteLRU(PLAN_CACHE_BYTES)


def _cache_key(leaves, shape, tag=()):
    """A plan's key in the cache: a tag, then the identities and version
    counters of the storage tensors it was built from, then the shape.
    Unlike JAX arrays, a tensor can change in place, and a changed tensor
    gets a new plan."""
    return tuple(tag) + tuple((id(t), t._version) for t in leaves) + (tuple(shape),)


def _cached(key, leaves):
    """(True, the cached plan, None for a cached decline) or (False, None).
    An entry holds its storage tensors, so their ids stay valid while it
    lives; a hit must hold these very tensors."""
    hit = _PLAN_CACHE.get(key)
    if hit is not None and len(hit[0]) == len(leaves) and all(
            a is b for a, b in zip(hit[0], leaves)):
        return True, hit[1]
    return False, None


def _cache_put(key, leaves, A):
    _PLAN_CACHE.put(key, (tuple(leaves), A), 0 if A is None else A.storage_bytes())


def plan_for(row_ptrs, col_idxs, values, shape):
    """The plan operator of a Csr's storage, a ``Pell`` or a ``Well``,
    built once and cached on its three tensors (``_cache_key``).  The plan
    is the cheaper of PELL (S = "auto", int8 lane indices) and WELL by the
    JAX package's cost model (``ops/well.choose_unstructured_plan``).
    Raises MemoryError when neither plan's padded slots fit
    HARD_PAD_BYTES."""
    from .well import choose_unstructured_plan

    leaves = (row_ptrs, col_idxs, values)
    key = _cache_key(leaves, shape)
    hit, A = _cached(key, leaves)
    if hit:
        return A
    plan = choose_unstructured_plan(
        types.to_host(row_ptrs), types.to_host(col_idxs), types.to_host(values),
        shape, q_dtype=np.int8, max_cells=HARD_PAD_BYTES // 8,
        value_itemsize=values.element_size(),
    )
    if plan.too_large:
        raise MemoryError(
            "neither the PELL plan nor the WELL plan of this pattern fits: "
            f"{plan.total_cells * 8 / 2**30:.1f} GB of padded slots "
            f"(inflation {plan.inflation:.0f}x); use the classical or "
            "merge_path strategy, or reorder the matrix to improve column locality"
        )
    A = _plan_operator(plan, values)
    _cache_put(key, leaves, A)
    plan_for.builds += 1
    return A


plan_for.builds = 0


def _sibling8(A, key, leaves, csr_of):
    """The plan operator a k-column product runs, as the JAX package picks
    it: a Pell with S != 8 gets an S = 8 sibling, built once from the CSR
    arrays ``csr_of()`` gives and cached under ``key`` tagged "spmm8" (the
    JAX package measured its SpMM kernel faster at S = 8); a Well (8
    sublanes by construction) or a Pell with S = 8 is its own.  When the S
    = 8 plan would pass HARD_PAD_BYTES, ``A`` stays."""
    if hasattr(A, "rt") or A.S == SUBLANES:
        return A
    key = ("spmm8",) + key
    hit, A8 = _cached(key, leaves)
    if hit:
        return A8
    row_ptrs, col_idxs, values = csr_of()
    p8 = PellPlan(
        types.to_host(row_ptrs), types.to_host(col_idxs), types.to_host(values),
        tuple(A.shape), S=SUBLANES, q_dtype=np.int8, max_cells=HARD_PAD_BYTES // 8,
        value_itemsize=values.element_size(),
    )
    if p8.too_large:
        return A
    A8 = _plan_operator(p8, values)
    _cache_put(key, leaves, A8)
    _sibling8.builds += 1
    return A8


_sibling8.builds = 0


def _spmm_plan(A, row_ptrs, col_idxs, values, shape):
    """The S = 8 sibling (``_sibling8``) of a Csr's plan ``A``."""
    leaves = (row_ptrs, col_idxs, values)
    return _sibling8(A, _cache_key(leaves, shape), leaves, lambda: leaves)


def _plan_operator(plan, values):
    """A host plan as the operator its kernels take, on ``values``'
    device and in their dtype."""
    from ..matrix.pell import Pell
    from ..matrix.well import Well
    from .well import WellPlan

    cls = Well if isinstance(plan, WellPlan) else Pell
    return cls.from_plan(plan, device=values.device, dtype=values.dtype)


def csr_spmv(row_ptrs, col_idxs, values, arr, n_rows):
    """The Csr "pallas" strategy: arr (m, k) through the cached plan; one
    column runs K5 or K8, k columns K6 (on the S = 8 plan) or K9."""
    from .well import plan_spmm, plan_spmv

    shape = (n_rows, arr.shape[0])
    A = plan_for(row_ptrs, col_idxs, values, shape)
    if arr.shape[1] > 1:
        A = _spmm_plan(A, row_ptrs, col_idxs, values, shape)
        return plan_spmm(A, arr.contiguous())
    return plan_spmv(A, arr[:, 0].contiguous())[:, None]


# -- the streaming route of the unstructured formats ------------------------------------

#: the route's padding gates (the JAX package's ``linop_streaming_spmv``
#: defaults): a plan is taken at inflation <= 16 or padded slot bytes <=
#: 256 MiB, and never past HARD_PAD_BYTES
STREAM_MAX_INFLATION = 16.0
STREAM_MAX_PAD_BYTES = 256 << 20

def streaming_plan_choice(indptr, indices, values, shape, *, value_itemsize=None):
    """The host plan the streaming route takes for a CSR pattern, chosen as
    the JAX package's ``linop_streaming_spmv`` chooses it (not as
    ``plan_for`` does): statistics of the S = "auto" PELL plan, of the WELL
    plan only where PELL's inflation passes 4; each admitted at inflation <=
    STREAM_MAX_INFLATION or padded bytes <= STREAM_MAX_PAD_BYTES, and under
    HARD_PAD_BYTES; the cheaper admitted one by the cost model,
    materialized.  Returns a ``PellPlan``, a ``WellPlan`` or None (the route
    declines: an empty pattern or padding past the gates).
    ``value_itemsize`` is the stored values' width (bfloat16 values reach
    the planner widened to float32)."""
    from .well import _SLOT_BASE_SECONDS, WellPlan, _plan_cost

    if value_itemsize is None:
        value_itemsize = np.asarray(values).dtype.itemsize
    pell_s = PellPlan(indptr, indices, values, shape, q_dtype=np.int8, S="auto",
                      materialize=False, value_itemsize=value_itemsize)
    well_s = None
    if pell_s.inflation > 4.0 and pell_s.nnz > 0:
        well_s = WellPlan(indptr, indices, values, shape, materialize=False,
                          value_itemsize=value_itemsize)

    def admitted(stats, bpc):
        pad = stats.total_cells * bpc
        return (stats.nnz > 0 and (stats.inflation <= STREAM_MAX_INFLATION
                                   or pad <= STREAM_MAX_PAD_BYTES)
                and pad <= HARD_PAD_BYTES)

    bpc_p = value_itemsize + 1  # int8 lane indices
    cands = []
    if admitted(pell_s, bpc_p):
        cands.append((_plan_cost(pell_s.n_steps, pell_s.total_cells, bpc_p)
                      + pell_s.n_steps * pell_s.G * _SLOT_BASE_SECONDS, "pell"))
    if well_s is not None and admitted(well_s, well_s.bytes_per_cell):
        cands.append((well_s.modeled_seconds, "well"))
    if not cands:
        return None
    if min(cands)[1] == "pell":
        # the S that S = "auto" picked for the statistics: the same plan as
        # the JAX route's S = "auto" build, without its three probes again
        return PellPlan(indptr, indices, values, shape, q_dtype=np.int8, S=pell_s.S,
                        value_itemsize=value_itemsize)
    return WellPlan(indptr, indices, values, shape, T=well_s.T, value_itemsize=value_itemsize)


def _storage_leaves(op):
    """The storage tensors of a format, in field order, those of its parts
    (a Hybrid's Ell and Coo) included."""
    out = []
    for f in dataclasses.fields(op):
        v = getattr(op, f.name)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif dataclasses.is_dataclass(v):
            out.extend(_storage_leaves(v))
    return out


def _route_key(op):
    """The route's cache key of format ``op`` and its storage tensors."""
    leaves = _storage_leaves(op)
    return _cache_key(leaves, op.shape, ("route", type(op).__name__)), leaves


def streaming_plan(op):
    """The plan operator (a ``Pell`` or a ``Well`` on the format's device)
    that the streaming route runs for format ``op``, or None where the route
    declines: :func:`streaming_plan_choice` on ``op.to_csr()``, built once
    and cached on the format's storage tensors (``_cache_key``, in the one
    cache and budget that the Csr plans use).  A decline is cached too.  The
    CSR view is the format's own: Ell, Sellp, Hybrid and Fbcsr drop stored
    zeros on the way, as the JAX package's do."""
    key, leaves = _route_key(op)
    hit, A = _cached(key, leaves)
    if hit:
        return A
    csr = op.to_csr()
    values = csr.values
    plan = streaming_plan_choice(
        types.to_host(csr.row_ptrs), types.to_host(csr.col_idxs), types.to_host(values),
        tuple(op.shape), value_itemsize=values.element_size())
    A = None if plan is None else _plan_operator(plan, values)
    _cache_put(key, leaves, A)
    if A is not None:
        streaming_plan.builds += 1
    return A


streaming_plan.builds = 0


def _streaming_spmm_plan(op, A):
    """The S = 8 sibling (``_sibling8``) of the route's plan ``A`` of
    format ``op``, built from the format's CSR view."""
    def csr_of():
        csr = op.to_csr()
        return csr.row_ptrs, csr.col_idxs, csr.values

    key, leaves = _route_key(op)
    return _sibling8(A, key, leaves, csr_of)


def linop_streaming_spmv(op, arr):
    """The streaming route of the unstructured formats (Coo, Ell, Sellp,
    Hybrid, SparsityCsr, Fbcsr): arr (m, k) through ``op``'s cached plan;
    one column runs K5 or K8, k columns K6 (on the S = 8 plan) or K9.
    Returns the product in arr's dtype, or None where the route declines
    (counted in ``declines``).  On a CPU tensor the kernels' plain versions
    run; formats call it through ``ops/spmv.try_streaming``, which takes it
    on a CUDA tensor only, as the JAX package takes it on a TPU only.  A
    kernel that fails to build or launch raises."""
    from .well import plan_spmm, plan_spmv

    A = streaming_plan(op)
    if A is None:
        linop_streaming_spmv.declines += 1
        return None
    # the kernels take float32 or float64 vectors; a bfloat16 vector widens
    # exactly and the product comes back in its dtype
    x = arr if arr.dtype in VECTOR_DTYPES else arr.to(torch.float32)
    if arr.shape[1] > 1:
        out = plan_spmm(_streaming_spmm_plan(op, A), x.contiguous())
    else:
        out = plan_spmv(A, x[:, 0].contiguous())[:, None]
    return out.to(arr.dtype)


linop_streaming_spmv.declines = 0
