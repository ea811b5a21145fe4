"""WELL ("windowed gather-ELL") SpMV for locality-free patterns: the host
planner, the PELL-or-WELL plan chooser, kernels K8 and K9 with their plain
versions.

Counterpart of ``ginkgo_tpu/ops/spmv_well.py``.  Layout: output rows are
tiled 1024 (8 sublanes x 128 lanes) at a time, and T consecutive tiles form
a *supertile*.  A slot of supertile st is one (8, 128) values tile, one
(8, 128) residue tile q, one (8, 128) routing tile rt, for T > 1 one
(8, 128) sub-tile tile tsb, and one window base b (a panel index, a
multiple of 8).  Cell (s, l) holds at most one nonzero, of row

    1024 * (T * st + tsb[s, l]) + 128 * s + l,

whose column is ``128 * (b + rt[s, q]) + q`` with ``q = q[s, l]``: the
routing tile is read at lane q of the same sublane, not at lane l (the
TPU's chained sublane-then-lane gather).  Padding cells hold value 0, q 0
and tsb 0.

:class:`WellPlan` is a copy of the JAX package's numpy planner
(``spmv_well.py:98-316``) with its TPU cost constants, so both pick the same
T and G and build the same arrays bit for bit, plus ``tile_ptr`` (NST + 1):
the slots of supertile st are ``[tile_ptr[st], tile_ptr[st + 1])``, a whole
number of G-slot steps.  :func:`choose_unstructured_plan` picks the cheaper
of a PELL and a WELL plan as the JAX package does.

K8 ``well_spmv`` and K9 ``well_spmm`` are ``csrc/well_spmv.cu``.  They walk
a *work list* (:func:`chunk_list`): each supertile is cut into chunks of
whole G-slot steps, ``CHUNK_SLOTS`` slots each at most, so that a hub row's
supertile spreads over many blocks.  A chunk of a supertile that is one
chunk writes its rows; the chunks of a split supertile write partial sums,
which a second launch adds in chunk order.  The plain versions walk the
same list in the same order.  A wrapper takes the plain version only for
a tensor on the CPU; on a CUDA tensor it launches the kernel or raises,
and counts its calls in ``launches``.  The operator argument ``A`` of the
functions here is anything with ``values, qidx, rt, tsb, bases, tile_ptr,
T, G, shape`` (``matrix.well.Well``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..log.logger import logged_kernel
from .dia import DTYPE_CODE, VECTOR_DTYPES, check_status, on_cpu
from .pell import (
    LANES,
    SUBLANES,
    VALUE_DTYPES,
    PellPlan,
    _G_CANDIDATES,
    _G_HBM_BYTES_PER_S,
    _G_STEP_SECONDS,
)

TILE_ROWS = SUBLANES * LANES  # 1024
WIN_PANELS = SUBLANES  # a window is 8 panels of 128 columns
#: most sub-tiles a supertile may have in the kernels (csrc/well_spmv.cu)
MAX_KERNEL_T = 64
#: most slots in one chunk of the K8/K9 work list, before it is rounded up
#: to whole G-slot steps (``chunk_list``)
CHUNK_SLOTS = 256

# -- supertile cost model ------------------------------------------------------
# The JAX package's constants, kept unchanged so that both planners choose
# the same T and G.  They are a TPU's measured costs (a slot's slice and
# chained gathers, the extra mask chain beyond 16 sub-tiles) and only
# choose a layout here.
_T_CANDIDATES = (1, 4, 16)
_T_DEEP_CANDIDATES = (32, 64)
_T_DEEP_MIN_NNZ = 2_000_000
_SLOT_BASE_SECONDS = 7e-9
_MASK_SECONDS_PER_SUB = 0.4e-9


def _assign_layers(t, w, s, q, rows, cols, NW):
    """Greedy layer assignment, as the JAX planner does it.

    Per (supertile, window) the layer of each entry satisfies: one entry
    per (layer, row cell), and a single distinct column per (layer,
    sublane, residue).  Each pass assigns a maximal consistent set to the
    next layer: in every (t, w, s, q) residue group the lowest remaining
    column is chosen, and among the chosen-column entries the first per
    (t, w, cell) wins."""
    nnz = len(rows)
    layer = np.zeros(nnz, np.int32)
    if nnz == 0:
        return layer
    resgrp = ((t * NW + w) * SUBLANES + s) * LANES + q
    cellgrp = (t * NW + w) * TILE_ROWS + (rows % TILE_ROWS)
    order = np.lexsort((cols, resgrp))
    rg_s = resgrp[order]
    c_s = cols[order]
    cell_s = cellgrp[order]
    rem = np.ones(nnz, bool)
    lay = 0
    while True:
        pos = np.flatnonzero(rem)
        if len(pos) == 0:
            break
        g = rg_s[pos]
        first = np.ones(len(pos), bool)
        first[1:] = g[1:] != g[:-1]
        grp_id = np.cumsum(first) - 1
        chosen_col = c_s[pos[first]][grp_id]
        elig = np.flatnonzero(c_s[pos] == chosen_col)
        pe = pos[elig]
        ck = cell_s[pe]
        o2 = np.argsort(ck, kind="stable")
        ck_o = ck[o2]
        fc = np.ones(len(ck_o), bool)
        fc[1:] = ck_o[1:] != ck_o[:-1]
        win = pe[o2[fc]]
        layer[order[win]] = lay
        rem[win] = False
        lay += 1
    return layer


class WellPlan:
    """Static WELL expansion of a CSR pattern, built on the host in numpy.

    G: slots per step ("auto" uses the cost model); T: sub-tiles per
    supertile ("auto" scores 1, 4, 16, and 32, 64 from 2M nonzeros on).
    ``materialize=False`` computes the statistics only, ``max_cells``
    declines a plan (``too_large``) before its arrays are allocated, and
    ``value_itemsize`` overrides the value width the cost model charges
    (bfloat16 values reach the planner widened to float32)."""

    S = SUBLANES

    def __init__(self, indptr, indices, values, shape, G="auto", *,
                 T="auto", materialize: bool = True,
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
        self.nnz = nnz
        NT = max(-(-n_rows // TILE_ROWS), 1)
        NP = max(-(-n_cols // LANES), 1)
        NW = max(-(-NP // WIN_PANELS), 1)
        self.NT, self.NP, self.NW = NT, NP, NW
        self.val_dtype = values.dtype
        if value_itemsize is None:
            value_itemsize = values.dtype.itemsize

        rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
        cols = indices.astype(np.int64)
        t_tile = rows // TILE_ROWS
        s = (rows >> 7) % SUBLANES
        lane = (rows & 127).astype(np.int64)
        p = cols >> 7
        w = p // WIN_PANELS
        wr = (p % WIN_PANELS).astype(np.int64)
        q = (cols & 127).astype(np.int64)

        def vbpc(T_):
            return value_itemsize + 2 + (1 if T_ > 1 else 0)

        def build_stats(T_):
            t_ = t_tile // T_
            layer_ = _assign_layers(t_, w, s, q, rows, cols, NW)
            nlay_ = np.int64(layer_.max() + 1 if nnz else 1)
            K_ = (t_ * NW + w) * nlay_ + layer_
            uniqK_ = np.unique(K_)  # the entries' slots only once a plan is built
            u_t_ = uniqK_ // (np.int64(NW) * nlay_)
            NST_ = max(-(-NT // T_), 1)
            K_t_ = np.zeros(NST_, np.int64)
            if len(uniqK_):
                np.add.at(K_t_, u_t_, 1)
            return t_, layer_, nlay_, K_, uniqK_, u_t_, NST_, K_t_

        def model_cost(K_t_, g, T_):
            st = int(np.maximum(-(-K_t_ // g), 1).sum())
            slots = st * g
            return (
                st * _G_STEP_SECONDS
                + slots * TILE_ROWS * vbpc(T_) / _G_HBM_BYTES_PER_S
                + slots * (_SLOT_BASE_SECONDS
                           + max(0, T_ - 16) * _MASK_SECONDS_PER_SUB)
            )

        auto_g = G == "auto"
        if T == "auto":
            cands = _T_CANDIDATES + (
                _T_DEEP_CANDIDATES if nnz >= _T_DEEP_MIN_NNZ else ())
            best = None
            for T_ in cands:
                stats_ = build_stats(T_)
                for g in (_G_CANDIDATES if auto_g else (int(G),)):
                    c = model_cost(stats_[-1], g, T_)
                    if best is None or c < best[0]:
                        best = (c, T_, g, stats_)
            _, T, G_best, stats = best
            if auto_g:
                G = G_best
        else:
            T = int(T)
            stats = build_stats(T)
            if auto_g:
                best = None
                for g in _G_CANDIDATES:
                    c = model_cost(stats[-1], g, T)
                    if best is None or c < best[0]:
                        best = (c, g)
                G = best[1]
        self.T = T = int(T)
        t, layer, nlay, K, uniqK, u_t, NST, K_t = stats
        self.NST = NST
        self.bytes_per_cell = vbpc(T)
        self.modeled_seconds = model_cost(K_t, int(G), T)

        self.G = G = int(G)
        steps_t = np.maximum(-(-K_t // G), 1)
        slot_off = np.concatenate([[0], np.cumsum(steps_t * G)])
        total_slots = int(slot_off[-1])
        self.n_steps = int(steps_t.sum())
        self.total_cells = total_slots * TILE_ROWS
        self.inflation = self.total_cells / max(nnz, 1)
        self.padded_bytes = self.total_cells * self.bytes_per_cell

        self.too_large = max_cells is not None and self.total_cells > max_cells
        if not materialize or self.too_large:
            self.values = self.qidx = self.rt = self.tsb = None
            self.bases = self.tile_of_step = self.tile_ptr = None
            return

        cells = (total_slots, SUBLANES, LANES)
        vals_arr = np.zeros(cells, values.dtype)
        q_arr = np.zeros(cells, np.int8)
        rt_arr = np.zeros(cells, np.int8)
        tsb_arr = np.zeros(cells, np.int8) if T > 1 else None
        bases = np.zeros(total_slots, np.int32)
        if nnz:
            # dense slot index: the rank of the slot's key in its supertile
            t_change = np.ones(len(uniqK), bool)
            t_change[1:] = u_t[1:] != u_t[:-1]
            g_id = np.cumsum(t_change) - 1
            g_start = np.nonzero(t_change)[0][g_id]
            slot_in_t = np.arange(len(uniqK), dtype=np.int64) - g_start
            slot_of_pair = slot_off[u_t] + slot_in_t
            gslot = slot_of_pair[np.unique(K, return_inverse=True)[1]]
            vals_arr[gslot, s, lane] = values
            q_arr[gslot, s, lane] = q
            # the routing entry lives at lane q; entries of one column
            # write the same window row (the layering guarantees it)
            rt_arr[gslot, s, q] = wr
            if T > 1:
                tsb_arr[gslot, s, lane] = (t_tile % T).astype(np.int8)
            u_w = (uniqK // nlay) % NW
            bases[slot_of_pair] = (u_w * WIN_PANELS).astype(np.int32)
        self.values = vals_arr
        self.qidx = q_arr
        self.rt = rt_arr
        self.tsb = tsb_arr
        self.bases = bases
        self.tile_of_step = np.repeat(np.arange(NST, dtype=np.int32), steps_t)
        self.tile_ptr = slot_off.astype(np.int32)


# -- PELL-or-WELL plan choice ------------------------------------------------------


def _plan_cost(n_steps: int, total_cells: int, bytes_per_cell: int,
               gather_factor: float = 1.0) -> float:
    """Modeled apply seconds: step overhead plus padded bytes."""
    return (n_steps * _G_STEP_SECONDS
            + total_cells * bytes_per_cell / _G_HBM_BYTES_PER_S * gather_factor)


def choose_unstructured_plan(indptr, indices, values, shape, *, q_dtype=np.int8,
                             max_cells=None, value_itemsize=None):
    """The cheaper of a PELL plan (column locality) and a WELL plan
    (locality-free) for this pattern, materialized; or a statistics-only
    plan with ``too_large`` set when neither fits ``max_cells``.  PELL is
    taken at once when its inflation is at most 4 (the WELL statistics pass
    costs host seconds and cannot win there).  A PELL plan is built at the S
    that its S = "auto" statistics chose: the plan the JAX package's S =
    "auto" build makes, without its three probes again."""
    if value_itemsize is None:
        value_itemsize = np.asarray(values).dtype.itemsize
    kw = dict(value_itemsize=value_itemsize)
    pell_bpc = value_itemsize + np.dtype(q_dtype).itemsize
    pell = PellPlan(indptr, indices, values, shape, q_dtype=q_dtype, S="auto",
                    materialize=False, **kw)
    if pell.inflation <= 4.0:
        return PellPlan(indptr, indices, values, shape, q_dtype=q_dtype, S=pell.S,
                        max_cells=max_cells, **kw)
    well = WellPlan(indptr, indices, values, shape, materialize=False, **kw)
    # the same per-slot base charge on both sides, so that the deep-T mask
    # charge inside WellPlan.modeled_seconds compares fairly
    pell_cost = (_plan_cost(pell.n_steps, pell.total_cells, pell_bpc)
                 + pell.n_steps * pell.G * _SLOT_BASE_SECONDS)
    if pell_cost <= well.modeled_seconds:
        plan = PellPlan(indptr, indices, values, shape, q_dtype=q_dtype, S=pell.S,
                        max_cells=max_cells, **kw)
        if not plan.too_large:
            return plan
        alt = WellPlan(indptr, indices, values, shape, T=well.T,
                       max_cells=max_cells, **kw)
        return plan if alt.too_large else alt
    plan = WellPlan(indptr, indices, values, shape, T=well.T,
                    max_cells=max_cells, **kw)
    if not plan.too_large:
        return plan
    alt = PellPlan(indptr, indices, values, shape, q_dtype=q_dtype, S=pell.S,
                   max_cells=max_cells, **kw)
    return plan if alt.too_large else alt


# -- the work list -------------------------------------------------------------------


class WellChunks:
    """The K8/K9 work list of a plan for one chunk length, built on the host
    from ``tile_ptr``.

    ``work`` (n_chunks, 4) int32 holds, per chunk in slot order: its
    supertile, first slot, end slot and partial (-1 when its supertile is
    one chunk, which then writes its rows itself).  ``fold`` (n_split, 3)
    int32 holds, per split supertile: the supertile, its first partial and
    its partial count; a supertile's partials are consecutive, in chunk
    order.  ``slots`` is the chunk length, a whole number of G-slot steps."""

    def __init__(self, tile_ptr: np.ndarray, G: int, chunk_slots: int):
        tp = np.asarray(tile_ptr, np.int64)
        start, end = tp[:-1], tp[1:]
        if len(tp) < 2 or tp[0] != 0 or np.any(end < start) or np.any((end - start) % G):
            raise ValueError("tile_ptr must start at 0 and give each supertile a "
                             f"whole number of {G}-slot steps")
        self.slots = C = -(-max(int(chunk_slots), 1) // G) * G
        counts = np.maximum(-(-(end - start) // C), 1)
        st = np.repeat(np.arange(len(start), dtype=np.int64), counts)
        rank = np.arange(len(st)) - np.repeat(np.cumsum(counts) - counts, counts)
        s0 = start[st] + rank * C
        s1 = np.minimum(s0 + C, end[st])
        split = counts[st] > 1
        part = np.full(len(st), -1, np.int64)
        part[split] = np.arange(int(split.sum()))
        self.work = np.stack([st, s0, s1, part], axis=1).astype(np.int32)
        self.rank = rank
        first = split & (rank == 0)
        self.fold = np.stack([st[first], part[first], counts[st[first]]], axis=1).astype(np.int32)
        self.n_parts = int(split.sum())
        self._on: dict = {}

    def tensors(self, device):
        """(work, fold) on ``device``, copied there once."""
        key = str(device)
        if key not in self._on:
            self._on[key] = tuple(torch.from_numpy(a).to(device) for a in (self.work, self.fold))
        return self._on[key]


def chunk_list(A, chunk_slots: int = CHUNK_SLOTS) -> WellChunks:
    """The work list of operator ``A`` for chunks of ``chunk_slots`` slots
    (rounded up to whole G-slot steps), cached on ``A`` beside its dataclass
    fields, so that it enters neither ``storage_bytes()`` nor the fields
    that ``astype``/``reduce_storage`` copy (their new operator shares
    ``tile_ptr`` and builds its own list once)."""
    cache = vars(A).setdefault("_well_chunks", {})
    if chunk_slots not in cache:
        cache[chunk_slots] = WellChunks(A.tile_ptr.cpu().numpy(), A.G, chunk_slots)
    return cache[chunk_slots]


# -- plain versions ----------------------------------------------------------------


def _lib():
    lib = _build.load("well_spmv")
    if not hasattr(lib, "gk_typed"):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # values, v_dtype, qidx, rt, tsb, bases, T, G, work, n_chunks, fold,
        # n_split, partials
        plan = [P, I, P, P, P, P, I, I, P, I, P, I, P]
        lib.well_spmv.argtypes = plan + [P, I, P, L, L, P]
        lib.well_spmm.argtypes = plan + [P, I, P, L, L, I, P]
        lib.well_spmv.restype = I
        lib.well_spmm.restype = I
        lib.well_block_smem.argtypes = [I, I, I, I]
        lib.well_block_smem.restype = I
        lib.gk_error_string.argtypes = [I]
        lib.gk_error_string.restype = ctypes.c_char_p
        lib.gk_typed = True
    return lib


def _cell_products(A, x, slots, acc_dtype):
    """values * x[column] of every cell of ``slots``: (len, 8, 128) for an
    (n_cols,) x, (len, 8, 128, k) for (n_cols, k).  The routing tile is read
    at lane q; a column at or past n_cols reads 0, as the TPU kernel's zero
    pad panels do."""
    n_cols = A.shape[1]
    q = A.qidx[slots].to(torch.int64)
    wr = torch.gather(A.rt[slots].to(torch.int64), 2, q)
    col = (A.bases[slots].to(torch.int64)[:, None, None] + wr) * LANES + q
    ok = col < n_cols
    xv = x.to(acc_dtype)[col.clamp(max=max(n_cols - 1, 0))]
    vals = A.values[slots].to(acc_dtype)
    if x.dim() == 2:
        ok, vals = ok[..., None], vals[..., None]
    return vals * torch.where(ok, xv, torch.zeros((), dtype=acc_dtype, device=x.device))


def _route_add(dst, contrib, sub):
    """dst[i, sub[i]] += contrib[i] for dst of shape (len, T, 8, 128[, k]):
    each cell adds into its sub-tile only.  The TPU kernel adds
    ``where(tsb == b, contrib, 0)`` into all T sums; adding +0.0 to a sum
    that started at +0.0 leaves it unchanged bit for bit, so both give the
    same sums.  ``sub`` is None for T = 1."""
    if sub is None:
        dst[:, 0] += contrib
        return
    idx = sub[:, None]
    if contrib.dim() == 4:
        idx = idx[..., None].expand(-1, -1, -1, -1, contrib.shape[-1])
    dst.scatter_add_(1, idx, contrib[:, None])


def _chunks(A, chunk_slots, device):
    """The work list, each chunk's first slot and slot count on ``device``,
    and the longest chunk."""
    ch = chunk_list(A, chunk_slots)
    work = torch.from_numpy(ch.work).to(device=device, dtype=torch.int64)
    count = work[:, 2] - work[:, 1]
    return ch, work[:, 1], count, int((ch.work[:, 2] - ch.work[:, 1]).max())


def _all_cells(A, x, acc):
    """The products of every cell and the sub-tile of every cell (None for
    T = 1), computed at once; the sums below only add them up in order."""
    prod = _cell_products(A, x, torch.arange(A.values.shape[0], device=x.device), acc)
    return prod, (A.tsb.to(torch.int64).to(x.device) if A.T > 1 else None)


def _fold(parts, ch, n_st):
    """The rows of every supertile from its chunks' sums, (NST, T, 8, 128[,
    k]): 0 + p0 + p1 + ... in chunk order, as the fold launch adds them (a
    chunk's sum starts at +0.0 and only adds, so it is never -0.0, and 0 +
    p0 is p0 bit for bit)."""
    out = torch.zeros((n_st,) + parts.shape[1:], dtype=parts.dtype, device=parts.device)
    st = torch.from_numpy(ch.work[:, 0].astype(np.int64)).to(parts.device)
    for r in range(int(ch.rank.max()) + 1):
        sel = torch.from_numpy(np.flatnonzero(ch.rank == r)).to(parts.device)
        out[st[sel]] = out[st[sel]] + parts[sel]
    return out


def _rows(out, n_rows, k=None):
    """(NST, T, 8, 128[, k]) sub-tile blocks -> the first n_rows rows."""
    return (out.reshape(-1) if k is None else out.reshape(-1, k))[:n_rows]


def well_spmv_reference(A, x, chunk_slots: int = CHUNK_SLOTS):
    """y = A x with plain tensor ops, in the kernel's order.  Inside a chunk
    the TPU's order: the G slots of a step sum into T step sums (each cell
    into the sum of its sub-tile), and the step sums add into the chunk's
    sums in step order, each only where the step touched its sub-tile, as
    the kernel folds them (an untouched step sum is +0.0 and changes
    nothing).  Then the chunks of each supertile add in chunk order."""
    n_rows, n_cols = A.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    T, G = A.T, A.G
    ch, start, count, max_count = _chunks(A, chunk_slots, x.device)
    parts = torch.zeros((count.shape[0], T, SUBLANES, LANES), dtype=acc, device=x.device)
    if n_cols > 0 and max_count:
        prod, sub = _all_cells(A, x, acc)
        for j in range(0, max_count, G):
            t = torch.nonzero(count > j).flatten()
            step = torch.zeros((t.shape[0], T, SUBLANES, LANES), dtype=acc, device=x.device)
            touched = torch.zeros(step.shape, dtype=torch.bool, device=x.device)
            for g in range(G):
                slots = start[t] + j + g
                s = None if sub is None else sub[slots]
                _route_add(step, prod[slots], s)
                if s is None:
                    touched[:, 0] = True
                else:
                    touched.scatter_(1, s[:, None], True)
            parts[t] = torch.where(touched, parts[t] + step, parts[t])
    return _rows(_fold(parts, ch, A.tile_ptr.shape[0] - 1), n_rows).to(x.dtype)


def well_spmm_reference(A, X, chunk_slots: int = CHUNK_SLOTS):
    """Y = A X for X of shape (n_cols, k), in the kernel's order: inside a
    chunk the TPU SpMM kernel's, each slot's products added straight into
    the sums, slot by slot (no step sum); then the chunks of each supertile
    add in chunk order."""
    n_rows, n_cols = A.shape
    k = X.shape[1]
    acc = torch.promote_types(X.dtype, torch.float32)
    ch, start, count, max_count = _chunks(A, chunk_slots, X.device)
    parts = torch.zeros((count.shape[0], A.T, SUBLANES, LANES, k), dtype=acc, device=X.device)
    if n_cols > 0 and max_count:
        prod, sub = _all_cells(A, X, acc)
        for j in range(max_count):
            t = torch.nonzero(count > j).flatten()
            slots = start[t] + j
            block = parts[t]
            _route_add(block, prod[slots], None if sub is None else sub[slots])
            parts[t] = block
    return _rows(_fold(parts, ch, A.tile_ptr.shape[0] - 1), n_rows, k).to(X.dtype)


# -- kernel wrappers -------------------------------------------------------------------


def _check_operands(A, x, what):
    if not x.is_cuda:
        raise RuntimeError(f"{what}: x on {x.device}")
    int8_tiles = [A.qidx, A.rt] + ([A.tsb] if A.T > 1 else [])
    arrays = [A.values, A.bases, A.tile_ptr] + int8_tiles
    if any(t is None or t.device != x.device for t in arrays):
        raise RuntimeError(f"{what}: the plan and the vectors must be on one device")
    if A.values.dtype not in VALUE_DTYPES:
        raise TypeError(f"{what}: values {A.values.dtype}")
    if any(t.dtype != torch.int8 for t in int8_tiles):
        raise TypeError(f"{what}: qidx, rt and tsb must be int8")
    if A.bases.dtype != torch.int32 or A.tile_ptr.dtype != torch.int32:
        raise TypeError(f"{what}: bases and tile_ptr must be int32")
    slots = A.values.shape[0]
    cells = (slots, SUBLANES, LANES)
    if any(tuple(t.shape) != cells for t in [A.values] + int8_tiles):
        raise ValueError(f"{what}: values, qidx, rt and tsb must be (slots, 8, 128)")
    if A.bases.shape != (slots,) or A.tile_ptr.dim() != 1:
        raise ValueError(f"{what}: bases must be (slots,), tile_ptr (NST + 1,)")
    if not 1 <= A.T <= MAX_KERNEL_T or A.G < 1:
        raise ValueError(f"{what}: T = {A.T}, G = {A.G}; the kernels take 1 <= T <= {MAX_KERNEL_T}")
    if (A.tile_ptr.shape[0] - 1) * A.T * TILE_ROWS < A.shape[0]:
        raise ValueError(f"{what}: the plan's supertiles cover fewer than {A.shape[0]} rows")
    if not all(t.is_contiguous() for t in arrays):
        raise ValueError(f"{what}: plan arrays must be contiguous")
    # the kernels stage slot rows into shared memory in 16-byte copies
    if any(t.data_ptr() % 16 for t in [A.values] + int8_tiles):
        raise ValueError(f"{what}: values, qidx, rt and tsb must be 16-byte aligned")
    if x.dtype not in VECTOR_DTYPES:
        raise TypeError(f"{what}: vectors must be float32/float64, got {x.dtype}")
    if x.shape[0] != A.shape[1] or not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous with {A.shape[1]} rows")


def _launch_args(A, chunks, device, scratch):
    """The plan, the work list and the partials' scratch as the C entry
    points take them."""
    work, fold = chunks.tensors(device)
    if int(chunks.work[:, 2].max()) > A.values.shape[0]:
        raise ValueError("tile_ptr reaches past the plan's slots")
    return (A.values.data_ptr(), DTYPE_CODE[A.values.dtype], A.qidx.data_ptr(),
            A.rt.data_ptr(), A.tsb.data_ptr() if A.T > 1 else None,
            A.bases.data_ptr(), A.T, A.G, work.data_ptr(), work.shape[0],
            fold.data_ptr(), fold.shape[0], None if scratch is None else scratch.data_ptr())


def _scratch(A, chunks, x, k=1):
    """Room for the partial sums of every chunk of a split supertile."""
    if not chunks.n_parts:
        return None
    return torch.empty(chunks.n_parts * A.T * TILE_ROWS * k, dtype=x.dtype, device=x.device)


@logged_kernel
def well_spmv(A, x, chunk_slots: int = CHUNK_SLOTS):
    """K8: y = A x for one right-hand side x of shape (n_cols,).
    ``chunk_slots`` sets the work list's chunks (tests force small ones)."""
    if on_cpu(x):
        return well_spmv_reference(A, x, chunk_slots)
    _check_operands(A, x, "well_spmv")
    if x.dim() != 1:
        raise ValueError("well_spmv: x must be 1-D")
    lib = _lib()
    chunks = chunk_list(A, chunk_slots)
    y = torch.empty(A.shape[0], dtype=x.dtype, device=x.device)
    scratch = _scratch(A, chunks, x)
    with torch.cuda.device(x.device):
        status = lib.well_spmv(
            *_launch_args(A, chunks, x.device, scratch), x.data_ptr(), DTYPE_CODE[x.dtype],
            y.data_ptr(), A.shape[0], A.shape[1], torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "well_spmv")
    well_spmv.launches += 1
    return y


well_spmv.launches = 0


@logged_kernel
def well_spmm(A, X, chunk_slots: int = CHUNK_SLOTS):
    """K9: Y = A X for X of shape (n_cols, k), row-major; the plan is read
    once for every group of up to 4 columns that fits a block's shared
    memory.  ``chunk_slots`` as for ``well_spmv``."""
    if on_cpu(X):
        return well_spmm_reference(A, X, chunk_slots)
    _check_operands(A, X, "well_spmm")
    if X.dim() != 2:
        raise ValueError("well_spmm: X must be (n_cols, k)")
    lib = _lib()
    k = X.shape[1]
    chunks = chunk_list(A, chunk_slots)
    Y = torch.empty((A.shape[0], k), dtype=X.dtype, device=X.device)
    scratch = _scratch(A, chunks, X, k)
    with torch.cuda.device(X.device):
        status = lib.well_spmm(
            *_launch_args(A, chunks, X.device, scratch), X.data_ptr(), DTYPE_CODE[X.dtype],
            Y.data_ptr(), A.shape[0], A.shape[1], k, torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "well_spmm")
    well_spmm.launches += 1
    return Y


well_spmm.launches = 0


def block_smem_bytes(A, x_dtype, k=0) -> int:
    """Dynamic shared memory one K8 block (k = 0) or K9 block (k columns)
    asks for on this plan, as ``csrc/well_spmv.cu`` sizes it; -1 when it
    does not fit the current card."""
    with torch.cuda.device(A.values.device):
        return _lib().well_block_smem(DTYPE_CODE[A.values.dtype], DTYPE_CODE[x_dtype], A.T, k)


def plan_spmv(A, x):
    """y = A x through either kind of cached plan operator (Pell or Well)."""
    from .pell import pell_spmv

    return well_spmv(A, x) if hasattr(A, "rt") else pell_spmv(A, x)


def plan_spmm(A, X):
    """Y = A X through either kind of cached plan operator."""
    from .pell import pell_spmm

    return well_spmm(A, X) if hasattr(A, "rt") else pell_spmm(A, X)
