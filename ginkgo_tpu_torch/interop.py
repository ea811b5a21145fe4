"""Carry state across from the JAX package.

These functions take the JAX package's arrays as numpy (``np.asarray`` of a
``ginkgo_tpu`` object's fields) and build the port's objects from them, so
both packages compute on identical operands.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .base.matrix_data import MatrixData
from .matrix.bell import Bell
from .matrix.csr import Csr
from .matrix.dia import Dia
from .matrix.pell import Pell
from .matrix.well import Well
from .ops.pell import tile_ptr_from_steps
from .multigrid.pgm import (
    BandedProlongation,
    BandedRestriction,
    MultigridLevel,
    Prolongation,
    Restriction,
)
from .preconditioner.jacobi import Jacobi
from .solver.direct import DirectFactory
from .solver.multigrid import FixedSmoother, Multigrid
from .stop.criterion import Iteration, ResidualNorm, combine
from .solver.triangular import TriangularSolver


def _tensor(a, device) -> torch.Tensor:
    """numpy -> tensor; a bfloat16 array (ml_dtypes, as JAX hands it out)
    is carried bit for bit."""
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def dia_from_arrays(diags, offsets, shape, *, device) -> Dia:
    """A ``Dia`` from diagonals in the TPU lane frame ``(nd, R, 128)`` or
    flat ``(nd, n)``: the frame is flattened and cut to the n rows."""
    n = int(shape[0])
    nd = len(offsets)
    flat = np.asarray(diags).reshape(nd, -1)[:, :n]
    return Dia(
        diags=_tensor(flat, device),
        offsets=tuple(int(o) for o in offsets),
        shape=(n, int(shape[1])),
    )


def matrix_data_from_arrays(shape, rows, cols, values) -> MatrixData:
    return MatrixData.from_coo(tuple(int(s) for s in shape), rows, cols, values)


def jacobi_from_arrays(inv_diag, *, device) -> Jacobi:
    inv = _tensor(inv_diag, device)
    return Jacobi(inv_diag=inv, n=int(inv.shape[0]), max_block_size=1)


def csr_from_arrays(row_ptrs, col_idxs, values, shape, *, device,
                    strategy="auto") -> Csr:
    """A ``Csr`` from a JAX Csr's row_ptrs / col_idxs / values."""
    return Csr(
        row_ptrs=_tensor(row_ptrs, device),
        col_idxs=_tensor(col_idxs, device),
        values=_tensor(values, device),
        shape=tuple(int(s) for s in shape),
        strategy=strategy,
    )


def pell_from_arrays(values, qidx, bases, tile_of_step, *, shape, n_steps,
                     nnz, G, NT, NP, S, device) -> Pell:
    """A ``Pell`` from a JAX PELL plan or Pell: its arrays, carried bit for
    bit, and its geometry; ``tile_ptr`` is derived from the step -> tile
    map."""
    return Pell(
        values=_tensor(values, device),
        qidx=_tensor(qidx, device),
        bases=_tensor(np.asarray(bases, np.int32), device),
        tile_ptr=_tensor(tile_ptr_from_steps(tile_of_step, int(NT), int(G)), device),
        shape=tuple(int(s) for s in shape),
        n_steps=int(n_steps),
        nnz=int(nnz),
        G=int(G),
        NT=int(NT),
        NP=int(NP),
        S=int(S),
    )


def well_from_arrays(values, qidx, rt, tsb, bases, tile_of_step, *, shape, n_steps,
                     nnz, G, T, NT, NST, NP, NW, device) -> Well:
    """A ``Well`` from a JAX WELL plan or Well: its arrays, carried bit for
    bit (``tsb`` None for T = 1), and its geometry; ``tile_ptr`` is derived
    from the step -> supertile map."""
    return Well(
        values=_tensor(values, device),
        qidx=_tensor(qidx, device),
        rt=_tensor(rt, device),
        bases=_tensor(np.asarray(bases, np.int32), device),
        tile_ptr=_tensor(tile_ptr_from_steps(tile_of_step, int(NST), int(G)), device),
        tsb=None if tsb is None else _tensor(tsb, device),
        shape=tuple(int(s) for s in shape),
        n_steps=int(n_steps),
        nnz=int(nnz),
        G=int(G),
        T=int(T),
        NT=int(NT),
        NST=int(NST),
        NP=int(NP),
        NW=int(NW),
    )


def bell_from_arrays(values, panel_ids, panel_valid, ent_flat, *, shape, block_rows,
                     nnz_stored, device) -> Bell:
    """A ``Bell`` from a JAX Bell's panels, panel ids, validity and entry
    slots, carried bit for bit."""
    return Bell(
        values=_tensor(values, device),
        panel_ids=_tensor(panel_ids, device),
        panel_valid=_tensor(panel_valid, device),
        ent_flat=None if ent_flat is None else _tensor(ent_flat, device),
        shape=tuple(int(s) for s in shape),
        block_rows=int(block_rows),
        nnz_stored=int(nnz_stored),
    )


def triangular_solver_from_arrays(diag, *, n, block, lower, unit_diag, algorithm, sweeps,
                                  device, off_op=None, inv_diag_blocks=None, off_cols=None,
                                  off_vals=None, off_lrow=None) -> TriangularSolver:
    """A ``TriangularSolver`` from a JAX one's arrays, carried bit for bit:
    'sweeps' takes the strict triangle ``off_op``, already carried over
    (:func:`dia_from_arrays` or :func:`csr_from_arrays`); 'block_scan' the
    inverted diagonal blocks and the per-block panels."""
    def opt(a, dtype=None):
        if a is None:
            return None
        return _tensor(a if dtype is None else np.asarray(a, dtype), device)

    return TriangularSolver(
        inv_diag_blocks=opt(inv_diag_blocks), off_csr=off_op, diag=_tensor(diag, device),
        off_cols=opt(off_cols, np.int64), off_vals=opt(off_vals),
        off_lrow=opt(off_lrow, np.int64), n=int(n), block=int(block), lower=bool(lower),
        unit_diag=bool(unit_diag), algorithm=str(algorithm), sweeps=int(sweeps),
    )


def _transfer_pair(t, device):
    """(restrict, prolong) from a transfer's arrays: ``stride``, ``deltas``
    and ``delta`` for the banded pair, else ``agg``; and ``n_coarse``."""
    nc = int(t["n_coarse"])
    if "delta" in t:
        delta = _tensor(np.asarray(t["delta"], np.int32), device)
        ds = tuple(int(d) for d in t["deltas"])
        stride = int(t["stride"])
        return (BandedRestriction(delta=delta, deltas=ds, n_coarse=nc, stride=stride),
                BandedProlongation(delta=delta, deltas=ds, n_coarse=nc, stride=stride))
    agg = _tensor(np.asarray(t["agg"], np.int64), device)
    return Restriction(agg=agg, n_coarse=nc), Prolongation(agg=agg, n_coarse=nc)


def multigrid_from_arrays(fine_ops, coarse_op, transfers, dinvs, *, coarse_dense_inv=None,
                          cycle="v", mid_case="standalone", kcycle_base=1, kcycle_rel_tol=0.25,
                          smoother_iters=1, smoother_relax=0.9, criteria=None,
                          device) -> Multigrid:
    """A ``Multigrid`` from a JAX one's hierarchy: the level operators
    ``fine_ops`` and the coarsest ``coarse_op``, already carried over (e.g.
    :func:`dia_from_arrays`); per level the transfer's arrays (see
    ``_transfer_pair``) and the smoother's inverse diagonal, carried bit for
    bit; one ``FixedSmoother`` per level in every role, the default
    ``Direct`` coarse solver generated from ``coarse_op``, and the JAX
    package's dense coarse inverse (its (Rc 128)^2 transposed frame, or
    None), cut to the coarse rows and transposed back."""
    levels, smoothers = [], []
    for l, A in enumerate(fine_ops):
        R, P = _transfer_pair(transfers[l], device)
        coarse = fine_ops[l + 1] if l + 1 < len(fine_ops) else coarse_op
        levels.append(MultigridLevel(fine_op=A, restrict_op=R, prolong_op=P, coarse_op=coarse))
        smoothers.append(FixedSmoother(A=A, dinv=_tensor(dinvs[l], device),
                                       iters=int(smoother_iters), relax=float(smoother_relax)))
    inv = None
    if coarse_dense_inv is not None:
        nc = coarse_op.shape[0]
        inv = _tensor(np.asarray(coarse_dense_inv, np.float32)[:nc, :nc].T, device)
    crit = combine(criteria) if criteria is not None else combine(
        [Iteration(max_iters=100), ResidualNorm(tolerance=1e-8)])
    smoothers = tuple(smoothers)
    return Multigrid(levels=tuple(levels), pre_smoothers=smoothers, post_smoothers=smoothers,
                     mid_smoothers=smoothers, coarse_solver=DirectFactory().generate(coarse_op),
                     criterion=crit, coarse_dense_inv=inv, cycle=cycle, mid_case=mid_case,
                     kcycle_base=int(kcycle_base), kcycle_rel_tol=float(kcycle_rel_tol))
