"""The summation orders K5 (pell_spmv) and K10 (bell_spmv) declare, held on
the CPU against the plain versions their CUDA kernels are checked against.

Each kernel keeps a fixed order so that it equals its plain version bit for
bit on the card:

- K5: per output row, the G slots of a step sum into a step sum that starts
  from 0, and the step sums add into the row's total in slot order; a
  column outside [0, n_cols) reads 0, and every cell is multiplied, padding
  included.
- K10: per row and panel, a lane sum from 0 over l = 0..127 in order, then
  the panel sums add into the row's total in panel order; x's last panel is
  cut at n_cols and padding panels are multiplied.
- K11: K10's order for each column of X.

An independent numpy loop of each order, float32 throughout, must equal
``pell_spmv_reference``, ``bell_spmv_reference`` and ``bell_spmm_reference``
bit for bit, on plans and Bells built by the JAX package and carried across
by ``interop``: Pell tiles with 0, 1 and 3 or more steps, rows past the
last tile's end, int8 and int32 lane indices, float32 and bfloat16 values,
columns outside [0, n_cols), NaN and Inf in x; Bells with BR = 8, 16 and
32, K = 1 and 6, x's last panel cut inside a panel, NaN in x[0:128] with
padding panels; K11 at 2, 3 and 9 columns (one launch of 2 and of 3, and
on the card two launches, 8 columns and 1), each column also equal to
``bell_spmv_reference`` of that column.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.matrix import bell as jbell
from ginkgo_tpu.matrix.csr import Csr as JCsr
from ginkgo_tpu.ops import spmv_pallas as jsp
from ginkgo_tpu_torch import interop
from ginkgo_tpu_torch.ops import bell as ops_bell
from ginkgo_tpu_torch.ops import pell as ops_pell
from ginkgo_tpu_torch.utils import generators

LANES = 128
F32 = np.float32


def _bits_equal(got, want):
    """Equal bits, NaN where the other has NaN: +0.0 and -0.0 differ."""
    got, want = np.asarray(got, F32), np.asarray(want, F32)
    nan = np.isnan(want)
    return (got.shape == want.shape and np.array_equal(np.isnan(got), nan)
            and np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32)))


def _x(n, seed):
    """float32 x with NaN, Inf and -0.0 among normal values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(F32)
    x[rng.integers(0, n, 3)] = np.nan
    x[rng.integers(0, n, 2)] = np.inf
    x[rng.integers(0, n, 2)] = -np.inf
    x[rng.integers(0, n, 3)] = -0.0
    return x


# -- K5: Pell ----------------------------------------------------------------------


@np.errstate(invalid="ignore")  # inf * 0 and inf - inf are NaN, as on the card
def pell_loop(values, qidx, bases, tile_ptr, S, G, n_rows, n_cols, x):
    """K5's declared order, one tile and one slot at a time, in numpy float32."""
    vals = np.asarray(values, F32)
    n_tiles = len(tile_ptr) - 1
    y = np.zeros(n_tiles * S * LANES, F32)
    sub = np.arange(S)[:, None]
    for t in range(n_tiles):
        total = np.zeros((S, LANES), F32)
        acc = np.zeros((S, LANES), F32)
        for k, slot in enumerate(range(tile_ptr[t], tile_ptr[t + 1])):
            col = (int(bases[slot]) - (S - 1) + sub) * LANES + qidx[slot].astype(np.int64)
            ok = (col >= 0) & (col < n_cols)
            xv = np.where(ok, x[np.clip(col, 0, max(n_cols - 1, 0))], F32(0))
            acc = acc + vals[slot] * xv
            if (k + 1) % G == 0:  # the end of a step
                total = total + acc
                acc = np.zeros((S, LANES), F32)
        y[t * S * LANES:(t + 1) * S * LANES] = total.reshape(-1)
    return y[:n_rows]


def _jax_plan(data, S, G, q):
    JA = JCsr.from_matrix_data(JMatrixData.from_coo(data.shape, data.rows, data.cols,
                                                    data.values))
    return jsp.PellPlan(np.asarray(JA.row_ptrs), np.asarray(JA.col_idxs), np.asarray(JA.values),
                        data.shape, G=G, S=S, q_dtype=q)


def _without_tile(jp, t):
    """The JAX plan's arrays with the steps of tile t taken out: a tile with
    no steps (the planners give every tile one)."""
    steps = np.asarray(jp.tile_of_step)
    keep_steps = steps != t
    keep_slots = np.repeat(keep_steps, jp.G)
    return (np.asarray(jp.values)[keep_slots], np.asarray(jp.qidx)[keep_slots],
            np.asarray(jp.bases)[keep_slots], steps[keep_steps])


PELL_CASES = {
    # name: (matrix, S, G, whether a tile loses its steps)
    "poisson3d_S8": (lambda: generators.poisson_3d(13, dtype=F32), 8, "auto", False),
    "poisson3d_S16_no_steps_in_tile1": (lambda: generators.poisson_3d(13, dtype=F32), 16,
                                        "auto", True),
    "scatter_G4": (lambda: generators.local_scatter(3000, half_window=96), 8, 4, False),
    "scatter_S32_G4_no_steps_in_tile0": (lambda: generators.local_scatter(5000, half_window=64),
                                         32, 4, True),
}


@pytest.mark.parametrize("case", sorted(PELL_CASES))
@pytest.mark.parametrize("q", [np.int8, np.int32])
@pytest.mark.parametrize("vals", ["f32", "bf16"])
def test_pell_reference_is_the_declared_order(case, q, vals):
    make, S, G, drop = PELL_CASES[case]
    data = make()
    jp = _jax_plan(data, S, G, q)
    values, qidx, bases, tile_of_step = (np.asarray(jp.values), np.asarray(jp.qidx),
                                         np.asarray(jp.bases), np.asarray(jp.tile_of_step))
    if drop:
        values, qidx, bases, tile_of_step = _without_tile(jp, 1 if "tile1" in case else 0)
    if vals == "bf16":
        values = np.asarray(jnp.asarray(values).astype(jnp.bfloat16))
    A = interop.pell_from_arrays(values, qidx, bases, tile_of_step, shape=jp.shape,
                                 n_steps=len(tile_of_step), nnz=jp.nnz, G=jp.G, NT=jp.NT,
                                 NP=jp.NP, S=jp.S, device="cpu")
    tile_ptr = A.tile_ptr.numpy()
    steps = np.diff(tile_ptr) // A.G
    n_rows, n_cols = A.shape
    # what the case must reach
    assert n_rows % (A.S * LANES) != 0
    assert (steps == 0).any() == drop
    assert steps.max() >= 3 if "scatter" in case else (steps == 1).any()
    vals32 = A.values.float().numpy()
    cols = ((A.bases.numpy().astype(np.int64)[:, None, None] - (A.S - 1)
             + np.arange(A.S)[None, :, None]) * LANES + A.qidx.numpy().astype(np.int64))
    assert ((cols < 0) | (cols >= n_cols)).any()  # padding cells read 0 there
    x = _x(n_cols, seed=len(case))
    want = pell_loop(vals32, A.qidx.numpy(), A.bases.numpy(), tile_ptr, A.S, A.G, n_rows,
                     n_cols, x)
    got = ops_pell.pell_spmv_reference(A, torch.from_numpy(x))
    assert _bits_equal(got.numpy(), want)
    assert np.isnan(want).any() and np.isinf(x).any()
    if drop:  # the rows of a tile without steps are 0
        t = 1 if "tile1" in case else 0
        assert (want[t * A.S * LANES:(t + 1) * A.S * LANES] == 0).all()
    # the kernel's wrapper takes this plain version for a CPU tensor
    assert _bits_equal(ops_pell.pell_spmv(A, torch.from_numpy(x)).numpy(), want)


# -- K10: Bell ---------------------------------------------------------------------


@np.errstate(invalid="ignore")
def bell_loop(values, panel_ids, n_rows, n_cols, x):
    """K10's declared order in numpy float32: per panel a lane sum over
    l = 0..127 from 0, then the panel sums in panel order."""
    vals = np.asarray(values, F32)
    NRB, K, BR, _ = vals.shape
    xp = np.zeros(-(-n_cols // LANES) * LANES, F32)
    xp[:n_cols] = x
    total = np.zeros((NRB, BR), F32)
    for k in range(K):
        xk = xp.reshape(-1, LANES)[panel_ids[:, k]]  # (NRB, 128)
        lane = np.zeros((NRB, BR), F32)
        for l in range(LANES):
            lane = lane + vals[:, k, :, l] * xk[:, l][:, None]
        total = total + lane
    return total.reshape(-1)[:n_rows]


def block_structured(NRB, BR, K, NPC, seed=7):
    rng = np.random.default_rng(seed)
    rows_l, cols_l = [], []
    for rb in range(NRB):
        for pnl in rng.choice(NPC, size=K, replace=False):
            rr, cc = np.nonzero(rng.random((BR, LANES)) < 0.3)
            rows_l.append(rb * BR + rr)
            cols_l.append(pnl * LANES + cc)
    rows, cols = np.concatenate(rows_l), np.concatenate(cols_l)
    return rows, cols, (rng.random(len(rows)).astype(F32) - 0.5) * 1e-2


BELL_CASES = {
    # name: (NRB, generating BR, K, NPC, n_rows cut, n_cols, Bell BR, padding panel)
    "BR8_K6": (24, 8, 6, 12, 0, None, 8, False),
    "BR16_K1_cut_inside_a_panel": (12, 16, 1, 10, 0, 10 * LANES - 75, 16, False),
    "BR32_K6_rows_cut": (6, 32, 6, 16, 13, 16 * LANES - 1, 32, False),
    "BR8_padding_panels": (20, 8, 3, 10, 5, None, 8, True),
}


def _bell_case(case, panels):
    """The JAX package's Bell of a BELL_CASES entry carried across, its
    shape and whether it has padding panels."""
    NRB, gBR, K, NPC, cut, n_cols, BR, pad = BELL_CASES[case]
    rows, cols, vals = block_structured(NRB, gBR, K, NPC)
    shape = (NRB * gBR - cut, n_cols or NPC * LANES)
    keep = (rows < shape[0]) & (cols < shape[1])
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if pad:  # one more panel in row block 0: every other row block pads
        extra = min(set(range(NPC)) - set((cols[rows < BR] // LANES).tolist()))
        r = np.arange(BR)
        rows, cols = np.concatenate([rows, r]), np.concatenate([cols, extra * LANES + r])
        vals = np.concatenate([vals, np.ones(BR, F32)])
    JB = jbell.Bell.from_matrix_data(JMatrixData.from_coo(shape, rows, cols, vals),
                                     block_rows=BR)
    if panels == "bf16":
        JB = JB.reduce_storage()
    B = interop.bell_from_arrays(np.asarray(JB.values), np.asarray(JB.panel_ids),
                                 np.asarray(JB.panel_valid), np.asarray(JB.ent_flat),
                                 shape=JB.shape, block_rows=JB.block_rows,
                                 nnz_stored=JB.nnz_stored, device="cpu")
    assert B.values.shape[1:3] == (K + pad, BR)
    assert (B.panel_valid.numpy() == 0).any() == pad
    return B, shape, pad


@pytest.mark.parametrize("case", sorted(BELL_CASES))
@pytest.mark.parametrize("panels", ["f32", "bf16"])
def test_bell_reference_is_the_declared_order(case, panels):
    B, shape, pad = _bell_case(case, panels)
    BR = B.block_rows
    x = _x(shape[1], seed=BELL_CASES[case][0])
    if pad:
        x[3] = np.nan  # every padding panel reads it
    want = bell_loop(B.values.float().numpy(), B.panel_ids.numpy(), shape[0], shape[1], x)
    got = ops_bell.bell_spmv_reference(B, torch.from_numpy(x))
    assert _bits_equal(got.numpy(), want)
    if pad:
        padded_blocks = (B.panel_valid.numpy() == 0).any(axis=1)
        padded_rows = np.repeat(padded_blocks, BR)[:shape[0]]
        assert np.isnan(want[padded_rows]).all()
    assert _bits_equal(ops_bell.bell_spmv(B, torch.from_numpy(x)).numpy(), want)


# -- K11: Bell, k columns -------------------------------------------------------------


@np.errstate(invalid="ignore")
def bell_mm_loop(values, panel_ids, n_rows, n_cols, X):
    """K11's declared order in numpy float32, every column at once: per
    panel a lane sum over l = 0..127 from 0, then the panel sums in panel
    order."""
    vals = np.asarray(values, F32)
    NRB, K, BR, _ = vals.shape
    k = X.shape[1]
    Xp = np.zeros((-(-n_cols // LANES) * LANES, k), F32)
    Xp[:n_cols] = X
    total = np.zeros((NRB, BR, k), F32)
    for p in range(K):
        xk = Xp.reshape(-1, LANES, k)[panel_ids[:, p]]  # (NRB, 128, k)
        lane = np.zeros((NRB, BR, k), F32)
        for l in range(LANES):
            lane = lane + vals[:, p, :, l][:, :, None] * xk[:, None, l, :]
        total = total + lane
    return total.reshape(-1, k)[:n_rows]


@pytest.mark.parametrize("case", sorted(BELL_CASES))
@pytest.mark.parametrize("panels", ["f32", "bf16"])
@pytest.mark.parametrize("k", [2, 3, 9])
def test_bell_spmm_reference_is_the_declared_order(case, panels, k):
    B, shape, pad = _bell_case(case, panels)
    rng = np.random.default_rng(BELL_CASES[case][0] + k)
    X = rng.standard_normal((shape[1], k)).astype(F32)
    for value, count in ((np.nan, 3), (np.inf, 2), (-np.inf, 2), (-0.0, 3)):
        X.reshape(-1)[rng.integers(0, X.size, count)] = value
    if pad:
        X[3] = np.nan  # every padding panel reads it, in every column
    want = bell_mm_loop(B.values.float().numpy(), B.panel_ids.numpy(), shape[0], shape[1], X)
    got = ops_bell.bell_spmm_reference(B, torch.from_numpy(X))
    assert got.shape == (shape[0], k)
    assert _bits_equal(got.numpy(), want)
    for j in range(k):  # column j is K10's order on column j
        col = ops_bell.bell_spmv_reference(B, torch.from_numpy(X[:, j].copy()))
        assert _bits_equal(col.numpy(), want[:, j])
    assert np.isnan(want).any()
    if pad:
        padded_blocks = (B.panel_valid.numpy() == 0).any(axis=1)
        padded_rows = np.repeat(padded_blocks, B.block_rows)[:shape[0]]
        assert np.isnan(want[padded_rows]).all()
    # the kernel's wrapper takes this plain version for a CPU tensor
    assert _bits_equal(ops_bell.bell_spmm(B, torch.from_numpy(X)).numpy(), want)
