"""Problem + random-matrix generators.

Reference analogs: core/test/utils/matrix_generator.hpp
(generate_random_matrix, generate_random_band_matrix, ...) and the stencil
matrices used across examples (examples/three-pt-stencil-solver,
nine-pt-stencil-solver, poisson-solver) and benchmark/matrix_generator."""

from __future__ import annotations

import numpy as np

from ..base.matrix_data import MatrixData


def poisson_1d(n: int, dtype=np.float64) -> MatrixData:
    """Three-point stencil [-1, 2, -1] (examples/three-pt-stencil-solver)."""
    i = np.arange(n)
    rows = np.concatenate([i, i[:-1], i[1:]])
    cols = np.concatenate([i, i[1:], i[:-1]])
    vals = np.concatenate(
        [np.full(n, 2), np.full(n - 1, -1), np.full(n - 1, -1)]
    ).astype(dtype)
    return MatrixData.from_coo((n, n), rows, cols, vals).sort_row_major()


def poisson_2d(nx: int, ny: int | None = None, dtype=np.float64) -> MatrixData:
    """Five-point 2-D Laplacian stencil (examples/poisson-solver)."""
    ny = ny or nx
    n = nx * ny

    def idx(i, j):
        return i * ny + j

    rows, cols, vals = [], [], []
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    center = idx(ii, jj)
    rows.append(center)
    cols.append(center)
    vals.append(np.full(n, 4.0))
    for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        ni, nj = ii + di, jj + dj
        ok = (ni >= 0) & (ni < nx) & (nj >= 0) & (nj < ny)
        rows.append(center[ok])
        cols.append(idx(ni[ok], nj[ok]))
        vals.append(np.full(ok.sum(), -1.0))
    return MatrixData.from_coo(
        (n, n),
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals).astype(dtype),
    ).sort_row_major()


def poisson_2d_9pt(nx: int, ny: int | None = None, dtype=np.float64) -> MatrixData:
    """Nine-point stencil (examples/nine-pt-stencil-solver)."""
    ny = ny or nx
    n = nx * ny

    def idx(i, j):
        return i * ny + j

    rows, cols, vals = [], [], []
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    center = idx(ii, jj)
    rows.append(center)
    cols.append(center)
    vals.append(np.full(n, 8.0))
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            ni, nj = ii + di, jj + dj
            ok = (ni >= 0) & (ni < nx) & (nj >= 0) & (nj < ny)
            rows.append(center[ok])
            cols.append(idx(ni[ok], nj[ok]))
            vals.append(np.full(ok.sum(), -1.0))
    return MatrixData.from_coo(
        (n, n),
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals).astype(dtype),
    ).sort_row_major()


def generate_random_matrix(
    num_rows: int,
    num_cols: int,
    nnz_per_row_lo: int,
    nnz_per_row_hi: int,
    rng: np.random.Generator | int | None = None,
    dtype=np.float64,
    value_lo: float = -1.0,
    value_hi: float = 1.0,
) -> MatrixData:
    """Random sparsity + uniform values, per-row nnz in [lo, hi]
    (core/test/utils/matrix_generator.hpp generate_random_matrix)."""
    rng = np.random.default_rng(rng)
    rows_list, cols_list = [], []
    for r in range(num_rows):
        k = int(rng.integers(nnz_per_row_lo, nnz_per_row_hi + 1))
        k = min(k, num_cols)
        c = rng.choice(num_cols, size=k, replace=False)
        rows_list.append(np.full(k, r))
        cols_list.append(c)
    rows = np.concatenate(rows_list) if rows_list else np.zeros(0, np.int64)
    cols = np.concatenate(cols_list) if cols_list else np.zeros(0, np.int64)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        vals = rng.uniform(value_lo, value_hi, len(rows)) + 1j * rng.uniform(
            value_lo, value_hi, len(rows)
        )
        vals = vals.astype(dtype)
    else:
        vals = rng.uniform(value_lo, value_hi, len(rows)).astype(dtype)
    return MatrixData.from_coo((num_rows, num_cols), rows, cols, vals).sort_row_major()


def make_spd(data: MatrixData, shift: float | None = None) -> MatrixData:
    """Symmetrize + diagonally dominate (test helper make_hpd analog)."""
    a = data.to_dense()
    a = 0.5 * (a + a.conj().T)
    row_abs = np.abs(a).sum(axis=1)
    if shift is None:
        shift = 1.0
    np.fill_diagonal(a, row_abs + shift)
    return MatrixData.from_dense(a)


def generate_random_dense(
    num_rows, num_cols, rng=None, dtype=np.float64, lo=-1.0, hi=1.0
) -> np.ndarray:
    rng = np.random.default_rng(rng)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        return (
            rng.uniform(lo, hi, (num_rows, num_cols))
            + 1j * rng.uniform(lo, hi, (num_rows, num_cols))
        ).astype(dtype)
    return rng.uniform(lo, hi, (num_rows, num_cols)).astype(dtype)


def generate_tridiag_matrix(n, diag=2.0, offdiag=-1.0, dtype=np.float64) -> MatrixData:
    i = np.arange(n)
    rows = np.concatenate([i, i[:-1], i[1:]])
    cols = np.concatenate([i, i[1:], i[:-1]])
    vals = np.concatenate(
        [np.full(n, diag), np.full(n - 1, offdiag), np.full(n - 1, offdiag)]
    ).astype(dtype)
    return MatrixData.from_coo((n, n), rows, cols, vals).sort_row_major()


def poisson_3d(nx: int, ny: int | None = None, nz: int | None = None,
               dtype=np.float64) -> MatrixData:
    """7-point 3-D Poisson stencil (row-major z-fastest ordering); offsets
    {0, ±1, ±nz, ±ny*nz} — the 3-D analog of poisson_2d for the DIA/
    distributed-banded paths."""
    ny = ny or nx
    nz = nz or nx
    n = nx * ny * nz
    idx = np.arange(n)
    iz = idx % nz
    iy = (idx // nz) % ny
    ix = idx // (ny * nz)
    rows_l = [idx]
    cols_l = [idx]
    vals_l = [np.full(n, 6.0, dtype)]
    for coord, stride, size in ((iz, 1, nz), (iy, nz, ny), (ix, ny * nz, nx)):
        ok = coord + 1 < size
        rows_l += [idx[ok], idx[ok] + stride]
        cols_l += [idx[ok] + stride, idx[ok]]
        vals_l += [np.full(ok.sum(), -1.0, dtype)] * 2
    return MatrixData.from_coo(
        (n, n),
        np.concatenate(rows_l),
        np.concatenate(cols_l),
        np.concatenate(vals_l),
    ).sort_row_major()


def local_scatter(n: int, per_row: int = 9, half_window: int = 256,
                  seed: int = 11) -> MatrixData:
    """Unstructured pattern with column locality and no stencil structure:
    ``per_row`` random columns within ``half_window`` of each row, values
    uniform in (-0.005, 0.005), plus a diagonal of 4.0 (float32,
    duplicates summed).  The same pattern as the general-sparse rows of the
    JAX package's ``bench.py`` (``_local_spd``), for the same seed."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    cols = rows + rng.integers(-half_window, half_window + 1, size=rows.size)
    np.clip(cols, 0, n - 1, out=cols)
    vals = (rng.random(rows.size).astype(np.float32) - 0.5) * 1e-2
    return MatrixData.from_coo(
        (n, n),
        np.concatenate([rows, np.arange(n)]),
        np.concatenate([cols, np.arange(n)]),
        np.concatenate([vals, np.full(n, 4.0, np.float32)]),
    ).sum_duplicates()
