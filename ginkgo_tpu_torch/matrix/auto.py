"""Automatic format selection.

Counterpart of ``ginkgo_tpu/matrix/auto.py`` (reference: Csr's
``automatical`` strategy, csr.hpp:526, one level up): the format decides
whether the SpMV streams or gathers.  Banded operators go to ``Dia``,
column-local ones to ``Pell`` or ``Bell``, locality-free ones to ``Well``,
and the rest stays ``Csr``.  The thresholds and their order are the JAX
package's, so both packages pick the same class for the same data.
"""

from __future__ import annotations

import numpy as np

from ..base import types
from ..base.matrix_data import MatrixData
from ..ops.pell import PellPlan
from ..ops.well import WellPlan
from .bell import Bell, bell_inflation_estimate
from .csr import Csr
from .dia import Dia, suitable_for_dia
from .pell import Pell
from .well import Well

#: most padded bytes of a Well that choose_format accepts
WELL_MAX_PADDED_BYTES = 1 << 30


def choose_format(data: MatrixData, max_diags: int = 64, max_inflation: float = 40.0,
                  block_rows: int = 8, *, device):
    """The fastest suitable operator for ``data``, built on ``device``.

    Preference: Dia > (Pell | Bell, whichever streams fewer bytes per
    nonzero) > Pell up to twice ``max_inflation`` > Well > Csr.  The
    inflations compared are allocated-cell inflations, padding included,
    from statistics-only plans: nothing is materialized for a candidate
    that loses."""
    if suitable_for_dia(data, max_diags=max_diags):
        return Dia.from_matrix_data(data, device=device)
    if data.nnz:
        best_bell = None
        for br in (block_rows, 2 * block_rows, 4 * block_rows):
            inflation = bell_inflation_estimate(data, block_rows=br)
            if best_bell is None or inflation < best_bell[1]:
                best_bell = (br, inflation)
        csr = Csr.from_matrix_data(data, device=device)
        host = [types.to_host(t) for t in (csr.row_ptrs, csr.col_idxs, csr.values)]
        itemsize = csr.values.element_size()
        stats = PellPlan(*host, csr.shape, q_dtype=np.int8, materialize=False,
                         value_itemsize=itemsize)
        # bytes streamed per nonzero: Pell a value and an int8 lane index
        # (5 B a cell), Bell the dense panels (4 B a cell)
        pell_bytes = stats.inflation * 5
        bell_bytes = best_bell[1] * 4
        if pell_bytes <= bell_bytes and stats.inflation <= max_inflation:
            return Pell.from_csr(csr)
        if best_bell[1] <= max_inflation:
            return Bell.from_matrix_data(data, block_rows=best_bell[0], device=device)
        if stats.inflation <= 2 * max_inflation:
            return Pell.from_csr(csr)
        # the locality-free tail: the WELL layout, whenever its padded bytes
        # are sane
        wstats = WellPlan(*host, csr.shape, materialize=False, value_itemsize=itemsize)
        if (wstats.inflation * wstats.bytes_per_cell < min(pell_bytes, bell_bytes)
                and wstats.padded_bytes <= WELL_MAX_PADDED_BYTES):
            return Well.from_csr(csr, T=wstats.T)
    return Csr.from_matrix_data(data, device=device)
