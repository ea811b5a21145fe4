"""choose_format and slice 3 end to end, in the port against the JAX
package on the CPU.

- choose_format returns the same class as the JAX package's on a Poisson
  stencil (Dia), a local scatter (Pell), a block-structured pattern (Bell)
  and a power-law pattern (Well), with the same arrays.
- The slice: a symmetric power-law graph Laplacian plus the identity,
  handed over as a Csr, solved by Cg in both packages in float64.  The
  port runs its "pallas" strategy (the WELL plan the accelerator branch of
  "auto" picks, through K8's plain version) and the JAX package its
  "classical" gather (its merge_path, which the CPU branch of "auto" picks
  for skewed rows, sums a row as a difference of prefix sums and loses
  digits).  Solved to 1e-12: there iteration counts agree within one and
  solutions within 1e-10 (at 1e-10 the residual of this system lingers
  at the threshold for two iterations, and the two packages' dot products,
  summed in other orders, stop two iterations apart).
"""

import jax
import numpy as np
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu import stop as jstop
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.matrix.auto import choose_format as jchoose
from ginkgo_tpu.matrix.csr import Csr as JCsr
from ginkgo_tpu.solver.cg import Cg as JCg
from ginkgo_tpu_torch import interop
from ginkgo_tpu_torch.ops import pell as ops_pell
from tests.test_torch_bell import block_structured
from tests.test_well import _powerlaw


def powerlaw_laplacian(n, seed=23):
    """The JAX bench's power-law pattern (bench.py, row_pell_powerlaw: Zipf
    out-degrees capped at 64, targets biased to low ids) made symmetric,
    P + P^T, as a shifted graph Laplacian L + I: -1 off the diagonal, and
    on the diagonal the row's off-diagonal count + 1 (SPD)."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(2.1, size=n) + 2, 64)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = np.minimum((rng.random(rows.size) ** 3.0 * n).astype(np.int64), n - 1)
    off = rows != cols
    key = np.unique(np.concatenate([rows[off] * n + cols[off], cols[off] * n + rows[off]]))
    r, c = key // n, key % n
    diag = np.bincount(r, minlength=n) + 1.0
    return (n, n), np.concatenate([r, np.arange(n)]), np.concatenate([c, np.arange(n)]), \
        np.concatenate([np.full(len(r), -1.0), diag]).astype(np.float32)


def _data(shape, rows, cols, vals):
    return (JMatrixData.from_coo(shape, rows, cols, vals).sum_duplicates(),
            interop.matrix_data_from_arrays(shape, rows, cols, vals).sum_duplicates())


def _coo(d):
    return d.shape, d.rows, d.cols, d.values


CASES = {
    "poisson": (lambda: _coo(gt.generators.poisson_2d(8)), {}, "Dia"),
    "scatter": (lambda: _coo(gt.generators.local_scatter(2048)), {}, "Pell"),
    "blocks": (lambda: (lambda r, c, v, s: (s, r, c, v))(*block_structured(16, 8, 2, 4, 0.5)),
               {}, "Bell"),
    "powerlaw": (lambda: (lambda c: (c.shape, c.row, c.col, c.data))(_powerlaw(8192).tocoo()),
                 {"max_inflation": 20.0}, "Well"),
}

ARRAYS = {"Dia": ("diags",), "Pell": ("values", "qidx", "bases"),
          "Bell": ("values", "panel_ids", "panel_valid", "ent_flat"),
          "Well": ("values", "qidx", "rt", "tsb", "bases")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_choose_format_matches_jax(case):
    make, kw, kind = CASES[case]
    shape, rows, cols, vals = make()
    jd, pd = _data(shape, rows, cols, vals)
    J = jchoose(jd, **kw)
    P = gt.choose_format(pd, **kw, device="cpu")
    assert type(P).__name__ == type(J).__name__ == kind
    if kind == "Dia":
        assert tuple(P.offsets) == tuple(J.offsets)
        np.testing.assert_array_equal(P.to_dense().values.numpy(), np.asarray(J.to_dense().values))
        return
    for f in ARRAYS[kind]:
        np.testing.assert_array_equal(getattr(P, f).numpy(), np.asarray(getattr(J, f)), err_msg=f)


def test_choose_format_falls_back_to_csr():
    """A locality-free pattern whose WELL plan streams more bytes than the
    other candidates stays a Csr in both packages."""
    jd, pd = _data(*_coo(gt.generators.generate_random_matrix(64, 2048, 1, 2, 5)))
    J = jchoose(jd, max_inflation=1.0)
    P = gt.choose_format(pd, max_inflation=1.0, device="cpu")
    assert type(P).__name__ == type(J).__name__


def test_slice_end_to_end(monkeypatch):
    shape, rows, cols, vals = powerlaw_laplacian(4096)
    jd, pd = _data(shape, rows, cols, vals.astype(np.float64))
    n = shape[0]
    b = np.random.default_rng(0).uniform(0.5, 1.5, n)
    # the port's accelerator branch of "auto" takes the WELL plan, as the
    # JAX package's does
    C = gt.Csr.from_matrix_data(pd, device="cpu")
    JC = JCsr.from_matrix_data(jd)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert C._resolve_unstructured() == JC._resolve_strategy_uncached() == "pallas"
    monkeypatch.undo()
    C = C.with_strategy("pallas")
    crit = [gt.stop.Iteration(max_iters=500), gt.stop.ResidualNorm(tolerance=1e-12)]
    before = ops_pell.plan_for.builds
    x, info = gt.Cg.build(criteria=crit).generate(C).solve(torch.from_numpy(b))
    assert ops_pell.plan_for.builds == before + 1
    jcrit = [jstop.Iteration(max_iters=500), jstop.ResidualNorm(tolerance=1e-12)]
    jx, jinfo = JCg.build(criteria=jcrit).generate(JC.with_strategy("classical")).solve(
        jax.numpy.asarray(b))
    assert bool(info.converged.all()) and bool(np.asarray(jinfo.converged).all())
    assert abs(int(info.num_iterations) - int(np.asarray(jinfo.num_iterations))) <= 1
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-10, atol=1e-10)
    assert isinstance(ops_pell.plan_for(C.row_ptrs, C.col_idxs, C.values, C.shape), gt.Well)
    # the cached plan is the Well a user builds from the Csr
    W, cached = gt.Well.from_csr(C), ops_pell.plan_for(C.row_ptrs, C.col_idxs, C.values, C.shape)
    for f in ("values", "qidx", "rt", "tsb", "bases", "tile_ptr"):
        assert torch.equal(getattr(W, f), getattr(cached, f)), f
