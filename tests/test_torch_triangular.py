"""Slice 7, triangular solves: the port (ginkgo_tpu_torch) against the JAX
package (ginkgo_tpu) on the CPU.

- ``TriangularSolver`` with both algorithms ('block_scan' and 'sweeps'),
  lower and upper, with and without a unit diagonal, generated by both
  packages from the same ILU(0) factor of a 16^2 convection-diffusion
  matrix: in float64 the solutions agree to 1e-12 relative (the sweeps
  stream in both packages: the fused route takes float32 only) and equal
  the exact solution where the algorithm is exact (block_scan, and sweeps
  at the level count); in float32 the port's sweeps run K22's plain
  version, which multiplies by the inverse diagonal where the JAX
  streaming loop divides, so they agree to 1e-5 relative.
- K22's plain version ``trs_reference`` against the JAX kernel
  ``trs_vmem_solve`` in Pallas interpret mode, on the JAX triangle's own
  diagonals (``interop.dia_from_arrays``): XLA on the CPU contracts the
  product's sums into fused multiply-adds
  (tests/test_torch_ir.py::test_xla_contracts_multiply_adds), so x is held
  to 2 float32 epsilons of max |x| (a Jacobi sweep on a diagonally
  dominant factor does not amplify the difference).
- The K22 route: a 'sweeps' solve on a float32/bfloat16 Dia triangle with a
  float32 right-hand side and sweeps >= 1 takes ``trs_fused`` (one launch
  per column); block_scan, sweeps = 0, a float64 or bfloat16 right-hand
  side and a triangle that is not a Dia stream.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.factorization.ilu import IluFactory as JIluFactory
from ginkgo_tpu.matrix.csr import Csr as JCsr
from ginkgo_tpu.ops.pallas_trs import trs_vmem_solve
from ginkgo_tpu.solver._fused_gate import frame as jframe
from ginkgo_tpu.solver.triangular import (
    LowerTrsFactory as JLowerTrsFactory,
    UpperTrsFactory as JUpperTrsFactory,
    _level_count as j_level_count,
)
from ginkgo_tpu_torch import interop
from ginkgo_tpu_torch.factorization import IluFactory
from ginkgo_tpu_torch.ops import trs as ops_trs
from ginkgo_tpu_torch.solver.triangular import (
    LowerTrsFactory,
    TriangularSolver,
    UpperTrsFactory,
    _level_count,
)
from tests.test_torch_bicgstab import convdiff_2d

EPS32 = float(np.finfo(np.float32).eps)


def _factors(dtype=np.float64, nside=16):
    """The ILU(0) factors of the jittered convection-diffusion matrix from
    both packages: (JAX L, JAX U, port L, port U)."""
    shape, rows, cols, vals = convdiff_2d(nside, jitter_seed=5)
    vals = vals.astype(dtype)
    parts = (shape, rows, cols, vals)
    jf = JIluFactory().generate(JCsr.from_matrix_data(JMatrixData.from_coo(*parts)))
    pf = IluFactory().generate(gt.Csr.from_matrix_data(gt.MatrixData.from_coo(*parts),
                                                       device="cpu"))
    return jf.l_factor, jf.u_factor, pf.l_factor, pf.u_factor


def _solvers(lower, **kw):
    JL, JU, L, U = _factors(kw.pop("dtype", np.float64))
    jfac, pfac, JT, T = ((JLowerTrsFactory, LowerTrsFactory, JL, L) if lower
                         else (JUpperTrsFactory, UpperTrsFactory, JU, U))
    return jfac(**kw).generate(JT), pfac(**kw).generate(T), T


@pytest.mark.parametrize("unit_diag", [False, True])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("algorithm", ["block_scan", "sweeps"])
def test_triangular_solver_matches_jax_float64(algorithm, lower, unit_diag):
    kw = dict(algorithm=algorithm, unit_diagonal=unit_diag)
    if algorithm == "block_scan":
        kw["block"] = 32
    js, ps, T = _solvers(lower, **kw)
    assert ps.algorithm == algorithm and ps.dtype == torch.float64
    assert str(js.dtype) == "float64"
    n = ps.shape[0]
    b = np.random.default_rng(3).standard_normal((n, 2))
    jx = np.asarray(js.apply(jnp.asarray(b)))
    x = ps.apply(torch.from_numpy(b))
    assert x.dtype == torch.float64 and x.shape == (n, 2)
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-12, atol=1e-12 * np.abs(jx).max())
    # block_scan and sweeps at the level count (sweeps=None) are exact
    sp = T.to_scipy().tocsr()
    if unit_diag:
        sp = sps.tril(sp, -1) + sps.eye(n) if lower else sps.triu(sp, 1) + sps.eye(n)
    exact = spla.spsolve_triangular(sp.tocsr(), b, lower=lower)
    np.testing.assert_allclose(x.numpy(), exact, rtol=1e-10, atol=1e-10 * np.abs(exact).max())
    if algorithm == "sweeps":
        assert ps.sweeps == js.sweeps == _level_count(sp.tocsr(), lower)


@pytest.mark.parametrize("lower", [True, False])
def test_sweeps_float32_route_matches_jax(lower):
    """float32: the port runs K22 (its plain version here), the JAX package
    its streaming loop; 3 sweeps, one and two columns."""
    js, ps, _ = _solvers(lower, algorithm="sweeps", sweeps=3, dtype=np.float32)
    assert isinstance(ps.off_csr, gt.Dia) and ps.dtype == torch.float32
    n = ps.shape[0]
    b = np.random.default_rng(4).uniform(0.5, 1.5, (n, 2)).astype(np.float32)
    for cols in (b[:, :1], b):
        arr = torch.from_numpy(cols.copy())
        assert ps._try_fused_sweeps(arr) is not None
        x = ps.apply(arr)
        jx = np.asarray(js.apply(jnp.asarray(cols)))
        assert x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), jx, rtol=1e-5, atol=1e-6 * np.abs(jx).max())
        invd = (1.0 / ps.diag).float()
        for j in range(cols.shape[1]):
            want = ops_trs.trs_reference(ps.off_csr, invd, arr[:, j].contiguous(), sweeps=3)
            assert torch.equal(x[:, j], want)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("sweeps", [1, 3, 8])
def test_trs_reference_matches_pallas_kernel(sweeps, storage):
    JL, _, _, _ = _factors(np.float32)
    js = JLowerTrsFactory(algorithm="sweeps", sweeps=sweeps).generate(JL)
    JT = js.off_csr
    if storage == "bf16":
        JT = JT.astype(jnp.bfloat16)
    T = interop.dia_from_arrays(np.asarray(JT.diags), JT.offsets, JT.shape, device="cpu")
    assert str(T.dtype).split(".")[-1] == str(JT.diags.dtype)
    n, R = T.shape[0], JT.diags.shape[1]
    b = np.random.default_rng(5).uniform(0.5, 1.5, n).astype(np.float32)
    invd = np.asarray((1.0 / js.diag).astype(jnp.float32))
    jx = trs_vmem_solve(JT, jframe(jnp.asarray(invd)[:, None], R),
                        jframe(jnp.asarray(b)[:, None], R), sweeps=sweeps, interpret=True)
    jx = np.asarray(jx).reshape(-1)[:n]
    x = ops_trs.trs_reference(T, torch.from_numpy(invd.copy()), torch.from_numpy(b), sweeps=sweeps)
    np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=2 * EPS32 * np.abs(jx).max())


def test_k22_route_and_declines():
    _, ps, _ = _solvers(True, algorithm="sweeps", sweeps=3, dtype=np.float32)
    n = ps.shape[0]
    b = torch.ones(n, 1)
    assert ps._try_fused_sweeps(b) is not None
    before = ops_trs.trs_fused.launches
    x = ps.apply(b[:, 0])
    assert x.shape == (n,) and ops_trs.trs_fused.launches == before  # CPU: the plain version
    declined = {
        "float64 rhs": (ps, b.double()),
        "bfloat16 rhs": (ps, b.to(torch.bfloat16)),
        "sweeps = 0": (ps.replace(sweeps=0), b),
        "block_scan": (_solvers(True, algorithm="block_scan", dtype=np.float32)[1], b),
        "Csr triangle": (ps.replace(off_csr=ps.off_csr.to_csr()), b),
    }
    for label, (s, rhs) in declined.items():
        assert s._try_fused_sweeps(rhs) is None, label
        assert torch.isfinite(s.apply(rhs)).all(), label
    # the streaming loop on a Csr triangle divides by the diagonal
    s = ps.replace(off_csr=ps.off_csr.to_csr())
    np.testing.assert_allclose(s.apply(b).numpy(), ps.apply(b).numpy(), rtol=1e-5)


def test_bfloat16_rhs_dtypes_match_jax():
    """block_scan computes in the right-hand side's dtype; sweeps promote
    it with the factor's (ginkgo_tpu solver/triangular.py)."""
    for algorithm in ("block_scan", "sweeps"):
        js, ps, _ = _solvers(True, algorithm=algorithm, sweeps=2, dtype=np.float32)
        for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float64, torch.float64)):
            jy = js.apply(jnp.ones((ps.shape[0], 1), jdt))
            y = ps.apply(torch.ones(ps.shape[0], 1, dtype=tdt))
            assert str(y.dtype).split(".")[-1] == str(jy.dtype), (algorithm, jdt)


def test_level_count_and_interop_carry_jax_solvers():
    JL, JU, L, U = _factors()
    for lower, JT, T in ((True, JL, L), (False, JU, U)):
        sp = T.to_scipy().tocsr()
        assert _level_count(sp, lower) == j_level_count(JT.to_scipy().tocsr(), lower)
        for algorithm in ("block_scan", "sweeps"):
            jfac = JLowerTrsFactory if lower else JUpperTrsFactory
            js = jfac(algorithm=algorithm, sweeps=4, block=16).generate(JT)
            if algorithm == "sweeps":
                JO = js.off_csr
                op = interop.dia_from_arrays(np.asarray(JO.diags), JO.offsets, JO.shape,
                                             device="cpu")
                ps = interop.triangular_solver_from_arrays(
                    np.asarray(js.diag), n=js.n, block=js.block, lower=js.lower,
                    unit_diag=js.unit_diag, algorithm=js.algorithm, sweeps=js.sweeps,
                    off_op=op, device="cpu")
            else:
                ps = interop.triangular_solver_from_arrays(
                    np.asarray(js.diag), n=js.n, block=js.block, lower=js.lower,
                    unit_diag=js.unit_diag, algorithm=js.algorithm, sweeps=js.sweeps,
                    inv_diag_blocks=np.asarray(js.inv_diag_blocks),
                    off_cols=np.asarray(js.off_cols), off_vals=np.asarray(js.off_vals),
                    off_lrow=np.asarray(js.off_lrow), device="cpu")
            assert isinstance(ps, TriangularSolver)
            b = np.random.default_rng(6).standard_normal((js.n, 1))
            np.testing.assert_allclose(ps.apply(torch.from_numpy(b)).numpy(),
                                       np.asarray(js.apply(jnp.asarray(b))), rtol=1e-13,
                                       atol=1e-13)
