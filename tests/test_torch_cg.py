"""K4's plain version (ginkgo_tpu_torch.ops.cg.cg_solve_reference) against
the JAX whole-solve kernel ginkgo_tpu.ops.pallas_cg.cg_vmem_solve, run in
Pallas interpret mode on the CPU.

Both take identical float32 operands (the port's Dia is built from the JAX
Dia's arrays through ginkgo_tpu_torch.interop).  The iteration counts must
be equal; x and the monitor agree to float32 round-off (the JAX kernel
sums its dot products in float32 chunks, the port in float64), with the
tolerances of tests/test_pallas_cg.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ginkgo_tpu.matrix.dia import Dia as JDia
from ginkgo_tpu.ops.pallas_cg import cg_vmem_solve
from ginkgo_tpu.utils import generators as jgen
from ginkgo_tpu_torch import interop
from ginkgo_tpu_torch.ops.cg import cg_fused, cg_solve_reference

LANES = 128


def _shifted_poisson(nside, rng):
    """2-D Poisson with a random positive diagonal shift: SPD, with a
    non-constant diagonal so Jacobi is not a scalar multiple of I."""
    data = jgen.poisson_2d(nside, dtype=np.float32)
    diag = data.rows == data.cols
    vals = data.values.copy()
    vals[diag] += rng.uniform(0.0, 2.0, int(diag.sum())).astype(np.float32)
    return interop.matrix_data_from_arrays(data.shape, data.rows, data.cols, vals)


def _frame(v, R):
    out = np.zeros(R * LANES, np.float32)
    out[: v.shape[0]] = v
    return jnp.asarray(out.reshape(R, LANES))


CASES = {
    # name: (max_iters, tol mode, implicit, flexible, jacobi, x0 value, rhs)
    "resnorm": (500, "rel", False, False, False, 0.0, "ones"),
    "implicit": (500, "rel", True, False, False, 0.0, "ones"),
    "iteration_only": (30, "none", False, False, False, 0.0, "ones"),
    "jacobi": (500, "rel", False, False, True, 0.0, "ones"),
    "initial_guess": (500, "rel", False, False, False, 0.5, "ones"),
    "flexible": (500, "rel", False, True, True, 0.0, "ones"),
    "negative_tol_runs_to_cap": (40, "negative", False, False, False, 0.0, "random"),
    "zero_denominator": (500, "rel", False, False, False, 0.0, "zeros"),
    "nan_runs_full_cap": (25, "rel", False, False, False, 0.0, "nan"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cg_reference_matches_pallas_cg(case):
    max_iters, tol_mode, implicit, flexible, jacobi, x0v, rhs = CASES[case]
    rng = np.random.default_rng(7)
    data = _shifted_poisson(16, rng)
    JA = JDia.from_matrix_data(data)
    A = interop.dia_from_arrays(np.asarray(JA.diags), JA.offsets, JA.shape, device="cpu")
    n = data.shape[0]
    R = JA.diags.shape[1]
    Ad = data.to_dense().astype(np.float64)
    b = {
        "ones": np.ones(n, np.float32),
        "random": rng.standard_normal(n).astype(np.float32),
        "zeros": np.zeros(n, np.float32),
        "nan": np.ones(n, np.float32),
    }[rhs]
    x0 = np.full(n, x0v, np.float32)
    r0 = (b - Ad @ x0).astype(np.float32)
    if rhs == "nan":
        r0[3] = np.nan
    tol_sq = {
        "rel": np.float32((1e-6 * np.linalg.norm(b)) ** 2),
        "none": np.float32(-1.0),
        "negative": np.float32(-1.0),
    }[tol_mode]
    minv = (1.0 / np.diag(Ad)).astype(np.float32) if jacobi else None

    jx, jit_, jmon, jconv = cg_vmem_solve(
        JA.diags, JA.offsets, _frame(r0, R), _frame(x0, R),
        None if minv is None else _frame(minv, R),
        tol_sq_eff=tol_sq, max_iters=max_iters, use_implicit=implicit,
        flexible=flexible, interpret=True,
    )
    t = torch.from_numpy
    x, r, it, mon, conv = cg_solve_reference(
        A.diags, A.offsets, t(r0), t(x0), None if minv is None else t(minv),
        tol_sq_eff=float(tol_sq), max_iters=max_iters, use_implicit=implicit,
        flexible=flexible,
    )
    assert it.dtype == torch.int32 and mon.dtype == torch.float32
    assert int(it) == int(jit_)
    assert bool(conv) == bool(jconv)
    jx = np.asarray(jx).reshape(-1)[:n]
    if rhs == "nan":
        assert int(it) == max_iters
        assert np.isnan(float(mon)) and np.isnan(float(jmon))
        assert np.isnan(jx).all() and torch.isnan(x).all()
        return
    assert np.isfinite(x.numpy()).all()
    np.testing.assert_allclose(x.numpy(), jx, rtol=2e-6, atol=2e-5)
    np.testing.assert_allclose(float(mon), float(jmon), rtol=1e-3, atol=1e-30)
    if tol_mode == "negative":
        assert int(it) == max_iters and not bool(conv)
    if rhs == "zeros":
        assert int(it) == 1 and bool(conv)
        np.testing.assert_array_equal(x.numpy(), x0)
    # r is the recurrence residual the kernel carries
    np.testing.assert_allclose(
        r.numpy(), (b - Ad @ x.numpy()).astype(np.float32), atol=1e-4
    )


def test_cg_fused_wrapper_takes_plain_version_on_cpu():
    """On a CPU tensor the K4 wrapper runs the plain version (no launch)."""
    data = jgen.poisson_2d(8, dtype=np.float32)
    JA = JDia.from_matrix_data(data)
    A = interop.dia_from_arrays(np.asarray(JA.diags), JA.offsets, JA.shape, device="cpu")
    b = torch.ones(64)
    before = cg_fused.launches
    got = cg_fused(A.diags, A.offsets, b, torch.zeros(64), None,
                   tol_sq_eff=1e-10, max_iters=100)
    want = cg_solve_reference(A.diags, A.offsets, b, torch.zeros(64), None,
                              tol_sq_eff=1e-10, max_iters=100)
    assert cg_fused.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
