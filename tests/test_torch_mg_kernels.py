"""Slice 8, the fused multigrid kernels K25-K28: their plain versions
(``ops/mg.py``) against the JAX kernels (``ginkgo_tpu/ops/pallas_mg.py``)
in Pallas interpret mode on the CPU, on one hierarchy carried across by
``interop.multigrid_from_arrays`` (the JAX hierarchy's diagonals, inverse
diagonals, transfers and dense coarse inverse, bit for bit).

The hierarchy: poisson_2d(32), float32, 4 levels (1024, 512, 256, 128
rows; 64 coarse rows), one smoothing sweep at 0.9.  The tolerances are the
JAX package's own for its fused-versus-generic comparisons
(tests/test_pallas_mg.py): rtol = atol = 3e-5 for one cycle, iterations
within one and x to 2e-4 for a solve.  The JAX kernels sum in float32 and
XLA contracts their multiply-adds; the plain versions round every product
and sum dots in float64.  Each interpret-mode call takes several seconds,
so there are six: K25 with a V, an F and a K cycle, K26, K27 and K28.

Route tests state which gate accepts and which declines, and the two
declared differences from the JAX gate: the port takes any stride (a 48^2
hierarchy, whose strides 2S do not divide 128, runs K25 where the JAX gate
declines) and has no VMEM budget or environment flag.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ginkgo_tpu as gko
import ginkgo_tpu_torch as gt
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.ops import pallas_mg as jmg
from ginkgo_tpu.solver._fused_gate import frame as jframe
from ginkgo_tpu_torch import interop, stop
from ginkgo_tpu_torch.ops import mg as ops_mg
from ginkgo_tpu_torch.solver._fused_gate import prepare_fused_mg


def _jax_mg(nside=32, **kw):
    data = gt.generators.poisson_2d(nside, dtype=np.float32)
    jd = JMatrixData.from_coo(data.shape, data.rows, data.cols, data.values)
    JA = gko.matrix.dia.Dia.from_matrix_data(jd)
    kw.setdefault("max_levels", 4)
    kw.setdefault("min_coarse_rows", 32)
    return JA, gko.solver.Multigrid.build(**kw).generate(JA)


def _port_dia(J):
    return interop.dia_from_arrays(np.asarray(J.diags), J.offsets, J.shape, device="cpu")


def _carry(jm):
    """The port's Multigrid on the JAX hierarchy's arrays."""
    transfers = []
    for lv in jm.levels:
        R = lv.restrict_op
        transfers.append(dict(stride=R.stride, deltas=R.deltas, delta=np.asarray(R.delta),
                              n_coarse=R.n_coarse))
    return interop.multigrid_from_arrays(
        [_port_dia(lv.fine_op) for lv in jm.levels], _port_dia(jm.levels[-1].coarse_op),
        transfers, [np.asarray(s.dinv) for s in jm.pre_smoothers],
        coarse_dense_inv=np.asarray(jm.coarse_dense_inv), cycle=jm.cycle,
        mid_case=jm.mid_case, kcycle_base=jm.kcycle_base, kcycle_rel_tol=jm.kcycle_rel_tol,
        smoother_iters=jm.pre_smoothers[0].iters, smoother_relax=jm.pre_smoothers[0].relax,
        device="cpu")


def _rhs(n, seed=3):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def test_carried_hierarchy_equals_generated():
    """interop's Multigrid and the port's own Pgm hierarchy of the same
    matrix hold identical operators, smoothers and coarse inverse."""
    JA, jm = _jax_mg()
    pm = _carry(jm)
    own = gt.Multigrid.build(max_levels=4, min_coarse_rows=32).generate(_port_dia(JA))
    h, ho = pm._fused_hierarchy(), own._fused_hierarchy()
    assert h is not None and ho is not None and h.sizes == ho.sizes == (1024, 512, 256, 128, 64)
    for a, b in zip(h.diags + h.dinv + (h.minv,), ho.diags + ho.dinv + (ho.minv,)):
        assert torch.equal(a, b)
    assert h.strides == ho.strides and h.offsets == ho.offsets


@pytest.mark.parametrize("cycle,x0", [("v", False), ("f", True), ("k", False)])
def test_vcycle_plain_matches_pallas(cycle, x0):
    JA, jm = _jax_mg(cycle=cycle)
    parts = jm._fused_vcycle_parts()
    assert parts is not None
    pm = _carry(jm)
    h = pm._fused_hierarchy()
    n, R0 = JA.shape[0], parts["plan"]["lv"][0]["R"]
    b = _rhs(n)
    xs = _rhs(n, seed=8) if x0 else None
    jx = jmg.mg_vmem_vcycle(parts["plan"], parts["diags"], parts["dinv2"], parts["minv2"],
                            jframe(jnp.asarray(b)[:, None], R0),
                            None if xs is None else jframe(jnp.asarray(xs)[:, None], R0),
                            interpret=True)
    jx = np.asarray(jx).reshape(-1)[:n]
    x = ops_mg.mg_vcycle_reference(h, torch.from_numpy(b),
                                   None if xs is None else torch.from_numpy(xs))
    np.testing.assert_allclose(x.numpy(), jx, rtol=3e-5, atol=3e-5)


def _solve_case(kernel):
    JA, jm = _jax_mg()
    parts = jm._fused_vcycle_parts()
    pm = _carry(jm)
    h = pm._fused_hierarchy()
    n, R0 = JA.shape[0], parts["plan"]["lv"][0]["R"]
    b = np.random.default_rng(5).uniform(0.5, 1.5, n).astype(np.float32)
    # a float32 multigrid solve stagnates near 2e-5 (poisson_2d: pairwise
    # aggregation with a V(1,1) cycle); the solvers reach 1e-6
    rel = 1e-4 if kernel == "solve" else 1e-6
    tol = np.float32((rel * np.linalg.norm(b)) ** 2)
    fb, fz = jframe(jnp.asarray(b)[:, None], R0), jframe(jnp.zeros((n, 1), jnp.float32), R0)
    A = _port_dia(JA)
    tb, tz = torch.from_numpy(b), torch.zeros(n)
    if kernel == "solve":
        jx, jit, _, jconv = jmg.mg_vmem_solve(parts["plan"], parts["diags"], parts["dinv2"],
                                              parts["minv2"], fb, fz, tol_sq_eff=tol,
                                              max_iters=200, interpret=True)
        x, it, rr, conv = ops_mg.mg_solve_reference(h, tb, tz, tol_sq_eff=tol, max_iters=200)
    else:
        jfn, pfn = {"cg": (jmg.mg_cg_vmem_solve, ops_mg.mg_cg_solve_reference),
                    "bicgstab": (jmg.mg_bicgstab_vmem_solve,
                                 ops_mg.mg_bicgstab_solve_reference)}[kernel]
        jx, jit, _, jconv = jfn(JA, parts["plan"], parts["diags"], parts["dinv2"],
                                parts["minv2"], fb, fz, tol_sq_eff=tol, max_iters=60,
                                interpret=True)
        x, _r, it, _mon, conv = pfn(A, h, tb, tz, tol_sq_eff=tol, max_iters=60)
    return np.asarray(jx).reshape(-1)[:n], int(jit), bool(jconv), x.numpy(), int(it), bool(conv)


@pytest.mark.parametrize("kernel", ["cg", "solve", "bicgstab"])
def test_solve_plain_matches_pallas(kernel):
    jx, jit, jconv, x, it, conv = _solve_case(kernel)
    assert jconv and conv
    assert abs(it - jit) <= 1
    np.testing.assert_allclose(x, jx, rtol=2e-4, atol=2e-4)


def test_visit_counts_match_jax():
    for L in range(1, 9):
        for mode in "vwf":
            assert ops_mg.visit_count(L, mode) == jmg._visit_count(L, mode)


@pytest.mark.parametrize("cycle,rel_tol", [("v", 0.25), ("w", 0.25), ("f", 0.25), ("k", 0.25),
                                           ("k", 0.0), ("k", float("inf"))])
def test_plan_visits_and_stash_match_jax(cycle, rel_tol):
    _, jm = _jax_mg(cycle=cycle, kcycle_rel_tol=rel_tol)
    jplan = jm._fused_vcycle_parts()["plan"]
    h = _carry(jm)._fused_hierarchy()
    assert h.plan["visits"] == jplan["visits"]
    assert h.plan["kacc"][:h.L] == list(jplan["kacc"][:h.L])
    assert [bool(r) for r in jplan["RVk"]] == h.plan["stash"]
    passes = h.passes[False][0]
    # one COARSE pass a coarsest visit, one RESTRICT and one PROLONG a
    # level visit; a K-cycle's second inner solve is in the list once,
    # behind its jump
    counts = np.bincount(passes[:, 0], minlength=len(ops_mg.PASS_NAMES))
    assert counts[ops_mg.RESTRICT] == counts[ops_mg.PROLONG]
    assert counts[ops_mg.COARSE] + counts[ops_mg.RESTRICT] == jplan["visits"]


def test_route_48_strides_take_k25():
    """Declared difference: the 48^2 hierarchy's strides (48, 24, ...) fail
    the JAX gate's lane-frame condition 128 % 2S == 0 or S % 128 == 0; the
    port has no lane frame and takes K25 (tests/test_pallas_mg.py:41-47)."""
    _, jm = _jax_mg(48, max_levels=6)
    assert jm._fused_vcycle_parts() is None
    pm = _carry(jm)
    assert any(128 % (2 * s) and s % 128 for s in pm._fused_hierarchy().strides)
    b = torch.ones(pm.shape[0], 1)
    x = pm._try_fused_vcycle(b, None)
    xs = pm._run_cycle(0, b, None, "v")
    np.testing.assert_allclose(x.numpy(), xs.numpy(), rtol=3e-5, atol=3e-5)


def test_route_no_vmem_budget_or_env_flags(monkeypatch):
    """Declared difference: the JAX gates also ask the VMEM fits
    (vcycle_vmem_fits, mg_cg_vmem_fits, mg_solve_vmem_fits,
    mg_bicgstab_vmem_fits) and the GINKGO_TPU_* flags; the port's gate
    looks at structure only."""
    _, jm = _jax_mg()
    parts = jm._fused_vcycle_parts()
    monkeypatch.setattr(jmg, "cg_vmem_budget_bytes", lambda: 0)
    assert not jmg.vcycle_vmem_fits(parts["plan"])
    assert not jmg.mg_solve_vmem_fits(parts["plan"])
    monkeypatch.setenv("GINKGO_TPU_NO_PALLAS", "1")
    assert _carry(jm)._fused_hierarchy() is not None


def _solver(cls, M, A, **kw):
    crit = kw.pop("criteria", [stop.Iteration(max_iters=50), stop.ResidualNorm(tolerance=1e-6)])
    return cls.build(criteria=crit, preconditioner=M, **kw).generate(A)


def test_routes_accept_and_decline():
    JA, jm = _jax_mg()
    pm = _carry(jm)
    A = pm.levels[0].fine_op
    b1 = torch.ones(A.shape[0], 1)
    for cls in (gt.Cg, gt.Fcg, gt.Bicgstab):
        assert prepare_fused_mg(_solver(cls, pm, A), b1) is not None
    # declined: two columns, float64, a Csr operator, history tracking,
    # another preconditioner, an operator of another size
    assert prepare_fused_mg(_solver(gt.Cg, pm, A), torch.ones(A.shape[0], 2)) is None
    assert prepare_fused_mg(_solver(gt.Cg, pm, A), b1.double()) is None
    assert prepare_fused_mg(_solver(gt.Cg, pm, A.to_csr()), b1) is None
    assert prepare_fused_mg(_solver(gt.Cg, pm, A, track_history=True), b1) is None
    assert prepare_fused_mg(_solver(gt.Cg, None, A), b1) is None
    A2 = gt.Dia.from_matrix_data(gt.generators.poisson_2d(16, dtype=np.float32), device="cpu")
    assert prepare_fused_mg(_solver(gt.Cg, pm, A2), torch.ones(256, 1)) is None
    # the hierarchy's own gate: a custom criterion keeps K27 out
    pm.criterion = stop.combine([stop.Iteration(max_iters=3), stop.ImplicitResidualNorm(),
                                 stop.ResidualNorm()])
    assert pm._try_fused_solve(b1, torch.zeros_like(b1)) is None


def test_hierarchy_gate_declines():
    """Each structural condition of the gate, in both packages."""
    # W with 7 levels: more than 96 visits
    _, jm = _jax_mg(64, cycle="w", max_levels=7, min_coarse_rows=16)
    assert jm._fused_vcycle_parts() is None
    assert gt.Multigrid.build(cycle="w", max_levels=7, min_coarse_rows=16).generate(
        _port_dia(jm.levels[0].fine_op))._fused_hierarchy() is None
    _, jm = _jax_mg()
    pm = _carry(jm)
    assert pm.replace(coarse_dense_inv=None)._fused_hierarchy() is None
    assert pm.replace(mid_case="sometimes")._fused_hierarchy() is None
    other = gt.solver.multigrid.FixedSmoother(A=pm.levels[0].fine_op,
                                               dinv=pm.pre_smoothers[0].dinv, iters=2)
    post = (other,) + pm.post_smoothers[1:]
    assert pm.replace(post_smoothers=post)._fused_hierarchy() is None
    # the same sweeps in another object are accepted
    same = gt.solver.multigrid.FixedSmoother(A=pm.levels[0].fine_op,
                                              dinv=pm.pre_smoothers[0].dinv)
    assert pm.replace(post_smoothers=(same,) + pm.post_smoothers[1:])._fused_hierarchy()
    csr_level = pm.levels[0].replace(fine_op=pm.levels[0].fine_op.to_csr())
    assert pm.replace(levels=(csr_level,) + pm.levels[1:])._fused_hierarchy() is None
