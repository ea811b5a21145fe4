"""Slice 7, the ILU-preconditioned whole solves: the port (ginkgo_tpu_torch)
against the JAX package (ginkgo_tpu) on the CPU.

- The plain versions of K23 (``cg_ilu_reference``) and K24
  (``bicgstab_ilu_reference``) against the JAX kernels cg_ilu_vmem_solve
  and bicgstab_ilu_vmem_solve in Pallas interpret mode, on the JAX
  operator's and triangles' own diagonals (``interop.dia_from_arrays``):
  the 16^2 Poisson matrix with IC and ILU sweeps for CG, the jittered 16^2
  convection-diffusion matrix with ILU for BiCGSTAB; sweeps 0/1/3/8, the
  implicit criterion, bfloat16 operator and triangles.  The JAX kernels sum
  their dots in float32 and XLA contracts their SpMVs into fused
  multiply-adds, the port sums in float64 and rounds every product: the
  iteration counts agree within one and x to 1e-4 of its largest entry.
- ``Cg`` and ``Bicgstab`` with ``Ilu``/``Ic`` built by both packages from
  the same matrix: the port takes its fused route (K23/K24's plain version
  here), the JAX package its streaming loop on the CPU; iteration counts
  within two, x within 1e-4 relative, and fewer iterations than plain CG
  (JAX tests/test_pallas_cg_ilu.py:41-65).
- The gate's refusals: reverse_apply, block_scan triangles, more than 8
  sweeps, Fcg, k > 1 columns, float64, a Csr operator, each streaming.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu import stop as jstop
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.matrix.dia import Dia as JDia
from ginkgo_tpu.ops.pallas_cg_ilu import bicgstab_ilu_vmem_solve, cg_ilu_vmem_solve
from ginkgo_tpu.preconditioner.ilu import Ic as JIc, Ilu as JIlu
from ginkgo_tpu.solver._fused_gate import frame as jframe
from ginkgo_tpu.solver.bicgstab import Bicgstab as JBicgstab
from ginkgo_tpu.solver.cg import Cg as JCg
from ginkgo_tpu.solver.triangular import LowerTrs as JLowerTrs, UpperTrs as JUpperTrs
from ginkgo_tpu_torch import interop, stop
from ginkgo_tpu_torch.ops import cg_ilu as ops_cg_ilu
from ginkgo_tpu_torch.preconditioner import Ic, Ilu
from ginkgo_tpu_torch.solver import LowerTrs, UpperTrs
from ginkgo_tpu_torch.solver import cg as sol_cg
from ginkgo_tpu_torch.solver._fused_gate import prepare_fused_dia_ilu
from tests.test_torch_bicgstab import convdiff_2d


def _parts(name):
    if name == "poisson16":
        d = gt.generators.poisson_2d(16, dtype=np.float32)
        return d.shape, d.rows, d.cols, d.values
    return convdiff_2d(16, jitter_seed=5)


def _builds(kind, sweeps_l, sweeps_u, jax):
    """(L, U) factory kwargs of an Ilu or the Ic factory kwargs."""
    mod = (JLowerTrs, JUpperTrs) if jax else (LowerTrs, UpperTrs)
    lf = mod[0].build(algorithm="sweeps", sweeps=sweeps_l)
    if kind == "ic":
        return (JIc if jax else Ic).build(l_solver_factory=lf)
    return (JIlu if jax else Ilu).build(
        l_solver_factory=lf, u_solver_factory=mod[1].build(algorithm="sweeps", sweeps=sweeps_u))


def _port_dia(J):
    return interop.dia_from_arrays(np.asarray(J.diags), J.offsets, J.shape, device="cpu")


def _kernel_case(name, kind, sweeps_l, sweeps_u, storage):
    JA = JDia.from_matrix_data(JMatrixData.from_coo(*_parts(name)))
    M = _builds(kind, sweeps_l, sweeps_u, jax=True).generate(JA.to_csr())
    JTl, JTu = M.l_solver.off_csr, M.u_solver.off_csr
    assert isinstance(JTl, JDia) and isinstance(JTu, JDia)
    if storage == "bf16":
        JA, JTl, JTu = (op.astype(jnp.bfloat16) for op in (JA, JTl, JTu))
    invdl = np.asarray((1.0 / M.l_solver.diag).astype(jnp.float32))
    invdu = np.asarray((1.0 / M.u_solver.diag).astype(jnp.float32))
    return JA, JTl, JTu, invdl, invdu


CASES = [
    # (kernel, matrix, preconditioner, sweeps_l, sweeps_u, storage, implicit)
    ("cg", "poisson16", "ic", 3, 3, "f32", False),
    ("cg", "poisson16", "ic", 0, 0, "f32", False),
    ("cg", "poisson16", "ilu", 1, 1, "f32", False),
    ("cg", "poisson16", "ic", 8, 8, "bf16", False),
    ("cg", "poisson16", "ilu", 3, 3, "f32", True),
    ("bicgstab", "convdiff16", "ilu", 3, 3, "f32", False),
    ("bicgstab", "convdiff16", "ilu", 1, 0, "bf16", False),
    ("bicgstab", "convdiff16", "ilu", 8, 3, "f32", True),
]


@pytest.mark.parametrize("kernel,name,kind,sweeps_l,sweeps_u,storage,implicit", CASES)
def test_plain_versions_match_pallas_kernels(kernel, name, kind, sweeps_l, sweeps_u, storage,
                                             implicit):
    JA, JTl, JTu, invdl, invdu = _kernel_case(name, kind, sweeps_l, sweeps_u, storage)
    A, Tl, Tu = _port_dia(JA), _port_dia(JTl), _port_dia(JTu)
    assert A.dtype == Tl.dtype == {"f32": torch.float32, "bf16": torch.bfloat16}[storage]
    n, R = A.shape[0], JA.diags.shape[1]
    b = np.random.default_rng(11).uniform(0.5, 1.5, n).astype(np.float32)
    tol = np.float32((1e-5 * np.linalg.norm(b)) ** 2)
    jkern, pkern = ((cg_ilu_vmem_solve, ops_cg_ilu.cg_ilu_reference) if kernel == "cg"
                    else (bicgstab_ilu_vmem_solve, ops_cg_ilu.bicgstab_ilu_reference))
    kw = dict(sweeps_l=sweeps_l, sweeps_u=sweeps_u, tol_sq_eff=tol, max_iters=300,
              use_implicit=implicit)
    jx, jit, _, jconv = jkern(JA, JTl, JTu, jframe(jnp.asarray(invdl)[:, None], R),
                              jframe(jnp.asarray(invdu)[:, None], R),
                              jframe(jnp.asarray(b)[:, None], R),
                              jframe(jnp.zeros((n, 1), jnp.float32), R), interpret=True, **kw)
    jx = np.asarray(jx).reshape(-1)[:n]
    x, r, it, mon, conv = pkern(A, Tl, Tu, torch.from_numpy(invdl.copy()),
                                torch.from_numpy(invdu.copy()), torch.from_numpy(b),
                                torch.zeros(n), **kw)
    assert bool(conv) and bool(jconv)
    assert abs(int(it) - int(jit)) <= 1
    np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=1e-4 * np.abs(jx).max())
    if not implicit:
        assert float(mon) <= tol


def test_nan_runs_to_the_cap():
    JA, JTl, JTu, invdl, invdu = _kernel_case("poisson16", "ic", 3, 3, "f32")
    A, Tl, Tu = _port_dia(JA), _port_dia(JTl), _port_dia(JTu)
    b = torch.ones(A.shape[0])
    b[7] = float("nan")
    for run in (ops_cg_ilu.cg_ilu_fused, ops_cg_ilu.bicgstab_ilu_fused):
        x, r, it, mon, conv = run(A, Tl, Tu, torch.from_numpy(invdl.copy()),
                                  torch.from_numpy(invdu.copy()), b, torch.zeros_like(b),
                                  sweeps_l=3, sweeps_u=3, tol_sq_eff=1e-6, max_iters=17)
        assert int(it) == 17 and torch.isnan(mon) and not bool(conv)


def _solver_pair(jcls, pcls, name, kind, sweeps, crit):
    parts = _parts(name)
    JA = JDia.from_matrix_data(JMatrixData.from_coo(*parts))
    A = gt.Dia.from_matrix_data(gt.MatrixData.from_coo(*parts), device="cpu")
    jc = [jstop.Iteration(max_iters=crit[0]), jstop.ResidualNorm(tolerance=crit[1])]
    pc = [stop.Iteration(max_iters=crit[0]), stop.ResidualNorm(tolerance=crit[1])]
    js = jcls.build(criteria=jc, preconditioner=_builds(kind, sweeps, sweeps, True)).generate(JA)
    ps = pcls.build(criteria=pc, preconditioner=_builds(kind, sweeps, sweeps, False)).generate(A)
    return JA, A, js, ps


@pytest.mark.parametrize("solver,kind", [("cg", "ic"), ("cg", "ilu"), ("bicgstab", "ilu")])
def test_solvers_with_ilu_match_jax(solver, kind):
    name = "poisson16" if solver == "cg" else "convdiff16"
    jcls, pcls = (JCg, gt.Cg) if solver == "cg" else (JBicgstab, gt.Bicgstab)
    JA, A, js, ps = _solver_pair(jcls, pcls, name, kind, 3, (300, 1e-6))
    n = A.shape[0]
    b = np.random.default_rng(12).uniform(0.5, 1.5, (n, 1)).astype(np.float32)
    assert prepare_fused_dia_ilu(ps, torch.from_numpy(b)) is not None
    jx, jinfo = js.solve(jnp.asarray(b))  # the JAX package streams on the CPU
    x, info = ps.solve(torch.from_numpy(b))
    assert bool(info.converged.all()) and bool(jinfo.converged.all())
    assert abs(int(info.iterations) - int(jinfo.iterations)) <= 2
    jx = np.asarray(jx)
    np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=1e-4 * np.abs(jx).max())
    # the preconditioner cuts the iterations against the unpreconditioned solver
    _, plain = pcls.build(criteria=[stop.Iteration(max_iters=300),
                                    stop.ResidualNorm(tolerance=1e-6)]).generate(A).solve(
        torch.from_numpy(b))
    assert int(info.iterations) < int(plain.iterations)


def test_fused_and_streaming_ilu_routes_agree():
    """The fused route (K23's plain version) against the port's own streaming
    loop with the same preconditioner (K22's plain version per triangle)."""
    _, A, _, ps = _solver_pair(JCg, gt.Cg, "poisson16", "ic", 3, (300, 1e-6))
    b = torch.ones(A.shape[0], 1)
    x, info = ps.solve(b)
    xs, sinfo = ps._solve_streaming(b, torch.zeros_like(b))
    assert abs(info.num_iterations - sinfo.num_iterations) <= 1
    np.testing.assert_allclose(x.numpy(), xs.numpy(), rtol=0, atol=1e-4 * float(xs.abs().max()))


def test_gate_declines_stream():
    _, A, _, ps = _solver_pair(JCg, gt.Cg, "poisson16", "ilu", 3, (20, 1e-6))
    b = torch.ones(A.shape[0], 1)
    assert prepare_fused_dia_ilu(ps, b) is not None
    M = ps.preconditioner
    many = Ilu.build(l_solver_factory=LowerTrs.build(algorithm="sweeps", sweeps=9),
                     u_solver_factory=UpperTrs.build(algorithm="sweeps", sweeps=9)).generate(A)
    declined = {
        "reverse_apply": (ps.replace(preconditioner=M.replace(reverse_apply=True)), b),
        "block_scan": (ps.replace(preconditioner=Ilu.build().generate(A)), b),
        "sweeps > 8": (ps.replace(preconditioner=many), b),
        "k = 2": (ps, torch.ones(A.shape[0], 2)),
        "float64": (ps, b.double()),
        "Csr operator": (ps.replace(A=A.to_csr()), b),
    }
    for label, (s, rhs) in declined.items():
        assert prepare_fused_dia_ilu(s, rhs) is None, label
        assert sol_cg._try_fused(s, rhs, torch.zeros_like(rhs), False) is None, label
    # Fcg never takes the ILU route (the JAX package's is plain CG's only)
    fcg = gt.Fcg.build(criteria=[stop.Iteration(max_iters=20)], preconditioner=M).generate(A)
    assert prepare_fused_dia_ilu(fcg, b) is not None
    assert sol_cg._try_fused(fcg, b, torch.zeros_like(b), True) is None
    x, info = fcg.solve(b)
    assert info.num_iterations == 20 and torch.isfinite(x).all()
    # Bicgstab streams the same refusals
    bs = gt.Bicgstab.build(criteria=[stop.Iteration(max_iters=20)], preconditioner=M).generate(A)
    assert bs._try_fused(b, torch.zeros_like(b)) is not None
    for label in ("reverse_apply", "block_scan", "sweeps > 8"):
        s = bs.replace(preconditioner=declined[label][0].preconditioner)
        assert s._try_fused(b, torch.zeros_like(b)) is None, label


def test_wrappers_take_plain_versions_on_cpu():
    JA, JTl, JTu, invdl, invdu = _kernel_case("poisson16", "ilu", 2, 2, "f32")
    A, Tl, Tu = _port_dia(JA), _port_dia(JTl), _port_dia(JTu)
    b = torch.ones(A.shape[0])
    args = (A, Tl, Tu, torch.from_numpy(invdl.copy()), torch.from_numpy(invdu.copy()), b,
            torch.zeros_like(b))
    kw = dict(sweeps_l=2, sweeps_u=2, tol_sq_eff=1e-8, max_iters=50)
    before = (ops_cg_ilu.cg_ilu_fused.launches, ops_cg_ilu.bicgstab_ilu_fused.launches)
    for kern, plain in ((ops_cg_ilu.cg_ilu_fused, ops_cg_ilu.cg_ilu_reference),
                        (ops_cg_ilu.bicgstab_ilu_fused, ops_cg_ilu.bicgstab_ilu_reference)):
        for g, w in zip(kern(*args, **kw), plain(*args, **kw)):
            assert torch.equal(g, w)
    assert (ops_cg_ilu.cg_ilu_fused.launches, ops_cg_ilu.bicgstab_ilu_fused.launches) == before
