"""Algebraic multigrid solver (V/W/F/K cycles).

Counterpart of ``ginkgo_tpu/solver/multigrid.py`` (reference
core/solver/multigrid.cpp: the hierarchy built in generate(), the cycle in
MultigridState::run_cycle :269-489, pre/mid/post smoothers and a coarse
solver).  ``Multigrid`` is a standalone solver (``solve``: cycles to the
stop test) and a preconditioner (``apply``: one cycle from zero).

Routes, decided by structure only (so the CPU, where each kernel's plain
version runs, and the card route alike):

- the fused routes (``_fused_hierarchy``, the JAX package's
  ``_fused_vcycle_parts`` gate, solver/multigrid.py:354-454): cycle v/w/f/k
  with at most 96 level visits, an all-``Dia`` hierarchy of float32/
  bfloat16 diagonals, ``FixedSmoother``s with equal iterations and
  relaxation in every role, ``BandedRestriction``/``BandedProlongation``
  pairs with deltas == (0,) and equal strides, and the default ``Direct``
  coarse solver with its dense inverse (at most 1536 coarse rows), and
  the kernels' 32-bit rows (``ops/mg.rows_fit``: at most 2^30 fine rows
  and 2 S <= 2^30 for every stride S).  One
  float32 column: ``apply``/``cycle_apply`` run one cycle in kernel K25
  (``ops/mg.mg_vcycle``), ``solve`` with a simple residual criterion runs
  the cycles and the stop test in K27 (``ops/mg.mg_solve_fused``); ``Cg``/
  ``Fcg`` and ``Bicgstab`` with a ``Multigrid`` preconditioner run in K26
  and K28 (their own routes).  The TPU-only conditions of the JAX gate are
  left behind: the VMEM fits, the lane-frame stride condition and the
  environment flags;
- otherwise the streaming cycle (``_run_cycle``), step for step as the JAX
  package's: ``FixedSmoother`` sweeps in one K17 ``ir_smooth`` launch on a
  ``Dia`` with one float32 column, the level operators' products, the
  transfers as tensor ops and the coarse solver's ``apply``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..base.linop import LinOp, as_2d, restore_1d
from ..matrix.dia import Dia
from ..multigrid.pgm import BandedProlongation, BandedRestriction, PgmFactory
from ..ops import mg as ops_mg
from ..ops.cg import FUSED_DIAG_DTYPES, _sqrt
from ..ops.dia import MAX_DIAGS
from ..ops.ir import ir_smooth
from ..stop.criterion import Iteration, ResidualNorm, analyze_simple_residual, combine
from .solver_base import SolveInfo, extract_max_iters, norm2

#: most coarse rows whose dense inverse the factory stores (ginkgo_tpu
#: solver/multigrid.py:700)
MAX_DENSE_COARSE_ROWS = 1536


@dataclasses.dataclass(eq=False)
class FixedSmoother(LinOp):
    """Fixed-count damped Jacobi-Richardson smoother (the reference's
    default build_smoother(Jacobi, 1, 0.9), multigrid.hpp): ``iters``
    sweeps x += relax dinv (b - A x).  On a square ``Dia`` with 1 to 64
    float32/bfloat16 diagonals and one float32 column all sweeps run in
    one launch of K17's ``ir_smooth``; otherwise as plain tensor ops."""

    A: Any
    dinv: Any  # (n,) inverse diagonal, in A's dtype
    iters: int = 1
    relax: float = 0.9

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return self.A.dtype

    def _kernel_ok(self, arr):
        A = self.A
        return (arr.dim() == 2 and arr.shape[1] == 1 and arr.dtype == torch.float32
                and isinstance(A, Dia) and A.shape[0] == A.shape[1]
                and 1 <= A.num_diags <= MAX_DIAGS and A.dtype in FUSED_DIAG_DTYPES)

    def _fused(self, arr, x0_arr, with_residual):
        """(x, r or None) from one ``ir_smooth`` launch, or None."""
        if not self._kernel_ok(arr):
            return None
        x, r = ir_smooth(
            self.A.diags, self.A.offsets, arr[:, 0].contiguous(),
            None if x0_arr is None else x0_arr[:, 0].to(torch.float32).contiguous(),
            self.dinv.to(torch.float32).contiguous(), omega=self.relax, iters=self.iters,
            with_residual=with_residual)
        return x[:, None], (r[:, None] if with_residual else None)

    def solve(self, b, x0=None):
        arr, was_1d = as_2d(b)
        x0_arr = None if x0 is None else as_2d(x0)[0]
        fast = self._fused(arr, x0_arr, with_residual=False)
        if fast is not None:
            return restore_1d(fast[0], was_1d), None
        x = torch.zeros_like(arr) if x0_arr is None else x0_arr
        scale = torch.tensor(self.relax, dtype=arr.dtype, device=arr.device) * self.dinv[:, None]
        for _ in range(self.iters):
            x = x + scale * (arr - as_2d(self.A.apply(x))[0])
        return restore_1d(x, was_1d), None

    def solve_with_residual(self, b, x0=None):
        """(x, r = b - A x): the kernel returns r with x; the plain loop
        pays one more product."""
        arr, was_1d = as_2d(b)
        x0_arr = None if x0 is None else as_2d(x0)[0]
        fast = self._fused(arr, x0_arr, with_residual=True)
        if fast is not None:
            return restore_1d(fast[0], was_1d), restore_1d(fast[1], was_1d)
        x, _ = self.solve(arr, x0=x0_arr)
        r = arr - as_2d(self.A.apply(x))[0]
        return restore_1d(x, was_1d), restore_1d(r, was_1d)

    def apply(self, b):
        return self.solve(b)[0]


def _fixed_smoother(A, iters=1, relax=0.9):
    src = A if hasattr(A, "extract_diagonal") else A.to_csr()
    diag = src.extract_diagonal().values
    nz = diag != 0
    dinv = torch.where(nz, 1.0 / torch.where(nz, diag, torch.ones_like(diag)),
                       torch.zeros_like(diag))
    return FixedSmoother(A=A, dinv=dinv.to(A.dtype), iters=iters, relax=relax)


def default_smoother_factory(A):
    """Damped Jacobi-Richardson, 1 iteration (the reference's default
    build_smoother(Jacobi, 1, 0.9), multigrid.hpp)."""
    return _fixed_smoother(A)


def default_coarse_solver_factory(A):
    from .direct import DirectFactory

    return DirectFactory().generate(A)


def _same_sweeps(s, pre):
    return s is pre or (isinstance(s, FixedSmoother) and s.iters == pre.iters
                        and s.relax == pre.relax)


@dataclasses.dataclass(eq=False)
class Multigrid(LinOp):
    levels: tuple  # of MultigridLevel
    pre_smoothers: tuple
    post_smoothers: tuple
    mid_smoothers: tuple
    coarse_solver: Any
    criterion: Any
    #: (n_c, n_c) float32 dense inverse of the coarsest operator, built at
    #: generate time when the coarse solver is the default Direct solve
    #: (x_c = inv @ b_c; the fused kernels' coarse solve)
    coarse_dense_inv: Any = None
    #: 'v' | 'w' | 'f' (multigrid.hpp:79) | 'k' (the JAX package's working
    #: K-cycle)
    cycle: str = "v"
    #: FCG acceleration when level % kcycle_base == 0
    kcycle_base: int = 1
    #: second FCG iteration: <= 0 never, +inf always, else iff the updated
    #: residual norm > rel_tol * old (kcycle_check_stop)
    kcycle_rel_tol: float = 0.25
    #: mid_smooth_type (multigrid.hpp:95): 'both' | 'post_smoother' |
    #: 'pre_smoother' | 'standalone'
    mid_case: str = "standalone"

    @property
    def shape(self):
        return self.levels[0].fine_op.shape

    @property
    def dtype(self):
        return self.levels[0].fine_op.dtype

    # -- the streaming cycle -----------------------------------------------------------

    def _run_cycle(self, lvl: int, b, x, mode: str, first: bool = True, end: bool = True):
        """MultigridState::run_mg_cycle (multigrid.cpp:403-487), step for step
        as ginkgo_tpu's ``_run_cycle``: pre-smooth on first visits (or when
        mid_case routes the mid role through it), the W/F second coarse
        visit from the first one's solution with the same rhs (F drops to
        V), one prolongation per visit, post-smooth at the end (or with
        mid_case 'both'/'post_smoother'), the standalone mid smoother at the
        end of non-final W/F visits.  x None is a zero guess."""
        level = self.levels[lvl]
        A = level.fine_op
        if first or self.mid_case in ("both", "pre_smoother"):
            pre = self.pre_smoothers[lvl]
            if hasattr(pre, "solve_with_residual"):
                x, r = pre.solve_with_residual(b, x0=x)
            else:
                x = pre.solve(b, x0=x)[0]
                r = b - A.apply(x)
        else:
            if x is None:
                x = torch.zeros_like(b)
            r = b - A.apply(x)
        rc = level.restrict_op.apply(r)
        if lvl + 1 == len(self.levels):
            ec = self.coarse_solver.apply(rc)
        elif mode == "k":
            if lvl % max(self.kcycle_base, 1) == 0:
                ec = self._kcycle_correction(lvl, rc)
            else:
                ec = self._run_cycle(lvl + 1, rc, None, "k", first=True, end=True)
        else:
            ec = self._run_cycle(lvl + 1, rc, None, mode, first=True, end=(mode == "v"))
            if mode in ("w", "f"):
                ec = self._run_cycle(lvl + 1, rc, ec, "v" if mode == "f" else mode,
                                     first=False, end=True)
        x = x + level.prolong_op.apply(ec)
        if end or self.mid_case in ("both", "post_smoother"):
            x = self.post_smoothers[lvl].solve(b, x0=x)[0]
        if mode in ("w", "f") and not end and self.mid_case == "standalone":
            x = self.mid_smoothers[lvl].solve(b, x0=x)[0]
        return x

    def _kcycle_correction(self, lvl, rc):
        """FCG(2)-accelerated coarse correction (the K-cycle), with the
        reference kcycle kernels' scalar formulas and finite guards
        (reference/solver/multigrid_kernels.cpp:55-121), as ginkgo_tpu's."""
        Ac = self.levels[lvl].coarse_op

        def col(a, b):
            return torch.sum(a * b, dim=0)

        c1 = self._run_cycle(lvl + 1, rc, None, "k", first=True, end=True)
        v = Ac.apply(c1)
        rho = col(c1, v)
        alpha = col(c1, rc)
        temp = alpha / rho
        fin = torch.isfinite(temp)
        tempe = torch.where(fin, temp, torch.ones_like(temp))
        g2 = torch.where(fin[None, :], rc - tempe[None, :] * v, rc)
        e1 = torch.where(fin[None, :], tempe[None, :] * c1, c1)

        def second():
            c2 = self._run_cycle(lvl + 1, g2, None, "k", first=True, end=True)
            w = Ac.apply(c2)
            gamma = col(c1, w)
            beta = col(c2, w)
            zeta = col(c2, g2)
            scalar_d = zeta / (beta - gamma * gamma / rho)
            scalar_e = 1.0 - gamma / alpha * scalar_d
            ok = torch.isfinite(scalar_d) & torch.isfinite(scalar_e)
            return torch.where(ok[None, :], scalar_e[None, :] * e1 + scalar_d[None, :] * c2,
                               e1)

        rt = self.kcycle_rel_tol
        if math.isnan(rt) or (math.isinf(rt) and rt > 0):
            return second()
        if rt <= 0:
            return e1
        old_n = torch.sqrt(col(rc, rc))
        new_n = torch.sqrt(col(g2, g2))
        return second() if bool(torch.any(new_n > rt * old_n)) else e1

    # -- the fused routes -------------------------------------------------------------

    def _fused_hierarchy(self):
        """The structural gate of the fused routes (see the module
        docstring); the :class:`ops.mg.MgHierarchy` the kernels read, built
        once per Multigrid, or None."""
        cache = self.__dict__.get("_fused_cache")
        if cache is not None:
            return cache[0]
        h = self._build_fused_hierarchy()
        self.__dict__["_fused_cache"] = (h,)
        return h

    def _build_fused_hierarchy(self):
        from .direct import Direct

        if self.cycle not in ("v", "w", "f", "k"):
            return None
        if self.mid_case not in ("both", "post_smoother", "pre_smoother", "standalone"):
            return None
        inv = self.coarse_dense_inv
        if inv is None or not isinstance(self.coarse_solver, Direct):
            return None
        if not 1 <= len(self.levels) <= ops_mg.MAX_LEVELS:
            return None
        mid_used = self.cycle in ("w", "f") and self.mid_case == "standalone"
        meta, strides = [], []
        n = self.levels[0].fine_op.shape[0]
        for l, level in enumerate(self.levels):
            A = level.fine_op
            pre, post = self.pre_smoothers[l], self.post_smoothers[l]
            if not (isinstance(A, Dia) and isinstance(pre, FixedSmoother)):
                return None
            if A.shape != (n, n) or A.num_diags == 0 or A.dtype not in FUSED_DIAG_DTYPES:
                return None
            if not _same_sweeps(post, pre) or (mid_used and not _same_sweeps(
                    self.mid_smoothers[l], pre)):
                return None
            R, P = level.restrict_op, level.prolong_op
            if not (isinstance(R, BandedRestriction) and isinstance(P, BandedProlongation)
                    and R.deltas == (0,) and P.deltas == (0,) and R.stride == P.stride
                    and R.shape == (P.shape[1], n) and P.shape[0] == n):
                return None
            n = R.n_coarse
            if level.coarse_op.shape != (n, n):
                return None
            strides.append(R.stride)
            meta.append(dict(iters_pre=pre.iters, relax_pre=pre.relax, iters_post=pre.iters,
                             relax_post=pre.relax, iters_mid=pre.iters, relax_mid=pre.relax))
        if tuple(inv.shape) != (n, n):
            return None
        if not ops_mg.rows_fit(self.levels[0].fine_op.shape[0], strides):
            return None
        plan = ops_mg.build_cycle_plan(meta, self.cycle, self.mid_case, self.kcycle_base,
                                       self.kcycle_rel_tol)
        if plan["visits"] > ops_mg.MAX_VISITS:  # a W-cycle grows exponentially
            return None
        return ops_mg.make_hierarchy(
            [lv.fine_op.diags for lv in self.levels], [lv.fine_op.offsets for lv in self.levels],
            [s.dinv for s in self.pre_smoothers], strides, inv, meta, mode=self.cycle,
            mid_case=self.mid_case, kcycle_base=self.kcycle_base,
            kcycle_rel_tol=self.kcycle_rel_tol)

    def _try_fused_vcycle(self, arr, x_arr):
        """One cycle in K25 for one float32 column, or None.  x_arr None is
        a zero guess."""
        if arr.dim() != 2 or arr.shape[1] != 1 or arr.dtype != torch.float32:
            return None
        h = self._fused_hierarchy()
        if h is None:
            return None
        x0 = None if x_arr is None else x_arr[:, 0].to(torch.float32).contiguous()
        return ops_mg.mg_vcycle(h, arr[:, 0].contiguous(), x0)[:, None]

    def cycle_apply(self, b, x, x_is_zero=False):
        """One full multigrid cycle from initial guess x."""
        fast = self._try_fused_vcycle(b, None if x_is_zero else x)
        if fast is not None:
            return fast
        return self._run_cycle(0, b, x, self.cycle)

    # -- LinOp / solver surface ---------------------------------------------------------

    def apply(self, b):
        """Preconditioner-style apply: one cycle from zero."""
        arr, was_1d = as_2d(b)
        with torch.no_grad():
            out = self.cycle_apply(arr, torch.zeros_like(arr), x_is_zero=True)
        return restore_1d(out, was_1d)

    def solve(self, b, x0=None):
        arr, was_1d = as_2d(b)
        x = torch.zeros_like(arr) if x0 is None else as_2d(x0)[0]
        with torch.no_grad():
            xr, info = self._solve_impl(arr, x)
        return restore_1d(xr, was_1d), info

    def _try_fused_solve(self, arr, x):
        """The cycles and the true-residual stop test in K27 for one float32
        column under a simple Iteration/ResidualNorm criterion, or None."""
        from ._fused_gate import tol_sq_eff

        if arr.dim() != 2 or arr.shape[1] != 1 or arr.dtype != torch.float32:
            return None
        simple = analyze_simple_residual(self.criterion)
        if simple is None:
            return None
        tol, baseline, _implicit, has_res = simple
        h = self._fused_hierarchy()
        if h is None:
            return None
        A = self.levels[0].fine_op
        r0 = arr - as_2d(A.apply(x))[0]
        tol_sq = tol_sq_eff({"has_res": has_res, "baseline": baseline, "tol": tol}, arr, r0)
        xr, it, mon, conv = ops_mg.mg_solve_fused(
            h, arr[:, 0].contiguous(), x[:, 0].to(torch.float32).contiguous(),
            tol_sq_eff=tol_sq, max_iters=extract_max_iters(self.criterion))
        return xr[:, None], SolveInfo(iterations=it, residual_norm=_sqrt(mon)[None],
                                      converged=(conv & has_res)[None])

    def _solve_impl(self, arr, x):
        fast = self._try_fused_solve(arr, x)
        if fast is not None:
            return fast
        cap = extract_max_iters(self.criterion)
        A = self.levels[0].fine_op
        k, dev = arr.shape[1], arr.device
        r0 = arr - A.apply(x)
        baselines = {"num_cols": k, "device": dev, "rhs_norm": norm2(arr),
                     "initial_resnorm": norm2(r0)}
        it = 0
        stopped = torch.zeros(k, dtype=torch.bool, device=dev)
        rn = baselines["initial_resnorm"]
        # the loop condition reads the stop flags on the host once per cycle
        while it < cap and not bool(torch.all(stopped)):
            x_new = self.cycle_apply(arr, x)
            x = torch.where(stopped[None, :], x, x_new)
            rn = norm2(arr - A.apply(x))
            ctx = dict(baselines)
            ctx.update(iteration=it + 1, residual_norm=rn, implicit_sq_residual_norm=rn**2)
            stopped = stopped | self.criterion.check_converged(ctx)
            it += 1
        return x, SolveInfo(iterations=torch.tensor(it, dtype=torch.int32, device=dev),
                            residual_norm=rn, converged=stopped)

    @staticmethod
    def build(**kw):
        return MultigridFactory(**kw)


class MultigridFactory:
    """multigrid.hpp factory: mg_level (level factory), max_levels (default
    10), min_coarse_rows (default 64), cycle, smoother/coarse-solver
    factories, smoother_iters, smoother_relax."""

    def __init__(
        self,
        criteria=None,
        mg_level=None,
        max_levels: int = 10,
        min_coarse_rows: int = 64,
        cycle: str = "v",
        mid_case: str = "standalone",
        kcycle_base: int = 1,
        kcycle_rel_tol: float = 0.25,
        pre_smoother=None,
        post_smoother=None,
        mid_smoother=None,
        coarse_solver=None,
        smoother_iters: int = 1,
        smoother_relax: float = 0.9,
    ):
        self.criteria = criteria
        self.mg_level = mg_level or PgmFactory()
        self.max_levels = max_levels
        self.min_coarse_rows = min_coarse_rows
        self.cycle = cycle
        self.mid_case = mid_case
        self.kcycle_base = kcycle_base
        # the documented nan sentinel ("always two") is canonicalized to
        # +inf, as the JAX package does
        self.kcycle_rel_tol = (float("inf") if math.isnan(kcycle_rel_tol)
                               else float(kcycle_rel_tol))
        self.smoother_iters = smoother_iters
        self.smoother_relax = smoother_relax
        self.pre_smoother = pre_smoother
        self.post_smoother = post_smoother
        self.mid_smoother = mid_smoother
        self.coarse_solver = coarse_solver

    def _make_smoother(self, A):
        return _fixed_smoother(A, iters=self.smoother_iters, relax=self.smoother_relax)

    def generate(self, A) -> Multigrid:
        levels = []
        op = A
        while len(levels) < self.max_levels and op.shape[0] > self.min_coarse_rows:
            level = self.mg_level.generate(op)
            if level.coarse_op.shape[0] >= op.shape[0]:
                break  # no coarsening progress
            levels.append(level)
            op = level.coarse_op
        if not levels:
            level = self.mg_level.generate(op)
            levels.append(level)
            op = level.coarse_op
        mk_pre = self.pre_smoother or self._make_smoother
        mk_post = self.post_smoother or mk_pre
        mk_mid = self.mid_smoother or mk_post
        pre = tuple(mk_pre(l.fine_op) for l in levels)
        # identical factories give identical smoothers: reuse them
        post = pre if mk_post is mk_pre else tuple(mk_post(l.fine_op) for l in levels)
        mid = post if mk_mid is mk_post else tuple(mk_mid(l.fine_op) for l in levels)
        mk_coarse = self.coarse_solver or default_coarse_solver_factory
        coarse = mk_coarse(op)
        crit = combine(self.criteria) if self.criteria is not None else combine(
            [Iteration(max_iters=100), ResidualNorm(tolerance=1e-8)])
        return Multigrid(
            levels=tuple(levels), pre_smoothers=pre, post_smoothers=post, mid_smoothers=mid,
            coarse_solver=coarse, criterion=crit,
            coarse_dense_inv=self._coarse_inverse(op, coarse), cycle=self.cycle,
            mid_case=self.mid_case, kcycle_base=self.kcycle_base,
            kcycle_rel_tol=self.kcycle_rel_tol,
        )

    @staticmethod
    def _coarse_inverse(op, coarse):
        """(n_c, n_c) float32 dense inverse of the coarsest operator (taken
        in float64) when the coarse solver is the default exact Direct
        solve, n_c <= 1536 and the operator converts to scipy (Dia, Csr), on
        the operator's device; else None.  A coarsest Pell, Bell or Well
        gets none, as in the JAX package (whose other conversion raises
        there, solver/multigrid.py:703-709)."""
        from .direct import Direct

        nc = op.shape[0]
        if not isinstance(coarse, Direct) or nc > MAX_DENSE_COARSE_ROWS:
            return None
        if not hasattr(op, "to_scipy"):
            return None
        try:
            inv = np.linalg.inv(np.asarray(op.to_scipy().todense(), np.float64))
        except Exception:  # a singular or unconvertible coarse operator: no inverse
            return None
        from ..multigrid.pgm import _device_of

        return torch.as_tensor(inv.astype(np.float32), device=_device_of(op))
