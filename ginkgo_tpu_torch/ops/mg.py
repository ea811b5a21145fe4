"""Fused multigrid: kernels K25-K28 and their plain versions.

Counterpart of ``ginkgo_tpu/ops/pallas_mg.py``: ``mg_vmem_vcycle`` (K25,
one V/W/F/K cycle, :689), ``mg_cg_vmem_solve`` (K26, CG/FCG with one cycle
as the preconditioner, :925), ``mg_vmem_solve`` (K27, cycles to the stop
test, :1072) and ``mg_bicgstab_vmem_solve`` (K28, right-preconditioned
BiCGSTAB, :1349).  The four CUDA kernels (``csrc/mg_fused.cu``) share one
device routine that walks a **pass list** compiled here on the host from
the cycle plan; the plain versions walk the same list with tensor ops.

The TPU kernel unrolls the cycle recursion at trace time
(``_vcycle_refs.visit``, :573); here :func:`compile_passes` unrolls it
into passes, each one loop over a level's rows followed by a grid barrier:

- ``SMOOTH_ZERO`` x = w dinv b, the first sweep from a zero guess;
- ``SMOOTH`` x_dst = x_src + w (dinv (b - A x_src)), a damped Jacobi
  sweep; it reads x across rows, so it writes the level's other x buffer
  (the two ping-pong, the host tracks which holds x);
- ``RESTRICT`` b_{l+1}[c] = r[f0] + r[f1], r = b - A x computed at the two
  fine rows f0 = 2S (c // S) + c % S and f1 = f0 + S (0 past the last row),
  the residual and the restriction of the TPU kernel in one pass;
- ``PROLONG`` x_l[i] += x_{l+1}[(i // 2S) S + i % S];
- ``COARSE`` x_L = M^{-1} b_L with the dense inverse, products summed in
  float64 and rounded once;
- the K-cycle's ``VPASS`` (v = A c1 into r, c1 stashed, rho = c1.v,
  alpha = c1.b, bb = b.b), ``S1`` (kcycle_step_1: temp = alpha / rho,
  b -= temp v and x = temp x where temp is finite, g2 = b.b), ``JUMP``
  (kcycle_check_stop: the second inner solve runs iff g2 > rel_tol^2 bb;
  no barrier), ``WPASS`` (gamma = c1.w, beta = c2.w, zeta = c2.b with
  w = A c2) and ``COMB`` (kcycle_step_2's combination);
- ``COPY`` moves level 0's x back into its first buffer after a cycle
  from a given x whose sweep count is odd.

A visit from a zero guess starts in the buffer that makes it end in the
first one, so both sides of a K-cycle jump leave every level's x where the
host expects it.  The semantics are the TPU kernel's (the JAX package's
fused route), which differ from its streaming cycle in rounding only:
the sweep multiplies relax into (dinv (b - A x)), the coarse solve uses the
dense inverse, and the K-cycle's check compares squared norms.  Dot
products are float64 sums rounded to float32 (``ops/cg._dots``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from .. import _build
from .cg import _dots, _sdiv, check_fused_diags, coop_grid_blocks
from .dia import DTYPE_CODE, check_status, dia_spmv_reference, offsets_array, on_cpu

(SMOOTH_ZERO, SMOOTH, RESTRICT, PROLONG, COARSE, VPASS, S1, JUMP, WPASS, COMB,
 COPY) = range(11)
PASS_NAMES = ("smooth_zero", "smooth", "restrict", "prolong", "coarse", "vpass", "s1",
              "jump", "wpass", "comb", "copy")
#: most levels the kernels take (csrc/mg_fused.cu MG_MAX_LEVELS)
MAX_LEVELS = 32
#: most level visits of one cycle that the fused routes take (the JAX
#: package's cap, solver/multigrid.py:440; a W-cycle grows exponentially)
MAX_VISITS = 96
#: int64 fields of one level of the kernels' level table (mg_fused.cu
#: MgLevel): diags, offs, dinv, xa, xb, b, r, k, n, nd, stride, unused
_LEVEL_FIELDS = 12


def visit_count(L: int, mode: str) -> int:
    """Level-visits of one unrolled cycle (pallas_mg._visit_count)."""

    def c(l, md):
        if l == L:
            return 1
        n = 1 + c(l + 1, md)
        if md in ("w", "f") and l + 1 < L:
            n += c(l + 1, "v" if md == "f" else md)
        return n

    return c(0, mode)


def build_cycle_plan(levels_meta, mode="v", mid_case="standalone", kcycle_base=1,
                     kcycle_rel_tol=0.25):
    """The cycle's plan (pallas_mg.build_vcycle_plan without its frames,
    chunks and VMEM sums).  levels_meta: one dict per level with iters_pre,
    relax_pre, iters_post, relax_post, iters_mid, relax_mid.  Returns
    {L, lv, mode, mid_case, kacc, krt, stash, visits}: kacc[l] marks the
    levels whose coarse correction is FCG-accelerated, stash[l] the levels
    that keep c1 for a possible second inner solve."""
    L = len(levels_meta)
    lv = [dict(itp=int(m["iters_pre"]), rp=float(m["relax_pre"]),
               ito=int(m["iters_post"]), ro=float(m["relax_post"]),
               itm=int(m.get("iters_mid", m["iters_post"])),
               rm=float(m.get("relax_mid", m["relax_post"]))) for m in levels_meta]
    krt = float(kcycle_rel_tol)
    two_possible = math.isnan(krt) or krt > 0
    kacc = [mode == "k" and l % max(int(kcycle_base), 1) == 0 and l + 1 < L
            for l in range(L)]
    stash = [False] * (L + 1)
    for l in range(L):
        if kacc[l] and two_possible:
            stash[l + 1] = True

    def k_visits(l):
        if l == L:
            return 1
        n = 1 + k_visits(l + 1)
        if kacc[l] and two_possible:
            n += k_visits(l + 1)
        return n

    visits = k_visits(0) if mode == "k" else visit_count(L, mode)
    return dict(L=L, lv=lv, mode=mode, mid_case=mid_case, kacc=kacc, krt=krt, stash=stash,
                visits=visits)


def compile_passes(plan, use_x0=False):
    """The pass list of one cycle: (passes (P, 4) int32 rows of op, level,
    src, dst; relax (P,) float32).  use_x0: level 0 smooths from the x in
    its first buffer (else from zero).  The cycle's result is in level 0's
    first buffer.  A JUMP row carries its target pass in src."""
    L, lv, mode, mid_case = plan["L"], plan["lv"], plan["mode"], plan["mid_case"]
    krt = plan["krt"]
    two_always = math.isnan(krt) or (math.isinf(krt) and krt > 0)
    two_never = not two_always and krt <= 0
    out = []
    cur = [0] * (L + 1)  # the buffer holding each level's x

    def emit(op, l, src=0, dst=0, relax=0.0):
        out.append([op, l, src, dst, relax])

    def smooth(l, relax):
        s = cur[l]
        emit(SMOOTH, l, s, 1 - s, relax)
        cur[l] = 1 - s

    def sweeps(l, cyc, first, end, zero):
        e = lv[l]
        n = 0
        if first or mid_case in ("both", "pre_smoother"):
            n += max(e["itp"] - 1, 0) if zero else e["itp"]
        if end or mid_case in ("both", "post_smoother"):
            n += e["ito"]
        if cyc in ("w", "f") and not end and mid_case == "standalone":
            n += e["itm"]
        return n

    def kcycle(l):
        ln = l + 1
        visit(ln, "k", True, True, True)
        emit(VPASS, ln, cur[ln])
        emit(S1, ln, cur[ln])
        if two_never:
            return
        jump = None
        if not two_always:
            jump = len(out)
            emit(JUMP, ln)
        visit(ln, "k", True, True, True)
        emit(WPASS, ln, cur[ln])
        emit(COMB, ln, cur[ln])
        if jump is not None:
            out[jump][2] = len(out)

    def visit(l, cyc, first, end, zero):
        if l == L:
            emit(COARSE, L)
            return
        e = lv[l]
        if zero:  # start where the visit's sweeps end in the first buffer
            cur[l] = sweeps(l, cyc, first, end, zero) % 2
        if first or mid_case in ("both", "pre_smoother"):
            extra = e["itp"]
            if zero:
                emit(SMOOTH_ZERO, l, 0, cur[l], e["rp"])
                extra -= 1
            for _ in range(extra):
                smooth(l, e["rp"])
        emit(RESTRICT, l, cur[l])
        if cyc == "k" and plan["kacc"][l]:
            kcycle(l)
        else:
            visit(l + 1, cyc, True, cyc in ("v", "k"), True)
            if cyc in ("w", "f") and l + 1 < L:
                # second coarse visit from the first one's solution, same rhs
                visit(l + 1, "v" if cyc == "f" else cyc, False, True, False)
        emit(PROLONG, l, cur[l + 1] if l + 1 < L else 0, cur[l])
        if end or mid_case in ("both", "post_smoother"):
            for _ in range(e["ito"]):
                smooth(l, e["ro"])
        if cyc in ("w", "f") and not end and mid_case == "standalone":
            for _ in range(e["itm"]):
                smooth(l, e["rm"])

    visit(0, mode, True, True, not use_x0)
    if cur[0] != 0:
        emit(COPY, 0, 1, 0)
    passes = np.array([r[:4] for r in out], np.int32).reshape(-1, 4)
    relax = np.array([r[4] for r in out], np.float32)
    return passes, relax


def barriers(passes) -> int:
    """Grid barriers of a pass list when every jump falls through (JUMP
    rows take none)."""
    return int(np.count_nonzero(passes[:, 0] != JUMP))


@dataclasses.dataclass(eq=False)
class MgHierarchy:
    """What the fused multigrid kernels read: per level l < L the operator's
    diagonals (one dtype for all levels, float32 or bfloat16), offsets and
    rows, the smoother's float32 inverse diagonal and the stride of the
    transfer to level l + 1; the coarsest level's rows and the float32 dense
    inverse ``minv`` (x_L = minv @ b_L); the cycle plan and its pass lists.
    Built by :func:`make_hierarchy`."""

    diags: tuple
    offsets: tuple
    dinv: tuple
    strides: tuple
    sizes: tuple  # rows of levels 0..L
    minv: torch.Tensor
    plan: dict
    passes: dict  # use_x0 -> (passes, relax)
    krt2: float  # rel_tol^2 rounded to float32, the K-cycle's check
    _dev: dict = dataclasses.field(default_factory=dict)

    @property
    def L(self):
        return len(self.diags)

    @property
    def dtype(self):
        return self.diags[0].dtype


def make_hierarchy(diags, offsets, dinv, strides, minv, levels_meta, *, mode="v",
                   mid_case="standalone", kcycle_base=1, kcycle_rel_tol=0.25) -> MgHierarchy:
    """An :class:`MgHierarchy`; diagonals of mixed float32 / bfloat16 levels
    are widened to float32 (exact)."""
    if not 1 <= len(diags) <= MAX_LEVELS:
        raise ValueError(f"make_hierarchy: takes 1 to {MAX_LEVELS} levels, got {len(diags)}")
    if len({d.dtype for d in diags}) > 1:
        diags = [d.to(torch.float32) for d in diags]
    sizes = tuple(int(d.shape[1]) for d in diags) + (int(minv.shape[0]),)
    for l, S in enumerate(strides):
        nb = -(-sizes[l] // (2 * S))
        if not (nb - 1) * S < sizes[l + 1] <= nb * S:
            raise ValueError(f"make_hierarchy: level {l + 1} has {sizes[l + 1]} rows, not the "
                             f"stride-{S} pairing of {sizes[l]}")
    plan = build_cycle_plan(levels_meta, mode, mid_case, kcycle_base, kcycle_rel_tol)
    krt = plan["krt"]
    return MgHierarchy(
        diags=tuple(d.contiguous() for d in diags), offsets=tuple(tuple(o) for o in offsets),
        dinv=tuple(v.to(torch.float32).contiguous() for v in dinv),
        strides=tuple(int(s) for s in strides), sizes=sizes,
        minv=minv.to(torch.float32).contiguous(), plan=plan,
        passes={u: compile_passes(plan, use_x0=u) for u in (False, True)},
        krt2=float(np.float32(krt * krt)) if math.isfinite(krt) else float("inf"),
    )


# -- plain versions ---------------------------------------------------------------------


def _run_passes(h: MgHierarchy, b0, x0=None):
    """One cycle with plain tensor ops, pass by pass as the kernels: level
    0's rhs b0 (n0,) float32, from x0 (or zero).  Returns x (n0,)."""
    passes, relax = h.passes[x0 is not None]
    dev = b0.device
    L, sizes = h.L, h.sizes
    z = [torch.zeros(n, dtype=torch.float32, device=dev) for n in sizes]
    x = [[x0.clone() if x0 is not None else z[0].clone(), z[0].clone()]]
    x += [[z[l].clone(), z[l].clone()] for l in range(1, L + 1)]
    b = [b0] + [z[l].clone() for l in range(1, L + 1)]
    r = [None] * (L + 1)
    k = [None] * (L + 1)
    ks = {}

    def A(l, v):
        return dia_spmv_reference(h.diags[l], h.offsets[l], v, sizes[l])

    def pairs(v, S, n_out):
        """(nb, 2, S) view of v zero-padded to whole pair blocks."""
        nb = -(-n_out // S) if n_out else 0
        return torch.nn.functional.pad(v, (0, 2 * S * nb - v.shape[0])).reshape(nb, 2, S)

    pc = 0
    while pc < len(passes):
        op, l, src, dst = (int(v) for v in passes[pc])
        w = torch.tensor(float(relax[pc]), dtype=torch.float32, device=dev)
        if op == JUMP:
            pc = pc + 1 if bool(ks[l]["g2"] > h.krt2 * ks[l]["bb"]) else src
            continue
        if op == SMOOTH_ZERO:
            x[l][dst] = w * (h.dinv[l] * b[l])
        elif op == SMOOTH:
            xs = x[l][src]
            x[l][dst] = xs + w * (h.dinv[l] * (b[l] - A(l, xs)))
        elif op == RESTRICT:
            p = pairs(b[l] - A(l, x[l][src]), h.strides[l], sizes[l + 1])
            b[l + 1] = (p[:, 0, :] + p[:, 1, :]).reshape(-1)[:sizes[l + 1]]
        elif op == PROLONG:
            S, n = h.strides[l], sizes[l]
            nb = -(-n // (2 * S))
            xc = torch.nn.functional.pad(x[l + 1][src], (0, nb * S - sizes[l + 1]))
            add = xc.reshape(nb, 1, S).expand(nb, 2, S).reshape(-1)[:n]
            x[l][dst] = x[l][dst] + add
        elif op == COARSE:
            x[L][0] = (h.minv.to(torch.float64) @ b[L].to(torch.float64)).to(torch.float32)
        elif op == VPASS:
            c1 = x[l][src]
            r[l] = A(l, c1)
            k[l] = c1.clone()
            rho, alpha, bb = _dots(torch.stack([c1, c1, b[l]], 1),
                                   torch.stack([r[l], b[l], b[l]], 1))
            temp = alpha / rho
            fin = torch.isfinite(temp)
            ks[l] = dict(rho=rho, alpha=alpha, bb=bb, fin=fin,
                         tempe=torch.where(fin, temp, torch.ones_like(temp)))
        elif op == S1:
            s = ks[l]
            b[l] = torch.where(s["fin"], b[l] - s["tempe"] * r[l], b[l])
            x[l][src] = torch.where(s["fin"], s["tempe"] * x[l][src], x[l][src])
            s["g2"] = _dots(b[l][:, None], b[l][:, None])[0]
        elif op == WPASS:
            c2 = x[l][src]
            wv = A(l, c2)
            s = ks[l]
            s["gamma"], s["beta"], s["zeta"] = _dots(torch.stack([k[l], c2, c2], 1),
                                                     torch.stack([wv, wv, b[l]], 1))
        elif op == COMB:
            s = ks[l]
            sd = s["zeta"] / (s["beta"] - s["gamma"] * s["gamma"] / s["rho"])
            se = 1.0 - s["gamma"] / s["alpha"] * sd
            ok = torch.isfinite(sd) & torch.isfinite(se)
            se = torch.where(ok, se, torch.ones_like(se))
            sd = torch.where(ok, sd, torch.zeros_like(sd))
            x[l][src] = (se * s["tempe"]) * k[l] + sd * x[l][src]
        elif op == COPY:
            x[l][dst] = x[l][src]
        pc += 1
    return x[0][0]


def mg_vcycle_reference(h: MgHierarchy, b, x0=None):
    """K25's plain version: one cycle on b (n0,) float32 from x0 (or
    zero).  Returns x."""
    return _run_passes(h, b, x0)


def _tol(tol_sq_eff, dev):
    return torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(())


def _dot(a, b):
    return _dots(a[:, None], b[:, None])[0]


def mg_solve_reference(h: MgHierarchy, b, x0, *, tol_sq_eff, max_iters):
    """K27's plain version: cycles from x0 while it < max_iters and
    ``not (r.r <= tol_sq_eff)``, r = b - A x after each cycle; the monitor
    starts at +inf.  Returns (x, iterations int32, r.r float32,
    converged)."""
    dev = b.device
    tol = _tol(tol_sq_eff, dev)
    x = x0.clone()
    rr = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    it = 0
    # the loop condition reads the monitor on the host once per cycle
    while it < max_iters and not bool(rr <= tol):
        x = _run_passes(h, b, x)
        res = b - dia_spmv_reference(h.diags[0], h.offsets[0], x, h.sizes[0])
        rr = _dot(res, res)
        it += 1
    return x, torch.tensor(it, dtype=torch.int32, device=dev), rr, rr <= tol


def mg_cg_solve_reference(A, h: MgHierarchy, r0, x0, *, tol_sq_eff, max_iters,
                          use_implicit=False, flexible=False):
    """K26's plain version: CG (FCG with ``flexible``: beta's numerator
    r_new.z - r_old.z) with z = one cycle from zero on r.  A: square
    ``Dia``; r0, x0: (n,) float32.  Returns (x, r, iterations int32,
    monitored_sq float32, converged)."""
    dev = r0.device
    tol = _tol(tol_sq_eff, dev)
    n = r0.shape[0]
    x, r = x0.clone(), r0.clone()
    z = _run_passes(h, r)
    p = z
    rho = _dot(r, z)
    mon = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    it = 0
    while it < max_iters and not bool(mon <= tol):
        q = dia_spmv_reference(A.diags, A.offsets, p, n)
        alpha = _sdiv(rho, _dot(p, q))
        x = x + alpha * p
        r_old = r
        r = r - alpha * q
        rr_new = _dot(r, r)
        z = _run_passes(h, r)
        rho_new = _dot(r, z)
        num = rho_new - _dot(r_old, z) if flexible else rho_new
        p = z + _sdiv(num, rho) * p
        mon = torch.abs(rho) if use_implicit else rr_new
        rho = rho_new
        it += 1
    return x, r, torch.tensor(it, dtype=torch.int32, device=dev), mon, mon <= tol


def mg_bicgstab_solve_reference(A, h: MgHierarchy, r0, x0, *, tol_sq_eff, max_iters,
                                use_implicit=False):
    """K28's plain version: right-preconditioned BiCGSTAB (y = M p, v = A y,
    the half-step check on s, z = M s, t = A z) with M one cycle from
    zero; the scalars as ``ops/cg_ilu.bicgstab_ilu_reference``.  Returns
    (x, r, iterations int32, monitored_sq float32, converged)."""
    dev = r0.device
    tol = _tol(tol_sq_eff, dev)
    n = r0.shape[0]
    one = torch.ones((), dtype=torch.float32, device=dev)
    x, r, rr = x0.clone(), r0.clone(), r0.clone()
    p = torch.zeros_like(r0)
    v = torch.zeros_like(r0)
    rho_new = _dot(r, r)
    rho_old, alpha, omega = one, one, one
    mon = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    it = 0
    while it < max_iters and not bool(mon <= tol):
        beta = _sdiv(rho_new * alpha, rho_old * omega)
        p = r + beta * (p - omega * v)
        y = _run_passes(h, p)
        v = dia_spmv_reference(A.diags, A.offsets, y, n)
        alpha_new = _sdiv(rho_new, _dot(rr, v))
        x = x + alpha_new * y
        s = r - alpha_new * v
        half_done = (torch.abs(rho_new) if use_implicit else _dot(s, s)) <= tol
        z = _run_passes(h, s)
        t = dia_spmv_reference(A.diags, A.offsets, z, n)
        omega_new = torch.where(half_done, 0.0, _sdiv(_dot(t, s), _dot(t, t)))
        x = x + omega_new * z
        r = s - omega_new * t
        rho_next = _dot(rr, r)
        mon = torch.abs(rho_new) if use_implicit else _dot(r, r)
        rho_old, alpha = rho_new, alpha_new
        omega = torch.where(half_done, 1.0, omega_new)
        rho_new = rho_next
        it += 1
    return x, r, torch.tensor(it, dtype=torch.int32, device=dev), mon, mon <= tol


# -- kernel wrappers ----------------------------------------------------------------------


def _lib():
    lib = _build.load("mg_fused")
    if not hasattr(lib, "gk_typed"):
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        offs, blocks = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
        vecs = ctypes.POINTER(ctypes.c_void_p)
        cyc = [P, I, P, P, I, P, F]  # levels, L, passes, relax, npasses, minv, krt2
        lib.mg_vcycle_grid.argtypes = [I, blocks]
        lib.mg_solve_fused_grid.argtypes = [I, blocks]
        lib.mg_cg_fused_grid.argtypes = [I, I, blocks]
        lib.mg_bicgstab_fused_grid.argtypes = [I, I, blocks]
        lib.mg_vcycle_solve.argtypes = [I] + cyc + [P, P, P, P, P, I, P]
        lib.mg_solve_fused_solve.argtypes = [I] + cyc + [
            P, P, P, I, P, P, P, I, P, P, P, P]  # b x0 tol max x xalt part blocks outs stream
        solver = [I, P, I, offs, I, L]  # level dtype, A diags, A dtype, offsets, nd, n
        lib.mg_cg_fused_solve.argtypes = solver + cyc + [
            P, P, P, I, I, I, vecs, P, I, P, P, P, P]  # r0 x0 tol max impl flex vecs part ...
        lib.mg_bicgstab_fused_solve.argtypes = solver + cyc + [
            P, P, P, I, I, vecs, P, I, P, P, P, P]
        for fn in (lib.mg_vcycle_grid, lib.mg_solve_fused_grid, lib.mg_cg_fused_grid,
                   lib.mg_bicgstab_fused_grid, lib.mg_vcycle_solve, lib.mg_solve_fused_solve,
                   lib.mg_cg_fused_solve, lib.mg_bicgstab_fused_solve):
            fn.restype = I
        lib.gk_error_string.argtypes = [I]
        lib.gk_error_string.restype = ctypes.c_char_p
        lib.gk_typed = True
    return lib


def _device_state(h: MgHierarchy, dev):
    """The hierarchy's kernel operands on ``dev``, built once: the level
    table (L + 1 rows of _LEVEL_FIELDS int64), the offsets, both pass lists
    and the work buffers of levels 1..L (level 0's come with each launch)."""
    key = (dev.type, dev.index)
    if key in h._dev:
        return h._dev[key]
    L, sizes = h.L, h.sizes
    for l in range(L):
        check_fused_diags(h.diags[l], h.offsets[l], dev, "multigrid")
        if h.dinv[l].device != dev or h.dinv[l].shape != (sizes[l],):
            raise ValueError("multigrid: dinv must be (n_l,) float32 on the diagonals' device")
    if h.minv.device != dev or h.minv.shape != (sizes[L], sizes[L]):
        raise ValueError("multigrid: minv must be (n_L, n_L) float32 on the device")
    offs = torch.tensor([o for off in h.offsets for o in off], dtype=torch.int64, device=dev)
    kmode = h.plan["mode"] == "k"
    plan_len = []
    for l in range(1, L + 1):
        nbuf = 2 if l == L else 3 + kmode + h.plan["stash"][l]
        plan_len.append(nbuf * sizes[l])
    work = torch.zeros(max(sum(plan_len), 1), dtype=torch.float32, device=dev)
    table = np.zeros((L + 1, _LEVEL_FIELDS), np.int64)
    pos, start = 0, 0
    for l in range(L + 1):
        row = table[l]
        row[8] = sizes[l]
        if l < L:
            row[0] = h.diags[l].data_ptr()
            row[1] = offs.data_ptr() + 8 * start
            row[2] = h.dinv[l].data_ptr()
            row[9] = len(h.offsets[l])
            row[10] = h.strides[l]
            start += len(h.offsets[l])
        if l == 0:
            continue
        n = sizes[l]

        def take():
            nonlocal pos
            ptr = work.data_ptr() + 4 * pos
            pos += n
            return ptr

        row[3] = take()  # xa
        if l < L:
            row[4] = take()  # xb
        row[5] = take()  # b
        if l < L and kmode:
            row[6] = take()  # r
        if l < L and h.plan["stash"][l]:
            row[7] = take()  # k
    state = {
        "offs": offs, "work": work,
        "table": torch.as_tensor(table).to(dev),
        "passes": {u: (torch.as_tensor(p).to(dev), torch.as_tensor(r).to(dev))
                   for u, (p, r) in h.passes.items()},
    }
    h._dev[key] = state
    return state


def _cycle_args(h, st, use_x0):
    passes, relax = st["passes"][use_x0]
    return [DTYPE_CODE[h.dtype], st["table"].data_ptr(), h.L, passes.data_ptr(),
            relax.data_ptr(), passes.shape[0], h.minv.data_ptr(), h.krt2]


def _check_vec(what, v, n, dev):
    if v.device != dev or v.dtype != torch.float32 or v.shape != (n,) or not v.is_contiguous():
        raise ValueError(f"{what}: vectors must be contiguous float32 ({n},) on {dev}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def mg_vcycle(h: MgHierarchy, b, x0=None):
    """K25: one multigrid cycle (the plan's V/W/F/K) in one kernel.  b, x0:
    (n0,) float32 on the hierarchy's device; x0 None starts from zero.
    Returns x."""
    if on_cpu(b):
        return mg_vcycle_reference(h, b, x0)
    dev = b.device
    st = _device_state(h, dev)
    n = h.sizes[0]
    for v in (b,) if x0 is None else (b, x0):
        _check_vec("mg_vcycle", v, n, dev)
    lib = _lib()
    blocks = coop_grid_blocks(lib, "mg_vcycle_grid", (DTYPE_CODE[h.dtype],), dev)
    x, xalt = torch.empty_like(b), torch.empty_like(b)
    part = torch.empty(7 * blocks, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        status = lib.mg_vcycle_solve(
            *_cycle_args(h, st, x0 is not None), b.data_ptr(),
            None if x0 is None else x0.data_ptr(), x.data_ptr(), xalt.data_ptr(),
            part.data_ptr(), blocks, _stream())
    check_status(lib, status, "mg_vcycle")
    mg_vcycle.launches += 1
    return x


mg_vcycle.launches = 0


def mg_solve_fused(h: MgHierarchy, b, x0, *, tol_sq_eff, max_iters):
    """K27: cycles from x0 to the stop test on the true residual, in one
    kernel.  tol_sq_eff: squared absolute threshold on r.r (negative: run
    to max_iters) as a float32 tensor on the device.  Returns (x, iterations
    int32, r.r float32, converged bool) as device tensors."""
    if on_cpu(b):
        return mg_solve_reference(h, b, x0, tol_sq_eff=tol_sq_eff, max_iters=max_iters)
    dev = b.device
    st = _device_state(h, dev)
    n = h.sizes[0]
    for v in (b, x0):
        _check_vec("mg_solve_fused", v, n, dev)
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(1).contiguous()
    lib = _lib()
    blocks = coop_grid_blocks(lib, "mg_solve_fused_grid", (DTYPE_CODE[h.dtype],), dev)
    x, xalt = torch.empty_like(b), torch.empty_like(b)
    part = torch.empty(8 * blocks, dtype=torch.float64, device=dev)
    it_conv = torch.empty(2, dtype=torch.int32, device=dev)
    rr = torch.empty(1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.mg_solve_fused_solve(
            *_cycle_args(h, st, True), b.data_ptr(), x0.data_ptr(), tol.data_ptr(),
            min(int(max_iters), 2**31 - 1), x.data_ptr(), xalt.data_ptr(), part.data_ptr(),
            blocks, it_conv.data_ptr(), rr.data_ptr(), it_conv[1:].data_ptr(), _stream())
    check_status(lib, status, "mg_solve_fused")
    mg_solve_fused.launches += 1
    return x, it_conv[0], rr[0], it_conv[1] != 0


mg_solve_fused.launches = 0


def _solver_operands(A, h, r0, x0, what):
    dev = r0.device
    n = h.sizes[0]
    if A.shape != (n, n):
        raise ValueError(f"{what}: A must be square with the hierarchy's {n} rows")
    check_fused_diags(A.diags, A.offsets, dev, what)
    for v in (r0, x0):
        _check_vec(what, v, n, dev)
    st = _device_state(h, dev)
    return dev, n, st, [DTYPE_CODE[h.dtype], A.diags.data_ptr(), DTYPE_CODE[A.diags.dtype],
                        offsets_array(A.offsets), len(A.offsets), n]


def mg_cg_fused(A, h: MgHierarchy, r0, x0, *, tol_sq_eff, max_iters, use_implicit=False,
                flexible=False):
    """K26: CG (FCG with ``flexible``) preconditioned by one cycle from
    zero, to the stop test in one kernel.  A: square ``Dia`` with 1 to 64
    float32/bfloat16 diagonals and the hierarchy's level-0 rows; r0, x0:
    (n,) float32.  Returns (x, r, iterations int32, monitored_sq float32,
    converged bool) as device tensors."""
    kw = dict(tol_sq_eff=tol_sq_eff, max_iters=max_iters, use_implicit=use_implicit)
    if on_cpu(r0):
        return mg_cg_solve_reference(A, h, r0, x0, flexible=flexible, **kw)
    dev, n, st, head = _solver_operands(A, h, r0, x0, "mg_cg_fused")
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(1).contiguous()
    lib = _lib()
    blocks = coop_grid_blocks(lib, "mg_cg_fused_grid",
                              (DTYPE_CODE[A.diags.dtype], DTYPE_CODE[h.dtype]), dev)
    bufs = torch.empty((6, n), dtype=torch.float32, device=dev)  # x r p q z zalt
    vecs = (ctypes.c_void_p * 6)(*(bufs[i].data_ptr() for i in range(6)))
    part = torch.empty(12 * blocks, dtype=torch.float64, device=dev)
    it_conv = torch.empty(2, dtype=torch.int32, device=dev)
    mon = torch.empty(1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.mg_cg_fused_solve(
            *head, *_cycle_args(h, st, False)[1:], r0.data_ptr(), x0.data_ptr(),
            tol.data_ptr(), min(int(max_iters), 2**31 - 1), int(bool(use_implicit)),
            int(bool(flexible)), vecs, part.data_ptr(), blocks, it_conv.data_ptr(),
            mon.data_ptr(), it_conv[1:].data_ptr(), _stream())
    check_status(lib, status, "mg_cg_fused")
    mg_cg_fused.launches += 1
    return bufs[0], bufs[1], it_conv[0], mon[0], it_conv[1] != 0


mg_cg_fused.launches = 0


def mg_bicgstab_fused(A, h: MgHierarchy, r0, x0, *, tol_sq_eff, max_iters,
                      use_implicit=False):
    """K28: BiCGSTAB right-preconditioned by one cycle from zero, to the
    stop test in one kernel; operands and result as :func:`mg_cg_fused`."""
    kw = dict(tol_sq_eff=tol_sq_eff, max_iters=max_iters, use_implicit=use_implicit)
    if on_cpu(r0):
        return mg_bicgstab_solve_reference(A, h, r0, x0, **kw)
    dev, n, st, head = _solver_operands(A, h, r0, x0, "mg_bicgstab_fused")
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(1).contiguous()
    lib = _lib()
    blocks = coop_grid_blocks(lib, "mg_bicgstab_fused_grid",
                              (DTYPE_CODE[A.diags.dtype], DTYPE_CODE[h.dtype]), dev)
    bufs = torch.empty((9, n), dtype=torch.float32, device=dev)  # x r rr p v s t y yalt
    vecs = (ctypes.c_void_p * 9)(*(bufs[i].data_ptr() for i in range(9)))
    part = torch.empty(14 * blocks, dtype=torch.float64, device=dev)
    it_conv = torch.empty(2, dtype=torch.int32, device=dev)
    mon = torch.empty(1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.mg_bicgstab_fused_solve(
            *head, *_cycle_args(h, st, False)[1:], r0.data_ptr(), x0.data_ptr(),
            tol.data_ptr(), min(int(max_iters), 2**31 - 1), int(bool(use_implicit)), vecs,
            part.data_ptr(), blocks, it_conv.data_ptr(), mon.data_ptr(),
            it_conv[1:].data_ptr(), _stream())
    check_status(lib, status, "mg_bicgstab_fused")
    mg_bicgstab_fused.launches += 1
    return bufs[0], bufs[1], it_conv[0], mon[0], it_conv[1] != 0


mg_bicgstab_fused.launches = 0
