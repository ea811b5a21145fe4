"""Whole-solve fused IDR(s): kernel K16 and its plain version.

Counterpart of ``ginkgo_tpu/ops/pallas_idr.py`` ``idr_vmem_solve``
(``_idr_kernel``, :60-303): biorthogonal IDR(s) with the kappa-safeguarded
omega, a diagonal preconditioner applied to v and a residual replacement
once per outer iteration, on a ``Dia``, in one persistent cooperative CUDA
kernel (``csrc/idr_fused.cu``) templated on s <= 4, so the s x s system
and f unroll as the TPU kernel unrolls them.

Semantics, shared by the kernel and :func:`idr_solve_reference`:

- G = U = 0, M = I (s x s), om = 1, f = P r0;
- the monitor starts as r0.r0 when that is already at the threshold, else
  +inf, so an r0 that has converged runs no iteration; the loop runs while
  it < max_iters and ``not (mon <= tol_sq_eff)`` (NaN keeps going);
- inner step kk = 0..s-1: c = forward substitution on M[kk:, kk:] c = f[kk:]
  (zero pivots give 0); u = om M (r - sum c_j G_j) + sum c_j U_j;
  g = A u; then, in order for i = 0..kk-1, alpha_i = <P_i, g> / M_ii (each
  on the g already reduced by alpha_0..alpha_{i-1}), g -= alpha_i G_i,
  u -= alpha_i U_i; G_kk = g, U_kk = u; rows >= kk of column kk of M take
  P g; beta = f_kk / M_kk,kk; r -= beta g; x += beta u; f_j -= beta M_j,kk
  for j > kk and f_kk = 0;
- the dimension-reduction step: v = M r, t = A v, om = <t, r> / <t, t>,
  rho = |<t, r> / (sqrt(<t, t>) sqrt(<r, r>))| with r.r from before the x
  update; om *= kappa / rho when rho < kappa; x += om v;
- residual replacement: r = b - A x, then f = P r and the monitor r.r;
  ``iterations`` counts outer iterations.

The kernel runs the same element operations in the same order, but
defers each update that no reduction waits for to the next pass that
reads those rows: r -= beta g and u -= alpha_i U_i into the next step's u
pass, x += beta U and x += om v into one pass before the replacement, and
v = M r is gathered inside t = A v rather than stored
(``tests/test_torch_idr_order.py``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..log.logger import logged_kernel
from .cg import _dots, _sdiv, _sqrt, check_fused_diags, check_solve_vectors, coop_grid_blocks
from .dia import DTYPE_CODE, check_status, dia_spmv_reference, offsets_array, on_cpu

#: largest subspace dimension K16 takes (ginkgo_tpu/ops/pallas_idr.py:44)
MAX_FUSED_IDR_S = 4


def idr_solve_reference(diags, offsets, P, r0, x0, b, minv=None, *, kappa, tol_sq_eff,
                        max_iters):
    """K16's plain version, pass by pass as the kernel.  diags: (nd, n); P:
    (s, n) float32 shadow space; r0, x0, b, minv: (n,) float32.  The s x s
    scalar work runs on the host in float32.  Returns (x, r, iterations
    int32, monitored_sq float32, converged)."""
    n = r0.shape[0]
    s = P.shape[0]
    dev = r0.device
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32).reshape(()).cpu()
    kap = torch.tensor(kappa, dtype=torch.float32)
    mv = None if minv is None else minv.to(torch.float32)

    def spmv(v):
        return dia_spmv_reference(diags, offsets, v, n)

    def proj(v):
        """P v, s dots with float64 sums, on the host."""
        return _dots(P.T, v[:, None].expand(n, s)).cpu()

    x = x0.clone()
    r = r0.clone()
    G = torch.zeros((s, n), dtype=torch.float32, device=dev)
    U = torch.zeros((s, n), dtype=torch.float32, device=dev)
    f = proj(r)
    rr0 = _dots(r, r).cpu()
    Mm = torch.eye(s, dtype=torch.float32)
    om = torch.ones((), dtype=torch.float32)
    mon = rr0 if bool(rr0 <= tol) else torch.tensor(float("inf"))
    it = 0
    while it < max_iters and not bool(mon <= tol):
        for kk in range(s):
            csol = torch.zeros(s, dtype=torch.float32)
            for i in range(kk, s):
                acc = f[i].clone()
                for j in range(kk, i):
                    acc = acc - Mm[i, j] * csol[j]
                csol[i] = _sdiv(acc, Mm[i, i])
            cd = csol.to(dev)
            v = r
            for j in range(kk, s):
                v = v - cd[j] * G[j]
            if mv is not None:
                v = mv * v
            u = om.to(dev) * v
            for j in range(kk, s):
                u = u + cd[j] * U[j]
            g = spmv(u)
            for i in range(kk):  # sequential: each alpha on the reduced g
                alpha = _sdiv(_dots(P[i], g).cpu(), Mm[i, i]).to(dev)
                g = g - alpha * G[i]
                u = u - alpha * U[i]
            G[kk] = g
            U[kk] = u
            mcol = proj(g)
            Mm[kk:, kk] = mcol[kk:]
            beta = _sdiv(f[kk], Mm[kk, kk])
            bd = beta.to(dev)
            r = r - bd * G[kk]
            x = x + bd * U[kk]
            for j in range(kk + 1, s):
                f[j] = f[j] - beta * Mm[j, kk]
            f[kk] = 0.0
        v = r if mv is None else mv * r
        t = spmv(v)
        tt, tr, rr = _dots(t, t).cpu(), _dots(t, r).cpu(), _dots(r, r).cpu()
        om_raw = _sdiv(tr, tt)
        rho = torch.abs(_sdiv(tr, _sqrt(tt) * _sqrt(rr)))
        om = torch.where(rho < kap, om_raw * _sdiv(kap, rho), om_raw)
        x = x + om.to(dev) * v
        r = b - spmv(x)
        f = proj(r)
        mon = _dots(r, r).cpu()
        it += 1
    iters = torch.tensor(it, dtype=torch.int32, device=dev)
    mon = mon.to(torch.float32).to(dev)
    return x, r, iters, mon, mon <= tol.to(dev)


def _lib():
    lib = _build.load("idr_fused")
    if not hasattr(lib, "gk_typed"):
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        offs, blocks = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
        lib.idr_fused_grid.argtypes = [I, I, blocks]
        lib.idr_fused_solve.argtypes = [
            P, I, offs, I, L, I,  # diags, offsets, n, s
            P, P, P, P, P, P,  # P, r0, x0, b, minv, tol_sq
            F, I,  # kappa, max_iters
            P, P, P, P,  # x, r, G, U
            P, I,  # partials, blocks
            P, P, P, P,  # it_out, mon_out, conv_out, stream
        ]
        for fn in (lib.idr_fused_grid, lib.idr_fused_solve):
            fn.restype = I
        lib.gk_error_string.argtypes = [I]
        lib.gk_error_string.restype = ctypes.c_char_p
        lib.gk_typed = True
    return lib


@logged_kernel
def idr_fused(diags, offsets, P, r0, x0, b, minv=None, *, kappa, tol_sq_eff, max_iters):
    """K16: run IDR(s) to the stop test in one kernel.  diags: (nd, n)
    float32/bfloat16; P: (s, n) float32, 1 <= s <= MAX_FUSED_IDR_S; r0, x0,
    b, minv: (n,) float32; tol_sq_eff: the squared absolute threshold on
    r.r, a float32 tensor on the device.  Returns (x, r, iterations int32,
    monitored_sq float32, converged bool) as device tensors."""
    if on_cpu(r0):
        return idr_solve_reference(diags, offsets, P, r0, x0, b, minv, kappa=kappa,
                                   tol_sq_eff=tol_sq_eff, max_iters=max_iters)
    dev = r0.device
    tol = torch.as_tensor(tol_sq_eff, dtype=torch.float32, device=dev).reshape(1).contiguous()
    check_fused_diags(diags, offsets, dev, "idr_fused")
    n = diags.shape[1]
    check_solve_vectors("idr_fused", (n,), dev, (r0, x0, b), minv, tol, 1)
    s = P.shape[0] if P.dim() == 2 else 0
    if (not 1 <= s <= MAX_FUSED_IDR_S or P.shape != (s, n) or P.dtype != torch.float32
            or P.device != dev or not P.is_contiguous()):
        raise ValueError(f"idr_fused: P must be contiguous float32 (s, {n}) on {dev} "
                         f"with 1 <= s <= {MAX_FUSED_IDR_S}")
    lib = _lib()
    code = DTYPE_CODE[diags.dtype]
    blocks = coop_grid_blocks(lib, "idr_fused_grid", (code, s), dev)
    x, r = torch.empty_like(r0), torch.empty_like(r0)
    G = torch.empty((s, n), dtype=torch.float32, device=dev)
    U = torch.empty((s, n), dtype=torch.float32, device=dev)
    # two halves used in turn, each max(s + 1, 3) doubles a block
    part = torch.empty(2 * max(s + 1, 3) * blocks, dtype=torch.float64, device=dev)
    it_conv = torch.empty(2, dtype=torch.int32, device=dev)
    mon = torch.empty(1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.idr_fused_solve(
            diags.data_ptr(), code, offsets_array(offsets), len(offsets), n, s,
            P.data_ptr(), r0.data_ptr(), x0.data_ptr(), b.data_ptr(),
            None if minv is None else minv.data_ptr(), tol.data_ptr(),
            float(kappa), min(int(max_iters), 2**31 - 1),
            x.data_ptr(), r.data_ptr(), G.data_ptr(), U.data_ptr(),
            part.data_ptr(), blocks, it_conv.data_ptr(), mon.data_ptr(),
            it_conv[1:].data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    check_status(lib, status, "idr_fused")
    idr_fused.launches += 1
    return x, r, it_conv[0], mon[0], it_conv[1] != 0


idr_fused.launches = 0
