#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ginkgo_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``ginkgo_tpu_torch/csrc`` (one
``nvcc`` per source, all started together) and drives the two paths of
the port that users call:

- path 1 (slice 1): a 2-D Poisson matrix on a 2048 x 2048 grid (4,194,304
  rows, about 21M nonzeros) -> ``Dia`` -> ``Cg``/``Fcg``;
- path 2 (slice 2): the 7-point 3-D Poisson matrix on a 160^3 grid
  (4,096,000 rows, 28,518,400 nonzeros) handed over as a ``Csr`` ->
  ``Pell`` -> ``Cg``/``Fcg``.

Phases, each of which raises on failure:

1. probe: versions, the card, the kernel build;
2. every kernel against its plain PyTorch version on the card, at the
   shapes of the main paths (and at small sizes, where whole solves must
   take equal iteration counts): the DIA family K1-K3 and the whole-solve
   K4 at 64^2 and 2048^2, the k-RHS whole-solve K4m at 64^2 and 2048^2,
   the PELL SpMV/SpMM K5/K6 on poisson_3d(160) (S = 8, float32 and
   bfloat16/int8) and on an unstructured local-scatter pattern of 2^20
   rows (the "auto" plan and S = 8), the Pell whole-solve K7 at 24^3 and
   160^3;
3. main path 1: fused CG (K4) with float32 and bfloat16 diagonals and with
   Jacobi, the streaming CG route (K1), a 4-column solve (K4m) and an
   explicit streaming 4-column solve (K3), each checked against a float64
   solve and by its backward error through ``apply_advanced`` (K2);
4. main path 2: ``Csr.from_matrix_data`` ("auto" resolves to "pallas"),
   ``Cg`` on the Csr (K5 through the plan cache, one plan build), ``Pell``
   -> fused ``Cg`` (K7) with float32, bfloat16 and Jacobi, fused ``Fcg``,
   the streaming route on the Pell (K5) and a 4-column solve (K6), each
   checked against a float64 solve (K6 with float64 vectors);
5. timings, printed and not checked: each kernel, its plain version and
   the one PyTorch call that computes the same function, by the slope
   between two trip counts (CUDA events); CG time per iteration fused and
   streaming; bounds; the copy bandwidth.

The launch counters are set to 0 just before each main path and read just
after it; every kernel of a path must have run there.  The last lines are
the kernels' JSON record, the card's name and power limit as nvidia-smi
reports them, and ``{"ok": true, ...}``.  Without a CUDA device, or
without the package beside it, the script fails and prints no result.
"""

from __future__ import annotations

import importlib.metadata
import json
import subprocess
import time

import numpy as np
import torch

DEVICE = "cuda"
NSIDE = 2048
SMALL = 64
NSIDE3 = 160
SMALL3 = 24
SCATTER_ROWS = 1 << 20
TOL = 1e-6
MAX_ITERS = 20000
SEED = 2024
#: peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
#: HBM bytes/s and float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

KERNEL_META = {
    # name: (source, the TPU kernel it replaces)
    "dia_spmv": ("ginkgo_tpu_torch/csrc/dia_spmv.cu", "ginkgo_tpu/ops/pallas_dia.py:364"),
    "dia_spmv_advanced": ("ginkgo_tpu_torch/csrc/dia_spmv.cu", "ginkgo_tpu/ops/pallas_dia.py:173"),
    "dia_spmm": ("ginkgo_tpu_torch/csrc/dia_spmv.cu", "ginkgo_tpu/ops/pallas_dia.py:275"),
    "cg_fused": ("ginkgo_tpu_torch/csrc/cg_fused.cu", "ginkgo_tpu/ops/pallas_cg.py:564"),
    "cg_fused_multi": ("ginkgo_tpu_torch/csrc/cg_fused.cu", "ginkgo_tpu/ops/pallas_cg.py:462"),
    "pell_spmv": ("ginkgo_tpu_torch/csrc/pell_spmv.cu", "ginkgo_tpu/ops/spmv_pallas.py:326"),
    "pell_spmm": ("ginkgo_tpu_torch/csrc/pell_spmv.cu", "ginkgo_tpu/ops/spmv_pallas.py:519"),
    "pell_cg_fused": ("ginkgo_tpu_torch/csrc/pell_cg_fused.cu",
                      "ginkgo_tpu/ops/pallas_pell_cg.py:261"),
}
PATH1 = ("dia_spmv", "dia_spmv_advanced", "dia_spmm", "cg_fused", "cg_fused_multi")
PATH2 = ("pell_spmv", "pell_spmm", "pell_cg_fused")


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _dist_version(name):
    """Installed version of a distribution, None when absent (no import)."""
    try:
        return importlib.metadata.version(name)
    except importlib.metadata.PackageNotFoundError:
        return None


def events_ms(fn, n):
    """Device time of n back-to-back calls, in ms (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def slope_ms(fn, n1=10, n2=60, trials=3):
    """ms per call: the slope between n1 and n2 chained calls (the best of
    `trials` runs each), which removes launch and sync overhead."""
    fn()
    torch.cuda.synchronize()
    t1 = min(events_ms(fn, n1) for _ in range(trials))
    t2 = min(events_ms(fn, n2) for _ in range(trials))
    return (t2 - t1) / (n2 - n1)


def iter_ms(run, lo=200, hi=1000):
    """ms per solver iteration: the slope between whole solves of lo and
    hi iterations (CUDA events around each, best of two), which removes
    the solve's set-up and launch overhead."""
    run(lo)
    torch.cuda.synchronize()
    t_lo = min(events_ms(lambda: run(lo), 1) for _ in range(2))
    t_hi = min(events_ms(lambda: run(hi), 1) for _ in range(2))
    return (t_hi - t_lo) / (hi - lo)


def bound(nbytes, flops):
    """The least time the card could take (ms) and what bounds it: bytes
    over the HBM rate or float32 operations over the peak rate."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def inf_norm(data):
    """max_i sum_j |A_ij| of host MatrixData."""
    return float(np.bincount(data.rows, weights=np.abs(data.values.astype(np.float64)),
                             minlength=data.shape[0]).max())


def library_csr(A):
    """torch.sparse_csr_tensor of a port Csr's storage: the one PyTorch call
    that computes the SpMV family is timed on it as a yardstick only."""
    return torch.sparse_csr_tensor(A.row_ptrs, A.col_idxs, A.values, size=A.shape)


def accuracy(A, x, rhs, x_ref, norm_a, label):
    """Check a float32 solution against the float64 reference solve and by
    its backward error; returns what it measured.

    The true residual b - A x is evaluated in float64 through
    ``apply_advanced`` (the fused alpha A x + beta y kernel K2 on a Dia, K5/K6
    with float64 vectors on a Pell).  It is reported, not bounded: x grows
    like |b| / lambda_min (|x_i| up to ~3e5 on the 2048^2 grid), where one
    float32 ulp of x_i is 0.03 and the float32 iterate's error of a few ulps
    per entry makes A x miss b by O(1) per row.  What is checked instead:
    the relative error against the float64 solution (<= 1e-3) and the
    normwise backward error |b - A x| / (|A|_inf |x| + |b|) (<= 1e-5, about
    80 float32 epsilons)."""
    r = A.apply_advanced(-1.0, x.double(), 1.0, rhs.double())
    rn = r.norm(dim=0)
    bn = rhs.double().norm(dim=0)
    xn = x.double().norm(dim=0)
    relres = float((rn / bn).max())
    eta = float((rn / (norm_a * xn + bn)).max())
    fwd = float(((x.double() - x_ref).norm(dim=0) / x_ref.norm(dim=0)).max())
    check(bool(torch.isfinite(x).all()), f"{label}: non-finite x")
    check(fwd <= 1e-3, f"{label}: relative error {fwd} against the float64 solve")
    check(eta <= 1e-5, f"{label}: backward error {eta}")
    return {"true_relres": relres, "backward_error": eta, "rel_error_vs_f64": fwd}


def rhs4(n, rng, dev):
    """Four right-hand sides: ones, uniform, a ramp and Gaussian noise."""
    return torch.as_tensor(
        np.stack([np.ones(n), rng.uniform(0.5, 1.5, n), np.linspace(-1, 1, n),
                  rng.standard_normal(n)], axis=1).astype(np.float32), device=dev)


def eig_rhs4(nside, dev):
    """Four right-hand sides on an nside^2 grid, the third a Laplacian
    eigenvector, whose column stops after a few iterations and freezes."""
    n = nside * nside
    i = np.arange(nside) + 1
    eig = np.outer(np.sin(np.pi * i / (nside + 1)), np.sin(2 * np.pi * i / (nside + 1)))
    rng = np.random.default_rng(SEED + 1)
    return torch.as_tensor(np.stack([np.ones(n), rng.standard_normal(n), eig.reshape(-1),
                                     np.linspace(-1, 1, n)], axis=1).astype(np.float32),
                           device=dev)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU")
    import ginkgo_tpu_torch as gt
    from ginkgo_tpu_torch import _build, stop
    from ginkgo_tpu_torch.ops import cg as ops_cg
    from ginkgo_tpu_torch.ops import dia as ops_dia
    from ginkgo_tpu_torch.ops import pell as ops_pell
    from ginkgo_tpu_torch.ops import pell_cg as ops_pell_cg

    dev = torch.device(DEVICE, 0)
    torch.cuda.set_device(dev)
    rng = np.random.default_rng(SEED)
    kernels = {
        "dia_spmv": ops_dia.dia_spmv,
        "dia_spmv_advanced": ops_dia.dia_spmv_advanced,
        "dia_spmm": ops_dia.dia_spmm,
        "cg_fused": ops_cg.cg_fused,
        "cg_fused_multi": ops_cg.cg_fused_multi,
        "pell_spmv": ops_pell.pell_spmv,
        "pell_spmm": ops_pell.pell_spmm,
        "pell_cg_fused": ops_pell_cg.pell_cg_fused,
    }
    max_err = {k: 0.0 for k in kernels}

    def record_err(name, got, want):
        err = float((got.double() - want.double()).abs().max())
        max_err[name] = max(max_err[name], err)
        return err

    # -- 1. probe ----------------------------------------------------------------
    card = smi_line()
    nvcc = _build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    _build.build(_build.KERNELS)
    build_s = time.perf_counter() - t0
    regs = {
        name: [ln.split("info    : ")[-1] for ln in rec["ptxas"].splitlines() if "registers" in ln]
        for name, rec in _build.BUILD_LOG.items()
    }
    emit({"phase": "probe", "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc_ver, "triton": _dist_version("triton"), "card": card,
          "device": torch.cuda.get_device_name(0),
          "sm_count": torch.cuda.get_device_properties(0).multi_processor_count,
          "kernel_build_s": round(build_s, 3), "ptxas_registers": regs})

    # -- 2a. the DIA kernels and K4 / K4m against their plain versions -------------
    datas = {}
    gaps = []
    for nside in (SMALL, NSIDE):
        t0 = time.perf_counter()
        data = gt.generators.poisson_2d(nside, dtype=np.float32)
        datas[nside] = data
        A32 = gt.Dia.from_matrix_data(data, device=dev)
        n = A32.shape[0]
        setup_s = time.perf_counter() - t0
        x = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=dev)
        y = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=dev)
        X = torch.as_tensor(rng.standard_normal((n, 4)).astype(np.float32), device=dev)
        alpha = torch.full((1,), 0.7, device=dev)
        beta = torch.full((1,), -0.3, device=dev)
        b = torch.ones(n, device=dev)
        tol_sq = torch.full((), (TOL * float(np.sqrt(n))) ** 2, dtype=torch.float32, device=dev)
        for storage in ("f32", "bf16"):
            A = A32 if storage == "f32" else A32.reduce_storage()
            D, offs = A.diags, A.offsets
            pairs = {
                "dia_spmv": (ops_dia.dia_spmv(D, offs, x, n),
                             ops_dia.dia_spmv_reference(D, offs, x, n)),
                "dia_spmv_advanced": (
                    ops_dia.dia_spmv_advanced(D, offs, x, alpha, beta, y, n),
                    ops_dia.dia_spmv_advanced_reference(D, offs, x, alpha, beta, y, n)),
                "dia_spmm": (ops_dia.dia_spmm(D, offs, X, n),
                             ops_dia.dia_spmm_reference(D, offs, X, n)),
            }
            torch.cuda.synchronize()
            row = {"phase": "kernel_check", "nside": nside, "storage": storage,
                   "setup_s": round(setup_s, 3)}
            for name, (got, want) in pairs.items():
                err = record_err(name, got, want)
                check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                      f"{name} differs from its plain version ({nside}, {storage}): {err}")
                row[name + "_max_abs_err"] = err
            diag = A.extract_diagonal().values.float()
            for pre, minv in (("identity", None), ("jacobi", 1.0 / diag)):
                t0 = time.perf_counter()
                kx, _, kit, _, kconv = ops_cg.cg_fused(
                    D, offs, b, torch.zeros_like(b), minv, tol_sq_eff=tol_sq, max_iters=MAX_ITERS)
                torch.cuda.synchronize()
                k_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                px, _, pit, _, pconv = ops_cg.cg_solve_reference(
                    D, offs, b, torch.zeros_like(b), minv, tol_sq_eff=tol_sq, max_iters=MAX_ITERS)
                torch.cuda.synchronize()
                p_s = time.perf_counter() - t0
                kit, pit = int(kit), int(pit)
                err = record_err("cg_fused", kx, px)
                rel = float((kx - px).norm() / px.norm())
                check(bool(kconv) and bool(pconv), f"cg_fused {nside} {storage} {pre}: not converged")
                if nside == SMALL:
                    check(kit == pit, f"cg_fused {nside} {storage} {pre}: {kit} vs {pit} iterations")
                    check(torch.allclose(kx, px, rtol=1e-5, atol=1e-5),
                          f"cg_fused {nside} {storage} {pre}: x differs by {err}")
                else:
                    check(abs(kit - pit) <= 0.01 * pit,
                          f"cg_fused {nside} {storage} {pre}: {kit} vs {pit} iterations")
                    check(rel <= 1e-3, f"cg_fused {nside} {storage} {pre}: x differs by {rel} relative")
                    gaps.append(kit - pit)
                row[f"cg_fused_{pre}"] = {"iters": kit, "plain_iters": pit, "x_max_abs_err": err,
                                          "x_rel_err": rel, "s": round(k_s, 4),
                                          "plain_s": round(p_s, 4)}
            emit(row)
        # K4m: four columns, one of them a Laplacian eigenvector that stops
        # early and freezes; at 64^2 with and without Jacobi, at 2048^2 the
        # main path's solve
        B = eig_rhs4(nside, dev)
        tol4 = (TOL * B.norm(dim=0)) ** 2
        diag = A32.extract_diagonal().values.float()
        for pre, minv in (("identity", None), ("jacobi", 1.0 / diag))[: 2 if nside == SMALL else 1]:
            t0 = time.perf_counter()
            kx, _, kit, _, kconv, kitc = ops_cg.cg_fused_multi(
                A32.diags, A32.offsets, B, torch.zeros_like(B), minv, tol_sq_eff=tol4,
                max_iters=MAX_ITERS)
            torch.cuda.synchronize()
            k_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            px, _, pit, _, pconv, pitc = ops_cg.cg_multi_solve_reference(
                A32.diags, A32.offsets, B, torch.zeros_like(B), minv, tol_sq_eff=tol4,
                max_iters=MAX_ITERS)
            torch.cuda.synchronize()
            p_s = time.perf_counter() - t0
            err = record_err("cg_fused_multi", kx, px)
            rel = float(((kx - px).norm(dim=0) / px.norm(dim=0)).max())
            kitc, pitc = kitc.tolist(), pitc.tolist()
            check(bool(kconv.all()) and bool(pconv.all()), f"cg_fused_multi {nside} {pre}: not converged")
            frozen = [c for c in range(4) if pitc[c] < int(pit)]
            if nside == SMALL:
                check(kitc == pitc and int(kit) == int(pit),
                      f"cg_fused_multi {nside} {pre}: per-column iterations {kitc} vs {pitc}")
                check(frozen and all(torch.equal(kx[:, c], px[:, c]) for c in frozen),
                      f"cg_fused_multi {nside} {pre}: frozen columns {frozen} differ")
                check(torch.allclose(kx, px, rtol=1e-5, atol=1e-5),
                      f"cg_fused_multi {nside} {pre}: x differs by {err}")
            else:
                check(all(abs(a - c) <= 0.01 * c for a, c in zip(kitc, pitc)),
                      f"cg_fused_multi {nside}: per-column iterations {kitc} vs {pitc}")
                check(rel <= 1e-3, f"cg_fused_multi {nside}: x differs by {rel} relative")
            emit({"phase": "kernel_check", "kernel": "cg_fused_multi", "nside": nside,
                  "preconditioner": pre, "column_iters": kitc, "plain_column_iters": pitc,
                  "frozen_columns": frozen, "x_max_abs_err": err, "x_rel_err": rel,
                  "s": round(k_s, 4), "plain_s": round(p_s, 4)})
        del A32, A, D

    # -- 2b. the PELL kernels against their plain versions --------------------------
    def spmv_pair_check(label, P):
        n = P.shape[0]
        x = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=dev)
        X = torch.as_tensor(rng.standard_normal((n, 4)).astype(np.float32), device=dev)
        row = {"phase": "kernel_check", "matrix": label, "S": P.S, "G": P.G,
               "values": str(P.dtype), "qidx": str(P.qidx.dtype), "inflation": P.inflation,
               "cells": P.values.numel()}
        for name, got, want in (
                ("pell_spmv", ops_pell.pell_spmv(P, x), ops_pell.pell_spmv_reference(P, x)),
                ("pell_spmm", ops_pell.pell_spmm(P, X), ops_pell.pell_spmm_reference(P, X))):
            torch.cuda.synchronize()
            err = record_err(name, got, want)
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                  f"{name} differs from its plain version ({label}, {P.dtype}): {err}")
            row[name + "_max_abs_err"] = err
        emit(row)

    def pell_cg_check(label, P, pre, small):
        n = P.shape[0]
        b = torch.ones(n, device=dev)
        tol_sq = torch.full((), (TOL * float(np.sqrt(n))) ** 2, dtype=torch.float32, device=dev)
        minv = None
        if pre == "jacobi":
            minv = 1.0 / P.extract_diagonal().values.float()
        t0 = time.perf_counter()
        kx, _, kit, _, kconv = ops_pell_cg.pell_cg_fused(
            P, b, torch.zeros_like(b), minv, tol_sq_eff=tol_sq, max_iters=MAX_ITERS)
        torch.cuda.synchronize()
        k_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        px, _, pit, _, pconv = ops_pell_cg.pell_cg_solve_reference(
            P, b, torch.zeros_like(b), minv, tol_sq_eff=tol_sq, max_iters=MAX_ITERS)
        torch.cuda.synchronize()
        p_s = time.perf_counter() - t0
        kit, pit = int(kit), int(pit)
        err = record_err("pell_cg_fused", kx, px)
        rel = float((kx - px).norm() / px.norm())
        what = f"pell_cg_fused {label} {P.dtype} {pre}"
        check(bool(kconv) and bool(pconv), f"{what}: not converged")
        if small:
            check(kit == pit, f"{what}: {kit} vs {pit} iterations")
            check(torch.allclose(kx, px, rtol=1e-5, atol=1e-5), f"{what}: x differs by {err}")
        else:
            check(abs(kit - pit) <= 0.01 * pit, f"{what}: {kit} vs {pit} iterations")
            check(rel <= 1e-3, f"{what}: x differs by {rel} relative")
        emit({"phase": "kernel_check", "kernel": "pell_cg_fused", "matrix": label,
              "values": str(P.dtype), "preconditioner": pre, "iters": kit, "plain_iters": pit,
              "x_max_abs_err": err, "x_rel_err": rel, "s": round(k_s, 4),
              "plain_s": round(p_s, 4)})

    data3s = gt.generators.poisson_3d(SMALL3, dtype=np.float32)
    P = gt.Pell.from_matrix_data(data3s, device=dev)
    for Pv in (P, P.reduce_storage()):
        spmv_pair_check(f"poisson_3d({SMALL3})", Pv)
        for pre in ("identity", "jacobi"):
            pell_cg_check(f"poisson_3d({SMALL3})", Pv, pre, small=True)

    t0 = time.perf_counter()
    data3 = gt.generators.poisson_3d(NSIDE3, dtype=np.float32)
    gen3_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    C3 = gt.Csr.from_matrix_data(data3, device=dev)
    torch.cuda.synchronize()
    csr3_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    P3 = gt.Pell.from_csr(C3)
    torch.cuda.synchronize()
    pell3_s = time.perf_counter() - t0
    emit({"phase": "setup", "matrix": f"poisson_3d({NSIDE3})", "rows": data3.shape[0],
          "nnz": data3.nnz, "generate_s": round(gen3_s, 3), "csr_s": round(csr3_s, 3),
          "pell_plan_s": round(pell3_s, 3), "S": P3.S, "G": P3.G, "inflation": P3.inflation,
          "cells": P3.values.numel(), "plan_bytes": P3.storage_bytes()})
    for Pv in (P3, P3.reduce_storage()):
        spmv_pair_check(f"poisson_3d({NSIDE3})", Pv)
        pell_cg_check(f"poisson_3d({NSIDE3})", Pv, "identity", small=False)

    t0 = time.perf_counter()
    scatter = gt.generators.local_scatter(SCATTER_ROWS)
    Cs = gt.Csr.from_matrix_data(scatter, device=dev, strategy="pallas")
    Ps_auto = ops_pell.plan_for(Cs.row_ptrs, Cs.col_idxs, Cs.values, Cs.shape)
    Ps8 = gt.Pell.from_csr(Cs)
    torch.cuda.synchronize()
    emit({"phase": "setup", "matrix": f"local_scatter({SCATTER_ROWS})", "nnz": scatter.nnz,
          "plans_s": round(time.perf_counter() - t0, 3)})
    for Pv in (Ps_auto, Ps8):
        spmv_pair_check(f"local_scatter({SCATTER_ROWS})", Pv)
    del Cs, Ps_auto, Ps8, scatter
    ops_pell._PLAN_CACHE.clear()

    crit = [stop.Iteration(max_iters=MAX_ITERS), stop.ResidualNorm(tolerance=TOL)]

    def zero_counts():
        for f in kernels.values():
            f.launches = 0

    # -- 3. main path 1: Dia, through the entry points a user calls ---------------
    zero_counts()
    data = datas[NSIDE]
    n = data.shape[0]
    norm_a = inf_norm(data)
    b = torch.ones(n, device=dev)
    bnorm = float(b.norm())

    # float64 reference: the same system solved to 1e-10 on the streaming
    # route (K3 with float64 vectors), for the four right-hand sides below
    B = rhs4(n, rng, dev)
    A64 = gt.Dia.from_matrix_data(data, device=dev).astype(torch.float64)
    t0 = time.perf_counter()
    X64, info64 = gt.Cg.build(
        criteria=[stop.Iteration(max_iters=MAX_ITERS), stop.ResidualNorm(tolerance=1e-10)]
    ).generate(A64).solve(B.double())
    torch.cuda.synchronize()
    check(bool(info64.converged.all()), "float64 reference solve: not converged")
    emit({"phase": "main_path", "path": 1, "route": "streaming", "case": "f64_reference_k4",
          "iterations": info64.num_iterations, "solve_s": round(time.perf_counter() - t0, 4)})
    del A64

    A32 = gt.Dia.from_matrix_data(data, device=dev)
    for label, A, pre in (("f32", A32, None),
                          ("bf16", A32.reduce_storage(), None),
                          ("f32_jacobi", A32, gt.Jacobi.build(max_block_size=1))):
        solver = gt.Cg.build(criteria=crit, preconditioner=pre).generate(A)
        before = ops_cg.cg_fused.launches
        t0 = time.perf_counter()
        x, info = solver.solve(b)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        check(ops_cg.cg_fused.launches == before + 1, f"main path {label} did not run cg_fused")
        check(bool(info.converged.all()), f"main path {label}: not converged")
        check(x.shape == (n,) and bool(torch.isfinite(x).all()), f"main path {label}: bad x")
        emit({"phase": "main_path", "path": 1, "route": "fused", "case": label,
              "iterations": info.num_iterations, "residual_norm": float(info.residual_norm[0]),
              **accuracy(A, x, b, X64[:, 0], norm_a, f"main path {label}"),
              "solve_s": round(solve_s, 4)})

    solver = gt.Cg.build(criteria=crit).generate(A32)
    k1_before = ops_dia.dia_spmv.launches
    t0 = time.perf_counter()
    with torch.no_grad():
        xs, sinfo = solver._solve_streaming(b[:, None], torch.zeros(n, 1, device=dev))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    k1_runs = ops_dia.dia_spmv.launches - k1_before
    check(bool(sinfo.converged.all()), "streaming route: not converged")
    check(k1_runs >= sinfo.num_iterations, "streaming route did not run dia_spmv once per iteration")
    emit({"phase": "main_path", "path": 1, "route": "streaming", "case": "f32",
          "iterations": sinfo.num_iterations,
          **accuracy(A32, xs[:, 0], b, X64[:, 0], norm_a, "streaming route"),
          "dia_spmv_launches": k1_runs, "solve_s": round(solve_s, 4)})

    k4m_before = ops_cg.cg_fused_multi.launches
    t0 = time.perf_counter()
    X, minfo = solver.solve(B)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    check(ops_cg.cg_fused_multi.launches == k4m_before + 1, "k=4 solve did not run cg_fused_multi")
    check(bool(minfo.converged.all()), f"k=4 solve: converged {minfo.converged.tolist()}")
    emit({"phase": "main_path", "path": 1, "route": "fused", "case": "f32_k4",
          "iterations": minfo.num_iterations, **accuracy(A32, X, B, X64, norm_a, "k=4 solve"),
          "solve_s": round(solve_s, 4)})

    k3_before = ops_dia.dia_spmm.launches
    t0 = time.perf_counter()
    with torch.no_grad():
        X, minfo = solver._solve_streaming(B, torch.zeros_like(B))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    check(ops_dia.dia_spmm.launches - k3_before >= minfo.num_iterations,
          "streaming k=4 solve did not run dia_spmm once per iteration")
    check(bool(minfo.converged.all()), f"streaming k=4 solve: converged {minfo.converged.tolist()}")
    emit({"phase": "main_path", "path": 1, "route": "streaming", "case": "f32_k4",
          "iterations": minfo.num_iterations,
          **accuracy(A32, X, B, X64, norm_a, "streaming k=4 solve"),
          "solve_s": round(solve_s, 4)})
    launches1 = {k: f.launches for k, f in kernels.items()}
    check(all(launches1[k] > 0 for k in PATH1), f"a kernel of path 1 never ran: {launches1}")
    emit({"phase": "main_path", "path": 1, "launches": launches1, "bnorm": bnorm})
    del X64

    # -- 4. main path 2: Csr -> Pell, through the entry points a user calls -------
    del C3, P3
    zero_counts()
    n3 = data3.shape[0]
    norm_a3 = inf_norm(data3)
    b3 = torch.ones(n3, device=dev)
    B3 = rhs4(n3, rng, dev)
    t0 = time.perf_counter()
    C = gt.Csr.from_matrix_data(data3, device=dev)
    strategy = C._resolve_strategy()
    resolve_s = time.perf_counter() - t0
    check(strategy == "pallas", f"Csr 'auto' resolved to {strategy!r}, not 'pallas'")
    t0 = time.perf_counter()
    P = gt.Pell.from_csr(C)
    torch.cuda.synchronize()
    emit({"phase": "main_path", "path": 2, "case": "pell_from_csr",
          "setup_s": round(time.perf_counter() - t0, 3), "S": P.S, "G": P.G,
          "inflation": P.inflation, "cells": P.values.numel()})

    # float64 reference: the same system solved to 1e-10 on the streaming
    # route of a float64 Pell (K6 with float64 vectors)
    P64 = P.astype(torch.float64)
    t0 = time.perf_counter()
    X64, info64 = gt.Cg.build(
        criteria=[stop.Iteration(max_iters=MAX_ITERS), stop.ResidualNorm(tolerance=1e-10)]
    ).generate(P64).solve(B3.double())
    torch.cuda.synchronize()
    check(bool(info64.converged.all()), "float64 reference solve (path 2): not converged")
    emit({"phase": "main_path", "path": 2, "route": "streaming", "case": "f64_reference_k4",
          "iterations": info64.num_iterations, "solve_s": round(time.perf_counter() - t0, 4),
          "csr_resolve_s": round(resolve_s, 3), "norm_inf": norm_a3})
    del P64

    builds = ops_pell.plan_for.builds
    k5_before = ops_pell.pell_spmv.launches
    t0 = time.perf_counter()
    x, info = gt.Cg.build(criteria=crit).generate(C).solve(b3)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    k5_runs = ops_pell.pell_spmv.launches - k5_before
    check(ops_pell.plan_for.builds == builds + 1, "Cg on the Csr did not build its plan once")
    check(k5_runs >= info.num_iterations, "Cg on the Csr did not run pell_spmv once per iteration")
    check(bool(info.converged.all()), "Cg on the Csr: not converged")
    emit({"phase": "main_path", "path": 2, "route": "streaming", "case": "csr_f32",
          "iterations": info.num_iterations, "pell_spmv_launches": k5_runs,
          **accuracy(C, x, b3, X64[:, 0], norm_a3, "Cg on the Csr"),
          "solve_s_with_plan_build": round(solve_s, 4)})
    ops_pell._PLAN_CACHE.clear()

    for label, A, pre, cls in (("pell_f32", P, None, gt.Cg),
                               ("pell_bf16", P.reduce_storage(), None, gt.Cg),
                               ("pell_f32_jacobi", P, gt.Jacobi.build(max_block_size=1), gt.Cg),
                               ("pell_f32_fcg", P, None, gt.Fcg)):
        t0 = time.perf_counter()
        solver = cls.build(criteria=crit, preconditioner=pre).generate(A)
        generate_s = time.perf_counter() - t0
        before = ops_pell_cg.pell_cg_fused.launches
        t0 = time.perf_counter()
        x, info = solver.solve(b3)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        check(ops_pell_cg.pell_cg_fused.launches == before + 1,
              f"main path {label} did not run pell_cg_fused")
        check(bool(info.converged.all()), f"main path {label}: not converged")
        check(x.shape == (n3,), f"main path {label}: bad x")
        emit({"phase": "main_path", "path": 2, "route": "fused", "case": label,
              "iterations": info.num_iterations, "residual_norm": float(info.residual_norm[0]),
              **accuracy(A, x, b3, X64[:, 0], norm_a3, f"main path {label}"),
              "generate_s": round(generate_s, 4), "solve_s": round(solve_s, 4)})

    solver = gt.Cg.build(criteria=crit).generate(P)
    k5_before = ops_pell.pell_spmv.launches
    t0 = time.perf_counter()
    with torch.no_grad():
        xs, sinfo = solver._solve_streaming(b3[:, None], torch.zeros(n3, 1, device=dev))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    k5_runs = ops_pell.pell_spmv.launches - k5_before
    check(bool(sinfo.converged.all()), "streaming route on the Pell: not converged")
    check(k5_runs >= sinfo.num_iterations, "streaming route did not run pell_spmv once per iteration")
    emit({"phase": "main_path", "path": 2, "route": "streaming", "case": "pell_f32",
          "iterations": sinfo.num_iterations, "pell_spmv_launches": k5_runs,
          **accuracy(P, xs[:, 0], b3, X64[:, 0], norm_a3, "streaming route on the Pell"),
          "solve_s": round(solve_s, 4)})

    k6_before = ops_pell.pell_spmm.launches
    t0 = time.perf_counter()
    X, minfo = solver.solve(B3)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    check(ops_pell.pell_spmm.launches - k6_before >= minfo.num_iterations,
          "k=4 solve on the Pell did not run pell_spmm once per iteration")
    check(bool(minfo.converged.all()), f"k=4 solve on the Pell: converged {minfo.converged.tolist()}")
    emit({"phase": "main_path", "path": 2, "route": "streaming", "case": "pell_f32_k4",
          "iterations": minfo.num_iterations,
          **accuracy(P, X, B3, X64, norm_a3, "k=4 solve on the Pell"),
          "solve_s": round(solve_s, 4)})
    launches2 = {k: f.launches for k, f in kernels.items()}
    check(all(launches2[k] > 0 for k in PATH2), f"a kernel of path 2 never ran: {launches2}")
    emit({"phase": "main_path", "path": 2, "launches": launches2})
    launches = {k: launches1[k] + launches2[k] for k in kernels}
    del X64

    # -- 5. timings (printed, not checked) -------------------------------------------
    src = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_ms = slope_ms(lambda: dst.copy_(src))
    copy_gbs = 2 * src.numel() / copy_ms / 1e6
    del src, dst
    timing = {"phase": "timing", "card": card, "copy_GBps": copy_gbs}
    rec = {}  # name -> (ms, plain_ms, library_ms, bytes, flops)

    x = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=dev)
    y = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=dev)
    X = torch.as_tensor(rng.standard_normal((n, 4)).astype(np.float32), device=dev)
    alpha = torch.full((1,), 0.7, device=dev)
    beta = torch.full((1,), -0.3, device=dev)
    lib2 = library_csr(gt.Csr.from_matrix_data(data, device=dev))
    lib_calls = {
        "dia_spmv": lambda: torch.mv(lib2, x),
        "dia_spmv_advanced": lambda: torch.addmv(y, lib2, x, beta=-0.3, alpha=0.7),
        "dia_spmm": lambda: torch.sparse.mm(lib2, X),
    }
    for storage, A in (("f32", A32), ("bf16", A32.reduce_storage())):
        D, offs = A.diags, A.offsets
        nd, s = len(offs), D.element_size()
        cases = {
            "dia_spmv": (lambda: ops_dia.dia_spmv(D, offs, x, n),
                         lambda: ops_dia.dia_spmv_reference(D, offs, x, n),
                         (nd * s + 8) * n, 2 * nd * n),
            "dia_spmv_advanced": (
                lambda: ops_dia.dia_spmv_advanced(D, offs, x, alpha, beta, y, n),
                lambda: ops_dia.dia_spmv_advanced_reference(D, offs, x, alpha, beta, y, n),
                (nd * s + 12) * n, (2 * nd + 3) * n),
            "dia_spmm": (lambda: ops_dia.dia_spmm(D, offs, X, n),
                         lambda: ops_dia.dia_spmm_reference(D, offs, X, n),
                         (nd * s + 2 * 4 * 4) * n, 2 * nd * n * 4),
        }
        for name, (kern, plain, nbytes, flops) in cases.items():
            k_ms = slope_ms(kern)
            p_ms = slope_ms(plain)
            gbs = nbytes / k_ms / 1e6
            timing[f"{name}_{storage}"] = {"ms": k_ms, "plain_ms": p_ms, "GBps": gbs,
                                           "frac_of_copy": gbs / copy_gbs}
            if storage == "f32":
                rec[name] = (k_ms, p_ms, slope_ms(lib_calls[name]), nbytes, flops)
    del lib2

    x3 = torch.as_tensor(rng.standard_normal(n3).astype(np.float32), device=dev)
    X3 = torch.as_tensor(rng.standard_normal((n3, 4)).astype(np.float32), device=dev)
    lib3 = library_csr(C)
    for storage, Pv in (("f32", P), ("bf16", P.reduce_storage())):
        plan_bytes = Pv.storage_bytes()
        cells = Pv.values.numel()
        cases = {
            "pell_spmv": (lambda: ops_pell.pell_spmv(Pv, x3),
                          lambda: ops_pell.pell_spmv_reference(Pv, x3),
                          lambda: torch.mv(lib3, x3), plan_bytes + 8 * n3, 2 * cells),
            "pell_spmm": (lambda: ops_pell.pell_spmm(Pv, X3),
                          lambda: ops_pell.pell_spmm_reference(Pv, X3),
                          lambda: torch.sparse.mm(lib3, X3), plan_bytes + 32 * n3, 8 * cells),
        }
        for name, (kern, plain, lib, nbytes, flops) in cases.items():
            k_ms = slope_ms(kern)
            p_ms = slope_ms(plain, 2, 7, 2)
            gbs = nbytes / k_ms / 1e6
            timing[f"{name}_{storage}"] = {"ms": k_ms, "plain_ms": p_ms, "GBps": gbs,
                                           "frac_of_copy": gbs / copy_gbs}
            if storage == "f32":
                rec[name] = (k_ms, p_ms, slope_ms(lib), nbytes, flops)
    del lib3

    zeros4 = torch.zeros_like(B)

    def fused(its):
        gt.Cg.build(criteria=[stop.Iteration(max_iters=its)]).generate(A32).solve(b)

    def streaming(its):
        s = gt.Cg.build(criteria=[stop.Iteration(max_iters=its)]).generate(A32)
        with torch.no_grad():
            s._solve_streaming(b[:, None], torch.zeros(n, 1, device=dev))

    def plain_k4(its):
        ops_cg.cg_solve_reference(A32.diags, A32.offsets, b, torch.zeros_like(b), None,
                                  tol_sq_eff=-1.0, max_iters=its)

    def fused4(its):
        gt.Cg.build(criteria=[stop.Iteration(max_iters=its)]).generate(A32).solve(B)

    def streaming4(its):
        s = gt.Cg.build(criteria=[stop.Iteration(max_iters=its)]).generate(A32)
        with torch.no_grad():
            s._solve_streaming(B, zeros4)

    def plain_k4m(its):
        ops_cg.cg_multi_solve_reference(A32.diags, A32.offsets, B, zeros4, None,
                                        tol_sq_eff=-1.0, max_iters=its)

    def fused_pell(its):
        gt.Cg.build(criteria=[stop.Iteration(max_iters=its)]).generate(P).solve(b3)

    def streaming_pell(its):
        s = gt.Cg.build(criteria=[stop.Iteration(max_iters=its)]).generate(P)
        with torch.no_grad():
            s._solve_streaming(b3[:, None], torch.zeros(n3, 1, device=dev))

    def plain_k7(its):
        ops_pell_cg.pell_cg_solve_reference(P, b3, torch.zeros_like(b3), None,
                                            tol_sq_eff=-1.0, max_iters=its)

    nd = len(A32.offsets)
    per_iter = {
        # per CG iteration: the operator and x, r, p read once and written
        # once (a Jacobi inverse diagonal adds 4 bytes a row); operations:
        # the SpMV plus 12 per row (three dots, three axpys)
        "cg_fused": (fused, streaming, plain_k4, (nd * 4 + 24) * n, (2 * nd + 12) * n),
        "cg_fused_multi": (fused4, streaming4, plain_k4m, (nd * 4 + 24 * 4) * n,
                           (2 * nd + 12) * 4 * n),
        "pell_cg_fused": (fused_pell, streaming_pell, plain_k7, P.storage_bytes() + 24 * n3,
                          2 * P.values.numel() + 12 * n3),
    }
    timing["cg_us_per_iter"] = {}
    for name, (fz, st, pl, nbytes, flops) in per_iter.items():
        f_ms, s_ms = iter_ms(fz), iter_ms(st)
        p_ms = iter_ms(pl, 50, 250)
        rec[name] = (f_ms, p_ms, None, nbytes, flops)
        timing["cg_us_per_iter"][name] = {"fused": f_ms * 1e3, "streaming": s_ms * 1e3,
                                          "plain": p_ms * 1e3,
                                          "GBps": nbytes / f_ms / 1e6}
    timing["cg_iteration_gap_2048"] = gaps
    emit(timing)

    # -- 6. result -----------------------------------------------------------------------
    rows = []
    for name in kernels:
        k_ms, p_ms, l_ms, nbytes, flops = rec[name]
        b_ms, b_by = bound(nbytes, flops)
        rows.append({"name": name, "route": "cuda", "source": KERNEL_META[name][0],
                     "replaces": KERNEL_META[name][1], "launches": launches[name],
                     "max_abs_err": max_err[name], "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
                     "bytes": nbytes, "flops": flops,
                     "copy_bound_ms": nbytes / copy_gbs / 1e6})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
