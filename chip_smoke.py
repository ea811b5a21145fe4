#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ginkgo_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``ginkgo_tpu_torch/csrc`` and
drives slice 1 of the port, the path users call: a 2-D Poisson matrix on a
2048 x 2048 grid (4,194,304 rows, about 21M nonzeros) -> ``Dia`` -> ``Cg``
with ``Iteration`` and ``ResidualNorm`` criteria.  Phases, each of which
raises on failure:

1. probe: versions, the card, the kernel build;
2. every kernel against its plain PyTorch version on the card, at the
   shapes of the main path (and at 64 x 64);
3. the main path: fused CG (K4) with float32 and bfloat16 diagonals and
   with Jacobi, the streaming CG route (K1), a 4-column solve (K3), each
   checked by its true residual through ``apply_advanced`` (K2).  The
   launch counters are zeroed just before and must all have risen;
4. timings, printed and not checked: each kernel and its plain version by
   the slope between two trip counts (CUDA events), CG time per iteration
   fused and streaming, and a device-to-device copy bandwidth.

The last lines are the kernels' JSON record, the card's name and power
limit as nvidia-smi reports them, and ``{"ok": true, ...}``.  Without a
CUDA device, or without the package beside it, the script fails and prints
no result.
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
TOL = 1e-6
MAX_ITERS = 20000
SEED = 2024


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


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU")
    import ginkgo_tpu_torch as gt
    from ginkgo_tpu_torch import _build, stop
    from ginkgo_tpu_torch.ops import cg as ops_cg
    from ginkgo_tpu_torch.ops import dia as ops_dia

    dev = torch.device(DEVICE, 0)
    torch.cuda.set_device(dev)
    rng = np.random.default_rng(SEED)
    kernels = {
        "dia_spmv": ops_dia.dia_spmv,
        "dia_spmv_advanced": ops_dia.dia_spmv_advanced,
        "dia_spmm": ops_dia.dia_spmm,
        "cg_fused": ops_cg.cg_fused,
    }
    meta = {
        "dia_spmv": ("ginkgo_tpu_torch/csrc/dia_spmv.cu", "ginkgo_tpu/ops/pallas_dia.py:364"),
        "dia_spmv_advanced": ("ginkgo_tpu_torch/csrc/dia_spmv.cu", "ginkgo_tpu/ops/pallas_dia.py:173"),
        "dia_spmm": ("ginkgo_tpu_torch/csrc/dia_spmv.cu", "ginkgo_tpu/ops/pallas_dia.py:275"),
        "cg_fused": ("ginkgo_tpu_torch/csrc/cg_fused.cu", "ginkgo_tpu/ops/pallas_cg.py:564"),
    }
    max_err = {k: 0.0 for k in kernels}

    # -- 1. probe ----------------------------------------------------------------
    card = smi_line()
    nvcc = _build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    for name in ("dia_spmv", "cg_fused"):
        _build.load(name)
    build_s = time.perf_counter() - t0
    regs = {
        name: [ln.split("info    : ")[-1] for ln in rec["ptxas"].splitlines() if "registers" in ln]
        for name, rec in _build.BUILD_LOG.items()
    }
    emit({"phase": "probe", "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc_ver, "triton": _dist_version("triton"), "card": card, "device": torch.cuda.get_device_name(0),
          "sm_count": torch.cuda.get_device_properties(0).multi_processor_count,
          "kernel_build_s": round(build_s, 3),
          "per_library_build_s": {k: round(v["seconds"], 3) for k, v in _build.BUILD_LOG.items()},
          "ptxas_registers": regs})

    # -- 2. each kernel against its plain version on the card ----------------------
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
                err = float((got - want).abs().max())
                check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                      f"{name} differs from its plain version ({nside}, {storage}): {err}")
                max_err[name] = max(max_err[name], err)
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
                err = float((kx - px).abs().max())
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
                max_err["cg_fused"] = max(max_err["cg_fused"], err)
                row[f"cg_fused_{pre}"] = {"iters": kit, "plain_iters": pit, "x_max_abs_err": err,
                                          "x_rel_err": rel, "s": round(k_s, 4),
                                          "plain_s": round(p_s, 4)}
            emit(row)
        del A32, A, D

    # -- 3. the main path, through the entry points a user calls ------------------
    for f in kernels.values():
        f.launches = 0
    data = datas[NSIDE]
    n = data.shape[0]
    b = torch.ones(n, device=dev)
    bnorm = float(b.norm())

    def accuracy(A, x, rhs, x_ref, label):
        """Check a float32 solution against the float64 reference solve and
        by its backward error; returns what it measured.

        The true residual b - A x is evaluated in float64 through the fused
        alpha * A x + beta * y kernel (K2) for one column.  It is reported,
        not bounded by 1e-4: x grows like |b| / lambda_min (|x_i| up to
        ~3e5 on the 2048^2 grid), where one float32 ulp of x_i is 0.03 and
        the float32 iterate's error of a few ulps per entry makes A x miss
        b by O(1) per row.  What is checked instead:
        the relative error against the float64 solution (<= 1e-3) and the
        normwise backward error |b - A x| / (|A| |x| + |b|) (<= 1e-5, about
        80 float32 epsilons)."""
        r = A.apply_advanced(-1.0, x.double(), 1.0, rhs.double())
        rn = r.norm(dim=0)
        bn = rhs.double().norm(dim=0)
        xn = x.double().norm(dim=0)
        norm_a = float(A.diags.float().abs().sum(0).max())
        relres = float((rn / bn).max())
        eta = float((rn / (norm_a * xn + bn)).max())
        fwd = float(((x.double() - x_ref).norm(dim=0) / x_ref.norm(dim=0)).max())
        check(bool(torch.isfinite(x).all()), f"{label}: non-finite x")
        check(fwd <= 1e-3, f"{label}: relative error {fwd} against the float64 solve")
        check(eta <= 1e-5, f"{label}: backward error {eta}")
        return {"true_relres": relres, "backward_error": eta, "rel_error_vs_f64": fwd}

    # float64 reference: the same system solved to 1e-10 on the streaming
    # route (K3 with float64 vectors), for the four right-hand sides below
    B = torch.as_tensor(
        np.stack([np.ones(n), rng.uniform(0.5, 1.5, n), np.linspace(-1, 1, n),
                  rng.standard_normal(n)], axis=1).astype(np.float32), device=dev)
    A64 = gt.Dia.from_matrix_data(data, device=dev).astype(torch.float64)
    t0 = time.perf_counter()
    X64, info64 = gt.Cg.build(
        criteria=[stop.Iteration(max_iters=MAX_ITERS), stop.ResidualNorm(tolerance=1e-10)]
    ).generate(A64).solve(B.double())
    torch.cuda.synchronize()
    check(bool(info64.converged.all()), "float64 reference solve: not converged")
    emit({"phase": "main_path", "route": "streaming", "case": "f64_reference_k4",
          "iterations": info64.num_iterations, "solve_s": round(time.perf_counter() - t0, 4)})
    del A64

    crit = [stop.Iteration(max_iters=MAX_ITERS), stop.ResidualNorm(tolerance=TOL)]
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
        emit({"phase": "main_path", "route": "fused", "case": label,
              "iterations": info.num_iterations, "residual_norm": float(info.residual_norm[0]),
              **accuracy(A, x, b, X64[:, 0], f"main path {label}"),
              "solve_s": round(solve_s, 4)})

    solver = gt.Cg.build(criteria=crit).generate(A32)
    k1_before = ops_dia.dia_spmv.launches
    t0 = time.perf_counter()
    with torch.no_grad():
        xs, sinfo = solver._solve_streaming(b[:, None], torch.zeros(n, 1, device=dev))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    check(bool(sinfo.converged.all()), "streaming route: not converged")
    check(ops_dia.dia_spmv.launches - k1_before >= sinfo.num_iterations,
          "streaming route did not run dia_spmv once per iteration")
    emit({"phase": "main_path", "route": "streaming", "case": "f32",
          "iterations": sinfo.num_iterations,
          **accuracy(A32, xs[:, 0], b, X64[:, 0], "streaming route"),
          "dia_spmv_launches": ops_dia.dia_spmv.launches - k1_before,
          "solve_s": round(solve_s, 4)})

    k3_before = ops_dia.dia_spmm.launches
    t0 = time.perf_counter()
    X, minfo = solver.solve(B)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    check(ops_dia.dia_spmm.launches > k3_before, "k=4 solve did not run dia_spmm")
    check(bool(minfo.converged.all()), f"k=4 solve: converged {minfo.converged.tolist()}")
    emit({"phase": "main_path", "route": "streaming", "case": "f32_k4",
          "iterations": minfo.num_iterations, **accuracy(A32, X, B, X64, "k=4 solve"),
          "solve_s": round(solve_s, 4)})
    launches = {k: f.launches for k, f in kernels.items()}
    check(all(v > 0 for v in launches.values()), f"a kernel of the path never ran: {launches}")
    emit({"phase": "main_path", "launches": launches, "bnorm": bnorm})

    # -- 4. timings (printed, not checked) -------------------------------------------
    src = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_ms = slope_ms(lambda: dst.copy_(src))
    copy_gbs = 2 * src.numel() / copy_ms / 1e6
    del src, dst
    timing = {"phase": "timing", "card": card, "copy_GBps": copy_gbs}
    ms = {}
    x = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=dev)
    y = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=dev)
    X = torch.as_tensor(rng.standard_normal((n, 4)).astype(np.float32), device=dev)
    alpha = torch.full((1,), 0.7, device=dev)
    beta = torch.full((1,), -0.3, device=dev)
    for storage, A in (("f32", A32), ("bf16", A32.reduce_storage())):
        D, offs = A.diags, A.offsets
        nd = len(offs)
        cases = {
            "dia_spmv": (lambda: ops_dia.dia_spmv(D, offs, x, n),
                         lambda: ops_dia.dia_spmv_reference(D, offs, x, n),
                         (nd * D.element_size() + 8) * n),
            "dia_spmv_advanced": (
                lambda: ops_dia.dia_spmv_advanced(D, offs, x, alpha, beta, y, n),
                lambda: ops_dia.dia_spmv_advanced_reference(D, offs, x, alpha, beta, y, n),
                (nd * D.element_size() + 12) * n),
            "dia_spmm": (lambda: ops_dia.dia_spmm(D, offs, X, n),
                         lambda: ops_dia.dia_spmm_reference(D, offs, X, n),
                         (nd * D.element_size() + 2 * 4 * 4) * n),
        }
        for name, (kern, plain, nbytes) in cases.items():
            k_ms = slope_ms(kern)
            p_ms = slope_ms(plain)
            gbs = nbytes / k_ms / 1e6
            timing[f"{name}_{storage}"] = {"ms": k_ms, "plain_ms": p_ms, "GBps": gbs,
                                           "frac_of_copy": gbs / copy_gbs}
            if storage == "f32":
                ms[name] = (k_ms, p_ms)

    def cg_iter_ms(run):
        """ms per CG iteration: slope between Iteration(200) and (1000)."""
        run(200)
        t200 = min(host_ms(lambda: run(200)) for _ in range(2))
        t1000 = min(host_ms(lambda: run(1000)) for _ in range(2))
        return (t1000 - t200) / 800

    def fused(its):
        gt.Cg.build(criteria=[stop.Iteration(max_iters=its)]).generate(A32).solve(b)

    def streaming(its):
        s = gt.Cg.build(criteria=[stop.Iteration(max_iters=its)]).generate(A32)
        with torch.no_grad():
            s._solve_streaming(b[:, None], torch.zeros(n, 1, device=dev))

    def plain_k4(its):
        ops_cg.cg_solve_reference(A32.diags, A32.offsets, b, torch.zeros_like(b), None,
                                  tol_sq_eff=-1.0, max_iters=its)

    fused_ms, stream_ms, plain4_ms = cg_iter_ms(fused), cg_iter_ms(streaming), cg_iter_ms(plain_k4)
    ms["cg_fused"] = (fused_ms, plain4_ms)
    timing["cg_us_per_iter"] = {"fused": fused_ms * 1e3, "streaming": stream_ms * 1e3,
                                "plain_k4": plain4_ms * 1e3}
    k4_bytes = (len(A32.offsets) * 4 + 44) * n
    timing["cg_fused_GBps"] = k4_bytes / fused_ms / 1e6
    timing["cg_fused_frac_of_copy"] = timing["cg_fused_GBps"] / copy_gbs
    timing["cg_iteration_gap_2048"] = gaps
    emit(timing)

    # -- 5. result -----------------------------------------------------------------------
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": ms[name][0], "plain_ms": ms[name][1]}
        for name in kernels
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
