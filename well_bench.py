#!/usr/bin/env python3
"""A/B runs of the port's SpMV kernels on one NVIDIA GPU, at the shapes of
``chip_smoke.py``'s main paths: K8 ``well_spmv`` and K9 ``well_spmm`` on
path 3a (the power-law Laplacian handed over as a ``Csr`` and planned as a
WELL, T and G by the planner), K5 ``pell_spmv`` on path 2's plan
(``poisson_3d(160)`` as a ``Csr`` -> ``Pell.from_csr``, S = 8) and K10
``bell_spmv`` on path 3b's ``Bell`` (``choose_format`` on
``block_structured(2048, 16, 6, 256)``); and the whole-solve K4
``cg_fused`` and K4m ``cg_fused_multi`` (k = 4) on path 1's
``poisson_2d(2048)`` ``Dia``.

Run from the repository root:

    python3 well_bench.py [--kernels well,pell_spmv,bell_spmv,cg_fused,cg_fused_multi]
                          [--rows N] [--chunks 256,512] [--cg-columns 2,4,8]
                          [--other DIR ...] [--check] [--profile]

``--kernels`` chooses what runs (default ``well``, K8/K9).  For ``well`` it
prints JSON lines:

- ``plan``: the plan's T, G, supertiles, slots and largest supertile, and
  for each chunk length of ``--chunks`` the work list's chunks, split
  supertiles, partials and scratch bytes;
- ``build``: ptxas's report (registers, stack frame, spills) of each
  kernel of ``csrc/well_spmv.cu``, this checkout's and each ``--other``'s,
  and the dynamic shared memory a K8 and a K9 (k = 4) block asks for on
  this plan;
- ``check`` (with ``--check``): K8 and K9 against their plain versions on
  small power-law plans (T = 1 to 64, G = 4 to 64, float32, float64 and
  bfloat16 values, float32 and float64 vectors, k = 1 to 5, default and
  forced small chunks), bit for bit, and two calls of each with the same
  bits; it fails on any difference;
- ``timing``: ms per call (CUDA events, the slope between 5 and 25 chained
  calls) of K8 and K9 (k = 4, float32) for each chunk length, of the
  kernels of each ``--other`` checkout of this repository on the same plan
  (its own ``ginkgo_tpu_torch``, built from its own sources into its own
  ``build/``), in turns (others, this, this, others), and of the library
  calls ``torch.mv`` and ``torch.sparse.mm`` on the same Csr; the padded
  plan's byte bound and the copy bandwidth;
- ``profile`` (with ``--profile``): the device time of each kernel that
  ten K8 and ten K9 calls launch (``torch.profiler``), by kernel name;
- the card's name and power limit, as nvidia-smi reports them.

For ``pell_spmv`` and ``bell_spmv``:

- ``build`` and ``launch``: ptxas's report of each kernel of the source,
  this checkout's and each ``--other``'s, and the kernel's launch on the
  main path's operator here (blocks, threads and dynamic shared memory a
  block, blocks an SM, registers a thread, the ring's shape);
- ``check`` (with ``--check``): ``chip_smoke.check_spmv_edges``, K5 and
  K10 bit for bit against their plain versions on small plans and Bells
  that reach every branch of their rings, each called twice;
- ``timing``: ms per call (CUDA events, the slope between 5 and 25 chained
  calls) with float32 and bfloat16 values, of this checkout's kernel and
  of each ``--other``'s on the same operator and x, in turns (others,
  this, this, others), and of ``torch.mv`` on the same ``Csr``; the bytes
  a call must move, the bound and the share of the copy rate; whether the
  kernel's y equals its plain version's bit for bit; the host microseconds
  a call takes to return, each checkout's;
- ``profile`` (with ``--profile``): the device time of each kernel that ten
  calls launch, this checkout's and each ``--other``'s, by kernel name.

For ``cg_fused`` and ``cg_fused_multi``:

- ``build``: ptxas's registers line of each kernel of ``csrc/cg_fused.cu``,
  this checkout's and each ``--other``'s, and each one's launch with
  float32 and bfloat16 diagonals (blocks of the cooperative grid, blocks
  an SM, registers a thread);
- ``check`` (with ``--check``): ``chip_smoke.check_cg_edges``, K4 and K4m
  against their plain versions on small banded operators that reach every
  branch of the two-pass iteration;
- ``timing``, one row a case (k = 1 for K4, ``--cg-columns`` for K4m,
  4 by default; float32 and bfloat16 diagonals; Identity and Jacobi; CG
  and FCG): microseconds an
  iteration by the slope between whole solves of 200 and 1000 iterations
  (CUDA events), this checkout's and each ``--other``'s, in turns
  (others, this, this, others); the bytes an iteration of the bound and of
  the two- and three-pass designs, the bound and each kernel's share of
  the copy rate by the bound's bytes and by its own design's; the solve to
  1e-6 (b = ones, ``chip_smoke.rhs4``'s four columns, or k uniform ones)
  by each checkout,
  its seconds, iterations and per-column iterations, and whether this
  checkout's x equals each other's bit for bit.

Without a CUDA device it fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs


#: the kernel library each choice of --kernels builds
LIBRARY = {"well": "well_spmv", "pell_spmv": "pell_spmv", "bell_spmv": "bell_spmv",
           "cg_fused": "cg_fused", "cg_fused_multi": "cg_fused"}
#: the whole-solve kernels of --kernels: K4 runs one column, K4m --cg-columns
CG_KERNELS = ("cg_fused", "cg_fused_multi")


def load_other(root: Path, tag: str):
    """The ``ginkgo_tpu_torch`` package of another checkout, imported under
    its own name so that both live in one process."""
    name = f"gt_{tag}"
    pkg = root / "ginkgo_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def ops_of(pkg, kernel):
    """The ops module of a package that holds ``kernel``'s wrapper."""
    return importlib.import_module(f"{pkg.__name__}.ops.{LIBRARY[kernel].split('_')[0]}")


def small_powerlaw(n, seed):
    """A power-law pattern as ``chip_smoke.powerlaw_laplacian`` makes it,
    with values of both signs (a general matrix, not SPD)."""
    shape, r, c, v = cs.powerlaw_laplacian(n, seed=seed)
    v = v * np.where(np.random.default_rng(seed).random(len(v)) < 0.5, -1.0, 1.0)
    return shape, r, c, v.astype(np.float32)


def run_checks(gt, ops_well, dev):
    cases = [  # rows, T, G, chunk slots (None: the module's)
        (4096, 1, 8, None), (4096, 1, 8, 8), (4096, 4, 8, 16), (8192, 4, 4, None),
        (16384, 16, 64, 64), (16384, 16, 64, None), (32768, 32, 64, 64), (16384, 64, 8, 24),
    ]
    rng = np.random.default_rng(5)
    rows, n_cmp = [], 0
    for n, T, G, chunk in cases:
        data = gt.MatrixData.from_coo(*small_powerlaw(n, seed=n + T)).sum_duplicates()
        base = gt.Well.from_csr(gt.Csr.from_matrix_data(data, device=dev), T=T, G=G)
        cs_ = ops_well.CHUNK_SLOTS if chunk is None else chunk
        ch = ops_well.chunk_list(base, cs_)
        for vals in (torch.float32, torch.float64, torch.bfloat16):
            W = base.astype(vals)
            for vec in (torch.float32, torch.float64):
                x = torch.as_tensor(rng.standard_normal(n), dtype=vec, device=dev)
                x[rng.integers(0, n, 3)] = float("nan")
                x[rng.integers(0, n, 3)] = float("-inf")
                x[rng.integers(0, n, 3)] = -0.0
                outs = [(ops_well.well_spmv(W, x, cs_), ops_well.well_spmv(W, x, cs_),
                         ops_well.well_spmv_reference(W, x, cs_), "k1")]
                for k in (1, 2, 3, 4, 5):
                    X = torch.as_tensor(rng.standard_normal((n, k)), dtype=vec, device=dev)
                    X[rng.integers(0, n, 2), :] = float("nan")
                    outs.append((ops_well.well_spmm(W, X, cs_), ops_well.well_spmm(W, X, cs_),
                                 ops_well.well_spmm_reference(W, X, cs_), f"mm{k}"))
                torch.cuda.synchronize()
                for got, again, want, what in outs:
                    n_cmp += 1
                    same = bool(torch.equal(got.isnan(), want.isnan())) and bool(
                        torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)))
                    twice = bool(torch.equal(got.view(torch.uint8), again.view(torch.uint8)))
                    if not (same and twice):
                        raise RuntimeError(
                            f"well_bench: {what} differs (n {n}, T {T}, G {G}, chunk {cs_}, "
                            f"values {vals}, vectors {vec}): bit_equal {same}, repeat {twice}, "
                            f"max err {float((got.double() - want.double()).abs().nan_to_num().max())}")
        rows.append({"rows": n, "T": base.T, "G": base.G, "chunk": ch.slots,
                     "chunks": len(ch.work), "split": len(ch.fold)})
    return {"phase": "check", "cases": rows, "comparisons": n_cmp, "all_bit_equal": True}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="well",
                    help="comma-separated: well (K8/K9), pell_spmv (K5), bell_spmv (K10), "
                         "cg_fused (K4), cg_fused_multi (K4m)")
    ap.add_argument("--rows", type=int, default=cs.POWERLAW_ROWS)
    ap.add_argument("--chunks", default="256", help="chunk lengths to time, comma-separated")
    ap.add_argument("--other", action="append", default=[],
                    help="another checkout of this repository whose kernels to time alongside")
    ap.add_argument("--check", action="store_true", help="check the kernels on small plans first")
    ap.add_argument("--profile", action="store_true", help="device time by kernel name")
    ap.add_argument("--cg-columns", default="4",
                    help="cg_fused_multi: the column counts to time, comma-separated (2 to 8)")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(LIBRARY):
        raise SystemExit(f"well_bench: --kernels takes {', '.join(LIBRARY)}")
    if not torch.cuda.is_available():
        raise SystemExit("well_bench: torch.cuda.is_available() is False; this needs a GPU")
    import ginkgo_tpu_torch as gt
    from ginkgo_tpu_torch import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = cs.smi_line()
    others_pkg = {f"other{i}": load_other(Path(d).resolve(), f"other{i}")
                  for i, d in enumerate(args.other)}
    t0 = time.perf_counter()
    builders = [_build] + [importlib.import_module(f"{pkg.__name__}._build")
                           for pkg in others_pkg.values()]
    with ThreadPoolExecutor(len(builders)) as pool:  # every checkout's nvcc runs at once
        list(pool.map(lambda b: b.build([LIBRARY[k] for k in kernels]), builders))
    cs.emit({"phase": "build", "build_s": round(time.perf_counter() - t0, 2)})
    src = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_gbs = 2 * src.numel() / cs.slope_ms(lambda: dst.copy_(src)) / 1e6
    del src, dst
    if args.check and {"pell_spmv", "bell_spmv"} & set(kernels):
        t0 = time.perf_counter()
        rows = cs.check_spmv_edges(gt, dev, np.random.default_rng(5))
        cs.emit({"phase": "check", "kernels": ["pell_spmv", "bell_spmv"], "edge_cases": len(rows),
                 "all_bit_equal": True, "s": round(time.perf_counter() - t0, 2)})
    if args.check and set(CG_KERNELS) & set(kernels):
        t0 = time.perf_counter()
        rows = cs.check_cg_edges(gt, dev, np.random.default_rng(5))
        cs.emit({"phase": "check", "kernels": ["cg_fused", "cg_fused_multi"],
                 "edge_operators": len(rows), "s": round(time.perf_counter() - t0, 2)})
    cg_kernels = [k for k in kernels if k in CG_KERNELS]
    if cg_kernels:
        bench_cg(cg_kernels, [int(k) for k in args.cg_columns.split(",")], gt, dev, card,
                 copy_gbs, others_pkg)
    for k in kernels:
        if k == "well":
            bench_well(args, gt, dev, card, copy_gbs, others_pkg)
        elif k not in CG_KERNELS:
            bench_spmv(k, args, gt, dev, card, copy_gbs, others_pkg)
    print(card, flush=True)


def bench_well(args, gt, dev, card, copy_gbs, others_pkg):
    """K8/K9 at path 3a's shapes: plan, build, timing and profile rows."""
    from ginkgo_tpu_torch import _build
    from ginkgo_tpu_torch.ops import well as ops_well

    others = {tag: ops_of(pkg, "well") for tag, pkg in others_pkg.items()}
    ptxas = _build.BUILD_LOG["well_spmv"]["ptxas"].splitlines()
    if args.check:
        cs.emit(run_checks(gt, ops_well, dev))

    t0 = time.perf_counter()
    data = gt.MatrixData.from_coo(*cs.powerlaw_laplacian(args.rows)).sum_duplicates()
    C = gt.Csr.from_matrix_data(data, device=dev)
    W = gt.Well.from_csr(C)
    plan_s = time.perf_counter() - t0
    n = W.shape[0]
    chunks = [int(c) for c in args.chunks.split(",")]
    stats = {}
    for c in chunks:
        ch = ops_well.chunk_list(W, c)
        stats[c] = {"chunk_slots": ch.slots, "chunks": len(ch.work), "split_supertiles": len(ch.fold),
                    "partials": ch.n_parts,
                    "scratch_bytes_k1": ch.n_parts * W.T * ops_well.TILE_ROWS * 4,
                    "scratch_bytes_k4": ch.n_parts * W.T * ops_well.TILE_ROWS * 16}
    slots = W.tile_ptr.diff()
    cs.emit({"phase": "plan", "rows": n, "nnz": data.nnz, "T": W.T, "G": W.G, "NST": W.NST,
             "slots": W.values.shape[0], "max_supertile_slots": int(slots.max()),
             "median_supertile_slots": float(slots.float().median()),
             "plan_bytes": W.storage_bytes(), "plan_s": round(plan_s, 2), "chunks": stats})
    cs.emit({"phase": "build", "ptxas": ptxas,
             "ptxas_other": {tag: importlib.import_module(f"gt_{tag}._build")
                             .BUILD_LOG["well_spmv"]["ptxas"].splitlines() for tag in others},
             "smem_k8_f32": ops_well.block_smem_bytes(W, torch.float32),
             "smem_k9_f32_k4": ops_well.block_smem_bytes(W, torch.float32, 4),
             "smem_k8_f64": ops_well.block_smem_bytes(W, torch.float64),
             "smem_k9_f64_k4": ops_well.block_smem_bytes(W, torch.float64, 4)})

    rng = np.random.default_rng(cs.SEED)
    x = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=dev)
    X = torch.as_tensor(rng.standard_normal((n, 4)).astype(np.float32), device=dev)
    y_ref = ops_well.well_spmv_reference(W, x)
    Y_ref = ops_well.well_spmm_reference(W, X)
    y, Y = ops_well.well_spmv(W, x), ops_well.well_spmm(W, X)
    torch.cuda.synchronize()
    check = {"k8_bit_equal": bool(torch.equal(y, y_ref)), "k9_bit_equal": bool(torch.equal(Y, Y_ref)),
             "k8_max_abs_err": float((y - y_ref).abs().max()),
             "k9_max_abs_err": float((Y - Y_ref).abs().max())}
    del y_ref, Y_ref
    lib = cs.library_csr(C)
    nbytes = {"k8": W.storage_bytes() + 8 * n, "k9": W.storage_bytes() + 32 * n}
    times = {}

    def time_all(tag, mod, chunk=None):
        kw = {} if chunk is None else {"chunk_slots": chunk}
        for name, fn in (("k8", lambda: mod.well_spmv(W, x, **kw)),
                         ("k9", lambda: mod.well_spmm(W, X, **kw))):
            times.setdefault(f"{name}_{tag}", []).append(cs.slope_ms(fn, 5, 25))

    order = list(others.items())
    for turn in range(2):
        if turn == 0:
            for tag, mod in order:
                time_all(tag, mod)
        for c in chunks:
            time_all(f"chunk{c}", ops_well, c)
        if turn == 1:
            for tag, mod in reversed(order):
                time_all(tag, mod)
    times["k8_torch_mv"] = [cs.slope_ms(lambda: torch.mv(lib, x), 5, 25)]
    times["k9_torch_sparse_mm"] = [cs.slope_ms(lambda: torch.sparse.mm(lib, X), 5, 25)]
    bound = {k: v / cs.PEAK_BYTES_S * 1e3 for k, v in nbytes.items()}
    cs.emit({"phase": "timing", "card": card, "rows": n, "copy_GBps": copy_gbs, **check,
             "ms": times, "bound_ms": bound,
             "csr_bound_ms": {"k8": (12 * data.nnz + 4 * n) / cs.PEAK_BYTES_S * 1e3,
                              "k9": (24 * data.nnz + 16 * n) / cs.PEAK_BYTES_S * 1e3},
             "frac_of_copy": {k: nbytes[k[:2]] / min(v) / 1e6 / copy_gbs
                              for k, v in times.items() if k[:2] in nbytes}})
    if args.profile:
        cs.emit(profile(ops_well, W, x, X))


def main_path_operator(gt, kernel, dev):
    """The operator ``kernel`` takes on its main path, its ``Csr`` and a
    label: path 2's 160^3 ``Pell`` for K5, path 3b's ``Bell`` for K10."""
    if kernel == "pell_spmv":
        C = gt.Csr.from_matrix_data(gt.generators.poisson_3d(cs.NSIDE3, dtype=np.float32),
                                    device=dev)
        return gt.Pell.from_csr(C), C, f"poisson_3d({cs.NSIDE3})"
    data = gt.MatrixData.from_coo(*cs.block_structured(*cs.BELL_BLOCKS)).sum_duplicates()
    A = gt.choose_format(data, device=dev)
    if not isinstance(A, gt.Bell):
        raise RuntimeError(f"well_bench: choose_format gave a {type(A).__name__}, not a Bell")
    return A, gt.Csr.from_matrix_data(data, device=dev), f"block_structured{cs.BELL_BLOCKS}"


def bench_spmv(kernel, args, gt, dev, card, copy_gbs, others_pkg):
    """K5 or K10 on its main path's operator: build, launch, timing and
    profile rows, against each other checkout's kernel in turns."""
    from ginkgo_tpu_torch import _build

    ops = ops_of(gt, kernel)
    others = {tag: ops_of(pkg, kernel) for tag, pkg in others_pkg.items()}
    t0 = time.perf_counter()
    A, C, label = main_path_operator(gt, kernel, dev)
    setup_s = time.perf_counter() - t0
    lib_name = LIBRARY[kernel]
    cs.emit({"phase": "build", "kernel": kernel,
             "ptxas": _build.BUILD_LOG[lib_name]["ptxas"].splitlines(),
             "ptxas_other": {tag: importlib.import_module(f"gt_{tag}._build")
                             .BUILD_LOG[lib_name]["ptxas"].splitlines() for tag in others},
             "launch": {"f32": ops.spmv_launch(A), "bf16": ops.spmv_launch(A.reduce_storage())}})
    rng = np.random.default_rng(cs.SEED)
    x = torch.as_tensor(rng.standard_normal(A.shape[1]).astype(np.float32), device=dev)
    lib = cs.library_csr(C)
    fn = getattr(ops, kernel)
    times, bit_equal, nbytes = {}, {}, {}
    for storage, Av in (("f32", A), ("bf16", A.reduce_storage())):
        # bytes a call must move: the stored plan or panels, x read once, y
        # written once
        stored = (Av.storage_bytes() if kernel == "pell_spmv" else
                  Av.values.numel() * Av.values.element_size() + Av.panel_ids.numel() * 4)
        nbytes[storage] = stored + 4 * (A.shape[0] + A.shape[1])
        y = fn(Av, x)
        bit_equal[storage] = cs.bit_equal(y, getattr(ops, kernel + "_reference")(Av, x))
        order = list(others.items())
        for turn in range(2):
            if turn == 0:
                for tag, mod in order:
                    times.setdefault(f"{storage}_{tag}", []).append(
                        cs.slope_ms(lambda: getattr(mod, kernel)(Av, x), 5, 25))
            times.setdefault(f"{storage}_this", []).append(cs.slope_ms(lambda: fn(Av, x), 5, 25))
            if turn == 1:
                for tag, mod in reversed(order):
                    times[f"{storage}_{tag}"].append(
                        cs.slope_ms(lambda: getattr(mod, kernel)(Av, x), 5, 25))
    times["torch_mv"] = [cs.slope_ms(lambda: torch.mv(lib, x), 5, 25)]
    host = {"this": cs.host_us(lambda: fn(A, x))}
    for tag, mod in others.items():
        host[tag] = cs.host_us(lambda mod=mod: getattr(mod, kernel)(A, x))
    bound = {k: v / cs.PEAK_BYTES_S * 1e3 for k, v in nbytes.items()}
    cs.emit({"phase": "timing", "kernel": kernel, "matrix": label, "card": card,
             "shape": list(A.shape), "setup_s": round(setup_s, 2), "copy_GBps": copy_gbs,
             "bit_equal": bit_equal, "ms": times, "host_us_per_call": host, "bytes": nbytes,
             "bound_ms": bound,
             "frac_of_copy": {k: nbytes[k.split("_")[0]] / min(v) / 1e6 / copy_gbs
                              for k, v in times.items() if k.split("_")[0] in nbytes}})
    if args.profile:
        A_bf16 = A.reduce_storage()
        calls = {"this": lambda: fn(A, x), "this_bf16": lambda: fn(A_bf16, x)}
        for tag, mod in others.items():
            calls[tag] = lambda mod=mod: getattr(mod, kernel)(A, x)
            calls[tag + "_bf16"] = lambda mod=mod: getattr(mod, kernel)(A_bf16, x)
        cs.emit({"phase": "profile", "kernel": kernel, **profile_calls(calls)})


def ptxas_registers(text):
    """{mangled kernel name: ptxas's "Used N registers, ..." line and its
    stack and spill line} of one build's ptxas report."""
    out, name, spill = {}, None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], ""
        elif name and "spill stores" in line:
            spill = "; " + line.strip()
        elif name and "registers" in line:
            out[name] = line.split("info    : ")[-1].strip() + spill
            name = None
    return out


def cg_launch(mod, build_log, dtype, k, dev):
    """The launch of a checkout's K4 (k = 1) or K4m kernel: blocks, blocks
    an SM and registers.  A checkout without ``cg_fused_launch`` (the
    three-pass design) gives its blocks from its grid query and its
    registers from ptxas."""
    if hasattr(mod, "cg_fused_launch"):
        return mod.cg_fused_launch(dtype, k, dev)
    lib = mod._lib()
    code = mod.DTYPE_CODE[dtype]
    blocks = (mod.coop_grid_blocks(lib, "cg_fused_grid", (code,), dev) if k == 1 else
              mod.coop_grid_blocks(lib, "cg_fused_multi_grid", (code, k), dev))
    token = "kernelIf" if dtype == torch.float32 else "kernelI13__nv_bfloat16"
    regs = [line for name, line in ptxas_registers(build_log).items()
            if token in name and ((f"Li{k}E" in name) if k > 1 else ("Li" not in name))]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return {"blocks": blocks, "blocks_per_sm": blocks // sms,
            "registers": regs[0].split()[1] if regs else None}


def design(mod, k):
    """The pass design of a checkout's kernel at k columns: K4m is two-pass
    where the checkout has ``cg_fused_launch``; K4 is three-pass in all."""
    return "two_pass" if k > 1 and hasattr(mod, "cg_fused_launch") else "three_pass"


def bench_cg(kernels, multi_columns, gt, dev, card, copy_gbs, others_pkg):
    """K4 (k = 1) and K4m (k in ``multi_columns``) on path 1's
    ``poisson_2d(2048)`` Dia:
    build and launch rows, then each case's microseconds an iteration by the
    slope between whole solves of 200 and 1000 iterations, this checkout's
    kernel against each other checkout's in turns, and the solve to 1e-6
    with its iterations and x against the first other checkout's bits."""
    from ginkgo_tpu_torch import _build
    from ginkgo_tpu_torch.ops import cg as ops_cg

    others = {tag: ops_of(pkg, "cg_fused") for tag, pkg in others_pkg.items()}
    logs = {"this": _build.BUILD_LOG["cg_fused"]["ptxas"]}
    logs.update({tag: importlib.import_module(f"gt_{tag}._build").BUILD_LOG["cg_fused"]["ptxas"]
                 for tag in others})
    mods = {"this": ops_cg, **others}
    columns = [1] * ("cg_fused" in kernels) + multi_columns * ("cg_fused_multi" in kernels)
    A = gt.Dia.from_matrix_data(gt.generators.poisson_2d(cs.NSIDE, dtype=np.float32), device=dev)
    n, nd = A.shape[0], len(A.offsets)
    cs.emit({"phase": "build", "kernels": kernels,
             "ptxas": {tag: ptxas_registers(log) for tag, log in logs.items()},
             "launch": {tag: {f"{str(dt)[6:]}_k{k}": cg_launch(mod, logs[tag], dt, k, dev)
                              for k in columns for dt in (torch.float32, torch.bfloat16)}
                        for tag, mod in mods.items()}})
    minv = 1.0 / A.extract_diagonal().values.float()
    stop_never = torch.full((), -1.0, device=dev)
    rng = np.random.default_rng(cs.SEED)
    for k in columns:
        if k == 1:
            b = torch.ones(n, device=dev)
        elif k == 4:
            b = cs.rhs4(n, rng, dev)
        else:
            b = torch.as_tensor(rng.uniform(0.5, 1.5, (n, k)).astype(np.float32), device=dev)
        z = torch.zeros_like(b)
        tol = ((cs.TOL * b.double().norm(dim=0)) ** 2).float()
        for storage, Av in (("f32", A), ("bf16", A.reduce_storage())):
            for pre, mv in (("identity", None), ("jacobi", minv)):
                for flexible in (False, True):
                    case = f"k{k}_{storage}_{pre}{'_fcg' if flexible else ''}"

                    def call(mod, its, tol=tol):
                        fn = mod.cg_fused if k == 1 else mod.cg_fused_multi
                        return fn(Av.diags, Av.offsets, b, z, mv, tol_sq_eff=tol, max_iters=its,
                                  flexible=flexible)

                    us = {}
                    order = list(others.items())
                    for turn in range(2):
                        if turn == 0:
                            for tag, mod in order:
                                us.setdefault(tag, []).append(1e3 * cs.iter_ms(
                                    lambda its, mod=mod: call(mod, its, stop_never)))
                        us.setdefault("this", []).append(1e3 * cs.iter_ms(
                            lambda its: call(ops_cg, its, stop_never)))
                        if turn == 1:
                            for tag, mod in reversed(order):
                                us[tag].append(1e3 * cs.iter_ms(
                                    lambda its, mod=mod: call(mod, its, stop_never)))
                    solves, xs = {}, {}
                    for tag, mod in mods.items():
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        out = call(mod, cs.MAX_ITERS)
                        torch.cuda.synchronize()
                        solves[tag] = {"s": time.perf_counter() - t0, "iterations": int(out[2]),
                                       "converged": bool(out[4].all())}
                        if k > 1:
                            solves[tag]["column_iterations"] = out[5].tolist()
                        xs[tag] = out[0]
                    for tag in others:
                        solves["this"][f"x_bit_equal_{tag}"] = cs.bit_equal(xs["this"], xs[tag])
                    del xs
                    # bytes an iteration: the bound's (diagonals, and x, r, p
                    # read and written once each, the inverse diagonal read
                    # once), this design's two passes and the three-pass
                    # design's
                    dsz = nd * Av.diags.element_size()
                    jac = mv is not None
                    nbytes = {"bound": (dsz + 24 * k + 4 * jac) * n,
                              "two_pass": (dsz + 40 * k + 8 * jac) * n,
                              "three_pass": (dsz + 44 * k + (8 if k == 1 else 12) * jac) * n}
                    best = {tag: min(v) for tag, v in us.items()}
                    cs.emit({"phase": "timing", "case": case, "card": card, "rows": n,
                             "copy_GBps": copy_gbs, "us_per_iteration": us, "bytes": nbytes,
                             "bound_us": nbytes["bound"] / cs.PEAK_BYTES_S * 1e6,
                             "frac_of_copy_bound_bytes": {
                                 tag: nbytes["bound"] / t / 1e3 / copy_gbs for tag, t in best.items()},
                             "frac_of_copy_own_bytes": {
                                 tag: nbytes[design(mods[tag], k)] / t / 1e3 / copy_gbs
                                 for tag, t in best.items()},
                             "solve_1e-6": solves})


def profile_calls(calls):
    """Device microseconds per call of each kernel that ten calls of each
    function launch, by kernel name (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        out[name] = {e.key[:60]: getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) / 10
                     for e in prof.key_averages()}
    return out


def profile(ops_well, W, x, X):
    """Device microseconds per call of each kernel K8 and K9 launch."""
    return {"phase": "profile", **profile_calls({"k8": lambda: ops_well.well_spmv(W, x),
                                                  "k9": lambda: ops_well.well_spmm(W, X)})}


if __name__ == "__main__":
    main()
