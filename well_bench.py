#!/usr/bin/env python3
"""A/B runs of the port's SpMV kernels on one NVIDIA GPU, at the shapes of
``chip_smoke.py``'s main paths: K8 ``well_spmv`` and K9 ``well_spmm`` on
path 3a (the power-law Laplacian handed over as a ``Csr`` and planned as a
WELL, T and G by the planner), K5 ``pell_spmv`` on path 2's plan
(``poisson_3d(160)`` as a ``Csr`` -> ``Pell.from_csr``, S = 8) and K10
``bell_spmv`` and K11 ``bell_spmm`` on path 3b's ``Bell``
(``choose_format`` on ``block_structured(2048, 16, 6, 256)``); the
whole-solve K4
``cg_fused`` and K4m ``cg_fused_multi`` (k = 4) on path 1's
``poisson_2d(2048)`` ``Dia``; K22 ``trs_fused`` and K23
``cg_ilu_fused`` on path 7's IC and ILU of that ``Dia``; K12, K15m and K12m
on that ``Dia``; K7 ``pell_cg_fused`` and K18 ``pell_gmres_fused`` on
path 2's 160^3 ``Pell``, K15 ``gmres_fused`` on path 4's A2; and the
multigrid kernels K25-K28 on path 8's hierarchies.

Run from the repository root:

    python3 well_bench.py [--kernels well,pell_spmv,bell_spmv,bell_spmm,cg_fused,cg_fused_multi,
                                     trs_fused,cg_ilu_fused,bicgstab_fused,
                                     gmres_fused_multi,bicgstab_fused_multi,
                                     pell_cg_fused,gmres_fused,pell_gmres_fused,
                                     mg_cg_fused,pell_ir_fused,idr_fused,
                                     pell_bicgstab_fused,pell_cgs_fused,
                                     ir_fused,ir_smooth,bicg_fused,cgs_fused,
                                     bicgstab_ilu_fused]
                          [--rows N] [--chunks 256,512] [--cg-columns 2,4,8]
                          [--bicgstab-columns 2,4,8] [--bell-columns 2,4,8]
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
  calls, and ``chip_smoke.graph_ms``, a CUDA graph's) with float32 and
  bfloat16 values, of this checkout's kernel and
  of each ``--other``'s on the same operator and x, in turns (others,
  this, this, others), and of ``torch.mv`` on the same ``Csr``; the bytes
  a call must move, the bound and the share of the copy rate; whether the
  kernel's y equals its plain version's bit for bit; the host microseconds
  a call takes to return, each checkout's;
- ``profile`` (with ``--profile``): the device time of each kernel that ten
  calls launch, this checkout's and each ``--other``'s, by kernel name.

For ``bell_spmm`` (K11), at each column count of ``--bell-columns``
(2, 4 and 8 by default):

- ``build`` and ``launch``: ptxas's report of each kernel of
  ``csrc/bell_spmv.cu``, this checkout's and each ``--other``'s, and K11's
  launch on path 3b's ``Bell`` at each column count, float32 and bfloat16
  panels, where a checkout reports it;
- ``check`` (with ``--check``): as for ``bell_spmv``, which holds K11 at
  2, 3, 4, 8 and 9 columns too;
- ``timing``, one row a column count: ms per call (``chip_smoke.graph_ms``:
  CUDA events around a CUDA graph of 20 calls, the card's time alone; and the
  slope between 5 and 25 chained calls, which a call's host time bounds
  from below) with float32 and bfloat16 panels, of this
  checkout's kernel and of each ``--other``'s on the same ``Bell`` and X,
  in turns (others, this, this, others), and of ``torch.sparse.mm`` on the
  same ``Csr``; the bytes a call must move, the bound and the share of the
  copy rate (by the graph's time); whether each checkout's Y equals the
  plain version's bit for
  bit, and this checkout's column j K10's on column j; the host
  microseconds a call takes to return;
- ``profile`` (with ``--profile``): the device time of each kernel that ten
  calls launch at each column count, each checkout's, by kernel name (a
  call's host time exceeds K11's device time, so the slope overstates it).

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

For ``trs_fused`` and ``cg_ilu_fused`` (path 7's ParIc and ParIlu of the
2048^2 Poisson ``Dia``, 3 sweeps a triangle):

- ``build``: ptxas's registers line of each kernel of ``csrc/trs_fused.cu``,
  this checkout's and each ``--other``'s;
- ``check`` (with ``--check``): ``chip_smoke.check_trs_edges``, K22 and K23
  bit for bit against their plain versions on edge triangles that reach
  every branch of the walk;
- ``probe``: on each checkout, K22's device time (``torch.profiler``, by
  kernel name) at 0, 1, 2, 3, 4, 5 and 8 sweeps on A1's IC lower triangle
  and on the 64^2 one (where a sweep pass costs next to nothing, so the
  slope is a grid barrier's), K23's microseconds an iteration at 0/0 and
  1/1 sweeps on the 64^2 triangles (three grid barriers and two folds, and
  two passes and barriers more) and at 1/1, 2/2, 4/4 and 3/4 on A1's IC,
  K22 at 0 sweeps at 64^2 (a launch's fixed cost: cooperative on the
  barrier routine, plain on the walk), and where a checkout reports them
  the route each of those launches takes;
- ``timing``, one row a case (IC and ILU; float32 and bfloat16 triangles):
  K22 on the lower and the upper triangle, by device time and by the slope
  of chained calls; K23 in microseconds an iteration by the slope between
  solves of 200 and 1000 iterations; this checkout's and each
  ``--other``'s in turns (others, this, this, others); the launch (route, blocks, shared memory,
  blocks an SM, registers); the bytes a row of the bound, of the walk (its
  halo included) and of the barrier routine, and each checkout's share of
  the copy rate measured in the same process; x against the first other
  checkout's bits, and K23's solve to 1e-6 (ILU: to path 7's cap of 5000)
  with its iterations.

For ``bicgstab_fused`` (K12) and ``gmres_fused_multi`` (K15m, k = 4, m = 30)
on path 1's ``poisson_2d(2048)`` ``Dia``:

- ``build``: ptxas's registers and spills of each kernel of their sources,
  this checkout's and each ``--other``'s;
- ``check`` (with ``--check``): ``chip_smoke.check_bicgstab_edges`` and
  ``check_gmres_multi_edges``, bit for bit against the plain versions;
- ``timing``, one row a case (K12: float32, bfloat16 and Jacobi; K15m: a
  float32 and a bfloat16 basis): microseconds an iteration (Arnoldi step)
  by the slope between whole solves of 200 and 1000 iterations (60 and
  240 steps), this checkout's and each ``--other``'s in turns; the launch
  (route, blocks, blocks an SM, shared memory, registers); the bytes of the
  bound and of each design; x against the other checkouts and the plain
  version (K12: the solve to 1e-6 under path 4's cap of 5000; K15m: 90
  steps on A1, and a solve to 1e-6 on path 4's A2 with each column's stop
  step);
- ``bicgstab_fused_multi`` (K12m): ``check`` (with ``--check``)
  ``chip_smoke.check_bicgstab_multi_edges``; ``build``: ptxas's lines of
  its kernels and each checkout's launch (blocks, blocks an SM, registers,
  grid barriers an iteration); ``timing``, one row a case (each k of
  ``--bicgstab-columns``; float32, bfloat16, Jacobi): microseconds an
  iteration on A1 by the slope between solves of 200 and 1000 iterations
  in turns, the bytes of the bound and of the three- and five-pass
  designs, and x, r and each column's stop iteration of the solve to 1e-6
  on path 5's A2 against the plain version and the other checkouts.

For ``mg_cg_fused`` (K26, with K25, K27 and K28, which share its cycle):

- ``check`` (with ``--check``): ``chip_smoke.check_mg_edges``, K25-K28 bit
  for bit at 64^2 on every cycle shape and on pass lists that fuse in
  part;
- ``build`` and ``setup``: ptxas's lines and blocks an SM of each kernel,
  and each checkout's grid barriers a cycle and K26's an iteration, each
  on its own pass list;
- ``timing``, one row a kernel and hierarchy (the 64^2 hierarchy, path 8's
  A1 and A2): K25 per cycle by the slope of chained launches, K26 (CG and
  FCG), K27 and K28 by the slope between solves of 20 and 100 iterations
  (cycles), in turns; the bound's bytes and each checkout's pass bytes; x
  against the plain version and the other checkouts (K25 one cycle, K27
  20 cycles, K26 and K28 the solves to 1e-6, with their iterations).

For ``pell_cg_fused`` (K7 on path 2's 160^3 ``Pell``: float32 and bfloat16
values, Jacobi), ``gmres_fused`` (K15 on path 4's A2) and
``pell_gmres_fused`` (K18 on the 160^3 ``Pell``), m = 30 with a float32 and
a bfloat16 basis:

- ``build``: ptxas's registers and spills of each kernel, this checkout's
  and each ``--other``'s, and the count of each memory-order opcode in K7's
  SASS (``cuobjdump -sass``: the L1 invalidation of its grid barriers);
- ``check`` (with ``--check``): ``chip_smoke.check_pell_cg_edges`` and
  ``check_gmres_edges``, bit for bit against the plain versions;
- ``timing``, one row a case: microseconds an iteration (K7) or Arnoldi
  step by the slope between whole solves of 200 and 1000 iterations (60
  and 240 steps) in turns, beside the kernel's device time by name at the
  same trip counts (``torch.profiler``, which reads these long launches
  short or as 0 at times: the slope is the figure); the launch (blocks,
  blocks an SM, registers); the bytes of the bound and of the design; x,
  the iterations and the monitor against the plain version and the other
  checkouts (K7: the solve to 1e-6; GMRES: 90 steps, and the solve to 1e-6
  on A2, K18 on A2 as a ``Pell``).

For ``pell_bicgstab_fused`` (K19) and ``pell_cgs_fused`` (K20) on path
2's 160^3 ``Pell`` (float32 and bfloat16 values, Jacobi), with
``bench_solves``' method:

- ``build``: ptxas's registers and spills of each one's kernels, this
  checkout's and each ``--other``'s (a parent's Dia kernels on
  ``GkPellOp`` under their own names), and whether every other kernel of
  their sources (K12 on both routes, K12m, K13, K14; K18 where
  ``pell_gmres_fused`` is built too) kept its ptxas line;
- ``check`` (with ``--check``): ``chip_smoke.check_pell_bicgstab_cgs_edges``;
- ``timing``, one row a case: microseconds an iteration by the slope
  between solves of 200 and 1000 iterations in turns, beside the device
  time by kernel name; the launch (blocks, blocks an SM, registers); the
  bytes of the bound and of each checkout's design; x, r, the iterations
  and the monitor against the plain version and the other checkouts on
  300 capped iterations at 160^3 and on the solve to 1e-6 on path 4's A2
  as a ``Pell``, and where this checkout parts from the plain bits, the
  first iteration after which it does (by bisection on the cap), the
  plain solve's monitor and true residual just before it, and both
  solves' at the end.

For ``pell_ir_fused`` (K21 on path 2's 160^3 ``Pell``: float32 and
bfloat16 values with the Identity at relaxation 0.15, and Jacobi at 1.0)
and ``idr_fused`` (K16 on path 1's ``poisson_2d(2048)`` ``Dia`` at s = 2
and s = 4, ``chip_smoke.time_path5``'s shapes):

- ``build``: ptxas's registers and spills of each kernel of
  ``csrc/ir_fused.cu`` and ``csrc/idr_fused.cu``, this checkout's and each
  ``--other``'s, and each one's cooperative grid;
- ``check`` (with ``--check``): ``chip_smoke.check_pell_ir_edges`` and
  ``check_idr_edges``, bit for bit against the plain versions;
- ``timing``, one row a case: microseconds a sweep (K21) or an outer
  iteration (K16) by the slope between whole solves of 200 and 1000, in
  turns (others, this, this, others); K21's streaming loop (K5 and tensor
  ops, one host sync a sweep) beside it, this checkout's; the bytes of the
  bound and of each design; x, r, the sweeps (iterations) and the monitor
  against the plain version and the other checkouts: K21 300 sweeps on
  the 160^3 ``Pell``, K16 the solve to 1e-6 on path 4's A2.

For ``ir_fused`` and ``ir_smooth`` (K17) and ``bicg_fused`` (K14) on path
1's ``poisson_2d(2048)`` ``Dia`` (A1):

- ``build``: ptxas's registers and spills of each of their kernels, this
  checkout's and each ``--other``'s, and each one's launch with float32
  and bfloat16 diagonals (blocks, blocks an SM, registers);
- ``check`` (with ``--check``): ``chip_smoke.check_ir_edges`` and
  ``check_bicg_edges``, bit for bit against the plain versions, each case
  twice;
- ``timing``, one row a case (float32 and bfloat16 diagonals with Jacobi,
  float32 with the Identity; the smoother with and without the residual;
  K14 float32, bfloat16 and Jacobi): microseconds a sweep or an iteration
  by the slope between solves of 200 and 1000 (smoothings of 20 and 100
  sweeps) in turns (others, this, this, others); the bytes of the bound,
  of this design and of the design before it; x, r, the sweeps or
  iterations and the monitor against the plain version and the other
  checkouts: the solves to 1e-6 on path 4's A2, the smoother's 20 sweeps
  on A1.

A variant is a copy of the package under ``build/`` with one macro changed
(``GK_IR_ROWS`` or ``GK_IR_MIN_BLOCKS`` in ``csrc/ir_fused.cu``,
``GK_BICG_ROWS`` or ``GK_BICG_MIN_BLOCKS`` in ``csrc/cgs_fused.cu``),
passed as another ``--other``.

For ``cgs_fused`` (K13) on path 1's ``poisson_2d(2048)`` ``Dia`` (A1) and
``bicgstab_ilu_fused`` (K24) on path 7's ILU (3 sweeps a triangle) of path
4's ``convdiff_2d(2048)`` ``Dia`` (A2):

- ``build``: ptxas's registers and spills of their kernels, this
  checkout's and each ``--other``'s, and each one's launch (K13 with
  float32 and bfloat16 diagonals: blocks, blocks an SM, registers; K24 on
  each timed case: its route, grid barriers, shared memory and walks);
- ``check`` (with ``--check``): ``chip_smoke.check_cgs_edges`` and
  ``check_ilu_small`` (K22-K24 at 24^2 and 64^2, both of K24's routes and
  its walk with p in a pass of its own), bit for bit against the plain
  versions, each case twice;
- ``timing``, one row a case (K13: float32 and bfloat16 diagonals, Jacobi
  folded into A M; K24: path 7's float32 ILU, bfloat16 triangles, and
  bfloat16 A and triangles): microseconds an iteration by the slope
  between solves of 200 and 1000 in turns (others, this, this, others);
  the bytes of the bound, of this design and of the barrier routine's; x,
  r, the iterations and the monitor against the plain version and the
  other checkouts on the solve to 1e-6 (K13 on A2, K24 on A2 with its
  ILU).

A K13 variant is a copy of the package under ``build/`` with one macro
changed (``GK_CGS_ROWS`` or ``GK_CGS_MIN_BLOCKS`` in ``csrc/cgs_fused.cu``).

Without a CUDA device it fails.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs


#: the kernel library each choice of --kernels builds
LIBRARY = {"well": "well_spmv", "pell_spmv": "pell_spmv", "bell_spmv": "bell_spmv",
           "bell_spmm": "bell_spmv",
           "cg_fused": "cg_fused", "cg_fused_multi": "cg_fused", "trs_fused": "trs_fused",
           "cg_ilu_fused": "trs_fused", "bicgstab_fused": "bicgstab_fused",
           "gmres_fused_multi": "gmres_fused", "bicgstab_fused_multi": "bicgstab_fused",
           "gmres_fused": "gmres_fused", "pell_cg_fused": "pell_cg_fused",
           "pell_gmres_fused": "gmres_fused", "mg_cg_fused": "mg_fused",
           "pell_ir_fused": "ir_fused", "idr_fused": "idr_fused",
           "pell_bicgstab_fused": "bicgstab_fused", "pell_cgs_fused": "cgs_fused",
           "ir_fused": "ir_fused", "ir_smooth": "ir_fused", "bicg_fused": "cgs_fused",
           "cgs_fused": "cgs_fused", "bicgstab_ilu_fused": "trs_fused"}
#: the whole-solve kernels of --kernels: K4 runs one column, K4m --cg-columns
CG_KERNELS = ("cg_fused", "cg_fused_multi")
#: K22 and K23, the kernels of the sweep solve
TRS_KERNELS = ("trs_fused", "cg_ilu_fused")

#: K12 and K15m: the ring route and the tiled GMRES passes
KRYLOV_KERNELS = ("bicgstab_fused", "gmres_fused_multi")
#: K26 and the multigrid kernels that share its cycle (K25, K27, K28)
MG_KERNELS = ("mg_cg_fused",)
#: K7 (CG on a Pell), the one-column GMRES kernel, K15 on a Dia and K18 on
#: a Pell, and K19 (BiCGSTAB) and K20 (CGS) on a Pell, at their main paths'
#: shapes
SOLVE_KERNELS = ("pell_cg_fused", "gmres_fused", "pell_gmres_fused", "pell_bicgstab_fused",
                 "pell_cgs_fused")
#: K19 and K20 and the TPU sites they replace
PELL_KRYLOV = {"pell_bicgstab_fused": "bicgstab", "pell_cgs_fused": "cgs"}
#: K21 (IR on a Pell) and K16 (IDR(s) on a Dia), at path 6's and path 5's
#: shapes
SWEEP_KERNELS = ("pell_ir_fused", "idr_fused")
#: K17 (both entry points) and K14 on path 1's Dia
DIA_SWEEP_KERNELS = ("ir_fused", "ir_smooth", "bicg_fused")
#: K13 on path 1's Dia and K24 on path 7's ILU of path 4's Dia
CGS_ILU_KERNELS = ("cgs_fused", "bicgstab_ilu_fused")


def max_abs_err(name, got, want):
    """The largest |got - want| (the record_err of chip_smoke's checks)."""
    return float((got.double() - want.double()).abs().max())


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
                         "bell_spmm (K11), "
                         "cg_fused (K4), cg_fused_multi (K4m), trs_fused (K22), "
                         "cg_ilu_fused (K23), bicgstab_fused (K12), gmres_fused_multi (K15m), "
                         "bicgstab_fused_multi (K12m), pell_cg_fused (K7), gmres_fused (K15), "
                         "pell_gmres_fused (K18), mg_cg_fused (K26, with K25, K27, K28), "
                         "pell_ir_fused (K21), idr_fused (K16), pell_bicgstab_fused (K19), "
                         "pell_cgs_fused (K20), ir_fused and ir_smooth (K17), bicg_fused (K14), "
                         "cgs_fused (K13), bicgstab_ilu_fused (K24)")
    ap.add_argument("--rows", type=int, default=cs.POWERLAW_ROWS)
    ap.add_argument("--chunks", default="256", help="chunk lengths to time, comma-separated")
    ap.add_argument("--other", action="append", default=[],
                    help="another checkout of this repository whose kernels to time alongside")
    ap.add_argument("--check", action="store_true", help="check the kernels on small plans first")
    ap.add_argument("--profile", action="store_true", help="device time by kernel name")
    ap.add_argument("--cg-columns", default="4",
                    help="cg_fused_multi: the column counts to time, comma-separated (2 to 8)")
    ap.add_argument("--bicgstab-columns", default="2,4,8",
                    help="bicgstab_fused_multi: the column counts to time, comma-separated")
    ap.add_argument("--bell-columns", default="2,4,8",
                    help="bell_spmm: the column counts to time, comma-separated")
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
    build_mods = [_build] + [importlib.import_module(f"{pkg.__name__}._build")
                           for pkg in others_pkg.values()]
    with ThreadPoolExecutor(len(build_mods)) as pool:  # every checkout's nvcc runs at once
        list(pool.map(lambda b: b.build([LIBRARY[k] for k in kernels]), build_mods))
    cs.emit({"phase": "build", "build_s": round(time.perf_counter() - t0, 2),
             "library_s": [{k: round(v["seconds"], 2) for k, v in b.BUILD_LOG.items()}
                           for b in build_mods]})
    src = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_gbs = 2 * src.numel() / cs.slope_ms(lambda: dst.copy_(src)) / 1e6
    del src, dst
    if args.check and {"pell_spmv", "bell_spmv", "bell_spmm"} & set(kernels):
        t0 = time.perf_counter()
        rows = cs.check_spmv_edges(gt, dev, np.random.default_rng(5))
        cs.emit({"phase": "check", "kernels": ["pell_spmv", "bell_spmv", "bell_spmm"],
                 "edge_cases": len(rows),
                 "all_bit_equal": True, "s": round(time.perf_counter() - t0, 2)})
    if args.check and set(CG_KERNELS) & set(kernels):
        t0 = time.perf_counter()
        rows = cs.check_cg_edges(gt, dev, np.random.default_rng(5))
        cs.emit({"phase": "check", "kernels": ["cg_fused", "cg_fused_multi"],
                 "edge_operators": len(rows), "s": round(time.perf_counter() - t0, 2)})
    if args.check and set(TRS_KERNELS) & set(kernels):
        t0 = time.perf_counter()
        rows = cs.check_trs_edges(gt, dev, np.random.default_rng(5))
        cs.emit({"phase": "check", "kernels": list(TRS_KERNELS), "edge_grids": len(rows),
                 "cases": sum(r["cases"] for r in rows), "all_bit_equal": True,
                 "s": round(time.perf_counter() - t0, 2)})
    if args.check and "bicgstab_fused" in kernels:
        t0 = time.perf_counter()
        rows = cs.check_bicgstab_edges(gt, dev, np.random.default_rng(5))
        cs.emit({"phase": "check", "kernels": ["bicgstab_fused"], "edge_operators": len(rows),
                 "all_bit_equal": True, "s": round(time.perf_counter() - t0, 2)})
    if args.check and "pell_cg_fused" in kernels:
        t0 = time.perf_counter()
        rows = cs.check_pell_cg_edges(gt, dev, np.random.default_rng(5))
        cs.emit({"phase": "check", "kernels": ["pell_cg_fused"], "edge_operators": len(rows),
                 "all_bit_equal": True, "s": round(time.perf_counter() - t0, 2)})
    if args.check and {"gmres_fused", "pell_gmres_fused"} & set(kernels):
        t0 = time.perf_counter()
        rows = cs.check_gmres_edges(gt, dev, np.random.default_rng(5))
        cs.emit({"phase": "check", "kernels": ["gmres_fused", "pell_gmres_fused"],
                 "edge_cases": len(rows), "all_bit_equal": True,
                 "s": round(time.perf_counter() - t0, 2)})
    if args.check and "bicgstab_fused_multi" in kernels:
        t0 = time.perf_counter()
        rows = cs.check_bicgstab_multi_edges(gt, dev, np.random.default_rng(5))
        cs.emit({"phase": "check", "kernels": ["bicgstab_fused_multi"], "edge_operators": len(rows),
                 "all_bit_equal": True, "s": round(time.perf_counter() - t0, 2)})
    if args.check and "mg_cg_fused" in kernels:
        t0 = time.perf_counter()
        cs.check_mg_edges(gt, dev, np.random.default_rng(5))
        cs.emit({"phase": "check", "kernels": ["mg_vcycle", "mg_cg_fused", "mg_solve_fused",
                                               "mg_bicgstab_fused"],
                 "all_bit_equal": True, "s": round(time.perf_counter() - t0, 2)})
    if args.check and "gmres_fused_multi" in kernels:
        t0 = time.perf_counter()
        rows = cs.check_gmres_multi_edges(gt, dev, np.random.default_rng(5))
        cs.emit({"phase": "check", "kernels": ["gmres_fused_multi"], "edge_cases": len(rows),
                 "all_bit_equal": True, "s": round(time.perf_counter() - t0, 2)})
    if args.check and set(PELL_KRYLOV) & set(kernels):
        t0 = time.perf_counter()
        rows = cs.check_pell_bicgstab_cgs_edges(gt, dev, np.random.default_rng(5))
        cs.emit({"phase": "check", "kernels": list(PELL_KRYLOV), "edge_cases": len(rows),
                 "all_bit_equal": True, "s": round(time.perf_counter() - t0, 2)})
    if args.check and "pell_ir_fused" in kernels:
        t0 = time.perf_counter()
        rows = cs.check_pell_ir_edges(gt, dev, np.random.default_rng(5))
        cs.emit({"phase": "check", "kernels": ["pell_ir_fused"], "edge_operators": len(rows),
                 "all_bit_equal": True, "s": round(time.perf_counter() - t0, 2)})
    if args.check and "idr_fused" in kernels:
        t0 = time.perf_counter()
        rows = cs.check_idr_edges(gt, dev, np.random.default_rng(5))
        cs.emit({"phase": "check", "kernels": ["idr_fused"], "edge_operators": len(rows),
                 "all_bit_equal": True, "s": round(time.perf_counter() - t0, 2)})
    if args.check and {"ir_fused", "ir_smooth"} & set(kernels):
        t0 = time.perf_counter()
        rows = cs.check_ir_edges(gt, dev, np.random.default_rng(5))
        cs.emit({"phase": "check", "kernels": ["ir_fused", "ir_smooth"],
                 "edge_operators": len(rows), "all_bit_equal": True,
                 "s": round(time.perf_counter() - t0, 2)})
    if args.check and "bicg_fused" in kernels:
        t0 = time.perf_counter()
        rows = cs.check_bicg_edges(gt, dev, np.random.default_rng(5))
        cs.emit({"phase": "check", "kernels": ["bicg_fused"], "edge_operators": len(rows),
                 "all_bit_equal": True, "s": round(time.perf_counter() - t0, 2)})
    if args.check and "cgs_fused" in kernels:
        t0 = time.perf_counter()
        rows = cs.check_cgs_edges(gt, dev, np.random.default_rng(5))
        cs.emit({"phase": "check", "kernels": ["cgs_fused"], "edge_operators": len(rows),
                 "all_bit_equal": True, "s": round(time.perf_counter() - t0, 2)})
    if args.check and "bicgstab_ilu_fused" in kernels:
        t0 = time.perf_counter()
        cs.check_ilu_small(gt, dev, np.random.default_rng(5), max_abs_err)
        cs.emit({"phase": "check", "kernels": ["trs_fused", "cg_ilu_fused", "bicgstab_ilu_fused"],
                 "all_bit_equal": True, "s": round(time.perf_counter() - t0, 2)})
    cg_kernels = [k for k in kernels if k in CG_KERNELS]
    if cg_kernels:
        bench_cg(cg_kernels, [int(k) for k in args.cg_columns.split(",")], gt, dev, card,
                 copy_gbs, others_pkg)
    trs_kernels = [k for k in kernels if k in TRS_KERNELS]
    if trs_kernels:
        bench_trs(trs_kernels, gt, dev, card, copy_gbs, others_pkg)
    krylov_kernels = [k for k in kernels if k in KRYLOV_KERNELS]
    if krylov_kernels:
        bench_krylov(krylov_kernels, gt, dev, card, copy_gbs, others_pkg)
    if "bicgstab_fused_multi" in kernels:
        bench_bicgstab_multi([int(k) for k in args.bicgstab_columns.split(",")], gt, dev, card,
                             copy_gbs, others_pkg)
    if "mg_cg_fused" in kernels:
        bench_mg(gt, dev, card, copy_gbs, others_pkg)
    solve_kernels = [k for k in kernels if k in SOLVE_KERNELS]
    if solve_kernels:
        bench_solves(solve_kernels, gt, dev, card, copy_gbs, others_pkg)
    sweep_kernels = [k for k in kernels if k in SWEEP_KERNELS]
    if sweep_kernels:
        bench_sweeps(sweep_kernels, gt, dev, card, copy_gbs, others_pkg)
    dia_sweep_kernels = [k for k in kernels if k in DIA_SWEEP_KERNELS]
    if dia_sweep_kernels:
        bench_dia_sweeps(dia_sweep_kernels, gt, dev, card, copy_gbs, others_pkg)
    cgs_ilu_kernels = [k for k in kernels if k in CGS_ILU_KERNELS]
    if cgs_ilu_kernels:
        bench_cgs_ilu(cgs_ilu_kernels, gt, dev, card, copy_gbs, others_pkg)
    for k in kernels:
        if k == "well":
            bench_well(args, gt, dev, card, copy_gbs, others_pkg)
        elif k == "bell_spmm":
            bench_spmm([int(c) for c in args.bell_columns.split(",")], args, gt, dev, card,
                       copy_gbs, others_pkg)
        elif k not in (CG_KERNELS + TRS_KERNELS + KRYLOV_KERNELS + SOLVE_KERNELS + MG_KERNELS
                       + SWEEP_KERNELS + DIA_SWEEP_KERNELS + CGS_ILU_KERNELS
                       + ("bicgstab_fused_multi",)):
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
    times, graph, bit_equal, nbytes = {}, {}, {}, {}
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
                    graph.setdefault(f"{storage}_{tag}", []).append(
                        cs.graph_ms(lambda: getattr(mod, kernel)(Av, x)))
            times.setdefault(f"{storage}_this", []).append(cs.slope_ms(lambda: fn(Av, x), 5, 25))
            graph.setdefault(f"{storage}_this", []).append(cs.graph_ms(lambda: fn(Av, x)))
            if turn == 1:
                for tag, mod in reversed(order):
                    times[f"{storage}_{tag}"].append(
                        cs.slope_ms(lambda: getattr(mod, kernel)(Av, x), 5, 25))
                    graph[f"{storage}_{tag}"].append(
                        cs.graph_ms(lambda: getattr(mod, kernel)(Av, x)))
    times["torch_mv"] = [cs.slope_ms(lambda: torch.mv(lib, x), 5, 25)]
    host = {"this": cs.host_us(lambda: fn(A, x))}
    for tag, mod in others.items():
        host[tag] = cs.host_us(lambda mod=mod: getattr(mod, kernel)(A, x))
    bound = {k: v / cs.PEAK_BYTES_S * 1e3 for k, v in nbytes.items()}
    cs.emit({"phase": "timing", "kernel": kernel, "matrix": label, "card": card,
             "shape": list(A.shape), "setup_s": round(setup_s, 2), "copy_GBps": copy_gbs,
             "bit_equal": bit_equal, "ms": times, "graph_ms": graph, "host_us_per_call": host,
             "bytes": nbytes,
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


def bench_spmm(columns, args, gt, dev, card, copy_gbs, others_pkg):
    """K11 on path 3b's ``Bell`` at each column count: build, launch, timing
    and profile rows, against each other checkout's kernel in turns."""
    from ginkgo_tpu_torch import _build

    ops = ops_of(gt, "bell_spmm")
    others = {tag: ops_of(pkg, "bell_spmm") for tag, pkg in others_pkg.items()}
    t0 = time.perf_counter()
    A, C, label = main_path_operator(gt, "bell_spmm", dev)
    setup_s = time.perf_counter() - t0
    A_bf16 = A.reduce_storage()
    mods = {"this": ops, **others}
    cs.emit({"phase": "build", "kernel": "bell_spmm",
             "ptxas": _build.BUILD_LOG["bell_spmv"]["ptxas"].splitlines(),
             "ptxas_other": {tag: importlib.import_module(f"gt_{tag}._build")
                             .BUILD_LOG["bell_spmv"]["ptxas"].splitlines() for tag in others},
             "launch": {tag: {f"{storage}_k{k}": mod.spmm_launch(Av, k)
                              for k in columns for storage, Av in (("f32", A), ("bf16", A_bf16))}
                        for tag, mod in mods.items() if hasattr(mod, "spmm_launch")}})
    rng = np.random.default_rng(cs.SEED)
    lib = cs.library_csr(C)
    n, m = A.shape
    for k in columns:
        X = torch.as_tensor(rng.standard_normal((m, k)).astype(np.float32), device=dev)
        times, graph, bits, by_column, nbytes = {}, {}, {}, {}, {}
        for storage, Av in (("f32", A), ("bf16", A_bf16)):
            # bytes a call must move: the panels and their ids, X read once
            # and Y written once
            nbytes[storage] = (Av.values.numel() * Av.values.element_size()
                               + Av.panel_ids.numel() * 4 + 4 * k * (m + n))
            want = ops.bell_spmm_reference(Av, X)
            for tag, mod in mods.items():
                bits[f"{storage}_{tag}"] = cs.bit_equal(mod.bell_spmm(Av, X), want)
            Y = ops.bell_spmm(Av, X)
            by_column[storage] = all(
                cs.bit_equal(Y[:, j], ops.bell_spmv(Av, X[:, j].contiguous())) for j in range(k))
            del want, Y

            def measure(tag, Av=Av, storage=storage):
                call = lambda: mods[tag].bell_spmm(Av, X)  # noqa: E731
                times.setdefault(f"{storage}_{tag}", []).append(cs.slope_ms(call, 5, 25))
                graph.setdefault(f"{storage}_{tag}", []).append(cs.graph_ms(call))

            in_turns(measure, others)
        times["torch_sparse_mm"] = [cs.slope_ms(lambda: torch.sparse.mm(lib, X), 5, 25)]
        host = {tag: cs.host_us(lambda mod=mod: mod.bell_spmm(A, X)) for tag, mod in mods.items()}
        cs.emit({"phase": "timing", "kernel": "bell_spmm", "matrix": label, "card": card,
                 "columns": k, "shape": list(A.shape), "setup_s": round(setup_s, 2),
                 "copy_GBps": copy_gbs, "bit_equal": bits, "columns_equal_k10": by_column,
                 "ms": times, "graph_ms": graph, "host_us_per_call": host, "bytes": nbytes,
                 "bound_ms": {s_: v / cs.PEAK_BYTES_S * 1e3 for s_, v in nbytes.items()},
                 "frac_of_copy": {key: nbytes[key.split("_")[0]] / min(v) / 1e6 / copy_gbs
                                  for key, v in graph.items() if key.split("_")[0] in nbytes}})
        if args.profile:
            calls = {}
            for tag, mod in mods.items():
                calls[tag] = lambda mod=mod: mod.bell_spmm(A, X)
                calls[tag + "_bf16"] = lambda mod=mod: mod.bell_spmm(A_bf16, X)
            cs.emit({"phase": "profile", "kernel": "bell_spmm", "columns": k,
                     **profile_calls(calls)})


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


def walk_bytes(T, walk, sweeps, blocks, vectors):
    """Bytes one walk (a launch's ``walks`` entry) over the triangle T moves
    at ``blocks`` ranges of rows: each block reads the diagonals, ``vectors``
    vectors and invd of its rows and of its halo once, and one float a row
    is written."""
    n = T.shape[0]
    per_row = len(T.offsets) * T.diags.element_size() + 4 * (vectors + 1)
    span = -(-n // blocks)
    sw = sweeps * walk["width"]
    rows = 0
    for a in range(0, n, span):
        ln = min(span, n - a)
        if walk["direction"] > 0:
            rows += a + ln - (max(0, a - sw) & ~3)
        else:
            rows += ((min(n, a + ln + sw) + 3) & ~3) - a
    return rows * per_row + 4 * n


def trs_launch_of(mod, tag, T, sweeps, dev, logs):
    """A checkout's K22 launch: its own report where it has one (the walk's
    checkouts), else the barrier routine's grid and ptxas's registers."""
    if hasattr(mod, "trs_fused_launch"):
        return mod.trs_fused_launch(T, sweeps, dev)
    lib = mod._lib()
    code = mod.DTYPE_CODE[T.diags.dtype]
    token = "trs_fused_kernelIf" if T.diags.dtype == torch.float32 else "trs_fused_kernelI13"
    regs = [line for name, line in ptxas_registers(logs[tag]).items() if token in name]
    return {"route": "barrier", "blocks": mod.coop_grid_blocks(lib, "trs_fused_grid", (code,), dev),
            "registers": regs[0].split()[1] if regs else None, "grid_barriers": sweeps}


def cg_ilu_launch_of(mod, tag, A, L, U, sweeps, dev, logs):
    """A checkout's K23 launch, as :func:`trs_launch_of`."""
    if hasattr(mod, "cg_ilu_fused_launch"):
        return mod.cg_ilu_fused_launch(A, L, U, sweeps, sweeps, dev)
    lib = mod._lib()
    codes = (mod.DTYPE_CODE[A.diags.dtype], mod.DTYPE_CODE[L.diags.dtype])
    token = "cg_ilu_fused_kernelIf" + ("f" if L.diags.dtype == torch.float32 else "13")
    regs = [line for name, line in ptxas_registers(logs[tag]).items() if token in name]
    return {"route": "barrier",
            "blocks": mod.coop_grid_blocks(lib, "cg_ilu_fused_grid", codes, dev),
            "registers": regs[0].split()[1] if regs else None,
            "grid_barriers": 3 + 2 * sweeps}


def in_turns(measure, others):
    """measure(tag) for each other checkout and this one, in turns: others,
    this, this, others."""
    for tag in others:
        measure(tag)
    measure("this")
    measure("this")
    for tag in reversed(list(others)):
        measure(tag)


def bench_trs(kernels, gt, dev, card, copy_gbs, others_pkg):
    """K22 and K23 on path 7's IC and ILU of the 2048^2 Poisson Dia (3
    sweeps a triangle): build, probe and timing rows, this checkout's
    kernels against each other checkout's in turns."""
    from ginkgo_tpu_torch import _build
    from ginkgo_tpu_torch.factorization import ParIc, ParIlu
    from ginkgo_tpu_torch.ops import cg_ilu as ops_cg_ilu
    from ginkgo_tpu_torch.ops import trs as ops_trs

    s = cs.SWEEPS7
    mods = {"this": (ops_trs, ops_cg_ilu)}
    logs = {"this": _build.BUILD_LOG["trs_fused"]["ptxas"]}
    for tag, pkg in others_pkg.items():
        mods[tag] = (importlib.import_module(f"{pkg.__name__}.ops.trs"),
                     importlib.import_module(f"{pkg.__name__}.ops.cg_ilu"))
        logs[tag] = importlib.import_module(f"{pkg.__name__}._build").BUILD_LOG["trs_fused"]["ptxas"]
    others = [tag for tag in mods if tag != "this"]
    cs.emit({"phase": "build", "kernels": kernels,
             "ptxas": {tag: ptxas_registers(log) for tag, log in logs.items()}})

    t0 = time.perf_counter()
    A1 = gt.Dia.from_matrix_data(gt.generators.poisson_2d(cs.NSIDE, dtype=np.float32), device=dev)
    C1 = A1.to_csr()
    precs = {"ic": cs.ilu_factories(gt, "ic").generate(ParIc().generate(C1)),
             "ilu": cs.ilu_factories(gt, "ilu").generate(ParIlu().generate(C1))}
    del C1
    A64 = gt.Dia.from_matrix_data(gt.generators.poisson_2d(cs.SMALL, dtype=np.float32),
                                  device=dev)
    M64 = cs.ilu_factories(gt, "ic").generate(A64)
    n = A1.shape[0]
    b = torch.ones(n, device=dev)
    z = torch.zeros_like(b)
    never = torch.full((), -1.0, device=dev)
    cs.emit({"phase": "setup", "rows": n, "setup_s": round(time.perf_counter() - t0, 2)})

    # probes: a sweep pass and a grid barrier (K22's device time against its
    # sweeps at 2048^2 and at 64^2), the folds (K23 at 64^2), a launch's
    # fixed cost (K22 at 0 sweeps at 64^2); K22 and K23 at 2048^2 at sweep
    # counts beside path 7's: the kernels compiled for 1 to 4 sweeps, and
    # the walk with runtime counts (K22 at 5, K23 at 3 and 4)
    Tl, Tu, invdl, invdu = cs._ilu_parts(precs["ic"])
    T64l, T64u, inv64l, inv64u = cs._ilu_parts(M64)
    b64 = torch.ones(A64.shape[0], device=dev)
    probe = {"phase": "probe", "card": card, "sweeps": [0, 1, 2, 3, 4, 5, 8],
             "k23_sweeps_2048": [(1, 1), (2, 2), (4, 4), (3, 4)]}
    for tag, (mt, mc) in mods.items():
        def k22_us(T, invd, rhs, sw, mt=mt):
            return 1e3 * cs.device_ms(lambda: mt.trs_fused(T, invd, rhs, sweeps=sw), "trs_")

        def k23_us(A, L, U, il, iu, rhs, sw, mc=mc):
            return 1e3 * cs.iter_ms(lambda its: mc.cg_ilu_fused(
                A, L, U, il, iu, rhs, torch.zeros_like(rhs), sweeps_l=sw[0], sweeps_u=sw[1],
                tol_sq_eff=never, max_iters=its))

        big = {sw: k22_us(Tl, invdl, b, sw) for sw in probe["sweeps"]}
        small = {sw: k22_us(T64l, inv64l, b64, sw) for sw in probe["sweeps"]}
        k23 = {f"{k}/{k}": k23_us(A64, T64l, T64u, inv64l, inv64u, b64, (k, k)) for k in (0, 1)}
        k23_big = {f"{sl}/{su}": k23_us(A1, Tl, Tu, invdl, invdu, b, (sl, su))
                   for sl, su in probe["k23_sweeps_2048"]}
        barrier = (small[8] - small[0]) / 8
        probe[tag] = {"k22_device_us_2048": big, "k22_device_us_64": small,
                      "k23_us_per_iteration_64": k23, "k23_us_per_iteration_2048": k23_big,
                      "us_per_sweep_2048": (big[8] - big[0]) / 8,
                      "us_per_sweep_64": barrier,
                      "fold_us": (k23["0/0"] - 3 * barrier) / 2,
                      "launch_us_64_0_sweeps": small[0]}
        if hasattr(mt, "trs_fused_launch"):
            probe[tag]["k22_routes_2048"] = {
                sw: [mt.trs_fused_launch(Tl, sw, dev)[k] for k in ("route", "unrolled")]
                for sw in probe["sweeps"]}
            probe[tag]["k23_routes_2048"] = {
                f"{sl}/{su}": [mc.cg_ilu_fused_launch(A1, Tl, Tu, sl, su, dev)[k]
                               for k in ("route", "unrolled")]
                for sl, su in probe["k23_sweeps_2048"]}
    cs.emit(probe)

    for kind, M in precs.items():
        Tl, Tu, invdl, invdu = cs._ilu_parts(M)
        for storage in (torch.float32, torch.bfloat16):
            L, U = Tl.astype(storage), Tu.astype(storage)
            esz = L.diags.element_size()
            case = f"{kind}_{str(storage)[6:]}"
            if "trs_fused" in kernels:
                for side, T, invd in (("l", L, invdl), ("u", U, invdu)):
                    dev_us, slope_us = {}, {}

                    def measure(tag, T=T, invd=invd, dev_us=dev_us, slope_us=slope_us):
                        fn = (lambda: mods[tag][0].trs_fused(T, invd, b, sweeps=s))
                        dev_us.setdefault(tag, []).append(1e3 * cs.device_ms(fn, "trs_"))
                        slope_us.setdefault(tag, []).append(1e3 * cs.slope_ms(fn))

                    in_turns(measure, others)
                    launches = {tag: trs_launch_of(mods[tag][0], tag, T, s, dev, logs)
                                for tag in mods}
                    x = ops_trs.trs_fused(T, invd, b, sweeps=s)
                    bits = {"plain": cs.bit_equal(x, ops_trs.trs_reference(T, invd, b, sweeps=s))}
                    bits.update({tag: cs.bit_equal(x, mods[tag][0].trs_fused(T, invd, b, sweeps=s))
                                 for tag in others})
                    nd = len(T.offsets)
                    own = {}
                    for key, launch in launches.items():
                        if launch["route"] == "pipelined":
                            own[key] = walk_bytes(T, launch["walks"][0], s, launch["blocks"], 1)
                        else:
                            own[key] = (12 + s * (nd * esz + 16)) * n
                    nbytes = (nd * esz + 12) * n
                    best = {k: min(v) for k, v in dev_us.items()}
                    cs.emit({"phase": "timing", "kernel": "trs_fused", "case": f"{case}_{side}",
                             "card": card, "rows": n, "sweeps": s, "copy_GBps": copy_gbs,
                             "device_us": dev_us, "slope_us": slope_us, "launch": launches,
                             "bit_equal": bits, "bytes_bound": nbytes, "bytes_own": own,
                             "bytes_per_row_own": {k: v / n for k, v in own.items()},
                             "bound_us": nbytes / cs.PEAK_BYTES_S * 1e6,
                             "frac_of_copy_bound_bytes": {
                                 k: nbytes / t / 1e3 / copy_gbs for k, t in best.items()},
                             "frac_of_copy_own_bytes": {
                                 k: own[k] / t / 1e3 / copy_gbs for k, t in best.items()}})
            if "cg_ilu_fused" in kernels:
                us = {}

                def measure(tag, L=L, U=U, invdl=invdl, invdu=invdu, us=us):
                    mc = mods[tag][1]
                    us.setdefault(tag, []).append(1e3 * cs.iter_ms(lambda its: mc.cg_ilu_fused(
                        A1, L, U, invdl, invdu, b, z, sweeps_l=s, sweeps_u=s, tol_sq_eff=never,
                        max_iters=its)))

                in_turns(measure, others)
                launches = {tag: cg_ilu_launch_of(mods[tag][1], tag, A1, L, U, s, dev, logs)
                            for tag in mods}
                tol = torch.full((), (cs.TOL * float(b.norm())) ** 2, device=dev)
                cap = cs.MAX_ITERS if kind == "ic" else cs.A1_CG_ILU_CAP
                solves, xs = {}, {}
                for tag, (_, mc) in mods.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = mc.cg_ilu_fused(A1, L, U, invdl, invdu, b, z, sweeps_l=s, sweeps_u=s,
                                          tol_sq_eff=tol, max_iters=cap)
                    torch.cuda.synchronize()
                    solves[tag] = {"s": time.perf_counter() - t0, "iterations": int(out[2]),
                                   "converged": bool(out[4])}
                    xs[tag] = out[0]
                for tag in others:
                    solves["this"][f"x_bit_equal_{tag}"] = cs.bit_equal(xs["this"], xs[tag])
                del xs
                nd_a, nd_t = len(A1.offsets), len(L.offsets) + len(U.offsets)
                # bytes an iteration: the bound's (A's and the triangles'
                # diagonals, x, r and p read and written, invdl and invdu read
                # once); the walk's four passes (q = A p; x, the L walk on r
                # and q with its halo, r and mid written; the U walk on mid, z
                # written, r.z; p) and the barrier routine's nine
                nbytes = {"bound": (4 * nd_a + esz * nd_t + 32) * n,
                          "barrier": (4 * nd_a + 8 + 24 + 2 * (12 + s * (esz * nd_t // 2 + 16))
                                      + 8 + 12) * n}
                for key, launch in launches.items():
                    if launch["route"] == "pipelined":
                        wl, wu = launch["walks"]
                        nbytes[key] = ((4 * nd_a + 8) * n + 12 * n
                                       + walk_bytes(L, wl, s, launch["blocks"], 2) + 4 * n
                                       + walk_bytes(U, wu, s, launch["blocks"], 1)
                                       + 8 * n + 12 * n)
                best = {k: min(v) for k, v in us.items()}
                cs.emit({"phase": "timing", "kernel": "cg_ilu_fused", "case": case, "card": card,
                         "rows": n, "sweeps": s, "copy_GBps": copy_gbs, "us_per_iteration": us,
                         "launch": launches, "bytes": nbytes,
                         "bound_us": nbytes["bound"] / cs.PEAK_BYTES_S * 1e6,
                         "frac_of_copy_bound_bytes": {
                             k: nbytes["bound"] / t / 1e3 / copy_gbs for k, t in best.items()},
                         "frac_of_copy_own_bytes": {
                             k: nbytes[k if k in nbytes else "barrier"] / t / 1e3 / copy_gbs
                             for k, t in best.items()},
                         "solve_1e-6": solves})


#: K12m's design and grid barriers an iteration by checkout tag: this
#: checkout runs three passes; each ``--other`` is taken for the five-pass
#: kernel that came before the three-pass one
MULTI_DESIGN = {"this": ("three_pass", 3)}
MULTI_OTHER_DESIGN = ("five_pass", 5)


def multi_launch_of(tag, mod, dtype, k, dev, logs):
    """A checkout's K12m launch: its grid's blocks and blocks an SM,
    ptxas's registers, and its grid barriers an iteration (``MULTI_DESIGN``)."""
    code = mod.DTYPE_CODE[dtype]
    token = ("multi_kernelIfLi" if dtype == torch.float32 else "multi_kernelI13__nv_bfloat16Li")
    regs = [line for name, line in ptxas_registers(logs).items() if f"{token}{k}E" in name]
    blocks = mod.coop_grid_blocks(mod._lib(), "bicgstab_fused_multi_grid", (code, k), dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return {"blocks": blocks, "blocks_per_sm": blocks // sms,
            "grid_barriers": MULTI_DESIGN.get(tag, MULTI_OTHER_DESIGN)[1],
            "registers": regs[0].split()[1] if regs else None}


def bench_bicgstab_multi(columns, gt, dev, card, copy_gbs, others_pkg):
    """K12m on path 1's ``poisson_2d(2048)`` Dia at each k of ``columns``
    (float32 and bfloat16 diagonals, Jacobi folded into A M): the launch of
    each checkout, then microseconds an iteration by the slope between
    whole solves of 200 and 1000 iterations in turns, the bytes of the
    bound and of each design, and x, r and the per-column stop iterations
    of the solve to 1e-6 on path 5's A2 (k uniform columns; Jacobi: a
    seeded inverse diagonal folded into A M) against the other checkouts
    and the plain version."""
    from ginkgo_tpu_torch import _build
    from ginkgo_tpu_torch.ops import bicgstab as ops_bicgstab
    from ginkgo_tpu_torch.solver._fused_gate import fold_minv

    mods = {"this": ops_bicgstab, **{tag: ops_of(pkg, "bicgstab_fused_multi")
                                     for tag, pkg in others_pkg.items()}}
    others = [tag for tag in mods if tag != "this"]
    logs = {"this": _build.BUILD_LOG["bicgstab_fused"]["ptxas"]}
    logs.update({tag: importlib.import_module(f"{pkg.__name__}._build")
                 .BUILD_LOG["bicgstab_fused"]["ptxas"] for tag, pkg in others_pkg.items()})
    cs.emit({"phase": "build", "kernel": "bicgstab_fused_multi",
             "ptxas": {tag: {k: line for k, line in ptxas_registers(log).items()
                             if "bicgstab_fused_multi_kernel" in k} for tag, log in logs.items()},
             "launch": {tag: {f"{str(dt)[6:]}_k{k}": multi_launch_of(tag, mod, dt, k, dev, logs[tag])
                              for k in columns for dt in (torch.float32, torch.bfloat16)}
                        for tag, mod in mods.items()}})
    A1 = gt.Dia.from_matrix_data(gt.generators.poisson_2d(cs.NSIDE, dtype=np.float32), device=dev)
    A2 = gt.Dia.from_matrix_data(gt.MatrixData.from_coo(*cs.convdiff_2d(cs.NSIDE)), device=dev)
    n, nd = A1.shape[0], len(A1.offsets)
    minv = 1.0 / A1.extract_diagonal().values.float()
    minv2 = torch.as_tensor(np.random.default_rng(cs.SEED + 9).uniform(0.15, 0.3, n)
                            .astype(np.float32), device=dev)
    rng = np.random.default_rng(cs.SEED + 5)
    for k in columns:
        B = (cs.rhs4(n, rng, dev) if k == 4 else
             torch.as_tensor(rng.uniform(0.5, 1.5, (n, k)).astype(np.float32), device=dev))
        B2 = torch.as_tensor(rng.uniform(0.5, 1.5, (n, k)).astype(np.float32), device=dev)
        tol2 = ((cs.TOL * B2.norm(dim=0)) ** 2).contiguous()
        Z = torch.zeros_like(B)
        never = torch.full((k,), -1.0, device=dev)
        for case, D, mv in (("f32", A1.diags, None), ("bf16", A1.reduce_storage().diags, None),
                            ("jacobi", fold_minv(A1, minv), minv)):
            def solve(tag, its, D=D, mv=mv):
                return mods[tag].bicgstab_fused_multi(D, A1.offsets, B, Z, mv, tol_sq_eff=never,
                                                      max_iters=its)

            us = {}

            def measure(tag):
                us.setdefault(tag, []).append(1e3 * cs.iter_ms(lambda its: solve(tag, its)))

            in_turns(measure, others)
            # bits: the solve to 1e-6 on path 5's A2 (A1's float32 BiCGSTAB
            # does not reach it, and past convergence a column iterates on
            # round-off, where the declared float64 dot order shows)
            D2 = {"f32": A2.diags, "bf16": A2.reduce_storage().diags,
                  "jacobi": fold_minv(A2, minv2)}[case]
            mv2 = minv2 if mv is not None else None
            runs = {tag: mods[tag].bicgstab_fused_multi(D2, A2.offsets, B2, Z, mv2, tol_sq_eff=tol2,
                                                        max_iters=cs.MAX_ITERS) for tag in mods}
            plain = mods["this"].bicgstab_solve_multi_reference(
                D2, A2.offsets, B2, Z, mv2, tol_sq_eff=tol2, max_iters=cs.MAX_ITERS)
            runs["plain"] = plain
            bits = {tag: cs.bit_equal(runs["this"][0], runs[tag][0])
                    and cs.bit_equal(runs["this"][1], runs[tag][1])
                    and runs["this"][5].tolist() == runs[tag][5].tolist()
                    for tag in ["plain"] + others}
            stops = {tag: out[5].tolist() for tag, out in runs.items()}
            del runs, plain
            # bytes an iteration: the bound's (the diagonals, rr and minv read
            # once; x, r, p and v read and written once), this three-pass
            # design's and the five-pass design's
            dsz = nd * D.element_size()
            jac = 4 * (mv is not None)
            nbytes = {"bound": (dsz + 36 * k + jac) * n,
                      "three_pass": (2 * dsz + 68 * k + jac) * n,
                      "five_pass": (2 * dsz + 72 * k + jac) * n}
            best = {tag: min(v) for tag, v in us.items()}

            cs.emit({"phase": "timing", "kernel": "bicgstab_fused_multi", "case": f"k{k}_{case}",
                     "card": card, "rows": n, "copy_GBps": copy_gbs, "us_per_iteration": us,
                     "bytes": nbytes, "bound_us": nbytes["bound"] / cs.PEAK_BYTES_S * 1e6,
                     "frac_of_copy_bound_bytes": {
                         tag: nbytes["bound"] / t / 1e3 / copy_gbs for tag, t in best.items()},
                     "frac_of_copy_own_bytes": {
                         tag: nbytes[MULTI_DESIGN.get(tag, MULTI_OTHER_DESIGN)[0]] / t / 1e3
                         / copy_gbs for tag, t in best.items()},
                     "a2_stop_iterations": stops, "a2_x_r_stops_equal": bits})


def mg_hierarchy_of(mod, h):
    """Another checkout's own MgHierarchy of h's arrays and cycle, with the
    pass lists its own compiler makes (this checkout's: h itself)."""
    if mod.__name__ == "ginkgo_tpu_torch.ops.mg":
        return h
    meta = [dict(iters_pre=e["itp"], relax_pre=e["rp"], iters_post=e["ito"],
                 relax_post=e["ro"], iters_mid=e["itm"], relax_mid=e["rm"])
            for e in h.plan["lv"]]
    return mod.make_hierarchy(list(h.diags), list(h.offsets), list(h.dinv), list(h.strides),
                              h.minv, meta, mode=h.plan["mode"], mid_case=h.plan["mid_case"],
                              kcycle_rel_tol=h.plan["krt"])


def mg_barriers(mod, h):
    """A checkout's grid barriers of one cycle from zero (its pass list) and
    of K26's iteration (``ops/mg.mg_cg_barriers`` where the checkout has it,
    else the cycle's and three)."""
    passes = h.passes[False][0]
    if hasattr(mod, "mg_cg_barriers"):
        return {"cycle": mod.barriers(passes), "mg_cg_fused": mod.mg_cg_barriers(passes)}
    return {"cycle": mod.barriers(passes), "mg_cg_fused": mod.barriers(passes) + 3}


def bench_mg(gt, dev, card, copy_gbs, others_pkg):
    """K26 (CG and FCG + MG on path 8's A1 hierarchy, 12 levels) and the
    kernels that share its cycle: K25 (one cycle, the slope of chained
    launches), K27 (cycles, the slope between 20 and 100) and K28 (BiCGSTAB +
    MG on A2's hierarchy); K26 and K28 by the slope between solves of 20
    and 100 iterations.  Each checkout runs its own pass lists on the same
    hierarchy arrays, in turns.  The same four at 64^2 (6 levels), where a
    pass moves next to nothing, give each design's fixed cost a barrier.
    Rows: the build (ptxas, blocks an SM), the barriers, the timings with
    the bytes of the bound and of each checkout's passes, and x against the
    plain version and the other checkouts (K25: one cycle; K26: the solve
    to 1e-6; K27: 20 cycles; K28: the solve to 1e-6)."""
    from ginkgo_tpu_torch import _build
    from ginkgo_tpu_torch.ops import mg as ops_mg

    mods = {"this": ops_mg, **{tag: ops_of(pkg, "mg_cg_fused")
                               for tag, pkg in others_pkg.items()}}
    others = [tag for tag in mods if tag != "this"]
    logs = {"this": _build.BUILD_LOG["mg_fused"]["ptxas"]}
    logs.update({tag: importlib.import_module(f"{pkg.__name__}._build")
                 .BUILD_LOG["mg_fused"]["ptxas"] for tag, pkg in others_pkg.items()})
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    launch = {}
    for tag, mod in mods.items():
        lib, f32 = mod._lib(), mod.DTYPE_CODE[torch.float32]
        launch[tag] = {name: mod.coop_grid_blocks(lib, f"{name}_grid", codes, dev) // sms
                       for name, codes in (("mg_vcycle", (f32,)), ("mg_solve_fused", (f32,)),
                                           ("mg_cg_fused", (f32, f32)),
                                           ("mg_bicgstab_fused", (f32, f32)))}
    cs.emit({"phase": "build", "kernels": ["mg_vcycle", "mg_cg_fused", "mg_solve_fused",
                                           "mg_bicgstab_fused"],
             "ptxas": {tag: ptxas_registers(log) for tag, log in logs.items()},
             "blocks_per_sm": launch})
    t0 = time.perf_counter()
    A1 = gt.Dia.from_matrix_data(gt.generators.poisson_2d(cs.NSIDE, dtype=np.float32), device=dev)
    A2 = gt.Dia.from_matrix_data(gt.MatrixData.from_coo(*cs.convdiff_2d(cs.NSIDE)), device=dev)
    A64 = gt.Dia.from_matrix_data(gt.generators.poisson_2d(cs.SMALL, dtype=np.float32),
                                  device=dev)
    hs = {"a1": gt.Multigrid.build(max_levels=cs.MG_LEVELS8).generate(A1)._fused_hierarchy(),
          "a2": gt.Multigrid.build(max_levels=cs.MG_LEVELS8).generate(A2)._fused_hierarchy(),
          "64": gt.Multigrid.build(max_levels=6, min_coarse_rows=32).generate(A64)
          ._fused_hierarchy()}
    own = {tag: {key: mg_hierarchy_of(mod, h) for key, h in hs.items()}
           for tag, mod in mods.items()}
    cs.emit({"phase": "setup", "s": round(time.perf_counter() - t0, 2),
             "levels": {key: h.L for key, h in hs.items()},
             "diagonals": {key: [len(o) for o in h.offsets] for key, h in hs.items()},
             "barriers": {tag: {key: mg_barriers(mods[tag], hh) for key, hh in own[tag].items()}
                          for tag in mods}})
    rng = np.random.default_rng(cs.SEED + 8)
    rhs = {"a1": torch.ones(A1.shape[0], device=dev),
           "a2": torch.as_tensor(rng.uniform(0.5, 1.5, A2.shape[0]).astype(np.float32),
                                 device=dev),
           "64": torch.ones(A64.shape[0], device=dev)}
    ops = {"a1": A1, "a2": A2, "64": A64}
    never = torch.full((), -1.0, device=dev)

    def runs(key):
        """{kernel case: call(tag, its)} on hierarchy ``key``."""
        A, b = ops[key], rhs[key]
        z = torch.zeros_like(b)

        def cg(flexible):
            return lambda tag, its, tol=never: mods[tag].mg_cg_fused(
                A, own[tag][key], b, z, tol_sq_eff=tol, max_iters=its, flexible=flexible)

        out = {"mg_vcycle": lambda tag, its: mods[tag].mg_vcycle(own[tag][key], b),
               "mg_solve_fused": lambda tag, its, tol=never: mods[tag].mg_solve_fused(
                   own[tag][key], b, z, tol_sq_eff=tol, max_iters=its)}
        if key != "a2":
            out["mg_cg_fused"] = cg(False)
            out["mg_cg_fused fcg"] = cg(True)
        if key != "a1":
            out["mg_bicgstab_fused"] = lambda tag, its, tol=never: mods[tag].mg_bicgstab_fused(
                A, own[tag][key], b, z, tol_sq_eff=tol, max_iters=its)
        return out

    for key in ("64", "a1", "a2"):
        h = hs[key]
        n = h.sizes[0]
        nd_a = len(ops[key].offsets)
        for case, call in runs(key).items():
            us = {}

            def measure(tag, call=call, case=case):
                if case == "mg_vcycle":
                    t = cs.slope_ms(lambda: call(tag, 1))
                else:
                    t = cs.iter_ms(lambda its: call(tag, its), 20, 100)
                us.setdefault(tag, []).append(1e3 * t)

            in_turns(measure, others)
            # bits: one cycle, 20 cycles of K27, the K26/K28 solves to 1e-6
            b = rhs[key]
            tol = torch.full((), (cs.TOL * float(b.norm())) ** 2, device=dev)
            z = torch.zeros_like(b)
            if case == "mg_vcycle":
                got = {tag: call(tag, 1) for tag in mods}
                plain = ops_mg.mg_vcycle_reference(h, b)
                iters = {}
            elif case == "mg_solve_fused":
                got = {tag: call(tag, 20) for tag in mods}
                plain = ops_mg.mg_solve_reference(h, b, z, tol_sq_eff=never, max_iters=20)
                iters = {}
            else:
                got = {tag: call(tag, 500, tol) for tag in mods}
                if case.startswith("mg_cg"):
                    plain = ops_mg.mg_cg_solve_reference(ops[key], h, b, z, tol_sq_eff=tol,
                                                         max_iters=500,
                                                         flexible=case.endswith("fcg"))
                else:
                    plain = ops_mg.mg_bicgstab_solve_reference(ops[key], h, b, z,
                                                               tol_sq_eff=tol, max_iters=500)
                iters = {tag: int(out[2]) for tag, out in got.items()}
                iters["plain"] = int(plain[2])

            def x_of(out):
                return out if case == "mg_vcycle" else out[0]

            bits = {"plain": cs.bit_equal(x_of(got["this"]), x_of(plain))}
            bits.update({tag: cs.bit_equal(x_of(got["this"]), x_of(got[tag])) for tag in others})
            del got, plain
            # bytes: the bound's (the hierarchy once, and level 0's vectors as
            # chip_smoke.time_path8 counts them) and each checkout's passes
            hh = own["this"][key]
            hier, _, _ = cs.mg_cycle_cost(hh, hh.passes[False][0])
            vec = {"mg_vcycle": 8, "mg_solve_fused": 12, "mg_cg_fused": 32,
                   "mg_cg_fused fcg": 32, "mg_bicgstab_fused": 44}[case] * n
            per_pass = {}
            for tag in mods:
                ht = own[tag][key]
                _, pp, _ = cs.mg_cycle_cost(ht, ht.passes[case == "mg_solve_fused"][0])
                if case.startswith("mg_cg"):
                    pp += (4 * nd_a + 32) * n
                elif case == "mg_bicgstab_fused":
                    pp = 2 * pp + (8 * nd_a + 44) * n
                elif case == "mg_solve_fused":
                    pp += (4 * nd_a + 8) * n
                per_pass[tag] = pp
            best = {tag: min(v) for tag, v in us.items()}
            cs.emit({"phase": "timing", "kernel": case.split(" ")[0], "case": f"{key} {case}",
                     "card": card, "rows": n, "levels": h.L, "copy_GBps": copy_gbs,
                     "us": us, "bound_bytes": hier + vec,
                     "bound_us": (hier + vec) / cs.PEAK_BYTES_S * 1e6,
                     "pass_bytes": per_pass,
                     "frac_of_copy_pass_bytes": {
                         tag: per_pass[tag] / t / 1e3 / copy_gbs for tag, t in best.items()},
                     "iterations": iters, "x_bit_equal": bits})


def ring_halo_rows(n, width, blocks):
    """Rows the ring route's walks form beyond the blocks' own: each block's
    halo of up to w rows on each side of its range."""
    span = -(-n // blocks)
    rows = 0
    for a in range(0, n, span):
        ln = min(span, n - a)
        rows += (min(n, a + ln + width) - max(0, a - width)) - ln
    return rows


def krylov_launch(mod, kernel, diags, offsets, dev):
    """A checkout's K12 launch where it reports one (the ring route's
    checkouts), else its five-pass grid."""
    if kernel == "bicgstab_fused" and hasattr(mod, "bicgstab_fused_launch"):
        return mod.bicgstab_fused_launch(diags, offsets, dev)
    if kernel == "bicgstab_fused":
        code = mod.DTYPE_CODE[diags.dtype]
        return {"route": "barrier", "grid_barriers": 5,
                "blocks": mod.coop_grid_blocks(mod._lib(), "bicgstab_fused_grid", (code,), dev)}
    return {}


def bench_krylov(kernels, gt, dev, card, copy_gbs, others_pkg):
    """K12 on path 1's ``poisson_2d(2048)`` Dia (float32, bfloat16, Jacobi)
    and K15m (k = 4, m = 30, float32 and bfloat16 basis): build rows, then
    each case's microseconds an iteration (K12) or Arnoldi step (K15m) by
    the slope between whole solves, this checkout's against each other's
    in turns, and x and the iteration counts against the other checkouts
    and the plain version.  Device time by kernel name is not taken:
    ``torch.profiler`` read these long cooperative launches short by up to
    half in some readings on the H100."""
    from ginkgo_tpu_torch import _build
    from ginkgo_tpu_torch.ops import bicgstab as ops_bicgstab
    from ginkgo_tpu_torch.ops import gmres as ops_gmres
    from ginkgo_tpu_torch.solver._fused_gate import fold_minv

    libs = sorted({LIBRARY[k] for k in kernels})
    logs = {"this": {lib: _build.BUILD_LOG[lib]["ptxas"] for lib in libs}}
    for tag, pkg in others_pkg.items():
        b = importlib.import_module(f"{pkg.__name__}._build")
        logs[tag] = {lib: b.BUILD_LOG[lib]["ptxas"] for lib in libs}
    mods = {"this": {"bicgstab_fused": ops_bicgstab, "gmres_fused_multi": ops_gmres}}
    for tag, pkg in others_pkg.items():
        mods[tag] = {"bicgstab_fused": importlib.import_module(f"{pkg.__name__}.ops.bicgstab"),
                     "gmres_fused_multi": importlib.import_module(f"{pkg.__name__}.ops.gmres")}
    others = [tag for tag in mods if tag != "this"]
    tokens = {"bicgstab_fused": ("bicgstab_fused_kernel", "bicgstab_ring_kernel"),
              "gmres_fused_multi": ("gmres_fused_multi_kernel",)}
    cs.emit({"phase": "build", "kernels": kernels,
             "ptxas": {tag: {k: line for lib, log in lg.items()
                             for k, line in ptxas_registers(log).items()
                             if any(tok in k for kern in kernels for tok in tokens[kern])}
                       for tag, lg in logs.items()}})
    A1 = gt.Dia.from_matrix_data(gt.generators.poisson_2d(cs.NSIDE, dtype=np.float32), device=dev)
    n, nd = A1.shape[0], len(A1.offsets)
    b1 = torch.ones(n, device=dev)
    z1 = torch.zeros_like(b1)
    never = torch.full((), -1.0, device=dev)
    minv = 1.0 / A1.extract_diagonal().values.float()
    if "bicgstab_fused" in kernels:
        for case, D, mv in (("f32", A1.diags, None), ("bf16", A1.reduce_storage().diags, None),
                            ("jacobi", fold_minv(A1, minv), minv)):
            def solve(tag, its, tol=never, D=D, mv=mv):
                return mods[tag]["bicgstab_fused"].bicgstab_fused(
                    D, A1.offsets, b1, z1, mv, tol_sq_eff=tol, max_iters=its)

            us = {}

            def measure(tag):
                us.setdefault(tag, []).append(1e3 * cs.iter_ms(lambda its: solve(tag, its)))

            in_turns(measure, others)
            launches = {tag: krylov_launch(mods[tag]["bicgstab_fused"], "bicgstab_fused", D,
                                           A1.offsets, dev) for tag in mods}
            tol = torch.full((), (cs.TOL * float(b1.norm())) ** 2, device=dev)
            solves, xs = {}, {}
            for tag in mods:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = solve(tag, cs.A1_BICGSTAB_CAP, tol)
                torch.cuda.synchronize()
                solves[tag] = {"s": time.perf_counter() - t0, "iterations": int(out[2]),
                               "converged": bool(out[4])}
                xs[tag] = out[0]
            plain = ops_bicgstab.bicgstab_solve_reference(
                D, A1.offsets, b1, z1, mv, tol_sq_eff=tol, max_iters=cs.A1_BICGSTAB_CAP)
            solves["plain"] = {"iterations": int(plain[2])}
            solves["this"]["x_bit_equal_plain"] = cs.bit_equal(xs["this"], plain[0])
            for tag in others:
                solves["this"][f"x_bit_equal_{tag}"] = cs.bit_equal(xs["this"], xs[tag])
            del xs, plain
            # bytes an iteration: the bound's (the diagonals, rr and minv read
            # once; x, r, p and v read and written once), the five-pass
            # kernel's and the ring route's (its halo rows formed again)
            dsz = nd * D.element_size()
            jac = 4 * (mv is not None)
            nbytes = {"bound": (dsz + 36) * n + jac * n,
                      "five_pass": (2 * dsz + 72) * n + 2 * jac * n}
            for tag, launch in launches.items():
                if launch.get("route") == "ring":
                    halo = ring_halo_rows(n, launch["width"], launch["blocks"])
                    nbytes[tag] = (2 * dsz + 64 + jac) * n + 20 * halo
            best = {tag: min(v) for tag, v in us.items()}
            cs.emit({"phase": "timing", "kernel": "bicgstab_fused", "case": case, "card": card,
                     "rows": n, "copy_GBps": copy_gbs, "us_per_iteration": us,
                     "launch": launches, "bytes": nbytes,
                     "bound_us": nbytes["bound"] / cs.PEAK_BYTES_S * 1e6,
                     "frac_of_copy_bound_bytes": {
                         tag: nbytes["bound"] / t / 1e3 / copy_gbs for tag, t in best.items()},
                     "frac_of_copy_own_bytes": {
                         tag: nbytes.get(tag, nbytes["five_pass"]) / t / 1e3 / copy_gbs
                         for tag, t in best.items()},
                     "solve_1e-6": solves})
    if "gmres_fused_multi" in kernels:
        k, m = 4, cs.KRYLOV_DIM
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        launch = {}
        for tag in mods:
            mod = mods[tag]["gmres_fused_multi"]
            for basis in (torch.float32, torch.bfloat16):
                blocks = mod.coop_grid_blocks(mod._lib(), "gmres_fused_multi_grid",
                                              (0, mod.DTYPE_CODE[basis], k, m), dev)
                launch[f"{tag}_{str(basis)[6:]}"] = {"blocks": blocks,
                                                     "blocks_per_sm": blocks // sms}
        cs.emit({"phase": "launch", "kernel": "gmres_fused_multi", "k": k, "m": m,
                 "launch": launch})
        B1 = cs.rhs4(n, np.random.default_rng(cs.SEED + 5), dev)
        Z1 = torch.zeros_like(B1)
        never4 = torch.full((k,), -1.0, device=dev)
        A2 = gt.Dia.from_matrix_data(gt.MatrixData.from_coo(*cs.convdiff_2d(cs.NSIDE)),
                                     device=dev)
        B2 = cs.rhs4(n, np.random.default_rng(cs.SEED + 6), dev)
        tol2 = ((cs.TOL * B2.norm(dim=0)) ** 2).contiguous()
        for label, basis, vb in (("f32", torch.float32, 4), ("bf16", torch.bfloat16, 2)):
            def solve(tag, its, A=A1, B=B1, tol=never4, basis=basis):
                return mods[tag]["gmres_fused_multi"].gmres_fused_multi(
                    A.diags, A.offsets, B, torch.zeros_like(B), None, m=m, tol_sq_eff=tol,
                    max_iters=its, basis_dtype=basis)

            us = {}

            def measure(tag):
                us.setdefault(tag, []).append(1e3 * cs.iter_ms(lambda its: solve(tag, its),
                                                               60, 240))

            in_turns(measure, others)
            # bits: 90 steps (three cycles) on A1, and a solve to 1e-6 on A2 whose
            # columns stop at different steps
            runs = {tag: solve(tag, 90) for tag in mods}
            plain = ops_gmres.gmres_solve_multi_reference(
                A1.diags, A1.offsets, B1, Z1, None, m=m, tol_sq_eff=never4, max_iters=90,
                basis_dtype=basis)
            bits = {"a1_90_steps_plain": cs.bit_equal(runs["this"][0], plain[0])}
            bits.update({f"a1_90_steps_{tag}": cs.bit_equal(runs["this"][0], runs[tag][0])
                         for tag in others})
            del runs, plain
            solves = {tag: solve(tag, cs.MAX_ITERS, A2, B2, tol2) for tag in mods}
            plain = ops_gmres.gmres_solve_multi_reference(
                A2.diags, A2.offsets, B2, torch.zeros_like(B2), None, m=m, tol_sq_eff=tol2,
                max_iters=cs.MAX_ITERS, basis_dtype=basis)
            stops = {tag: out[4].tolist() for tag, out in solves.items()}
            stops["plain"] = plain[4].tolist()
            bits["a2_solve_plain"] = cs.bit_equal(solves["this"][0], plain[0])
            bits.update({f"a2_solve_{tag}": cs.bit_equal(solves["this"][0], solves[tag][0])
                         for tag in others})
            del solves, plain
            # bytes a step, averaged over a cycle: the bound's (chip_smoke
            # time_path5's model), and this design's passes (A: the diagonals,
            # V_j, u written, the basis rows; B: u in and out, the basis rows
            # twice; C: u in and out, the basis rows; D: u, V_{j+1}) with pass
            # B's second read of the basis rows counted and not
            row = vb * k
            own = [sum((4 * nd + 96 + 2 * row + reads * row * (j + 1)) * n for j in range(m)) / m
                   for reads in (4, 3)]
            cycle_bytes = (sum((4 * nd + (j + 2) * vb * k) * n for j in range(m))
                           + (4 * nd + (m * vb + 12) * k) * n)
            nbytes = {"bound": cycle_bytes / m, "this_design": own[0],
                      "this_design_second_read_from_l2": own[1]}
            best = {tag: min(v) for tag, v in us.items()}
            cs.emit({"phase": "timing", "kernel": "gmres_fused_multi", "case": f"k4_m30_{label}",
                     "card": card, "rows": n, "copy_GBps": copy_gbs, "us_per_step": us,
                     "bytes_per_step": nbytes,
                     "bound_us": nbytes["bound"] / cs.PEAK_BYTES_S * 1e6,
                     "frac_of_copy_bound_bytes": {
                         tag: nbytes["bound"] / t / 1e3 / copy_gbs for tag, t in best.items()},
                     "bit_equal": bits, "a2_stop_iterations": stops})


def sass_ops(lib_path, token):
    """{kernel: {SASS opcode: count}} of the memory-order opcodes (CCTL,
    MEMBAR, ERRBAR, the LDG forms) in the kernels of a built library whose
    mangled name holds ``token`` (``cuobjdump -sass``): whether a grid
    barrier invalidates L1 (CCTL.IVALL after its fence) and how the kernel
    loads."""
    from ginkgo_tpu_torch import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if token in name else None
            if name:
                out[name] = {}
        elif name:
            for word in line.replace(";", " ").split():
                if word.startswith(("CCTL", "MEMBAR", "ERRBAR", "LDG")):
                    out[name][word] = out[name].get(word, 0) + 1
    return out


def solve_launch(mod, kernel, A, m, basis, dev):
    """A checkout's launch of K7 (m, basis unused), K15 or K18 where it
    reports one, else the blocks of its cooperative grid."""
    if kernel == "pell_cg_fused":
        if hasattr(mod, "pell_cg_fused_launch"):
            return mod.pell_cg_fused_launch(A, dev)
        codes = (mod.DTYPE_CODE[A.values.dtype], mod.INDEX_CODE[A.qidx.dtype])
        return {"blocks": mod.coop_grid_blocks(mod._lib(), "pell_cg_fused_grid", codes, dev)}
    if hasattr(mod, "gmres_fused_launch"):
        return mod.gmres_fused_launch(A, m, basis, dev)
    vcode = mod.DTYPE_CODE[basis]
    if kernel == "gmres_fused":
        codes = ("gmres_fused_grid", (mod.DTYPE_CODE[A.diags.dtype], vcode, m))
    else:
        codes = ("pell_gmres_fused_grid", (mod.DTYPE_CODE[A.values.dtype],
                                           mod.INDEX_CODE[A.qidx.dtype], vcode, m))
    return {"blocks": mod.coop_grid_blocks(mod._lib(), *codes, dev)}


def bench_solves(kernels, gt, dev, card, copy_gbs, others_pkg):
    """K7 on path 2's 160^3 ``Pell`` (float32, bfloat16 values, Jacobi), K15
    on path 4's A2 and K18 on the 160^3 ``Pell`` (m = 30, a float32 and a
    bfloat16 basis): build rows (ptxas, and for K7 the SASS of its grid
    barrier), then each case's microseconds an iteration (Arnoldi step) by
    the slope between whole solves of 200 and 1000 iterations (60 and 240
    steps) in turns, beside the device time of the kernel by name at the
    same trip counts; the launch, the bytes of the bound and of each
    design; x, the iterations (steps), the monitor (true r.r) against the
    plain version and the other checkouts: K7's solve to 1e-6, GMRES's 90
    steps and its solve to 1e-6 on A2 (K18: A2 as a ``Pell``)."""
    from ginkgo_tpu_torch import _build
    from ginkgo_tpu_torch.ops import gmres as ops_gmres
    from ginkgo_tpu_torch.ops import pell_cg as ops_pc

    pkgs = {"this": gt, **others_pkg}
    mods = {tag: {"pell_cg_fused": importlib.import_module(f"{pkg.__name__}.ops.pell_cg"),
                  "gmres": importlib.import_module(f"{pkg.__name__}.ops.gmres")}
            for tag, pkg in pkgs.items()}
    others = [tag for tag in mods if tag != "this"]
    logs = {tag: importlib.import_module(f"{pkg.__name__}._build").BUILD_LOG
            for tag, pkg in pkgs.items()}
    tokens = {"pell_cg_fused": "pell_cg_fused_kernel",
              "gmres_fused": "gmres_fused_kernelI7GkDiaOp",
              "pell_gmres_fused": "gmres_fused_kernelI8GkPellOp",
              "pell_bicgstab_fused": "pell_bicgstab_fused_kernel",
              "pell_cgs_fused": "pell_cgs_fused_kernel"}
    # K19 and K20 of a checkout that still runs the Dia kernels on GkPellOp
    tokens_parent = {"pell_bicgstab_fused": "bicgstab_fused_kernelI8GkPellOp",
                     "pell_cgs_fused": "cgs_fused_kernelI8GkPellOp"}
    ptxas = {tag: {k: line for kern in kernels
                   for k, line in ptxas_registers(lg[LIBRARY[kern]]["ptxas"]).items()
                   if tokens[kern] in k or tokens_parent.get(kern, tokens[kern]) in k}
             for tag, lg in logs.items()}
    cs.emit({"phase": "build", "kernels": kernels, "ptxas": ptxas,
             "sass": {tag: sass_ops(lg["pell_cg_fused"]["path"], tokens["pell_cg_fused"])
                      for tag, lg in logs.items()} if "pell_cg_fused" in kernels else {}})
    if set(PELL_KRYLOV) & set(kernels):
        cs.emit(shared_source_ptxas(logs, kernels, tokens, tokens_parent))
    m = cs.KRYLOV_DIM
    t0 = time.perf_counter()
    C3 = gt.Csr.from_matrix_data(gt.generators.poisson_3d(cs.NSIDE3, dtype=np.float32),
                                 device=dev)
    P3 = gt.Pell.from_csr(C3)
    del C3
    n3 = P3.shape[0]
    b3 = torch.ones(n3, device=dev)
    data2 = gt.MatrixData.from_coo(*cs.convdiff_2d(cs.NSIDE))
    A2 = gt.Dia.from_matrix_data(data2, device=dev)
    n2 = A2.shape[0]
    b2 = torch.as_tensor(np.random.default_rng(cs.SEED + 7).uniform(0.5, 1.5, n2)
                         .astype(np.float32), device=dev)
    P2 = gt.Pell.from_csr(gt.Csr.from_matrix_data(data2, device=dev)) \
        if {"pell_gmres_fused", *PELL_KRYLOV} & set(kernels) else None
    cs.emit({"phase": "setup", "s": round(time.perf_counter() - t0, 2), "rows_160": n3,
             "rows_a2": n2, "plan_bytes": P3.storage_bytes()})
    never = torch.full((), -1.0, device=dev)

    def measure_all(call, lo, hi, token):
        """The slope in turns, and the device slope by kernel name (token:
        one name, or one a checkout)."""
        us, dev_us = {}, {}

        def measure(tag):
            us.setdefault(tag, []).append(1e3 * cs.iter_ms(lambda its: call(tag, its), lo, hi))

        in_turns(measure, others)
        for tag in mods:
            name = token if isinstance(token, str) else token[tag]
            t_lo = cs.device_ms(lambda: call(tag, lo), name, calls=2)
            t_hi = cs.device_ms(lambda: call(tag, hi), name, calls=2)
            dev_us[tag] = 1e3 * (t_hi - t_lo) / (hi - lo)
        return us, dev_us

    def emit_timing(kernel, case, rows, us, dev_us, nbytes, launches, bits):
        best = {tag: min(v) for tag, v in us.items()}
        cs.emit({"phase": "timing", "kernel": kernel, "case": case, "card": card, "rows": rows,
                 "copy_GBps": copy_gbs, "us_per_iteration": us, "device_us_per_iteration": dev_us,
                 "launch": launches, "bytes": nbytes,
                 "bound_us": nbytes["bound"] / cs.PEAK_BYTES_S * 1e6,
                 "frac_of_copy_bound_bytes": {
                     tag: nbytes["bound"] / t / 1e3 / copy_gbs for tag, t in best.items()},
                 "frac_of_copy_own_bytes": {
                     tag: nbytes["design"] / t / 1e3 / copy_gbs for tag, t in best.items()},
                 **bits})

    if "pell_cg_fused" in kernels:
        minv3 = (1.0 / P3.extract_diagonal().values.float()).contiguous()
        z3 = torch.zeros_like(b3)
        tol3 = torch.full((), (cs.TOL * float(b3.norm())) ** 2, device=dev)
        for case, P, mv in (("f32", P3, None), ("bf16", P3.reduce_storage(), None),
                            ("jacobi", P3, minv3)):
            plan = P.storage_bytes()
            def call(tag, its, tol=never, P=P, mv=mv):
                return mods[tag]["pell_cg_fused"].pell_cg_fused(P, b3, z3, mv, tol_sq_eff=tol,
                                                                max_iters=its)

            us, dev_us = measure_all(call, 200, 1000, tokens["pell_cg_fused"])
            launches = {tag: solve_launch(mods[tag]["pell_cg_fused"], "pell_cg_fused", P, m, None,
                                          dev) for tag in mods}
            outs = {tag: call(tag, cs.MAX_ITERS, tol3) for tag in mods}
            plain = ops_pc.pell_cg_solve_reference(P, b3, z3, mv, tol_sq_eff=tol3,
                                                   max_iters=cs.MAX_ITERS)
            bits = {"iterations": {tag: int(o[2]) for tag, o in outs.items()}}
            bits["iterations"]["plain"] = int(plain[2])
            bits["bit_equal_plain"] = {tag: cs.bit_equal(o[0], plain[0]) and cs.bit_equal(
                o[1], plain[1]) and cs.bit_equal(o[3], plain[3]) for tag, o in outs.items()}
            bits["x_bit_equal_this"] = {tag: cs.bit_equal(outs["this"][0], outs[tag][0])
                                        for tag in others}
            del outs, plain
            # bytes an iteration: the bound's (the plan once; x, r, p read and
            # written once; the inverse diagonal read once) and the three
            # passes' (1: the plan, p gathered, q out; 2: p, q, x and r in and
            # out; 3: r in, p in and out; the inverse diagonal in 2 and 3)
            jac = mv is not None
            nbytes = {"bound": plan + (24 + 4 * jac) * n3, "design": plan + (44 + 8 * jac) * n3}
            emit_timing("pell_cg_fused", case, n3, us, dev_us, nbytes, launches, bits)

    for kernel in (k for k in PELL_KRYLOV if k in kernels):
        bench_pell_krylov(kernel, mods, others, P3, b3, P2, b2, measure_all, emit_timing, dev,
                          token={tag: tokens[kernel] if hasattr(m["pell_cg_fused"],
                                                                "pell_krylov_launch")
                                 else tokens_parent[kernel].replace("I8GkPellOp", "<GkPellOp")
                                 for tag, m in mods.items()})

    gm_cases = [(k, label, basis) for k in ("gmres_fused", "pell_gmres_fused") if k in kernels
                for label, basis in (("f32", torch.float32), ("bf16", torch.bfloat16))]
    for kernel, label, basis in gm_cases:
        A, b, A_1e6, b_1e6 = ((A2, b2, A2, b2) if kernel == "gmres_fused" else (P3, b3, P2, b2))

        def call(tag, its, A=A, b=b, tol=never, kernel=kernel, basis=basis):
            g = mods[tag]["gmres"]
            kw = dict(m=m, tol_sq_eff=tol, max_iters=its, basis_dtype=basis)
            if kernel == "gmres_fused":
                return g.gmres_fused(A.diags, A.offsets, b, torch.zeros_like(b), None, **kw)
            return g.pell_gmres_fused(A, b, torch.zeros_like(b), None, **kw)

        def plain(A, b, its, tol=never, kernel=kernel, basis=basis):
            kw = dict(m=m, tol_sq_eff=tol, max_iters=its, basis_dtype=basis)
            if kernel == "gmres_fused":
                return ops_gmres.gmres_solve_reference(A.diags, A.offsets, b, torch.zeros_like(b),
                                                       None, **kw)
            return ops_gmres.pell_gmres_solve_reference(A, b, torch.zeros_like(b), None, **kw)

        us, dev_us = measure_all(call, 60, 240, tokens[kernel])
        launches = {tag: solve_launch(mods[tag]["gmres"], kernel, A, m, basis, dev)
                    for tag in mods}
        outs = {tag: call(tag, 90) for tag in mods}
        want = plain(A, b, 90)
        bits = {"steps_90_x_bit_equal_plain": {tag: cs.bit_equal(o[0], want[0])
                                               for tag, o in outs.items()}}
        tol = torch.full((), (cs.TOL * float(b_1e6.norm())) ** 2, device=dev)
        outs = {tag: call(tag, cs.MAX_ITERS, A_1e6, b_1e6, tol) for tag in mods}
        want = plain(A_1e6, b_1e6, cs.MAX_ITERS, tol)
        bits["solve_1e-6_a2"] = {
            "steps": {**{tag: int(o[1]) for tag, o in outs.items()}, "plain": int(want[1])},
            "x_and_rr_bit_equal_plain": {tag: cs.bit_equal(o[0], want[0])
                                         and cs.bit_equal(o[2], want[2]) for tag, o in outs.items()}}
        del outs, want
        # bytes a step, averaged over a cycle: the bound's (chip_smoke
        # time_path4's and time_path6's model) and this design's passes (A:
        # the operator, V_j, u out, the basis rows; B: u in and out, the basis
        # rows twice; C: u in and out, the basis rows; D: u in, V_{j+1} out),
        # pass B's second read of the basis rows counted and not
        vb = basis.itemsize
        n = A.shape[0]
        op = (A.storage_bytes() / n if kernel == "pell_gmres_fused"
              else 4 * len(A.offsets))
        cycle = (sum((op + (j + 2) * vb) * n for j in range(m)) + (op + m * vb + 12) * n) / m
        own = [sum((op + 24 + 2 * vb + reads * vb * (j + 1)) * n for j in range(m)) / m
               for reads in (4, 3)]
        nbytes = {"bound": cycle, "design": own[0], "design_second_read_from_l2": own[1]}
        emit_timing(kernel, f"m30_{label}", n, us, dev_us, nbytes, launches, bits)


def shared_source_ptxas(logs, kernels, tokens, tokens_parent):
    """A ``build`` row: whether every other kernel of K19's and K20's
    sources (K12 on both routes, K12m, K13, K14) and of K18's, where built,
    has this checkout's ptxas line in each other checkout."""
    skip = tuple(tokens[k] for k in PELL_KRYLOV) + tuple(tokens_parent.values())
    libs = sorted({LIBRARY[k] for k in kernels if LIBRARY[k] in
                   ("bicgstab_fused", "cgs_fused", "gmres_fused")})
    lines = {tag: {k: v for lib in libs for k, v in ptxas_registers(lg[lib]["ptxas"]).items()
                   if not any(t in k for t in skip)} for tag, lg in logs.items()}
    this = lines["this"]
    return {"phase": "build", "libraries": libs, "kernels_compared": len(this),
            "ptxas_unchanged": {tag: lines[tag] == this for tag in lines if tag != "this"},
            "ptxas_differs": {tag: sorted(k for k in set(this) | set(lines[tag])
                                          if this.get(k) != lines[tag].get(k))
                              for tag in lines if tag != "this"}}


def parting(call, plain, A, b, minv, tol, its, got, want):
    """Where this checkout's solve parts from the plain version's bits: the
    fewest iterations (by bisection on the cap) after which x differs, and
    both solves' monitors and true relative residuals after ``its``."""
    bn = float(b.double().norm())

    def relres(x):
        return float((b.double() - A.apply(x).double()).norm()) / bn

    lo, hi = 0, its  # x equal after lo iterations, different after hi
    before = {"monitor": None, "true_relres": 1.0}
    while hi - lo > 1:
        mid = (lo + hi) // 2
        a = call("this", mid, tol, A, minv, b)
        w = plain(A, b, torch.zeros_like(b), minv, tol_sq_eff=tol, max_iters=mid)
        if cs.bit_equal(a[0], w[0]):
            lo = mid
            before = {"monitor": float(w[3]), "true_relres": relres(w[0])}
        else:
            hi = mid
    return {"first_iteration_apart": hi, "plain_before": before,
            "monitor": {"this": float(got[3]), "plain": float(want[3])},
            "true_relres": {"this": relres(got[0]), "plain": relres(want[0])}}


def bench_pell_krylov(kernel, mods, others, P3, b3, P2, b2, measure_all, emit_timing, dev,
                      token):
    """K19 or K20 on path 2's 160^3 ``Pell`` (float32 and bfloat16 values,
    Jacobi): microseconds an iteration by the slope between solves of 200
    and 1000 in turns, beside the device time by kernel name; the launch;
    the bytes of the bound and of each checkout's design; x, r, the
    iterations and the monitor against the plain version and the other
    checkouts on the solve to 1e-6 on A2 as a ``Pell`` and on 300 capped
    iterations at 160^3."""
    from ginkgo_tpu_torch.ops import pell_cg as ops_pc

    plain = (ops_pc.pell_bicgstab_solve_reference if kernel == "pell_bicgstab_fused"
             else ops_pc.pell_cgs_solve_reference)
    never = torch.full((), -1.0, device=dev)
    n3 = P3.shape[0]
    z3 = torch.zeros_like(b3)
    minv3 = (1.0 / P3.extract_diagonal().values.float()).contiguous()
    minv2 = (1.0 / P2.extract_diagonal().values.float()).contiguous()
    tol2 = torch.full((), (cs.TOL * float(b2.norm())) ** 2, device=dev)

    def same(a, b):
        return (cs.bit_equal(a[0], b[0]) and cs.bit_equal(a[1], b[1]) and int(a[2]) == int(b[2])
                and cs.bit_equal(a[3], b[3]) and bool(a[4]) == bool(b[4]))

    for case, P, mv, mv2 in (("f32", P3, None, None), ("bf16", P3.reduce_storage(), None, None),
                             ("jacobi", P3, minv3, minv2)):
        def call(tag, its, tol=never, P=P, mv=mv, b=b3):
            return getattr(mods[tag]["pell_cg_fused"], kernel)(
                P, b, torch.zeros_like(b), mv, tol_sq_eff=tol, max_iters=its)

        us, dev_us = measure_all(call, 200, 1000, token)
        launches = {}
        for tag, m in mods.items():
            mod = m["pell_cg_fused"]
            if hasattr(mod, "pell_krylov_launch"):
                launches[tag] = mod.pell_krylov_launch(kernel, P, dev)
        # the plain version's bits: 300 capped iterations at 160^3, and the
        # solve to 1e-6 on A2 as a Pell (with A2's inverse diagonal for
        # Jacobi)
        P2c = P2 if case != "bf16" else P2.reduce_storage()
        bits = {}
        for what, args in (("capped_300_160", (P, b3, mv, never, 300)),
                           ("solve_1e-6_a2", (P2c, b2, mv2, tol2, cs.MAX_ITERS))):
            A, b, m_, tol, its = args
            outs = {tag: call(tag, its, tol, A, m_, b) for tag in mods}
            want = plain(A, b, torch.zeros_like(b), m_, tol_sq_eff=tol, max_iters=its)
            bits[what] = {"iterations": {**{tag: int(o[2]) for tag, o in outs.items()},
                                         "plain": int(want[2])},
                          "bit_equal_plain": {tag: same(o, want) for tag, o in outs.items()},
                          "x_bit_equal_this": {tag: cs.bit_equal(outs["this"][0], o[0])
                                               for tag, o in outs.items() if tag != "this"}}
            if not bits[what]["bit_equal_plain"]["this"]:
                bits[what]["parting"] = parting(call, plain, A, b, m_, tol, its, outs["this"],
                                                want)
            del outs, want
        # bytes an iteration: the bound's (time_path6: the plan once, rr in,
        # x, r and two carried vectors in and out, minv in) and each
        # checkout's design (the plan twice and its passes' vectors: K19 76
        # B a row, 100 with M p and M s staged; K20 72, 84 with M p staged;
        # a checkout that runs the Dia kernels on GkPellOp, five and four
        # passes, 72 + 8 and 68 + 4)
        plan, jac = P.storage_bytes(), mv is not None
        design = {"pell_bicgstab_fused": (76 + 24 * jac, 72 + 8 * jac),
                  "pell_cgs_fused": (72 + 12 * jac, 68 + 4 * jac)}[kernel]
        per_tag = {tag: 2 * plan + design[not hasattr(m["pell_cg_fused"], "pell_krylov_launch")]
                   * n3 for tag, m in mods.items()}
        nbytes = {"bound": plan + (36 + 4 * jac) * n3, "design": per_tag["this"],
                  "design_by_checkout": per_tag}
        emit_timing(kernel, case, n3, us, dev_us, nbytes, launches, bits)


def idr_vectors(s, jacobi, deferred):
    """n-long float32 vectors one IDR(s) outer iteration reads or writes in
    K16's passes (the diagonals apart): the deferred design (x once, r -=
    beta g and U -= alpha U folded into the next pass, no w) or the
    parent's (a pass each).  A product's gathered source counts once."""
    j = int(jacobi)
    total = 0
    for kk in range(s):
        u = 1 + 2 * (s - kk) + j + 1  # r, G and U rows kk.., minv, U[kk] out
        if deferred and kk > 0:  # step kk - 1: G[kk - 1] in, r out, U[kk - 1]
            u += 2 + (2 + (kk - 1) if kk > 1 else 0)
        product = 2 + (s if kk == 0 else 1)  # U[kk] gathered, G[kk] out, P rows
        alphas = sum(3 + (0 if deferred else 3) + (1 if ib + 1 < kk else s)
                     for ib in range(kk))
        update = 0 if deferred else 6  # r in and out, G[kk], x in and out, U[kk]
        total += u + product + alphas + update
    if deferred:
        settle = 3 + (2 + (s - 1) if s > 1 else 0)
        tail = 1 + j + (2 + s + 1 + j)  # t = A M r; x in and out, U, r, minv
    else:
        settle = 0
        tail = (1 + j + 1) + 2 + (2 + 1)  # w = M r; t = A w, r; x += om w
    return total + settle + tail + 3 + s  # the replacement: x, b, r out, P


def bench_sweeps(kernels, gt, dev, card, copy_gbs, others_pkg):
    """K21 on path 2's 160^3 ``Pell`` (float32 and bfloat16 values with the
    Identity at relaxation 0.15, Jacobi at 1.0) a sweep, and K16 on path
    1's ``poisson_2d(2048)`` ``Dia`` at s = 2 and s = 4 an outer iteration:
    build rows (ptxas, grids), then each case's microseconds by the slope
    between whole solves of 200 and 1000 in turns, the bytes of the bound
    and of the design, and the bits against the plain version and the
    other checkouts."""
    from ginkgo_tpu_torch import stop
    from ginkgo_tpu_torch.ops import idr as ops_idr
    from ginkgo_tpu_torch.ops import pell_cg as ops_pc

    pkgs = {"this": gt, **others_pkg}
    mods = {tag: {"pell_cg": importlib.import_module(f"{pkg.__name__}.ops.pell_cg"),
                  "ir": importlib.import_module(f"{pkg.__name__}.ops.ir"),
                  "idr": importlib.import_module(f"{pkg.__name__}.ops.idr")}
            for tag, pkg in pkgs.items()}
    others = [tag for tag in mods if tag != "this"]
    logs = {tag: importlib.import_module(f"{pkg.__name__}._build").BUILD_LOG
            for tag, pkg in pkgs.items()}
    tokens = {"pell_ir_fused": "pell_ir_fused_kernel", "idr_fused": "idr_fused_kernel"}
    tokens_parent = {"pell_ir_fused": "ir_fused_kernelI8GkPellOp", "idr_fused": "idr_fused_kernel"}
    cs.emit({"phase": "build", "kernels": kernels,
             "ptxas": {tag: {k: line for kern in kernels
                             for k, line in ptxas_registers(lg[LIBRARY[kern]]["ptxas"]).items()
                             if tokens[kern] in k or tokens_parent[kern] in k}
                       for tag, lg in logs.items()}})
    never = torch.full((), -1.0, device=dev)

    def bits_of(out):
        """(x, r or None, count, monitor, converged) of either checkout's
        output: the parent's K21 returns no r."""
        if len(out) == 4:
            return out[0], None, int(out[1]), out[2], bool(out[3])
        return out[0], out[1], int(out[2]), out[3], bool(out[4])

    def same(a, b):
        return (cs.bit_equal(a[0], b[0]) and (a[1] is None or b[1] is None
                                              or cs.bit_equal(a[1], b[1]))
                and a[2] == b[2] and cs.bit_equal(a[3], b[3]) and a[4] == b[4])

    def timing_row(kernel, case, rows, us, nbytes, extra):
        best = {tag: min(v) for tag, v in us.items()}
        cs.emit({"phase": "timing", "kernel": kernel, "case": case, "card": card, "rows": rows,
                 "copy_GBps": copy_gbs, "us": us, "bytes": nbytes,
                 "bound_us": nbytes["bound"] / cs.PEAK_BYTES_S * 1e6,
                 "frac_of_copy_bound_bytes": {
                     tag: nbytes["bound"] / t / 1e3 / copy_gbs for tag, t in best.items()},
                 "frac_of_copy_own_bytes": {
                     tag: nbytes["this" if tag == "this" else "parent_design"] / t / 1e3 / copy_gbs
                     for tag, t in best.items()}, **extra})

    if "pell_ir_fused" in kernels:
        t0 = time.perf_counter()
        C3 = gt.Csr.from_matrix_data(gt.generators.poisson_3d(cs.NSIDE3, dtype=np.float32),
                                     device=dev)
        P3 = gt.Pell.from_csr(C3)
        del C3
        n3 = P3.shape[0]
        b3, z3 = torch.ones(n3, device=dev), torch.zeros(n3, device=dev)
        minv3 = (1.0 / P3.extract_diagonal().values.float()).contiguous()
        tol3 = torch.full((), (cs.TOL * float(b3.norm())) ** 2, device=dev)
        cs.emit({"phase": "setup", "kernel": "pell_ir_fused", "s": round(time.perf_counter() - t0, 2),
                 "rows": n3, "plan_bytes": P3.storage_bytes(),
                 "blocks": {tag: m["pell_cg"].coop_grid_blocks(
                     m["ir"]._lib(), "pell_ir_fused_grid",
                     (m["pell_cg"].DTYPE_CODE[torch.float32], m["pell_cg"].INDEX_CODE[torch.int8]),
                     dev) for tag, m in mods.items()}})
        jac = gt.Jacobi.build(max_block_size=1)
        for case, P, mv, omega in (("f32", P3, None, 0.15), ("bf16", P3.reduce_storage(), None, 0.15),
                                   ("jacobi", P3, minv3, 1.0)):
            def call(tag, its, tol=never, P=P, mv=mv, omega=omega):
                # r is formed for the bits check only, and only this
                # checkout's K21 takes the flag
                kw = {"with_residual": True} if tol is not never and tag == "this" else {}
                return mods[tag]["pell_cg"].pell_ir_fused(P, b3, z3, mv, omega=omega,
                                                          tol_sq_eff=tol, max_iters=its, **kw)

            us = {}

            def measure(tag, call=call):
                us.setdefault(tag, []).append(1e3 * cs.iter_ms(lambda its: call(tag, its)))

            in_turns(measure, others)
            extra = {}
            if case == "jacobi":
                ir = gt.Ir.build(criteria=[stop.Iteration(max_iters=1)], preconditioner=jac,
                                 relaxation_factor=1.0).generate(P3)

                def streaming(its):
                    with torch.no_grad():
                        ir.replace(criterion=stop.Iteration(max_iters=its))._solve_streaming(
                            b3[:, None], z3[:, None])

                extra["streaming_us_this"] = 1e3 * cs.iter_ms(streaming, *cs.STREAM_TRIPS)
            outs = {tag: bits_of(call(tag, 300, tol3)) for tag in mods}
            plain = bits_of(ops_pc.pell_ir_solve_reference(P, b3, z3, mv, omega=omega,
                                                           tol_sq_eff=tol3, max_iters=300,
                                                           with_residual=True))
            extra["sweeps_300"] = {**{tag: o[2] for tag, o in outs.items()}, "plain": plain[2]}
            extra["bit_equal_plain"] = {tag: same(o, plain) for tag, o in outs.items()}
            extra["x_bit_equal_this"] = {tag: same(outs["this"], o) for tag, o in outs.items()}
            del outs, plain
            # bytes a sweep: the bound (the plan; x gathered once, b and
            # minv in; x out: r is used at once on the rows that form it),
            # this design's (the same: x_j's own rows are the gathered
            # lines), the parent's two passes (x, r in and out, minv, b; x
            # read again by the update)
            plan, jb = P.storage_bytes(), 4 * (mv is not None)
            nbytes = {"bound": plan + (12 + jb) * n3, "this": plan + (12 + jb) * n3,
                      "parent_design": plan + (24 + jb) * n3}
            timing_row("pell_ir_fused", case, n3, us, nbytes, extra)
        del P3, b3, z3, minv3

    if "idr_fused" in kernels:
        A1 = gt.Dia.from_matrix_data(gt.generators.poisson_2d(cs.NSIDE, dtype=np.float32),
                                     device=dev)
        n, nd = A1.shape[0], len(A1.offsets)
        b1, z1 = torch.ones(n, device=dev), torch.zeros(n, device=dev)
        data2 = gt.MatrixData.from_coo(*cs.convdiff_2d(cs.NSIDE))
        A2 = gt.Dia.from_matrix_data(data2, device=dev)
        b2 = torch.as_tensor(np.random.default_rng(cs.SEED + 7).uniform(0.5, 1.5, n)
                             .astype(np.float32), device=dev)
        tol2 = torch.full((), (cs.TOL * float(b2.norm())) ** 2, device=dev)
        for sdim in (2, 4):
            crit = [stop.Iteration(max_iters=1)]
            P1 = gt.Idr.build(criteria=crit, subspace_dim=sdim).generate(A1).P
            P2 = gt.Idr.build(criteria=crit, subspace_dim=sdim).generate(A2).P
            cs.emit({"phase": "setup", "kernel": "idr_fused", "s": sdim, "blocks": {
                tag: m["idr"].coop_grid_blocks(m["idr"]._lib(), "idr_fused_grid",
                                               (m["idr"].DTYPE_CODE[torch.float32], sdim), dev)
                for tag, m in mods.items()}})

            def call(tag, its, A=A1, P=P1, b=b1, tol=never):
                return mods[tag]["idr"].idr_fused(A.diags, A.offsets, P, b, z1, b, None,
                                                  kappa=0.7, tol_sq_eff=tol, max_iters=its)

            us = {}

            def measure(tag, call=call):
                us.setdefault(tag, []).append(1e3 * cs.iter_ms(lambda its: call(tag, its)))

            in_turns(measure, others)
            outs = {tag: bits_of(call(tag, cs.MAX_ITERS, A2, P2, b2, tol2)) for tag in mods}
            plain = bits_of(ops_idr.idr_solve_reference(A2.diags, A2.offsets, P2, b2, z1, b2, None,
                                                        kappa=0.7, tol_sq_eff=tol2,
                                                        max_iters=cs.MAX_ITERS))
            extra = {"solve_1e-6_a2": {**{tag: o[2] for tag, o in outs.items()},
                                       "plain": plain[2]},
                     "bit_equal_plain": {tag: same(o, plain) for tag, o in outs.items()},
                     "x_bit_equal_this": {tag: same(outs["this"], o) for tag, o in outs.items()}}
            del outs, plain
            diag = 4 * nd * (sdim + 2) * n  # s + 2 products read the diagonals
            nbytes = {"bound": (4 * nd + 20 * sdim + 20) * n,
                      "this": diag + 4 * n * idr_vectors(sdim, False, True),
                      "parent_design": diag + 4 * n * idr_vectors(sdim, False, False)}
            timing_row("idr_fused", f"s{sdim}", n, us, nbytes, extra)


def dia_sweep_launch(mod, kernel, dtype, dev):
    """A checkout's K17 or K14 launch where it reports one (blocks,
    threads, blocks an SM, registers), else its cooperative grid."""
    lib = mod._lib()
    code = mod.DTYPE_CODE[dtype]
    out = (ctypes.c_int * 4)()
    if kernel == "bicg_fused":
        if not hasattr(lib, "bicg_fused_config"):
            return {"blocks": mod.coop_grid_blocks(lib, "bicg_fused_grid", (code, code), dev)}
        with torch.cuda.device(dev):
            cs.check(lib.bicg_fused_config(code, code, out) == 0, "bicg_fused_config")
    else:
        if not hasattr(lib, "ir_fused_config"):
            return {"blocks": mod.coop_grid_blocks(lib, "ir_fused_grid", (code,), dev)}
        with torch.cuda.device(dev):
            cs.check(lib.ir_fused_config(code, int(kernel == "ir_smooth"), out) == 0,
                     "ir_fused_config")
    return dict(zip(("blocks", "threads", "blocks_per_sm", "registers"), out))


def bench_dia_sweeps(kernels, gt, dev, card, copy_gbs, others_pkg):
    """K17 (``ir_fused`` a sweep, ``ir_smooth`` a sweep) and K14
    (``bicg_fused`` an iteration) on path 1's ``poisson_2d(2048)`` ``Dia``
    (A1): float32 and bfloat16 diagonals, Jacobi and the Identity; build
    rows (ptxas, launches), then each case's microseconds by the slope in
    turns (others, this, this, others): solves of 200 and 1000 (K17 and
    K14), smoothings of 20 and 100 sweeps; the bytes of the bound and of
    each design; and the bits against the plain version and the other
    checkouts: the solves to 1e-6 on path 4's A2, the smoother's 20
    sweeps on A1."""
    pkgs = {"this": gt, **others_pkg}
    mods = {tag: {"ir": importlib.import_module(f"{pkg.__name__}.ops.ir"),
                  "cgs": importlib.import_module(f"{pkg.__name__}.ops.cgs")}
            for tag, pkg in pkgs.items()}
    others = [tag for tag in mods if tag != "this"]
    logs = {tag: importlib.import_module(f"{pkg.__name__}._build").BUILD_LOG
            for tag, pkg in pkgs.items()}

    def ours(name):
        return (("ir_fused_kernel" in name or "ir_smooth_kernel" in name or "bicg_fused_kernel"
                 in name) and "pell" not in name)

    A1 = gt.Dia.from_matrix_data(gt.generators.poisson_2d(cs.NSIDE, dtype=np.float32),
                                 device=dev)
    n, nd = A1.shape[0], len(A1.offsets)
    A1t = A1.conj_transpose()
    ndt = len(A1t.offsets)
    b1, z1 = torch.ones(n, device=dev), torch.zeros(n, device=dev)
    minv1 = (1.0 / A1.extract_diagonal().values.float()).contiguous()
    data2 = gt.MatrixData.from_coo(*cs.convdiff_2d(cs.NSIDE))
    A2 = gt.Dia.from_matrix_data(data2, device=dev)
    A2t = A2.conj_transpose()
    b2 = torch.as_tensor(np.random.default_rng(cs.SEED + 7).uniform(0.5, 1.5, n)
                         .astype(np.float32), device=dev)
    minv2 = (1.0 / A2.extract_diagonal().values.float()).contiguous()
    tol2 = torch.full((), (cs.TOL * float(b2.norm())) ** 2, device=dev)
    never = torch.full((), -1.0, device=dev)
    cs.emit({"phase": "build", "kernels": kernels,
             "ptxas": {tag: {k: line for lib in {LIBRARY[kern] for kern in kernels}
                             for k, line in ptxas_registers(lg[lib]["ptxas"]).items() if ours(k)}
                       for tag, lg in logs.items()},
             "launch": {tag: {f"{kern} {str(dt)[6:]}": dia_sweep_launch(
                 m["cgs" if kern == "bicg_fused" else "ir"], kern, dt, dev)
                 for kern in kernels for dt in (torch.float32, torch.bfloat16)}
                 for tag, m in mods.items()}})

    def bits(a, b):
        """x, r (and the count, the monitor and the stop flag of a solve)
        bit for bit."""
        if len(a) <= 2:
            return all(cs.bit_equal(x, y) for x, y in zip(a, b))
        return (all(cs.bit_equal(a[j], b[j]) for j in (0, 1, 3)) and int(a[2]) == int(b[2])
                and bool(a[4]) == bool(b[4]))

    def row(kernel, case, us, nbytes, extra):
        best = {tag: min(v) for tag, v in us.items()}
        cs.emit({"phase": "timing", "kernel": kernel, "case": case, "card": card, "rows": n,
                 "copy_GBps": copy_gbs, "us": us, "bytes": nbytes,
                 "bound_us": nbytes["bound"] / cs.PEAK_BYTES_S * 1e6,
                 "frac_of_copy_bound_bytes": {
                     tag: nbytes["bound"] / t / 1e3 / copy_gbs for tag, t in best.items()},
                 "frac_of_copy_own_bytes": {
                     tag: nbytes["this" if tag == "this" else "parent_design"] / t / 1e3 / copy_gbs
                     for tag, t in best.items()}, **extra})

    def timed(call, lo, hi):
        us = {}

        def measure(tag):
            us.setdefault(tag, []).append(1e3 * cs.iter_ms(lambda its: call(tag, its), lo, hi))

        in_turns(measure, others)
        return us

    cases = (("f32", A1, minv1, 1.0), ("bf16", A1.reduce_storage(), minv1, 1.0),
             ("f32 identity", A1, None, 0.2))
    if "ir_fused" in kernels:
        for case, A, mv, omega in cases:
            us = timed(lambda tag, its, A=A, mv=mv, omega=omega: mods[tag]["ir"].ir_fused(
                A.diags, A.offsets, b1, z1, mv, omega=omega, tol_sq_eff=never, max_iters=its),
                200, 1000)
            A2c = A2 if case != "bf16" else A2.reduce_storage()
            mv2 = None if mv is None else minv2
            om2 = 1.0 if mv is not None else 0.2
            outs = {tag: m["ir"].ir_fused(A2c.diags, A2c.offsets, b2, z1, mv2, omega=om2,
                                          tol_sq_eff=tol2, max_iters=cs.MAX_ITERS)
                    for tag, m in mods.items()}
            plain = mods["this"]["ir"].ir_solve_reference(A2c.diags, A2c.offsets, b2, z1, mv2,
                                                          omega=om2, tol_sq_eff=tol2,
                                                          max_iters=cs.MAX_ITERS)
            extra = {"sweeps_a2": {**{t: int(o[2]) for t, o in outs.items()},
                                   "plain": int(plain[2])},
                     "bit_equal_plain": {t: bits(o, plain) for t, o in outs.items()},
                     "bit_equal_this": {t: bits(o, outs["this"]) for t, o in outs.items()}}
            esz, jb = A.diags.element_size(), 4 * (mv is not None)
            # a sweep: the diagonals, x_j, b (and minv) in, x_{j+1} out;
            # the two-pass design: x and r in and out besides
            nbytes = {"bound": (esz * nd + 12 + jb) * n, "this": (esz * nd + 12 + jb) * n,
                      "parent_design": (esz * nd + 20 + jb) * n,
                      "bound_counted_with_r": (esz * nd + 20 + jb) * n}
            row("ir_fused", case, us, nbytes, extra)
    if "ir_smooth" in kernels:
        x0 = torch.ones_like(b1)
        for case, A, mv, omega in cases[:2]:
            for with_r in (True, False):
                us = timed(lambda tag, its, A=A, with_r=with_r: mods[tag]["ir"].ir_smooth(
                    A.diags, A.offsets, b1, x0, minv1, omega=1.0, iters=its,
                    with_residual=with_r), 20, 100)
                outs = {tag: m["ir"].ir_smooth(A.diags, A.offsets, b1, x0, minv1, omega=1.0,
                                               iters=20, with_residual=with_r)
                        for tag, m in mods.items()}
                plain = mods["this"]["ir"].ir_smooth_reference(A.diags, A.offsets, b1, x0, minv1,
                                                               omega=1.0, iters=20,
                                                               with_residual=with_r)
                keep = 2 if with_r else 1  # r of the smoother without the residual is scratch
                extra = {"bit_equal_plain": {t: bits(o[:keep], plain[:keep])
                                             for t, o in outs.items()},
                         "with_residual": with_r}
                esz = A.diags.element_size()
                nbytes = {"bound": (esz * nd + 16) * n, "this": (esz * nd + 16) * n,
                          "parent_design": (esz * nd + 24) * n}
                row("ir_smooth", f"{case} residual={with_r}", us, nbytes, extra)
    if "bicg_fused" in kernels:
        for case, A, mv in (("f32", A1, None), ("bf16", A1.reduce_storage(), None),
                            ("f32 jacobi", A1, minv1)):
            At = A.conj_transpose()
            us = timed(lambda tag, its, A=A, At=At, mv=mv: mods[tag]["cgs"].bicg_fused(
                A.diags, A.offsets, At.diags, At.offsets, b1, z1, mv, tol_sq_eff=never,
                max_iters=its), 200, 1000)
            A2c = A2 if case != "bf16" else A2.reduce_storage()
            A2ct = A2c.conj_transpose()
            mv2 = None if mv is None else minv2
            args = (A2c.diags, A2c.offsets, A2ct.diags, A2ct.offsets, b2, z1, mv2)
            outs = {tag: m["cgs"].bicg_fused(*args, tol_sq_eff=tol2, max_iters=cs.MAX_ITERS)
                    for tag, m in mods.items()}
            plain = mods["this"]["cgs"].bicg_solve_reference(*args, tol_sq_eff=tol2,
                                                             max_iters=cs.MAX_ITERS)
            extra = {"iterations_a2": {**{t: int(o[2]) for t, o in outs.items()},
                                       "plain": int(plain[2])},
                     "bit_equal_plain": {t: bits(o, plain) for t, o in outs.items()},
                     "bit_equal_this": {t: bits(o, outs["this"]) for t, o in outs.items()}}
            esz, jb = A.diags.element_size(), 4 * (mv is not None)
            diag = esz * (nd + ndt)
            # the bound: the diagonals, r, r2, p, p2, x in and out; three
            # passes (x deferred into pass 1); the design before (x in pass
            # 3, p2 re-read)
            nbytes = {"bound": (diag + 40) * n, "this": (diag + 72 + 2 * jb) * n,
                      "parent_design": (diag + 76 + 2 * jb) * n}
            row("bicg_fused", case, us, nbytes, extra)



def cgs_ilu_launch(mods, tag, kernel, dev, logs, args):
    """A checkout's K13 launch (diagonals of the given dtype) or K24 launch
    (``args`` = (A, L, U)): its own report where it has one, else its
    cooperative grid and ptxas's registers."""
    lib = mods[tag][kernel]._lib()
    mod = mods[tag][kernel]
    if kernel == "cgs":
        code = mod.DTYPE_CODE[args]
        if hasattr(lib, "cgs_fused_config"):
            out = (ctypes.c_int * 4)()
            with torch.cuda.device(dev):
                cs.check(lib.cgs_fused_config(code, out) == 0, "cgs_fused_config")
            return dict(zip(("blocks", "threads", "blocks_per_sm", "registers"), out))
        return {"blocks": mod.coop_grid_blocks(lib, "cgs_fused_grid", (code,), dev)}
    A, L, U = args
    if hasattr(mod, "bicgstab_ilu_fused_launch"):
        return mod.bicgstab_ilu_fused_launch(A, L, U, cs.SWEEPS7, cs.SWEEPS7, dev)
    codes = (mod.DTYPE_CODE[A.diags.dtype], mod.DTYPE_CODE[L.diags.dtype])
    token = ("bicgstab_ilu_fused_kernelI" + ("f" if A.diags.dtype == torch.float32 else "13")
             + ("f" if L.diags.dtype == torch.float32 else "13"))
    regs = [line for name, line in ptxas_registers(logs[tag]["trs_fused"]["ptxas"]).items()
            if token in name]
    return {"route": "barrier",
            "blocks": mod.coop_grid_blocks(lib, "bicgstab_ilu_fused_grid", codes, dev),
            "registers": regs[0].split()[1] if regs else None,
            "grid_barriers": 5 + 4 * cs.SWEEPS7}


def bench_cgs_ilu(kernels, gt, dev, card, copy_gbs, others_pkg):
    """K13 (``cgs_fused`` an iteration) on path 1's ``poisson_2d(2048)``
    ``Dia`` (A1): float32 and bfloat16 diagonals, Jacobi folded into A M;
    K24 (``bicgstab_ilu_fused`` an iteration) on path 7's ILU of path 4's
    A2 at 3 sweeps a triangle: float32, bfloat16 triangles, bfloat16 A and
    triangles.  Build rows (ptxas, launches), then each case's microseconds
    by the slope between solves of 200 and 1000 in turns (others, this,
    this, others), the bytes of the bound and of each design, and the bits
    against the plain version and the other checkouts on the solve to 1e-6
    (K13 on A2, K24 on A2 with its ILU)."""
    from ginkgo_tpu_torch.solver._fused_gate import fold_minv

    pkgs = {"this": gt, **others_pkg}
    mods = {tag: {"cgs": importlib.import_module(f"{pkg.__name__}.ops.cgs"),
                  "ilu": importlib.import_module(f"{pkg.__name__}.ops.cg_ilu")}
            for tag, pkg in pkgs.items()}
    others = [tag for tag in mods if tag != "this"]
    logs = {tag: importlib.import_module(f"{pkg.__name__}._build").BUILD_LOG
            for tag, pkg in pkgs.items()}
    s7 = cs.SWEEPS7

    def ours(name):
        return (("cgs_fused_kernel" in name and "pell" not in name)
                or "bicgstab_ilu" in name)

    t0 = time.perf_counter()
    A1 = gt.Dia.from_matrix_data(gt.generators.poisson_2d(cs.NSIDE, dtype=np.float32),
                                 device=dev)
    n, nd = A1.shape[0], len(A1.offsets)
    b1, z1 = torch.ones(n, device=dev), torch.zeros(n, device=dev)
    minv1 = (1.0 / A1.extract_diagonal().values.float()).contiguous()
    A2 = gt.Dia.from_matrix_data(gt.MatrixData.from_coo(*cs.convdiff_2d(cs.NSIDE)), device=dev)
    b2 = torch.as_tensor(np.random.default_rng(cs.SEED + 7).uniform(0.5, 1.5, n)
                         .astype(np.float32), device=dev)
    minv2 = (1.0 / A2.extract_diagonal().values.float()).contiguous()
    tol2 = torch.full((), (cs.TOL * float(b2.norm())) ** 2, device=dev)
    never = torch.full((), -1.0, device=dev)
    k24_cases = ()
    if "bicgstab_ilu_fused" in kernels:
        M2 = cs.ilu_factories(gt, "ilu").generate(A2.to_csr())
        Tl, Tu, invdl, invdu = cs._ilu_parts(M2)
        bf = torch.bfloat16
        k24_cases = (("f32", A2, Tl, Tu), ("bf16 triangles", A2, Tl.astype(bf), Tu.astype(bf)),
                     ("bf16", A2.reduce_storage(), Tl.astype(bf), Tu.astype(bf)))
    cs.emit({"phase": "setup", "rows": n, "setup_s": round(time.perf_counter() - t0, 2)})
    launch = {tag: {} for tag in mods}
    for tag in mods:
        if "cgs_fused" in kernels:
            for dt in (torch.float32, torch.bfloat16):
                launch[tag][f"cgs_fused {str(dt)[6:]}"] = cgs_ilu_launch(
                    mods, tag, "cgs", dev, logs, dt)
        for case, A, L, U in k24_cases:
            launch[tag][f"bicgstab_ilu_fused {case}"] = cgs_ilu_launch(
                mods, tag, "ilu", dev, logs, (A, L, U))
    cs.emit({"phase": "build", "kernels": kernels,
             "ptxas": {tag: {k: line for lib in {LIBRARY[kern] for kern in kernels}
                             for k, line in ptxas_registers(lg[lib]["ptxas"]).items() if ours(k)}
                       for tag, lg in logs.items()},
             "launch": launch})

    def bits(a, b):
        """x, r, the iterations, the monitor and the stop flag bit for bit."""
        return (all(cs.bit_equal(a[j], b[j]) for j in (0, 1, 3)) and int(a[2]) == int(b[2])
                and bool(a[4]) == bool(b[4]))

    def row(kernel, case, us, nbytes, extra):
        best = {tag: min(v) for tag, v in us.items()}
        cs.emit({"phase": "timing", "kernel": kernel, "case": case, "card": card, "rows": n,
                 "copy_GBps": copy_gbs, "us": us, "bytes": nbytes,
                 "bytes_per_row": {k: v / n for k, v in nbytes.items()},
                 "bound_us": nbytes["bound"] / cs.PEAK_BYTES_S * 1e6,
                 "frac_of_copy_bound_bytes": {
                     tag: nbytes["bound"] / t / 1e3 / copy_gbs for tag, t in best.items()},
                 **extra})

    def timed(call):
        us = {}

        def measure(tag):
            us.setdefault(tag, []).append(1e3 * cs.iter_ms(lambda its: call(tag, its), 200, 1000))

        in_turns(measure, others)
        return us

    def solves(run, plain):
        outs = {tag: run(tag) for tag in mods}
        want = plain()
        return {"iterations_a2": {**{t: int(o[2]) for t, o in outs.items()}, "plain": int(want[2])},
                "bit_equal_plain": {t: bits(o, want) for t, o in outs.items()},
                "bit_equal_this": {t: bits(o, outs["this"]) for t, o in outs.items()}}

    if "cgs_fused" in kernels:
        for case, A, mv in (("f32", A1, None), ("bf16", A1.reduce_storage(), None),
                            ("f32 jacobi", A1, minv1)):
            D = A.diags if mv is None else fold_minv(A, mv)
            us = timed(lambda tag, its, D=D, A=A, mv=mv: mods[tag]["cgs"].cgs_fused(
                D, A.offsets, b1, z1, mv, tol_sq_eff=never, max_iters=its))
            A2c = A2 if case != "bf16" else A2.reduce_storage()
            mv2 = None if mv is None else minv2
            args = (A2c.diags if mv2 is None else fold_minv(A2c, mv2), A2c.offsets, b2, z1, mv2)
            extra = solves(lambda tag: mods[tag]["cgs"].cgs_fused(
                *args, tol_sq_eff=tol2, max_iters=cs.MAX_ITERS),
                lambda: mods["this"]["cgs"].cgs_solve_reference(
                    *args, tol_sq_eff=tol2, max_iters=cs.MAX_ITERS))
            esz, jb = A.diags.element_size(), 4 * (mv is not None)
            # the bound: the diagonals, rr (and minv) in, x, r, q, p in and
            # out; three passes: p gathered, u and v stored and gathered; the
            # four passes before (q and w stored in a pass of their own, w
            # gathered in a fourth)
            nbytes = {"bound": (esz * nd + 36 + jb) * n, "this": (2 * esz * nd + 64 + jb) * n,
                      "four_pass_design": (2 * esz * nd + 72 + jb) * n}
            row("cgs_fused", case, us, nbytes, extra)
    for case, A, L, U in k24_cases:
        us = timed(lambda tag, its, A=A, L=L, U=U: mods[tag]["ilu"].bicgstab_ilu_fused(
            A, L, U, invdl, invdu, b2, z1, sweeps_l=s7, sweeps_u=s7, tol_sq_eff=never,
            max_iters=its))
        kw = dict(sweeps_l=s7, sweeps_u=s7, tol_sq_eff=tol2, max_iters=cs.MAX_ITERS)
        extra = solves(
            lambda tag: mods[tag]["ilu"].bicgstab_ilu_fused(A, L, U, invdl, invdu, b2, z1, **kw),
            lambda: mods["this"]["ilu"].bicgstab_ilu_reference(A, L, U, invdl, invdu, b2, z1,
                                                               **kw))
        ea, et = A.diags.element_size(), L.diags.element_size()
        nda, ndl, ndu = len(A.offsets), len(L.offsets), len(U.offsets)
        walk = launch["this"][f"bicgstab_ilu_fused {case}"]
        # the bound: the three operators' diagonals, x, r, p and v in and
        # out, rr in; the walk: four walks (step 1 stages r, p and v and
        # writes p, step 4 stages r and v and writes s), two products (the
        # diagonals, the gathered source, rr or s, the product out) and the
        # update (x in and out, y, z, s, t, rr in, r out); the barrier
        # routine: the p pass, 1 + sweeps passes a triangular solve, the two
        # products and the x and s pass and the update
        nbytes = {"bound": (ea * nda + et * (ndl + ndu) + 44) * n,
                  "barrier_routine": (16 + 2 * (24 + s7 * (et * ndl + 16) + s7 * (et * ndu + 16))
                                      + 2 * (ea * nda + 12) + 24 + 28) * n}
        if walk.get("route") == "pipelined":
            wl, wu = walk["walks"]
            blocks = walk["blocks"]
            nbytes["this"] = (walk_bytes(L, wl, s7, blocks, 3) + walk_bytes(U, wu, s7, blocks, 1)
                              + walk_bytes(L, wl, s7, blocks, 2) + walk_bytes(U, wu, s7, blocks, 1)
                              + (8 + 2 * (ea * nda + 12) + 32) * n)
        row("bicgstab_ilu_fused", case, us, nbytes, extra)

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
