#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ginkgo_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``ginkgo_tpu_torch/csrc`` (one
``nvcc`` per source, all started together) and drives the ten paths of
the port that users call:

- path 1 (slice 1): a 2-D Poisson matrix on a 2048 x 2048 grid (4,194,304
  rows, about 21M nonzeros) -> ``Dia`` -> ``Cg``/``Fcg``;
- path 2 (slice 2): the 7-point 3-D Poisson matrix on a 160^3 grid
  (4,096,000 rows, 28,518,400 nonzeros) handed over as a ``Csr`` ->
  ``Pell`` -> ``Cg``/``Fcg``;
- path 3 (slice 3): a locality-free SPD system, the JAX bench's power-law
  pattern at 2^17 rows made symmetric (a shifted graph Laplacian L + I,
  1,411,214 nonzeros), handed over as a ``Csr`` whose "auto" strategy
  takes the WELL plan -> ``Cg``; ``choose_format`` -> ``Well`` at 2^17;
  and a 32768^2 block-structured matrix -> ``choose_format`` -> ``Bell``;
- path 4 (slice 4): a nonsymmetric convection-diffusion operator on the
  2048^2 grid as ``Dia`` -> ``Bicgstab``/``Cgs``/``Bicg``/``Gmres``/
  ``CbGmres``, and ``Bicgstab`` on the Poisson matrix of path 1;
- path 5 (slice 5): the same operator with four right-hand sides ->
  ``Bicgstab``/``Gmres``/``CbGmres`` (the k-column kernels), and with one
  -> ``Idr``(2 and 4) and ``Ir``;
- path 6 (slice 6): the same operator handed over as a ``Csr`` ->
  ``Pell.from_csr`` -> ``Bicgstab``/``Cgs``/``Gmres``/``CbGmres``/``Ir``
  (the Pell whole-solve kernels), and per-iteration times on path 2's
  160^3 ``Pell``;
- path 7 (slice 7): incomplete factorizations and triangular solves:
  path 1's ``Dia`` -> ``Cg`` with ``Ic`` and with ``Ilu`` (ParIc/ParIlu,
  3 sweeps a triangle; the whole-solve kernel K23), path 4's ``Dia`` ->
  ``Bicgstab`` with ``Ilu`` (K24) and ``Gmres(30)`` with it (streaming,
  K22 per triangle), path 2's ``Csr`` -> ``Cg`` with ``Ic`` (K5 + K22), a
  ``LowerTrs`` solve (K22), and at 64^2 ``Direct`` and ``Isai`` + ``Gmres``;
  K22 and K23 on the 2048^2 triangles take the pipelined walk (no grid
  barrier in K22, four an iteration in K23), the 160^3 IC the barrier
  routine;
- path 8 (slice 8): algebraic multigrid, ``Multigrid(max_levels=12)`` (Pgm,
  FixedSmoother, Direct on 1024 coarse rows) on path 1's ``Dia`` ->
  ``Cg``/``Fcg`` + MG (the whole-solve kernel K26) and ``Multigrid.solve``
  (K27), each also through the streaming cycle (K1, K17 ``ir_smooth``), and
  on path 4's ``Dia`` -> ``Bicgstab`` + MG (K28) and ``Gmres(30)`` + MG
  (one K25 cycle per M apply);
- path 9 (slice 9): the streaming formats through their one route (the
  CSR view's PELL or WELL plan): path 2's 160^3 matrix as a ``Coo`` ->
  ``Cg`` (K5) and a 4-column apply (K6), in float32 and with bfloat16
  values, each apply bit for bit with the ``Csr`` "pallas" apply; path
  3a's power-law
  matrix as a ``Hybrid`` -> ``Cg`` (K8 on the WELL plan the route picks)
  and a 4-column apply (K9); ``Ell``, ``Sellp``, ``SparsityCsr``,
  ``Fbcsr``, ``Csr`` "sellp" and a bfloat16 ``Coo`` at 64^3 (and an
  ``Fbcsr`` of path 3b's pattern), each against its own product and
  ``Cg`` where SPD; a pattern
  the route declines; SpGEMM and SpGEAM against scipy;
- path 10 (slice 10): the reorderings, Cholesky, block Jacobi and the
  solver plumbing: ``poisson_2d(512)`` in float64 as a ``Csr`` ->
  ``Cholesky`` with the ``NestedDissection`` ordering, on the native
  up-looking kernel (``native/cholesky.cpp``, built by the host C++
  compiler at first use) -> ``Direct``, and ``Lu`` with the RCM ordering ->
  ``Direct`` at 64^2; path 1's ``Dia`` -> ``Cg`` and path 4's -> ``Gmres(30)``
  with ``Jacobi(max_block_size=8)`` (float32 and bfloat16 blocks), which
  stream through K1; ``solve_chunked`` on path 1's ``Dia`` (chunks of 500,
  and a ``Time`` limit), ``solve(loggers=[Record()])`` on the K4 route with
  a global ``Counters`` logger, ``ProfilerRange`` under ``torch.profiler``;
  ``convdiff_2d(256)`` under a seeded symmetric permutation ->
  ``ScaledReordered(Gmres(30) + Ilu, reordering=Rcm)``.

Phases, each of which raises on failure:

1. probe: versions, the card, the kernel build;
2. every kernel against its plain PyTorch version on the card, at the
   shapes of the main paths (and at small sizes, where whole solves must
   take equal iteration counts): the DIA family K1-K3 and the whole-solve
   K4 at 64^2 and 2048^2, the k-RHS whole-solve K4m at 64^2 and 2048^2,
   K4 and K4m on small banded operators that reach every branch of their
   two-pass iteration (``check_cg_edges``: fewer rows than the grid has
   threads and more, 1 and 64 diagonals, diagonals past both ends, K = 2
   to 8, a NaN b, a zero b, max_iters 0 and 1, columns that stop at
   iteration 1, FCG, implicit mode; equal iterations and per-column stop
   iterations, frozen columns bit for bit),
   the PELL SpMV/SpMM K5/K6 on poisson_3d(160) (S = 8, float32 and
   bfloat16/int8) and on an unstructured local-scatter pattern of 2^20
   rows (S = "auto" and S = 8), K5 bit for bit; K5, K10 and K11 bit for
   bit and each twice on small plans and Bells that reach every branch of
   their rings (``check_spmv_edges``: several steps a tile and none, rows
   past the last tile's end, int32 lane indices, S = 16/32, bfloat16 and
   float64 values, float64 vectors; BR = 8 to 128, K = 1 to 20, x cut
   inside a panel, not 16-byte aligned, NaN in x[0:128] with padding
   panels; K11 at 2, 3, 4, 8 and 9 columns); the Pell whole-solve K7 at
   24^3 and 160^3 (iterations, x, r and the monitor bit for bit) and on
   small Pells that reach every branch of its chunks
   (``check_pell_cg_edges``: S = 1, 3, 8 and 16, G = 4, n not a multiple
   of a chunk or a tile, 63 chunks, bfloat16 values, int32 lane indices,
   Jacobi, FCG, implicit mode, a NaN b; bit for bit);
3. main path 1: fused CG (K4) with float32 and bfloat16 diagonals and with
   Jacobi, the streaming CG route (K1), a 4-column solve (K4m) and an
   explicit streaming 4-column solve (K3), each checked against a float64
   solve and by its backward error through ``apply_advanced`` (K2);
4. main path 2: ``Csr.from_matrix_data`` ("auto" resolves to "pallas"),
   ``Cg`` on the Csr (K5 through the plan cache, one plan build), ``Pell``
   -> fused ``Cg`` (K7) with float32, bfloat16 and Jacobi, fused ``Fcg``,
   the streaming route on the Pell (K5) and a 4-column solve (K6), each
   checked against a float64 solve (K6 with float64 vectors);
5. main path 3: ``Csr`` "auto" resolves to "pallas" and the plan cache
   holds a ``Well``; ``Cg`` on the Csr (K8 through the plan cache, one
   plan build), with scalar Jacobi, and a 4-column solve (K9), each
   checked against a float64 solve (K9 with float64 vectors) and by its
   backward error (K8/K9 with float64 vectors); ``choose_format`` at 2^17
   returns a ``Well``, solved by ``Cg``; ``choose_format`` on the
   block-structured matrix returns a ``Bell``, applied to one column (K10)
   and four (K11) with float32 and bfloat16 panels and checked against a
   float64 product; then K8-K11 against their plain versions on the plans
   of the path (K8/K9 at the chosen T, at T = 1 and on the 2^17 plan cut
   into one-step chunks, K10/K11 bit for bit, each called twice for the
   same bits), with each
   plan's chunks, split supertiles and scratch bytes;
6. main path 4: the four solvers fused (K12-K15) with float32 and
   bfloat16 diagonals and with Jacobi, and streaming, each checked against
   a float64 solve of the system it solved; CbGmres "auto" (K15 with a
   bfloat16 basis) and "integer" (streaming); BiCGSTAB on the Poisson
   matrix fused and streaming (K12 on its ring route); then K12-K15
   against their plain versions on the path's matrix, with a NaN case
   each; K12 on edge operators that reach every branch of its ring route
   (``check_bicgstab_edges``: w = 0, 1, 2047 and 2048, ranges shorter than
   their halo and longer than several chunks, n not a multiple of the
   chunk, a w past the ring's limit on the five-pass kernel, the half step,
   a NaN b, bfloat16 diagonals, Jacobi, implicit mode; x, r and the
   monitor bit for bit); K14 on banded edge operators
   (``check_bicg_edges``: 1 to 7 diagonals, n below one block and past the
   grid's threads, offsets past a block's rows, bfloat16 diagonals, the
   Identity, Jacobi, implicit mode, caps of 0 and 1, a NaN b; each case
   twice, x, r and the monitor bit for bit); K13 on the same operators
   (``check_cgs_edges``, the same cases, a seeded inverse diagonal folded
   into A M; each case twice, x, r and the monitor bit for bit);
7. main path 5: on the operator of path 4, Bicgstab and Gmres(30) with
   four columns fused (K12m, K15m) with float32 and bfloat16 diagonals and
   with Jacobi, CbGmres "auto" (K15m with a bfloat16 basis) and both
   streaming, each column held against a float64 four-column solve, with
   the per-column stop iterations; Idr(2) and Idr(4) fused (K16) the same
   three ways and streaming; Ir fused (K17) with Jacobi (f32, bf16) and
   with the Identity, and streaming; then the routes that stream (k = 9
   BiCGSTAB, k = 5 GMRES, IDR(5), IR with the implicit criterion, k = 4
   CGS) at 64^2, by launch counters; then K12m, K15m, K16, K17 and the
   smoother ir_smooth against their plain versions at 64^2 and 2048^2,
   equal bit for bit, with a NaN case each; K12m on edge operators
   (``check_bicgstab_multi_edges``: w = 1, 2047 and 16000, k = 2, 3, 4
   and 8, bfloat16 diagonals, Jacobi, implicit mode, a column that stops
   early while a NaN column runs to the cap; equal iterations and stop
   iterations, x and r bit for bit, an implicit monitor within the float64
   order's bound); K15m on edge cases
   (``check_gmres_multi_edges``: 64^2 and 700^2, k = 2 to 4, m = 1, 2, 30
   and 50, a float32 and a bfloat16 basis, Jacobi, a column that stops
   inside a cycle, a NaN column; equal step counts and per-column stop
   iterations, x bit for bit); K17 on ``check_bicg_edges``'s operators
   (``check_ir_edges``: ``ir_fused`` with Jacobi and the Identity, caps of
   0, 1 and 2, a start at the solution, a NaN b; ``ir_smooth`` from zero
   and from x0, with and without the residual, 0 to 3 sweeps; float32 and
   bfloat16 diagonals, each case twice, x, r and r.r bit for bit);
8. main path 6: on path 4's operator as a ``Pell`` (S = 8, from the
   ``Csr``), Bicgstab, Cgs, Gmres(30) and Ir fused (K19, K20, K18, K21)
   with float32 and bfloat16 values and with Jacobi (IR: Jacobi with both
   value types and the Identity at 0.2), each streaming, CbGmres "auto" (K18
   with a bfloat16 basis), each held against path 4's float64 solve of the
   same system; the routes that stream on a Pell (Bicg, Idr, k = 2
   BiCGSTAB, krylov_dim 101, IR implicit) at 64^2 by launch counters; then
   K18-K21 against their plain versions on a 24^3 shifted Poisson and the
   64^2 operator (float32/bfloat16 values, int8/int32 lane indices, equal
   iterations and x bit for bit, a NaN case each, IR's zero-sweep case)
   and at 2048^2 under a cap; K15 and K18 on edge cases
   (``check_gmres_edges``: fewer tiles than blocks, n not a multiple of 4,
   m = 1, 2, 5, 30 and 100, a stop inside a cycle after a restart, a NaN
   b, a bfloat16 basis, Jacobi, bfloat16 Pell values, int32 lane indices;
   equal steps, x and the true r.r bit for bit); K21, K19 and K20 on K7's
   edge Pells (``check_pell_ir_edges``, ``check_pell_bicgstab_cgs_edges``:
   float32 and bfloat16 values, the Identity and Jacobi to the threshold,
   caps of 0, 1 and 2, a NaN b, K19's half step on 2 I, implicit mode;
   each case twice, x, r and the monitor bit for bit);
9. main path 7: ``Dia.to_csr``, ParIc and ParIlu on A1 (two ParIlu runs
   bit-identical), the IC and ILU sweep preconditioners, ``Cg`` with each
   fused (K23) and streaming (K1 + K22), ``Bicgstab`` with A2's ILU fused
   (K24 on its walk route) and streaming, ``Gmres(30)`` with it (K22),
   ``Cg`` with IC on the
   160^3 ``Csr`` (K5 + K22), one ``LowerTrs`` solve (K22), ``Direct`` and
   ``Isai`` + ``Gmres`` at 64^2, each held against a float64 solve; then
   K22-K24 against their plain versions at 24^2 and 64^2 (f32/bf16
   triangles and A, sweeps 0/1/3/8, equal iterations and x bit for bit, a
   NaN case each; K24 on both of its routes) and at 2048^2 under a cap
   (K22 bit for bit); K24 on its walk with p in a pass of its own (a 3000 x
   8 grid, bit for bit); K22 and K23
   on edge triangles that reach every branch of the walk
   (``check_trs_edges``: w = 1 to 2048, halos across many blocks, rings
   that wrap, odd n, ranges shorter than their halo and longer than
   several chunks, lower and upper
   triangles, a w past the ring limit on the barrier route; bit for bit,
   each twice), every launch's route printed;
10. main path 8: the two 12-level hierarchies (the host seconds of each
   level's aggregation and triple product, the dense coarse inverse), the
   solves above held against path 1's and path 4's float64 solves (the
   standalone solve, which stagnates, to a cap of 100 cycles, its residual
   reported); a 12-level V(1,1) cycle must take 2 L + 1 = 25 grid
   barriers (one fused restriction and one fused prolongation a level);
   then K25-K28 against their plain versions at 64^2 with V, W, F and K
   cycles, the four mid_case values, float32/bfloat16 diagonals and pass
   lists that fuse in part (``check_mg_edges``; equal iterations and x bit
   for bit, a NaN case each) and at 2048^2 under a cap, bit for bit too;
11. main path 9, as above, every product against a float64 one, every
   solve against a float64 solve, one plan build a format, the route's
   apply timed by CUDA graph beside the ``Csr`` "pallas" apply and
   torch.sparse (the applies and K5 alone on each plan, by graph, in both
   orders); then K5/K6 and K8/K9 against their plain versions on the plans
   the route built (twice each; K5, K8 and K9 bit for bit, K6 within
   1e-5);
   ``check_spmv_edges`` also holds K10 and K11 on Bells of wide row blocks
   (``BELL_WIDE``), with the form each launch must take (row totals in
   shared memory or in y);
12. main path 10, as above: the native Cholesky route asserted, the
   direct solves within 1e-10 of a scipy float64 solve, the block Jacobi
   solves streaming (K1 launches, no whole-solve kernel) beside scalar
   Jacobi's iterations and held against path 1's and path 4's float64
   solves, the chunked solve with the one-shot streaming solve's
   iterations and x within 1e-6, the ``Time`` limit stopping at the first
   chunk boundary past it, the logged events and kernel counts, the
   profiler's range names, and ScaledReordered within 1e-4 of a scipy
   float64 solve, with the bandwidth before and after RCM;
13. timings, printed and not checked: each kernel, its plain version and
   the one PyTorch call that computes the same function, by the slope
   between two trip counts (CUDA events); CG, BiCGSTAB, CGS and BiCG time
   per iteration and GMRES(30) time per Arnoldi step, fused and
   streaming; the k-column BiCGSTAB and GMRES, IDR(2), IDR(4) and IR per
   iteration, and the smoother per sweep; BiCGSTAB, CGS, IR and GMRES(30)
   on the 160^3 ``Pell``; K23 and K24 per iteration and K22 per launch
   (with its wrapper's host time a call); K22's and K23's routes;
   K25 per cycle beside the streaming cycle, K26/K28 per iteration (with
   their grid barriers an iteration) and K27 per cycle; bounds; the copy
   bandwidth; K5's and K10's launch
   (registers, shared memory a block, blocks an SM) and device time by
   kernel name (torch.profiler) in their rows.

The launch counters are set to 0 just before each main path and read just
after it; every kernel of a path must have run there.  Each phase ends
with a ``stamp`` line (seconds since the start), and a ``phases`` line
before the kernels' lists the ten slowest.  The last lines are the
kernels' JSON record, the card's name and power limit as nvidia-smi
reports them, and ``{"ok": true, ...}``.  Without a CUDA device, or
without the package beside it, the script fails and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
#: the power-law system at the size of the JAX package's multi-million-row
#: WELL figure (``well_bench.py`` times K8/K9 there), path 3a's size, and
#: the JAX bench's own size (path 3's ``choose_format``).  Path 3a runs at
#: 2^17 rows: at 2^20 its host set-up (the "auto" statistics and the WELL
#: plan) took about 143 s of the run's 900 s budget, and 2^18 gave way to
#: path 10's time (path 9's Hybrid is this matrix too).
POWERLAW_ROWS = 1 << 20
PATH3_ROWS = 1 << 17
POWERLAW_SMALL = 1 << 17
#: path 3: row blocks, rows per block, panels per block and column panels
#: of the JAX package's BELL figure (32768^2, 7.55M nonzeros)
BELL_BLOCKS = (2048, 16, 6, 256)
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
    "well_spmv": ("ginkgo_tpu_torch/csrc/well_spmv.cu", "ginkgo_tpu/ops/spmv_well.py:492"),
    "well_spmm": ("ginkgo_tpu_torch/csrc/well_spmv.cu", "ginkgo_tpu/ops/spmv_well.py:681"),
    # one CUDA kernel for both TPU sites (:221 x streamed, :183 x resident)
    "bell_spmv": ("ginkgo_tpu_torch/csrc/bell_spmv.cu", "ginkgo_tpu/ops/pallas_bell.py:221"),
    "bell_spmm": ("ginkgo_tpu_torch/csrc/bell_spmv.cu", "ginkgo_tpu/ops/pallas_bell.py:124"),
    "bicgstab_fused": ("ginkgo_tpu_torch/csrc/bicgstab_fused.cu",
                       "ginkgo_tpu/ops/pallas_bicgstab.py:536"),
    "cgs_fused": ("ginkgo_tpu_torch/csrc/cgs_fused.cu", "ginkgo_tpu/ops/pallas_cgs.py:211"),
    "bicg_fused": ("ginkgo_tpu_torch/csrc/cgs_fused.cu", "ginkgo_tpu/ops/pallas_cgs.py:428"),
    "gmres_fused": ("ginkgo_tpu_torch/csrc/gmres_fused.cu",
                    "ginkgo_tpu/ops/pallas_gmres.py:913"),
    "bicgstab_fused_multi": ("ginkgo_tpu_torch/csrc/bicgstab_fused.cu",
                             "ginkgo_tpu/ops/pallas_bicgstab.py:462"),
    "gmres_fused_multi": ("ginkgo_tpu_torch/csrc/gmres_fused.cu",
                          "ginkgo_tpu/ops/pallas_gmres.py:799"),
    "idr_fused": ("ginkgo_tpu_torch/csrc/idr_fused.cu", "ginkgo_tpu/ops/pallas_idr.py:338"),
    # one TPU site (_common_call) for both kernels of pallas_ir.py
    "ir_fused": ("ginkgo_tpu_torch/csrc/ir_fused.cu", "ginkgo_tpu/ops/pallas_ir.py:232"),
    "ir_smooth": ("ginkgo_tpu_torch/csrc/ir_fused.cu", "ginkgo_tpu/ops/pallas_ir.py:232"),
    # K18: K15's source on the Pell operator; K19-K21: kernels of their own on
    # K7's chunked rows, beside the Dia kernels
    "pell_gmres_fused": ("ginkgo_tpu_torch/csrc/gmres_fused.cu",
                         "ginkgo_tpu/ops/pallas_gmres.py:984"),
    "pell_bicgstab_fused": ("ginkgo_tpu_torch/csrc/bicgstab_fused.cu",
                            "ginkgo_tpu/ops/pallas_pell_cg.py:505"),
    "pell_cgs_fused": ("ginkgo_tpu_torch/csrc/cgs_fused.cu",
                       "ginkgo_tpu/ops/pallas_pell_cg.py:741"),
    "pell_ir_fused": ("ginkgo_tpu_torch/csrc/ir_fused.cu", "ginkgo_tpu/ops/pallas_pell_cg.py:915"),
    # K22-K24: one source, one shared sweep routine
    "trs_fused": ("ginkgo_tpu_torch/csrc/trs_fused.cu", "ginkgo_tpu/ops/pallas_trs.py:87"),
    "cg_ilu_fused": ("ginkgo_tpu_torch/csrc/trs_fused.cu", "ginkgo_tpu/ops/pallas_cg_ilu.py:268"),
    "bicgstab_ilu_fused": ("ginkgo_tpu_torch/csrc/trs_fused.cu",
                           "ginkgo_tpu/ops/pallas_cg_ilu.py:518"),
    # K25-K28: one source, one shared cycle routine
    "mg_vcycle": ("ginkgo_tpu_torch/csrc/mg_fused.cu", "ginkgo_tpu/ops/pallas_mg.py:689"),
    "mg_cg_fused": ("ginkgo_tpu_torch/csrc/mg_fused.cu", "ginkgo_tpu/ops/pallas_mg.py:925"),
    "mg_solve_fused": ("ginkgo_tpu_torch/csrc/mg_fused.cu", "ginkgo_tpu/ops/pallas_mg.py:1072"),
    "mg_bicgstab_fused": ("ginkgo_tpu_torch/csrc/mg_fused.cu",
                          "ginkgo_tpu/ops/pallas_mg.py:1349"),
}
PATH1 = ("dia_spmv", "dia_spmv_advanced", "dia_spmm", "cg_fused", "cg_fused_multi")
PATH2 = ("pell_spmv", "pell_spmm", "pell_cg_fused")
PATH3 = ("well_spmv", "well_spmm", "bell_spmv", "bell_spmm")
PATH4 = ("bicgstab_fused", "cgs_fused", "bicg_fused", "gmres_fused")
PATH5 = ("bicgstab_fused_multi", "gmres_fused_multi", "idr_fused", "ir_fused")
PATH7 = ("trs_fused", "cg_ilu_fused", "bicgstab_ilu_fused")
#: ir_smooth runs every smoothing of the streaming multigrid cycle
PATH8 = ("ir_smooth", "mg_vcycle", "mg_cg_fused", "mg_solve_fused", "mg_bicgstab_fused")
#: path 4: GMRES(30), the restart length of the JAX bench's GMRES row
KRYLOV_DIM = 30
#: path 4: BiCGSTAB's cap on the Poisson matrix, about CG's 4217 iterations
A1_BICGSTAB_CAP = 5000
#: path 6: the iteration cap of the full-width kernel-against-plain checks
CAP6 = 20
EPS32 = float(np.finfo(np.float32).eps)
#: the timings' trip counts where the default's 200 and 1000 iterations are
#: more than a figure needs: the plain versions (their times are no
#: yardstick of a kernel: a short slope serves; GMRES steps apart; 3 and 15,
#: 10 and 20 until path 9 needed the time, 2 and 8, 5 and 10 until path 10
#: did) and the host-bound streaming routes; PLAIN_SLOPE: the plain SpMV
#: and SpMM versions' calls
PLAIN_TRIPS = (1, 3)
PLAIN_GMRES_TRIPS = (2, 4)
PLAIN_SLOPE = (1, 3, 1)
STREAM_TRIPS = (25, 125)


_T0 = time.perf_counter()


def elapsed():
    """Seconds since the script started, for the budget of the run."""
    return round(time.perf_counter() - _T0, 1)


#: (phase, seconds since the start at its end), in the order of the run
_STAMPS = []


def stamp(phase):
    """Mark the end of a phase of the run: a line with the seconds since the
    start; the last lines list the slowest phases (:func:`slowest_phases`)."""
    _STAMPS.append((phase, elapsed()))
    emit({"phase": "stamp", "what": phase, "t_s": _STAMPS[-1][1]})


def slowest_phases(count=10):
    """The ``count`` phases that took longest, with their seconds."""
    spans, t_prev = [], 0.0
    for phase, t in _STAMPS:
        spans.append((round(t - t_prev, 1), phase))
        t_prev = t
    return [{"phase": p, "s": dt} for dt, p in sorted(spans, reverse=True)[:count]]


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


def device_ms(fn, kernel, calls=10):
    """Device ms per call of the kernels whose name holds ``kernel``
    (torch.profiler): the kernel's own time, which the slope of chained
    calls overstates when the host takes longer to launch a call than the
    card to run it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
             for e in prof.key_averages() if kernel in e.key)
    return us / calls / 1e3


def graph_ms(fn, calls=20, reps=5):
    """ms per call of ``fn`` replayed from a CUDA graph of ``calls`` calls
    (the best of ``reps`` replays, CUDA events): the card's time without the
    host's, which a wrapper call can exceed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    del graph
    return best


def sm_clock_mhz():
    """The card's SM clock now, in MHz (NVML through torch), or None where
    NVML cannot be read."""
    try:
        return torch.cuda.clock_rate()
    except Exception:  # no pynvml, or NVML refused: the figure is optional
        return None


def host_us(fn, calls=200):
    """Host microseconds a call takes to return (wrapper and launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


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


def accuracy(A, x, rhs, x_ref, norm_a, label, bounded=True):
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
    80 float32 epsilons).  With ``bounded=False`` the same numbers are
    measured and returned, and nothing is checked."""
    r = A.apply_advanced(-1.0, x.double(), 1.0, rhs.double())
    rn = r.norm(dim=0)
    bn = rhs.double().norm(dim=0)
    xn = x.double().norm(dim=0)
    relres = float((rn / bn).max())
    eta = float((rn / (norm_a * xn + bn)).max())
    fwd = float(((x.double() - x_ref).norm(dim=0) / x_ref.norm(dim=0)).max())
    if bounded:
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


def powerlaw_laplacian(n, seed=23):
    """The JAX bench's power-law pattern (``bench.py``, row_pell_powerlaw:
    Zipf(2.1) out-degrees + 2 capped at 64, targets u^3 * n biased to low
    ids) made symmetric, P + P^T, as a shifted graph Laplacian L + I: -1
    off the diagonal, the row's off-diagonal count + 1 on it (SPD, float32).
    Returns (shape, rows, cols, values)."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(2.1, size=n) + 2, 64)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = np.minimum((rng.random(rows.size) ** 3.0 * n).astype(np.int64), n - 1)
    off = rows != cols
    key = np.unique(np.concatenate([rows[off] * n + cols[off], cols[off] * n + rows[off]]))
    r, c = key // n, key % n
    diag = np.bincount(r, minlength=n) + 1.0
    return ((n, n), np.concatenate([r, np.arange(n)]), np.concatenate([c, np.arange(n)]),
            np.concatenate([np.full(len(r), -1.0), diag]).astype(np.float32))


def block_structured(NRB, BR, K, NPC, density=0.3, seed=7):
    """The JAX bench's block-structured pattern (``bench.py``, row_bell):
    each of NRB row blocks of BR rows fills K random 128-column panels of
    NPC at the given density; float32 values uniform in (-0.005, 0.005).
    Returns (shape, rows, cols, values)."""
    rng = np.random.default_rng(seed)
    rows_l, cols_l = [], []
    for rb in range(NRB):
        for pnl in rng.choice(NPC, size=K, replace=False):
            rr, cc = np.nonzero(rng.random((BR, 128)) < density)
            rows_l.append(rb * BR + rr)
            cols_l.append(pnl * 128 + cc)
    rows, cols = np.concatenate(rows_l), np.concatenate(cols_l)
    vals = (rng.random(len(rows)).astype(np.float32) - 0.5) * 1e-2
    return (NRB * BR, NPC * 128), rows, cols, vals


def convdiff_2d(nside):
    """One backward-Euler step of 2-D advection-diffusion on an nside^2
    grid, 5-point: diagonal 4.5, west/south -1.3, east/north -0.7 (the
    coefficients of tests/conftest.py nonsym_tridiag in 2-D plus a 0.5 mass
    shift): nonsymmetric and strictly diagonally dominant.  Returns (shape,
    rows, cols, values float32)."""
    n = nside * nside
    i = np.arange(n)
    ix, iy = i % nside, i // nside
    rows, cols, vals = [i], [i], [np.full(n, 4.5)]
    for keep, off, v in ((ix > 0, -1, -1.3), (ix < nside - 1, 1, -0.7),
                         (iy > 0, -nside, -1.3), (iy < nside - 1, nside, -0.7)):
        rows.append(i[keep])
        cols.append(i[keep] + off)
        vals.append(np.full(int(keep.sum()), v))
    return ((n, n), np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals).astype(np.float32))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main_path3(gt, dev, rng, crit, n_big=PATH3_ROWS, n_small=POWERLAW_SMALL,
               bell_blocks=BELL_BLOCKS):
    """Main path 3 through the entry points a user calls; every check
    raises.  Returns the operators that the kernel checks and the timings
    reuse."""
    from ginkgo_tpu_torch import stop
    from ginkgo_tpu_torch.ops import bell as ops_bell
    from ginkgo_tpu_torch.ops import pell as ops_pell
    from ginkgo_tpu_torch.ops import well as ops_well

    def f64_solve(A, rhs):
        """The same system solved to 1e-10 in float64 (K8/K9 with float64
        vectors on a float64 Well)."""
        t0 = time.perf_counter()
        X, info = gt.Cg.build(criteria=[stop.Iteration(max_iters=MAX_ITERS),
                                        stop.ResidualNorm(tolerance=1e-10)]
                              ).generate(A.astype(torch.float64)).solve(rhs.double())
        _sync(dev)
        check(bool(info.converged.all()), "path 3: float64 reference solve: not converged")
        return X, {"f64_iterations": info.num_iterations,
                   "f64_solve_s": round(time.perf_counter() - t0, 4)}

    # 3a: the locality-free system, handed over as a Csr
    t0 = time.perf_counter()
    data = gt.MatrixData.from_coo(*powerlaw_laplacian(n_big)).sum_duplicates()
    gen_s = time.perf_counter() - t0
    n = data.shape[0]
    t0 = time.perf_counter()
    C = gt.Csr.from_matrix_data(data, device=dev)
    _sync(dev)
    csr_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    strategy = C._resolve_strategy()
    resolve_s = time.perf_counter() - t0
    check(strategy == "pallas", f"path 3: Csr 'auto' resolved to {strategy!r}, not 'pallas'")
    norm_a = inf_norm(data)
    # (L + I) 1 = 1: a right-hand side of ones is solved at once, so the
    # one-column solves take the uniform column of the four
    B = rhs4(n, rng, dev)
    b = B[:, 1].contiguous()

    builds, k8 = ops_pell.plan_for.builds, ops_well.well_spmv.launches
    t0 = time.perf_counter()
    x, info = gt.Cg.build(criteria=crit).generate(C).solve(b)
    _sync(dev)
    solve_s = time.perf_counter() - t0
    k8 = ops_well.well_spmv.launches - k8
    check(ops_pell.plan_for.builds == builds + 1, "path 3: Cg on the Csr did not build its plan once")
    W = ops_pell.plan_for(C.row_ptrs, C.col_idxs, C.values, C.shape)
    check(isinstance(W, gt.Well), f"path 3: the plan cache holds a {type(W).__name__}, not a Well")
    check(k8 >= info.num_iterations, "path 3: Cg on the Csr did not run well_spmv once per iteration")
    check(bool(info.converged.all()), "path 3: Cg on the Csr: not converged")
    emit({"phase": "setup", "path": 3, "matrix": f"powerlaw_laplacian({n})", "rows": n,
          "nnz": data.nnz, "max_row_nnz": int(np.bincount(data.rows, minlength=n).max()),
          "norm_inf": norm_a, "generate_s": round(gen_s, 3), "csr_s": round(csr_s, 3),
          "auto_resolve_s": round(resolve_s, 3), "strategy": strategy, "T": W.T, "G": W.G,
          "NST": W.NST, "inflation": W.inflation, "cells": W.values.numel(),
          "slots": W.values.shape[0], "max_supertile_slots": int(W.tile_ptr.diff().max()),
          "plan_bytes": W.storage_bytes(), "csr_bytes_12_per_nnz": 12 * data.nnz})
    X64, ref = f64_solve(W, B)
    emit({"phase": "main_path", "path": 3, "route": "streaming", "case": "csr_f32",
          "iterations": info.num_iterations, "well_spmv_launches": k8,
          **accuracy(C, x, b, X64[:, 1], norm_a, "path 3: Cg on the Csr"),
          "solve_s_with_plan_build": round(solve_s, 4), **ref})

    t0 = time.perf_counter()
    x, info = gt.Cg.build(criteria=crit, preconditioner=gt.Jacobi.build(max_block_size=1)
                          ).generate(C).solve(b)
    _sync(dev)
    check(bool(info.converged.all()), "path 3: Cg with Jacobi on the Csr: not converged")
    emit({"phase": "main_path", "path": 3, "route": "streaming", "case": "csr_f32_jacobi",
          "iterations": info.num_iterations,
          **accuracy(C, x, b, X64[:, 1], norm_a, "path 3: Cg with Jacobi on the Csr"),
          "solve_s": round(time.perf_counter() - t0, 4)})

    k9 = ops_well.well_spmm.launches
    t0 = time.perf_counter()
    X, minfo = gt.Cg.build(criteria=crit).generate(C).solve(B)
    _sync(dev)
    k9 = ops_well.well_spmm.launches - k9
    check(k9 >= minfo.num_iterations, "path 3: the k=4 solve did not run well_spmm once per iteration")
    check(bool(minfo.converged.all()), f"path 3: k=4 solve: converged {minfo.converged.tolist()}")
    emit({"phase": "main_path", "path": 3, "route": "streaming", "case": "csr_f32_k4",
          "iterations": minfo.num_iterations, "well_spmm_launches": k9,
          **accuracy(C, X, B, X64, norm_a, "path 3: k=4 solve on the Csr"),
          "solve_s": round(time.perf_counter() - t0, 4)})
    del X64, X

    # choose_format on the same pattern at the JAX bench's size
    t0 = time.perf_counter()
    data_s = gt.MatrixData.from_coo(*powerlaw_laplacian(n_small)).sum_duplicates()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    Ws = gt.choose_format(data_s, device=dev)
    _sync(dev)
    choose_s = time.perf_counter() - t0
    check(isinstance(Ws, gt.Well), f"path 3: choose_format({n_small}) gave a {type(Ws).__name__}")
    bs = torch.as_tensor(rng.uniform(0.5, 1.5, n_small).astype(np.float32), device=dev)
    x64, ref = f64_solve(Ws, bs)
    t0 = time.perf_counter()
    x, info = gt.Cg.build(criteria=crit).generate(Ws).solve(bs)
    _sync(dev)
    check(bool(info.converged.all()), "path 3: Cg on the Well: not converged")
    emit({"phase": "main_path", "path": 3, "route": "streaming", "case": "choose_format_well",
          "rows": n_small, "nnz": data_s.nnz, "generate_s": round(gen_s, 3),
          "choose_format_s": round(choose_s, 3), "T": Ws.T, "G": Ws.G, "inflation": Ws.inflation,
          "iterations": info.num_iterations,
          **accuracy(Ws, x, bs, x64, inf_norm(data_s), "path 3: Cg on the Well"),
          "solve_s": round(time.perf_counter() - t0, 4), **ref})

    # 3b: the block-structured matrix
    t0 = time.perf_counter()
    data_b = gt.MatrixData.from_coo(*block_structured(*bell_blocks)).sum_duplicates()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    Bop = gt.choose_format(data_b, device=dev)
    _sync(dev)
    choose_s = time.perf_counter() - t0
    check(isinstance(Bop, gt.Bell), f"path 3: choose_format gave a {type(Bop).__name__}, not a Bell")
    Cb = gt.Csr.from_matrix_data(data_b, device=dev)
    m = data_b.shape[1]
    xb = torch.as_tensor(rng.standard_normal(m).astype(np.float32), device=dev)
    Xb = torch.as_tensor(rng.standard_normal((m, 4)).astype(np.float32), device=dev)
    K = Bop.values.shape[1]
    row = {"phase": "main_path", "path": 3, "case": "choose_format_bell",
           "matrix": f"block_structured{bell_blocks}", "shape": list(data_b.shape),
           "nnz": data_b.nnz, "generate_s": round(gen_s, 3), "choose_format_s": round(choose_s, 3),
           "block_rows": Bop.block_rows, "K": K, "storage_inflation": Bop.storage_inflation()}
    for label, Bv in (("f32", Bop), ("bf16", Bop.reduce_storage())):
        # the float64 product of the same CSR with the values as the panels
        # store them (a library call, as a check only)
        vals = Cb.values.to(Bv.dtype).double()
        lib64 = torch.sparse_csr_tensor(Cb.row_ptrs, Cb.col_idxs, vals, size=Cb.shape)
        abs64 = torch.sparse_csr_tensor(Cb.row_ptrs, Cb.col_idxs, vals.abs(), size=Cb.shape)
        k10, k11 = ops_bell.bell_spmv.launches, ops_bell.bell_spmm.launches
        y, Y = Bv.apply(xb), Bv.apply(Xb)
        _sync(dev)
        check(ops_bell.bell_spmv.launches == k10 + 1 and ops_bell.bell_spmm.launches == k11 + 1,
              f"path 3: Bell {label} apply did not run bell_spmv and bell_spmm")
        for case, got, v in (("k1", y[:, None], xb[:, None]), ("k4", Y, Xb)):
            want = lib64 @ v.double()
            # a row's 128 * K float32 products and sums against the exact
            # product: at most 128 * K * eps32 * (|A| |x|)
            slack = 128 * K * EPS32 * (abs64 @ v.double().abs())
            err = (got.double() - want).abs()
            check(bool(torch.isfinite(got).all()) and bool((err <= slack).all()),
                  f"path 3: Bell {label} {case} differs from the float64 product")
            row[f"{label}_{case}_max_abs_err_vs_f64"] = float(err.max())
            row[f"{label}_{case}_err_over_bound"] = float((err / slack.clamp_min(1e-300)).max())
    emit(row)
    return {"C": C, "W": W, "data": data, "b": b, "data_s": data_s, "Ws": Ws, "Bop": Bop,
            "Cb": Cb}


def check_path3_kernels(gt, dev, rng, p3, record_err):
    """K8-K11 against their plain versions on the plans of path 3: K8/K9 at
    the chosen T (path 3a's rows, float32 and float64 vectors, the hub row's
    supertile split into chunks; 2^17 rows), at T = 1 (2^17 rows, forced)
    and on the 2^17 plan with one G-slot step a chunk (every supertile
    split), each called twice; K10/K11 with float32 and bfloat16 panels,
    each called twice.  Kernel and plain version walk the same work list in
    the same order: equal bit for bit is expected, 1e-5 (float32) or 1e-12
    (float64) relative is required (K10 and K11: the same bits), and two
    calls must give the same bits."""
    from ginkgo_tpu_torch.ops import bell as ops_bell
    from ginkgo_tpu_torch.ops import well as ops_well

    def pair_check(label, A, pairs, vec, twice=False):
        x = torch.as_tensor(rng.standard_normal(A.shape[1]), dtype=vec, device=dev)
        X = torch.as_tensor(rng.standard_normal((A.shape[1], 4)), dtype=vec, device=dev)
        tol = 1e-12 if vec == torch.float64 else 1e-5
        row = {"phase": "kernel_check", "matrix": label, "values": str(A.dtype),
               "vectors": str(vec)}
        for (name, kern, plain), v in zip(pairs, (x, X)):
            t0 = time.perf_counter()
            got = kern(A, v)
            _sync(dev)
            k_s = time.perf_counter() - t0
            want = plain(A, v)
            err = record_err(name, got, want)
            # K10 and K11 keep their plain versions' summation order: the
            # same bits
            same = bit_equal(got, want) if name.startswith("bell_") else torch.allclose(
                got, want, rtol=tol, atol=tol)
            check(same, f"{name} differs from its plain version ({label}, {A.dtype}, {vec}): {err}")
            row[name + "_max_abs_err"] = err
            row[name + "_bit_equal"] = bool(torch.equal(got, want))
            row[name + "_first_call_s"] = round(k_s, 4)
            if twice:
                again = kern(A, v)
                same = bool(torch.equal(got.view(torch.uint8), again.view(torch.uint8)))
                check(same, f"{name}: two calls gave different bits ({label}, {vec})")
                row[name + "_repeat_bit_equal"] = same
        return row

    def well_pairs(chunk):
        return (("well_spmv", lambda A, v: ops_well.well_spmv(A, v, chunk),
                 lambda A, v: ops_well.well_spmv_reference(A, v, chunk)),
                ("well_spmm", lambda A, v: ops_well.well_spmm(A, v, chunk),
                 lambda A, v: ops_well.well_spmm_reference(A, v, chunk)))

    bell_pairs = (("bell_spmv", ops_bell.bell_spmv, ops_bell.bell_spmv_reference),
                  ("bell_spmm", ops_bell.bell_spmm, ops_bell.bell_spmm_reference))
    W, Ws = p3["W"], p3["Ws"]
    t0 = time.perf_counter()
    W1 = gt.Well.from_csr(gt.Csr.from_matrix_data(p3["data_s"], device=dev), T=1)
    t1_s = time.perf_counter() - t0
    default = ops_well.CHUNK_SLOTS
    for label, A, vec, chunk in (
            (f"powerlaw_laplacian({W.shape[0]}), T = {W.T}", W, torch.float32, default),
            (f"powerlaw_laplacian({W.shape[0]}), T = {W.T}", W, torch.float64, default),
            (f"powerlaw_laplacian({Ws.shape[0]}), T = {Ws.T}", Ws, torch.float32, default),
            (f"powerlaw_laplacian({W1.shape[0]}), T = 1", W1, torch.float32, default),
            (f"powerlaw_laplacian({Ws.shape[0]}), T = {Ws.T}, chunk = G", Ws, torch.float32,
             Ws.G)):
        ch = ops_well.chunk_list(A, chunk)
        if chunk != default:
            check(len(ch.fold) == A.tile_ptr.shape[0] - 1,
                  f"path 3: a {chunk}-slot chunk left a supertile whole ({label})")
        row = pair_check(label, A, well_pairs(chunk), vec, twice=True)
        row.update({"T": A.T, "G": A.G, "inflation": A.inflation, "cells": A.values.numel(),
                    **chunk_figures(A, ch, vec)})
        if A is W1:
            row["plan_s"] = round(t1_s, 3)
        emit(row)
    del W1
    for Bv in (p3["Bop"], p3["Bop"].reduce_storage()):
        emit(pair_check(f"block_structured{BELL_BLOCKS}", Bv, bell_pairs, torch.float32,
                        twice=True))


def chunk_figures(A, ch, vec):
    """The K8/K9 work list of plan A and the scratch its partials take."""
    from ginkgo_tpu_torch.ops.well import TILE_ROWS

    part = ch.n_parts * A.T * TILE_ROWS * torch.empty((), dtype=vec).element_size()
    return {"chunk_slots": ch.slots, "chunks": len(ch.work), "split_supertiles": len(ch.fold),
            "max_supertile_slots": int(A.tile_ptr.diff().max()), "partials": ch.n_parts,
            "scratch_bytes_k1": part, "scratch_bytes_k4": 4 * part}


def bit_equal(a, b):
    """The same dtype, shape and bits, NaN where the other has NaN (NaN
    payloads aside): +0.0 and -0.0 differ."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    na, nb = a.isnan(), b.isnan()
    if not torch.equal(na, nb):
        return False
    as_int = torch.int64 if a.element_size() == 8 else torch.int32
    return torch.equal(a.masked_fill(na, 0).view(as_int), b.masked_fill(nb, 0).view(as_int))


def without_tile(P, t):
    """Pell P with the slots of tile t taken out: a tile with no slots,
    whose rows K5 writes as 0 (the planners give every tile a step)."""
    tp = P.tile_ptr.cpu().to(torch.int64)
    a, b = int(tp[t]), int(tp[t + 1])
    keep = torch.cat([torch.arange(a), torch.arange(b, P.values.shape[0])]).to(P.values.device)
    tile_ptr = torch.cat([tp[:t + 1], tp[t + 1:] - (b - a)]).to(torch.int32)
    return dataclasses.replace(P, values=P.values[keep], qidx=P.qidx[keep], bases=P.bases[keep],
                               tile_ptr=tile_ptr.to(P.values.device),
                               n_steps=P.n_steps - (b - a) // P.G)


def with_padding_panel(shape, rows, cols, vals, BR):
    """The pattern plus one more panel in row block 0, so that every other
    row block gets a padding panel (id 0, zero values)."""
    taken = set((cols[rows < BR] // 128).tolist())
    extra = min(set(range(shape[1] // 128)) - taken)
    r = np.arange(BR)
    return (shape, np.concatenate([rows, r]), np.concatenate([cols, extra * 128 + r]),
            np.concatenate([vals, np.ones(BR, np.float32)]))


def pell_edge_plans(gt, dev):
    """Small Pell plans that reach every branch of K5's ring: label ->
    Pell (float32 values)."""
    p13 = gt.Csr.from_matrix_data(gt.generators.poisson_3d(13, dtype=np.float32), device=dev)
    sc = gt.Csr.from_matrix_data(gt.generators.local_scatter(1 << 16), device=dev)
    rng = np.random.default_rng(3)
    rr = np.repeat(np.arange(3000), 7)
    cc = np.clip((rr * 0.7).astype(np.int64) + rng.integers(-300, 300, rr.size), 0, 2099)
    rect = gt.Csr.from_matrix_data(gt.MatrixData.from_coo(
        (3000, 2100), rr, cc, rng.standard_normal(rr.size).astype(np.float32)).sum_duplicates(),
        device=dev)
    P13 = gt.Pell.from_csr(p13)
    return {
        # 2197 rows: the last tile is partly past n_rows
        "poisson_3d(13), S = 8, int8": P13,
        "poisson_3d(13), S = 16, int32": gt.Pell.from_csr(p13, S=16, q_dtype=np.int32),
        "poisson_3d(13), tile 1 without slots": without_tile(P13, 1),
        # several G-slot steps a tile; G = 64 spans four stages a step
        "local_scatter(2^16), G = 4": gt.Pell.from_csr(sc, G=4),
        "local_scatter(2^16), S = auto, G = 64, int32": gt.Pell.from_csr(sc, S="auto", G=64,
                                                                          q_dtype=np.int32),
        "3000 x 2100, S = 32": gt.Pell.from_csr(rect, S=32),
    }


def bell_edge_operators(gt, dev):
    """Small Bells that reach every branch of K10's ring: label -> Bell
    (float32 panels)."""
    out = {}
    for NRB, gBR, K, NPC, n_cols, BR in (
            (64, 8, 6, 40, None, 8),           # path 3b's BR and K
            (40, 16, 3, 30, 30 * 128 - 75, 16),  # x cut inside a 16-byte piece
            (20, 32, 5, 20, None, 32),
            (50, 8, 1, 30, None, 8),           # K = 1
            (9, 24, 4, 12, None, 24),          # BR divides no stage, nor a stage BR
            (4, 128, 2, 12, None, 128),        # a panel spans two stages
            (30, 16, 20, 40, None, 8)):        # a row block spans three stages
        shape, r, c, v = block_structured(NRB, gBR, K, NPC)
        if n_cols is not None:
            keep = c < n_cols
            shape, r, c, v = (shape[0], n_cols), r[keep], c[keep], v[keep]
        data = gt.MatrixData.from_coo(shape, r, c, v).sum_duplicates()
        out[f"block_structured({NRB}, {gBR}, {K}, {NPC}), {shape[0]} x {shape[1]}, BR = {BR}"] = (
            gt.Bell.from_matrix_data(data, block_rows=BR, device=dev))
    shape, r, c, v = block_structured(33, 8, 4, 24)
    keep = r < 33 * 8 - 5  # n_rows not a multiple of BR
    shape, r, c, v = with_padding_panel((33 * 8 - 5, shape[1]), r[keep], c[keep], v[keep], 8)
    out["block_structured(33, 8, 4, 24), 259 rows, padding panels"] = gt.Bell.from_matrix_data(
        gt.MatrixData.from_coo(shape, r, c, v).sum_duplicates(), block_rows=8, device=dev)
    return out


#: the column counts K11 is checked at on the edge Bells: one launch of
#: 2, 3, 4 (16-byte rows) and 8 columns, and 9 in two launches (8 and 1)
BELL_EDGE_COLUMNS = (2, 3, 4, 8, 9)
#: wide row blocks, whose running totals do not all fit a block's shared
#: memory beside the ring: (row blocks, block_rows, panels a row block,
#: column panels, the cases checked: (column count, None for K10; 1 where
#: the totals must live in y (Y) with float32 panels; the same with
#: bfloat16 panels)).  The shared totals' form takes (2 R + BR) KC floats
#: beside K11's ring and (64 + BR) floats beside K10's (a 102,960-byte ring
#: in float32, 53,808 in bfloat16), against 232,448 bytes a block: K11 at 8
#: columns keeps its totals in Y from 8192 rows in both dtypes, K10 in y
#: from 32,768 rows in float32 and from 49,152 in bfloat16.  Few row
#: blocks keep the panels under 1 GB
BELL_WIDE = ((3, 8192, 4, 16, ((None, 0, 0), (4, 0, 0), (8, 1, 1), (9, 1, 1))),
             (2, 32768, 2, 8, ((None, 1, 0),)),
             (2, 49152, 2, 8, ((None, 1, 1),)))


def bell_wide_operators(gt, dev):
    """Bells at the block_rows of ``BELL_WIDE``, n_rows 5 short of whole
    row blocks and a padding panel in every row block but the first."""
    out = {}
    for NRB, BR, K, NPC, cols in BELL_WIDE:
        shape, r, c, v = block_structured(NRB, BR, K, NPC, seed=11)
        keep = r < NRB * BR - 5
        r, c, v = r[keep], c[keep], v[keep]
        # one more panel in row block 0, one entry a row
        extra = min(set(range(NPC)) - set((c[r < BR] // 128).tolist()))
        pr = np.arange(BR)
        r, c = np.concatenate([r, pr]), np.concatenate([c, extra * 128 + pr % 128])
        v = np.concatenate([v, np.ones(BR, np.float32)])
        shape = (NRB * BR - 5, shape[1])
        out[f"block_structured({NRB}, {BR}, {K}, {NPC}), padding panels"] = (
            gt.Bell.from_matrix_data(gt.MatrixData.from_coo(shape, r, c, v).sum_duplicates(),
                                     block_rows=BR, device=dev), cols)
    return out


def check_bell_wide(gt, dev, record_err=None):
    """K10 and K11 on ``bell_wide_operators`` against their plain versions,
    bit for bit and twice each, float32 and bfloat16 panels, with each
    launch's shared bytes a block and where its row totals live, which must
    be where ``BELL_WIDE`` says.  Returns the rows it emitted."""
    from ginkgo_tpu_torch.ops import bell as ops_bell

    gen = np.random.default_rng(SEED + 21)
    rows = []
    for label, (B, columns) in bell_wide_operators(gt, dev).items():
        for j, Bv in enumerate((B, B.reduce_storage())):
            for k, *forms in columns:
                shape = (B.shape[1],) if k is None else (B.shape[1], k)
                x = torch.as_tensor(gen.standard_normal(shape).astype(np.float32), device=dev)
                name = "bell_spmv" if k is None else "bell_spmm"
                kern = getattr(ops_bell, name)
                got, again = kern(Bv, x), kern(Bv, x)
                want = getattr(ops_bell, name + "_reference")(Bv, x)
                _sync(dev)
                if record_err is not None:
                    record_err(name, got, want)
                what = f"{name} on {label}, BR = {B.block_rows}, {Bv.values.dtype}, k = {k or 1}"
                check(bit_equal(got, want), f"{what}: differs from its plain version")
                check(bit_equal(got, again), f"{what}: two calls gave different bits")
                launch = (ops_bell.spmv_launch(Bv) if k is None
                          else ops_bell.spmm_launch(Bv, k))
                check(launch["global_totals"] == forms[j],
                      f"{what}: the launch keeps its totals in "
                      f"{'y' if launch['global_totals'] else 'shared memory'}")
                rows.append({"phase": "kernel_check", "kernel": name, "matrix": label,
                             "shape": list(B.shape), "BR": B.block_rows,
                             "K": B.values.shape[1], "values": str(Bv.values.dtype),
                             "columns": k or 1, "smem_bytes": launch["smem_bytes"],
                             "global_totals": launch["global_totals"],
                             "blocks": launch["blocks"], "bit_equal": True,
                             "repeat_bit_equal": True})
                emit(rows[-1])
        del B
    return rows


def check_spmv_edges(gt, dev, rng, record_err=None):
    """K5, K10 and K11 against their plain versions, bit for bit, on the
    plans and Bells of ``pell_edge_plans`` and ``bell_edge_operators``: K5
    with float32, bfloat16 and float64 values and float32 and float64
    vectors, K10 and K11 (at ``BELL_EDGE_COLUMNS``) with float32 and
    bfloat16 panels and an x or X that is 16-byte aligned and one that
    starts a float past an aligned start; x and X hold NaN, Inf and -0.0
    (and in the unaligned case a NaN in row 3, which reaches every padding
    panel).  Each kernel is called twice and must give the same bits.  Then
    ``check_bell_wide``: K10 and K11 on Bells of wide row blocks.  Returns
    the rows it emitted."""
    from ginkgo_tpu_torch.ops import bell as ops_bell
    from ginkgo_tpu_torch.ops import pell as ops_pell

    def vector(n, dtype, offset=0, k=None, gen=rng):
        shape = (n,) if k is None else (n, k)
        base = torch.empty(n * (k or 1) + offset, dtype=dtype, device=dev)
        x = base[offset:].view(shape)
        x.copy_(torch.as_tensor(gen.standard_normal(shape), dtype=dtype))
        flat, m = x.view(-1), x.numel()
        flat[torch.as_tensor(gen.integers(0, m, 3), device=dev)] = float("nan")
        flat[torch.as_tensor(gen.integers(0, m, 2), device=dev)] = float("-inf")
        flat[torch.as_tensor(gen.integers(0, m, 3), device=dev)] = -0.0
        return x

    def run(name, kern, plain, A, x, label):
        got, again = kern(A, x), kern(A, x)
        want = plain(A, x)
        _sync(dev)
        if record_err is not None:
            record_err(name, got.nan_to_num(), want.nan_to_num())
        check(bit_equal(got, want), f"{name} differs from its plain version ({label})")
        check(bit_equal(got, again), f"{name}: two calls gave different bits ({label})")

    rows = []
    for label, P in pell_edge_plans(gt, dev).items():
        n_cases = 0
        for vals in (torch.float32, torch.bfloat16, torch.float64):
            Pv = P.astype(vals)
            for vec in (torch.float32, torch.float64):
                run("pell_spmv", ops_pell.pell_spmv, ops_pell.pell_spmv_reference, Pv,
                    vector(P.shape[1], vec), f"{label}, {vals}, {vec}")
                n_cases += 1
        tiles = P.tile_ptr.diff()
        rows.append({"phase": "kernel_check", "kernel": "pell_spmv", "matrix": label,
                     "shape": list(P.shape), "S": P.S, "G": P.G, "qidx": str(P.qidx.dtype),
                     "steps_per_tile_max": int(tiles.max()) // P.G,
                     "empty_tiles": int((tiles == 0).sum()), "cases": n_cases,
                     "bit_equal": True, "repeat_bit_equal": True})
        emit(rows[-1])
    # K11's X from a generator of its own, so that the caller's draws stay
    # as they were before K11 was checked here
    gen_k11 = np.random.default_rng(SEED + 20)
    for label, B in bell_edge_operators(gt, dev).items():
        n_cases = {"bell_spmv": 0, "bell_spmm": 0}
        for Bv in (B, B.reduce_storage()):
            for offset in (0, 1):  # a view one float past an aligned start
                for k in (None,) + BELL_EDGE_COLUMNS:
                    x = vector(B.shape[1], torch.float32, offset, k, rng if k is None else gen_k11)
                    if offset:
                        x[3] = float("nan")  # every padding panel reads it
                    name = "bell_spmv" if k is None else "bell_spmm"
                    run(name, getattr(ops_bell, name), getattr(ops_bell, name + "_reference"),
                        Bv, x, f"{label}, {Bv.values.dtype}, x offset {offset}, k = {k or 1}")
                    n_cases[name] += 1
        for name, n in n_cases.items():
            rows.append({"phase": "kernel_check", "kernel": name, "matrix": label,
                         "shape": list(B.shape), "BR": B.block_rows, "K": B.values.shape[1],
                         "padding_panels": int((B.panel_valid == 0).sum()), "cases": n,
                         "bit_equal": True, "repeat_bit_equal": True})
            if name == "bell_spmm":
                rows[-1]["columns"] = list(BELL_EDGE_COLUMNS)
            emit(rows[-1])
    return rows + check_bell_wide(gt, dev, record_err)


def cg_edge_operators(dev):
    """Small SPD banded operators as (nd, n) float32 diagonals and offsets,
    every padding slot (a row whose column falls outside [0, n)) NaN, so a
    read past either end shows: a tridiagonal one at n = 1000 (fewer rows
    than the grid has threads, not a multiple of 256) and at n = 250,001
    (more), each with two diagonals past both ends; one diagonal at n =
    777; 64 diagonals (0, +-1..+-31, and one past the end) at n = 3000."""
    rng = np.random.default_rng(SEED + 11)

    def build(n, coeffs, past=()):
        """coeffs: {offset > 0: value} of a symmetric Toeplitz band, a
        diagonal made dominant with a random part; past: offsets with no
        column in range."""
        offs = [0] + [s * o for o in sorted(coeffs) for s in (-1, 1)] + list(past)
        D = np.zeros((len(offs), n), np.float32)
        D[0] = 1.0 + 2.0 * sum(abs(c) for c in coeffs.values()) + rng.uniform(0, 1, n)
        for d, o in enumerate(offs[1:], 1):
            D[d] = coeffs.get(abs(o), 0.0)
        rows = np.arange(n)
        for d, o in enumerate(offs):
            D[d, (rows + o < 0) | (rows + o >= n)] = np.nan
        return torch.as_tensor(D, device=dev), tuple(offs)

    return {
        "tridiagonal(1000)": build(1000, {1: -1.0}, past=(-1000, 1003)),
        "tridiagonal(250001)": build(250001, {1: -1.0}, past=(-250001, 250001)),
        "diagonal(777)": build(777, {}),
        "band64(3000)": build(3000, {o: -0.5 / o for o in range(1, 32)}, past=(3002,)),
    }


def check_cg_edges(gt, dev, rng, record_err=None):
    """K4 and K4m against their plain versions on ``cg_edge_operators``,
    with float32 and bfloat16 diagonals: K4 with Identity and Jacobi, CG and
    FCG, exact and implicit; a NaN in b (both run to the cap), a zero b
    (rho = 0), max_iters 0 and 1, a threshold that stops the solve at
    iteration 1.  K4m with K = 2 to 8 columns of these kinds, in turn:
    random, stopped at iteration 1, zero, NaN (runs to the cap), random,
    a negative threshold (runs to the cap), random, stopped at 1; the four
    modes each, and max_iters 0 and 1.  Each case must take the plain
    version's iterations (K4m: and per-column stop iterations and stop
    flags), hold every frozen column bit for bit, and x within 1e-5.
    Returns the rows it emitted."""
    from ginkgo_tpu_torch.ops import cg as ops_cg

    cap = 60
    modes = [(pre, flex, imp) for pre in ("identity", "jacobi") for flex in (False, True)
             for imp in (False, True)]

    def compare(name, got, want, label):
        _sync(dev)
        kx, pxx = got[0], want[0]
        if record_err is not None:
            record_err(name, kx.nan_to_num(), pxx.nan_to_num())
        kit, pit = int(got[2]), int(want[2])
        check(kit == pit, f"{name} {label}: {kit} vs {pit} iterations")
        check(bool(torch.equal(got[4], want[4])), f"{name} {label}: stop flags differ")
        if name == "cg_fused_multi":
            kitc, pitc = got[5].tolist(), want[5].tolist()
            check(kitc == pitc, f"{name} {label}: per-column iterations {kitc} vs {pitc}")
            for c in range(kx.shape[1]):
                if pitc[c] < pit:
                    check(bit_equal(kx[:, c], pxx[:, c]), f"{name} {label}: frozen column {c} differs")
        check(torch.allclose(kx, pxx, rtol=1e-5, atol=1e-5, equal_nan=True),
              f"{name} {label}: x differs by {float((kx - pxx).abs().nan_to_num().max())}")
        return kit

    def columns(n, k):
        """(n, k) right-hand sides and their squared thresholds."""
        B = torch.as_tensor(rng.uniform(0.5, 1.5, (n, k)).astype(np.float32), device=dev)
        tol = ((TOL * B.double().norm(dim=0)) ** 2).float()
        for c in range(k):
            kind = c % 8
            if kind in (1, 7):
                tol[c] = 1e30
            elif kind == 2:
                B[:, c] = 0.0
                tol[c] = 0.0
            elif kind == 3:
                B[n // 3, c] = float("nan")
            elif kind == 5:
                tol[c] = -1.0
        return B, tol

    rows = []
    for label, (D32, offs) in cg_edge_operators(dev).items():
        n = D32.shape[1]
        diag = D32[offs.index(0)]
        for D in (D32, D32.to(torch.bfloat16)):
            minv = {"identity": None, "jacobi": 1.0 / diag.to(D.dtype).float()}
            b = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
            z = torch.zeros_like(b)
            tol = torch.full((1,), (TOL * float(b.double().norm())) ** 2, device=dev)
            iters = {}
            cases = [(f"{pre}{' fcg' if flex else ''}{' implicit' if imp else ''}",
                      b, minv[pre], tol, MAX_ITERS, flex, imp) for pre, flex, imp in modes]
            nan_b = b.clone()
            nan_b[n // 2] = float("nan")
            cases += [("nan b", nan_b, None, tol, cap, False, False),
                      ("zero b", z, None, torch.zeros(1, device=dev), MAX_ITERS, False, False),
                      ("max_iters 0", b, None, tol, 0, False, False),
                      ("max_iters 1", b, minv["jacobi"], tol, 1, True, False),
                      ("stops at 1", b, None, torch.full((1,), 1e30, device=dev), MAX_ITERS,
                       False, False)]
            for what, rhs, mv, t, its, flex, imp in cases:
                kw = dict(tol_sq_eff=t, max_iters=its, use_implicit=imp, flexible=flex)
                kout = ops_cg.cg_fused(D, offs, rhs, z, mv, **kw)
                pout = ops_cg.cg_solve_reference(D, offs, rhs, z, mv, **kw)
                iters[what] = compare("cg_fused", kout, pout, f"{label} {D.dtype} {what}")
            check(iters["nan b"] == cap and iters["zero b"] == 1 and iters["max_iters 0"] == 0
                  and iters["max_iters 1"] == 1 and iters["stops at 1"] == 1,
                  f"cg_fused {label}: edge iterations {iters}")
            multi = {}
            if label in ("tridiagonal(1000)", "band64(3000)") or D.dtype == torch.float32:
                for k in range(2, 9):
                    B, tk = columns(n, k)
                    Z = torch.zeros_like(B)
                    for pre, flex, imp in modes[::3] + [modes[5]]:
                        kw = dict(tol_sq_eff=tk, max_iters=cap, use_implicit=imp, flexible=flex)
                        what = f"k={k} {pre}{' fcg' if flex else ''}{' implicit' if imp else ''}"
                        kout = ops_cg.cg_fused_multi(D, offs, B, Z, minv[pre], **kw)
                        pout = ops_cg.cg_multi_solve_reference(D, offs, B, Z, minv[pre], **kw)
                        multi[what] = compare("cg_fused_multi", kout, pout,
                                              f"{label} {D.dtype} {what}")
                    check(k < 4 or multi[what] == cap,
                          f"cg_fused_multi {label}: k={k} with a NaN column stopped early")
                B, tk = columns(n, 4)
                for its in (0, 1):
                    kw = dict(tol_sq_eff=tk, max_iters=its)
                    multi[f"max_iters {its}"] = compare(
                        "cg_fused_multi", ops_cg.cg_fused_multi(D, offs, B, torch.zeros_like(B), **kw),
                        ops_cg.cg_multi_solve_reference(D, offs, B, torch.zeros_like(B), **kw),
                        f"{label} {D.dtype} max_iters {its}")
            rows.append({"phase": "kernel_check", "kernels": ["cg_fused", "cg_fused_multi"],
                         "matrix": label, "diagonals": str(D.dtype), "rows": n, "nd": len(offs),
                         "iterations": iters, "multi_iterations": multi})
            emit(rows[-1])
    return rows


def path4_solvers(gt):
    """name -> (solver class, build parameters, its fused kernel)."""
    return {"bicgstab": (gt.Bicgstab, {}, "bicgstab_fused"),
            "cgs": (gt.Cgs, {}, "cgs_fused"),
            "bicg": (gt.Bicg, {}, "bicg_fused"),
            "gmres": (gt.Gmres, {"krylov_dim": KRYLOV_DIM}, "gmres_fused")}


def main_path4(gt, dev, rng, crit, kernels, data1, x64_ones, nside=NSIDE):
    """Main path 4 through the entry points a user calls; every check
    raises.  A2, the convection-diffusion operator on the nside^2 grid:
    Bicgstab, Cgs, Bicg and Gmres(30) fused with float32 and bfloat16
    diagonals and with scalar Jacobi, then streaming; CbGmres "auto" (a
    bfloat16 basis at this size) and "integer" (streams).  A1, the Poisson
    matrix of path 1: Bicgstab fused and streaming.  Each solution is held
    against a float64 solve of the operator it solved (the bfloat16
    diagonals round A2's coefficients, so that system has its own)."""
    from ginkgo_tpu_torch import stop

    t0 = time.perf_counter()
    data = gt.MatrixData.from_coo(*convdiff_2d(nside))
    A = gt.Dia.from_matrix_data(data, device=dev)
    Ab = A.reduce_storage()
    _sync(dev)
    setup_s = time.perf_counter() - t0
    n = A.shape[0]
    norm_a = inf_norm(data)
    b = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
    f64_crit = [stop.Iteration(max_iters=MAX_ITERS), stop.ResidualNorm(tolerance=1e-10)]
    refs = {}
    for storage, Av in (("f32", A), ("bf16", Ab)):
        # streaming BiCGSTAB in float64 (K1 with float64 vectors)
        t0 = time.perf_counter()
        refs[storage], info = gt.Bicgstab.build(criteria=f64_crit).generate(
            Av.astype(torch.float64)).solve(b.double())
        _sync(dev)
        check(bool(info.converged.all()), f"path 4: float64 reference ({storage}): not converged")
        emit({"phase": "main_path", "path": 4, "route": "streaming",
              "case": f"f64_reference_{storage}", "matrix": f"convdiff_2d({nside})", "rows": n,
              "nnz": data.nnz, "norm_inf": norm_a, "setup_s": round(setup_s, 3),
              "iterations": info.num_iterations,
              "solve_s": round(time.perf_counter() - t0, 4)})

    iterations = {}  # the f32 counts, which path 7's preconditioned solves must beat
    for name, (cls, params, kname) in path4_solvers(gt).items():
        kern = kernels[kname]
        for case, Av, pre, ref in (("f32", A, None, "f32"), ("bf16", Ab, None, "bf16"),
                                   ("f32_jacobi", A, gt.Jacobi.build(max_block_size=1), "f32")):
            solver = cls.build(criteria=crit, preconditioner=pre, **params).generate(Av)
            before = kern.launches
            rings = getattr(kern, "routes", {}).get("ring", 0)
            t0 = time.perf_counter()
            x, info = solver.solve(b)
            _sync(dev)
            solve_s = time.perf_counter() - t0
            label = f"path 4: {name} {case}"
            check(kern.launches == before + 1, f"{label} did not run {kname}")
            check(kname != "bicgstab_fused" or kern.routes["ring"] == rings + 1,
                  f"{label}: K12 did not take its ring route")
            check(bool(info.converged.all()), f"{label}: not converged")
            check(x.shape == (n,), f"{label}: bad x")
            if case == "f32":
                iterations[name] = info.num_iterations
            emit({"phase": "main_path", "path": 4, "route": "fused", "solver": name,
                  "case": case, "iterations": info.num_iterations,
                  "residual_norm": float(info.residual_norm[0]),
                  **accuracy(Av, x, b, refs[ref], norm_a, label),
                  "solve_s": round(solve_s, 4)})
        solver = cls.build(criteria=crit, **params).generate(A)
        t0 = time.perf_counter()
        with torch.no_grad():
            xs, sinfo = solver._solve_streaming(b[:, None], torch.zeros(n, 1, device=dev))
        _sync(dev)
        check(bool(sinfo.converged.all()), f"path 4: {name} streaming: not converged")
        emit({"phase": "main_path", "path": 4, "route": "streaming", "solver": name,
              "case": "f32", "iterations": sinfo.num_iterations,
              **accuracy(A, xs[:, 0], b, refs["f32"], norm_a, f"path 4: {name} streaming"),
              "solve_s": round(time.perf_counter() - t0, 4)})

    for mode, fused in (("auto", True), ("integer", False)):
        solver = gt.CbGmres.build(criteria=crit, krylov_dim=KRYLOV_DIM,
                                  storage_precision=mode).generate(A)
        resolved = solver._resolved_mode()
        check(mode != "auto" or resolved == "reduce1",
              f"path 4: CbGmres 'auto' resolved to {resolved!r} at {n} rows")
        before = kernels["gmres_fused"].launches
        t0 = time.perf_counter()
        x, info = solver.solve(b)
        _sync(dev)
        label = f"path 4: CbGmres {mode}"
        check((kernels["gmres_fused"].launches == before + 1) == fused,
              f"{label}: gmres_fused launched {kernels['gmres_fused'].launches - before} times")
        check(bool(info.converged.all()), f"{label}: not converged")
        emit({"phase": "main_path", "path": 4, "route": "fused" if fused else "streaming",
              "solver": "cbgmres", "case": mode, "resolved": resolved,
              "iterations": info.num_iterations,
              **accuracy(A, x, b, refs["f32"], norm_a, label),
              "solve_s": round(time.perf_counter() - t0, 4)})

    # A1: BiCGSTAB on the Poisson matrix of path 1, fused and streaming, to
    # 1e-6 within A1_BICGSTAB_CAP iterations.  In float32 BiCGSTAB does not
    # reach 1e-6 on this system (the JAX package's kernel and loop fail the
    # same way on the CPU from 512^2 rows on): the counts, flags and errors
    # of the two routes are reported side by side, and only the routes are
    # checked.
    A1 = gt.Dia.from_matrix_data(data1, device=dev)
    b1 = torch.ones(A1.shape[0], device=dev)
    solver = gt.Bicgstab.build(criteria=[stop.Iteration(max_iters=A1_BICGSTAB_CAP),
                                         stop.ResidualNorm(tolerance=TOL)]).generate(A1)
    row = {"phase": "main_path", "path": 4, "solver": "bicgstab",
           "matrix": f"poisson_2d({NSIDE})", "cap": A1_BICGSTAB_CAP}
    for route in ("fused", "streaming"):
        before = kernels["bicgstab_fused"].launches
        rings = kernels["bicgstab_fused"].routes["ring"]
        t0 = time.perf_counter()
        with torch.no_grad():
            x, info = (solver.solve(b1[:, None]) if route == "fused"
                       else solver._solve_streaming(b1[:, None], torch.zeros(A1.shape[0], 1,
                                                                              device=dev)))
        _sync(dev)
        label = f"path 4: bicgstab on poisson_2d({NSIDE}) {route}"
        check((kernels["bicgstab_fused"].launches == before + 1) == (route == "fused")
              and kernels["bicgstab_fused"].routes["ring"] == rings + (route == "fused"),
              f"{label}: wrong route")
        row[route] = {"iterations": info.num_iterations,
                      "converged": bool(info.converged.all()),
                      "residual_norm": float(info.residual_norm[0]),
                      **accuracy(A1, x[:, 0], b1, x64_ones, inf_norm(data1), label,
                                 bounded=False),
                      "solve_s": round(time.perf_counter() - t0, 4)}
    emit(row)
    return {"A": A, "Ab": Ab, "b": b, "refs": refs, "norm_a": norm_a, "A1": A1, "b1": b1,
            "iterations": iterations}


def check_path4_kernels(gt, dev, rng, p4, record_err, max_iters=MAX_ITERS):
    """K12-K15 against their plain versions on A2: float32 and bfloat16
    diagonals, each with and without an inverse diagonal (a seeded uniform
    one, folded into A M for K12/K13), K15 with a float32 basis and, on
    float32 diagonals, a bfloat16 basis; then a NaN in b per kernel, which
    must run to the cap on both.  Equal iteration counts are required.  The
    kernel and its plain version differ only in the order of their float64
    dot sums, so x is expected bit for bit; where a sum rounds to the
    neighbouring float32 (seen with a bfloat16 basis) the difference is
    reported and must stay within 1e-5 of max |x|; K13's and K14's x, r and
    monitor must be bit for bit."""
    from ginkgo_tpu_torch.ops import bicgstab as ops_bicgstab
    from ginkgo_tpu_torch.ops import cgs as ops_cgs
    from ginkgo_tpu_torch.ops import gmres as ops_gmres
    from ginkgo_tpu_torch.solver._fused_gate import fold_minv

    A, b = p4["A"], p4["b"]
    n = A.shape[0]
    z = torch.zeros_like(b)
    minv = torch.as_tensor(rng.uniform(0.15, 0.3, n).astype(np.float32), device=dev)

    def cases(Av, pre, rhs, tol, cap):
        At = Av.conj_transpose()
        folded = Av.diags if pre is None else fold_minv(Av, pre)
        kw = dict(tol_sq_eff=tol, max_iters=cap)
        out = {
            "bicgstab_fused": (
                lambda: ops_bicgstab.bicgstab_fused(folded, Av.offsets, rhs, z, pre, **kw),
                lambda: ops_bicgstab.bicgstab_solve_reference(folded, Av.offsets, rhs, z, pre,
                                                              **kw)),
            "cgs_fused": (
                lambda: ops_cgs.cgs_fused(folded, Av.offsets, rhs, z, pre, **kw),
                lambda: ops_cgs.cgs_solve_reference(folded, Av.offsets, rhs, z, pre, **kw)),
            "bicg_fused": (
                lambda: ops_cgs.bicg_fused(Av.diags, Av.offsets, At.diags, At.offsets, rhs, z,
                                           pre, **kw),
                lambda: ops_cgs.bicg_solve_reference(Av.diags, Av.offsets, At.diags,
                                                     At.offsets, rhs, z, pre, **kw)),
        }
        for basis in ((torch.float32, torch.bfloat16) if Av.dtype == torch.float32
                      else (torch.float32,)):
            out[f"gmres_fused:{str(basis)[6:]}"] = (
                lambda basis=basis: ops_gmres.gmres_fused(
                    Av.diags, Av.offsets, rhs, z, pre, m=KRYLOV_DIM, basis_dtype=basis, **kw),
                lambda basis=basis: ops_gmres.gmres_solve_reference(
                    Av.diags, Av.offsets, rhs, z, pre, m=KRYLOV_DIM, basis_dtype=basis, **kw))
        return out

    def run(kern, plain):
        """(x, iterations, monitor) of a whole-solve kernel's output."""
        def norm(out):
            x = out[0]
            it, mon = (out[2], out[3]) if len(out) == 5 else (out[1], out[2])
            return x, int(it), float(mon)
        t0 = time.perf_counter()
        kout = kern()
        k = norm(kout)
        _sync(dev)
        k_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pout = plain()
        p = norm(pout)
        _sync(dev)
        return k, p, k_s, time.perf_counter() - t0, kout, pout

    tol = torch.full((), (TOL * float(b.norm())) ** 2, dtype=torch.float32, device=dev)
    for storage, Av in (("f32", A), ("bf16", A.reduce_storage())):
        for pre_label, pre in (("identity", None), ("minv", minv)):
            row = {"phase": "kernel_check", "path": 4, "matrix": f"convdiff_2d({NSIDE})",
                   "storage": storage, "preconditioner": pre_label}
            for key, (kern, plain) in cases(Av, pre, b, tol, max_iters).items():
                name = key.split(":")[0]
                (kx, kit, kmon), (px, pit, pmon), k_s, p_s, kout, pout = run(kern, plain)
                err = record_err(name, kx, px)
                what = f"{key} {storage} {pre_label}"
                check(kit == pit, f"{what}: {kit} vs {pit} iterations")
                if name in ("cgs_fused", "bicg_fused"):
                    check(all(bit_equal(kout[j], pout[j]) for j in (0, 1, 3)),
                          f"{what}: x, r or the monitor differs")
                check(bool(torch.isfinite(kx).all()) and kmon <= float(tol),
                      f"{what}: not converged (monitor {kmon})")
                check(err <= 1e-5 * float(px.abs().max()), f"{what}: x differs by {err}")
                row[key] = {"iters": kit, "plain_iters": pit, "bit_equal": bool(torch.equal(kx, px)),
                            "x_max_abs_err": err, "s": round(k_s, 4), "plain_s": round(p_s, 4)}
            emit(row)
    # a NaN in b keeps every monitor NaN: both run to the cap
    bn = b.clone()
    bn[5] = float("nan")
    row = {"phase": "kernel_check", "path": 4, "case": "nan_rhs_runs_to_cap", "cap": 25}
    for key, (kern, plain) in cases(A, None, bn, tol, 25).items():
        (kx, kit, kmon), (px, pit, pmon), *_ = run(kern, plain)
        check(kit == pit == 25 and np.isnan(kmon) and np.isnan(pmon),
              f"{key} with a NaN: {kit} / {pit} iterations, monitors {kmon} / {pmon}")
        row[key] = {"iters": kit, "plain_iters": pit}
    emit(row)


def banded_grid(nx, ny, coeffs, jitter=True, seed=SEED + 13):
    """A nonsymmetric diagonally dominant 5-point operator on an nx x ny
    grid (offsets +-1 and +-nx; +-1 alone when ny is 1), coefficients
    (diagonal, west/south, east/north), a zero coefficient leaving its
    diagonals out, with a seeded jitter in [0, 0.5) of the diagonal.
    Returns COO parts."""
    n = nx * ny
    i = np.arange(n)
    ix, iy = i % nx, i // nx
    diag, lo, hi = coeffs
    extra = np.random.default_rng(seed).uniform(0.0, 0.5, n) if jitter else np.zeros(n)
    rows, cols, vals = [i], [i], [diag + extra]
    for on, keep, off, v in ((nx > 1, ix > 0, -1, lo), (nx > 1, ix < nx - 1, 1, hi),
                             (ny > 1, iy > 0, -nx, lo), (ny > 1, iy < ny - 1, nx, hi)):
        if on and v != 0.0:
            rows.append(i[keep])
            cols.append(i[keep] + off)
            vals.append(np.full(int(keep.sum()), v))
    return ((n, n), np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals).astype(np.float32))


#: K12 edge operators (``check_bicgstab_edges``): label -> grid (nx, ny),
#: coefficients and jitter.  w = 0 (2 I: s = 0 in the first half step), w = 1 at
#: n not a multiple of the walk's chunk, w = 2047 and 2048 with ranges
#: shorter than the halo, w = 2048 with ranges of several chunks, and w =
#: 16000, whose ring does not fit a block (the five-pass kernel).
BICGSTAB_EDGES = {
    "2I(5000)": ((1, 5000), (2.0, 0.0, 0.0), False),
    "line(3001)": ((3001, 1), (2.6, -1.3, -0.7), True),
    "grid(2047x5)": ((2047, 5), (4.5, -1.3, -0.7), True),
    "grid(2048x6)": ((2048, 6), (4.5, -1.3, -0.7), True),
    "grid(2048x150)": ((2048, 150), (4.5, -1.3, -0.7), True),
    "grid(16000x3)": ((16000, 3), (4.5, -1.3, -0.7), True),
}


def check_bicgstab_edges(gt, dev, rng, record_err=None):
    """K12 against its plain version on ``BICGSTAB_EDGES``: float32 and
    bfloat16 diagonals, the Identity and a seeded inverse diagonal folded
    into A M (Jacobi), exact and implicit mode, and a NaN in b (both run to
    the cap).  Each case must take its route (the ring, or the five-pass
    kernel past the ring's limit), the plain version's iterations, and x, r
    and the monitor bit for bit; the 2 I operator must stop in the first
    half step.  Returns the rows it emitted."""
    from ginkgo_tpu_torch.ops import bicgstab as ops_bicgstab
    from ginkgo_tpu_torch.solver._fused_gate import fold_minv

    kern = ops_bicgstab.bicgstab_fused
    rows = []
    for label, (grid, coeffs, jitter) in BICGSTAB_EDGES.items():
        A = gt.Dia.from_matrix_data(gt.MatrixData.from_coo(*banded_grid(*grid, coeffs, jitter)),
                                    device=dev)
        n = A.shape[0]
        b = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
        z = torch.zeros_like(b)
        tol = torch.full((), (TOL * float(b.norm())) ** 2, dtype=torch.float32, device=dev)
        minv = torch.as_tensor(rng.uniform(0.15, 0.3, n).astype(np.float32), device=dev)
        nan_b = b.clone()
        nan_b[n // 2] = float("nan")
        row = {"phase": "kernel_check", "kernel": "bicgstab_fused", "matrix": label, "rows": n,
               "width": max(abs(o) for o in A.offsets),
               "launch": ops_bicgstab.bicgstab_fused_launch(A.diags, A.offsets, dev)}
        for storage, Av in (("f32", A), ("bf16", A.reduce_storage())):
            plan = ops_bicgstab.ring_plan(Av.offsets, n, Av.diags.element_size())
            route = "ring" if plan else "barrier"
            check((route == "barrier") == (label == "grid(16000x3)"),
                  f"bicgstab_fused {label} {storage}: the {route} route")
            for pre_label, pre in (("identity", None), ("jacobi", minv)):
                D = Av.diags if pre is None else fold_minv(Av, pre)
                for what, rhs, cap, imp in (("exact", b, 500, False), ("implicit", b, 500, True),
                                            ("nan b", nan_b, 7, False)):
                    if what != "exact" and (storage, pre_label) != ("f32", "identity"):
                        continue
                    kw = dict(tol_sq_eff=tol, max_iters=cap, use_implicit=imp)
                    before = kern.routes[route]
                    got = kern(D, Av.offsets, rhs, z, pre, **kw)
                    want = ops_bicgstab.bicgstab_solve_reference(D, Av.offsets, rhs, z, pre, **kw)
                    _sync(dev)
                    case = f"bicgstab_fused {label} {storage} {pre_label} {what}"
                    check(kern.routes[route] == before + 1, f"{case}: not the {route} route")
                    kit, pit = int(got[2]), int(want[2])
                    if record_err is not None and what != "nan b":
                        record_err("bicgstab_fused", got[0], want[0])
                    check(kit == pit, f"{case}: {kit} vs {pit} iterations")
                    check(bit_equal(got[0], want[0]) and bit_equal(got[1], want[1])
                          and bit_equal(got[3], want[3]), f"{case}: x, r or the monitor differs")
                    if what == "nan b":
                        check(kit == cap and not bool(got[4]), f"{case}: stopped at {kit}")
                    else:
                        check(bool(got[4]), f"{case}: not converged")
                    if label == "2I(5000)" and what == "exact" and pre is None:
                        check(kit == 1, f"{case}: {kit} iterations, not the first half step")
                    row[f"{storage} {pre_label} {what}"] = kit
        rows.append(row)
        emit(row)
    return rows


def implicit_monitor_within_bound(got, want, stops, total, r_final, residual_after, rr):
    """Implicit-mode monitors of a k-column solve against the plain
    version's, where x and r are bit for bit: column c's monitor is
    |<rr, r>|, a float64 sum rounded to float32, and the kernel sums it in
    another order (declared).  Two sums of the same float32 products differ
    by at most 2 n u sum |rr_i r_i| (u = 2^-53), and rounding to float32
    adds one ulp; near the stop the sum cancels to 1e-10 of its terms, so
    the float64 order shows in float32.  The r of column c: its final r
    where it stopped before the last of the ``total`` iterations (its rho
    was updated in its stop iteration), else the r that entered that
    iteration, the plain version's after ``residual_after(total - 1)``,
    bit for bit."""
    n = rr.shape[0]
    for c, stop in enumerate(stops):
        if bit_equal(got[c], want[c]):
            continue
        r_in = (r_final if stop < total else residual_after(stop - 1))[:, c].double()
        terms = float((rr[:, c].double() * r_in).abs().sum())
        ulp = float(torch.nextafter(want[c].abs(), torch.tensor(float("inf"),
                                                                device=want.device))
                    - want[c].abs())
        if not abs(float(got[c]) - float(want[c])) <= 2 * n * 2.0**-53 * terms + ulp:
            return False
    return True


#: K12m edge operators (``check_bicgstab_multi_edges``): the K12 edges that
#: give rows past both ends at w = 1 and w = 2047, and a w past K12's ring
BICGSTAB_MULTI_EDGES = ("line(3001)", "grid(2047x5)", "grid(16000x3)")


def check_bicgstab_multi_edges(gt, dev, rng, record_err=None):
    """K12m against its plain version on ``BICGSTAB_MULTI_EDGES`` at k = 2,
    3, 4 and 8 (8-byte rows, scalar rows, 16-byte rows and two of them):
    float32 and bfloat16 diagonals, a seeded inverse diagonal folded into A
    M, implicit mode, and a run in which column 0 stops early (a loose
    threshold) and column 1 carries a NaN and runs to the cap, so the other
    columns stay frozen from their stops.  Equal iterations and per-column
    stop iterations, x, r and the monitors bit for bit.  Returns the rows
    it emitted."""
    from ginkgo_tpu_torch.ops import bicgstab as ops_bicgstab
    from ginkgo_tpu_torch.solver._fused_gate import fold_minv

    kern = ops_bicgstab.bicgstab_fused_multi
    rows = []
    for label in BICGSTAB_MULTI_EDGES:
        grid, coeffs, jitter = BICGSTAB_EDGES[label]
        A = gt.Dia.from_matrix_data(gt.MatrixData.from_coo(*banded_grid(*grid, coeffs, jitter)),
                                    device=dev)
        n = A.shape[0]
        minv = torch.as_tensor(rng.uniform(0.15, 0.3, n).astype(np.float32), device=dev)
        row = {"phase": "kernel_check", "kernel": "bicgstab_fused_multi", "matrix": label,
               "rows": n, "width": max(abs(o) for o in A.offsets)}
        for k in (2, 3, 4, 8):
            B = torch.as_tensor(rng.uniform(0.5, 1.5, (n, k)).astype(np.float32), device=dev)
            Z = torch.zeros_like(B)
            tol = ((TOL * B.norm(dim=0)) ** 2).contiguous()
            loose = tol.clone()
            loose[0] = float(B[:, 0].norm()) ** 2 * 1e-2
            Bn = B.clone()
            Bn[n // 3, 1] = float("nan")
            cases = [("f32 identity", A, None, B, tol, 500, False),
                     ("bf16 identity", A.reduce_storage(), None, B, tol, 500, False),
                     ("f32 jacobi", A, minv, B, tol, 500, False),
                     ("f32 identity implicit", A, None, B, tol, 500, True),
                     ("f32 frozen and nan", A, None, Bn, loose, 40, False)]
            for what, Av, pre, rhs, tl, cap, imp in cases:
                D = Av.diags if pre is None else fold_minv(Av, pre)
                kw = dict(tol_sq_eff=tl, max_iters=cap, use_implicit=imp)
                got = kern(D, Av.offsets, rhs, Z, pre, **kw)
                want = ops_bicgstab.bicgstab_solve_multi_reference(D, Av.offsets, rhs, Z, pre,
                                                                   **kw)
                _sync(dev)
                case = f"bicgstab_fused_multi {label} k={k} {what}"
                kit, pit = int(got[2]), int(want[2])
                kitc, pitc = got[5].tolist(), want[5].tolist()
                if record_err is not None and "nan" not in what:
                    record_err("bicgstab_fused_multi", got[0], want[0])
                check(kit == pit and kitc == pitc, f"{case}: {kit} / {pit} iterations, "
                      f"{kitc} / {pitc}")
                same_x, same_r = bit_equal(got[0], want[0]), bit_equal(got[1], want[1])
                mon_ok = bit_equal(got[3], want[3])
                if imp and not mon_ok:
                    mon_ok = implicit_monitor_within_bound(
                        got[3], want[3], kitc, kit, want[1],
                        lambda its: ops_bicgstab.bicgstab_solve_multi_reference(
                            D, Av.offsets, rhs, Z, pre, **dict(kw, max_iters=its))[1], rhs)
                check(same_x and same_r and mon_ok,
                      f"{case}: x equal {same_x}, r equal {same_r}, monitors "
                      f"{got[3].tolist()} / {want[3].tolist()}")
                conv = got[4].tolist()
                if "nan" in what:
                    rest = [c for c in range(k) if c != 1]
                    check(kit == cap and kitc[1] == cap and not conv[1]
                          and all(conv[c] for c in rest) and kitc[0] < cap,
                          f"{case}: stops {kitc}, converged {conv}")
                else:
                    check(all(conv), f"{case}: not converged ({conv})")
                row[f"k={k} {what}"] = kitc
        rows.append(row)
        emit(row)
    return rows


def check_bicgstab_multi_order(gt, dev, A):
    """K12m against its plain version where the declared float64 dot order
    can show: 8 columns on A2 at 2048^2 (4.2M rows, so each dot's two
    orders part by more than at the edges' sizes), float32 and bfloat16
    diagonals and a seeded inverse diagonal folded into A M, solved to
    1e-6.  The iterations and every column's stop iteration must be equal
    and every column converged.  x and r are the plain version's bit for
    bit unless a dot, summed in the two orders, rounds to two float32
    scalars: then the first iteration at which x or r part (both solves
    rerun to fewer iterations, bisected) and whether the monitors r.r
    parted in the iteration before it are recorded, and each column's true
    residual ||b - A x|| (float64) must be at most twice the plain
    version's or the threshold, whichever is larger.  Returns the row it
    emitted."""
    from ginkgo_tpu_torch.ops import bicgstab as ops_bicgstab
    from ginkgo_tpu_torch.ops import dia as ops_dia
    from ginkgo_tpu_torch.solver._fused_gate import fold_minv

    n, k = A.shape[0], 8
    rng = np.random.default_rng(SEED + 9)
    minv = torch.as_tensor(rng.uniform(0.15, 0.3, n).astype(np.float32), device=dev)
    B = torch.as_tensor(rng.uniform(0.5, 1.5, (n, k)).astype(np.float32), device=dev)
    Z = torch.zeros_like(B)
    tol = ((TOL * B.norm(dim=0)) ** 2).contiguous()
    row = {"phase": "kernel_check", "kernel": "bicgstab_fused_multi",
           "matrix": f"convdiff_2d({NSIDE})", "k": k}
    for what, Av, pre in (("f32", A, None), ("bf16", A.reduce_storage(), None),
                          ("jacobi", A, minv)):
        D = Av.diags if pre is None else fold_minv(Av, pre)

        def run(fn, its, D=D, Av=Av, pre=pre):
            return fn(D, Av.offsets, B, Z, pre, tol_sq_eff=tol, max_iters=its)

        got = run(ops_bicgstab.bicgstab_fused_multi, MAX_ITERS)
        want = run(ops_bicgstab.bicgstab_solve_multi_reference, MAX_ITERS)
        _sync(dev)
        case = f"bicgstab_fused_multi {row['matrix']} k={k} {what}"
        kit, pit = int(got[2]), int(want[2])
        kitc, pitc = got[5].tolist(), want[5].tolist()
        check(kit == pit and kitc == pitc, f"{case}: {kit} / {pit} iterations, {kitc} / {pitc}")
        check(all(got[4].tolist()) and all(want[4].tolist()), f"{case}: not converged")
        same = bit_equal(got[0], want[0]) and bit_equal(got[1], want[1])
        out = {"column_iters": kitc, "bit_equal": same}
        if not same:
            def parted(its):
                g = run(ops_bicgstab.bicgstab_fused_multi, its)
                w = run(ops_bicgstab.bicgstab_solve_multi_reference, its)
                return not (bit_equal(g[0], w[0]) and bit_equal(g[1], w[1])), g[3], w[3]

            lo, hi = 0, kit  # x and r equal after lo iterations, parted after hi
            while hi - lo > 1:
                mid = (lo + hi) // 2
                lo, hi = (lo, mid) if parted(mid)[0] else (mid, hi)
            _, gmon, wmon = parted(lo) if lo > 0 else (None, None, None)
            Ad = Av.diags.double()

            def true_res(x, Ad=Ad, Av=Av):
                return (B.double() - ops_dia.dia_spmm_reference(Ad, Av.offsets, x.double(), n)
                        ).norm(dim=0)

            kres, pres = true_res(got[0]), true_res(want[0])
            bound = 2 * torch.maximum(pres, tol.double().sqrt())
            out.update(first_parted_iteration=hi,
                       monitors_parted_before=None if gmon is None else not bit_equal(gmon, wmon),
                       x_max_rel_diff=float(((got[0] - want[0]).norm(dim=0)
                                             / want[0].norm(dim=0)).max()),
                       true_residual=kres.tolist(), plain_true_residual=pres.tolist())
            check(bool((kres <= bound).all()),
                  f"{case}: true residuals {kres.tolist()} over twice the plain version's "
                  f"{pres.tolist()} or the threshold")
        row[what] = out
    emit(row)
    return row


def check_gmres_multi_edges(gt, dev, rng, record_err=None):
    """K15m against its plain version on A2's operator at 64^2 (fewer
    tiles than the grid has blocks) and 700^2 (490,000 rows, several tiles
    a block, not a multiple of a tile): k = 2, 3, 4 columns, m = 1, 2, 30
    and 50, a float32 and a bfloat16 basis, the Identity and Jacobi, columns
    that stop at different steps (one inside a cycle another runs on in),
    and a NaN column that runs to the cap while the others stop.  Each case
    must take the plain version's iterations and per-column stop
    iterations, and x bit for bit (the NaN case: the other columns).
    Returns the rows it emitted."""
    from ginkgo_tpu_torch.ops import gmres as ops_gmres

    ops = {nside: gt.Dia.from_matrix_data(gt.MatrixData.from_coo(*convdiff_2d(nside)),
                                          device=dev) for nside in (SMALL, 700)}
    cases = [  # (nside, k, m, basis, Jacobi, cap, NaN column)
        (SMALL, 2, 1, torch.float32, False, 400, None),
        (SMALL, 3, 2, torch.bfloat16, True, 400, None),
        (SMALL, 4, 30, torch.float32, False, 400, None),
        (SMALL, 4, 30, torch.float32, False, 25, 2),
        (SMALL, 3, 50, torch.bfloat16, False, 400, None),
        (700, 4, 50, torch.bfloat16, False, 400, None),
        (700, 2, 30, torch.float32, True, 400, None),
        (700, 3, 30, torch.bfloat16, False, 120, 0),
    ]
    rows = []
    for nside, k, m, basis, jacobi, cap, nan_col in cases:
        A = ops[nside]
        n = A.shape[0]
        B = rhs4(n, rng, dev)[:, :k].contiguous()
        if nan_col is not None:
            B[n // 3, nan_col] = float("nan")
        tol = ((TOL * B.norm(dim=0)) ** 2).contiguous()
        minv = 1.0 / A.extract_diagonal().values.float() if jacobi else None
        Z = torch.zeros_like(B)
        kw = dict(m=m, tol_sq_eff=tol, max_iters=cap, basis_dtype=basis)
        got = ops_gmres.gmres_fused_multi(A.diags, A.offsets, B, Z, minv, **kw)
        want = ops_gmres.gmres_solve_multi_reference(A.diags, A.offsets, B, Z, minv, **kw)
        _sync(dev)
        case = (f"gmres_fused_multi {nside}^2 k={k} m={m} {str(basis)[6:]} basis"
                f"{' jacobi' if jacobi else ''}{' nan' if nan_col is not None else ''}")
        kit, pit = int(got[1]), int(want[1])
        kitc, pitc = got[4].tolist(), want[4].tolist()
        check(kit == pit and kitc == pitc, f"{case}: {kit} / {pit} steps, {kitc} / {pitc}")
        check(got[3].tolist() == want[3].tolist(), f"{case}: stop flags differ")
        cols = [c for c in range(k) if c != nan_col]
        check(all(bit_equal(got[0][:, c], want[0][:, c]) for c in cols),
              f"{case}: x differs by {float((got[0] - want[0])[:, cols].abs().max())}")
        if nan_col is not None:
            check(kitc[nan_col] == cap and not bool(got[3][nan_col]),
                  f"{case}: the NaN column stopped at {kitc[nan_col]}")
        elif record_err is not None:
            record_err("gmres_fused_multi", got[0], want[0])
        mid = any(c < kit and (c - 1) // m == (d - 1) // m for c in kitc for d in kitc if d > c)
        rows.append({"phase": "kernel_check", "kernel": "gmres_fused_multi", "case": case,
                     "steps": kit, "column_steps": kitc, "mid_cycle_stop": mid})
        emit(rows[-1])
    check(any(r["mid_cycle_stop"] for r in rows),
          "gmres_fused_multi edges: no column stopped inside a cycle another ran on in")
    return rows


def pell_cg_edge_operators(gt, dev):
    """Small SPD Pells that reach every branch of K7's chunks: label ->
    Pell (float32 values).  The shifted 3-D Poisson matrix at 13^3 (2197
    rows: not a multiple of a chunk, nor of S x 128) with S = 8 (each chunk
    one tile), S = 8 with G = 4 (several G-slot steps a tile), S = 16 with
    int32 lane indices (a chunk half a tile), S = 1 and S = 3 (chunks over
    several tiles: the rows one at a time); and at 40^3 (64,000 rows, 63
    chunks) with S = 8."""
    C13 = gt.Csr.from_matrix_data(shifted_poisson_3d(gt, 13), device=dev)
    C40 = gt.Csr.from_matrix_data(shifted_poisson_3d(gt, 40, seed=9), device=dev)
    return {
        "poisson_3d_shifted(13), S = 8": gt.Pell.from_csr(C13),
        "poisson_3d_shifted(13), S = 8, G = 4": gt.Pell.from_csr(C13, G=4),
        "poisson_3d_shifted(13), S = 16, int32": gt.Pell.from_csr(C13, S=16, q_dtype=np.int32),
        "poisson_3d_shifted(13), S = 1": gt.Pell.from_csr(C13, S=1),
        "poisson_3d_shifted(13), S = 3, G = 8": gt.Pell.from_csr(C13, S=3, G=8),
        "poisson_3d_shifted(40), S = 8": gt.Pell.from_csr(C40),
    }


def check_pell_cg_edges(gt, dev, rng, record_err=None):
    """K7 against its plain version on ``pell_cg_edge_operators``, float32
    and bfloat16 values: CG with the Identity and with Jacobi, FCG with
    Jacobi, implicit mode, and a NaN in b (both run to the cap).  Each case
    must take the plain version's iterations and stop flag, and x, r and
    the monitor bit for bit.  Returns the rows it emitted."""
    from ginkgo_tpu_torch.ops import pell_cg as ops_pc

    cap = 7
    rows = []
    for label, P32 in pell_cg_edge_operators(gt, dev).items():
        n = P32.shape[0]
        b = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
        z = torch.zeros_like(b)
        tol = torch.full((), (TOL * float(b.double().norm())) ** 2, device=dev)
        nan_b = b.clone()
        nan_b[n // 2] = float("nan")
        row = {"phase": "kernel_check", "kernel": "pell_cg_fused", "matrix": label, "rows": n,
               "S": P32.S, "G": P32.G, "qidx": str(P32.qidx.dtype)}
        for storage, P in (("f32", P32), ("bf16", P32.astype(torch.bfloat16))):
            minv = (1.0 / P.extract_diagonal().values.float()).contiguous()
            for what, rhs, mv, its, imp, flex in (
                    ("identity", b, None, MAX_ITERS, False, False),
                    ("jacobi", b, minv, MAX_ITERS, False, False),
                    ("jacobi fcg", b, minv, MAX_ITERS, False, True),
                    ("implicit", b, None, MAX_ITERS, True, False),
                    ("nan b", nan_b, None, cap, False, False)):
                kw = dict(tol_sq_eff=tol, max_iters=its, use_implicit=imp, flexible=flex)
                got = ops_pc.pell_cg_fused(P, rhs, z, mv, **kw)
                want = ops_pc.pell_cg_solve_reference(P, rhs, z, mv, **kw)
                _sync(dev)
                case = f"pell_cg_fused {label} {storage} {what}"
                kit, pit = int(got[2]), int(want[2])
                check(kit == pit and bool(got[4]) == bool(want[4]),
                      f"{case}: {kit} / {pit} iterations, converged {bool(got[4])} / "
                      f"{bool(want[4])}")
                check(bit_equal(got[0], want[0]) and bit_equal(got[1], want[1])
                      and bit_equal(got[3], want[3]), f"{case}: x, r or the monitor differs")
                if what == "nan b":
                    check(kit == cap and not bool(got[4]), f"{case}: stopped at {kit}")
                else:
                    check(bool(got[4]), f"{case}: not converged")
                    if record_err is not None:
                        record_err("pell_cg_fused", got[0], want[0])
                row[f"{storage} {what}"] = kit
        rows.append(row)
        emit(row)
    return rows


def check_pell_ir_edges(gt, dev, rng, record_err=None):
    """K21 against its plain version on ``pell_cg_edge_operators`` (S = 1,
    3, 8 and 16, G = 4, int32 lane indices, n not a multiple of a chunk,
    63 chunks), float32 and bfloat16 values: Jacobi (relaxation 1.0) to
    the threshold, the Identity (0.15) under a cap of 10 sweeps, 0, 1 and
    2 sweeps from a seeded x0, zero sweeps (x0 the Jacobi solve's x, whose
    r0 meets the threshold) and a NaN in b (both run to the cap).  Each
    case must take the plain version's sweeps and stop flag, and x, r and
    r.r bit for bit, twice.  Returns the rows it emitted."""
    from ginkgo_tpu_torch.ops import pell_cg as ops_pc

    rows = []
    for label, P32 in pell_cg_edge_operators(gt, dev).items():
        n = P32.shape[0]
        b = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
        x0 = torch.as_tensor(rng.uniform(-0.1, 0.1, n).astype(np.float32), device=dev)
        z = torch.zeros_like(b)
        tol = torch.full((), (TOL * float(b.double().norm())) ** 2, device=dev)
        nan_b = b.clone()
        nan_b[n // 2] = float("nan")
        row = {"phase": "kernel_check", "kernel": "pell_ir_fused", "matrix": label, "rows": n,
               "S": P32.S, "G": P32.G, "qidx": str(P32.qidx.dtype)}
        for storage, P in (("f32", P32), ("bf16", P32.astype(torch.bfloat16))):
            minv = (1.0 / P.extract_diagonal().values.float()).contiguous()

            def run(what, rhs, start, mv, omega, cap, P=P, storage=storage):
                kw = dict(omega=omega, tol_sq_eff=tol, max_iters=cap)
                kw = dict(kw, with_residual=True)
                got = ops_pc.pell_ir_fused(P, rhs, start, mv, **kw)
                again = ops_pc.pell_ir_fused(P, rhs, start, mv, **kw)
                want = ops_pc.pell_ir_solve_reference(P, rhs, start, mv, **kw)
                _sync(dev)
                case = f"pell_ir_fused {label} {storage} {what}"
                kit, pit = int(got[2]), int(want[2])
                check(kit == pit == int(again[2]) and bool(got[4]) == bool(want[4]),
                      f"{case}: {kit} / {pit} sweeps, converged {bool(got[4])} / "
                      f"{bool(want[4])}")
                check(all(bit_equal(got[j], want[j]) and bit_equal(got[j], again[j])
                          for j in (0, 1, 3)), f"{case}: x, r or r.r differs")
                if what == "nan b":
                    check(kit == cap and not bool(got[4]), f"{case}: stopped at {kit}")
                elif cap <= 10:
                    check(kit == cap, f"{case}: {kit} sweeps")
                if record_err is not None and what != "nan b":
                    record_err("pell_ir_fused", got[0], want[0])
                row[f"{storage} {what}"] = kit
                return got

            got = run("jacobi", b, z, minv, 1.0, MAX_ITERS)
            check(bool(got[4]) and int(got[2]) > 0,
                  f"pell_ir_fused {label} {storage} jacobi: not converged")
            x = got[0]
            # the Jacobi solve's x meets the threshold: no sweep from it
            got = run("zero sweeps", b, x, minv, 1.0, MAX_ITERS)
            check(int(got[2]) == 0 and bool(got[4]) and bit_equal(got[0], x),
                  f"pell_ir_fused {label} {storage}: sweeps from an x0 that meets the threshold")
            run("identity", b, z, None, 0.15, 10)
            run("0 sweeps", b, x0, minv, 1.0, 0)
            run("1 sweep", b, x0, None, 0.15, 1)
            run("2 sweeps", b, x0, None, 0.3, 2)
            run("nan b", nan_b, z, minv, 1.0, 7)
        rows.append(row)
        emit(row)
    return rows


def check_pell_bicgstab_cgs_edges(gt, dev, rng, record_err=None):
    """K19 and K20 against their plain versions on ``pell_cg_edge_operators``
    (S = 1, 3, 8 and 16, G = 4, int32 lane indices, n not a multiple of a
    chunk, 63 chunks) and on 2 I at 5000 rows (s = 0 in the first
    iteration: BiCGSTAB's half step), float32 and bfloat16 values: the
    Identity and Jacobi to the threshold, implicit mode, caps of 0, 1 and 2
    iterations, and a NaN in b (run to the cap).  Each kernel runs each
    case twice; both runs must take the plain version's iterations and stop
    flag, and x, r and the monitor bit for bit.  Returns the rows it
    emitted."""
    from ginkgo_tpu_torch.ops import pell_cg as ops_pc

    kernels = {"pell_bicgstab_fused": (ops_pc.pell_bicgstab_fused,
                                       ops_pc.pell_bicgstab_solve_reference),
               "pell_cgs_fused": (ops_pc.pell_cgs_fused, ops_pc.pell_cgs_solve_reference)}
    ops = dict(pell_cg_edge_operators(gt, dev))
    two = np.arange(5000)
    ops["2I(5000), S = 8"] = gt.Pell.from_csr(gt.Csr.from_matrix_data(gt.MatrixData.from_coo(
        (5000, 5000), two, two, np.full(5000, 2.0, np.float32)), device=dev))
    rows = []
    for label, P32 in ops.items():
        n = P32.shape[0]
        b = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
        z = torch.zeros_like(b)
        tol = torch.full((), (TOL * float(b.double().norm())) ** 2, device=dev)
        nan_b = b.clone()
        nan_b[n // 2] = float("nan")
        half = label.startswith("2I")
        for kernel, (fused, plain) in kernels.items():
            row = {"phase": "kernel_check", "kernel": kernel, "matrix": label, "rows": n,
                   "S": P32.S, "G": P32.G, "qidx": str(P32.qidx.dtype)}
            for storage, P in (("f32", P32), ("bf16", P32.astype(torch.bfloat16))):
                minv = (1.0 / P.extract_diagonal().values.float()).contiguous()
                for what, rhs, mv, cap, imp in (
                        ("identity", b, None, MAX_ITERS, False),
                        ("jacobi", b, minv, MAX_ITERS, False),
                        ("implicit", b, None, MAX_ITERS, True),
                        ("0 iterations", b, minv, 0, False),
                        ("1 iteration", b, None, 1, False),
                        ("2 iterations", b, minv, 2, False),
                        ("nan b", nan_b, minv, 7, False)):
                    if half and what not in ("identity", "jacobi"):
                        continue
                    kw = dict(tol_sq_eff=tol, max_iters=cap, use_implicit=imp)
                    got = fused(P, rhs, z, mv, **kw)
                    again = fused(P, rhs, z, mv, **kw)
                    want = plain(P, rhs, z, mv, **kw)
                    _sync(dev)
                    case = f"{kernel} {label} {storage} {what}"
                    kit, pit = int(got[2]), int(want[2])
                    check(kit == pit == int(again[2]) and bool(got[4]) == bool(want[4])
                          == bool(again[4]),
                          f"{case}: {kit} / {pit} iterations, converged {bool(got[4])} / "
                          f"{bool(want[4])}")
                    check(all(bit_equal(got[j], want[j]) and bit_equal(got[j], again[j])
                              for j in (0, 1, 3)), f"{case}: x, r or the monitor differs")
                    if what == "nan b":
                        check(kit == cap and not bool(got[4]), f"{case}: stopped at {kit}")
                    elif cap <= 2:
                        check(kit == cap, f"{case}: {kit} iterations")
                    else:
                        check(bool(got[4]), f"{case}: not converged")
                        if record_err is not None:
                            record_err(kernel, got[0], want[0])
                    if half:
                        check(kit == 1, f"{case}: {kit} iterations, not the first half step")
                    row[f"{storage} {what}"] = kit
            rows.append(row)
            emit(row)
    return rows


#: K16 edge operators (``check_idr_edges``): label -> grid (nx, ny) and
#: coefficients of ``banded_grid``: n below the grid's threads, n not a
#: multiple of a block, and 2048 x 150 rows (several rows a thread).
IDR_EDGES = {
    "line(3001)": ((3001, 1), (2.6, -1.3, -0.7)),
    "grid(64x64)": ((64, 64), (4.5, -1.3, -0.7)),
    "grid(2048x150)": ((2048, 150), (4.5, -1.3, -0.7)),
}


def check_idr_edges(gt, dev, rng, record_err=None):
    """K16 against its plain version on ``IDR_EDGES`` at s = 1, 2 and 4:
    float32 diagonals with the Identity and with a seeded inverse diagonal,
    bfloat16 diagonals with the Identity, to the threshold; 0 and 1 outer
    iterations; an r0 that already meets the threshold (no iteration); a
    NaN in b (both run to the cap).  Each case must take the plain
    version's iterations and stop flag, and x, r and the monitor bit for
    bit, twice.  Returns the rows it emitted."""
    from ginkgo_tpu_torch.ops import idr as ops_idr

    rows = []
    for label, (grid, coeffs) in IDR_EDGES.items():
        A = gt.Dia.from_matrix_data(gt.MatrixData.from_coo(*banded_grid(*grid, coeffs)),
                                    device=dev)
        n = A.shape[0]
        b = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
        z = torch.zeros_like(b)
        tol = torch.full((), (TOL * float(b.norm())) ** 2, dtype=torch.float32, device=dev)
        minv = torch.as_tensor(rng.uniform(0.15, 0.3, n).astype(np.float32), device=dev)
        nan_b = b.clone()
        nan_b[n // 2] = float("nan")
        tiny = b * 1e-8  # r0 at the threshold
        row = {"phase": "kernel_check", "kernel": "idr_fused", "matrix": label, "rows": n}
        for sdim in (1, 2, 4):
            P = gt.Idr.build(criteria=None, subspace_dim=sdim).generate(A).P
            for what, Av, r0, rhs, mv, cap in (
                    ("f32 identity", A, b, b, None, 500), ("f32 jacobi", A, b, b, minv, 500),
                    ("bf16 identity", A.reduce_storage(), b, b, None, 500),
                    ("0 iterations", A, b, b, minv, 0), ("1 iteration", A, b, b, None, 1),
                    ("converged r0", A, tiny, b, minv, 500), ("nan b", A, nan_b, nan_b, None, 7)):
                kw = dict(kappa=0.7, tol_sq_eff=tol, max_iters=cap)
                args = (Av.diags, Av.offsets, P, r0, z, rhs, mv)
                got = ops_idr.idr_fused(*args, **kw)
                again = ops_idr.idr_fused(*args, **kw)
                want = ops_idr.idr_solve_reference(*args, **kw)
                _sync(dev)
                case = f"idr_fused {label} s={sdim} {what}"
                kit, pit = int(got[2]), int(want[2])
                check(kit == pit == int(again[2]) and bool(got[4]) == bool(want[4]),
                      f"{case}: {kit} / {pit} iterations, converged {bool(got[4])} / "
                      f"{bool(want[4])}")
                check(all(bit_equal(got[j], want[j]) and bit_equal(got[j], again[j])
                          for j in (0, 1, 3)), f"{case}: x, r or the monitor differs")
                if what == "nan b":
                    check(kit == cap and not bool(got[4]), f"{case}: stopped at {kit}")
                elif what == "converged r0":
                    check(kit == 0 and bool(got[4]), f"{case}: {kit} iterations")
                elif cap <= 1:
                    check(kit == cap, f"{case}: {kit} iterations")
                else:
                    check(bool(got[4]), f"{case}: not converged")
                if record_err is not None and what != "nan b":
                    record_err("idr_fused", got[0], want[0])
                row[f"s={sdim} {what}"] = kit
        rows.append(row)
        emit(row)
    return rows


#: K17 and K14 edge operators (``check_ir_edges``, ``check_bicg_edges``):
#: label -> rows and offsets of ``dia_band``.  1 to 7 diagonals; n below one
#: block of 256 rows; offsets past a block's rows; n not a multiple of 256,
#: and at 300,001 more rows than the grid has threads.
DIA_SWEEP_EDGES = {
    "diagonal(777)": (777, (0,)),
    "band2(1000)": (1000, (0, 1)),
    "line(200)": (200, (-1, 0, 1)),
    "band4(4099)": (4099, (-2, -1, 0, 3)),
    "grid(300x20)": (6000, (-300, -1, 0, 1, 300)),
    "band6(5001)": (5001, (-700, -5, -1, 0, 1, 5)),
    "band7(300001)": (300001, (-4000, -300, -1, 0, 1, 300, 4000)),
}


def dia_band(n, offsets, seed=SEED + 17):
    """A nonsymmetric band with the given offsets, strictly diagonally
    dominant: -1.3 below the diagonal, -0.7 above it, the diagonal 1 + the
    row's off-diagonal sum + a seeded [0, 0.5) jitter.  Returns COO parts."""
    i = np.arange(n)
    rows, cols, vals = [], [], []
    off_sum = np.zeros(n)
    for off in offsets:
        if off == 0:
            continue
        keep = (i + off >= 0) & (i + off < n)
        v = -1.3 if off < 0 else -0.7
        rows.append(i[keep])
        cols.append(i[keep] + off)
        vals.append(np.full(int(keep.sum()), v))
        off_sum[keep] += abs(v)
    rows.append(i)
    cols.append(i)
    vals.append(1.0 + off_sum + np.random.default_rng(seed + n).uniform(0.0, 0.5, n))
    return ((n, n), np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals).astype(np.float32))


def dia_sweep_edge_operators(gt, dev):
    """``DIA_SWEEP_EDGES`` as float32 ``Dia``s."""
    return {label: gt.Dia.from_matrix_data(gt.MatrixData.from_coo(*dia_band(n, offs)),
                                           device=dev)
            for label, (n, offs) in DIA_SWEEP_EDGES.items()}


def check_ir_edges(gt, dev, rng, record_err=None):
    """K17 against its plain versions on ``DIA_SWEEP_EDGES``, float32 and
    bfloat16 diagonals.  ``ir_fused``: Jacobi (relaxation 1.0) to the
    threshold, the Identity (0.3) under a cap of 10 sweeps, 0, 1 and 2
    sweeps from a seeded x0, x0 the Jacobi solve's x (the first sweep runs
    all the same) and a NaN in b (both run to the cap); the sweeps, the
    stop flag, x, r and r.r bit for bit.  ``ir_smooth``: from zero and from
    x0, with and without the residual, 0 to 3 sweeps; x and r bit for bit.
    Every case twice.  Returns the rows it emitted."""
    from ginkgo_tpu_torch.ops import ir as ops_ir

    rows = []
    for label, A32 in dia_sweep_edge_operators(gt, dev).items():
        n = A32.shape[0]
        b = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
        x0 = torch.as_tensor(rng.uniform(-0.1, 0.1, n).astype(np.float32), device=dev)
        z = torch.zeros_like(b)
        tol = torch.full((), (TOL * float(b.double().norm())) ** 2, device=dev)
        nan_b = b.clone()
        nan_b[n // 2] = float("nan")
        row = {"phase": "kernel_check", "kernel": "ir_fused", "matrix": label, "rows": n,
               "diagonals": len(A32.offsets)}
        for storage, A in (("f32", A32), ("bf16", A32.reduce_storage())):
            minv = (1.0 / A.extract_diagonal().values.float()).contiguous()

            def run(what, rhs, start, mv, omega, cap, A=A, storage=storage):
                kw = dict(omega=omega, tol_sq_eff=tol, max_iters=cap)
                args = (A.diags, A.offsets, rhs, start, mv)
                got = ops_ir.ir_fused(*args, **kw)
                again = ops_ir.ir_fused(*args, **kw)
                want = ops_ir.ir_solve_reference(*args, **kw)
                _sync(dev)
                case = f"ir_fused {label} {storage} {what}"
                kit, pit = int(got[2]), int(want[2])
                check(kit == pit == int(again[2]) and bool(got[4]) == bool(want[4]),
                      f"{case}: {kit} / {pit} sweeps, converged {bool(got[4])} / "
                      f"{bool(want[4])}")
                check(all(bit_equal(got[j], want[j]) and bit_equal(got[j], again[j])
                          for j in (0, 1, 3)), f"{case}: x, r or r.r differs")
                if what == "nan b":
                    check(kit == cap and not bool(got[4]), f"{case}: stopped at {kit}")
                elif cap <= 10:
                    check(kit == cap, f"{case}: {kit} sweeps")
                if record_err is not None and what != "nan b":
                    record_err("ir_fused", got[0], want[0])
                row[f"{storage} {what}"] = kit
                return got

            got = run("jacobi", b, z, minv, 1.0, MAX_ITERS)
            check(bool(got[4]) and int(got[2]) > 0, f"ir_fused {label} {storage}: not converged")
            # the monitor starts at +inf: a sweep runs from an x0 that meets the threshold
            got = run("from the solution", b, got[0], minv, 1.0, MAX_ITERS)
            check(int(got[2]) >= 1 and bool(got[4]),
                  f"ir_fused {label} {storage}: {int(got[2])} sweeps from the solution")
            run("identity", b, z, None, 0.3, 10)
            run("0 sweeps", b, x0, minv, 1.0, 0)
            run("1 sweep", b, x0, None, 0.3, 1)
            run("2 sweeps", b, x0, None, 0.3, 2)
            run("nan b", nan_b, z, minv, 1.0, 7)
            for start, xs in (("zero", None), ("x0", x0)):
                for with_r in (False, True):
                    for iters in (0, 1, 2, 3):
                        kw = dict(omega=0.8, iters=iters, with_residual=with_r)
                        args = (A.diags, A.offsets, b, xs, minv)
                        got = ops_ir.ir_smooth(*args, **kw)
                        again = ops_ir.ir_smooth(*args, **kw)
                        want = ops_ir.ir_smooth_reference(*args, **kw)
                        _sync(dev)
                        check(all(bit_equal(got[j], want[j]) and bit_equal(got[j], again[j])
                                  for j in (0, 1)),
                              f"ir_smooth {label} {storage} from {start}, residual {with_r}, "
                              f"{iters} sweeps: x or r differs")
                        if record_err is not None:
                            record_err("ir_smooth", got[0], want[0])
            row[f"{storage} ir_smooth cases"] = 16
        rows.append(row)
        emit(row)
    return rows


def check_bicg_edges(gt, dev, rng, record_err=None):
    """K14 against its plain version on ``DIA_SWEEP_EDGES``, float32 and
    bfloat16 diagonals (A and A^H alike): the Identity and a seeded inverse
    diagonal to the threshold, implicit mode, 0 and 1 iterations from a
    seeded x0, and a NaN in b (both run to the cap).  Each case twice; the
    iterations, the stop flag, x, r and the monitor bit for bit.  Returns
    the rows it emitted."""
    from ginkgo_tpu_torch.ops import cgs as ops_cgs

    rows = []
    for label, A32 in dia_sweep_edge_operators(gt, dev).items():
        n = A32.shape[0]
        b = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
        x0 = torch.as_tensor(rng.uniform(-0.1, 0.1, n).astype(np.float32), device=dev)
        z = torch.zeros_like(b)
        tol = torch.full((), (TOL * float(b.double().norm())) ** 2, device=dev)
        minv = torch.as_tensor(rng.uniform(0.15, 0.3, n).astype(np.float32), device=dev)
        nan_b = b.clone()
        nan_b[n // 2] = float("nan")
        row = {"phase": "kernel_check", "kernel": "bicg_fused", "matrix": label, "rows": n,
               "diagonals": len(A32.offsets)}
        for storage, A in (("f32", A32), ("bf16", A32.reduce_storage())):
            At = A.conj_transpose()
            for what, r0, start, mv, cap, imp in (
                    ("identity", b, z, None, 500, False), ("jacobi", b, z, minv, 500, False),
                    ("implicit", b, z, None, 500, True), ("0 iterations", b, x0, minv, 0, False),
                    ("1 iteration", b, x0, None, 1, False), ("nan b", nan_b, z, None, 7, False)):
                kw = dict(tol_sq_eff=tol, max_iters=cap, use_implicit=imp)
                args = (A.diags, A.offsets, At.diags, At.offsets, r0, start, mv)
                got = ops_cgs.bicg_fused(*args, **kw)
                again = ops_cgs.bicg_fused(*args, **kw)
                want = ops_cgs.bicg_solve_reference(*args, **kw)
                _sync(dev)
                case = f"bicg_fused {label} {storage} {what}"
                kit, pit = int(got[2]), int(want[2])
                check(kit == pit == int(again[2]) and bool(got[4]) == bool(want[4]),
                      f"{case}: {kit} / {pit} iterations, converged {bool(got[4])} / "
                      f"{bool(want[4])}")
                check(all(bit_equal(got[j], want[j]) and bit_equal(got[j], again[j])
                          for j in (0, 1, 3)), f"{case}: x, r or the monitor differs")
                if what == "nan b":
                    check(kit == cap and not bool(got[4]), f"{case}: stopped at {kit}")
                elif cap <= 1:
                    check(kit == cap, f"{case}: {kit} iterations")
                else:
                    check(bool(got[4]), f"{case}: not converged")
                if record_err is not None and what != "nan b":
                    record_err("bicg_fused", got[0], want[0])
                row[f"{storage} {what}"] = kit
        rows.append(row)
        emit(row)
    return rows



def check_cgs_edges(gt, dev, rng, record_err=None):
    """K13 against its plain version on ``DIA_SWEEP_EDGES``, float32 and
    bfloat16 diagonals: the Identity and a seeded inverse diagonal (folded
    into A M, applied in the x update) to the threshold, implicit mode, 0
    and 1 iterations from a seeded x0, and a NaN in b (both run to the
    cap).  Each case twice; the iterations, the stop flag, x, r and the
    monitor bit for bit.  The float32 cases must converge; CGS diverges
    from some right-hand sides on the bfloat16-rounded bands (band6's
    Identity case, the plain version alike), which are held to the bits
    alone.  Returns the rows it emitted."""
    from ginkgo_tpu_torch.ops import cgs as ops_cgs
    from ginkgo_tpu_torch.solver._fused_gate import fold_minv

    rows = []
    for label, A32 in dia_sweep_edge_operators(gt, dev).items():
        n = A32.shape[0]
        b = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
        x0 = torch.as_tensor(rng.uniform(-0.1, 0.1, n).astype(np.float32), device=dev)
        z = torch.zeros_like(b)
        tol = torch.full((), (TOL * float(b.double().norm())) ** 2, device=dev)
        minv = torch.as_tensor(rng.uniform(0.15, 0.3, n).astype(np.float32), device=dev)
        nan_b = b.clone()
        nan_b[n // 2] = float("nan")
        row = {"phase": "kernel_check", "kernel": "cgs_fused", "matrix": label, "rows": n,
               "diagonals": len(A32.offsets)}
        for storage, A in (("f32", A32), ("bf16", A32.reduce_storage())):
            folded = fold_minv(A, minv)
            for what, r0, start, mv, cap, imp in (
                    ("identity", b, z, None, 500, False), ("minv", b, z, minv, 500, False),
                    ("implicit", b, z, None, 500, True), ("0 iterations", b, x0, minv, 0, False),
                    ("1 iteration", b, x0, None, 1, False), ("nan b", nan_b, z, None, 7, False)):
                kw = dict(tol_sq_eff=tol, max_iters=cap, use_implicit=imp)
                args = (A.diags if mv is None else folded, A.offsets, r0, start, mv)
                got = ops_cgs.cgs_fused(*args, **kw)
                again = ops_cgs.cgs_fused(*args, **kw)
                want = ops_cgs.cgs_solve_reference(*args, **kw)
                _sync(dev)
                case = f"cgs_fused {label} {storage} {what}"
                kit, pit = int(got[2]), int(want[2])
                check(kit == pit == int(again[2]) and bool(got[4]) == bool(want[4]),
                      f"{case}: {kit} / {pit} iterations, converged {bool(got[4])} / "
                      f"{bool(want[4])}")
                check(all(bit_equal(got[j], want[j]) and bit_equal(got[j], again[j])
                          for j in (0, 1, 3)), f"{case}: x, r or the monitor differs")
                if what == "nan b":
                    check(kit == cap and not bool(got[4]), f"{case}: stopped at {kit}")
                elif cap <= 1:
                    check(kit == cap, f"{case}: {kit} iterations")
                elif storage == "f32":
                    check(bool(got[4]), f"{case}: not converged")
                if record_err is not None and what != "nan b":
                    record_err("cgs_fused", got[0], want[0])
                row[f"{storage} {what}"] = kit if bool(got[4]) or cap <= 7 else "diverged"
        rows.append(row)
        emit(row)
    return rows

def check_gmres_edges(gt, dev, rng, record_err=None):
    """K15 and K18 against their plain versions at small sizes: K15 on A2's
    operator at 64^2 (fewer tiles than the grid has blocks) and 701^2
    (491,401 rows, not a multiple of a tile nor of 4), K18 on it at 64^2 as
    a Pell and on the shifted 3-D Poisson matrix at 23^3 (12,167 rows) and
    24^3; m = 1, 2, 5, 30 and 100, a float32 and a bfloat16 basis, the
    Identity and Jacobi, bfloat16 Pell values and int32 lane indices, and a
    NaN in b (both run to the cap).  Each case must take the plain
    version's steps and stop flag, and x and the true r.r bit for bit;
    among the solves that converge one must restart and stop inside a later
    cycle.  Returns the rows it emitted."""
    from ginkgo_tpu_torch.ops import gmres as ops_gmres

    dia = {nside: gt.Dia.from_matrix_data(gt.MatrixData.from_coo(*convdiff_2d(nside)),
                                          device=dev) for nside in (SMALL, 701)}
    C64 = gt.Csr.from_matrix_data(gt.MatrixData.from_coo(*convdiff_2d(SMALL)), device=dev)
    C23 = gt.Csr.from_matrix_data(shifted_poisson_3d(gt, SMALL3 - 1), device=dev)
    C24 = gt.Csr.from_matrix_data(shifted_poisson_3d(gt, SMALL3), device=dev)
    pell = {
        f"convdiff_2d({SMALL}), f32/i8": gt.Pell.from_csr(C64),
        f"convdiff_2d({SMALL}), bf16/i32": gt.Pell.from_csr(
            C64, q_dtype=np.int32).astype(torch.bfloat16),
        f"poisson_3d_shifted({SMALL3 - 1}), f32/i32": gt.Pell.from_csr(C23, q_dtype=np.int32),
        f"poisson_3d_shifted({SMALL3}), bf16/i8": gt.Pell.from_csr(C24).reduce_storage(),
    }
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (kernel, operator, m, basis, Jacobi, cap, NaN in b)
        ("gmres_fused", SMALL, 1, f32, False, 400, False),
        ("gmres_fused", SMALL, 2, bf16, True, 400, False),
        ("gmres_fused", SMALL, 30, f32, False, 400, False),
        ("gmres_fused", SMALL, 100, f32, True, 400, False),
        ("gmres_fused", SMALL, 30, f32, False, 25, True),
        ("gmres_fused", 701, 30, bf16, False, 400, False),
        ("gmres_fused", 701, 30, f32, True, 400, False),
        ("pell_gmres_fused", f"convdiff_2d({SMALL}), f32/i8", 30, f32, False, 400, False),
        ("pell_gmres_fused", f"convdiff_2d({SMALL}), bf16/i32", 5, bf16, True, 400, False),
        ("pell_gmres_fused", f"poisson_3d_shifted({SMALL3 - 1}), f32/i32", 100, f32, False, 400,
         False),
        ("pell_gmres_fused", f"poisson_3d_shifted({SMALL3 - 1}), f32/i32", 1, f32, True, 400,
         False),
        ("pell_gmres_fused", f"poisson_3d_shifted({SMALL3}), bf16/i8", 2, bf16, False, 25, True),
    ]
    rows = []
    for kernel, op, m, basis, jacobi, cap, nan in cases:
        A = dia[op] if kernel == "gmres_fused" else pell[op]
        n = A.shape[0]
        b = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
        if nan:
            b[n // 3] = float("nan")
        z = torch.zeros_like(b)
        tol = torch.full((), (TOL * float(b.double().nan_to_num().norm())) ** 2, device=dev)
        minv = (1.0 / A.extract_diagonal().values.float()).contiguous() if jacobi else None
        kw = dict(m=m, tol_sq_eff=tol, max_iters=cap, basis_dtype=basis)
        if kernel == "gmres_fused":
            got = ops_gmres.gmres_fused(A.diags, A.offsets, b, z, minv, **kw)
            want = ops_gmres.gmres_solve_reference(A.diags, A.offsets, b, z, minv, **kw)
        else:
            got = ops_gmres.pell_gmres_fused(A, b, z, minv, **kw)
            want = ops_gmres.pell_gmres_solve_reference(A, b, z, minv, **kw)
        _sync(dev)
        case = (f"{kernel} {op if isinstance(op, str) else f'convdiff_2d({op})'} m={m} "
                f"{str(basis)[6:]} basis{' jacobi' if jacobi else ''}{' nan' if nan else ''}")
        kit, pit = int(got[1]), int(want[1])
        kconv, pconv = bool(got[3]), bool(want[3])
        check(kit == pit and kconv == pconv,
              f"{case}: {kit} / {pit} steps, converged {kconv} / {pconv}")
        if nan:
            check(kit == cap and not kconv, f"{case}: stopped at {kit}")
        else:
            check(bit_equal(got[0], want[0]) and bit_equal(got[2], want[2]),
                  f"{case}: x or the true r.r differs (x by "
                  f"{float((got[0] - want[0]).abs().max())})")
            if record_err is not None and kconv:
                record_err(kernel, got[0], want[0])
        rows.append({"phase": "kernel_check", "kernel": kernel, "case": case, "rows": n, "m": m,
                     "steps": kit, "converged": kconv, "true_rr": float(got[2])})
        emit(rows[-1])
    check(any(r["converged"] and r["steps"] > r["m"] and r["steps"] % r["m"] != 0 for r in rows),
          "gmres edges: no solve restarted and stopped inside a later cycle")
    return rows


def time_path4(gt, dev, p4, rec, timing):
    """Per-iteration times on A1 (the 2048^2 Poisson matrix of path 1) by
    the slope between whole solves: K12-K14 fused between Iteration(200)
    and Iteration(1000), streaming between 25 and 125 (STREAM_TRIPS), their
    plain versions between PLAIN_TRIPS; K15 per Arnoldi step
    between Iteration(60) and Iteration(240) (the JAX bench's trip counts,
    two and eight restart cycles of 30) with a float32 and a bfloat16
    basis, streaming between 30 and 90, the plain version between 15 and
    30.

    Bounds per iteration (each input read once, each output written once,
    the iteration's carried vectors in and out): BiCGSTAB and CGS read the
    diagonals, rr and four carried vectors and write those four (x, r, p,
    v; x, r, q, p): (4 nd + 36) n bytes, (4 nd + 22) n and (4 nd + 19) n
    operations; BiCG reads both stacks and five carried vectors and writes
    them: (4 (nd + nd_t) + 40) n bytes, (2 (nd + nd_t) + 16) n operations.
    GMRES(30) per step, averaged over a cycle: step j reads the diagonals
    and basis rows 0..j and writes row j + 1; the cycle's end reads the 30
    rows, x and b and writes x."""
    from ginkgo_tpu_torch import stop
    from ginkgo_tpu_torch.ops import bicgstab as ops_bicgstab
    from ginkgo_tpu_torch.ops import cgs as ops_cgs
    from ginkgo_tpu_torch.ops import gmres as ops_gmres

    A1, b1 = p4["A1"], p4["b1"]
    n = A1.shape[0]
    z = torch.zeros_like(b1)
    z2 = torch.zeros(n, 1, device=dev)
    nd = len(A1.offsets)
    solvers = {name: cls.build(criteria=[stop.Iteration(max_iters=1)], **params).generate(A1)
               for name, (cls, params, _) in path4_solvers(gt).items()}
    At1 = solvers["bicg"].At
    ndt = len(At1.offsets)

    def capped(solver, its):
        return solver.replace(criterion=stop.Iteration(max_iters=its))

    def fused(name, **params):
        return lambda its: capped(solvers[name].replace(**params), its).solve(b1)

    def streaming(name):
        def run(its):
            with torch.no_grad():
                capped(solvers[name], its)._solve_streaming(b1[:, None], z2)
        return run

    kw = dict(tol_sq_eff=-1.0)
    plains = {
        "bicgstab": lambda its: ops_bicgstab.bicgstab_solve_reference(
            A1.diags, A1.offsets, b1, z, None, max_iters=its, **kw),
        "cgs": lambda its: ops_cgs.cgs_solve_reference(
            A1.diags, A1.offsets, b1, z, None, max_iters=its, **kw),
        "bicg": lambda its: ops_cgs.bicg_solve_reference(
            A1.diags, A1.offsets, At1.diags, At1.offsets, b1, z, None, max_iters=its, **kw),
        "gmres": lambda its: ops_gmres.gmres_solve_reference(
            A1.diags, A1.offsets, b1, z, None, m=KRYLOV_DIM, max_iters=its, **kw),
    }
    per_iter = {
        "bicgstab": ((4 * nd + 36) * n, (4 * nd + 22) * n),
        "cgs": ((4 * nd + 36) * n, (4 * nd + 19) * n),
        "bicg": ((4 * (nd + ndt) + 40) * n, (2 * (nd + ndt) + 16) * n),
    }
    out = {"matrix": f"poisson_2d({NSIDE})", "card": timing["card"]}
    for name, (nbytes, flops) in per_iter.items():
        f_ms, s_ms = iter_ms(fused(name)), iter_ms(streaming(name), *STREAM_TRIPS)
        p_ms = iter_ms(plains[name], *PLAIN_TRIPS)
        kname = path4_solvers(gt)[name][2]
        rec[kname] = (f_ms, p_ms, None, nbytes, flops)
        out[kname] = {"fused_us": f_ms * 1e3, "streaming_us": s_ms * 1e3, "plain_us": p_ms * 1e3,
                      "GBps": nbytes / f_ms / 1e6}
    m = KRYLOV_DIM
    gm = {}
    for label, basis, vb in (("f32", "keep", 4), ("bf16", "reduce1", 2)):
        cycle_bytes = sum((4 * nd + (j + 2) * vb) * n for j in range(m)) + (4 * nd + m * vb + 12) * n
        cycle_flops = sum((2 * nd + 8 * (j + 1) + 3) * n for j in range(m)) + (2 * nd + 2 * m + 2) * n
        ms = iter_ms(fused("gmres", storage_precision=basis), 60, 240)
        gm[label] = {"fused_us_per_step": ms * 1e3, "bytes_per_step": cycle_bytes / m,
                     "GBps": cycle_bytes / m / ms / 1e6}
        if label == "f32":
            gm["streaming_us_per_step"] = iter_ms(streaming("gmres"), 30, 90) * 1e3
            p_ms = iter_ms(plains["gmres"], *PLAIN_GMRES_TRIPS)
            gm["plain_us_per_step"] = p_ms * 1e3
            rec["gmres_fused"] = (ms, p_ms, None, cycle_bytes / m, cycle_flops / m)
    out["gmres_fused"] = gm
    timing["krylov_us_per_iter"] = out


@contextlib.contextmanager
def outputs_of(module, name):
    """Keep the keyword arguments and outputs of ``module.name`` while the
    main path calls it: a solve's per-column stop iterations, which
    SolveInfo does not carry.  The wrapper itself still runs, and counts."""
    fn = getattr(module, name)
    seen = []

    def spy(*args, **kwargs):
        out = fn(*args, **kwargs)
        seen.append((kwargs, out))
        return out

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def main_path5(gt, dev, rng, crit, kernels, p4):
    """Main path 5 through the entry points a user calls; every check
    raises.  On A2 (path 4's convection-diffusion Dia, float32 and bfloat16
    diagonals): Bicgstab and Gmres(30) with k = 4 columns fused with
    float32 and bfloat16 diagonals and with scalar Jacobi (K12m, K15m),
    CbGmres "auto" with k = 4 (K15m with a bfloat16 basis), both streaming
    with k = 4; Idr(2) and Idr(4) fused (K16) the same three ways and
    streaming; Ir with scalar Jacobi, relaxation 1.0, fused f32 and bf16,
    with an Identity inner solver and relaxation 0.2 fused (K17), and Jacobi
    streaming.  Every solution is held against a float64 solve of the
    system it solved, column by column.  Then the declined routes at 64^2,
    by launch counters."""
    from ginkgo_tpu_torch import stop
    from ginkgo_tpu_torch.solver import bicgstab as sol_bicgstab
    from ginkgo_tpu_torch.solver import gmres as sol_gmres

    A, Ab, b, refs, norm_a = p4["A"], p4["Ab"], p4["b"], p4["refs"], p4["norm_a"]
    n = A.shape[0]
    B = rhs4(n, rng, dev)
    Z = torch.zeros_like(B)
    f64_crit = [stop.Iteration(max_iters=MAX_ITERS), stop.ResidualNorm(tolerance=1e-10)]
    refs4 = {}
    for storage, Av in (("f32", A), ("bf16", Ab)):
        # streaming BiCGSTAB in float64 on the four columns (K3 with
        # float64 vectors)
        t0 = time.perf_counter()
        refs4[storage], info = gt.Bicgstab.build(criteria=f64_crit).generate(
            Av.astype(torch.float64)).solve(B.double())
        _sync(dev)
        check(bool(info.converged.all()), f"path 5: float64 k=4 reference ({storage}): not converged")
        emit({"phase": "main_path", "path": 5, "route": "streaming",
              "case": f"f64_reference_k4_{storage}", "iterations": info.num_iterations,
              "solve_s": round(time.perf_counter() - t0, 4)})
    jac = gt.Jacobi.build(max_block_size=1)
    three = (("f32", A, None, "f32"), ("bf16", Ab, None, "bf16"), ("f32_jacobi", A, jac, "f32"))

    # k = 4 columns: K12m and K15m
    cols = {"bicgstab": (gt.Bicgstab, {}, sol_bicgstab, "bicgstab_fused_multi", 5),
            "gmres": (gt.Gmres, {"krylov_dim": KRYLOV_DIM}, sol_gmres, "gmres_fused_multi", 4)}
    for name, (cls, params, module, kname, itc_at) in cols.items():
        kern = kernels[kname]
        for case, Av, pre, ref in three:
            solver = cls.build(criteria=crit, preconditioner=pre, **params).generate(Av)
            before = kern.launches
            t0 = time.perf_counter()
            with outputs_of(module, kname) as seen:
                X, info = solver.solve(B)
            _sync(dev)
            solve_s = time.perf_counter() - t0
            label = f"path 5: {name} k=4 {case}"
            check(kern.launches == before + 1 and len(seen) == 1, f"{label} did not run {kname}")
            check(bool(info.converged.all()), f"{label}: converged {info.converged.tolist()}")
            check(X.shape == (n, 4), f"{label}: bad x")
            emit({"phase": "main_path", "path": 5, "route": "fused", "solver": name, "k": 4,
                  "case": case, "iterations": info.num_iterations,
                  "column_iterations": seen[0][1][itc_at].tolist(),
                  "residual_norm": info.residual_norm.tolist(),
                  **accuracy(Av, X, B, refs4[ref], norm_a, label), "solve_s": round(solve_s, 4)})
        solver = cls.build(criteria=crit, **params).generate(A)
        t0 = time.perf_counter()
        with torch.no_grad():
            Xs, sinfo = solver._solve_streaming(B, Z)
        _sync(dev)
        label = f"path 5: {name} k=4 streaming"
        check(bool(sinfo.converged.all()), f"{label}: converged {sinfo.converged.tolist()}")
        emit({"phase": "main_path", "path": 5, "route": "streaming", "solver": name, "k": 4,
              "case": "f32", "iterations": sinfo.num_iterations,
              **accuracy(A, Xs, B, refs4["f32"], norm_a, label),
              "solve_s": round(time.perf_counter() - t0, 4)})

    solver = gt.CbGmres.build(criteria=crit, krylov_dim=KRYLOV_DIM).generate(A)
    check(solver._resolved_mode() == "reduce1", "path 5: CbGmres 'auto' did not resolve to reduce1")
    t0 = time.perf_counter()
    with outputs_of(sol_gmres, "gmres_fused_multi") as seen:
        X, info = solver.solve(B)
    _sync(dev)
    label = "path 5: CbGmres auto k=4"
    check(len(seen) == 1 and seen[0][0]["basis_dtype"] == torch.bfloat16,
          f"{label} did not run gmres_fused_multi with a bfloat16 basis")
    check(bool(info.converged.all()), f"{label}: converged {info.converged.tolist()}")
    emit({"phase": "main_path", "path": 5, "route": "fused", "solver": "cbgmres", "k": 4,
          "case": "auto", "resolved": "reduce1", "iterations": info.num_iterations,
          "column_iterations": seen[0][1][4].tolist(),
          **accuracy(A, X, B, refs4["f32"], norm_a, label),
          "solve_s": round(time.perf_counter() - t0, 4)})

    # one column: IDR(s) (K16) and IR (K17)
    z = torch.zeros_like(b)
    for sdim in (2, 4):
        for case, Av, pre, ref in three:
            t0 = time.perf_counter()
            solver = gt.Idr.build(criteria=crit, preconditioner=pre, subspace_dim=sdim).generate(Av)
            generate_s = time.perf_counter() - t0
            before = kernels["idr_fused"].launches
            t0 = time.perf_counter()
            x, info = solver.solve(b)
            _sync(dev)
            label = f"path 5: idr({sdim}) {case}"
            check(kernels["idr_fused"].launches == before + 1, f"{label} did not run idr_fused")
            check(bool(info.converged.all()), f"{label}: not converged")
            emit({"phase": "main_path", "path": 5, "route": "fused", "solver": f"idr({sdim})",
                  "case": case, "iterations": info.num_iterations,
                  "residual_norm": float(info.residual_norm[0]),
                  **accuracy(Av, x, b, refs[ref], norm_a, label),
                  "generate_s": round(generate_s, 4),
                  "solve_s": round(time.perf_counter() - t0, 4)})
        solver = gt.Idr.build(criteria=crit, subspace_dim=sdim).generate(A)
        t0 = time.perf_counter()
        with torch.no_grad():
            x, it, stopped, _rn = solver._solve_single(b, z)
        _sync(dev)
        label = f"path 5: idr({sdim}) streaming"
        check(bool(stopped), f"{label}: not converged")
        emit({"phase": "main_path", "path": 5, "route": "streaming", "solver": f"idr({sdim})",
              "case": "f32", "iterations": int(it), **accuracy(A, x, b, refs["f32"], norm_a, label),
              "solve_s": round(time.perf_counter() - t0, 4)})

    for case, Av, pre, omega, ref in (("f32_jacobi", A, jac, 1.0, "f32"),
                                      ("bf16_jacobi", Ab, jac, 1.0, "bf16"),
                                      ("f32_identity", A, None, 0.2, "f32")):
        solver = gt.Ir.build(criteria=crit, preconditioner=pre,
                             relaxation_factor=omega).generate(Av)
        before = kernels["ir_fused"].launches
        t0 = time.perf_counter()
        x, info = solver.solve(b)
        _sync(dev)
        label = f"path 5: ir {case}"
        check(kernels["ir_fused"].launches == before + 1, f"{label} did not run ir_fused")
        check(bool(info.converged.all()), f"{label}: not converged")
        emit({"phase": "main_path", "path": 5, "route": "fused", "solver": "ir", "case": case,
              "relaxation_factor": omega, "iterations": info.num_iterations,
              "residual_norm": float(info.residual_norm[0]),
              **accuracy(Av, x, b, refs[ref], norm_a, label),
              "solve_s": round(time.perf_counter() - t0, 4)})
    solver = gt.Ir.build(criteria=crit, preconditioner=jac).generate(A)
    t0 = time.perf_counter()
    with torch.no_grad():
        xs, sinfo = solver._solve_streaming(b[:, None], z[:, None])
    _sync(dev)
    check(bool(sinfo.converged.all()), "path 5: ir streaming: not converged")
    emit({"phase": "main_path", "path": 5, "route": "streaming", "solver": "ir",
          "case": "f32_jacobi", "iterations": sinfo.num_iterations,
          **accuracy(A, xs[:, 0], b, refs["f32"], norm_a, "path 5: ir streaming"),
          "solve_s": round(time.perf_counter() - t0, 4)})

    # the routes that stream, at 64^2: no kernel of the slice runs for them
    A64 = gt.Dia.from_matrix_data(gt.MatrixData.from_coo(*convdiff_2d(SMALL)), device=dev)
    n64 = A64.shape[0]
    short = [stop.Iteration(max_iters=200), stop.ResidualNorm(tolerance=1e-4)]
    implicit = [stop.Iteration(max_iters=30), stop.ImplicitResidualNorm(tolerance=TOL)]
    declined = (
        ("bicgstab k=9", gt.Bicgstab.build(criteria=short), 9, "bicgstab_fused_multi"),
        ("gmres k=5", gt.Gmres.build(criteria=short, krylov_dim=KRYLOV_DIM), 5,
         "gmres_fused_multi"),
        ("idr(5)", gt.Idr.build(criteria=short, subspace_dim=5), 1, "idr_fused"),
        ("ir implicit", gt.Ir.build(criteria=implicit, preconditioner=jac), 1, "ir_fused"),
        ("cgs k=4", gt.Cgs.build(criteria=short), 4, "cgs_fused"),
    )
    row = {"phase": "main_path", "path": 5, "case": "declined_routes", "nside": SMALL}
    for label, factory, k, kname in declined:
        before = {name: f.launches for name, f in kernels.items()}
        spmv = kernels["dia_spmv"].launches + kernels["dia_spmm"].launches
        X, info = factory.generate(A64).solve(torch.ones(n64, k, device=dev))
        _sync(dev)
        fused = [name for name in (*PATH4, *PATH5)
                 if kernels[name].launches != before[name]]
        check(not fused and kernels["dia_spmv"].launches + kernels["dia_spmm"].launches > spmv,
              f"path 5: {label} did not stream (fused kernels run: {fused})")
        check(X.shape == (n64, k) and bool(torch.isfinite(X).all()), f"path 5: {label}: bad x")
        row[label] = {"streams": True, "iterations": info.num_iterations,
                      "converged": info.converged.tolist()}
    emit(row)
    return {"B": B, "refs4": refs4}


def check_path5_kernels(gt, dev, rng, p4, p5, kernels, record_err):
    """K12m, K15m, K16, K17 and ir_smooth against their plain versions on
    A2 at 64^2 and at 2048^2: K12m with float32 and bfloat16 diagonals,
    with and without an inverse diagonal (folded into A M), and implicit,
    on four columns that stop at different iterations; K15m with a float32
    and a bfloat16 basis, with and without an inverse diagonal, where a
    column stops inside a cycle while another runs on; K16 with s = 1, 2, 4
    on float32 diagonals and on bfloat16 diagonals with an inverse
    diagonal; K17 with the Identity (relaxation 0.2) and an inverse
    diagonal (1.0); ir_smooth from zero and from x0, with and without the
    residual, 1 and 3 sweeps.  Then a NaN in b per kernel at 2048^2, which
    must run to the cap on both (for k columns, the NaN column only).

    Every kernel runs twice and must equal itself bit for bit, and then its
    plain version: the same iteration and per-column stop counts and x bit
    for bit (K17: r and r.r too).  (The plain versions' host-side square
    roots are correctly rounded, as the kernels' sqrtf is: ops/cg._sqrt.)"""
    from ginkgo_tpu_torch.ops import bicgstab as ops_bicgstab
    from ginkgo_tpu_torch.ops import gmres as ops_gmres
    from ginkgo_tpu_torch.ops import idr as ops_idr
    from ginkgo_tpu_torch.ops import ir as ops_ir
    from ginkgo_tpu_torch.solver._fused_gate import fold_minv

    def outcome(name, out):
        """(x, iterations, per-column stop iterations or None, converged)."""
        if name == "bicgstab_fused_multi":
            return out[0], int(out[2]), out[5].tolist(), out[4].tolist()
        if name == "gmres_fused_multi":
            return out[0], int(out[1]), out[4].tolist(), out[3].tolist()
        return out[0], int(out[2]), None, [bool(out[4])]

    def compare(name, label, kern, plain, nan_col=None, cap=None):
        t0 = time.perf_counter()
        kout = kern()
        kx, kit, kitc, kconv = outcome(name, kout)
        _sync(dev)
        k_s = time.perf_counter() - t0
        kx2, kit2, kitc2, _ = outcome(name, kern())
        t0 = time.perf_counter()
        pout = plain()
        px, pit, pitc, pconv = outcome(name, pout)
        _sync(dev)
        p_s = time.perf_counter() - t0
        what = f"{name} {label}"
        check(kit2 == kit and kitc2 == kitc and (torch.equal(kx2, kx) or cap is not None),
              f"{what}: the kernel differs from itself")
        row = {"iters": kit, "plain_iters": pit, "column_iters": kitc, "plain_column_iters": pitc,
               "s": round(k_s, 4), "plain_s": round(p_s, 4)}
        if cap is not None:  # a NaN in b: that column runs to the cap on both
            its = (kit, pit) if nan_col is None else (kitc[nan_col], pitc[nan_col])
            check(its == (cap, cap) and not kconv[nan_col or 0] and not pconv[nan_col or 0],
                  f"{what}: with a NaN, {its} iterations, converged {kconv} / {pconv}")
            return row
        row.update(bit_equal=bool(torch.equal(kx, px)), x_max_abs_err=record_err(name, kx, px))
        check(all(kconv) and all(pconv), f"{what}: not converged ({kconv}, {pconv})")
        check(kit == pit and kitc == pitc and row["bit_equal"],
              f"{what}: {kit} / {pit} iterations, {kitc} / {pitc}, x differs by "
              f"{row['x_max_abs_err']}")
        if name == "ir_fused":  # r and r.r too
            check(bit_equal(kout[1], pout[1]) and bit_equal(kout[3], pout[3]),
                  f"{what}: r or r.r differs")
        return row

    minv_big = torch.as_tensor(rng.uniform(0.15, 0.3, p4["A"].shape[0]).astype(np.float32),
                               device=dev)
    A64 = gt.Dia.from_matrix_data(gt.MatrixData.from_coo(*convdiff_2d(SMALL)), device=dev)
    B64 = rhs4(A64.shape[0], rng, dev)
    minv64 = torch.as_tensor(rng.uniform(0.15, 0.3, A64.shape[0]).astype(np.float32), device=dev)
    for nside, A, B, minv in ((SMALL, A64, B64, minv64), (NSIDE, p4["A"], p5["B"], minv_big)):
        Ab = A.reduce_storage()
        b = B[:, 1].contiguous()
        z, Z = torch.zeros_like(b), torch.zeros_like(B)
        tol4 = ((TOL * B.norm(dim=0)) ** 2).contiguous()
        tol1 = torch.full((), (TOL * float(b.norm())) ** 2, dtype=torch.float32, device=dev)
        row = {"phase": "kernel_check", "path": 5, "matrix": f"convdiff_2d({nside})"}
        for storage, Av in (("f32", A), ("bf16", Ab)):
            for pre_label, pre in (("identity", None), ("minv", minv)):
                D = Av.diags if pre is None else fold_minv(Av, pre)
                implicit_cases = (False, True) if (storage, pre) == ("f32", None) else (False,)
                for implicit in implicit_cases:
                    kw = dict(tol_sq_eff=tol4, max_iters=MAX_ITERS, use_implicit=implicit)
                    row[f"bicgstab_fused_multi {storage} {pre_label}{' implicit' * implicit}"] = compare(
                        "bicgstab_fused_multi", f"{nside} {storage} {pre_label} {implicit}",
                        lambda D=D, Av=Av, pre=pre, kw=kw: ops_bicgstab.bicgstab_fused_multi(
                            D, Av.offsets, B, Z, pre, **kw),
                        lambda D=D, Av=Av, pre=pre, kw=kw: ops_bicgstab.bicgstab_solve_multi_reference(
                            D, Av.offsets, B, Z, pre, **kw),
                    )
                if storage == "bf16":
                    continue
                for basis in (torch.float32, torch.bfloat16):
                    kw = dict(m=KRYLOV_DIM, tol_sq_eff=tol4, max_iters=MAX_ITERS, basis_dtype=basis)
                    key = f"gmres_fused_multi {str(basis)[6:]} basis {pre_label}"
                    row[key] = compare(
                        "gmres_fused_multi", f"{nside} {key}",
                        lambda pre=pre, kw=kw: ops_gmres.gmres_fused_multi(
                            Av.diags, Av.offsets, B, Z, pre, **kw),
                        lambda pre=pre, kw=kw: ops_gmres.gmres_solve_multi_reference(
                            Av.diags, Av.offsets, B, Z, pre, **kw),
                    )
                    itc, it = row[key]["column_iters"], row[key]["iters"]
                    # a column stopped inside a cycle that another ran on in
                    row[key]["mid_cycle_stop"] = any(
                        c < it and (c - 1) // KRYLOV_DIM == (d - 1) // KRYLOV_DIM
                        for c in itc for d in itc if d > c)
            pre_label, pre = ("identity", None) if storage == "f32" else ("minv", minv)
            for sdim in (1, 2, 4):
                P = gt.Idr.build(criteria=None, subspace_dim=sdim).generate(A).P
                kw = dict(kappa=0.7, tol_sq_eff=tol1, max_iters=MAX_ITERS)
                row[f"idr_fused s={sdim} {storage} {pre_label}"] = compare(
                    "idr_fused", f"{nside} s={sdim} {storage} {pre_label}",
                    lambda P=P, Av=Av, pre=pre, kw=kw: ops_idr.idr_fused(
                        Av.diags, Av.offsets, P, b, z, b, pre, **kw),
                    lambda P=P, Av=Av, pre=pre, kw=kw: ops_idr.idr_solve_reference(
                        Av.diags, Av.offsets, P, b, z, b, pre, **kw),
                )
        inv_diag = 1.0 / A.extract_diagonal().values.float()
        for pre_label, pre, omega in (("identity", None, 0.2), ("minv", inv_diag, 1.0)):
            kw = dict(omega=omega, tol_sq_eff=tol1, max_iters=MAX_ITERS)
            row[f"ir_fused {pre_label}"] = compare(
                "ir_fused", f"{nside} {pre_label}",
                lambda pre=pre, kw=kw: ops_ir.ir_fused(A.diags, A.offsets, b, z, pre, **kw),
                lambda pre=pre, kw=kw: ops_ir.ir_solve_reference(A.diags, A.offsets, b, z, pre,
                                                                 **kw),
            )
        # the smoother: no dots, so x (and r when asked for) bit for bit
        x0 = torch.as_tensor(rng.standard_normal(A.shape[0]).astype(np.float32), device=dev)
        before = kernels["ir_smooth"].launches
        for start, xs in (("zero", None), ("x0", x0)):
            for with_r in (False, True):
                for iters in (1, 3):
                    kw = dict(omega=0.8, iters=iters, with_residual=with_r)
                    kx, kr = ops_ir.ir_smooth(A.diags, A.offsets, b, xs, inv_diag, **kw)
                    px, pr = ops_ir.ir_smooth_reference(A.diags, A.offsets, b, xs, inv_diag, **kw)
                    _sync(dev)
                    err = record_err("ir_smooth", kx, px)
                    what = f"ir_smooth {nside} from {start}, residual {with_r}, {iters} sweeps"
                    check(torch.equal(kx, px) and (not with_r or torch.equal(kr, pr)),
                          f"{what}: x differs by {err}")
                    row[f"ir_smooth {start} r={with_r} iters={iters}"] = {"bit_equal": True}
        check(kernels["ir_smooth"].launches == before + 8,
              f"ir_smooth launched {kernels['ir_smooth'].launches - before} times, not 8")
        if nside == NSIDE:
            mid = [v["mid_cycle_stop"] for key, v in row.items() if key.startswith("gmres")]
            check(any(mid), "gmres_fused_multi: no case stopped a column inside a cycle")
        emit(row)

    # a NaN in b keeps its monitor NaN: it runs to the cap on both
    A, B = p4["A"], p5["B"]
    b = B[:, 1].contiguous()
    z, Z = torch.zeros_like(b), torch.zeros_like(B)
    Bn, bn = B.clone(), b.clone()
    Bn[5, 1] = float("nan")
    bn[5] = float("nan")
    tol4 = ((TOL * B.norm(dim=0)) ** 2).contiguous()
    tol1 = torch.full((), (TOL * float(b.norm())) ** 2, dtype=torch.float32, device=dev)
    inv_diag = 1.0 / A.extract_diagonal().values.float()
    P = gt.Idr.build(criteria=None, subspace_dim=2).generate(A).P
    cap = 25
    row = {"phase": "kernel_check", "path": 5, "case": "nan_rhs_runs_to_cap", "cap": cap}
    cases = {
        "bicgstab_fused_multi": (
            lambda: ops_bicgstab.bicgstab_fused_multi(A.diags, A.offsets, Bn, Z, None,
                                                      tol_sq_eff=tol4, max_iters=cap),
            lambda: ops_bicgstab.bicgstab_solve_multi_reference(A.diags, A.offsets, Bn, Z, None,
                                                                tol_sq_eff=tol4, max_iters=cap),
            1),
        "gmres_fused_multi": (
            lambda: ops_gmres.gmres_fused_multi(A.diags, A.offsets, Bn, Z, None, m=KRYLOV_DIM,
                                                tol_sq_eff=tol4, max_iters=cap),
            lambda: ops_gmres.gmres_solve_multi_reference(A.diags, A.offsets, Bn, Z, None,
                                                          m=KRYLOV_DIM, tol_sq_eff=tol4,
                                                          max_iters=cap),
            1),
        "idr_fused": (
            lambda: ops_idr.idr_fused(A.diags, A.offsets, P, bn, z, bn, None, kappa=0.7,
                                      tol_sq_eff=tol1, max_iters=cap),
            lambda: ops_idr.idr_solve_reference(A.diags, A.offsets, P, bn, z, bn, None,
                                                kappa=0.7, tol_sq_eff=tol1, max_iters=cap),
            None),
        "ir_fused": (
            lambda: ops_ir.ir_fused(A.diags, A.offsets, bn, z, inv_diag, omega=1.0,
                                    tol_sq_eff=tol1, max_iters=cap),
            lambda: ops_ir.ir_solve_reference(A.diags, A.offsets, bn, z, inv_diag, omega=1.0,
                                              tol_sq_eff=tol1, max_iters=cap),
            None),
    }
    for name, (kern, plain, nan_col) in cases.items():
        row[name] = compare(name, "nan", kern, plain, nan_col=nan_col, cap=cap)
    emit(row)


def time_path5(gt, dev, p4, rec, timing):
    """Per-iteration times on A1 (the 2048^2 Poisson matrix of path 1) by
    the slope between whole solves with Iteration-only criteria: K12m (k =
    4) per iteration and K17 (scalar Jacobi, relaxation 1.0) per sweep
    between Iteration(200) and Iteration(1000); K16 per outer iteration for
    s = 2 and s = 4, 200 to 1000; K15m (k = 4, m = 30) per Arnoldi step, 60
    to 240, with a float32 and a bfloat16 basis; ir_smooth per sweep between
    calls of 20 and 100 sweeps; each beside its streaming route and its
    plain version (fewer trips where those sync the host every step).

    Bounds, each input read once and each carried vector read and written
    once per iteration: K12m (4 nd + 36 k) n bytes, (4 nd + 22) k n
    operations; K15m per step K15's cycle model with the vectors k wide;
    K16 (4 nd + 20 s + 20) n bytes (diagonals, P and b in; x, r, G and U
    in and out); K17 and ir_smooth (4 nd + 16) n bytes a sweep (diagonals,
    x_j, b and minv in, x_{j+1} out: r is used at once on the rows that
    form it and is not stored in a sweep; counted with r in and out, as
    the bound stood before the one-pass sweep, (4 nd + 24) n)."""
    from ginkgo_tpu_torch import stop
    from ginkgo_tpu_torch.ops import bicgstab as ops_bicgstab
    from ginkgo_tpu_torch.ops import gmres as ops_gmres
    from ginkgo_tpu_torch.ops import idr as ops_idr
    from ginkgo_tpu_torch.ops import ir as ops_ir

    A1, b1 = p4["A1"], p4["b1"]
    n, nd, k, m = A1.shape[0], len(A1.offsets), 4, KRYLOV_DIM
    B1 = rhs4(n, np.random.default_rng(SEED + 5), dev)
    Z, z = torch.zeros_like(B1), torch.zeros_like(b1)
    inv_diag = 1.0 / A1.extract_diagonal().values.float()
    jac = gt.Jacobi.build(max_block_size=1)
    one = [stop.Iteration(max_iters=1)]
    solvers = {
        "bicgstab": gt.Bicgstab.build(criteria=one).generate(A1),
        "gmres": gt.Gmres.build(criteria=one, krylov_dim=m).generate(A1),
        "idr2": gt.Idr.build(criteria=one, subspace_dim=2).generate(A1),
        "idr4": gt.Idr.build(criteria=one, subspace_dim=4).generate(A1),
        "ir": gt.Ir.build(criteria=one, preconditioner=jac, relaxation_factor=1.0).generate(A1),
    }

    def capped(name, its, **params):
        return solvers[name].replace(criterion=stop.Iteration(max_iters=its), **params)

    def fused(name, rhs, **params):
        return lambda its: capped(name, its, **params).solve(rhs)

    def streaming(name, rhs):
        def run(its):
            with torch.no_grad():
                s = capped(name, its)
                if name.startswith("idr"):
                    s._solve_single(rhs, z)
                else:
                    s._solve_streaming(rhs, torch.zeros_like(rhs))
        return run

    out = {"matrix": f"poisson_2d({NSIDE})", "card": timing["card"]}
    # K12m
    f_ms = iter_ms(fused("bicgstab", B1))
    s_ms = iter_ms(streaming("bicgstab", B1), *STREAM_TRIPS)
    p_ms = iter_ms(lambda its: ops_bicgstab.bicgstab_solve_multi_reference(
        A1.diags, A1.offsets, B1, Z, None, tol_sq_eff=-1.0, max_iters=its), *PLAIN_TRIPS)
    nbytes, flops = (4 * nd + 36 * k) * n, (4 * nd + 22) * k * n
    rec["bicgstab_fused_multi"] = (f_ms, p_ms, None, nbytes, flops)
    out["bicgstab_fused_multi_k4"] = {"fused_us": f_ms * 1e3, "streaming_us": s_ms * 1e3,
                                      "plain_us": p_ms * 1e3, "GBps": nbytes / f_ms / 1e6}
    # K15m, per Arnoldi step
    gm = {}
    for label, mode, vb in (("f32", "keep", 4), ("bf16", "reduce1", 2)):
        cycle_bytes = (sum((4 * nd + (j + 2) * vb * k) * n for j in range(m))
                       + (4 * nd + (m * vb + 12) * k) * n)
        cycle_flops = (sum((2 * nd + 8 * (j + 1) + 3) * k * n for j in range(m))
                       + (2 * nd + 2 * m + 2) * k * n)
        ms = iter_ms(fused("gmres", B1, storage_precision=mode), 60, 240)
        gm[label] = {"fused_us_per_step": ms * 1e3, "bytes_per_step": cycle_bytes / m,
                     "GBps": cycle_bytes / m / ms / 1e6}
        if label == "f32":
            gm["streaming_us_per_step"] = iter_ms(streaming("gmres", B1), 30, 90) * 1e3
            p_ms = iter_ms(lambda its: ops_gmres.gmres_solve_multi_reference(
                A1.diags, A1.offsets, B1, Z, None, m=m, tol_sq_eff=-1.0, max_iters=its), *PLAIN_GMRES_TRIPS)
            gm["plain_us_per_step"] = p_ms * 1e3
            rec["gmres_fused_multi"] = (ms, p_ms, None, cycle_bytes / m, cycle_flops / m)
    out["gmres_fused_multi_k4"] = gm
    # K16, per outer iteration
    for sdim in (2, 4):
        name = f"idr{sdim}"
        P = solvers[name].P
        f_ms = iter_ms(fused(name, b1))
        s_ms = iter_ms(streaming(name, b1), 20, 100)
        p_ms = iter_ms(lambda its, P=P: ops_idr.idr_solve_reference(
            A1.diags, A1.offsets, P, b1, z, b1, None, kappa=0.7, tol_sq_eff=-1.0,
            max_iters=its), 10, 50)
        nbytes = (4 * nd + 20 * sdim + 20) * n
        flops = (2 * nd * (sdim + 2) + 7 * sdim * sdim + 6 * sdim + 11) * n
        if sdim == 2:  # the kernels line carries Idr's default subspace
            rec["idr_fused"] = (f_ms, p_ms, None, nbytes, flops)
        out[f"idr_fused_s{sdim}"] = {"fused_us": f_ms * 1e3, "streaming_us": s_ms * 1e3,
                                     "plain_us": p_ms * 1e3, "GBps": nbytes / f_ms / 1e6}
    # K17 per sweep, and the smoother
    nbytes = (4 * nd + 16) * n
    f_ms = iter_ms(fused("ir", b1))
    s_ms = iter_ms(streaming("ir", b1[:, None]), *STREAM_TRIPS)
    p_ms = iter_ms(lambda its: ops_ir.ir_solve_reference(
        A1.diags, A1.offsets, b1, z, inv_diag, omega=1.0, tol_sq_eff=-1.0, max_iters=its),
        *PLAIN_TRIPS)
    rec["ir_fused"] = (f_ms, p_ms, None, nbytes, (2 * nd + 6) * n)
    out["ir_fused"] = {"fused_us": f_ms * 1e3, "streaming_us": s_ms * 1e3,
                       "plain_us": p_ms * 1e3, "GBps": nbytes / f_ms / 1e6}
    x0 = torch.ones_like(b1)
    k_ms = iter_ms(lambda its: ops_ir.ir_smooth(A1.diags, A1.offsets, b1, x0, inv_diag,
                                                omega=1.0, iters=its, with_residual=True),
                   20, 100)
    p_ms = iter_ms(lambda its: ops_ir.ir_smooth_reference(
        A1.diags, A1.offsets, b1, x0, inv_diag, omega=1.0, iters=its, with_residual=True),
        20, 100)
    rec["ir_smooth"] = (k_ms, p_ms, None, nbytes, (2 * nd + 4) * n)
    out["ir_smooth"] = {"us_per_sweep": k_ms * 1e3, "plain_us_per_sweep": p_ms * 1e3,
                        "GBps": nbytes / k_ms / 1e6}
    timing["slice5_us_per_iter"] = out


PATH6 = ("pell_gmres_fused", "pell_bicgstab_fused", "pell_cgs_fused", "pell_ir_fused")


def path6_solvers(gt):
    """name -> (solver class, build parameters, its Pell kernel, inner
    solver factory or None, relaxation factor)."""
    jac = gt.Jacobi.build(max_block_size=1)
    return {"bicgstab": (gt.Bicgstab, {}, "pell_bicgstab_fused"),
            "cgs": (gt.Cgs, {}, "pell_cgs_fused"),
            "gmres": (gt.Gmres, {"krylov_dim": KRYLOV_DIM}, "pell_gmres_fused"),
            "ir": (gt.Ir, {"preconditioner": jac, "relaxation_factor": 1.0}, "pell_ir_fused")}


def shifted_poisson_3d(gt, nside, seed=7):
    """The 7-point 3-D Poisson matrix with a seeded uniform [0, 2) shift of
    its diagonal (SPD; scalar Jacobi is not a multiple of I)."""
    data = gt.generators.poisson_3d(nside, dtype=np.float32)
    diag = data.rows == data.cols
    vals = data.values.copy()
    vals[diag] += np.random.default_rng(seed).uniform(0.0, 2.0, int(diag.sum())).astype(np.float32)
    return gt.MatrixData.from_coo(data.shape, data.rows, data.cols, vals)


def main_path6(gt, dev, rng, crit, kernels, p4):
    """Main path 6 through the entry points a user calls; every check
    raises.  A2 (path 4's convection-diffusion operator on the 2048^2 grid)
    handed over as a ``Csr`` and converted by ``Pell.from_csr`` (S = 8):
    Bicgstab, Cgs, Gmres(30) and Ir (scalar Jacobi, relaxation 1.0) fused
    (K19, K20, K18, K21) with float32 values, with bfloat16 values
    (``reduce_storage``) and with Jacobi (IR: with the Identity at 0.2),
    then streaming; CbGmres "auto" (K18 with a bfloat16 basis).  The Pell
    holds A2's float32 values, and its bfloat16 form rounds them as the
    bfloat16 ``Dia`` does, so each solution is held against path 4's
    float64 solve of the same system.  Then the routes that must stream on
    a Pell, at 64^2, by launch counters."""
    from ginkgo_tpu_torch import stop
    from ginkgo_tpu_torch.solver import gmres as sol_gmres

    b, refs, norm_a = p4["b"], p4["refs"], p4["norm_a"]
    t0 = time.perf_counter()
    data = gt.MatrixData.from_coo(*convdiff_2d(NSIDE))
    C = gt.Csr.from_matrix_data(data, device=dev)
    _sync(dev)
    csr_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    P = gt.Pell.from_csr(C)
    _sync(dev)
    pell_s = time.perf_counter() - t0
    Pb = P.reduce_storage()
    n = P.shape[0]
    check(P.S == 8 and P.dtype == torch.float32 and n == b.shape[0], "path 6: bad Pell")
    emit({"phase": "main_path", "path": 6, "case": "pell_from_csr",
          "matrix": f"convdiff_2d({NSIDE})", "rows": n, "nnz": data.nnz,
          "csr_s": round(csr_s, 3), "pell_plan_s": round(pell_s, 3), "S": P.S, "G": P.G,
          "inflation": P.inflation, "cells": P.values.numel(), "plan_bytes": P.storage_bytes()})
    z = torch.zeros_like(b)
    jac = gt.Jacobi.build(max_block_size=1)
    # scalar Jacobi, generated once per operator (the diagonal comes from
    # the host: Pell.extract_diagonal goes through to_csr)
    t0 = time.perf_counter()
    M, Mb = jac.generate(P), jac.generate(Pb)
    _sync(dev)
    emit({"phase": "main_path", "path": 6, "case": "jacobi_generate_x2",
          "s": round(time.perf_counter() - t0, 3)})
    for name, (cls, params, kname) in path6_solvers(gt).items():
        kern = kernels[kname]
        if name == "ir":
            cases = (("f32_jacobi", P, {**params, "preconditioner": M}, "f32"),
                     ("bf16_jacobi", Pb, {**params, "preconditioner": Mb}, "bf16"),
                     ("f32_identity", P, {"relaxation_factor": 0.2}, "f32"))
        else:
            cases = (("f32", P, params, "f32"), ("bf16", Pb, params, "bf16"),
                     ("f32_jacobi", P, {**params, "preconditioner": M}, "f32"))
        for case, Pv, kw, ref in cases:
            t0 = time.perf_counter()
            solver = cls.build(criteria=crit, **kw).generate(Pv)
            generate_s = time.perf_counter() - t0
            before = kern.launches
            t0 = time.perf_counter()
            x, info = solver.solve(b)
            _sync(dev)
            solve_s = time.perf_counter() - t0
            label = f"path 6: {name} {case}"
            check(kern.launches == before + 1, f"{label} did not run {kname}")
            check(bool(info.converged.all()), f"{label}: not converged")
            check(x.shape == (n,) and x.dtype == torch.float32, f"{label}: bad x")
            emit({"phase": "main_path", "path": 6, "route": "fused", "solver": name,
                  "case": case, "iterations": info.num_iterations,
                  "residual_norm": float(info.residual_norm[0]),
                  **accuracy(Pv, x, b, refs[ref], norm_a, label),
                  "generate_s": round(generate_s, 4), "solve_s": round(solve_s, 4)})
        streaming_kw = {**params, "preconditioner": M} if name == "ir" else params
        solver = cls.build(criteria=crit, **streaming_kw).generate(P)
        before = {k: f.launches for k, f in kernels.items()}
        t0 = time.perf_counter()
        with torch.no_grad():
            xs, sinfo = solver._solve_streaming(b[:, None], z[:, None])
        _sync(dev)
        label = f"path 6: {name} streaming"
        fused = [k for k in (*PATH2, *PATH6) if k != "pell_spmv"
                 and kernels[k].launches != before[k]]
        check(not fused and kernels["pell_spmv"].launches > before["pell_spmv"],
              f"{label}: did not stream through pell_spmv ({fused})")
        check(bool(sinfo.converged.all()), f"{label}: not converged")
        emit({"phase": "main_path", "path": 6, "route": "streaming", "solver": name,
              "case": "f32_jacobi" if name == "ir" else "f32",
              "iterations": sinfo.num_iterations,
              "pell_spmv_launches": kernels["pell_spmv"].launches - before["pell_spmv"],
              **accuracy(P, xs[:, 0], b, refs["f32"], norm_a, label),
              "solve_s": round(time.perf_counter() - t0, 4)})

    solver = gt.CbGmres.build(criteria=crit, krylov_dim=KRYLOV_DIM).generate(P)
    check(solver._resolved_mode() == "reduce1", "path 6: CbGmres 'auto' did not resolve to reduce1")
    t0 = time.perf_counter()
    with outputs_of(sol_gmres, "pell_gmres_fused") as seen:
        x, info = solver.solve(b)
    _sync(dev)
    label = "path 6: CbGmres auto"
    check(len(seen) == 1 and seen[0][0]["basis_dtype"] == torch.bfloat16,
          f"{label} did not run pell_gmres_fused with a bfloat16 basis")
    check(bool(info.converged.all()), f"{label}: not converged")
    emit({"phase": "main_path", "path": 6, "route": "fused", "solver": "cbgmres",
          "case": "auto", "resolved": "reduce1", "iterations": info.num_iterations,
          **accuracy(P, x, b, refs["f32"], norm_a, label),
          "solve_s": round(time.perf_counter() - t0, 4)})

    # the routes that stream on a Pell, at 64^2: no whole-solve kernel runs
    d64 = gt.MatrixData.from_coo(*convdiff_2d(SMALL))
    P64 = gt.Pell.from_csr(gt.Csr.from_matrix_data(d64, device=dev))
    n64 = P64.shape[0]
    short = [stop.Iteration(max_iters=200), stop.ResidualNorm(tolerance=1e-4)]
    implicit = [stop.Iteration(max_iters=30), stop.ImplicitResidualNorm(tolerance=TOL)]
    declined = (
        ("bicg", gt.Bicg.build(criteria=short), 1),
        ("idr", gt.Idr.build(criteria=short), 1),
        ("bicgstab k=2", gt.Bicgstab.build(criteria=short), 2),
        ("gmres krylov_dim=101", gt.Gmres.build(criteria=short, krylov_dim=101), 1),
        ("ir implicit", gt.Ir.build(criteria=implicit, preconditioner=jac), 1),
    )
    row = {"phase": "main_path", "path": 6, "case": "declined_routes", "nside": SMALL}
    whole = [k for k in kernels if k.endswith("_fused") or k.endswith("_fused_multi")]
    for label, factory, k in declined:
        before = {name: f.launches for name, f in kernels.items()}
        X, info = factory.generate(P64).solve(torch.ones(n64, k, device=dev))
        _sync(dev)
        fused = [name for name in whole if kernels[name].launches != before[name]]
        spmv = sum(kernels[f].launches - before[f] for f in ("pell_spmv", "pell_spmm"))
        check(not fused and spmv > 0, f"path 6: {label} did not stream (fused kernels run: {fused})")
        check(X.shape == (n64, k) and bool(torch.isfinite(X).all()), f"path 6: {label}: bad x")
        row[label] = {"streams": True, "pell_spmv_launches": spmv,
                      "iterations": info.num_iterations, "converged": info.converged.tolist()}
    emit(row)
    return {"P": P, "Pb": Pb, "b": b}


def check_path6_kernels(gt, dev, rng, p4, p6, record_err):
    """K18-K21 against their plain versions on the card.  At small size (a
    24^3 shifted Poisson matrix and A2 at 64^2, each a ``Pell``), solves to
    convergence with float32 and bfloat16 values, int8 and int32 lane
    indices, with and without an inverse diagonal, K18 with a float32 and a
    bfloat16 basis: equal iteration counts and x bit for bit; then a NaN in
    b per kernel, which runs to the cap on both, and IR's zero-sweep case
    (x0 the float64 solution: no sweep on either).  At full width (A2 as
    the path's Pell, float32 and bfloat16 values), solves under a cap of
    CAP6 iterations: equal counts, x within 1e-5 of its largest entry and
    reported bit_equal.  Every kernel runs twice and must equal itself."""
    from ginkgo_tpu_torch import stop
    from ginkgo_tpu_torch.ops import gmres as ops_gmres
    from ginkgo_tpu_torch.ops import pell_cg as ops_pc

    def outcome(out):
        """(x, iterations, monitor, converged) of a Pell kernel's output."""
        x, it, mon, conv = (out[0], out[2], out[3], out[4]) if len(out) == 5 else out
        return x, int(it), float(mon), bool(conv)

    def cases(P, b, x0, minv, tol, cap, omega):
        kw = dict(tol_sq_eff=tol, max_iters=cap)
        out = {
            "pell_bicgstab_fused": (
                lambda: ops_pc.pell_bicgstab_fused(P, b, x0, minv, **kw),
                lambda: ops_pc.pell_bicgstab_solve_reference(P, b, x0, minv, **kw)),
            "pell_cgs_fused": (
                lambda: ops_pc.pell_cgs_fused(P, b, x0, minv, **kw),
                lambda: ops_pc.pell_cgs_solve_reference(P, b, x0, minv, **kw)),
            "pell_ir_fused": (
                lambda: ops_pc.pell_ir_fused(P, b, x0, minv, omega=omega, **kw),
                lambda: ops_pc.pell_ir_solve_reference(P, b, x0, minv, omega=omega, **kw)),
        }
        for basis in (torch.float32, torch.bfloat16):
            out[f"pell_gmres_fused:{str(basis)[6:]}"] = (
                lambda basis=basis: ops_gmres.pell_gmres_fused(
                    P, b, x0, minv, m=KRYLOV_DIM, basis_dtype=basis, **kw),
                lambda basis=basis: ops_gmres.pell_gmres_solve_reference(
                    P, b, x0, minv, m=KRYLOV_DIM, basis_dtype=basis, **kw))
        return out

    def compare(key, what, kern, plain, exact, cap=None):
        name = key.split(":")[0]
        t0 = time.perf_counter()
        kx, kit, kmon, kconv = outcome(kern())
        _sync(dev)
        k_s = time.perf_counter() - t0
        kx2, kit2, _, _ = outcome(kern())
        t0 = time.perf_counter()
        px, pit, pmon, pconv = outcome(plain())
        _sync(dev)
        p_s = time.perf_counter() - t0
        check(kit2 == kit and (torch.equal(kx2, kx) or np.isnan(kmon)),
              f"{what}: the kernel differs from itself")
        row = {"iters": kit, "plain_iters": pit, "s": round(k_s, 4), "plain_s": round(p_s, 4)}
        if cap is not None and np.isnan(kmon):  # a NaN in b: both run to the cap
            check(kit == pit == cap and np.isnan(pmon) and not kconv and not pconv,
                  f"{what}: with a NaN, {kit} / {pit} iterations, monitors {kmon} / {pmon}")
            return row
        err = record_err(name, kx, px)
        row.update(bit_equal=bool(torch.equal(kx, px)), x_max_abs_err=err, converged=kconv)
        check(kit == pit and kconv == pconv, f"{what}: {kit} / {pit} iterations, "
              f"converged {kconv} / {pconv}")
        if exact:
            check(kconv and row["bit_equal"], f"{what}: converged {kconv}, x differs by {err}")
        else:
            check(bool(torch.isfinite(kx).all()) and err <= 1e-5 * float(px.abs().max()),
                  f"{what}: x differs by {err}")
        return row

    small = {"poisson_3d_shifted(24)": shifted_poisson_3d(gt, SMALL3),
             f"convdiff_2d({SMALL})": gt.MatrixData.from_coo(*convdiff_2d(SMALL))}
    for label, data in small.items():
        C = gt.Csr.from_matrix_data(data, device=dev)
        P8 = gt.Pell.from_csr(C)
        P32 = gt.Pell.from_csr(C, q_dtype=np.int32)
        n = P8.shape[0]
        inv_diag = (1.0 / P8.extract_diagonal().values.float()).contiguous()
        b = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
        z = torch.zeros_like(b)
        tol = torch.full((), (TOL * float(b.norm())) ** 2, dtype=torch.float32, device=dev)
        row = {"phase": "kernel_check", "path": 6, "matrix": label}
        for storage, Pv, pre_label, pre in (
                ("f32/i8", P8, "identity", None), ("f32/i8", P8, "minv", inv_diag),
                ("f32/i32", P32, "identity", None), ("bf16/i8", P8.reduce_storage(), "minv", inv_diag),
                ("bf16/i32", P32.astype(torch.bfloat16), "identity", None)):
            held = f"{str(Pv.values.dtype)[6:]}/{str(Pv.qidx.dtype)[6:]}"
            check(held == storage.replace("f32", "float32").replace("bf16", "bfloat16")
                  .replace("i8", "int8").replace("i32", "int32"),
                  f"path 6 check: the {storage} plan holds {held}")
            for key, (kern, plain) in cases(Pv, b, z, pre, tol, MAX_ITERS,
                                            1.0 if pre is not None else 0.2).items():
                if key == "pell_ir_fused" and pre is None and label.startswith("poisson"):
                    continue  # the Identity at 0.2 diverges on this matrix
                row[f"{key} {storage} {pre_label}"] = compare(
                    key, f"{key} {label} {storage} {pre_label}", kern, plain, exact=True)
        # a NaN in b keeps every monitor NaN: both run to the cap
        bn = b.clone()
        bn[5] = float("nan")
        for key, (kern, plain) in cases(P8, bn, z, inv_diag, tol, 25, 1.0).items():
            row[f"{key} nan"] = compare(key, f"{key} {label} nan", kern, plain, exact=True, cap=25)
        # IR's zero-sweep case: r0 of the float64 solution meets the tolerance
        x64, _ = gt.Ir.build(criteria=[stop.Iteration(max_iters=MAX_ITERS),
                                       stop.ResidualNorm(tolerance=1e-10)],
                             preconditioner=gt.Jacobi.build(max_block_size=1)).generate(
            P8.astype(torch.float64)).solve(b.double())
        x0 = x64.float().contiguous()
        kw = dict(omega=1.0, tol_sq_eff=tol, max_iters=MAX_ITERS)
        row["pell_ir_fused zero_sweeps"] = compare(
            "pell_ir_fused", f"pell_ir_fused {label} zero sweeps",
            lambda: ops_pc.pell_ir_fused(P8, b, x0, inv_diag, **kw),
            lambda: ops_pc.pell_ir_solve_reference(P8, b, x0, inv_diag, **kw), exact=True)
        check(row["pell_ir_fused zero_sweeps"]["iters"] == 0,
              f"pell_ir_fused {label}: {row['pell_ir_fused zero_sweeps']['iters']} sweeps from "
              "an x0 that meets the tolerance")
        emit(row)

    # full width, under a cap
    P, b = p6["P"], p6["b"]
    z = torch.zeros_like(b)
    inv_diag = (1.0 / p4["A"].extract_diagonal().values.float()).contiguous()
    tol = torch.full((), (TOL * float(b.norm())) ** 2, dtype=torch.float32, device=dev)
    row = {"phase": "kernel_check", "path": 6, "matrix": f"convdiff_2d({NSIDE})", "cap": CAP6}
    for storage, Pv in (("f32/i8", P), ("bf16/i8", p6["Pb"])):
        for pre_label, pre in (("identity", None), ("minv", inv_diag)):
            for key, (kern, plain) in cases(Pv, b, z, pre, tol, CAP6,
                                            1.0 if pre is not None else 0.2).items():
                row[f"{key} {storage} {pre_label}"] = compare(
                    key, f"{key} {NSIDE} {storage} {pre_label}", kern, plain, exact=False)
    emit(row)


def time_path6(gt, dev, P, b3, rec, timing):
    """Per-iteration times on the 160^3 Poisson ``Pell`` of path 2 by the
    slope between whole solves with Iteration-only criteria: K19 and K20
    between Iteration(200) and Iteration(1000), K21 (scalar Jacobi,
    relaxation 1.0) per sweep the same, K18 per Arnoldi step between 60
    and 240 (m = 30, float32 and bfloat16 bases); each beside its streaming
    route (GMRES between 30 and 90) and its plain version (fewer trips).  The true residual of the
    longer run is reported, not bounded: in float32 BiCGSTAB on a Poisson
    matrix with b = ones stagnates before 1e-6 (ROADMAP, "Not faults").

    Bounds per iteration, each input read once and each output written
    once (the plan's bytes once, as the Dia rows count the diagonals once),
    and beside them the plan read once per SpMV: BiCGSTAB and CGS plan +
    36 n bytes (rr in; x, r and two carried vectors in and out), 4 cells +
    22 n (CGS 19 n) operations, two SpMVs; IR plan + 16 n (x gathered
    once, b and minv in, x out: a sweep uses r at once on the rows that form
    it and stores none), 2 cells + 6 n, one SpMV; GMRES per step K15's cycle
    model with the plan in place of the diagonals, one SpMV."""
    from ginkgo_tpu_torch import stop
    from ginkgo_tpu_torch.ops import gmres as ops_gmres
    from ginkgo_tpu_torch.ops import pell_cg as ops_pc

    n = P.shape[0]
    z = torch.zeros_like(b3)
    plan = P.storage_bytes()
    cells = P.values.numel()
    one = [stop.Iteration(max_iters=1)]
    solvers = {name: cls.build(criteria=one, **params).generate(P)
               for name, (cls, params, _) in path6_solvers(gt).items()}
    inv_diag = solvers["ir"].preconditioner.inv_diag.float().contiguous()

    def capped(name, its, **params):
        return solvers[name].replace(criterion=stop.Iteration(max_iters=its), **params)

    def fused(name, **params):
        return lambda its: capped(name, its, **params).solve(b3)

    def streaming(name):
        def run(its):
            with torch.no_grad():
                capped(name, its)._solve_streaming(b3[:, None], z[:, None])
        return run

    kw = dict(tol_sq_eff=-1.0)
    plains = {
        "bicgstab": lambda its: ops_pc.pell_bicgstab_solve_reference(P, b3, z, None,
                                                                     max_iters=its, **kw),
        "cgs": lambda its: ops_pc.pell_cgs_solve_reference(P, b3, z, None, max_iters=its, **kw),
        "ir": lambda its: ops_pc.pell_ir_solve_reference(P, b3, z, inv_diag, omega=1.0,
                                                         max_iters=its, **kw),
        "gmres": lambda its: ops_gmres.pell_gmres_solve_reference(
            P, b3, z, None, m=KRYLOV_DIM, max_iters=its, **kw),
    }
    per_iter = {
        "bicgstab": (plan + 36 * n, 2 * plan + 36 * n, 4 * cells + 22 * n),
        "cgs": (plan + 36 * n, 2 * plan + 36 * n, 4 * cells + 19 * n),
        "ir": (plan + 16 * n, plan + 16 * n, 2 * cells + 6 * n),
    }
    out = {"matrix": f"poisson_3d({NSIDE3})", "card": timing["card"], "plan_bytes": plan,
           "cells": cells}
    for name, (nbytes, nbytes_spmv, flops) in per_iter.items():
        f_ms, s_ms = iter_ms(fused(name)), iter_ms(streaming(name), *STREAM_TRIPS)
        p_ms = iter_ms(plains[name], *PLAIN_TRIPS)
        kname = path6_solvers(gt)[name][2]
        rec[kname] = (f_ms, p_ms, None, nbytes, flops, nbytes_spmv)
        x, info = capped(name, 1000).solve(b3)
        out[kname] = {"fused_us": f_ms * 1e3, "streaming_us": s_ms * 1e3, "plain_us": p_ms * 1e3,
                      "GBps": nbytes_spmv / f_ms / 1e6,
                      "true_relres_1000": float((b3 - P.apply(x)).norm() / b3.norm())}
    m = KRYLOV_DIM
    gm = {}
    for label, basis, vb in (("f32", "keep", 4), ("bf16", "reduce1", 2)):
        cycle_bytes = sum(plan + (j + 2) * vb * n for j in range(m)) + plan + (m * vb + 12) * n
        cycle_flops = sum(2 * cells + (8 * (j + 1) + 3) * n for j in range(m)) + 2 * cells + (2 * m + 2) * n
        ms = iter_ms(fused("gmres", storage_precision=basis), 60, 240)
        gm[label] = {"fused_us_per_step": ms * 1e3, "bytes_per_step": cycle_bytes / m,
                     "GBps": cycle_bytes / m / ms / 1e6}
        if label == "f32":
            gm["streaming_us_per_step"] = iter_ms(streaming("gmres"), 30, 90) * 1e3
            p_ms = iter_ms(plains["gmres"], *PLAIN_GMRES_TRIPS)
            gm["plain_us_per_step"] = p_ms * 1e3
            rec["pell_gmres_fused"] = (ms, p_ms, None, cycle_bytes / m, cycle_flops / m,
                                       cycle_bytes / m)
            x, info = capped("gmres", 240).solve(b3)
            gm["true_relres_240"] = float((b3 - P.apply(x)).norm() / b3.norm())
    out["pell_gmres_fused"] = gm
    timing["slice6_us_per_iter"] = out


#: path 7: the cap of CG with the ILU preconditioner on A1, which does not
#: reach 1e-6 in float32 (main_path7)
A1_CG_ILU_CAP = 5000
#: path 7: sweeps per triangle of every ILU/IC preconditioner of the path
#: (passed explicitly: sweeps=None runs the level count, a Python loop
#: over the rows)
SWEEPS7 = 3


def ilu_factories(gt, kind, sweeps=SWEEPS7):
    """The ``Ic`` or ``Ilu`` factory of path 7: 'sweeps' triangular solvers
    with ``sweeps`` sweeps each (Ic's upper solver mirrors its lower)."""
    from ginkgo_tpu_torch.solver import LowerTrs, UpperTrs

    lf = LowerTrs.build(algorithm="sweeps", sweeps=sweeps)
    if kind == "ic":
        return gt.preconditioner.Ic.build(l_solver_factory=lf)
    return gt.preconditioner.Ilu.build(
        l_solver_factory=lf, u_solver_factory=UpperTrs.build(algorithm="sweeps", sweeps=sweeps))


def _timed(fn, dev):
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, round(time.perf_counter() - t0, 3)


def main_path7(gt, dev, rng, crit, kernels, data1, x64_ones, p4, C3, P3, x64_3, norm3,
               cg_iterations):
    """Main path 7 through the entry points a user calls; every check
    raises; each preconditioned solve that converges must take fewer
    iterations than its solver took without a preconditioner in paths 1, 2
    and 4 (``cg_iterations``, ``p4["iterations"]``).  A1 (path 1's 2048^2
    Poisson ``Dia``): ``Cg`` with ``Ic``
    (ParIc, 5 iterations) and with ``Ilu`` (ParIlu), 3 sweeps a triangle,
    fused (K23) and streaming (K22 per triangle, K1); two ParIlu runs of
    one matrix must be bit-identical.  A2 (path 4's convection-diffusion
    ``Dia``): ``Bicgstab`` with ``Ilu`` fused (K24 on its walk route, seven
    grid barriers an iteration; K23 on its walk too) and streaming, and
    ``Gmres(30)`` with the same preconditioner, which has no ILU kernel and
    streams (2 K22 launches per M apply).  Path 2's 160^3 Poisson: ``Ic``
    generated from the ``Csr``, ``Cg`` on its ``Pell`` (the triangles of the
    factor are Dias, the operator is not, and K7 takes only a diagonal M:
    streaming on K5 and K22; the Csr's own plan build is path 2's set-up,
    and the plan cache no longer holds it).  One ``LowerTrs`` sweeps solve on
    A1's L factor (K22).  At 64^2: ``Direct`` (Lu + block_scan) and
    ``Isai`` + ``Gmres``, host-built solvers running on the card.  Every
    solution is held against a float64 solve of its system."""
    from ginkgo_tpu_torch import stop
    from ginkgo_tpu_torch.factorization import LuFactory, ParIc, ParIlu
    from ginkgo_tpu_torch.ops import cg_ilu as ops_cg_ilu
    from ginkgo_tpu_torch.ops import trs as ops_trs
    from ginkgo_tpu_torch.solver import LowerTrs

    def routes(fn, before):
        return {k: v - before[k] for k, v in fn.routes.items()}

    row = {"phase": "main_path", "path": 7, "case": "setup", "sweeps": SWEEPS7}
    A1 = p4["A1"]
    b1 = p4["b1"]
    n1 = A1.shape[0]
    norm1 = inf_norm(data1)
    C1, row["a1_to_csr_s"] = _timed(A1.to_csr, dev)
    fic, row["a1_paric_s"] = _timed(lambda: ParIc().generate(C1), dev)
    filu, row["a1_parilu_s"] = _timed(lambda: ParIlu().generate(C1), dev)
    filu2 = ParIlu().generate(C1)
    _sync(dev)
    check(torch.equal(filu.l_factor.values, filu2.l_factor.values)
          and torch.equal(filu.u_factor.values, filu2.u_factor.values),
          "path 7: two ParIlu factorizations of A1 differ")
    row["parilu_bit_identical"] = True
    del filu2
    M_ic, row["a1_ic_trs_builds_s"] = _timed(lambda: ilu_factories(gt, "ic").generate(fic), dev)
    M_ilu, row["a1_ilu_trs_builds_s"] = _timed(lambda: ilu_factories(gt, "ilu").generate(filu),
                                               dev)
    for label, M in (("ic", M_ic), ("ilu", M_ilu)):
        for t in (M.l_solver, M.u_solver):
            check(isinstance(t.off_csr, gt.Dia) and t.sweeps == SWEEPS7,
                  f"path 7: the {label} triangles are not Dias with {SWEEPS7} sweeps")
        row[f"{label}_triangle_offsets"] = [M.l_solver.off_csr.offsets,
                                            M.u_solver.off_csr.offsets]
    # A1's IC and ILU triangles take the walk: K22 with no grid barrier, K23
    # with four an iteration
    for label, M in (("ic", M_ic), ("ilu", M_ilu)):
        Tl, Tu = M.l_solver.off_csr, M.u_solver.off_csr
        for side, T in (("l", Tl), ("u", Tu)):
            launch = ops_trs.trs_fused_launch(T, SWEEPS7, dev)
            check(launch["route"] == "pipelined" and launch["grid_barriers"] == 0
                  and launch["unrolled"],
                  f"path 7: A1's {label} {side} triangle takes the {launch['route']} route "
                  f"(unrolled {launch['unrolled']})")
            emit({"phase": "launch", "path": 7, "kernel": "trs_fused", "case": f"a1_{label}_{side}",
                  **launch})
        launch = ops_cg_ilu.cg_ilu_fused_launch(A1, Tl, Tu, SWEEPS7, SWEEPS7, dev)
        check(launch["route"] == "pipelined" and launch["grid_barriers"] == 4
              and launch["unrolled"],
              f"path 7: K23 with A1's {label} takes the {launch['route']} route "
              f"(unrolled {launch['unrolled']})")
        emit({"phase": "launch", "path": 7, "kernel": "cg_ilu_fused", "case": f"a1_{label}",
              **launch})
    A2, b2, refs2, norm2 = p4["A"], p4["b"], p4["refs"], p4["norm_a"]
    C2, row["a2_to_csr_s"] = _timed(A2.to_csr, dev)
    M2, row["a2_ilu_s"] = _timed(lambda: ilu_factories(gt, "ilu").generate(C2), dev)
    emit(row)
    # A2's ILU takes K24's walk for both M applies: seven grid barriers an
    # iteration
    launch = ops_cg_ilu.bicgstab_ilu_fused_launch(A2, M2.l_solver.off_csr, M2.u_solver.off_csr,
                                                  SWEEPS7, SWEEPS7, dev)
    check(launch["route"] == "pipelined" and launch["grid_barriers"] == 7 and launch["unrolled"],
          f"path 7: K24 with A2's ilu takes the {launch['route']} route "
          f"(unrolled {launch['unrolled']})")
    emit({"phase": "launch", "path": 7, "kernel": "bicgstab_ilu_fused", "case": "a2_ilu",
          **launch})

    out = {"A1": A1, "b1": b1, "M_ic": M_ic, "M_ilu": M_ilu, "A2": A2, "b2": b2, "M2": M2,
           "L1": filu.l_factor}
    # CG with the ILU sweeps preconditioner (M = U^-1 L^-1 by truncated
    # sweeps is not exactly symmetric) does not reach 1e-6 in float32 on A1;
    # the JAX package takes the same counts from 64^2 to 1024^2 (56 to 1566
    # iterations) on the CPU.  It runs under a cap, its numbers reported and
    # only its routes checked, as path 4 does for BiCGSTAB on A1.
    ilu_crit = [stop.Iteration(max_iters=A1_CG_ILU_CAP), stop.ResidualNorm(tolerance=TOL)]
    unprec = p4["iterations"]
    runs = (("cg_ic", gt.Cg, A1, M_ic, b1, x64_ones, norm1, "cg_ilu_fused", crit,
             cg_iterations["a1"]),
            ("cg_ilu", gt.Cg, A1, M_ilu, b1, x64_ones, norm1, "cg_ilu_fused", ilu_crit, None),
            ("bicgstab_ilu", gt.Bicgstab, A2, M2, b2, refs2["f32"], norm2, "bicgstab_ilu_fused",
             crit, unprec["bicgstab"]))
    for label, cls, A, M, b, ref, norm_a, kname, criteria, plain_its in runs:
        bounded = criteria is crit
        solver = cls.build(criteria=criteria, preconditioner=M).generate(A)
        before = {k: f.launches for k, f in kernels.items()}
        k_routes = dict(kernels[kname].routes)
        (x, info), solve_s = _timed(lambda: solver.solve(b), dev)
        check(kernels[kname].launches == before[kname] + 1, f"path 7: {label} did not run {kname}")
        k_routes = routes(kernels[kname], k_routes)
        check(k_routes["pipelined"] == 1, f"path 7: {label}: {kname} took the routes {k_routes}")
        check(kernels["trs_fused"].launches == before["trs_fused"],
              f"path 7: {label} ran trs_fused beside {kname}")
        check(bool(info.converged.all()) or not bounded, f"path 7: {label}: not converged")
        check(x.shape == b.shape and x.dtype == torch.float32 and bool(torch.isfinite(x).all()),
              f"path 7: {label}: bad x")
        fused_it = info.num_iterations
        check(plain_its is None or fused_it < plain_its,
              f"path 7: {label}: {fused_it} iterations, {plain_its} without a preconditioner")
        emit({"phase": "main_path", "path": 7, "route": "fused", "case": label,
              "iterations": fused_it, "unpreconditioned_iterations": plain_its,
              "converged": bool(info.converged.all()),
              "residual_norm": float(info.residual_norm[0]),
              **accuracy(A, x, b, ref, norm_a, f"path 7: {label}", bounded=bounded),
              "solve_s": solve_s, f"{kname}_routes": k_routes})
        before = {k: f.launches for k, f in kernels.items()}
        k22_routes = dict(ops_trs.trs_fused.routes)
        with torch.no_grad():
            (xs, sinfo), solve_s = _timed(
                lambda: solver._solve_streaming(b[:, None], torch.zeros_like(b)[:, None]), dev)
        k22 = kernels["trs_fused"].launches - before["trs_fused"]
        k22_routes = routes(ops_trs.trs_fused, k22_routes)
        check(k22_routes["pipelined"] == k22,
              f"path 7: {label} streaming: trs_fused took the routes {k22_routes}")
        per_iter = 2 if cls is gt.Cg else 4  # M applies: CG one, BiCGSTAB two an iteration
        check(kernels[kname].launches == before[kname] and k22 >= per_iter * sinfo.num_iterations,
              f"path 7: {label} streaming: {k22} trs_fused launches in "
              f"{sinfo.num_iterations} iterations")
        if bounded:
            check(bool(sinfo.converged.all()), f"path 7: {label} streaming: not converged")
            check(abs(sinfo.num_iterations - fused_it) <= max(3, 0.01 * fused_it),
                  f"path 7: {label}: fused {fused_it} and streaming {sinfo.num_iterations} "
                  "iterations")
        emit({"phase": "main_path", "path": 7, "route": "streaming", "case": label,
              "iterations": sinfo.num_iterations, "converged": bool(sinfo.converged.all()),
              "trs_fused_launches": k22, "trs_fused_routes": k22_routes,
              **accuracy(A, xs[:, 0], b, ref, norm_a, f"path 7: {label} streaming",
                         bounded=bounded),
              "solve_s": solve_s})

    # GMRES(30) with the ILU of A2: no ILU kernel for GMRES, so it streams
    solver = gt.Gmres.build(criteria=crit, krylov_dim=KRYLOV_DIM, preconditioner=M2).generate(A2)
    before = {k: f.launches for k, f in kernels.items()}
    (x, info), solve_s = _timed(lambda: solver.solve(b2), dev)
    k22 = kernels["trs_fused"].launches - before["trs_fused"]
    fused = [k for k in kernels if k.endswith("_fused") and k != "trs_fused"
             and kernels[k].launches != before[k]]
    check(not fused and k22 >= 2 * info.num_iterations,
          f"path 7: gmres_ilu: {k22} trs_fused launches in {info.num_iterations} steps, "
          f"fused kernels {fused}")
    check(bool(info.converged.all()) and info.num_iterations < unprec["gmres"],
          f"path 7: gmres_ilu: {info.num_iterations} steps, converged {info.converged.tolist()}")
    emit({"phase": "main_path", "path": 7, "route": "streaming", "case": "gmres_ilu",
          "iterations": info.num_iterations, "unpreconditioned_iterations": unprec["gmres"],
          "trs_fused_launches": k22,
          **accuracy(A2, x, b2, refs2["f32"], norm2, "path 7: gmres_ilu"), "solve_s": solve_s})

    # Cg + Ic on path 2's 160^3 system: IC from the Csr, K5 for A (the
    # Pell), K22 for the triangles
    M3, ic3_s = _timed(lambda: ilu_factories(gt, "ic").generate(C3), dev)
    check(isinstance(M3.l_solver.off_csr, gt.Dia), "path 7: the 160^3 IC triangle is not a Dia")
    b3 = torch.ones(C3.shape[0], device=dev)
    before = {k: f.launches for k, f in kernels.items()}
    k22_routes = dict(ops_trs.trs_fused.routes)
    (x, info), solve_s = _timed(
        lambda: gt.Cg.build(criteria=crit, preconditioner=M3).generate(P3).solve(b3), dev)
    k22 = kernels["trs_fused"].launches - before["trs_fused"]
    k22_routes = routes(ops_trs.trs_fused, k22_routes)
    k5 = kernels["pell_spmv"].launches - before["pell_spmv"]
    check(k22 >= 2 * info.num_iterations and k5 >= info.num_iterations,
          f"path 7: cg_ic on the 160^3 system: {k22} trs_fused, {k5} pell_spmv launches")
    check(bool(info.converged.all()) and info.num_iterations < cg_iterations["poisson3d160"],
          f"path 7: cg_ic on the 160^3 system: {info.num_iterations} iterations, converged "
          f"{info.converged.tolist()}")
    emit({"phase": "main_path", "path": 7, "route": "streaming", "case": "poisson3d160_cg_ic",
          "ic_generate_s": ic3_s, "iterations": info.num_iterations,
          "unpreconditioned_iterations": cg_iterations["poisson3d160"], "trs_fused_launches": k22,
          "trs_fused_routes": k22_routes,
          "trs_fused_launch": ops_trs.trs_fused_launch(M3.l_solver.off_csr, SWEEPS7, dev),
          "pell_spmv_launches": k5, "triangle_offsets": M3.l_solver.off_csr.offsets,
          **accuracy(P3, x, b3, x64_3, norm3, "path 7: poisson3d160_cg_ic"),
          "solve_s": solve_s})
    del M3

    # one direct LowerTrs sweeps solve on A1's L factor
    T, trs_s = _timed(lambda: LowerTrs.build(algorithm="sweeps", sweeps=SWEEPS7).generate(
        filu.l_factor), dev)
    before = kernels["trs_fused"].launches
    y = T.apply(b1)
    _sync(dev)
    check(kernels["trs_fused"].launches == before + 1 and bool(torch.isfinite(y).all()),
          "path 7: LowerTrs did not run trs_fused once")
    emit({"phase": "main_path", "path": 7, "case": "lower_trs", "build_s": trs_s,
          "y_norm": float(y.norm())})

    # host-built solvers at 64^2: Direct (Lu + block_scan) on the Poisson
    # matrix, Isai + Gmres on the convection-diffusion one
    import scipy.sparse.linalg as spla

    for case, d64 in (("direct_64", gt.generators.poisson_2d(SMALL, dtype=np.float32)),
                      ("isai_gmres_64", gt.MatrixData.from_coo(*convdiff_2d(SMALL)))):
        A64 = gt.Dia.from_matrix_data(d64, device=dev)
        b64 = torch.as_tensor(rng.uniform(0.5, 1.5, A64.shape[0]).astype(np.float32), device=dev)
        x64 = torch.as_tensor(spla.spsolve(A64.astype(torch.float64).to_scipy().tocsc(),
                                           b64.double().cpu().numpy()), device=dev)
        if case == "direct_64":
            S, generate_s = _timed(
                lambda: gt.Direct.build(factorization=LuFactory()).generate(A64), dev)
            check(S.l_solver.algorithm == "block_scan", "path 7: Direct's solvers")
        else:
            S, generate_s = _timed(lambda: gt.Gmres.build(
                criteria=crit, krylov_dim=KRYLOV_DIM,
                preconditioner=gt.preconditioner.Isai.build(isai_type="general")).generate(A64),
                dev)
        (x, info), solve_s = _timed(lambda: S.solve(b64), dev)
        check(bool(info.converged.all()) and x.device == dev, f"path 7: {case}: not converged")
        emit({"phase": "main_path", "path": 7, "case": case, "generate_s": generate_s,
              "iterations": info.num_iterations, "solve_s": solve_s,
              **accuracy(A64, x, b64, x64, inf_norm(d64), f"path 7: {case}")})
    return out


def _ilu_parts(M):
    """(Tl, Tu, invdl, invdu) of an IluPreconditioner, as K23/K24 take them."""
    lt, ut = M.l_solver, M.u_solver
    return (lt.off_csr, ut.off_csr, (1.0 / lt.diag).float().contiguous(),
            (1.0 / ut.diag).float().contiguous())


#: the neighbours of a grid point in the edge matrices' stencils, as
#: (dx, dy, dz): the 5-point Laplacian (3-point on a line), the 9-point one
#: and the 7-point one in 3D
STENCILS = {
    "5pt": ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0)),
    "9pt": tuple((dx, dy, 0) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dx or dy),
    "7pt": ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)),
}


def grid_laplacian(dims, stencil="5pt"):
    """The Laplacian of the stencil on the grid dims = (nx, ny, nz) (-1 a
    neighbour inside the grid, the neighbour count on the diagonal; a line
    of nx points where ny = nz = 1), as COO parts.  Row i = x + nx (y + ny
    z), so a neighbour (dx, dy, dz) sits at offset dx + nx dy + nx ny dz."""
    nx, ny, nz = dims
    n = nx * ny * nz
    i = np.arange(n)
    x, y, z = i % nx, (i // nx) % ny, i // (nx * ny)
    nbrs = [d for d in STENCILS[stencil] if (ny > 1 or d[1] == 0) and (nz > 1 or d[2] == 0)]
    rows, cols, vals = [i], [i], [np.full(n, float(len(nbrs)))]
    for dx, dy, dz in nbrs:
        ok = ((x + dx >= 0) & (x + dx < nx) & (y + dy >= 0) & (y + dy < ny)
              & (z + dz >= 0) & (z + dz < nz))
        rows.append(i[ok])
        cols.append(i[ok] + dx + nx * dy + nx * ny * dz)
        vals.append(np.full(int(ok.sum()), -1.0))
    return (n, n), np.concatenate(rows), np.concatenate(cols), np.concatenate(vals).astype(
        np.float32)


#: K22/K23 edge triangles (``check_trs_edges``): the grid and stencil of a
#: Laplacian, its factorization, whether a walk at path 7's sweeps fits a
#: block's shared memory, and whether the triangles' shapes run the kernels
#: compiled for them through interior steps.  w = 1 on an odd n (a bfloat16
#: diagonal starting mid-word), w = 31, w = 2048 (rings that wrap; at 264
#: blocks every range is shorter than its halo, which crosses many blocks),
#: w = 2047 on an odd n, w = 512 at 307,200 rows (own ranges of several
#: chunks), w = 40,000 (past the ring limit: the barrier route).  Then
#: ranges longer than their halo plus sweeps + 2 chunks, so that interior
#: steps run, at up to three blocks an SM: 1, 2, 3 and 4 diagonals a
#: triangle (w = 1 on a line of 3,000,001 rows, w = 512 on 1,536,000 rows
#: of the 5-point stencil, w = 1600 on a 40 x 40 x 1000 grid of the 7-point
#: one, w = 1001 on 1,600,000 rows of the 9-point one), each at 1 to 4
#: sweeps.
TRS_EDGE_GRIDS = (
    ((999, 1, 1), "5pt", "ic", True, False), ((31, 40, 1), "5pt", "ilu", True, False),
    ((2048, 3, 1), "5pt", "ic", True, False), ((2047, 5, 1), "5pt", "ilu", True, False),
    ((512, 600, 1), "5pt", "ic", True, False), ((40000, 3, 1), "5pt", "ic", False, False),
    ((3_000_001, 1, 1), "5pt", "ic", True, True), ((512, 3000, 1), "5pt", "ilu", True, True),
    ((40, 40, 1000), "7pt", "ic", True, True), ((1000, 1600, 1), "9pt", "ic", True, True),
)
#: the sweep counts the edge checks run: K22's, and K23's (L, U) pairs; on
#: the grids with interior steps every count the kernels are compiled for
TRS_EDGE_SWEEPS = ((0, 1, 3, 8), ((3, 3), (0, 1), (8, 2)))
TRS_INTERIOR_SWEEPS = ((1, 2, 3, 4), ((1, 1), (2, 2), (3, 3), (4, 4)))


def check_trs_edges(gt, dev, rng, record_err=None):
    """K22 and K23 against their plain versions, bit for bit and each
    twice, on the triangles of ParIc/ParIlu of ``TRS_EDGE_GRIDS``: K22 on
    the lower and the upper triangle, float32 and bfloat16, b with a -0.0
    and with a NaN, at ``TRS_EDGE_SWEEPS`` (``TRS_INTERIOR_SWEEPS`` on the
    grids with interior steps); K23 under a cap of 40 iterations, equal
    counts and x and r bit for bit.  At path 7's 3 sweeps every launch takes
    the walk, past the ring limit the barrier routine (so do 8 sweeps where
    their rings outgrow a block, and K22 at 0 sweeps); both routes of both
    kernels must run.  On the grids with interior steps every launch on the
    walk must run the kernel compiled for its shape with interior steps in
    every walk, and together they must reach every shape of 1 to 4
    diagonals and 1 to 4 sweeps of both kernels.  Returns one row a grid."""
    from ginkgo_tpu_torch.ops import cg_ilu as ops_cg_ilu
    from ginkgo_tpu_torch.ops import trs as ops_trs

    def interior(launch, what):
        check(launch["unrolled"] and all(w["interior_steps"] > 0 for w in launch["walks"]),
              f"{what}: the walk ran no interior step of the kernel compiled for its shape "
              f"({launch})")

    rows = []
    seen = {"trs_fused": set(), "cg_ilu_fused": set()}
    shapes = {"trs_fused": set(), "cg_ilu_fused": set()}
    for dims, stencil, kind, walks, inner in TRS_EDGE_GRIDS:
        want = "pipelined" if walks else "barrier"
        k22_sweeps, k23_sweeps = TRS_INTERIOR_SWEEPS if inner else TRS_EDGE_SWEEPS
        t0 = time.perf_counter()
        A = gt.Dia.from_matrix_data(gt.MatrixData.from_coo(*grid_laplacian(dims, stencil)),
                                    device=dev)
        M = ilu_factories(gt, kind).generate(A)
        Tl, Tu, invdl, invdu = _ilu_parts(M)
        n = A.shape[0]
        b = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
        b[5] = -0.0
        bn = b.clone()
        bn[n // 2] = float("nan")
        z = torch.zeros_like(b)
        tol = torch.full((), (TOL * float(b.norm())) ** 2, dtype=torch.float32, device=dev)
        row = {"phase": "kernel_check", "kernels": ["trs_fused", "cg_ilu_fused"],
               "grid": list(dims), "stencil": stencil, "kind": kind, "rows": n,
               "offsets": [list(Tl.offsets), list(Tu.offsets)], "launches": {}}
        n_cases = 0
        for storage in (torch.float32, torch.bfloat16):
            L, U = Tl.astype(storage), Tu.astype(storage)
            tag = str(storage)[6:]
            for side, T, invd in (("l", L, invdl), ("u", U, invdu)):
                for sweeps in k22_sweeps:
                    launch = ops_trs.trs_fused_launch(T, sweeps, dev)
                    seen["trs_fused"].add(launch["route"])
                    what = f"trs_fused {dims} {side} {tag} sweeps {sweeps}"
                    if sweeps == SWEEPS7:
                        check(launch["route"] == want,
                              f"{what}: the {launch['route']} route, not the {want} one")
                    if inner and launch["route"] == "pipelined":
                        interior(launch, what)
                        shapes["trs_fused"].add((len(T.offsets), sweeps))
                    row["launches"][f"trs_fused {side} {tag} {sweeps}"] = launch
                    for rhs in (b, bn):
                        k1 = ops_trs.trs_fused(T, invd, rhs, sweeps=sweeps)
                        k2 = ops_trs.trs_fused(T, invd, rhs, sweeps=sweeps)
                        p = ops_trs.trs_reference(T, invd, rhs, sweeps=sweeps)
                        if record_err is not None:
                            record_err("trs_fused", k1, p)
                        check(bit_equal(k1, p) and bit_equal(k1, k2),
                              f"{what}: x differs from its plain version or from itself")
                        n_cases += 1
            for sl, su in k23_sweeps:
                launch = ops_cg_ilu.cg_ilu_fused_launch(A, L, U, sl, su, dev)
                seen["cg_ilu_fused"].add(launch["route"])
                what = f"cg_ilu_fused {dims} {tag} sweeps {sl}/{su}"
                if sl == su == SWEEPS7:
                    check(launch["route"] == want,
                          f"{what}: the {launch['route']} route, not the {want} one")
                if inner and launch["route"] == "pipelined":
                    interior(launch, what)
                    shapes["cg_ilu_fused"].add((len(L.offsets), sl))
                row["launches"][f"cg_ilu_fused {tag} {sl}/{su}"] = launch
                kw = dict(sweeps_l=sl, sweeps_u=su, tol_sq_eff=tol, max_iters=40)
                k1 = ops_cg_ilu.cg_ilu_fused(A, L, U, invdl, invdu, b, z, **kw)
                k2 = ops_cg_ilu.cg_ilu_fused(A, L, U, invdl, invdu, b, z, **kw)
                p = ops_cg_ilu.cg_ilu_reference(A, L, U, invdl, invdu, b, z, **kw)
                if record_err is not None:
                    record_err("cg_ilu_fused", k1[0], p[0])
                its = (int(k1[2]), int(k2[2]), int(p[2]))
                check(its[0] == its[1] == its[2] and bit_equal(k1[0], p[0])
                      and bit_equal(k1[1], p[1]) and bit_equal(k1[0], k2[0]),
                      f"{what}: iterations {its}, x or r differs from the plain version's or "
                      f"from itself")
                row.setdefault("cg_ilu_iterations", {})[f"{sl}/{su} {tag}"] = its[0]
                n_cases += 1
        row.update(cases=n_cases, bit_equal=True, s=round(time.perf_counter() - t0, 2))
        emit(row)
        rows.append(row)
        del A, M, Tl, Tu, invdl, invdu, b, bn, z
    check(all(v == {"pipelined", "barrier"} for v in seen.values()),
          f"the edge checks did not reach both routes of K22 and K23: {seen}")
    every = {(nd, sw) for nd in range(1, 5) for sw in range(1, 5)}
    check(all(v == every for v in shapes.values()),
          f"the edge checks did not run every compiled shape through interior steps: "
          f"{ {k: sorted(every - v) for k, v in shapes.items()} }")
    return rows


def _ilu_checks(dev, record_err):
    """compare(name, what, kern, plain, exact, cap=None), which runs a K22-K24
    kernel twice and its plain version once and checks them, and cases(A,
    M, b, tol, cap, sweeps, storage, solvers), the (kernel, plain version)
    pairs of K22 on M's lower triangle and of the ILU solvers named, with
    sweeps_l = sweeps and sweeps_u = sweeps + 1 mod 9."""
    from ginkgo_tpu_torch.ops import cg_ilu as ops_cg_ilu
    from ginkgo_tpu_torch.ops import trs as ops_trs

    def compare(name, what, kern, plain, exact, cap=None):
        t0 = time.perf_counter()
        k = kern()
        _sync(dev)
        k_s = time.perf_counter() - t0
        k2 = kern()
        t0 = time.perf_counter()
        p = plain()
        _sync(dev)
        p_s = time.perf_counter() - t0
        if name == "trs_fused":
            kx, kit, kmon, kconv, px, pit, pmon, pconv = k, 0, 0.0, True, p, 0, 0.0, True
            same = torch.equal(k2, k)
        else:
            kx, kit, kmon, kconv = k[0], int(k[2]), float(k[3]), bool(k[4])
            px, pit, pmon, pconv = p[0], int(p[2]), float(p[3]), bool(p[4])
            same = int(k2[2]) == kit and (torch.equal(k2[0], kx) or np.isnan(kmon))
        check(same, f"{what}: the kernel differs from itself")
        row = {"iters": kit, "plain_iters": pit, "s": round(k_s, 4), "plain_s": round(p_s, 4)}
        if cap is not None and np.isnan(kmon):
            check(kit == pit == cap and np.isnan(pmon) and not kconv and not pconv,
                  f"{what}: with a NaN, {kit} / {pit} iterations, monitors {kmon} / {pmon}")
            return row
        err = record_err(name, kx, px)
        row.update(bit_equal=bool(torch.equal(kx, px)), x_max_abs_err=err, converged=kconv)
        check(kit == pit and kconv == pconv,
              f"{what}: {kit} / {pit} iterations, converged {kconv} / {pconv}")
        if exact:
            check(row["bit_equal"], f"{what}: x differs by {err}")
        else:
            check(bool(torch.isfinite(kx).all()) and err <= 1e-5 * float(px.abs().max()),
                  f"{what}: x differs by {err}")
        return row

    def cases(A, M, b, tol, cap, sweeps, storage, solvers):
        Tl, Tu, invdl, invdu = _ilu_parts(M)
        Tl, Tu = Tl.astype(storage), Tu.astype(storage)
        z = torch.zeros_like(b)
        out = {"trs_fused": (lambda: ops_trs.trs_fused(Tl, invdl, b, sweeps=sweeps),
                             lambda: ops_trs.trs_reference(Tl, invdl, b, sweeps=sweeps))}
        kw = dict(sweeps_l=sweeps, sweeps_u=(sweeps + 1) % 9, tol_sq_eff=tol, max_iters=cap)
        for name in solvers:
            kern = getattr(ops_cg_ilu, name)
            plain = (ops_cg_ilu.cg_ilu_reference if name == "cg_ilu_fused"
                     else ops_cg_ilu.bicgstab_ilu_reference)
            out[name] = (lambda kern=kern: kern(A, Tl, Tu, invdl, invdu, b, z, **kw),
                         lambda plain=plain: plain(A, Tl, Tu, invdl, invdu, b, z, **kw))
        return out

    return compare, cases


def check_ilu_small(gt, dev, rng, record_err):
    """K22-K24 against their plain versions at 24^2 and 64^2 (the Poisson
    matrix with IC triangles for K22/K23 and with ILU ones for K23, the
    convection-diffusion matrix with ILU triangles for K22/K24): float32
    and bfloat16 triangles, float32 and bfloat16 A, sweeps 0/1/3/8
    (K23/K24 with the U side one more, mod 9): equal iterations and x bit
    for bit; a NaN in b runs to the cap on both.  K24 must take both of its
    routes (the walk at 1/2 and 3/4 sweeps, the barrier routine where a side
    has 0).  Then K24 on the Laplacian of a 3000 x 8 grid (w = 3000, ILU) at
    3 sweeps: with float32 triangles step 1's three staged vectors do not
    fit a block and it takes its walk with p in a pass of its own, with
    bfloat16 triangles the walk; bit for bit.  Every kernel runs twice and
    must equal itself."""
    from ginkgo_tpu_torch.ops import cg_ilu as ops_cg_ilu

    compare, cases = _ilu_checks(dev, record_err)
    small_cap = 300
    k24_routes = dict(ops_cg_ilu.bicgstab_ilu_fused.routes)
    for nside in (24, SMALL):
        systems = (
            ("poisson_ic", gt.generators.poisson_2d(nside, dtype=np.float32), "ic",
             ("cg_ilu_fused",)),
            ("poisson_ilu", gt.generators.poisson_2d(nside, dtype=np.float32), "ilu",
             ("cg_ilu_fused",)),
            ("convdiff_ilu", gt.MatrixData.from_coo(*convdiff_2d(nside)), "ilu",
             ("bicgstab_ilu_fused",)),
        )
        for label, data, kind, solvers in systems:
            A = gt.Dia.from_matrix_data(data, device=dev)
            M = ilu_factories(gt, kind).generate(A)
            b = torch.as_tensor(rng.uniform(0.5, 1.5, A.shape[0]).astype(np.float32), device=dev)
            tol = torch.full((), (TOL * float(b.norm())) ** 2, dtype=torch.float32, device=dev)
            row = {"phase": "kernel_check", "path": 7, "matrix": f"{label}({nside})"}
            for storage in (torch.float32, torch.bfloat16):
                for Av in (A, A.reduce_storage()):
                    for sweeps in (0, 1, 3, 8):
                        for name, (kern, plain) in cases(Av, M, b, tol, small_cap, sweeps,
                                                         storage, solvers).items():
                            if name == "trs_fused" and Av is not A:
                                continue  # K22 does not read A
                            key = (f"{name} tri {str(storage)[6:]} A {str(Av.dtype)[6:]} "
                                   f"sweeps {sweeps}")
                            row[key] = compare(name, f"{key} {label}({nside})", kern, plain,
                                               exact=True)
            bn = b.clone()
            bn[5] = float("nan")
            for name, (kern, plain) in cases(A, M, bn, tol, 25, 3, torch.float32,
                                             solvers).items():
                if name != "trs_fused":
                    row[f"{name} nan"] = compare(name, f"{name} {label}({nside}) nan", kern,
                                                 plain, exact=True, cap=25)
            emit(row)
    k24_routes = {k: v - k24_routes[k] for k, v in ops_cg_ilu.bicgstab_ilu_fused.routes.items()}
    check(k24_routes["pipelined"] > 0 and k24_routes["barrier"] > 0,
          f"K24's checks at 24^2 and {SMALL}^2 did not take both routes: {k24_routes}")

    # K24 where only the walk with p in a pass of its own fits a block
    A = gt.Dia.from_matrix_data(gt.MatrixData.from_coo(*grid_laplacian((3000, 8, 1))),
                                device=dev)
    M = ilu_factories(gt, "ilu").generate(A)
    b = torch.as_tensor(rng.uniform(0.5, 1.5, A.shape[0]).astype(np.float32), device=dev)
    tol = torch.full((), (TOL * float(b.norm())) ** 2, dtype=torch.float32, device=dev)
    Tl, Tu, invdl, invdu = _ilu_parts(M)
    z = torch.zeros_like(b)
    kw = dict(sweeps_l=SWEEPS7, sweeps_u=SWEEPS7, tol_sq_eff=tol, max_iters=small_cap)
    row = {"phase": "kernel_check", "path": 7, "matrix": "laplacian(3000x8)"}
    # bfloat16 triangles stage half the bytes: step 1's three vectors fit
    for storage, route in ((torch.float32, "pipelined_p_pass"), (torch.bfloat16, "pipelined")):
        L, U = Tl.astype(storage), Tu.astype(storage)
        key = f"bicgstab_ilu_fused tri {str(storage)[6:]} sweeps {SWEEPS7}/{SWEEPS7}"
        launch = ops_cg_ilu.bicgstab_ilu_fused_launch(A, L, U, SWEEPS7, SWEEPS7, dev)
        check(launch["route"] == route
              and launch["grid_barriers"] == (8 if route == "pipelined_p_pass" else 7),
              f"{key} laplacian(3000x8): the {launch['route']} route")
        before = ops_cg_ilu.bicgstab_ilu_fused.routes[route]
        row[key] = compare(
            "bicgstab_ilu_fused", f"{key} laplacian(3000x8)",
            lambda L=L, U=U: ops_cg_ilu.bicgstab_ilu_fused(A, L, U, invdl, invdu, b, z, **kw),
            lambda L=L, U=U: ops_cg_ilu.bicgstab_ilu_reference(A, L, U, invdl, invdu, b, z,
                                                               **kw),
            exact=True)
        check(ops_cg_ilu.bicgstab_ilu_fused.routes[route] == before + 2,
              f"{key} laplacian(3000x8): not the {route} route")
        row[f"{key} launch"] = launch
    emit(row)
    del A, M



def check_path7_kernels(gt, dev, rng, p7, record_err):
    """K22-K24 against their plain versions on the card: ``check_ilu_small``,
    then at 2048^2 (path 7's preconditioners, float32 and bfloat16
    triangles) K23 and K24 under a cap of CAP6 iterations (the U side one
    sweep more) and K22 with 3 sweeps: equal counts, x bit for bit; then
    path 7's own launches, bit for bit: K22 on both triangles and K23 with
    3 sweeps in both, and K24 with 3 sweeps in both on its walk, each on
    the kernels compiled for its shape.  Every kernel runs twice and must
    equal itself.  Then ``check_trs_edges``."""
    from ginkgo_tpu_torch.ops import cg_ilu as ops_cg_ilu
    from ginkgo_tpu_torch.ops import trs as ops_trs

    compare, cases = _ilu_checks(dev, record_err)
    check_ilu_small(gt, dev, rng, record_err)
    row = {"phase": "kernel_check", "path": 7, "nside": NSIDE, "cap": CAP6}
    for label, A, M, b, solvers in (("poisson_ic", p7["A1"], p7["M_ic"], p7["b1"],
                                     ("cg_ilu_fused",)),
                                    ("poisson_ilu", p7["A1"], p7["M_ilu"], p7["b1"],
                                     ("cg_ilu_fused",)),
                                    ("convdiff_ilu", p7["A2"], p7["M2"], p7["b2"],
                                     ("bicgstab_ilu_fused",))):
        tol = torch.full((), (TOL * float(b.norm())) ** 2, dtype=torch.float32, device=dev)
        for storage in (torch.float32, torch.bfloat16):
            for name, (kern, plain) in cases(A, M, b, tol, CAP6, SWEEPS7, storage,
                                             solvers).items():
                key = f"{name} {label} tri {str(storage)[6:]}"
                row[key] = compare(name, f"{key} {NSIDE}", kern, plain, exact=True)
            Tl, Tu, invdl, invdu = _ilu_parts(M)
            L, U = Tl.astype(storage), Tu.astype(storage)
            z = torch.zeros_like(b)
            tag = f"{label} tri {str(storage)[6:]}"
            kw = dict(sweeps_l=SWEEPS7, sweeps_u=SWEEPS7, tol_sq_eff=tol, max_iters=CAP6)
            if "cg_ilu_fused" not in solvers:
                # path 7's own launch of K24: SWEEPS7 in both, on the walk
                # kernel compiled for its shape
                launch = ops_cg_ilu.bicgstab_ilu_fused_launch(A, L, U, SWEEPS7, SWEEPS7, dev)
                check(launch["route"] == "pipelined" and launch["grid_barriers"] == 7
                      and launch["unrolled"]
                      and all(w["interior_steps"] > 0 for w in launch["walks"]),
                      f"bicgstab_ilu_fused {tag} {NSIDE}: not the walk compiled for its shape "
                      f"({launch})")
                before = ops_cg_ilu.bicgstab_ilu_fused.routes["pipelined"]
                row[f"bicgstab_ilu_fused {tag} sweeps {SWEEPS7}/{SWEEPS7}"] = compare(
                    "bicgstab_ilu_fused", f"bicgstab_ilu_fused {tag} {SWEEPS7}/{SWEEPS7} {NSIDE}",
                    lambda L=L, U=U: ops_cg_ilu.bicgstab_ilu_fused(A, L, U, invdl, invdu, b, z,
                                                                   **kw),
                    lambda L=L, U=U: ops_cg_ilu.bicgstab_ilu_reference(A, L, U, invdl, invdu, b,
                                                                       z, **kw),
                    exact=True)
                check(ops_cg_ilu.bicgstab_ilu_fused.routes["pipelined"] == before + 2,
                      f"bicgstab_ilu_fused {tag} {NSIDE}: not the walk")
                continue
            # path 7's own launches: both triangles through K22 and K23 at
            # SWEEPS7 in both, on the kernels compiled for their shape
            for side, T, invd in (("l", L, invdl), ("u", U, invdu)):
                launch = ops_trs.trs_fused_launch(T, SWEEPS7, dev)
                check(launch["route"] == "pipelined" and launch["unrolled"]
                      and launch["walks"][0]["interior_steps"] > 0,
                      f"trs_fused {tag} {side} {NSIDE}: not the walk compiled for its shape "
                      f"({launch})")
                row[f"trs_fused {tag} {side} sweeps {SWEEPS7}"] = compare(
                    "trs_fused", f"trs_fused {tag} {side} {NSIDE}",
                    lambda T=T, invd=invd: ops_trs.trs_fused(T, invd, b, sweeps=SWEEPS7),
                    lambda T=T, invd=invd: ops_trs.trs_reference(T, invd, b, sweeps=SWEEPS7),
                    exact=True)
            launch = ops_cg_ilu.cg_ilu_fused_launch(A, L, U, SWEEPS7, SWEEPS7, dev)
            check(launch["route"] == "pipelined" and launch["unrolled"]
                  and all(w["interior_steps"] > 0 for w in launch["walks"]),
                  f"cg_ilu_fused {tag} {NSIDE}: not the walks compiled for their shape "
                  f"({launch})")
            row[f"cg_ilu_fused {tag} sweeps {SWEEPS7}/{SWEEPS7}"] = compare(
                "cg_ilu_fused", f"cg_ilu_fused {tag} {SWEEPS7}/{SWEEPS7} {NSIDE}",
                lambda L=L, U=U: ops_cg_ilu.cg_ilu_fused(A, L, U, invdl, invdu, b, z, **kw),
                lambda L=L, U=U: ops_cg_ilu.cg_ilu_reference(A, L, U, invdl, invdu, b, z, **kw),
                exact=True)
    emit(row)
    check_trs_edges(gt, dev, rng, record_err)


def time_path7(gt, dev, p7, rec, timing):
    """Per-iteration times by the slope between whole solves with
    Iteration-only criteria: K23 with path 7's IC on A1 and K24 with its
    ILU on A2, between Iteration(200) and Iteration(1000), each beside its
    streaming route (K1 + K22, between 25 and 125) and its plain version
    (between PLAIN_TRIPS);
    K22 per launch (3 sweeps on A1's IC lower triangle, slope of chained
    launches) beside its plain version.

    Bounds (NVIDIA's peak rates, each input read once, each output written
    once): K22 the triangle's diagonals, b and the inverse diagonal read,
    x written, (4 nd + 12) n bytes, (s (2 nd + 2) + 1) n operations.  K23 per
    iteration A's, L's and U's diagonals, x, r and p read and written, the
    two inverse diagonals read, (4 (nd_A + nd_L + nd_U) + 32) n bytes; K24
    per iteration the same with x, r, p and v read and written and rr read,
    (4 (nd_A + nd_L + nd_U) + 44) n; beside them ``bound_ms_tri_per_sweep``
    with the triangles' diagonals read once per sweep pass.  Operations: the
    products with A and the sweeps (2 a stored diagonal entry, 2 a row a
    sweep, 1 a row a solve's start) and the vector work (K23 12 n, K24 22 n
    a product-pair)."""
    from ginkgo_tpu_torch import stop
    from ginkgo_tpu_torch.ops import cg_ilu as ops_cg_ilu
    from ginkgo_tpu_torch.ops import trs as ops_trs

    s = SWEEPS7
    out = {"card": timing["card"], "sweeps": s}

    def tri_flops(M, n):
        return sum((s * (2 * t.off_csr.num_diags + 2) + 1) * n for t in (M.l_solver, M.u_solver))

    for kname, cls, A, M, b, n_m, vec_bytes, vec_flops in (
            ("cg_ilu_fused", gt.Cg, p7["A1"], p7["M_ic"], p7["b1"], 1, 32, 12),
            ("bicgstab_ilu_fused", gt.Bicgstab, p7["A2"], p7["M2"], p7["b2"], 2, 44, 22)):
        n = A.shape[0]
        z = torch.zeros_like(b)
        solver = cls.build(criteria=[stop.Iteration(max_iters=1)], preconditioner=M).generate(A)

        def capped(its, solver=solver):
            return solver.replace(criterion=stop.Iteration(max_iters=its))

        def fused(its, b=b):
            capped(its).solve(b)

        def streaming(its, b=b, z=z):
            with torch.no_grad():
                capped(its)._solve_streaming(b[:, None], z[:, None])

        Tl, Tu, invdl, invdu = _ilu_parts(M)
        plain_fn = (ops_cg_ilu.cg_ilu_reference if kname == "cg_ilu_fused"
                    else ops_cg_ilu.bicgstab_ilu_reference)

        def plain(its, A=A, Tl=Tl, Tu=Tu, invdl=invdl, invdu=invdu, b=b, z=z, fn=plain_fn):
            fn(A, Tl, Tu, invdl, invdu, b, z, sweeps_l=s, sweeps_u=s, tol_sq_eff=-1.0,
               max_iters=its)

        nd_t = Tl.num_diags + Tu.num_diags
        nbytes = (4 * (A.num_diags + nd_t) + vec_bytes) * n
        nbytes_sweep = (4 * A.num_diags + 4 * s * nd_t + vec_bytes) * n
        flops = n_m * (2 * A.num_diags * n + tri_flops(M, n)) + vec_flops * n
        f_ms, st_ms = iter_ms(fused), iter_ms(streaming, *STREAM_TRIPS)
        p_ms = iter_ms(plain, *PLAIN_TRIPS)
        rec[kname] = (f_ms, p_ms, None, nbytes, flops)
        out[kname] = {"fused_us": f_ms * 1e3, "streaming_us": st_ms * 1e3, "plain_us": p_ms * 1e3,
                      "bytes": nbytes, "GBps": nbytes / f_ms / 1e6,
                      "bound_ms_tri_per_sweep": bound(nbytes_sweep, flops)[0]}
    M = p7["M_ic"]
    Tl, _, invdl, _ = _ilu_parts(M)
    b = p7["b1"]
    n = b.shape[0]
    k22 = lambda: ops_trs.trs_fused(Tl, invdl, b, sweeps=s)  # noqa: E731
    k_ms = slope_ms(k22)
    p_ms = slope_ms(lambda: ops_trs.trs_reference(Tl, invdl, b, sweeps=s), 2, 7, 2)
    nbytes = (4 * Tl.num_diags + 12) * n
    flops = (s * (2 * Tl.num_diags + 2) + 1) * n
    rec["trs_fused"] = (k_ms, p_ms, None, nbytes, flops)
    # the slope of chained calls measures the kernel while the wrapper's host
    # time a call stays below it
    out["trs_fused"] = {"us": k_ms * 1e3, "host_us_per_call": host_us(k22),
                        "plain_us": p_ms * 1e3, "bytes": nbytes, "GBps": nbytes / k_ms / 1e6,
                        "bound_ms_tri_per_sweep": bound((4 * Tl.num_diags * s + 12) * n,
                                                        flops)[0]}

    def kernel_row(launch):
        """The launch as fields of the kernel's row, whose "route" is the
        kernel's language: the solve's route as "sweep_route"."""
        row = dict(launch)
        row["sweep_route"] = row.pop("route")
        return row

    M2 = p7["M2"]
    out["launch"] = {
        "trs_fused": kernel_row(ops_trs.trs_fused_launch(Tl, s, dev)),
        "cg_ilu_fused": kernel_row(ops_cg_ilu.cg_ilu_fused_launch(p7["A1"], Tl, _ilu_parts(M)[1],
                                                                  s, s, dev)),
        "bicgstab_ilu_fused": kernel_row(ops_cg_ilu.bicgstab_ilu_fused_launch(
            p7["A2"], M2.l_solver.off_csr, M2.u_solver.off_csr, s, s, dev))}
    timing["slice7"] = out


# -- path 8: algebraic multigrid ------------------------------------------------------

#: path 8: levels of the multigrid hierarchy on the 2048^2 grids; 12 levels
#: leave 1024 coarse rows, under the 1536-row cap of the dense coarse
#: inverse that the fused routes need (the default 10 leave 4096)
MG_LEVELS8 = 12
#: path 8: the standalone multigrid solve's cycle cap (a float32 V(1,1)
#: cycle of pairwise aggregation stagnates above 1e-6 on these matrices)
MG_SOLVE_CAP8 = 100


def mg_generate(gt, A, dev, **kw):
    """(Multigrid, set-up row): the factory with MG_LEVELS8 levels on A, each
    level's host seconds as its Pgm recorded them, and the dense coarse
    inverse's seconds."""
    t0 = time.perf_counter()
    M = gt.Multigrid.build(max_levels=MG_LEVELS8, **kw).generate(A)
    _sync(dev)
    total = time.perf_counter() - t0
    op = M.levels[-1].coarse_op
    _, inv_s = _timed(lambda: gt.MultigridFactory._coarse_inverse(op, M.coarse_solver), dev)
    h = M._fused_hierarchy()
    check(h is not None and M.coarse_dense_inv is not None,
          "path 8: the hierarchy does not take the fused multigrid kernels")
    levels = [{"rows": lvl.fine_op.shape[0],
               **{f"{k}_s": round(v, 3) for k, v in lvl.setup_seconds.items()}}
              for lvl in M.levels]
    row = {"generate_s": round(total, 3), "coarse_inverse_s": inv_s, "levels": levels,
           "coarse_rows": op.shape[0], "strides": list(h.strides),
           "diagonals": [len(o) for o in h.offsets],
           "cycle_barriers": ops_barriers(h), "mg_cg_fused_barriers": solver_barriers("mg_cg_fused", h)}
    # V(1,1): one fused restriction and one fused prolongation a level
    check(row["cycle_barriers"] == 2 * h.L + 1,
          f"path 8: {row['cycle_barriers']} barriers a {h.L}-level cycle, not {2 * h.L + 1}")
    return M, row


def ops_barriers(h):
    from ginkgo_tpu_torch.ops import mg as ops_mg

    return ops_mg.barriers(h.passes[False][0])


def solver_barriers(kernel, h):
    """K26's or K28's grid barriers an iteration on h's pass list from zero
    (``ops/mg.mg_cg_barriers``, ``ops/mg.mg_bicgstab_barriers``)."""
    from ginkgo_tpu_torch.ops import mg as ops_mg

    count = ops_mg.mg_cg_barriers if kernel == "mg_cg_fused" else ops_mg.mg_bicgstab_barriers
    return count(h.passes[False][0])


def main_path8(gt, dev, rng, crit, kernels, data1, x64_ones, p4, cg_iterations):
    """Main path 8 through the entry points a user calls; every check raises.
    A1 (path 1's 2048^2 Poisson ``Dia``) with ``Multigrid(max_levels=12)``
    (Pgm, FixedSmoother V(1,1) at 0.9, Direct coarse solve through its dense
    inverse): ``Cg`` + MG and ``Fcg`` + MG fused (K26) to 1e-6, fewer
    iterations than CG's; ``Multigrid.solve`` fused (K27) to a cap of 100
    cycles, its relative residual reported; the same three through the
    streaming cycle (the hierarchy without its dense inverse: K1 products,
    K17 ir_smooth for every smoothing, tensor transfers, Direct at the
    coarse level).  A2 (path 4's convection-diffusion ``Dia``), its own
    hierarchy: ``Bicgstab`` + MG fused (K28), and ``Gmres(30)`` + MG, whose
    streaming loop runs each M apply in one K25 launch.  Every solution is
    held against a float64 solve of its system where it converges."""
    from ginkgo_tpu_torch import stop

    A1, b1 = p4["A1"], p4["b1"]
    norm1 = inf_norm(data1)
    M1, row = mg_generate(gt, A1, dev)
    emit({"phase": "main_path", "path": 8, "case": "setup_a1", **row})
    A2, b2, ref2, norm2 = p4["A"], p4["b"], p4["refs"]["f32"], p4["norm_a"]
    M2, row = mg_generate(gt, A2, dev)
    emit({"phase": "main_path", "path": 8, "case": "setup_a2", **row})
    M1s = M1.replace(coarse_dense_inv=None)  # the streaming cycle
    check(M1s._fused_hierarchy() is None, "path 8: the streaming hierarchy is fused")

    def launched(before, name):
        return kernels[name].launches - before[name]

    out = {"A1": A1, "b1": b1, "M1": M1, "M1s": M1s, "A2": A2, "b2": b2, "M2": M2}
    runs = (("cg_mg", gt.Cg, A1, M1, b1, x64_ones, norm1, "mg_cg_fused", cg_iterations["a1"]),
            ("fcg_mg", gt.Fcg, A1, M1, b1, x64_ones, norm1, "mg_cg_fused", cg_iterations["a1"]),
            ("bicgstab_mg", gt.Bicgstab, A2, M2, b2, ref2, norm2, "mg_bicgstab_fused",
             p4["iterations"]["bicgstab"]))
    iterations = {}
    for label, cls, A, M, b, ref, norm_a, kname, plain_its in runs:
        solver = cls.build(criteria=crit, preconditioner=M).generate(A)
        before = {k: f.launches for k, f in kernels.items()}
        (x, info), solve_s = _timed(lambda: solver.solve(b), dev)
        check(launched(before, kname) == 1 and launched(before, "mg_vcycle") == 0,
              f"path 8: {label} did not run {kname} once")
        check(bool(info.converged.all()), f"path 8: {label}: not converged")
        its = iterations[label] = info.num_iterations
        check(its < plain_its, f"path 8: {label}: {its} iterations, {plain_its} without MG")
        emit({"phase": "main_path", "path": 8, "route": "fused", "case": label,
              "iterations": its, "unpreconditioned_iterations": plain_its,
              "residual_norm": float(info.residual_norm[0]),
              **accuracy(A, x, b, ref, norm_a, f"path 8: {label}"), "solve_s": solve_s})
    # the streaming cycle under CG and FCG
    for label, cls in (("cg_mg", gt.Cg), ("fcg_mg", gt.Fcg)):
        solver = cls.build(criteria=crit, preconditioner=M1s).generate(A1)
        before = {k: f.launches for k, f in kernels.items()}
        (x, info), solve_s = _timed(lambda: solver.solve(b1), dev)
        its = info.num_iterations
        smooth = launched(before, "ir_smooth")
        check(not any(launched(before, k) for k in PATH8 if k != "ir_smooth")
              and smooth >= 2 * len(M1s.levels) * its,
              f"path 8: {label} streaming: {smooth} ir_smooth launches in {its} iterations")
        check(bool(info.converged.all()) and abs(its - iterations[label]) <= max(2, its // 20),
              f"path 8: {label} streaming: {its} iterations, fused {iterations[label]}")
        emit({"phase": "main_path", "path": 8, "route": "streaming", "case": label,
              "iterations": its, "ir_smooth_launches": smooth,
              "dia_spmv_launches": launched(before, "dia_spmv"),
              **accuracy(A1, x, b1, x64_ones, norm1, f"path 8: {label} streaming"),
              "solve_s": solve_s})
    # the standalone solve to its cap, fused (K27) and streaming
    mg_crit = stop.combine([stop.Iteration(max_iters=MG_SOLVE_CAP8),
                            stop.ResidualNorm(tolerance=TOL)])
    bn = float(b1.norm())
    for route, M, kname in (("fused", M1, "mg_solve_fused"), ("streaming", M1s, "ir_smooth")):
        before = {k: f.launches for k, f in kernels.items()}
        (x, info), solve_s = _timed(lambda: M.replace(criterion=mg_crit).solve(b1), dev)
        check(launched(before, kname) >= 1 and bool(torch.isfinite(x).all()),
              f"path 8: mg_solve {route} did not run {kname}")
        relres = float((b1 - A1.apply(x)).norm()) / bn
        out[f"mg_solve_{route}"] = (info.num_iterations, relres)
        emit({"phase": "main_path", "path": 8, "route": route, "case": "mg_solve",
              "iterations": info.num_iterations, "cap": MG_SOLVE_CAP8,
              "converged": bool(info.converged.all()), "relres": relres,
              "reported_residual_norm": float(info.residual_norm[0]),
              f"{kname}_launches": launched(before, kname),
              **accuracy(A1, x, b1, x64_ones, norm1, f"path 8: mg_solve {route}",
                         bounded=False), "solve_s": solve_s})
    f_it, f_res = out["mg_solve_fused"]
    s_it, s_res = out["mg_solve_streaming"]
    check(f_res < 0.5 and s_res < 0.5 and abs(np.log10(f_res / s_res)) < 1,
          f"path 8: mg_solve relative residuals fused {f_res}, streaming {s_res}")
    # GMRES(30) + MG on A2: streaming GMRES, each M apply one K25 launch
    solver = gt.Gmres.build(criteria=crit, krylov_dim=KRYLOV_DIM, preconditioner=M2).generate(A2)
    before = {k: f.launches for k, f in kernels.items()}
    (x, info), solve_s = _timed(lambda: solver.solve(b2), dev)
    k25 = launched(before, "mg_vcycle")
    check(k25 >= info.num_iterations, f"path 8: gmres_mg: {k25} mg_vcycle launches in "
          f"{info.num_iterations} steps")
    converged = bool(info.converged.all())
    check(info.num_iterations < p4["iterations"]["gmres"] or not converged,
          f"path 8: gmres_mg: {info.num_iterations} steps")
    emit({"phase": "main_path", "path": 8, "route": "streaming", "case": "gmres_mg",
          "iterations": info.num_iterations, "converged": converged,
          "unpreconditioned_iterations": p4["iterations"]["gmres"], "mg_vcycle_launches": k25,
          **accuracy(A2, x, b2, ref2, norm2, "path 8: gmres_mg", bounded=converged),
          "solve_s": solve_s})
    out["iterations"] = iterations
    return out


def mg_kernel_cases(A, h, b, x0, tol, cap, solve_cap):
    """{case: (kernel call, plain call)} of K25 (from zero and from x0),
    K26 (CG, FCG), K27 and K28 on hierarchy h and operator A."""
    from ginkgo_tpu_torch.ops import mg as ops_mg

    z = torch.zeros_like(b)
    kw = dict(tol_sq_eff=tol, max_iters=cap)
    return {
        "mg_vcycle": (lambda: ops_mg.mg_vcycle(h, b), lambda: ops_mg.mg_vcycle_reference(h, b)),
        "mg_vcycle x0": (lambda: ops_mg.mg_vcycle(h, b, x0),
                         lambda: ops_mg.mg_vcycle_reference(h, b, x0)),
        "mg_cg_fused": (lambda: ops_mg.mg_cg_fused(A, h, b, z, **kw),
                        lambda: ops_mg.mg_cg_solve_reference(A, h, b, z, **kw)),
        "mg_cg_fused fcg": (lambda: ops_mg.mg_cg_fused(A, h, b, z, flexible=True, **kw),
                            lambda: ops_mg.mg_cg_solve_reference(A, h, b, z, flexible=True,
                                                                 **kw)),
        "mg_solve_fused": (
            lambda: ops_mg.mg_solve_fused(h, b, z, tol_sq_eff=tol, max_iters=solve_cap),
            lambda: ops_mg.mg_solve_reference(h, b, z, tol_sq_eff=tol, max_iters=solve_cap)),
        "mg_bicgstab_fused": (lambda: ops_mg.mg_bicgstab_fused(A, h, b, z, **kw),
                              lambda: ops_mg.mg_bicgstab_solve_reference(A, h, b, z, **kw)),
    }


def mg_compare(dev, record_err, name, what, kern, plain, cap=None):
    """One K25-K28 case: the kernel twice (equal to itself), then its plain
    version: equal iterations and x bit for bit, or with a NaN in b (cap
    given) both at the cap with NaN monitors.  Returns the case's row."""
    t0 = time.perf_counter()
    k = kern()
    _sync(dev)
    k_s = time.perf_counter() - t0
    k2 = kern()
    t0 = time.perf_counter()
    p = plain()
    _sync(dev)
    p_s = time.perf_counter() - t0
    if name == "mg_vcycle":
        kx, kit, kmon, kconv, px, pit, pmon, pconv = k, 0, 0.0, True, p, 0, 0.0, True
        same = torch.equal(k2, k)
    else:
        i_it, i_mon, i_conv = (1, 2, 3) if name == "mg_solve_fused" else (2, 3, 4)
        kx, kit, kmon, kconv = k[0], int(k[i_it]), float(k[i_mon]), bool(k[i_conv])
        px, pit, pmon, pconv = p[0], int(p[i_it]), float(p[i_mon]), bool(p[i_conv])
        same = int(k2[i_it]) == kit and (torch.equal(k2[0], kx) or np.isnan(kmon))
    check(same, f"{what}: the kernel differs from itself")
    row = {"iters": kit, "plain_iters": pit, "s": round(k_s, 4), "plain_s": round(p_s, 4)}
    if cap is not None and np.isnan(kmon):
        check(kit == pit == cap and np.isnan(pmon) and not kconv and not pconv,
              f"{what}: with a NaN, {kit} / {pit} iterations, monitors {kmon} / {pmon}")
        return row
    err = record_err(name, kx, px) if record_err is not None else float(
        (kx.double() - px.double()).abs().max())
    row.update(bit_equal=bool(torch.equal(kx, px)), x_max_abs_err=err, converged=kconv)
    check(kit == pit and kconv == pconv,
          f"{what}: {kit} / {pit} iterations, converged {kconv} / {pconv}")
    check(row["bit_equal"], f"{what}: x differs by {err}")
    return row


def check_mg_edges(gt, dev, rng, record_err=None):
    """K25-K28 against their plain versions at 64^2 (the Poisson matrix, 6
    levels of at least 32 rows) with V, W, F and K cycles, the four
    mid_case values under F, kcycle_rel_tol 0, 0.25 and +inf under K and
    two sweeps under F 'both', float32 diagonals, and bfloat16 ones under
    V and under K at each rel_tol; on pass lists that fuse in part
    (``PARTIAL_FUSION8``: two pre-sweeps, so no fused restriction; no
    post-sweep, so no fused prolongation; a W-cycle without pre-sweeps; a
    K-cycle); and V-cycles, float32 and bfloat16, on a line of 4096 rows
    and the 9-point Laplacian at 64^2, whose levels of 3 and 9 diagonals
    run the cycle's generic pass.  K25 from zero and from a random x, K26
    (CG and FCG), K27 and K28, each twice: equal to itself, equal
    iterations and x bit for bit; a NaN in b runs K26 and K28 to their cap
    of 25 on both."""
    from ginkgo_tpu_torch.ops import mg as ops_mg

    def compare(name, what, kern, plain, cap=None):
        return mg_compare(dev, record_err, name, what, kern, plain, cap)

    cases = mg_kernel_cases

    data = gt.generators.poisson_2d(SMALL, dtype=np.float32)
    A = gt.Dia.from_matrix_data(data, device=dev)
    b = torch.as_tensor(rng.uniform(0.5, 1.5, A.shape[0]).astype(np.float32), device=dev)
    x0 = torch.as_tensor(rng.standard_normal(A.shape[0]).astype(np.float32), device=dev)
    tol = torch.full((), (TOL * float(b.norm())) ** 2, dtype=torch.float32, device=dev)
    configs = ([("v", "standalone", 0.25, 1), ("w", "standalone", 0.25, 1)]
               + [("f", m, 0.25, 2 if m == "both" else 1)
                  for m in ("standalone", "both", "pre_smoother", "post_smoother")]
               + [("k", "standalone", rt, 1) for rt in (0.0, 0.25, float("inf"))])
    for storage in ("f32", "bf16"):
        Av = A if storage == "f32" else A.reduce_storage()
        for cycle, mid, rt, iters in configs:
            # bfloat16: the V-cycle and the K-cycle at every rel_tol
            if storage == "bf16" and (cycle, mid) not in (("v", "standalone"),
                                                          ("k", "standalone")):
                continue
            M = gt.Multigrid.build(max_levels=6, min_coarse_rows=32, cycle=cycle, mid_case=mid,
                                   kcycle_rel_tol=rt, smoother_iters=iters).generate(Av)
            h = M._fused_hierarchy()
            check(h is not None, f"path 8: the 64^2 {cycle} hierarchy is not fused")
            label = f"{storage} {cycle} {mid} rel_tol {rt} sweeps {iters}"
            row = {"phase": "kernel_check", "path": 8, "matrix": f"poisson({SMALL})",
                   "case": label, "levels": len(M.levels), "barriers": ops_barriers(h)}
            for key, (kern, plain) in cases(Av, h, b, x0, tol, 300, 60).items():
                name = key.split(" ")[0]
                row[key] = compare(name, f"{key} {label}", kern, plain)
            bn = b.clone()
            bn[5] = float("nan")
            for key in ("mg_cg_fused", "mg_bicgstab_fused"):
                kern, plain = cases(Av, h, bn, x0, tol, 25, 25)[key]
                row[f"{key} nan"] = compare(key, f"{key} nan {label}", kern, plain, cap=25)
            emit(row)
    # pass lists that fuse in part: more pre-sweeps than one (no fused
    # restriction), no post-sweep (no fused prolongation), a K-cycle with
    # both
    for cycle, itp, ito in PARTIAL_FUSION8:
        M = gt.Multigrid.build(max_levels=6, min_coarse_rows=32, cycle=cycle).generate(A)
        h0 = M._fused_hierarchy()
        plan = dict(h0.plan, lv=[dict(e, itp=itp, ito=ito, itm=ito) for e in h0.plan["lv"]])
        h = dataclasses.replace(h0, plan=plan, _dev={}, passes={
            u: ops_mg.compile_passes(plan, use_x0=u) for u in (False, True)})
        ops = h.passes[False][0][:, 0]
        label = f"f32 {cycle} pre-sweeps {itp} post-sweeps {ito}"
        row = {"phase": "kernel_check", "path": 8, "matrix": f"poisson({SMALL})",
               "case": label, "levels": len(M.levels), "barriers": ops_barriers(h),
               "restrict_zero": int((ops == ops_mg.RESTRICT_ZERO).sum()),
               "prolong_smooth": int((ops == ops_mg.PROLONG_SMOOTH).sum()),
               "lead_barrier": ops_mg.lead_barrier(h.passes[False][0])}
        for key, (kern, plain) in cases(A, h, b, x0, tol, 300, 60).items():
            row[key] = compare(key.split(" ")[0], f"{key} {label}", kern, plain)
        emit(row)
    # levels of other than 5 diagonals, which run the cycle's generic pass
    # (csrc/mg_fused.cu GK_MG_ND)
    rng_o = np.random.default_rng(SEED + 21)
    for label, coo in (("line(4096)", banded_grid(4096, 1, (2.0, -1.0, -1.0), False)),
                       (f"9-point({SMALL})", nine_point(SMALL))):
        Ao = gt.Dia.from_matrix_data(gt.MatrixData.from_coo(*coo), device=dev)
        no = Ao.shape[0]
        bo = torch.as_tensor(rng_o.uniform(0.5, 1.5, no).astype(np.float32), device=dev)
        xo = torch.as_tensor(rng_o.standard_normal(no).astype(np.float32), device=dev)
        tolo = torch.full((), (TOL * float(bo.norm())) ** 2, dtype=torch.float32, device=dev)
        for storage in ("f32", "bf16"):
            Av = Ao if storage == "f32" else Ao.reduce_storage()
            M = gt.Multigrid.build(max_levels=6, min_coarse_rows=32).generate(Av)
            h = M._fused_hierarchy()
            nds = [len(o) for o in h.offsets] if h is not None else []
            check(h is not None and 5 not in nds,
                  f"path 8: the {label} hierarchy is not fused, or has 5-diagonal levels ({nds})")
            what = f"{storage} v {label}"
            row = {"phase": "kernel_check", "path": 8, "matrix": label, "case": what,
                   "levels": len(M.levels), "diagonals": nds, "barriers": ops_barriers(h)}
            for key, (kern, plain) in cases(Av, h, bo, xo, tolo, 300, 60).items():
                row[key] = compare(key.split(" ")[0], f"{key} {what}", kern, plain)
            emit(row)


def nine_point(nside):
    """The 9-point Laplacian on an nside x nside grid (8 on the diagonal,
    -1 to each of the eight neighbours).  Returns COO parts."""
    n = nside * nside
    i = np.arange(n)
    ix, iy = i % nside, i // nside
    rows, cols, vals = [i], [i], [np.full(n, 8.0)]
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            keep = (ix + dx >= 0) & (ix + dx < nside) & (iy + dy >= 0) & (iy + dy < nside)
            if dx or dy:
                rows.append(i[keep])
                cols.append(i[keep] + dx + dy * nside)
                vals.append(np.full(int(keep.sum()), -1.0))
    return ((n, n), np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals).astype(np.float32))


def check_path8_kernels(gt, dev, rng, p8, record_err):
    """K25-K28 against their plain versions on the card: the 64^2 cases of
    ``check_mg_edges``, then at 2048^2 on path 8's hierarchies, and on them
    with every level's diagonals and A's rounded to bfloat16: one K25
    cycle, K26/K28 under a cap of CAP6 iterations, K27 under 5 cycles:
    equal counts and x bit for bit, as at 64^2."""
    check_mg_edges(gt, dev, rng, record_err)

    def compare(name, what, kern, plain, cap=None):
        return mg_compare(dev, record_err, name, what, kern, plain, cap)

    cases = mg_kernel_cases
    row = {"phase": "kernel_check", "path": 8, "nside": NSIDE, "cap": CAP6}
    for label, Am, M, bv in (("poisson", p8["A1"], p8["M1"], p8["b1"]),
                             ("convdiff", p8["A2"], p8["M2"], p8["b2"])):
        tolv = torch.full((), (TOL * float(bv.norm())) ** 2, dtype=torch.float32, device=dev)
        xr = torch.as_tensor(rng.standard_normal(Am.shape[0]).astype(np.float32), device=dev)
        h = M._fused_hierarchy()
        for storage in ("f32", "bf16"):
            if storage == "bf16":  # the same hierarchy with its diagonals rounded
                Am = Am.reduce_storage()
                h = dataclasses.replace(h, diags=tuple(d.to(torch.bfloat16) for d in h.diags),
                                        _dev={})
            for key, (kern, plain) in cases(Am, h, bv, xr, tolv, CAP6, 5).items():
                if label == "convdiff" and key.startswith("mg_cg"):
                    continue  # CG is for the symmetric matrix
                row[f"{key} {label} {storage}"] = compare(
                    key.split(" ")[0], f"{key} {label} {storage} {NSIDE}", kern, plain)
    emit(row)


#: the 64^2 hierarchies whose pass lists fuse in part (cycle, pre-sweeps,
#: post-sweeps) in ``check_path8_kernels``
PARTIAL_FUSION8 = (("v", 2, 1), ("v", 1, 0), ("w", 0, 2), ("k", 2, 1))


def mg_cycle_cost(h, passes):
    """(bytes of the hierarchy, bytes once per pass, float32 operations) of
    one cycle of hierarchy h along the pass list (every jump falling
    through).  The hierarchy, read once: each level's diagonals and inverse
    diagonal, each coarse level's b and x, and the coarse inverse; level
    0's b and x are the caller's vectors and are counted by the caller.
    Once per pass: what each pass reads and writes."""
    from ginkgo_tpu_torch.ops import mg as ops_mg

    s = h.diags[0].element_size()
    n, nd = h.sizes, [len(o) for o in h.offsets]
    L = h.L
    hier = (sum((nd[l] * s + 4) * n[l] for l in range(L)) + 8 * sum(n[1:])
            + 4 * n[L] ** 2)
    per_pass = flops = 0
    for op, l, _, _ in passes:
        if op == ops_mg.COARSE:
            per_pass += 4 * n[L] ** 2 + 8 * n[L]
            flops += 2 * n[L] ** 2
            continue
        if op == ops_mg.JUMP:
            continue
        a = nd[l] * s
        rows_b, rows_f = {
            ops_mg.SMOOTH_ZERO: (12, 2), ops_mg.SMOOTH: (a + 16, 2 * nd[l] + 4),
            ops_mg.RESTRICT: (a + 8, 2 * nd[l] + 2), ops_mg.PROLONG: (8, 1),
            ops_mg.VPASS: (a + 16, 2 * nd[l] + 6), ops_mg.S1: (20, 4),
            ops_mg.WPASS: (a + 12, 2 * nd[l] + 6), ops_mg.COMB: (12, 3),
            ops_mg.COPY: (8, 0), ops_mg.RESTRICT_ZERO: (a + 12, 4 * nd[l] + 4),
            ops_mg.PROLONG_SMOOTH: (a + 16, 3 * nd[l] + 5)}[int(op)]
        coarse = (ops_mg.RESTRICT, ops_mg.PROLONG, ops_mg.RESTRICT_ZERO, ops_mg.PROLONG_SMOOTH)
        per_pass += rows_b * n[l] + (4 * n[l + 1] if op in coarse else 0)
        flops += rows_f * n[l]
    return hier, per_pass, flops


def time_path8(gt, dev, p8, rec, timing):
    """Times on path 8's 2048^2 hierarchies (12 levels), CUDA events.  K25
    per cycle by the slope of chained launches, beside the streaming cycle
    (one ``apply`` of the hierarchy without its dense inverse) and the
    plain version; K26 (CG + MG on A1) and K28 (BiCGSTAB + MG on A2) per
    iteration, K27 per cycle, each by the slope between whole solves of 20
    and 100 iterations (cycles), beside the plain versions (between 5 and
    25).  Bounds (NVIDIA's peak rates), each input read once and each output
    written once a launch, cycle or iteration: the hierarchy of
    ``mg_cycle_cost`` (A is its level 0) and the vectors of level 0 -- K25
    b and x, 8 n; K27 b, x0 and x, 12 n; K26 x, r, p and z read and
    written, 32 n, and K28 BiCGSTAB's 44 n, as K23 and K24 count them (r
    and z, p and y are the cycles' b and x).  Operations: the cycle's, for
    K26 2 nd_A + 12 a row more, for K28 a second cycle and 4 nd_A + 22,
    for K27 a residual, 2 nd_A + 3.  ``bound_ms_per_pass`` counts what
    every pass reads and writes, A's products and K28's two cycles too."""
    from ginkgo_tpu_torch import stop
    from ginkgo_tpu_torch.ops import mg as ops_mg

    out = {"card": timing["card"]}
    A1, b1, M1, M1s = p8["A1"], p8["b1"], p8["M1"], p8["M1s"]
    h1 = M1._fused_hierarchy()
    n = A1.shape[0]
    hier, per_pass, flops = mg_cycle_cost(h1, h1.passes[False][0])
    k_ms = slope_ms(lambda: ops_mg.mg_vcycle(h1, b1))
    p_ms = slope_ms(lambda: ops_mg.mg_vcycle_reference(h1, b1), 2, 7, 2)
    s_ms = slope_ms(lambda: M1s.apply(b1), 2, 7, 2)
    rec["mg_vcycle"] = (k_ms, p_ms, None, hier + 8 * n, flops)
    out["mg_vcycle"] = {"us": k_ms * 1e3, "plain_us": p_ms * 1e3, "streaming_us": s_ms * 1e3,
                        "barriers": ops_barriers(h1), "bytes": hier + 8 * n,
                        "bytes_per_pass": per_pass,
                        "bound_ms_per_pass": bound(per_pass, flops)[0]}
    z1 = torch.zeros_like(b1)
    nd1 = A1.num_diags
    A2, b2, M2 = p8["A2"], p8["b2"], p8["M2"]
    h2 = M2._fused_hierarchy()
    z2 = torch.zeros_like(b2)
    nd2 = A2.num_diags
    hier2, per_pass2, flops2 = mg_cycle_cost(h2, h2.passes[False][0])
    for kname, cls, A, M, h, b, z, nbytes, nflops, nbytes_pp in (
            ("mg_cg_fused", gt.Cg, A1, M1, h1, b1, z1, hier + 32 * n,
             flops + (2 * nd1 + 12) * n, per_pass + (4 * nd1 + 32) * n),
            ("mg_bicgstab_fused", gt.Bicgstab, A2, M2, h2, b2, z2, hier2 + 44 * n,
             2 * flops2 + (4 * nd2 + 22) * n, 2 * per_pass2 + (8 * nd2 + 44) * n)):
        solver = cls.build(criteria=[stop.Iteration(max_iters=1)], preconditioner=M).generate(A)

        def fused(its, solver=solver, b=b):
            solver.replace(criterion=stop.Iteration(max_iters=its)).solve(b)

        plain_fn = (ops_mg.mg_cg_solve_reference if kname == "mg_cg_fused"
                    else ops_mg.mg_bicgstab_solve_reference)

        def plain(its, A=A, h=h, b=b, z=z, fn=plain_fn):
            fn(A, h, b, z, tol_sq_eff=-1.0, max_iters=its)

        f_ms, pl_ms = iter_ms(fused, 20, 100), iter_ms(plain, *PLAIN_TRIPS)
        rec[kname] = (f_ms, pl_ms, None, nbytes, nflops)
        out[kname] = {"us_per_iteration": f_ms * 1e3, "plain_us": pl_ms * 1e3, "bytes": nbytes,
                      "bound_ms_per_pass": bound(nbytes_pp, nflops)[0],
                      "barriers_per_iteration": solver_barriers(kname, h)}

    def solve_fused(its):
        ops_mg.mg_solve_fused(h1, b1, z1, tol_sq_eff=-1.0, max_iters=its)

    def solve_plain(its):
        ops_mg.mg_solve_reference(h1, b1, z1, tol_sq_eff=-1.0, max_iters=its)

    _, per_pass_x0, flops_x0 = mg_cycle_cost(h1, h1.passes[True][0])
    nbytes = hier + 12 * n
    nflops = flops_x0 + (2 * nd1 + 3) * n
    f_ms, pl_ms = iter_ms(solve_fused, 20, 100), iter_ms(solve_plain, 5, 25)
    rec["mg_solve_fused"] = (f_ms, pl_ms, None, nbytes, nflops)
    out["mg_solve_fused"] = {"us_per_cycle": f_ms * 1e3, "plain_us": pl_ms * 1e3,
                             "bytes": nbytes, "barriers_per_cycle":
                             ops_mg.barriers(h1.passes[True][0]) + 1,
                             "bound_ms_per_pass": bound(per_pass_x0 + (4 * nd1 + 8) * n,
                                                        nflops)[0]}
    timing["slice8"] = out


# -- path 9: the streaming formats, SpGEMM and SpGEAM ------------------------------------

#: the kernels path 9 runs whatever the route picks; the WELL kernels join
#: them where the power-law Hybrid's plan is a WELL
PATH9 = ("pell_spmv", "pell_spmm")
#: path 9's small formats: the 7-point Poisson matrix on a 64^3 grid
SMALL9 = 64
#: SpGEMM: the 2-D Poisson matrix on a 512^2 grid, and the power-law
#: Laplacian at 2^14 rows (path 9 prints the products its square at path
#: 3a's rows would form, a bound of that square's nonzeros, which is
#: left out); SpGEAM at path 3a's rows
SPGEMM_GRID = 512
SPGEMM_POWERLAW = 1 << 14
#: a pattern the route declines: 2^17 rows of two entries at random columns
#: of 2^24 (no plan passes both the inflation gate and the 256 MiB one)
DECLINE_SHAPE = (1 << 17, 1 << 24)


@contextlib.contextmanager
def no_route():
    """The formats' own products: the streaming route declines every
    apply while this is active (the JAX package's products off a TPU)."""
    from ginkgo_tpu_torch.ops import spmv as spmv_ops

    saved = spmv_ops.try_streaming
    spmv_ops.try_streaming = lambda op, arr: None
    try:
        yield
    finally:
        spmv_ops.try_streaming = saved


def product_bound(lib64, abs64, row_nnz, v):
    """The float64 product of a CSR with v, and the float32 error bound of
    any summation order of its rows: 2 * nnz(row) * eps32 * (|A| |v|)."""
    v = v.double()
    v2 = v if v.dim() == 2 else v[:, None]
    want = lib64 @ v2
    slack = 2 * row_nnz[:, None] * EPS32 * (abs64 @ v2.abs())
    return (want, slack) if v.dim() == 2 else (want[:, 0], slack[:, 0])


def csr64(C, dtype=None):
    """torch.sparse CSR tensors of C's values (as ``dtype`` stores them) and
    their absolute values in float64, and C's row lengths: a check only."""
    vals = (C.values if dtype is None else C.values.to(dtype)).double()
    lib = torch.sparse_csr_tensor(C.row_ptrs, C.col_idxs, vals, size=C.shape)
    absl = torch.sparse_csr_tensor(C.row_ptrs, C.col_idxs, vals.abs(), size=C.shape)
    return lib, absl, C.row_ptrs.diff().double()


def check_product(label, got, want, slack):
    err = (got.double() - want).abs()
    check(bool(torch.isfinite(got).all()) and bool((err <= slack).all()),
          f"{label}: differs from the float64 product by {float(err.max())}")
    return float(err.max())


def main_path9(gt, dev, rng, crit, data3, C3, x64_3, norm3, p3):
    """Main path 9 through the entry points a user calls; every check
    raises.  Returns the kind of plan ("Pell" or "Well") the route took for
    the power-law Hybrid, and the plans of the 160^3 Coo and the Hybrid."""
    from ginkgo_tpu_torch import stop
    from ginkgo_tpu_torch.ops import pell as ops_pell
    from ginkgo_tpu_torch.ops import spmv as spmv_ops
    from ginkgo_tpu_torch.ops import well as ops_well

    declines = ops_pell.linop_streaming_spmv.declines

    # 9a: the 160^3 Poisson matrix handed over as a Coo, K5 through the route
    n3 = data3.shape[0]
    t0 = time.perf_counter()
    Co = gt.Coo.from_matrix_data(data3, device=dev)
    _sync(dev)
    coo_s = time.perf_counter() - t0
    x = torch.as_tensor(rng.standard_normal(n3).astype(np.float32), device=dev)
    X = torch.as_tensor(rng.standard_normal((n3, 4)).astype(np.float32), device=dev)
    builds = ops_pell.streaming_plan.builds
    t0 = time.perf_counter()
    y = Co.apply(x)
    _sync(dev)
    first_s = time.perf_counter() - t0
    P = ops_pell.streaming_plan(Co)
    check(isinstance(P, gt.Pell), f"path 9: the 160^3 Coo's plan is a {type(P).__name__}")
    # the Csr "pallas" apply of the same pattern: the same PELL plan (path 2
    # built it into the plan cache), the same kernel, the same bits
    Cp = C3.with_strategy("pallas")
    csr_builds = ops_pell.plan_for.builds
    check(bit_equal(y, Cp.apply(x)), "path 9: the Coo apply differs from the Csr 'pallas' apply")
    lib, absl, row_nnz = csr64(C3)
    want, slack = product_bound(lib, absl, row_nnz, x)
    err1 = check_product("path 9: the Coo apply", y, want, slack)
    b3 = torch.ones(n3, device=dev)
    k5 = ops_pell.pell_spmv.launches
    t0 = time.perf_counter()
    xs, info = gt.Cg.build(criteria=crit).generate(Co).solve(b3)
    _sync(dev)
    solve_s = time.perf_counter() - t0
    k5 = ops_pell.pell_spmv.launches - k5
    check(bool(info.converged.all()), "path 9: Cg on the Coo: not converged")
    check(k5 >= info.num_iterations, f"path 9: Cg on the Coo ran pell_spmv {k5} times")
    acc = accuracy(Co, xs, b3, x64_3, norm3, "path 9: Cg on the Coo")
    k6 = ops_pell.pell_spmm.launches
    Y = Co.apply(X)
    check(ops_pell.pell_spmm.launches == k6 + 1, "path 9: the 4-column Coo apply did not run pell_spmm")
    check(bit_equal(Y, Cp.apply(X)), "path 9: the 4-column Coo apply differs from the Csr's")
    want, slack = product_bound(lib, absl, row_nnz, X)
    err4 = check_product("path 9: the 4-column Coo apply", Y, want, slack)
    coo_builds = ops_pell.streaming_plan.builds - builds
    check(coo_builds == 1, "path 9: the Coo's applies and its Cg did not build one plan")
    csr_builds = ops_pell.plan_for.builds - csr_builds
    lib32 = library_csr(C3)

    def route1():
        return Co.apply(x)

    def csr1():
        return Cp.apply(x)

    # K5 through the route beside K5 through the Csr "pallas" apply, on
    # plans of the same arrays, each by CUDA graph in the order route, Csr,
    # Csr, route: the applies, then K5 alone on each plan (the kernel's own
    # time, no wrapper), so that a gap shows whether it follows the timing
    # order or the route's copy of the plan; the SM clock after each
    Pc = ops_pell.plan_for(C3.row_ptrs, C3.col_idxs, C3.values, C3.shape)
    order = {"applies": (route1, csr1), "k5": (lambda: ops_pell.pell_spmv(P, x),
                                               lambda: ops_pell.pell_spmv(Pc, x))}
    order_us, clocks = {}, []
    for what, (r, c) in order.items():
        order_us[what] = []
        for f in (r, c, c, r):
            order_us[what].append(graph_ms(f) * 1e3)
            clocks.append(sm_clock_mhz())
    coo_us = {
        "route_us": order_us["applies"][0], "csr_pallas_us": order_us["applies"][1],
        "graph_us_route_csr_csr_route": order_us, "sm_clock_mhz_after_each": clocks,
        "plan_offsets_in_2MiB": {
            name: [t.data_ptr() % (1 << 21) for t in (A.values, A.qidx, A.bases)]
            for name, A in (("route", P), ("csr", Pc))},
        "torch_sparse_us": slope_ms(lambda: torch.mv(lib32, x), 5, 25) * 1e3,
        "route_k4_us": graph_ms(lambda: Co.apply(X)) * 1e3,
        "csr_pallas_k4_us": graph_ms(lambda: Cp.apply(X)) * 1e3,
        "torch_sparse_k4_us": slope_ms(lambda: torch.sparse.mm(lib32, X), 5, 25) * 1e3,
        "route_host_us_per_call": host_us(route1, 50),
        "csr_host_us_per_call": host_us(csr1, 50)}
    del Pc
    # bfloat16 values on the same pattern: the route and the Csr plan them
    # at 2 bytes a value, each apply bit for bit with the Csr "pallas" apply
    Co16 = Co.astype(torch.bfloat16)
    Cp16 = C3.astype(torch.bfloat16).with_strategy("pallas")
    builds, csr16_builds = ops_pell.streaming_plan.builds, ops_pell.plan_for.builds
    t0 = time.perf_counter()
    y16 = Co16.apply(x)
    _sync(dev)
    first16_s = time.perf_counter() - t0
    P16 = ops_pell.streaming_plan(Co16)
    check(isinstance(P16, gt.Pell) and P16.values.dtype == torch.bfloat16,
          "path 9: the bfloat16 Coo's plan is no bfloat16 Pell")
    check(bit_equal(y16, Cp16.apply(x)),
          "path 9: the bfloat16 Coo apply differs from the Csr 'pallas' apply")
    k6 = ops_pell.pell_spmm.launches
    Y16 = Co16.apply(X)
    check(ops_pell.pell_spmm.launches == k6 + 1,
          "path 9: the 4-column bfloat16 Coo apply did not run pell_spmm")
    check(bit_equal(Y16, Cp16.apply(X)),
          "path 9: the 4-column bfloat16 Coo apply differs from the Csr's")
    check(ops_pell.streaming_plan.builds == builds + 1,
          "path 9: the bfloat16 Coo's applies did not build one plan")
    csr16_builds = ops_pell.plan_for.builds - csr16_builds
    lib, absl, row_nnz = csr64(C3, torch.bfloat16)
    want, slack = product_bound(lib, absl, row_nnz, x)
    err16 = check_product("path 9: the bfloat16 Coo apply", y16, want, slack)
    want, slack = product_bound(lib, absl, row_nnz, X)
    err16_4 = check_product("path 9: the 4-column bfloat16 Coo apply", Y16, want, slack)
    P16_8 = ops_pell._streaming_spmm_plan(Co16, P16)
    emit({"phase": "main_path", "path": 9, "case": "coo_160", "rows": n3, "nnz": Co.nnz,
          "coo_s": round(coo_s, 3), "first_apply_s_with_plan_build": round(first_s, 3),
          "plan": "Pell", "S": P.S, "G": P.G, "inflation": P.inflation,
          "csr_plan_builds": {"f32": csr_builds, "bf16": csr16_builds},
          "max_abs_err_vs_f64": {"k1": err1, "k4": err4, "bf16_k1": err16, "bf16_k4": err16_4},
          "bf16_first_apply_s_with_plan_build": round(first16_s, 3),
          "bf16_plan": {"S": P16.S, "G": P16.G, "k4_S": P16_8.S},
          "cg_iterations": info.num_iterations, "cg_solve_s": round(solve_s, 4),
          "pell_spmv_launches": k5, "plan_builds": coo_builds,
          **acc, **coo_us})
    plans = {"160^3 Coo": P, "160^3 Coo, S = 8": ops_pell._streaming_spmm_plan(Co, P),
             "160^3 bfloat16 Coo": P16, "160^3 bfloat16 Coo, S = 8": P16_8}
    del lib, absl, lib32, Y, Y16, Co16, Cp16

    # 9b: path 3a's power-law Laplacian handed over as a Hybrid
    Cpl, bpl = p3["C"], p3["b"]
    n = Cpl.shape[0]
    t0 = time.perf_counter()
    H = gt.Hybrid.from_csr(Cpl)
    _sync(dev)
    hyb_s = time.perf_counter() - t0
    builds = ops_pell.streaming_plan.builds
    t0 = time.perf_counter()
    Hp = ops_pell.streaming_plan(H)
    plan_s = time.perf_counter() - t0
    check(Hp is not None, "path 9: the route declined the power-law Hybrid")
    kind = type(Hp).__name__
    spmv_k, spmm_k = ((ops_well.well_spmv, ops_well.well_spmm) if kind == "Well"
                      else (ops_pell.pell_spmv, ops_pell.pell_spmm))
    W64 = p3["W"].astype(torch.float64)
    x64, info64 = gt.Cg.build(criteria=[stop.Iteration(max_iters=MAX_ITERS),
                                        stop.ResidualNorm(tolerance=1e-10)]
                              ).generate(W64).solve(bpl.double())
    check(bool(info64.converged.all()), "path 9: float64 reference solve: not converged")
    del W64
    k = spmv_k.launches
    t0 = time.perf_counter()
    xh, info = gt.Cg.build(criteria=crit).generate(H).solve(bpl)
    _sync(dev)
    solve_s = time.perf_counter() - t0
    k = spmv_k.launches - k
    check(bool(info.converged.all()), "path 9: Cg on the Hybrid: not converged")
    check(k >= info.num_iterations, f"path 9: Cg on the Hybrid ran {spmv_k.__name__} {k} times "
          f"for its {kind} plan")
    acc = accuracy(H, xh, bpl, x64, inf_norm(p3["data"]), "path 9: Cg on the Hybrid")
    Xh = torch.as_tensor(rng.standard_normal((n, 4)).astype(np.float32), device=dev)
    k4 = spmm_k.launches
    Yh = H.apply(Xh)
    check(spmm_k.launches == k4 + 1, f"path 9: the 4-column Hybrid apply did not run {spmm_k.__name__}")
    lib, absl, row_nnz = csr64(Cpl)
    want, slack = product_bound(lib, absl, row_nnz, Xh)
    errh = check_product("path 9: the 4-column Hybrid apply", Yh, want, slack)
    check(ops_pell.streaming_plan.builds == builds + 1,
          "path 9: the Hybrid's applies and its Cg did not build one plan")
    xr = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=dev)
    lib32 = library_csr(Cpl)
    Cplp = Cpl.with_strategy("pallas")
    hybrid_us = {
        "route_us": graph_ms(lambda: H.apply(xr)) * 1e3,
        "csr_pallas_us": graph_ms(lambda: Cplp.apply(xr)) * 1e3,
        "torch_sparse_us": slope_ms(lambda: torch.mv(lib32, xr), 5, 25) * 1e3,
        "route_k4_us": graph_ms(lambda: H.apply(Xh)) * 1e3,
        "torch_sparse_k4_us": slope_ms(lambda: torch.sparse.mm(lib32, Xh), 5, 25) * 1e3}
    emit({"phase": "main_path", "path": 9, "case": "hybrid_powerlaw", "rows": n,
          "nnz": H.nnz, "ell_width": H.ell.max_nnz_per_row, "coo_tail": H.coo.nnz,
          "hybrid_s": round(hyb_s, 3), "plan_s": round(plan_s, 3), "plan": kind,
          "T": getattr(Hp, "T", None), "S": getattr(Hp, "S", None), "G": Hp.G,
          "inflation": Hp.inflation, "cg_iterations": info.num_iterations,
          "cg_solve_s": round(solve_s, 4), f"{spmv_k.__name__}_launches": k,
          "k4_max_abs_err_vs_f64": errh, **acc, **hybrid_us})
    plans[f"powerlaw_laplacian({n}) Hybrid"] = Hp
    del H, Yh, lib, absl, lib32

    # 9c: the small formats at 64^3 against their own products, Cg where SPD
    data64 = gt.generators.poisson_3d(SMALL9, dtype=np.float32)
    C64 = gt.Csr.from_matrix_data(data64, device=dev)
    n64 = C64.shape[0]
    b64 = torch.ones(n64, device=dev)
    x64_64, _ = gt.Cg.build(criteria=[stop.Iteration(max_iters=MAX_ITERS),
                                      stop.ResidualNorm(tolerance=1e-10)]
                            ).generate(C64.astype(torch.float64).with_strategy("classical")
                                       ).solve(b64.double())
    # path 3b's block-structured pattern at 1/64 of its row blocks
    Cb = gt.Csr.from_matrix_data(gt.MatrixData.from_coo(
        *block_structured(BELL_BLOCKS[0] // 64, *BELL_BLOCKS[1:])).sum_duplicates(), device=dev)
    formats = {
        # label: (the format, the Csr of its values, SPD)
        "ell": (lambda: gt.Ell.from_csr(C64), C64, True),
        "sellp": (lambda: gt.Sellp.from_csr(C64), C64, True),
        "sparsity_csr": (lambda: C64.to_sparsity_csr(), C64, False),
        "fbcsr2": (lambda: gt.Fbcsr.from_csr(C64, 2), C64, True),
        "fbcsr4_block_structured": (lambda: gt.Fbcsr.from_csr(Cb, 4), Cb, False),
        "csr_sellp": (lambda: C64.with_strategy("sellp"), C64, True),
        "coo_bf16": (lambda: C64.to_coo().astype(torch.bfloat16),
                     C64.astype(torch.bfloat16), True),
    }
    for label, (make, Cref, spd) in formats.items():
        t0 = time.perf_counter()
        A = make()
        _sync(dev)
        make_s = time.perf_counter() - t0
        m = A.shape[1]
        xa = torch.as_tensor(rng.standard_normal((m, 4)).astype(np.float32), device=dev)
        builds, dec = ops_pell.streaming_plan.builds, ops_pell.linop_streaming_spmv.declines
        t0 = time.perf_counter()
        ya = A.apply(xa)
        _sync(dev)
        first_s = time.perf_counter() - t0
        with no_route():
            own = A.apply(xa)
        check(ops_pell.linop_streaming_spmv.declines == dec,
              f"path 9: the route declined the {label}")
        check(torch.allclose(ya, own, rtol=1e-5, atol=1e-5 * float(own.abs().max())),
              f"path 9: the {label}'s route and own products differ")
        if label == "sparsity_csr":
            Cref = Cref.replace(values=torch.ones_like(Cref.values))
        lib, absl, row_nnz = csr64(Cref)
        want, slack = product_bound(lib, absl, row_nnz, xa)
        err = check_product(f"path 9: the {label} apply", ya, want, slack)
        row = {"phase": "main_path", "path": 9, "case": label, "shape": list(A.shape),
               "make_s": round(make_s, 3), "first_apply_s_with_plan_build": round(first_s, 3),
               "plan": type(ops_pell.streaming_plan(
                   A._sellp() if label == "csr_sellp" else A)).__name__,
               "max_abs_err_vs_f64": err}
        if spd:
            t0 = time.perf_counter()
            xs, info = gt.Cg.build(criteria=crit).generate(A).solve(b64)
            _sync(dev)
            check(bool(info.converged.all()), f"path 9: Cg on the {label}: not converged")
            row.update(cg_iterations=info.num_iterations,
                       cg_solve_s=round(time.perf_counter() - t0, 4),
                       **accuracy(A, xs, b64, x64_64[:, 0] if x64_64.dim() == 2 else x64_64,
                                  inf_norm(data64), f"path 9: Cg on the {label}"))
        row["plan_builds"] = ops_pell.streaming_plan.builds - builds
        check(row["plan_builds"] == 1, f"path 9: the {label} built {row['plan_builds']} plans")
        emit(row)
    # a pattern the route declines: its own product (coo_spmv), no kernel
    gen = np.random.default_rng(SEED + 9)
    nd, md = DECLINE_SHAPE
    Cd = gt.Coo.from_matrix_data(gt.MatrixData.from_coo(
        (nd, md), np.repeat(np.arange(nd), 2), np.sort(gen.integers(0, md, (nd, 2))).ravel(),
        gen.standard_normal(2 * nd).astype(np.float32)).sum_duplicates(), device=dev)
    xd = torch.as_tensor(gen.standard_normal(md).astype(np.float32), device=dev)
    dec = ops_pell.linop_streaming_spmv.declines
    before = [f.launches for f in (ops_pell.pell_spmv, ops_well.well_spmv)]
    t0 = time.perf_counter()
    yd = Cd.apply(xd)
    _sync(dev)
    decline_s = time.perf_counter() - t0
    check(ops_pell.linop_streaming_spmv.declines == dec + 1, "path 9: the route did not decline")
    check([f.launches for f in (ops_pell.pell_spmv, ops_well.well_spmv)] == before,
          "path 9: a declined apply launched a kernel")
    want = spmv_ops.coo_spmv(Cd.rows, Cd.cols, Cd.values.double(), xd.double(), nd)
    slack = 4 * EPS32 * spmv_ops.coo_spmv(Cd.rows, Cd.cols, Cd.values.double().abs(),
                                          xd.double().abs(), nd)
    check_product("path 9: the declined Coo's own product", yd, want, slack)
    emit({"phase": "main_path", "path": 9, "case": "declined_scatter", "shape": [nd, md],
          "route": "coo_spmv", "declines": ops_pell.linop_streaming_spmv.declines - declines,
          "apply_s_with_plan_choice": round(decline_s, 3)})
    del Cd, xd, yd, C64

    # 9d: SpGEMM and SpGEAM against scipy, each twice for the same bits
    import scipy.sparse as sps

    def sp_of(C):
        host = gt.types.to_host
        m = sps.csr_matrix((host(C.values).astype(np.float64), host(C.col_idxs),
                            host(C.row_ptrs)), shape=C.shape)
        m.sort_indices()
        return m

    def spgemm_check(label, run, want, **extra):
        t0 = time.perf_counter()
        got = run()
        _sync(dev)
        first_s = time.perf_counter() - t0
        again = run()
        _sync(dev)
        check(bit_equal(got.values, again.values), f"path 9: {label}: two calls gave other bits")
        g = sp_of(got)
        w = want.tocsr()
        w.sort_indices()
        check(np.array_equal(g.indptr, w.indptr) and np.array_equal(g.indices, w.indices),
              f"path 9: {label}: the pattern differs from scipy's")
        err = np.abs(g.data - w.data)
        check(bool((err <= 1e-5 * (1 + np.abs(w.data))).all()),
              f"path 9: {label}: values differ from the float64 product by {err.max()}")
        emit({"phase": "main_path", "path": 9, "case": label, "shape": list(got.shape),
              "nnz": got.nnz, "first_s": round(first_s, 3), "max_abs_err_vs_f64": float(err.max()),
              "repeat_bit_equal": True, **extra})

    A2d = gt.Csr.from_matrix_data(gt.generators.poisson_2d(SPGEMM_GRID, dtype=np.float32),
                                  device=dev)
    Apl = gt.Csr.from_matrix_data(gt.MatrixData.from_coo(*powerlaw_laplacian(SPGEMM_POWERLAW)
                                                         ).sum_duplicates(), device=dev)
    def products(A):
        # the products A A forms before they are summed: per inner index k,
        # column k's entries times row k's (a bound of A A's nonzeros)
        cols = torch.bincount(A.col_idxs.to(torch.int64), minlength=A.shape[0])
        return int((cols * A.row_ptrs.diff().to(torch.int64)).sum())

    for name, A in ((f"poisson_2d({SPGEMM_GRID})", A2d),
                    (f"powerlaw_laplacian({SPGEMM_POWERLAW})", Apl)):
        s = sp_of(A)
        spgemm_check(f"spgemm {name}", lambda: A.apply(A), s @ s, products=products(A))
    # path 3a's matrix squared is left out: the products it would form
    emit({"phase": "main_path", "path": 9, "case": f"spgemm powerlaw_laplacian({n}) left out",
          "nnz": Cpl.nnz, "products": products(Cpl)})
    for name, A in ((f"poisson_2d({SPGEMM_GRID})", A2d), (f"powerlaw_laplacian({n})", Cpl)):
        s = sp_of(A)
        spgemm_check(f"spgeam {name}", lambda: A.spgeam(1.0, A.transpose(), 1.0), s + s.T)
    return {"hybrid_plan": kind, "plans": plans}


def check_path9_kernels(gt, dev, rng, p9, record_err):
    """K5/K6 or K8/K9 against their plain versions on the plans path 9's
    route built (the 160^3 Coo's S = "auto" plan and its S = 8 sibling, of
    float32 and of bfloat16 values, and the power-law Hybrid's), each
    called twice: the same bits twice; K5, K8 and K9 the plain version's
    bits, K6 within 1e-5 of it (the bound the other K6 checks hold: its
    plain version sums a slot's rows in another order)."""
    from ginkgo_tpu_torch.ops import pell as ops_pell
    from ginkgo_tpu_torch.ops import well as ops_well

    for label, A in p9["plans"].items():
        x = torch.as_tensor(rng.standard_normal(A.shape[1]).astype(np.float32), device=dev)
        X = torch.as_tensor(rng.standard_normal((A.shape[1], 4)).astype(np.float32), device=dev)
        mod = ops_well if isinstance(A, gt.Well) else ops_pell
        kind = "well" if mod is ops_well else "pell"
        row = {"phase": "kernel_check", "path": 9, "matrix": label, "plan": type(A).__name__,
               "values": str(A.values.dtype)}
        for name, v in ((f"{kind}_spmv", x), (f"{kind}_spmm", X)):
            kern, plain = getattr(mod, name), getattr(mod, name + "_reference")
            got, again = kern(A, v), kern(A, v)
            want = plain(A, v)
            _sync(dev)
            err = record_err(name, got, want)
            check(bit_equal(got, again), f"path 9: {name} on {label}: two calls gave other bits")
            same = bit_equal(got, want) if name != "pell_spmm" else torch.allclose(
                got, want, rtol=1e-5, atol=1e-5)
            check(same, f"path 9: {name} differs from its plain version on {label}: {err}")
            row[name + "_max_abs_err"] = err
        emit(row)


#: path 10: the direct solve's grid (262,144 rows; nested dissection keeps
#: nnz(L) near 10.1M), the reordered LU's grid, the block Jacobi's block
#: size (the JAX bench's solver row), the chunked solve's chunk and time
#: limit, and ScaledReordered's convection-diffusion grid
DIRECT_GRID = 512
LU_GRID = 64
JACOBI_BLOCK = 8
CHUNK10 = 500
TIME10 = 0.2
SR_GRID = 256
#: the kernels path 10 must launch: the block Jacobi solves stream through
#: K1, the logged one-shot solve takes K4
PATH10 = ("dia_spmv", "cg_fused")


class _Stamps:
    """A logger that notes the host clock at each ``iteration_complete``."""

    def __init__(self, log):
        self.enabled_events = {log.Event.iteration_complete}
        self.at = []

    def on(self, event, **data):
        self.at.append((time.perf_counter(), data["iteration"]))


def main_path10(gt, dev, rng, crit, kernels, data1, x64_ones, p4, stream1):
    """Main path 10 (slice 10) through the entry points a user calls; every
    check raises.  (a) ``poisson_2d(DIRECT_GRID)`` in float64 as a ``Csr``
    -> ``Cholesky`` with the ``NestedDissection`` ordering (the native
    route, asserted) -> ``Direct``, against a scipy float64 solve; ``Lu``
    with the RCM ordering -> ``Direct`` at ``LU_GRID``^2.  (b) A1 -> ``Cg``
    and A2 -> ``Gmres(30)`` with ``Jacobi(max_block_size=8)``, float32 and
    bfloat16 block storage, beside scalar Jacobi: the streaming route (K1,
    no whole-solve kernel).  (c) ``solve_chunked`` on A1 (the one-shot
    streaming solve's iterations and x; a ``Time`` limit), ``solve(loggers=
    [Record()])`` on K4 with a global ``Counters``, ``ProfilerRange`` under
    ``torch.profiler``.  (d) ``convdiff_2d(SR_GRID)`` under a seeded
    symmetric permutation -> ``ScaledReordered(Gmres(30) + Ilu,
    reordering=Rcm)``, against a scipy float64 solve."""
    import scipy.sparse.linalg as spla

    from ginkgo_tpu_torch import _native, log, reorder, stop
    from ginkgo_tpu_torch.factorization import Cholesky, Lu
    from ginkgo_tpu_torch.solver import Direct

    # -- (a) the direct solvers -------------------------------------------------
    t0 = time.perf_counter()
    lib_was_built = _native.is_built()
    check(_native.load() is not None, "path 10: no C++ compiler for native/cholesky.cpp")
    native_s = time.perf_counter() - t0
    data = gt.generators.poisson_2d(DIRECT_GRID, dtype=np.float64)
    C = gt.Csr.from_matrix_data(data, device=dev)
    n = C.shape[0]
    t0 = time.perf_counter()
    perm = reorder.NestedDissection.build().generate(C)
    order_s = time.perf_counter() - t0
    native_before = Cholesky.routes["native"]
    t0 = time.perf_counter()
    fact = Cholesky(reorder=perm).generate(C)
    _sync(dev)
    factor_s = time.perf_counter() - t0
    check(Cholesky.routes["native"] == native_before + 1, "path 10: Cholesky left the native route")
    check(fact.l_factor.values.device == dev, "path 10: the factor is not on the card")
    t0 = time.perf_counter()
    direct = Direct.build().generate(fact)
    _sync(dev)
    trs_s = time.perf_counter() - t0
    b = torch.as_tensor(rng.standard_normal(n), device=dev)
    t0 = time.perf_counter()
    x, info = direct.solve(b)
    _sync(dev)
    solve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = spla.spsolve(C.to_scipy().tocsc(), b.cpu().numpy())
    ref_s = time.perf_counter() - t0
    err = float(np.linalg.norm(x.cpu().numpy() - ref) / np.linalg.norm(ref))
    check(x.device == dev and bool(torch.isfinite(x).all()), "path 10: Direct x is not finite")
    check(err <= 1e-10, f"path 10: Cholesky + Direct relative error {err}")
    emit({"phase": "main_path", "path": 10, "case": "cholesky_nd_direct",
          "matrix": f"poisson_2d({DIRECT_GRID})", "rows": n, "nnz": data.nnz,
          "nnz_L": fact.l_factor.nnz, "native_library_was_built": lib_was_built,
          "native_load_s": round(native_s, 3), "ordering_s": round(order_s, 3),
          "factor_s": round(factor_s, 3), "triangular_build_s": round(trs_s, 3),
          "solve_s": round(solve_s, 4), "scipy_solve_s": round(ref_s, 3),
          "rel_error_vs_scipy": err, "routes": dict(Cholesky.routes)})
    del fact, direct, C, x, perm

    data = gt.generators.poisson_2d(LU_GRID, dtype=np.float64)
    C = gt.Csr.from_matrix_data(data, device=dev)
    t0 = time.perf_counter()
    direct = Direct.build(factorization=Lu(reorder="rcm")).generate(C)
    gen_s = time.perf_counter() - t0
    b = torch.as_tensor(rng.standard_normal(C.shape[0]), device=dev)
    x, _ = direct.solve(b)
    ref = spla.spsolve(C.to_scipy().tocsc(), b.cpu().numpy())
    err = float(np.linalg.norm(x.cpu().numpy() - ref) / np.linalg.norm(ref))
    check(err <= 1e-10, f"path 10: Lu(rcm) + Direct relative error {err}")
    check(direct.col_perm is not None, "path 10: Lu(rcm) carries no permutation")
    emit({"phase": "main_path", "path": 10, "case": "lu_rcm_direct",
          "matrix": f"poisson_2d({LU_GRID})", "generate_s": round(gen_s, 3),
          "rel_error_vs_scipy": err})
    stamp("path 10a: Cholesky and LU with reorderings")

    # -- (b) block Jacobi ---------------------------------------------------------
    from ginkgo_tpu_torch.base.types import precision_reduction

    runs = (("A1", gt.Cg, {}, p4["A1"], p4["b1"], x64_ones, inf_norm(data1), "cg_fused"),
            ("A2", gt.Gmres, {"krylov_dim": KRYLOV_DIM}, p4["A"], p4["b"], p4["refs"]["f32"],
             p4["norm_a"], "gmres_fused"))
    for label, cls, params, A, rhs, x_ref, norm_a, fused_name in runs:
        solver = cls.build(criteria=crit, preconditioner=gt.Jacobi.build(), **params).generate(A)
        x, info = solver.solve(rhs)
        scalar_iters = info.num_iterations
        for storage, so in (("f32", None), ("bf16", precision_reduction(0, 1))):
            t0 = time.perf_counter()
            M = gt.Jacobi.build(max_block_size=JACOBI_BLOCK, storage_optimization=so).generate(A)
            _sync(dev)
            gen_s = time.perf_counter() - t0
            want = torch.float32 if storage == "f32" else torch.bfloat16
            check(M.inv_blocks.dtype == want and M.inv_blocks.device == dev,
                  f"path 10: block Jacobi {label} {storage}: blocks {M.inv_blocks.dtype} on "
                  f"{M.inv_blocks.device}")
            check(M.apply(rhs).device == dev, "path 10: the block apply left the card")
            solver = cls.build(criteria=crit, preconditioner=M, **params).generate(A)
            k1, fused = kernels["dia_spmv"].launches, kernels[fused_name].launches
            t0 = time.perf_counter()
            x, info = solver.solve(rhs)
            _sync(dev)
            solve_s = time.perf_counter() - t0
            what = f"path 10: {cls.__name__} + block Jacobi on {label} ({storage})"
            check(kernels[fused_name].launches == fused, f"{what} ran {fused_name}")
            check(kernels["dia_spmv"].launches - k1 >= info.num_iterations,
                  f"{what} did not stream through dia_spmv")
            check(bool(info.converged.all()), f"{what}: not converged")
            emit({"phase": "main_path", "path": 10, "case": f"block_jacobi_{storage}",
                  "matrix": label, "solver": cls.__name__, "blocks": M.num_blocks,
                  "iterations": info.num_iterations, "scalar_jacobi_iterations": scalar_iters,
                  "generate_s": round(gen_s, 3), "solve_s": round(solve_s, 4),
                  **accuracy(A, x, rhs, x_ref, norm_a, what)})
            del M, solver
    stamp("path 10b: block Jacobi")

    # -- (c) solve_chunked, loggers, profiler ranges -----------------------------------
    A1, b1 = p4["A1"], p4["b1"]
    solver = gt.Cg.build(criteria=crit).generate(A1)
    k4 = kernels["cg_fused"].launches
    t0 = time.perf_counter()
    xc, cinfo = solver.solve_chunked(b1, chunk=CHUNK10)
    _sync(dev)
    chunked_s = time.perf_counter() - t0
    check(kernels["cg_fused"].launches == k4, "path 10: solve_chunked ran cg_fused")
    check(cinfo.num_iterations == stream1["iterations"],
          f"path 10: solve_chunked took {cinfo.num_iterations} iterations, the one-shot "
          f"streaming solve {stream1['iterations']}")
    rel = float((xc - stream1["x"]).norm() / stream1["x"].norm())
    check(rel <= 1e-6, f"path 10: solve_chunked x differs by {rel} relative")
    timed = gt.Cg.build(criteria=crit + [stop.Time(time_limit_sec=TIME10)]).generate(A1)
    stamps = _Stamps(log)
    t0 = time.perf_counter()
    _, tinfo = timed.solve_chunked(b1, chunk=CHUNK10, loggers=[stamps])
    wall = time.perf_counter() - t0
    ends = [t - t0 for t, _ in stamps.at]
    # it stops at the first chunk boundary past the limit
    check(not bool(tinfo.converged.all()) and ends[-1] > TIME10
          and (len(ends) == 1 or ends[-2] <= TIME10),
          f"path 10: Time({TIME10}) stopped at {ends}")
    emit({"phase": "main_path", "path": 10, "case": "solve_chunked", "chunk": CHUNK10,
          "iterations": cinfo.num_iterations, "streaming_iterations": stream1["iterations"],
          "x_rel_diff": rel, "solve_s": round(chunked_s, 4),
          "time_limit_s": TIME10, "time_iterations": tinfo.num_iterations,
          "time_chunk_ends_s": [round(e, 4) for e in ends], "time_wall_s": round(wall, 4)})

    rec, counters = log.Record(), log.add_global_logger(log.Counters())
    try:
        x, info = solver.solve(b1, loggers=[rec])
        _sync(dev)
    finally:
        log.remove_global_logger(counters)
    kinds = [e.value for e, _ in rec.history]
    check(kinds == ["linop_apply_started", "iteration_complete", "linop_apply_completed"],
          f"path 10: the fused solve's events {kinds}")
    check(rec.history[1][1]["iteration"] == info.num_iterations and bool(info.converged.all()),
          "path 10: the replayed iteration_complete")
    check(counters.kernel_counts["cg_fused"] == 1 and counters.counts["operation_launched"] >= 1,
          f"path 10: Counters saw {dict(counters.kernel_counts)}")
    emit({"phase": "main_path", "path": 10, "case": "loggers_fused", "events": kinds,
          "iterations": info.num_iterations, "kernel_counts": dict(counters.kernel_counts),
          "counts": dict(counters.counts)})

    short = gt.Cg.build(criteria=[stop.Iteration(max_iters=20)]).generate(A1)
    ranges = log.ProfilerRange(device=dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        log.add_global_logger(ranges)
        try:
            with log.profile_region("path10_chunked", device=dev):
                short.solve_chunked(b1, chunk=10)
            _sync(dev)
        finally:
            log.remove_global_logger(ranges)
            ranges.close()
    names = sorted({e.key for e in prof.key_averages()} & {
        "path10_chunked", "dia_spmv", "iteration_10", "iteration_20", "criterion_check"})
    check(len(names) == 5, f"path 10: profiler ranges {names}")
    emit({"phase": "main_path", "path": 10, "case": "profiler_ranges", "ranges": names})
    stamp("path 10c: solve_chunked, loggers, profiler ranges")

    # -- (d) ScaledReordered ------------------------------------------------------------
    shape, r, c, v = convdiff_2d(SR_GRID)
    scramble = np.random.default_rng(SEED + 10).permutation(shape[0])
    inv = np.empty_like(scramble)
    inv[scramble] = np.arange(shape[0])
    data = gt.MatrixData.from_coo(shape, inv[r], inv[c], v)
    C = gt.Csr.from_matrix_data(data, device=dev)
    t0 = time.perf_counter()
    p = reorder.rcm_permutation(C)
    rcm_s = time.perf_counter() - t0
    bw = (reorder.bandwidth(C), reorder.bandwidth(C.symm_permute(p)))
    t0 = time.perf_counter()
    S = reorder.ScaledReorderedFactory(
        gt.Gmres.build(criteria=crit, krylov_dim=KRYLOV_DIM,
                       preconditioner=gt.preconditioner.Ilu.build()),
        reordering=reorder.Rcm.build()).generate(C)
    _sync(dev)
    gen_s = time.perf_counter() - t0
    check(np.array_equal(S.permutation.to_host(), p), "path 10: ScaledReordered's permutation")
    rhs = torch.as_tensor(rng.uniform(0.5, 1.5, shape[0]).astype(np.float32), device=dev)
    before = {k: f.launches for k, f in kernels.items()}
    t0 = time.perf_counter()
    x = S.apply(rhs)
    _sync(dev)
    solve_s = time.perf_counter() - t0
    launched = {k: f.launches - before[k] for k, f in kernels.items() if f.launches > before[k]}
    ref = spla.spsolve(C.to_scipy().astype(np.float64).tocsc(), rhs.double().cpu().numpy())
    err = float(np.linalg.norm(x.double().cpu().numpy() - ref) / np.linalg.norm(ref))
    check(x.device == dev and err <= 1e-4, f"path 10: ScaledReordered relative error {err}")
    emit({"phase": "main_path", "path": 10, "case": "scaled_reordered",
          "matrix": f"convdiff_2d({SR_GRID}), scrambled", "bandwidth_before": bw[0],
          "bandwidth_after_rcm": bw[1], "rcm_s": round(rcm_s, 3), "generate_s": round(gen_s, 3),
          "solve_s": round(solve_s, 4), "inner_launches": launched,
          "rel_error_vs_scipy": err})
    stamp("path 10d: ScaledReordered")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU")
    import ginkgo_tpu_torch as gt
    from ginkgo_tpu_torch import _build, stop
    from ginkgo_tpu_torch.ops import bell as ops_bell
    from ginkgo_tpu_torch.ops import bicgstab as ops_bicgstab
    from ginkgo_tpu_torch.ops import cg as ops_cg
    from ginkgo_tpu_torch.ops import cg_ilu as ops_cg_ilu
    from ginkgo_tpu_torch.ops import cgs as ops_cgs
    from ginkgo_tpu_torch.ops import dia as ops_dia
    from ginkgo_tpu_torch.ops import gmres as ops_gmres
    from ginkgo_tpu_torch.ops import idr as ops_idr
    from ginkgo_tpu_torch.ops import ir as ops_ir
    from ginkgo_tpu_torch.ops import mg as ops_mg
    from ginkgo_tpu_torch.ops import pell as ops_pell
    from ginkgo_tpu_torch.ops import pell_cg as ops_pell_cg
    from ginkgo_tpu_torch.ops import trs as ops_trs
    from ginkgo_tpu_torch.ops import well as ops_well

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
        "well_spmv": ops_well.well_spmv,
        "well_spmm": ops_well.well_spmm,
        "bell_spmv": ops_bell.bell_spmv,
        "bell_spmm": ops_bell.bell_spmm,
        "bicgstab_fused": ops_bicgstab.bicgstab_fused,
        "cgs_fused": ops_cgs.cgs_fused,
        "bicg_fused": ops_cgs.bicg_fused,
        "gmres_fused": ops_gmres.gmres_fused,
        "bicgstab_fused_multi": ops_bicgstab.bicgstab_fused_multi,
        "gmres_fused_multi": ops_gmres.gmres_fused_multi,
        "idr_fused": ops_idr.idr_fused,
        "ir_fused": ops_ir.ir_fused,
        "ir_smooth": ops_ir.ir_smooth,
        "pell_gmres_fused": ops_gmres.pell_gmres_fused,
        "pell_bicgstab_fused": ops_pell_cg.pell_bicgstab_fused,
        "pell_cgs_fused": ops_pell_cg.pell_cgs_fused,
        "pell_ir_fused": ops_pell_cg.pell_ir_fused,
        "trs_fused": ops_trs.trs_fused,
        "cg_ilu_fused": ops_cg_ilu.cg_ilu_fused,
        "bicgstab_ilu_fused": ops_cg_ilu.bicgstab_ilu_fused,
        "mg_vcycle": ops_mg.mg_vcycle,
        "mg_cg_fused": ops_mg.mg_cg_fused,
        "mg_solve_fused": ops_mg.mg_solve_fused,
        "mg_bicgstab_fused": ops_mg.mg_bicgstab_fused,
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
          "kernel_build_s": round(build_s, 3),
          "library_build_s": {k: round(v["seconds"], 3) for k, v in _build.BUILD_LOG.items()},
          "ptxas_registers": regs})
    stamp("build")

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
    t0 = time.perf_counter()
    edges = check_cg_edges(gt, dev, rng, record_err)
    emit({"phase": "kernel_check", "kernels": ["cg_fused", "cg_fused_multi"],
          "edge_operators": len(edges), "s": round(time.perf_counter() - t0, 3)})

    stamp("check K1-K4m at 64^2 and 2048^2, K4/K4m edges")

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
            # K5 keeps its plain version's summation order: the same bits
            same = bit_equal(got, want) if name == "pell_spmv" else torch.allclose(
                got, want, rtol=1e-5, atol=1e-5)
            check(same, f"{name} differs from its plain version ({label}, {P.dtype}): {err}")
            row[name + "_max_abs_err"] = err
        emit(row)

    def pell_cg_check(label, P, pre):
        n = P.shape[0]
        b = torch.ones(n, device=dev)
        tol_sq = torch.full((), (TOL * float(np.sqrt(n))) ** 2, dtype=torch.float32, device=dev)
        minv = None
        if pre == "jacobi":
            minv = 1.0 / P.extract_diagonal().values.float()
        t0 = time.perf_counter()
        kx, kr, kit, kmon, kconv = ops_pell_cg.pell_cg_fused(
            P, b, torch.zeros_like(b), minv, tol_sq_eff=tol_sq, max_iters=MAX_ITERS)
        torch.cuda.synchronize()
        k_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        px, pr, pit, pmon, pconv = ops_pell_cg.pell_cg_solve_reference(
            P, b, torch.zeros_like(b), minv, tol_sq_eff=tol_sq, max_iters=MAX_ITERS)
        torch.cuda.synchronize()
        p_s = time.perf_counter() - t0
        kit, pit = int(kit), int(pit)
        err = record_err("pell_cg_fused", kx, px)
        what = f"pell_cg_fused {label} {P.dtype} {pre}"
        check(bool(kconv) and bool(pconv), f"{what}: not converged")
        # the kernel and its plain version differ only in the order of their
        # float64 dot sums: the same iterations, x, r and monitor bit for bit
        check(kit == pit, f"{what}: {kit} vs {pit} iterations")
        check(bit_equal(kx, px) and bit_equal(kr, pr) and bit_equal(kmon, pmon),
              f"{what}: x, r or the monitor differs (x by {err})")
        emit({"phase": "kernel_check", "kernel": "pell_cg_fused", "matrix": label,
              "values": str(P.dtype), "preconditioner": pre, "iters": kit, "plain_iters": pit,
              "x_max_abs_err": err, "bit_equal": True, "s": round(k_s, 4),
              "plain_s": round(p_s, 4)})

    data3s = gt.generators.poisson_3d(SMALL3, dtype=np.float32)
    P = gt.Pell.from_matrix_data(data3s, device=dev)
    for Pv in (P, P.reduce_storage()):
        spmv_pair_check(f"poisson_3d({SMALL3})", Pv)
        for pre in ("identity", "jacobi"):
            pell_cg_check(f"poisson_3d({SMALL3})", Pv, pre)
    t0 = time.perf_counter()
    edges = check_pell_cg_edges(gt, dev, rng, record_err)
    emit({"phase": "kernel_check", "kernels": ["pell_cg_fused"], "edge_operators": len(edges),
          "s": round(time.perf_counter() - t0, 3), "t_s": elapsed()})
    stamp("check K5-K7 at 24^3, K7 edges")

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
        pell_cg_check(f"poisson_3d({NSIDE3})", Pv, "identity")

    t0 = time.perf_counter()
    scatter = gt.generators.local_scatter(SCATTER_ROWS)
    Cs = gt.Csr.from_matrix_data(scatter, device=dev)
    # the S = "auto" PELL layout itself: for this pattern (PELL inflation
    # 6.5 > 4) the plan cache's chooser prefers the WELL plan, as the JAX
    # package's does
    Ps_auto = gt.Pell.from_csr(Cs, S="auto")
    Ps8 = gt.Pell.from_csr(Cs)
    torch.cuda.synchronize()
    emit({"phase": "setup", "matrix": f"local_scatter({SCATTER_ROWS})", "nnz": scatter.nnz,
          "plans_s": round(time.perf_counter() - t0, 3)})
    for Pv in (Ps_auto, Ps8):
        spmv_pair_check(f"local_scatter({SCATTER_ROWS})", Pv)
    del Cs, Ps_auto, Ps8, scatter
    ops_pell._PLAN_CACHE.clear()
    stamp("check K5-K7 at 160^3, K5/K6 on local_scatter")
    t0 = time.perf_counter()
    edges = check_spmv_edges(gt, dev, rng, record_err)
    emit({"phase": "kernel_check", "kernels": ["pell_spmv", "bell_spmv", "bell_spmm"],
          "edge_cases": len(edges),
          "s": round(time.perf_counter() - t0, 3)})
    stamp("K5/K10/K11 edges")

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
        if label == "f32":
            cg_iterations = {"a1": info.num_iterations}  # path 7 must beat it
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
    # path 10's chunked solve must take this solve's iterations and x
    stream1 = {"iterations": sinfo.num_iterations, "x": xs[:, 0]}

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
    emit({"phase": "main_path", "path": 1, "launches": launches1, "t_s": elapsed(),
          "bnorm": bnorm})
    stamp("path 1")
    x64_ones = X64[:, 0].clone()  # path 4 solves the same system with BiCGSTAB
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
    cg_iterations["poisson3d160"] = info.num_iterations
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
    # the plan stays cached: path 9's Coo of the same pattern is held
    # against this Csr's "pallas" applies

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
    emit({"phase": "main_path", "path": 2, "launches": launches2, "t_s": elapsed()})
    stamp("path 2")
    x64_3 = X64[:, 0].clone()  # path 7 solves the same system with an IC preconditioner
    del X64

    # -- 5. main path 3: Csr -> Well, choose_format -> Well and Bell ----------------
    zero_counts()
    p3 = main_path3(gt, dev, rng, crit)
    launches3 = {k: f.launches for k, f in kernels.items()}
    check(all(launches3[k] > 0 for k in PATH3), f"a kernel of path 3 never ran: {launches3}")
    emit({"phase": "main_path", "path": 3, "launches": launches3, "t_s": elapsed()})
    stamp("path 3")
    check_path3_kernels(gt, dev, rng, p3, record_err)
    stamp("check K8-K11")

    # -- 5b. main path 4: the nonsymmetric Krylov solvers on a Dia -----------------------
    zero_counts()
    p4 = main_path4(gt, dev, rng, crit, kernels, data, x64_ones)
    launches4 = {k: f.launches for k, f in kernels.items()}
    check(all(launches4[k] > 0 for k in PATH4), f"a kernel of path 4 never ran: {launches4}")
    emit({"phase": "main_path", "path": 4, "launches": launches4, "t_s": elapsed()})
    stamp("path 4")
    check_path4_kernels(gt, dev, rng, p4, record_err)
    stamp("check K12-K15")
    check_bicgstab_edges(gt, dev, rng, record_err)
    stamp("K12 edges")
    check_bicg_edges(gt, dev, rng, record_err)
    stamp("K14 edges")
    check_cgs_edges(gt, dev, rng, record_err)
    stamp("K13 edges")

    # -- 5c. main path 5: k columns, IDR and IR on a Dia -------------------------------
    zero_counts()
    p5 = main_path5(gt, dev, rng, crit, kernels, p4)
    launches5 = {k: f.launches for k, f in kernels.items()}
    check(all(launches5[k] > 0 for k in PATH5), f"a kernel of path 5 never ran: {launches5}")
    emit({"phase": "main_path", "path": 5, "launches": launches5, "t_s": elapsed()})
    stamp("path 5")
    check_path5_kernels(gt, dev, rng, p4, p5, kernels, record_err)
    stamp("check K12m, K15m, K16, K17")
    check_bicgstab_multi_edges(gt, dev, rng, record_err)
    check_bicgstab_multi_order(gt, dev, p4["A"])
    stamp("K12m edges")
    check_gmres_multi_edges(gt, dev, rng, record_err)
    stamp("K15m edges")
    check_idr_edges(gt, dev, rng, record_err)
    stamp("K16 edges")
    check_ir_edges(gt, dev, rng, record_err)
    stamp("K17 edges")
    del p5

    # -- 5d. main path 6: the Krylov solvers on a Pell (Csr -> Pell) -------------------
    zero_counts()
    p6 = main_path6(gt, dev, rng, crit, kernels, p4)
    launches6 = {k: f.launches for k, f in kernels.items()}
    check(all(launches6[k] > 0 for k in PATH6), f"a kernel of path 6 never ran: {launches6}")
    emit({"phase": "main_path", "path": 6, "launches": launches6, "t_s": elapsed()})
    stamp("path 6")
    check_path6_kernels(gt, dev, rng, p4, p6, record_err)
    stamp("check K18-K21")
    del p6
    t0 = time.perf_counter()
    edges = check_gmres_edges(gt, dev, rng, record_err)
    emit({"phase": "kernel_check", "kernels": ["gmres_fused", "pell_gmres_fused"],
          "edge_cases": len(edges), "s": round(time.perf_counter() - t0, 3), "t_s": elapsed()})
    stamp("K15/K18 edges")
    check_pell_ir_edges(gt, dev, rng, record_err)
    stamp("K21 edges")
    check_pell_bicgstab_cgs_edges(gt, dev, rng, record_err)
    stamp("K19/K20 edges")

    # -- 5e. main path 7: triangular solves and incomplete factorizations ----------------
    zero_counts()
    p7 = main_path7(gt, dev, rng, crit, kernels, data, x64_ones, p4, C, P, x64_3, norm_a3,
                    cg_iterations)
    launches7 = {k: f.launches for k, f in kernels.items()}
    check(all(launches7[k] > 0 for k in PATH7), f"a kernel of path 7 never ran: {launches7}")
    emit({"phase": "main_path", "path": 7, "launches": launches7, "t_s": elapsed()})
    stamp("path 7")
    check_path7_kernels(gt, dev, rng, p7, record_err)
    stamp("check K22-K24")
    emit({"phase": "kernel_check", "path": 7, "done": True, "t_s": elapsed()})

    # -- 5f. main path 8: algebraic multigrid -------------------------------------------
    zero_counts()
    p8 = main_path8(gt, dev, rng, crit, kernels, data, x64_ones, p4, cg_iterations)
    launches8 = {k: f.launches for k, f in kernels.items()}
    check(all(launches8[k] > 0 for k in PATH8), f"a kernel of path 8 never ran: {launches8}")
    emit({"phase": "main_path", "path": 8, "launches": launches8, "t_s": elapsed()})
    stamp("path 8")
    check_path8_kernels(gt, dev, rng, p8, record_err)
    emit({"phase": "kernel_check", "path": 8, "done": True, "t_s": elapsed()})
    stamp("check K25-K28")

    # -- 5g. main path 9: the streaming formats, SpGEMM and SpGEAM ------------------------
    zero_counts()
    p9 = main_path9(gt, dev, rng, crit, data3, C, x64_3, norm_a3, p3)
    launches9 = {k: f.launches for k, f in kernels.items()}
    path9 = PATH9 + (("well_spmv", "well_spmm") if p9["hybrid_plan"] == "Well" else ())
    check(all(launches9[k] > 0 for k in path9), f"a kernel of path 9 never ran: {launches9}")
    emit({"phase": "main_path", "path": 9, "launches": launches9, "kernels": list(path9),
          "t_s": elapsed()})
    stamp("path 9")
    check_path9_kernels(gt, dev, rng, p9, record_err)
    stamp("check K5/K6, K8/K9 on path 9's plans")
    del x64_3, p9

    # -- 5h. main path 10: reorderings, Cholesky, block Jacobi, solver plumbing ------------
    zero_counts()
    main_path10(gt, dev, rng, crit, kernels, data, x64_ones, p4, stream1)
    launches10 = {k: f.launches for k, f in kernels.items()}
    check(all(launches10[k] > 0 for k in PATH10), f"a kernel of path 10 never ran: {launches10}")
    emit({"phase": "main_path", "path": 10, "launches": launches10, "kernels": list(PATH10),
          "t_s": elapsed()})
    del x64_ones, stream1
    launches = {k: launches1[k] + launches2[k] + launches3[k] + launches4[k] + launches5[k]
                + launches6[k] + launches7[k] + launches8[k] + launches9[k] + launches10[k]
                for k in kernels}

    # -- 6. timings (printed, not checked) -------------------------------------------
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
            p_ms = slope_ms(plain, *PLAIN_SLOPE)
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
            p_ms = slope_ms(plain, *PLAIN_SLOPE)
            gbs = nbytes / k_ms / 1e6
            timing[f"{name}_{storage}"] = {"ms": k_ms, "plain_ms": p_ms, "GBps": gbs,
                                           "frac_of_copy": gbs / copy_gbs}
            if name == "pell_spmv":
                timing[f"{name}_{storage}"].update(
                    device_ms=device_ms(kern, name), host_us_per_call=host_us(kern))
            if storage == "f32":
                rec[name] = (k_ms, p_ms, slope_ms(lib), nbytes, flops)
    del lib3

    W, Bop = p3["W"], p3["Bop"]
    n_pl = W.shape[0]
    x_pl = torch.as_tensor(rng.standard_normal(n_pl).astype(np.float32), device=dev)
    X_pl = torch.as_tensor(rng.standard_normal((n_pl, 4)).astype(np.float32), device=dev)
    lib_pl = library_csr(p3["C"])
    m_b = Bop.shape[1]
    x_b = torch.as_tensor(rng.standard_normal(m_b).astype(np.float32), device=dev)
    X_b = torch.as_tensor(rng.standard_normal((m_b, 4)).astype(np.float32), device=dev)
    lib_b = library_csr(p3["Cb"])
    nnz_pl = p3["C"].nnz
    cells_w = W.values.numel()
    for storage, Bv in (("f32", Bop), ("bf16", Bop.reduce_storage())):
        # bound bytes: the stored plan or panels (padding included), x read
        # once and y written once; operations: 2 per stored cell and column
        cells_b = Bv.values.numel()
        bell_bytes = cells_b * Bv.values.element_size() + Bv.panel_ids.numel() * 4
        cases = {
            "bell_spmv": (lambda: ops_bell.bell_spmv(Bv, x_b),
                          lambda: ops_bell.bell_spmv_reference(Bv, x_b),
                          lambda: torch.mv(lib_b, x_b), bell_bytes + 4 * (m_b + Bv.shape[0]),
                          2 * cells_b),
            "bell_spmm": (lambda: ops_bell.bell_spmm(Bv, X_b),
                          lambda: ops_bell.bell_spmm_reference(Bv, X_b),
                          lambda: torch.sparse.mm(lib_b, X_b),
                          bell_bytes + 16 * (m_b + Bv.shape[0]), 8 * cells_b),
        }
        if storage == "f32":
            cases.update({
                "well_spmv": (lambda: ops_well.well_spmv(W, x_pl),
                              lambda: ops_well.well_spmv_reference(W, x_pl),
                              lambda: torch.mv(lib_pl, x_pl), W.storage_bytes() + 8 * n_pl,
                              2 * cells_w),
                "well_spmm": (lambda: ops_well.well_spmm(W, X_pl),
                              lambda: ops_well.well_spmm_reference(W, X_pl),
                              lambda: torch.sparse.mm(lib_pl, X_pl),
                              W.storage_bytes() + 32 * n_pl, 8 * cells_w),
            })
        for name, (kern, plain, lib, nbytes, flops) in cases.items():
            k_ms = slope_ms(kern, 5, 25)
            extra = {}
            if name == "bell_spmm":
                # a call's host time exceeds K11's time on the card, so the
                # slope measures the host: K11's ms is a CUDA graph's
                extra["slope_ms"], k_ms = k_ms, graph_ms(kern)
            p_ms = slope_ms(plain, *PLAIN_SLOPE)
            gbs = nbytes / k_ms / 1e6
            timing[f"{name}_{storage}"] = {"ms": k_ms, "plain_ms": p_ms, "GBps": gbs,
                                           "frac_of_copy": gbs / copy_gbs, **extra}
            if name in ("bell_spmv", "bell_spmm"):
                timing[f"{name}_{storage}"].update(
                    device_ms=device_ms(kern, name), host_us_per_call=host_us(kern))
            if storage == "f32":
                rec[name] = (k_ms, p_ms, slope_ms(lib, 5, 25), nbytes, flops)
    timing["well_chunks"] = {
        **chunk_figures(W, ops_well.chunk_list(W), torch.float32),
        "smem_bytes_k8": ops_well.block_smem_bytes(W, torch.float32),
        "smem_bytes_k9_k4": ops_well.block_smem_bytes(W, torch.float32, 4)}
    # the CSR's own bound for the WELL kernels: 12 bytes a nonzero (value,
    # column index, gathered x) plus y, and x for the k columns
    timing["well_csr_bound_ms"] = {
        "well_spmv": (12 * nnz_pl + 4 * n_pl) / PEAK_BYTES_S * 1e3,
        "well_spmm": (8 * nnz_pl + 4 * 4 * nnz_pl + 16 * n_pl) / PEAK_BYTES_S * 1e3}
    del lib_pl, lib_b
    stamp("timing K1-K3, K5, K6, K8-K11")

    def streaming_well(its):
        gt.Cg.build(criteria=[stop.Iteration(max_iters=its)]).generate(W).solve(p3["b"])

    w_ms = iter_ms(streaming_well, 20, 100)
    timing["cg_us_per_iter_well"] = {"streaming": w_ms * 1e3, "T": W.T, "rows": n_pl}

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
        f_ms, s_ms = iter_ms(fz), iter_ms(st, *STREAM_TRIPS)
        p_ms = iter_ms(pl, *PLAIN_TRIPS)
        rec[name] = (f_ms, p_ms, None, nbytes, flops)
        timing["cg_us_per_iter"][name] = {"fused": f_ms * 1e3, "streaming": s_ms * 1e3,
                                          "plain": p_ms * 1e3,
                                          "GBps": nbytes / f_ms / 1e6}
    timing["cg_iteration_gap_2048"] = gaps
    stamp("timing K4, K4m, K7, streaming CG on the Well")
    for step, run in (("timing K12-K15", lambda: time_path4(gt, dev, p4, rec, timing)),
                      ("timing K12m, K15m, K16, K17", lambda: time_path5(gt, dev, p4, rec, timing)),
                      ("timing K18-K21 on 160^3", lambda: time_path6(gt, dev, P, b3, rec, timing)),
                      ("timing K22-K24", lambda: time_path7(gt, dev, p7, rec, timing)),
                      ("timing K25-K28", lambda: time_path8(gt, dev, p8, rec, timing))):
        run()
        stamp(step)
    timing["t_s"] = elapsed()
    emit(timing)
    # the launches of K5, K10 and K11 (k = 4) on the main path's operators
    # (float32), and their device time by kernel name
    launch_info = {"pell_spmv": ops_pell.spmv_launch(P), "bell_spmv": ops_bell.spmv_launch(Bop),
                   "bell_spmm": ops_bell.spmm_launch(Bop, X_b.shape[1])}
    for name in launch_info:
        launch_info[name]["device_ms"] = timing[f"{name}_f32"]["device_ms"]
    # K4's and K4m's (k = 4) cooperative grids with float32 diagonals
    launch_info["cg_fused"] = ops_cg.cg_fused_launch(torch.float32, 1, dev)
    launch_info["cg_fused_multi"] = ops_cg.cg_fused_launch(torch.float32, 4, dev)
    # K22's and K23's launches on A1's IC triangles
    launch_info.update(timing["slice7"]["launch"])
    # K7's on the 160^3 Pell, K15's on A2 and K18's on the 160^3 Pell (m =
    # 30, a float32 basis)
    launch_info["pell_cg_fused"] = ops_pell_cg.pell_cg_fused_launch(P, dev)
    launch_info["gmres_fused"] = ops_gmres.gmres_fused_launch(p4["A"], KRYLOV_DIM, device=dev)
    launch_info["pell_gmres_fused"] = ops_gmres.gmres_fused_launch(P, KRYLOV_DIM, device=dev)

    # -- 7. result -----------------------------------------------------------------------
    rows = []
    for name in kernels:
        k_ms, p_ms, l_ms, nbytes, flops = rec[name][:5]
        b_ms, b_by = bound(nbytes, flops)
        rows.append({"name": name, "route": "cuda", "source": KERNEL_META[name][0],
                     "replaces": KERNEL_META[name][1], "launches": launches[name],
                     "max_abs_err": max_err[name], "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
                     "bytes": nbytes, "flops": flops,
                     "copy_bound_ms": nbytes / copy_gbs / 1e6})
        if name in timing["well_csr_bound_ms"]:
            rows[-1]["csr_bound_ms"] = timing["well_csr_bound_ms"][name]
        if len(rec[name]) > 5:  # the Pell solvers: the plan read once per SpMV
            rows[-1]["bound_ms_plan_per_spmv"] = bound(rec[name][5], flops)[0]
        if name in launch_info:  # registers, blocks an SM (the ring kernels: shared memory)
            rows[-1].update(launch_info[name])
    emit({"phase": "phases", "t_s": elapsed(), "slowest": slowest_phases()})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
