"""ginkgo_tpu_torch — the PyTorch / CUDA port of ginkgo_tpu for NVIDIA Hopper.

A second package beside ``ginkgo_tpu`` (the JAX reference, which it is
tested against), with the same factory/LinOp API.  Plain tensor code is
PyTorch; every kernel the JAX package wrote in Pallas for the TPU is a
hand-written CUDA kernel for ``sm_90a`` under ``csrc/``, built by ``nvcc``
at first use (``_build.py``).  On a CPU tensor each kernel wrapper runs
the kernel's plain PyTorch version instead.

Ported so far:

- slice 1: 2-D Poisson ``MatrixData`` -> ``Dia`` -> ``Cg`` / ``Fcg`` with
  Identity or scalar-Jacobi preconditioning, one or up to 8 right-hand
  sides in one fused kernel;
- slice 2: unstructured matrices, ``MatrixData`` -> ``Csr`` (classical,
  merge_path, sparselib and the PELL-plan "pallas" strategy) -> ``Pell``
  -> ``Cg`` / ``Fcg``, fused or streaming;
- slice 3: locality-free and block-sparse matrices, ``Well`` and ``Bell``,
  the WELL plan of ``Csr``'s "pallas" and "auto" strategies, and
  ``choose_format``;
- slice 4: the nonsymmetric Krylov solvers ``Bicgstab``, ``Cgs``, ``Bicg``,
  ``Gmres`` and ``CbGmres``, each with a whole-solve kernel for one column
  on a ``Dia``;
- slice 5: k-column whole-solve kernels for ``Bicgstab`` (2 to 8 columns)
  and ``Gmres``/``CbGmres`` (2 to 4), and the solvers ``Idr`` and
  ``Ir``/``Richardson``, each with a whole-solve kernel for one column on
  a ``Dia`` (IR's kernel also runs fixed smoothing sweeps);
- slice 6: ``Bicgstab``, ``Cgs``, ``Gmres``/``CbGmres`` and ``Ir`` with a
  whole-solve kernel for one column on a ``Pell``;
- slice 7: triangular solves and incomplete factorizations:
  ``solver.LowerTrs``/``UpperTrs`` (block_scan and sweeps, the sweeps in
  one kernel), ``factorization.Ilu``/``Ic``/``ParIlu``/``ParIc``/
  ``ParIlut``/``ParIct``/``Lu``, ``preconditioner.Ilu``/``Ic``/``Isai``,
  ``Direct``, and whole-solve kernels for ``Cg`` and ``Bicgstab`` with an
  ILU/IC preconditioner applied in the kernel on a ``Dia``;
- slice 8: algebraic multigrid: ``multigrid.Pgm``/``FixedCoarsening``,
  ``solver.Multigrid`` (V/W/F/K cycles, ``FixedSmoother``, ``Direct`` on
  the coarsest level) as a solver and as a preconditioner, with
  whole-cycle and whole-solve kernels on an all-``Dia`` hierarchy (one
  cycle; cycles to the stop test; ``Cg``/``Fcg`` and ``Bicgstab`` with the
  cycle as M);
- slice 9: the streaming formats ``Coo``, ``Ell``, ``Sellp``,
  ``Hybrid``, ``SparsityCsr`` and ``Fbcsr``, each served on a CUDA tensor
  by one route (the CSR view's PELL or WELL plan, kernels K5/K6/K8/K9)
  with its own gather product where the route declines; ``Csr``'s "sellp"
  strategy, SpGEMM (``Csr.apply(Csr)``, ``spgemm``) and SpGEAM
  (``spgeam``), ``create_submatrix`` with ``IndexSet``; the rest of
  ``Dense``; ``Permutation``, ``RowGatherer`` and ``IdentityFactory``;
- slice 10: the reorderings ``reorder.Rcm``, ``NestedDissection`` and
  ``ScaledReordered``, ``factorization.Cholesky`` on the native up-looking
  kernel (``native/cholesky.cpp``, built by ``_native``) and the named
  reorderings of ``Lu``, block and adaptive-storage ``Jacobi``, the
  loggers (``log``), ``stop.Time`` and ``solve_chunked``, and
  ``precision_dispatch``, the accessors, the executors and
  ``version_info`` in ``base``.
"""

__version__ = "0.1.0"

from . import factorization, log, multigrid, preconditioner, reorder, solver, stop
from .base import accessor, exceptions, types
from .base.executor import (
    CudaExecutor,
    Executor,
    OmpExecutor,
    ReferenceExecutor,
    TpuExecutor,
    default_executor,
)
from .base.precision_dispatch import precision_dispatch, precision_dispatch_advanced
from .base.types import precision_reduction
from .base.version import version_info
from .base.linop import Combination, Composition, LinOp, Perturbation
from .base.matrix_data import DeviceMatrixData, MatrixData
from .matrix.auto import choose_format
from .base.index_set import IndexSet
from .matrix.bell import Bell
from .matrix.coo import Coo
from .matrix.csr import Csr
from .matrix.dense import Dense
from .matrix.dia import Dia
from .matrix.diagonal import Diagonal, Identity, IdentityFactory, Permutation, RowGatherer
from .matrix.ell import Ell, Sellp
from .matrix.fbcsr import Fbcsr
from .matrix.hybrid import Hybrid
from .matrix.pell import Pell
from .matrix.sparsity_csr import SparsityCsr
from .matrix.well import Well
from .preconditioner.jacobi import Jacobi, JacobiFactory
from .solver.bicgstab import Bicg, Bicgstab, Cgs
from .solver.cg import Cg, Fcg
from .solver.direct import Direct
from .solver.gmres import CbGmres, Gmres
from .solver.idr import Idr
from .solver.ir import Ir, Richardson
from .solver.multigrid import FixedSmoother, Multigrid, MultigridFactory
from .solver.solver_base import SolveInfo
from .utils import generators

__all__ = [
    "Bell",
    "Bicg",
    "Bicgstab",
    "CbGmres",
    "Cg",
    "Cgs",
    "Combination",
    "Composition",
    "Coo",
    "Csr",
    "CudaExecutor",
    "Dense",
    "DeviceMatrixData",
    "Dia",
    "Diagonal",
    "Direct",
    "Ell",
    "Executor",
    "Fbcsr",
    "Fcg",
    "FixedSmoother",
    "Gmres",
    "Hybrid",
    "Identity",
    "IdentityFactory",
    "Idr",
    "IndexSet",
    "Ir",
    "Jacobi",
    "JacobiFactory",
    "LinOp",
    "MatrixData",
    "Multigrid",
    "MultigridFactory",
    "OmpExecutor",
    "Pell",
    "Permutation",
    "Perturbation",
    "ReferenceExecutor",
    "Richardson",
    "RowGatherer",
    "Sellp",
    "SolveInfo",
    "SparsityCsr",
    "TpuExecutor",
    "Well",
    "accessor",
    "choose_format",
    "default_executor",
    "exceptions",
    "factorization",
    "generators",
    "log",
    "multigrid",
    "precision_dispatch",
    "precision_dispatch_advanced",
    "precision_reduction",
    "preconditioner",
    "reorder",
    "solver",
    "stop",
    "types",
    "version_info",
]
