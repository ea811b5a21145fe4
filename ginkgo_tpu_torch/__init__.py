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
  -> ``Cg`` / ``Fcg``, fused or streaming.
"""

__version__ = "0.1.0"

from . import stop
from .base import exceptions, types
from .base.linop import Combination, Composition, LinOp, Perturbation
from .base.matrix_data import DeviceMatrixData, MatrixData
from .matrix.csr import Csr
from .matrix.dense import Dense
from .matrix.dia import Dia
from .matrix.diagonal import Diagonal, Identity
from .matrix.pell import Pell
from .preconditioner.jacobi import Jacobi
from .solver.cg import Cg, Fcg
from .solver.solver_base import SolveInfo
from .utils import generators

__all__ = [
    "Cg",
    "Combination",
    "Composition",
    "Csr",
    "Dense",
    "DeviceMatrixData",
    "Dia",
    "Diagonal",
    "Fcg",
    "Identity",
    "Jacobi",
    "LinOp",
    "MatrixData",
    "Pell",
    "Perturbation",
    "SolveInfo",
    "exceptions",
    "generators",
    "stop",
    "types",
]
