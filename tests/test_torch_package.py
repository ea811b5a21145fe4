"""Packaging rules of the PyTorch port (ginkgo_tpu_torch).

- Importing it pulls in no JAX and nothing of the JAX package; its sources,
  chip_smoke.py and well_bench.py import neither.
- On CPU tensors every kernel wrapper runs its plain version, so a whole
  slice-1 run leaves the launch counters at 0.
- The kernel modules import without nvcc, and building a kernel without
  nvcc raises instead of falling back.
- chip_smoke.py fails, printing no result, without a CUDA device and
  without the package beside it.
"""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "ginkgo_tpu_torch"


def _run(code, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
        timeout=300,
    )


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(p.relative_to(REPO).as_posix() for p in PKG.rglob("*.py"))
    + ["chip_smoke.py", "well_bench.py"],
)
def test_sources_import_no_jax(path):
    for mod in _imported_modules(REPO / path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "ginkgo_tpu"), f"{path} imports {mod}"


def test_import_leaves_no_jax_in_sys_modules():
    proc = _run(
        "import sys, json\n"
        "import ginkgo_tpu_torch, ginkgo_tpu_torch.interop\n"
        "import ginkgo_tpu_torch.ops.dia, ginkgo_tpu_torch.ops.cg\n"
        "import ginkgo_tpu_torch.ops.pell, ginkgo_tpu_torch.ops.pell_cg\n"
        "import ginkgo_tpu_torch.ops.well, ginkgo_tpu_torch.ops.bell\n"
        "import ginkgo_tpu_torch.matrix.auto\n"
        "import ginkgo_tpu_torch.matrix.coo, ginkgo_tpu_torch.matrix.ell\n"
        "import ginkgo_tpu_torch.matrix.hybrid, ginkgo_tpu_torch.matrix.sparsity_csr\n"
        "import ginkgo_tpu_torch.matrix.fbcsr, ginkgo_tpu_torch.base.index_set\n"
        "import ginkgo_tpu_torch.ops.spgemm, ginkgo_tpu_torch.ops.components\n"
        "import ginkgo_tpu_torch.ops.spmv\n"
        "import ginkgo_tpu_torch.reorder, ginkgo_tpu_torch.reorder.rcm\n"
        "import ginkgo_tpu_torch.reorder.nd, ginkgo_tpu_torch.reorder.scaled_reordered\n"
        "import ginkgo_tpu_torch.log, ginkgo_tpu_torch.log.logger, ginkgo_tpu_torch.log.profiler\n"
        "import ginkgo_tpu_torch.base.precision_dispatch, ginkgo_tpu_torch.base.accessor\n"
        "import ginkgo_tpu_torch.base.executor, ginkgo_tpu_torch.base.version\n"
        "import ginkgo_tpu_torch._native, ginkgo_tpu_torch.factorization.lu\n"
        "import ginkgo_tpu_torch.preconditioner.jacobi\n"
        "ginkgo_tpu_torch.base.version.version_info()\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'ginkgo_tpu'))))\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_cpu_slice_launches_no_kernel():
    """Fused route, streaming route, k-column solve and apply_advanced on
    CPU tensors, on a Dia, through Csr, Pell and Well, and Bell applies:
    every wrapper takes its plain version."""
    proc = _run(
        "import json, numpy as np, torch\n"
        "import ginkgo_tpu_torch as gt\n"
        "from ginkgo_tpu_torch.ops import bell, cg, dia, pell, pell_cg, well\n"
        "A = gt.Dia.from_matrix_data(gt.generators.poisson_2d(12, dtype=np.float32), device='cpu')\n"
        "n = A.shape[0]\n"
        "crit = [gt.stop.Iteration(max_iters=200), gt.stop.ResidualNorm(tolerance=1e-6)]\n"
        "s = gt.Cg.build(criteria=crit, preconditioner=gt.Jacobi.build()).generate(A)\n"
        "x, info = s.solve(torch.ones(n))\n"
        "xs, _ = s._solve_streaming(torch.ones(n, 1), torch.zeros(n, 1))\n"
        "X, minfo = s.solve(torch.ones(n, 3))\n"
        "r = A.apply_advanced(-1.0, x, 1.0, torch.ones(n))\n"
        "assert bool(info.converged.all()) and bool(minfo.converged.all())\n"
        "C = gt.Csr.from_matrix_data(gt.generators.poisson_3d(6, dtype=np.float32), device='cpu')\n"
        "P = gt.Pell.from_csr(C)\n"
        "for op in (C.with_strategy('pallas'), P, gt.Well.from_csr(C, T=4)):\n"
        "    for b in (torch.ones(C.shape[0]), torch.ones(C.shape[0], 3)):\n"
        "        _, i = gt.Cg.build(criteria=crit).generate(op).solve(b)\n"
        "        assert bool(i.converged.all())\n"
        "B = C.to_bell()\n"
        "assert B.apply(torch.ones(C.shape[0])).shape == (C.shape[0],)\n"
        "assert B.apply(torch.ones(C.shape[0], 3)).shape == (C.shape[0], 3)\n"
        "print(json.dumps([f.launches for f in (dia.dia_spmv, dia.dia_spmv_advanced,\n"
        "                  dia.dia_spmm, cg.cg_fused, cg.cg_fused_multi, pell.pell_spmv,\n"
        "                  pell.pell_spmm, pell_cg.pell_cg_fused, well.well_spmv,\n"
        "                  well.well_spmm, bell.bell_spmv, bell.bell_spmm)]))\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [0] * 12


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from ginkgo_tpu_torch import _build

    for var in ("CUDA_HOME", "CUDA_PATH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_DEFAULT_HOME", tmp_path / "cuda")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load("dia_spmv")
    assert not (tmp_path / "build").exists()


def test_kernel_sources_are_listed():
    """Every kernel the wrappers load has its source in csrc/."""
    from ginkgo_tpu_torch import _build

    assert _build.KERNELS == ("dia_spmv", "cg_fused", "pell_spmv", "pell_cg_fused",
                              "well_spmv", "bell_spmv", "bicgstab_fused", "cgs_fused",
                              "gmres_fused", "idr_fused", "ir_fused", "trs_fused",
                              "mg_fused")
    for name in _build.KERNELS:
        assert (PKG / "csrc" / f"{name}.cu").is_file()
    for header in ("async", "common", "coop", "pell"):
        assert (PKG / "csrc" / f"{header}.cuh").is_file()


def test_chip_smoke_fails_without_cuda():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
