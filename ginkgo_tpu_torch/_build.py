"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is a self-contained translation unit with a plain C
interface.  On first use it is compiled by ``nvcc`` into a shared library
(``-gencode arch=compute_90a,code=sm_90a``, Hopper) and loaded with
``ctypes``; :func:`build` compiles several sources at once, one ``nvcc``
process each.  The library name carries a hash of the source and the flags,
so an edited source rebuilds and a stale library is never loaded.  Builds
land in ``build/kernels/`` at the repository root (listed in
``.gitignore``); a library is written under a temporary name and renamed
into place, so concurrent processes never load a half-written file.

No PyTorch headers are included, which keeps a build at seconds instead of
minutes.  There is no fallback: a missing ``nvcc`` or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
#: the CUDA toolkit's conventional install prefix, searched last
CUDA_DEFAULT_HOME = Path("/usr/local/cuda")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
#: every kernel library of the port, one ``csrc/<name>.cu`` each
KERNELS = ("dia_spmv", "cg_fused", "pell_spmv", "pell_cg_fused", "well_spmv", "bell_spmv",
           "bicgstab_fused", "cgs_fused", "gmres_fused", "idr_fused", "ir_fused", "trs_fused",
           "mg_fused")

# -fmad=false: every multiply and add rounds on its own, as PyTorch's
# elementwise ops do, so a kernel and its plain version differ only in the
# order of their float64 dot-product sums.  The kernels are bound by memory
# traffic, so the fused multiply-add buys no time.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
#: per-library build record: {"seconds": float, "ptxas": str, "path": str}
BUILD_LOG: dict[str, dict] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc() -> str:
    """Locate nvcc: $CUDA_HOME/bin, $CUDA_PATH/bin, PATH, then the
    toolkit's conventional install prefix.  Raises when none exists."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root:
            candidates.append(Path(root) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(CUDA_DEFAULT_HOME / "bin" / "nvcc")
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of ginkgo_tpu_torch are built from source at first use"
    )


def _source_hash(src: Path) -> str:
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(names) -> dict[str, ctypes.CDLL]:
    """Return the loaded libraries built from ``csrc/<name>.cu`` for each
    name.  Every library without a build for its current source is
    compiled first, all of them at once (one ``nvcc`` process each); the
    call returns after every process it started has ended."""
    names = list(dict.fromkeys(names))
    outs = {name: BUILD_DIR / f"lib{name}-{_source_hash(CSRC / f'{name}.cu')}.so"
            for name in names if name not in _LIBS}
    missing = [name for name, out in outs.items() if not out.exists()]
    procs = {}
    if missing:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for name in missing:
            tmp = outs[name].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True),
                           tmp, time.perf_counter())
    records, errors = {}, []
    for name, (proc, tmp, t0) in procs.items():
        stdout, stderr = proc.communicate()
        records[name] = {"seconds": time.perf_counter() - t0, "ptxas": stderr,
                         "path": str(outs[name])}
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed on {name}.cu (rc {proc.returncode}):\n"
                          f"{stdout}\n{stderr}")
        else:
            os.replace(tmp, outs[name])
    if errors:
        raise KernelBuildError("\n".join(errors))
    for name, out in outs.items():
        _LIBS[name] = ctypes.CDLL(str(out))
        BUILD_LOG[name] = records.get(name, {"seconds": 0.0, "ptxas": "", "path": str(out)})
    return {name: _LIBS[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library built from ``csrc/<name>.cu``, compiling
    it first when no library for the current source exists."""
    return build([name])[name]
