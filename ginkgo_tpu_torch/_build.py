"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is a self-contained translation unit with a plain C
interface.  On first use it is compiled by ``nvcc`` into a shared library
(``-gencode arch=compute_90a,code=sm_90a``, Hopper) and loaded with
``ctypes``; :func:`build` compiles several sources at once, one ``nvcc``
process each.  A source listed in ``PARTS`` is compiled in that many
translation units at once, each with ``-DGK_PART=<i>`` (the source decides
which kernels each part holds), and the objects are linked into its
library.  The library name carries a hash of the source and the flags,
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
#: sources compiled in parts, and their part counts: trs_fused.cu's 192
#: kernels compiled for each walk shape (K22's, K23's and K24's; the first
#: 128 took 199 s in one nvcc process on the H100's host, beside 13 s
#: without them); gmres_fused.cu holds K15's, K18's and K15m's 36 kernels,
#: one part each
PARTS = {"trs_fused": 10, "gmres_fused": 3}

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
    h.update(str(PARTS.get(src.stem, 1)).encode())
    return h.hexdigest()[:16]


def _commands(nvcc: str, name: str, out: Path):
    """The nvcc commands that build ``csrc/<name>.cu`` into ``out``: one
    that compiles and links it, or (``PARTS``) one a part that compiles it
    into an object, all run at once, then one that links them."""
    src = str(CSRC / f"{name}.cu")
    parts = PARTS.get(name, 1)
    if parts == 1:
        return [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), src]], None
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [out.with_suffix(f".part{i}.o") for i in range(parts)]
    compiles = [[nvcc, *flags, "-c", f"-DGK_PART={i}", "-I", str(CSRC), "-o", str(obj), src]
                for i, obj in enumerate(objs)]
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(out),
            *map(str, objs)]
    return compiles, (link, objs)


def build(names) -> dict[str, ctypes.CDLL]:
    """Return the loaded libraries built from ``csrc/<name>.cu`` for each
    name.  Every library without a build for its current source is
    compiled first, all of them at once (one ``nvcc`` process each, or
    each part's); the call returns after every process it started has
    ended."""
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
            compiles, link = _commands(nvcc, name, tmp)
            procs[name] = ([subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True)
                            for cmd in compiles], link, tmp, time.perf_counter())
    records, errors = {}, []
    for name, (started, link, tmp, t0) in procs.items():
        results = []
        for proc in started:
            out, err = proc.communicate()
            results.append((proc.returncode, out, err))
        if link is not None and all(rc == 0 for rc, _, _ in results):
            cmd, objs = link
            done = subprocess.run(cmd, capture_output=True, text=True)
            results.append((done.returncode, done.stdout, done.stderr))
            for obj in objs:
                obj.unlink(missing_ok=True)
        stderr = "".join(err for _, _, err in results)
        records[name] = {"seconds": time.perf_counter() - t0, "ptxas": stderr,
                         "path": str(outs[name])}
        failed = [(rc, out, err) for rc, out, err in results if rc != 0]
        if failed:
            tmp.unlink(missing_ok=True)
            errors.extend(f"nvcc failed on {name}.cu (rc {rc}):\n{out}\n{err}"
                          for rc, out, err in failed)
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


def is_built(name: str) -> bool:
    """Whether a library of the current ``csrc/<name>.cu`` is loaded or on
    disk (nothing is compiled)."""
    return name in _LIBS or (
        BUILD_DIR / f"lib{name}-{_source_hash(CSRC / f'{name}.cu')}.so").exists()
