"""Build and load the port's host C++ library: the sparse Cholesky factor.

``native/cholesky.cpp`` (the up-looking LL^T of the JAX package's native
library, reference core/factorization/cholesky_kernels.hpp) is compiled
unchanged from its path by the host C++ compiler (``$CXX``, else ``c++``,
else ``g++``; ``-O3 -std=c++17 -fPIC -shared``) into ``build/native/`` at the
repository root (listed in ``.gitignore``), under a name that carries a hash
of the source and the flags.  The library is written under a temporary name
and renamed into place, so concurrent processes never load a half-written
file.  The JAX package's ``make`` in ``native/`` is not run: it writes
``native/build/``, which that package's own loader builds.

With no compiler at all :func:`load` returns None (the caller then takes
its bounded dense fallback); when a compiler is found and the build fails,
it raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
SOURCE = REPO / "native" / "cholesky.cpp"
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_LIB: list = []  # the loaded library, once


class NativeBuildError(RuntimeError):
    """The host compiler refused ``native/cholesky.cpp``."""


class NotPositiveDefinite(RuntimeError):
    """Cholesky breakdown: a non-positive pivot at the reported row."""


def find_cxx() -> str | None:
    """``$CXX``, else ``c++``, else ``g++`` on PATH; None when there is none."""
    env = os.environ.get("CXX")
    for c in ([env] if env else []) + ["c++", "g++"]:
        path = shutil.which(c)
        if path:
            return path
    return None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libgko_cholesky-{h.hexdigest()[:16]}.so"


def is_built() -> bool:
    return bool(_LIB) or library_path().exists()


def load():
    """The loaded library, compiled first when no build of the current
    source exists; None when no C++ compiler is found."""
    if _LIB:
        return _LIB[0]
    with _lock:
        if _LIB:
            return _LIB[0]
        out = library_path()
        if not out.exists():
            cxx = find_cxx()
            if cxx is None:
                return None
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            done = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
            if done.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise NativeBuildError(
                    f"{cxx} failed on {SOURCE} (rc {done.returncode}):\n{done.stdout}\n"
                    f"{done.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.gko_chol_factor.argtypes = [ctypes.c_int64, i64p, i64p,
                                        ctypes.POINTER(ctypes.c_double),
                                        ctypes.POINTER(ctypes.c_void_p), i64p]
        lib.gko_chol_factor.restype = ctypes.c_int
        lib.gko_chol_sizes.argtypes = [ctypes.c_void_p, i64p, i64p]
        lib.gko_chol_sizes.restype = None
        lib.gko_chol_fill.argtypes = [ctypes.c_void_p, i64p, i64p,
                                      ctypes.POINTER(ctypes.c_double)]
        lib.gko_chol_fill.restype = None
        lib.gko_chol_free.argtypes = [ctypes.c_void_p]
        lib.gko_chol_free.restype = None
        _LIB.append(lib)
        return lib


def sparse_cholesky(indptr, indices, values):
    """Up-looking sparse LL^T of a full symmetric CSR with sorted column
    indices.  Returns (col_ptr, row_idx, val) of L in CSC (the CSR of L^T),
    or None when no C++ compiler is found.  Raises NotPositiveDefinite on
    breakdown."""
    lib = load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    values = np.ascontiguousarray(values, np.float64)
    n = len(indptr) - 1

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    handle = ctypes.c_void_p()
    info = ctypes.c_int64()
    rc = lib.gko_chol_factor(ctypes.c_int64(n), ptr(indptr, ctypes.c_int64),
                             ptr(indices, ctypes.c_int64), ptr(values, ctypes.c_double),
                             ctypes.byref(handle), ctypes.byref(info))
    if rc == 1:
        raise NotPositiveDefinite(
            f"matrix is not positive definite (breakdown at row {info.value})")
    if rc != 0:
        raise MemoryError(f"native Cholesky failed to allocate (rc {rc}, n = {n})")
    try:
        n_out = ctypes.c_int64()
        lnnz = ctypes.c_int64()
        lib.gko_chol_sizes(handle, ctypes.byref(n_out), ctypes.byref(lnnz))
        col_ptr = np.empty(n + 1, np.int64)
        row_idx = np.empty(max(lnnz.value, 1), np.int64)
        val = np.empty(max(lnnz.value, 1), np.float64)
        lib.gko_chol_fill(handle, ptr(col_ptr, ctypes.c_int64),
                          ptr(row_idx, ctypes.c_int64), ptr(val, ctypes.c_double))
        return col_ptr, row_idx[:lnnz.value], val[:lnnz.value]
    finally:
        lib.gko_chol_free(handle)
