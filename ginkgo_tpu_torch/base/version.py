"""Version info per module.

Counterpart of ``ginkgo_tpu/base/version.py`` (reference
core/base/version.cpp, ``version_info::get()``: one version per compiled
backend module).  The modules here are the Python core, the CUDA kernel
libraries of ``csrc/`` (in place of the JAX package's Pallas kernel set)
and the host C++ Cholesky library; a module whose libraries are not built
for the current sources carries the tag "not built".  Nothing is compiled
to answer.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class version:
    major: int
    minor: int
    patch: int
    tag: str = ""

    def __str__(self):
        s = f"{self.major}.{self.minor}.{self.patch}"
        return f"{s}-{self.tag}" if self.tag else s


_CORE = version(0, 1, 0)


@dataclass(frozen=True)
class version_info_t:
    core_version: version
    kernels_version: version
    native_version: version


def version_info() -> version_info_t:
    """version_info::get() analog."""
    from .. import _build, _native

    kernels_tag = "" if all(_build.is_built(k) for k in _build.KERNELS) else "not built"
    native_tag = "" if _native.is_built() else "not built"
    return version_info_t(
        core_version=_CORE,
        kernels_version=version(0, 1, 0, kernels_tag),
        native_version=version(0, 1, 0, native_tag),
    )
