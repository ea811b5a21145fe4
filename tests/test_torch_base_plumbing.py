"""Base plumbing (slice 10): precision dispatch, accessors, executors,
version info and the precision-reduction types, the port against the JAX
package on the CPU.

- ``precision_dispatch`` and ``precision_dispatch_advanced``: a float32 and
  a float64 operator applied to float32, float64, complex64 and complex128
  vectors; the result's dtype and values equal the JAX package's (within
  the operator's precision: 1e-6 relative for float32, 1e-14 for float64).
- ``ReducedRowMajor`` and ``ScaledReducedRowMajor`` (int8 and int16
  storage, reads and writes) and ``block_col_major``: the JAX package's
  stored values and reads, equal (float32 arithmetic) or within 1e-7.
- ``reduce_precision`` and ``precision_reduction``: the same chains.
- ``Executor``: put, copy_from, run and synchronize on the CPU with their
  events; ``CudaExecutor`` names a CUDA device (``TpuExecutor`` is it);
  ``version_info`` tags what is not built.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ginkgo_tpu_torch as gt
from ginkgo_tpu.base import accessor as jacc
from ginkgo_tpu.base import precision_dispatch as jpd
from ginkgo_tpu.base import types as jtypes
from ginkgo_tpu.base import version as jversion
from ginkgo_tpu_torch import log as plog
from ginkgo_tpu_torch.base import accessor as pacc
from ginkgo_tpu_torch.base import executor as pex
from ginkgo_tpu_torch.base import precision_dispatch as ppd
from ginkgo_tpu_torch.base import types as ptypes
from ginkgo_tpu_torch.base import version as pversion

NP = {"float32": np.float32, "float64": np.float64, "complex64": np.complex64,
      "complex128": np.complex128}


def _mat(op_dtype):
    rng = np.random.default_rng(2)
    return (np.eye(6) * 3 + rng.standard_normal((6, 6)) * 0.3).astype(NP[op_dtype])


@pytest.mark.parametrize("op_dtype", ["float32", "float64"])
@pytest.mark.parametrize("arg_dtype", ["float32", "float64", "complex64", "complex128"])
def test_precision_dispatch_matches_jax(op_dtype, arg_dtype):
    M = _mat(op_dtype)
    rng = np.random.default_rng(3)
    b = rng.standard_normal((6, 2)) + (1j * rng.standard_normal((6, 2))
                                       if arg_dtype.startswith("complex") else 0)
    b = b.astype(NP[arg_dtype])
    x = rng.standard_normal((6, 2)).astype(NP[arg_dtype])
    Mt, Mj = torch.from_numpy(M), jnp.asarray(M)
    seen = []

    def papply(v):
        seen.append(v.dtype)
        return Mt @ v

    got = ppd.precision_dispatch(papply, torch.float32 if op_dtype == "float32"
                                 else torch.float64, torch.from_numpy(b))
    want = jpd.precision_dispatch(lambda v: Mj @ v, jnp.dtype(op_dtype), jnp.asarray(b))
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == arg_dtype
    assert all(d == ptypes.to_torch_dtype(NP[op_dtype]) for d in seen)
    tol = 1e-6 if op_dtype == "float32" or arg_dtype in ("float32", "complex64") else 1e-14
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(
        ppd.precision_dispatch(papply, NP[op_dtype], torch.from_numpy(b[:, 0].copy())).numpy(),
        np.asarray(want)[:, 0], rtol=tol, atol=tol)
    assert ppd.dispatch_dtype(NP[op_dtype], NP[arg_dtype]) == ptypes.to_torch_dtype(NP[op_dtype])
    if not arg_dtype.startswith("complex"):
        got = ppd.precision_dispatch_advanced(
            lambda a, v, be, y: a * (Mt @ v) + be * y, NP[op_dtype], 2.0,
            torch.from_numpy(b), -0.5, torch.from_numpy(x))
        want = jpd.precision_dispatch_advanced(
            lambda a, v, be, y: a * (Mj @ v) + be * y, jnp.dtype(op_dtype), 2.0,
            jnp.asarray(b), -0.5, jnp.asarray(x))
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_precision_reduction_chains_match_jax():
    for t, j in ((torch.float64, np.float64), (torch.float32, np.float32),
                 (torch.complex128, np.complex128)):
        assert str(ptypes.reduce_precision(t)).split(".")[-1] == str(jtypes.reduce_precision(j))
    for pres in ((0, 0), (0, 1), (0, 2), (1, 1)):
        p, j = ptypes.precision_reduction(*pres), jtypes.precision_reduction(*pres)
        assert repr(p) == repr(j) and p == ptypes.precision_reduction(*pres)
        assert str(p.storage_dtype(torch.float64)).split(".")[-1] == str(
            j.storage_dtype(np.float64))
    assert ptypes.precision_reduction.autodetect() == ptypes.precision_reduction(-1, -1)
    assert ptypes.reduce_precision(torch.bfloat16) == torch.bfloat16


def test_reduced_row_major_matches_jax():
    v = np.random.default_rng(4).standard_normal((5, 7)).astype(np.float32)
    p = pacc.ReducedRowMajor.create(torch.from_numpy(v))
    j = jacc.ReducedRowMajor.create(jnp.asarray(v))
    assert p.storage_dtype == torch.bfloat16 and p.shape == tuple(j.shape)
    np.testing.assert_array_equal(p.read().numpy(), np.asarray(j.read()))
    np.testing.assert_array_equal(p.read((1, slice(2, 5))).numpy(),
                                  np.asarray(j.read((1, slice(2, 5)))))
    w = np.linspace(-1, 1, 7).astype(np.float32)
    np.testing.assert_array_equal(p.write(2, torch.from_numpy(w)).read().numpy(),
                                  np.asarray(j.write(2, jnp.asarray(w)).read()))
    p16 = pacc.ReducedRowMajor.create(torch.from_numpy(v.astype(np.float64)),
                                      storage_dtype=torch.float16)
    j16 = jacc.ReducedRowMajor.create(jnp.asarray(v.astype(np.float64)),
                                      storage_dtype=jnp.float16)
    np.testing.assert_array_equal(p16.read().numpy(), np.asarray(j16.read()))


@pytest.mark.parametrize("storage", ["int8", "int16"])
def test_scaled_reduced_row_major_matches_jax(storage):
    v = np.random.default_rng(5).standard_normal((4, 9)).astype(np.float32)
    v[2] = 0.0  # a zero row keeps scale 1
    p = pacc.ScaledReducedRowMajor.create(torch.from_numpy(v), getattr(torch, storage))
    j = jacc.ScaledReducedRowMajor.create(jnp.asarray(v), getattr(jnp, storage))
    np.testing.assert_allclose(p.scale.numpy(), np.asarray(j.scale), rtol=1e-7)
    assert np.abs(p.storage.numpy().astype(int) - np.asarray(j.storage).astype(int)).max() <= 1
    np.testing.assert_allclose(p.read().numpy(), np.asarray(j.read()), rtol=1e-6,
                               atol=float(np.asarray(j.scale).max()) * 1.01)
    np.testing.assert_allclose(p.read().numpy(), v, atol=float(p.scale.max()) * 0.51)
    w = np.full(9, 0.25, np.float32)
    np.testing.assert_allclose(p.write(1, torch.from_numpy(w)).read().numpy()[1],
                               np.asarray(j.write(1, jnp.asarray(w)).read())[1], rtol=1e-6)


def test_block_col_major_matches_jax():
    v = np.arange(35, dtype=np.float64).reshape(7, 5)
    np.testing.assert_array_equal(pacc.block_col_major(torch.from_numpy(v), 3).numpy(),
                                  np.asarray(jacc.block_col_major(jnp.asarray(v), 3)))
    assert torch.equal(pacc.row_major(torch.from_numpy(v)), torch.from_numpy(v))


def test_executors():
    ref = gt.ReferenceExecutor.create()
    rec = plog.Record()
    ref.add_logger(rec)
    A = gt.Dia.from_matrix_data(gt.generators.poisson_2d(4, dtype=np.float32), device="cpu")
    moved = ref.put({"A": A, "b": [torch.ones(16)]})
    assert moved["A"].diags.device.type == "cpu" and moved["b"][0].shape == (16,)
    out = ref.run("zeros", lambda: torch.zeros(3))
    assert out.device.type == "cpu"
    ref.copy_from(ref, torch.ones(2))
    ref.synchronize()
    assert [e.value for e, _ in rec.history] == [
        "allocation_started", "allocation_completed", "operation_launched",
        "operation_completed", "copy_started", "copy_completed"]
    assert ref.get_master() is ref and gt.OmpExecutor is gt.ReferenceExecutor
    cuda = gt.CudaExecutor.create(1)
    assert cuda.device == torch.device("cuda", 1) and gt.TpuExecutor is gt.CudaExecutor
    assert not cuda.memory_accessible(ref) and ref.memory_accessible(gt.ReferenceExecutor())
    assert isinstance(cuda.get_master(), gt.ReferenceExecutor)
    want = gt.CudaExecutor if torch.cuda.is_available() else gt.ReferenceExecutor
    assert isinstance(pex.default_executor(), want)
    with pytest.raises(gt.exceptions.NotImplementedError_):
        pex.Executor().device


def test_version_info(monkeypatch, tmp_path):
    from ginkgo_tpu_torch import _build, _native

    info = pversion.version_info()
    jinfo = jversion.version_info()
    assert str(info.core_version) == str(jinfo.core_version) == "0.1.0"
    assert set(vars(info)) == {"core_version", "kernels_version", "native_version"}
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(_native, "_LIB", [])
    info = pversion.version_info()
    assert str(info.kernels_version) == "0.1.0-not built"
    assert str(info.native_version) == "0.1.0-not built"
    assert not (tmp_path / "kernels").exists() and not (tmp_path / "native").exists()
    monkeypatch.undo()
    _native.load()
    assert str(pversion.version_info().native_version) == "0.1.0"
