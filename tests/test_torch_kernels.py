"""The port's kernel ops (``repro_torch.kernels.ops`` on CPU, i.e. the plain
PyTorch versions) held against the JAX package's ``repro.kernels.ops``: the
chunked XLA path and the Pallas kernels in interpret mode.

Inputs are made with numpy from the per-test ``rng`` and cross between the
packages as numpy arrays.  Tolerances are those of tests/test_kernels_pallas.py:
f32 rtol 2e-4 / atol 2e-5 scaled by max(1, |ref|max) (summation order
differs), bf16 (0.05, 0.02) (one bf16 ulp of a kernel value can differ where
the f32 distances round differently).  Interpret-mode cases are kept to one
shape per kernel: interpret mode is slow.  The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.kernels import kernel_diag as j_kernel_diag  # noqa: E402
from repro.core.kernels import kernel_matrix as j_kernel_matrix  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.kernels import KERNEL_NAMES, kernel_diag, kernel_matrix  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.kernel_block import kernel_block_cuda  # noqa: E402
from repro_torch.kernels.kernel_matvec import kernel_matvec_cuda  # noqa: E402

SHAPES = [(7, 13, 1), (32, 64, 3), (129, 257, 2), (256, 300, 4)]
F32_TOL = (2e-4, 2e-5)
BF16_TOL = (0.05, 0.02)


def _tol(ref, rtol, atol):
    return dict(rtol=rtol, atol=atol * max(1.0, float(np.abs(ref).max())))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _port_matvec(a, b, v, **kw):
    return ops.kernel_matvec(_t(a), _t(b), _t(v), **kw).numpy()


def test_kernel_names_match_reference():
    from repro.core.kernels import KERNEL_FAMILIES as J_FAMILIES
    from repro.core.kernels import KERNEL_NAMES as J_NAMES
    from repro_torch.core.kernels import KERNEL_FAMILIES

    assert KERNEL_NAMES == J_NAMES
    assert KERNEL_FAMILIES == J_FAMILIES


@pytest.mark.parametrize("kern", KERNEL_NAMES)
def test_kernel_matrix_and_diag_match(rng, kern):
    x = rng.standard_normal((23, 5)).astype(np.float32)
    y = rng.standard_normal((31, 5)).astype(np.float32)
    x[4] = 0.0  # cosine's zero-norm-as-1 rule
    want = np.asarray(j_kernel_matrix(kern, x, y, 1.3))
    got = kernel_matrix(kern, _t(x), _t(y), 1.3).numpy()
    np.testing.assert_allclose(got, want, **_tol(want, *F32_TOL))
    np.testing.assert_allclose(
        kernel_diag(kern, _t(x), 1.3).numpy(), np.asarray(j_kernel_diag(kern, x, 1.3)),
        rtol=1e-6, atol=1e-6,
    )


@pytest.mark.parametrize("kern", KERNEL_NAMES)
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_matvec_matches_xla(rng, kern, m, n, k):
    d = 11
    a = rng.standard_normal((m, d)).astype(np.float32)
    b = rng.standard_normal((n, d)).astype(np.float32)
    v = rng.standard_normal((n, k)).astype(np.float32)
    want = np.asarray(jops.kernel_matvec(a, b, v, kernel=kern, sigma=1.7, backend="xla",
                                         chunk_a=64, chunk_b=96))
    got = _port_matvec(a, b, v, kernel=kern, sigma=1.7, chunk_a=64, chunk_b=96)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **_tol(want, *F32_TOL))


@pytest.mark.parametrize("kern", KERNEL_NAMES)
@pytest.mark.parametrize("vshape", ["1d", "2d"])
def test_matvec_bf16_matches_xla(rng, kern, vshape):
    a = rng.standard_normal((33, 7)).astype(np.float32)
    b = rng.standard_normal((67, 7)).astype(np.float32)
    v = rng.standard_normal((67,) if vshape == "1d" else (67, 3)).astype(np.float32)
    want = np.asarray(jops.kernel_matvec(a, b, v, kernel=kern, sigma=1.2, backend="xla",
                                         chunk_a=16, chunk_b=32, precision="bf16"))
    got = _port_matvec(a, b, v, kernel=kern, sigma=1.2, chunk_a=16, chunk_b=32,
                       precision="bf16")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **_tol(want, *BF16_TOL))


@pytest.mark.parametrize("kern", KERNEL_NAMES)
def test_matvec_matches_pallas_interpret(rng, kern):
    precision = "f32"  # the bf16 policy is held against the XLA path above
    a = rng.standard_normal((32, 11)).astype(np.float32)
    b = rng.standard_normal((64, 11)).astype(np.float32)
    v = rng.standard_normal((64, 3)).astype(np.float32)
    want = np.asarray(jops.kernel_matvec(a, b, v, kernel=kern, sigma=1.7,
                                         backend="interpret", precision=precision))
    got = _port_matvec(a, b, v, kernel=kern, sigma=1.7, precision=precision)
    np.testing.assert_allclose(got, want, **_tol(want, *F32_TOL))


@pytest.mark.parametrize("kern", KERNEL_NAMES)
@pytest.mark.parametrize("backend,precision", [("xla", "f32"), ("xla", "bf16"), ("interpret", "f32")])
def test_block_matches(rng, kern, backend, precision):
    a = rng.standard_normal((53, 9)).astype(np.float32)
    b = rng.standard_normal((171, 9)).astype(np.float32)
    want = np.asarray(jops.kernel_block(a, b, kernel=kern, sigma=0.9, backend=backend,
                                        precision=precision))
    got = ops.kernel_block(_t(a), _t(b), kernel=kern, sigma=0.9, precision=precision).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **_tol(want, *(F32_TOL if precision == "f32" else BF16_TOL)))


def test_bf16_inputs_accumulate_f32(rng):
    a = rng.standard_normal((33, 8)).astype(np.float32)
    b = rng.standard_normal((65, 8)).astype(np.float32)
    v = rng.standard_normal((65, 2)).astype(np.float32)
    want = np.asarray(jops.kernel_matvec(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), kernel="rbf", sigma=1.3, backend="xla"))
    got = ops.kernel_matvec(_t(a).bfloat16(), _t(b).bfloat16(), _t(v).bfloat16(),
                            kernel="rbf", sigma=1.3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **_tol(want, *F32_TOL))


def test_precision_and_kernel_errors(rng):
    a = _t(rng.standard_normal((4, 3)).astype(np.float32))
    v = _t(rng.standard_normal((4,)).astype(np.float32))
    with pytest.raises(ValueError, match="unknown precision"):
        ops.kernel_matvec(a, a, v, precision="f16")
    with pytest.raises(ValueError, match="unknown precision"):
        ops.kernel_block(a, a, precision="f16")
    with pytest.raises(ValueError, match="unknown kernel"):
        ops.kernel_matvec(a, a, v, kernel="gauss")


def test_sigma_canonicalized(rng):
    a = _t(rng.standard_normal((9, 4)).astype(np.float32))
    b = _t(rng.standard_normal((17, 4)).astype(np.float32))
    v = _t(rng.standard_normal((17,)).astype(np.float32))
    want = ops.kernel_matvec(a, b, v, sigma=2.0)
    for sigma in (2, np.float64(2.0), np.float32(2.0), torch.tensor(2.0), torch.tensor(2.0).bfloat16()):
        got = ops.kernel_matvec(a, b, v, sigma=sigma)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_dispatch_refuses_other_devices(rng):
    """Dispatch goes by the tensor's device: neither operands on mixed
    devices nor a CPU tensor handed to a CUDA wrapper fall back anywhere;
    meta operands (the dry run) compute nothing and get the result's shape."""
    a = _t(rng.standard_normal((5, 3)).astype(np.float32))
    v = _t(rng.standard_normal((5,)).astype(np.float32))
    with pytest.raises(ValueError, match="all be on the CPU, all on CUDA or all on meta"):
        ops.kernel_matvec(a, a.to("meta"), v.to("meta"))
    out = ops.kernel_matvec(a.to("meta"), a.to("meta"), v.to("meta"))
    assert out.device.type == "meta" and out.shape == (5,) and out.dtype == torch.float32
    with pytest.raises(ValueError, match="CUDA device"):
        kernel_matvec_cuda(a, a, v, kernel="rbf", sigma=1.0, precision="f32")
    with pytest.raises(ValueError, match="CUDA device"):
        kernel_block_cuda(a, a, kernel="rbf", sigma=1.0, precision="f32")


def test_build_needs_nvcc_and_sources_only(monkeypatch, tmp_path):
    """The CUDA libraries are built from csrc/ at first use; without nvcc
    the build raises (no prebuilt binary, no download)."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    assert sorted(p.name for p in _build.CSRC.iterdir()) == [
        "kernel_block.cu", "kernel_common.cuh", "kernel_matvec.cu", "kernel_multi.cu",
        "sweep_cols.cuh", "sweep_t1.cuh"]
    for name in ("kernel_matvec", "kernel_block", "kernel_multi"):
        assert _build.lib_path(name) == tmp_path / f"lib{name}.so"
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build([name])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("kernel_multi")  # the multi-kernel wrappers' first call builds it


def test_every_kernel_module_imports_first():
    """Each CUDA wrapper module (and ``ops``, and the serving modules) can
    be the first ``repro_torch`` module a process imports: the wrappers
    must not import ``repro_torch.core``, whose package imports the
    operators, which import the wrappers (a tool that imported
    ``kernel_block`` first failed on this cycle)."""
    import pathlib
    import subprocess
    import sys

    mods = ["repro_torch.kernels.kernel_block", "repro_torch.kernels.kernel_matvec",
            "repro_torch.kernels.multi", "repro_torch.kernels.ops",
            "repro_torch.serving.engine", "repro_torch.launch.krr_serve"]
    code = (
        "import importlib, sys, torch\n"
        f"for m in {mods!r}:\n"
        "    for k in [k for k in sys.modules if k.startswith('repro_torch')]:\n"
        "        del sys.modules[k]\n"
        "    importlib.import_module(m)\n"
    )
    src = pathlib.Path(__file__).resolve().parent.parent / "src"
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env={**__import__("os").environ, "PYTHONPATH": str(src)})
    assert proc.returncode == 0, proc.stderr[-2000:]
