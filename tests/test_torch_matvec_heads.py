"""``kernel_matvec`` with t heads (2 <= t <= 16) at serving-bucket rows: the
port's ``ops.kernel_matvec`` on the CPU (its plain version) against the JAX
package's ``kernel_matvec_pallas`` in interpret mode.

These are the shapes the multi-column sweep of ``csrc/kernel_matvec.cu``
serves on the card (m in {1, 8, 64} queries, n = 1,103 rows, t in {2, 5, 8,
10, 16}); the sweep itself is held against the same plain version there
(tests/test_torch_cuda.py, chip_smoke.py).  The rows and columns of
K(A, B) V are independent, so each JAX reference is computed once, at 64
rows and 16 columns, and each (m, t) case is held against its first m rows
and t columns; interpret mode is slow.
Tolerances are those of tests/test_kernels_pallas.py: f32 rtol 2e-4 / atol
2e-5 scaled by max(1, |ref|max) (summation order differs), bf16 (0.05,
0.02) (one bf16 ulp of a kernel value can differ where the f32 distances
round differently).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.kernel_matvec import kernel_matvec_pallas  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

N, D, SIGMA = 1103, 9, 1.3
HEADS_M = (1, 8, 64)
HEADS_T = (2, 5, 8, 10, 16)
TOL = {"f32": (2e-4, 2e-5), "bf16": (0.05, 0.02)}


@functools.lru_cache(maxsize=None)
def _operands():
    rng = np.random.default_rng(25)
    a = (rng.standard_normal((max(HEADS_M), D)) / 3).astype(np.float32)
    a[3] = 0.0  # cosine's zero-norm-as-1 rule
    b = (rng.standard_normal((N, D)) / 3).astype(np.float32)
    v = rng.standard_normal((N, max(HEADS_T))).astype(np.float32)
    return a, b, v


@functools.lru_cache(maxsize=None)
def _reference(kern: str, precision: str) -> np.ndarray:
    a, b, v = _operands()
    return np.asarray(kernel_matvec_pallas(a, b, v, kernel=kern, sigma=SIGMA, interpret=True,
                                           precision=precision))


@pytest.mark.parametrize("t", HEADS_T)
@pytest.mark.parametrize("m", HEADS_M)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("kern", ["rbf", "laplacian", "cosine"])
def test_heads_match_pallas_interpret(kern, precision, m, t):
    a, b, v = _operands()
    want = _reference(kern, precision)[:m, :t]
    got = ops.kernel_matvec(torch.from_numpy(a[:m]), torch.from_numpy(b),
                            torch.from_numpy(np.ascontiguousarray(v[:, :t])), kernel=kern,
                            sigma=SIGMA, precision=precision).numpy()
    assert got.dtype == np.float32 and got.shape == (m, t)
    rtol, atol = TOL[precision]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("t", HEADS_T)
@pytest.mark.parametrize("m", HEADS_M)
def test_heads_meta_shape(m, t):
    """The dry run's meta route gives the (m, t) result the sweep writes."""
    out = ops.kernel_matvec(torch.empty((m, D), device="meta"), torch.empty((N, D), device="meta"),
                            torch.empty((N, t), device="meta"))
    assert out.device.type == "meta" and out.shape == (m, t) and out.dtype == torch.float32
