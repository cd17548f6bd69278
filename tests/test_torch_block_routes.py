"""kernel_block's routes (``repro_torch.kernels.kernel_block``) on the CPU:
the route picked from the shape and from whether b is a, the operands cast
once when b is a, and the plain version (the CPU path and the card's
oracle) held against the JAX package's ``kernel_block_pallas`` in interpret
mode at the routes' shapes: a column (the RPCholesky pivot), a row (SAP's)
and K(A, A) (the symmetric route).

Inputs are made with numpy from the per-test ``rng`` and cross between the
packages as numpy arrays.  Tolerance as tests/test_kernels_pallas.py: f32
rtol 2e-4 / atol 2e-5 scaled by max(1, |ref|max) (summation order
differs).  The CUDA routes themselves are held against the plain version on
the card (tests/test_torch_block_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.kernel_block import kernel_block_pallas  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import kernel_block as kb  # noqa: E402

F32_TOL = (2e-4, 2e-5)

#: the skinny routes' limit the card's library reports (``kb.skinny_max()``,
#: the source's SK_QMAX); the route choice takes it as an argument
LIMIT = 64


@pytest.mark.parametrize("m,n,same,limit,route", [
    (1_000_000, 1, False, LIMIT, "skinny_cols"),          # RPCholesky's pivot column
    (1000, LIMIT, False, LIMIT, "skinny_cols"),
    (1, 20_000, False, LIMIT, "skinny_rows"),             # SAP's row
    (LIMIT + 1, LIMIT + 1, False, LIMIT, "tile"),
    (50_000, 50_000, True, LIMIT, "symmetric"),           # K_BB: b is a
    (50_000, 50_000, False, 8, "tile"),                   # K_BB of a copy, another limit
])
def test_route_by_shape_and_same(m, n, same, limit, route):
    assert kb.block_route(m, n, same, limit) == route


def test_operands_cast_once_when_b_is_a(rng):
    x = torch.from_numpy(rng.standard_normal((40, 9)).astype(np.float32))
    a, b, same = kb.prepare_operands(x, x, "bf16")
    assert same and b is a and a.dtype == torch.bfloat16
    a, b, same = kb.prepare_operands(x, x[:], "f32")  # the same view of the same memory
    assert same and b is a
    a, b, same = kb.prepare_operands(x, x.clone(), "bf16")
    assert not same and b is not a and torch.equal(a, b)
    assert not kb.prepare_operands(x, x[1:], "f32")[2]


@pytest.mark.parametrize("m,n,kern", [(300, 1, "rbf"), (1, 300, "laplacian"),
                                      (132, 132, "cosine")])
def test_plain_matches_pallas_at_route_shapes(rng, m, n, kern):
    a = rng.standard_normal((m, 9)).astype(np.float32) / 3
    b = a if m == n else rng.standard_normal((n, 9)).astype(np.float32) / 3
    want = np.asarray(kernel_block_pallas(a, b, kernel=kern, sigma=0.9, interpret=True))
    ta = torch.from_numpy(a)
    got = ops.kernel_block(ta, ta if m == n else torch.from_numpy(b), kernel=kern,
                           sigma=0.9).numpy()
    assert got.shape == want.shape == (m, n) and got.dtype == np.float32
    rtol, atol = F32_TOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1.0, float(np.abs(want).max())))
    if m == n:  # K(A, A) of the plain version is symmetric too
        np.testing.assert_allclose(got, got.T, rtol=rtol, atol=atol)
