"""Card-only tests of kernel_block's routes (``csrc/kernel_block.cu``): each
route against the plain PyTorch version, K(A, A) on the symmetric route
bitwise its own transpose and bitwise the tile route's K of a copy, one
launch counted a call, and a launch a route does not take raising.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and none of them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_block_cuda.py

Without a card every test skips (decided in the ``cuda_device`` fixture).
Tolerances as tests/test_kernels_pallas.py: f32 rtol 2e-4 / atol 2e-5
scaled by max(1, |ref|max) (summation order differs), bf16 (0.05, 0.02).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.kernels import KERNEL_NAMES  # noqa: E402
from repro_torch.kernels import kernel_block as kb  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = {"f32": (2e-4, 2e-5), "bf16": (0.05, 0.02)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are built with nvcc there)")
    return torch.device("cuda")


def _rows(rng, k, d, device):
    return torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32) / 3).to(device)


#: (m, n, d, b is a) on each route: few columns, few rows (None: the skinny
#: routes' limit, ``kb.skinny_max()``), symmetric (float4 stores; n % 4 !=
#: 0: float stores), tile (the same two)
ROUTE_CASES = [
    (700, 1, 9, False), (700, None, 37, False),
    (1, 900, 9, False), (None, 900, 17, False),
    (260, 260, 9, True), (259, 259, 37, True),
    (300, 516, 16, False), (300, 517, 1, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,d,same", ROUTE_CASES)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_block_routes_match_plain(cuda_device, rng, m, n, d, same, precision):
    m, n = (kb.skinny_max() if k is None else k for k in (m, n))
    a = _rows(rng, m, d, cuda_device)
    b = a if same else _rows(rng, n, d, cuda_device)
    rtol, atol = TOL[precision]
    for kern in KERNEL_NAMES:
        before = kb.kernel_block_cuda.launches
        got = kb.kernel_block_cuda(a, b, kernel=kern, sigma=1.3, precision=precision)
        assert kb.kernel_block_cuda.launches == before + 1
        want = ref.kernel_block(a, b, 1.3, kernel=kern, precision=precision)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=rtol,
                                   atol=atol * max(1.0, float(want.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_symmetric_route_is_bitwise_symmetric(cuda_device, rng, precision):
    a = _rows(rng, 1000, 9, cuda_device)
    assert kb.block_route(1000, 1000, True, kb.skinny_max()) == "symmetric"
    for kern in KERNEL_NAMES:
        k_same = kb.kernel_block_cuda(a, a, kernel=kern, sigma=1.1, precision=precision)
        k_copy = kb.kernel_block_cuda(a, a.clone(), kernel=kern, sigma=1.1, precision=precision)
        assert torch.equal(k_same, k_same.T), kern
        assert torch.equal(k_same, k_copy), kern


@pytest.mark.cuda
def test_cuda_block_route_refusals_raise(cuda_device, rng):
    a = _rows(rng, 100, 9, cuda_device)
    b = a.clone()
    with pytest.raises(RuntimeError, match="CUDA error"):  # symmetric needs b == a
        kb.launch_route(a, b, kernel="rbf", sigma=1.0, route="symmetric")
    wide = _rows(rng, kb.skinny_max() + 1, 9, cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):  # more columns than it takes
        kb.launch_route(a, wide, kernel="rbf", sigma=1.0, route="skinny_cols")
    with pytest.raises(RuntimeError, match="CUDA error"):  # more rows than it takes
        kb.launch_route(wide, a, kernel="rbf", sigma=1.0, route="skinny_rows")

