"""Card-only tests of the multi-column sweeps at their new widths:
``kernel_matvec`` at 17 <= t <= 32 (``csrc/kernel_matvec.cu``, widths 20,
24 and 32) and the weighted matvec's heads at 2 <= t <= 16 with static
weights (``csrc/kernel_multi.cu``), each against its plain PyTorch version
on the split route's edges of m and n, a row bitwise the same in buckets of
8, 64 and 1024 rows, and one launch counted a call.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and none of them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_heads_cuda.py

Without a card every test skips (decided in the ``cuda_device`` fixture).
Tolerances as tests/test_kernels_pallas.py: f32 rtol 2e-4 / atol 2e-5
scaled by max(1, |ref|max) (summation order differs), bf16 (0.05, 0.02).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.kernels import KERNEL_NAMES  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import multi as mk  # noqa: E402
from repro_torch.kernels.kernel_matvec import (  # noqa: E402
    kernel_matvec_cuda,
    sweep_t_max,
    t1_splits,
)

TOL = {"f32": (2e-4, 2e-5), "bf16": (0.05, 0.02)}

#: kernel_matvec's width edges: the last of the 16-column sweep, each new
#: width (20, 24, 32) at it and one above the width below, and the first t
#: of the column path
WIDE_T = (16, 17, 20, 21, 24, 25, 32, 33)
#: the weighted heads: widths 2, 4, 12 and 16 at or below their edge, and
#: the first t of the column path
WEIGHTED_T = (2, 3, 10, 16, 17)
#: the combinations held: the l2 + l1 families (the refit's) and dot + cos;
#: 9 kernels, above the per-launch cap, in two accumulating launches
CASES = {
    "l2+l1": (("rbf", "laplacian", "matern52"), (1.5, 0.8, 2.2)),
    "dot+cos": (("linear", "polynomial", "sigmoid", "cosine"), (1.5, 1.1, 2.0, 1.0)),
    "q9": (("rbf", "laplacian", "matern52", "linear", "polynomial", "sigmoid", "cosine",
            "rbf", "laplacian"), (1.5, 0.8, 2.2, 1.5, 1.1, 2.0, 1.0, 0.6, 3.0)),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are built with nvcc there)")
    return torch.device("cuda")


def _rows(rng, k, d, device):
    return torch.from_numpy((rng.standard_normal((k, d)) / np.sqrt(d)).astype(np.float32)).to(device)


def _split_ns(d):
    """n below one staged tile (no split), at a multiple of it (40 tiles)
    and one either side: 256 rows a tile up to d = 16, 64 above."""
    tile = 256 if d <= 16 else 64
    return {"below": tile - 1, "multiple": 40 * tile, "minus1": 40 * tile - 1,
            "plus1": 40 * tile + 1}


def _assert_close(got, want, precision):
    rtol, atol = TOL[precision]
    want = want.cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())))


@pytest.mark.cuda
def test_cuda_sweep_limits(cuda_device):
    """The libraries' limits: kernel_matvec sweeps up to 32 columns, the
    weighted heads up to 16, and the route function follows them."""
    assert sweep_t_max() == 32 and mk.heads_t_max() == 16
    assert mk.matvec_multi_route(16, False, mk.heads_t_max()) == "heads"
    assert mk.matvec_multi_route(17, False, mk.heads_t_max()) == "cols"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [9, 37])
@pytest.mark.parametrize("edge", ["below", "multiple", "minus1", "plus1"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_wide_sweep_edges_match_plain(cuda_device, rng, d, edge, precision):
    """kernel_matvec at WIDE_T (every kernel) on the split route's edges of
    m and n and above it (m = 4097: one range), against the plain version;
    one launch a call."""
    n = _split_ns(d)[edge]
    assert (t1_splits(_build.load("kernel_matvec"), 8, n, d) > 1) == (edge != "below")
    b = _rows(rng, n, d, cuda_device)
    v = torch.from_numpy(rng.standard_normal((n, max(WIDE_T))).astype(np.float32)).to(cuda_device)
    for m in (1, 8, 64, 65, 4097):
        a = _rows(rng, m, d, cuda_device)
        for t in WIDE_T:
            vt = v[:, :t].contiguous()
            for kern in KERNEL_NAMES:
                before = kernel_matvec_cuda.launches
                got = kernel_matvec_cuda(a, b, vt, kernel=kern, sigma=1.3, precision=precision)
                assert kernel_matvec_cuda.launches == before + 1 and got.shape == (m, t)
                _assert_close(got, ref.kernel_matvec(a, b, vt, 1.3, kernel=kern,
                                                     precision=precision), precision)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [9, 16, 17, 37])
@pytest.mark.parametrize("edge", ["below", "multiple", "minus1", "plus1"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_weighted_heads_edges_match_plain(cuda_device, rng, d, edge, precision):
    """The weighted matvec with (q,) weights at WEIGHTED_T (every CASES
    combination) on the split route's edges of m and n and above it,
    against the plain version; one launch a call up to 8 kernels, two for
    9 (the second accumulates)."""
    n = _split_ns(d)[edge]
    b = _rows(rng, n, d, cuda_device)
    v = torch.from_numpy(rng.standard_normal((n, max(WEIGHTED_T))).astype(np.float32)).to(cuda_device)
    for m in (1, 8, 64, 65, 4097):
        a = _rows(rng, m, d, cuda_device)
        for t in WEIGHTED_T:
            vt = v[:, :t].contiguous()
            for kernels, sigmas in CASES.values():
                w = tuple(float(x) for x in rng.dirichlet(np.ones(len(kernels))))
                before = mk.kernel_matvec_multi_cuda.launches
                got = mk.kernel_matvec_multi_cuda(a, b, vt, w, kernels=kernels, sigmas=sigmas,
                                                  precision=precision)
                assert mk.kernel_matvec_multi_cuda.launches == before + -(-len(kernels) // mk.QMAX)
                assert got.shape == (m, t)
                want = ref.kernel_matvec_multi(a, b, vt, sigmas, torch.tensor(w, device=cuda_device),
                                               kernels=kernels, precision=precision)
                _assert_close(got, want, precision)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_wide_and_weighted_heads_rows_bitwise_in_every_bucket(cuda_device, rng, precision):
    """The same 8 rows in buckets of 8, 64 and 1024 rows, at other positions
    and with other rows beside them, score bitwise the same: kernel_matvec
    at t = 20 and 32, and the weighted heads at t = 10 (the split is set
    by n alone up to 4096 rows)."""
    n, d = 100_000, 9
    b = _rows(rng, n, d, cuda_device)
    v = torch.from_numpy(rng.standard_normal((n, 32)).astype(np.float32)).to(cuda_device)
    rows = _rows(rng, 8, d, cuda_device)
    kernels, sigmas = CASES["l2+l1"]
    fns = [lambda a, t=t: kernel_matvec_cuda(a, b, v[:, :t].contiguous(), kernel="rbf", sigma=1.0,
                                             precision=precision) for t in (20, 32)]
    fns.append(lambda a: mk.kernel_matvec_multi_cuda(a, b, v[:, :10].contiguous(), (0.5, 0.2, 0.3),
                                                     kernels=kernels, sigmas=sigmas,
                                                     precision=precision))
    for fn in fns:
        base = fn(rows)
        for bucket, at in ((64, 37), (1024, 1000), (1024, 0)):
            a = _rows(rng, bucket, d, cuda_device)
            a[at:at + 8] = rows
            assert torch.equal(fn(a)[at:at + 8], base)
