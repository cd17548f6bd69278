"""Card-only tests of the port: the hand-written CUDA kernels against their
plain PyTorch versions, one ASkotch step on the card against the same step
on the CPU, a multi-kernel operator whose every primitive launches the
multi-kernel CUDA kernels, the baselines, the estimators and the SAP steps
on the card against the CPU, a telemetry-enabled solve, the t = 1 sweep
and the multi-column sweep (2 <= t <= 16) split over n (their edges, and
a row bitwise the same in every serving bucket), the serving engine on the card against the engine on the CPU, and
the distributed tier on meshes of cuda:0 against the same meshes of CPU
devices, every reduced LM architecture (loss, prefill, decode, greedy
tokens, a decode at a clamped position, the serving launcher) on the card
against the CPU, and LM training (each reduced architecture's train step on
the card against the CPU, the checkpointer, the data pipeline and the
launcher's fault drill on the card).

This file imports neither JAX nor the JAX package nor scikit-learn, so it
runs on a machine with a card and none of them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test skips (decided in the ``cuda_device`` fixture).
Kernel tolerances are those of tests/test_kernels_pallas.py: f32 rtol 2e-4 /
atol 2e-5 scaled by max(1, |ref|max) (summation order differs), bf16
(0.05, 0.02) (one bf16 ulp of a kernel value can differ where the f32
distances round differently).
"""

import contextlib
import dataclasses
import json
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import askotch  # noqa: E402
from repro_torch.core.kernels import KERNEL_NAMES  # noqa: E402
from repro_torch.core.krr import KRRProblem  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.core.multikernel import WeightedSumKernelOperator  # noqa: E402
from repro_torch.kernels.kernel_block import kernel_block_cuda  # noqa: E402
from repro_torch.kernels.kernel_matvec import kernel_matvec_cuda  # noqa: E402
from repro_torch.kernels.multi import (  # noqa: E402
    QMAX,
    QMAX_COMPONENTS,
    kernel_block_multi_cuda,
    kernel_matvec_components_cuda,
    kernel_matvec_multi_cuda,
)

F32_TOL = (2e-4, 2e-5)
BF16_TOL = (0.05, 0.02)


def _tol(ref, rtol, atol):
    return dict(rtol=rtol, atol=atol * max(1.0, float(np.abs(ref).max())))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are built with nvcc there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kern", KERNEL_NAMES)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_kernels_match_plain(cuda_device, rng, kern, precision):
    a = _t(rng.standard_normal((130, 37)).astype(np.float32) / 6).to(cuda_device)
    b = _t(rng.standard_normal((301, 37)).astype(np.float32) / 6).to(cuda_device)
    v = _t(rng.standard_normal((301, 5)).astype(np.float32)).to(cuda_device)
    tol = F32_TOL if precision == "f32" else BF16_TOL
    before = kernel_matvec_cuda.launches, kernel_block_cuda.launches
    got = ops.kernel_matvec(a, b, v, kernel=kern, sigma=1.4, precision=precision)
    blk = ops.kernel_block(a, b, kernel=kern, sigma=1.4, precision=precision)
    torch.cuda.synchronize()
    want = ops.ref.kernel_matvec(a, b, v, 1.4, kernel=kern, precision=precision).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, **_tol(want, *tol))
    want = ops.ref.kernel_block(a, b, 1.4, kernel=kern, precision=precision).cpu().numpy()
    np.testing.assert_allclose(blk.cpu().numpy(), want, **_tol(want, *tol))
    assert (kernel_matvec_cuda.launches, kernel_block_cuda.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_f64(cuda_device):
    a = torch.zeros((4, 3), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.kernel_matvec(a, a, a[:, 0])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.kernel_block(a, a)


@pytest.mark.cuda
def test_cuda_empty_outputs_launch_nothing(cuda_device):
    a = torch.zeros((0, 3), device=cuda_device)
    b = torch.ones((5, 3), device=cuda_device)
    before = kernel_matvec_cuda.launches, kernel_block_cuda.launches
    assert ops.kernel_matvec(a, b, b[:, 0]).shape == (0,)
    assert ops.kernel_block(a, b).shape == (0, 5)
    assert ops.kernel_block(b, a).shape == (5, 0)
    assert (kernel_matvec_cuda.launches, kernel_block_cuda.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 3])
def test_cuda_step_matches_cpu_step(cuda_device, rng, t):
    """One ASkotch step with the same injected draws on the card (the CUDA
    kernels, cuBLAS / cuSOLVER) and on the CPU (the plain versions, LAPACK):
    w, v, z and step_L agree to rtol 1e-3 (atol 1e-4 x magnitude); the
    kernels' sums run in another order and the factorizations differ."""
    n, d, b, r = 2000, 6, 256, 32
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.standard_normal((n,) if t == 1 else (n, t)).astype(np.float32)
    idx = rng.permutation(n)[:b]
    omega = rng.standard_normal((b, r)).astype(np.float32)
    probe = rng.standard_normal((b, 1)).astype(np.float32)
    cfg = askotch.ASkotchConfig(block_size=b, rank=r)
    out = {}
    for dev in ("cpu", cuda_device):
        prob = KRRProblem(x=_t(x).to(dev), y=_t(y).to(dev), lam_unscaled=1e-4)
        step = askotch.make_step(prob, cfg)
        state, aux = step(askotch.init_state(prob, seed=0), idx=_t(idx).to(dev),
                          omega=_t(omega).to(dev), probe=_t(probe).to(dev))
        out[str(dev)] = [s.cpu().numpy() for s in (state.w, state.v, state.z, aux.step_l)]
    for got, want in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(got, want, **_tol(want, 1e-3, 1e-4))


#: (kernels, sigmas): l2 + l1, dot + cos, one kernel twice, and q = 9 —
#: above both per-launch caps, so the wrapper splits it into groups
MULTI_CASES = {
    "l2+l1": (("rbf", "laplacian", "matern52"), (1.5, 0.8, 2.2)),
    "dot+cos": (("linear", "polynomial", "sigmoid", "cosine"), (1.5, 1.1, 2.0, 1.0)),
    "rbf-twice": (("rbf", "rbf"), (0.5, 2.0)),
    "q9": (("rbf", "laplacian", "matern52", "linear", "polynomial", "sigmoid", "cosine",
            "rbf", "laplacian"), (1.5, 0.8, 2.2, 1.5, 1.1, 2.0, 1.0, 0.6, 3.0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MULTI_CASES))
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_multi_kernels_match_plain(cuda_device, rng, case, precision):
    """The three multi-kernel kernels against their plain versions at a
    ragged n (301) and d (37), with (q,) and per-column (q, t) weights; the
    launch counts grow by one per group of at most QMAX (QMAX_COMPONENTS)."""
    kernels, sigmas = MULTI_CASES[case]
    q = len(kernels)
    a = _t(rng.standard_normal((130, 37)).astype(np.float32) / 6).to(cuda_device)
    b = _t(rng.standard_normal((301, 37)).astype(np.float32) / 6).to(cuda_device)
    v = _t(rng.standard_normal((301, 5)).astype(np.float32)).to(cuda_device)
    w = tuple(float(x) for x in rng.dirichlet(np.ones(q)))
    wc = _t(rng.dirichlet(np.ones(q), size=5).T.astype(np.float32)).to(cuda_device)
    tol = F32_TOL if precision == "f32" else BF16_TOL
    kw = dict(kernels=kernels, sigmas=sigmas, precision=precision)
    before = ops.launches()
    got = [
        ops.kernel_matvec_multi(a, b, v[:, 0], weights=w, **kw),
        ops.kernel_matvec_multi(a, b, v, weights=wc, **kw),
        ops.kernel_matvec_components(a, b, v, **kw),
        ops.kernel_block_multi(a, b, weights=w, **kw),
    ]
    torch.cuda.synchronize()
    after = ops.launches()
    want = [
        ops.ref.kernel_matvec_multi(a, b, v[:, 0], sigmas, torch.tensor(w, device=cuda_device),
                                    kernels=kernels, precision=precision),
        ops.ref.kernel_matvec_multi(a, b, v, sigmas, wc, kernels=kernels, precision=precision),
        ops.ref.kernel_matvec_components(a, b, v, sigmas, kernels=kernels, precision=precision),
        ops.ref.kernel_block_multi(a, b, sigmas, w, kernels=kernels, precision=precision),
    ]
    for g, wnt in zip(got, want):
        wnt = wnt.cpu().numpy()
        np.testing.assert_allclose(g.cpu().numpy(), wnt, **_tol(wnt, *tol))
    groups, groups_c = -(-q // QMAX), -(-q // QMAX_COMPONENTS)
    assert after["kernel_matvec_multi"] - before["kernel_matvec_multi"] == 2 * groups
    assert after["kernel_matvec_components"] - before["kernel_matvec_components"] == groups_c
    assert after["kernel_block_multi"] - before["kernel_block_multi"] == groups


@pytest.mark.cuda
@pytest.mark.parametrize("t", [2, 150, 160, 161])
@pytest.mark.parametrize("per_column", [False, True])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_weighted_matvec_columns_match_plain(cuda_device, rng, t, per_column, precision):
    """The weighted matvec's column path (t > 1) against its plain version
    at ragged m (70), n (301) and d (11): t = 2 (one 128-column block),
    t = 150 (one ragged 160-column block), t = 160 (the tune's width, one
    full 160-column block) and t = 161 (two 128-column blocks of 84 and 77
    columns), with (q,) or per-column (q, t) weights; one launch."""
    kernels, sigmas = MULTI_CASES["l2+l1"]
    q = len(kernels)
    a = _t(rng.standard_normal((70, 11)).astype(np.float32) / 3).to(cuda_device)
    b = _t(rng.standard_normal((301, 11)).astype(np.float32) / 3).to(cuda_device)
    v = _t(rng.standard_normal((301, t)).astype(np.float32)).to(cuda_device)
    w_cols = _t(rng.dirichlet(np.ones(q), size=t).T.astype(np.float32)).to(cuda_device)
    w = w_cols if per_column else tuple(float(x) for x in rng.dirichlet(np.ones(q)))
    before = kernel_matvec_multi_cuda.launches
    got = kernel_matvec_multi_cuda(a, b, v, w, kernels=kernels, sigmas=sigmas, precision=precision)
    torch.cuda.synchronize()
    assert kernel_matvec_multi_cuda.launches == before + 1
    w_ref = w_cols if per_column else torch.tensor(w, device=cuda_device)
    want = ops.ref.kernel_matvec_multi(a, b, v, sigmas, w_ref, kernels=kernels,
                                       precision=precision).cpu().numpy()
    assert got.shape == (70, t)
    tol = F32_TOL if precision == "f32" else BF16_TOL
    np.testing.assert_allclose(got.cpu().numpy(), want, **_tol(want, *tol))


@pytest.mark.cuda
def test_cuda_weighted_operator_launches_its_kernels(cuda_device, rng):
    """A kernel tuple on CUDA tensors runs every operator primitive through
    the multi-kernel CUDA kernels (and never through the single-kernel ones)."""
    x = _t(rng.standard_normal((500, 9)).astype(np.float32)).to(cuda_device)
    v = _t(rng.standard_normal((500, 4)).astype(np.float32)).to(cuda_device)
    wc = _t(rng.dirichlet(np.ones(3), size=4).T.astype(np.float32)).to(cuda_device)
    op = WeightedSumKernelOperator(x=x, kernels=("rbf", "laplacian", "matern52"),
                                   weights=(0.5, 0.2, 0.3))
    ops.reset_launches()
    out = [op.matvec(v), op.block_idx(torch.arange(64, device=cuda_device)),
           op.matvec_cols(v, wc), op.sketch_components(v)]
    torch.cuda.synchronize()
    assert all(o.device.type == "cuda" for o in out)
    assert ops.launches() == {"kernel_matvec": 0, "kernel_block": 0, "kernel_matvec_multi": 2,
                              "kernel_matvec_components": 1, "kernel_block_multi": 1}
    cpu = op.with_points(x.cpu())
    want = cpu.matvec(v.cpu()).numpy()
    np.testing.assert_allclose(out[0].cpu().numpy(), want, **_tol(want, *F32_TOL))


#: (d, n) edges of the t = 1 sweep: d = 1, the register cap (16) and one
#: above it (the slab loop over d), and n below one staged B tile and one
#: past a multiple of it (256 rows a tile up to the cap, 64 above it)
T1_EDGES = [(1, 301), (16, 301), (17, 301), (9, 100), (9, 257), (37, 50), (37, 65)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", T1_EDGES)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_t1_sweep_edges_match_plain(cuda_device, rng, d, n, precision):
    """The t = 1 sweep of kernel_matvec (every kernel) and of the weighted
    matvec (every combination of MULTI_CASES) at its edges of d and n,
    against the plain versions, one launch a call (a group for q = 9)."""
    a = _t((rng.standard_normal((130, d)) / np.sqrt(d)).astype(np.float32)).to(cuda_device)
    b = _t((rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)).to(cuda_device)
    v = _t(rng.standard_normal((n,)).astype(np.float32)).to(cuda_device)
    tol = F32_TOL if precision == "f32" else BF16_TOL
    for kern in KERNEL_NAMES:
        got = kernel_matvec_cuda(a, b, v, kernel=kern, sigma=1.3, precision=precision)
        want = ops.ref.kernel_matvec(a, b, v, 1.3, kernel=kern, precision=precision).cpu().numpy()
        np.testing.assert_allclose(got.cpu().numpy(), want, **_tol(want, *tol))
    for kernels, sigmas in MULTI_CASES.values():
        w = tuple(float(x) for x in rng.dirichlet(np.ones(len(kernels))))
        got = kernel_matvec_multi_cuda(a, b, v, w, kernels=kernels, sigmas=sigmas,
                                       precision=precision)
        want = ops.ref.kernel_matvec_multi(a, b, v, sigmas, torch.tensor(w, device=cuda_device),
                                           kernels=kernels, precision=precision).cpu().numpy()
        np.testing.assert_allclose(got.cpu().numpy(), want, **_tol(want, *tol))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MULTI_CASES))
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_weighted_matvec_t1_weight_column_matches_plain(cuda_device, rng, case, precision):
    """The weighted matvec at t = 1 with a device (q, 1) weight column and
    v of shape (n, 1): the device-weight branch of the t = 1 launcher."""
    kernels, sigmas = MULTI_CASES[case]
    q = len(kernels)
    a = _t(rng.standard_normal((130, 9)).astype(np.float32) / 3).to(cuda_device)
    b = _t(rng.standard_normal((301, 9)).astype(np.float32) / 3).to(cuda_device)
    v = _t(rng.standard_normal((301, 1)).astype(np.float32)).to(cuda_device)
    w = _t(rng.dirichlet(np.ones(q))[:, None].astype(np.float32)).to(cuda_device)
    got = kernel_matvec_multi_cuda(a, b, v, w, kernels=kernels, sigmas=sigmas, precision=precision)
    want = ops.ref.kernel_matvec_multi(a, b, v, sigmas, w, kernels=kernels,
                                       precision=precision).cpu().numpy()
    assert got.shape == (130, 1)
    tol = F32_TOL if precision == "f32" else BF16_TOL
    np.testing.assert_allclose(got.cpu().numpy(), want, **_tol(want, *tol))


@pytest.mark.cuda
def test_cuda_t1_sweep_is_deterministic(cuda_device, rng):
    """Two launches of each t = 1 kernel on the same inputs are bitwise
    equal (no atomics; the warps' row sums are added in a fixed order)."""
    a = _t(rng.standard_normal((3000, 9)).astype(np.float32)).to(cuda_device)
    b = _t(rng.standard_normal((50_000, 9)).astype(np.float32)).to(cuda_device)
    v = _t(rng.standard_normal((50_000,)).astype(np.float32)).to(cuda_device)
    kernels, sigmas = MULTI_CASES["l2+l1"]
    for fn in (lambda: kernel_matvec_cuda(a, b, v, kernel="rbf", sigma=1.0, precision="f32"),
               lambda: kernel_matvec_multi_cuda(a, b, v, (0.5, 0.2, 0.3), kernels=kernels,
                                                sigmas=sigmas, precision="f32")):
        assert torch.equal(fn(), fn())


#: the stacked matvec's combinations by q: l1 alone, l2 + l1, dot + cos (one
#: full launch of QMAX_COMPONENTS) and five kernels (two launches)
STACKED_CASES = {
    1: (("laplacian",), (0.8,)),
    3: MULTI_CASES["l2+l1"],
    4: MULTI_CASES["dot+cos"],
    5: (("rbf", "laplacian", "matern52", "cosine", "rbf"), (1.5, 0.8, 2.2, 1.0, 0.6)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("t", [2, 100, 101, 161])
@pytest.mark.parametrize("q", sorted(STACKED_CASES))
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_stacked_matvec_columns_match_plain(cuda_device, rng, t, q, precision):
    """The stacked matvec on the column path (grid.z over the kernels) at
    ragged m (70), n (301) and d (11): t = 2, the tune's rank 100, a ragged
    101 and 161 (two column blocks); one launch per QMAX_COMPONENTS kernels."""
    kernels, sigmas = STACKED_CASES[q]
    a = _t(rng.standard_normal((70, 11)).astype(np.float32) / 3).to(cuda_device)
    b = _t(rng.standard_normal((301, 11)).astype(np.float32) / 3).to(cuda_device)
    v = _t(rng.standard_normal((301, t)).astype(np.float32)).to(cuda_device)
    before = kernel_matvec_components_cuda.launches
    got = kernel_matvec_components_cuda(a, b, v, kernels=kernels, sigmas=sigmas,
                                        precision=precision)
    torch.cuda.synchronize()
    assert kernel_matvec_components_cuda.launches == before + -(-q // QMAX_COMPONENTS)
    want = ops.ref.kernel_matvec_components(a, b, v, sigmas, kernels=kernels,
                                            precision=precision).cpu().numpy()
    assert got.shape == (q, 70, t)
    tol = F32_TOL if precision == "f32" else BF16_TOL
    np.testing.assert_allclose(got.cpu().numpy(), want, **_tol(want, *tol))


#: (d, m, n) edges of the weighted block: n % 4 == 0 with a ragged last
#: 128-column strip (float4 stores), m and n below one 64 x 128 warp tile,
#: d = 1, the register cap 16, one above it (the slab loop) and 37
BLOCK_EDGES = [(9, 130, 300), (9, 37, 50), (1, 200, 129), (16, 70, 260), (17, 65, 131),
               (37, 130, 301)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,m,n", BLOCK_EDGES)
@pytest.mark.parametrize("case", sorted(MULTI_CASES))
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_weighted_block_edges_match_plain(cuda_device, rng, d, m, n, case, precision):
    """The weighted block at its edges against the plain version, one launch
    per QMAX kernels (q = 9: the second launch accumulates)."""
    kernels, sigmas = MULTI_CASES[case]
    a = _t((rng.standard_normal((m, d)) / np.sqrt(d)).astype(np.float32)).to(cuda_device)
    b = _t((rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)).to(cuda_device)
    w = tuple(float(x) for x in rng.dirichlet(np.ones(len(kernels))))
    before = kernel_block_multi_cuda.launches
    got = kernel_block_multi_cuda(a, b, kernels=kernels, sigmas=sigmas, weights=w,
                                  precision=precision)
    torch.cuda.synchronize()
    assert kernel_block_multi_cuda.launches == before + -(-len(kernels) // QMAX)
    want = ops.ref.kernel_block_multi(a, b, sigmas, w, kernels=kernels,
                                      precision=precision).cpu().numpy()
    tol = F32_TOL if precision == "f32" else BF16_TOL
    np.testing.assert_allclose(got.cpu().numpy(), want, **_tol(want, *tol))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [132, 300])
@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_weighted_block_of_one_point_set(cuda_device, rng, m, same, precision):
    """K_w(a, a) with b the same tensor as a (the symmetric path: packed
    once, the tiles above the diagonal also written transposed; q = 9, so
    the second launch accumulates) and with b a copy of a (the full path)
    agree with the plain version."""
    kernels, sigmas = MULTI_CASES["q9"]
    a = _t(rng.standard_normal((m, 9)).astype(np.float32) / 3).to(cuda_device)
    w = tuple(float(x) for x in rng.dirichlet(np.ones(len(kernels))))
    got = kernel_block_multi_cuda(a, a if same else a.clone(), kernels=kernels, sigmas=sigmas,
                                  weights=w, precision=precision)
    want = ops.ref.kernel_block_multi(a, a.clone(), sigmas, w, kernels=kernels,
                                      precision=precision).cpu().numpy()
    tol = F32_TOL if precision == "f32" else BF16_TOL
    np.testing.assert_allclose(got.cpu().numpy(), want, **_tol(want, *tol))


@pytest.mark.cuda
def test_cuda_block_and_stacked_matvec_are_deterministic(cuda_device, rng):
    """Two launches of the weighted block and of the stacked matvec on the
    same inputs are bitwise equal (no atomics; a thread owns whole values)."""
    x = _t(rng.standard_normal((3000, 9)).astype(np.float32)).to(cuda_device)
    v = _t(rng.standard_normal((3000, 100)).astype(np.float32)).to(cuda_device)
    kernels, sigmas = MULTI_CASES["l2+l1"]
    for fn in (lambda: kernel_block_multi_cuda(x, x, kernels=kernels, sigmas=sigmas,
                                               weights=(0.5, 0.2, 0.3), precision="f32"),
               lambda: kernel_matvec_components_cuda(x, x, v, kernels=kernels, sigmas=sigmas,
                                                     precision="f32")):
        assert torch.equal(fn(), fn())


# ---------------------------------------------------------------------------
# the baseline solvers' shapes and solves
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(300, 1), (1, 300), (1000, 1), (1, 1)])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_block_single_row_or_column(cuda_device, rng, m, n, precision):
    """kernel_block at (m, 1) (an RPCholesky pivot column) and (1, n): one
    live column or row of a tile, no float4 store."""
    a = _t(rng.standard_normal((m, 9)).astype(np.float32) / 3).to(cuda_device)
    b = _t(rng.standard_normal((n, 9)).astype(np.float32) / 3).to(cuda_device)
    tol = F32_TOL if precision == "f32" else BF16_TOL
    for kern in ("rbf", "laplacian", "cosine"):
        got = kernel_block_cuda(a, b, kernel=kern, sigma=1.2, precision=precision)
        torch.cuda.synchronize()
        want = ops.ref.kernel_block(a, b, 1.2, kernel=kern, precision=precision).cpu().numpy()
        assert got.shape == (m, n)
        np.testing.assert_allclose(got.cpu().numpy(), want, **_tol(want, *tol))


#: kernel_matvec's widths t > 1: 2, 3, 8, 9 and 10 on its multi-column
#: sweep (widths 2, 4, 8 and 12, V zero-filled to them in the pack), then
#: its column path: 17 and 20 (the single-kernel tune's 4 lams x 5 folds)
#: in a 32-column block, 33 in a 64-column one, pcg-nystrom's rank 100 (one
#: 128-column block), 129 (one 160-column block) and 161 (two blocks of 84
#: columns); there a t that is not a multiple of 4 runs with V padded by
#: zero columns
COLS_T = [2, 3, 8, 9, 10, 17, 20, 33, 100, 129, 161]


@pytest.mark.cuda
@pytest.mark.parametrize("t", COLS_T)
@pytest.mark.parametrize("kern", KERNEL_NAMES)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_matvec_t100_matches_plain(cuda_device, rng, t, kern, precision):
    """kernel_matvec at t > 1 (the multi-column sweep up to t = 16, the
    column path above: pcg-nystrom's sketch width 100 among them) against
    its plain version, every kernel, at m and n ragged against the tiles
    ((130, 301), (1000, 3001)) and at (65, 64); one launch a call."""
    tol = F32_TOL if precision == "f32" else BF16_TOL
    for m, n in [(130, 301), (1000, 3001), (65, 64)]:
        a = _t(rng.standard_normal((m, 9)).astype(np.float32) / 3).to(cuda_device)
        b = _t(rng.standard_normal((n, 9)).astype(np.float32) / 3).to(cuda_device)
        v = _t(rng.standard_normal((n, t)).astype(np.float32)).to(cuda_device)
        before = kernel_matvec_cuda.launches
        got = kernel_matvec_cuda(a, b, v, kernel=kern, sigma=1.2, precision=precision)
        torch.cuda.synchronize()
        assert kernel_matvec_cuda.launches == before + 1
        assert got.shape == (m, t)
        want = ops.ref.kernel_matvec(a, b, v, 1.2, kernel=kern, precision=precision).cpu().numpy()
        np.testing.assert_allclose(got.cpu().numpy(), want, **_tol(want, *tol))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [8, 10, 100])
def test_cuda_matvec_columns_are_deterministic(cuda_device, rng, t):
    """Two launches of kernel_matvec at t > 1 on the same inputs are
    bitwise equal (no atomics: the multi-column sweep's warp-ordered row
    sums and split-ordered partials at 8 and 10, the column path's whole
    output values a thread at 100)."""
    x = _t(rng.standard_normal((3000, 9)).astype(np.float32)).to(cuda_device)
    v = _t(rng.standard_normal((3000, t)).astype(np.float32)).to(cuda_device)
    for kern in ("rbf", "laplacian"):
        fn = lambda: kernel_matvec_cuda(x, x, v, kernel=kern, sigma=1.0,  # noqa: E731
                                        precision="f32")
        assert torch.equal(fn(), fn())


def _baseline_solve(method, prob, draws, dev):
    """``method`` on ``prob`` with the injected draws moved to ``dev``."""
    from repro_torch.core import direct, eigenpro, falkon, pcg

    d = {k: ([p.to(dev) for p in v] if isinstance(v, list) else v.to(dev))
         for k, v in draws.items()}
    if method == "direct":
        return direct.solve_direct(prob)
    if method == "falkon":
        return falkon.solve_falkon(prob, 200, max_iters=10, **d).w
    if method == "eigenpro":
        return eigenpro.solve_eigenpro(prob, rank=40, subsample=300, batch_size=100, epochs=1,
                                       **d).w
    precond = {"pcg-nystrom": "nystrom", "pcg-rpcholesky": "rpcholesky", "pcg-rff": "rff",
               "cg": "identity"}[method]
    return pcg.solve_pcg(prob, precond=precond, rank=40, max_iters=10, **d).w


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["pcg-nystrom", "pcg-rpcholesky", "pcg-rff", "cg",
                                    "falkon", "eigenpro", "direct"])
def test_cuda_baseline_matches_cpu(cuda_device, rng, method):
    """Each baseline at n = 2000 on the card (the CUDA kernels, cuBLAS /
    cuSOLVER) against the same solve on the CPU (the plain versions,
    LAPACK), with the same injected draws: w within 1e-3 relative after 10
    CG iterations (one EigenPro epoch; direct exactly).  sigma 0.7 keeps the
    f32 CG trajectories stable against summation order."""
    n, d, r = 2000, 6, 40
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    draws = {
        "pcg-nystrom": {"omega": rng.standard_normal((n, r))},
        "pcg-rpcholesky": {"pivots": rng.choice(n, r, replace=False)},
        "pcg-rff": {"freqs": rng.standard_normal((4 * r, d)) / 0.7,
                    "phases": rng.uniform(0, 2 * np.pi, 4 * r)},
        "falkon": {"centers_idx": rng.choice(n, 200, replace=False)},
        "eigenpro": {"sub_idx": rng.choice(n, 300, replace=False),
                     "perms": [rng.permutation(n)]},
    }.get(method, {})
    draws = {k: ([_t(p) for p in v] if isinstance(v, list)
                 else _t(v.astype(np.float32) if v.dtype == np.float64 else v))
             for k, v in draws.items()}
    out = {}
    for dev in ("cpu", cuda_device):
        prob = KRRProblem(x=_t(x).to(dev), y=_t(y).to(dev), sigma=0.7, lam_unscaled=1e-4)
        out[str(dev)] = _baseline_solve(method, prob, draws, dev).cpu().numpy()
    want = out["cpu"]
    assert np.linalg.norm(out["cuda"] - want) / np.linalg.norm(want) < 1e-3


def _estimator_data(rng, n=2000, d=6, m=300):
    x = rng.standard_normal((n + m, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.3 * x[:, 1] + 0.1 * rng.standard_normal(n + m)).astype(np.float32)
    return x[:n], y[:n], x[n:], y[n:]


@pytest.mark.cuda
def test_cuda_estimators_match_cpu(cuda_device, rng):
    """The estimators at n = 2000 with ``device="cuda"`` (direct: K from
    ``kernel_block``, cuSOLVER; the CV search on the CUDA kernels) against
    ``device="cpu"`` on the same numpy inputs: predictions within 1e-3
    relative, the same CV winner, CV MSEs within 1e-2 relative (the search's
    sketch draws come from each device's generator).  No scikit-learn is
    needed: ``score`` is the port's torch R²."""
    from repro_torch.estimators import KernelRidge, KernelRidgeCV

    x, y, xt, yt = _estimator_data(rng)
    got = KernelRidge(alpha=1.0, sigma=1.5).fit(x, y)  # device defaults to cuda
    want = KernelRidge(alpha=1.0, sigma=1.5, device="cpu").fit(x, y)
    pred = got.predict(xt)
    assert pred.device.type == "cuda" and got.dual_coef_.dtype == torch.float32
    ref = want.predict(xt).numpy()
    assert np.linalg.norm(pred.cpu().numpy() - ref) / np.linalg.norm(ref) < 1e-3
    assert got.score(xt, yt) == pytest.approx(want.score(xt, yt), rel=1e-3)
    gram = ops.kernel_block(_t(x).to(cuda_device), _t(x).to(cuda_device), kernel="rbf",
                            sigma=1.5)
    cross = ops.kernel_block(_t(xt).to(cuda_device), _t(x).to(cuda_device), kernel="rbf",
                             sigma=1.5)
    pre = KernelRidge(alpha=1.0, kernel="precomputed").fit(gram, _t(y).to(cuda_device))
    assert np.linalg.norm(pre.predict(cross).cpu().numpy() - ref) / np.linalg.norm(ref) < 1e-3
    kw = dict(alphas=(0.01, 1.0, 100.0), sigmas=(0.5, 2.0), cv=3)
    cv_got = KernelRidgeCV(**kw).fit(x, y)
    cv_want = KernelRidgeCV(device="cpu", **kw).fit(x, y)
    assert cv_got.best_params_ == cv_want.best_params_
    np.testing.assert_allclose(cv_got.cv_results_["mean_test_mse"],
                               cv_want.cv_results_["mean_test_mse"], rtol=1e-2)


@pytest.mark.cuda
def test_cuda_telemetry_solve_jsonl_validates(cuda_device, rng, tmp_path):
    """An ASkotch solve on the card with ``Telemetry(jsonl=...)``: the file
    validates, one trace event a history record, the solve span covers the
    last record, and the tile counters follow ``record_tile_work``."""
    from repro_torch.obs import Telemetry, diff, snapshot, validate_jsonl

    x, y, _, _ = _estimator_data(rng)
    prob = KRRProblem(x=_t(x).to(cuda_device), y=_t(y).to(cuda_device), lam_unscaled=1e-4)
    path = str(tmp_path / "run.jsonl")
    tel = Telemetry(jsonl=path)
    s0 = snapshot()
    res = askotch.solve(prob, askotch.ASkotchConfig(block_size=200, rank=20), max_iters=6,
                        eval_every=3, telemetry=tel)
    delta = diff(s0, snapshot())
    tel.close()
    counts = validate_jsonl(path)
    assert counts["trace"] == len(res.history) == 2
    with open(path) as fh:
        events = [json.loads(line) for line in fh]
    (span,) = [e for e in events if e["type"] == "span"]
    assert span["dur_s"] >= res.history[-1]["time_s"]
    assert delta['repro_tile_flops_total{dtype="f32"}'] == 6 * (200 * 200 + 200 * 2000) * (2 * 6 + 8)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["newton", "nsap", "kaczmarz", "cd"])
def test_cuda_sap_step_matches_cpu(cuda_device, rng, name):
    """Ten SAP steps on the card (``kernel_block`` K_BB and rows,
    ``kernel_matvec`` block residuals) against the CPU with the same
    injected draws: iterates within 1e-4 relative."""
    from repro_torch.core import sap

    n, b = 2000, 100
    x, y, _, _ = _estimator_data(rng, n=n)
    make = {"newton": lambda p: sap.make_randomized_newton_step(p, b),
            "nsap": lambda p: sap.make_nsap_step(p, b, 0.01, n / b),
            "kaczmarz": sap.make_kaczmarz_step, "cd": sap.make_cd_step}[name]
    draws = [rng.choice(n, b, replace=False) if name in ("newton", "nsap")
             else int(rng.integers(n)) for _ in range(10)]
    kind = "idx" if name in ("newton", "nsap") else "j"
    out = {}
    for dev in ("cpu", cuda_device):
        prob = KRRProblem(x=_t(x).to(dev), y=_t(y).to(dev), sigma=1.5, lam_unscaled=1e-3)
        step, state = make(prob), sap.init_state(prob)
        for draw in draws:
            state = step(state, **{kind: draw})
        out[str(dev)] = state.w.cpu().numpy()
    want = out["cpu"]
    assert np.linalg.norm(out["cuda"] - want) / np.linalg.norm(want) < 1e-4


# ---------------------------------------------------------------------------
# the t = 1 sweep split over n (m <= 4096 rows: the serving buckets) and the
# serving engine on the card
# ---------------------------------------------------------------------------

#: rows of A the split route is held at: one row, a bucket of 8, a block's
#: 64 rows and one either side, and a 16-block bucket
SPLIT_M = (1, 8, 63, 64, 65, 1024)


def _split_ns(d):
    """n below one staged tile (no split), at a multiple of it (40 tiles)
    and one either side: 256 rows a tile up to d = 16, 64 above."""
    tile = 256 if d <= 16 else 64
    return {"below": tile - 1, "multiple": 40 * tile, "minus1": 40 * tile - 1,
            "plus1": 40 * tile + 1}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [9, 16, 17, 37])
@pytest.mark.parametrize("edge", ["below", "multiple", "minus1", "plus1"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_split_sweep_edges_match_plain(cuda_device, rng, d, edge, precision):
    """kernel_matvec (every kernel) and the weighted matvec (every
    combination of MULTI_CASES) at t = 1 on the split route's edges of m
    and n, against the plain versions."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.kernel_matvec import t1_splits

    n = _split_ns(d)[edge]
    splits = t1_splits(_build.load("kernel_matvec"), 8, n, d)
    assert (splits > 1) == (edge != "below")
    b = _t((rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)).to(cuda_device)
    v = _t(rng.standard_normal((n,)).astype(np.float32)).to(cuda_device)
    tol = F32_TOL if precision == "f32" else BF16_TOL
    for m in SPLIT_M:
        a = _t((rng.standard_normal((m, d)) / np.sqrt(d)).astype(np.float32)).to(cuda_device)
        for kern in KERNEL_NAMES:
            got = kernel_matvec_cuda(a, b, v, kernel=kern, sigma=1.3, precision=precision)
            want = ops.ref.kernel_matvec(a, b, v, 1.3, kernel=kern,
                                         precision=precision).cpu().numpy()
            np.testing.assert_allclose(got.cpu().numpy(), want, **_tol(want, *tol))
        for kernels, sigmas in MULTI_CASES.values():
            w = tuple(float(x) for x in rng.dirichlet(np.ones(len(kernels))))
            got = kernel_matvec_multi_cuda(a, b, v, w, kernels=kernels, sigmas=sigmas,
                                           precision=precision)
            want = ops.ref.kernel_matvec_multi(a, b, v, sigmas,
                                               torch.tensor(w, device=cuda_device),
                                               kernels=kernels, precision=precision)
            want = want.cpu().numpy()
            np.testing.assert_allclose(got.cpu().numpy(), want, **_tol(want, *tol))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_split_rows_bitwise_the_same_in_every_bucket(cuda_device, rng, precision):
    """The same 8 rows in buckets of 8, 64 and 1024 rows, at other
    positions and with other rows beside them, score bitwise the same on
    both t = 1 kernels: the split is set by n alone up to 4096 rows."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.kernel_matvec import t1_splits

    n, d = 100_000, 9
    lib = _build.load("kernel_matvec")
    assert t1_splits(lib, 1, n, d) == t1_splits(lib, 4096, n, d) > 1
    assert t1_splits(lib, 4097, n, d) == 1
    b = _t(rng.standard_normal((n, d)).astype(np.float32) / 3).to(cuda_device)
    v = _t(rng.standard_normal((n,)).astype(np.float32)).to(cuda_device)
    rows = _t(rng.standard_normal((8, d)).astype(np.float32) / 3).to(cuda_device)
    kernels, sigmas = MULTI_CASES["l2+l1"]
    fns = (lambda a: kernel_matvec_cuda(a, b, v, kernel="rbf", sigma=1.0, precision=precision),
           lambda a: kernel_matvec_multi_cuda(a, b, v, (0.5, 0.2, 0.3), kernels=kernels,
                                              sigmas=sigmas, precision=precision))
    for fn in fns:
        base = fn(rows)
        for bucket, at in ((64, 37), (1024, 1000), (1024, 0)):
            a = _t(rng.standard_normal((bucket, d)).astype(np.float32) / 3).to(cuda_device)
            a[at:at + 8] = rows
            assert torch.equal(fn(a)[at:at + 8], base)


#: kernel_matvec's multi-column sweep on the split route: each width W (2,
#: 4, 8, 12, 16) at t = W, and 3, 10 and 13 below one
HEADS_T = (2, 3, 4, 8, 10, 12, 13, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [9, 16, 17, 37])
@pytest.mark.parametrize("edge", ["below", "multiple", "minus1", "plus1"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_heads_sweep_edges_match_plain(cuda_device, rng, d, edge, precision):
    """kernel_matvec at 2 <= t <= 16 (the multi-column sweep, every kernel)
    on the split route's edges of m and n, against the plain version: S
    ranges of B, (S, m, t) partials added in split order."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.kernel_matvec import t1_splits

    n = _split_ns(d)[edge]
    assert (t1_splits(_build.load("kernel_matvec"), 8, n, d) > 1) == (edge != "below")
    b = _t((rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)).to(cuda_device)
    v = _t(rng.standard_normal((n, max(HEADS_T))).astype(np.float32)).to(cuda_device)
    tol = F32_TOL if precision == "f32" else BF16_TOL
    for m in (1, 8, 64, 65):
        a = _t((rng.standard_normal((m, d)) / np.sqrt(d)).astype(np.float32)).to(cuda_device)
        for t in HEADS_T:
            vt = v[:, :t].contiguous()
            for kern in KERNEL_NAMES:
                before = kernel_matvec_cuda.launches
                got = kernel_matvec_cuda(a, b, vt, kernel=kern, sigma=1.3, precision=precision)
                assert kernel_matvec_cuda.launches == before + 1 and got.shape == (m, t)
                want = ops.ref.kernel_matvec(a, b, vt, 1.3, kernel=kern,
                                             precision=precision).cpu().numpy()
                np.testing.assert_allclose(got.cpu().numpy(), want, **_tol(want, *tol))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_heads_rows_bitwise_the_same_in_every_bucket(cuda_device, rng, precision):
    """At t = 10 the same 8 rows in buckets of 8, 64 and 1024 rows, at other
    positions and with other rows beside them, score bitwise the same: the
    multi-column sweep splits B as the t = 1 sweep does, by n alone."""
    n, d, t = 100_000, 9, 10
    b = _t(rng.standard_normal((n, d)).astype(np.float32) / 3).to(cuda_device)
    v = _t(rng.standard_normal((n, t)).astype(np.float32)).to(cuda_device)
    rows = _t(rng.standard_normal((8, d)).astype(np.float32) / 3).to(cuda_device)

    def fn(a):
        return kernel_matvec_cuda(a, b, v, kernel="rbf", sigma=1.0, precision=precision)

    base = fn(rows)
    for bucket, at in ((64, 37), (1024, 1000), (1024, 0)):
        a = _t(rng.standard_normal((bucket, d)).astype(np.float32) / 3).to(cuda_device)
        a[at:at + 8] = rows
        assert torch.equal(fn(a)[at:at + 8], base)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [{"kernel": "rbf", "sigma": 1.5},
                                 {"kernel": ["rbf", "laplacian", "matern52"], "sigma": 1.5,
                                  "weights": [0.5, 0.2, 0.3]}], ids=["rbf", "multi"])
@pytest.mark.parametrize("heads", [1, 3])
def test_cuda_engine_matches_cpu_engine(cuda_device, rng, cfg, heads):
    """A model of 2000 rows served by the engine on the card against the
    engine on the CPU (within the f32 tolerance), threaded clients bitwise
    the card's sequential closure, and one kernel launch a bucket pass."""
    import threading

    from repro_torch.serving.engine import ServingEngine, bucket_sizes
    from repro_torch.serving.krr_serve import make_krr_predict_fn_from_config

    x = rng.standard_normal((2000, 6)).astype(np.float32) / 2
    w = rng.standard_normal((2000, heads)).astype(np.float32)
    w = w[:, 0].copy() if heads == 1 else w
    queries = [rng.standard_normal((int(rng.integers(1, 40)), 6)).astype(np.float32)
               for _ in range(24)]
    wrapper = kernel_matvec_cuda if isinstance(cfg["kernel"], str) else kernel_matvec_multi_cuda
    with ServingEngine(max_batch=64, max_wait_ms=2.0) as eng, \
            ServingEngine(max_batch=64, max_wait_ms=2.0, device="cpu") as cpu:
        before = wrapper.launches
        eng.register("m", cfg, x, w)
        assert wrapper.launches - before == len(bucket_sizes(64))
        cpu.register("m", cfg, x, w)
        predict = make_krr_predict_fn_from_config(cfg, x, w, max_batch=64)
        expected = [predict(q).cpu().numpy() for q in queries]
        results = [None] * len(queries)

        def client(lo, hi):
            for i in range(lo, hi):
                results[i] = eng.predict("m", queries[i])

        eng.reset_stats()
        before = wrapper.launches
        threads = [threading.Thread(target=client, args=(j * 6, (j + 1) * 6)) for j in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        eng.drain()
        runs = sum(o["runs"] for o in eng.stats("m")["occupancy"].values())
        assert wrapper.launches - before == runs
        for q, got, want in zip(queries, results, expected):
            np.testing.assert_array_equal(got, want)
            ref = cpu.predict("m", q)
            np.testing.assert_allclose(got, ref, **_tol(ref, *F32_TOL))


# ---------------------------------------------------------------------------
# the distributed tier on the card: a mesh of cuda:0 repeated
# ---------------------------------------------------------------------------


def _mesh(device, shape):
    from repro_torch.distributed.meshes import SolverMesh

    return SolverMesh([device] * (shape[0] * shape[1]), shape=shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_cuda_sharded_operator_matches_cpu(cuda_device, rng, shape):
    """Every shard's kernels launch on the card; the primitives agree with
    the same mesh of CPU devices, and two runs are bitwise equal."""
    from repro_torch.distributed.sharded_operator import ShardedKernelOperator

    x = rng.standard_normal((512, 9)).astype(np.float32)
    v = rng.standard_normal((512, 3)).astype(np.float32)
    a = rng.standard_normal((64, 9)).astype(np.float32)
    idx = rng.integers(0, 512, 64)
    ops_ = {dev: ShardedKernelOperator.bind(_mesh(dev, shape), _t(x), sigma=1.5)
            for dev in ("cpu", "cuda:0")}
    ops.reset_launches()
    got = ops_["cuda:0"]
    outs = [got.matvec(_t(v).cuda()), got.row_block_matvec(_t(a).cuda(), _t(v).cuda()),
            got.block(_t(a).cuda()), got.block_idx(_t(idx).cuda())]
    assert ops.launches()["kernel_matvec"] > 0 and ops.launches()["kernel_block"] > 0
    want = [ops_["cpu"].matvec(_t(v)), ops_["cpu"].row_block_matvec(_t(a), _t(v)),
            ops_["cpu"].block(_t(a)), ops_["cpu"].block_idx(_t(idx))]
    for g, w in zip(outs, want):
        assert g.device.type == "cuda"
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), **_tol(w.numpy(), *F32_TOL))
    assert torch.equal(got.matvec(_t(v).cuda()), outs[0])


@pytest.mark.cuda
def test_cuda_dist_askotch_steps_match_cpu(cuda_device, rng):
    """Three distributed ASkotch steps on a (2, 2) mesh of cuda:0 against
    the same mesh of CPU devices, with injected draws."""
    from repro_torch.distributed import krr_dist

    n, b, r = 512, 64, 16
    x = rng.standard_normal((n, 5)).astype(np.float32)
    y = rng.standard_normal((n,)).astype(np.float32)
    draws = [(rng.integers(0, n, b), rng.standard_normal((b, r)).astype(np.float32),
              rng.standard_normal((b,)).astype(np.float32)) for _ in range(3)]
    cfg = krr_dist.DistKRRConfig(n=n, d=5, sigma=1.5, lam_unscaled=1e-3, block_size=b, rank=r)
    w = {}
    for run, dev in enumerate(("cpu", "cuda:0", "cuda:0")):
        mesh = _mesh(dev, (2, 2))
        step = krr_dist.make_dist_askotch_step(mesh, cfg)
        state = krr_dist.init_dist_state(cfg, 0, device=dev)
        for idx, omega, probe in draws:
            state = step(state, _t(x).to(dev), _t(y).to(dev), idx=_t(idx), omega=_t(omega),
                         probe=_t(probe))
        w[run] = state.w.cpu()
    np.testing.assert_allclose(w[1].numpy(), w[0].numpy(), **_tol(w[0].numpy(), *F32_TOL))
    assert torch.equal(w[1], w[2])  # repeated block rows are summed in a fixed order


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (3, 1)])
def test_cuda_dc_mesh_is_bitwise_the_sequential_run(cuda_device, rng, shape):
    # (3, 1) repeats cuda:0: one host thread per mesh device drives a shard
    from repro_torch.core.solver_api import solve
    from repro_torch.kernels import ops

    x = rng.standard_normal((600, 6)).astype(np.float32)
    y = rng.standard_normal((600,)).astype(np.float32)
    p = KRRProblem(x=_t(x).cuda(), y=_t(y).cuda(), sigma=1.5, lam_unscaled=1e-3)
    kw = dict(dc_shards=3, dc_method="askotch", block_size=64, rank=16, max_iters=10)
    ops.reset_launches()
    seq = solve(p, "dc", **kw)
    seq_launches = ops.launches()
    ops.reset_launches()
    par = solve(p, "dc", mesh=_mesh("cuda:0", shape), **kw)
    assert ops.launches() == seq_launches  # counted under a lock from every thread
    assert torch.equal(seq.w, par.w) and seq.w.device.type == "cuda"
    assert torch.equal(seq.predict_fn(p.x[:50]), par.predict_fn(p.x[:50]))
    assert par.info["collective_dispatches"] == 0


@pytest.mark.cuda
def test_cuda_kmeans_partition_distances_run_on_the_card(cuda_device, rng):
    from repro_torch.distributed.partition import chunked_sq_dists, kmeans_partition

    x = rng.standard_normal((3000, 5)).astype(np.float32)
    c = x[:4]
    d_card = chunked_sq_dists(_t(x).cuda(), c, chunk=1000)
    np.testing.assert_allclose(d_card, chunked_sq_dists(x, c, chunk=1000),
                               **_tol(d_card, *F32_TOL))
    part = kmeans_partition(_t(x).cuda(), 4, seed=0)
    assert sorted(part.sizes.tolist()) == [750] * 4
    assert part.n == 3000 and part.centers.shape == (4, 5)


# ---------------------------------------------------------------------------
# LM serving: every reduced architecture on the card against the CPU
# ---------------------------------------------------------------------------

def _lm_close(got, want, cfg, what):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    np.testing.assert_allclose(got, want, err_msg=what, **_tol(want, *F32_TOL))


@contextlib.contextmanager
def _recorded_routes():
    """Every MoE routing round of the port within the block, as (input,
    gates, experts) on the CPU."""
    from repro_torch.models import layers

    rounds, route = [], layers.moe_route

    def recording(xc, router, k):
        gates, experts = route(xc, router, k)
        rounds.append((xc.detach().cpu(), gates.detach().cpu(), experts.cpu()))
        return gates, experts

    with mock.patch.object(layers, "moe_route", recording):
        yield rounds


def _assert_routes_agree(card, cpu):
    """Each card round saw its CPU round's input and routed every token to
    the same experts (gates and inputs within f32 tolerance)."""
    assert len(card) == len(cpu) > 0
    for n, ((xg, gg, eg), (xc, gc, ec)) in enumerate(zip(card, cpu)):
        np.testing.assert_allclose(xg.numpy(), xc.numpy(), err_msg=f"round {n} input",
                                   **_tol(xc.numpy(), *F32_TOL))
        assert torch.equal(eg, ec), f"round {n} experts"
        np.testing.assert_allclose(gg.numpy(), gc.numpy(), err_msg=f"round {n} gates",
                                   **_tol(gc.numpy(), *F32_TOL))


def _lm_inputs(arch):
    """Reduced (f32) weights and a batch drawn on the CPU from a seed."""
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.data import synthetic
    from repro_torch.models.model_api import init_params

    cfg = get_reduced_config(arch)
    params = init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    batch = synthetic.batch_for(cfg, (2, 16), 0, 0, device="cpu")
    return cfg, params, batch


def _lm_run(cfg, params, batch, dev, tokens=None, steps=4):
    """loss, prefill logits, ``steps`` decode logits (fed ``tokens``, else
    greedy), the greedy tokens of ``greedy_generate`` and every MoE routing
    round, on ``dev``."""
    with _recorded_routes() as rounds:
        out = _lm_forward(cfg, params, batch, dev, tokens, steps)
    return {**out, "routes": rounds}


def _lm_forward(cfg, params, batch, dev, tokens, steps):
    from repro_torch.models.model_api import get_model, tree_map
    from repro_torch.serving.serve_step import _copy_cache, greedy_generate

    impl = get_model(cfg)
    params = tree_map(lambda t: t.to(dev), params)
    batch = {k: v.to(dev) for k, v in batch.items()}
    loss, _ = impl.loss_fn(params, batch, cfg)
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    logits, cache = impl.prefill(params, prompt, cfg)
    total = int(cache["pos"]) + steps
    big = _copy_cache(cache, impl.init_cache(cfg, logits.shape[0], total, device=dev))
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    dec, fed = [], []
    for i in range(steps):
        tok = tokens[i].to(dev) if tokens is not None else tok
        fed.append(tok.cpu())
        out, big = impl.decode_step(params, big, {"tokens": tok}, cfg)
        dec.append(out)
        tok = torch.argmax(out[:, -1], -1)[:, None].to(torch.int32)
    return {"loss": loss, "logits": logits, "dec": dec, "fed": fed,
            "greedy": greedy_generate(cfg, params, prompt, steps)}


LM_ARCHS = ("whisper-base", "grok-1-314b", "deepseek-moe-16b", "qwen2-1.5b", "chatglm3-6b",
            "command-r-plus-104b", "llama3-405b", "rwkv6-1.6b", "jamba-1.5-large-398b",
            "llava-next-mistral-7b")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cuda_lm_reduced_matches_cpu(cuda_device, arch):
    """Loss, prefill logits, four decode steps (fed the CPU run's tokens)
    and greedy tokens on the card against the CPU, f32 tolerance; with
    experts, every routing round routes alike."""
    cfg, params, batch = _lm_inputs(arch)
    cpu = _lm_run(cfg, params, batch, "cpu")
    card = _lm_run(cfg, params, batch, cuda_device, tokens=cpu["fed"])
    assert card["logits"].device.type == "cuda"
    _lm_close(card["loss"], cpu["loss"], cfg, "loss")
    _lm_close(card["logits"], cpu["logits"], cfg, "prefill logits")
    for i, (g, w) in enumerate(zip(card["dec"], cpu["dec"])):
        _lm_close(g, w, cfg, f"decode step {i}")
    assert torch.equal(card["greedy"].cpu(), cpu["greedy"])
    if cfg.num_experts:
        _assert_routes_agree(card["routes"], cpu["routes"])


@pytest.mark.cuda
def test_cuda_moe_ffn_with_drops_and_chunks_matches_cpu(cuda_device):
    """``moe_ffn`` on the card against the CPU at O(1) inputs: 256 tokens
    routed 64 a round (four chunks) at capacity factor 0.25, so experts
    drop assignments; f32 tolerance, and every round routes alike."""
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.models import layers, transformer

    cfg = dataclasses.replace(get_reduced_config("deepseek-moe-16b"), capacity_factor=0.25,
                              moe_dispatch_tokens=64)
    gen = torch.Generator().manual_seed(5)
    params = {}
    for path, (shape, _) in transformer.param_defs(cfg).items():
        if path.startswith("layers.moe_"):
            w = torch.randn(shape[1:], generator=gen) * shape[-2] ** -0.5
            params[path[len("layers."):]] = w
    x = torch.randn((4, 64, cfg.d_model), generator=gen)
    with _recorded_routes() as cpu_rounds:
        want = layers.moe_ffn(cfg, x, params)
    with _recorded_routes() as card_rounds:
        got = layers.moe_ffn(cfg, x.to(cuda_device),
                             {k: v.to(cuda_device) for k, v in params.items()})
    assert got.device.type == "cuda" and len(cpu_rounds) == 4
    assert max(int(torch.bincount(e.reshape(-1)).max()) for _, _, e in cpu_rounds) > 8
    _lm_close(got, want, cfg, "moe_ffn")
    _assert_routes_agree(card_rounds, cpu_rounds)


@pytest.mark.cuda
def test_cuda_lm_decode_at_clamped_pos_matches_cpu(cuda_device):
    """A decode at pos == cache length writes the last slot (the clamp of
    ``lax.dynamic_update_slice``) on the card as on the CPU."""
    from repro_torch.models.model_api import get_model, tree_map

    cfg, params, _ = _lm_inputs("qwen2-1.5b")
    impl = get_model(cfg)
    gen = torch.Generator().manual_seed(4)
    shape = (cfg.num_layers, 2, 6, cfg.kv_heads, cfg.hd)
    cache = {"k": torch.randn(shape, generator=gen), "v": torch.randn(shape, generator=gen),
             "pos": torch.tensor(6, dtype=torch.int32)}
    tok = torch.tensor([[5], [7]], dtype=torch.int32)
    out = {}
    for dev in ("cpu", cuda_device):
        c = {k: v.clone().to(dev) for k, v in cache.items()}
        out[str(dev)] = impl.decode_step(tree_map(lambda t: t.to(dev), params), c,
                                         {"tokens": tok.to(dev)}, cfg)
    (lc, cc), (lg, cg) = out["cpu"], out["cuda"]
    _lm_close(lg, lc, cfg, "logits")
    for k in ("k", "v"):
        _lm_close(cg[k], cc[k], cfg, k)
        assert torch.equal(cg[k][:, :, :-1].cpu(), cache[k][:, :, :-1])
    assert int(cg["pos"]) == 7


@pytest.mark.cuda
def test_cuda_serve_launcher_reduced(cuda_device, capsys):
    from repro_torch.launch import serve

    report = serve.main(["--arch", "qwen2-1.5b", "--reduced"])  # the cuda default
    assert list(report) == ["arch", "generated_shape", "tokens", "seconds", "tok_per_s",
                            "sample"]
    assert report["generated_shape"] == [4, 16] and report["tokens"] == 64
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report


# ---------------------------------------------------------------------------
# LM training: every reduced architecture's train step on the card against
# the CPU; the checkpointer, the pipeline and the launcher on the card
# ---------------------------------------------------------------------------


def _train_run(cfg, params, batch, dev):
    from repro_torch.models.model_api import flatten, get_model, tree_map
    from repro_torch.training.optimizers import adamw
    from repro_torch.training.train_step import make_train_step, value_and_grad

    params = tree_map(lambda t: t.to(dev, copy=True), params)
    batch = {k: v.to(dev) for k, v in batch.items()}
    with _recorded_routes() as rounds:
        loss, _, grads = value_and_grad(get_model(cfg).loss_fn, params, batch, cfg)
    # eps 1e-3: a first AdamW step at eps 1e-8 moves a weight by ~lr sign(g),
    # which turns last-digit gradient differences near 0 into lr-sized ones
    opt = adamw(1e-2, eps=1e-3)
    new, _, metrics = make_train_step(cfg, opt)(params, opt.init(params), batch, 0)
    return loss, flatten(grads), flatten(new), metrics, rounds


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cuda_train_step_matches_cpu(cuda_device, arch):
    """Loss, every gradient leaf and every parameter after one AdamW train
    step (the config's microbatches) on the card against the CPU, f32
    tolerance; with experts, every routing round routes alike."""
    cfg, params, batch = _lm_inputs(arch)
    c_loss, c_grads, c_new, c_metrics, c_rounds = _train_run(cfg, params, batch, "cpu")
    g_loss, g_grads, g_new, g_metrics, g_rounds = _train_run(cfg, params, batch, cuda_device)
    assert g_loss.device.type == "cuda"
    _lm_close(g_loss, c_loss, cfg, "loss")
    _lm_close(g_metrics["loss"], c_metrics["loss"], cfg, "step loss")
    _lm_close(g_metrics["grad_norm"], c_metrics["grad_norm"], cfg, "grad norm")
    for k in c_grads:
        _lm_close(g_grads[k], c_grads[k], cfg, f"grad {k}")
        _lm_close(g_new[k], c_new[k], cfg, f"param {k} after the step")
    if cfg.num_experts:
        _assert_routes_agree(g_rounds, c_rounds)


@pytest.mark.cuda
def test_cuda_checkpointer_round_trip(cuda_device, tmp_path):
    """f32, bf16 and int leaves saved from the card restore on the card
    (``device`` defaults to cuda), bitwise and in their dtypes."""
    from repro_torch.checkpoint import checkpointer

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    w = torch.randn((64, 32), generator=gen, device=cuda_device)
    state = {"params": {"w": w, "w_bf16": w.to(torch.bfloat16)},
             "opt_state": ({"m": w * 2},), "count": torch.tensor(3, device=cuda_device)}
    checkpointer.save(str(tmp_path), 4, state, extra={"data": {"seed": 0, "step": 4}})
    back, extra, step = checkpointer.restore(str(tmp_path))
    assert step == 4 and extra == {"data": {"seed": 0, "step": 4}}
    for got, want in ((back["params"]["w"], w), (back["params"]["w_bf16"], w.to(torch.bfloat16)),
                      (back["opt_state"][0]["m"], w * 2), (back["count"], state["count"])):
        assert got.device.type == "cuda" and got.dtype == want.dtype
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_pipeline_batches_on_the_card_and_resume(cuda_device):
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.data import synthetic
    from repro_torch.data.pipeline import LMDataPipeline

    cfg = get_reduced_config("llava-next-mistral-7b")
    pipe = LMDataPipeline(cfg, 4, 16, seed=2)  # the cuda default
    batches = [next(pipe) for _ in range(3)]
    for step, b in enumerate(batches):
        want = synthetic.batch_for(cfg, (4, 16), 2, step, device=cuda_device)
        assert all(v.device.type == "cuda" and torch.equal(v, want[k]) for k, v in b.items())
    again = next(LMDataPipeline.from_state(cfg, 4, 16, {"seed": 2, "step": 2}))
    assert all(torch.equal(again[k], batches[2][k]) for k in again)


@pytest.mark.cuda
def test_cuda_train_launcher_fault_drill(cuda_device, tmp_path, capsys):
    """The launcher's fault drill on the card (the cuda default): a failure
    at step 7 restores step 5; the step-10 loss is a clean run's."""
    from repro_torch.launch import train

    common = ["--arch", "qwen2-1.5b", "--reduced", "--steps", "10", "--batch", "2", "--seq",
              "8", "--ckpt-every", "5", "--log-every", "5"]
    drill = train.main(common + ["--ckpt-dir", str(tmp_path / "a"), "--inject-failure", "7"])
    clean = train.main(common + ["--ckpt-dir", str(tmp_path / "b")])
    assert drill["final_step"] == clean["final_step"] == 10
    assert abs(drill["history"][-1]["loss"] - clean["history"][-1]["loss"]) < 1e-4
    assert "[fault]" in capsys.readouterr().out
