"""The port's multi-kernel slice (``repro_torch``) held against the JAX
package: the three plain multi-kernel ops, the weighted-sum operator, its
validation, and a multi-kernel ASkotch solve.

Inputs are made with numpy from a seed and cross between the packages as
numpy arrays; JAX runs on the CPU (its Pallas kernels in interpret mode),
the port on CPU tensors, i.e. its plain versions.  Tolerances: f32 rtol
2e-4 / atol 2e-5 scaled by max(1, |ref|max) (summation order differs), as
tests/test_kernels_pallas.py; bf16 against the JAX bf16 result (0.05, 0.02)
(one bf16 ulp of a kernel value can differ where the f32 distances round
differently).  Interpret-mode cases keep one small shape each: interpret
mode is slow.  The CUDA kernels are held against these plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import multikernel as j_mk  # noqa: E402
from repro.core.krr import KRRProblem as JProblem  # noqa: E402
from repro.core.krr import evaluate as j_evaluate  # noqa: E402
from repro.core.solver_api import solve as j_solve  # noqa: E402
from repro.data import synthetic as j_synthetic  # noqa: E402
from repro.kernels import multi as j_multi  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.krr import evaluate  # noqa: E402
from repro_torch.core.multikernel import (  # noqa: E402
    WeightedSumKernelOperator,
    canonical_kernels,
    make_operator,
)
from repro_torch.core.operator import KernelOperator, PrecomputedKernelOperator  # noqa: E402
from repro_torch.core.solver_api import solve  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.multi import (  # noqa: E402
    kernel_block_multi_cuda,
    kernel_matvec_components_cuda,
    kernel_matvec_multi_cuda,
)

#: (kernels, per-kernel sigmas): the l2 + l1 families, and dot + cos
COMBOS = {
    "l2+l1": (("rbf", "laplacian", "matern52"), (0.7, 1.3, 2.1)),
    "dot+cos": (("linear", "polynomial", "sigmoid", "cosine"), (1.5, 1.1, 2.0, 1.0)),
}
F32_TOL = (2e-4, 2e-5)
BF16_TOL = (0.05, 0.02)


def _tol(ref, rtol, atol):
    return dict(rtol=rtol, atol=atol * max(1.0, float(np.abs(ref).max())))


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy (JAX arrays are read-only)


def _operands(rng, m, n, d, t, q, vdim="2d"):
    a = (rng.standard_normal((m, d)) / np.sqrt(d)).astype(np.float32)
    b = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    a[1] = 0.0  # a zero row: cosine's zero-norm-as-1 rule
    v = rng.standard_normal((n,) if vdim == "1d" else (n, t)).astype(np.float32)
    w = rng.dirichlet(np.ones(q), size=t).T.astype(np.float32)  # (q, t)
    return a, b, v, w


def _port_weights(w):
    """The port's weights for a numpy array: q floats for (q,), a tensor for (q, t)."""
    return tuple(float(x) for x in w) if w.ndim == 1 else _t(w)


# ---------------------------------------------------------------------------
# the three plain versions against repro.kernels.ref (the XLA path)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("combo", sorted(COMBOS))
@pytest.mark.parametrize("vdim,wkind,precision", [
    ("1d", "q", "f32"), ("2d", "q", "f32"), ("2d", "qt", "f32"),
    ("1d", "q", "bf16"), ("2d", "qt", "bf16"),
])
def test_matvec_multi_matches_xla(rng, combo, vdim, wkind, precision):
    kernels, sigmas = COMBOS[combo]
    a, b, v, w = _operands(rng, 37, 101, 7, 3, len(kernels), vdim)
    weights = w[:, 0] if wkind == "q" or vdim == "1d" else w
    want = np.asarray(jops.kernel_matvec_multi(
        a, b, v, kernels=kernels, sigmas=sigmas, weights=weights, backend="xla",
        chunk_a=16, chunk_b=48, precision=precision))
    got = ops.kernel_matvec_multi(_t(a), _t(b), _t(v), kernels=kernels, sigmas=sigmas,
                                  weights=_port_weights(weights), chunk_a=16, chunk_b=48,
                                  precision=precision).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **_tol(want, *(F32_TOL if precision == "f32" else BF16_TOL)))


@pytest.mark.parametrize("combo", sorted(COMBOS))
@pytest.mark.parametrize("vdim,precision", [("1d", "f32"), ("2d", "f32"), ("2d", "bf16")])
def test_components_match_xla(rng, combo, vdim, precision):
    kernels, sigmas = COMBOS[combo]
    a, b, v, _ = _operands(rng, 29, 83, 5, 4, len(kernels), vdim)
    want = np.asarray(jops.kernel_matvec_components(
        a, b, v, kernels=kernels, sigmas=sigmas, backend="xla", chunk_a=16, chunk_b=32,
        precision=precision))
    got = ops.kernel_matvec_components(_t(a), _t(b), _t(v), kernels=kernels, sigmas=sigmas,
                                       chunk_a=16, chunk_b=32, precision=precision).numpy()
    assert got.shape == want.shape == ((len(kernels), 29) if vdim == "1d" else (len(kernels), 29, 4))
    np.testing.assert_allclose(got, want, **_tol(want, *(F32_TOL if precision == "f32" else BF16_TOL)))


@pytest.mark.parametrize("combo", sorted(COMBOS))
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_block_multi_matches_xla(rng, combo, precision):
    kernels, sigmas = COMBOS[combo]
    a, b, _, w = _operands(rng, 31, 77, 6, 1, len(kernels))
    weights = tuple(float(x) for x in w[:, 0])
    want = np.asarray(jops.kernel_block_multi(a, b, kernels=kernels, sigmas=sigmas,
                                              weights=weights, backend="xla", precision=precision))
    got = ops.kernel_block_multi(_t(a), _t(b), kernels=kernels, sigmas=sigmas, weights=weights,
                                 precision=precision).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **_tol(want, *(F32_TOL if precision == "f32" else BF16_TOL)))


# ---------------------------------------------------------------------------
# ... and against the Pallas kernels in interpret mode (one shape each)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["matvec_cols", "matvec_q", "components", "block"])
def test_plain_versions_match_pallas_interpret(rng, op):
    kernels, sigmas = COMBOS["l2+l1"] if op != "matvec_q" else COMBOS["dot+cos"]
    q = len(kernels)
    a, b, v, w = _operands(rng, 24, 40, 5, 3, q)
    ta, tb, tv = _t(a), _t(b), _t(v)
    if op in ("matvec_cols", "matvec_q"):
        weights = w if op == "matvec_cols" else w[:, 0]
        want = j_multi.kernel_matvec_multi_pallas(a, b, v, jnp.asarray(weights), kernels=kernels,
                                                  sigmas=sigmas, interpret=True)
        got = ops.kernel_matvec_multi(ta, tb, tv, kernels=kernels, sigmas=sigmas,
                                      weights=_port_weights(weights))
    elif op == "components":
        want = j_multi.kernel_matvec_components_pallas(a, b, v, kernels=kernels, sigmas=sigmas,
                                                       interpret=True)
        got = ops.kernel_matvec_components(ta, tb, tv, kernels=kernels, sigmas=sigmas)
    else:
        weights = tuple(float(x) for x in w[:, 0])
        want = j_multi.kernel_block_multi_pallas(a, b, kernels=kernels, sigmas=sigmas,
                                                 weights=weights, interpret=True)
        got = ops.kernel_block_multi(ta, tb, kernels=kernels, sigmas=sigmas, weights=weights)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, **_tol(want, *F32_TOL))


def test_repeated_kernel_and_many_kernels(rng):
    """One kernel twice with its own sigmas, and q = 9 (above the CUDA
    kernels' per-launch cap, which only the card's wrapper splits)."""
    a, b, v, _ = _operands(rng, 19, 45, 4, 2, 2)
    for kernels, sigmas in [(("rbf", "rbf"), (0.5, 2.0)),
                            (COMBOS["l2+l1"][0] + COMBOS["dot+cos"][0] + ("rbf", "laplacian"),
                             COMBOS["l2+l1"][1] + COMBOS["dot+cos"][1] + (0.6, 3.0))]:
        w = tuple(float(x) for x in rng.dirichlet(np.ones(len(kernels))))
        want = np.asarray(jops.kernel_matvec_multi(a, b, v, kernels=kernels, sigmas=sigmas,
                                                   weights=jnp.asarray(w), backend="xla"))
        got = ops.kernel_matvec_multi(_t(a), _t(b), _t(v), kernels=kernels, sigmas=sigmas,
                                      weights=w).numpy()
        np.testing.assert_allclose(got, want, **_tol(want, *F32_TOL))


def test_multi_dispatch_validates_and_refuses_mixed_devices(rng):
    a, b, v, w = _operands(rng, 5, 7, 3, 2, 2)
    ta, tb, tv = _t(a), _t(b), _t(v)
    with pytest.raises(ValueError, match="unknown kernel"):
        ops.kernel_matvec_multi(ta, tb, tv, kernels=("rbf", "gauss"), sigmas=(1, 1),
                                weights=(0.5, 0.5))
    with pytest.raises(ValueError, match="unknown precision"):
        ops.kernel_block_multi(ta, tb, kernels=("rbf",), sigmas=(1,), weights=(1,), precision="f16")
    with pytest.raises(ValueError, match="2 sigmas for 1 kernels"):
        ops.kernel_matvec_components(ta, tb, tv, kernels=("rbf",), sigmas=(1, 2))
    # weights are q floats or a (q, t) tensor; a caller converts numpy itself
    with pytest.raises(TypeError, match="sequence of 2 floats"):
        ops.kernel_matvec_multi(ta, tb, tv, kernels=("rbf", "laplacian"), sigmas=(1, 1), weights=w)
    with pytest.raises(ValueError, match=r"must be a \(2, t\) tensor"):
        ops.kernel_matvec_multi(ta, tb, tv, kernels=("rbf", "laplacian"), sigmas=(1, 1),
                                weights=_t(w[:, 0]))
    with pytest.raises(ValueError, match="3 weights for 2 kernels"):
        ops.kernel_matvec_multi(ta, tb, tv, kernels=("rbf", "laplacian"), sigmas=(1, 1),
                                weights=(0.2, 0.3, 0.5))
    with pytest.raises(ValueError, match="all be on the CPU, all on CUDA or all on meta"):
        ops.kernel_matvec_multi(ta, tb.to("meta"), tv.to("meta"),
                                kernels=("rbf", "laplacian"), sigmas=(1, 1), weights=(0.5, 0.5))
    # the CUDA wrappers take no CPU tensor: nothing falls back to the plain version
    with pytest.raises(ValueError, match="CUDA device"):
        kernel_matvec_multi_cuda(ta, tb, tv, (0.5, 0.5), kernels=("rbf", "laplacian"),
                                 sigmas=(1.0, 1.0), precision="f32")
    with pytest.raises(ValueError, match="CUDA device"):
        kernel_matvec_components_cuda(ta, tb, tv, kernels=("rbf",), sigmas=(1.0,), precision="f32")
    with pytest.raises(ValueError, match="CUDA device"):
        kernel_block_multi_cuda(ta, tb, kernels=("rbf",), sigmas=(1.0,), weights=(1.0,),
                                precision="f32")


# ---------------------------------------------------------------------------
# WeightedSumKernelOperator against repro.core.multikernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("combo", sorted(COMBOS))
def test_weighted_operator_contract_matches(rng, combo):
    kernels, sigmas = COMBOS[combo]
    q, n = len(kernels), 48
    x = (rng.standard_normal((n, 5)) / np.sqrt(5)).astype(np.float32)
    a = (rng.standard_normal((11, 5)) / np.sqrt(5)).astype(np.float32)
    v = rng.standard_normal((n, 3)).astype(np.float32)
    wc = rng.dirichlet(np.ones(q), size=3).T.astype(np.float32)
    weights = tuple(float(w) for w in rng.dirichlet(np.ones(q)))
    idx = np.array([3, 11, 40, 41, 7])
    jop = j_mk.WeightedSumKernelOperator(x=jnp.asarray(x), kernels=kernels, sigma=sigmas,
                                         weights=weights, backend="xla")
    top = WeightedSumKernelOperator(x=_t(x), kernels=kernels, sigma=sigmas, weights=weights)
    assert (top.q, top.sigmas, top.weights, top.shape, top.n, top.d) == (
        jop.q, jop.sigmas, jop.weights, jop.shape, jop.n, jop.d)
    pairs = [
        (top.matvec(_t(v)), jop.matvec(v)),
        (top.matvec(_t(v[:, 0])), jop.matvec(v[:, 0])),
        (top.row_block_matvec(_t(a), _t(v)), jop.row_block_matvec(a, v)),
        (top.block(_t(a)), jop.block(a)),
        (top.block(_t(a), _t(x)), jop.block(a, x)),
        (top.block_idx(_t(idx)), jop.block_idx(jnp.asarray(idx))),
        (top.trace_est(), jop.trace_est()),
        (top.k_lam_matvec(_t(v), 0.3), jop.k_lam_matvec(v, 0.3)),
        (top.sketch(_t(v)), jop.sketch(v)),
        (top.matvec_cols(_t(v), _t(wc)), jop.matvec_cols(v, jnp.asarray(wc))),
        (top.row_block_matvec_cols(_t(a), _t(v), _t(wc)),
         jop.row_block_matvec_cols(a, v, jnp.asarray(wc))),
        (top.sketch_components(_t(v)), jop.sketch_components(v)),
        (top.row_block_components(_t(a), _t(v)), jop.row_block_components(a, v)),
        (top.restrict(_t(idx)).matvec(_t(v[idx])), jop.restrict(jnp.asarray(idx)).matvec(v[idx])),
        (top.with_points(_t(a)).matvec(_t(v[:11])), jop.with_points(a).matvec(v[:11])),
        (top.with_weights(wc[:, 0]).matvec(_t(v)), jop.with_weights(wc[:, 0]).matvec(v)),
    ]
    for got, want in pairs:
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, **_tol(want, *F32_TOL))
    comps = top.components()
    assert all(isinstance(c, KernelOperator) for c in comps)
    assert [(c.kernel, c.sigma) for c in comps] == [(c.kernel, c.sigma) for c in jop.components()]
    shared = WeightedSumKernelOperator(x=_t(x), kernels=kernels, sigma=(0.9,) * q)
    assert shared.sigma == 0.9 and shared.weights == (1.0 / q,) * q  # canonicalized as JAX's


@pytest.mark.parametrize("kw", [
    dict(kernels=()),
    dict(kernels=("rbf", "gauss")),
    dict(kernels=("rbf", "laplacian"), sigma=(1.0, 2.0, 3.0)),
    dict(kernels=("rbf", "laplacian"), sigma=(1.0, -2.0)),
    dict(kernels=("rbf", "laplacian"), sigma=1.0, weights=(1.0,)),
    dict(kernels=("rbf", "laplacian"), sigma=1.0, weights=(-1.0, 2.0)),
    dict(kernels=("rbf", "laplacian"), sigma=1.0, weights=(0.0, 0.0)),
])
def test_canonical_kernels_errors_match(kw):
    kw = {"sigma": 1.0, "weights": None, **kw}
    with pytest.raises(ValueError) as want:
        j_mk.canonical_kernels(kw["kernels"], kw["sigma"], kw["weights"])
    with pytest.raises(ValueError) as got:
        canonical_kernels(kw["kernels"], kw["sigma"], kw["weights"])
    assert str(got.value) == str(want.value)  # word for word


def test_make_operator_dispatch_and_errors_match(rng):
    x = rng.standard_normal((12, 3)).astype(np.float32)
    gram = np.asarray(x @ x.T, np.float32)
    assert isinstance(make_operator(_t(x), kernel="rbf"), KernelOperator)
    assert isinstance(make_operator(_t(x), kernel=["rbf", "cosine"]), WeightedSumKernelOperator)
    assert isinstance(make_operator(_t(gram), kernel="precomputed"), PrecomputedKernelOperator)
    for kw in (dict(kernel="precomputed", weights=(1.0,)), dict(kernel="rbf", weights=(1.0,)),
               dict(kernel="rbf", sigma=(1.0, 2.0))):
        xin = gram if kw["kernel"] == "precomputed" else x
        with pytest.raises(ValueError) as want:
            j_mk.make_operator(jnp.asarray(xin), **kw)
        with pytest.raises(ValueError) as got:
            make_operator(_t(xin), **kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# a multi-kernel ASkotch solve, both packages on the same problem
# ---------------------------------------------------------------------------

#: both solves run to this per-head residual; their final residuals and
#: test RMSEs must then agree within DELTA (two approximate solutions of one
#: system)
SOLVE_TOL, DELTA, LAM = 1e-4, 1e-3, 1e-2
MK_KERNELS, MK_SIGMAS, MK_WEIGHTS = ("rbf", "laplacian", "matern52"), (0.9, 1.7, 1.2), (0.5, 0.2, 0.3)
SOLVE_KW = dict(block_size=64, rank=16, max_iters=400, eval_every=10, tol=SOLVE_TOL, seed=0)


def test_multikernel_askotch_solve_matches():
    x, y, xt, yt = (np.asarray(a) for a in j_synthetic.krr_regression(1, 512, 6, n_test=128))
    jp = JProblem(x=jnp.asarray(x), y=jnp.asarray(y), kernel=MK_KERNELS, sigma=MK_SIGMAS,
                  weights=MK_WEIGHTS, lam_unscaled=LAM, backend="xla")
    jout = j_solve(jp, "askotch", **SOLVE_KW)
    tp, tw = convert.from_reference(x, y, np.asarray(jout.w), kernel=list(MK_KERNELS),
                                    sigma=list(MK_SIGMAS), weights=MK_WEIGHTS, lam_unscaled=LAM,
                                    device="cpu")
    assert isinstance(tp.op, WeightedSumKernelOperator) and tp.op.sigmas == MK_SIGMAS
    # the reference's solution seen through the port: the same residual
    j_rel = float(jp.residual_report(jout.w)[0])
    np.testing.assert_allclose(float(tp.residual_report(tw)[0]), j_rel, rtol=1e-3, atol=1e-6)
    tout = solve(tp, "askotch", **SOLVE_KW)
    assert jout.info["converged"] and tout.info["converged"]
    t_rel = float(tp.residual_report(tout.w)[0])
    assert abs(t_rel - j_rel) < DELTA
    j_rmse = float(j_evaluate(jout.predict_fn(jnp.asarray(xt)), jnp.asarray(yt)).rmse)
    t_rmse = float(evaluate(tout.predict_fn(_t(xt)), _t(yt)).rmse)
    assert abs(j_rmse - t_rmse) < DELTA
    # the universal kernel= / weights= overrides reach the same operator
    over = solve(convert.from_reference(x, y, tw, lam_unscaled=LAM, device="cpu")[0], "askotch",
                 kernel=MK_KERNELS, weights=MK_WEIGHTS, **{**SOLVE_KW, "max_iters": 10})
    assert over.w.shape == (512,) and np.isfinite(over.history[-1]["rel_residual"])
