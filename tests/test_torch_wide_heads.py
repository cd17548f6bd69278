"""``kernel_matvec`` at 17 <= t <= 32 and the weighted matvec with static
weights at 2 <= t <= 16, the shapes of the multi-column sweeps of
``csrc/kernel_matvec.cu`` and ``csrc/kernel_multi.cu``: the port's ``ops``
on the CPU (its plain versions) against the JAX package's Pallas kernels in
interpret mode; the weighted matvec's route choice; and a multi-kernel
one-vs-all ASkotch solve against the JAX package's.

The sweeps themselves are held against the same plain versions on the card
(tests/test_torch_heads_cuda.py, chip_smoke.py).  The rows and columns of
K(A, B) V are independent, so each JAX reference is computed once, at 64
rows and the widest t, and each (m, t) case is held against its first m
rows and t columns; interpret mode is slow.  Tolerances are those of
tests/test_kernels_pallas.py: f32 rtol 2e-4 / atol 2e-5 scaled by max(1,
|ref|max) (summation order differs), bf16 (0.05, 0.02) (one bf16 ulp of a
kernel value can differ where the f32 distances round differently).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.krr import KRRProblem as JProblem  # noqa: E402
from repro.core.krr import evaluate as j_evaluate  # noqa: E402
from repro.core.solver_api import solve as j_solve  # noqa: E402
from repro.data import synthetic as j_synthetic  # noqa: E402
from repro.kernels.kernel_matvec import kernel_matvec_pallas  # noqa: E402
from repro.kernels.multi import kernel_matvec_multi_pallas  # noqa: E402
from repro_torch.core.krr import KRRProblem, evaluate  # noqa: E402
from repro_torch.core.solver_api import solve  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.multi import matvec_multi_route  # noqa: E402

N, D, SIGMA = 1103, 9, 1.3
M = (1, 64)
WIDE_T = (17, 20, 24, 32)
HEADS_T = (2, 10, 16)
TOL = {"f32": (2e-4, 2e-5), "bf16": (0.05, 0.02)}
#: the refit's combination (rbf + laplacian + matern52: the l2 and l1
#: families) with its own sigmas and static weights
MK_KERNELS, MK_SIGMAS, MK_WEIGHTS = ("rbf", "laplacian", "matern52"), (1.3, 0.8, 2.2), (0.5, 0.2, 0.3)


@functools.lru_cache(maxsize=None)
def _operands():
    rng = np.random.default_rng(27)
    a = (rng.standard_normal((max(M), D)) / 3).astype(np.float32)
    a[3] = 0.0  # cosine's zero-norm-as-1 rule
    b = (rng.standard_normal((N, D)) / 3).astype(np.float32)
    v = rng.standard_normal((N, max(WIDE_T))).astype(np.float32)
    return a, b, v


@functools.lru_cache(maxsize=None)
def _reference(op: str, kern: str, precision: str) -> np.ndarray:
    a, b, v = _operands()
    if op == "kernel_matvec":
        return np.asarray(kernel_matvec_pallas(a, b, v, kernel=kern, sigma=SIGMA, interpret=True,
                                               precision=precision))
    return np.asarray(kernel_matvec_multi_pallas(
        a, b, v[:, :max(HEADS_T)], jnp.asarray(MK_WEIGHTS, jnp.float32), kernels=MK_KERNELS,
        sigmas=MK_SIGMAS, interpret=True, precision=precision))


def _port(op: str, kern: str, precision: str, m: int, t: int) -> np.ndarray:
    a, b, v = _operands()
    a, b, vt = (torch.from_numpy(np.ascontiguousarray(x)) for x in (a[:m], b, v[:, :t]))
    if op == "kernel_matvec":
        return ops.kernel_matvec(a, b, vt, kernel=kern, sigma=SIGMA, precision=precision).numpy()
    return ops.kernel_matvec_multi(a, b, vt, kernels=MK_KERNELS, sigmas=MK_SIGMAS,
                                   weights=MK_WEIGHTS, precision=precision).numpy()


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("m", M)
@pytest.mark.parametrize("op,kern,t", [("kernel_matvec", k, t) for k in ("rbf", "laplacian")
                                       for t in WIDE_T]
                         + [("kernel_matvec_multi", "l2+l1", t) for t in HEADS_T])
def test_sweep_widths_match_pallas_interpret(op, kern, t, m, precision):
    """kernel_matvec at 17 <= t <= 32 (rbf, laplacian) and the weighted
    matvec with (q,) weights at 2 <= t <= 16 (q = 3), m in {1, 64}."""
    want = _reference(op, kern, precision)[:m, :t]
    got = _port(op, kern, precision, m, t)
    assert got.dtype == np.float32 and got.shape == (m, t)
    rtol, atol = TOL[precision]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("t,per_column,route", [
    (1, False, "t1"), (1, True, "t1"), (2, False, "heads"), (10, False, "heads"),
    (16, False, "heads"), (17, False, "cols"), (2, True, "cols"), (10, True, "cols"),
    (160, True, "cols"), (160, False, "cols"),
])
def test_weighted_matvec_route(t, per_column, route):
    """t = 1 on the weighted t = 1 sweep; static weights up to the heads'
    limit (16, the library's) on the weighted heads; per-column weights and
    wider V on the column path."""
    assert matvec_multi_route(t, per_column, 16) == route


#: both solves run to this per-head residual; their test accuracies must then
#: agree within ACC_DELTA (two approximate solutions of one system: a
#: handful of the 128 test points may fall on the other side of a margin)
SOLVE_TOL, ACC_DELTA, LAM = 1e-4, 0.02, 1e-2
SOLVE_KW = dict(block_size=64, rank=16, max_iters=400, eval_every=10, tol=SOLVE_TOL, seed=0)


def test_multikernel_one_vs_all_solve():
    """A multi-kernel (rbf + laplacian + matern52, static weights) one-vs-all
    askotch solve of 10 heads at n = 512 in both packages: every head
    converges below tol, and the top-1 test accuracies agree within
    ACC_DELTA.  JAX's and torch's draws differ, so the solves are judged by
    their outcome."""
    t = 10
    jx, jy, _, jxt, jyt, _ = j_synthetic.krr_one_vs_all(5, 512, 6, num_classes=t, n_test=128)
    tx, ty, _, txt, tyt, _ = synthetic.krr_one_vs_all(5, 512, 6, num_classes=t, n_test=128,
                                                      device="cpu")
    mk = dict(kernel=MK_KERNELS, sigma=MK_SIGMAS, weights=MK_WEIGHTS, lam_unscaled=LAM)
    jout = j_solve(JProblem(x=jx, y=jy, backend="xla", **mk), "askotch", **SOLVE_KW)
    tout = solve(KRRProblem(x=tx, y=ty, **mk), "askotch", **SOLVE_KW)
    for out in (jout, tout):
        assert out.info["converged"] and out.info["t"] == t
        assert max(out.info["rel_residual_per_head"]) < SOLVE_TOL
    assert tout.w.shape == (512, t)
    j_acc = float(j_evaluate(jout.predict_fn(jxt), jyt).accuracy)
    t_acc = float(evaluate(tout.predict_fn(txt), tyt).accuracy)
    assert abs(j_acc - t_acc) <= ACC_DELTA
