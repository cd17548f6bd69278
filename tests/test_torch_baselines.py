"""The port's baseline solvers (PCG with Nystrom / RPCholesky / RFF / no
preconditioner, Falkon, EigenPro, direct) held against the JAX package.

Inputs are made with numpy from a seed; JAX runs on the CPU
(``backend="xla"``), the port on CPU tensors.  Every randomized step gets
the reference's own draws injected (omega, the pivots, the RFF frequencies
and phases, the Falkon centers, EigenPro's subsample and permutations):
torch's generators never reproduce JAX's streams.  Tolerances, stated where
used: "relative" is ||got - want|| / ||want||; elementwise checks scale
their atol by max(1, |want|max), as the port's other parity tests do.
"""

import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import direct as j_direct  # noqa: E402
from repro.core import eigenpro as j_eigenpro  # noqa: E402
from repro.core import falkon as j_falkon  # noqa: E402
from repro.core import pcg as j_pcg  # noqa: E402
from repro.core import rff as j_rff  # noqa: E402
from repro.core import rpcholesky as j_rpc  # noqa: E402
from repro.core.krr import KRRProblem as JProblem  # noqa: E402
from repro.core.operator import KernelOperator as JOperator  # noqa: E402
from repro_torch.core import direct, eigenpro, falkon, pcg, rff, rpcholesky  # noqa: E402
from repro_torch.core.krr import KRRProblem  # noqa: E402
from repro_torch.core.operator import KernelOperator  # noqa: E402
from repro_torch.core.solver_api import METHOD_OPTIONS, METHODS, PORTED_METHODS, solve  # noqa: E402

N, D, SIGMA, LAM_UNSCALED = 384, 5, 1.5, 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy (JAX arrays are read-only)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close(got, want, rtol, atol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())))


def _data(seed, n=N, t=None):
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, D)).astype(np.float32)
    f = np.sin(2 * x[:, 0]) + 0.3 * x[:, 1]
    if t is None:
        y = f + 0.05 * r.standard_normal(n)
    else:
        y = f[:, None] * np.linspace(0.5, 1.5, t)[None, :] + 0.05 * r.standard_normal((n, t))
    return x, y.astype(np.float32)


def _problems(x, y, kernel="rbf", sigma=SIGMA):
    jp = JProblem(x=jnp.asarray(x), y=jnp.asarray(y), kernel=kernel, sigma=sigma,
                  lam_unscaled=LAM_UNSCALED, backend="xla")
    tp = KRRProblem(x=_t(x), y=_t(y), kernel=kernel, sigma=sigma, lam_unscaled=LAM_UNSCALED)
    return jp, tp


@pytest.fixture(scope="module")
def data():
    return _data(7)


# ---------------------------------------------------------------------------
# RFF and RPCholesky factors
# ---------------------------------------------------------------------------


def _j_rff_draws(key, kernel, rank, d, sigma):
    """W and b exactly as ``repro.core.rff.rff_features`` draws them."""
    kw, kb = jax.random.split(key)
    w = j_rff.sample_freqs(kw, kernel, rank, d, sigma)
    b = jax.random.uniform(kb, (rank,), jnp.float32, minval=0.0, maxval=2.0 * jnp.pi)
    return _t(w), _t(b)


def test_rff_features_match_with_injected_draws(data):
    """rbf features from the reference's W and b: rtol 1e-5, atol 1e-5."""
    x, _ = data
    key, rank = jax.random.PRNGKey(3), 64
    want = j_rff.rff_features(key, jnp.asarray(x), rank, SIGMA, chunk=100)
    w, b = _j_rff_draws(key, "rbf", rank, D, SIGMA)
    got = rff.rff_features(None, _t(x), rank, SIGMA, chunk=100, freqs=w, phases=b)
    _close(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("kernel", rff.RFF_KERNELS)
def test_rff_preconditioner_apply_matches(data, kernel):
    """The pcg-rff P^{-1} apply on a fixed (n, 3) block, from the
    reference's draws: rtol 1e-3 (the apply, not U column by column: signs
    and near-degenerate columns are arbitrary)."""
    x, y = data
    jp, tp = _problems(x, y, kernel)
    rank, seed = 24, 2
    c = rff.DEFAULT_OVERSAMPLE[kernel]
    w, b = _j_rff_draws(jax.random.PRNGKey(seed), kernel, c * rank, D, SIGMA)
    v = np.random.default_rng(11).standard_normal((N, 3)).astype(np.float32)
    want = j_pcg.make_preconditioner(jp, "rff", rank, seed=seed)(jnp.asarray(v))
    got = pcg.make_preconditioner(tp, "rff", rank, seed=seed, freqs=w, phases=b)(_t(v))
    _close(got, want, 1e-3, 1e-3)


def test_rff_draws_from_generator():
    """Without injection each measure draws from the generator: reproducible
    from a seed, finite, with the measure's scale (rbf: unit variance
    times 1/sigma^2)."""
    g = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    for kernel in rff.RFF_KERNELS:
        w1 = rff.sample_freqs(g(), kernel, 2000, 3, 2.0)
        assert torch.equal(w1, rff.sample_freqs(g(), kernel, 2000, 3, 2.0))
        assert w1.shape == (2000, 3) and bool(torch.isfinite(w1).all())
    assert abs(float(rff.sample_freqs(g(), "rbf", 4000, 2, 2.0).var()) - 0.25) < 0.03
    with pytest.raises(ValueError, match="no RFF spectral measure"):
        rff.sample_freqs(g(), "linear", 4, 2, 1.0)


def test_rp_cholesky_matches_with_injected_pivots(data):
    """F from the reference's pivots: atol 1e-4."""
    x, _ = data
    jop = JOperator(x=jnp.asarray(x[:200]), kernel="rbf", sigma=SIGMA, backend="xla")
    f_want, piv = j_rpc.rp_cholesky(jax.random.PRNGKey(0), jop, 30)
    f_got, piv_got = rpcholesky.rp_cholesky(None, KernelOperator(x=_t(x[:200]), sigma=SIGMA), 30,
                                            pivots=_t(piv))
    np.testing.assert_allclose(f_got.numpy(), np.asarray(f_want), rtol=0, atol=1e-4)
    assert piv_got.tolist() == np.asarray(piv).tolist()
    # drawn pivots: mostly distinct, and the factor shrinks the residual trace
    g = torch.Generator().manual_seed(0)
    op = KernelOperator(x=_t(x[:200]), sigma=SIGMA)
    f, p = rpcholesky.rp_cholesky(g, op, 30)
    assert len(set(p.tolist())) > 25
    assert float(torch.trace(op.block(op.x) - f @ f.T)) < 0.5 * 200


# ---------------------------------------------------------------------------
# PCG family, direct, Falkon, EigenPro
# ---------------------------------------------------------------------------


def _pcg_draws(precond, jp, rank, seed, kernel="rbf"):
    """The reference's draws for ``make_preconditioner(kind, rank, seed)``."""
    key = jax.random.PRNGKey(seed)
    if precond == "nystrom":
        return {"omega": _t(jax.random.normal(key, (jp.n, rank), jnp.float32))}
    if precond == "rpcholesky":
        return {"pivots": _t(j_rpc.rp_cholesky(key, jp.op, rank)[1])}
    if precond == "rff":
        c = rff.DEFAULT_OVERSAMPLE[kernel]
        w, b = _j_rff_draws(key, kernel, c * rank, D, SIGMA)
        return {"freqs": w, "phases": b}
    return {}


@pytest.mark.parametrize("precond", ["nystrom", "rpcholesky", "rff", "identity"])
def test_pcg_matches_with_injected_draws(data, precond):
    """The first 10 residuals within 1e-3 relative of the reference's; the
    converged w within 1e-3 relative of the reference's and 1e-2 of
    ``solve_direct``.  Plain CG runs at sigma 0.7: at sigma 1.5 the
    reference's own f32 residual history moves by 10-50 % at iterations
    7-10 when y moves by 1e-7 relative, so no second implementation can
    match it there; at 0.7 it moves by ~1e-6."""
    x, y = data
    jp, tp = _problems(x, y, sigma=0.7 if precond == "identity" else SIGMA)
    kw = dict(precond=precond, rank=40, max_iters=400, tol=1e-7, seed=1)
    want = j_pcg.solve_pcg(jp, **kw)
    got = pcg.solve_pcg(tp, **kw, **_pcg_draws(precond, jp, 40, 1))
    r_want = np.array([h["rel_residual"] for h in want.history[:10]])
    r_got = np.array([h["rel_residual"] for h in got.history[:10]])
    np.testing.assert_allclose(r_got, r_want, rtol=1e-3)
    assert got.converged and want.converged
    assert _rel(got.w, want.w) < 1e-3
    assert _rel(got.w, direct.solve_direct(tp)) < 1e-2


def test_pcg_residual_climbs_while_objective_falls():
    """On taxi-like data with a wide kernel (sigma 4: at 512 rows, the
    conditioning the taxi configuration has at 10^6) PCG's relative
    residual climbs above its start of 1 within 12 iterations, in the
    reference as in the port, while CG's objective 1/2 w'(K + lam I)w - y'w
    falls at every iteration.  The port's first 4 residuals are within 1e-3
    relative of the reference's (the later ones drift apart in f32, as the
    reference's own do under a 1e-7 change of y)."""
    from repro.data import synthetic as j_synthetic

    x, y = (np.asarray(a) for a in j_synthetic.taxi_like(0, 512, 9))
    jp = JProblem(x=jnp.asarray(x), y=jnp.asarray(y), sigma=4.0, lam_unscaled=2e-7,
                  backend="xla")
    tp = KRRProblem(x=_t(x), y=_t(y), sigma=4.0, lam_unscaled=2e-7)
    r_want = [h["rel_residual"] for h in j_pcg.solve_pcg(jp, rank=20, max_iters=12).history]
    draws = _pcg_draws("nystrom", jp, 20, 0)
    r_got = [h["rel_residual"] for h in pcg.solve_pcg(tp, rank=20, max_iters=12, **draws).history]
    np.testing.assert_allclose(r_got[:4], r_want[:4], rtol=1e-3)
    assert max(r_want) > 1.0 and max(r_got) > 1.0
    objective = []
    for k in range(1, 13):
        w = pcg.solve_pcg(tp, rank=20, max_iters=k, **draws).w.double()
        kw = tp.op.k_lam_matvec(w.float(), tp.lam).double()
        objective.append(float(0.5 * w @ kw - tp.y.double() @ w))
    assert objective[0] < 0 and all(b < a for a, b in zip(objective, objective[1:]))


def test_pcg_multirhs_and_multikernel_match(rng):
    """t = 3 heads, then kernel=("rbf", "matern52") through solve(): w within
    1e-3 relative of the reference's, per head and in all."""
    x, y = _data(5, t=3)
    jp, tp = _problems(x, y)
    draws = _pcg_draws("nystrom", jp, 40, 0)
    want = j_pcg.solve_pcg(jp, rank=40, max_iters=300, tol=1e-7)
    got = pcg.solve_pcg(tp, rank=40, max_iters=300, tol=1e-7, **draws)
    assert got.w.shape == (N, 3) and len(got.history[-1]["rel_residual_per_head"]) == 3
    for h in range(3):
        assert _rel(got.w[:, h], want.w[:, h]) < 1e-3
    x, y = _data(6)
    jp, tp = _problems(x, y)
    kern = ("rbf", "matern52")
    jp_mk = JProblem(x=jp.x, y=jp.y, kernel=kern, sigma=SIGMA, lam_unscaled=LAM_UNSCALED,
                     backend="xla")
    want = j_pcg.solve_pcg(jp_mk, rank=40, max_iters=300, tol=1e-7)
    out = solve(tp, "pcg-nystrom", kernel=kern, rank=40, max_iters=300, tol=1e-7)
    assert out.info["converged"]
    assert _rel(out.w, want.w) < 1e-2  # drawn omega (not injected): outcome only
    got = pcg.solve_pcg(KRRProblem(x=tp.x, y=tp.y, kernel=kern, sigma=SIGMA,
                                   lam_unscaled=LAM_UNSCALED),
                        rank=40, max_iters=300, tol=1e-7, **_pcg_draws("nystrom", jp_mk, 40, 0))
    assert _rel(got.w, want.w) < 1e-3


@pytest.mark.parametrize("t", [None, 2])
def test_direct_and_loo_match(t):
    """solve_direct and loo_residuals within 1e-3 relative."""
    x, y = _data(8, n=256, t=t)
    jp, tp = _problems(x, y)
    assert _rel(direct.solve_direct(tp), j_direct.solve_direct(jp)) < 1e-3
    assert _rel(direct.loo_residuals(tp), j_direct.loo_residuals(jp)) < 1e-3
    assert abs(direct.loo_mse(tp) / j_direct.loo_mse(jp) - 1) < 1e-3


def test_falkon_matches_with_injected_centers(data):
    """w and the predictions within 1e-3 relative, centers injected."""
    x, y = data
    jp, tp = _problems(x, y)
    want = j_falkon.solve_falkon(jp, 96, max_iters=60, seed=3)
    got = falkon.solve_falkon(tp, 96, max_iters=60, centers_idx=_t(want.centers_idx))
    assert got.w.shape == (96,)
    assert _rel(got.w, want.w) < 1e-3
    xt = np.random.default_rng(12).standard_normal((64, D)).astype(np.float32)
    assert _rel(falkon.falkon_predict(tp, got, _t(xt)),
                j_falkon.falkon_predict(jp, want, jnp.asarray(xt))) < 1e-3


def test_eigenpro_matches_with_injected_draws(data):
    """w after one epoch within 1e-3 relative, with the reference's
    subsample and permutation injected."""
    x, y = data
    jp, tp = _problems(x, y)
    kw = dict(rank=30, subsample=200, batch_size=48, epochs=1, eval_every=4, seed=2)
    want = j_eigenpro.solve_eigenpro(jp, **kw)
    ks, kperm = jax.random.split(jax.random.PRNGKey(2))
    sub_idx = jax.random.choice(ks, N, (200,), replace=False)
    perm = jax.random.permutation(jax.random.split(kperm)[1], N)
    got = eigenpro.solve_eigenpro(tp, **kw, sub_idx=_t(sub_idx), perms=[_t(perm)])
    assert got.iters == want.iters == N // 48
    assert _rel(got.w, want.w) < 1e-3
    r_want = [h["rel_residual"] for h in want.history]
    r_got = [h["rel_residual"] for h in got.history]
    np.testing.assert_allclose(r_got, r_want, rtol=1e-3)


# ---------------------------------------------------------------------------
# solve() and the launcher
# ---------------------------------------------------------------------------


def test_solve_runs_every_ported_method_and_fails_fast():
    x, y = _data(9, n=128)
    p = KRRProblem(x=_t(x), y=_t(y), sigma=SIGMA, lam_unscaled=LAM_UNSCALED)
    assert PORTED_METHODS == METHODS
    small = {"falkon": {"m": 32, "max_iters": 5}, "eigenpro": {"rank": 8, "subsample": 40},
             "direct": {}, "askotch": {"block_size": 32, "rank": 8, "max_iters": 2},
             "skotch": {"block_size": 32, "rank": 8, "max_iters": 2}}
    for method in PORTED_METHODS:
        out = solve(p, method, **small.get(method, {"rank": 8, "max_iters": 5}))
        assert out.w.shape == ((32,) if method == "falkon" else (128,))
        assert bool(torch.isfinite(out.predict_fn(p.x[:5])).all())
        with pytest.raises(ValueError, match=r"unknown option\(s\) \['bogus'\].*accepted"):
            solve(p, method, bogus=1)
        if method != "askotch":
            with pytest.raises(TypeError, match="telemetry"):
                solve(p, method, telemetry=object(), **small.get(method, {"max_iters": 1}))
    with pytest.raises(ValueError, match="inner solver"):
        solve(p, "dc", dc_method="dc")
    assert set(METHOD_OPTIONS) == set(PORTED_METHODS)
    # every method takes t = 3 heads and the universal overrides (pcg-rff:
    # one shift-invariant kernel only)
    x3, y3 = _data(9, n=128, t=3)
    p3 = KRRProblem(x=_t(x3), y=_t(y3), sigma=SIGMA, lam_unscaled=LAM_UNSCALED)
    for method in PORTED_METHODS:
        for over in ({}, {"kernel": ("rbf", "laplacian"), "weights": (0.7, 0.3)},
                     {"precision": "bf16"}):
            if method == "pcg-rff" and "kernel" in over:
                continue
            out = solve(p3, method, **over, **small.get(method, {"rank": 8, "max_iters": 5}))
            assert out.w.shape == ((32, 3) if method == "falkon" else (128, 3))
            assert out.predict_fn(p3.x[:5]).shape == (5, 3)
            assert bool(torch.isfinite(out.w).all())
    with pytest.raises(ValueError, match="has no RFF spectral measure|shift-invariant"):
        solve(p, "pcg-rff", kernel="linear", max_iters=1)


def test_solve_mesh_keyword():
    """mesh=None is the reference's default and runs; a solver mesh runs
    the methods with a distributed path and refuses the others."""
    from repro_torch.distributed.meshes import make_solver_mesh

    x, y = _data(10, n=64)
    p = KRRProblem(x=_t(x), y=_t(y), sigma=SIGMA, lam_unscaled=LAM_UNSCALED)
    assert solve(p, "direct", mesh=None).w.shape == (64,)
    mesh = make_solver_mesh("1x1", device="cpu")
    out = solve(p, "cg", mesh=mesh, max_iters=1)
    assert out.w.shape == (64,) and out.info["mesh"] == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="no distributed path"):
        solve(p, "direct", mesh=mesh)


def test_launcher_falkon_keys_match_reference(capsys, monkeypatch):
    """``--method falkon`` prints the JAX launcher's keys in order, with
    rel_residual -1 and the reference's center count."""
    from repro.launch import krr_solve as j_launch
    from repro_torch.launch import krr_solve as t_launch

    argv = ["--n", "120", "--n-test", "30", "--d", "3", "--iters", "20", "--method", "falkon"]
    monkeypatch.setattr(sys, "argv", ["krr_solve", *argv])
    j_launch.main()
    j_report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    report = t_launch.main([*argv, "--device", "cpu"])
    assert list(report) == list(j_report)
    assert report["rel_residual"] == -1.0 and report["m"] == j_report["m"] == 50
    assert np.isfinite(report["test_rmse"])
