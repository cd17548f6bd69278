"""The port's distributed tier (``repro_torch.distributed.meshes`` /
``sharded_operator`` / ``krr_dist`` and ``mesh=`` through solve, tune,
serving, the estimators and the launchers) held against the JAX package.

The port's meshes are ``SolverMesh``es of ``cpu`` devices at (1, 1), (2, 1)
and (2, 2): one process, the collectives made of tensor moves and sums.
JAX runs on its own single CPU device with a (1, 1) ``make_solver_mesh``
(no XLA flag is set).  Inputs are made with numpy from a seed (n <= 256,
d <= 5).  Tolerances are the kernel tests': f32 rtol 2e-4, atol 2e-5 x
max(1, |ref|max).  Randomized steps take the reference's draws, replayed
from its key splits on the host.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.solver_api import DIST_METHOD_OPTIONS as J_DIST_OPTIONS  # noqa: E402
from repro.distributed import krr_dist as j_dist  # noqa: E402
from repro.distributed.meshes import make_solver_mesh as j_make_mesh  # noqa: E402
from repro.distributed.sharded_operator import ShardedKernelOperator as JSharded  # noqa: E402
from repro_torch.core.krr import KRRProblem, evaluate  # noqa: E402
from repro_torch.core.multikernel import make_operator  # noqa: E402
from repro_torch.core.solver_api import DIST_METHOD_OPTIONS, solve, tune  # noqa: E402
from repro_torch.distributed import krr_dist  # noqa: E402
from repro_torch.distributed.meshes import (  # noqa: E402
    SolverMesh,
    make_solver_mesh,
    parse_mesh_spec,
)
from repro_torch.distributed.sharded_operator import ShardedKernelOperator  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.krr_serve import (  # noqa: E402
    make_krr_predict_fn,
    make_sharded_krr_predict_fn,
)

SHAPES = [(1, 1), (2, 1), (2, 2)]
N, D, T, B = 64, 5, 4, 12
CONFIGS = {
    "rbf": dict(kernel="rbf", sigma=1.5),
    "multi": dict(kernel=("rbf", "laplacian"), sigma=(1.5, 2.0), weights=(0.7, 0.3)),
}
_J_CACHE: dict = {}


def _close(got, want, rtol=2e-4, atol=2e-5):
    want = np.asarray(want)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())))


def _cpu_mesh(shape):
    return SolverMesh(["cpu"] * (shape[0] * shape[1]), shape=shape)


def _operands():
    r = np.random.default_rng(0)
    return dict(
        x=r.standard_normal((N, D)).astype(np.float32),
        v1=r.standard_normal((N,)).astype(np.float32),
        vt=r.standard_normal((N, T)).astype(np.float32),
        a=r.standard_normal((B, D)).astype(np.float32),
        idx=r.integers(0, N, B),
        omega=r.standard_normal((N, 6)).astype(np.float32),
        wc=r.dirichlet(np.ones(2), size=T).T.astype(np.float32),
    )


def _expected_collectives(shape, calls):
    """The reference's table (``sharded_operator.py:19-29``) for a list of
    (primitive, rows of its block or of x) calls on an (S, M) mesh."""
    s, m = shape
    want: dict = {}

    def add(prim, coll, k=1):
        key = f'repro_collective_dispatch_total{{collective="{coll}",primitive="{prim}"}}'
        want[key] = want.get(key, 0.0) + k

    for prim, rows in calls:
        if prim in ("matvec", "matvec_cols", "sketch_components"):
            if s > 1:
                add(prim, "all_gather", 2)
            if m > 1 and rows % m == 0:
                add(prim, "psum")
        elif prim == "row_block_matvec":
            if s > 1:
                add(prim, "psum")
            if m > 1 and rows % m == 0:
                add(prim, "all_gather")
        elif prim == "block":
            if m > 1 and rows % m == 0:
                add(prim, "all_gather")
        elif prim == "gather_rows" and s > 1:
            add(prim, "psum")
    return want


def _reference_results(name):
    """The reference's sharded operator on its (1, 1) mesh, once per config."""
    if name not in _J_CACHE:
        o = _operands()
        cfg = CONFIGS[name]
        jop = JSharded.bind(j_make_mesh("1x1"), jnp.asarray(o["x"]), backend="xla", **cfg)
        res = {
            "mv1": jop.matvec(jnp.asarray(o["v1"])), "mvt": jop.matvec(jnp.asarray(o["vt"])),
            "rb1": jop.row_block_matvec(o["a"], jnp.asarray(o["v1"])),
            "rbt": jop.row_block_matvec(o["a"], jnp.asarray(o["vt"])),
            "blk": jop.block(o["a"]), "bidx": jop.block_idx(jnp.asarray(o["idx"])),
            "tr": jop.trace_est(), "sk": jop.sketch(jnp.asarray(o["omega"])),
        }
        if name == "multi":
            res["cols"] = jop.matvec_cols(jnp.asarray(o["vt"]), o["wc"])
            res["comp"] = jop.sketch_components(jnp.asarray(o["omega"]))
        _J_CACHE[name] = {k: np.asarray(v) for k, v in res.items()}
    return _J_CACHE[name]


# ---------------------------------------------------------------------------
# the mesh and the sharded operator
# ---------------------------------------------------------------------------


def test_solver_mesh_specs_and_collectives():
    assert parse_mesh_spec("4x2") == (4, 2) and parse_mesh_spec("auto", "cpu") == (1, 1)
    with pytest.raises(ValueError, match="mesh spec '4y2' invalid"):
        parse_mesh_spec("4y2")
    mesh = make_solver_mesh("1x1", device="cpu")
    assert dict(mesh.shape) == {"data": 1, "model": 1} and mesh.axis_names == ("data", "model")
    with pytest.raises(ValueError, match="needs 2 cpu device"):
        make_solver_mesh("2x1", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_solver_mesh("1x1")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SolverMesh(["cuda:0"], shape=(1, 1))
    m = _cpu_mesh((2, 2))
    parts = {c: torch.full((2,), float(c[0] * 10 + c[1])) for c in m.coords()}
    s = m.psum(parts, "data")
    assert torch.equal(s[(1, 1)], torch.tensor([12.0, 12.0])) and s[(0, 1)] is s[(1, 1)]
    g = m.all_gather(parts, "model")
    assert torch.equal(g[(1, 0)], torch.tensor([10.0, 10.0, 11.0, 11.0]))
    assert m.psum(parts, "data") is not parts and _cpu_mesh((1, 1)).psum({(0, 0): parts[(0, 0)]},
                                                                      "data")[(0, 0)] is parts[(0, 0)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sharded_primitives_match_single_device_and_reference(shape, name):
    o = _operands()
    cfg = CONFIGS[name]
    want = _reference_results(name)
    x = torch.from_numpy(o["x"])
    op = make_operator(x, **cfg)
    sop = ShardedKernelOperator.bind(_cpu_mesh(shape), x, **cfg)
    v1, vt, a = torch.from_numpy(o["v1"]), torch.from_numpy(o["vt"]), torch.from_numpy(o["a"])
    idx, omega = torch.from_numpy(o["idx"]), torch.from_numpy(o["omega"])
    before = obs_metrics.snapshot()
    got = {
        "mv1": sop.matvec(v1), "mvt": sop.matvec(vt),
        "rb1": sop.row_block_matvec(a, v1), "rbt": sop.row_block_matvec(a, vt),
        "blk": sop.block(a), "bidx": sop.block_idx(idx), "tr": sop.trace_est(),
        "sk": sop.sketch(omega),
    }
    calls = [("matvec", N), ("matvec", N), ("row_block_matvec", B), ("row_block_matvec", B),
             ("block", B), ("gather_rows", B), ("block", B), ("matvec", N)]
    if name == "multi":
        wc = torch.from_numpy(o["wc"])
        got["cols"] = sop.matvec_cols(vt, wc)
        got["comp"] = sop.sketch_components(omega)
        calls += [("matvec_cols", N), ("sketch_components", N)]
        _close(got["cols"], op.matvec_cols(vt, wc))
        _close(got["comp"], op.sketch_components(omega))
    counts = {k: v for k, v in obs_metrics.diff(before, obs_metrics.snapshot()).items()
              if k.startswith("repro_collective_dispatch_total")}
    assert counts == _expected_collectives(shape, calls)
    single = {"mv1": op.matvec(v1), "mvt": op.matvec(vt), "rb1": op.row_block_matvec(a, v1),
              "rbt": op.row_block_matvec(a, vt), "blk": op.block(a), "bidx": op.block_idx(idx),
              "tr": op.trace_est(), "sk": op.sketch(omega)}
    for k, v in got.items():
        if k in single:
            _close(v, single[k])
        _close(v, want[k])
    if shape == (1, 1):  # one shard: the single-device sweeps exactly
        for k in ("mv1", "mvt", "rb1", "rbt", "blk", "bidx", "sk"):
            assert torch.equal(got[k], single[k]), k
    # gather_rows is exact: one owner per row, the others add zeros
    (xb, yb, tb), owned = sop.gather_rows(idx, v1, vt)
    assert torch.equal(xb, x[idx]) and torch.equal(yb, v1[idx]) and torch.equal(tb, vt[idx])
    assert owned.shape == (shape[0] * B,) and torch.equal(
        owned.reshape(shape[0], B).sum(0), torch.ones(B))
    _close(sop.k_lam_matvec(vt, 0.3), op.k_lam_matvec(vt, 0.3))
    sub = sop.restrict(idx)
    assert sub.n == B and not isinstance(sub, ShardedKernelOperator)
    _close(sub.matvec(vt[:B]), op.restrict(idx).matvec(vt[:B]))
    _close(sop.with_points(x[:32]).matvec(v1[:32]), op.with_points(x[:32]).matvec(v1[:32]))
    # two runs of one mesh are bitwise equal (a fixed psum order)
    assert torch.equal(sop.matvec(vt), got["mvt"])


def test_bind_and_unbound_operator_errors():
    x = torch.zeros((10, 2))
    with pytest.raises(ValueError, match="do not shard evenly over 4 row"):
        ShardedKernelOperator.bind(_cpu_mesh((4, 1)), x)
    unbound = ShardedKernelOperator(mesh=_cpu_mesh((1, 1)))
    with pytest.raises(ValueError, match="unbound"):
        unbound.matvec(torch.zeros(10))
    with pytest.raises(ValueError, match="multi-kernel"):
        ShardedKernelOperator.bind(_cpu_mesh((1, 1)), x).matvec_cols(torch.zeros(10, 2),
                                                                    torch.ones(1, 2))


# ---------------------------------------------------------------------------
# distributed ASkotch / PCG
# ---------------------------------------------------------------------------


def _krr_data(n=256, d=4, t=3, seed=0, n_test=64, lam=1e-3):
    """y = (K + lam I) w_true for a random w_true, and test targets from the
    same w_true (so a converged solve predicts them exactly)."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((n + n_test, d)).astype(np.float32)
    w_true = r.standard_normal((n, t)).astype(np.float32)
    op = make_operator(torch.from_numpy(x[:n]), kernel="rbf", sigma=1.5)
    y = op.k_lam_matvec(torch.from_numpy(w_true), n * lam)
    y_te = op.row_block_matvec(torch.from_numpy(x[n:]), torch.from_numpy(w_true))
    return x[:n], y.numpy(), x[n:], y_te.numpy()


@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_dist_askotch_steps_match_reference_with_injected_draws(shape, heads):
    n, b, r = 128, 32, 8
    x, y, _, _ = _krr_data(n=n, t=heads)
    y = y[:, 0] if heads == 1 else y
    key = ("step", heads)
    if key not in _J_CACHE:
        jm = j_make_mesh("1x1")
        jcfg = j_dist.DistKRRConfig(n=n, d=4, sigma=1.5, lam_unscaled=1e-3, block_size=b,
                                    rank=r, heads=heads, backend="xla")
        step, sh = j_dist.make_dist_askotch_step(jm, jcfg)
        jstep = jax.jit(step)
        state = jax.device_put(j_dist.init_dist_state(jcfg, 0), sh["state"])
        xs, ys = jax.device_put(jnp.asarray(x), sh["x"]), jax.device_put(jnp.asarray(y), sh["y"])
        draws = []
        for _ in range(3):
            _, kb, knys, kl = jax.random.split(state.key, 4)
            draws.append(tuple(np.array(a) for a in (
                jax.random.randint(kb, (b,), 0, n), jax.random.normal(knys, (b, r), jnp.float32),
                jax.random.normal(kl, (b,), jnp.float32))))
            state = jstep(state, xs, ys)
        _J_CACHE[key] = (draws, {k: np.asarray(getattr(state, k)) for k in ("w", "v", "z")},
                         float(state.sketch_res))
    draws, want, want_res = _J_CACHE[key]
    cfg = krr_dist.DistKRRConfig(n=n, d=4, sigma=1.5, lam_unscaled=1e-3, block_size=b,
                                 rank=r, heads=heads)
    mesh = _cpu_mesh(shape)
    step = krr_dist.make_dist_askotch_step(mesh, cfg)
    bound = ShardedKernelOperator.bind(mesh, torch.from_numpy(x), sigma=1.5)
    state = krr_dist.init_dist_state(cfg, 0, device="cpu")
    before = obs_metrics.snapshot()
    for idx, omega, probe in draws:
        state = step(state, bound.x_shards, torch.from_numpy(y), idx=torch.from_numpy(idx),
                     omega=torch.from_numpy(omega), probe=torch.from_numpy(probe))
    assert obs_metrics.diff(before, obs_metrics.snapshot()) == {}  # composites count nothing
    for k in ("w", "v", "z"):
        _close(getattr(state, k), want[k])
    np.testing.assert_allclose(float(state.sketch_res), want_res, rtol=2e-4)


def test_solve_over_a_mesh_converges_like_one_device():
    """askotch and pcg-nystrom with mesh=: converged, and their test RMSE
    within 1e-3 of the single-device solve of the same problem."""
    x, y, xt, yt = _krr_data()
    p = KRRProblem(x=torch.from_numpy(x), y=torch.from_numpy(y), sigma=1.5, lam_unscaled=1e-3)
    q, truth = torch.from_numpy(xt), torch.from_numpy(yt)
    runs = {"askotch": dict(block_size=64, rank=24, max_iters=160, eval_every=40, tol=1e-3),
            "pcg-nystrom": dict(rank=48, max_iters=100, tol=1e-7)}
    for method, kw in runs.items():
        one = solve(p, method, **kw)
        rmse_one = float(evaluate(one.predict_fn(q), truth).rmse)
        for shape in ((2, 1), (2, 2)) if method == "pcg-nystrom" else ((2, 1),):
            out = solve(p, method, mesh=_cpu_mesh(shape), **kw)
            assert out.info["converged"] and out.info["mesh"] == {"data": shape[0],
                                                                  "model": shape[1]}
            assert out.w.shape == (256, 3) and len(out.history[-1]["rel_residual_per_head"]) == 3
            rmse = float(evaluate(out.predict_fn(q), truth).rmse)
            assert abs(rmse - rmse_one) < 1e-3, (method, shape, rmse, rmse_one)
    # a (n, 1) y solves as 1-D and keeps its column; cg takes a 1-D y
    p1 = KRRProblem(x=p.x, y=p.y[:, :1], sigma=1.5, lam_unscaled=1e-3)
    out = solve(p1, "askotch", mesh=_cpu_mesh((1, 1)), block_size=64, rank=24, max_iters=5)
    assert out.w.shape == (256, 1) and out.predict_fn(q[:7]).shape == (7, 1)
    out = solve(dataclasses.replace(p1, y=p.y[:, 0]), "cg", mesh=_cpu_mesh((2, 1)), max_iters=5)
    assert out.w.shape == (256,)


def test_solve_mesh_options_match_reference():
    x, y, _, _ = _krr_data(n=64)
    p = KRRProblem(x=torch.from_numpy(x), y=torch.from_numpy(y))
    mesh = _cpu_mesh((1, 1))
    assert {k: set(v) for k, v in DIST_METHOD_OPTIONS.items()} == {
        k: set(v) - {"backend"} for k, v in J_DIST_OPTIONS.items()}
    with pytest.raises(ValueError, match="has no distributed path"):
        solve(p, "falkon", mesh=mesh)
    with pytest.raises(ValueError, match=r"unknown option\(s\) \['sampling'\].*with mesh="):
        solve(p, "askotch", mesh=mesh, sampling="arls")
    with pytest.raises(ValueError, match="precomputed"):
        solve(KRRProblem(x=torch.eye(8), y=torch.zeros(8), kernel="precomputed"), "cg",
              mesh=mesh)
    with pytest.raises(ValueError, match="precomputed"):
        tune(KRRProblem(x=torch.eye(8), y=torch.zeros(8), kernel="precomputed"), mesh=mesh)


# ---------------------------------------------------------------------------
# wiring: tune, serving, the estimators, the launchers
# ---------------------------------------------------------------------------


def test_tune_over_a_mesh_picks_the_same_best():
    x, y, _, _ = _krr_data(n=120, t=1)
    p = KRRProblem(x=torch.from_numpy(x), y=torch.from_numpy(y[:, 0]))
    kw = dict(sigmas=(0.7, 1.5), lams=(1e-4, 1e-2), folds=3, rank=8, max_iters=30)
    base = tune(p, **kw)
    for shape in ((1, 1), (2, 1)):
        got = tune(p, mesh=_cpu_mesh(shape), **kw)
        assert got.best == base.best or (
            got.best["sigma"], got.best["lam_unscaled"]) == (base.best["sigma"],
                                                             base.best["lam_unscaled"])
        np.testing.assert_allclose([r["cv_mse"] for r in got.records],
                                   [r["cv_mse"] for r in base.records], rtol=1e-4)
    mk = tune(p, mesh=_cpu_mesh((2, 1)), kernels=("rbf", "laplacian"), n_weight_samples=2,
              **dict(kw, sigmas=(1.0,)))
    assert mk.best["kernel"] == ["rbf", "laplacian"]


def test_sharded_serving_matches_the_single_device_closure():
    x, _, xt, _ = _krr_data(n=96, t=1)
    w = np.random.default_rng(1).standard_normal((96, 3)).astype(np.float32)
    single = make_krr_predict_fn(make_operator(torch.from_numpy(x), sigma=1.2),
                                 torch.from_numpy(w), max_batch=16)
    want = single(xt[:40])
    for shape in SHAPES:
        got = make_sharded_krr_predict_fn(_cpu_mesh(shape), x, w, sigma=1.2, max_batch=16)
        _close(got(xt[:40]), want)
    cfg = {"kernel": "rbf", "sigma": 1.2}
    with ServingEngine(max_batch=16, max_wait_ms=1.0, device="cpu") as eng:
        eng.register("plain", cfg, x, w)
        eng.register("sharded", cfg, x, w, mesh=_cpu_mesh((1, 1)))
        eng.register("sharded22", cfg, x, w, mesh=_cpu_mesh((2, 2)))
        futs = [(eng.submit(m, xt[i:i + 3]), m, i) for i in range(0, 30, 3)
                for m in ("plain", "sharded", "sharded22")]
        got = {(m, i): np.asarray(f.result(timeout=30)) for f, m, i in futs}
    for (m, i), v in got.items():
        if m == "sharded":  # one shard: the same sweep as the plain model
            np.testing.assert_array_equal(v, got[("plain", i)])
        _close(v, got[("plain", i)])


def test_kernel_ridge_fits_over_a_mesh():
    from repro_torch.estimators import KernelRidge

    x, y, xt, _ = _krr_data(n=128, t=1)
    mesh = _cpu_mesh((2, 1))
    est = KernelRidge(alpha=0.1, sigma=1.5, solver="pcg-nystrom", device="cpu", mesh=mesh,
                      solver_opts={"rank": 32, "max_iters": 60, "tol": 1e-7}).fit(x, y[:, 0])
    plain = KernelRidge(alpha=0.1, sigma=1.5, solver="pcg-nystrom", device="cpu",
                        solver_opts={"rank": 32, "max_iters": 60, "tol": 1e-7}).fit(x, y[:, 0])
    assert est.solve_info_["mesh"] == {"data": 2, "model": 1}
    _close(est.predict(xt), plain.predict(xt), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("extra", [["--mesh", "1x1", "--method", "cg"],
                                   ["--method", "dc", "--dc-shards", "2", "--dc-method", "cg"]])
def test_krr_solve_mesh_and_dc_keys_match_reference(capsys, monkeypatch, extra):
    from repro.launch import krr_solve as j_launch
    from repro_torch.launch import krr_solve as t_launch

    argv = ["--n", "96", "--n-test", "24", "--d", "3", "--iters", "10", *extra]
    monkeypatch.setattr(sys, "argv", ["krr_solve", *argv])
    j_launch.main()
    j_report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    report = t_launch.main([*argv, "--device", "cpu"])
    assert list(report) == list(j_report)
    assert report["method"] == j_report["method"] and np.isfinite(report["test_rmse"])
    if "dc" in extra:
        assert report["collective_dispatches"] == 0 and report["shards"] == 2
    else:
        assert report["mesh"] == {"data": 1, "model": 1}


def test_krr_tune_mesh_keys_match_reference(capsys, monkeypatch):
    from repro.launch import krr_tune as j_launch
    from repro_torch.launch import krr_tune as t_launch

    argv = ["--n", "96", "--d", "3", "--n-test", "24", "--sigmas", "1.0", "--lams", "1e-2",
            "--folds", "2", "--rank", "8", "--iters", "10", "--refit-iters", "10",
            "--method", "cg", "--mesh", "1x1"]
    monkeypatch.setattr(sys, "argv", ["krr_tune", *argv])
    j_launch.main()
    j_report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    report = t_launch.main([*argv, "--device", "cpu"])
    assert list(report) == list(j_report) and report["mesh"] == {"data": 1, "model": 1}
    assert list(report["refit"]) == list(j_report["refit"])
    assert report["best"]["sigma"] == j_report["best"]["sigma"]
