"""The port's tuning slice (``repro_torch``) held against the JAX package:
blocked CG, the stacked tune engine under the grid / random / halving
policies, the tune launcher, and a tuned model refit in both packages.

Inputs are made with numpy from a seed and cross between the packages as
numpy arrays; JAX runs on the CPU, the port on CPU tensors.  The folds
(``make_folds``) and the Dirichlet weight candidates (``_weight_candidates``)
come from numpy in both packages, so the candidate sets and the best config
must match exactly; CV scores agree to rtol 1e-3 (two f32 CG solves of one
system).  Nystrom sketches are not compared: ``torch.linalg.qr`` and
``jnp.linalg.qr`` may differ in column signs, and the preconditioner is
invariant to them.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import blocked_cg as j_bcg  # noqa: E402
from repro.core.krr import KRRProblem as JProblem  # noqa: E402
from repro.core.solver_api import solve as j_solve  # noqa: E402
from repro.core.tune import apply_best as j_apply_best  # noqa: E402
from repro.core.tune import tune as j_tune  # noqa: E402
from repro.core.tune import tune_multikernel as j_tune_mk  # noqa: E402
from repro.data import synthetic as j_synthetic  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.blocked_cg import blocked_cg  # noqa: E402
from repro_torch.core.krr import KRRProblem  # noqa: E402
from repro_torch.core.solver_api import MULTIKERNEL_TUNE_OPTIONS, TUNE_OPTIONS, solve  # noqa: E402
from repro_torch.core.solver_api import tune as api_tune  # noqa: E402
from repro_torch.core.tune import apply_best, tune, tune_multikernel  # noqa: E402

#: f32 parity of deterministic linear algebra (summation order differs)
RTOL, ATOL = 1e-4, 1e-5
#: CV scores of two f32 CG solves of one system
SCORE_RTOL = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy (JAX arrays are read-only)


def _close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------------------------------
# blocked CG
# ---------------------------------------------------------------------------


def _spd_system(rng, p=40, t=4):
    a = rng.standard_normal((p, p)).astype(np.float32)
    m = (a @ a.T / p + 0.3 * np.eye(p)).astype(np.float32)
    rhs = rng.standard_normal((p, t)).astype(np.float32)
    rhs[:, 2] = 0.0  # an all-zero column: frozen at iteration 0
    dinv = (1.0 / np.diag(m)).astype(np.float32)
    return m, rhs, dinv


def _both_cg(m, rhs, dinv, **kw):
    """The same Jacobi-preconditioned blocked CG in both packages."""
    jm, jd = jnp.asarray(m), jnp.asarray(dinv)
    tm, td = _t(m), _t(dinv)
    jkw, tkw = dict(kw), dict(kw)
    if "x0" in kw:
        jkw["x0"], tkw["x0"] = jnp.asarray(kw["x0"]), _t(kw["x0"])
    jres = j_bcg.blocked_cg(lambda v: jm @ v, jnp.asarray(rhs), lambda r: jd[:, None] * r, **jkw)
    tres = blocked_cg(lambda v: tm @ v, _t(rhs), lambda r: td[:, None] * r, **tkw)
    return jres, tres


@pytest.mark.parametrize("warm", [False, True])
def test_blocked_cg_matches(rng, warm):
    m, rhs, dinv = _spd_system(rng)
    kw = dict(max_iters=100, tol=1e-5)
    if warm:
        kw["x0"] = (0.5 * rhs * dinv[:, None]).astype(np.float32)
    jres, tres = _both_cg(m, rhs, dinv, **kw)
    assert tres.iters == jres.iters and tres.converged == jres.converged
    np.testing.assert_array_equal(tres.frozen, jres.frozen)  # the zero column
    _close(tres.x, jres.x)
    assert np.all(np.asarray(tres.x)[:, 2] == 0.0)
    assert [list(h) for h in tres.history] == [list(h) for h in jres.history]  # keys, in order
    assert tres.history[-1]["rel_residual_per_head"][2] == 0.0
    _close(np.asarray([h["rel_residual"] for h in tres.history]),
           [h["rel_residual"] for h in jres.history], rtol=1e-3)


def test_blocked_cg_freeze_rung_matches(rng):
    """A rung at iteration 3 freezes column 0; its mask is OR-ed into the
    cumulative freeze (with the zero column) and the column keeps its value."""
    m, rhs, dinv = _spd_system(rng)
    seen = {"jax": [], "torch": []}

    def callback(tag):
        def cb(it, x, rel_heads, frozen):
            seen[tag].append((it, np.asarray(x).copy(), rel_heads.copy(), frozen.copy()))
            return np.array([True, False, False, False])
        return cb

    jm, jd, tm, td = jnp.asarray(m), jnp.asarray(dinv), _t(m), _t(dinv)
    kw = dict(max_iters=100, tol=1e-6, freeze_at=(3,))
    jres = j_bcg.blocked_cg(lambda v: jm @ v, jnp.asarray(rhs), lambda r: jd[:, None] * r,
                            freeze_callback=callback("jax"), **kw)
    tres = blocked_cg(lambda v: tm @ v, _t(rhs), lambda r: td[:, None] * r,
                      freeze_callback=callback("torch"), **kw)
    assert len(seen["torch"]) == len(seen["jax"]) == 1
    (tit, tx3, trel, tfrozen), (jit, jx3, jrel, jfrozen) = seen["torch"][0], seen["jax"][0]
    assert tit == jit == 3
    np.testing.assert_array_equal(tfrozen, jfrozen)
    _close(tx3, jx3)
    _close(trel, jrel, rtol=1e-3)
    np.testing.assert_array_equal(tres.frozen, [True, False, True, False])
    np.testing.assert_array_equal(tres.frozen, jres.frozen)
    assert tres.iters == jres.iters
    _close(tres.x, jres.x)
    np.testing.assert_array_equal(np.asarray(tres.x)[:, 0], tx3[:, 0])  # kept its rung value


# ---------------------------------------------------------------------------
# tune / tune_multikernel against the reference
# ---------------------------------------------------------------------------

GRID_KW = dict(sigmas=(0.5, 1.0, 2.0), lams=(1e-4, 1e-3, 1e-2), folds=3, rank=32,
               max_iters=100, tol=1e-5, seed=0)
MK_KW = dict(kernels=("rbf", "laplacian", "matern52"), sigmas=(1.0,), lams=(1e-4, 1e-3, 1e-2),
             folds=3, n_weight_samples=4, rank=32, max_iters=100, tol=1e-5, seed=0)
HALVING_KW = dict(sigmas=(1.0,), lams=(1e-5, 1e-3, 1e-1, 10.0), folds=4, rank=32,
                  max_iters=200, tol=1e-6, seed=0, policy="halving")


@pytest.fixture(scope="module")
def data():
    """n = 256 regression rows and 64 test rows, as numpy arrays."""
    x, y, xt, yt = j_synthetic.krr_regression(0, 256, 4, n_test=64, noise=0.3)
    return tuple(np.asarray(a) for a in (x, y, xt, yt))


def _jprob(data, **kw):
    return JProblem(x=jnp.asarray(data[0]), y=jnp.asarray(data[1]), backend="xla", **kw)


def _tprob(data, **kw):
    return KRRProblem(x=_t(data[0]), y=_t(data[1]), **kw)


@pytest.fixture(scope="module")
def j_mk_result(data):
    return j_tune_mk(_jprob(data), **MK_KW)


def _assert_same_search(rt, rj):
    """Same candidates, best config, scores and sweep accounting.  A pruned
    candidate's score is an early-stopped CG snapshot (for the tiny lams,
    of a badly conditioned system) and is held only through the prune
    decisions, which must match."""
    assert list(rt.best) == list(rj.best)  # the reference's keys, in its order
    for key in ("kernel", "sigma", "weights", "lam_unscaled", "precision", "folds"):
        assert rt.best.get(key) == rj.best.get(key), key
    np.testing.assert_allclose(rt.best["cv_mse"], rj.best["cv_mse"], rtol=SCORE_RTOL)
    assert (rt.search, rt.strategy, rt.folds) == (rj.search, rj.strategy, rj.folds)
    assert len(rt.records) == len(rj.records)
    for a, b in zip(rt.records, rj.records):
        assert list(a) == list(b)
        assert (a["sigma"], a["lam_unscaled"], a.get("weights")) == (
            b["sigma"], b["lam_unscaled"], b.get("weights"))
        assert a.get("pruned_at_rung") == b.get("pruned_at_rung")
        if "pruned_at_rung" in a:
            continue
        np.testing.assert_allclose(a["cv_mse"], b["cv_mse"], rtol=SCORE_RTOL)
        np.testing.assert_allclose(a["fold_mse"], b["fold_mse"], rtol=SCORE_RTOL)
    for a, b in zip(rt.trace, rj.trace):
        assert a["pruned_at_rung"] == b["pruned_at_rung"]
        assert len(a["scores"]) == len(b["scores"])
    # sweeps: one per CG iteration plus a fixed count per group, so the
    # tallies are equal where the iteration counts are, and otherwise
    # differ by exactly the iterations
    it_t, it_j = rt.info["iters_by_sigma"], rj.info["iters_by_sigma"]
    assert list(it_t) == list(it_j)
    assert rt.sweeps - rj.sweeps == pytest.approx(sum(it_t.values()) - sum(it_j.values()))
    assert all(abs(it_t[k] - it_j[k]) <= 2 for k in it_t)
    assert {k: v for k, v in rt.info.items() if k not in ("pairs", "iters_by_sigma",
                                                          "naive_sweep_estimate")} == {
        k: v for k, v in rj.info.items() if k not in ("pairs", "iters_by_sigma",
                                                      "naive_sweep_estimate")}


def test_tune_grid_matches(data):
    rj = j_tune(_jprob(data), **GRID_KW)
    rt = tune(_tprob(data), **GRID_KW)
    _assert_same_search(rt, rj)
    assert rt.best["backend"] == "auto"


def test_tune_multikernel_shared_matches(data, j_mk_result):
    rt = tune_multikernel(_tprob(data), **MK_KW)
    _assert_same_search(rt, j_mk_result)
    assert rt.info["q"] == 3 and rt.info["weight_samples"] == 4
    assert rt.best_w0.shape == (256,)


def test_halving_matches_reference_trace(data):
    rj = j_tune(_jprob(data), **HALVING_KW)
    rt = tune(_tprob(data), **HALVING_KW)
    pruned = [t["pruned_at_rung"] for t in rj.trace]
    assert any(p is not None for p in pruned), "the testbed must prune"
    assert [t["pruned_at_rung"] for t in rt.trace] == pruned
    assert [t["iters"][:-1] for t in rt.trace] == [t["iters"][:-1] for t in rj.trace]
    _assert_same_search(rt, rj)


def test_shared_matches_naive_in_port(data):
    """The stacked engine and the per-candidate loop agree within the port,
    as tests/test_multikernel.py checks for the reference."""
    kw = dict(MK_KW, kernels=("rbf", "laplacian"), n_weight_samples=2, lams=(1e-3, 1e-1),
              max_iters=300, tol=1e-6)
    rs = tune_multikernel(_tprob(data), strategy="shared", **kw)
    rn = tune_multikernel(_tprob(data), strategy="naive", **kw)
    assert (rs.best["weights"], rs.best["sigma"], rs.best["lam_unscaled"]) == (
        rn.best["weights"], rn.best["sigma"], rn.best["lam_unscaled"])
    for a, b in zip(rs.records, rn.records):
        np.testing.assert_allclose(a["cv_mse"], b["cv_mse"], rtol=SCORE_RTOL)
        np.testing.assert_allclose(a["fold_mse"], b["fold_mse"], rtol=SCORE_RTOL)
    assert rs.sweeps < rs.info["naive_sweep_estimate"] and rn.best_w0 is None
    rg = tune(_tprob(data), strategy="shared", **dict(GRID_KW, tol=1e-6, max_iters=300))
    rgn = tune(_tprob(data), strategy="naive", **dict(GRID_KW, tol=1e-6, max_iters=300))
    assert (rg.best["sigma"], rg.best["lam_unscaled"]) == (rgn.best["sigma"], rgn.best["lam_unscaled"])


def test_tune_routing_and_validation(data):
    from repro.core.solver_api import MULTIKERNEL_TUNE_OPTIONS as J_MK_OPTIONS
    from repro.core.solver_api import TUNE_OPTIONS as J_OPTIONS

    assert (TUNE_OPTIONS, MULTIKERNEL_TUNE_OPTIONS) == (J_OPTIONS, J_MK_OPTIONS)
    p = _tprob(data)
    small = dict(sigmas=(1.0,), lams=(1e-2,), folds=2, rank=8, max_iters=5)
    assert api_tune(p, **small).best["kernel"] == "rbf"
    mk = api_tune(p, kernels=("rbf", "cosine"), n_weight_samples=2, **small)
    assert mk.best["kernel"] == ["rbf", "cosine"] and len(mk.best["weights"]) == 2
    with pytest.raises(ValueError, match=r"unknown option\(s\) \['bogus'\] for tune\(\)"):
        api_tune(p, bogus=1)
    with pytest.raises(ValueError, match="multi-kernel tune"):
        api_tune(p, kernels=("rbf",), search="random")
    with pytest.raises(ValueError, match="policy='grid' does not apply"):
        tune_multikernel(p, kernels=("rbf", "laplacian"), policy="grid", **small)
    from repro_torch.distributed.meshes import SolverMesh

    one = api_tune(p, mesh=SolverMesh(["cpu"], shape=(1, 1)), **small)
    assert one.best == api_tune(p, **small).best
    with pytest.raises(ValueError, match="single-device reference loop"):
        api_tune(p, mesh=SolverMesh(["cpu"] * 2, shape=(2, 1)), strategy="naive", **small)
    with pytest.raises(TypeError, match="telemetry"):
        api_tune(p, telemetry=object(), **small)
    with pytest.raises(ValueError, match="folds must be in"):
        tune(p, sigmas=(1.0,), lams=(1e-2,), folds=1)


# ---------------------------------------------------------------------------
# refit: apply_best, problem_from_best, the launcher
# ---------------------------------------------------------------------------


def test_problem_from_best_refits_like_reference(data, j_mk_result):
    """The reference's tuned multi-kernel model, refit by ASkotch in both
    packages from its ``best`` dict, predicts the same test targets."""
    x, y, xt, _ = data
    kw = dict(block_size=128, rank=32, max_iters=300, eval_every=10, tol=1e-4, seed=0)
    jp = j_apply_best(_jprob(data), j_mk_result)
    jout = j_solve(jp, "askotch", **kw)
    tp = convert.problem_from_best(x, y, j_mk_result.best, device="cpu")
    assert (tp.kernel, tp.weights, tp.lam_unscaled) == (
        tuple(j_mk_result.best["kernel"]), tuple(j_mk_result.best["weights"]),
        j_mk_result.best["lam_unscaled"])
    tout = solve(tp, "askotch", **kw)
    assert jout.info["converged"] and tout.info["converged"]
    want = np.asarray(jout.predict_fn(jnp.asarray(xt)))
    _close(tout.predict_fn(_t(xt)), want, rtol=1e-3, atol=1e-3)
    # apply_best in the port gives the same problem, and a warm start on its device
    rp, w0 = apply_best(_tprob(data), tune_multikernel(_tprob(data), **dict(MK_KW, max_iters=20)),
                        with_w0=True)
    assert isinstance(rp.kernel, tuple) and w0.device == rp.device and w0.shape == (256,)


def test_tune_launcher_keys_match_reference(capsys, monkeypatch, tmp_path):
    """The port's launcher prints the JAX launcher's JSON keys, in order,
    and writes the same export layout."""
    import sys

    from repro.launch import krr_tune as j_launch
    from repro_torch.launch import krr_tune as t_launch

    argv = ["--n", "96", "--d", "3", "--n-test", "32", "--kernels", "rbf,laplacian",
            "--n-weight-samples", "2", "--sigmas", "1.0", "--lams", "1e-2", "--folds", "2",
            "--rank", "8", "--iters", "20", "--refit-iters", "20"]
    monkeypatch.setattr(sys, "argv", ["krr_tune", *argv])
    j_launch.main()
    j_report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    export = tmp_path / "best.json"
    report = t_launch.main([*argv, "--device", "cpu", "--export", str(export)])
    assert list(report) == [*j_report, "exported"]
    assert list(report["best"]) == list(j_report["best"])
    assert list(report["refit"]) == list(j_report["refit"])
    assert report["refit_warm_start"] is True and np.isfinite(report["refit"]["test_rmse"])
    assert json.loads(export.read_text()) == {**report["best"], "trace": report["trace"]}
    with pytest.raises(ValueError, match="mesh spec 'x' invalid"):
        t_launch.main([*argv, "--device", "cpu", "--mesh", "x"])
