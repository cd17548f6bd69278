"""The port's solver slice (``repro_torch``) held against the JAX package.

Every input is made with numpy from a seed and crosses between the packages
as numpy arrays; JAX runs on the CPU, the port on CPU tensors.  Randomized
parts are checked with the reference's own draws injected into the port
(torch's generator never reproduces JAX's stream); whole solves are checked
by their outcome.  Tolerances are stated where they are used.
"""

import json
import pathlib
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import askotch as j_askotch  # noqa: E402
from repro.core import get_l as j_get_l  # noqa: E402
from repro.core import nystrom as j_nystrom  # noqa: E402
from repro.core import samplers as j_samplers  # noqa: E402
from repro.core.krr import KRRProblem as JProblem  # noqa: E402
from repro.core.krr import evaluate as j_evaluate  # noqa: E402
from repro.core.krr import evaluate_per_head as j_evaluate_per_head  # noqa: E402
from repro.core.operator import KernelOperator as JOperator  # noqa: E402
from repro.core.operator import PrecomputedKernelOperator as JPrecomputed  # noqa: E402
from repro.core.operator import widen_gram as j_widen_gram  # noqa: E402
from repro.core.solver_api import solve as j_solve  # noqa: E402
from repro.data import synthetic as j_synthetic  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import askotch, nystrom, samplers  # noqa: E402
from repro_torch.core.get_l import get_l, get_l_dense  # noqa: E402
from repro_torch.core.krr import KRRProblem, evaluate, evaluate_per_head  # noqa: E402
from repro_torch.core.operator import (  # noqa: E402
    KernelOperator,
    PrecomputedKernelOperator,
    widen_gram,
)
from repro_torch.core.solver_api import METHODS, solve  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: f32 parity of deterministic linear algebra (different summation orders,
#: LAPACK paths): rtol 1e-4, atol 1e-5 scaled by the reference's magnitude
RTOL, ATOL = 1e-4, 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy (JAX arrays are read-only)


def _close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())))


def _psd(rng, p, rank):
    a = rng.standard_normal((p, rank)).astype(np.float32)
    return (a @ a.T / rank + 0.01 * np.eye(p)).astype(np.float32)


# ---------------------------------------------------------------------------
# Nystrom, Woodbury, get_l — injected omega / probes
# ---------------------------------------------------------------------------


@jax.jit
def _j_nystrom_applies(m, omega_raw, rho, g1, g2):
    """The reference's Nystrom factors and its three inverse applies, as
    one compiled program (eager op-by-op dispatch is slow on the CPU)."""
    q, _ = jnp.linalg.qr(omega_raw)
    f = j_nystrom.nystrom_from_sketch(m @ q, q, jnp.trace(m))
    chol = j_nystrom.stable_inv_apply_setup(f, rho)
    applies = [(j_nystrom.woodbury_inv_apply(f, rho, g), j_nystrom.stable_inv_apply(f, rho, chol, g),
                j_nystrom.woodbury_invsqrt_apply(f, rho, g)) for g in (g1, g2)]
    return f.lam, j_nystrom.nystrom_dense(f), applies


def test_nystrom_and_woodbury_match(rng):
    p, r, t = 48, 8, 3
    m = _psd(rng, p, 12)
    omega_raw = rng.standard_normal((p, r)).astype(np.float32)
    gs = [rng.standard_normal(shape).astype(np.float32) for shape in ((p,), (p, t))]
    tf = nystrom.nystrom(_t(m), r, omega=_t(omega_raw))
    rho = float(tf.lam[-1]) + 0.1
    j_lam, j_dense, j_applies = _j_nystrom_applies(m, omega_raw, rho, *gs)
    # the factors' column signs are arbitrary; the approximation is not
    _close(tf.lam, j_lam)
    _close(nystrom.nystrom_dense(tf), j_dense)
    chol_t = nystrom.stable_inv_apply_setup(tf, rho)
    for g, (j_wood, j_stable, j_sqrt) in zip(gs, j_applies):
        _close(nystrom.woodbury_inv_apply(tf, rho, _t(g)), j_wood)
        _close(nystrom.stable_inv_apply(tf, rho, chol_t, _t(g)), j_stable)
        _close(nystrom.woodbury_invsqrt_apply(tf, rho, _t(g)), j_sqrt)


def test_cholesky_failure_keeps_jax_semantics():
    """cholesky_ex replaces JAX's NaN-on-failure: a non-PD input yields a
    NaN factor instead of raising, and the sketch path takes the jitter."""
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    assert torch.isnan(nystrom.cholesky_or_nan(bad)).all()
    # an exactly rank-deficient sketch still factors (jittered retry)
    omega = torch.eye(4)[:, :3]
    y = torch.zeros((4, 3))
    f = nystrom.nystrom_from_sketch(y, omega, torch.tensor(0.0))
    assert torch.isfinite(f.u).all() and torch.isfinite(f.lam).all()


def test_get_l_matches_with_injected_probe(rng):
    num_probes = 2  # block powering: probes re-orthonormalized by QR each round
    p, r = 40, 6
    kbb = _psd(rng, p, 20)
    omega_raw = rng.standard_normal((p, r)).astype(np.float32)
    tf = nystrom.nystrom(_t(kbb), r, omega=_t(omega_raw))
    lam, rho = 0.05, float(tf.lam[-1]) + 0.05
    key = jax.random.PRNGKey(3)

    @jax.jit
    def reference(kbb, omega_raw):
        q, _ = jnp.linalg.qr(omega_raw)
        jf = j_nystrom.nystrom_from_sketch(kbb @ q, q, jnp.trace(kbb))
        return j_get_l.get_l_dense(key, kbb, lam, jf, rho, num_probes=num_probes)

    want = reference(kbb, omega_raw)
    probe = np.asarray(jax.random.normal(key, (p, num_probes), dtype=jnp.float32))
    got = get_l_dense(None, _t(kbb), lam, tf, torch.tensor(rho), num_probes=num_probes,
                      probe=_t(probe))
    _close(got, want)


# ---------------------------------------------------------------------------
# operators, residuals, metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kern", ["rbf", "polynomial"])  # unit / data-dependent diagonal
def test_kernel_operator_primitives_match(rng, kern):
    x = rng.standard_normal((57, 5)).astype(np.float32)
    a = rng.standard_normal((13, 5)).astype(np.float32)
    v = rng.standard_normal((57, 2)).astype(np.float32)
    idx = np.array([3, 9, 0, 41, 22])
    jop = JOperator(x=jnp.asarray(x), kernel=kern, sigma=1.4, backend="xla")
    top = KernelOperator(x=_t(x), kernel=kern, sigma=1.4)
    _close(top.matvec(_t(v)), jop.matvec(jnp.asarray(v)))
    _close(top.matvec(_t(v[:, 0])), jop.matvec(jnp.asarray(v[:, 0])))
    _close(top.row_block_matvec(_t(a), _t(v)), jop.row_block_matvec(jnp.asarray(a), jnp.asarray(v)))
    _close(top.block(_t(a)), jop.block(jnp.asarray(a)))
    _close(top.block_idx(_t(idx)), jop.block_idx(jnp.asarray(idx)))
    _close(top.trace_est(), jop.trace_est())
    _close(top.k_lam_matvec(_t(v), 0.3), jop.k_lam_matvec(jnp.asarray(v), 0.3))
    _close(top.restrict(_t(idx)).matvec(_t(v[idx])), jop.restrict(jnp.asarray(idx)).matvec(jnp.asarray(v[idx])))


def test_precomputed_operator_matches(rng):
    x = rng.standard_normal((30, 4)).astype(np.float32)
    gram = np.asarray(j_askotch.KRRProblem(x=jnp.asarray(x), y=jnp.zeros(30), backend="xla").op.block(jnp.asarray(x)))
    jw, tw = j_widen_gram(jnp.asarray(gram)), widen_gram(_t(gram))
    _close(tw, jw, rtol=0, atol=0)
    assert widen_gram(tw) is tw  # idempotent on widened input
    jop, top = JPrecomputed(x=jw), PrecomputedKernelOperator(x=tw)
    v = rng.standard_normal((30, 3)).astype(np.float32)
    idx = np.array([5, 2, 17, 29])
    _close(top.matvec(_t(v)), jop.matvec(jnp.asarray(v)))
    _close(top.block_idx(_t(idx)), jop.block_idx(jnp.asarray(idx)))
    _close(top.row_block_matvec(_t(gram[:7]), _t(v)), jop.row_block_matvec(jnp.asarray(gram[:7]), jnp.asarray(v)))
    _close(top.trace_est(), jop.trace_est())
    _close(top.restrict(_t(idx)).matvec(_t(v[idx])), jop.restrict(jnp.asarray(idx)).matvec(jnp.asarray(v[idx])))
    with pytest.raises(ValueError, match="columns"):
        top.row_block_matvec(_t(gram[:, :5]), _t(v))


@pytest.mark.parametrize("t", [1, 3])
def test_residual_report_and_evaluate_match(rng, t):
    x = rng.standard_normal((64, 4)).astype(np.float32)
    y = rng.standard_normal((64,) if t == 1 else (64, t)).astype(np.float32)
    w = 0.1 * rng.standard_normal(y.shape).astype(np.float32)
    jp = JProblem(x=jnp.asarray(x), y=jnp.asarray(y), lam_unscaled=1e-3, backend="xla")
    tp = KRRProblem(x=_t(x), y=_t(y), lam_unscaled=1e-3)
    ja, jh = jp.residual_report(jnp.asarray(w))
    ta, th = tp.residual_report(_t(w))
    _close(ta, ja)
    _close(th, jh)
    pred = rng.standard_normal(y.shape).astype(np.float32)
    for tf, jf in ((evaluate, j_evaluate), (evaluate_per_head, j_evaluate_per_head)):
        got, want = tf(_t(pred), _t(y)), jf(jnp.asarray(pred), jnp.asarray(y))
        for g, wv in zip(got, want):
            _close(g, wv)


# ---------------------------------------------------------------------------
# one ASkotch / Skotch step with the reference's draws injected
# ---------------------------------------------------------------------------


def _reference_draws(state, n, b, r):
    """The draws ``repro.core.askotch.make_step`` makes from ``state.key``
    (askotch.py:137-147, get_l.py:38), as numpy arrays."""
    _key, kb, knys, kl = jax.random.split(state.key, 4)
    idx = jax.random.choice(kb, n, (b,), replace=False)
    omega = jax.random.normal(knys, (b, r), dtype=jnp.float32)
    probe = jax.random.normal(kl, (b, 1), dtype=jnp.float32)
    return np.asarray(idx).astype(np.int64), np.asarray(omega), np.asarray(probe)


@pytest.mark.parametrize("accelerated,t", [(True, 1), (True, 3), (False, 1)])
def test_step_matches_with_injected_draws(accelerated, t):
    """Two consecutive steps agree on w, v, z, sketch_res and step_L to
    rtol 1e-4 (atol 1e-5 x magnitude): the draws are identical, so only f32
    summation order and LAPACK paths (QR, SVD, Cholesky) differ."""
    n, d, b, r = 160, 5, 32, 8
    if t == 1:
        x, y, _, _ = j_synthetic.krr_regression(4, n, d)
    else:
        x, y, *_ = j_synthetic.krr_one_vs_all(4, n, d, num_classes=t)
    x, y = np.asarray(x), np.asarray(y)
    jp = JProblem(x=jnp.asarray(x), y=jnp.asarray(y), lam_unscaled=1e-3, backend="xla")
    tp = KRRProblem(x=_t(x), y=_t(y), lam_unscaled=1e-3)
    cfg_kw = dict(block_size=b, rank=r, accelerated=accelerated)
    jstep = jax.jit(j_askotch.make_step(jp, j_askotch.ASkotchConfig(backend="xla", **cfg_kw)))
    tstep = askotch.make_step(tp, askotch.ASkotchConfig(**cfg_kw))
    jstate = j_askotch.init_state(jp, seed=0)
    tstate = askotch.init_state(tp, seed=0)
    for _ in range(2):
        idx, omega, probe = _reference_draws(jstate, n, b, r)
        jstate, jaux = jstep(jstate)
        tstate, taux = tstep(tstate, idx=_t(idx), omega=_t(omega), probe=_t(probe))
        for name in ("w", "v", "z", "sketch_res"):
            _close(getattr(tstate, name), getattr(jstate, name))
        _close(taux.step_l, jaux.step_l)
        _close(taux.rho, jaux.rho)
        assert tstate.it == int(jstate.it)


def test_step_draws_from_generator_without_injection():
    x, y, _, _ = synthetic.krr_regression(1, 100, 4, device="cpu")
    tp = KRRProblem(x=x, y=y, lam_unscaled=1e-3)
    step = askotch.make_step(tp, askotch.ASkotchConfig(block_size=20, rank=5))
    s1, _ = step(askotch.init_state(tp, seed=7))
    s2, _ = step(askotch.init_state(tp, seed=7))
    torch.testing.assert_close(s1.w, s2.w, rtol=0, atol=0)  # same seed, same draws
    s3, _ = step(askotch.init_state(tp, seed=8))
    assert not torch.equal(s1.w, s3.w)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

#: both solves run to this per-head relative residual; test RMSE must then
#: agree within RMSE_DELTA (two approximate solutions of one system)
SOLVE_TOL, RMSE_DELTA, LAM = 1e-4, 1e-3, 1e-2
SOLVE_KW = dict(block_size=64, rank=16, max_iters=400, eval_every=10, tol=SOLVE_TOL, seed=0)


@pytest.fixture(scope="module")
def regression_data():
    x, y, xt, yt = j_synthetic.krr_regression(0, 512, 6, n_test=128)
    return tuple(np.asarray(a) for a in (x, y, xt, yt))


@pytest.fixture(scope="module")
def jax_regression_solve(regression_data):
    x, y, _, _ = regression_data
    jp = JProblem(x=jnp.asarray(x), y=jnp.asarray(y), lam_unscaled=LAM, backend="xla")
    return jp, j_solve(jp, "askotch", **SOLVE_KW)


def test_whole_slice_regression(regression_data, jax_regression_solve):
    x, y, xt, yt = regression_data
    _, jout = jax_regression_solve
    tx, ty, txt, tyt = synthetic.krr_regression(0, 512, 6, n_test=128, device="cpu")
    for got, want in zip((tx, ty, txt, tyt), (x, y, xt, yt)):
        np.testing.assert_array_equal(got.numpy(), want)  # identical data
    tp = KRRProblem(x=tx, y=ty, lam_unscaled=LAM)
    tout = solve(tp, "askotch", **SOLVE_KW)
    assert jout.info["converged"] and tout.info["converged"]
    assert max(tout.history[-1]["rel_residual_per_head"]) < SOLVE_TOL
    assert list(tout.history[-1]) == list(jout.history[-1])  # history keys, in order
    j_rmse = float(j_evaluate(jout.predict_fn(jnp.asarray(xt)), jnp.asarray(yt)).rmse)
    t_rmse = float(evaluate(tout.predict_fn(txt), tyt).rmse)
    assert abs(j_rmse - t_rmse) < RMSE_DELTA


def test_whole_slice_one_vs_all():
    t = 4
    jx, jy, _, jxt, jyt, _ = j_synthetic.krr_one_vs_all(2, 512, 6, num_classes=t, n_test=128)
    tx, ty, _, txt, tyt, _ = synthetic.krr_one_vs_all(2, 512, 6, num_classes=t, n_test=128,
                                                      device="cpu")
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    jout = j_solve(JProblem(x=jx, y=jy, lam_unscaled=LAM, backend="xla"), "askotch", **SOLVE_KW)
    tout = solve(KRRProblem(x=tx, y=ty, lam_unscaled=LAM), "askotch", **SOLVE_KW)
    for out in (jout, tout):
        assert out.info["converged"] and out.info["t"] == t
        assert len(out.info["rel_residual_per_head"]) == t
        assert max(out.info["rel_residual_per_head"]) < SOLVE_TOL
    assert tout.w.shape == (512, t)
    j_rmse = float(j_evaluate(jout.predict_fn(jxt), jyt).rmse)
    t_rmse = float(evaluate(tout.predict_fn(txt), tyt).rmse)
    assert abs(j_rmse - t_rmse) < RMSE_DELTA


def test_skotch_and_arls_solve_run():
    x, y, _, _ = synthetic.krr_regression(3, 300, 4, device="cpu")
    tp = KRRProblem(x=x, y=y, lam_unscaled=1e-2)
    for kw in ({"sampling": "arls"}, {"rho_mode": "regularization"}, {"precond": "identity"},
               {"stable_inv": False}):
        out = solve(tp, "skotch", block_size=40, rank=8, max_iters=30, eval_every=10, **kw)
        rel = out.history[-1]["rel_residual"]
        assert np.isfinite(rel) and rel < 1.0, kw
    gram = KernelOperator(x=x).block(x)  # the same system through a stored Gram
    out = solve(KRRProblem(x=gram, y=y, kernel="precomputed", lam_unscaled=1e-2), "askotch",
                block_size=40, rank=8, max_iters=30, eval_every=10)
    assert out.w.shape == (300,) and out.history[-1]["rel_residual"] < 1.0


def test_convert_from_reference_predicts_identically(regression_data, jax_regression_solve):
    """Port predictions and residuals from the reference's solved weights
    equal the reference's to f32 tolerance."""
    x, y, xt, _ = regression_data
    jp, jout = jax_regression_solve
    tp, tw = convert.from_reference(x, y, np.asarray(jout.w), kernel="rbf", sigma=1.0,
                                    lam_unscaled=LAM, precision="f32", device="cpu")
    _close(tp.predict(tw, _t(xt)), jout.predict_fn(jnp.asarray(xt)))
    _close(tp.residual_report(tw)[0], jp.residual_report(jout.w)[0], rtol=1e-3)
    st = j_askotch.init_state(jp)
    ts = convert.state_from_reference(st.w, st.v, st.z, st.it, device="cpu")
    assert ts.it == 0 and ts.w.shape == (512,) and torch.isinf(ts.sketch_res)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


def test_samplers(rng):
    g = torch.Generator().manual_seed(0)
    idx = samplers.uniform_sampler(100, 30, device="cpu")(g)
    assert idx.shape == (30,) and len(set(idx.tolist())) == 30 and int(idx.max()) < 100
    scores = rng.uniform(0.01, 1.0, 50).astype(np.float32)
    probs = samplers.arls_probs(_t(scores))
    _close(probs, j_samplers.arls_probs(jnp.asarray(scores)))
    idx = samplers.arls_sampler(probs, 20)(g)
    assert len(set(idx.tolist())) == 20
    x, _, _, _ = synthetic.krr_regression(0, 200, 3, device="cpu")
    s = samplers.approx_rls_bless(g, KernelOperator(x=x), lam=0.2)
    assert s.shape == (200,) and bool(((s >= 1e-12) & (s <= 1.0)).all())


# ---------------------------------------------------------------------------
# entry points and boundaries
# ---------------------------------------------------------------------------


def test_solver_api_fail_fast():
    x, y, _, _ = synthetic.krr_regression(0, 64, 3, device="cpu")
    p = KRRProblem(x=x, y=y)
    assert METHODS[:2] == ("askotch", "skotch")
    with pytest.raises(ValueError, match="unknown method"):
        solve(p, "gmres")
    with pytest.raises(ValueError, match=r"unknown option\(s\) \['bogus'\].*accepted"):
        solve(p, "askotch", bogus=1)
    with pytest.raises(ValueError, match="inner solver"):
        solve(p, "dc", dc_method="dc")
    assert solve(p, "dc", dc_shards=2, dc_method="direct").w.shape == (64,)  # dc runs
    out = solve(p, "askotch", kernel=("rbf", "laplacian"), max_iters=1)  # multi-kernel runs
    assert out.w.shape == (64,)
    with pytest.raises(ValueError, match="unknown kernel"):
        solve(p, "askotch", kernel=("rbf", "gauss"), max_iters=1)
    with pytest.raises(ValueError, match="weights="):
        solve(p, "askotch", weights=(1.0,), max_iters=1)
    with pytest.raises(TypeError, match="telemetry"):
        solve(p, "askotch", telemetry=object(), max_iters=1)
    with pytest.raises(ValueError, match="unknown precision"):
        solve(p, "askotch", precision="f16", max_iters=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = solve(p, "askotch", precision="bf16", tol=1e-9, max_iters=2, block_size=16, rank=4)
    assert any("bf16" in str(w.message) for w in caught)
    assert out.w.dtype == torch.float32


def test_launcher_keys_match_reference(capsys, monkeypatch):
    """The port's launcher prints the JAX launcher's JSON keys, in order: a
    one-vs-all run has them all; a single-head run lacks only the per-head
    test accuracies."""
    from repro.launch import krr_solve as j_launch
    from repro_torch.launch import krr_solve as t_launch

    argv = ["--n", "120", "--n-test", "30", "--d", "3", "--iters", "2"]
    ova = ["--dataset", "one-vs-all", "--classes", "3"]
    monkeypatch.setattr(sys, "argv", ["krr_solve", *argv, *ova])
    j_launch.main()
    j_keys = list(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert list(t_launch.main([*argv, *ova, "--device", "cpu"])) == j_keys
    report = t_launch.main([*argv, "--device", "cpu"])
    assert list(report) == [k for k in j_keys if k != "test_acc_per_head"]
    assert report["t"] == 1 and np.isfinite(report["rel_residual"])


def test_cuda_without_card_raises(monkeypatch):
    from repro_torch.launch import krr_solve as t_launch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic.krr_regression(0, 10, 2)  # the default device is the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_reference(np.zeros((2, 2), np.float32), np.zeros(2, np.float32),
                               np.zeros(2, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_launch.main(["--n", "20", "--iters", "1"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys, repro_torch, repro_torch.convert, repro_torch.launch.krr_solve, "
        "repro_torch.core.solver_api, repro_torch.core.skotch, repro_torch.launch.krr_tune, "
        "repro_torch.core.tuning, repro_torch.core.multikernel, repro_torch.kernels.multi, "
        "repro_torch.core.pcg, repro_torch.core.rff, repro_torch.core.rpcholesky, "
        "repro_torch.core.direct, repro_torch.core.falkon, repro_torch.core.eigenpro\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


_FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
                        re.MULTILINE)


def test_port_sources_name_no_jax_or_repro_import():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    offenders = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert not offenders
