"""The port's estimators (``repro_torch.estimators``) held against the JAX
package's (``repro.estimators``) and against scikit-learn.

Inputs are made with numpy from a seed and shared through module fixtures;
JAX runs on the CPU, the port on CPU tensors (``device="cpu"``).
Tolerances, stated where used:

* port vs JAX package, both f32 direct solves: predictions rtol 1e-3 /
  atol 1e-4 x max(1, |want|max) (two f32 Cholesky factorizations);
* port vs ``sklearn.kernel_ridge.KernelRidge``, both f64: rtol 1e-5 (the
  same differential check as tests/test_sklearn_api.py);
* the torch R² against ``sklearn.metrics.r2_score``: rtol 1e-12 (f64).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
sklearn = pytest.importorskip("sklearn")

from sklearn.base import clone  # noqa: E402
from sklearn.gaussian_process.kernels import Matern  # noqa: E402
from sklearn.kernel_ridge import KernelRidge as SkKernelRidge  # noqa: E402
from sklearn.metrics import r2_score as sk_r2_score  # noqa: E402
from sklearn.model_selection import GridSearchCV  # noqa: E402

from repro import estimators as j_est  # noqa: E402
from repro_torch import estimators as t_est  # noqa: E402
from repro_torch.estimators.base import r2_score  # noqa: E402

N, D, M = 60, 4, 17


def _close(got, want, rtol=1e-3, atol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(11)
    X = r.standard_normal((N, D)).astype(np.float32)
    f = np.sin(2 * X[:, 0]) + 0.3 * X[:, 1]
    y = (f + 0.1 * r.standard_normal(N)).astype(np.float32)
    Y = (f[:, None] * np.array([0.5, 1.0, 1.5]) + 0.1 * r.standard_normal((N, 3))).astype(np.float32)
    Xt = r.standard_normal((M, D)).astype(np.float32)
    return X, y, Y, Xt


@pytest.fixture(scope="module")
def data64():
    r = np.random.default_rng(12)
    return (r.standard_normal((70, 6)), r.standard_normal(70), r.standard_normal((70, 3)),
            r.standard_normal((17, 6)))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["rbf", "laplacian", "matern52", "linear", "polynomial",
                                    "sigmoid", "cosine", "precomputed"])
def test_resolve_sigma_table_matches_reference(kernel):
    for sigma, gamma, nf in [(None, None, 4), (None, 0.25, 4), (None, 0.5, 8), (3.0, 0.5, 4),
                             (None, None, 8)]:
        assert t_est.resolve_sigma(kernel, sigma, gamma, nf) == \
            j_est.resolve_sigma(kernel, sigma, gamma, nf)
    assert t_est.AUTO_DIRECT_MAX_N == j_est.AUTO_DIRECT_MAX_N


@pytest.mark.parametrize("t", [None, 3], ids=["y1d", "multioutput"])
@pytest.mark.parametrize("kernel,kw", [("rbf", dict(gamma=0.3)), ("laplacian", dict(gamma=0.45)),
                                       ("matern52", dict(sigma=1.7)),
                                       ("polynomial", dict(gamma=0.2)), ("cosine", dict())],
                         ids=["rbf", "laplacian", "matern52", "polynomial", "cosine"])
def test_kernel_ridge_predictions_match_reference(data, kernel, kw, t):
    X, y, Y, Xt = data
    yy = y if t is None else Y
    got = t_est.KernelRidge(alpha=0.8, kernel=kernel, device="cpu", **kw).fit(X, yy)
    want = j_est.KernelRidge(alpha=0.8, kernel=kernel, **kw).fit(X, yy)
    assert isinstance(got.dual_coef_, torch.Tensor) and got.dual_coef_.device.type == "cpu"
    _close(got.dual_coef_, want.dual_coef_)
    _close(got.predict(Xt), want.predict(Xt))
    assert got.score(Xt, np.asarray(want.predict(Xt))) == pytest.approx(1.0, abs=1e-5)
    assert got.sigma_ == want.sigma_ and got.n_features_in_ == want.n_features_in_


def test_precomputed_matches_reference(data):
    from repro_torch.core.kernels import kernel_matrix

    X, y, _, Xt = data
    tx = torch.from_numpy(X)
    K = kernel_matrix("rbf", tx, tx, 1.2).numpy()
    Kt = kernel_matrix("rbf", torch.from_numpy(Xt), tx, 1.2).numpy()
    got = t_est.KernelRidge(alpha=0.5, kernel="precomputed", device="cpu").fit(K, y)
    want = j_est.KernelRidge(alpha=0.5, kernel="precomputed").fit(K, y)
    _close(got.predict(Kt), want.predict(Kt))
    rbf = t_est.KernelRidge(alpha=0.5, kernel="rbf", sigma=1.2, device="cpu").fit(X, y)
    _close(got.predict(Kt), rbf.predict(Xt))


def _bad_cases(X, y):
    Xn = X.copy()
    Xn[3, 1] = np.nan
    yi = y.copy()
    yi[0] = np.inf
    sq = np.random.default_rng(0).standard_normal((6, 9)).astype(np.float32)
    return {
        "nonfinite-X": (dict(), Xn, y),
        "nonfinite-y": (dict(), X, yi),
        "row-counts": (dict(), X, y[:-1]),
        "X-1d": (dict(), X[:, 0], y),
        "y-3d": (dict(), X, y[:, None, None]),
        "nonsquare-precomputed": (dict(kernel="precomputed"), sq, y[:6]),
        "alpha": (dict(alpha=0.0), X, y),
        "sigma": (dict(sigma=-1.0), X, y),
        "gamma": (dict(gamma=-2.0), X, y),
        "kernel": (dict(kernel="nope"), X, y),
        "solver": (dict(solver="nope"), X, y),
        "solver-opt": (dict(solver="direct", solver_opts={"max_iters": 5}), X, y),
    }


@pytest.mark.parametrize("case", sorted(_bad_cases(np.zeros((4, 2)), np.zeros(4))))
def test_validation_errors_match_reference(data, case):
    X, y, _, _ = data
    kw, bx, by = _bad_cases(X, y)[case]
    with pytest.raises(ValueError) as want:
        j_est.KernelRidge(**kw).fit(bx, by)
    with pytest.raises(ValueError) as got:
        t_est.KernelRidge(device="cpu", **kw).fit(bx, by)
    assert str(got.value) == str(want.value)


def test_predict_edges_and_unfitted(data):
    X, y, Y, Xt = data
    with pytest.raises(ValueError, match="not fitted"):
        t_est.KernelRidge(device="cpu").predict(Xt)
    est = t_est.KernelRidge(alpha=0.5, device="cpu").fit(X, Y)
    p = est.predict(np.zeros((0, D), np.float32))
    assert p.shape == (0, 3) and p.dtype == est.dual_coef_.dtype
    assert est.predict(X[:7]).shape == (7, 3)
    one = t_est.KernelRidge(alpha=1.0, device="cpu").fit(X[:1], y[:1])
    assert one.predict(X[:1]).shape == (1,) and bool(torch.isfinite(one.predict(X[:1])).all())


def test_device_and_mesh_are_refused(data):
    X, y, _, _ = data
    assert t_est.KernelRidge().device == "cuda"  # entry points default to the card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_est.KernelRidge().fit(X, y)
    from repro_torch.distributed.meshes import make_solver_mesh

    mesh = make_solver_mesh("1x1", device="cpu")
    with pytest.raises(ValueError, match="no distributed path"):  # auto -> direct
        t_est.KernelRidge(device="cpu", mesh=mesh).fit(X, y)


@pytest.mark.parametrize("cls", ["KernelRidge", "KernelRidgeCV", "MultipleKernelRidgeCV"])
def test_params_are_the_references_with_device_for_backend(cls):
    want = getattr(j_est, cls)().get_params()
    got = getattr(t_est, cls)().get_params()
    assert set(got) == (set(want) - {"backend"}) | {"device"}
    assert {k: v for k, v in got.items() if k != "device"} == \
        {k: v for k, v in want.items() if k != "backend"}


@pytest.fixture(scope="module")
def cv_pair(data):
    X, y, _, _ = data
    kw = dict(alphas=(0.1, 1.0, 5.0), sigmas=(0.8, 1.5), cv=3)
    return (t_est.KernelRidgeCV(device="cpu", **kw).fit(X, y),
            j_est.KernelRidgeCV(**kw).fit(X, y))


def test_kernel_ridge_cv_matches_reference(cv_pair, data):
    got, want = cv_pair
    assert got.best_params_["sigma"] == want.best_params_["sigma"]
    assert got.best_params_["alpha"] == pytest.approx(want.best_params_["alpha"], rel=1e-12)
    assert set(got.cv_results_) == set(want.cv_results_)
    assert got.cv_results_["rank_test_score"] == want.cv_results_["rank_test_score"]
    assert got.cv_results_["param_sigma"] == want.cv_results_["param_sigma"]
    np.testing.assert_allclose(got.cv_results_["mean_test_mse"],
                               want.cv_results_["mean_test_mse"], rtol=1e-3)
    assert got.best_score_ == pytest.approx(want.best_score_, rel=1e-3)
    _close(got.predict(data[3]), want.predict(data[3]))


def test_multiple_kernel_cv_matches_reference(data):
    X, _, Y, Xt = data
    kw = dict(kernels=("rbf", "laplacian"), alphas=(0.1, 1.0), sigmas=((0.8, 1.6),),
              cv=3, n_weight_samples=3, seed=2)
    got = t_est.MultipleKernelRidgeCV(device="cpu", **kw).fit(X, Y[:, :2])
    want = j_est.MultipleKernelRidgeCV(**kw).fit(X, Y[:, :2])
    assert got.kernel_weights_ == pytest.approx(want.kernel_weights_, rel=1e-6)
    assert got.best_params_["sigma"] == want.best_params_["sigma"]
    assert got.best_params_["alpha"] == pytest.approx(want.best_params_["alpha"], rel=1e-12)
    assert set(got.cv_results_) == set(want.cv_results_)
    assert got.cv_results_["rank_test_score"] == want.cv_results_["rank_test_score"]
    _close(got.predict(Xt), want.predict(Xt))


# ---------------------------------------------------------------------------
# against scikit-learn (f64 on the CPU)
# ---------------------------------------------------------------------------

PAIRS = [("rbf", dict(gamma=0.3)), ("laplacian", dict(gamma=0.45)), ("linear", dict()),
         ("polynomial", dict(gamma=0.2)), ("sigmoid", dict(gamma=0.05)), ("cosine", dict())]


@pytest.mark.parametrize("t", [None, 3], ids=["y1d", "multioutput"])
@pytest.mark.parametrize("kernel,kw", PAIRS, ids=[p[0] for p in PAIRS])
def test_kernel_ridge_matches_sklearn_f64(data64, kernel, kw, t):
    X, y, Y, Xt = data64
    yy = y if t is None else Y
    est = t_est.KernelRidge(alpha=0.8, kernel=kernel, device="cpu", **kw).fit(X, yy)
    sk = SkKernelRidge(alpha=0.8, kernel=kernel, **kw).fit(X, yy)
    pred = est.predict(Xt)
    assert pred.dtype == torch.float64
    np.testing.assert_allclose(pred.numpy(), sk.predict(Xt), rtol=1e-5, atol=1e-8)
    yt = sk.predict(Xt) + 0.1
    assert est.score(Xt, yt) == pytest.approx(sk.score(Xt, yt), rel=1e-5)


def test_matern52_and_precomputed_match_sklearn_f64(data64):
    X, y, _, Xt = data64
    mat = Matern(length_scale=1.3, nu=2.5)
    sk = SkKernelRidge(alpha=0.6, kernel="precomputed").fit(mat(X), y)
    est = t_est.KernelRidge(alpha=0.6, kernel="matern52", sigma=1.3, device="cpu").fit(X, y)
    np.testing.assert_allclose(est.predict(Xt).numpy(), sk.predict(mat(Xt, X)), rtol=1e-5,
                               atol=1e-8)
    pre = t_est.KernelRidge(alpha=0.6, kernel="precomputed", device="cpu").fit(mat(X), y)
    np.testing.assert_allclose(pre.predict(mat(Xt, X)).numpy(), sk.predict(mat(Xt, X)),
                               rtol=1e-5, atol=1e-8)


R2_CASES = {
    "1d": lambda r: (r.standard_normal(30), r.standard_normal(30)),
    "multioutput": lambda r: (r.standard_normal((30, 3)), r.standard_normal((30, 3))),
    "constant-exact": lambda r: (np.full(10, 2.0), np.full(10, 2.0)),
    "constant-missed": lambda r: (np.full(10, 2.0), np.full(10, 2.5)),
    "one-constant-head": lambda r: (np.c_[np.full(12, 1.0), r.standard_normal(12)],
                                    np.c_[np.full(12, 1.5), r.standard_normal(12)]),
}


@pytest.mark.parametrize("case", sorted(R2_CASES))
def test_r2_matches_sklearn(case):
    yt, yp = R2_CASES[case](np.random.default_rng(3))
    want = sk_r2_score(yt, yp)
    assert r2_score(torch.from_numpy(yt), torch.from_numpy(yp)) == pytest.approx(want, rel=1e-12)


def test_clone_and_grid_search_match_sklearn(data64):
    X, y, _, _ = data64
    est = t_est.KernelRidge(alpha=0.3, kernel="laplacian", gamma=0.2, device="cpu")
    cl = clone(est)
    assert cl is not est and cl.get_params() == est.get_params()
    grid = {"alpha": [0.05, 0.5, 5.0]}
    got = GridSearchCV(t_est.KernelRidge(kernel="rbf", gamma=0.3, device="cpu"), grid,
                       cv=3).fit(X, y)
    want = GridSearchCV(SkKernelRidge(kernel="rbf", gamma=0.3), grid, cv=3).fit(X, y)
    assert got.best_params_ == want.best_params_
    assert got.best_score_ == pytest.approx(want.best_score_, rel=1e-5)
