"""Cross-validated estimators over the ``core/tune`` engine — the port of
``repro.estimators.cv``.

``KernelRidgeCV`` sweeps a (sigma, alpha) grid with k-fold CV and refits the
winner; ``MultipleKernelRidgeCV`` adds himalaya-style Dirichlet weight search
over a convex kernel combination (per-kernel sigma vectors included).  Both
ride the tile-sharing stacked engine — per sigma, ONE blocked solve scores
every (alpha, fold, head[, weight]) candidate — so a CV sweep costs a few
kernel sweeps, not ``len(alphas) * folds`` of them, and both expose the
search through sklearn's ``best_params_`` / ``best_score_`` /
``cv_results_`` idiom (built from ``TuneResult.trace``).

Alpha convention, exactly as :class:`~repro_torch.estimators.kernel_ridge.
KernelRidge`: the refit solves ``(K + alpha I) c = y``.  One documented
nuance: during CV the engine scales each candidate's shift by the TRAIN-FOLD
size (``n_fold * lam_unscaled``, the paper's per-problem rule), so a
candidate's effective CV alpha is ``alpha * (k-1)/k`` — ranking is on
slightly lighter regularization than the refit, the same direction every
k-fold ridge CV (sklearn included, which reuses one alpha across fold sizes
by a different convention) accepts.

``device=`` takes the reference's ``backend=`` slot (see
:mod:`repro_torch.estimators.kernel_ridge`); ``mesh=`` is passed through
to ``tune`` and the refit's ``solve``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.krr import KRRProblem
from repro_torch.core.solver_api import solve, tune
from repro_torch.core.tune import apply_best
from repro_torch.device import resolve_device
from repro_torch.estimators.base import (
    BaseEstimator,
    FittedPredictorMixin,
    RegressorMixin,
    check_fit_arrays,
    solver_dtype,
)
from repro_torch.estimators.kernel_ridge import resolve_method


def _rank_desc(scores: list[float]) -> list[int]:
    """sklearn-style 1-based competition ranks, higher score = rank 1."""
    order = np.argsort([-s for s in scores], kind="stable")
    ranks = [0] * len(scores)
    rank = 0
    prev = None
    for pos, idx in enumerate(order):
        if prev is None or scores[idx] != prev:
            rank = pos + 1
            prev = scores[idx]
        ranks[idx] = rank
    return ranks


def _cv_results(result, n: int) -> dict:
    """``cv_results_`` dict from a TuneResult: one entry per candidate in
    trace order, scores in sklearn's higher-is-better convention (negated
    CV MSE)."""
    trace = result.trace or []
    sigmas = [t["sigma"] for t in trace]
    alphas = [float(t["lam_unscaled"]) * n for t in trace]
    mses = [float(t["scores"][-1]) for t in trace]
    scores = [-m for m in mses]
    out = {
        "param_sigma": sigmas,
        "param_alpha": alphas,
        "mean_test_mse": mses,
        "mean_test_score": scores,
        "rank_test_score": _rank_desc(scores),
        "pruned_at_rung": [t.get("pruned_at_rung") for t in trace],
        "trace": trace,
    }
    if trace and "weights" in trace[0]:
        out["param_weights"] = [t["weights"] for t in trace]
    return out


class _BaseTunedRidge(FittedPredictorMixin, RegressorMixin, BaseEstimator):
    """Shared tune -> refit plumbing; subclasses build the tune() call."""

    def _refit(self, problem: KRRProblem, result) -> None:
        refit_problem = apply_best(problem, result)
        n = refit_problem.n
        out = solve(
            refit_problem, resolve_method(self.solver, n), mesh=self.mesh,
            **dict(self.solver_opts or {}),
        )
        self._problem = refit_problem
        self._predict_fn = out.predict_fn
        self.dual_coef_ = out.w
        self.X_fit_ = refit_problem.x
        self.tune_result_ = result
        self.best_score_ = -float(result.best_score)
        self.cv_results_ = _cv_results(result, n)
        self.alpha_ = float(result.best["lam_unscaled"]) * n
        self.sigma_ = result.best["sigma"]
        self.solve_info_ = out.info


class KernelRidgeCV(_BaseTunedRidge):
    """Kernel ridge with built-in (sigma, alpha) search + winning refit.

    Args:
      alphas: candidate ridge strengths (sklearn's ``alpha`` convention).
      sigmas: candidate bandwidths in the stack's parameterization; for
        ``kernel="precomputed"`` the bandwidth axis collapses to (1.0,)
        automatically (the Gram already encodes it).
      kernel: one ``core.kernels.KERNEL_NAMES`` name or ``"precomputed"``.
      cv: number of CV folds (k-fold over a seeded shuffle split).
      policy: ``"grid"`` | ``"random"`` | ``"halving"`` search policy
        (``num_samples`` bounds the random draw).
      seed: rng seed for folds / sampling.
      tune_opts: extra ``tune()`` options (``rank``, ``max_iters``, ``tol``,
        ``warm_start``, ``sigma_continuation``, ...).
      solver / solver_opts / device / precision / mesh: refit pass-throughs,
        as in :class:`~repro_torch.estimators.kernel_ridge.KernelRidge`
        (``device`` also places the search).

    Attributes (after fit): ``best_params_`` (``{"alpha", "sigma"}``),
    ``best_score_`` (negated CV MSE — sklearn's higher-is-better),
    ``cv_results_`` (per-candidate params/scores/ranks from
    ``TuneResult.trace``), ``tune_result_`` (the full audit trail), plus
    the fitted-model attributes of ``KernelRidge``.
    """

    def __init__(
        self,
        alphas=(0.01, 0.1, 1.0),
        *,
        sigmas=(0.5, 1.0, 2.0),
        kernel: str = "rbf",
        cv: int = 5,
        policy: str = "grid",
        num_samples: int | None = None,
        seed: int = 0,
        tune_opts: dict | None = None,
        solver: str = "auto",
        solver_opts: dict | None = None,
        device: str = "cuda",
        precision: str = "f32",
        mesh=None,
    ):
        self.alphas = alphas
        self.sigmas = sigmas
        self.kernel = kernel
        self.cv = cv
        self.policy = policy
        self.num_samples = num_samples
        self.seed = seed
        self.tune_opts = tune_opts
        self.solver = solver
        self.solver_opts = solver_opts
        self.device = device
        self.precision = precision
        self.mesh = mesh

    def fit(self, X, y):
        """Run the CV sweep over (sigmas, alphas) and refit the winner on
        all of ``X``/``y``.  Returns self."""
        X, y = check_fit_arrays(X, y, precomputed=self.kernel == "precomputed",
                                device=resolve_device(self.device))
        X, y = solver_dtype(X, y, "tune")  # the search's CG keeps f32 state
        n = X.shape[0]
        problem = KRRProblem(
            x=X, y=y, kernel=self.kernel, sigma=1.0, precision=self.precision,
        )
        sigmas = (
            (1.0,) if self.kernel == "precomputed" else tuple(self.sigmas)
        )
        kw = dict(self.tune_opts or {})
        if self.num_samples is not None:
            kw["num_samples"] = int(self.num_samples)
        result = tune(
            problem,
            sigmas=sigmas,
            lams=tuple(float(a) / n for a in self.alphas),
            folds=int(self.cv),
            policy=self.policy,
            seed=int(self.seed),
            mesh=self.mesh,
            **kw,
        )
        self._refit(problem, result)
        self.n_features_in_ = int(X.shape[1])
        self.best_params_ = {"alpha": self.alpha_, "sigma": self.sigma_}
        return self


class MultipleKernelRidgeCV(_BaseTunedRidge):
    """CV search over convex kernel combinations ``K_w = sum_i w_i K_i``.

    himalaya's ``MultipleKernelRidgeCV`` shape: Dirichlet-sample weight
    vectors on the simplex (or score explicit ``weights`` rows), sweep them
    jointly with (sigma, alpha) through the stacked multi-kernel engine —
    every weight candidate is one more COLUMN of the same solve, and the q
    per-kernel tiles come from one data sweep — then refit the winning
    (weights, sigma, alpha) on all the data.

    Args:
      kernels: the q base-kernel names of the combination.
      sigmas: candidate bandwidths — scalars (shared by all q kernels) or
        length-q tuples (per-kernel bandwidth vectors), freely mixed.
      alphas / cv / seed: as :class:`KernelRidgeCV`.
      n_weight_samples: Dirichlet draws from the simplex (ignored when
        ``weights`` rows are given).
      dirichlet_alpha: concentration of the Dirichlet sampler.
      weights: optional explicit (M, q) weight candidates.
      policy: ``"random"`` (default) or ``"halving"``.
      tune_opts / solver / solver_opts / device / precision / mesh: as
        :class:`KernelRidgeCV`.

    Attributes (after fit): ``kernel_weights_`` (the winning (q,) weight
    vector), ``best_params_`` (``{"alpha", "sigma", "weights"}``), and the
    rest of the :class:`KernelRidgeCV` surface.
    """

    def __init__(
        self,
        kernels=("rbf", "laplacian"),
        *,
        alphas=(0.01, 0.1, 1.0),
        sigmas=(0.5, 1.0, 2.0),
        cv: int = 5,
        n_weight_samples: int = 8,
        dirichlet_alpha: float = 1.0,
        weights=None,
        policy: str = "random",
        seed: int = 0,
        tune_opts: dict | None = None,
        solver: str = "auto",
        solver_opts: dict | None = None,
        device: str = "cuda",
        precision: str = "f32",
        mesh=None,
    ):
        self.kernels = kernels
        self.alphas = alphas
        self.sigmas = sigmas
        self.cv = cv
        self.n_weight_samples = n_weight_samples
        self.dirichlet_alpha = dirichlet_alpha
        self.weights = weights
        self.policy = policy
        self.seed = seed
        self.tune_opts = tune_opts
        self.solver = solver
        self.solver_opts = solver_opts
        self.device = device
        self.precision = precision
        self.mesh = mesh

    def fit(self, X, y):
        """Joint (weights, sigma, alpha) CV search + winning refit."""
        X, y = check_fit_arrays(X, y, device=resolve_device(self.device))
        X, y = solver_dtype(X, y, "tune")  # the search's CG keeps f32 state
        n = X.shape[0]
        problem = KRRProblem(
            x=X, y=y, kernel=tuple(self.kernels), sigma=1.0,
            precision=self.precision,
        )
        result = tune(
            problem,
            sigmas=tuple(self.sigmas),
            lams=tuple(float(a) / n for a in self.alphas),
            folds=int(self.cv),
            n_weight_samples=int(self.n_weight_samples),
            dirichlet_alpha=float(self.dirichlet_alpha),
            weights=self.weights,
            policy=self.policy,
            seed=int(self.seed),
            mesh=self.mesh,
            **dict(self.tune_opts or {}),
        )
        self._refit(problem, result)
        self.n_features_in_ = int(X.shape[1])
        self.kernel_weights_ = tuple(
            float(w) for w in result.best["weights"]
        )
        self.best_params_ = {
            "alpha": self.alpha_,
            "sigma": self.sigma_,
            "weights": self.kernel_weights_,
        }
        return self
