"""KernelRidge — the sklearn-compatible front door to the solver stack; the
port of ``repro.estimators.kernel_ridge``.

``sklearn.kernel_ridge.KernelRidge`` semantics (same model, same ``alpha``
and ``gamma`` conventions, same multi-output behavior) over
``repro_torch.core.solver_api.solve``: small fits default to the
closed-form direct solver and large ones to ASkotch, and every solver /
precision option of the stack is reachable through constructor parameters —
fit/predict/score is the only API a scientific user needs.

sklearn solves ``(K + alpha I) c = y`` while this stack solves
``(K + n lam_unscaled I) W = Y`` (the paper's App. C.2.1 scaling), so
``lam_unscaled = alpha / n`` makes the two models identical; bandwidths map
through ``core.kernels``'s single-sigma parameterization (each kernel's
docstring states its sklearn ``gamma`` equivalence).

The reference's ``backend=`` has no counterpart (the port dispatches by the
tensor's device): ``device=`` takes its place in the parameter list, so
``get_params`` lists the reference's keys with ``device`` for ``backend``.
It defaults to ``"cuda"`` and raises without a card; pass ``device="cpu"``
to fit on the CPU.
"""

from __future__ import annotations

from repro_torch.core.kernels import KERNEL_NAMES
from repro_torch.core.krr import KRRProblem
from repro_torch.core.solver_api import METHODS, solve
from repro_torch.device import resolve_device
from repro_torch.estimators.base import (
    BaseEstimator,
    FittedPredictorMixin,
    RegressorMixin,
    check_fit_arrays,
    solver_dtype,
)

#: n up to which solver="auto" picks the O(n^3) closed-form direct solver;
#: beyond it ASkotch's O(n b) iterations win
AUTO_DIRECT_MAX_N = 2048


def resolve_sigma(kernel: str, sigma, gamma, n_features: int) -> float:
    """The single bandwidth ``sigma`` the operator layer runs on.

    Precedence: explicit ``sigma`` > explicit ``gamma`` (translated per
    kernel — the table in ``core.kernels``) > sklearn's default
    ``gamma = 1 / n_features``.  ``linear``/``cosine`` are gamma-free
    (sigma 1.0) and ``precomputed`` has no bandwidth at all.
    """
    if kernel == "precomputed":
        return 1.0
    if sigma is not None:
        sigma = float(sigma)
        if sigma <= 0:
            raise ValueError(f"sigma must be positive; got {sigma}")
        return sigma
    if kernel in ("linear", "cosine"):
        return 1.0
    g = 1.0 / n_features if gamma is None else float(gamma)
    if g <= 0:
        raise ValueError(f"gamma must be positive; got {g}")
    if kernel == "rbf":
        return (0.5 / g) ** 0.5  # k = exp(-g d^2) = exp(-d^2 / (2 sigma^2))
    if kernel in ("laplacian", "matern52"):
        return 1.0 / g  # laplacian k = exp(-g d1); matern length_scale
    if kernel in ("polynomial", "sigmoid"):
        return g**-0.5  # g <x, y> = <x, y> / sigma^2
    raise ValueError(
        f"unknown kernel {kernel!r}; available: "
        f"{KERNEL_NAMES + ('precomputed',)}"
    )


def resolve_method(solver: str, n: int) -> str:
    """The ``solve()`` method for ``solver`` at n training rows
    (``"auto"``: direct up to :data:`AUTO_DIRECT_MAX_N`, ASkotch beyond)."""
    if solver == "auto":
        return "direct" if n <= AUTO_DIRECT_MAX_N else "askotch"
    if solver not in METHODS:
        raise ValueError(
            f"unknown solver {solver!r}; available: {METHODS + ('auto',)}"
        )
    return solver


class KernelRidge(FittedPredictorMixin, RegressorMixin, BaseEstimator):
    """Kernel ridge regression with sklearn fit/predict/score semantics.

    Args:
      alpha: sklearn's ridge strength — the solved system is
        ``(K + alpha I) c = y`` exactly (internally ``lam_unscaled =
        alpha / n``).
      kernel: a ``core.kernels.KERNEL_NAMES`` name, or ``"precomputed"``
        (then ``fit`` X is the (n, n) train Gram and ``predict`` X is the
        (m, n) test-vs-train cross Gram).
      gamma: sklearn-convention bandwidth (``None`` -> ``1 / n_features``
        for the gamma-full kernels); translated to the stack's single
        ``sigma`` per kernel.
      sigma: direct bandwidth in this stack's parameterization — wins over
        ``gamma`` when both are given.
      solver: a ``solver_api.METHODS`` name, or ``"auto"`` (direct up to
        n = 2048, ASkotch beyond).
      solver_opts: extra keyword options for ``solve`` (``tol``,
        ``max_iters``, ``rank``, ``block_size``, ``telemetry``, ...),
        validated against the method's accepted list there.
      device: where the data and every kernel sweep live (the reference's
        ``backend`` slot): ``"cuda"`` (default; raises without a card) or
        ``"cpu"``.  float64 input stays float64 for a direct solve on the
        CPU; the iterative solvers and the card run float32.
      precision: "f32" | "bf16" kernel tile policy.
      mesh: optional ``repro_torch.distributed.meshes.SolverMesh``, passed
        through to ``solve`` (a method without a distributed path raises
        there).

    Attributes (after fit):
      dual_coef_: (n,) or (n, t) representer weights, a tensor on the fit
        device.
      X_fit_: the training rows (features, or the widened Gram for
        ``precomputed``) predictions are computed against.
      n_features_in_: feature count of fit X.
      sigma_: the resolved bandwidth actually solved with.
      solve_info_: the ``solve()`` info dict (iterations, convergence).
    """

    def __init__(
        self,
        alpha: float = 1.0,
        *,
        kernel: str = "rbf",
        gamma: float | None = None,
        sigma: float | None = None,
        solver: str = "auto",
        solver_opts: dict | None = None,
        device: str = "cuda",
        precision: str = "f32",
        mesh=None,
    ):
        self.alpha = alpha
        self.kernel = kernel
        self.gamma = gamma
        self.sigma = sigma
        self.solver = solver
        self.solver_opts = solver_opts
        self.device = device
        self.precision = precision
        self.mesh = mesh

    def fit(self, X, y):
        """Solve the dual system for ``X`` ((n, d) features, or the (n, n)
        train Gram when ``kernel="precomputed"``) and targets ``y`` ((n,) or
        (n, t) multi-output).  Returns self."""
        if float(self.alpha) <= 0:
            raise ValueError(f"alpha must be positive; got {self.alpha}")
        X, y = check_fit_arrays(X, y, precomputed=self.kernel == "precomputed",
                                device=resolve_device(self.device))
        n = X.shape[0]
        sigma = resolve_sigma(self.kernel, self.sigma, self.gamma, X.shape[1])
        method = resolve_method(self.solver, n)
        X, y = solver_dtype(X, y, method)
        problem = KRRProblem(
            x=X, y=y, kernel=self.kernel, sigma=sigma,
            lam_unscaled=float(self.alpha) / n, precision=self.precision,
        )
        out = solve(problem, method, mesh=self.mesh, **dict(self.solver_opts or {}))
        self._problem = problem
        # per-method scorer (Falkon's w lives on inducing points) —
        # dual_coef_ stays the raw weights
        self._predict_fn = out.predict_fn
        self.dual_coef_ = out.w
        self.X_fit_ = problem.x
        self.n_features_in_ = int(X.shape[1])
        self.sigma_ = sigma
        self.solve_info_ = out.info
        return self
