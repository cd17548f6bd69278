"""sklearn interop for the estimator front end — import guard, validation
and R²; the port of ``repro.estimators.base``.

The estimators subclass ``sklearn.base.BaseEstimator``/``RegressorMixin``
when scikit-learn is importable (so ``sklearn.clone``, ``GridSearchCV``
nesting, and pipeline composition all work natively) and fall back to a
small structural shim otherwise — the public surface (``get_params`` /
``set_params`` / ``score`` with R^2) is identical either way, so nothing in
the port requires scikit-learn at runtime (the card's machine has none).

``score`` is computed here, in torch, with ``sklearn.metrics.r2_score``'s
semantics (:func:`r2_score`): ``predict`` returns a tensor on the fit
device, which sklearn's own ``score`` cannot pass through ``np.asarray``
when that device is a card.

The shared fit-time validation lives here too: estimator ``fit`` is the ONE
boundary where user data enters the solver stack, so shape/finite checks
raise clear ``ValueError``s here instead of surfacing as NaN solutions deep
inside a solve.  Dtypes (there is no global x64 switch in torch): a float64
input stays float64 on the CPU, where the plain kernel versions promote;
everything goes to float32 on the card, where the CUDA kernels take f32;
integer and other inputs become float32.  The iterative solvers and the CV
search keep the JAX package's f32 state, so the estimators narrow float64
to float32 for them (:func:`solver_dtype`): float64 reaches only a direct
solve on the CPU — what the sklearn parity check compares.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

try:  # pragma: no cover - exercised implicitly by every estimator test
    from sklearn.base import BaseEstimator, RegressorMixin

    HAVE_SKLEARN = True
except ImportError:  # pragma: no cover
    HAVE_SKLEARN = False

    class BaseEstimator:  # type: ignore[no-redef]
        """Structural stand-in for ``sklearn.base.BaseEstimator``: the
        get_params/set_params contract over ``__init__`` keyword names."""

        @classmethod
        def _get_param_names(cls):
            sig = inspect.signature(cls.__init__)
            return sorted(
                p.name
                for p in sig.parameters.values()
                if p.name != "self" and p.kind != p.VAR_KEYWORD
            )

        def get_params(self, deep: bool = True) -> dict:
            """Constructor parameters by name (``deep`` accepted for API
            compatibility; these estimators have no nested estimators)."""
            return {k: getattr(self, k) for k in self._get_param_names()}

        def set_params(self, **params):
            """Set constructor parameters by name; unknown names raise."""
            valid = set(self._get_param_names())
            for k, v in params.items():
                if k not in valid:
                    raise ValueError(
                        f"invalid parameter {k!r} for {type(self).__name__}; "
                        f"valid: {sorted(valid)}"
                    )
                setattr(self, k, v)
            return self

        def __repr__(self) -> str:
            args = ", ".join(
                f"{k}={v!r}" for k, v in sorted(self.get_params().items())
            )
            return f"{type(self).__name__}({args})"

    class RegressorMixin:  # type: ignore[no-redef]
        """Structural stand-in for ``sklearn.base.RegressorMixin`` (``score``
        comes from :class:`FittedPredictorMixin`)."""

        _estimator_type = "regressor"


def r2_score(y_true: torch.Tensor, y_pred: torch.Tensor) -> float:
    """R² with ``sklearn.metrics.r2_score``'s defaults, in torch on the
    tensors' device: uniform average over output heads; a constant target
    head scores 1.0 when predicted exactly and 0.0 otherwise; fewer than
    two samples give NaN."""
    if y_true.shape != y_pred.shape:
        raise ValueError(
            f"y has shape {tuple(y_true.shape)}, predictions {tuple(y_pred.shape)}"
        )
    if y_true.shape[0] < 2:
        return float("nan")
    y2 = y_true.reshape(y_true.shape[0], -1)
    p2 = y_pred.reshape(y_pred.shape[0], -1)
    ss_res = ((y2 - p2) ** 2).sum(dim=0)
    ss_tot = ((y2 - y2.mean(dim=0)) ** 2).sum(dim=0)
    safe = torch.where(ss_tot == 0, torch.ones_like(ss_tot), ss_tot)
    r2 = torch.where(ss_tot == 0, (ss_res == 0).to(ss_res.dtype), 1.0 - ss_res / safe)
    return float(r2.mean())


class FittedPredictorMixin:
    """Shared predict / score for estimators whose ``fit`` stores
    ``dual_coef_`` and a per-method ``_predict_fn`` scorer (the ``solve()``
    output's closure)."""

    def predict(self, X):
        """Predictions for ``X`` ((m, d) features, or the (m, n) cross Gram
        for a precomputed-kernel fit): a (m,) or (m, t) tensor on the fit
        device in the weights' dtype, matching the fit targets."""
        if not hasattr(self, "dual_coef_"):
            raise ValueError(
                f"{type(self).__name__} is not fitted; call fit(X, y) first"
            )
        X = check_array(X, "X", device=self.dual_coef_.device).to(self.dual_coef_.dtype)
        if X.shape[0] == 0:
            # dtype follows the weights (the serving-layer contract)
            return torch.zeros((0,) + tuple(self.dual_coef_.shape[1:]),
                               dtype=self.dual_coef_.dtype, device=self.dual_coef_.device)
        return self._predict_fn(X)

    def score(self, X, y) -> float:
        """R² of ``self.predict(X)`` against ``y`` (:func:`r2_score`)."""
        pred = self.predict(X)
        y = check_array(y, "y", ndim=(1, 2), device=pred.device)
        return r2_score(y.to(pred.dtype), pred)


def check_array(arr, name: str, *, ndim: tuple[int, ...] = (2,),
                device: torch.device | str = "cpu") -> torch.Tensor:
    """Convert to a float tensor on ``device``, rejecting bad shapes/values
    with clear errors.  float64 stays float64 on the CPU; anything else, and
    everything on the card, becomes float32."""
    if isinstance(arr, torch.Tensor):
        a = arr
    else:
        a_np = np.asarray(arr)
        # a read-only buffer (a JAX array, a broadcast view) is copied: torch
        # wants writable memory
        a = torch.as_tensor(a_np if a_np.flags.writeable else a_np.copy())
    if a.ndim not in ndim:
        raise ValueError(
            f"{name} must be {' or '.join(f'{d}-D' for d in ndim)}; got "
            f"shape {tuple(a.shape)}"
        )
    device = torch.device(device)
    keep64 = a.dtype == torch.float64 and device.type == "cpu"
    a = a.to(device=device, dtype=torch.float64 if keep64 else torch.float32)
    if a.numel() and not bool(torch.isfinite(a).all()):
        raise ValueError(
            f"{name} contains non-finite values (NaN or inf); clean or "
            f"impute the data before fit/predict"
        )
    return a


def solver_dtype(X: torch.Tensor, y: torch.Tensor, method: str):
    """(X, y) in the dtype ``method`` runs: float64 only for a direct solve
    (the iterative solvers keep f32 state), float32 otherwise."""
    if method == "direct":
        return X, y
    return X.to(torch.float32), y.to(torch.float32)


def check_fit_arrays(X, y, *, precomputed: bool = False,
                     device: torch.device | str = "cpu"):
    """Validate an (X, y) fit pair; returns tensors on ``device``.

    ``precomputed=True`` means X is the train Gram: it must be square (or
    already index-widened) and row-aligned with y.  y takes X's dtype.
    """
    X = check_array(X, "X", device=device)
    y = check_array(y, "y", ndim=(1, 2), device=device).to(X.dtype)
    if precomputed and X.shape[1] not in (X.shape[0], X.shape[0] + 1):
        raise ValueError(
            "kernel='precomputed' expects a square (n, n) train Gram matrix "
            f"for X; got shape {tuple(X.shape)}"
        )
    if X.shape[0] != y.shape[0]:
        raise ValueError(
            f"X and y row counts differ: X has {X.shape[0]} rows, y has "
            f"{y.shape[0]}"
        )
    if X.shape[0] < 1:
        raise ValueError("fit needs at least one sample")
    return X, y
