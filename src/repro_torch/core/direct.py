"""Direct Cholesky solve of (K + lam I) W = Y — O(n^3) time, O(n^2) memory —
the port of ``repro.core.direct``.

Ground truth for tests and the small-n end of the baselines.  One
factorization back-substitutes all t columns of a (n, t) Y; a (n,) y
returns a (n,) w.  The same factorization gives closed-form leave-one-out
residuals (:func:`loo_residuals`).

A failed factorization yields NaN, as ``jnp.linalg.cholesky`` does, not an
exception (``cholesky_or_nan``).
"""

from __future__ import annotations

import torch

from repro_torch.core.krr import KRRProblem, scaled_lam
from repro_torch.core.nystrom import cholesky_or_nan
from repro_torch.core.operator import as_multirhs, maybe_squeeze


def _chol_k_lam(problem: KRRProblem, lam: float) -> torch.Tensor:
    k = problem.op.block(problem.x)
    k.diagonal().add_(lam)
    return cholesky_or_nan(k)


def solve_direct(problem: KRRProblem) -> torch.Tensor:
    """Dense Cholesky solve of (K + lam I) W = Y; W (n,) or (n, t)."""
    chol = _chol_k_lam(problem, problem.lam)
    y2, squeeze = as_multirhs(problem.y)
    return maybe_squeeze(torch.cholesky_solve(y2, chol), squeeze)


def loo_residuals(problem: KRRProblem, *, lam: float | None = None) -> torch.Tensor:
    """Closed-form leave-one-out residuals from ONE Cholesky.

    For C = K + lam I and alpha = C^{-1} y, the model trained without point
    i predicts it with residual ``alpha_i / (C^{-1})_{ii}``.  ``lam``
    defaults to ``scaled_lam(n - 1, lam_unscaled)`` (each LOO model trains
    on n - 1 rows); pass ``lam=problem.lam`` for the fixed shift.

    Returns residuals shaped like ``problem.y``.
    """
    lam_f = scaled_lam(problem.n - 1, problem.lam_unscaled) if lam is None else lam
    chol = _chol_k_lam(problem, float(lam_f))
    y2, squeeze = as_multirhs(problem.y)
    alpha = torch.cholesky_solve(y2, chol)
    eye = torch.eye(problem.n, dtype=y2.dtype, device=y2.device)
    c_inv = torch.cholesky_solve(eye, chol)
    return maybe_squeeze(alpha / torch.diagonal(c_inv)[:, None], squeeze)


def loo_mse(problem: KRRProblem, *, lam: float | None = None) -> float:
    """Exact leave-one-out CV mean-squared-error (see :func:`loo_residuals`)."""
    return float(torch.mean(loo_residuals(problem, lam=lam) ** 2))
