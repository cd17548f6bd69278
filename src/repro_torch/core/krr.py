"""Full-KRR problem container, prediction, and metrics (paper Eqs. (2)-(3)).

The port of ``repro.core.krr``.  The problem is the linear system
(K + lam I) W = Y with lam = n * lam_unscaled.  Y may be (n,) or (n, t)
with t one-vs-all heads.  The problem's tensors decide the device every
kernel sweep runs on.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.operator import as_multirhs, widen_gram


def scaled_lam(n: int, lam_unscaled: float) -> float:
    """The paper's regularization scaling, lam = n * lam_unscaled."""
    return float(n) * float(lam_unscaled)


def residual_report(op, y: torch.Tensor, lam: float, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(aggregate, per-head) relative residuals of (K + lam I) W = Y from ONE
    streamed matvec; both stay on the device (no host sync)."""
    w2, _ = as_multirhs(w)
    y2, _ = as_multirhs(y)
    r = op.k_lam_matvec(w2, lam) - y2
    ynorm = torch.clamp_min(torch.linalg.vector_norm(y2, dim=0), torch.finfo(y2.dtype).tiny)
    per_head = torch.linalg.vector_norm(r, dim=0) / ynorm
    return torch.linalg.vector_norm(r) / torch.linalg.vector_norm(y2), per_head


@dataclasses.dataclass(frozen=True)
class KRRProblem:
    """Problem container.  ``kernel`` is one kernel name, a tuple of names
    (a weighted-sum multi-kernel problem: ``sigma`` may then be per kernel,
    ``weights`` defaults to uniform) or ``"precomputed"`` (``x`` is then the
    train Gram)."""

    x: torch.Tensor  # (n, d) features
    y: torch.Tensor  # (n,) or (n, t) targets (t one-vs-all heads)
    kernel: str | tuple[str, ...] = "rbf"
    sigma: float | tuple[float, ...] = 1.0
    lam_unscaled: float = 1e-6
    weights: tuple[float, ...] | None = None  # multi-kernel combination weights
    precision: str = "f32"  # kernel tile-compute policy: "f32" | "bf16"

    def __post_init__(self) -> None:
        if isinstance(self.kernel, list):
            object.__setattr__(self, "kernel", tuple(self.kernel))
        if isinstance(self.sigma, list):
            object.__setattr__(self, "sigma", tuple(self.sigma))
        if self.weights is not None:
            object.__setattr__(self, "weights", tuple(float(w) for w in self.weights))
        if self.kernel == "precomputed":
            object.__setattr__(self, "x", widen_gram(self.x))

    @property
    def n(self) -> int:
        """Number of training points."""
        return self.x.shape[0]

    @property
    def t(self) -> int:
        """Number of right-hand sides (1 for a scalar-target problem)."""
        return 1 if self.y.ndim == 1 else self.y.shape[1]

    @property
    def lam(self) -> float:
        """The scaled regularization n * lam_unscaled."""
        return scaled_lam(self.n, self.lam_unscaled)

    @property
    def device(self) -> torch.device:
        """Where the problem's tensors (and so its kernel sweeps) live."""
        return self.x.device

    @property
    def op(self):
        """The kernel operator owning the (kernel, sigma, precision) plumbing."""
        from repro_torch.core.multikernel import make_operator

        return make_operator(
            self.x, kernel=self.kernel, sigma=self.sigma, weights=self.weights,
            precision=self.precision,
        )

    def residual_report(self, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(aggregate, per-head) relative residuals from ONE streamed matvec."""
        return residual_report(self.op, self.y, self.lam, w)

    def predict(self, w: torch.Tensor, x_test: torch.Tensor) -> torch.Tensor:
        """f(x) = K(x_test, X_train) @ w; w (n,) -> (m,), w (n, t) -> (m, t)."""
        return self.op.row_block_matvec(x_test, w)


class Metrics(NamedTuple):
    rmse: torch.Tensor
    mae: torch.Tensor
    accuracy: torch.Tensor  # sign agreement (±1 tasks) / top-1 over one-vs-all heads


def evaluate(y_pred: torch.Tensor, y_true: torch.Tensor) -> Metrics:
    """RMSE/MAE over all entries; accuracy is sign agreement for scalar or
    single-head targets and argmax (top-1 one-vs-all decoding) when t > 1."""
    err = y_pred - y_true
    rmse = torch.sqrt(torch.mean(err**2))
    mae = torch.mean(err.abs())
    if y_pred.ndim == 2 and y_pred.shape[1] > 1:
        acc = (y_pred.argmax(1) == y_true.argmax(1)).float().mean()
    else:
        acc = (torch.sign(y_pred) == torch.sign(y_true)).float().mean()
    return Metrics(rmse=rmse, mae=mae, accuracy=acc)


def evaluate_per_head(y_pred: torch.Tensor, y_true: torch.Tensor) -> Metrics:
    """Per-head metrics — each field is (t,); accuracy is per-head sign
    agreement."""
    p2, _ = as_multirhs(y_pred)
    t2, _ = as_multirhs(y_true)
    err = p2 - t2
    return Metrics(
        rmse=torch.sqrt(torch.mean(err**2, dim=0)),
        mae=torch.mean(err.abs(), dim=0),
        accuracy=(torch.sign(p2) == torch.sign(t2)).float().mean(dim=0),
    )
