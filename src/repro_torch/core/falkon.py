"""Falkon (Rudi et al. 2017; Meanti et al. 2020): the inducing-points KRR
baseline — the port of ``repro.core.falkon``.

Solves (K_nm^T K_nm + lam K_mm) W = K_nm^T Y with m uniformly sampled
centers, by blocked CG in the Falkon-preconditioned variable
W = L^{-T} R^{-T} beta where

  L = chol(K_mm),   R = chol((1/m) L^T L + lam I).

Every K_nm product is a streamed kernel matvec (O(n m d) a CG iteration,
O(m^2) memory for K_mm).  A (n, t) Y runs one CG over t columns.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core.blocked_cg import blocked_cg
from repro_torch.core.krr import KRRProblem
from repro_torch.core.nystrom import cholesky_or_nan
from repro_torch.core.operator import as_multirhs, maybe_squeeze
from repro_torch.device import synchronize
from repro_torch.obs.metrics import record_tile_work
from repro_torch.obs.telemetry import as_telemetry


@dataclasses.dataclass
class FalkonResult:
    w: torch.Tensor  # (m,) or (m, t) inducing-point weights
    centers_idx: torch.Tensor  # (m,) indices into the training set
    iters: int
    history: list[dict]
    wall_time_s: float


def _tri(a: torch.Tensor, b: torch.Tensor, *, upper: bool) -> torch.Tensor:
    return torch.linalg.solve_triangular(a, b, upper=upper)


def solve_falkon(
    problem: KRRProblem,
    m: int,
    *,
    max_iters: int = 100,
    tol: float = 1e-10,
    seed: int = 0,
    jitter: float = 1e-7,
    time_budget_s: float | None = None,
    telemetry=None,
    centers_idx: torch.Tensor | None = None,
) -> FalkonResult:
    """Falkon solve with ``m`` uniformly sampled centers (the first m of
    ``torch.randperm(n)`` from a generator seeded with ``seed``, or the
    injected ``centers_idx``).  ``telemetry`` adds a span + canonical
    trace events + tile-work metrics."""
    tel = as_telemetry(telemetry)
    t0 = time.perf_counter()
    n, dev = problem.n, problem.device
    if centers_idx is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        centers_idx = torch.randperm(n, generator=gen, device=dev)[:m]
    centers_idx = centers_idx.to(device=dev, dtype=torch.int64)
    op = problem.op
    op_m = op.restrict(centers_idx)  # operator over the center rows
    lam = float(problem.lam)

    kmm = op_m.block(op_m.x)
    kmm.diagonal().add_(jitter * m)
    l = cholesky_or_nan(kmm)
    del kmm
    inner = (l.T @ l) / m
    inner.diagonal().add_(lam)
    r = cholesky_or_nan(inner)
    del inner

    def knm_t_knm(v: torch.Tensor) -> torch.Tensor:
        """K_nm^T (K_nm v) streamed over n; v (m, t)."""
        tmp = op_m.row_block_matvec(op.x, v)  # K(x, xm) @ v
        return op.row_block_matvec(op_m.x, tmp)  # K(xm, x) @ tmp

    def from_beta(beta: torch.Tensor) -> torch.Tensor:
        return _tri(l.T, _tri(r.T, beta, upper=True), upper=True)

    def to_precond(v: torch.Tensor) -> torch.Tensor:
        return _tri(r, _tri(l, v, upper=False), upper=False)

    def operator(beta: torch.Tensor) -> torch.Tensor:
        wv = from_beta(beta)
        return to_precond(knm_t_knm(wv)) + lam * _tri(r, _tri(r.T, beta, upper=True),
                                                      upper=False)

    y, squeeze = as_multirhs(problem.y)
    rhs = to_precond(op.row_block_matvec(op_m.x, y))  # (m, t)
    # plain blocked CG on the Falkon-preconditioned operator (pinv = None)
    with tel.span("solve/falkon", n=n, m=m, t=problem.t, max_iters=max_iters,
                  tol=tol):
        res = blocked_cg(operator, rhs, max_iters=max_iters, tol=tol, t0=t0,
                         time_budget_s=time_budget_s,
                         recorder=tel.recorder("falkon", n=n))
        if tel.enabled:
            # each CG iteration streams K_nm and K_mn (plus one K_mn for the
            # RHS setup and the m^2 block build)
            d = problem.x.shape[1]
            record_tile_work(n, m, d, count=res.iters)
            record_tile_work(m, n, d, count=res.iters + 1)
            record_tile_work(m, m, d)
            synchronize(dev)  # the last update is never read
    return FalkonResult(
        w=maybe_squeeze(from_beta(res.x), squeeze),
        centers_idx=centers_idx,
        iters=res.iters,
        history=res.history,
        wall_time_s=time.perf_counter() - t0,
    )


def falkon_predict(problem: KRRProblem, result: FalkonResult, x_test: torch.Tensor) -> torch.Tensor:
    """Predictions K(x_test, X_m) @ w at the result's centers."""
    op_m = problem.op.restrict(result.centers_idx)
    return op_m.row_block_matvec(x_test, result.w)
