"""Preconditioned conjugate gradient for full KRR (baseline, paper §4.1/§6)
— the port of ``repro.core.pcg``.

Preconditioners:
  * "nystrom"    — rank-r Gaussian Nystrom of the full K (Frangella et al.
                   2023), its sketch one (n, n) x (n, r) kernel matvec;
                   the paper's "damped"/"regularization" rho modes.
  * "rpcholesky" — rank-r randomly pivoted Cholesky factor (Diaz et al. 2023).
  * "rff"        — rank-r random-Fourier-feature factors (``core/rff.py``),
                   with no kernel sweep at all.
  * "identity"   — plain CG.

The iteration is blocked CG over (n, t) right-hand sides: each column
carries its own alpha/beta/residual and freezes at ``tol``, and every
iteration is one streamed K matvec shared by all t columns.  A 1-D y is the
t = 1 special case.

Each randomized factor takes its draw from a ``torch.Generator`` on the
problem's device seeded with ``seed``, or injected: ``omega=`` (nystrom),
``pivots=`` (rpcholesky), ``freqs=`` / ``phases=`` (rff).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.core.blocked_cg import blocked_cg
from repro_torch.core.krr import KRRProblem
from repro_torch.core.nystrom import NystromFactors, nystrom_from_sketch
from repro_torch.core.operator import as_multirhs, maybe_squeeze
from repro_torch.core.rpcholesky import rp_cholesky
from repro_torch.device import synchronize
from repro_torch.obs.metrics import record_tile_work
from repro_torch.obs.telemetry import as_telemetry


@dataclasses.dataclass
class PCGResult:
    w: torch.Tensor
    iters: int
    history: list[dict]
    converged: bool
    wall_time_s: float


def _generator(problem: KRRProblem, seed: int) -> torch.Generator:
    return torch.Generator(device=problem.device).manual_seed(seed)


def _nystrom_full(problem: KRRProblem, rank: int, generator: torch.Generator | None, *,
                  omega: torch.Tensor | None = None) -> NystromFactors:
    """Nystrom factors of the full K from one sketch ``K @ Omega``; ``omega``
    is the raw (n, rank) Gaussian test matrix (drawn when not given)."""
    op = problem.op
    if omega is None:
        omega = torch.randn((op.n, rank), generator=generator, dtype=torch.float32,
                            device=problem.device)
    omega, _ = torch.linalg.qr(omega)
    sketch = op.sketch(omega)
    return nystrom_from_sketch(sketch, omega, op.trace_est())


def _rff_full(problem: KRRProblem, rank: int, generator: torch.Generator | None, *,
              freqs: torch.Tensor | None = None,
              phases: torch.Tensor | None = None) -> NystromFactors:
    from repro_torch.core.rff import RFF_KERNELS, rff_factors

    if problem.kernel not in RFF_KERNELS:
        raise ValueError(
            'kind="rff" preconditioning needs a shift-invariant kernel with '
            f"an implemented spectral measure ({RFF_KERNELS}); got "
            f"kernel={problem.kernel!r} — use kind=\"nystrom\""
        )
    return rff_factors(generator, problem.x, rank, float(problem.sigma),
                       kernel=problem.kernel, freqs=freqs, phases=phases)


def make_preconditioner(
    problem: KRRProblem,
    kind: str = "nystrom",
    rank: int = 100,
    rho_mode: str = "damped",
    seed: int = 0,
    *,
    omega: torch.Tensor | None = None,
    pivots: torch.Tensor | None = None,
    freqs: torch.Tensor | None = None,
    phases: torch.Tensor | None = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Returns the P^{-1} apply over a (n, t) residual block.  For
    Nystrom-type preconditioners:
    P^{-1} V = U diag((lam_r + rho)/(lam_j + rho)) U^T V + (V - U U^T V)."""
    lam = float(problem.lam)
    if kind == "identity":
        return lambda v: v
    if kind == "nystrom":
        f = _nystrom_full(problem, rank, _generator(problem, seed), omega=omega)
    elif kind == "rff":
        f = _rff_full(problem, rank, _generator(problem, seed), freqs=freqs, phases=phases)
    elif kind == "rpcholesky":
        fmat, _ = rp_cholesky(_generator(problem, seed), problem.op, rank, pivots=pivots)
        u, s, _ = torch.linalg.svd(fmat, full_matrices=False)
        f = NystromFactors(u=u, lam=s * s)
    else:
        raise ValueError(f"unknown preconditioner {kind!r}")

    rho = lam + f.lam[-1] if rho_mode == "damped" else lam
    coeff = (f.lam[-1] + rho) / (f.lam + rho)

    def apply(v: torch.Tensor) -> torch.Tensor:
        utv = f.u.T @ v
        scaled = utv * (coeff[:, None] if v.ndim == 2 else coeff)
        return f.u @ scaled + (v - f.u @ utv)

    return apply


def solve_pcg(
    problem: KRRProblem,
    *,
    precond: str = "nystrom",
    rank: int = 100,
    rho_mode: str = "damped",
    max_iters: int = 200,
    tol: float = 1e-8,
    seed: int = 0,
    time_budget_s: float | None = None,
    w0: torch.Tensor | None = None,
    telemetry=None,
    omega: torch.Tensor | None = None,
    pivots: torch.Tensor | None = None,
    freqs: torch.Tensor | None = None,
    phases: torch.Tensor | None = None,
) -> PCGResult:
    """Blocked PCG on (K + lam I) W = Y with per-column residual tracking.

    History records carry ``rel_residual`` (aggregate ||R||_F / ||Y||_F) and
    ``rel_residual_per_head``; convergence requires every column below tol.
    ``w0`` warm-starts the iteration at the cost of one extra matvec.
    ``omega`` / ``pivots`` / ``freqs`` / ``phases`` inject the
    preconditioner's draws.  ``telemetry`` adds a solve span, canonical
    per-iteration trace events, and tile-work metrics.
    """
    tel = as_telemetry(telemetry)
    n, d = problem.n, problem.x.shape[1]
    precision = problem.precision
    recorder = tel.recorder("pcg", precision=precision, n=n)
    with tel.span("solve/pcg", n=n, t=problem.t, precond=precond, rank=rank,
                  max_iters=max_iters, tol=tol):
        t0 = time.perf_counter()
        pinv = make_preconditioner(problem, precond, rank, rho_mode, seed, omega=omega,
                                   pivots=pivots, freqs=freqs, phases=phases)
        op, lam = problem.op, problem.lam
        y, squeeze = as_multirhs(problem.y)
        x0 = None if w0 is None else as_multirhs(torch.as_tensor(w0, device=problem.device))[0]
        res = blocked_cg(
            lambda v: op.k_lam_matvec(v, lam), y, pinv, x0=x0, max_iters=max_iters, tol=tol,
            t0=t0, time_budget_s=time_budget_s, recorder=recorder,
        )
        if tel.enabled:
            # each CG iteration streams one full (n, n) K matvec; the warm
            # start costs one extra for the initial residual
            record_tile_work(n, n, d, precision,
                             count=res.iters + (1 if x0 is not None else 0))
            synchronize(problem.device)  # the last update is never read
    return PCGResult(
        w=maybe_squeeze(res.x, squeeze), iters=res.iters, history=res.history,
        converged=res.converged, wall_time_s=time.perf_counter() - t0,
    )
