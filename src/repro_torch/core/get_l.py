"""Automatic stepsize: preconditioned smoothness constant via randomized
powering (paper Algorithm 5, §2.3, App. A.2) — the port of
``repro.core.get_l``.

Estimates L_PB = lambda_1((K_hat+rho I)^{-1/2} (K_BB + lam I) (K_hat+rho I)^{-1/2})
with matvecs only.  The estimate stays on the device (no host sync).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.nystrom import NystromFactors, woodbury_invsqrt_apply


def get_l(
    generator: torch.Generator | None,
    kbb_lam_matvec: Callable[[torch.Tensor], torch.Tensor],
    factors: NystromFactors,
    rho,
    num_iters: int = 10,
    num_probes: int = 1,
    *,
    probe: torch.Tensor | None = None,
) -> torch.Tensor:
    """Algorithm 5: randomized (block) powering; returns L_PB (0-d tensor).

    ``probe`` is the raw (p, q) Gaussian probe block before its QR; it is
    drawn from ``generator`` when not given (a test injects the reference's
    draw).  num_probes > 1 runs subspace iteration.
    """
    p = factors.u.shape[0]
    q = max(1, min(num_probes, p))
    if probe is None:
        probe = torch.randn((p, q), generator=generator, dtype=factors.u.dtype,
                            device=factors.u.device)
    v, _ = torch.linalg.qr(probe)
    lam_est = torch.ones((), dtype=v.dtype, device=v.device)
    for _ in range(num_iters):
        u = woodbury_invsqrt_apply(factors, rho, v)
        u = kbb_lam_matvec(u)
        u = woodbury_invsqrt_apply(factors, rho, u)
        # Rayleigh quotients against the orthonormal probe columns
        lam_est = (v * u).sum(0).max()
        v, _ = torch.linalg.qr(u)
    return lam_est


def get_l_dense(
    generator: torch.Generator | None,
    kbb: torch.Tensor,
    lam,
    factors: NystromFactors,
    rho,
    num_iters: int = 10,
    num_probes: int = 1,
    *,
    probe: torch.Tensor | None = None,
) -> torch.Tensor:
    """Convenience wrapper for a materialized block."""

    def mv(v):
        return kbb @ v + lam * v

    return get_l(generator, mv, factors, rho, num_iters=num_iters,
                 num_probes=num_probes, probe=probe)
