"""Coordinate-block sampling distributions (paper §2.4, §3.1, Def. 9) — the
port of ``repro.core.samplers``.

  * uniform  — the recommended default (§3.2).
  * ARLS     — approximate ridge-leverage-score sampling with BLESS-style
               multi-round scores (Rudi et al. 2018).

Samplers are closures ``generator -> idx (b,)`` drawing distinct indices on
the generator's device.  Torch's streams differ from JAX's for the same
seed; tests inject the reference's draws instead of matching seeds.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.core.nystrom import cholesky_or_nan
from repro_torch.core.operator import KernelOperator
from repro_torch.device import resolve_device

Sampler = Callable[[torch.Generator], torch.Tensor]


def uniform_sampler(n: int, b: int, device: torch.device | str = "cuda") -> Sampler:
    """b distinct indices uniformly at random, drawn on ``device`` (the card
    unless the caller asks for the CPU)."""
    device = resolve_device(device)

    def sample(generator: torch.Generator) -> torch.Tensor:
        return torch.randperm(n, generator=generator, device=device)[:b]

    return sample


def arls_sampler(probs: torch.Tensor, b: int) -> Sampler:
    """ARLS_c sampling (Def. 9) by rounded leverage scores, without
    replacement (the paper discards duplicates)."""

    def sample(generator: torch.Generator) -> torch.Tensor:
        return torch.multinomial(probs, b, replacement=False, generator=generator)

    return sample


def arls_probs(scores: torch.Tensor) -> torch.Tensor:
    """Def. 9 rounding: p_i ∝ (l/n) * ceil(n * l_i / l), l = sum l_i."""
    total = scores.sum()
    p = torch.ceil(scores * scores.shape[0] / torch.clamp_min(total, 1e-30))
    return p / p.sum()


def approx_rls_bless(
    generator: torch.Generator,
    op: KernelOperator,
    *,
    lam: float,
    k_cap: int | None = None,
    rounds: int = 4,
) -> torch.Tensor:
    """BLESS-style approximate ridge leverage scores for all n points.

    Round h uses lam_h = lam_0 * (lam / lam_0)^(h / (rounds - 1)) with
    lam_0 = n, and a dictionary of k_cap = O(sqrt(n)) points resampled by
    the previous round's scores:
        l_i(lam_h) ≈ (K_ii - k_iS (K_SS + s lam_h diag(q_S))^{-1} k_Si) / lam_h
    clipped to [1e-12, 1].  Kernel access goes through ``op.block`` only.
    """
    n = op.n
    if k_cap is None:
        k_cap = max(16, int(math.sqrt(n)))
    k_cap = min(k_cap, n)
    dev = op.x.device
    lam0 = float(n)
    ratio = (float(lam) / lam0) ** (1.0 / max(rounds - 1, 1))

    scores = torch.ones((n,), dtype=torch.float32, device=dev)
    for h in range(rounds):
        lam_h = lam0 * ratio**h if rounds > 1 else float(lam)
        q = scores / scores.sum()
        idx = torch.multinomial(q, k_cap, replacement=False, generator=generator)
        xs = op.x.index_select(0, idx)
        q_s = q[idx] * k_cap
        k_ss = op.block(xs)
        reg = lam_h * torch.diag(torch.clamp_min(q_s, 1e-12))
        eye = torch.eye(k_cap, dtype=k_ss.dtype, device=dev)
        chol = cholesky_or_nan(k_ss + reg + 1e-6 * eye)
        k_ns = op.block(op.x, xs)
        sol = torch.cholesky_solve(k_ns.T, chol)  # (s, n)
        quad = (k_ns.T * sol).sum(0)
        scores = torch.clamp((1.0 - quad) / lam_h, 1e-12, 1.0)
    return scores
