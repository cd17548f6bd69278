"""Skotch (Algorithm 2) — the non-accelerated variant of ASkotch.

Thin wrapper: Skotch is exactly the ASkotch machinery with the Nesterov
mixing disabled (see ``repro_torch.core.askotch`` for the shared step).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.askotch import ASkotchConfig, SolveResult, solve
from repro_torch.core.krr import KRRProblem


def skotch_config(**kwargs) -> ASkotchConfig:
    """An :class:`ASkotchConfig` with ``accelerated=False``."""
    return dataclasses.replace(ASkotchConfig(**kwargs), accelerated=False)


def solve_skotch(problem: KRRProblem, cfg: ASkotchConfig | None = None, **kw) -> SolveResult:
    """Run Skotch: :func:`~repro_torch.core.askotch.solve` without acceleration."""
    cfg = dataclasses.replace(cfg or ASkotchConfig(), accelerated=False)
    return solve(problem, cfg, **kw)
