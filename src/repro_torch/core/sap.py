"""Exact sketch-and-project methods (paper §2.1): randomized Kaczmarz,
randomized coordinate descent, randomized (block) Newton, and NSAP
(Algorithm 1, Nesterov-accelerated SAP) — the port of ``repro.core.sap``.

These use exact block solves ((K_BB + lam I)^{-1}, O(b^3)) and exist as
(a) theory-faithful references for tests — Skotch/ASkotch must track their
behaviour while being much cheaper per iteration — and (b) the SAP ablation
arm.  Small/medium n only: the b x b block is materialized
(``op.block_idx``, ``kernel_block``) and solved densely
(``torch.linalg.solve``, as the reference does), the block residual streams
through ``op.row_block_matvec`` (``kernel_matvec``), and a single-row step
builds its (1, n) row with ``op.block`` (``kernel_block``).

Every step draws from ``state.generator`` (a ``torch.Generator`` on the
problem's device) unless its draw is injected: ``idx=`` (b distinct block
indices) for the block steps, ``j=`` (one row) for the single-row steps.
Torch's streams differ from JAX's, so tests inject the reference's draws.
No step reads a device value on the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import samplers
from repro_torch.core.krr import KRRProblem


class SAPState(NamedTuple):
    w: torch.Tensor
    v: torch.Tensor
    z: torch.Tensor
    generator: torch.Generator  # draws of every step; advanced in place


def _f32_lam(problem: KRRProblem) -> float:
    return float(torch.tensor(problem.lam, dtype=torch.float32))  # the f32 value JAX uses


def _block_residual(problem: KRRProblem, idx: torch.Tensor, w: torch.Tensor, lam: float
                    ) -> torch.Tensor:
    """(K_lam)_{B,:} w - y_B via the fused streaming op (w: (n,) or (n, t))."""
    xb = problem.x.index_select(0, idx)
    return (
        problem.op.row_block_matvec(xb, w)
        + lam * w.index_select(0, idx)
        - problem.y.index_select(0, idx)
    )


def _block_solve(problem: KRRProblem, idx: torch.Tensor, g: torch.Tensor, lam: float
                 ) -> torch.Tensor:
    """(K_BB + lam I)^{-1} g by a dense solve of the materialized block."""
    kbb = problem.op.block_idx(idx)
    kbb.diagonal().add_(lam)
    return torch.linalg.solve(kbb, g)


def _as_index(i, device) -> torch.Tensor:
    """An injected draw (int, sequence, numpy array or tensor) as int64
    indices on ``device``."""
    if not isinstance(i, torch.Tensor):
        i = torch.from_numpy(np.array(i, dtype=np.int64))
    return i.to(device=device, dtype=torch.int64).reshape(-1)


def make_randomized_newton_step(problem: KRRProblem, b: int):
    """Example 3 / Eq. (8): exact block projection with Q = K_lam.

    ``step(state, *, idx=None)``: ``idx`` injects the (b,) block indices."""
    lam = _f32_lam(problem)
    sampler = samplers.uniform_sampler(problem.n, b, problem.device)

    def step(state: SAPState, *, idx=None) -> SAPState:
        idx = sampler(state.generator) if idx is None else _as_index(idx, problem.device)
        d = _block_solve(problem, idx, _block_residual(problem, idx, state.w, lam), lam)
        w = state.w.index_add(0, idx, -d)
        return SAPState(w=w, v=w, z=w, generator=state.generator)

    return step


def make_nsap_step(problem: KRRProblem, b: int, mu: float, nu: float):
    """Algorithm 1 (NSAP) with block (randomized Newton) sketches.

    ``step(state, *, idx=None)``: ``idx`` injects the (b,) block indices."""
    lam = _f32_lam(problem)
    beta = 1.0 - math.sqrt(mu / nu)
    gamma = 1.0 / math.sqrt(mu * nu)
    alpha = 1.0 / (1.0 + gamma * nu)
    sampler = samplers.uniform_sampler(problem.n, b, problem.device)

    def step(state: SAPState, *, idx=None) -> SAPState:
        idx = sampler(state.generator) if idx is None else _as_index(idx, problem.device)
        d = _block_solve(problem, idx, _block_residual(problem, idx, state.z, lam), lam)
        w = state.z.index_add(0, idx, -d)
        v = (beta * state.v + (1.0 - beta) * state.z).index_add(0, idx, -gamma * d)
        z = alpha * v + (1.0 - alpha) * w
        return SAPState(w=w, v=v, z=z, generator=state.generator)

    return step


def _draw_row(problem: KRRProblem, state: SAPState, j) -> torch.Tensor:
    """The (1,) row index: drawn uniformly from ``state.generator`` or
    injected."""
    if j is None:
        return torch.randint(0, problem.n, (1,), generator=state.generator,
                             device=problem.device)
    return _as_index(j, problem.device)


def _klam_row(problem: KRRProblem, j: torch.Tensor, lam: float) -> torch.Tensor:
    """Row j of K + lam I, (n,), from one (1, n) ``kernel_block``."""
    xj = problem.x.index_select(0, j)
    row = problem.op.block(xj, problem.x)[0]
    return row.index_add(0, j, torch.full((1,), lam, dtype=row.dtype, device=row.device))


def make_kaczmarz_step(problem: KRRProblem):
    """Example 1: Q = I, single-row sketches.

    ``step(state, *, j=None)``: ``j`` injects the row index."""
    lam = _f32_lam(problem)

    def step(state: SAPState, *, j=None) -> SAPState:
        j = _draw_row(problem, state, j)
        row = _klam_row(problem, j, lam)
        resid = row @ state.w - problem.y.index_select(0, j)[0]  # scalar or (t,)
        coef = resid / torch.sum(row * row)
        upd = torch.outer(row, coef) if state.w.ndim == 2 else coef * row
        w = state.w - upd
        return SAPState(w=w, v=w, z=w, generator=state.generator)

    return step


def make_cd_step(problem: KRRProblem):
    """Example 2: Q = K_lam, single-coordinate sketches.

    ``step(state, *, j=None)``: ``j`` injects the coordinate."""
    lam = _f32_lam(problem)

    def step(state: SAPState, *, j=None) -> SAPState:
        j = _draw_row(problem, state, j)
        row = _klam_row(problem, j, lam)
        resid = row @ state.w - problem.y.index_select(0, j)[0]
        upd = -resid / row.index_select(0, j)[0]  # scalar or (t,)
        w = state.w.index_add(0, j, upd.reshape((1,) + state.w.shape[1:]))
        return SAPState(w=w, v=w, z=w, generator=state.generator)

    return step


def init_state(problem: KRRProblem, seed: int = 0) -> SAPState:
    """Zero iterate (f32) on the problem's device and a generator there
    seeded from ``seed``."""
    w0 = torch.zeros(problem.y.shape, dtype=torch.float32, device=problem.device)
    return SAPState(w=w0, v=w0, z=w0,
                    generator=torch.Generator(device=problem.device).manual_seed(seed))


def run(problem: KRRProblem, step, num_iters: int, seed: int = 0) -> torch.Tensor:
    """``num_iters`` steps from zero; returns w."""
    state = init_state(problem, seed)
    for _ in range(num_iters):
        state = step(state)
    return state.w
