"""Skotch (Algorithm 2) and ASkotch (Algorithm 3): approximate sketch-and-
project solvers for full KRR — the port of ``repro.core.askotch``.

Per iteration (blocksize b, Nystrom rank r, n training points, t heads):
  1. sample block B                          — uniform or ARLS
  2. K_BB                                    — kernel_block, O(b^2 d)
  3. K_hat_BB = Nystrom(K_BB, r)             — Algorithm 4, O(b^2 r)
  4. rho = lam + lam_r(K_hat_BB) ("damped")
  5. L_PB via randomized powering            — Algorithm 5
  6. G_B = (K_lam)_{B,:} Z - Y_B             — kernel_matvec, O(n b d)  << hot spot
  7. D_B = (K_hat_BB + rho I)^{-1} G_B       — Woodbury, O(b r t)
  8. iterate updates (+ Nesterov mixing for ASkotch), O(n t)

Steps 1-5 are shared across the t heads.  The step runs eagerly and never
reads a device value on the host; :func:`solve` syncs only at eval points,
:func:`solve_scan` not at all.
The dense products K_BB @ omega and K_BB @ u stay ``torch.matmul`` in f32
(TF32 off), as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, NamedTuple

import torch

from repro_torch.core import samplers
from repro_torch.core.get_l import get_l
from repro_torch.core.krr import KRRProblem
from repro_torch.core.nystrom import (
    NystromFactors,
    nystrom_from_sketch,
    stable_inv_apply,
    stable_inv_apply_setup,
    woodbury_inv_apply,
)
from repro_torch.device import synchronize
from repro_torch.obs.metrics import record_tile_work
from repro_torch.obs.telemetry import as_telemetry


@dataclasses.dataclass(frozen=True)
class ASkotchConfig:
    """Hyperparameters; defaults are the paper's recommended settings."""

    block_size: int | None = None  # default n // 100 (>= rank + 8)
    rank: int = 100
    rho_mode: str = "damped"  # "damped" (lam + lam_r) | "regularization" (lam)
    sampling: str = "uniform"  # "uniform" | "arls"
    precond: str = "nystrom"  # "nystrom" | "identity" (Lin et al. ablation)
    accelerated: bool = True  # ASkotch; False -> Skotch
    mu: float | None = None  # default: lam (clipped)
    nu: float | None = None  # default: n / b
    stable_inv: bool = True  # f32-stable Cholesky Woodbury (App. A.1.1)
    powering_iters: int = 10

    def resolve_block(self, n: int) -> int:
        """The block size b for n points: n // 100 by default, at least
        rank + 8, at most n."""
        b = self.block_size if self.block_size is not None else max(n // 100, 1)
        return int(min(max(b, self.rank + 8), n))


class SolverState(NamedTuple):
    w: torch.Tensor  # (n,) or (n, t) primal iterate
    v: torch.Tensor  # acceleration sequence (= w when not accelerated)
    z: torch.Tensor  # acceleration sequence (= w when not accelerated)
    generator: torch.Generator  # draws of every step; advanced in place
    it: int  # iteration counter
    sketch_res: torch.Tensor  # ||G_B|| per head ((t,) or scalar)


class StepAux(NamedTuple):
    step_l: torch.Tensor  # L_PB estimate
    rho: torch.Tensor


def _accel_params(mu: float, nu: float) -> tuple[float, float, float]:
    """beta, gamma, alpha from (mu_hat, nu_hat) — Algorithm 3 preamble."""
    beta = 1.0 - math.sqrt(mu / nu)
    gamma = 1.0 / math.sqrt(mu * nu)
    alpha = 1.0 / (1.0 + gamma * nu)
    return beta, gamma, alpha


def resolve_accel_params(cfg: ASkotchConfig, n: int, lam: float) -> tuple[float, float]:
    """mu_hat = lam, nu_hat = n/b, with mu clipped so mu <= nu and mu nu <= 1."""
    b = cfg.resolve_block(n)
    nu = cfg.nu if cfg.nu is not None else n / b
    mu = cfg.mu if cfg.mu is not None else lam
    mu = min(mu, nu, 1.0 / nu)
    return mu, nu


def make_step(
    problem: KRRProblem, cfg: ASkotchConfig, probs: torch.Tensor | None = None
) -> Callable[..., tuple[SolverState, StepAux]]:
    """Build the Skotch/ASkotch step for a fixed problem.

    ``step(state, *, idx=None, omega=None, probe=None)``: the block indices
    (b,), the raw Gaussian Nystrom test matrix (b, r) and the raw
    power-iteration probe (b, 1) may be injected; each one not given is
    drawn, in that order, from ``state.generator``.
    """
    n = problem.n
    b = cfg.resolve_block(n)
    r = min(cfg.rank, b - 1)
    lam = float(torch.tensor(problem.lam, dtype=torch.float32))  # the f32 value JAX uses
    op = problem.op
    dev = problem.device

    if cfg.sampling == "arls":
        if probs is None:
            raise ValueError("ARLS sampling requires precomputed probs")
        sampler = samplers.arls_sampler(probs, b)
    elif cfg.sampling == "uniform":
        sampler = samplers.uniform_sampler(n, b, dev)
    else:
        raise ValueError(f"unknown sampling {cfg.sampling!r}")

    if cfg.accelerated:
        mu, nu = resolve_accel_params(cfg, n, lam)
        beta, gamma, alpha = _accel_params(mu, nu)

    x, y = problem.x, problem.y

    def step(state: SolverState, *, idx=None, omega=None, probe=None):
        g = state.generator
        if idx is None:
            idx = sampler(g)
        xb = x.index_select(0, idx)
        yb = y.index_select(0, idx)
        zref = state.z if cfg.accelerated else state.w
        zb = zref.index_select(0, idx)

        # -- block build + Nystrom preconditioner (shared across heads) -----
        kbb = op.block(xb)
        if omega is None:
            omega = torch.randn((b, r), generator=g, dtype=kbb.dtype, device=dev)
        omega, _ = torch.linalg.qr(omega)
        factors = nystrom_from_sketch(kbb @ omega, omega, torch.trace(kbb))

        if cfg.rho_mode == "damped":
            rho = lam + factors.lam[-1]
        else:
            rho = torch.tensor(lam, dtype=kbb.dtype, device=dev)

        def kbb_lam_mv(u):
            return kbb @ u + lam * u

        if cfg.precond == "identity":
            # ablation: K_hat = 0, rho = 1 -> sketched-gradient step
            factors_id = NystromFactors(
                u=torch.zeros((b, 1), dtype=kbb.dtype, device=dev),
                lam=torch.zeros((1,), dtype=kbb.dtype, device=dev),
            )
            one = torch.ones((), dtype=kbb.dtype, device=dev)
            step_l = get_l(g, kbb_lam_mv, factors_id, one,
                           num_iters=cfg.powering_iters, probe=probe)
            solve_g = lambda gb: gb  # noqa: E731
        else:
            step_l = get_l(g, kbb_lam_mv, factors, rho,
                           num_iters=cfg.powering_iters, probe=probe)
            if cfg.stable_inv:
                chol_l = stable_inv_apply_setup(factors, rho)
                solve_g = lambda gb: stable_inv_apply(factors, rho, chol_l, gb)  # noqa: E731
            else:
                solve_g = lambda gb: woodbury_inv_apply(factors, rho, gb)  # noqa: E731

        eta = 1.0 / torch.clamp_min(step_l, 1.0)  # eta = 1 / hat-L_PB (Lemma 8)

        # -- fused O(nbt) kernel matvec: G_B = (K_lam)_{B,:} Z - Y_B --------
        gb = op.row_block_matvec(xb, zref) + lam * zb - yb
        db = solve_g(gb)

        # -- iterate updates: new tensors built from the OLD z and v (the
        # indices are distinct, so index_add_ equals JAX's .at[idx].add) ----
        if cfg.accelerated:
            w_new = state.z.clone().index_add_(0, idx, -eta * db)
            v_new = (beta * state.v + (1.0 - beta) * state.z).index_add_(
                0, idx, -gamma * eta * db
            )
            z_new = alpha * v_new + (1.0 - alpha) * w_new
        else:
            w_new = state.w.clone().index_add_(0, idx, -eta * db)
            v_new = z_new = w_new

        sketch_res = (torch.linalg.vector_norm(gb) if gb.ndim == 1
                      else torch.linalg.vector_norm(gb, dim=0))
        new_state = SolverState(w=w_new, v=v_new, z=z_new, generator=g,
                                it=state.it + 1, sketch_res=sketch_res)
        return new_state, StepAux(step_l=step_l, rho=rho)

    return step


def init_state(problem: KRRProblem, seed: int = 0, w0: torch.Tensor | None = None) -> SolverState:
    """Zero-initialized state on the problem's device, with a
    ``torch.Generator`` there seeded from ``seed``."""
    dev = problem.device
    if w0 is None:
        w0 = torch.zeros(problem.y.shape, dtype=torch.float32, device=dev)
    res0 = torch.full(() if problem.y.ndim == 1 else (problem.t,), float("inf"),
                      dtype=torch.float32, device=dev)
    return SolverState(
        w=w0, v=w0, z=w0,
        generator=torch.Generator(device=dev).manual_seed(seed),
        it=0, sketch_res=res0,
    )


@dataclasses.dataclass
class SolveResult:
    w: torch.Tensor
    iters: int
    history: list[dict]
    converged: bool
    wall_time_s: float


def _maybe_arls_probs(problem: KRRProblem, cfg: ASkotchConfig, seed: int):
    if cfg.sampling != "arls":
        return None
    gen = torch.Generator(device=problem.device).manual_seed(seed + 1)
    scores = samplers.approx_rls_bless(gen, problem.op, lam=problem.lam)
    return samplers.arls_probs(scores)


def solve(
    problem: KRRProblem,
    cfg: ASkotchConfig | None = None,
    *,
    max_iters: int = 500,
    tol: float = 1e-8,
    eval_every: int = 25,
    seed: int = 0,
    time_budget_s: float | None = None,
    callback: Callable[[int, SolverState, dict], None] | None = None,
    w0: torch.Tensor | None = None,
    telemetry=None,
) -> SolveResult:
    """Python-loop driver: eager steps + periodic full-residual evaluation.

    The full relative residual costs one O(n^2 d) streamed matvec, so it is
    computed every ``eval_every`` iterations (and at the end); only there
    does the host read device values.  History records carry
    ``rel_residual`` (aggregate) and ``rel_residual_per_head``; the solve
    converges when every head is below ``tol``.

    ``telemetry`` (a ``repro_torch.obs.Telemetry``) adds a solve span,
    canonical trace events mirroring the history records, and per-iteration
    tile-work metrics; ``None`` (default) keeps the whole telemetry path to
    one bool test an iteration, with no device synchronization.
    """
    cfg = cfg or ASkotchConfig()
    tel = as_telemetry(telemetry)
    solver_name = "askotch" if cfg.accelerated else "skotch"
    n, b, d = problem.n, cfg.resolve_block(problem.n), problem.x.shape[1]
    precision = problem.precision
    recorder = tel.recorder(solver_name, precision=precision, n=n)
    probs = _maybe_arls_probs(problem, cfg, seed)
    step = make_step(problem, cfg, probs)
    state = init_state(problem, seed, w0)
    tel_enabled = tel.enabled  # hoisted: the loop pays one bool test
    with tel.span(f"solve/{solver_name}", n=n, t=problem.t, b=b,
                  max_iters=max_iters, tol=tol):
        t0 = time.perf_counter()
        converged = False
        it = 0
        for it in range(1, max_iters + 1):
            state, aux = step(state)
            if tel_enabled:
                # per-step kernel-tile work: the K_BB block + the (b, n)
                # row-block matvec (counted on the host, exact per step)
                record_tile_work(b, b, d, precision)
                record_tile_work(b, n, d, precision)
            if it % eval_every == 0 or it == max_iters:
                rel_agg, rel_heads = problem.residual_report(state.w)
                heads = rel_heads.tolist()
                rec = recorder.add(
                    it, float(rel_agg),
                    rel_residual_per_head=heads,
                    sketch_res=float(torch.linalg.vector_norm(state.sketch_res)),
                    step_L=float(aux.step_l),
                    time_s=time.perf_counter() - t0,
                )
                if callback:
                    callback(it, state, rec)
                # every head must pass (NaN passes none)
                if all(h < tol for h in heads):
                    converged = True
                    break
            if time_budget_s is not None and time.perf_counter() - t0 > time_budget_s:
                break
        if tel_enabled:  # a budget stop ends on a step the host never read
            synchronize(problem.device)
    return SolveResult(
        w=state.w, iters=it, history=recorder.history, converged=converged,
        wall_time_s=time.perf_counter() - t0,
    )


def solve_scan(
    problem: KRRProblem,
    cfg: ASkotchConfig | None = None,
    *,
    num_iters: int = 100,
    seed: int = 0,
    w0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``num_iters`` steps with no residual evaluation and no host read (the
    counterpart of the JAX package's ``lax.scan`` solve, as a plain loop):
    returns (w, per-iteration sketched residuals — (iters,) or (iters, t))."""
    cfg = cfg or ASkotchConfig()
    probs = _maybe_arls_probs(problem, cfg, seed)
    step = make_step(problem, cfg, probs)
    state = init_state(problem, seed, w0)
    res = []
    for _ in range(num_iters):
        state, _aux = step(state)
        res.append(state.sketch_res)
    return state.w, torch.stack(res)
