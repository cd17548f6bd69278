"""EigenPro 2.0-style preconditioned stochastic gradient for full KRR
(Ma & Belkin 2019) — the port of ``repro.core.eigenpro``, run with lam = 0
in its updates as the original authors recommend.

Coefficient-space formulation: W in R^{n x t}.  The preconditioner is the
top-q eigensystem of the subsampled kernel (1/s) K_SS; each step on batch B
takes a gradient step and the EigenPro correction on the subsample S,

  W_B <- W_B - eta G,
  W_S <- W_S + eta V diag((1 - lam_{q+1}/lam_j) / (s lam_j)) V^T K_SB G,

with eta = lr_scale / lam_{q+1} / n.  The fixed defaults can diverge on
hard data; they stay fixed, as in the reference.

The updates are ``index_add_`` over distinct indices (a batch of a
permutation, the subsample), so each entry gets one add and the result is
deterministic on the card.  ``sub_idx=`` and ``perms=`` inject the
subsample and the per-epoch permutations.
"""

from __future__ import annotations

import dataclasses
import time
from collections.abc import Sequence

import torch

from repro_torch.core.krr import KRRProblem
from repro_torch.core.operator import as_multirhs, maybe_squeeze
from repro_torch.device import synchronize
from repro_torch.obs.metrics import record_tile_work
from repro_torch.obs.telemetry import as_telemetry


@dataclasses.dataclass
class EigenProResult:
    w: torch.Tensor
    iters: int
    history: list[dict]
    wall_time_s: float


def solve_eigenpro(
    problem: KRRProblem,
    *,
    rank: int = 100,
    subsample: int | None = None,
    batch_size: int | None = None,
    lr_scale: float = 1.5,
    epochs: int = 10,
    seed: int = 0,
    eval_every: int = 100,
    time_budget_s: float | None = None,
    telemetry=None,
    sub_idx: torch.Tensor | None = None,
    perms: Sequence[torch.Tensor] | None = None,
) -> EigenProResult:
    """EigenPro 2.0 SGD solve (the module docstring has the update rule).

    The subsample is the first s of ``torch.randperm(n)`` and each epoch
    walks a fresh ``torch.randperm(n)``, all from one generator seeded with
    ``seed``, unless ``sub_idx`` / ``perms`` (one permutation an epoch)
    inject them.  The full residual is evaluated every ``eval_every``
    steps.  ``telemetry`` adds a span, trace events, and per-batch tile
    metrics.
    """
    tel = as_telemetry(telemetry)
    t0 = time.perf_counter()
    n, dev = problem.n, problem.device
    op = problem.op
    s = min(subsample or max(1000, 2 * rank), n)
    bs = min(batch_size or max(n // 100, 32), n)
    gen = torch.Generator(device=dev).manual_seed(seed)

    # --- top-q eigensystem of the subsampled kernel --------------------------
    if sub_idx is None:
        sub_idx = torch.randperm(n, generator=gen, device=dev)[:s]
    sub_idx = sub_idx.to(device=dev, dtype=torch.int64)
    op_s = op.restrict(sub_idx)
    kss = op_s.block(op_s.x)
    evals, evecs = torch.linalg.eigh(kss / s)
    evals, evecs = evals.flip(0), evecs.flip(1)
    q = min(rank, s - 1)
    lam_q, lam_tail = evals[:q], torch.clamp_min(evals[q], 1e-12)
    d_corr = (1.0 - lam_tail / lam_q) / (s * lam_q)  # (q,)
    vq = evecs[:, :q]
    eta = lr_scale / float(lam_tail) / n  # per-sample scaling

    x = problem.x
    y, squeeze = as_multirhs(problem.y)

    def step(w: torch.Tensor, batch_idx: torch.Tensor) -> None:
        xb = x.index_select(0, batch_idx)
        # one fused kernel pass per batch serves all t heads (lam = 0)
        g = op.row_block_matvec(xb, w) - y.index_select(0, batch_idx)
        w.index_add_(0, batch_idx, g, alpha=-eta)
        ksb_g = op.with_points(xb).row_block_matvec(op_s.x, g)  # K_SB @ g
        corr = vq @ (d_corr[:, None] * (vq.T @ ksb_g))
        w.index_add_(0, sub_idx, corr, alpha=eta)

    w = torch.zeros_like(y)
    recorder = tel.recorder("eigenpro", n=n)
    tel_enabled = tel.enabled
    d = x.shape[1]
    steps_per_epoch = n // bs
    it = 0
    with tel.span("solve/eigenpro", n=n, t=problem.t, rank=rank, bs=bs,
                  epochs=epochs):
        try:
            for ep in range(epochs):
                perm = (torch.randperm(n, generator=gen, device=dev) if perms is None
                        else perms[ep].to(device=dev, dtype=torch.int64))
                for sidx in range(steps_per_epoch):
                    step(w, perm[sidx * bs:(sidx + 1) * bs])
                    it += 1
                    if tel_enabled:
                        # (bs, n) gradient pass + (s, bs) correction pass
                        record_tile_work(bs, n, d)
                        record_tile_work(s, bs, d)
                    if it % eval_every == 0:
                        rel_agg, rel_heads = problem.residual_report(w)
                        recorder.add(
                            it, float(rel_agg), rel_residual_per_head=rel_heads.tolist(),
                            time_s=time.perf_counter() - t0,
                        )
                    if time_budget_s is not None and time.perf_counter() - t0 > time_budget_s:
                        return EigenProResult(maybe_squeeze(w, squeeze), it, recorder.history,
                                              time.perf_counter() - t0)
        finally:
            if tel_enabled:  # the last batch update is never read
                synchronize(dev)
    return EigenProResult(maybe_squeeze(w, squeeze), it, recorder.history,
                          time.perf_counter() - t0)
