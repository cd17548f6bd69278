"""Blocked (multi-RHS) preconditioned conjugate gradient — the port of
``repro.core.blocked_cg``.

The tuning engine's solver (``core/tune/engine.py``, one stacked solve per
sigma group).  Each of the t right-hand-side columns carries its own
alpha/beta/residual; columns whose relative residual reaches ``tol`` are
frozen (their search direction zeroed) while the rest continue —
trajectories are those of t independent CG runs, but every ``matvec`` is one
fused pass over all t columns.

Two freezing mechanisms compose:

  * **Convergence freezing** (always on): a column below ``tol`` stops
    moving; the solve ends when every column is below ``tol``.
  * **External freezing** (``freeze_at``/``freeze_callback``): at chosen
    iterations — the *rungs* of a successive-halving search — a callback
    inspects the current block and may freeze more columns.  Externally
    frozen columns keep their prune-time values and are excluded from the
    convergence requirement; if every column ends up frozen the loop exits
    early.

All-zero RHS columns are frozen at iteration 0 with
``rel_residual_per_head = 0`` (the exact solution of ``A x = 0`` is 0).

The host reads the (t,) column norms once per iteration, as the reference
does: convergence, freezing and the history records are decided there.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.obs.metrics import counter as _obs_counter
from repro_torch.obs.trace import TraceRecorder

#: signature of the external-freeze hook: ``(it, x, rel_heads, frozen) ->
#: bool mask of columns to freeze now (or None)``; ``frozen`` is the
#: cumulative external-freeze mask so far and the returned mask is OR-ed in.
FreezeCallback = Callable[
    [int, torch.Tensor, np.ndarray, np.ndarray], "np.ndarray | None"
]


@dataclasses.dataclass
class BlockedCGResult:
    x: torch.Tensor  # (p, t) solution block
    iters: int
    history: list[dict]
    converged: bool
    #: (t,) bool — columns frozen externally (freeze_callback / zero RHS);
    #: their x columns hold the value at freeze time
    frozen: np.ndarray | None = None


def _mask(keep: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host (t,) bool mask as a 0/1 tensor of ``like``'s type and device."""
    return torch.from_numpy(keep.astype(np.float32)).to(device=like.device, dtype=like.dtype)


def blocked_cg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rhs: torch.Tensor,
    pinv: Callable[[torch.Tensor], torch.Tensor] | None = None,
    *,
    x0: torch.Tensor | None = None,
    max_iters: int = 200,
    tol: float = 1e-8,
    t0: float | None = None,
    time_budget_s: float | None = None,
    freeze_at: "tuple[int, ...] | list[int] | None" = None,
    freeze_callback: FreezeCallback | None = None,
    recorder: TraceRecorder | None = None,
) -> BlockedCGResult:
    """Solve A X = RHS column-blocked, RHS of shape (p, t).

    ``x0`` warm-starts the iteration (one extra ``matvec`` to form the
    initial residual; default is the zero start, which costs none).  History
    records carry ``rel_residual`` (aggregate ||R||_F / ||RHS||_F) and
    ``rel_residual_per_head``; convergence requires every non-frozen column
    below ``tol`` (relative to its own RHS column norm).

    ``freeze_at`` is a collection of iteration numbers (rungs); after each
    listed iteration completes, ``freeze_callback(it, x, rel_heads, frozen)``
    runs and may return a (t,) bool mask of columns to freeze externally —
    those columns stop moving but keep their current x values.
    ``result.frozen`` reports the final external-freeze mask; ``converged``
    stays the strict all-columns-below-tol statement.

    ``recorder`` (a ``repro_torch.obs.trace.TraceRecorder``) receives every
    iterate; without one an internal recorder builds the same ``history``.
    """
    if recorder is None:
        recorder = TraceRecorder("cg")
    t0 = time.perf_counter() if t0 is None else t0
    tiny = torch.finfo(rhs.dtype).tiny
    rhs_norm_raw = torch.linalg.vector_norm(rhs, dim=0)  # (t,) true norms, may be 0
    rhs_norm_raw_np = rhs_norm_raw.cpu().numpy()
    rhs_norm_np = np.maximum(rhs_norm_raw_np, tiny)
    rhs_norm_f = max(float(np.sqrt((rhs_norm_np**2).sum())), float(tiny))
    # all-zero RHS columns: the solution is exactly 0 — freeze them at
    # iteration 0 instead of letting 0/0 scalars decide
    ext_frozen = rhs_norm_raw_np == 0.0  # (t,) cumulative mask
    rungs = frozenset(int(i) for i in freeze_at) if freeze_at else frozenset()
    if ext_frozen.any():
        live = _mask(~ext_frozen, rhs)
        rhs = rhs * live
        if x0 is not None:
            x0 = x0 * live
    if x0 is None:
        x = torch.zeros_like(rhs)
        r = rhs  # residual for x0 = 0
    else:
        x = x0
        r = rhs - matvec(x0)
    history = recorder.history
    converged = bool(ext_frozen.all())
    if converged:  # every column zero: nothing to solve
        return BlockedCGResult(x=x, iters=0, history=history, converged=True, frozen=ext_frozen)
    z = pinv(r) if pinv is not None else r
    p = z
    rz = (r * z).sum(dim=0)  # (t,) per-column <r, z>
    if ext_frozen.any():
        gate = _mask(~ext_frozen, rz)
        p = p * gate
        rz = rz * gate
    it = 0
    for it in range(1, max_iters + 1):
        ap = matvec(p)  # one fused pass for all t columns
        pap = (p * ap).sum(dim=0)
        # frozen (converged or external) columns get alpha = 0 and stop moving
        active = rz > 0
        alpha = torch.where(active, rz / torch.where(active, pap, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        # ONE device->host transfer per iteration: the column norms; the
        # aggregate Frobenius residual derives from them on the host
        col_norms = torch.linalg.vector_norm(r, dim=0).cpu().numpy()
        rel_heads_np = col_norms / rhs_norm_np
        rel = float(np.sqrt((col_norms**2).sum())) / rhs_norm_f
        recorder.add(
            it, rel,
            rel_residual_per_head=rel_heads_np.tolist(),
            time_s=time.perf_counter() - t0,
        )
        below = rel_heads_np < tol
        if bool(below.all()):
            converged = True
            break
        if freeze_callback is not None and it in rungs:
            new_frozen = freeze_callback(it, x, rel_heads_np, ext_frozen)
            if new_frozen is not None:
                ext_frozen = ext_frozen | np.asarray(new_frozen, bool)
        # a frozen column (converged or external) is done; exit when none left
        if bool((below | ext_frozen).all()):
            break
        z = pinv(r) if pinv is not None else r
        rz_new = (r * z).sum(dim=0)
        # zero the search direction of columns below tol or frozen externally
        keep = _mask((rel_heads_np >= tol) & ~ext_frozen, rz_new)
        beta = torch.where(active, rz_new / torch.where(active, rz, 1.0), 0.0)
        p = (z + beta * p) * keep
        rz = rz_new * keep
        if time_budget_s is not None and time.perf_counter() - t0 > time_budget_s:
            break
    if it:
        _obs_counter(
            "repro_cg_iterations_total",
            help="blocked-CG iterations executed (all callers)",
        ).inc(it)
    return BlockedCGResult(
        x=x, iters=it, history=history, converged=converged,
        frozen=ext_frozen if ext_frozen.any() else None,
    )
