"""The tuning ENGINE: one stacked blocked-CG per sigma group — the port of
``repro.core.tune.engine``.

Fold masks, stacked-column assembly, the per-sigma Nystrom sketch with
lam-damped preconditioning, sweep accounting and CV scoring.  Policies
(``core/tune/policies.py``) decide WHICH candidates exist and WHEN to stop
paying for them; the engine decides how cheaply a sigma group's worth of
candidates is solved together.  The single-kernel path is the q = 1 case of
the multi-kernel one: a :class:`SigmaGroup` without ``weight_samples``
solves the same stacked system with an implicit weight matrix ``[[1.0]]``.

Column layout of one group's stacked solve (head innermost):

    candidate c = m * len(lam_list) + lam_i          (m = weight sample)
    column   of (c, fold_j, head_h) = (c * k + j) * t + h
    A_col v  = M_j (sum_i W[m, i] K_i) M_j v + lam_c v

The reference's jitted closures are plain functions on tensors here.  The
host reads device values where the reference does: the blocked CG's column
norms each iteration, every rung's predictions, and the results at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.blocked_cg import blocked_cg
from repro_torch.core.krr import KRRProblem, scaled_lam
from repro_torch.core.nystrom import nystrom_from_sketch
from repro_torch.core.operator import as_multirhs
from repro_torch.obs.metrics import counter as _obs_counter

__all__ = [
    "Continuation",
    "GroupResult",
    "SigmaGroup",
    "SweepCounter",
    "naive_candidate_solve",
    "make_folds",
    "fold_avg_w0",
    "operator_for",
    "place",
    "score_fold",
    "solve_sigma_group",
]


@dataclasses.dataclass
class SweepCounter:
    """Kernel-pair-evaluation tally.

    ``pairs`` counts (row, col) kernel evaluations touched by matvec work; a
    multi-RHS matvec touches the same tiles as a single-RHS one, so the
    natural unit is a *sweep* = one full pass over the n x n tile grid
    (``pairs / n**2``).

    Every ``add_matvec`` also feeds the identical quantity into the global
    ``repro_kernel_pairs_total`` telemetry counter (``repro_torch.obs.metrics``),
    so per-search accounting (``TuneResult.sweeps``, the local ``pairs``
    float) and the process-wide metric can never disagree.
    """

    pairs: float = 0.0

    def add_matvec(self, rows: int, cols: int, count: int = 1) -> None:
        """Tally ``count`` matvec passes over a (rows, cols) tile grid."""
        q = float(rows) * float(cols) * count
        self.pairs += q
        _obs_counter(
            "repro_kernel_pairs_total",
            help="kernel pair evaluations tallied by tuning sweep accounting",
        ).inc(q)

    def sweeps(self, n: int) -> float:
        """Pair tally in full-K sweep units (``pairs / n**2``)."""
        return self.pairs / float(n) ** 2


@dataclasses.dataclass(frozen=True)
class SigmaGroup:
    """One sigma's worth of candidates — the unit of stacked solving.

    ``weight_samples`` is the (M, q) weight-candidate matrix of a
    multi-kernel search, or None for the single-kernel path (the q = 1
    degenerate case: an implicit ``[[1.0]]``).
    """

    sigma: float
    lam_list: tuple[float, ...]
    weight_samples: Any = None  # np.ndarray (M, q) | None

    @property
    def n_weight(self) -> int:
        return 1 if self.weight_samples is None else int(self.weight_samples.shape[0])

    @property
    def n_candidates(self) -> int:
        return self.n_weight * len(self.lam_list)

    def candidate_params(self) -> list[dict[str, Any]]:
        """Per-candidate parameter dicts in column-block order
        (weight outer, lam inner)."""
        out = []
        for m in range(self.n_weight):
            for lam_u in self.lam_list:
                p: dict[str, Any] = {"sigma": self.sigma, "lam_unscaled": lam_u}
                if self.weight_samples is not None:
                    p["weights"] = [float(w) for w in self.weight_samples[m]]
                out.append(p)
        return out


@dataclasses.dataclass
class Continuation:
    """Sigma-continuation state handed from one group's solve to the next.

    ``omega`` is the previous group's rank-r Nystrom basis (orthonormal —
    reused as the next sketch's test matrix instead of a fresh Gaussian);
    ``x0`` the previous solution block, valid as a warm start when the next
    group has the same column layout (``layout`` guards it).
    """

    omega: np.ndarray  # (n, r)
    x0: np.ndarray  # (n, C)
    layout: tuple  # (lam_list, weight-matrix bytes) identity of the columns


@dataclasses.dataclass
class GroupResult:
    """Everything one stacked solve produced, host-side."""

    group: SigmaGroup
    preds: np.ndarray  # (n, C) — K @ W, scores every candidate
    w_cols: np.ndarray  # (n, C) — the solution block (mask-supported)
    iters: int
    rung_history: list[dict]  # per rung: {"iter", "cv_mse": (n_cand,) list}
    pruned_at_rung: dict[int, int]  # candidate idx -> rung index
    continuation: "Continuation | None"  # only when asked for (host copies)


def _group_layout(group: SigmaGroup) -> tuple:
    w = group.weight_samples
    return (
        tuple(group.lam_list),
        None if w is None else np.asarray(w, np.float32).tobytes(),
    )


# ---------------------------------------------------------------------------
# shared helpers (folds, placement, scoring)
# ---------------------------------------------------------------------------


def make_folds(n: int, folds: int, rng: np.random.Generator) -> list[np.ndarray]:
    """Shuffled index sets of the k validation folds (near-equal sizes)."""
    perm = rng.permutation(n)
    return [np.sort(f) for f in np.array_split(perm, folds)]


def canon_sigma(sigma) -> float | tuple[float, ...]:
    """Hashable canonical form of a sigma candidate: ``float`` for a scalar,
    tuple of floats for a per-kernel bandwidth vector."""
    if isinstance(sigma, (tuple, list)):
        return tuple(float(s) for s in sigma)
    return float(sigma)


def operator_for(problem: KRRProblem, sigma, mesh, weights=None) -> Any:
    """Operator for one sigma candidate — local, or with ``mesh`` a bound
    ``ShardedKernelOperator``; ``weights`` re-weights a multi-kernel
    problem's combination (naive reference loop).  A precomputed-Gram
    problem has no sigma axis, so its operator is returned unchanged."""
    if mesh is None:
        if problem.kernel == "precomputed":
            return problem.op
        rep: dict[str, Any] = {"sigma": canon_sigma(sigma)}
        if weights is not None:
            rep["weights"] = tuple(float(w) for w in weights)
        return dataclasses.replace(problem.op, **rep)
    from repro_torch.distributed.sharded_operator import ShardedKernelOperator

    return ShardedKernelOperator.bind(
        mesh, problem.x, kernel=problem.kernel, sigma=canon_sigma(sigma),
        weights=weights, precision=problem.precision,
    )


def place(op: Any, arr: np.ndarray) -> torch.Tensor:
    """Row-aligned host data as a tensor on the operator's device: for a
    ``ShardedKernelOperator`` that is the row-sharded layout (the global
    view on the mesh's home device, which each shard slices)."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(op.x.device)


def score_fold(pred: np.ndarray, truth: np.ndarray) -> tuple[float, float]:
    """(mse, top1-accuracy) of validation predictions vs targets, all heads."""
    mse = float(np.mean((pred - truth) ** 2))
    if truth.ndim == 2 and truth.shape[1] > 1:
        acc = float(np.mean(pred.argmax(axis=1) == truth.argmax(axis=1)))
    else:
        acc = float(np.mean(np.sign(pred) == np.sign(truth)))
    return mse, acc


def fold_avg_w0(
    w_cols: np.ndarray, col0: int, folds: int, t: int, squeeze: bool
) -> np.ndarray:
    """Mask-supported mean of one candidate's k fold solutions.

    The candidate's fold-j/head-h column sits at ``col0 + j*t + h``; off-mask
    rows are exactly zero and every row is on-mask in ``k - 1`` folds, so the
    mean over its supporting folds is the column sum divided by ``k - 1``.
    """
    block = w_cols[:, col0 : col0 + folds * t]
    w0 = block.reshape(block.shape[0], folds, t).sum(axis=1) / max(folds - 1, 1)
    return w0[:, 0] if squeeze else w0


def candidate_scores(
    preds: np.ndarray,
    y2: np.ndarray,
    val_folds: list[np.ndarray],
    n_candidates: int,
) -> np.ndarray:
    """(n_cand,) mean CV validation MSE per candidate from a (n, C) pred
    block laid out candidate-major (k*t columns per candidate)."""
    k = len(val_folds)
    t = y2.shape[1]
    scores = np.empty(n_candidates, np.float64)
    for c in range(n_candidates):
        col0 = c * k * t
        fold_mse = [
            score_fold(preds[val, col0 + j * t : col0 + (j + 1) * t], y2[val])[0]
            for j, val in enumerate(val_folds)
        ]
        scores[c] = float(np.mean(fold_mse))
    return scores


# ---------------------------------------------------------------------------
# the unified stacked engine — one solve per sigma group
# ---------------------------------------------------------------------------


def solve_sigma_group(
    op: Any,
    y2: np.ndarray,
    group: SigmaGroup,
    val_folds: list[np.ndarray],
    *,
    rank: int,
    max_iters: int,
    tol: float,
    seed: int,
    warm_start: bool,
    counter: SweepCounter,
    rung_iters: Sequence[int] = (),
    prune_fn: Callable[[int, int, np.ndarray, np.ndarray], "np.ndarray | None"]
    | None = None,
    continuation: Continuation | None = None,
    want_continuation: bool = False,
    recorder=None,
) -> GroupResult:
    """Solve ALL (weight, lam, fold, head) systems of one sigma group in ONE
    stacked blocked-CG.

    Column c's operator is ``M_j (sum_i W[m, i] K_i) M_j + lam_c I``; the
    per-column weight vector rides the fused multi-kernel matvec
    (``op.matvec_cols``), so the kernel work per iteration is ONE data sweep
    however many candidates are in flight.  The per-kernel Nystrom sketches
    come from one ``sketch_components`` sweep (plain ``sketch`` at q = 1);
    candidate m's preconditioner and warm start are its weighted sketch
    combination.  ``rung_iters`` + ``prune_fn`` wire a policy's mid-solve
    pruning into ``blocked_cg``'s external freeze hook; ``continuation``
    seeds the sketch test matrix and the iterate block from the previous
    sigma group.

    Returns a :class:`GroupResult`; ``preds`` (n, C) = K @ W host-side.
    """
    n, t = y2.shape
    k = len(val_folds)
    l = len(group.lam_list)  # noqa: E741
    m_w = group.n_weight
    c_m = l * k * t  # columns per weight sample
    cand_cols = k * t  # columns per candidate

    fold_mask = np.ones((n, k), np.float32)
    for j, val in enumerate(val_folds):
        fold_mask[val, j] = 0.0
    n_train = [n - len(val) for val in val_folds]

    # columns: weight outer, then lam, fold, head (head innermost)
    fh_mask = np.repeat(fold_mask, t, axis=1)  # (n, k*t)
    fh_rhs = (fold_mask[:, :, None] * y2[:, None, :]).reshape(n, k * t)
    masks_cols = np.tile(fh_mask, (1, m_w * l))
    rhs = np.tile(fh_rhs, (1, m_w * l))
    lam_block = np.repeat(
        np.asarray(
            [scaled_lam(n_train[j], lam_u) for lam_u in group.lam_list
             for j in range(k)],
            np.float32,
        ),
        t,
    )  # (l*k*t,)
    lam_cols = np.tile(lam_block, m_w)  # (C,)

    masks_d = place(op, masks_cols)
    rhs_d = place(op, rhs)
    lam_d = place(op, lam_cols)

    # -- sketch: ONE data sweep (q per-kernel sketches; q = 1 degenerates to
    # the plain operator sketch).  Sigma-continuation reuses the previous
    # group's Nystrom basis as the test matrix (already orthonormal).
    cont_omega = None
    if continuation is not None and continuation.omega.shape == (n, rank):
        cont_omega = continuation.omega
    if cont_omega is not None:
        omega = place(op, np.asarray(cont_omega, np.float32))
    else:
        rng = np.random.default_rng(seed)
        omega = place(op, rng.standard_normal((n, rank)).astype(np.float32))
        omega, _ = torch.linalg.qr(omega)
    if group.weight_samples is None:
        y_stack = op.sketch(omega)[None]  # (1, n, r)
        w_mat = np.ones((1, 1), np.float32)
    else:
        y_stack = op.sketch_components(omega)  # (q, n, r)
        w_mat = np.asarray(group.weight_samples, np.float32)
    counter.add_matvec(n, n)

    # per weight sample: Nystrom factors of K_w from the combined sketch
    trace = op.trace_est()
    us, lams_ny = [], []
    for m in range(m_w):
        w_m = place(op, w_mat[m])
        f_m = nystrom_from_sketch(
            torch.tensordot(w_m, y_stack, dims=1), omega,
            float(w_mat[m].sum()) * trace,
        )
        us.append(f_m.u)
        lams_ny.append(f_m.lam)
    u_st = torch.stack(us)  # (M, n, r)
    lam_st = torch.stack(lams_ny)  # (M, r)

    lam3 = lam_d.reshape(m_w, c_m)  # (M, Cm) per-column shifts
    rho = lam3 + lam_st[:, -1:]  # damped rho per column
    coeff = (lam_st[:, -1:][:, :, None] + rho[:, None, :]) / (
        lam_st[:, :, None] + rho[:, None, :]
    )  # (M, r, Cm)

    if group.weight_samples is None:
        apply_k = op.matvec
    else:
        wc_d = place(op, np.repeat(w_mat.T, c_m, axis=1))  # (q, C)

        def apply_k(v: torch.Tensor) -> torch.Tensor:
            return op.matvec_cols(v, wc_d)

    def matvec(v: torch.Tensor) -> torch.Tensor:
        # one fused kernel pass over ALL columns; the per-column weight
        # vector, mask and shift are elementwise
        return masks_d * apply_k(masks_d * v) + lam_d * v

    def pinv(r_blk: torch.Tensor) -> torch.Tensor:
        # residuals are mask-supported by construction, so masking the output
        # makes this exactly the restricted (SPD) Nystrom preconditioner
        r3 = r_blk.reshape(n, m_w, c_m)
        utv = torch.einsum("mnr,nmc->mrc", u_st, r3)
        uutv = torch.einsum("mnr,mrc->nmc", u_st, utv)
        out3 = torch.einsum("mnr,mrc->nmc", u_st, coeff * utv) + (r3 - uutv)
        return masks_d * out3.reshape(n, m_w * c_m)

    x0 = None
    if continuation is not None and continuation.layout == _group_layout(group):
        # seed the whole block from the previous sigma's solution
        x0 = place(op, np.asarray(continuation.x0, np.float32))
    elif warm_start:
        # per-column Woodbury apply of candidate m's Nystrom inverse
        # (Eq. (15)), per-column rho = lam_c — zero extra kernel sweeps
        rhs3 = rhs_d.reshape(n, m_w, c_m)
        utg = torch.einsum("mnr,nmc->mrc", u_st, rhs3)
        core = utg / (lam_st[:, :, None] + lam3[:, None, :])
        out3 = torch.einsum("mnr,mrc->nmc", u_st, core) + (
            rhs3 - torch.einsum("mnr,mrc->nmc", u_st, utg)
        ) / lam3[None, :, :]
        x0 = masks_d * out3.reshape(n, m_w * c_m)

    # -- mid-solve rungs: score -> policy prune -> external column freeze
    n_cand = group.n_candidates
    rung_history: list[dict] = []
    pruned_at: dict[int, int] = {}
    active = np.ones(n_cand, bool)

    def _freeze_cb(it, x, rel_heads, frozen):
        preds_now = apply_k(x).cpu().numpy()  # ONE sweep scores every candidate
        counter.add_matvec(n, n)
        scores = candidate_scores(preds_now, y2, val_folds, n_cand)
        rung_index = len(rung_history)
        rung_history.append(
            {"iter": int(it), "cv_mse": [float(s) for s in scores]}
        )
        if prune_fn is None:
            return None
        prune = prune_fn(rung_index, int(it), scores, active.copy())
        if prune is None:
            return None
        prune = np.asarray(prune, bool) & active
        if not prune.any():
            return None
        for c in np.nonzero(prune)[0]:
            pruned_at[int(c)] = rung_index
        active[prune] = False
        return np.repeat(prune, cand_cols)

    res = blocked_cg(
        matvec, rhs_d, pinv, x0=x0, max_iters=max_iters, tol=tol,
        freeze_at=tuple(rung_iters) if rung_iters else None,
        freeze_callback=_freeze_cb if rung_iters else None,
        recorder=recorder,
    )
    counter.add_matvec(n, n, res.iters + (1 if x0 is not None else 0))

    preds = apply_k(res.x)  # scoring: ONE more sweep serves every candidate
    counter.add_matvec(n, n)
    w_cols = res.x.cpu().numpy()
    return GroupResult(
        group=group,
        preds=preds.cpu().numpy(),
        w_cols=w_cols,
        iters=res.iters,
        rung_history=rung_history,
        pruned_at_rung=pruned_at,
        continuation=(
            Continuation(
                omega=us[0].cpu().numpy(), x0=w_cols, layout=_group_layout(group)
            )
            if want_continuation
            else None
        ),
    )


# ---------------------------------------------------------------------------
# naive reference engine — one solve per (sigma[, weights], lam, fold)
# ---------------------------------------------------------------------------


def naive_candidate_solve(
    problem: KRRProblem,
    sigma: float,
    lam_u: float,
    val_folds: list[np.ndarray],
    *,
    rank: int,
    max_iters: int,
    tol: float,
    seed: int,
    counter: SweepCounter,
    mesh=None,
    weights=None,
) -> tuple[list[np.ndarray], list[int]]:
    """The loop the shared path replaces: an independent Nystrom-PCG solve
    per fold, each with its own sketch.  Returns per-fold validation
    predictions (len(val), t) and the per-fold CG iteration counts.
    ``weights`` makes the candidate a weighted kernel combination."""
    n = problem.n
    x = problem.x
    y2, _ = as_multirhs(problem.y)
    base_op = operator_for(problem, sigma, mesh, weights=weights)
    out = []
    fold_iters: list[int] = []
    for val in val_folds:
        train = np.setdiff1d(np.arange(n), val)
        train_d = place(base_op, train)
        op_f = base_op.restrict(train_d)
        n_f = len(train)
        lam_f = scaled_lam(n_f, lam_u)
        f = _naive_sketch(op_f, min(rank, n_f), seed)
        counter.add_matvec(n_f, n_f)  # the per-candidate sketch is NOT shared
        rho = lam_f + f.lam[-1]
        coeff = (f.lam[-1] + rho) / (f.lam + rho)

        def matvec(v, op_f=op_f, lam_f=lam_f):
            return op_f.matvec(v) + lam_f * v

        def pinv(r_blk, f=f, coeff=coeff):
            utv = f.u.T @ r_blk
            return f.u @ (coeff[:, None] * utv) + (r_blk - f.u @ utv)

        rhs = y2.index_select(0, train_d)
        res = blocked_cg(matvec, rhs, pinv, max_iters=max_iters, tol=tol)
        counter.add_matvec(n_f, n_f, res.iters)
        fold_iters.append(res.iters)
        pred_val = op_f.row_block_matvec(x.index_select(0, place(base_op, val)), res.x)
        counter.add_matvec(len(val), n_f)
        out.append(pred_val.cpu().numpy())
    return out, fold_iters


def _naive_sketch(op: Any, rank: int, seed: int):
    """Per-fold rank-r Nystrom sketch for the naive reference loop."""
    rng = np.random.default_rng(seed)
    omega = place(op, rng.standard_normal((op.n, rank)).astype(np.float32))
    omega, _ = torch.linalg.qr(omega)
    sketch = op.sketch(omega)
    return nystrom_from_sketch(sketch, omega, op.trace_est())
